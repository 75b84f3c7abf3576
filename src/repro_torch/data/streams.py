"""Synthetic continual-learning benchmarks mirroring the paper's setup
(§II "Scenario change", §V-A):

- ``nc_benchmark``   — CORe50-NC-style: each scenario introduces new
  classes on top of the existing ones (class-incremental).
- ``ni_benchmark``   — new-instance: same classes, new feature patterns
  (illumination / background / occlusion-style transforms).
- ``nic_benchmark``  — NICv2-style mix of both.
- ``split_benchmark``— S-CIFAR-10-style: disjoint class pairs per scenario.
- ``text_benchmark`` — 20News-style class-incremental token streams for the
  BERT model.

Data is synthetic (no dataset downloads in this container) but structured:
every class has a latent prototype; instances are prototype + structured
noise; "new pattern" scenarios apply a fixed per-scenario transform
(brightness/contrast shift + channel mix + spatial roll) so a model really
must adapt. Labels are exact. The same generator yields train batches,
a 5% validation split (paper §IV-A) and a held-out test set per scenario.

A numpy-only copy of `repro.data.streams`: the same seed gives bitwise the
same batches (tests/test_torch_data.py holds the two together).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Scenario:
    index: int
    train_batches: List[dict]     # list of {"images"/"tokens", "labels"}
    val: dict
    test: dict
    classes: List[int]
    kind: str = "nc"              # nc | ni | nic


@dataclass
class ContinualBenchmark:
    name: str
    scenarios: List[Scenario]
    num_classes: int
    modality: str = "image"       # image | text

    @property
    def num_scenarios(self) -> int:
        return len(self.scenarios)


# ---------------------------------------------------------------------------
# image benchmarks


class _ImageWorld:
    """Latent class prototypes + per-scenario appearance transforms."""

    def __init__(self, num_classes: int, size: int, seed: int):
        rng = np.random.default_rng(seed)
        self.size = size
        self.rng = rng
        # smooth prototypes: low-frequency random fields per class
        base = rng.normal(0, 1, (num_classes, 8, 8, 3))
        self.protos = np.stack([_upsample(b, size) for b in base])

    def sample(self, cls: np.ndarray, transform_id: int, n_noise: float = 0.35):
        rng = self.rng
        imgs = self.protos[cls] + rng.normal(0, n_noise, (len(cls), self.size, self.size, 3))
        if transform_id:
            t = np.random.default_rng(1000 + transform_id)
            bright = t.uniform(0.5, 1.6)
            mix = np.eye(3) + t.normal(0, 0.25, (3, 3))
            roll = t.integers(0, self.size // 2)
            imgs = (imgs * bright) @ mix
            imgs = np.roll(imgs, roll, axis=2)
        return imgs.astype(np.float32)


def _upsample(x: np.ndarray, size: int) -> np.ndarray:
    reps = size // x.shape[0]
    return np.repeat(np.repeat(x, reps, axis=0), reps, axis=1)


def _make_image_scenario(world: _ImageWorld, idx: int, classes: List[int],
                         transform_id: int, batches: int, batch_size: int,
                         test_size: int, kind: str, seed: int) -> Scenario:
    rng = np.random.default_rng(seed)
    train_batches = []
    n_train = batches * batch_size
    cls = rng.choice(classes, n_train + max(test_size, 8))
    imgs = world.sample(cls, transform_id)
    val_n = max(batch_size, int(0.05 * n_train))  # ~5% validation (paper)
    test = {"images": imgs[n_train:], "labels": cls[n_train:].astype(np.int32)}
    # validation carved from the head of the train stream
    val = {"images": imgs[:val_n], "labels": cls[:val_n].astype(np.int32)}
    for b in range(batches):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        train_batches.append({"images": imgs[sl], "labels": cls[sl].astype(np.int32)})
    return Scenario(index=idx, train_batches=train_batches, val=val, test=test,
                    classes=list(classes), kind=kind)


def nc_benchmark(num_classes=10, num_scenarios=5, batches=24, batch_size=16,
                 image_size=32, test_size=64, seed=0) -> ContinualBenchmark:
    """Class-incremental: scenario s adds `num_classes/num_scenarios` new
    classes; train data covers the new classes, test covers all seen."""
    world = _ImageWorld(num_classes, image_size, seed)
    per = num_classes // num_scenarios
    scenarios = []
    seen: List[int] = []
    for s in range(num_scenarios):
        new = list(range(s * per, (s + 1) * per))
        seen = seen + new
        sc = _make_image_scenario(world, s, new if s else seen, 0, batches,
                                  batch_size, test_size, "nc", seed + 7 * s + 1)
        # test on all classes seen so far (average inference accuracy def.)
        rng = np.random.default_rng(seed + 91 * s)
        cls = rng.choice(seen, test_size)
        sc.test = {"images": world.sample(cls, 0),
                   "labels": cls.astype(np.int32)}
        scenarios.append(sc)
    return ContinualBenchmark("nc", scenarios, num_classes)


def ni_benchmark(num_classes=10, num_scenarios=5, batches=24, batch_size=16,
                 image_size=32, test_size=64, seed=0) -> ContinualBenchmark:
    """New-instance: all classes from the start; each scenario applies a
    new appearance transform (illumination/background-style shift)."""
    world = _ImageWorld(num_classes, image_size, seed)
    classes = list(range(num_classes))
    scenarios = [
        _make_image_scenario(world, s, classes, s, batches, batch_size,
                             test_size, "ni", seed + 7 * s + 1)
        for s in range(num_scenarios)]
    return ContinualBenchmark("ni", scenarios, num_classes)


def nic_benchmark(num_classes=10, num_scenarios=8, batches=12, batch_size=16,
                  image_size=32, test_size=64, seed=0) -> ContinualBenchmark:
    """NICv2-style: alternates new-class and new-instance scenarios."""
    world = _ImageWorld(num_classes, image_size, seed)
    per = max(1, num_classes // (num_scenarios // 2 + 1))
    scenarios = []
    seen: List[int] = list(range(per))
    transform = 0
    for s in range(num_scenarios):
        if s % 2 == 1 and len(seen) < num_classes:  # new classes
            new = list(range(len(seen), min(len(seen) + per, num_classes)))
            seen += new
            sc = _make_image_scenario(world, s, new, transform, batches,
                                      batch_size, test_size, "nc", seed + 7 * s)
        else:  # new instances
            transform += 1
            sc = _make_image_scenario(world, s, seen, transform, batches,
                                      batch_size, test_size, "ni", seed + 7 * s)
        rng = np.random.default_rng(seed + 91 * s)
        cls = rng.choice(seen, test_size)
        sc.test = {"images": world.sample(cls, transform),
                   "labels": cls.astype(np.int32)}
        scenarios.append(sc)
    return ContinualBenchmark("nic", scenarios, num_classes)


def split_benchmark(num_classes=10, batches=24, batch_size=16, image_size=32,
                    test_size=64, seed=0) -> ContinualBenchmark:
    """S-CIFAR-10-style: 5 scenarios x 2 disjoint classes."""
    world = _ImageWorld(num_classes, image_size, seed)
    scenarios = []
    for s in range(num_classes // 2):
        classes = [2 * s, 2 * s + 1]
        sc = _make_image_scenario(world, s, classes, 0, batches, batch_size,
                                  test_size, "nc", seed + 7 * s + 1)
        seen = list(range(0, 2 * s + 2))
        rng = np.random.default_rng(seed + 91 * s)
        cls = rng.choice(seen, test_size)
        sc.test = {"images": world.sample(cls, 0), "labels": cls.astype(np.int32)}
        scenarios.append(sc)
    return ContinualBenchmark("s-cifar", scenarios, num_classes)


# ---------------------------------------------------------------------------
# text benchmark (20News-style)


def text_benchmark(num_classes=10, num_scenarios=5, batches=20, batch_size=16,
                   seq_len=32, vocab=512, seed=0) -> ContinualBenchmark:
    """Class-incremental text: each class boosts a distinct token subset on
    top of a shared Zipf background (20News split into class pairs)."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    boosts = []
    for c in range(num_classes):
        b = np.zeros(vocab)
        toks = rng.choice(vocab, 24, replace=False)
        b[toks] = 1.0
        boosts.append(b)

    def sample(cls, n):
        out = np.zeros((n, seq_len), np.int64)
        for i, c in enumerate(cls):
            p = zipf + 0.3 * boosts[c] / boosts[c].sum()
            p /= p.sum()
            out[i] = rng.choice(vocab, seq_len, p=p)
        return out.astype(np.int32)

    per = num_classes // num_scenarios
    scenarios = []
    seen: List[int] = []
    for s in range(num_scenarios):
        new = list(range(s * per, (s + 1) * per))
        seen = seen + new
        cls_pool = new if s else seen
        n_train = batches * batch_size
        cls = rng.choice(cls_pool, n_train)
        toks = sample(cls, n_train)
        val_n = max(batch_size, int(0.05 * n_train))
        train_batches = [{"tokens": toks[b * batch_size:(b + 1) * batch_size],
                          "labels": cls[b * batch_size:(b + 1) * batch_size].astype(np.int32)}
                         for b in range(batches)]
        tcls = rng.choice(seen, 64)
        test = {"tokens": sample(tcls, 64), "labels": tcls.astype(np.int32)}
        val = {"tokens": toks[:val_n], "labels": cls[:val_n].astype(np.int32)}
        scenarios.append(Scenario(index=s, train_batches=train_batches,
                                  val=val, test=test, classes=cls_pool, kind="nc"))
    return ContinualBenchmark("20news", scenarios, num_classes, modality="text")


REGISTRY = {"nc": nc_benchmark, "ni": ni_benchmark, "nic": nic_benchmark,
            "s-cifar": split_benchmark, "20news": text_benchmark}
