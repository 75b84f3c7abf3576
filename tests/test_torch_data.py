"""The port's numpy copies of the data streams and arrival timelines give
bitwise the batches and events of the JAX package's for the same seed."""
import numpy as np
import pytest

from repro.data import arrivals as jax_arrivals
from repro.data import streams as jax_streams
from repro_torch.data import arrivals, streams


def _assert_same_split(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,kw", [
    ("nc", dict(num_classes=10, num_scenarios=4, batches=3, batch_size=4)),
    ("ni", dict(num_classes=6, num_scenarios=3, batches=2, batch_size=4)),
    ("nic", dict(num_classes=6, num_scenarios=4, batches=2, batch_size=4)),
    ("s-cifar", dict(num_classes=4, batches=2, batch_size=4)),
    ("20news", dict(num_classes=4, num_scenarios=2, batches=2, batch_size=4,
                    seq_len=8, vocab=64)),
])
def test_benchmarks_are_bitwise_equal(name, kw, seed):
    a = jax_streams.REGISTRY[name](seed=seed, **kw)
    b = streams.REGISTRY[name](seed=seed, **kw)
    assert (a.name, a.num_classes, a.modality) == \
        (b.name, b.num_classes, b.modality)
    assert len(a.scenarios) == len(b.scenarios)
    for sa, sb in zip(a.scenarios, b.scenarios):
        assert (sa.index, list(sa.classes), sa.kind) == \
            (sb.index, list(sb.classes), sb.kind)
        assert len(sa.train_batches) == len(sb.train_batches)
        for ba, bb in zip(sa.train_batches, sb.train_batches):
            _assert_same_split(ba, bb)
        _assert_same_split(sa.val, sb.val)
        _assert_same_split(sa.test, sb.test)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("data_dist,inf_dist", [("poisson", "poisson"),
                                                ("uniform", "trace"),
                                                ("normal", "poisson")])
def test_timelines_are_bitwise_equal(seed, data_dist, inf_dist):
    kw = dict(num_scenarios=3, batches_per_scenario=6, inferences_total=48,
              data_dist=data_dist, inf_dist=inf_dist, seed=seed)
    a = jax_arrivals.build_timeline(**kw)
    b = arrivals.build_timeline(**kw)
    assert [tuple(vars(e).values()) for e in a] == \
        [tuple(vars(e).values()) for e in b]
