"""The port's roofline (`repro_torch.roofline`, `PodCostModel`) against
`repro.roofline.analysis` on the CPU.

- The collective record: torch collectives issued on a fake process
  group of 2 ranks under `StepCostCounter` give, kind by kind, the bytes
  and counts `parse_collectives` gives for the HLO lines of
  `tests/test_roofline.py` (the all-reduce's factor of 2, an async pair
  counted once, a tuple operand's two tensors).
- `model_flops_estimate` equal to the reference's for the ten archs and
  four shapes.
- `finalize` at the H100's peaks (each term 1.0 at them), and
  `PodCostModel.roofline_terms` agreeing with `RooflineReport`.
- The counter's per-op bytes, its peak of the storage a step made, and
  a DTensor op counted at the rank's local size.
"""
import math
import warnings

import pytest
import torch
import torch.distributed as dist

from repro.configs import LM_SHAPES as JAX_LM_SHAPES
from repro.configs import get_config as jax_get_config
from repro.roofline import analysis as JRA
from repro_torch.configs import ARCHS, LM_SHAPES, get_config
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.h100 import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.runtime import PodCostModel

# tests/test_roofline.py::test_parse_collectives_counts_and_factors
HLO = """
  %ar = f32[16,128]{1,0} all-reduce(%x), replica_groups={}
  %ag.1 = bf16[4,256]{1,0} all-gather(%y), dimensions={0}
  %rs = f32[8,64]{1,0} reduce-scatter(%z), dimensions={0}
  %cp = f32[2,2]{1,0} collective-permute(%w)
  %a2a = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-to-all(%p, %q)
  %ar-start = f32[10]{0} all-reduce-start(%r)
  %ar-done = f32[10]{0} all-reduce-done(%ar-start)
"""


@pytest.fixture
def fake_group():
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=2)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_record_matches_parse_collectives(fake_group):
    """The same kinds and result shapes as the HLO lines, issued as torch
    collectives: the same bytes and counts, kind by kind."""
    counter = RA.StepCostCounter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with counter:
            dist.all_reduce(torch.zeros(16, 128))
            dist.all_gather_into_tensor(
                torch.empty(4, 256, dtype=torch.bfloat16),
                torch.zeros(2, 256, dtype=torch.bfloat16))
            dist.reduce_scatter_tensor(torch.empty(8, 64),
                                       torch.zeros(16, 64))
            dist.send(torch.zeros(2, 2), dst=1)
            dist.all_to_all([torch.empty(4, 4), torch.empty(4, 4)],
                            [torch.zeros(4, 4), torch.zeros(4, 4)])
            work = dist.all_reduce(torch.zeros(10), async_op=True)
            work.wait()
    got, want = counter.collectives, JRA.parse_collectives(HLO)
    assert got.counts == want.counts
    assert got.bytes_by_kind == pytest.approx(want.bytes_by_kind)
    assert got.bytes_per_chip == pytest.approx(want.bytes_per_chip)


def test_functional_collective_and_its_wait_count_once(fake_group):
    """A functional all-gather is a start and a `wait_tensor`, the async
    pair the reference counts at its `-start` only."""
    from torch.distributed import _functional_collectives as fc

    counter = RA.StepCostCounter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with counter:
            out = fc.all_gather_tensor(torch.zeros(4, 8), 0,
                                       dist.group.WORLD)
            fc.wait_tensor(out)
    assert counter.collectives.counts == {"all-gather": 1}
    assert counter.collectives.bytes_per_chip == 8 * 8 * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_matches_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for s, js in zip(LM_SHAPES, JAX_LM_SHAPES, strict=True):
        assert RA.model_flops_estimate(cfg, s) == \
            JRA.model_flops_estimate(jcfg, js)


def test_finalize_at_the_h100_peaks():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 50e9)
    rep = RA.RooflineReport(
        arch="x", shape="train_4k", mesh="single", chips=256,
        flops_per_chip=PEAK_FLOPS, bytes_per_chip=HBM_BW,
        collective_bytes_per_chip=LINK_BW, model_flops=PEAK_FLOPS * 256)
    rep.finalize()
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(1.0)
    assert rep.collective_s == pytest.approx(1.0)
    assert rep.flops_ratio == pytest.approx(1.0)
    assert rep.roofline_fraction() == pytest.approx(1.0)
    assert rep.bound_s == pytest.approx(1.0)
    d = rep.to_dict()
    jrep = JRA.RooflineReport(
        arch="x", shape="train_4k", mesh="single", chips=256,
        flops_per_chip=1.0, bytes_per_chip=1.0,
        collective_bytes_per_chip=1.0, model_flops=1.0).finalize()
    assert list(d) == list(jrep.to_dict())


@pytest.mark.parametrize("chips", [1, 256, 512])
def test_pod_cost_model_agrees_with_the_report(chips):
    rep = RA.RooflineReport(
        arch="x", shape="train_4k", mesh="single", chips=chips,
        flops_per_chip=3.1e15, bytes_per_chip=7.7e11,
        collective_bytes_per_chip=2.9e10, model_flops=1e18).finalize()
    terms = PodCostModel(chips=chips).roofline_terms(
        rep.flops_per_chip * chips, rep.bytes_per_chip * chips,
        rep.collective_bytes_per_chip * chips)
    assert terms == pytest.approx({"compute_s": rep.compute_s,
                                   "memory_s": rep.memory_s,
                                   "collective_s": rep.collective_s})


def test_counter_bytes_and_peak_of_what_the_step_made():
    """Each op's inputs and outputs once (a view moves nothing); the peak
    counts the storage made inside, never the arguments'."""
    x = torch.zeros(256, 64)
    counter = RA.StepCostCounter(arguments=(x,))
    with counter:
        y = x * 2.0                  # reads 64 KiB, writes 64 KiB
        v = y.view(64, 256)          # a view: nothing
        z = torch.mm(v.t(), v)      # [256, 256] from y twice
        del y, v
        w = z.sum()
    nbytes = 256 * 64 * 4
    assert counter.bytes == 2 * nbytes + (2 * nbytes + 256 * 256 * 4) + \
        (256 * 256 * 4 + 4)
    assert counter.peak == nbytes + 256 * 256 * 4
    assert counter.count.matmul == 2 * 256 * 64 * 256
    assert float(w) == 0.0


def _gather_grad(x):
    """gather's gradient: fresh zeros scattered into, in place on a plain
    tensor."""
    idx = torch.zeros(x.shape[0], 1, dtype=torch.long)
    return x.gather(-1, idx).sum()


def _two_grads(x):
    """Two gradients of `x` summed: into the first, in place, on a plain
    tensor."""
    return (x * 2.0).sum() + (x * 3.0).sum()


@pytest.mark.parametrize("loss, copies", [(_gather_grad, 1),
                                          (_two_grads, 2)],
                         ids=["gather", "two_grads"])
def test_peak_of_backward_work_done_in_place(loss, copies):
    """On fake tensors autograd runs some backward work out of place that
    it runs in place on plain ones (a tensor subclass's composite
    compliance): the peak counts it as a plain tensor's run does, at
    `copies` gradients of x's size live at once, not one more."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.zeros(64, 1000, requires_grad=True)
        counter = RA.StepCostCounter(arguments=(x,))
        with counter:
            (g,) = torch.autograd.grad(loss(x), x)
    nbytes = 64 * 1000 * 4
    assert g.shape == x.shape
    assert copies * nbytes <= counter.peak < copies * nbytes + 1024


def test_dtensor_op_counts_the_local_shard():
    """An op on a DTensor is counted at the rank's shard: DTensor runs the
    local op back through the counter (ROADMAP A.9.2)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=8)
    try:
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        x = distribute_tensor(torch.zeros(64, 32), mesh, [Shard(0)],
                              src_data_rank=None)
        counter = RA.StepCostCounter(arguments=(x,))
        with counter:
            y = x * 3.0
        assert y.to_local().shape == (8, 32)
        assert counter.count.elementwise == 8 * 32
        assert counter.bytes == 2 * 8 * 32 * 4
        assert math.isclose(counter.peak, 8 * 32 * 4)
    finally:
        dist.destroy_process_group()
