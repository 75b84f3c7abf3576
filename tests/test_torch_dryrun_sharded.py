"""The port's dry run of the sharded step at full size against the
reference's, live: gemma2-2b `train_4k`, `prefill_32k` and `decode_32k`,
kimi-k2-1t-a32b `train_4k`, and the decodes of one row, rwkv6-3b's and
jamba-1.5-large-398b's `long_500k`, on the single-pod (16, 16) mesh, and
gemma2-2b `train_4k` on the multi-pod (2, 16, 16) mesh; the reference's
cells one after another in one subprocess started as the module begins
(5-40 s of XLA compiles each here), each port cell in this process
meanwhile.

Held (ROADMAP C.18, C.19): status `ok` and `memory_per_chip.argument`
equal to the byte in every cell, but for the reference decode's int32
position, a traced scalar of 4 bytes there and a Python int in the port
(`dryrun.reference_position_bytes`: none where the decode does not read
it, as rwkv6's does not); gemma2-2b `train_4k` temp at most 1.25x the
reference's and `flops_per_chip` at most 1.5x; `decode_32k` temp at most
2x; `prefill_32k` temp not above the reference's; kimi-k2 `train_4k`
temp at most 2x. The step at commit c267de1 gathered every param whole
and ran the whole model on every rank: 279.10, 18.6, 61.6 and 8339 GB of
temp in these cells. The `long_500k` decodes, whose rows the data axes
do not split, keep the weights where they lie (`spmd.matmul`): FLOPs at
most 1.5x the reference's, `collective_s` at most 3x and temp at most
1.5x (gathering the FSDP shards, as at commit be24a54, moved 369.06 MB a
rank for rwkv6-3b against the reference's 0.73 and 50.1 GB for jamba
against 1.31). On the multi mesh the reference counts the scanned group
body once (no depth probes there, C.19): the port's outer work plus one
group (`probe_outer + probe_per_group`, counted on that mesh) at most
1.5x the reference's record, its full count at most 1.5x the reference's
single-mesh total times 256 / 512, and its temp at most 1.25x.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import dryrun
from torch_ranks import ROOT

# the decodes of one row: FLOPs, collective seconds and temp
LONG = {"flops_per_chip": 1.5, "collective_s": 3.0, "temp": 1.5}
# (arch, shape, mesh, {figure: at most this multiple of the reference's});
# `rolled_flops` is the port's outer work plus one group against the
# reference's multi-mesh record, `single_flops` the port's FLOPs against
# the reference's single-mesh total at the same work a rank
CELLS = (("gemma2-2b", "train_4k", "single",
          {"temp": 1.25, "flops_per_chip": 1.5}),
         ("gemma2-2b", "decode_32k", "single", {"temp": 2.0}),
         ("gemma2-2b", "prefill_32k", "single", {"temp": 1.0}),
         ("kimi-k2-1t-a32b", "train_4k", "single", {"temp": 2.0}),
         ("rwkv6-3b", "long_500k", "single", LONG),
         ("jamba-1.5-large-398b", "long_500k", "single", LONG),
         ("gemma2-2b", "train_4k", "multi",
          {"temp": 1.25, "rolled_flops": 1.5, "single_flops": 1.5}))

REFERENCE = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun   # sets XLA_FLAGS first
    print(json.dumps([dryrun.run_cell(a, s, m, print_analysis=False)
                      for a, s, m in json.loads(sys.argv[1])]))
    """)

_REF = {}


@pytest.fixture(autouse=True, scope="module")
def reference_cells():
    """The reference's cells in one subprocess, started as the module
    begins."""
    _REF["proc"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE,
         json.dumps([c[:3] for c in CELLS])], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    yield
    _REF["proc"].kill()
    _REF["proc"].communicate()


def _reference(arch, shape, mesh) -> dict:
    if "records" not in _REF:
        out, err = _REF["proc"].communicate(timeout=900)
        assert _REF["proc"].returncode == 0, err[-3000:]
        _REF["records"] = json.loads(out.strip().splitlines()[-1])
    return _REF["records"][[c[:3] for c in CELLS].index((arch, shape, mesh))]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _figures(got, want, key, arch, shape):
    """(the port's figure, the reference's) of a held `key`."""
    if key == "temp":
        return got["memory_per_chip"]["temp"], want["memory_per_chip"]["temp"]
    if key == "rolled_flops":
        return (got["probe_outer"]["flops"] + got["probe_per_group"]["flops"],
                want["flops_per_chip"])
    if key == "single_flops":
        single = _reference(arch, shape, "single")
        return (got["flops_per_chip"],
                single["flops_per_chip"] * single["chips"] / got["chips"])
    return got[key], want[key]


@pytest.mark.parametrize("arch,shape,mesh,limits", CELLS, ids=[
    f"{a}-{s}" + ("" if m == "single" else f"-{m}") for a, s, m, _ in CELLS])
def test_sharded_dry_run_at_full_size(arch, shape, mesh, limits):
    got = dryrun.run_cell(arch, shape, mesh, print_analysis=False)
    want = _reference(arch, shape, mesh)
    assert got["status"] == want["status"] == "ok"
    assert got["memory_per_chip"]["argument"] + \
        dryrun.reference_position_bytes(arch, shape) == \
        want["memory_per_chip"]["argument"]
    assert got["chips"] == want["chips"] == math.prod(dryrun.MESHES[mesh][0])
    for key, most in limits.items():
        port, ref = _figures(got, want, key, arch, shape)
        assert port <= most * ref, (key, port, ref)
