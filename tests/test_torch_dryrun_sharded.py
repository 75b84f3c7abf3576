"""The port's dry run of the sharded step at full size against the
reference's, live: gemma2-2b `train_4k`, `prefill_32k` and `decode_32k`
and kimi-k2-1t-a32b `train_4k` on the single-pod (16, 16) mesh, the
reference's cells one after another in one subprocess started as the
module begins (20-40 s of XLA compiles each here), each port cell in
this process meanwhile.

Held (ROADMAP C.18): status `ok` and `memory_per_chip.argument` equal to
the byte in every cell, but for the reference decode's int32 position,
a traced scalar of 4 bytes there and a Python int in the port (as at
commit c267de1); gemma2-2b `train_4k` temp at most 1.25x the
reference's and `flops_per_chip` at most 1.5x; `decode_32k` temp at most
2x; `prefill_32k` temp not above the reference's; kimi-k2 `train_4k`
temp at most 2x. The step at commit c267de1 gathered every param whole
and ran
the whole model on every rank: 279.10, 18.6, 61.6 and 8339 GB of temp
in these cells.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import dryrun
from torch_ranks import ROOT

# (arch, shape, {figure: at most this multiple of the reference's})
CELLS = (("gemma2-2b", "train_4k", {"temp": 1.25, "flops_per_chip": 1.5}),
         ("gemma2-2b", "decode_32k", {"temp": 2.0}),
         ("gemma2-2b", "prefill_32k", {"temp": 1.0}),
         ("kimi-k2-1t-a32b", "train_4k", {"temp": 2.0}))

REFERENCE = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun   # sets XLA_FLAGS first
    print(json.dumps([dryrun.run_cell(a, s, "single", print_analysis=False)
                      for a, s in json.loads(sys.argv[1])]))
    """)

_REF = {}


@pytest.fixture(autouse=True, scope="module")
def reference_cells():
    """The reference's cells in one subprocess, started as the module
    begins."""
    _REF["proc"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE,
         json.dumps([(a, s) for a, s, _ in CELLS])], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    yield
    _REF["proc"].kill()
    _REF["proc"].communicate()


def _reference(arch, shape) -> dict:
    if "records" not in _REF:
        out, err = _REF["proc"].communicate(timeout=900)
        assert _REF["proc"].returncode == 0, err[-3000:]
        _REF["records"] = json.loads(out.strip().splitlines()[-1])
    return _REF["records"][[(a, s) for a, s, _ in CELLS].index(
        (arch, shape))]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _figure(record, key):
    return record["memory_per_chip"]["temp"] if key == "temp" \
        else record[key]


@pytest.mark.parametrize("arch,shape,limits", CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_sharded_dry_run_at_full_size(arch, shape, limits):
    got = dryrun.run_cell(arch, shape, "single", print_analysis=False)
    want = _reference(arch, shape)
    assert got["status"] == want["status"] == "ok"
    position = 4 if shape.startswith("decode") else 0
    assert got["memory_per_chip"]["argument"] + position == \
        want["memory_per_chip"]["argument"]
    assert got["chips"] == want["chips"] == 256
    for key, most in limits.items():
        assert _figure(got, key) <= most * _figure(want, key), \
            (key, _figure(got, key), _figure(want, key))
