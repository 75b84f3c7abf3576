"""Run a program on a CPU world of several ranks (gloo), one process a
rank, for the port's multi-rank tests.

`run_ranks(world, body, inputs)` starts `world` Python processes with
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` set for
``tcp://localhost`` at a free port, each running: the default process
group on gloo, ``inputs`` (an npz file of numpy arrays, `np.load`ed as
``inp``), then `body`, which assigns a JSON-serializable ``out``. Each
rank prints ``out`` as its last line; the list of every rank's ``out``
comes back in rank order. A rank that fails fails the call with its
stderr; every rank has `timeout` seconds.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = """\
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo")
rank, world = dist.get_rank(), dist.get_world_size()
inp = np.load(os.environ["RANKS_INPUT"]) if os.environ.get("RANKS_INPUT") \\
    else {}
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, body: str, inputs=None, tmp_path=None,
              timeout: float = 120.0) -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    if inputs is not None:
        path = Path(tmp_path) / "ranks_input.npz"
        np.savez(path, **inputs)
        env["RANKS_INPUT"] = str(path)
    prog = PRELUDE + textwrap.dedent(body) + EPILOGUE
    procs = [subprocess.Popen([sys.executable, "-c", prog], cwd=ROOT,
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r}:\n{stderr[-4000:]}"
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
