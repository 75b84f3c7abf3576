"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source in `repro_torch/csrc/` with a plain C interface.
It is compiled with nvcc for Hopper (`sm_90a`) into a shared library and
loaded with ctypes; no PyTorch header is compiled, which keeps a build to
seconds. Libraries go to `build/kernels/` at the root of the checkout
(listed in .gitignore) under a name that carries a hash of the source,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.

Nothing is built or loaded when a module is imported: the first launch
builds what it needs, and `build` compiles several sources at once, one
nvcc process each. `entry` and `call` keep the host's share of a launch
small: the wrappers run eagerly, hundreds of launches a slice run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -cudart shared: the libraries link the CUDA runtime dynamically, so
# loaded into a process that has imported torch they resolve to the
# libcudart.so.12 torch already mapped, and one runtime owns the context
# and the streams (the default static runtime would be a second copy).
# -Xptxas -v: the compiler's report of registers, shared memory and
# spills per kernel, which `build` returns for the caller to print
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
              "-Xptxas", "-v")

# loaded libraries, one per source for the life of the process (ctypes
# would map the same file once anyway)
_LIBS: Dict[str, ctypes.CDLL] = {}
# C entry points with their argument types set, by (source, symbol)
_ENTRIES: Dict[Tuple[str, str], Any] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, all nvcc
    processes started together. Returns the compiler's report for each
    source it compiled; raises with the compiler output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
            reports[name] = log
        return reports
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def entry(name: str, symbol: str, argtypes: Sequence[Any]):
    """The C function `symbol` of `csrc/<name>.cu`, returning a
    cudaError_t as an int. Its argument types are set once, on the first
    call: setting them again on every launch costs the host microseconds
    a launch."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def call(fn, device: torch.device, *args) -> int:
    """`fn(*args, stream)` with `device`'s current stream, `device` made
    the current one for the call where it is not. The stream is read on
    every call (a CUDA graph captures on a stream of its own) as the raw
    handle that torch's compiled kernels take, without the Stream object
    `torch.cuda.current_stream` builds."""
    idx = device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)
