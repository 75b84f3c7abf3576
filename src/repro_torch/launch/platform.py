"""Process setup for the port's entry points, the counterpart of
`repro.launch.platform` (DESIGN.md §12).

One idempotent entry point, `bootstrap()`, called before the first
launch: logging through the "edgeol" logger tree at ``$EDGEOL_LOG``'s
level, the device (the card unless ``"cpu"`` is asked for:
`repro_torch.resolve_device`), and the directory the hand-written kernels
are built into, the counterpart of XLA's persistent compilation cache: a
built kernel is reused by every later process (`kernels/build.py`).

The reference's XLA flags (the GPU latency-hiding scheduler, the host
platform's device count, x64, the donation warning's filter) configure
XLA and have no meaning for torch; they are not carried over. A CPU
world of several ranks comes from `torch.distributed` (`launch/mesh.py`),
not from splitting the host into devices. Library code never calls this.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch import resolve_device

_bootstrapped = None


def bootstrap(device=None, build_dir=None) -> torch.device:
    """Set the process up once; returns the device entry points run on.
    `build_dir` replaces `kernels/build.py`'s `BUILD_DIR` (the checkout's
    ``build/kernels``)."""
    global _bootstrapped
    if _bootstrapped is not None:
        return _bootstrapped
    from repro_torch.kernels import build
    from repro_torch.obs.log import configure_logging

    configure_logging()
    if build_dir is not None:
        build.BUILD_DIR = Path(build_dir)
    _bootstrapped = resolve_device(device)
    return _bootstrapped
