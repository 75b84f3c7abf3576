"""Structured logging bootstrap for the port (a copy of `repro.obs.log`,
DESIGN.md §14).

Library modules never call `logging.basicConfig` — they grab a module
logger via `get_logger(__name__-ish)` and log; entry points (scripts,
examples) call `configure_logging()` once,
which installs a single stderr handler on the `"edgeol"` root logger at
the level named by the ``EDGEOL_LOG`` environment variable (default
WARNING, so library users see problems but not chatter; set
``EDGEOL_LOG=DEBUG`` to watch sync skips and probe routing live).

Library modules log through loggers only, never a bare print, so every
runtime decision that used to be silent (dropped probes, mid-round sync
skips, straggler flags/evictions) flows through here.
"""
from __future__ import annotations

import logging
import os
import sys

#: Root of the library's logger tree; every module logger hangs under it.
ROOT = "edgeol"

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    """A logger under the `edgeol` tree: ``get_logger("fleet")`` ->
    ``edgeol.fleet``. Safe at import time — no handler is installed
    until `configure_logging` runs."""
    if name.startswith(ROOT):
        return logging.getLogger(name)
    return logging.getLogger(f"{ROOT}.{name}")


def configure_logging(level: str = None, *, stream=None,
                      force: bool = False) -> logging.Logger:
    """Idempotently install one stderr handler on the `edgeol` root
    logger. `level` falls back to ``$EDGEOL_LOG`` then ``WARNING``;
    `force=True` reconfigures (tests). Returns the root logger."""
    root = logging.getLogger(ROOT)
    if level is None:
        level = os.environ.get("EDGEOL_LOG", "WARNING")
    resolved = getattr(logging, str(level).upper(), None)
    if not isinstance(resolved, int):
        raise ValueError(f"unknown log level {level!r}; use one of "
                         f"DEBUG/INFO/WARNING/ERROR/CRITICAL")
    if force:
        for h in list(root.handlers):
            root.removeHandler(h)
    if not root.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.propagate = False
    root.setLevel(resolved)
    return root
