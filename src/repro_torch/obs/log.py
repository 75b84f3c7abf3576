"""Module loggers under the ``edgeol`` tree (counterpart of
`repro.obs.log.get_logger`). Library modules log through these and never
install handlers; an entry point configures the tree."""
from __future__ import annotations

import logging

#: Root of the library's logger tree; every module logger hangs under it.
ROOT = "edgeol"


def get_logger(name: str) -> logging.Logger:
    """A logger under the `edgeol` tree: ``get_logger("scheduler")`` ->
    ``edgeol.scheduler``."""
    if name.startswith(ROOT):
        return logging.getLogger(name)
    return logging.getLogger(f"{ROOT}.{name}")
