"""CheckpointManager: rotation, integrity-checked restore-latest, and
restart-after-failure semantics (counterpart of
`repro.checkpoint.manager`).

A host failure mid-save leaves the previous valid checkpoint in place
(atomic rename + checksums), and `restore_latest` skips any checkpoint
that fails validation."""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional, Tuple

from repro_torch.checkpoint import ckpt


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async = ckpt.AsyncCheckpointer() if use_async else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, tree, extra: Optional[dict] = None,
             block: bool = False) -> str:
        path = self._path(step)
        if self._async is not None:
            self._async.save(path, tree, step, extra)
            if block:
                self._async.wait()
        else:
            ckpt.save(path, tree, step, extra)
        self._gc()
        return path

    def wait(self) -> None:
        if self._async is not None:
            self._async.wait()

    @property
    def write_seconds(self):
        """Host seconds the last finished background write took (None
        before one, or without `use_async`)."""
        return self._async.write_seconds if self._async is not None \
            else None

    def restore_latest(self, like, shardings=None,
                       device=None) -> Tuple[Optional[Any], int]:
        """Newest *valid* checkpoint, its leaves on `device` (CUDA unless
        given) or placed by `shardings` (as `ckpt.restore` places them),
        skipping corrupt ones. (None, -1) if nothing restorable — the
        caller falls back to fresh init."""
        self.wait()
        for step in reversed(self.all_steps()):
            restored = ckpt.restore_if_valid(self._path(step), like, device,
                                             shardings)
            if restored is not None:
                return restored
        return None, -1

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)
