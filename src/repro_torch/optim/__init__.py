"""Optimizers of the port (counterpart of `repro.optim`; `compression`
is not ported yet)."""
from repro_torch.optim.optimizer import (AdamWConfig, AdamWState, SGDMConfig,
                                         SGDMState, adamw_init, adamw_update,
                                         clip_by_global_norm, cosine_schedule,
                                         global_norm, sgdm_init, sgdm_update)

__all__ = [
    "AdamWConfig", "AdamWState", "SGDMConfig", "SGDMState", "adamw_init",
    "adamw_update", "clip_by_global_norm", "cosine_schedule", "global_norm",
    "sgdm_init", "sgdm_update",
]
