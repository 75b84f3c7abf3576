"""Batched serving engine for the LMs: a prefill step, then greedy decode
steps over the caches it returns (port of `repro.runtime.serve`).

The prompt is uploaded once, as one tensor; generated tokens stay on the
device until the end, so the loop waits for the device only once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_steps: int = 0


class ServeEngine:
    def __init__(self, model, max_len: int = 256):
        self.model = model
        self.max_len = max_len
        self.stats = ServeStats()

    @torch.inference_mode()
    def generate(self, params, tokens: np.ndarray, steps: int = 16,
                 return_logits: bool = False):
        """tokens: [B, S] prompt. Returns [B, steps] greedy (argmax) ids
        as int32, and with `return_logits` also the fp32 logits
        [B, steps, V] that chose them (those of the prefill, then of each
        decode step but the last). A frontend config gets zero
        `frontend_embeds` [B, frontend_tokens, frontend_dim] in bf16, as
        in the reference, and decodes from S + frontend_tokens."""
        cfg = self.model.cfg
        B, S = tokens.shape
        batch = {"tokens": torch.as_tensor(np.asarray(tokens),
                                           device=self.model.device)}
        prefix = 0
        if cfg.frontend != "none":
            prefix = cfg.frontend_tokens
            batch["frontend_embeds"] = torch.zeros(
                (B, prefix, cfg.frontend_dim), dtype=torch.bfloat16,
                device=self.model.device)
        logits, cache = self.model.prefill(params, batch)
        self.stats.prefill_tokens += B * S
        # decode caches are sized by the prefill; attention caches are
        # pre-extended to max_len once (rwkv states are left alone)
        cache = self._extend_cache(cache, self.max_len)
        out, chose = [], []
        cur = logits.argmax(-1)[:, None]
        for t in range(steps):
            out.append(cur[:, 0])
            chose.append(logits)
            logits, cache = self.model.decode(params, cur, cache,
                                              S + prefix + t)
            self.stats.decode_steps += 1
            cur = logits.argmax(-1)[:, None]
        ids = (torch.stack(out, dim=1).to(torch.int32).cpu().numpy() if out
               else np.zeros((B, 0), np.int32))
        if not return_logits:
            return ids
        return ids, (torch.stack(chose, dim=1).cpu().numpy() if chose
                     else np.zeros((B, 0, logits.shape[-1]), np.float32))

    def _extend_cache(self, cache, max_len: int):
        """Attention k/v leaves [..., L, Hkv, hd] padded with zeros along
        L (axis ndim-3) to max_len; every other leaf as it is (JAX's
        rule: only leaves named k or v)."""
        def ext(leaf):
            if leaf.dim() >= 3 and leaf.is_floating_point():
                ax = leaf.dim() - 3
                L = leaf.shape[ax]
                if 1 < L < max_len and ax >= 1:
                    pad = [0, 0] * (leaf.dim() - ax - 1) + [0, max_len - L]
                    return F.pad(leaf, pad)
            return leaf

        def walk(node, name=None):
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v) for v in node]
            return ext(node) if name in ("k", "v") else node

        return walk(cache)
