"""FineTuneExecutor — round execution for the continual-learning loop,
ported from `repro.runtime.executor`.

Owns the training state (params/optimizer), the pending-batch buffer, the
anti-forgetting replay buffer, and the per-round mechanics: plan-aware
steps (via TrainStepCache), FLOPs per plan, cost-model calibration and
the `CostLedger` charge. Orthogonal training behaviours — the
semi-supervised SimSiam pass on unlabeled batches (paper §IV-C) and
simulated quantization-aware training (paper §V-G) — are composable
`RoundHook`s rather than special cases inlined in the event loop.

The executor is timeline-agnostic: it receives `now` and an
`EventScheduler` to reserve device time on, and reports what it did via
`RoundReport`; publishing the new params to serving, validation and
controller notification stay with the caller. The reference's tracer
spans come with the port of `repro.obs`'s live tracer.

The eager train steps are out of place, and the compiled path's
`TrainStepCache.fused_call` copies the params and optimizer state into
its graph's static buffers before every replay and hands out fresh
tensors after it (the counterpart of the reference's `_own_buffers`,
which its donating steps need). So the params that escape the executor
(published to serving, held as SimFreeze's reference) are never written.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree_leaves, tree_map, tree_unflatten
from repro_torch.core import semi
from repro_torch.runtime.costmodel import EdgeCostModel
from repro_torch.runtime.ledger import DEFAULT_DEVICE, DEFAULT_MODEL, CostLedger
from repro_torch.runtime.train_loop import (TrainStepCache, as_tensor,
                                            same_shape_runs)


# ---------------------------------------------------------------------------
# replay buffer (documented substitution for CORe50's CWR; DESIGN.md §4)


class ReplayBuffer:
    """Small reservoir of past batches mixed into each round (one sampled
    batch per round) so new-scenario tuning does not erase old scenarios."""

    def __init__(self, batches: Sequence[dict] = (), capacity: int = 6):
        self._items: List[dict] = list(batches)
        self.capacity = capacity

    def add(self, batch: dict) -> None:
        if len(self._items) < self.capacity:
            self._items.append(batch)

    def sample(self, rng: np.random.Generator) -> dict:
        return self._items[rng.integers(len(self._items))]

    def __len__(self) -> int:
        return len(self._items)


# ---------------------------------------------------------------------------
# round hooks


class RoundHook:
    """Composable per-round behaviour. Lifecycle:

    - `bind(model)` once at construction time; may return a *wrapped*
      model (the executor and serving path then use the wrapped one);
    - `on_round_start(round_index)` before each round's batch loop;
    - `process_batch(params, batch, tensor_batch)` per batch: return
      updated params to claim the batch (the supervised step is skipped),
      or None to pass.
    """

    def bind(self, model):
        return model

    def on_round_start(self, round_index: int) -> None:
        pass

    def process_batch(self, params, batch: dict, tensor_batch: dict):
        return None


#: the generator seeds of the SimSiam augmentations and head: fixed, so
#: every semi step augments alike (the reference re-seeds its draws on
#: every call, ROADMAP C.7) and the head is drawn once
AUGMENT_SEED = 0
HEAD_SEED = 1


def draw_views(images: torch.Tensor):
    """The two views' augmentation draws of a semi step: the same on
    every call for a batch shape."""
    gen = torch.Generator().manual_seed(AUGMENT_SEED)
    return tuple(semi.draw_augment(gen, images.shape) for _ in range(2))


class SimSiamHook(RoundHook):
    """Semi-supervised rounds (paper §IV-C): with probability
    `unlabeled_fraction`, an image batch is treated as unlabeled and gets a
    SimSiam self-supervised update instead of the supervised step.

    As in the reference: the labeled/unlabeled split of a round is drawn
    from ``default_rng(round_index + 17)``; every semi step augments with
    the same draws (`draws(images)`, the reference re-seeds its own on
    every call: ROADMAP C.7); the SimSiam head is initialized once
    (`init_head(feat_dim)`) on the first 256 flattened numbers of the
    last activation, not a pool; and the update is plain ``p - 1e-3 g``
    on autograd gradients, outside the optimizer. `draws` and
    `init_head` are attributes a caller may replace (a parity test gives
    the reference's). The reference's `donate` switch, a JAX buffer
    donation, has no counterpart: the update is out of place."""

    def __init__(self, unlabeled_fraction: float):
        self.unlabeled_fraction = unlabeled_fraction
        self.model = None
        self.draws = draw_views
        self.init_head = lambda feat_dim: semi.init_simsiam_head(
            torch.Generator().manual_seed(HEAD_SEED), feat_dim)
        self._head = None
        self._feat_dim = None
        self._rng = np.random.default_rng(17)

    def bind(self, model):
        self.model = model
        return model

    def on_round_start(self, round_index: int) -> None:
        # deterministic per-round labeled/unlabeled split
        self._rng = np.random.default_rng(round_index + 17)

    def process_batch(self, params, batch, tensor_batch):
        if self.unlabeled_fraction and "images" in batch and \
                self._rng.random() < self.unlabeled_fraction:
            return self._semi_update(params, tensor_batch)
        return None

    def _pooled(self, params, images):
        f = self.model.features(params, {"images": images})[-1]
        return f.reshape(f.shape[0], -1)[:, :self._feat_dim].float()

    def _semi_update(self, params, batch):
        images = batch["images"]
        if self._head is None:
            last = self.model.features(params, batch)[-1]
            self._feat_dim = min(last[0].numel(), 256)
            self._head = tree_map(lambda t: t.to(images.device),
                                  self.init_head(self._feat_dim))
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = semi.simsiam_loss(self._pooled, self._head,
                                     tree_unflatten(params, leaves), images,
                                     self.draws(images))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return tree_unflatten(params, [
            p.detach() if g is None else
            (p.detach().float() - 1e-3 * g.float()).to(p.dtype)
            for p, g in zip(leaves, grads)])


class FakeQuantHook(RoundHook):
    """Simulated quantization-aware training (paper §V-G, Table VIII): the
    model's loss/predict see fake-quantized params (straight-through
    estimator keeps gradients alive). Purely a model wrap — no per-batch
    work."""

    def __init__(self, bits: int):
        self.bits = bits

    def bind(self, model):
        return quantized_model(model, self.bits)


# ---------------------------------------------------------------------------
# executor


@dataclass
class RoundReport:
    iters: int
    flops: float
    time_s: float
    energy_j: float
    recompiled: bool
    start: float
    end: float
    stream: int = 0      # arrival stream whose buffer the round drained
    segments: int = 1    # occupancy segments (1 unless preempted)
    preemptions: int = 0  # higher-priority splits the round absorbed


class ActiveRound:
    """Checkpointed state of an in-flight *preemptible* round.

    The round's full cost (time/energy/FLOPs/parts) is fixed when it
    launches — preemption changes *when* the work runs, never how much —
    and is charged to the ledger in per-segment slices as occupancy
    elapses. `trained` is the checkpointed batch-iterator position:
    batches train lazily as the modeled timeline covers their completion
    point, so a preemption observes exactly the params the device would
    hold at that instant. The final segment charges the exact remainder
    of every cost component, so segments always sum to the unpreempted
    round's charge."""

    def __init__(self, step, plan, stream: int, batches, flops: float,
                 time_s: float, energy_j: float, parts, recompiled: bool,
                 reservation):
        self.step = step
        self.plan = plan
        self.stream = stream
        self.batches = batches
        self.trained = 0
        self.flops = flops
        self.time_s = time_s
        self.energy_j = energy_j
        self.parts = dict(parts)
        self.recompiled = recompiled
        self.reservation = reservation
        self.first_start = reservation.start
        self.seg_start = reservation.start
        self.segments = 0
        self.preemptions = 0
        self.charged = {"time_s": 0.0, "energy_j": 0.0, "flops": 0.0}
        self.charged_parts = {k: 0.0 for k in self.parts}

    @property
    def end(self) -> float:
        return self.reservation.end


class FineTuneExecutor:
    def __init__(self, steps: TrainStepCache, cost: EdgeCostModel,
                 ledger: CostLedger, replay: ReplayBuffer, *,
                 rng: np.random.Generator,
                 hooks: Sequence[RoundHook] = (),
                 calibrate_cost: bool = True,
                 model_name: str = DEFAULT_MODEL,
                 device_name: str = DEFAULT_DEVICE,
                 speed_scale: float = 1.0,
                 preempt_resume_cost_s: float = 0.0,
                 compiled: bool = False,
                 fuse: bool = True):
        self.steps = steps
        self.device = steps.model.device
        self.cost = cost
        self.ledger = ledger
        self.replay = replay
        self.rng = rng
        self.hooks = list(hooks)
        self.calibrate_cost = calibrate_cost
        # compiled hot path (DESIGN.md §12): every supervised update goes
        # through the fused masked step — `fuse` additionally batches each
        # maximal same-shape run of a round into one call, and can be
        # dropped per run without moving a bit, since both are the same
        # masked loop
        self.compiled = bool(compiled)
        self.fuse = bool(fuse)
        # model-slot and fleet-device attribution keys of every ledger
        # charge and occupancy; cost calibration multiplies flops_per_sec
        # by `speed_scale`
        self.model_name = model_name
        self.device_name = device_name
        self.speed_scale = float(speed_scale)
        # modeled checkpoint-resume overhead paid on each preemption split
        # (0.0 = the legacy free split; see `preempt`)
        self.preempt_resume_cost_s = float(preempt_resume_cost_s)
        # pending batches, bucketed by arrival stream: a round drains one
        # stream's bucket
        self.buffers: Dict[int, List[dict]] = {}
        self.compiled_plans = set()
        self.params = None
        self.opt_state = None
        # in-flight preemptible round (at most one: the device is single)
        self.active_round: Optional[ActiveRound] = None

    # ---- state -----------------------------------------------------------
    def load(self, params, opt_state) -> None:
        self.params = params
        self.opt_state = opt_state

    def enqueue(self, batch: dict, stream: int = 0) -> None:
        self.buffers.setdefault(stream, []).append(batch)

    @property
    def pending(self) -> int:
        """Total buffered batches across all streams."""
        return sum(len(b) for b in self.buffers.values())

    def pending_for(self, stream: int) -> int:
        return len(self.buffers.get(stream, ()))

    @property
    def pending_streams(self) -> List[int]:
        return sorted(s for s, b in self.buffers.items() if b)

    # ---- round -----------------------------------------------------------
    def _train_batch(self, step, plan, b: dict) -> None:
        """One training iteration: the first hook that claims the batch
        updates the params; otherwise the plan-aware supervised step (the
        bucket-1 fused step in compiled mode, so per-batch and
        segment-batched execution are the same masked loop, which takes
        the host batch)."""
        tb = as_tensor(b, self.device) \
            if self.hooks or not self.compiled else None
        for h in self.hooks:
            handled = h.process_batch(self.params, b, tb)
            if handled is not None:
                self.params = handled
                return
        if self.compiled:
            self.params, self.opt_state, _ = self.steps.fused_call(
                plan, self.params, self.opt_state, [b])
            return
        self.params, self.opt_state, _ = step(self.params, self.opt_state,
                                              tb)

    def _run_batches(self, step, plan, batches: Sequence[dict]) -> None:
        """Train a round's batches. Compiled hook-free rounds batch each
        maximal run of same-shape batches into one fused call; hooks claim
        batches one at a time (their RNG draws are order-dependent), so
        hook-bearing rounds stay per batch."""
        if not (self.compiled and self.fuse) or self.hooks:
            for b in batches:
                self._train_batch(step, plan, b)
            return
        for run in same_shape_runs(batches):
            self.params, self.opt_state, _ = self.steps.fused_call(
                plan, self.params, self.opt_state, run)

    def _calibrated(self, per_iter_flops: float) -> EdgeCostModel:
        # Preserve the paper's compute/overhead balance (Fig. 3) at
        # reduced model scale: scale the device throughput so a
        # 2-iteration immediate round spends ~0.8 s in compute vs the
        # 1.1 s fixed overheads (58%/42% split). DESIGN.md §3.
        return dataclasses.replace(
            self.cost,
            flops_per_sec=max(per_iter_flops * 2 / 0.8, 1.0)
            * self.speed_scale)

    def _round_cost(self, plan, batches, recompile: int):
        """Round FLOPs + (one-shot calibrated) modeled cost."""
        flops = self.steps.flops(plan, batches[0]) * len(batches)
        if self.calibrate_cost:
            self.cost = self._calibrated(flops / max(len(batches), 1))
            self.calibrate_cost = False
        t, e, parts = self.cost.round_cost(flops, recompiles=recompile)
        return flops, t, e, parts

    def estimate_round(self, plan, stream: int = 0):
        """Modeled ``(time_s, energy_j)`` the round `stream`'s buffer
        would cost if triggered now — replay batch and worst-case
        recompile included — without mutating any state (the one-shot
        cost calibration is mirrored, not applied)."""
        batches = self.buffers.get(stream)
        if not batches:
            return 0.0, 0.0
        n = len(batches) + (1 if self.replay else 0)
        flops = self.steps.flops(plan, batches[0]) * n
        cost = self._calibrated(flops / max(n, 1)) if self.calibrate_cost \
            else self.cost
        recompile = 0 if plan in self.compiled_plans else 1
        t, e, _ = cost.round_cost(flops, recompiles=recompile)
        return t, e

    def execute_round(self, plan, now: float, scheduler, stream: int = 0,
                      *, priority: int = 0,
                      preemptible: bool = False) -> Optional[RoundReport]:
        """Train one round on everything buffered for `stream` (plus one
        replay batch), charge the ledger (attributed to that stream), and
        reserve device time on the scheduler. Returns None when nothing is
        buffered.

        With ``preemptible=True`` the round *launches* instead of running
        to completion: its cost is fixed and the device reserved up front
        (at the stream's `priority`), but batches train lazily as the
        timeline covers them, so a higher-priority arrival can split the
        occupancy (`preempt`) and the round completes only when
        `finalize_round` is called at/after its reservation's end. In
        that mode this method returns None and the caller polls
        `active_round` / `finalize_round`."""
        if not self.buffers.get(stream):
            return None
        assert self.active_round is None, "previous round not finalized"
        recompile = 0
        if plan not in self.compiled_plans:
            self.compiled_plans.add(plan)
            recompile = 1
        step = self.steps.get(plan)
        batches = self.buffers.pop(stream)
        if self.replay:
            batches.append(self.replay.sample(self.rng))
        for h in self.hooks:
            h.on_round_start(self.ledger.rounds)
        if not preemptible:
            self._run_batches(step, plan, batches)
            flops, t, e, parts = self._round_cost(plan, batches, recompile)
            self.ledger.charge_round(flops=flops, time_s=t, energy_j=e,
                                     parts=parts, stream=stream,
                                     model=self.model_name,
                                     device=self.device_name)
            start, end = scheduler.occupy(now, t, stream=stream,
                                          priority=priority,
                                          device=self.device_name)
            return RoundReport(iters=len(batches), flops=flops, time_s=t,
                               energy_j=e, recompiled=bool(recompile),
                               start=start, end=end, stream=stream)
        flops, t, e, parts = self._round_cost(plan, batches, recompile)
        res = scheduler.occupy(now, t, stream=stream, priority=priority,
                               preemptible=True, device=self.device_name)
        self.active_round = ActiveRound(step, plan, stream, batches, flops,
                                        t, e, parts, bool(recompile), res)
        return None

    def _advance_training(self, ar: ActiveRound, elapsed: float) -> None:
        """Train every batch whose modeled completion point lies within
        the first `elapsed` seconds of the round (uniform per-batch
        spread; mid-batch progress is carried by the time accounting, not
        re-done)."""
        n = len(ar.batches)
        target = min(n, int(n * elapsed / max(ar.time_s, 1e-12)))
        while ar.trained < target:
            self._train_batch(ar.step, ar.plan, ar.batches[ar.trained])
            ar.trained += 1

    def _charge_segment(self, ar: ActiveRound, seg_dur: float,
                        final: bool) -> None:
        """Charge one occupancy segment: proportional slices of every cost
        component, except the final segment which charges the exact
        remainder (so segments sum to the unpreempted round's charge with
        no float drift)."""
        if final:
            time_s = ar.time_s - ar.charged["time_s"]
            energy_j = ar.energy_j - ar.charged["energy_j"]
            flops = ar.flops - ar.charged["flops"]
            parts = {k: v - ar.charged_parts[k] for k, v in ar.parts.items()}
        else:
            f = seg_dur / max(ar.time_s, 1e-12)
            time_s, energy_j, flops = (ar.time_s * f, ar.energy_j * f,
                                       ar.flops * f)
            parts = {k: v * f for k, v in ar.parts.items()}
        self.ledger.charge_round_segment(flops=flops, time_s=time_s,
                                         energy_j=energy_j, parts=parts,
                                         stream=ar.stream,
                                         model=self.model_name,
                                         device=self.device_name,
                                         final=final)
        ar.charged["time_s"] += time_s
        ar.charged["energy_j"] += energy_j
        ar.charged["flops"] += flops
        for k, v in parts.items():
            ar.charged_parts[k] += v
        ar.segments += 1

    def preempt(self, t: float, scheduler, *,
                preempting_stream: Optional[int] = None) -> None:
        """A higher-priority arrival at time `t` splits the in-flight
        round: train the batches the device completed by `t`, charge the
        elapsed segment to the round's stream, and immediately re-occupy
        the remainder. With the default `preempt_resume_cost_s == 0` a
        split is free and the round's end time is unchanged; a positive
        value models the checkpoint-resume overhead of a real split — the
        device pays it (occupied, non-preemptible) before the remainder
        resumes, the charge lands on the *preempting* stream under
        `t_resume`/`e_resume`, and the round's end shifts by that much.
        Callers gate on `scheduler.can_preempt`."""
        ar = self.active_round
        assert ar is not None, "no active round to preempt"
        if t == ar.seg_start:
            # same-instant arrival: zero occupancy elapsed, so there is no
            # segment to charge; the arrival is served at the existing
            # preemption point
            return
        self._advance_training(ar, ar.charged["time_s"] + (t - ar.seg_start))
        self._charge_segment(ar, t - ar.seg_start, final=False)
        self.ledger.note_preemption(ar.stream)
        ar.preemptions += 1
        remaining = scheduler.preempt(t, self.device_name)
        resume = self.preempt_resume_cost_s
        if resume > 0.0:
            payer = ar.stream if preempting_stream is None \
                else preempting_stream
            self.ledger.charge_probe(
                "resume", resume, resume * self.cost.overhead_power_w,
                stream=payer, model=self.model_name,
                device=self.device_name)
            scheduler.occupy(t, resume, stream=payer,
                             priority=ar.reservation.priority,
                             device=self.device_name)
        ar.reservation = scheduler.occupy(
            t, remaining, stream=ar.stream,
            priority=ar.reservation.priority, preemptible=True,
            device=self.device_name)
        # segment bookkeeping resumes where the round's work does (after
        # any resume overhead), so segment durations stay pure round time
        ar.seg_start = ar.reservation.start

    def finalize_round(self, now: Optional[float] = None
                       ) -> Optional[RoundReport]:
        """Complete the in-flight preemptible round: train the remaining
        batches, charge the final segment (exact remainder), and report.
        No-op (None) when no round is active or, if `now` is given, while
        the reservation has not yet elapsed (``now < end``)."""
        ar = self.active_round
        if ar is None or (now is not None and now < ar.end):
            return None
        # preemption boundaries advance batch by batch (the bucket-1 fused
        # step in compiled mode) — QoS semantics untouched
        while ar.trained < len(ar.batches):
            self._train_batch(ar.step, ar.plan, ar.batches[ar.trained])
            ar.trained += 1
        self._charge_segment(ar, ar.end - ar.seg_start, final=True)
        self.active_round = None
        return RoundReport(iters=len(ar.batches), flops=ar.flops,
                           time_s=ar.time_s, energy_j=ar.energy_j,
                           recompiled=ar.recompiled, start=ar.first_start,
                           end=ar.end, stream=ar.stream,
                           segments=ar.segments, preemptions=ar.preemptions)


# ---------------------------------------------------------------------------
# simulated quantization-aware training (paper §V-G, Table VIII)


def fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor fake quantization to `bits` with a
    straight-through estimator (the gradient passes as if unquantized).
    `torch.round` rounds half to even, as `jnp.round` does."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        return x
    xf = x.float()
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(xf.abs().max(), min=1e-8) / qmax
    q = torch.round(xf / scale) * scale
    return (xf + (q - xf).detach()).to(x.dtype)  # STE


def quantized_model(model, bits: int):
    def loss(params, batch, plan=None):
        qp = tree_map(lambda p: fake_quant(p, bits), params)
        return model.loss(qp, batch, plan)

    def predict(params, batch):
        qp = tree_map(lambda p: fake_quant(p, bits), params)
        return model.predict(qp, batch)

    return dataclasses.replace(model, loss=loss, predict=predict)
