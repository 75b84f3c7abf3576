"""InferenceServer — the serving half of the continual-learning loop.

Owns the request path: which params serve a request (the
`visible_params`/`visible_at` seam — resolved at *arrival* time), per-
request accuracy recording, and opt-in **micro-batched serving**:
requests that land within `batch_window` seconds of each other and
resolve to the same params are coalesced into a single forward pass. On
the paper's workloads (many small requests, §V-D sweeps
`inferences_total`) this turns N model invocations into ~N/k while
leaving every recorded per-request accuracy unchanged (a regression test
asserts the equivalence). Controller signals fed by `on_served`
(LazyTune's inference-arrival decay, scenario detection) are delivered at
flush time; the composition root bounds that lag to one window via
`expire`, so stateful controllers may see signal timing shift by at most
`batch_window` timeline seconds relative to per-request serving.

Multi-model serving (ModelPool, DESIGN.md §9): the server holds one
params-visibility lane per model *slot* (`register`/`publish(slot=...)`),
each with its own `visible_params`/`visible_at` pair and model, and
records accuracies per slot (`accs_by_slot`) alongside the per-stream
view. The single-model runtime only ever touches the ``"default"`` slot,
created in the constructor — its request path is byte-identical to the
pre-pool server.

Visibility caveat (kept bug-compatible with the pre-decomposition
monolith; DESIGN.md §5): by default `publish` sets `visible_params` and
`latest_params` to the *same* object, so requests landing mid-round are
served by the round's freshly trained params. `publish(delayed=True)` —
driven by a `RoundEndPublish` policy (repro.core.policies) — retains the
pre-round params as `latest`, so mid-round arrivals genuinely resolve the
outdated model; the request path (`_resolve`, the per-group
params-identity split) is unchanged either way.

`batch_window=0` (the default) reproduces the legacy per-request path
exactly — bit-for-bit, including the shared RNG consumption order.

Counterpart of `repro.runtime.inference`. The compiled path's deferred
serving (`fused`, `drain`) stacks same-(slot, params, shape) groups as
the reference's vmapped dispatch does, but runs each group's `predict` at
the group's own shape, one after another in one CUDA graph per (predict,
concat signature, bucket) on the card (eagerly on the CPU). The groups
are never merged into one larger batch: the CNNs normalize on batch
statistics, per group under `jax.vmap`, and a merged batch would change
the served numbers (and give cuBLAS other shapes than the eager path).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.ledger import DEFAULT_MODEL
from repro_torch.runtime.train_loop import (CapturedCall, as_tensor,
                                            evaluate, forward_program,
                                            on_card, pinned)

# Process-global serving graphs keyed on the eager predict function plus
# (concat signature, stack bucket), so every server over the same model
# shares them.
_STACKS: Dict[Any, CapturedCall] = {}


@dataclass
class _SlotLane:
    """Per-model-slot serving state: the model that answers the slot's
    requests and the params-visibility pair (DESIGN.md §5 seam)."""
    model: Any
    visible_params: Any = None
    visible_at: float = 0.0
    latest_params: Any = None


@dataclass
class _Pending:
    time: float
    request: Dict[str, np.ndarray]
    params: Any  # resolved at submit time (arrival-time visibility policy)
    stream: int = 0  # arrival stream (multi-stream workloads)
    slot: str = DEFAULT_MODEL  # model slot that serves it (ModelPool)
    model: Any = field(default=None, repr=False)


class InferenceServer:
    """Request queue + params-visibility policy + optional micro-batching.

    `on_served(logits, stream) -> bool` is invoked once per request, in
    arrival order, with that request's logits and arrival-stream id (so a
    multi-stream composition root can route the signal to that stream's
    controller). A True return is additionally latched into
    `change_detected` / `poll_change` — a stream-agnostic convenience
    latch for embedders that don't track per-stream state themselves
    (runtime/continual.py latches per stream inside its own callback
    instead).
    """

    def __init__(self, model, *, batch_window: float = 0.0,
                 on_served: Optional[Callable[[np.ndarray, int], bool]] = None,
                 fused: bool = False, tracer=NULL_TRACER,
                 track: Optional[str] = None):
        self.batch_window = float(batch_window)
        self.on_served = on_served
        # observability (DESIGN.md §14): request spans (per-stream latency
        # on the modeled timeline — no device tag, so they never enter
        # device-time reconciliation) plus serve/publish instants tagged
        # with `track`, the owning device's lane. NULL_TRACER = free.
        self.tracer = tracer
        self.track = track
        # compiled hot path (DESIGN.md §12): defer closed groups to a FIFO
        # and execute them in `drain()`, same-shape groups for one (slot,
        # params) in a single call. Recording and `on_served` delivery
        # stay in arrival order; the composition root drains at every
        # event boundary, so controller signal timing matches the eager
        # path.
        self.fused = bool(fused)
        self._ready: List[List[_Pending]] = []
        # model slots: the single-model path lives entirely in "default";
        # a ModelPool runtime registers one extra lane per slot.
        self._lanes: Dict[str, _SlotLane] = {DEFAULT_MODEL: _SlotLane(model)}
        # recorded outcomes (global, plus per-stream and per-slot views)
        self.accs: List[float] = []
        self.accs_by_stream: Dict[int, List[float]] = {}
        self.accs_by_slot: Dict[str, List[float]] = {}
        # recorded serving latency (request arrival -> modeled service
        # time, seconds) per arrival stream; purely observational — the
        # composition root computes it from device occupancy (QoS
        # preemption drives a high-priority request's latency to 0)
        self.latencies_by_stream: Dict[int, List[float]] = {}
        self.served = 0
        self.eval_calls = 0
        self.change_detected = False
        self._queue: List[_Pending] = []

    # ---- slot lifecycle --------------------------------------------------
    def register(self, slot: str, model) -> None:
        """Add a serving lane for model slot `slot` (ModelPool). Re-
        registering an existing slot swaps its model but keeps its
        published params (the pool owns params continuity)."""
        lane = self._lanes.get(slot)
        if lane is None:
            self._lanes[slot] = _SlotLane(model)
        else:
            lane.model = model

    @property
    def model(self):
        """The default slot's model (legacy single-model accessor)."""
        return self._lanes[DEFAULT_MODEL].model

    @property
    def visible_params(self):
        return self._lanes[DEFAULT_MODEL].visible_params

    @property
    def visible_at(self) -> float:
        return self._lanes[DEFAULT_MODEL].visible_at

    @property
    def latest_params(self):
        return self._lanes[DEFAULT_MODEL].latest_params

    # ---- params lifecycle ------------------------------------------------
    def publish(self, params, visible_at: float,
                slot: str = DEFAULT_MODEL, *, delayed: bool = False) -> None:
        """A fine-tuning round finished training `params` for `slot`; they
        become visible once the round's device occupancy ends
        (`visible_at`). Queued requests arrived earlier and must be served
        first, with the params they resolved to at arrival.

        ``delayed=False`` (default) keeps the bug-compat §5 seam: `latest`
        and `visible` are the same object, so requests arriving *before*
        `visible_at` still resolve the new params. ``delayed=True``
        (`RoundEndPublish` and future async publish policies) retains the
        previously visible params as `latest`, so mid-round arrivals
        genuinely serve the pre-round model — the paper §III-A "outdated
        model" effect."""
        self.flush()
        self.drain()
        if self.tracer:
            self.tracer.instant("publish", f"publish/{slot}", visible_at,
                                device=self.track, slot=slot,
                                delayed=delayed)
        lane = self._lanes[slot]
        if delayed and lane.visible_params is not None:
            lane.latest_params = lane.visible_params
        else:
            lane.latest_params = params
        lane.visible_params = params
        lane.visible_at = visible_at

    def _resolve(self, t: float, slot: str = DEFAULT_MODEL):
        lane = self._lanes[slot]
        return lane.visible_params if t >= lane.visible_at \
            else lane.latest_params

    # ---- request path ----------------------------------------------------
    def submit(self, t: float, request: Dict[str, np.ndarray],
               stream: int = 0, latency: float = 0.0,
               slot: str = DEFAULT_MODEL) -> None:
        """Serve (or enqueue) one inference request arriving at time `t` on
        arrival stream `stream`, answered by model slot `slot`. The params
        are resolved *now* — arrival-time visibility — so coalescing never
        changes which model state answers a request. Requests from
        different streams may share a coalesced group (one device, one
        forward pass); accuracy recording and `on_served` routing stay
        per-request. Requests for different *slots* never coalesce (their
        params — and models — differ by construction).

        Coalescing window semantics (pinned by a boundary-value test in
        tests/test_scheduler.py): the window is **closed** — a request
        landing at *exactly* ``first.time + batch_window`` still joins the
        open group; only a strictly later one starts a new group. `expire`
        uses the same closed-boundary rule, so the two paths can never
        disagree about a group's fate.

        `latency` is the caller-computed serving latency (arrival ->
        modeled service time); it is recorded per stream and reported via
        `RunResult.per_stream` percentiles, never acted on here."""
        self.latencies_by_stream.setdefault(stream, []).append(float(latency))
        if self.tracer:
            self.tracer.span("request", f"s{stream}", t, float(latency),
                             stream=stream, slot=slot)
        params = self._resolve(t, slot)
        pending = _Pending(t, request, params, stream, slot,
                           self._lanes[slot].model)
        if self.batch_window <= 0.0:
            self._serve([pending])
            return
        if self._queue and (t - self._queue[0].time > self.batch_window
                            or self._queue[0].params is not params
                            or self._queue[0].slot != slot):
            self.flush()
        self._queue.append(pending)

    def flush(self) -> None:
        if self._queue:
            group, self._queue = self._queue, []
            self._serve(group)

    def expire(self, now: float) -> None:
        """Flush any queued group whose window has elapsed by time `now`.
        The composition root calls this as the timeline advances so a
        coalesced group (and anything latched by its `on_served`
        callbacks, e.g. scenario-change detection) is never deferred past
        its window just because no further request arrived. Boundary rule
        matches `submit` (closed window): at ``now == first.time +
        batch_window`` the group is still open — a request landing at
        that exact instant must coalesce — and it expires only strictly
        after."""
        if self._queue and now - self._queue[0].time > self.batch_window:
            self.flush()

    def poll_change(self) -> bool:
        changed, self.change_detected = self.change_detected, False
        return changed

    # ---- execution -------------------------------------------------------
    def _serve(self, group: List[_Pending]) -> None:
        if self.fused:
            self._ready.append(group)
            return
        if self.tracer:
            self.tracer.instant("serve", f"serve/{group[0].slot}",
                                group[0].time, device=self.track,
                                slot=group[0].slot, requests=len(group))
        self.eval_calls += 1
        if len(group) == 1:
            p = group[0]
            acc, logits = evaluate(p.model, p.params,
                                   as_tensor(p.request, p.model.device))
            self._record(p, acc, logits)
            return
        # one forward pass over the concatenated group, then per-request
        # slicing — identical math to per-request serving because every
        # request in a group shares the same params (and hence model).
        batch = {k: np.concatenate([p.request[k] for p in group])
                 for k in group[0].request}
        _, logits = evaluate(group[0].model, group[0].params,
                             as_tensor(batch, group[0].model.device))
        offset = 0
        for p in group:
            n = len(p.request["labels"])
            lg = logits[offset:offset + n]
            offset += n
            acc = float(np.mean((np.argmax(lg, -1) ==
                                 np.asarray(p.request["labels"]))
                                .astype(np.float32)))
            self._record(p, acc, lg)

    def drain(self) -> None:
        """Execute every deferred group (fused mode; no-op otherwise).

        Groups are concatenated exactly like the eager multi-request path,
        then same-(slot, params, shape) concats are stacked and run in one
        call (`_forward_stack`). Results are recorded strictly in arrival
        order."""
        if not self._ready:
            return
        ready, self._ready = self._ready, []
        concats: List[Dict[str, np.ndarray]] = []
        stacks: Dict[Any, List[int]] = {}
        for gi, group in enumerate(ready):
            if len(group) == 1:
                batch = {k: np.asarray(v) for k, v in group[0].request.items()}
            else:
                batch = {k: np.concatenate([p.request[k] for p in group])
                         for k in group[0].request}
            concats.append(batch)
            sig = tuple(sorted((k, v.shape, str(v.dtype))
                               for k, v in batch.items()))
            key = (group[0].slot, id(group[0].params), sig)
            stacks.setdefault(key, []).append(gi)
        logits_by_group: Dict[int, np.ndarray] = {}
        for (slot, _, sig), idxs in stacks.items():
            first = ready[idxs[0]][0]
            if self.tracer:
                self.tracer.instant("serve", f"vmap/{slot}", first.time,
                                    device=self.track, slot=slot,
                                    groups=len(idxs),
                                    requests=sum(len(ready[i])
                                                 for i in idxs))
            out = self._forward_stack(first.model, first.params, slot, sig,
                                      [concats[i] for i in idxs])
            for row, gi in enumerate(idxs):
                logits_by_group[gi] = out[row]
        for gi, group in enumerate(ready):
            self.eval_calls += 1
            logits = logits_by_group[gi]
            offset = 0
            for p in group:
                n = len(p.request["labels"])
                lg = logits[offset:offset + n]
                offset += n
                acc = float(np.mean((np.argmax(lg, -1) ==
                                     np.asarray(p.request["labels"]))
                                    .astype(np.float32)))
                self._record(p, acc, lg)

    def _forward_stack(self, model, params, slot, sig,
                       concats: List[Dict[str, np.ndarray]]
                       ) -> List[np.ndarray]:
        """Each concat's logits from its own `predict` call at its own
        shape. On the card: one CUDA graph of `bucket` calls, the padding
        calls repeating the first concat and dropped, as the reference
        pads its vmapped stack; on the CPU: the calls themselves. Each
        call runs inside its forward's entry (`forward_program`)."""
        eager = getattr(model.predict, "eager", model.predict)
        device = model.device

        def predict(params, batch):
            with forward_program(eager, batch):
                return eager(params, batch)

        if not on_card(device):
            return [predict(params, as_tensor(c, device)).cpu().numpy()
                    for c in concats]
        n = len(concats)
        bucket = 1 << max(n - 1, 0).bit_length()
        key = (eager, sig, bucket)
        graph = _STACKS.get(key)
        if graph is None:
            graph = _STACKS[key] = CapturedCall(
                lambda args: [predict(args[0], b) for b in args[1]], device)
        padded = concats + [concats[0]] * (bucket - n)
        out = graph((params, [pinned(c) for c in padded]))
        return [t.cpu().numpy() for t in out[:n]]

    def _record(self, p: _Pending, acc: float, logits) -> None:
        self.accs.append(acc)
        self.accs_by_stream.setdefault(p.stream, []).append(acc)
        self.accs_by_slot.setdefault(p.slot, []).append(acc)
        self.served += 1
        if self.on_served is not None and self.on_served(logits, p.stream):
            self.change_detected = True

    # ---- reporting -------------------------------------------------------
    @property
    def avg_acc(self) -> float:
        return float(np.mean(self.accs)) if self.accs else 0.0
