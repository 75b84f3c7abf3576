"""Policy protocols — the orthogonal decisions of EdgeOL's Algorithm 1,
each behind its own small contract (a copy of
`repro.core.policies.base`):

- **when to fine-tune** (`TriggerPolicy` — LazyTune's accumulation
  target, Alg. 1 l.1-2/10-21),
- **what to train** (`FreezePolicy` — SimFreeze's CKA-guided freeze
  plan, Alg. 1 l.4-9/22-26),
- **when the scenario changed** (`DriftPolicy` — energy-score detection
  from served logits + dedicated probe confirmation, §IV-A3),
- **when to publish** trained params to serving (`PublishPolicy` — the
  DESIGN.md §5 visibility seam),
- **whether the device can afford a round now** (`ThrottlePolicy` —
  battery/thermal gating against the `repro_torch.env` device
  environment, DESIGN.md §15; inert unless the device carries an active
  `EnvSpec`, which the port's fleet does not take yet, ROADMAP A.8).

`PolicyStack` (policies/stack.py) composes one of each back into a full
controller. Policies are pure-Python state machines: they *schedule* the
train steps, they never sit inside them.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable


@runtime_checkable
class TriggerPolicy(Protocol):
    """When to launch a fine-tuning round (inter-tuning frequency).

    - `should_trigger(batches_available, staleness=0.0, priority=0)`:
      called on every buffered data batch. `staleness` is the seconds
      since this stream's last round completed; `priority` is the
      stream's QoS priority.
    - `round_finished(iters, val_acc)`: accuracy feedback after a round.
    - `inference_arrived()`: one served request (LazyTune's decay signal).
    - `scenario_changed()`: drift reset.
    - `stats()`: reporting dict.
    """

    def should_trigger(self, batches_available: int, staleness: float = 0.0,
                       priority: int = 0) -> bool: ...

    def round_finished(self, iters: int, val_acc: float) -> None: ...

    def inference_arrived(self) -> None: ...

    def scenario_changed(self) -> None: ...

    def stats(self) -> dict: ...


@runtime_checkable
class FreezePolicy(Protocol):
    """Which layers train (intra-tuning plan). Owns the freeze plan — a
    hashable key of the train-step cache; a changed plan implies a
    recompile charge (the stack counts changes in `plan_changes`).

    - `start_scenario(reference_params, probe_batch)`: offered once per
      scenario for reference-similarity tracking.
    - `round_finished(iters, params)`: post-round freeze pass.
    - `scenario_changed(params, probe_batch)`: unfreeze re-evaluation.
    """

    @property
    def plan(self) -> Any: ...

    plan_changes: int

    def start_scenario(self, reference_params, probe_batch) -> None: ...

    def round_finished(self, iters: int, params) -> None: ...

    def scenario_changed(self, params, probe_batch) -> None: ...

    def stats(self) -> dict: ...


@runtime_checkable
class DriftPolicy(Protocol):
    """When the scenario changed, inferred from serving.

    - `observe(logits) -> bool`: one served request's logits; True flags
      a suspected scenario change (honored in boundaries='detector').
    - `confirm(logits) -> bool`: side-effect-free check for a dedicated
      confirmation probe pass (DESIGN.md §10).
    """

    def observe(self, logits) -> bool: ...

    def confirm(self, logits) -> bool: ...

    def stats(self) -> dict: ...


@runtime_checkable
class ThrottlePolicy(Protocol):
    """Whether to spend a fine-tuning round *now*, given the device's
    physical environment (DESIGN.md §15 — the fifth facet).

    - `allow_round(state, time_s=..., energy_j=...) -> bool`: `state` is
      an `repro_torch.env.EnvState` snapshot; `time_s`/`energy_j` are the
      runtime's modeled estimate of the round about to launch. False
      defers: batches stay buffered and the next arrival re-asks.
    - `stats()`: reporting dict (merged into the stack's stats).
    """

    def allow_round(self, state, *, time_s: float = 0.0,
                    energy_j: float = 0.0) -> bool: ...

    def stats(self) -> dict: ...


@runtime_checkable
class PublishPolicy(Protocol):
    """When a round's freshly trained params become visible to serving.

    - `visible_at(round_end) -> float`: the timestamp requests start
      resolving the new params.
    - `delayed`: False keeps the §5 bug-compat seam (mid-round arrivals
      see the new params: latest == visible); True retains the pre-round
      params for arrivals before `visible_at`.
    """

    delayed: bool

    def visible_at(self, round_end: float) -> float: ...
