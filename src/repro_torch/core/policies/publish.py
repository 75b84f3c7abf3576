"""Publish policies — *when* a round's trained params reach serving.

Both built-ins make the new params resolvable from the round's device-
occupancy end; they differ in what requests arriving *mid-round* see
(the `visible_params`/`latest_params` seam, DESIGN.md §5):

- `ImmediatePublish` keeps the bug-compat monolith behaviour: publish
  overwrites both sides of the seam, so a mid-round arrival is served by
  the round's freshly trained params. The golden regression pins this
  as the default.
- `RoundEndPublish` is the genuinely-delayed seam the async-publish
  ROADMAP item needs: arrivals before `visible_at` keep resolving the
  *pre-round* params (the paper §III-A "outdated model" effect).

A future async policy can subclass and shift `visible_at` past the round
end to model a real transfer/validation delay.

A copy of `repro.core.policies.publish`.
"""
from __future__ import annotations


class ImmediatePublish:
    """Bug-compat §5 seam: latest == visible (mid-round arrivals get the
    new params)."""

    delayed = False

    def visible_at(self, round_end: float) -> float:
        return round_end


class RoundEndPublish:
    """Genuinely delayed publication: params flip over only at the
    round's occupancy end; earlier arrivals resolve the pre-round
    params."""

    delayed = True

    def visible_at(self, round_end: float) -> float:
        return round_end
