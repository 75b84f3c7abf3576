"""Observability seams of the port (counterpart of `repro.obs`): the
disabled tracer every hot path guards on, the logger tree and the
`TelemetrySpec` a `RuntimeConfig` carries. The live tracer, metrics and
sinks come with ROADMAP A.8."""
from repro_torch.obs.log import get_logger
from repro_torch.obs.spec import TelemetrySpec
from repro_torch.obs.trace import NULL_TRACER, NullTracer

__all__ = ["NULL_TRACER", "NullTracer", "TelemetrySpec", "get_logger"]
