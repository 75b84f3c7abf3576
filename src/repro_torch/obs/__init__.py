"""Observability seams of the port (counterpart of `repro.obs`): the
disabled tracer every hot path guards on, and the logger tree. The live
tracer, metrics and sinks come with a later slice."""
from repro_torch.obs.log import get_logger
from repro_torch.obs.trace import NULL_TRACER, NullTracer

__all__ = ["NULL_TRACER", "NullTracer", "get_logger"]
