"""Host-side helpers: frame arithmetic, device selection, tensor trees,
staging, span tracing.  Exports the JAX package's 15 names."""

from .frames import (
    I32_MAX,
    I32_MIN,
    NULL_FRAME,
    frame_add,
    frame_diff,
    frame_ge,
    frame_gt,
    frame_le,
    frame_lt,
    frame_max,
    frame_min,
    wrap_i32,
)
from .tracing import get_trace_events, span, trace_log

__all__ = [
    "NULL_FRAME",
    "I32_MIN",
    "I32_MAX",
    "wrap_i32",
    "frame_add",
    "frame_diff",
    "frame_lt",
    "frame_le",
    "frame_gt",
    "frame_ge",
    "frame_max",
    "frame_min",
    "span",
    "trace_log",
    "get_trace_events",
]
