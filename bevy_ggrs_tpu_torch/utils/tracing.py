"""Lightweight span tracing for the host-side runner.

Port of ``bevy_ggrs_tpu/utils/tracing.py``.  The reference plugin wraps
request handling and each schedule in tracing spans ("HandleRequests",
"SaveWorld", "LoadWorld", "AdvanceWorld") and relies on the host engine's
tracing backend.  Here ``span`` feeds two sinks: stdlib logging (at DEBUG
level) and the telemetry timeline when enabled (``set_span_sink``; the
timeline then carries the spans into ``telemetry.chrome_trace()`` as
Perfetto slices).  ``torch.profiler`` covers the device side; a span adds
no NVTX range or profiler hook.

Phase attribution lives in :mod:`..telemetry.phases` and span export in
:mod:`..telemetry.trace`.  With no sink installed and DEBUG logging off, a
span is one shared null context: the runner's tick is bound by host time,
so a span that records nothing must cost next to nothing.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Optional

logger = logging.getLogger("bevy_ggrs_tpu_torch")

_SPAN_SINK: Optional[Callable[[str, float, float], None]] = None
_NULL = contextlib.nullcontext()


def set_span_sink(sink: Optional[Callable[[str, float, float], None]]) -> None:
    """Install a callback fed every completed span as ``(name, t0, t1)``.

    The telemetry timeline (``telemetry.enable()``) installs its sink here;
    None uninstalls.  The sink runs inside the span's ``finally`` — keep it
    cheap and non-raising."""
    global _SPAN_SINK
    _SPAN_SINK = sink


@contextlib.contextmanager
def _recording_span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        sink = _SPAN_SINK
        if sink is not None:
            sink(name, t0, t1)
        logger.debug("span %s: %.3f ms", name, (t1 - t0) * 1e3)


def span(name: str):
    """Context manager recording a named wall-clock span (a null context
    when nothing would record it)."""
    if _SPAN_SINK is None and not logger.isEnabledFor(logging.DEBUG):
        return _NULL
    return _recording_span(name)
