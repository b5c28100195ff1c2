"""Frame arithmetic with explicit i32 wraparound semantics.

The reference stores frames as ``i32`` and its snapshot ring handles both
wraparound directions explicitly (bevy_ggrs src/snapshot/mod.rs:159-163,
tests :369-512).  All frame comparisons in this framework go through the
wrapping helpers below so that a session running long enough to wrap i32
keeps working.  ``NULL_FRAME = -1`` matches the ggrs sentinel (the initial
``ConfirmedFrameCount`` is -1, bevy_ggrs src/snapshot/mod.rs:79-86).
"""

from __future__ import annotations

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1

#: Sentinel for "no frame" (matches ggrs NULL_FRAME; initial confirmed frame).
NULL_FRAME = -1


def wrap_i32(x: int) -> int:
    """Wrap a python int into i32 two's-complement range."""
    return ((x + 2**31) % 2**32) - 2**31


def frame_add(a: int, n: int) -> int:
    """a + n with i32 wraparound."""
    return wrap_i32(a + n)


def frame_diff(a: int, b: int) -> int:
    """Wrapping signed distance a - b.  Positive => a is newer than b."""
    return wrap_i32(a - b)


def frame_lt(a: int, b: int) -> bool:
    """True if a is older than b under wrapping order."""
    return frame_diff(a, b) < 0


def frame_le(a: int, b: int) -> bool:
    """a <= b under wrapping order."""
    return frame_diff(a, b) <= 0


def frame_gt(a: int, b: int) -> bool:
    """a > b under wrapping order."""
    return frame_diff(a, b) > 0


def frame_ge(a: int, b: int) -> bool:
    """a >= b under wrapping order."""
    return frame_diff(a, b) >= 0


def frame_max(a: int, b: int) -> int:
    """Newer of a, b under wrapping order."""
    return a if frame_ge(a, b) else b


def frame_min(a: int, b: int) -> int:
    """Older of a, b under wrapping order."""
    return a if frame_le(a, b) else b
