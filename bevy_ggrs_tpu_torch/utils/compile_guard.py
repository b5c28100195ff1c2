"""Steady-state recompile sentinel.

Port of ``bevy_ggrs_tpu/utils/compile_guard.py``.  In eager torch a
"compile" is the first dispatch of a program variant — a ``(kind, depth)``
of the runner, a ``(kind, bucket)`` of the wave executor — which those
sites already time (``runner._note_compile``, the executor's
``_dispatch``).  The guard keeps the JAX package's contract that the
variant set is closed after warm-up: a new variant in steady state is a
new code path (and, once the variants are captured as CUDA graphs, a new
capture), so it is a hazard worth failing on.

Usage mirrors the ``BGT_SANITIZE`` transfer sanitizer:

* ``BGT_COMPILE_GUARD=1`` (or :func:`set_compile_guard`) enables the
  guard process-wide; it starts **disarmed** so warmup compiles pass.
* After warmup, call :meth:`GgrsRunner.arm_compile_guard` /
  :meth:`BatchedRunner.arm_compile_guard` (or :meth:`CompileGuard.arm`
  directly).  From that point any first dispatch seen by those sites
  increments ``recompiles_steady_total{owner}`` and raises
  :class:`RecompileError` naming the owner and program kind.

The JAX package's ``arm(watch_jax=True)`` listener, which trips on XLA
compiles outside the hooked sites, has no counterpart: eager torch has no
compile event to listen to.

Disabled (the default), the whole feature is one module-global load and
attribute check per first dispatch — steady-state ticks never reach the
hook at all.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .. import telemetry

_ENV = "BGT_COMPILE_GUARD"

_HELP = (
    "program compiles observed after the BGT_COMPILE_GUARD sentinel was "
    "armed (steady state; a healthy run stays at 0)"
)


class RecompileError(RuntimeError):
    """A program variant first dispatched while the guard was armed."""

    def __init__(self, owner: str, kind: str, ms: float = 0.0):
        self.owner = owner
        self.kind = kind
        self.ms = ms
        super().__init__(
            f"steady-state recompile: owner={owner!r} kind={kind!r} "
            f"({ms:.1f}ms) — a post-warmup program variant means a "
            "shape-stability hazard (the hazards BGT070/BGT071 flag in the "
            "JAX package, docs/static-analysis.md); every such first "
            "dispatch is a frame-time cliff the tick budget cannot absorb"
        )


class CompileGuard:
    """Post-warmup compile sentinel (module singleton; see :func:`guard`)."""

    __slots__ = ("enabled", "armed", "steady_compiles")

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get(_ENV, "0") not in ("", "0", "false")
        self.enabled = bool(enabled)
        self.armed = False
        # (owner, kind, ms) of every armed-state compile observed —
        # retained even though _trip raises, for post-mortem asserts
        self.steady_compiles: List[Tuple[str, str, float]] = []

    def arm(self) -> bool:
        """Declare warmup over.  No-op (returns False) unless the guard
        is enabled, so engine code may call this unconditionally."""
        if not self.enabled:
            return False
        self.armed = True
        return True

    def disarm(self) -> None:
        self.armed = False

    def notify(self, owner: str, kind: str, ms: float = 0.0) -> None:
        """Hook for compile-accounting sites; raises when armed."""
        if self.armed:
            self._trip(owner, str(kind), ms)

    def _trip(self, owner: str, kind: str, ms: float) -> None:
        self.steady_compiles.append((owner, kind, ms))
        telemetry.count("recompiles_steady_total", help=_HELP, owner=owner)
        raise RecompileError(owner, kind, ms)


_GUARD = CompileGuard()


def guard() -> CompileGuard:
    """The process-wide guard (the instance engine hooks consult)."""
    return _GUARD


def set_compile_guard(enabled: bool) -> CompileGuard:
    """Swap in a fresh guard (tests/bench): enabled as given, disarmed,
    empty history.  Returns the new singleton."""
    global _GUARD
    _GUARD = CompileGuard(enabled=enabled)
    return _GUARD


def notify(owner: str, kind: str, ms: float = 0.0) -> None:
    """Module-level fast path for engine hooks: one global load plus one
    attribute check when disarmed."""
    g = _GUARD
    if g.armed:
        g._trip(owner, str(kind), ms)
