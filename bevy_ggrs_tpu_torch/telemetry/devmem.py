"""Device-memory accounting — who owns the bytes resident on the device.

Port of ``bevy_ggrs_tpu/telemetry/devmem.py``: the owner rows are the same
host dicts; :func:`census` reconciles them against torch's allocator
instead of ``jax.live_arrays()``.

The runners keep several long-lived device (and pinned-host staging)
allocations alive between ticks: the snapshot ring, the megastep device
ring, the packed/unpacked staging buffers, the batched resident worlds and
the speculation branch cache.  None of them show up in any metric, so "why
is HBM full" has meant reading allocation sites.  This module is the
registry that answers it:

- every long-lived allocation site calls :func:`note` with an **owner**
  string and its current byte count (absolute, not a delta — re-noting
  after a reallocation or a ring push replaces the old figure);
- owners are namespaced per runner instance via :func:`scope`
  (``solo0/snapshot_ring``, ``batched0/worlds``, ...) and garbage-collected
  with the instance via :func:`forget_scope` (the runners register a
  ``weakref.finalize``), so a long run never accumulates stale rows;
- while telemetry is enabled every note also lands on the
  ``device_resident_bytes{owner}`` gauge; the plain-dict registry itself is
  ALWAYS on — one dict store per note — so :func:`snapshot` works even
  when metrics never were;
- :func:`census` reconciles the registry against the live tensors —
  registered-but-freed or live-but-unregistered bytes are the drift the
  reconciliation bounds.

The byte counts come from ``utils/mem.py`` at the sites that allocate: a
host integer each, so noting reads no tensor and syncs nothing.

``telemetry.summary()`` carries :func:`snapshot` + :func:`total` as the
live-residency line, and the Chrome-trace export (:mod:`.trace`) emits
:func:`total` as a counter track per tick.
"""

from __future__ import annotations

from typing import Dict

from . import metrics as _metrics

_BUFFERS: Dict[str, int] = {}
_SCOPE_COUNTS: Dict[str, int] = {}

_GAUGE_HELP = (
    "bytes of long-lived device/staging memory per owning allocation site"
)

# generation-checked gauge-family + label-key cache (the BoundMetric idiom):
# note() runs inside runners' per-tick ring/staging updates, so it must not
# re-pay the family lookup and label-tuple build on every call.
_gauge_gen = -1
_gauge = None
_owner_keys: Dict[str, tuple] = {}


def _gauge_key(reg, owner: str):
    global _gauge_gen, _gauge
    if _gauge_gen != reg.generation:
        _gauge = reg.gauge("device_resident_bytes", _GAUGE_HELP)
        _owner_keys.clear()
        _gauge_gen = reg.generation
    key = _owner_keys.get(owner)
    if key is None:
        key = _owner_keys[owner] = _metrics._label_key({"owner": owner})
    return _gauge, key


def scope(prefix: str) -> str:
    """A unique owner namespace for one runner instance (``solo0``,
    ``solo1``, ...).  Pair with ``weakref.finalize(self, forget_scope, tag)``
    so the rows die with the instance."""
    n = _SCOPE_COUNTS.get(prefix, 0)
    _SCOPE_COUNTS[prefix] = n + 1
    return f"{prefix}{n}"


def note(owner: str, nbytes: int) -> None:
    """Record ``owner``'s current resident byte count (absolute).

    Always updates the registry dict; mirrors to the
    ``device_resident_bytes`` gauge only while telemetry is enabled, so a
    note from a hot path costs one dict store when telemetry is off."""
    nbytes = int(nbytes)
    _BUFFERS[owner] = nbytes
    reg = _metrics.registry()
    if reg.enabled:
        gauge, key = _gauge_key(reg, owner)
        gauge.set_key(key, nbytes)


def forget(owner: str) -> None:
    """Drop one owner's row (its buffers were freed); zeroes the gauge."""
    _BUFFERS.pop(owner, None)
    reg = _metrics.registry()
    if reg.enabled:
        gauge, key = _gauge_key(reg, owner)
        gauge.set_key(key, 0)


def forget_scope(tag: str) -> None:
    """Drop every owner under ``tag/`` — the runner-finalizer cleanup."""
    for owner in [o for o in _BUFFERS if o == tag or o.startswith(tag + "/")]:
        forget(owner)


def snapshot() -> Dict[str, int]:
    """``{owner: bytes}`` — the current registry contents."""
    return dict(_BUFFERS)


def total() -> int:
    """Sum over all owners (the trace export's counter-track value)."""
    return sum(_BUFFERS.values())


def reset() -> None:
    """Drop every row and scope counter (test isolation; wired into
    ``telemetry.reset()``)."""
    _BUFFERS.clear()
    _SCOPE_COUNTS.clear()


def _cpu_storage_bytes() -> tuple:
    """Bytes and count of the distinct CPU storages under the live tensors
    the garbage collector tracks (every ``torch.Tensor`` is tracked)."""
    import gc
    import warnings

    import torch

    storages = {}
    with warnings.catch_warnings():
        # touching some module objects' class raises deprecation warnings
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.device.type == "cpu":
                st = obj.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values()), len(storages)


def census(strict: bool = False, device=None) -> dict:
    """Reconcile the registry against the live tensors.

    Returns ``{"registered_bytes", "live_bytes", "live_arrays",
    "unregistered_bytes", "owners"}``.

    - With CUDA initialised (or ``device`` a CUDA device),
      ``live_bytes`` is ``torch.cuda.memory_allocated(device)`` (every
      device when ``device`` is None): every live tensor on the card,
      transients in flight included, as ``jax.live_arrays()`` counts them
      in the JAX package.  ``live_arrays`` is None (the allocator keeps no
      tensor count).
    - Otherwise (``device`` the CPU, or no card) ``live_bytes`` is the sum
      of the distinct storages of the live CPU tensors the garbage
      collector finds, and ``live_arrays`` their count.

    ``unregistered_bytes`` (live minus registered, floored at 0) is an
    upper bound on what the owners table is missing, not an exact leak.

    ``strict=True`` additionally asserts the registry is not STALE: every
    registered byte must be backed by a live tensor, so
    ``registered_bytes > live_bytes`` proves some owner dropped its buffers
    without re-noting and raises ``RuntimeError`` naming the owners."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available() and torch.cuda.is_initialized():
        live_bytes = sum(torch.cuda.memory_allocated(i)
                         for i in range(torch.cuda.device_count()))
        n_live = None
    elif dev is not None and dev.type == "cuda":
        live_bytes = torch.cuda.memory_allocated(dev)
        n_live = None
    else:
        live_bytes, n_live = _cpu_storage_bytes()
    registered = total()
    if strict and registered > live_bytes:
        owners = ", ".join(
            f"{k}={v}" for k, v in sorted(_BUFFERS.items()) if v > 0
        )
        raise RuntimeError(
            f"devmem registry is stale: registered_bytes={registered} > "
            f"live_bytes={live_bytes} — an owner dropped device buffers "
            f"without re-noting (owners: {owners})"
        )
    return {
        "registered_bytes": registered,
        "live_bytes": live_bytes,
        "live_arrays": n_live,
        "unregistered_bytes": max(live_bytes - registered, 0),
        "owners": snapshot(),
    }
