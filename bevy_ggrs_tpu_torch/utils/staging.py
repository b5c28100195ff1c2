"""Pinned host staging for host-to-device uploads, fenced by CUDA events.

Port of ``bevy_ggrs_tpu/utils/staging.py``.  A runner rewrites its staging
buffers every dispatch, and an upload from a buffer is asynchronous: if the
host rewrote the buffer before the copy had read it, the card would see
the next tick's bytes.  The JAX package blocks on each transfer; here the
copy is queued with ``non_blocking=True`` from pinned memory and a CUDA
event recorded after it fences the buffer's reuse:

- :class:`StagingBuffer` is one pinned host buffer.  :meth:`~StagingBuffer.
  acquire` hands it out for rewriting once its last upload has landed (an
  ``event.query()``; it waits on the event only if the copy is still in
  flight, counted in ``deferred_blocks``), and :meth:`~StagingBuffer.
  commit` uploads a view of it.
- The copy runs on a side stream that only uploads.  Queued on the compute
  stream it would wait behind the resim in flight, and fencing the
  rewrite on its event would bring back the wait the pipeline removes.
  The compute stream waits on the event before it reads the upload, and
  ``record_stream`` keeps the allocator from reusing the uploaded tensor's
  memory until the compute stream is done with it.
- :class:`StagingQueue` rotates ``depth >= 2`` such buffers, so a buffer
  is rewritten only ``depth`` acquires after its upload started.

On the CPU (``device="cpu"``, the tests) there is no pinned memory and no
event: the host buffer is plain numpy and a commit returns a copy of it.
That path exists only for CPU worlds; a CUDA device always takes the
pinned path, and a failure to pin or record raises.

``BGT_SANITIZE=1`` arms the :class:`TransferSanitizer`, with the JAX
package's rules: commits stamp their backing host buffer, a landed upload
(an acquire) clears the stamp, and every rewrite funnel (``pack_prefix``,
the runner's row stagers) asks first, so a rewrite of a buffer whose
upload is still in flight raises :class:`TransferRaceError` at the racing
write.  A world handed to a donating resim is recorded with
:meth:`TransferSanitizer.donate`; handing it to a dispatch again raises
(:meth:`~TransferSanitizer.guard_donated`).  Disarmed (the default),
every hook is one attribute check.  A violation also counts on the
``sanitizer_violations_total{rule}`` family while telemetry is on, and
every commit notes its bytes as the ``staging/last_commit`` devmem row."""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from ..telemetry import devmem
from ..telemetry.metrics import registry
from .device import DeviceLike, resolve_device


class TransferRaceError(RuntimeError):
    """A staging buffer or donated world was reused before its transfer
    landed, or after it was donated."""


class TransferSanitizer:
    """Version-stamp ledger for in-flight host-to-device transfers.

    The ledger keys on ``id()`` of the *backing* buffer (``_base`` walks
    the numpy ``.base`` chain, so committing ``buf[:k]`` and rewriting
    ``buf`` meet on the same key).  Donated worlds live in a separate
    insertion-ordered table trimmed to the newest ``_DONATED_CAP``
    entries; the table holds each donated object, so its ``id()`` cannot
    be recycled by a new object while the entry lives.

    Every public method returns at once unless ``self.enabled``."""

    _DONATED_CAP = 64

    def __init__(self, enabled=None):
        if enabled is None:
            enabled = os.environ.get("BGT_SANITIZE", "") == "1"
        self.enabled = bool(enabled)
        self.violations = 0
        self.violations_by_rule: Dict[str, int] = {}
        self._versions = 0
        self._inflight = {}  # id(base) -> (version, note)
        self._donated = {}  # id(obj) -> (obj, note), insertion-ordered

    @staticmethod
    def _base(buf):
        while getattr(buf, "base", None) is not None:
            buf = buf.base
        return buf

    def _violate(self, rule, msg):
        self.violations += 1
        self.violations_by_rule[rule] = self.violations_by_rule.get(rule, 0) + 1
        reg = registry()
        if reg.enabled:
            reg.counter(
                "sanitizer_violations_total",
                "transfer races caught by the BGT_SANITIZE runtime "
                "sanitizer, by rule",
            ).inc(rule=rule)
        raise TransferRaceError(msg)

    def begin(self, buf, note=""):
        """A transfer of ``buf`` is now in flight: stamp its backing."""
        if not self.enabled:
            return
        self._versions += 1
        self._inflight[id(self._base(buf))] = (self._versions, note)

    def land(self, buf):
        """The transfer consuming ``buf`` has landed: clear the stamp."""
        if not self.enabled:
            return
        self._inflight.pop(id(self._base(buf)), None)

    def guard_write(self, buf, site=""):
        """Called by every staging rewrite funnel before touching ``buf``."""
        if not self.enabled:
            return
        entry = self._inflight.get(id(self._base(buf)))
        if entry is not None:
            version, note = entry
            self._violate(
                "staging_reuse",
                f"staging buffer rewrite at {site or '<unknown>'} while "
                f"upload #{version}{f' ({note})' if note else ''} is still "
                "in flight — acquire() the buffer before rewriting it",
            )

    def donate(self, arr, note=""):
        """``arr`` was donated to a resim: it is dead until its owner
        rebinds it."""
        if not self.enabled or arr is None:
            return
        self._donated[id(arr)] = (arr, note)
        while len(self._donated) > self._DONATED_CAP:
            self._donated.pop(next(iter(self._donated)))

    def guard_donated(self, arr, site=""):
        """Called before handing ``arr`` back into a dispatch."""
        if not self.enabled or arr is None:
            return
        entry = self._donated.get(id(arr))
        if entry is not None and entry[0] is arr:
            note = entry[1]
            self._violate(
                "donated_reuse",
                f"donated world reused at {site or '<unknown>'}"
                f"{f' ({note})' if note else ''} — a donating resim consumed "
                "it; use the world the call returned",
            )

    def undonate(self, arr):
        """``arr``'s slot was legitimately rebound: forget the donation."""
        if not self.enabled or arr is None:
            return
        self._donated.pop(id(arr), None)

    def reset(self):
        """Forget every stamp and donation, and zero the violation counts."""
        self._inflight.clear()
        self._donated.clear()
        self.violations = 0
        self.violations_by_rule.clear()


_SANITIZER = TransferSanitizer()


def sanitizer() -> TransferSanitizer:
    """The process sanitizer — callers fetch it per use (not cache it) so
    :func:`set_sanitize` swaps take effect."""
    return _SANITIZER


def set_sanitize(enabled: bool) -> TransferSanitizer:
    """Swap in a fresh sanitizer (test hook; mirrors ``BGT_SANITIZE=1``)."""
    global _SANITIZER
    _SANITIZER = TransferSanitizer(enabled=enabled)
    return _SANITIZER


_COMMIT_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def commit(buf, device: DeviceLike = None) -> torch.Tensor:
    """Upload ``buf`` (a numpy array or host tensor) and wait for the copy
    only, the JAX package's ``commit``: on return the host may rewrite
    ``buf``.  On CUDA the copy is queued without blocking on a side stream
    that only uploads, and the host waits on an event recorded after it,
    not on the compute stream's work; on the CPU it is a plain copy.  No
    runner path calls it (they commit through :class:`StagingQueue`, which
    never waits here)."""
    devmem.note("staging/last_commit", getattr(buf, "nbytes", 0))
    san = _SANITIZER
    san.guard_write(buf, "staging.commit")  # a racing earlier upload of buf
    san.begin(buf, "staging.commit")
    src = torch.from_numpy(np.ascontiguousarray(buf)) if isinstance(buf, np.ndarray) else buf
    dev = resolve_device(device)
    if dev.type != "cuda":
        out = src.to(dev, copy=True)
    else:
        stream = _COMMIT_STREAMS.get(dev)
        if stream is None:
            stream = _COMMIT_STREAMS[dev] = torch.cuda.Stream(dev)
        event = torch.cuda.Event()
        with torch.cuda.stream(stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=dev)
            out.copy_(src, non_blocking=True)
            event.record(stream)
        event.synchronize()
        out.record_stream(torch.cuda.current_stream(dev))
    san.land(buf)
    return out


class StagingBuffer:
    """One host staging buffer whose reuse is fenced by the event of its
    last upload (see module docstring).

    ``make_buffer`` returns the numpy buffer; on a CUDA device it is
    copied into pinned memory once, and :attr:`host` is a numpy view of
    that pinned tensor.  ``stream`` is the side stream the uploads run on
    (one is made if none is given)."""

    def __init__(self, make_buffer: Callable[[], np.ndarray],
                 device: DeviceLike = None, stream=None):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        buf = np.ascontiguousarray(make_buffer())
        if self.cuda:
            self._pinned = torch.from_numpy(buf).pin_memory()
            self.host = self._pinned.numpy()
            self.stream = stream if stream is not None else torch.cuda.Stream(self.device)
            self._event = torch.cuda.Event()
        else:
            self._pinned = None
            self.host = buf
            self.stream = None
            self._event = None
        self._lanes: dict = {}  # other devices' (stream, event)
        self._inflight = False
        self.deferred_blocks = 0  # acquires that waited on the last upload
        self.landed_free = 0  # acquires whose last upload had landed

    @property
    def nbytes(self) -> int:
        return self.host.nbytes

    def acquire(self) -> np.ndarray:
        """The host buffer, safe to rewrite: waits for its last upload iff
        that has not landed yet (every device's, after uploads of blocks to
        several devices)."""
        if self._inflight:
            events = [self._event] + [ev for _st, ev in self._lanes.values()]
            if self._event is None or all(ev.query() for ev in events):
                self.landed_free += 1
            else:
                self.deferred_blocks += 1
                for ev in events:
                    ev.synchronize()
            self._inflight = False
        # either branch proved the old upload landed: clear its stamp so the
        # caller's rewrite passes the sanitizer
        _SANITIZER.land(self.host)
        return self.host

    def commit(self, view: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
        """Start the upload of ``view`` (a view of :attr:`host` returned by
        the matching :meth:`acquire`) and return the device tensor; the
        compute stream is ordered after the copy, the host is not.
        ``device`` sends it to another card than the buffer's (each shard
        of a lobby-sharded wave takes its block of one pinned buffer, on a
        stream of its own device)."""
        # the upload's device copy stays resident until the dispatch reads it
        devmem.note("staging/last_commit", view.nbytes)
        _SANITIZER.begin(view, "StagingBuffer.commit")
        self._inflight = True
        src = torch.from_numpy(view)
        dev_ = self.device if device is None else torch.device(device)
        if dev_.type != "cuda":
            return src.clone()
        if dev_ == self.device:
            stream, event = self.stream, self._event
        else:
            if dev_ not in self._lanes:
                self._lanes[dev_] = (torch.cuda.Stream(dev_), torch.cuda.Event())
            stream, event = self._lanes[dev_]
        compute = torch.cuda.current_stream(dev_)
        with torch.cuda.stream(stream):
            dev = torch.empty(src.shape, dtype=src.dtype, device=dev_)
            dev.copy_(src, non_blocking=True)
            event.record(stream)
        compute.wait_event(event)
        dev.record_stream(compute)
        return dev


class StagingQueue:
    """Device-resident input queue: rotate ``depth`` staging buffers so a
    buffer's upload has ``depth - 1`` further dispatches of host work to
    land before the buffer is rewritten.  :meth:`acquire` waits only when
    it has not (``deferred_blocks`` against ``landed_free``); the census
    stays one upload per commit.  The buffers share one side stream."""

    def __init__(self, make_buffer: Callable[[], np.ndarray], depth: int = 2,
                 device: DeviceLike = None):
        if depth < 2:
            raise ValueError("StagingQueue needs depth >= 2 buffers")
        first = StagingBuffer(make_buffer, device)
        self.buffers = [first] + [StagingBuffer(make_buffer, device, first.stream)
                                  for _ in range(depth - 1)]
        self._idx = 0

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.buffers)

    @property
    def deferred_blocks(self) -> int:
        return sum(b.deferred_blocks for b in self.buffers)

    @property
    def landed_free(self) -> int:
        return sum(b.landed_free for b in self.buffers)

    def acquire(self) -> np.ndarray:
        """Next host buffer in rotation, safe to rewrite."""
        self._idx = (self._idx + 1) % len(self.buffers)
        return self.buffers[self._idx].acquire()

    def commit(self, view: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
        """Start the upload of ``view`` (a view of the buffer returned by
        the matching :meth:`acquire`) to the queue's device, or to
        ``device``; returns the device tensor."""
        return self.buffers[self._idx].commit(view, device)

