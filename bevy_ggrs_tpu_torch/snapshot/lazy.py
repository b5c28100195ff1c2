"""Lazy device->host checksum readback and lazy frame slices.

Port of ``bevy_ggrs_tpu/snapshot/lazy.py`` (the solo runner's part).  A
resim's checksums are one ``[k, 2]`` tensor (hi, lo; u32 in int64) on the
world's device, and a session needs only some of its rows, one at a time:
SyncTest at its comparison cadence, a P2P session every desync-detection
interval frame once it is confirmed.

- :class:`BatchChecks` wraps one resim's ``[k, 2]`` checksums and enters a
  process-wide pending set.  :meth:`~BatchChecks.start_async` starts ONE
  non-blocking copy of all k rows into pinned host memory and records a
  CUDA event after it; until ``event.query()`` is true non-blocking reads
  return None, and none of them waits for the card.  A forcing read waits
  for that copy (or makes a blocking one): a *forced* readback.  On CPU
  tensors the rows are host memory already, and either read takes them at
  once.
- :class:`ChecksumRef` is one row of a batch and the provider the sessions
  consume: calling it forces the value, :meth:`ChecksumRef.peek` is the
  non-blocking read that ``P2PSession._resolve_checksum`` retries each poll.
- :class:`ReadbackStats` counts the reads of one owner (a runner): peeks
  that returned None, reads that found the copy landed, forced reads.
  Telemetry mirrors the process's reads (as the JAX package's
  ``_note_readback`` does): ``readback_harvested_total``,
  ``readback_forced_total`` and ``host_blocked_seconds`` while it is on,
  and a ``forced_readback`` flight-recorder entry per forcing read always
  (forced reads are the pipeline's degrade signal).
- :class:`ReadbackQueue` is the pipelined runner's side of it: ``start``
  at dispatch, ``harvest`` of every landed copy at the top of each tick,
  ``flush`` (a blocking pull of everything pending) at flush points.  The
  pending set is the queue, so one queue (:func:`readback_queue`) serves
  every runner in the process, as in the JAX package.
- :class:`LazySlice` defers the per-frame slice of a stacked resim output:
  the snapshot ring stores ``(stacked, i)`` handles; :func:`tree_index`
  is the slice as views (what a rollback loads), and
  :meth:`LazySlice.materialize` a device clone that no longer pins the
  stacked buffer (the ring's memory guard).  ``i`` may be a
  ``(lobby, frame)`` pair into a wave's ``[M, k, ...]`` stack.

The batched runner's tail (``batch_runner.py``): :func:`plan_row_gather`
groups a wave's ``(target lane, LazySlice)`` rows by the stacked buffer
that backs them, and :func:`fused_load_rows` / :func:`fused_gather_rows`
serve the whole wave with one gather per source buffer and leaf, never
one per lobby.  Their row indices ride ONE upload per call from pinned
staging (:class:`RowIndexStager`), so a load wave neither waits for the
card nor copies from pageable memory.  Nothing is written in place: the
resident world's rows are replaced out of place (``index_copy``), since
ring entries may share its tensors.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import flight as _flight
from ..telemetry.metrics import registry as _registry
from ..utils.staging import StagingQueue
from ..utils.tree import tree_flatten, tree_map, tree_unflatten

_REG = _registry()


def _note_readback(harvested: int = 0, forced: int = 0, blocked_s: float = 0.0) -> None:
    """Telemetry of checksum reads: the registry families while telemetry
    is on, the flight entry of a forcing read always."""
    if _REG.enabled:
        if harvested:
            _REG.counter("readback_harvested_total",
                         "checksum readbacks collected without blocking "
                         "(async copy had landed)").inc(harvested)
        if forced:
            _REG.counter("readback_forced_total",
                         "checksum readbacks that blocked the host "
                         "(flush points / sync mode)").inc(forced)
        if blocked_s:
            _REG.counter("host_blocked_seconds",
                         "host seconds spent blocked in device->host "
                         "checksum pulls").inc(blocked_s)
    if forced:
        _flight._FLIGHT.record("forced_readback", n=forced,
                               blocked_ms=round(blocked_s * 1e3, 3))


@dataclass
class ReadbackStats:
    """Checksum reads of one owner since it was made."""

    peek_misses: int = 0  # non-blocking reads that returned None
    harvested: int = 0  # reads that found the rows on the host, no wait
    forced: int = 0  # reads that waited for the card


class BatchChecks:
    """One resim's ``[k, 2]`` checksums, read back to the host once (see
    module docstring)."""

    _pending: "weakref.WeakSet[BatchChecks]" = weakref.WeakSet()

    __slots__ = ("_dev", "_host", "_started", "_pinned", "_event", "_stats",
                 "__weakref__")

    def __init__(self, dev: torch.Tensor, stats: Optional[ReadbackStats] = None):
        self._dev: Optional[torch.Tensor] = dev
        self._host: Optional[List[List[int]]] = None
        self._started = False  # the copy was started (CPU rows: "landed")
        self._pinned: Optional[torch.Tensor] = None
        self._event = None
        self._stats = stats if stats is not None else ReadbackStats()
        BatchChecks._pending.add(self)

    def _adopt(self, rows: torch.Tensor) -> List[List[int]]:
        self._host = rows.tolist()
        self._dev = self._pinned = self._event = None
        BatchChecks._pending.discard(self)
        return self._host

    def start_async(self) -> None:
        """Start the one non-blocking device->host copy of the rows (a
        no-op once started or read; CPU rows need no copy)."""
        if self._host is not None or self._started:
            return
        self._started = True
        if self._dev.device.type != "cuda":
            return
        self._pinned = torch.empty(self._dev.shape, dtype=self._dev.dtype,
                                   pin_memory=True)
        self._pinned.copy_(self._dev, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def _landed(self) -> bool:
        """True when the started copy has landed: reading the rows would
        not wait for the card.  A batch never started has not landed, so a
        read of it counts as forced, on the CPU too."""
        if not self._started:
            return False
        return self._event is None or self._event.query()

    def _harvest(self) -> List[List[int]]:
        self._stats.harvested += 1
        if _REG.enabled:
            _note_readback(harvested=1)
        return self._adopt(self._pinned if self._event is not None else self._dev)

    def try_host(self) -> Optional[List[List[int]]]:
        """The ``[k, 2]`` rows if they can be had without waiting for the
        card, else None (starting the copy on the first call)."""
        if self._host is not None:
            return self._host
        self.start_async()
        if not self._landed():
            self._stats.peek_misses += 1
            return None
        return self._harvest()

    def host(self) -> List[List[int]]:
        """The ``[k, 2]`` rows, waiting for the card if they have not
        landed (a forced readback)."""
        if self._host is not None:
            return self._host
        if self._landed():
            return self._harvest()
        t0 = time.perf_counter()
        rows = self._force()
        _note_readback(forced=1, blocked_s=time.perf_counter() - t0)
        return rows

    def _force(self) -> List[List[int]]:
        """Wait for the rows (counted in the owner's stats; the caller
        notes the telemetry)."""
        self._stats.forced += 1
        if self._event is None:
            return self._adopt(self._dev)
        self._event.synchronize()
        return self._adopt(self._pinned)

    def ref(self, i: int) -> "ChecksumRef":
        return ChecksumRef(self, i)

    @classmethod
    def pull_pending(cls, stats: Optional[ReadbackStats] = None) -> None:
        """Read every pending batch in the process now (only those counted
        in ``stats`` when it is given, so one runner's flush does not force
        another's batches), in their owners' stats: a batch whose started
        copy has landed is harvested, the rest are forced (all their copies
        start before the first wait)."""
        pending = [b for b in list(cls._pending) if b._host is None
                   and (stats is None or b._stats is stats)]
        landed = [b._landed() for b in pending]
        for b in pending:
            b.start_async()
        t0 = time.perf_counter()
        for b, was_landed in zip(pending, landed):
            if was_landed:
                b._harvest()
            else:
                b._force()
        forced = len(pending) - sum(landed)
        if forced:
            _note_readback(forced=forced, blocked_s=time.perf_counter() - t0)


class ChecksumRef:
    """Row ``i`` of a :class:`BatchChecks`: one frame's checksum provider."""

    __slots__ = ("_batch", "_i")

    def __init__(self, batch: BatchChecks, i: int):
        self._batch = batch
        self._i = i

    def to_int(self) -> int:
        """The 64-bit cross-peer checksum (forces the batch's readback)."""
        hi, lo = self._batch.host()[self._i]
        return (hi << 32) | lo

    # calling a ref forces (SyncTest comparisons, flush points);
    # peek() is the non-blocking read the P2P desync detection retries
    __call__ = to_int

    def peek(self) -> Optional[int]:
        """The value if the batch's copy has landed, else None (starting
        the copy if needed); never waits for the card."""
        rows = self._batch.try_host()
        if rows is None:
            return None
        hi, lo = rows[self._i]
        return (hi << 32) | lo


def wrap_single_checksum(cs: torch.Tensor,
                         stats: Optional[ReadbackStats] = None) -> ChecksumRef:
    """Wrap one ``[2]`` checksum as a 1-row batch's ref."""
    return BatchChecks(cs[None], stats).ref(0)


class ReadbackQueue:
    """The pipelined runner's readback coordinator (see module docstring).

    ``start(batch)`` begins a batch's non-blocking copy right after its
    dispatch; ``harvest()`` (once per runner tick) reads every batch whose
    copy has landed and starts the copy of any pending batch that has
    none; ``flush()`` is the blocking read of everything pending, for
    flush points and the synchronous mode."""

    def start(self, batch: BatchChecks) -> None:
        batch.start_async()

    def harvest(self) -> int:
        """Read every landed batch; returns how many were read."""
        n = 0
        for b in list(BatchChecks._pending):
            if b._host is not None:
                BatchChecks._pending.discard(b)
                continue
            b.start_async()
            if b._landed():
                b._harvest()
                n += 1
        if _REG.enabled:
            _REG.gauge("pipeline_depth", "checksum dispatches in flight "
                       "(async readbacks not yet landed)").set(float(self.depth()))
        return n

    def depth(self) -> int:
        """Batches still in flight (pending and not read)."""
        return sum(1 for b in list(BatchChecks._pending) if b._host is None)

    def flush(self) -> None:
        """Blocking read of everything still pending."""
        BatchChecks.pull_pending()


_readback_queue: Optional[ReadbackQueue] = None


def readback_queue() -> ReadbackQueue:
    """The process-wide :class:`ReadbackQueue`."""
    global _readback_queue
    if _readback_queue is None:
        _readback_queue = ReadbackQueue()
    return _readback_queue


def tree_index(stacked, i):
    """``stacked``'s frame ``i`` (an int, or a ``(lobby, frame)`` pair):
    every leaf's row, as views."""
    return tree_map(lambda a: a[i], stacked)


def tree_index2(stacked, b: int, i: int):
    """Lobby ``b``'s frame ``i`` of a wave's ``[M, k, ...]`` stack (views)."""
    return tree_index(stacked, (b, i))


class LazySlice:
    """Frame ``i`` of a stacked resim output, not sliced yet: the ring
    stores these, and only the frame a rollback loads is sliced.  A live
    handle keeps the whole ``[k, ...]`` stacked buffer alive.  ``i`` may
    be a ``(lobby, frame)`` pair into a wave's ``[M, k, ...]`` stack, or a
    lobby of the resident ``[M, ...]`` world."""

    __slots__ = ("_stacked", "_i")

    def __init__(self, stacked, i):
        self._stacked = stacked
        self._i = i

    def materialize(self):
        """The frame as fresh device tensors (one clone per leaf); the
        result no longer pins the stacked buffer."""
        return tree_map(lambda a: a.clone(), tree_index(self._stacked, self._i))


def materialize(obj):
    """LazySlice -> concrete world; anything else passes through."""
    return obj.materialize() if isinstance(obj, LazySlice) else obj


# -- the batched runner's mixed-source row gathers ------------------------------

#: ``(buffer, lanes int64[n], frames int64[n] | None, targets int64[n])``
RowGroup = Tuple[object, np.ndarray, Optional[np.ndarray], np.ndarray]


def plan_row_gather(handles) -> Tuple[List[RowGroup], list]:
    """Group ``(target_row, snapshot)`` pairs by the stacked buffer behind
    each :class:`LazySlice`, for one fused gather (the JAX package's
    function of that name).

    Returns ``(groups, fallback)``: ``groups`` lists ``(buffer, lanes,
    frames, targets)`` in first-seen order, ``frames`` ``None`` where the
    handles index the buffer's leading axis only (a lobby of a resident
    world); ``fallback`` holds the ``(target, snapshot)`` pairs that are
    not lazy slices, for the caller's counted slow path."""
    by, order, fallback = {}, [], []
    for tgt, stored in handles:
        if not isinstance(stored, LazySlice):
            fallback.append((tgt, stored))
            continue
        lane, idx = stored._i if isinstance(stored._i, tuple) else (stored._i, None)
        key = (id(stored._stacked), idx is None)
        g = by.get(key)
        if g is None:
            g = by[key] = (stored._stacked, [], [], [])
            order.append(key)
        g[1].append(lane)
        g[2].append(idx)
        g[3].append(tgt)
    groups = []
    for key in order:
        buf, lanes, idxs, tgts = by[key]
        groups.append((buf, np.asarray(lanes, np.int64),
                       None if key[1] else np.asarray(idxs, np.int64),
                       np.asarray(tgts, np.int64)))
    return groups, fallback


class RowIndexStager:
    """The row indices of a fused gather, uploaded as ONE int64 buffer from
    pinned staging (two buffers in turn, fenced by CUDA events), grown
    geometrically.  On the CPU the indices are taken as they are."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stage: Optional[StagingQueue] = None
        self._cap = 0
        self.uploads = 0

    @property
    def deferred_blocks(self) -> int:
        return self._stage.deferred_blocks if self._stage is not None else 0

    @property
    def landed_free(self) -> int:
        return self._stage.landed_free if self._stage is not None else 0

    def upload(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """``arrays`` as int64 tensors on the device, split from one
        upload."""
        sizes = [len(a) for a in arrays]
        total = sum(sizes)
        if self.device.type == "cpu":
            flat = torch.from_numpy(np.concatenate(arrays).astype(np.int64))
        else:
            if self._stage is None or self._cap < total:
                cap = self._cap = max(total, 2 * self._cap, 64)
                self._stage = StagingQueue(lambda: np.zeros(cap, np.int64),
                                           device=self.device)
            buf = self._stage.acquire()
            buf[:total] = np.concatenate(arrays)
            flat = self._stage.commit(buf[:total])
            self.uploads += 1
        return list(torch.split(flat, sizes))


def _group_indices(groups: Sequence[RowGroup], stager: RowIndexStager):
    """Each group's ``(lanes, frames | None, targets)`` on the device."""
    arrays = []
    for _buf, lanes, idxs, tgts in groups:
        arrays += [lanes, tgts] + ([] if idxs is None else [idxs])
    it = iter(stager.upload(arrays))
    out = []
    for _buf, _lanes, idxs, _tgts in groups:
        lanes, tgts = next(it), next(it)
        out.append((lanes, None if idxs is None else next(it), tgts))
    return out


def _gather(buf, lanes: torch.Tensor, idxs: Optional[torch.Tensor]):
    if idxs is None:
        return tree_map(lambda a: a[lanes], buf)
    return tree_map(lambda a: a[lanes, idxs], buf)


def _map_rows(transform: Optional[Callable], rows):
    """``transform`` (a world -> world strategy hook) over every row of a
    ``[n, ...]`` world, under ``torch.func.vmap``."""
    if transform is None:
        return rows

    def one(leaves):
        return tree_flatten(transform(tree_unflatten(rows, leaves)))

    return tree_unflatten(rows, torch.func.vmap(one)(tree_flatten(rows)))


def fused_load_rows(worlds, groups: Sequence[RowGroup], stager: RowIndexStager,
                    transform: Optional[Callable] = None):
    """Gather every group's rows out of its stacked source buffer and put
    them at their target lanes of the resident ``[M, ...]`` worlds: the
    mixed-source batched load.  One upload of indices, then per group and
    leaf one gather and one out-of-place ``index_copy`` (no storage of
    ``worlds`` is written).  ``transform`` (the strategy's ``load_state``)
    runs over the gathered rows first."""
    for (buf, *_), (lanes, idxs, tgts) in zip(groups, _group_indices(groups, stager)):
        rows = _map_rows(transform, _gather(buf, lanes, idxs))
        worlds = tree_map(lambda w, r, t=tgts: w.index_copy(0, t, r), worlds, rows)
    return worlds


def fused_gather_rows(groups: Sequence[RowGroup], stager: RowIndexStager,
                      transform: Optional[Callable] = None):
    """Gather every group's rows into one fresh ``[n, ...]`` stack, in the
    groups' concatenated target order, and map ``transform`` (the
    strategy's ``store_state``) over it: the batched runner's non-identity
    saves, one stack per wave."""
    parts = [_gather(buf, lanes, idxs)
             for (buf, *_), (lanes, idxs, _t) in zip(groups, _group_indices(groups, stager))]
    rows = parts[0] if len(parts) == 1 else tree_map(lambda *xs: torch.cat(xs), *parts)
    return _map_rows(transform, rows)
