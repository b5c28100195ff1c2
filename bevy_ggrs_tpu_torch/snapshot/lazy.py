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
  The process's reads are counted in one place, ``_note_readback`` (as in
  the JAX package): :func:`readback_stats` (harvested, forced, seconds
  blocked) always, the telemetry families ``readback_harvested_total``,
  ``readback_forced_total`` and ``host_blocked_seconds`` while telemetry
  is on, and a ``forced_readback`` flight-recorder entry per forcing read
  always (forced reads are the pipeline's degrade signal).
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
- :class:`LobbyShards` is a per-shard value of the lobby axis (the
  lobby-sharded executor's resident world and wave outputs): shard ``d``
  holds lobbies ``d * lanes .. (d + 1) * lanes - 1`` as one tree on its
  device.  A :class:`BatchChecks` over it starts one copy per shard and
  assembles the host rows in lobby order; :class:`LazySlice`,
  :func:`plan_row_gather` and :func:`fused_load_rows` map a lobby to its
  (shard, row).

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


_STATS = {"harvested": 0, "forced": 0, "blocked_seconds": 0.0}


def readback_stats() -> dict:
    """A copy of the process's checksum reads since it started:
    ``{harvested, forced, blocked_seconds}``."""
    return dict(_STATS)


def _note_readback(harvested: int = 0, forced: int = 0, blocked_s: float = 0.0) -> None:
    """Count checksum reads: the process's totals always, the registry
    families while telemetry is on, the flight entry of a forcing read
    always."""
    _STATS["harvested"] += harvested
    _STATS["forced"] += forced
    _STATS["blocked_seconds"] += blocked_s
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
    module docstring).  ``dev`` may be a :class:`LobbyShards` of per-shard
    ``[lanes, ..., 2]`` checksums (a lobby-sharded wave's): one copy
    starts per shard, and the host rows are the shards' rows in lobby
    order, flattened to ``[n, 2]`` (row ``b * bucket + i`` of a wave)."""

    _pending: "weakref.WeakSet[BatchChecks]" = weakref.WeakSet()

    __slots__ = ("_dev", "_host", "_started", "_pinned", "_event", "_stats",
                 "__weakref__")

    def __init__(self, dev, stats: Optional[ReadbackStats] = None):
        self._dev = dev
        self._host: Optional[List[List[int]]] = None
        self._started = False  # the copy was started (CPU rows: "landed")
        self._pinned: Optional[List[torch.Tensor]] = None
        self._event: Optional[list] = None
        self._stats = stats if stats is not None else ReadbackStats()
        BatchChecks._pending.add(self)

    def _parts(self) -> List[torch.Tensor]:
        if isinstance(self._dev, LobbyShards):
            return [p.reshape(-1, 2) for p in self._dev.parts]
        return [self._dev]

    def _adopt(self, parts: List[torch.Tensor]) -> List[List[int]]:
        self._host = parts[0].tolist() if len(parts) == 1 else \
            [row for p in parts for row in p.tolist()]
        self._pinned = self._event = None
        BatchChecks._pending.discard(self)
        return self._host

    def start_async(self) -> None:
        """Start the non-blocking device->host copy of the rows, one per
        shard (a no-op once started or read; CPU rows need no copy)."""
        if self._host is not None or self._started:
            return
        self._started = True
        parts = self._parts()
        if all(p.device.type != "cuda" for p in parts):
            return
        self._pinned, self._event = [], []
        for p in parts:
            pinned = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            if p.device.type == "cuda":
                pinned.copy_(p, non_blocking=True)  # on p's device's stream
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(p.device))
                self._event.append(event)
            else:
                pinned.copy_(p)
            self._pinned.append(pinned)

    def _landed(self) -> bool:
        """True when the started copies have landed: reading the rows would
        not wait for the card.  A batch never started has not landed, so a
        read of it counts as forced, on the CPU too."""
        if not self._started:
            return False
        return self._event is None or all(e.query() for e in self._event)

    def _harvest(self) -> List[List[int]]:
        self._stats.harvested += 1
        _note_readback(harvested=1)
        return self._adopt(self._pinned if self._event is not None else self._parts())

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
            return self._adopt(self._parts())
        for e in self._event:
            e.synchronize()
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

    def device(self) -> torch.Tensor:
        """The lazy ``[2]`` (hi, lo) row on the card: a view of the batch's
        checksums, no transfer (a lobby-sharded batch's row on its
        shard's device)."""
        i = self._i
        for part in self._batch._parts():
            if i < part.shape[0]:
                return part[i]
            i -= part.shape[0]
        raise IndexError(f"checksum row {self._i} is past the batch")


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


class LobbyShards:
    """A per-shard value of the lobby axis: ``parts[d]`` is shard ``d``'s
    tree, every leaf ``[rows_d, ...]`` on that shard's device, holding
    lobbies ``d * lanes`` onward in order (contiguous blocks, the pad
    lanes at the end).  Lobby ``b`` lives on shard ``b // lanes`` at local
    row ``b % lanes`` (:meth:`locate`).  A trimmed value's last parts may
    be shorter, or missing, and the lobby mapping stays the same."""

    __slots__ = ("parts", "lanes")

    def __init__(self, parts: Sequence, lanes: int):
        self.parts = list(parts)
        self.lanes = int(lanes)

    def locate(self, b: int) -> Tuple[int, int]:
        """``(shard, local row)`` of lobby ``b``."""
        return divmod(int(b), self.lanes)

    def rows(self, d: int) -> int:
        """Lobbies held by shard ``d``."""
        return tree_flatten(self.parts[d])[0].shape[0]

    def __len__(self) -> int:
        return sum(self.rows(d) for d in range(len(self.parts)))

    @property
    def devices(self) -> List[torch.device]:
        return [tree_flatten(p)[0].device for p in self.parts]

    def map(self, fn: Callable) -> "LobbyShards":
        """``fn`` over every shard's tree (a per-shard program)."""
        return LobbyShards([fn(p) for p in self.parts], self.lanes)

    def trim(self, m: int) -> "LobbyShards":
        """The first ``m`` lobbies (views; no device work)."""
        parts = []
        for d, p in enumerate(self.parts):
            keep = min(self.rows(d), m - d * self.lanes)
            if keep <= 0:
                break
            parts.append(p if keep == self.rows(d) else tree_map(lambda a: a[:keep], p))
        return LobbyShards(parts, self.lanes)

    def gather(self, device=None):
        """One tree of every lobby in order, on ``device`` (default: the
        first shard's): a copy, for checks and tests, never the hot path."""
        dev = self.devices[0] if device is None else torch.device(device)
        return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]), *self.parts)


def tree_index(stacked, i):
    """``stacked``'s frame ``i`` (an int, or a ``(lobby, frame)`` pair):
    every leaf's row, as views; on a :class:`LobbyShards` the lobby maps
    to its shard and local row."""
    if isinstance(stacked, LobbyShards):
        b, rest = (i[0], i[1:]) if isinstance(i, tuple) else (i, ())
        d, r = stacked.locate(b)
        return tree_map(lambda a: a[(r, *rest)], stacked.parts[d])
    return tree_map(lambda a: a[i], stacked)


def tree_index2(stacked, b: int, i: int):
    """Lobby ``b``'s frame ``i`` of a wave's ``[M, k, ...]`` stack (views)."""
    return tree_index(stacked, (b, i))


class LazySlice:
    """Frame ``i`` of a stacked resim output, not sliced yet: the ring
    stores these, and only the frame a rollback loads is sliced.  A live
    handle keeps the whole ``[k, ...]`` stacked buffer alive.  ``i`` may
    be a ``(lobby, frame)`` pair into a wave's ``[M, k, ...]`` stack, or a
    lobby of the resident ``[M, ...]`` world; either may be a
    :class:`LobbyShards`."""

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
    not lazy slices, for the caller's counted slow path.  A handle into a
    :class:`LobbyShards` groups by its shard, whose tree is the buffer and
    whose local rows are the lanes."""
    by, order, fallback = {}, [], []
    for tgt, stored in handles:
        if not isinstance(stored, LazySlice):
            fallback.append((tgt, stored))
            continue
        lane, idx = stored._i if isinstance(stored._i, tuple) else (stored._i, None)
        buf, shard = stored._stacked, None
        if isinstance(buf, LobbyShards):
            shard, lane = buf.locate(lane)
            buf = buf.parts[shard]
        key = (id(stored._stacked), shard, idx is None)
        g = by.get(key)
        if g is None:
            g = by[key] = (buf, [], [], [])
            order.append(key)
        g[1].append(lane)
        g[2].append(idx)
        g[3].append(tgt)
    groups = []
    for key in order:
        buf, lanes, idxs, tgts = by[key]
        groups.append((buf, np.asarray(lanes, np.int64),
                       None if key[2] else np.asarray(idxs, np.int64),
                       np.asarray(tgts, np.int64)))
    return groups, fallback


class RowIndexStager:
    """The row indices of a fused gather, uploaded as ONE int64 buffer per
    device from pinned staging (two buffers in turn, fenced by CUDA
    events), grown geometrically.  On the CPU the indices are taken as
    they are."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stages: dict = {}  # device -> (StagingQueue, capacity)
        self.uploads = 0

    @property
    def deferred_blocks(self) -> int:
        return sum(st.deferred_blocks for st, _cap in self._stages.values())

    @property
    def landed_free(self) -> int:
        return sum(st.landed_free for st, _cap in self._stages.values())

    def upload(self, arrays: Sequence[np.ndarray], device=None) -> List[torch.Tensor]:
        """``arrays`` as int64 tensors on ``device`` (default: the
        stager's), split from one upload."""
        dev = self.device if device is None else torch.device(device)
        sizes = [len(a) for a in arrays]
        total = sum(sizes)
        if dev.type == "cpu":
            flat = torch.from_numpy(np.concatenate(arrays).astype(np.int64))
        else:
            stage, cap = self._stages.get(dev, (None, 0))
            if stage is None or cap < total:
                cap = max(total, 2 * cap, 64)
                stage = StagingQueue(lambda: np.zeros(cap, np.int64), device=dev)
                self._stages[dev] = (stage, cap)
            buf = stage.acquire()
            buf[:total] = np.concatenate(arrays)
            flat = stage.commit(buf[:total])
            self.uploads += 1
        return list(torch.split(flat, sizes))


def _upload_by_device(stager: RowIndexStager, jobs) -> list:
    """``jobs`` of ``(device, [arrays])``: the arrays on their devices, one
    upload per distinct device, in the jobs' order."""
    by_dev: dict = {}
    for dev, arrays in jobs:
        by_dev.setdefault(dev, []).extend(arrays)
    got = {dev: iter(stager.upload(arrays, dev)) for dev, arrays in by_dev.items()}
    return [[next(got[dev]) for _ in arrays] for dev, arrays in jobs]


def _group_indices(groups: Sequence[RowGroup], stager: RowIndexStager):
    """Each group's ``(lanes, frames | None, targets)`` on its buffer's
    device."""
    jobs = [(_tree_device(buf), [lanes, tgts] + ([] if idxs is None else [idxs]))
            for buf, lanes, idxs, tgts in groups]
    out = []
    for (_buf, _l, idxs, _t), got in zip(groups, _upload_by_device(stager, jobs)):
        out.append((got[0], None if idxs is None else got[2], got[1]))
    return out


def _tree_device(tree) -> torch.device:
    return tree_flatten(tree)[0].device


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
    runs over the gathered rows first.  On a :class:`LobbyShards` world
    the targets map to their shards: one upload per device, and per group
    and target shard one gather and one ``index_copy`` into that shard."""
    if isinstance(worlds, LobbyShards):
        return _fused_load_shards(worlds, groups, stager, transform)
    for (buf, *_), (lanes, idxs, tgts) in zip(groups, _group_indices(groups, stager)):
        rows = _map_rows(transform, _gather(buf, lanes, idxs))
        worlds = tree_map(lambda w, r, t=tgts: w.index_copy(0, t, r), worlds, rows)
    return worlds


def _fused_load_shards(worlds: LobbyShards, groups: Sequence[RowGroup],
                       stager: RowIndexStager, transform: Optional[Callable]):
    """:func:`fused_load_rows` into a per-shard world: each group splits by
    its targets' shards (a lobby's own rows lie on its own shard, so a
    group from a shard's buffer targets that shard alone)."""
    jobs, plans = [], []
    for buf, lanes, idxs, tgts in groups:
        shard_of = tgts // worlds.lanes
        for d in dict.fromkeys(shard_of.tolist()):
            sel = shard_of == d
            arrays = [lanes[sel], tgts[sel] - d * worlds.lanes]
            if idxs is not None:
                arrays.append(idxs[sel])
            jobs.append((_tree_device(buf), arrays))
            plans.append((buf, d, idxs is not None))
    parts = list(worlds.parts)
    devices = worlds.devices
    for (buf, d, framed), got in zip(plans, _upload_by_device(stager, jobs)):
        rows = _map_rows(transform, _gather(buf, got[0], got[2] if framed else None))
        dev = devices[d]
        tgts = got[1].to(dev)
        parts[d] = tree_map(lambda w, r: w.index_copy(0, tgts, r.to(dev)), parts[d], rows)
    return LobbyShards(parts, worlds.lanes)


def fused_gather_rows(groups: Sequence[RowGroup], stager: RowIndexStager,
                      transform: Optional[Callable] = None):
    """Gather every group's rows into one fresh ``[n, ...]`` stack, in the
    groups' concatenated target order, and map ``transform`` (the
    strategy's ``store_state``) over it: the batched runner's non-identity
    saves, one stack per wave.  Rows from shards on other devices are
    moved to the first group's device."""
    parts = [_gather(buf, lanes, idxs)
             for (buf, *_), (lanes, idxs, _t) in zip(groups, _group_indices(groups, stager))]
    dev = _tree_device(parts[0])
    rows = parts[0] if len(parts) == 1 else tree_map(
        lambda *xs: torch.cat([x.to(dev) for x in xs]), *parts)
    return _map_rows(transform, rows)
