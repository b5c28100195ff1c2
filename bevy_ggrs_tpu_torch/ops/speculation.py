"""Speculative rollback cache — runner-side branch fan-out.

Port of ``bevy_ggrs_tpu/ops/speculation.py``.  While the session advances
on *predicted* remote inputs, the runner evaluates M candidate input
branches for the same transition in ONE branch-axis call
(:func:`~.resim.resim_branches`: ``torch.func.vmap`` over one frame's
advance, one checksum fold for all lanes).  When the real input arrives and
the session requests a rollback, the corrected input sequence is looked up
in the cache: a rollback whose corrected inputs were hedged is served from
the cached branch states with zero resimulated frames.

Usage: pass :class:`SpeculationConfig` to
:class:`~bevy_ggrs_tpu_torch.runner.GgrsRunner`.
``candidates_fn(last_inputs) -> [M, P, *input_shape]`` enumerates the input
combinations to hedge against (:func:`pad_candidates` builds one).

The draft's M candidate rows ride one ``int8[M, depth + 1, W]`` packed
buffer (``ops/packing.py``), staged in pinned memory by a
:class:`~..utils.staging.StagingQueue` and uploaded on its side copy
stream, fenced by a CUDA event: the JAX package commits that buffer
synchronously, the port never waits on the host for it.  Cached branch
states are views of the draft's ``[M, depth, ...]`` stack.

The counters are plain attributes (``hits``, ``misses``,
``branches_evaluated``, ``bytes_evicted``, ``draft_dispatches``,
``host_uploads``, ``packed_upload_bytes``, and the ``cached_bytes``
property), mirrored while telemetry is on into the JAX cache's pre-bound
families (``uploads_per_dispatch``, ``packed_upload_bytes``,
``draft_dispatches_total``; the runner counts ``speculation_hits_total`` /
``speculation_misses_total`` at its lookups).  The cache's bytes are a
device-memory row (``speculation<n>/branch_cache``) re-noted whenever an
entry comes or goes.
"""

from __future__ import annotations

import itertools
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..telemetry import devmem
from ..telemetry.metrics import registry
from ..utils.frames import frame_gt, frame_lt
from ..utils.mem import tree_storage_bytes
from ..utils.staging import StagingQueue
from ..utils.tree import tree_map
from .packing import (
    PackedUpload,
    pack_prefix,
    pack_row,
    prefix_words,
    repeat_last_row,
    unpack_seq,
)
from .resim import slice_frame


@dataclass
class SpeculationConfig:
    """``candidates_fn``: maps the inputs just used (``[P, *shape]``) to an
    ``[M, P, *shape]`` array of candidate input rows.  Should include likely
    corrections of the predicted players' inputs.

    ``depth``: each branch extends its candidate row ``depth`` frames forward
    (repeat-last continuation, matching how PredictRepeatLast mispredicts:
    the remote *held* an input we did not guess).  A rollback of d <= depth
    frames whose corrected inputs are constant and hedged becomes a cache
    select of the d-th stacked state; depth=1 recovers single-frame hedging.
    The speculate call costs M x depth frames of device work per predicted
    tick."""

    candidates_fn: Callable[[np.ndarray], np.ndarray]
    depth: int = 1
    max_cached_frames: int = 4  # keep branches for the newest N start frames
    # Memory note: the cache retains M x depth x max_cached_frames world
    # snapshots on the card (they share nothing with the ring).  For very
    # large worlds lower depth/max_cached_frames or hedge fewer candidates,
    # or set ``max_cached_bytes`` to let the cache bound itself.
    #: Device-byte budget across all cached start frames (None = unbounded
    #: beyond ``max_cached_frames``).  Oldest start frames evict first; the
    #: NEWEST entry is always retained even if it alone exceeds the budget
    #: (an empty cache would silently disable speculation), so the hard
    #: ceiling is max(max_cached_bytes, one entry's footprint).
    max_cached_bytes: Optional[int] = None


class SpeculationCache:
    """Branch cache: speculated (start_frame, inputs) -> per-frame states
    and checksums."""

    def __init__(self, app, config: SpeculationConfig):
        self.app = app
        self.config = config
        # start_frame -> (depth, {input bytes: (stacked [depth, ...], checks [depth, 2])})
        self._cache: Dict[int, Tuple[int, Dict[bytes, Tuple]]] = {}
        self._entry_bytes: Dict[int, int] = {}  # start_frame -> device bytes
        self.hits = 0
        self.misses = 0
        self.branches_evaluated = 0
        self.bytes_evicted = 0  # device bytes dropped by the BYTE budget only
        self.draft_dispatches = 0  # speculative fan-out calls issued
        # pinned [M, depth + 1, W] staging for the draft's one upload, grown
        # geometrically in M
        self._stage: Optional[StagingQueue] = None
        self._stage_shape = (0, 0)
        self.host_uploads = 0
        self.packed_upload_bytes = 0
        reg = registry()
        self._m_uploads = reg.bind_histogram(
            "uploads_per_dispatch",
            "host->device uploads issued per fused dispatch (1 on the packed path)",
            buckets=(1, 2, 3, 4, 8))
        self._m_packed_bytes = reg.bind_counter(
            "packed_upload_bytes", "bytes staged through packed single-upload buffers")
        self._m_drafts = reg.bind_counter(
            "draft_dispatches_total",
            "speculative draft dispatches issued into idle pipeline slots "
            "/ spare wave lanes")
        # the branch cache pins whole speculated worlds: a device-memory row
        # that dies with the cache
        self._devmem_owner = devmem.scope("speculation") + "/branch_cache"
        weakref.finalize(self, devmem.forget, self._devmem_owner)

    @property
    def cached_bytes(self) -> int:
        """Device bytes currently pinned by cached branch states."""
        return sum(self._entry_bytes.values())

    def _renote(self) -> None:
        devmem.note(self._devmem_owner, self.cached_bytes)

    def _account(self, start_frame: int, entry: Dict) -> None:
        # the storages the entry's views pin: the draft's whole [M, depth]
        # stack, or a branched dispatch's whole [B, K] stack
        self._entry_bytes[start_frame] = tree_storage_bytes(list(entry.values()))
        self._renote()

    def _stage_packed(self, cands: np.ndarray, start_frame: int,
                      depth: int) -> PackedUpload:
        """Stage the M candidate branches into the pinned packed buffer (one
        prefix row per lane, then the candidate held for ``depth`` rows with
        statuses zero) and start its upload."""
        spec = self.app.packed_spec
        m = cands.shape[0]
        cap, have_depth = self._stage_shape
        if self._stage is None or cap < m or have_depth != depth:
            cap = max(m, 2 * cap)
            self._stage_shape = (cap, depth)
            self._stage = StagingQueue(lambda: spec.new_batch_buffer(cap, depth),
                                       device=self.app.device)
        pk = self._stage.acquire()[:m]
        zero_status = np.zeros(self.app.num_players, np.int8)
        for b in range(m):
            pack_prefix(pk[b], start_frame, depth)
            pack_row(spec, pk[b], 0, cands[b], zero_status)
            repeat_last_row(pk[b], 1, depth)
        return PackedUpload(self._stage.commit(pk), *prefix_words(pk[0]))

    def speculate(self, world, start_frame: int, used_inputs: np.ndarray) -> None:
        """Fan out candidate branches from ``world`` (the pre-advance state):
        each candidate input row held constant for ``config.depth`` frames,
        in one branch-axis call fed by one packed upload."""
        cands = np.asarray(self.config.candidates_fn(used_inputs), self.app.input_dtype)
        m = cands.shape[0]
        if m == 0:
            return
        depth = max(self.config.depth, 1)
        pk = self._stage_packed(cands, start_frame, depth)
        inputs_b, status_b = unpack_seq(self.app.packed_spec, pk.rows)
        _, stacked, checks = self.app.speculate_fn(world, inputs_b, status_b, start_frame)
        self.host_uploads += 1
        self.packed_upload_bytes += pk.nbytes
        self.draft_dispatches += 1
        self._m_uploads.observe(1)
        self._m_packed_bytes.inc(pk.nbytes)
        self._m_drafts.inc()
        self.branches_evaluated += m * depth
        entry = {}
        for b in range(m):
            key = np.ascontiguousarray(cands[b]).tobytes()
            # per-branch stacked states [depth, ...] + checksums [depth, 2]
            entry[key] = (tree_map(lambda a, b=b: a[b], stacked), checks[b])
        self._cache[start_frame] = (depth, entry)
        self._account(start_frame, entry)
        self._trim()

    def fill_from_branched(self, start_frame: int, cands: np.ndarray,
                           stacked_b, checks_b, offset: int, depth_eff: int) -> None:
        """Store hedge-lane outputs of a canonical-branched dispatch.

        ``stacked_b``/``checks_b`` carry a leading branch axis ALIGNED with
        ``cands`` (hedge lanes only); each lane's frames [offset:] hold the
        candidate-driven continuation."""
        if depth_eff <= 0 or cands.shape[0] == 0:
            return
        entry = {}
        for b in range(cands.shape[0]):
            key = np.ascontiguousarray(cands[b]).tobytes()
            if key in entry:
                continue  # duplicate candidate (padding lanes)
            stacked = tree_map(lambda a, b=b: a[b, offset:offset + depth_eff], stacked_b)
            entry[key] = (stacked, checks_b[b, offset:offset + depth_eff])
        self.branches_evaluated += cands.shape[0] * depth_eff
        self._cache[start_frame] = (depth_eff, entry)
        self._account(start_frame, entry)
        self._trim()

    def lookup_seq(self, start_frame: int, inputs_seq: np.ndarray) -> Optional[Tuple]:
        """Longest cached prefix for advancing ``start_frame`` with the frame
        sequence ``inputs_seq [k, P, *shape]``.

        Returns ``(d, states_fn, checks)`` where d is the number of frames
        served: ``states_fn(i)`` yields the state after advance i (0-based,
        i < d, views) and ``checks[i]`` its checksum — or None on a miss.
        ``states_fn.stacked`` is the branch's ``[depth, ...]`` stack.  Matches
        only constant input prefixes (branches hold their candidate)."""
        got = self._cache.get(start_frame)
        if got is None:
            self.misses += 1
            return None
        depth, entry = got
        seq = np.asarray(inputs_seq, self.app.input_dtype)
        branch = entry.get(np.ascontiguousarray(seq[0]).tobytes())
        if branch is None:
            self.misses += 1
            return None
        d = 1
        while d < min(depth, seq.shape[0]) and np.array_equal(seq[d], seq[0]):
            d += 1
        stacked_b, checks_b = branch
        self.hits += 1

        def states_fn(i):
            return slice_frame(stacked_b, i)

        states_fn.stacked = stacked_b
        return d, states_fn, checks_b

    def lookup(self, start_frame: int, inputs: np.ndarray) -> Optional[Tuple]:
        """Single-frame convenience: (state, checksum) or None."""
        got = self.lookup_seq(start_frame, np.asarray(inputs)[None])
        if got is None:
            return None
        _, states_fn, checks = got
        return states_fn(0), checks[0]

    def _oldest(self) -> int:
        oldest = next(iter(self._cache))
        for f in self._cache:
            if frame_lt(f, oldest):
                oldest = f
        return oldest

    def _drop(self, frame: int) -> int:
        del self._cache[frame]
        dropped = self._entry_bytes.pop(frame, 0)
        self._renote()
        return dropped

    def _trim(self) -> None:
        """Evict the OLDEST start frames past the frame cap and the device-
        byte budget, under wrapping frame order (a plain ``sorted()`` would
        evict the newest at the i32 wrap).  The newest entry always stays —
        see ``SpeculationConfig.max_cached_bytes``."""
        while len(self._cache) > self.config.max_cached_frames:
            self._drop(self._oldest())
        budget = self.config.max_cached_bytes
        if budget is not None:
            while len(self._cache) > 1 and self.cached_bytes > budget:
                self.bytes_evicted += self._drop(self._oldest())

    def invalidate_after(self, frame: int) -> None:
        """Drop entries whose base state a rollback to ``frame`` invalidates.

        An entry for start_frame s was speculated from the live state at s.
        A rollback that loads frame f re-simulates every frame after f with
        corrected inputs, so entries with s > f (wrapping order) sit on
        superseded bases: their *inputs* can still match a later lookup,
        which would serve bit-stale states and desync the speculating peer
        from a plain one.  The entry at s == f stays valid: its base is
        exactly the ring snapshot the load restores."""
        for s in [s for s in self._cache if frame_gt(s, frame)]:
            self._drop(s)

    def clear(self) -> None:
        """Drop every cached branch (and its byte accounting)."""
        self._cache.clear()
        self._entry_bytes.clear()
        self._renote()

    def drain_drafts(self) -> None:
        """Wait until every issued draft has run (measurement only: the
        runner's ``measure_rollback_service`` mode calls it at the
        speculation seam, so a later rollback's timed span does not wait on
        a draft through the stream's order).  A stream synchronize on the
        card; nothing on the CPU."""
        if self.app.device.type == "cuda":
            torch.cuda.current_stream(self.app.device).synchronize()


def pad_candidates(num_players: int, predicted_handles, values) -> Callable:
    """Convenience candidates_fn: enumerate ``values`` for every predicted
    handle (cartesian over handles), holding other players' inputs as used."""

    def fn(used_inputs: np.ndarray) -> np.ndarray:
        combos = list(itertools.product(values, repeat=len(predicted_handles)))
        out = np.repeat(np.asarray(used_inputs)[None], len(combos), axis=0).copy()
        for i, combo in enumerate(combos):
            for h, v in zip(predicted_handles, combo):
                out[i, h] = v
        return out

    return fn
