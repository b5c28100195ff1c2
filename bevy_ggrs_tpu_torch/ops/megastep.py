"""Device-resident N-tick megastep: one upload and one program per flush.

Port of ``bevy_ggrs_tpu/ops/megastep.py``.  The runner's megastep mode
keeps a ring of the last advanced states on the device and folds a
rollback's load into the same call that replays the frames:

- the device ring is an ``[R + 1, ...]`` stacked world plus an int32
  ``ring_frames[R + 1]`` tag vector.  Rows ``0..R-1`` are the ring; row
  ``R`` is a trash row that takes the padded frames' writes (torch has no
  ``mode="drop"`` scatter), so the writeback is one ``index_copy_`` per
  leaf whatever ``n_real`` is.  The ring is updated in place, the port's
  counterpart of XLA's donation of it;
- every clock of the call is read on the device from the packed prefix
  (``ops/packing.py``: ``[start_frame, n_real, has_load, load_slot]``):
  the frames, retire horizons and times of the ``k_max`` steps
  (``ops/resim.py`` ``lane_clocks``, the many-worlds lane path's clock as
  its ``M = 1`` case), the load's select and the advance mask.  So the
  program makes no host read, no host branch and no shape that varies with
  the data: the same launches every flush, which is what a CUDA graph
  captures;
- the load is branchless: per leaf, ring row ``clamp(load_slot, 0, R-1)``
  is gathered (a copy, never a view of the ring) and selected against the
  live state by ``has_load != 0``;
- the resim is masked at a fixed ``k_max``: every step runs, and frame
  ``i``'s result is kept only where ``i < n_real``, else the carried state
  repeats (as ``resim_padded`` does); the stacked states are written into
  fresh ``[k_max, ...]`` tensors and checksummed by one fold launch on
  ``[k_max, N]``;
- the writeback copies real row ``i`` into slot ``(start_frame + 1 + i)
  mod R`` (``torch.remainder`` of the wrapped int32 frame, non-negative as
  Python's ``%``), padded rows into the trash row ``R``, and tags
  ``ring_frames`` the same way.

Nothing returned is a view of the ring (the final world is the last
select's output, ``stacked`` a fresh allocation), so the next writeback
cannot rewrite a saved or live state.  The host ring's lazy saves point at
``stacked``, as in the JAX package.

Eager torch runs every one of the ``k_max`` steps, so a 1-frame flush
costs ``k_max`` frames of launches; the fixed shape is the point.
"""

from __future__ import annotations

import numpy as np
import torch

from ..snapshot.checksum import world_checksums
from ..snapshot.world import Registry, WorldState, _bits
from ..utils import staging
from ..utils.frames import NULL_FRAME
from ..utils.tree import tree_map
from .packing import PREFIX_BYTES, PackedSpec, unpack_seq
from .resim import StepCtx, StepFn, _advance_ctx, _empty_stack, _write_frame, lane_clocks


def init_device_ring(world: WorldState, slots: int):
    """The device ring for ``world``'s structure: ``(ring, ring_frames)``,
    an ``[slots + 1, ...]`` zeroed stacked world (the last row is the trash
    row) and ``ring_frames`` int32 ``[slots + 1]`` of ``NULL_FRAME``.
    Unwritten rows are never selected: the runner's host mirror fuses a
    load only for a frame it has seen the program write."""
    ring = tree_map(lambda a: torch.zeros((slots + 1, *a.shape), dtype=a.dtype,
                                          device=a.device), world)
    frames = torch.full((slots + 1,), NULL_FRAME, dtype=torch.int32, device=world.device)
    return ring, frames


def prefix_scalars(rows: torch.Tensor):
    """``(start_frame, n_real, has_load, load_slot)`` as int32 device
    scalars, read from the prefix row of an uploaded ``int8[k + 1, W]``
    buffer (views; never read back)."""
    words = rows[0, :PREFIX_BYTES].view(torch.int32)
    return words[0], words[1], words[2], words[3]


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(cond, a, b)`` on any leaf dtype (unsigned ones by their bits)."""
    return torch.where(cond, _bits(a), _bits(b)).view(a.dtype)


def make_megastep_fn(reg: Registry, step_fn: StepFn, spec: PackedSpec, fps: int,
                     seed: int = 0, retention: int = 16, k_max: int = 8,
                     ring_slots: int = 16):
    """Build the megastep program.

    ``fn(state, ring, ring_frames, rows) -> (final, ring, ring_frames,
    stacked, checks)`` where ``rows`` is the flush's ONE upload, ``int8
    [k_max + 1, W]`` (prefix + payload rows, ``ops/packing.py``).  ``ring``
    and ``ring_frames`` are updated in place and returned.  ``stacked`` and
    ``checks`` come back untrimmed at ``k_max`` rows (rows at and past
    ``n_real`` repeat the held state), so saves slice the real rows."""
    delta = np.float32(1.0 / fps)

    def fn(state: WorldState, ring: WorldState, ring_frames: torch.Tensor,
           rows: torch.Tensor):
        staging.sanitizer().guard_donated(state, "megastep_fn")
        if rows.shape[0] != k_max + 1:
            raise ValueError(f"the megastep takes {k_max} payload rows, "
                             f"not {rows.shape[0] - 1}")
        inputs_seq, status_seq = unpack_seq(spec, rows)
        start, n_real, has_load, load_slot = prefix_scalars(rows)
        # branchless load: ring row `load_slot` where the prefix says so
        slot = torch.clamp(load_slot, 0, ring_slots - 1).to(torch.int64).reshape(1)
        take = has_load != 0
        state = tree_map(
            lambda r, s: _select(take, _bits(r).index_select(0, slot)[0].view(r.dtype), s),
            ring, state)
        frames, retire, times = lane_clocks(start.reshape(1), k_max, retention, fps)
        stacked = _empty_stack(state, k_max)
        for i in range(k_max):
            ctx = StepCtx(inputs_seq[i], status_seq[i], frames[0, i], retire[0, i],
                          times[0, i], delta, seed)
            new = _advance_ctx(reg, step_fn, state, ctx)
            live = n_real > i
            state = tree_map(lambda a, b: _select(live, a, b), new, state)
            _write_frame(stacked, i, state)
        checks = world_checksums(reg, stacked)
        # branchless writeback: real row i to its frame's slot, padded rows
        # to the trash row
        idx = torch.arange(k_max, dtype=torch.int32, device=rows.device)
        slots = torch.where(idx < n_real, torch.remainder(frames[0], ring_slots),
                            ring_slots).to(torch.int64)
        tree_map(lambda r, s: _bits(r).index_copy_(0, slots, _bits(s)), ring, stacked)
        ring_frames.index_copy_(0, slots, frames[0])
        return state, ring, ring_frames, stacked, checks

    return fn
