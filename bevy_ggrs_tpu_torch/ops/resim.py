"""Advance / resimulate — the frame engine, in eager torch.

Port of ``bevy_ggrs_tpu/ops/resim.py``.  A rollback of ``k`` frames is one
call: a Python loop over the frames (the reference's ``lax.scan``) that
writes each frame's state into preallocated ``[k, ...]`` stacked tensors,
then ONE checksum pass over the stacked output (the JAX package's
``fused_checksums=True`` placement, bit-identical to checksumming inside
the loop because the checksum is an integer wrapping sum).  That pass is
where the checksum fold kernel runs, once per resim.

Frame semantics match the reference: an AdvanceFrame increments the frame
counter and then runs the step, so the step computing frame ``f`` sees
``ctx.frame == f`` and ``ctx.time_seconds == f / fps``.  Every advance
starts with the despawn-retirement sweep at the fixed horizon
``frame - retention`` (see the JAX module's docstring for why that horizon
keeps slot reuse peer-independent).

Eager torch runs the same kernels for a frame whatever the rollback depth,
so the port needs no fixed-length program for bit-determinism; the
canonical (padded) functions are kept so an app configured with
``canonical_depth`` has the same interface and results as in JAX.

The resim takes its inputs and statuses as tensors on the world's device
(numpy arrays only for a CPU world, where they are host memory already):
no resim path copies from pageable host memory, which would make CUDA
synchronise the stream.  The runner and :class:`~..app.App` stage them
through pinned memory (``utils/staging.py``); the packed functions take
one uploaded ``int8[k + 1, W]`` buffer (``ops/packing.py``) and split it
on the card.  The donating variants donate by dropping the reference: the
input world is dead after the call (the sanitizer flags a later dispatch
of it), and no storage is written in place, so a snapshot that shares the
input's tensors stays valid.

The branch axis (speculation): :func:`resim_branches` advances M lanes
of inputs from one state with ``torch.func.vmap`` over one frame's
:func:`advance` (the despawn sweep, the step, the store/load round trip),
the frame loop outside it.  The ``[M, k, ...]`` stacks are allocated and
written outside ``vmap``, and the checksum fold runs once after the loop
over the stack viewed as ``[M * k, ...]``: one fold launch per call.
Each lane computes what the plain :func:`resim` computes on that lane's
inputs (bit for bit on the shipped models, checked on the CPU by the tests
and on the card by ``chip_smoke.py``).  A per-lane ``n_real`` (the
canonical-branched program) is a host decision: lanes past their count
repeat their carried state, and a select runs only on frames where some
lanes advance and others hold.  An op with no batching rule makes
``vmap`` run it lane by lane; those fallbacks are counted in
:data:`vmap_fallbacks`.  A step that cannot run under ``vmap`` at all (an
in-place write of a batched value into an unbatched tensor, as
``spawn``'s index writes do) raises at the first call; it is never run
lane by lane instead.  :func:`make_speculate_fn`,
:func:`make_packed_speculate_fn` and :func:`make_canonical_branched_fn`
wrap it as the JAX package's functions of those names.

The lane axis (many worlds, ``ops/batch.py``): :func:`resim_lanes`
runs the same ``vmap`` over an ``[M, ...]`` stacked world whose lanes are
independent lobbies at their own frames.  Each lane's frame, retire
horizon and time are computed on the device from an int32 ``[M]`` vector
of start frames (:func:`lane_clocks`, read from the packed wave's prefix)
and never read back; the solo and branch paths keep their host clock and
their bits.

``StepCtx.rng_key`` is the JAX package's per-frame key,
``fold_in(PRNGKey(seed), uint32(frame))`` (``utils/threefry.py``), with the
app's ``seed`` threaded through every function here as the JAX package
threads it.  It is computed when a step first reads it, so a step that
never does launches nothing for it (XLA drops an unused key; eager torch
would pay for it every frame): on a host clock it is two host ints, on
the lane path an int64 ``[2]`` tensor from the lane's own frame.
"""

from __future__ import annotations

import sys
import types
import warnings
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..snapshot.checksum import branch_checksums, world_checksum, world_checksums
from ..snapshot.world import Registry, WorldState, despawn_confirmed
from ..utils import staging, threefry
from ..utils.device import is_dtensor
from ..utils.frames import frame_add
from ..utils.tree import tree_flatten, tree_map, tree_unflatten
from .packing import PackedSpec, PackedUpload, unpack_seq


@dataclass
class StepCtx:
    """Per-frame context handed to the user step function.

    ``inputs``/``input_status`` are the ``PlayerInputs`` analog (tensors on
    the world's device).  On the solo and branch paths the clock is host
    values (``frame`` and ``retire_frame`` ints, ``time_seconds`` a numpy
    float32), so a step can use them in tensor arithmetic without an
    upload.  On the lane path (many worlds, ``ops/batch.py``) every lane
    runs its own clock: ``frame`` and ``retire_frame`` are int32 device
    scalars (i32 wrap) and ``time_seconds`` a float32 device scalar, as in
    the JAX package, so a step that must run there compares them with
    tensor ops, not Python ``if``.  ``delta_seconds`` is always the host
    float32 ``1 / fps``.  ``rng_key`` (computed on first read) is
    ``fold_in(PRNGKey(seed), uint32(frame))``, a key of
    ``utils/threefry.py``: host ints on a host clock (draw with
    ``device=``), a device tensor on the lane path."""

    inputs: torch.Tensor  # [num_players, *input_shape]
    input_status: torch.Tensor  # int8[num_players] (InputStatus)
    frame: Any  # the frame being computed
    retire_frame: Any  # despawn-retirement horizon
    time_seconds: Any  # GgrsTime total
    delta_seconds: np.float32  # 1 / fps
    seed: int = 0  # the app's seed

    @cached_property
    def rng_key(self) -> threefry.Key:
        """The frame's PRNG key, ``fold_in(PRNGKey(seed), uint32(frame))``."""
        return threefry.fold_in(threefry.prng_key(self.seed), self.frame)


StepFn = Callable[[WorldState, StepCtx], WorldState]


def advance(
    reg: Registry,
    step_fn: StepFn,
    state: WorldState,
    inputs: torch.Tensor,
    status: torch.Tensor,
    frame: int,
    retention: int,
    fps: int,
    seed: int = 0,
) -> WorldState:
    """One AdvanceWorld: despawn-retirement sweep, then the user step."""
    retire = frame_add(frame, -retention)
    return _advance_ctx(reg, step_fn, state, StepCtx(
        inputs=inputs,
        input_status=status,
        frame=frame,
        retire_frame=retire,
        time_seconds=np.float32(frame) / np.float32(fps),
        delta_seconds=np.float32(1.0 / fps),
        seed=seed,
    ))


def _advance_ctx(reg: Registry, step_fn: StepFn, state: WorldState,
                 ctx: StepCtx) -> WorldState:
    """:func:`advance` at a given clock (host values or device scalars)."""
    state = despawn_confirmed(reg, state, ctx.retire_frame)
    state = step_fn(state, ctx)
    if not reg.is_identity_strategy():
        # a lossy store strategy makes the stored form canonical: round-trip
        # the live state so a resim from a snapshot matches the live pass
        state = reg.load_state(reg.store_state(state))
    return state


_I32_SPAN = 1 << 32


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped into i32 range, as int32 (two's complement)."""
    return (torch.remainder(x + (1 << 31), _I32_SPAN) - (1 << 31)).to(torch.int32)


def lane_clocks(starts: torch.Tensor, k: int, retention: int,
                fps: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every lane's clock for ``k`` advances from its own start frame, on
    the device: ``(frame, retire_frame, time_seconds)``, each ``[M, k]``.

    Frames are the i32-wrapping ``start + i + 1``, the retire horizon
    ``frame - retention`` wraps too, and the time is the float32 division
    ``float32(frame) / float32(fps)`` by a tensor, so it rounds as the
    host's numpy (and JAX's ``astype(float32) / fps``) does: dividing by
    a Python scalar may compute a reciprocal product on CUDA."""
    steps = torch.arange(1, k + 1, dtype=torch.int64, device=starts.device)
    frames = _wrap_i32(starts.to(torch.int64)[:, None] + steps)
    retire = _wrap_i32(frames.to(torch.int64) - retention)
    times = frames.to(torch.float32) / torch.full_like(frames, fps, dtype=torch.float32)
    return frames, retire, times


def _as_input(x: Any, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device`` without a host-to-device copy: a
    tensor must already lie there; a numpy array is taken as is only for
    a CPU world."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"resim inputs lie on {x.device}, the world on {device}")
        return x
    if device.type != "cpu":
        raise TypeError(
            "resim inputs must be tensors on the world's device; stage host "
            "arrays through utils.staging (pinned, non-blocking) first"
        )
    return torch.from_numpy(np.ascontiguousarray(x))


def _is_sharded(state: WorldState) -> bool:
    """Whether the world is entity-sharded (DTensor leaves)."""
    return is_dtensor(state.alive)


def _empty_stack(state: WorldState, k: int) -> WorldState:
    if _is_sharded(state):
        return tree_map(lambda a: _empty_dtensor_stack(a, k), state)
    return tree_map(
        lambda a: torch.empty((k, *a.shape), dtype=a.dtype, device=a.device), state
    )


def _empty_dtensor_stack(a, k: int):
    """A ``[k, ...]`` stack for a DTensor leaf: each rank's local block,
    wrapped with the leaf's placements shifted past the new frame axis."""
    from torch.distributed.tensor import DTensor, Shard

    local = a.to_local()
    stack = torch.empty((k, *local.shape), dtype=local.dtype, device=local.device)
    placements = [Shard(p.dim + 1) if p.is_shard() else p for p in a.placements]
    return DTensor.from_local(stack, a.device_mesh, placements, run_check=False)


def _settle(state: WorldState) -> WorldState:
    """An entity-sharded state with every pending sum resolved: a leaf a
    step computed as a sum over the sharded rows (``spawn``'s count into
    ``next_id``) is a ``Partial`` DTensor, reduced here to the replicated
    value so the frame's stack and the next frame read the whole value."""
    from torch.distributed.tensor import Replicate

    def settle(a):
        if any(p.is_partial() for p in a.placements):
            return a.redistribute(a.device_mesh, [
                Replicate() if p.is_partial() else p for p in a.placements])
        return a

    return tree_map(settle, state)


def _write_frame(stacked: WorldState, i: int, state: WorldState) -> None:
    if _is_sharded(state):
        # DTensor's copy_ into a view refuses; the (settled) local blocks
        # line up with the stack's
        tree_map(lambda dst, src: dst.to_local()[i].copy_(src.to_local()), stacked, state)
        return
    tree_map(lambda dst, src: dst[i].copy_(src), stacked, state)


def resim(
    reg: Registry,
    step_fn: StepFn,
    state: WorldState,
    inputs_seq,  # [k, num_players, *input_shape]
    status_seq,  # int8[k, num_players]
    start_frame: int,  # the frame the state currently sits at
    retention: int,
    fps: int,
    seed: int = 0,
) -> Tuple[WorldState, WorldState, torch.Tensor]:
    """Advance ``k`` frames.

    Returns ``(final_state, stacked_states, checksums)``: ``stacked_states``
    holds the state after each advance (leading axis k — the per-frame
    SaveWorld outputs) and ``checksums`` is ``[k, 2]`` (u32 in int64)."""
    dev = state.device
    inputs_seq = _as_input(inputs_seq, dev)
    status_seq = _as_input(status_seq, dev)
    k = inputs_seq.shape[0]
    stacked = _empty_stack(state, k)
    sharded = _is_sharded(state)
    frame = int(start_frame)
    for i in range(k):
        frame = frame_add(frame, 1)
        state = advance(reg, step_fn, state, inputs_seq[i], status_seq[i],
                        frame, retention, fps, seed)
        if sharded:
            state = _settle(state)
        _write_frame(stacked, i, state)
    return state, stacked, world_checksums(reg, stacked)


def resim_padded(
    reg: Registry,
    step_fn: StepFn,
    state: WorldState,
    inputs_seq,  # [k_max, num_players, *input_shape]
    status_seq,  # int8[k_max, num_players]
    start_frame: int,
    n_real: int,  # how many leading frames actually advance
    retention: int,
    fps: int,
    seed: int = 0,
) -> Tuple[WorldState, WorldState, torch.Tensor]:
    """Fixed-length resim with masked padding: the first ``n_real`` frames
    advance, later rows repeat the carried state (and its checksum), as the
    JAX package's canonical program does."""
    dev = state.device
    inputs_seq = _as_input(inputs_seq, dev)
    status_seq = _as_input(status_seq, dev)
    k = inputs_seq.shape[0]
    n_real = int(n_real)
    stacked = _empty_stack(state, k)
    sharded = _is_sharded(state)
    frame = int(start_frame)
    for i in range(k):
        if i < n_real:
            frame = frame_add(frame, 1)
            state = advance(reg, step_fn, state, inputs_seq[i], status_seq[i],
                            frame, retention, fps, seed)
            if sharded:
                state = _settle(state)
        _write_frame(stacked, i, state)
    return state, stacked, world_checksums(reg, stacked)


def pad_repeat_last(arr, pad: int):
    """Extend the frame axis by repeating the last row ``pad`` times."""
    if pad == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])])
    arr = np.asarray(arr)
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])


def trim_frames(tree, k: int, axis: int = 0):
    """The first ``k`` frames along ``axis`` (0, or 1 for a branch
    stack), as views."""
    if axis == 0:
        return tree_map(lambda a: a[:k], tree)
    return tree_map(lambda a: a[:, :k], tree)


def make_resim_fn(reg: Registry, step_fn: StepFn, fps: int, retention: int = 16,
                  donate: bool = False, seed: int = 0):
    """k-frame resim ``fn(state, inputs_seq, status_seq, start_frame)`` ->
    ``(final, stacked, checksums)``.

    ``donate=True`` donates the input state: the passed state object is
    dead after the call and the caller must use the returned one.  Eager
    torch allocates ``final`` fresh either way, so donation writes nothing
    (a copy into the old storage would only add work); the results are the
    plain call's.  With the sanitizer armed, passing a donated state to any
    resim raises."""

    def fn(state, inputs_seq, status_seq, start_frame, _retire_unused=None):
        staging.sanitizer().guard_donated(state, "resim_fn")
        out = resim(reg, step_fn, state, inputs_seq, status_seq,
                    start_frame, retention, fps, seed)
        if donate:
            staging.sanitizer().donate(state, "donated resim input")
        return out

    return fn


def make_advance_fn(reg: Registry, step_fn: StepFn, fps: int, seed: int = 0,
                    retention: int = 16):
    """Single-frame advance ``fn(state, inputs, status, frame)`` ->
    ``(state, checksum)``, the JAX package's contract: one :func:`advance`
    computing ``frame``, then :func:`world_checksum` of the new state (one
    fold launch on the card).  ``inputs`` and ``status`` lie on the world's
    device (numpy only for a CPU world).  Unlike ``App.advance_fn`` it
    takes no host rows through a staging upload."""

    def fn(state, inputs, status, frame, _retire_unused=None):
        dev = state.device
        st = advance(reg, step_fn, state, _as_input(inputs, dev), _as_input(status, dev),
                     int(frame), retention, fps, seed)
        return st, world_checksum(reg, st)

    return fn


def make_packed_resim_fn(reg: Registry, step_fn: StepFn, spec: PackedSpec, fps: int,
                         retention: int = 16, donate: bool = False, seed: int = 0):
    """k-frame resim fed by ONE packed upload (``ops/packing.py``):
    ``fn(state, packed: PackedUpload) -> (final, stacked, checks)``.

    The inputs and statuses are split from ``packed.rows`` on its device by
    a bit reinterpretation, and the start frame is the host word staged
    with it, so the results are the unpacked function's bit for bit.
    ``donate=True`` donates the input state (as :func:`make_resim_fn`)."""
    plain = make_resim_fn(reg, step_fn, fps, retention, donate, seed)

    def fn(state, packed: PackedUpload):
        inputs_seq, status_seq = unpack_seq(spec, packed.rows)
        return plain(state, inputs_seq, status_seq, packed.start_frame)

    return fn


def make_packed_canonical_resim_fn(reg: Registry, step_fn: StepFn, spec: PackedSpec,
                                   fps: int, retention: int = 16, k_max: int = 16,
                                   seed: int = 0):
    """Packed variant of :func:`make_canonical_resim_fn`:
    ``fn(state, packed int8[k_max + 1, W]) -> (final, stacked, checks)``
    with the real advance count in ``packed.n_real`` (a host word).  The
    stacked states and checksums come back untrimmed at ``k_max`` rows;
    rows below ``n_real`` are the trimmed ones.  No donating variant, as
    in the JAX package (canonical mode runs one program for every call)."""

    def fn(state, packed: PackedUpload):
        inputs_seq, status_seq = unpack_seq(spec, packed.rows)
        staging.sanitizer().guard_donated(state, "packed_resim_fn")
        if inputs_seq.shape[0] != k_max:
            raise ValueError(f"packed canonical resim takes {k_max} rows, "
                             f"not {inputs_seq.shape[0]}")
        return resim_padded(reg, step_fn, state, inputs_seq, status_seq,
                            packed.start_frame, packed.n_real, retention, fps, seed)

    return fn


def make_canonical_resim_fn(reg: Registry, step_fn: StepFn, fps: int,
                            retention: int = 16, k_max: int = 16, seed: int = 0):
    """:func:`resim_padded` at a fixed ``k_max``, wrapped to the plain
    resim_fn signature (pads, runs, trims)."""

    def fn(state, inputs_seq, status_seq, start_frame, _unused=None):
        staging.sanitizer().guard_donated(state, "resim_fn")
        k = inputs_seq.shape[0]
        if k > k_max:
            raise ValueError(
                f"resim depth {k} exceeds canonical_depth {k_max}; raise "
                "App(canonical_depth=...) above every session window"
            )
        pad = k_max - k
        final, stacked, checks = resim_padded(
            reg, step_fn, state, pad_repeat_last(inputs_seq, pad),
            pad_repeat_last(status_seq, pad), start_frame, k, retention, fps, seed,
        )
        if pad:
            stacked, checks = trim_frames((stacked, checks), k)
        return final, stacked, checks

    return fn


# -- the branch axis (speculation) ------------------------------------------

#: Ops that ``torch.func.vmap`` ran lane by lane on the branch axis because
#: they have no batching rule (counted from functorch's fallback warning).
#: A plain counter: reset it to 0 before a run you want to count.
vmap_fallbacks = 0

_FALLBACK_WARNING = "There is a performance drop because we have not yet implemented"


def _advance_lanes(reg: Registry, step_fn: StepFn, template: WorldState, leaves: list,
                   batched: bool, inputs: torch.Tensor, status: torch.Tensor,
                   clock, retention: int, fps: int, seed: int = 0) -> list:
    """One :func:`advance` on every lane: ``torch.func.vmap`` over the
    world's leaves (batched on axis 0, or one state for all lanes), the
    lanes' inputs and statuses.  ``clock`` is the host frame every lane
    computes (the branch axis) or the lanes' own ``(frame, retire_frame,
    time_seconds)`` device vectors (the lane axis, :func:`lane_clocks`).
    Returns the new leaves, ``[M, ...]``."""
    global vmap_fallbacks

    if isinstance(clock, tuple):
        delta = np.float32(1.0 / fps)

        def one(lane_leaves, inp, st, frame, retire, time_s):
            out = _advance_ctx(reg, step_fn, tree_unflatten(template, lane_leaves),
                               StepCtx(inp, st, frame, retire, time_s, delta, seed))
            return tree_flatten(out)

        args = (leaves, inputs, status, *clock)
    else:
        def one(lane_leaves, inp, st):
            out = advance(reg, step_fn, tree_unflatten(template, lane_leaves), inp, st,
                          clock, retention, fps, seed)
            return tree_flatten(out)

        args = (leaves, inputs, status)
    in_dims = (0 if batched else None,) + (0,) * (len(args) - 1)
    lanes = torch.func.vmap(one, in_dims=in_dims)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            new = lanes(*args)
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                "the step failed under torch.func.vmap on the speculation branch "
                "axis or the many-worlds lane axis; such a step must batch (every "
                "op with a batching rule, no in-place write of a batched value "
                "into an unbatched tensor, no host read of a lane's clock): "
                f"{e}"
            ) from e
    for w in caught:
        if _FALLBACK_WARNING in str(w.message):
            vmap_fallbacks += 1
        else:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return new


def _lane_mask(advancing: Sequence[bool], device: torch.device) -> torch.Tensor:
    """``bool[M]`` of the advancing lanes, made on ``device`` by fills (no
    host-to-device copy)."""
    mask = torch.zeros(len(advancing), dtype=torch.bool, device=device)
    b = 0
    while b < len(advancing):
        if advancing[b]:
            e = b
            while e < len(advancing) and advancing[e]:
                e += 1
            mask[b:e] = True
            b = e
        else:
            b += 1
    return mask


def resim_branches(
    reg: Registry,
    step_fn: StepFn,
    state: WorldState,
    inputs_b,  # [M, k, num_players, *input_shape]
    status_b,  # int8[M, k, num_players]
    start_frame: int,
    retention: int,
    fps: int,
    n_real: Optional[Sequence[int]] = None,  # host ints, one per lane
    seed: int = 0,
) -> Tuple[WorldState, WorldState, torch.Tensor]:
    """Advance M lanes ``k`` frames from one ``state``, each on its own
    inputs: the branch-axis :func:`resim` (see module docstring).

    Returns ``(finals, stacked, checksums)`` with a leading lane axis:
    ``finals`` ``[M, ...]``, ``stacked`` ``[M, k, ...]`` and ``checksums``
    ``[M, k, 2]``.  With ``n_real``, lane ``b`` advances its first
    ``n_real[b]`` frames and repeats its carried state (and checksum) after
    them, as :func:`resim_padded` does."""
    return resim_lanes(reg, step_fn, state, inputs_b, status_b, int(start_frame),
                       retention, fps, n_real, batched=False, seed=seed)


def resim_lanes(
    reg: Registry,
    step_fn: StepFn,
    state: WorldState,
    inputs_b,  # [M, k, num_players, *input_shape]
    status_b,  # int8[M, k, num_players]
    clock,  # a host start frame for every lane, or int32[M] device starts
    retention: int,
    fps: int,
    n_real: Optional[Sequence[int]] = None,  # host ints, one per lane
    batched: bool = False,
    n_real_dev: Optional[torch.Tensor] = None,  # the same counts, int32[M] on the device
    seed: int = 0,
) -> Tuple[WorldState, WorldState, torch.Tensor]:
    """The lane engine under :func:`resim_branches` and the many-worlds
    waves (``ops/batch.py``).  ``state`` is one world for every lane, or
    with ``batched=True`` an ``[M, ...]`` world (lane ``b`` starts from
    row ``b``).  ``clock`` is a host int (every lane at the same frame:
    the branch axis, whose bits are the solo resim's) or an int32 ``[M]``
    tensor of per-lane start frames on the world's device, whose frames,
    retire horizons and times are computed there (:func:`lane_clocks`)
    and never read back.  ``n_real`` is a host decision, as in
    :func:`resim_branches`: which frames need a select.  With
    ``n_real_dev`` (the counts on the device, from a packed wave's
    prefix) each select's lane mask is one compare on the device, so the
    launches do not depend on which lanes hold."""
    dev = state.device
    inputs_b = _as_input(inputs_b, dev)
    status_b = _as_input(status_b, dev)
    m, k = inputs_b.shape[:2]
    counts = [k] * m if n_real is None else [int(n) for n in n_real]
    if len(counts) != m:
        raise ValueError(f"n_real has {len(counts)} lanes, the inputs {m}")
    leaves = tree_flatten(state)
    stacks = [torch.empty((m, k, *(a.shape[1:] if batched else a.shape)), dtype=a.dtype,
                          device=a.device) for a in leaves]
    if isinstance(clock, (int, np.integer)):
        clocks, frame = None, int(clock)
    else:
        clocks = lane_clocks(_as_input(clock, dev).to(torch.int32), k, retention, fps)
    masks = {}
    for i in range(k):
        advancing = tuple(i < n for n in counts)
        if not any(advancing):
            for dst, old in zip(stacks, leaves):
                dst[:, i].copy_(old)
        else:
            if clocks is None:
                frame = frame_add(frame, 1)
                lane_clock = frame
            else:
                lane_clock = tuple(c[:, i] for c in clocks)
            new = _advance_lanes(reg, step_fn, state, leaves, batched, inputs_b[:, i],
                                 status_b[:, i], lane_clock, retention, fps, seed)
            if all(advancing):
                for dst, src in zip(stacks, new):
                    dst[:, i].copy_(src)
            else:
                if n_real_dev is not None:
                    mask = n_real_dev > i
                else:
                    if advancing not in masks:
                        masks[advancing] = _lane_mask(advancing, dev)
                    mask = masks[advancing]
                for dst, src, old in zip(stacks, new, leaves):
                    keep = mask.view(m, *([1] * (src.dim() - 1)))
                    torch.where(keep, src, old, out=dst[:, i])
                new = [s[:, i] for s in stacks]
            leaves = new
            batched = True
    if not batched:  # no lane advanced: every frame is the start state
        leaves = [s[:, 0] for s in stacks] if k else [
            a.expand(m, *a.shape) for a in leaves]
    stacked = tree_unflatten(state, stacks)
    return tree_unflatten(state, leaves), stacked, branch_checksums(reg, stacked)


def make_speculate_fn(reg: Registry, step_fn: StepFn, fps: int, retention: int = 16,
                      seed: int = 0):
    """M speculative input branches from one state, in one call:
    ``fn(state, inputs_branches [M, k, P, ...], status_branches [M, k, P],
    start_frame) -> (finals[M], stacked[M, k], checksums[M, k, 2])``
    (:func:`resim_branches`).  Pick the branch matching the inputs that
    arrive with :func:`select_branch`."""

    def fn(state, inputs_branches, status_branches, start_frame, _retire_unused=None):
        staging.sanitizer().guard_donated(state, "speculate_fn")
        return resim_branches(reg, step_fn, state, inputs_branches, status_branches,
                              start_frame, retention, fps, seed=seed)

    return fn


def make_packed_speculate_fn(reg: Registry, step_fn: StepFn, spec: PackedSpec,
                             fps: int, retention: int = 16, seed: int = 0):
    """:func:`make_speculate_fn` fed by ONE packed upload: the M candidate
    branches ride an ``int8[M, depth + 1, W]`` buffer (a prefix row per
    lane), split on the card by :func:`~.packing.unpack_seq`:
    ``fn(state, packed: PackedUpload) -> (finals, stacked, checks)``."""

    def fn(state, packed: PackedUpload):
        staging.sanitizer().guard_donated(state, "packed_speculate_fn")
        inputs_b, status_b = unpack_seq(spec, packed.rows)
        return resim_branches(reg, step_fn, state, inputs_b, status_b,
                              packed.start_frame, retention, fps, seed=seed)

    return fn


def make_canonical_branched_fn(reg: Registry, step_fn: StepFn, fps: int,
                               retention: int = 16, k_max: int = 16,
                               branches: int = 8, seed: int = 0):
    """ONE fixed ``[branches, k_max]`` program for every dispatch, the
    bit-determinism-safe speculation shape: ``fn(state, inputs[B, K, P,
    ...], status[B, K, P], start_frame, n_real[B]) -> (finals[B],
    stacked[B, K], checks[B, K, 2])``, ``n_real`` host ints.

    Lane 0 carries the real inputs (its lane is the authoritative result);
    lanes 1.. evaluate hedge candidates in the same call.  Lanes are
    independent, so lane 0 computes what the canonical resim computes,
    whatever the other lanes hold."""

    def fn(state, inputs_b, status_b, start_frame, n_real):
        staging.sanitizer().guard_donated(state, "branched_fn")
        if tuple(inputs_b.shape[:2]) != (branches, k_max):
            raise ValueError(f"the branched program takes [{branches}, {k_max}] "
                             f"lanes x frames, not {list(inputs_b.shape[:2])}")
        if isinstance(n_real, torch.Tensor):
            n_real = n_real.tolist()
        return resim_branches(reg, step_fn, state, inputs_b, status_b, start_frame,
                              retention, fps, n_real=n_real, seed=seed)

    return fn


def select_branch(tree, idx: int):
    """Lane ``idx`` of a branch-axis output (views)."""
    return tree_map(lambda a: a[idx], tree)


def slice_frame(stacked_states, i: int):
    """The state after the ``(i + 1)``-th advance of a stacked resim output
    (views)."""
    return tree_map(lambda a: a[i], stacked_states)


class _CallableModule(types.ModuleType):
    """This module, callable as its :func:`resim`.  The JAX package's
    ``ops`` exports the function ``resim`` under the module's own name;
    here ``bevy_ggrs_tpu_torch.ops.resim`` stays the module (its helpers
    keep resolving) and a call to it is a call to :func:`resim`."""

    def __call__(self, *args, **kwargs):
        return resim(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
