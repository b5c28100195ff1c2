"""Many worlds: the frame engine over a leading LOBBY axis.

Port of ``bevy_ggrs_tpu/ops/batch.py`` (its single-device part).  M
independent game worlds (the lobbies of a game server, a tournament
bracket) live as ONE ``[M, ...]`` stacked world, and a wave advances every
lobby's pending frames in one call: :func:`~.resim.resim_lanes`, the
branch axis's ``torch.func.vmap`` over one frame's advance, with the
world batched on the lane axis and every lane on its own clock (int32
start frames on the device; the frame, retire horizon and time computed
there, never read back).  The stacks are ``[M, k, ...]`` and the checksum
fold folds them viewed as ``[M·k, N]`` in ONE launch; the checksums come
out flat, ``[M·k, 2]``, row ``b·k + i``.

Lane independence: each lane computes what the solo resim computes on
that lobby's inputs.  Eager torch runs the same elementwise kernels on a
wider tensor, so a lane is bit-equal to a solo run (held on the CPU by
``tests/test_torch_batch.py`` and on the card by ``chip_smoke.py``;
:mod:`.variant_probe` checks a given app).  Canonical modes are refused
with the JAX package's error, since there the one program's shape is a
lobby-wide constant.

:class:`BucketedWaveExecutor` picks each wave's program: the smallest
power-of-two depth bucket covering its hottest lobby, the exact program
when every lane advances exactly that many frames, else the
``n_real``-masked one.  A packed wave is one ``int8[M, k + 1, W]`` upload
from pinned staging (``ops/packing.py``).

Left out: XLA's knobs (``unroll``, ``fused_checksums``: eager torch has
one program, and the fold always runs once after the frame loop), the
executor's ``recycle_outputs`` and the exact programs' ``donate_outputs``
(XLA reuses a donated buffer's memory; eager torch has nothing to reuse,
and no caller of the port keeps a wave's outputs dead), the executor's
compile timings and jit-cache census (nothing compiles), and the sharded
functions, ``ShardedWaveExecutor`` and their ``_pad_rows`` (multi-device,
ROADMAP A6).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..snapshot.lazy import tree_index
from ..telemetry.flight import flight_recorder
from ..telemetry.metrics import LATENCY_MS_BUCKETS, registry
from ..utils import staging
from ..utils.staging import StagingQueue
from ..utils.tree import tree_map
from .packing import PackedWave, unpack_seq, wave_n_real, wave_starts
from .resim import _as_input, resim_lanes

_CANONICAL_REFUSAL = (
    "many-worlds batching is incompatible with canonical mode: the batched "
    "program differs from the single-lobby canonical program every peer "
    "dispatches, breaking the one-program bit-determinism guarantee (see "
    "make_batched_resim_fn docstring)"
)


def _refuse_canonical(app) -> None:
    if app.canonical_depth is not None or app.canonical_branches is not None:
        raise ValueError(_CANONICAL_REFUSAL)


def stack_worlds(worlds: List):
    """Stack M structurally identical worlds into one ``[M, ...]`` world."""
    return tree_map(lambda *xs: torch.stack(xs), *worlds)


def unstack_world(batched, i: int):
    """Lobby ``i`` of a stacked world (views)."""
    return tree_index(batched, i)


def _wave(app, worlds, inputs_b, status_b, starts, n_real=None, n_real_dev=None):
    """One wave: ``(finals[M], stacked[M, k], checks[M, k, 2])``."""
    return resim_lanes(app.reg, app.step, worlds, inputs_b, status_b, starts,
                       app.retention, app.fps, n_real, batched=True, n_real_dev=n_real_dev,
                       seed=app.seed)


def make_batched_resim_fn(app):
    """Every lobby advances k frames from its own start frame, in one call:
    ``fn(worlds[M], inputs[M, k, P, ...], status[M, k, P], starts int32[M])
    -> (finals[M], stacked[M, k], checksums[M, k, 2])``.  The inputs and
    start frames lie on the worlds' device (numpy only for a CPU world).

    Refuses canonical-mode apps (the JAX package's rationale: batching
    would run a different program than the one canonical program every
    peer of a lobby runs)."""
    _refuse_canonical(app)

    def fn(worlds, inputs_b, status_b, starts):
        staging.sanitizer().guard_donated(worlds, "batched_resim_fn")
        return _wave(app, worlds, inputs_b, status_b, starts)

    return fn


def make_batched_padded_fn(app, k_max: int):
    """The masked wave: every lobby advances up to ``k_max`` frames, lobby
    ``b`` its first ``n_real[b]`` (0 passes its lane through):
    ``fn(worlds[M], inputs[M, k_max, P, ...], status[M, k_max, P],
    starts int32[M], n_real) -> (finals[M], stacked[M, k_max],
    checks_flat[M * k_max, 2])``.  ``n_real`` is host ints (the mask's
    shape is a host decision, as on the branch axis).  The JAX package's
    ``donate`` option is left out: no caller donates the worlds, and eager
    torch would write nothing in place."""
    _refuse_canonical(app)

    def fn(worlds, inputs_b, status_b, starts, n_real):
        staging.sanitizer().guard_donated(worlds, "batched_padded_fn")
        if inputs_b.shape[1] != k_max:
            raise ValueError(f"the padded wave takes {k_max} frames, not {inputs_b.shape[1]}")
        finals, stacked, checks = _wave(app, worlds, inputs_b, status_b, starts,
                                        [int(n) for n in n_real])
        return finals, stacked, checks.reshape(-1, 2)

    return fn


def make_batched_exact_fn(app, k: int):
    """The unmasked full wave: every lane advances exactly ``k`` frames:
    ``fn(worlds[M], inputs[M, k, P, ...], status[M, k, P], starts int32[M])
    -> (finals[M], stacked[M, k], checks_flat[M * k, 2])``."""
    _refuse_canonical(app)

    def fn(worlds, inputs_b, status_b, starts):
        staging.sanitizer().guard_donated(worlds, "batched_exact_fn")
        if inputs_b.shape[1] != k:
            raise ValueError(f"the exact wave takes {k} frames, not {inputs_b.shape[1]}")
        finals, stacked, checks = _wave(app, worlds, inputs_b, status_b, starts)
        return finals, stacked, checks.reshape(-1, 2)

    return fn


def make_batched_packed_padded_fn(app, k: int):
    """Single-upload :func:`make_batched_padded_fn`: ``fn(worlds[M],
    packed: PackedWave) -> (finals, stacked, checks_flat)``.  Each lane's
    prefix carries its start frame, read on the device, and its
    ``n_real``, whose host copy shapes the mask; the unpack is a bit
    reinterpretation, so lanes equal the unpacked program's bit for bit."""
    _refuse_canonical(app)
    spec = app.packed_spec

    def fn(worlds, packed: PackedWave):
        staging.sanitizer().guard_donated(worlds, "batched_packed_padded_fn")
        inputs_b, status_b = unpack_seq(spec, packed.rows)
        if inputs_b.shape[1] != k:
            raise ValueError(f"the packed wave takes {k} frames, not {inputs_b.shape[1]}")
        finals, stacked, checks = _wave(app, worlds, inputs_b, status_b,
                                        wave_starts(packed.rows), packed.n_real,
                                        wave_n_real(packed.rows))
        return finals, stacked, checks.reshape(-1, 2)

    return fn


def make_batched_packed_exact_fn(app, k: int):
    """Single-upload :func:`make_batched_exact_fn`: ``fn(worlds[M],
    packed: PackedWave) -> (finals, stacked, checks_flat)`` (every lane
    advances exactly ``k``; the prefix's ``n_real`` is not read)."""
    _refuse_canonical(app)
    spec = app.packed_spec

    def fn(worlds, packed: PackedWave):
        staging.sanitizer().guard_donated(worlds, "batched_packed_exact_fn")
        inputs_b, status_b = unpack_seq(spec, packed.rows)
        if inputs_b.shape[1] != k:
            raise ValueError(f"the packed wave takes {k} frames, not {inputs_b.shape[1]}")
        finals, stacked, checks = _wave(app, worlds, inputs_b, status_b,
                                        wave_starts(packed.rows))
        return finals, stacked, checks.reshape(-1, 2)

    return fn


def bucket_sizes(k_max: int) -> Tuple[int, ...]:
    """Power-of-two depth buckets up to (and always including) ``k_max``:
    ``bucket_sizes(12) == (1, 2, 4, 8, 12)``."""
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    sizes, b = [], 1
    while b < k_max:
        sizes.append(b)
        b *= 2
    sizes.append(k_max)
    return tuple(sizes)


_BUILDERS = {
    "exact": make_batched_exact_fn,
    "padded": make_batched_padded_fn,
    "packed_exact": make_batched_packed_exact_fn,
    "packed_padded": make_batched_packed_padded_fn,
}


class BucketedWaveExecutor:
    """Shape-bucketed dispatcher for the batched runner's waves.

    A wave dispatches the smallest bucket of :func:`bucket_sizes` covering
    its hottest lobby's advance count: the ``exact`` program when every
    lane advances exactly that many frames, the masked ``padded`` one
    otherwise.  Host arrays are staged through pinned buffers (one
    :class:`~..utils.staging.StagingQueue` per array and bucket) and
    uploaded without a host wait: ``run_wave`` uploads inputs, statuses
    and start frames (3 copies), ``run_wave_packed`` one buffer.
    Counters: ``dispatch_count``, ``compile_count`` (programs
    built, per kind and bucket), :attr:`bucket_hist`, ``host_uploads`` and
    ``packed_upload_bytes``, all in :meth:`stats`; while telemetry is on,
    the JAX executor's pre-bound families (``batched_wave_dispatches_total``,
    ``batched_program_compiles_total``, ``uploads_per_dispatch``,
    ``packed_upload_bytes``).  :attr:`compile_ms` holds each ``(kind,
    bucket)`` program's first-dispatch wall time, also recorded in the
    flight ring and (telemetry on) ``program_compile_ms``: eager torch
    compiles nothing, so it times the first call's host work."""

    def __init__(self, app, k_max: int):
        _refuse_canonical(app)
        self.app = app
        self.device = app.device
        self.k_max = int(k_max)
        self.buckets = bucket_sizes(self.k_max)
        self._fns: Dict[Tuple[str, int], object] = {}
        self._stages: Dict[Tuple[str, tuple, str], StagingQueue] = {}
        self.compile_count = 0
        self.dispatch_count = 0
        self.bucket_hist: Dict[int, int] = {b: 0 for b in self.buckets}
        self.host_uploads = 0
        self.packed_upload_bytes = 0
        self.compile_ms: Dict[str, float] = {}
        self._timed: set = set()
        self._owner = "wave"
        reg = registry()
        self._m_dispatches = reg.bind_counter(
            "batched_wave_dispatches_total", "wave dispatches through the bucketed executor")
        self._m_compiles = reg.bind_counter(
            "batched_program_compiles_total", "bucketed wave programs built (kind x bucket)")
        self._m_uploads = reg.bind_histogram(
            "uploads_per_dispatch",
            "host->device uploads issued per fused dispatch (1 on the packed path)",
            buckets=(1, 2, 3, 4, 8))
        self._m_packed_bytes = reg.bind_counter(
            "packed_upload_bytes", "bytes staged through packed single-upload buffers")

    def _note_uploads(self, n: int, nbytes: int = 0) -> None:
        self.host_uploads += n
        self._m_uploads.observe(n)
        if nbytes:
            self.packed_upload_bytes += nbytes
            self._m_packed_bytes.inc(nbytes)

    def bucket_for(self, k_hot: int) -> int:
        """Smallest bucket >= ``k_hot`` (raises beyond ``k_max``)."""
        if k_hot > self.k_max:
            raise ValueError(f"wave depth {k_hot} exceeds k_max={self.k_max}")
        return next(b for b in self.buckets if b >= k_hot)

    def _get_fn(self, kind: str, bucket: int):
        fn = self._fns.get((kind, bucket))
        if fn is None:
            fn = self._fns[(kind, bucket)] = _BUILDERS[kind](self.app, bucket)
            self.compile_count += 1
            self._m_compiles.inc()
        return fn

    def _dispatch(self, kind: str, bucket: int, *args):
        """Call the ``(kind, bucket)`` wave program, timing its first call
        (:attr:`compile_ms`); later calls pay one set lookup."""
        key = (kind, bucket)
        if key in self._timed:
            return self._fns[key](*args)
        fn = self._get_fn(kind, bucket)
        t0 = time.perf_counter()
        out = fn(*args)
        ms = (time.perf_counter() - t0) * 1e3
        self._timed.add(key)
        self.compile_ms[f"{kind}_k{bucket}"] = round(ms, 3)
        flight_recorder().record("compile", owner=self._owner, program=kind, k=bucket,
                                 ms=round(ms, 3))
        reg = registry()
        if reg.enabled:
            reg.histogram(
                "program_compile_ms",
                "wall ms of each program variant's first dispatch (trace+compile)",
                buckets=LATENCY_MS_BUCKETS).observe(ms, owner=self._owner, kind=kind)
        return out

    def _upload(self, name: str, host) -> torch.Tensor:
        """``host`` (a numpy view) on the device: as it is for a CPU world
        or a tensor already there, else one non-blocking copy from a pinned
        buffer of this name and shape."""
        if isinstance(host, torch.Tensor):
            return _as_input(host, self.device)
        host = np.asarray(host)
        if self.device.type == "cpu":
            return torch.from_numpy(np.array(host))
        key = (name, host.shape, host.dtype.str)
        stage = self._stages.get(key)
        if stage is None:
            stage = self._stages[key] = StagingQueue(
                lambda: np.zeros(host.shape, host.dtype), device=self.device)
        buf = stage.acquire()
        buf[...] = host
        return stage.commit(buf)

    def _plan(self, ks) -> Tuple[List[int], int, bool]:
        ks = [int(k) for k in ks]
        k_hot = max(ks)
        if k_hot <= 0:
            raise ValueError("run_wave needs at least one advancing lobby")
        bucket = self.bucket_for(k_hot)
        self.dispatch_count += 1
        self.bucket_hist[bucket] += 1
        self._m_dispatches.inc()
        return ks, bucket, all(k == bucket for k in ks)

    def run_wave(self, worlds, inputs, status, starts, ks):
        """Dispatch one wave; returns ``(bucket, finals, stacked,
        checks_flat)``.  ``inputs``/``status`` are ``[M, >= bucket, ...]``
        (host arrays, or tensors on the device), sliced to the bucket here;
        ``ks`` is each lobby's advance count (0 = idle); ``checks_flat``
        rows are ``b * bucket + i``."""
        ks, bucket, exact = self._plan(ks)
        inp = self._upload("inputs", inputs[:, :bucket])
        st = self._upload("status", status[:, :bucket])
        starts = self._upload("starts", np.asarray(starts, np.int32)
                              if not isinstance(starts, torch.Tensor) else starts)
        self._note_uploads(3)
        if exact:
            finals, stacked, checks = self._dispatch("exact", bucket, worlds, inp, st, starts)
        else:
            finals, stacked, checks = self._dispatch("padded", bucket, worlds, inp, st,
                                                     starts, ks)
        return bucket, finals, stacked, checks

    def run_wave_packed(self, worlds, packed, ks):
        """Dispatch one wave fed by the packed host buffer ``int8[M, >=
        bucket + 1, W]`` (each lane's prefix carries its start frame and
        ``n_real``, ``ops/packing.py``); the same return contract as
        :meth:`run_wave`.  The whole wave is ONE upload."""
        ks, bucket, exact = self._plan(ks)
        rows = self._upload("packed", packed[:, :bucket + 1])
        self._note_uploads(1, rows.numel())
        wave = PackedWave(rows, tuple(ks))
        kind = "packed_exact" if exact else "packed_padded"
        finals, stacked, checks = self._dispatch(kind, bucket, worlds, wave)
        return bucket, finals, stacked, checks

    def staging_waits(self) -> Tuple[int, int]:
        """``(deferred_blocks, landed_free)`` over the executor's staging."""
        return (sum(s.deferred_blocks for s in self._stages.values()),
                sum(s.landed_free for s in self._stages.values()))

    def stats(self) -> dict:
        """Dispatches, programs built, the per-bucket dispatch histogram
        and the upload census."""
        return {
            "wave_dispatches": self.dispatch_count,
            "program_compiles": self.compile_count,
            "bucket_hist": {k: v for k, v in self.bucket_hist.items() if v},
            "host_uploads": self.host_uploads,
            "packed_upload_bytes": self.packed_upload_bytes,
            "compile_ms": dict(self.compile_ms),
        }


class DraftWaveScheduler:
    """Assign speculative draft branches to the wave lanes the active
    bucket left idle (the batched runner's speculation).

    ``plan()`` fills exactly the given idle lanes with candidate branches,
    round-robin across the drafting lobbies so one lobby's wide fan cannot
    starve the rest, and never touches an active lane.  Candidates that do
    not fit this tick are dropped (``dropped_candidates``), not queued: a
    stale draft for a frame the session has moved past is never looked up
    again."""

    def __init__(self, m_pad: int):
        self.m_pad = int(m_pad)
        self.waves_planned = 0
        self.lanes_filled = 0
        self.dropped_candidates = 0

    def plan(self, idle_lanes: Sequence[int],
             wants: Sequence[Tuple[int, int]]) -> List[Tuple[int, int, int]]:
        """``wants`` is ``[(lobby, n_candidates)]``; returns assignments
        ``[(lobby, candidate_index, lane)]`` using at most the idle lanes."""
        lanes = list(idle_lanes)
        queues = [[b, 0, n] for b, n in wants if n > 0]  # lobby, next, total
        out: List[Tuple[int, int, int]] = []
        qi = 0
        while lanes and queues:
            if qi >= len(queues):
                qi = 0
            b, nxt, total = queues[qi]
            out.append((b, nxt, lanes.pop(0)))
            queues[qi][1] = nxt + 1
            if nxt + 1 >= total:
                queues.pop(qi)
            else:
                qi += 1
        self.waves_planned += 1
        self.lanes_filled += len(out)
        self.dropped_candidates += sum(t - n for _b, n, t in queues)
        return out
