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

Lobbies across devices: :class:`ShardedWaveExecutor` splits the lobby
axis over a lobby mesh (``parallel/mesh.make_lobby_mesh``) in contiguous
blocks of ``M_pad / D`` lanes.  Lobbies never communicate, so there are no
collectives: a wave is one pinned staging buffer with one non-blocking
upload of each shard's block to its device, then one call of the same
lane program per shard (:func:`make_sharded_packed_padded_fn` and its
three siblings), all launched before anything waits, and one checksum
fold launch per shard.  Its values are :class:`~..snapshot.lazy.LobbyShards`
(one tree per shard, each on its own device).

Left out: XLA's knobs (``unroll``, ``fused_checksums``: eager torch has
one program, and the fold always runs once after the frame loop), the
executor's ``recycle_outputs`` and the exact programs' ``donate_outputs``
(XLA reuses a donated buffer's memory; eager torch has nothing to reuse,
and no caller of the port keeps a wave's outputs dead), and the
executor's jit-cache census (nothing compiles).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..snapshot.lazy import LobbyShards, tree_index
from ..telemetry.flight import flight_recorder
from ..telemetry.metrics import LATENCY_MS_BUCKETS, registry
from ..utils import compile_guard, staging
from ..utils.staging import StagingQueue
from ..utils.tree import tree_flatten, tree_map
from .packing import PackedWave, pack_prefix, unpack_seq, wave_n_real, wave_starts
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
    # bgt: ignore[BGT071]: len(worlds) is the caller's lobby count — bucketed
    # to wave capacity before dispatch, so the stacked length is stable per bucket
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
        compile_guard.notify(self._owner, kind, ms)
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


# -- the lobby-sharded many-worlds executor -----------------------------------


def _shard_calls(fn, worlds: LobbyShards, *per_shard):
    """``fn`` on every shard's block, each with its own arguments, all
    launched before anything waits (eager launches never wait); the
    outputs as one :class:`LobbyShards` each."""
    outs = [fn(w, *args) for w, *args in zip(worlds.parts, *per_shard)]
    return tuple(LobbyShards([o[j] for o in outs], worlds.lanes) for j in range(3))


def _lane_checks(fn):
    """A flat-checks lane program whose checksums come back ``[L, k, 2]``,
    so a shard's rows stay in lobby order."""

    def call(worlds, *args):
        finals, stacked, checks = fn(worlds, *args)
        return finals, stacked, checks.view(-1, stacked.alive.shape[1], 2)

    return call


def make_sharded_padded_fn(app, k: int, mesh):
    """The ``n_real``-masked wave over a lobby mesh: :func:`make_batched_padded_fn`
    on every shard's contiguous block of lanes, no collectives (lobbies
    never communicate; each shard's checksum fold runs on its own lanes).
    ``fn(worlds, inputs, status, starts, n_real)`` where each argument but
    ``worlds`` (a :class:`LobbyShards`) is a list with one entry per
    shard; returns ``(finals, stacked, checks)`` as :class:`LobbyShards`,
    the checks ``[L, k, 2]`` per shard."""
    _refuse_canonical(app)
    lane = _lane_checks(make_batched_padded_fn(app, k))

    def fn(worlds, inputs, status, starts, n_real):
        return _shard_calls(lane, worlds, inputs, status, starts, n_real)

    return fn


def make_sharded_exact_fn(app, k: int, mesh):
    """Exact-depth :func:`make_sharded_padded_fn` (every lane advances
    ``k``): ``fn(worlds, inputs, status, starts)``, per-shard lists."""
    _refuse_canonical(app)
    lane = _lane_checks(make_batched_exact_fn(app, k))

    def fn(worlds, inputs, status, starts):
        return _shard_calls(lane, worlds, inputs, status, starts)

    return fn


def make_sharded_packed_padded_fn(app, k: int, mesh):
    """Packed :func:`make_sharded_padded_fn`: ``fn(worlds, packed)`` with
    one :class:`~.packing.PackedWave` per shard (each shard reads its
    lanes' clocks from its own block's prefixes)."""
    _refuse_canonical(app)
    lane = _lane_checks(make_batched_packed_padded_fn(app, k))

    def fn(worlds, packed):
        return _shard_calls(lane, worlds, packed)

    return fn


def make_sharded_packed_exact_fn(app, k: int, mesh):
    """Packed :func:`make_sharded_exact_fn`: ``fn(worlds, packed)``, one
    :class:`~.packing.PackedWave` per shard."""
    _refuse_canonical(app)
    lane = _lane_checks(make_batched_packed_exact_fn(app, k))

    def fn(worlds, packed):
        return _shard_calls(lane, worlds, packed)

    return fn


_SHARDED_BUILDERS = {
    "exact": make_sharded_exact_fn,
    "padded": make_sharded_padded_fn,
    "packed_exact": make_sharded_packed_exact_fn,
    "packed_padded": make_sharded_packed_padded_fn,
}


class ShardedWaveExecutor(BucketedWaveExecutor):
    """:class:`BucketedWaveExecutor` whose waves split the lobby axis over
    a lobby mesh: the many-lobbies-across-devices executor.

    Same bucket/kind cache and :meth:`run_wave` contract as the parent;
    the differences:

    - programs come from :func:`make_sharded_padded_fn` and its siblings:
      shard ``d`` of ``D`` runs the parent's lane program on its
      contiguous ``M_pad / D`` block of lobby lanes, on its own device;
    - the worlds may be a :class:`~..snapshot.lazy.LobbyShards` (the
      runner's resident world) or one ``[M, ...]`` tree, which is split
      into blocks first; the outputs are :class:`LobbyShards` and the
      checksums a :class:`LobbyShards` of ``[L, bucket, 2]`` blocks, whose
      rows in lobby order are row ``b * bucket + i``
      (:class:`~..snapshot.lazy.BatchChecks` reads them that way);
    - waves whose lobby count M is not divisible by D are padded to
      ``M_pad = ceil(M / D) * D`` with idle lanes (``n_real = 0``, masked
      out by the padded program) and trimmed back to M (views, no device
      work); the batched runner pre-pads its resident world instead;
    - a packed wave stages into ONE pinned buffer and uploads each shard's
      block to its device without a host wait;
    - ``recycle_outputs`` is refused, as in the JAX package;
    - the pre-bound ``sharded_wave_dispatches_total`` and
      ``shard_program_compiles_total`` counters, and ``stats()
      ["shard_devices"]``.

    Bit equality: each shard runs the unsharded lane program on its lanes,
    and lanes never communicate, so every lane equals the unsharded wave's
    (``tests/test_torch_lobby_shard.py``, ``chip_smoke.py`` phase
    ``sharded``)."""

    def __init__(self, app, k_max: int, mesh, *, recycle_outputs: bool = False):
        if recycle_outputs:
            raise ValueError(
                "ShardedWaveExecutor does not support recycle_outputs "
                "(cross-wave donation of lobby-sharded buffers)")
        super().__init__(app, k_max)
        self.mesh = mesh
        self.devices = list(mesh.devices)
        self.n_devices = len(self.devices)
        self._owner = "sharded"
        reg = registry()
        self._m_sharded_dispatches = reg.bind_counter(
            "sharded_wave_dispatches_total",
            "wave dispatches through the lobby-sharded executor")
        self._m_shard_compiles = reg.bind_counter(
            "shard_program_compiles_total",
            "lobby-sharded wave programs built (kind x bucket)")

    def pad_lobbies(self, m: int) -> int:
        """Smallest multiple of the device count >= ``m``."""
        d = self.n_devices
        return -(-m // d) * d

    def _get_fn(self, kind: str, bucket: int):
        fn = self._fns.get((kind, bucket))
        if fn is None:
            if kind not in _SHARDED_BUILDERS:  # pragma: no cover
                raise ValueError(f"sharded executor has no {kind!r} programs")
            fn = self._fns[(kind, bucket)] = _SHARDED_BUILDERS[kind](
                self.app, bucket, self.mesh)
            self.compile_count += 1
            self._m_compiles.inc()
            self._m_shard_compiles.inc()
        return fn

    def _split(self, worlds, m_pad: int) -> LobbyShards:
        """The worlds as ``D`` blocks of ``m_pad / D`` lanes on their
        devices (a :class:`LobbyShards` of that layout passes through)."""
        lanes = m_pad // self.n_devices
        if isinstance(worlds, LobbyShards):
            if worlds.lanes != lanes or len(worlds) != m_pad:
                raise ValueError(f"the resident shards hold {len(worlds)} lobbies in "
                                 f"blocks of {worlds.lanes}, the wave {m_pad} in {lanes}")
            return worlds
        from ..parallel.mesh import shard_lobby_worlds

        m = tree_flatten(worlds)[0].shape[0]
        if m_pad > m:
            worlds = _pad_rows(worlds, m_pad - m)
        return shard_lobby_worlds(self.mesh, worlds)

    def _upload_blocks(self, name: str, host: np.ndarray, lanes: int) -> List[torch.Tensor]:
        """``host`` (``[M_pad, ...]``) staged once, each shard's block sent
        to its device: one pinned buffer, one non-blocking copy per shard."""
        host = np.asarray(host)
        dev0 = self.devices[0]
        if dev0.type == "cpu":
            return [torch.from_numpy(np.array(host[d * lanes:(d + 1) * lanes])).to(dev)
                    for d, dev in enumerate(self.devices)]
        key = (name, host.shape, host.dtype.str)
        stage = self._stages.get(key)
        if stage is None:
            stage = self._stages[key] = StagingQueue(
                lambda: np.zeros(host.shape, host.dtype), device=dev0)
        buf = stage.acquire()
        buf[...] = host
        return [stage.commit(buf[d * lanes:(d + 1) * lanes], dev)
                for d, dev in enumerate(self.devices)]

    def _plan_sharded(self, ks):
        ks, bucket, exact = self._plan(ks)
        self._m_sharded_dispatches.inc()
        return ks, bucket, exact

    def run_wave(self, worlds, inputs, status, starts, ks):
        """Dispatch one lobby-sharded wave (the parent's contract: returns
        ``(bucket, finals, stacked, checks)``, the checks' rows in lobby
        order at ``b * bucket + i`` over the CALLER's M lobbies).  Pads M
        to a device-count multiple when needed; padded lanes ride the
        masked program at ``n_real = 0`` and are trimmed from the
        outputs."""
        ks = [int(k) for k in ks]
        m = len(ks)
        m_pad = self.pad_lobbies(m)
        pad = m_pad - m
        inputs, status = np.asarray(inputs), np.asarray(status)
        starts = np.asarray(starts, np.int32)
        if pad:
            inputs = np.concatenate([inputs, np.repeat(inputs[-1:], pad, axis=0)])
            status = np.concatenate([status, np.repeat(status[-1:], pad, axis=0)])
            starts = np.concatenate([starts, np.zeros((pad,), np.int32)])
            ks = ks + [0] * pad
        ks, bucket, exact = self._plan_sharded(ks)
        shards = self._split(worlds, m_pad)
        lanes = shards.lanes
        inp = self._upload_blocks("inputs", np.ascontiguousarray(inputs[:, :bucket]), lanes)
        st = self._upload_blocks("status", np.ascontiguousarray(status[:, :bucket]), lanes)
        sts = self._upload_blocks("starts", starts, lanes)
        self._note_uploads(3)
        if exact:
            finals, stacked, checks = self._dispatch("exact", bucket, shards, inp, st, sts)
        else:
            n_real = [ks[d * lanes:(d + 1) * lanes] for d in range(self.n_devices)]
            finals, stacked, checks = self._dispatch("padded", bucket, shards, inp, st, sts,
                                                     n_real)
        if pad:
            finals, stacked, checks = self._trim_wave(finals, stacked, checks, m)
        return bucket, finals, stacked, checks

    def run_wave_packed(self, worlds, packed, ks):
        """Packed lobby-sharded wave (the parent's :meth:`run_wave_packed`
        contract).  Padded lanes get a zeroed prefix (``n_real = 0``) in
        the same staging buffer, so the wave stays one staged buffer."""
        ks = [int(k) for k in ks]
        m = len(ks)
        m_pad = self.pad_lobbies(m)
        pad = m_pad - m
        if pad:
            pad_block = np.repeat(packed[-1:], pad, axis=0)
            for r in range(pad):
                pack_prefix(pad_block[r], 0, 0)
            packed = np.concatenate([packed, pad_block])
            ks = ks + [0] * pad
        ks, bucket, exact = self._plan_sharded(ks)
        shards = self._split(worlds, m_pad)
        lanes = shards.lanes
        rows = self._upload_blocks("packed", np.ascontiguousarray(packed[:, :bucket + 1]),
                                   lanes)
        self._note_uploads(1, sum(r.numel() for r in rows))
        waves = [PackedWave(r, tuple(ks[d * lanes:(d + 1) * lanes]))
                 for d, r in enumerate(rows)]
        kind = "packed_exact" if exact else "packed_padded"
        finals, stacked, checks = self._dispatch(kind, bucket, shards, waves)
        if pad:
            finals, stacked, checks = self._trim_wave(finals, stacked, checks, m)
        return bucket, finals, stacked, checks

    def _trim_wave(self, finals, stacked, checks, m):
        """Drop the padded lobby rows from a wave's outputs (views of the
        shards' leading rows; no device work)."""
        return finals.trim(m), stacked.trim(m), checks.trim(m)

    def harvest_shards(self, outputs) -> dict:
        """Wait until a wave's outputs have retired on every shard's device
        and report the per-shard layout: shard count, shards touched and
        buffers per shard (keyed by the mesh's shard names, which tell
        logical shards of one card apart).  A flush point for measurement:
        never call it from the steady-state dispatch path."""
        names = self.mesh.shard_names()
        per_dev: Dict[str, int] = {}
        for out in outputs if isinstance(outputs, (tuple, list)) else (outputs,):
            if not isinstance(out, LobbyShards):
                continue
            for d, part in enumerate(out.parts):
                leaves = [a for a in tree_flatten(part) if isinstance(a, torch.Tensor)]
                if leaves and leaves[0].device.type == "cuda":
                    torch.cuda.synchronize(leaves[0].device)
                per_dev[names[d]] = per_dev.get(names[d], 0) + len(leaves)
        return {
            "n_devices": self.n_devices,
            "devices_touched": len(per_dev),
            "buffers_per_device": per_dev,
        }

    def stats(self) -> dict:
        """Parent counters plus ``shard_devices`` (the mesh's shard count)."""
        out = super().stats()
        out["shard_devices"] = self.n_devices
        return out


def _pad_rows(tree, pad: int):
    """Extend every leaf's leading (lobby) axis by ``pad`` rows repeating
    row 0 (one ``cat`` per leaf).  The pad lanes only ever run masked
    (``n_real = 0``), so their content is irrelevant; repeating a real row
    keeps the arithmetic finite."""
    return tree_map(lambda a: torch.cat([a, a[:1].expand(pad, *a.shape[1:])]), tree)


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
