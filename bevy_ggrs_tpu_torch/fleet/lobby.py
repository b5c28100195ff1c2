"""The fleet's unit of work: a deterministic, checkpointable lobby sim.

Port of ``bevy_ggrs_tpu/fleet/lobby.py``.  A :class:`LobbySim` is a
server-side lockstep lobby — app + world + frame + an input queue — that a
fleet worker hosts, advances in chunks, and can freeze into a single
checkpoint artifact (world + frame + the unsimulated input-queue tail, via
:mod:`..snapshot.persist`, the JAX package's format) for live migration or
failover.  Determinism contract: given the same :class:`LobbySpec` and the
same submitted inputs, a lobby produces bit-identical checksums at every
frame on every host of one device kind, whatever the chunking of its
advances.  The catalog apps are built with ``canonical_depth``, as in the
JAX package, so every advance runs through the one fixed-length program;
eager torch runs the same kernels per frame whatever the chunk, so a split
at any frame gives the straight run's bits.

Each chunk's inputs ride one packed upload (``ops/packing.py``) staged
through pinned memory (``utils/staging.StagingQueue``) into the canonical
packed program (``App.packed_resim_fn``), as ``App.advance_fn`` does; the
program's stacks and checksums come back untrimmed at ``LOBBY_CHUNK`` rows,
so the chunk's last checksum is row ``k - 1``.

Input modes:

- ``synthetic`` — inputs are a pure function of ``(spec.seed, frame)``
  (counter-based seeding, no sequential RNG state to checkpoint); any host
  can regenerate any frame's inputs after a failover.
- ``external`` — inputs arrive via :meth:`LobbySim.submit_input`; the sim
  only advances through frames whose inputs are queued, and the
  *unsimulated tail rides the checkpoint* — a migrated lobby must consume
  exactly the inputs its source had queued, or it desyncs.

A lobby runs on CUDA unless given ``device="cpu"``; the sizing helpers
(:func:`spec_est_bytes`) build nothing on a device.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Callable, Dict, Optional

import numpy as np

from ..app import App
from ..ops.packing import PackedUpload, pack_prefix, pack_row, prefix_words, repeat_last_row
from ..snapshot.checksum import checksum_to_int
from ..snapshot.persist import load_checkpoint, save_world, schema_digest
from ..utils.device import DeviceLike, resolve_device
from ..utils.staging import StagingQueue
from ..utils.tree import tree_leaves

# default per-advance chunk == the canonical program depth of catalog apps:
# one dispatch per chunk, and the padded program keeps partial chunks
# (barrier stops, target stops) bit-identical to full ones
LOBBY_CHUNK = 16


@dataclasses.dataclass(frozen=True)
class LobbySpec:
    """Everything needed to (re)build a lobby anywhere in the fleet.

    Travels as JSON in PLACE/RESUME/SUBMIT datagrams; ``est_bytes`` is the
    admission-control sizing hint (device-resident bytes the lobby will
    pin), defaulted from the app's world size when 0."""

    lobby_id: str
    app: str = "stress_soa"
    entities: int = 256
    players: int = 2
    seed: int = 0
    target_frames: int = 600
    input_mode: str = "synthetic"  # or "external"
    est_bytes: int = 0

    def to_json(self) -> dict:
        """The wire form (plain dict for protocol JSON tails)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "LobbySpec":
        """Rebuild from the wire form; unknown keys are ignored (forward
        compatibility across fleet versions)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in fields})


def _make_stress_soa(spec: LobbySpec, device: DeviceLike = None) -> App:
    from ..models import stress_soa

    return stress_soa.make_app(
        spec.entities, seed=spec.seed, canonical_depth=LOBBY_CHUNK, device=device
    )


def _make_box_game(spec: LobbySpec, device: DeviceLike = None) -> App:
    from ..models import box_game

    return box_game.make_app(
        num_players=spec.players, canonical_depth=LOBBY_CHUNK, device=device
    )


# app catalog: name -> App factory ``(spec, device)``.  Every entry MUST pass
# canonical_depth (see module docstring): the lobby's chunks run the packed
# canonical program.
APP_CATALOG: Dict[str, Callable[..., App]] = {
    "stress_soa": _make_stress_soa,
    "box_game": _make_box_game,
}


def synthetic_inputs(spec: LobbySpec, app, frame: int) -> np.ndarray:
    """The synthetic per-frame input row ``[players, *input_shape]``.

    Counter-based seeding — a pure function of (seed, frame) — so a resumed
    or failed-over lobby regenerates the identical stream with no RNG state
    in the checkpoint."""
    rng = np.random.default_rng((spec.seed, frame))
    shape = (app.num_players, *app.input_shape)
    if np.issubdtype(app.input_dtype, np.integer):
        return rng.integers(0, 16, size=shape).astype(app.input_dtype)
    return rng.uniform(-1, 1, size=shape).astype(app.input_dtype)


def _check_spec(spec: LobbySpec) -> None:
    if spec.app not in APP_CATALOG:
        raise ValueError(
            f"unknown lobby app {spec.app!r}; catalog: {sorted(APP_CATALOG)}"
        )
    if spec.input_mode not in ("synthetic", "external"):
        raise ValueError("input_mode must be 'synthetic' or 'external'")


class LobbySim:
    """One hosted lobby: app + world + frame + input queue, checkpointable.

    Drive with :meth:`step`; freeze with :meth:`checkpoint_bytes`; thaw on
    another host with :meth:`restore`.  ``frame`` is the last simulated
    (and, lockstep, confirmed) frame; the queue holds inputs for frames
    > ``frame``.  ``device`` is the lobby's device (``None`` = CUDA)."""

    def __init__(self, spec: LobbySpec, device: DeviceLike = None, _restored=None):
        _check_spec(spec)
        self.spec = spec
        if _restored is not None:
            self.app, self.world, self.frame = _restored
        else:
            self.app = APP_CATALOG[spec.app](spec, resolve_device(device))
            self.world = self.app.init_state()
            self.frame = 0
        self.device = self.app.device
        # pending inputs: frame -> [players, *input_shape] (external mode;
        # synthetic mode generates on demand)
        self.pending: Dict[int, np.ndarray] = {}
        self._status_row = np.zeros((self.app.num_players,), np.int8)
        self._last_checksum: Optional[int] = None
        self._rows = self.app.canonical_depth
        pspec = self.app.packed_spec
        self._stage = StagingQueue(lambda: pspec.new_buffer(self._rows), device=self.device)

    # -- inputs ------------------------------------------------------------

    def submit_input(self, frame: int, row) -> None:
        """Queue the input row for ``frame`` (external mode).  Frames at or
        below the simulated frame are already history — rejecting them here
        is what makes the checkpoint tail authoritative."""
        if self.spec.input_mode != "external":
            raise ValueError("submit_input on a synthetic-input lobby")
        if frame <= self.frame:
            raise ValueError(
                f"input for frame {frame} but lobby already simulated "
                f"frame {self.frame}"
            )
        row = np.asarray(row, self.app.input_dtype)
        want = (self.app.num_players, *self.app.input_shape)
        if row.shape != want:
            raise ValueError(f"input row shape {row.shape} != {want}")
        self.pending[frame] = row

    def _input_row(self, frame: int) -> Optional[np.ndarray]:
        if self.spec.input_mode == "synthetic":
            got = self.pending.pop(frame, None)
            if got is not None:
                return got
            return synthetic_inputs(self.spec, self.app, frame)
        return self.pending.pop(frame, None)

    def ready_frames(self, limit: int) -> int:
        """How many frames past ``self.frame`` could advance right now
        (bounded by ``limit``, the target frame, and — external mode — the
        contiguous queued prefix)."""
        room = min(limit, self.spec.target_frames - self.frame)
        if room <= 0:
            return 0
        if self.spec.input_mode == "synthetic":
            return room
        n = 0
        while n < room and (self.frame + n + 1) in self.pending:
            n += 1
        return n

    # -- advancing ---------------------------------------------------------

    @property
    def done(self) -> bool:
        """True once the lobby simulated its target frame."""
        return self.frame >= self.spec.target_frames

    def step(self, max_frames: int = LOBBY_CHUNK) -> int:
        """Advance up to ``max_frames`` frames in one chunked dispatch;
        returns how many frames actually advanced.  The chunk's inputs ride
        one pinned packed upload; the chunk's final checksum (row ``k - 1``
        of the untrimmed program output) is read back and retained."""
        k = self.ready_frames(max_frames)
        if k <= 0:
            return 0
        if k > self._rows:
            raise ValueError(
                f"resim depth {k} exceeds canonical_depth {self._rows}; step "
                f"at most LOBBY_CHUNK={self._rows} frames per call"
            )
        pspec = self.app.packed_spec
        buf = self._stage.acquire()
        pack_prefix(buf, self.frame, k)
        for i in range(k):
            row = self._input_row(self.frame + i + 1)
            if row is None:  # ready_frames counted it
                raise RuntimeError(f"no input for frame {self.frame + i + 1}")
            pack_row(pspec, buf, i, row, self._status_row)
        repeat_last_row(buf, k, self._rows)
        packed = PackedUpload(self._stage.commit(buf), *prefix_words(buf))
        final, _stacked, checks = self.app.packed_resim_fn(self.world, packed)
        self.world = final
        self.frame += k
        self._last_checksum = checksum_to_int(checks[k - 1])
        return k

    def run_to(self, frame: int, chunk: int = LOBBY_CHUNK) -> None:
        """Advance to exactly ``frame`` (synthetic mode / tests)."""
        while self.frame < min(frame, self.spec.target_frames):
            if self.step(min(chunk, frame - self.frame)) == 0:
                break

    def checksum(self) -> int:
        """The 64-bit world checksum at the current frame (forces a device
        readback — control-plane use, not hot-loop)."""
        return checksum_to_int(self.app.checksum_fn(self.world))

    # -- checkpoint / restore ---------------------------------------------

    def checkpoint_bytes(self) -> bytes:
        """Freeze world + frame + the unsimulated input-queue tail into one
        npz blob (the migration/failover artifact)."""
        tail = sorted(f for f in self.pending if f > self.frame)
        extras = {}
        if tail:
            extras["tail_frames"] = np.asarray(tail, np.int64)
            extras["tail_inputs"] = np.stack([self.pending[f] for f in tail])
        buf = io.BytesIO()
        save_world(buf, self.app.reg, self.world, frame=self.frame, extras=extras)
        return buf.getvalue()

    @classmethod
    def restore(cls, spec: LobbySpec, blob: bytes,
                device: DeviceLike = None) -> "LobbySim":
        """Thaw a checkpoint (the port's or the JAX package's) into a fresh
        sim on ``device`` (schema-checked, strict dtypes — see
        snapshot/persist.py) and re-queue its input tail.  Only the app is
        built before the load: no initial world is made on the device."""
        _check_spec(spec)
        app = APP_CATALOG[spec.app](spec, resolve_device(device))
        ck = load_checkpoint(io.BytesIO(blob), app.reg, device=app.device)
        sim = cls(spec, _restored=(app, ck.world, ck.frame))
        frames = ck.extras.get("tail_frames")
        if frames is not None:
            inputs = ck.extras["tail_inputs"]
            for i, f in enumerate(frames.tolist()):
                sim.pending[int(f)] = np.asarray(inputs[i], sim.app.input_dtype)
        return sim

    def state_digest(self) -> str:
        """Registry schema digest (control-plane sanity: a RESUME against a
        worker running a different build fails fast, by name)."""
        return schema_digest(self.app.reg)

    def est_bytes(self) -> int:
        """Device-resident footprint estimate for admission control: the
        world's tensor bytes, summed on the host (no device copy)."""
        return int(sum(t.nbytes for t in tree_leaves(self.world)))


def spec_est_bytes(spec: LobbySpec) -> int:
    """Admission sizing WITHOUT building device state: world bytes computed
    from the registry's template shapes on the CPU (equal to the JAX
    package's number)."""
    if spec.est_bytes:
        return int(spec.est_bytes)
    app = APP_CATALOG[spec.app](spec, "cpu")
    return int(sum(t.nbytes for t in tree_leaves(app.reg.init_state("cpu"))))


def spec_to_wire(spec: LobbySpec) -> dict:
    """Spec -> wire dict (alias of :meth:`LobbySpec.to_json`, kept as a
    module function for symmetry with :func:`spec_from_wire`)."""
    return spec.to_json()


def spec_from_wire(obj: dict) -> LobbySpec:
    """Wire dict -> spec (lenient; see :meth:`LobbySpec.from_json`)."""
    return LobbySpec.from_json(obj)


def checksum_hex(value: int) -> str:
    """64-bit checksum -> fixed-width hex for DONE datagrams."""
    return f"{value & 0xFFFFFFFFFFFFFFFF:016x}"
