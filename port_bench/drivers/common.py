"""What the drivers share: the game's interface, P2P sessions over the
in-memory channel, and the reading of what a game produced."""

from __future__ import annotations

import numpy as np

from ..clock import FixedClock
from ..worlds import COLUMNS, initial_columns

#: the work a game counts, cumulative; per 100 ticks on the run's work line
WORK_KEYS = ("rollbacks", "rolled_back_frames", "waves", "materialized_saves",
             "stalls", "frames")


class Game:
    """One cell's game: its worlds, sessions and runners (see drivers/).

    Subclasses set ``self.clock`` (or None) and implement :meth:`_step`,
    :meth:`counters`, :meth:`phase_seconds`, :meth:`rings` and
    :meth:`live_worlds`; ``world_of`` maps each of :meth:`rings`'s entries
    to the index of its initial world."""

    clock: FixedClock | None = None
    world_of: list = []

    def __init__(self, seed: int, sample_stride: int):
        # the confirmed checksums compared: frames f with f % stride == offset
        self._stride = int(sample_stride)
        self._offset = int(seed) % self._stride
        self.seen: list = []  # per ring: {frame: checksum ref}
        self.desyncs = 0

    def tick(self) -> None:
        """One host tick of the whole game, then the confirmed samples."""
        if self.clock is not None:
            self.clock.advance()
        self._step()
        for seen, (ring, confirmed) in zip(self.seen, self.rings()):
            for f in ring.frames():
                if f <= confirmed and f % self._stride == self._offset and f not in seen:
                    seen[f] = ring.peek(f)[1]

    def on_event(self, *event) -> None:
        if type(event[-1]).__name__ in ("DesyncDetected", "MismatchedChecksumError"):
            self.desyncs += 1

    # -- what the window produced, read once it has closed ------------------

    def outputs(self):
        """``(states, checksums)``: every live world's and every ring
        entry's columns as ``(world, frame, {name: tensor})`` (cloned, so
        that nothing pins the program's stacks), and each sampled confirmed
        checksum as ``(world, frame, int)``."""
        from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_to_int
        from bevy_ggrs_tpu_torch.snapshot.lazy import materialize

        states = []
        for idx, (frame, world) in enumerate(self.live_worlds()):
            states.append((self.world_of[idx], frame, _columns(world)))
        for idx, (ring, _confirmed) in enumerate(self.rings()):
            for f in ring.frames():
                states.append((self.world_of[idx], f, _columns(materialize(ring.peek(f)[0]))))
        checks = [(self.world_of[idx], f, checksum_to_int(ref))
                  for idx, seen in enumerate(self.seen) for f, ref in sorted(seen.items())]
        return states, checks

    def close(self) -> None:
        if self.clock is not None:
            self.clock.close()
            self.clock = None


def _columns(world) -> dict:
    return {name: world.comps[name].detach().clone() for name in COLUMNS}


def seeded_app(config: dict, seed: int, worlds: list, device):
    """A ``stress_soa`` app whose set-up spawns, call after call, the
    seed's initial worlds ``worlds[0]``, ``worlds[1]``, ..."""
    from bevy_ggrs_tpu_torch.models import stress_soa
    from bevy_ggrs_tpu_torch.snapshot.strategy import CopyStrategy, QuantizeStrategy
    from bevy_ggrs_tpu_torch.snapshot.world import spawn_many

    n = int(config["entities"])
    # "bf16": the program's own lower-precision path, snapshots kept in
    # bfloat16 (the control of the comparison; never a cell's setting)
    strategy = QuantizeStrategy() if config.get("snapshots") == "bf16" else CopyStrategy
    app = stress_soa.make_app(n_entities=n, fps=int(config["fps"]), device=device,
                              strategy=strategy)
    queue = list(worlds)

    def setup(empty):
        if not queue:
            raise RuntimeError("the app built more worlds than the game has")
        # one spawn of all n entities into the empty world: ids 0..n-1 in
        # row order
        return spawn_many(app.reg, empty, initial_columns(seed, queue.pop(0), n, device),
                          count=n)

    app.set_setup(setup)
    return app


def p2p_session(app, config: dict, traffic: dict, socket, handle: int, remote_addr):
    """One peer of a 2-player P2P game with the configuration's settings."""
    from bevy_ggrs_tpu_torch import DesyncDetection, PlayerType, SessionBuilder

    return (SessionBuilder.for_app(app)
            .with_input_delay(int(traffic["input_delay"]))
            .with_max_prediction_window(int(config["max_prediction"]))
            .with_desync_detection_mode(DesyncDetection.on(int(config["desync_interval"])))
            .add_player(PlayerType.LOCAL, handle)
            .add_player(PlayerType.REMOTE, 1 - handle, remote_addr)
            .start_p2p_session(socket))


def synchronize(tick, sessions, limit: int = 2000) -> int:
    """Tick until every session is RUNNING; returns the ticks it took."""
    for i in range(limit):
        tick()
        if all(s.current_state().value == "running" for s in sessions):
            return i + 1
    raise RuntimeError("the P2P sessions never synchronized")


def input_row(pads, handles, frame: int) -> dict:
    return {h: np.asarray(pads[h].at(frame)) for h in handles}
