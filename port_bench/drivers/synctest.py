"""A SyncTest session on one ``GgrsRunner``: every tick advances the live
frame and re-simulates the last ``check_distance`` frames, comparing
checksums (the determinism oracle developers run before shipping).  One
tick is one update of one frame's time; the session has no network and
no protocol clock.
"""

from __future__ import annotations

from .common import Game, input_row, seeded_app
from ..traffic import pads


class SyncTestGame(Game):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from bevy_ggrs_tpu_torch import GgrsRunner, SessionBuilder

        super().__init__(seed, traffic["checksum_sample_stride"])
        if int(config["matches"]) != 1:
            raise ValueError("the synctest driver runs one world")
        self.world_of = [0]
        app = seeded_app(config, seed, [0], device)
        session = (SessionBuilder.for_app(app)
                   .with_check_distance(int(traffic["check_distance"]))
                   .with_max_prediction_window(int(config["max_prediction"]))
                   .start_synctest_session())
        self._pads = pads(seed, 0, traffic)
        self._dt = 1.0 / int(config["fps"])
        self.runner = GgrsRunner(
            app, session, on_event=self.on_event, on_mismatch=self.on_event,
            read_inputs=lambda hs: input_row(self._pads, hs, self.runner.frame))
        self.seen = [{}]
        self.sync_ticks = 0

    def _step(self) -> None:
        self.runner.update(self._dt)

    def counters(self) -> dict:
        r = self.runner
        return {"rollbacks": r.rollbacks, "rolled_back_frames": r.rollback_frames,
                "waves": r.resims, "materialized_saves": r.materialized_saves,
                "stalls": r.stalled_frames, "frames": r.frame,
                "simulated_frames": r.rollback_frames + r.resims}

    def phase_seconds(self) -> dict:
        return dict(self.runner._phases.phase_seconds)

    def rings(self) -> list:
        return [(self.runner.ring, self.runner.confirmed)]

    def live_worlds(self) -> list:
        return [(self.runner.frame, self.runner.world)]


def build(config: dict, traffic: dict, seed: int, device) -> Game:
    return SyncTestGame(config, traffic, seed, device)
