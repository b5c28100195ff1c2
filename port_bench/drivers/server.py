"""A game server: ``matches`` two-player P2P games, both peers of each
hosted, as one ``BatchedRunner`` of ``2 * matches`` lobbies.

Lobby ``2m + i`` is peer ``i`` of match ``m`` and starts from initial
world ``m``.  Each match has its own ``ChannelNetwork``; every tick
delivers each network once, in match order, moves the shared protocol
clock one frame and runs one server tick.

A save counts as materialized when its ring entry owns a copy: when it is
not a view of the last wave's stack or of a resident world (the runner's
rings hold views, and a non-identity snapshot strategy gathers copies).
"""

from __future__ import annotations

from ..clock import FixedClock
from .common import Game, input_row, p2p_session, seeded_app, synchronize
from ..traffic import pads


class ServerGame(Game):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from bevy_ggrs_tpu_torch import BatchedRunner
        from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork

        super().__init__(seed, traffic["checksum_sample_stride"])
        matches = int(config["matches"])
        self.world_of = [m for m in range(matches) for _ in range(2)]
        self.clock = FixedClock(int(config["fps"]))
        app = seeded_app(config, seed, self.world_of, device)
        self.nets = [ChannelNetwork(latency_hops=int(traffic["latency_hops"]), seed=m)
                     for m in range(matches)]
        sessions = [p2p_session(app, config, traffic, self.nets[m].endpoint(f"m{m}p{i}"),
                                i, f"m{m}p{1 - i}")
                    for m in range(matches) for i in range(2)]
        self._pads = [pads(seed, m, traffic) for m in range(matches)]
        self.br = BatchedRunner(app, sessions, on_event=self.on_event,
                                on_mismatch=self.on_event,
                                read_inputs=lambda b, hs: input_row(
                                    self._pads[b // 2], hs, self.br.frames[b]))
        self._waves = self._simulated = self._rolled = self._materialized = 0
        self._wave_buffers = ()
        run_wave = self.br.exec.run_wave_packed

        def counted(worlds, stage, ks):
            self._waves += 1
            self._simulated += sum(ks)
            self._rolled += sum(max(k - 1, 0) for k in ks)
            out = run_wave(worlds, stage, ks)
            # what a save may view without a copy: the pre-wave world, the stack
            self._wave_buffers = (worlds, out[2])
            return out

        self.br.exec.run_wave_packed = counted
        for ring in self.br.rings:
            ring.push = self._counting(ring.push)
        self.seen = [{} for _ in sessions]
        self.sync_ticks = synchronize(self.tick, sessions)

    def _counting(self, push):
        from bevy_ggrs_tpu_torch.snapshot.lazy import LazySlice

        def counted(frame, entry):
            stored = entry[0]
            if not (isinstance(stored, LazySlice) and any(
                    stored._stacked is buf for buf in (self.br.worlds, *self._wave_buffers))):
                self._materialized += 1
            push(frame, entry)

        return counted

    def _step(self) -> None:
        for net in self.nets:
            net.deliver()
        self.br.tick()

    def counters(self) -> dict:
        br = self.br
        return {"rollbacks": br.rollbacks, "rolled_back_frames": self._rolled,
                "waves": self._waves, "materialized_saves": self._materialized,
                "stalls": sum(br.stalled), "frames": sum(br.frames),
                "simulated_frames": self._simulated}

    def phase_seconds(self) -> dict:
        return dict(self.br._phases.phase_seconds)

    def rings(self) -> list:
        return list(zip(self.br.rings, self.br.confirmed))

    def live_worlds(self) -> list:
        return [(self.br.frames[b], self.br.lobby_world(b)) for b in range(len(self.br.sessions))]


def build(config: dict, traffic: dict, seed: int, device) -> Game:
    return ServerGame(config, traffic, seed, device)
