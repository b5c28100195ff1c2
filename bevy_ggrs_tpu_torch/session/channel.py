"""In-process channel transport — the WebRTC/matchbox-analog alternative
socket (the reference supports swapping `UdpNonBlockingSocket` for matchbox
WebRTC behind the socket trait, README.md:79).  `ChannelNetwork` creates
endpoints addressed by name with optional deterministic latency/loss — a
pluggable `NonBlockingSocket` for tests and simulations that must not touch
real sockets.

A copy of ``bevy_ggrs_tpu/session/channel.py``; the port's tests and
``chip_smoke.py`` run P2P pairs over it."""

from __future__ import annotations

import random
from typing import Any, Dict, List, Tuple


class ChannelNetwork:
    """A little virtual packet network: named endpoints, optional per-hop
    latency (in ``deliver`` calls), loss rate, and reorder jitter (extra
    random hops per packet -> out-of-order delivery)."""

    def __init__(self, latency_hops: int = 0, loss: float = 0.0, seed: int = 0,
                 jitter_hops: int = 0):
        self.latency_hops = latency_hops
        self.loss = loss
        self.jitter_hops = jitter_hops
        self._rng = random.Random(seed)
        self._queues: Dict[Any, list] = {}
        self._clock = 0

    def endpoint(self, name: Any) -> "ChannelSocket":
        """Create/fetch the named endpoint's socket."""
        self._queues.setdefault(name, [])
        return ChannelSocket(self, name)

    def deliver(self) -> None:
        """Advance the virtual network one hop (ages queued packets)."""
        self._clock += 1

    def _send(self, src: Any, dst: Any, data: bytes) -> None:
        if self.loss and self._rng.random() < self.loss:
            return
        delay = self.latency_hops
        if self.jitter_hops:
            delay += self._rng.randint(0, self.jitter_hops)
        q = self._queues.setdefault(dst, [])
        q.append((self._clock + delay, src, data))

    def _recv_all(self, name: Any) -> List[Tuple[Any, bytes]]:
        q = self._queues.setdefault(name, [])
        due = [(t, src, d) for (t, src, d) in q if t <= self._clock]
        q[:] = [(t, src, d) for (t, src, d) in q if t > self._clock]
        return [(src, d) for (_, src, d) in due]


class ChannelSocket:
    """NonBlockingSocket over a ChannelNetwork."""

    def __init__(self, net: ChannelNetwork, name: Any):
        self.net = net
        self.name = name

    @property
    def local_addr(self) -> Any:
        return self.name

    def send_to(self, data: bytes, addr: Any) -> None:
        self.net._send(self.name, addr, data)

    def receive_all(self) -> List[Tuple[Any, bytes]]:
        return self.net._recv_all(self.name)
