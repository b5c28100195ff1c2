"""Lazy device->host checksum readback.

Port of the checksum-readback part of ``bevy_ggrs_tpu/snapshot/lazy.py``
(``BatchChecks``, ``ChecksumRef``, ``wrap_single_checksum``).  A resim's
checksums are one ``[k, 2]`` tensor (hi, lo; u32 in int64) on the world's
device, and a session needs only some of its rows, one at a time: SyncTest
at its comparison cadence, a P2P session every desync-detection interval
frame once it is confirmed.

- :class:`BatchChecks` wraps one resim's ``[k, 2]`` checksums.  Its first
  non-blocking read starts ONE non-blocking copy of all k rows into pinned
  host memory and records a CUDA event after it; until ``event.query()``
  is true such reads return None, and none of them waits for the card.  A
  forcing read waits for that copy (or makes a blocking one): a *forced*
  readback.  On CPU tensors the rows are host memory already, and either
  read takes them at once.
- :class:`ChecksumRef` is one row of a batch and the provider the sessions
  consume: calling it forces the value, :meth:`ChecksumRef.peek` is the
  non-blocking read that ``P2PSession._resolve_checksum`` retries each poll.
- :class:`ReadbackStats` counts the reads of one owner (a runner): peeks
  that returned None, reads that found the copy landed, forced reads.

Not ported yet (the dispatch pipeline): ``LazySlice``, ``fused_load_rows``
and ``ReadbackQueue``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class ReadbackStats:
    """Checksum reads of one owner since it was made."""

    peek_misses: int = 0  # non-blocking reads that returned None
    harvested: int = 0  # reads that found the rows on the host, no wait
    forced: int = 0  # reads that waited for the card


class BatchChecks:
    """One resim's ``[k, 2]`` checksums, read back to the host once (see
    module docstring)."""

    __slots__ = ("_dev", "_host", "_pinned", "_event", "_stats")

    def __init__(self, dev: torch.Tensor, stats: Optional[ReadbackStats] = None):
        self._dev: Optional[torch.Tensor] = dev
        self._host: Optional[List[List[int]]] = None
        self._pinned: Optional[torch.Tensor] = None
        self._event = None
        self._stats = stats if stats is not None else ReadbackStats()

    def _adopt(self, rows: torch.Tensor) -> List[List[int]]:
        self._host = rows.tolist()
        self._dev = self._pinned = self._event = None
        return self._host

    def try_host(self) -> Optional[List[List[int]]]:
        """The ``[k, 2]`` rows if they can be had without waiting for the
        card, else None (starting the copy on the first call)."""
        if self._host is not None:
            return self._host
        if self._dev.device.type != "cuda":
            self._stats.harvested += 1
            return self._adopt(self._dev)
        if self._event is None:  # the first read starts the one copy
            self._pinned = torch.empty(self._dev.shape, dtype=self._dev.dtype,
                                       pin_memory=True)
            self._pinned.copy_(self._dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        if not self._event.query():
            self._stats.peek_misses += 1
            return None
        self._stats.harvested += 1
        return self._adopt(self._pinned)

    def host(self) -> List[List[int]]:
        """The ``[k, 2]`` rows, waiting for the card if they have not
        landed (a forced readback)."""
        if self._host is not None:
            return self._host
        if self._dev.device.type != "cuda":
            self._stats.harvested += 1
            return self._adopt(self._dev)
        if self._event is not None and self._event.query():
            self._stats.harvested += 1
            return self._adopt(self._pinned)
        self._stats.forced += 1
        if self._event is None:
            return self._adopt(self._dev)
        self._event.synchronize()
        return self._adopt(self._pinned)

    def ref(self, i: int) -> "ChecksumRef":
        return ChecksumRef(self, i)


class ChecksumRef:
    """Row ``i`` of a :class:`BatchChecks`: one frame's checksum provider."""

    __slots__ = ("_batch", "_i")

    def __init__(self, batch: BatchChecks, i: int):
        self._batch = batch
        self._i = i

    def to_int(self) -> int:
        """The 64-bit cross-peer checksum (forces the batch's readback)."""
        hi, lo = self._batch.host()[self._i]
        return (hi << 32) | lo

    # calling a ref forces (SyncTest comparisons, flush points);
    # peek() is the non-blocking read the P2P desync detection retries
    __call__ = to_int

    def peek(self) -> Optional[int]:
        """The value if the batch's copy has landed, else None (starting
        the copy if needed); never waits for the card."""
        rows = self._batch.try_host()
        if rows is None:
            return None
        hi, lo = rows[self._i]
        return (hi << 32) | lo


def wrap_single_checksum(cs: torch.Tensor,
                         stats: Optional[ReadbackStats] = None) -> ChecksumRef:
    """Wrap one ``[2]`` checksum as a 1-row batch's ref."""
    return BatchChecks(cs[None], stats).ref(0)
