"""Frame-indexed snapshot ring buffer.

Port of ``bevy_ggrs_tpu/snapshot/ring.py``, the analog of ``GgrsSnapshots`` (bevy_ggrs
src/snapshot/mod.rs:97-273).
The reference keeps one ring *per registered component type*, each a pair of
newest-first ``VecDeque``s (frames, snapshots).  Here a snapshot is the whole
world state — a tree of device-resident SoA tensors — so ONE ring covers every
registered type, and push/rollback are O(1) host-side reference operations (the
arrays never leave the device).  Semantics preserved from the reference:

- ``set_depth`` trims oldest entries beyond depth (mod.rs:123-138); depth is
  synced to the max prediction window before every save (mod.rs:246-258).
- ``push`` evicts any stored frame >= the new frame under *wrapping* i32
  comparison (mod.rs:147-181, wraparound handling :159-163), then trims to depth.
- ``confirm(frame)`` prunes strictly-older frames (mod.rs:185-202).
- ``rollback(frame)`` discards newer entries until the target is at the front
  and raises if the target frame was never stored (mod.rs:210-226; the
  reference panics at :214).
- ``peek`` returns a stored snapshot without mutating the ring.

Device-memory accounting (``telemetry/devmem.py``): a runner that calls
:meth:`SnapshotRing.set_accounting` has every mutation re-note the ring's
rows times one stored world's bytes under its owner (a host integer; one
dict store per mutation).

Unit-test parity: tests/test_ring.py ports the battery at mod.rs:369-512.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Generic, List, Optional, Sequence, Tuple, TypeVar

from ..telemetry import devmem
from ..utils.frames import frame_ge, frame_lt

T = TypeVar("T")


class MissingSnapshotError(KeyError):
    """Rollback target frame is not in the ring (reference panics, mod.rs:214)."""


class SnapshotRing(Generic[T]):
    """Newest-first ring of (frame, snapshot) pairs with wrapping-frame order."""

    def __init__(self, depth: int = 60):
        self._frames: Deque[int] = deque()
        self._snapshots: Deque[T] = deque()
        self._depth = depth
        # device-memory accounting: owner + per-entry byte count set by the
        # runner; None keeps every ring op free of it
        self._devmem_owner: Optional[str] = None
        self._entry_bytes = 0

    def set_accounting(self, owner: Optional[str], entry_bytes: int) -> None:
        """Register this ring with the device-memory registry: every
        mutation re-notes ``len(ring) * entry_bytes`` under ``owner``
        (``entry_bytes`` = one stored world's bytes, computed once per
        session by the runner; lazy-slice entries share their stacked
        buffer, so this is the materialized figure).  ``owner=None`` turns
        accounting back off."""
        self._devmem_owner = owner
        self._entry_bytes = int(entry_bytes)
        if owner is not None:
            self._renote()

    def _renote(self) -> None:
        devmem.note(self._devmem_owner, len(self._frames) * self._entry_bytes)

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._frames)

    @property
    def depth(self) -> int:
        return self._depth

    def frames(self) -> list[int]:
        """Stored frames, newest first."""
        return list(self._frames)

    # -- reference-parity operations --------------------------------------

    def set_depth(self, depth: int) -> None:
        """Resize; drops oldest entries if shrinking (mod.rs:123-138)."""
        self._depth = depth
        while len(self._frames) > self._depth:
            self._frames.pop()
            self._snapshots.pop()
        if self._devmem_owner is not None:
            self._renote()

    def push(self, frame: int, snapshot: T) -> None:
        """Store ``snapshot`` for ``frame``, evicting stored frames that are
        not older than it (wrapping compare), then trimming to depth."""
        while self._frames and frame_ge(self._frames[0], frame):
            self._frames.popleft()
            self._snapshots.popleft()
        self._frames.appendleft(frame)
        self._snapshots.appendleft(snapshot)
        while len(self._frames) > self._depth:
            self._frames.pop()
            self._snapshots.pop()
        if self._devmem_owner is not None:
            self._renote()

    def confirm(self, frame: int) -> None:
        """Drop snapshots strictly older than the confirmed frame
        (mod.rs:185-202); keeps ``frame`` itself so it can still be loaded."""
        while self._frames and frame_lt(self._frames[-1], frame):
            self._frames.pop()
            self._snapshots.pop()
        if self._devmem_owner is not None:
            self._renote()

    def rollback(self, frame: int) -> T:
        """Discard entries newer than ``frame``; return its snapshot.

        Raises :class:`MissingSnapshotError` if the frame is absent."""
        while self._frames:
            if self._frames[0] == frame:
                if self._devmem_owner is not None:
                    self._renote()
                return self._snapshots[0]
            self._frames.popleft()
            self._snapshots.popleft()
        raise MissingSnapshotError(
            f"rollback target frame {frame} not in snapshot ring"
        )

    def peek(self, frame: int) -> Optional[T]:
        """Return the snapshot for ``frame`` without mutating, or None."""
        for f, s in zip(self._frames, self._snapshots):
            if f == frame:
                return s
        return None

    def latest(self) -> Optional[T]:
        return self._snapshots[0] if self._snapshots else None

    def latest_frame(self) -> Optional[int]:
        return self._frames[0] if self._frames else None

    def clear(self) -> None:
        """Drop every stored snapshot."""
        self._frames.clear()
        self._snapshots.clear()
        if self._devmem_owner is not None:
            self._renote()


def rollback_many(
    rings: Sequence["SnapshotRing[T]"], targets: Sequence[Tuple[int, int]]
) -> List[Tuple[int, T]]:
    """Batched rollback across a server's per-lobby rings.

    ``targets`` is ``[(ring_index, frame), ...]``; each named ring performs
    its normal :meth:`SnapshotRing.rollback` (discarding newer entries,
    raising :class:`MissingSnapshotError` on absence) and the stored
    snapshots come back as ``[(ring_index, snapshot), ...]`` in target order
    (the batched runner's mixed-source load wave, a later slice)."""
    return [(i, rings[i].rollback(f)) for i, f in targets]
