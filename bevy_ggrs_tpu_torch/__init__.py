"""bevy_ggrs_tpu_torch — the PyTorch / CUDA port of ``bevy_ggrs_tpu``.

GGPO-style rollback netcode for deterministic simulations whose state is
columnar SoA tensors on an NVIDIA GPU.  A rollback of N frames is one
resim call returning every intermediate state and checksum; the checksum
fold is a CUDA kernel written for Hopper (``csrc/checksum_fold.cu``).

The module layout and names mirror the JAX package, which stays the
reference.  This package imports torch, never JAX, and nothing of
``bevy_ggrs_tpu``.  Entry points run on CUDA unless given
``device="cpu"``.
"""

from .app import App
from .runner import GgrsRunner
from .session.builder import SessionBuilder
from .session.events import InputStatus
from .session.synctest import SyncTestSession

__all__ = ["App", "GgrsRunner", "SessionBuilder", "SyncTestSession", "InputStatus"]
