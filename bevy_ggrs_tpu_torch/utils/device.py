"""Device selection for the port's entry points.

The port is built for an NVIDIA GPU.  An entry point given no device runs
on CUDA and raises when no card is present; it never falls back to the CPU
on its own.  The CPU is used only when a caller asks for it by name, as the
tests do (``device="cpu"``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means CUDA.

    Raises :class:`RuntimeError` when CUDA is asked for (or implied by
    ``None``) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU"
        )
    return dev
