"""Platform selection helper for the port's CLIs.

Port of ``bevy_ggrs_tpu/utils/platform.py``.  ``BGT_PLATFORM`` names the
device the CLIs run on (``cpu`` runs them on the CPU; ``cuda`` or ``gpu``
on the card); ``JAX_PLATFORMS`` is honored as an alias with lower
precedence, so an operator exporting the JAX spelling gets the same
device in both packages' processes, and a fleet worker subprocess inherits
whichever spelling its parent used.  With neither set the device is CUDA,
which raises without a card (``utils/device.py``): that is the caller
asking for the card, not a fallback.

``BGT_CPU_DEVICES`` (the JAX package's virtual CPU device count) has no
meaning for torch and is ignored."""

from __future__ import annotations

import os

from .device import resolve_device

# BGT_PLATFORM / JAX_PLATFORMS spellings -> torch device strings
_DEVICES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def apply_platform_env() -> str:
    """The device string ``BGT_PLATFORM`` (or its ``JAX_PLATFORMS`` alias)
    names, checked: ``"cuda"`` when neither is set, and a
    :class:`RuntimeError` when that means a card and none is present.

    JAX's spelling may list platforms (``"cuda,cpu"``); the first is
    taken.  An unknown name raises :class:`ValueError`."""
    raw = os.environ.get("BGT_PLATFORM") or os.environ.get("JAX_PLATFORMS") or "cuda"
    name = raw.split(",")[0].strip().lower()
    if name not in _DEVICES:
        raise ValueError(
            f"platform {raw!r} is not one the port runs on: {sorted(_DEVICES)}"
        )
    return str(resolve_device(_DEVICES[name]))


def device_label(device) -> str:
    """``device`` with the card's name, for a CLI's first line
    (``cuda:0 (NVIDIA H100 80GB HBM3)``, or ``cpu``)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"cuda:{index} ({torch.cuda.get_device_name(index)})"
