"""Packed single-upload staging — one int8 buffer per dispatch.

Port of ``bevy_ggrs_tpu/ops/packing.py``.  A resim needs its inputs
``[k, P, ...]`` and statuses ``int8[k, P]`` on the card; this module packs
both (and the megastep's load-selection words) into ONE ``int8[k + 1, W]``
buffer, uploaded with one host-to-device copy from pinned memory:

- **row 0 is the prefix**: four little-endian int32 words
  ``[start_frame, n_real, has_load, load_slot]`` in the first 16 bytes
  (``has_load``/``load_slot`` are only read by the megastep; plain packed
  dispatches carry zeros).
- **rows 1..k are per-frame payloads**: the frame's input bytes
  (``P * prod(input_shape) * itemsize``, raw little-endian) followed by
  the ``P`` int8 status bytes.

Width is ``max(payload, 16)`` rounded up to a multiple of 4.  The layout
is byte for byte the JAX package's.

The host half (numpy, in place into a persistent buffer) is a copy of the
reference's.  The device half, :func:`unpack_seq`, splits the uploaded
buffer with ``Tensor.view(dtype)``: a bit reinterpretation, so the resim
gets exactly the tensors the two-upload path gave it.  The prefix is never
read back from the card (that would wait for it): the frame numbers travel
beside the device buffer in :class:`PackedUpload`, read from the host
buffer the upload was staged from.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from math import prod
from typing import NamedTuple, Tuple

import numpy as np
import torch

# prefix layout: int32 words [start_frame, n_real, has_load, load_slot]
PREFIX_WORDS = 4
PREFIX_BYTES = PREFIX_WORDS * 4

if sys.byteorder != "little":  # pragma: no cover - every supported host is LE
    raise ImportError("packed staging assumes a little-endian host")


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (``uint8`` -> ``torch.uint8``...)."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


@dataclass(frozen=True)
class PackedSpec:
    """Static layout of one app's packed buffer (derived from the input
    spec)."""

    players: int
    input_shape: Tuple[int, ...]
    input_dtype: np.dtype
    elems: int  # per-player input elements
    in_bytes: int  # all players' input bytes per frame row
    st_bytes: int  # status bytes per frame row (== players)
    payload: int  # in_bytes + st_bytes
    width: int  # row stride (>= payload and >= PREFIX_BYTES, 4-aligned)

    @classmethod
    def from_parts(cls, players: int, input_shape, input_dtype) -> "PackedSpec":
        """Derive the row layout from the app's player count and per-player
        input shape/dtype (width 4-aligned, never below the prefix)."""
        input_shape = tuple(input_shape)
        input_dtype = np.dtype(input_dtype)
        elems = prod(input_shape) if input_shape else 1
        in_bytes = players * elems * input_dtype.itemsize
        st_bytes = players
        payload = in_bytes + st_bytes
        width = max(payload, PREFIX_BYTES)
        width = -(-width // 4) * 4
        return cls(
            players=players, input_shape=input_shape, input_dtype=input_dtype,
            elems=elems, in_bytes=in_bytes, st_bytes=st_bytes,
            payload=payload, width=width,
        )

    @classmethod
    def for_app(cls, app) -> "PackedSpec":
        return cls.from_parts(app.num_players, app.input_shape, app.input_dtype)

    def new_buffer(self, k: int) -> np.ndarray:
        """Fresh zeroed host buffer for a ``k``-frame dispatch (+prefix)."""
        return np.zeros((k + 1, self.width), np.int8)

    def new_batch_buffer(self, m: int, k: int) -> np.ndarray:
        """Fresh zeroed host buffer for ``m`` lanes of a ``k``-frame
        dispatch, one prefix row per lane: ``int8[m, k + 1, W]``."""
        return np.zeros((m, k + 1, self.width), np.int8)


class PackedUpload(NamedTuple):
    """One packed dispatch's argument: the uploaded ``int8[k + 1, W]``
    buffer (``int8[m, k + 1, W]`` for ``m`` branch lanes) on the world's
    device and the prefix words, read on the host from the buffer it was
    staged from (see :func:`prefix_words`; lane 0's for a batch)."""

    rows: torch.Tensor
    start_frame: int
    n_real: int
    has_load: int = 0
    load_slot: int = 0

    @property
    def nbytes(self) -> int:
        return self.rows.numel()


class PackedWave(NamedTuple):
    """One many-worlds wave's argument (``ops/batch.py``): the uploaded
    ``int8[M, k + 1, W]`` buffer, one prefix row per lane, byte for byte
    the JAX package's batch buffer, and the lanes' advance counts as host
    ints.  The start frames are not carried on the host: each lane's clock
    is read from its prefix on the device (:func:`wave_starts`).  The
    counts are the host's copy of the prefixes' ``n_real`` words, which
    shape the masked program (which frames need a select)."""

    rows: torch.Tensor
    n_real: Tuple[int, ...]


def wave_starts(rows: torch.Tensor) -> torch.Tensor:
    """Every lane's start frame, int32 ``[M]``, read from the prefix rows
    of an uploaded wave ``int8[M, k + 1, W]`` on its device (a view)."""
    return rows[:, 0, :PREFIX_BYTES].view(torch.int32)[:, 0]


def wave_n_real(rows: torch.Tensor) -> torch.Tensor:
    """Every lane's advance count, int32 ``[M]``, from the same prefix."""
    return rows[:, 0, :PREFIX_BYTES].view(torch.int32)[:, 1]


# -- host-side packing (numpy, in place) -------------------------------------

def pack_prefix(buf: np.ndarray, start_frame: int, n_real: int,
                has_load: int = 0, load_slot: int = 0) -> None:
    """Write the int32 prefix words into row 0 of ``buf`` (``int8[k+1, W]``).

    This is the first rewrite of every packed tick, so it is the one
    sanitizer checkpoint for the whole pack (prefix, rows, pad all rewrite
    the same backing buffer a ``guard_write`` here has already cleared)."""
    from ..utils import staging

    staging.sanitizer().guard_write(buf, "packing.pack_prefix")
    pf = buf[0, :PREFIX_BYTES].view(np.int32)
    pf[0] = start_frame
    pf[1] = n_real
    pf[2] = has_load
    pf[3] = load_slot


def prefix_words(buf: np.ndarray) -> Tuple[int, int, int, int]:
    """``(start_frame, n_real, has_load, load_slot)`` read from row 0 of a
    host buffer."""
    return tuple(int(v) for v in buf[0, :PREFIX_BYTES].view(np.int32))


def pack_row(spec: PackedSpec, buf: np.ndarray, i: int, inputs, status) -> None:
    """Write frame ``i``'s input+status bytes into row ``1 + i``."""
    row = buf[1 + i]
    row[:spec.in_bytes] = (
        np.asarray(inputs, spec.input_dtype).reshape(-1).view(np.int8)
    )
    row[spec.in_bytes:spec.payload] = np.asarray(status, np.int8).reshape(-1)


def repeat_last_row(buf: np.ndarray, k: int, k_pad: int) -> None:
    """Repeat payload row ``k`` through rows ``k+1..k_pad`` (fixed-shape
    programs skip padded rows by ``n_real``; repeating the last real row
    matches ``pad_repeat_last``)."""
    if k_pad > k and k > 0:
        buf[1 + k:1 + k_pad] = buf[k]


# -- device-side unpacking (bit reinterpretation) ----------------------------

def unpack_seq(spec: PackedSpec, rows: torch.Tensor):
    """Split an uploaded ``int8[..., k + 1, W]`` buffer back into
    ``(inputs[..., k, P, *shape], status int8[..., k, P])`` on its device;
    leading axes (branch lanes) carry through.

    The statuses are a view.  The inputs are a view too where
    ``Tensor.view(dtype)`` allows it: the payload's byte offset and every
    stride but the last must be multiples of the input's item size, and a
    stride of ``W`` bytes is only 4-aligned.  Otherwise the input columns
    are copied into a contiguous tensor first (one device copy); the bytes,
    and so the values, are the same either way."""
    lead = tuple(rows.shape[:-2])
    k = rows.shape[-2] - 1
    payload = rows[..., 1:, :]
    raw = payload[..., :spec.in_bytes]
    dtype = torch_dtype(spec.input_dtype)
    size = spec.input_dtype.itemsize
    if size > 1 and (any(st % size for st in raw.stride()[:-1])
                     or raw.storage_offset() % size):
        # a fresh tensor: .contiguous() would keep a size-1 slice's offset
        raw = raw.clone(memory_format=torch.contiguous_format)
    inputs = raw.view(dtype).reshape(*lead, k, spec.players, *spec.input_shape)
    status = payload[..., spec.in_bytes:spec.payload].reshape(*lead, k, spec.players)
    return inputs, status
