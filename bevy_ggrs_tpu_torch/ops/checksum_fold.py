"""Checksum block fold: the CUDA kernel, its wrapper and its plain version.

Replaces the TPU kernel ``_hash_block_kernel`` (``component_part_pallas`` /
``world_checksum_pallas``, kept in ``docs/pallas_negative_result.md`` lines
63-152; live semantics ``bevy_ggrs_tpu/snapshot/checksum.py`` lines
101-139).  One call folds every checksummed component of a ``[k, N]``
stack of worlds: per frame, per component and for both seeds, the wrapping
u32 sum over live rows of ``fmix32(mix32(fold(lanes), rollback_id))``.

:func:`checksum_fold` launches ``csrc/checksum_fold.cu`` for CUDA tensors
and runs :func:`checksum_fold_plain` for CPU tensors, and only then; any
other device raises.  The kernel is bound by the bytes it reads (lanes,
ids and three mask bytes per row and frame) over the card's 3.35 TB/s; the
source file states its design.

torch on the CPU has no uint32 shift, sum or compare, so the plain version
holds u32 values in int64 and masks with ``& MASK32`` after every multiply
and shift.  A multiply by a 32-bit constant is split into 16-bit halves so
no int64 product overflows.

The library is built with ``nvcc`` at first use, from ``csrc/`` only, into
``_build/`` beside this package (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "checksum_fold.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches made by :func:`checksum_fold` (plain-version calls are
#: not counted).  Set it to 0 before a run to count that run's launches.
launches = 0

_lib = None


# -- u32 arithmetic held in int64 (plain version) ----------------------------


def _mul32(x, c: int):
    """``x * c mod 2**32`` for u32 ``x`` held in int64 and a constant ``c``."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def mix32(h, k):
    """One murmur3 round: fold lane ``k`` into state ``h`` (u32 in int64)."""
    k = _mul32(k, 0xCC9E2D51)
    k = _rotl(k, 15)
    k = _mul32(k, 0x1B873593)
    h = _rotl(h ^ k, 13)
    return (_mul32(h, 5) + 0xE6546B64) & MASK32


def fmix32(h):
    """murmur3 finalizer — avalanche (u32 in int64)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fold_rows(lanes: torch.Tensor, seed: int) -> torch.Tensor:
    """Hash each row of ``[..., L]`` u32 lanes (int64) -> u32[...] (int64)."""
    n_lanes = lanes.shape[-1]
    h = torch.full(lanes.shape[:-1], seed, dtype=torch.int64, device=lanes.device)
    for i in range(n_lanes):
        h = mix32(h, lanes[..., i])
    return fmix32(h ^ n_lanes)


def checksum_fold_plain(
    lanes: Sequence[torch.Tensor],
    has: Sequence[torch.Tensor],
    ids: torch.Tensor,
    alive: torch.Tensor,
    pending: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Plain torch version of the fold: u32 sums ``[k, C, 2]`` in int64.

    ``lanes[c]`` is int32 ``[k, N, L_c]`` (u32 bit patterns), ``has[c]``,
    ``alive`` and ``pending`` are bool ``[k, N]``, ``ids`` int32 ``[k, N]``
    and ``tags[c]`` the two seeds' type tags."""
    k = ids.shape[0]
    active = alive & ~pending
    ids64 = ids.to(torch.int64) & MASK32
    out = torch.empty((k, len(lanes), 2), dtype=torch.int64, device=ids.device)
    for c, (ln, hs, tag) in enumerate(zip(lanes, has, tags)):
        ln64 = ln.to(torch.int64) & MASK32
        keep = active & hs
        for s in (0, 1):
            h = fmix32(mix32(_fold_rows(ln64, tag[s]), ids64))
            out[:, c, s] = torch.where(keep, h, 0).sum(-1) & MASK32
    return out


# -- the kernel ----------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found to build checksum_fold.cu")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> Path:
    """Compile ``csrc/checksum_fold.cu`` for sm_90a unless a build of this
    exact source and these flags exists; returns the library's path.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside it as ``.log``."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libchecksum_fold_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.checksum_fold_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.checksum_fold_launch.restype = ctypes.c_int
        lib.checksum_fold_max_comps.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_inputs(lanes, has, ids, alive, pending, tags) -> None:
    k, n = ids.shape
    if not (len(lanes) == len(has) == len(tags)):
        raise ValueError("lanes, has and tags must have one entry per component")
    for name, t, dt in (("ids", ids, torch.int32), ("alive", alive, torch.bool),
                        ("pending", pending, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (k, n) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} [{k}, {n}] tensor")
    for ln, hs in zip(lanes, has):
        if ln.dtype != torch.int32 or ln.dim() != 3 or tuple(ln.shape[:2]) != (k, n) \
                or not ln.is_contiguous():
            raise ValueError(f"lanes must be contiguous int32 [{k}, {n}, L] tensors")
        if hs.dtype != torch.bool or tuple(hs.shape) != (k, n) or not hs.is_contiguous():
            raise ValueError(f"has must be contiguous bool [{k}, {n}] tensors")
    for t in (*lanes, *has, alive, pending):
        if t.device != ids.device:
            raise ValueError("all checksum_fold inputs must be on one device")


def checksum_fold(
    lanes: List[torch.Tensor],
    has: List[torch.Tensor],
    ids: torch.Tensor,
    alive: torch.Tensor,
    pending: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """u32 sums ``[k, C, 2]`` (int64) of every component's masked row hashes.

    Launches the CUDA kernel for CUDA tensors; uses
    :func:`checksum_fold_plain` only for CPU tensors."""
    global launches
    _check_inputs(lanes, has, ids, alive, pending, tags)
    dev = ids.device
    if dev.type == "cpu":
        return checksum_fold_plain(lanes, has, ids, alive, pending, tags)
    if dev.type != "cuda":
        raise ValueError(f"checksum_fold has no kernel for device {dev}")
    k, n = ids.shape
    n_comps = len(lanes)
    out = torch.zeros((k, n_comps, 2), dtype=torch.int32, device=dev)
    if k == 0 or n == 0 or n_comps == 0:
        return out.to(torch.int64)
    lib = _library()
    per_launch = lib.checksum_fold_max_comps()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for c0 in range(0, n_comps, per_launch):
        cs = range(c0, min(c0 + per_launch, n_comps))
        m = len(cs)
        err = lib.checksum_fold_launch(
            dev.index if dev.index is not None else torch.cuda.current_device(),
            k, n, m, n_comps,
            (ctypes.c_void_p * m)(*(lanes[c].data_ptr() for c in cs)),
            (ctypes.c_int * m)(*(lanes[c].shape[2] for c in cs)),
            (ctypes.c_void_p * m)(*(has[c].data_ptr() for c in cs)),
            (ctypes.c_uint * (2 * m))(*(t & MASK32 for c in cs for t in tags[c])),
            ids.data_ptr(), alive.data_ptr(), pending.data_ptr(),
            out.data_ptr() + c0 * 2 * out.element_size(), stream,
        )
        if err != 0:
            raise RuntimeError(f"checksum_fold kernel launch failed: CUDA error {err}")
        launches += 1
    return out.to(torch.int64) & MASK32
