"""The checksum pass: the CUDA kernel, its wrapper and its plain version.

Replaces the TPU kernel ``_hash_block_kernel`` (``component_part_pallas`` /
``world_checksum_pallas``, kept in ``docs/pallas_negative_result.md`` lines
63-152; live semantics ``bevy_ggrs_tpu/snapshot/checksum.py`` lines
101-190).  One call takes a ``[k, N]`` stack of worlds through the whole
checksum pass except the resource parts: per frame, per checksummed
component and for both seeds, the wrapping u32 sum over live rows of
``fmix32(mix32(fold(lanes), rollback_id))``, finished with the type tag,
XOR-combined across components and with the entity part (active count,
``next_id``).  It returns one int64 tensor ``[k, 1 + C, 2]`` of u32
values: ``[:, 0]`` the checksums (hi, lo), ``[:, 1 + c]`` component c's
part.

:func:`checksum_fold` launches ``csrc/checksum_fold.cu`` for CUDA tensors
and runs :func:`checksum_fold_plain` for CPU tensors, and only then; any
other device raises.  The kernel is bound by its 32-bit integer operations
(the source file states its design); everything it needs goes by value in
one parameter block, packed here by :func:`pack_params`, so a call makes
no host-to-device copy, never synchronises, allocates one buffer and is
safe inside a CUDA graph.

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
import struct
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

#: Components per launch pair, threads per block and blocks per SM that the
#: grid aims for; ``MAX_COMPS`` and ``THREADS`` equal the kernel's own.
MAX_COMPS = 16
THREADS = 256
BLOCKS_PER_SM = 4

#: Wrapper calls that launched the kernel (plain-version calls are not
#: counted): one per checksum pass.  Set it to 0 before a run to count
#: that run's launches.  It counts on the host, when the wrapper runs: a
#: call captured into a CUDA graph counts once, at capture, and replays of
#: the graph count nothing.  Code that replays a captured pass must count
#: its replays itself, where it launches the graph.
launches = 0

#: The split pass's wrapper calls that launched its kernels, counted as
#: :data:`launches` is: :func:`checksum_fold_partial` (fold and slot
#: sums) and :func:`checksum_fold_finalize`.
partial_launches = 0
finalize_launches = 0

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


def checksum_fold_partial_plain(
    lanes: Sequence[torch.Tensor],
    has: Sequence[torch.Tensor],
    ids: torch.Tensor,
    alive: torch.Tensor,
    pending: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Plain torch version of the split pass's first half: the slot sums
    ``[k, 2C + 1]`` (u32 in int64) of these rows, slot ``2c + s`` the
    wrapping sum of component c's kept row hashes under seed s, slot
    ``2C`` the active count.  Slots of row blocks add (mod 2**32) to the
    slots of the whole (see :func:`checksum_fold_partial`)."""
    k = ids.shape[0]
    active = alive & ~pending
    ids64 = ids.to(torch.int64) & MASK32
    out = torch.empty((k, 2 * len(lanes) + 1), dtype=torch.int64, device=ids.device)
    for c, (ln, hs, tag) in enumerate(zip(lanes, has, tags)):
        ln64 = ln.to(torch.int64) & MASK32
        keep = active & hs
        for s in (0, 1):
            h = fmix32(mix32(_fold_rows(ln64, tag[s]), ids64))
            out[:, 2 * c + s] = torch.where(keep, h, 0).sum(-1) & MASK32
    out[:, 2 * len(lanes)] = active.sum(-1).to(torch.int64) & MASK32
    return out


def checksum_fold_finalize_plain(
    slots: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
    next_id: torch.Tensor,
    entity_tags: Tuple[int, int],
) -> torch.Tensor:
    """Plain torch version of the split pass's second half: ``[k, 1 + C,
    2]`` from the slot sums ``[k, 2C + 1]`` (each taken mod 2**32)."""
    k = slots.shape[0]
    n_comps = len(tags)
    slots = slots & MASK32
    out = torch.empty((k, 1 + n_comps, 2), dtype=torch.int64, device=slots.device)
    for c, tag in enumerate(tags):
        for s in (0, 1):
            out[:, 1 + c, s] = fmix32(slots[:, 2 * c + s] ^ tag[s])
    count = slots[:, 2 * n_comps]
    next64 = next_id.to(torch.int64) & MASK32
    for s in (0, 1):
        h = torch.full((k,), entity_tags[s], dtype=torch.int64, device=slots.device)
        h = fmix32(mix32(mix32(h, count), next64))
        for c in range(n_comps):
            h = h ^ out[:, 1 + c, s]
        out[:, 0, s] = h
    return out


def checksum_fold_plain(
    lanes: Sequence[torch.Tensor],
    has: Sequence[torch.Tensor],
    ids: torch.Tensor,
    alive: torch.Tensor,
    pending: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
    next_id: torch.Tensor,
    entity_tags: Tuple[int, int],
) -> torch.Tensor:
    """Plain torch version of the pass: ``[k, 1 + C, 2]`` u32 values in
    int64, the checksums (without resource parts) and then each
    component's part.

    ``lanes[c]`` is int32 ``[k, N, L_c]`` (u32 bit patterns), ``has[c]``,
    ``alive`` and ``pending`` are bool ``[k, N]``, ``ids`` int32 ``[k, N]``,
    ``next_id`` int32 ``[k]``, ``tags[c]`` the two seeds' type tags and
    ``entity_tags`` the two seeds' entity tags.  Its arithmetic is the
    split pass's two halves (:func:`checksum_fold_partial_plain`, then
    :func:`checksum_fold_finalize_plain`) in one pass."""
    k = ids.shape[0]
    active = alive & ~pending
    ids64 = ids.to(torch.int64) & MASK32
    out = torch.empty((k, 1 + len(lanes), 2), dtype=torch.int64, device=ids.device)
    for c, (ln, hs, tag) in enumerate(zip(lanes, has, tags)):
        ln64 = ln.to(torch.int64) & MASK32
        keep = active & hs
        for s in (0, 1):
            h = fmix32(mix32(_fold_rows(ln64, tag[s]), ids64))
            out[:, 1 + c, s] = fmix32((torch.where(keep, h, 0).sum(-1) & MASK32) ^ tag[s])
    count = active.sum(-1).to(torch.int64) & MASK32
    next64 = next_id.to(torch.int64) & MASK32
    for s in (0, 1):
        h = torch.full((k,), entity_tags[s], dtype=torch.int64, device=ids.device)
        h = fmix32(mix32(mix32(h, count), next64))
        for c in range(len(lanes)):
            h = h ^ out[:, 1 + c, s]
        out[:, 0, s] = h
    return out


# -- the kernel ----------------------------------------------------------------


class _Comp(ctypes.Structure):
    _fields_ = [
        ("lanes", ctypes.c_void_p), ("has", ctypes.c_void_p),
        ("nlanes", ctypes.c_int32), ("tag", ctypes.c_uint32 * 2),
        ("pad", ctypes.c_int32),
    ]


class FoldParams(ctypes.Structure):
    """The kernel's parameter block, field for field as ``Params`` in
    ``csrc/checksum_fold.cu``; one per chunk of ``MAX_COMPS`` components."""

    _fields_ = [
        ("comp", _Comp * MAX_COMPS),
        ("ids", ctypes.c_void_p), ("alive", ctypes.c_void_p),
        ("pending", ctypes.c_void_p), ("next_id", ctypes.c_void_p),
        ("partials", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("n", ctypes.c_int64), ("entity_tag", ctypes.c_uint32 * 2),
        ("k", ctypes.c_int32), ("ncomp", ctypes.c_int32),
        ("comp0", ctypes.c_int32), ("ncomp_total", ctypes.c_int32),
        ("blocks_x", ctypes.c_int32), ("vec", ctypes.c_int32),
    ]


def grid_blocks(k: int, n: int, sm_count: int, vec: bool) -> int:
    """Blocks per frame: ``BLOCKS_PER_SM`` blocks on every SM over all ``k``
    frames, and no more than the frame's row groups fill."""
    groups = n // 4 if vec else n
    want = -(-sm_count * BLOCKS_PER_SM // k)
    return max(1, min(want, -(-groups // THREADS)))


def vector_loads(n: int, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether 4-row groups with 16-byte loads fit: ``n % 4 == 0`` (every
    frame starts aligned as row 0 does) and every base address is 16-byte
    aligned (a frame slice of a stack may not be)."""
    return n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def partial_words(k: int, n_comps: int, blocks_x: int) -> int:
    """u32 words of the partial sums that the largest chunk writes."""
    return k * (2 * min(n_comps, MAX_COMPS) + 1) * blocks_x


#: ``Params`` as bytes: per component (lanes, has, nlanes, tag[2], pad),
#: then ids, alive, pending, next_id, partials, out, n, entity_tag[2], k,
#: ncomp, comp0, ncomp_total, blocks_x, vec.  One ``pack`` per chunk is
#: several times faster than setting the ctypes fields one by one.
_PARAMS = struct.Struct("<" + "QQiIIi" * MAX_COMPS + "6Qq2I6i")
_NO_COMP = (0, 0, 0, 0, 0, 0)


def pack_params(
    lanes: Sequence[torch.Tensor],
    has: Sequence[torch.Tensor],
    ids: torch.Tensor,
    alive: torch.Tensor,
    pending: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
    next_id: torch.Tensor,
    entity_tags: Tuple[int, int],
    out: torch.Tensor,
    partials: int,
    blocks_x: int,
    vec: bool,
) -> List[FoldParams]:
    """The parameter blocks of one pass, one per chunk of ``MAX_COMPS``
    components in the given order (at least one, for the entity part).
    ``partials`` is the address of the partial-sum scratch.  The split
    pass's first half has no ``next_id`` (None) and writes its slot sums
    to ``out``."""
    k, n = ids.shape
    n_comps = len(lanes)
    comps = [(ln.data_ptr(), hs.data_ptr(), ln.shape[2], t0 & MASK32, t1 & MASK32, 0)
             for ln, hs, (t0, t1) in zip(lanes, has, tags)]
    tail = (ids.data_ptr(), alive.data_ptr(), pending.data_ptr(),
            0 if next_id is None else next_id.data_ptr(),
            partials, out.data_ptr(), n, entity_tags[0] & MASK32, entity_tags[1] & MASK32,
            k)
    chunks = []
    for c0 in range(0, max(n_comps, 1), MAX_COMPS):
        chunk = comps[c0:c0 + MAX_COMPS]
        fields = [v for comp in chunk for v in comp]
        fields += _NO_COMP * (MAX_COMPS - len(chunk))
        fields += (*tail, len(chunk), c0, n_comps, blocks_x, int(vec))
        chunks.append(FoldParams.from_buffer_copy(_PARAMS.pack(*fields)))
    return chunks


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
        for fn in ("checksum_fold_launch", "checksum_fold_partial_launch",
                   "checksum_fold_finalize_launch"):
            getattr(lib, fn).argtypes = [
                ctypes.c_int, ctypes.POINTER(FoldParams), ctypes.c_void_p,
            ]
            getattr(lib, fn).restype = ctypes.c_int
        for fn in ("checksum_fold_max_comps", "checksum_fold_threads",
                   "checksum_fold_params_size"):
            getattr(lib, fn).restype = ctypes.c_int
        got = (lib.checksum_fold_max_comps(), lib.checksum_fold_threads(),
               lib.checksum_fold_params_size())
        want = (MAX_COMPS, THREADS, ctypes.sizeof(FoldParams))
        if got != want:
            raise RuntimeError(f"checksum_fold.cu (max comps, threads, params "
                               f"size) = {got}, this wrapper expects {want}")
        _lib = lib
    return _lib


def _check_inputs(lanes, has, ids, alive, pending, tags, next_id, entity_tags) -> None:
    k, n = ids.shape
    kn = ids.shape
    if not (len(lanes) == len(has) == len(tags)):
        raise ValueError("lanes, has and tags must have one entry per component")
    if len(entity_tags) != 2 or any(len(t) != 2 for t in tags):
        raise ValueError("tags and entity_tags must hold one tag per seed")
    for name, t, dt in (("ids", ids, torch.int32), ("alive", alive, torch.bool),
                        ("pending", pending, torch.bool)):
        if t.dtype != dt or t.shape != kn or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} [{k}, {n}] tensor")
    if next_id is not None and (next_id.dtype != torch.int32 or next_id.shape != (k,)
                                or not next_id.is_contiguous()):
        raise ValueError(f"next_id must be a contiguous {torch.int32} [{k}] tensor")
    for ln in lanes:
        if ln.dtype != torch.int32 or ln.dim() != 3 or ln.shape[:2] != kn \
                or not ln.is_contiguous():
            raise ValueError(f"lanes must be contiguous int32 [{k}, {n}, L] tensors")
    for hs in has:
        if hs.dtype != torch.bool or hs.shape != kn or not hs.is_contiguous():
            raise ValueError(f"has must be contiguous bool [{k}, {n}] tensors")
    dev = ids.device
    if any(t.device != dev for t in (*lanes, *has, alive, pending)) or (
            next_id is not None and next_id.device != dev):
        raise ValueError("all checksum_fold inputs must be on one device")


def checksum_fold(
    lanes: List[torch.Tensor],
    has: List[torch.Tensor],
    ids: torch.Tensor,
    alive: torch.Tensor,
    pending: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
    next_id: torch.Tensor,
    entity_tags: Tuple[int, int],
) -> torch.Tensor:
    """Checksums and component parts ``[k, 1 + C, 2]`` (u32 values in
    int64) of a stack of worlds, as :func:`checksum_fold_plain`.

    Launches the CUDA kernel for CUDA tensors; uses
    :func:`checksum_fold_plain` only for CPU tensors."""
    global launches
    args = (lanes, has, ids, alive, pending, tags, next_id, entity_tags)
    _check_inputs(*args)
    dev = ids.device
    if dev.type == "cpu":
        return checksum_fold_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"checksum_fold has no kernel for device {dev}")
    k, n = ids.shape
    n_comps = len(lanes)
    if k > 65535:
        raise ValueError(f"checksum_fold takes at most 65535 frames, got {k}")
    vec = vector_loads(n, [ids, alive, pending, *lanes, *has])
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks_x = grid_blocks(k, n, sm_count, vec) if k else 1
    # one allocation: the output, then the partial sums (u32 words)
    head = k * (1 + n_comps) * 2
    buf = torch.empty(head + -(-partial_words(k, n_comps, blocks_x) // 2),
                      dtype=torch.int64, device=dev)
    out = buf[:head].view(k, 1 + n_comps, 2)
    if k == 0:
        return out
    lib = _library()
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for p in pack_params(*args, out, buf.data_ptr() + head * 8, blocks_x, vec):
        err = lib.checksum_fold_launch(device, ctypes.byref(p), stream)
        if err != 0:
            raise RuntimeError(f"checksum_fold kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _launch(entry: str, dev: torch.device, chunks: List[FoldParams]) -> None:
    lib = _library()
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for p in chunks:
        err = getattr(lib, entry)(device, ctypes.byref(p), stream)
        if err != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {err}")


def checksum_fold_partial(
    lanes: List[torch.Tensor],
    has: List[torch.Tensor],
    ids: torch.Tensor,
    alive: torch.Tensor,
    pending: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """The split pass's first half: the slot sums ``[k, 2C + 1]`` (u32 in
    int64) of these rows, as :func:`checksum_fold_partial_plain`.

    For a world whose entity axis is split over ranks: each rank folds its
    own rows, the ranks all-reduce the slots (an int64 sum, then ``&
    MASK32``: exact for fewer than 2**31 ranks), and
    :func:`checksum_fold_finalize` finishes from the sums; the result is
    the one-call pass's bit for bit.  Launches the fold kernel and a slot
    reduction per chunk of ``MAX_COMPS`` components for CUDA tensors; the
    plain version runs only for CPU tensors."""
    global partial_launches
    _check_inputs(lanes, has, ids, alive, pending, tags, None, (0, 0))
    dev = ids.device
    if dev.type == "cpu":
        return checksum_fold_partial_plain(lanes, has, ids, alive, pending, tags)
    if dev.type != "cuda":
        raise ValueError(f"checksum_fold_partial has no kernel for device {dev}")
    k, n = ids.shape
    if k > 65535:
        raise ValueError(f"checksum_fold_partial takes at most 65535 frames, got {k}")
    n_comps = len(lanes)
    slots = torch.zeros((k, 2 * n_comps + 1), dtype=torch.int64, device=dev)
    if k == 0 or n == 0:
        return slots
    vec = vector_loads(n, [ids, alive, pending, *lanes, *has])
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks_x = grid_blocks(k, n, sm_count, vec)
    scratch = torch.empty(-(-partial_words(k, n_comps, blocks_x) // 2), dtype=torch.int64,
                          device=dev)
    _launch("checksum_fold_partial_launch", dev,
            pack_params(lanes, has, ids, alive, pending, tags, None, (0, 0), slots,
                        scratch.data_ptr(), blocks_x, vec))
    partial_launches += 1
    return slots


def checksum_fold_finalize(
    slots: torch.Tensor,
    tags: Sequence[Tuple[int, int]],
    next_id: torch.Tensor,
    entity_tags: Tuple[int, int],
) -> torch.Tensor:
    """The split pass's second half: ``[k, 1 + C, 2]`` from the slot sums
    ``[k, 2C + 1]`` (int64, each taken mod 2**32), as
    :func:`checksum_fold_finalize_plain`; one launch per chunk of
    ``MAX_COMPS`` components for CUDA tensors."""
    global finalize_launches
    k = slots.shape[0]
    n_comps = len(tags)
    if slots.dtype != torch.int64 or slots.shape != (k, 2 * n_comps + 1) \
            or not slots.is_contiguous():
        raise ValueError(f"slots must be a contiguous int64 [{k}, {2 * n_comps + 1}] tensor")
    if next_id.dtype != torch.int32 or next_id.shape != (k,) or not next_id.is_contiguous() \
            or next_id.device != slots.device:
        raise ValueError(f"next_id must be a contiguous int32 [{k}] tensor beside the slots")
    dev = slots.device
    if dev.type == "cpu":
        return checksum_fold_finalize_plain(slots, tags, next_id, entity_tags)
    if dev.type != "cuda":
        raise ValueError(f"checksum_fold_finalize has no kernel for device {dev}")
    if k > 65535:
        raise ValueError(f"checksum_fold_finalize takes at most 65535 frames, got {k}")
    out = torch.empty((k, 1 + n_comps, 2), dtype=torch.int64, device=dev)
    if k == 0:
        return out
    chunks = []
    for c0 in range(0, max(n_comps, 1), MAX_COMPS):
        chunk = tags[c0:c0 + MAX_COMPS]
        fields = [v for t0, t1 in chunk for v in (0, 0, 0, t0 & MASK32, t1 & MASK32, 0)]
        fields += _NO_COMP * (MAX_COMPS - len(chunk))
        fields += (0, 0, 0, next_id.data_ptr(), slots.data_ptr(), out.data_ptr(), 1,
                   entity_tags[0] & MASK32, entity_tags[1] & MASK32, k,
                   len(chunk), c0, n_comps, 1, 0)
        chunks.append(FoldParams.from_buffer_copy(_PARAMS.pack(*fields)))
    _launch("checksum_fold_finalize_launch", dev, chunks)
    finalize_launches += 1
    return out
