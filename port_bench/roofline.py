"""The table of peaks and the work the checksum pass and the frame need.

A frozen copy of ``chip_smoke.py``'s fold bound (``fold_bound``), taken
from shapes alone: every row of the benchmark's worlds is live, kept by
every component and carries an id, so the counts need no read of the
masks.

Peaks of one NVIDIA H100 SXM at 700 W: HBM3 at 3.35 TB/s (data sheet).
Integer rates per SM and clock (CUDA C++ Programming Guide, compute
capability 9.0): 64 results of 32-bit add, shift, funnel shift and logic
on the ALU pipe, 64 of 32-bit multiply and multiply-add on the FMA pipe,
and at most 128 issued in all; times the SM count and the card's
``clocks.max.sm``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_CLOCK_PER_SM = 64
FMA_PIPE_OPS_PER_CLOCK_PER_SM = 64
ISSUE_OPS_PER_CLOCK_PER_SM = 128

#: bytes one frame of the ``stress_soa`` step must move per entity: its
#: six float32 columns read and written, and the alive and despawn masks read
STEP_BYTES_PER_ENTITY = 6 * 4 * 2 + 2


def fold_work(k: int, n: int, lanes: list) -> dict:
    """Bytes and 32-bit integer operations, by pipe, that the checksum
    pass needs on a ``[k, n]`` stack of full worlds with components of
    ``lanes[c]`` u32 lanes each (``chip_smoke.py`` ``fold_bound``)."""
    n_comps = len(lanes)
    rows = k * n  # every row live, not pending, kept by every component
    nbytes = rows + rows + k * 4 + k * (1 + n_comps) * 2 * 8
    alu = 2 * rows + k * 2 * (8 * n_comps + 13)
    fma = k * 2 * (2 * n_comps + 8)
    for n_lanes in lanes:
        nbytes += rows + rows * n_lanes * 4
        alu += rows + rows * (5 * n_lanes + 28)
        fma += rows * (4 * n_lanes + 12)
    nbytes += rows * 4
    alu += rows
    fma += 2 * rows
    return {"bytes": nbytes, "alu": alu, "fma": fma}


def least_seconds(work: dict, sm_clocks_per_s: float) -> float:
    """The least time the card needs for ``work``: the largest of its
    bytes over HBM bandwidth and its operations over each pipe's rate."""
    return max(work["bytes"] / HBM_BYTES_PER_S,
               work["alu"] / (ALU_OPS_PER_CLOCK_PER_SM * sm_clocks_per_s),
               work["fma"] / (FMA_PIPE_OPS_PER_CLOCK_PER_SM * sm_clocks_per_s),
               (work["alu"] + work["fma"]) / (ISSUE_OPS_PER_CLOCK_PER_SM * sm_clocks_per_s))


def sm_clocks_per_s() -> float:
    """SMs times the max SM clock (``nvidia-smi clocks.max.sm``)."""
    import subprocess

    import torch

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6
