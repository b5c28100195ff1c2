"""Program-variant stability probe: does this app need canonical mode, and
does a lobby batch bit-exactly?

Port of ``bevy_ggrs_tpu/ops/variant_probe.py``.  XLA compiles a different
executable per resim length, and the executables may round one step
differently; eager torch runs the same kernels for a frame whatever the
depth, so the probe is expected to find nothing, but it measures rather
than assumes.  It drives the app's own step through the k=1 and k=K resims
from seeded reachable states and inputs and bit-compares every leaf, as
the JAX package's probe does.  It also compares each lane of an M-lane
many-worlds wave (``ops/batch.py``, every lane at its own start frame)
against the solo resim of that lane's world and inputs: the batched
runner's bit-equality rests on it.

Zero mismatches is strong evidence of stability for the sampled
distribution, not a proof.  Runs on the app's device (CUDA unless the app
was built with ``device="cpu"``); its uploads are plain blocking copies,
off every hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.tree import tree_flatten
from .batch import make_batched_resim_fn, stack_worlds
from .resim import slice_frame


@dataclass
class VariantProbeReport:
    """Result of :func:`probe_program_variants`."""

    trials: int
    mismatching_trials: int
    first_example: Optional[dict]  # {"leaf", "a", "b"} for the report
    checked_lengths: tuple
    lanes: int = 0  # lanes of each batched wave compared with solo resims
    lane_mismatching_trials: int = 0

    @property
    def stable(self) -> bool:
        return self.mismatching_trials == 0 and self.lane_mismatching_trials == 0

    def summary(self) -> str:
        """One-line verdict."""
        if self.stable:
            return (f"stable: {self.trials} random trials bit-identical across resim "
                    f"lengths {self.checked_lengths} and across {self.lanes}-lane "
                    "waves against solo resims")
        return (f"UNSTABLE: {self.mismatching_trials}/{self.trials} trials differ across "
                f"lengths {self.checked_lengths}, {self.lane_mismatching_trials} across "
                "lanes — configure App(canonical_depth=...) and do not batch this app")


def _first_difference(a_tree, b_tree) -> Optional[dict]:
    for i, (a, b) in enumerate(zip(tree_flatten(a_tree), tree_flatten(b_tree))):
        if not torch.equal(a, b):
            idx = (a != b).nonzero()
            at = tuple(idx[0].tolist()) if len(idx) else ()
            return {"leaf": i, "a": a[at].item() if at else None,
                    "b": b[at].item() if at else None}
    return None


def probe_program_variants(app, trials: int = 200, k_long: int = 8, seed: int = 0,
                           warmup_frames: int = 16, lanes: int = 4) -> VariantProbeReport:
    """Bit-compare the k=1 against the k=``k_long`` resim on ``app``, and
    each lane of ``lanes``-lane waves against solo resims.

    Each trial reaches a state by ``warmup_frames`` random frames from the
    initial world, then applies one random input frame through both
    resims and compares every leaf of the first frame.  Every
    ``k_long``-th trial also runs a wave of ``lanes`` such states at
    spread start frames for ``k_long`` frames against each lane's solo
    resim (``lanes=0`` skips it)."""
    rng = np.random.default_rng(seed)
    dev = app.device
    players = app.num_players
    ishape = (players, *app.input_shape)

    def rand_inputs(k):
        if np.issubdtype(app.input_dtype, np.integer):
            info = np.iinfo(app.input_dtype)
            lo, hi = max(info.min, -(2**15)), min(info.max, 2**15 - 1)
            x = rng.integers(lo, hi + 1, (k, *ishape)).astype(app.input_dtype)
        else:
            x = rng.standard_normal((k, *ishape)).astype(app.input_dtype)
        return torch.from_numpy(x).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int8, device=dev)

    base = app.init_state()
    wave = make_batched_resim_fn(app) if lanes else None
    mismatches = lane_mismatches = 0
    first = None
    for t in range(trials):
        state, _, _ = app.resim_fn(base, rand_inputs(warmup_frames),
                                   zeros(warmup_frames, players), 0)
        inp = rand_inputs(1)
        one, _, _ = app.resim_fn(state, inp, zeros(1, players), warmup_frames)
        _, stacked, _ = app.resim_fn(state, inp.expand(k_long, *ishape).contiguous(),
                                     zeros(k_long, players), warmup_frames)
        diff = _first_difference(one, slice_frame(stacked, 0))
        if diff is not None:
            mismatches += 1
            first = first or diff
        if wave is None or t % k_long:
            continue
        starts = [int(s) for s in rng.integers(-(2**31), 2**31 - k_long, lanes)]
        worlds = [app.resim_fn(base, rand_inputs(warmup_frames),
                               zeros(warmup_frames, players), 0)[0] for _ in range(lanes)]
        inputs_b = torch.stack([rand_inputs(k_long) for _ in range(lanes)])
        status_b = zeros(lanes, k_long, players)
        starts_t = torch.tensor(starts, dtype=torch.int32).to(dev)
        finals, _, checks = wave(stack_worlds(worlds), inputs_b, status_b, starts_t)
        for b in range(lanes):
            solo, _, solo_checks = app.resim_fn(worlds[b], inputs_b[b], status_b[b], starts[b])
            diff = _first_difference(solo, slice_frame(finals, b))
            if diff is None and not torch.equal(solo_checks, checks[b]):
                diff = {"leaf": "checksum", "a": None, "b": None}
            if diff is not None:
                lane_mismatches += 1
                first = first or diff
                break
    return VariantProbeReport(trials=trials, mismatching_trials=mismatches,
                              first_example=first, checked_lengths=(1, k_long),
                              lanes=lanes, lane_mismatching_trials=lane_mismatches)
