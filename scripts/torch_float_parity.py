#!/usr/bin/env python
"""Float-state gap between the JAX package and the PyTorch port on the CPU.

Runs ``stress_soa`` (and ``box_game``) through both packages' ``resim_fn``
from the same seeded world and prints, per model, how many state elements
differ and by how much, plus whether the port's checksums of the JAX
states equal the JAX checksums.  XLA on the CPU contracts ``a*b + c`` into
fused multiply-adds; torch eager rounds the product and the sum apart, as
numpy does.  This script measures the resulting gap; it is the source of
the tolerance in tests/test_torch_resim.py.

Run from the repo root: JAX_PLATFORMS=cpu python scripts/torch_float_parity.py
"""

import dataclasses
import json
import sys

sys.path.insert(0, ".")

import jax  # noqa: E402
import numpy as np  # noqa: E402


def main() -> int:
    from bevy_ggrs_tpu.models import box_game as jbg
    from bevy_ggrs_tpu.models import stress_soa as jss
    from bevy_ggrs_tpu_torch.convert import world_from_numpy, world_to_numpy
    from bevy_ggrs_tpu_torch.models import box_game as tbg
    from bevy_ggrs_tpu_torch.models import stress_soa as tss
    from bevy_ggrs_tpu_torch.snapshot import checksum_to_int, world_checksums

    k = 8
    for name, japp, tapp in (
        ("stress_soa_4096", jss.make_app(n_entities=4096),
         tss.make_app(n_entities=4096, device="cpu")),
        ("box_game", jbg.make_app(), tbg.make_app(device="cpu")),
    ):
        rng = np.random.default_rng(7)
        inputs = rng.integers(0, 16, (k, 2)).astype(np.uint8)
        status = np.zeros((k, 2), np.int8)
        _, jstacked, jchecks = japp.resim_fn(japp.init_state(), inputs, status, 0, -1)
        _, tstacked, _ = tapp.resim_fn(tapp.init_state(), inputs, status, 0)
        jleaves = {f.name: jax.tree.map(np.asarray, getattr(jstacked, f.name))
                   for f in dataclasses.fields(jstacked)}
        tcomps = world_to_numpy(tstacked)["comps"]
        total = differ = 0
        max_abs = 0.0
        for c, a in jleaves["comps"].items():
            b = tcomps[c]
            total += a.size
            differ += int((a != b).sum())
            max_abs = max(max_abs, float(np.abs(a.astype(np.float64) - b).max()))
        carried = world_from_numpy(tapp.reg, jleaves, "cpu")
        exact = [checksum_to_int(c) for c in world_checksums(tapp.reg, carried)] == [
            (int(h) << 32) | int(lo) for h, lo in np.asarray(jchecks)]
        print(json.dumps({"model": name, "frames": k, "elements": total,
                          "differ": differ, "max_abs_diff": max_abs,
                          "checksums_of_jax_states_exact": exact}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
