#!/usr/bin/env python
"""Where a resim's time goes on the card: a torch.profiler trace of the
PyTorch port's ``App.resim_fn`` on ``stress_soa`` (k=8).

Prints one JSON line: wall ms per resim call (host clock around calls that
end in a synchronize), device-busy ms per call (the sum of the CUDA
kernels' self time in the trace; kernels of one stream do not overlap),
the idle share, the kernel launches per call and the wall time per launch,
and the top kernels by device time with their calls.
Needs a CUDA card; it fails without one.

Run from the repo root: python scripts/torch_port_profile.py [--entities N]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from bevy_ggrs_tpu_torch.models import stress_soa

    app = stress_soa.make_app(n_entities=args.entities, device="cuda")
    world = app.init_state()
    inputs = np.zeros((args.k, 2), np.uint8)
    status = np.zeros((args.k, 2), np.int8)
    for _ in range(3):
        app.resim_fn(world, inputs, status, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        app.resim_fn(world, inputs, status, 0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.calls):
            app.resim_fn(world, inputs, status, 0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.calls
    launches = sum(e.count for e in kernels) / args.calls
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "entities": args.entities,
        "k": args.k, "calls": args.calls, "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_call": launches,
        "wall_us_per_launch": wall_ms * 1e3 / launches if launches else None,
        "top_kernels": [{"name": e.key[:90], "ms_per_call": _device_us(e) / 1e3 / args.calls,
                         "calls_per_resim": e.count / args.calls} for e in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
