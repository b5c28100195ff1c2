"""The checksum pass's share of its roofline: the least time its calls in
the traced ticks need (``port_bench/roofline.py``, from each call's stack
shape) over the device time of its kernels there (``fold_kernel`` and
``finalize_kernel``), in percent.  Where the trace lost some of the
pass's kernel records, the bound is scaled to the calls it kept."""

from port_bench.roofline import fold_work, least_seconds

KERNELS = ("fold_kernel", "finalize_kernel")


def read(rec):
    calls = rec["trace"]["fold_calls"]
    dev = [d for d in rec["trace"]["device"]
           if d[1] == "kernel" and any(k in d[0] for k in KERNELS)]
    seconds = sum(b - a for _n, _k, a, b in dev) / 1e6
    folds = sum(1 for d in dev if KERNELS[0] in d[0])
    if not calls or not folds or seconds <= 0:
        return None
    bound = sum(least_seconds(fold_work(k, n, lanes), rec["sm_clocks_per_s"])
                for k, n, lanes in calls)
    return 100.0 * bound * min(folds / len(calls), 1.0) / seconds
