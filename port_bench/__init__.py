"""The benchmark of the PyTorch/CUDA port (``bevy_ggrs_tpu_torch``).

One command runs one cell once::

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells; each cell's
configuration (``configs/``), traffic (``traffic/``), driver (``drivers/``)
and per-layer readers (``metrics/``) are files of their own, found by
name.  ``README.md`` says how to add one.
"""
