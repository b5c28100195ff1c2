"""The plain reference the benchmark judges the program against.

Plain PyTorch written from the model's and the checksum's semantics: it
imports nothing of ``bevy_ggrs_tpu_torch`` or ``bevy_ggrs_tpu`` and takes
nothing the program made.  It starts from the seed's initial columns
(``port_bench/worlds.py``) and works every frame out again.
"""
