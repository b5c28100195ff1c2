"""Drivers: one game loop per kind, found by the traffic file's ``driver``.

A driver module ``<name>.py`` has ``build(config, traffic, seed, device)``
returning a :class:`~port_bench.drivers.common.Game`: the game set up,
sessions synchronized, and nothing yet warmed.  The harness warms it, runs
its window and asks it for what it produced.
"""
