"""The fixed game: the traffic file, not the seed or the host's pace,
decides the work of a run."""

import random
import time

import pytest

from port_bench import spec
from port_bench.drivers.common import WORK_KEYS

from conftest import ROOT

# (traffic, configuration, configuration overrides): every traffic file
CASES = [("p2p_everyframe_h4d2", "soa_lobbies_16x4m", {"matches": 2}),
         ("synctest_d7", "soa_world_32m", {})]
TICKS = 40


def play(traffic_name, config_name, extra, seed, pause=None):
    """The counters after every 10 of ``TICKS`` ticks behind the traffic's
    warm-up, with ``pause(i)`` seconds of sleep before tick ``i``."""
    config = {**spec.load_json(ROOT / f"port_bench/configs/{config_name}.json"),
              "entities": 256, **extra}
    traffic = spec.load_json(ROOT / f"port_bench/traffic/{traffic_name}.json")
    game = spec.driver(traffic["driver"]).build(config, traffic, seed, "cpu")
    out = []
    try:
        for i in range(int(traffic["warm_ticks"]) // 4 + TICKS):
            if pause is not None:
                time.sleep(pause(i))
            game.tick()
            if i % 10 == 9:
                c = game.counters()
                out.append([c[k] for k in WORK_KEYS])
    finally:
        game.close()
    return out


@pytest.mark.parametrize("traffic,config,extra", CASES, ids=[c[0] for c in CASES])
def test_every_seed_plays_the_same_game(traffic, config, extra):
    runs = [play(traffic, config, extra, seed) for seed in range(4)]
    assert all(r == runs[0] for r in runs), runs
    assert runs[0][-1][WORK_KEYS.index("rollbacks")] > 0


@pytest.mark.parametrize("traffic,config,extra", CASES, ids=[c[0] for c in CASES])
def test_a_slow_host_plays_the_same_game(traffic, config, extra):
    rng = random.Random(7)
    steady = play(traffic, config, extra, 11)
    slow = play(traffic, config, extra, 11, pause=lambda i: rng.choice((0.0, 0.0, 0.03)))
    assert slow == steady
