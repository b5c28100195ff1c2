"""The comparison fails where it must: the control (the program's own
bfloat16 snapshots) and faults planted in the timed path under a run that
skips the look for a card.  The cells run on one chip, so no exchange
between chips can be left out."""

import pytest
import torch

from port_bench.harness import run_cell

from conftest import CELLS, tiny


def _run(root, workload, config=None):
    return run_cell(root, workload, 2**31 + 77, 0.5, False, device="cpu",
                    overrides=tiny(workload, **(config or {})))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(root, workload):
    out = _run(root, workload)
    assert out["line"]["correct"] is True
    assert out["checks"]["state_gap"]["value"] == 0.0
    if workload.startswith("server"):
        # the server's rings hold views of the wave stacks: nothing copied
        assert out["work"]["window"]["materialized_saves"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(root, workload):
    out = _run(root, workload, {"snapshots": "bf16"})
    assert out["line"]["correct"] is False
    assert out["checks"]["state_gap"]["value"] > 0
    if workload.startswith("server"):
        # rounded snapshots are gathered copies: every save is counted
        assert out["work"]["window"]["materialized_saves"] > 0


def _stale(step):
    return lambda world, ctx: world


def _half(step):
    def half(world, ctx):
        new = step(world, ctx)
        n = world.alive.shape[-1]
        first = torch.arange(n, device=world.alive.device) < n // 2
        return type(world)(**{**vars(new), "comps": {
            k: torch.where(first, v, world.comps[k]) for k, v in new.comps.items()}})
    return half


def _nudged(step):
    def nudged(world, ctx):
        new = step(world, ctx)
        x = new.comps["x"]
        one = torch.arange(x.shape[-1], device=x.device) == 0
        return type(world)(**{**vars(new), "comps": {**new.comps,
                                                     "x": torch.where(one, x + 2**-10, x)}})
    return nudged


STEP_FAULTS = {"state_unchanged": _stale, "half_the_entities_left_out": _half,
               "a_value_altered": _nudged}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
def test_a_broken_step_is_not_correct(root, monkeypatch, workload, fault):
    from bevy_ggrs_tpu_torch.models import stress_soa

    monkeypatch.setattr(stress_soa, "step", STEP_FAULTS[fault](stress_soa.step))
    out = _run(root, workload)
    assert out["line"]["correct"] is False
    assert out["checks"]["state_gap"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_checksum_is_not_correct(root, monkeypatch, workload):
    from bevy_ggrs_tpu_torch.snapshot import checksum as cs

    fold = cs.checksum_fold

    def altered(*args):
        out = fold(*args).clone()
        out[:, 0, 1] ^= 1  # the low word's last bit, where the checksum is made
        return out

    monkeypatch.setattr(cs, "checksum_fold", altered)
    out = _run(root, workload)
    assert out["line"]["correct"] is False
    assert out["checks"]["checksum_mismatches"]["value"] > 0
