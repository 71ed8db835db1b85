"""The output check comes out false when the timed path is broken
underneath, and for the control (the reference in float8 in the
program's place), at a tiny size on the CPU: the rest of a run (set-up,
window, check, the cell's own limits) as the command drives it, without
its look for the card."""

import pytest
import torch

from uvcbench.calibrate import planted
from uvcbench.tests.tiny import tiny_cell

FAULTS = [("deit_small.stage1", "unchanged"), ("deit_small.stage1", "half"),
          ("t2t_vit_14.stage1", "unchanged"), ("t2t_vit_14.stage1", "half"),
          ("deit_small.stage2", "unchanged"), ("deit_small.stage2", "half"),
          ("deit_small.serve", "half"), ("deit_small.serve", "altered")]


@pytest.fixture(autouse=True)
def setting(monkeypatch):
    import uvcbench.entries.serve as serve
    monkeypatch.setattr(serve, "SAMPLE_FROM", 4)
    monkeypatch.setattr(serve, "SAMPLES", 2)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault):
    c = tiny_cell(name, seed=9)
    unit = planted(c.entry().Unit, fault)(c)
    unit.run(lambda: False, units=5)
    assert not _correct(unit.check())


@pytest.mark.parametrize("name", ["deit_small.stage1", "t2t_vit_14.stage1",
                                  "deit_small.stage2", "deit_small.serve"])
def test_sound_run_is_correct(name):
    c = tiny_cell(name, seed=9)
    unit = c.entry().Unit(c)
    unit.run(lambda: False, units=5)
    assert _correct(unit.check())


def _halve_lam(noise):
    return noise._replace(mixup=noise.mixup._replace(lam=noise.mixup.lam / 2))


def _uniform_token(noise):
    return noise._replace(token=torch.rand_like(noise.token))


@pytest.mark.parametrize("name,tamper", [
    ("deit_small.stage1", _halve_lam), ("deit_small.stage1", _uniform_token),
    ("t2t_vit_14.stage1", _uniform_token), ("deit_small.stage2", _halve_lam)])
def test_wrong_draw_is_not_correct(name, tamper):
    """A program that draws its noise wrongly fails the check: the
    reference draws its own from the seed."""
    c = tiny_cell(name, seed=9)
    unit_cls = c.entry().Unit

    class WrongDraw(unit_cls):
        def draw(self):
            return tamper(super().draw())

    unit = WrongDraw(c)
    unit.run(lambda: False, units=2)
    checks = unit.check()
    assert checks["draw_gap"]["value"] > 0 and not _correct(checks)
