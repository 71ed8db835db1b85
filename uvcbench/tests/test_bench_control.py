"""The control (the plain reference in float8 put in the program's place)
comes out not correct.

On the card (skipped without one): every cell at its own widths and
depth, the training cells at batch 256, the serving cell at its own batch,
held to the cell's own limits.  On the CPU at a tiny size: the number that
separates the control from the program reads three times the program's
there too."""

import dataclasses

import pytest
import torch

from uvcbench import cell as cells
from uvcbench.reference.model import strict_f32
from uvcbench.tests.tiny import tiny_cell

CELLS = ["deit_small.stage1", "t2t_vit_14.stage1", "deit_small.stage2",
         "deit_small.serve"]
SEPARATES = {"train": "grad_err", "serve": "logit_err"}


def _readings(c, control=None):
    unit = c.entry().Unit(c)
    if unit.kind == "serve":
        unit.run(lambda: False, units=max(unit.sample) - unit.k + 1)
    else:
        unit.run(lambda: False, units=2)
    return unit.kind, unit.check(control)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control is read at the cell's "
                    "own widths")
    strict_f32()
    c = cells.load(name, 3000000019, torch.device("cuda"))
    if c.workload["entry"] != "serve":
        c = dataclasses.replace(c, workload=dict(c.workload, batch=256))
    _, checks = _readings(c, "fp8")
    assert any(v["value"] > v["limit"] for v in checks.values()), checks


@pytest.mark.parametrize("name", CELLS)
def test_control_separates_at_a_tiny_size(name, monkeypatch):
    import uvcbench.entries.serve as serve
    monkeypatch.setattr(serve, "SAMPLE_FROM", 4)
    monkeypatch.setattr(serve, "SAMPLES", 2)
    kind, prog = _readings(tiny_cell(name, seed=11))
    _, ctl = _readings(tiny_cell(name, seed=11), "fp8")
    key = SEPARATES[kind]
    assert ctl[key]["value"] >= 3 * prog[key]["value"], (prog, ctl)
