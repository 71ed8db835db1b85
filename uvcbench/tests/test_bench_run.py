"""The command refuses a machine without the card, and the rest of a run
(set-up, window, traced stretch, every reader) goes through on the CPU at
a tiny size."""

import pytest
import torch

from uvcbench import cell as cells
from uvcbench import run
from uvcbench.tests.tiny import tiny_cell


@pytest.fixture(autouse=True)
def keep_threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def test_refuses_without_the_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "deit_small.stage1", "--seed",
                     str(2 ** 31 + 11), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload_refused(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["deit_small.stage1", "deit_small.serve"])
def test_traced_drive_and_readers(name, monkeypatch):
    import uvcbench.entries.serve as serve
    monkeypatch.setattr(serve, "SAMPLE_FROM", 4)
    monkeypatch.setattr(serve, "SAMPLES", 2)
    torch.set_num_threads(2)
    record, unit = run.drive(tiny_cell(name), 0.2, True)
    assert record["units"] >= 1 and record["trace"]["units"] == \
        unit.trace_units
    bench = cells.benchmark()
    for trace in (False, True):
        for m in run.cell_metrics(bench, name, trace):
            value = run.reader(m["name"])(record)
            # no device events on the CPU: the trace's readers find nothing
            assert value is None or value >= 0
