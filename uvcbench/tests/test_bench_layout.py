"""Everything BENCHMARK.json names is found by name, and the file keeps
the shape its format fixes (keys, names, bounds, size)."""

import importlib
import json
import re

import pytest

from uvcbench import cell as cells
from uvcbench import run

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found(w):
    c = cells.load(w["name"], 1, "cpu")
    assert c.workload["config"] == w["config"]
    assert hasattr(c.entry(), "Unit")
    assert (cells.ROOT / next(
        k["file"] for k in BENCH["configs"] if k["name"] == w["config"])
            ).is_file()


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found(m):
    assert callable(run.reader(m["name"]))
    for cell in m.get("workloads", []):
        assert any(w["name"] == cell for w in BENCH["workloads"])


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_config_files_match_the_port_registry():
    for w in BENCH["workloads"]:
        cells.load(w["name"], 1, "cpu").program_cfg()


def test_entries_import():
    for entry in ("stage1", "stage2", "serve"):
        importlib.import_module(f"uvcbench.entries.{entry}")
