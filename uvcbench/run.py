"""Run one cell of the benchmark of ``uvc_tpu_torch`` on the card.

    python3 -m uvcbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the kernel libraries, the weights and inputs made on
the card from the seed, the cell's first units, which the output check
keeps), then a window of ``--seconds`` in which the cell's entry drives
the program, then, with ``--trace 1``, a short stretch under the
profiler, then the output check against the plain reference.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number the check compared with
its limit.  The metrics are read by ``uvcbench/metrics/<name>.py`` from
the run's record; which metrics a cell reports is ``BENCHMARK.json``'s.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from uvcbench import cell as cells  # noqa: E402
from uvcbench.trace import breakdown  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "uvc_tpu")
HOST_THREADS = 1


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared as whole names)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def reader(name: str):
    """The reader of metric ``name``: ``uvcbench/metrics/<name>.py``'s
    ``read(record)``."""
    path = cells.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"uvcbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m
            or cell in m["workloads"]]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not readable"


def drive(cell: cells.Cell, seconds: float, trace: bool) -> tuple:
    """Set-up, the window, the traced stretch (``trace``); returns (the
    run's record, the entry's set-up object).  Runs on any device; the
    command refuses a machine without the card before it gets here."""
    import torch

    from uvcbench import trace as tracing

    unit = cell.entry().Unit(cell)
    sync = (torch.cuda.synchronize if cell.device.type == "cuda"
            else (lambda: None))
    sync()
    setup_s = time.perf_counter() - T_START
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window = unit.run(lambda: time.perf_counter() - t0 >= seconds)
    window_s = time.perf_counter() - t0
    record = {"cell": cell.name, "kind": unit.kind, "setup_s": setup_s,
              "window_s": window_s, "images_per_unit": unit.images_per_unit,
              "flops_per_unit": unit.flops_per_unit, "work": unit.work(),
              **window}
    if cell.device.type == "cuda":
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    if trace:
        from uvc_tpu_torch.ops import (backward_launch_counts, launch_counts,
                                       reset_launch_counts)
        reset_launch_counts()
        done = {}

        def stretch():
            done.update(unit.run(lambda: False, units=unit.trace_units))

        record["trace"] = tracing.profile(stretch)
        record["trace"].update(
            units=done["units"], issue_s=done["issue_s"],
            launches={**launch_counts(), **backward_launch_counts()})
    return record, unit


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = cells.benchmark()
    spec = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if spec is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    # one host thread for the program's CPU work (the draws): on a shared
    # host a parallel region waits for its slowest thread
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from uvcbench.reference.model import strict_f32
    strict_f32()
    cell = cells.load(args.workload, args.seed, torch.device("cuda"))
    card = card_line()
    print(f"card: {card}", file=sys.stderr, flush=True)

    record, unit = drive(cell, args.seconds, bool(args.trace))
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    described = unit.describe()
    checks = unit.check()
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec["chips"],
              "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": record["units"],
              "failed": record.get("failed", 0), "metrics": metrics,
              "device": device}
    print(f"{args.workload}: {record['units']} {unit.unit_name}s of "
          f"{unit.images_per_unit} images in {record['window_s']:.4f} s "
          f"after {record['setup_s']:.3f} s of set-up; "
          f"{described} [{card}]", file=sys.stderr)
    if args.trace:
        tr = record["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        result["breakdown"] = breakdown(tr)
        print(f"traced {tr['units']} {unit.unit_name}s: busy "
              f"{tr['busy_s']:.6f} s of {tr['wall_s']:.6f} s, "
              f"{len(tr['events'])} device events, launches "
              f"{tr['launches']}", file=sys.stderr)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
