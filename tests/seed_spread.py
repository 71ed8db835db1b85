"""The evidence harnesses at other seeds: how often the port passes each
gate.  Test-side: it imports no JAX, so the card's machine runs it.

``offset_seeds`` is the one way a fidelity run's seeds are moved (here and
in ``samestream.py``): the harness's seeds are fixed (``run_stage1``'s 0,
the loaders' 0 / 10 / 11 and the test loader's 99), and within it each is
``offset`` more.  ``e2e_accuracy`` takes its seed as it is.  Space the
seeds at least 100 apart: ``train/stage1.py`` and ``train/stage2.py`` seed
epoch e > 1 from ``seed + e - 1``, so two runs whose seeds differ by less
than the epoch count share shifted draw streams.

Every run is a process of its own (``--jobs`` at once, each with one CPU
thread); the records are merged into one JSON per harness with each gate's
pass count:

    python tests/seed_spread.py --fidelity 100,200,300,400 \\
        --e2e 100,200,300,400 --jobs 8 --dir spread \\
        --fidelity_out FIDELITY_h100_seeds.json \\
        --e2e_out E2EACC_h100_seeds.json
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import multiprocessing
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from uvc_tpu_torch.scripts import (e2e_accuracy, print_gates,  # noqa: E402
                                   trajectory_fidelity, write_record)


@contextlib.contextmanager
def offset_seeds(offset, harness, stage1):
    """Within it, every ``harness.TextureLoader`` and every call of
    ``stage1.run_stage1`` (either package's) takes its seed ``offset``
    more."""
    base_loader, base_run = harness.TextureLoader, stage1.run_stage1

    class Loader(base_loader):
        def __init__(self, batch_size, num_batches, *, seed=0):
            super().__init__(batch_size, num_batches, seed=seed + offset)

    def run_stage1(*args, seed=42, **kw):
        return base_run(*args, seed=seed + offset, **kw)

    harness.TextureLoader, stage1.run_stage1 = Loader, run_stage1
    try:
        yield
    finally:
        harness.TextureLoader, stage1.run_stage1 = base_loader, base_run


def run_fidelity(offset, device="cuda"):
    """The port's ``trajectory_fidelity.run`` with every seed moved by
    ``offset``: its record, with ``offset`` in it."""
    import uvc_tpu_torch.train.stage1 as stage1

    with offset_seeds(offset, trajectory_fidelity, stage1), \
            tempfile.TemporaryDirectory(prefix="traj_fid_") as out:
        record, secs = trajectory_fidelity.run(out, device=device)
    record["offset"] = offset
    record["stage_s"] = secs
    return record


def merge(records):
    """Each gate's pass count over ``records`` (one harness's)."""
    gates = {}
    for rec in records:
        for k, v in rec["gates"].items():
            gates[k] = gates.get(k, 0) + bool(v)
    return {"runs": len(records), "passes": gates,
            "all_pass": sum(bool(r["ok"]) for r in records),
            "records": records}


def _one(kind, seed, device):
    if kind == "fidelity":
        record = run_fidelity(seed, device)
    else:
        with tempfile.TemporaryDirectory(prefix="e2e_acc_") as d:
            record, _ = e2e_accuracy.run(seed, d, device)
    print_gates(record["gates"])
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fidelity", type=lambda t: [int(s) for s in
                                                  t.split(",") if s],
                    default=[], help="seed offsets of the fidelity harness")
    ap.add_argument("--e2e", type=lambda t: [int(s) for s in t.split(",")
                                             if s],
                    default=[], help="seeds of the e2e harness")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--dir", default="seed_spread", help="each run's record")
    ap.add_argument("--fidelity_out", default=None)
    ap.add_argument("--e2e_out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    opts = ap.parse_args(argv)
    os.makedirs(opts.dir, exist_ok=True)
    os.environ["OMP_NUM_THREADS"] = "1"
    jobs = [("fidelity", s) for s in opts.fidelity] + \
        [("e2e", s) for s in opts.e2e]
    records, missing = {"fidelity": [], "e2e": []}, []
    with concurrent.futures.ProcessPoolExecutor(
            opts.jobs, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        futs = {pool.submit(_one, kind, seed, opts.device): (kind, seed)
                for kind, seed in jobs}
        for fut in concurrent.futures.as_completed(futs):
            kind, seed = futs[fut]
            try:
                rec = fut.result()
            except Exception as exc:  # a failed run is reported, not fatal
                missing.append({"kind": kind, "seed": seed,
                                "error": repr(exc)})
                continue
            write_record(rec, os.path.join(opts.dir, f"{kind}_{seed}.json"))
            records[kind].append(rec)
    for kind, out in (("fidelity", opts.fidelity_out),
                      ("e2e", opts.e2e_out)):
        recs = sorted(records[kind],
                      key=lambda r: r.get("offset", r.get("seed", 0)))
        lost = [m for m in missing if m["kind"] == kind]
        if not recs and not lost:
            continue
        merged = dict(merge(recs), missing=lost, concurrent_jobs=opts.jobs)
        if out:
            write_record(merged, out)
        print(f"{kind}: {merged['passes']} of {merged['runs']} runs, "
              f"missing {lost}", flush=True)
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
