"""Read the output check's numbers over many seeds in one process, for the
limits in a workload file's ``check``: the program's sound runs, the
control (the reference in float8 in the program's place) and the planted
faults, each at the cell's own size on the card.

    python3 -m uvcbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults half,unchanged] \\
        [--fault-seeds 7,8,9] [--seconds 1.5] [--out <file.jsonl>]

Each reading is one JSON line: the cell, the kind (``program``,
``control``, or the fault's name), the seed and every number.  A training
cell's readings need no window; a serving cell's runs a short one at the
cell's own load, long enough to serve every sampled batch.  The
benchmark's own runs never run this.

A fault is planted in a subclass of the entry's unit (``planted``), so the
timed path of a benchmark run has none of it: a training step that
leaves its state unchanged or leaves half of the batch out (the loss then
a mean over the rest), a served batch whose second half repeats its
first, an answer altered where it is produced.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from uvcbench import cell as cells
from uvcbench.reference.model import strict_f32


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


class _Unchanged:
    def call(self, x, y, noise):
        state = self.state
        _, metrics = super().call(x, y, noise)
        return state, metrics


class _HalfBatch:
    def call(self, x, y, noise):
        half = self.batch // 2
        if getattr(noise, "token", None) is not None:
            noise = noise._replace(token=noise.token[:half])
        return super().call(x[:half], y[:half], noise)


class _HalfServed:
    def _serve(self, x):
        logits, _ = super()._serve(x)
        half = self.batch // 2
        logits = torch.cat([logits[:half], logits[:half]])
        return logits, logits.argmax(dim=-1)


class _Altered:
    def _serve(self, x):
        logits, ids = super()._serve(x)
        ids = ids.clone()
        ids[0] = (ids[0] + 1) % logits.shape[-1]
        return logits, ids


FAULTS = {"train": {"unchanged": _Unchanged, "half": _HalfBatch},
          "serve": {"half": _HalfServed, "altered": _Altered}}


def planted(unit, fault: str):
    """The entry's unit class ``unit`` with ``fault`` planted under its
    timed path."""
    return type(f"{unit.__name__}_{fault}", (FAULTS[unit.kind][fault], unit),
                {})


def reading(name: str, seed: int, kind: str, seconds: float) -> dict:
    cell = cells.load(name, seed, torch.device("cuda"))
    unit = cell.entry().Unit
    if kind not in ("program", "control"):
        unit = planted(unit, kind)
    unit = unit(cell)
    if unit.kind == "serve":
        t0 = time.perf_counter()
        unit.run(lambda: time.perf_counter() - t0 >= seconds)
    got = unit.check("fp8" if kind == "control" else None)
    del unit
    gc.collect()
    torch.cuda.empty_cache()
    return {"cell": name, "kind": kind, "seed": seed,
            **{k: v["value"] for k, v in got.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.5)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    strict_f32()
    jobs = [("program", s) for s in _seeds(args.seeds)]
    jobs += [("control", s) for s in _seeds(args.control_seeds)]
    jobs += [(f, s) for f in args.faults.split(",") if f
             for s in _seeds(args.fault_seeds)]
    out = open(args.out, "a") if args.out else None
    for kind, seed in jobs:
        line = json.dumps(reading(args.workload, seed, kind, args.seconds))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
