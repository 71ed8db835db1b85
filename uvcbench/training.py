"""What the training entries share: the ring of input batches, the window
loop, the first steps that the output check keeps, and the check.

Set-up builds one training state and drives it from the seed through its
first ``CHECK_STEPS`` steps by the window's own call and feed (ring slots
0, 1, 2: rows that all differ); the same state then runs the window.  The
check, once the window has closed and the program's state is freed, runs
the plain reference over those steps from the same initial weights and
batches, on the draws it makes itself from the seed
(``reference/draws.py``), and compares the program's draws with them,
each step's loss, the first gradient as AdamW got it (its first moment
after one step over 1 - b1) and each leaf's change over the steps
(``compare.py``).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import torch

from uvcbench import compare
from uvcbench.reference import draws
from uvcbench.reference import train as ref
from uvcbench.reference.model import Numerics
from uvcbench.weights import make_batches, make_params

CHECK_STEPS = 3
B1 = 0.9                     # AdamW's first-moment decay
CSTATE_KEYS = ("s", "r", "y", "p", "z", "gating_accum")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class TrainUnit:
    """A training cell: ``step()`` is one step of the program on the next
    ring slot with a fresh draw.  Subclasses build the program's step
    (``build``), draw its noise (``draw``), call it (``call``), give its
    draws and the reference's (``draws``) and run the reference
    (``reference``)."""

    kind, unit_name, trace_units = "train", "step", 4

    def __init__(self, cell):
        self.cell = cell
        w, s, dev = cell.workload, cell.sizes, cell.device
        self.batch, self.ring = w["batch"], w["ring"]
        self.cfg = cell.program_cfg()
        gen = torch.Generator(device=dev).manual_seed(cell.seed)
        self.params = make_params(s, gen, dev)
        self.teacher = make_params(s, gen, dev)
        self.x, self.y = make_batches(s, gen, self.ring, self.batch, dev)
        self.noise_gen = torch.Generator().manual_seed(cell.seed)
        self.images_per_unit = self.batch
        self.k = 0
        self.build(gen)
        self.init = ref.tmap(torch.clone, self.params)
        self.noises, self.losses = [], []
        for i in range(CHECK_STEPS):
            noise, metrics = self.step()
            self.noises.append(noise)
            self.losses.append(metrics["loss"])
            if i == 0:
                self.mu = {p: t.clone() for p, t in
                           ref.leaves(self.state.opt_state.mu)}
        self.after = self.summary_state()

    # -- the window -----------------------------------------------------

    def step(self):
        i = self.k % self.ring
        x, y = self.x[i], self.y[i]
        with torch.profiler.record_function("uvcbench.feed"):
            noise = self.draw()
        with torch.profiler.record_function("uvcbench.step"):
            t = time.perf_counter()
            self.state, metrics = self.call(x, y, noise)
            self.issue = time.perf_counter() - t
        self.k += 1
        return noise, metrics

    def run(self, stop, units: Optional[int] = None) -> dict:
        issue, n = [], 0
        while True:
            self.step()
            issue.append(self.issue)
            n += 1
            if (n >= units) if units is not None else stop():
                break
        _sync(self.cell.device)
        return {"units": n, "images": n * self.batch, "issue_s": issue}

    def describe(self) -> str:
        return f"batch {self.batch}, ring of {self.ring}"

    # -- the check --------------------------------------------------------

    def summary_state(self) -> dict:
        """The parameters' and the minimax state's leaves after the first
        steps (references: the program's step makes new tensors)."""
        flat = dict(ref.leaves(self.state.params))
        cs = self.state.cstate
        if cs is not None:
            flat.update({f"cstate/{k}": getattr(cs, k) for k in CSTATE_KEYS})
        return flat

    def program_readings(self) -> dict:
        init = dict(ref.leaves(self.init))
        init.update({f"cstate/{k}": v
                     for k, v in self.init_cstate().items()})
        return {"losses": [float(v) for v in self.losses],
                "grad_tree": {p: t / (1.0 - B1) for p, t in self.mu.items()},
                "delta": {p: t - init[p] for p, t in self.after.items()}}

    def reference_readings(self, num: Numerics) -> dict:
        trace = self.reference(num)
        init = dict(ref.leaves(self.init))
        delta = {p: t - init[p] for p, t in ref.leaves(trace.params)}
        if trace.cstate is not None:
            start = self.init_cstate()
            delta.update({f"cstate/{k}": trace.cstate[k] - start[k]
                          for k in CSTATE_KEYS})
        return {"losses": trace.losses, "grad_tree": dict(ref.leaves(trace.grad)),
                "delta": delta}

    def free_program(self) -> None:
        for name in ("state", "step_fn"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: Optional[str] = None) -> dict:
        """Every number beside its limit.  ``control`` ("fp8") judges the
        reference computed in float8 in the program's place instead."""
        program_draws, ref_draws = self.draws()
        draw_gap = draws.gap(program_draws, ref_draws)
        prog = (self.program_readings() if control is None
                else self.reference_readings(Numerics(control)))
        self.free_program()
        want = self.reference_readings(Numerics("f32"))
        want_grad = compare.norms(want["grad_tree"].items())
        keep = compare.live(want_grad)
        grad, grad_leaf = compare.worst_leaf(
            compare.norms(prog["grad_tree"].items()), want_grad, keep)
        live = compare.live_elements(want["grad_tree"])
        diff = compare.norms((p, (g - want["grad_tree"][p]) * live[p])
                             for p, g in prog["grad_tree"].items())
        err, err_leaf = compare.worst_leaf(
            diff, want_grad, keep, against={p: 0.0 for p in keep})
        changes = [compare.norms((p, d * live.get(p, 1.0))
                                 for p, d in side["delta"].items())
                   for side in (prog, want)]
        keep_change = keep | {p for p in want["delta"]
                              if p.startswith("cstate/")}
        change, change_leaf = compare.worst_leaf(*changes, keep_change)
        limits = self.cell.workload["check"]["limits"]
        out = {"draw_gap": draw_gap,
               "loss_gap": compare.loss_gap(prog["losses"], want["losses"]),
               "grad_gap": grad, "grad_err": err, "change_gap": change}
        print(f"check readings: losses {prog['losses']} vs "
              f"{want['losses']}; worst leaves: grad {grad_leaf}, grad "
              f"error {err_leaf}, change {change_leaf}; {len(keep)} of "
              f"{len(want_grad)} leaves live", file=sys.stderr, flush=True)
        return {k: {"value": v, "limit": limits[k]} for k, v in out.items()}
