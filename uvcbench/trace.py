"""The traced stretch: a few units of traffic under ``torch.profiler``,
reduced to what the per-layer readers need.

The profiler's chrome trace gives each device event (kernel, copy,
memset) with its interval and the correlation id of the host call that
launched it, and each host operator with its interval.  Each device event
is attributed to the stack of host operators open around its launch, so
that a reader can tell the performer's ``gemm_wg`` products from the
blocks' and name an idle gap by what the host was doing to end it.  The
busy time is the union of the device intervals, not their sum: copies
and kernels on other streams overlap.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted intervals covering ``(start, end)`` pairs."""
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def _launch_stacks(host: List[dict], launches: List[dict]) -> Dict:
    """For each launch (by correlation id), the names of the host
    operators of its thread open at its start, outermost first: one sweep
    over each thread's operators in time order."""
    by_tid: Dict[int, List[dict]] = {}
    for e in host:
        by_tid.setdefault(e["tid"], []).append(e)
    out = {}
    for tid in {ln["tid"] for ln in launches}:
        ops = sorted(by_tid.get(tid, []),
                     key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[Tuple[str, float]] = []
        i = 0
        for ln in sorted((ln for ln in launches if ln["tid"] == tid),
                         key=lambda e: e["ts"]):
            t = ln["ts"]
            while i < len(ops) and ops[i]["ts"] <= t:
                while stack and stack[-1][1] < ops[i]["ts"]:
                    stack.pop()
                stack.append((ops[i]["name"],
                              ops[i]["ts"] + ops[i].get("dur", 0)))
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[ln["args"]["correlation"]] = tuple(
                name for name, end in stack if end >= t)
    return out


def reduce(events: List[dict]) -> dict:
    """The device events with their launching host stacks, the wall span
    of the device's work, its busy time and its idle gaps."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e.get("ph") == "X"]
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})]
    stacks = _launch_stacks([e for e in events if e.get("cat") in HOST_CATS
                             and e.get("ph") == "X"], launches)
    device.sort(key=lambda e: e["ts"])
    out = [{"name": e["name"], "start_s": e["ts"] * 1e-6,
            "dur_s": e.get("dur", 0) * 1e-6,
            "stack": stacks.get(e.get("args", {}).get("correlation"), ())}
           for e in device]
    if not out:
        return {"events": [], "wall_s": 0.0, "busy_s": 0.0, "gaps": []}
    busy = union([(e["start_s"], e["start_s"] + e["dur_s"]) for e in out])
    gaps = []
    starts = [e["start_s"] for e in out]
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        after = out[bisect.bisect_left(starts, nxt)]
        inner = after["stack"][-1] if after["stack"] else "host: no operator"
        outer = next((s for s in after["stack"] if s.startswith("uvcbench.")),
                     "")
        gaps.append((f"{outer} > {inner}" if outer else inner, nxt - end))
    return {"events": out,
            "wall_s": busy[-1][1] - busy[0][0],
            "busy_s": sum(b - a for a, b in busy),
            "gaps": gaps}


def profile(run: Callable[[], None]) -> dict:
    """``run()`` under the profiler (host and device activity), reduced.
    The trace file goes to a temporary directory and is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        host_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = reduce(events)
    out["host_s"] = host_s
    return out


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each ``[name, seconds]``."""
    by_name: Dict[str, float] = {}
    for e in trace["events"]:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur_s"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace["gaps"], key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
