"""The port's named spans (uvc_tpu_torch/utils/profiler.py::span).

Off (no profiler session), ``span`` is one shared no-op and a step enters
no ``record_function`` and records nothing.  Under ``torch.profiler`` on
the CPU, a stage-1 and a stage-2 step of a narrow DeiT open each phase
span once under ``uvc.step``, each kernel wrapper they call opens its
``uvc.op.*`` span under the phase that called it, a served batch opens
``uvc.normalize`` and ``uvc.serve`` with ``uvc.embed`` and ``uvc.head``;
self times are never negative, a child lies inside its parent, and each
name's host time in ``span_totals`` is its ``user_annotation`` events'
time in the exported Chrome trace.  A backward taken through
``grad_in_span`` carries the caller's span on the thread that runs it.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import gc
import json
from typing import List, NamedTuple, Optional

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress.minimax import init_compression_state
from uvc_tpu_torch.compress.resource import build_macs_table
from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.data.pipeline import normalize_on_device
from uvc_tpu_torch.infer.compact import apply_compact, compact_model
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.parallel.mesh import Mesh
from uvc_tpu_torch.train import step as tstep
from uvc_tpu_torch.train.state import TrainHParams, create_train_state
from uvc_tpu_torch.utils import profiler

DEPTH, BATCH = 2, 4
CFG = tconfigs.ViTConfig(name="spantest", img_size=32, patch_size=8,
                         embed_dim=16, depth=DEPTH, num_heads=2,
                         mlp_ratio=2.0, num_classes=10)
HP = MinimaxHParams(enable_patch_gating=2, gating_interval=100)
THP = TrainHParams(compute_dtype=torch.float32, num_classes=10)
PHASES = ("uvc.mixup", "uvc.forward", "uvc.teacher", "uvc.loss",
          "uvc.backward", "uvc.optimizer")
# the wrappers' calls a step: the student's gated blocks and the
# teacher's dense ones forward, the student's backward
STEP_OPS = {"uvc.op.layer_attention_ln": ("uvc.forward", "uvc.teacher"),
            "uvc.op.mlp_ln_blend": ("uvc.forward",),
            "uvc.op.mlp_ln": ("uvc.teacher",),
            "uvc.op.layer_attention_ln_bwd": ("uvc.backward",),
            "uvc.op.mlp_ln_blend_bwd": ("uvc.backward",)}
# a span's time in the totals may fall short of its annotation's in the
# trace by this much (the trace's clock is an approximate one), and pass
# it by the range's own entry and exit
CLOCK_SLACK_US, RANGE_US = 5, 1000


def _setup(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params, teacher = (tvit.init_params(gen, CFG, device="cpu")
                       for _ in range(2))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (BATCH, CFG.img_size, CFG.img_size, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, BATCH))
    return gen, params, teacher, x, labels


def _stage1(gen, params, teacher, x, labels, mesh=None):
    state = create_train_state(params, THP,
                               init_compression_state(CFG, HP, "cpu"))
    step = tstep.build_stage1_step(CFG, build_macs_table(CFG), HP, THP,
                                   warmup=False, mesh=mesh)
    noise = tstep.draw_stage1_noise(gen, CFG, HP, THP, BATCH, "cpu")
    return step(state, teacher, x, labels, noise, 5.0)


def _stage2(gen, params, teacher, x, labels):
    state = create_train_state(params, THP)
    rng = np.random.default_rng(1)
    masks = {"attn": torch.from_numpy(
                 (rng.random((DEPTH, 16)) > 0.3).astype(np.float32)),
             "mlp": torch.from_numpy(
                 (rng.random((DEPTH, 32)) > 0.3).astype(np.float32))}
    step = tstep.build_stage2_step(CFG, HP, THP)
    noise = tstep.draw_stage2_noise(gen, CFG, THP, BATCH, "cpu")
    return step(state, teacher, masks, x, labels, noise)


class Span(NamedTuple):
    """A ``uvc.`` span's ``user_annotation`` event in the exported Chrome
    trace (us), with the innermost ``uvc.`` span around it on its
    thread."""

    name: str
    start: float
    end: float
    tid: int
    parent: Optional[str]


def _traced(fn, tmp_path) -> List[Span]:
    """``fn()``'s spans under a CPU profiler session, read from the
    session's Chrome trace; the totals start from zero."""
    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = sorted(
            (e for e in json.load(f)["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("uvc.")),
            key=lambda e: (e["ts"], -e["dur"]))
    out, open_ = [], {}
    for e in events:
        start, end = e["ts"], e["ts"] + e["dur"]
        stack = open_.setdefault(e["tid"], [])
        while stack and stack[-1].end < start:
            stack.pop()
        span = Span(e["name"], start, end, e["tid"],
                    stack[-1].name if stack else None)
        out.append(span)
        stack.append(span)
    return out


def _names(spans, **where):
    return [s for s in spans
            if all(getattr(s, k) == v for k, v in where.items())]


def test_off_is_one_shared_noop_and_records_nothing(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    profiler.reset_spans()
    assert profiler.span("uvc.a") is profiler.span("uvc.b")
    with profiler.span("uvc.a") as s:
        assert s is profiler.span("uvc.c")
    gen, params, teacher, x, labels = _setup()
    _stage1(gen, params, teacher, x, labels)
    _stage2(gen, params, teacher, x, labels)
    assert entered == []
    assert profiler.span_totals() == {}


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage1_mesh"])
def test_each_phase_once_under_the_step(stage, tmp_path):
    """The mesh is one process's (no process group: the all-reduce is the
    identity, its span opened all the same)."""
    gen, params, teacher, x, labels = _setup()
    run = {"stage1": _stage1, "stage2": _stage2,
           "stage1_mesh": lambda *a: _stage1(*a, mesh=Mesh(1, 0))}[stage]
    spans = _traced(lambda: run(gen, params, teacher, x, labels), tmp_path)
    (step,) = _names(spans, name="uvc.step")
    assert step.parent is None
    phases = PHASES + (("uvc.arch_update",) if stage != "stage2" else ()) \
        + (("uvc.all_reduce",) if stage == "stage1_mesh" else ())
    for name in phases:
        (got,) = _names(spans, name=name)
        assert got.parent == "uvc.step", name
    assert {s.name for s in spans if s.parent == "uvc.step"} == set(phases)
    (draw,) = _names(spans, name="uvc.draw")
    assert draw.parent is None
    for name, parents in STEP_OPS.items():
        ops = _names(spans, name=name)
        assert len(ops) == DEPTH * len(parents), (name, len(ops))
        assert sorted({s.parent for s in ops}) == sorted(parents), name
    totals = profiler.span_totals()
    assert set(totals) == {s.name for s in spans}
    for name in totals:
        assert totals[name]["calls"] == len(_names(spans, name=name)), name


def test_self_times_and_nesting(tmp_path):
    gen, params, teacher, x, labels = _setup()
    spans = _traced(lambda: _stage1(gen, params, teacher, x, labels),
                    tmp_path)
    for s in spans:
        assert s.end >= s.start
        if s.parent is None:
            continue
        around = [p for p in _names(spans, name=s.parent, tid=s.tid)
                  if p.start <= s.start and s.end <= p.end]
        assert around, s
    totals = profiler.span_totals()
    for name, row in totals.items():
        assert 0.0 <= row["self_host_ms"] <= row["host_ms"], name
    step = totals["uvc.step"]
    children = sum(totals[n]["host_ms"]
                   for n in PHASES + ("uvc.arch_update",))
    assert children <= step["host_ms"]
    assert step["self_host_ms"] == pytest.approx(
        step["host_ms"] - children, abs=1e-6)


def test_serving_spans(tmp_path):
    gen, params, _, _, _ = _setup()
    masks = {"attn": torch.ones(DEPTH, 16), "mlp": torch.ones(DEPTH, 32)}
    layers, top = compact_model(params, masks, CFG, dtype=torch.float32,
                                device="cpu")
    pixels = torch.randint(0, 256, (BATCH, 32, 32, 3), dtype=torch.uint8)
    spans = _traced(lambda: apply_compact(
        layers, top, normalize_on_device(pixels), CFG, dtype=torch.float32,
        token_ratio=0.5), tmp_path)
    (norm,) = _names(spans, name="uvc.normalize")
    (serve,) = _names(spans, name="uvc.serve")
    assert norm.parent is None and serve.parent is None
    for name in ("uvc.embed", "uvc.head", "uvc.op.layer_attention_ln",
                 "uvc.op.mlp_ln"):
        got = _names(spans, name=name)
        assert got and all(s.parent == "uvc.serve" for s in got), name
    assert len(_names(spans, name="uvc.op.mlp_ln")) == DEPTH


def test_intervals_match_the_chrome_trace(tmp_path):
    """Each name's host time in ``span_totals`` is its annotations' time
    in the trace, call for call, and the entry and exit of each range
    besides."""
    gen, params, teacher, x, labels = _setup()
    # a collection run between a span's clock and its range's (a pause of
    # milliseconds where the setup's allocations leave one due) would
    # count in one and not the other
    collecting = gc.isenabled()
    gc.disable()
    try:
        spans = _traced(lambda: _stage1(gen, params, teacher, x, labels),
                        tmp_path)
    finally:
        if collecting:
            gc.enable()
    totals = profiler.span_totals()
    for name, row in totals.items():
        mine = _names(spans, name=name)
        assert row["calls"] == len(mine), name
        traced_ms = sum(s.end - s.start for s in mine) * 1e-3
        assert traced_ms - len(mine) * CLOCK_SLACK_US * 1e-3 <= \
            row["host_ms"] <= traced_ms + len(mine) * RANGE_US * 1e-3, name


def test_backward_carries_the_callers_span_off_its_thread(monkeypatch,
                                                          tmp_path):
    """On the card the autograd engine runs the backward on its own
    thread; here it runs on the caller's, so the test has the hook take
    the caller's thread for another.  The backward then runs inside a
    second range of the caller's innermost span's name, which the
    engine's final callback closes: one in ``uvc.backward``, holding the
    backward wrappers' spans, and one for each of the architecture
    update's three gradients.  The totals count the caller's spans
    alone."""
    monkeypatch.setattr(profiler, "_off_thread", lambda caller: True)
    gen, params, teacher, x, labels = _setup()
    spans = _traced(lambda: _stage1(gen, params, teacher, x, labels),
                    tmp_path)
    outer, inner = sorted(_names(spans, name="uvc.backward"),
                          key=lambda s: s.start)
    assert (outer.parent, inner.parent) == ("uvc.step", "uvc.backward")
    assert outer.start <= inner.start <= inner.end <= outer.end
    for name in ("uvc.op.layer_attention_ln_bwd",
                 "uvc.op.mlp_ln_blend_bwd"):
        assert {s.parent for s in _names(spans, name=name)} == \
            {"uvc.backward"}, name
    arch = _names(spans, name="uvc.arch_update")
    assert sorted(s.parent for s in arch if s.parent) == \
        ["uvc.arch_update"] * 3 + ["uvc.step"]
    totals = profiler.span_totals()
    assert totals["uvc.backward"]["calls"] == 1
    assert totals["uvc.arch_update"]["calls"] == 1
