"""Device trace of a window of training steps (counterpart of
``uvc_tpu/utils/profiler.py``), on ``torch.profiler``, and the port's
named spans.

``--profile_dir`` captures a trace over a global-step window that starts
after the first steps have paid their set-up (the kernels' build, the
allocator's first blocks), so that the trace shows steady-state device
time.  The trace is a Chrome trace (``<host>_<pid>.<ns>.pt.trace.json``
in the directory), which TensorBoard's profiler plugin and
``chrome://tracing`` both read.

The trace carries the port's spans (``span``): each phase of a training
step (``uvc.draw``, ``uvc.step`` and its children ``uvc.mixup``,
``uvc.forward``, ``uvc.teacher``, ``uvc.loss``, ``uvc.backward``,
``uvc.all_reduce``, ``uvc.optimizer``, ``uvc.arch_update``), of a served
batch (``uvc.normalize``, ``uvc.serve`` with ``uvc.embed`` and
``uvc.head``) and each kernel wrapper's call (``uvc.op.<wrapper>``, at
the boundary where the wrapper raises its ``launches`` counter).  A span
is a ``record_function`` range, so every kernel launched inside it
carries its name in the trace; under ``torch.autograd.profiler.
emit_nvtx`` the same spans become NVTX ranges for Nsight Systems.  A
backward taken through ``grad_in_span`` carries the name of the span
around it on the autograd engine's thread too.  A span is on exactly
while a profiler session records (``torch.autograd._profiler_enabled()``);
off, ``span`` returns one shared no-op context and costs a flag check.
On, each span also adds to per-name totals (``span_totals``), which
``reset_spans`` clears.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled


class _Off:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_LOCK = threading.Lock()
_LOCAL = threading.local()
# name -> [calls, ns, self ns]
_TOTALS: Dict[str, List[int]] = {}


def _open_spans() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class _Span:
    """An open span: its ``record_function`` range, its start, and the
    time its children on its thread covered.  Its time takes in its own
    range's entry and exit."""

    __slots__ = ("name", "start", "children", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the range is made and the span pushed before the clock is read,
        # so that nothing but the range's own entry and exit (no allocation,
        # hence no collection) lies between the two clocks' readings
        self.children = 0
        self._rf = torch.profiler.record_function(self.name)
        _open_spans().append(self)
        self.start = time.perf_counter_ns()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        dur = time.perf_counter_ns() - self.start
        stack = _open_spans()
        stack.pop()
        if stack:
            stack[-1].children += dur
        with _LOCK:
            row = _TOTALS.setdefault(self.name, [0, 0, 0])
            row[0] += 1
            row[1] += dur
            row[2] += dur - self.children
        return False


def span(name: str):
    """A context that names the work inside it ``name`` while a profiler
    records, and does nothing otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each of its calls is ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _off_thread(caller: int) -> bool:
    """Whether this thread is not ``caller``: the autograd engine runs a
    graph on the card on its own device thread, one on the CPU on the
    caller's."""
    return threading.get_ident() != caller


def grad_in_span(outputs, inputs, **kwargs):
    """``torch.autograd.grad(outputs, inputs, **kwargs)``, whose backward
    carries the name of the caller's innermost open span on the thread
    that runs it.  While a profiler records and a span is open, a hook on
    the first node the engine runs opens a ``record_function`` range of
    that name on the engine's thread and the engine's final callback
    closes it, so that the backward's kernels, launched there, carry the
    name as the caller's do."""
    stack = _open_spans() if _profiler_enabled() else None
    if stack:
        name, caller = stack[-1].name, threading.get_ident()

        def open_range(grad_outputs):
            if not _off_thread(caller):
                return None
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            torch.autograd.Variable._execution_engine.queue_callback(
                lambda: rf.__exit__(None, None, None))
            return None

        for out in (outputs,) if torch.is_tensor(outputs) else outputs:
            if out.grad_fn is not None:
                out.grad_fn.register_prehook(open_range)
                break
    return torch.autograd.grad(outputs, inputs, **kwargs)


def span_totals() -> Dict[str, Dict[str, float]]:
    """Each span name's ``calls``, ``host_ms`` and ``self_host_ms`` (its
    time less what its children on its own thread cover) since the last
    ``reset_spans``."""
    with _LOCK:
        return {name: {"calls": n, "host_ms": ns * 1e-6,
                       "self_host_ms": own * 1e-6}
                for name, (n, ns, own) in _TOTALS.items()}


def reset_spans() -> None:
    """Forget the spans' totals."""
    with _LOCK:
        _TOTALS.clear()


class StepProfiler:
    """Start / stop a ``torch.profiler`` trace around a global-step window.

    Drivers call :meth:`step` once per loop iteration with the current
    global step, and :meth:`close` when training ends (which also stops
    a window the run never outlasted).  Inert when ``trace_dir`` is
    None.  A failure to start or stop the trace degrades to a logged
    warning and disables the profiler: profiling never ends a run.
    """

    def __init__(self, trace_dir: Optional[str] = None,
                 start_step: int = 10, num_steps: int = 5, logger=None):
        self.trace_dir = trace_dir
        self.start_step = int(start_step)
        self.stop_step = int(start_step) + int(num_steps)
        self.logger = logger
        self.active = False
        self.done = trace_dir is None
        self._prof = None

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.info(msg)
        else:
            print(msg)

    def step(self, global_step: int) -> None:
        """Advance the window; starts / stops the trace at its edges."""
        if self.done:
            return
        if not self.active:
            if global_step >= self.start_step:
                try:
                    from torch import profiler as tp
                    acts = [tp.ProfilerActivity.CPU]
                    if torch.cuda.is_available():
                        acts.append(tp.ProfilerActivity.CUDA)
                    self._prof = tp.profile(
                        activities=acts,
                        on_trace_ready=tp.tensorboard_trace_handler(
                            self.trace_dir))
                    self._prof.start()
                    self.active = True
                    self._log(f"[profiler] trace started at step "
                              f"{global_step} -> {self.trace_dir}")
                except Exception as e:           # noqa: BLE001
                    self.done = True
                    self._log(f"[profiler] start failed ({e!r}); "
                              f"profiling disabled for this run")
        elif global_step >= self.stop_step:
            self.close()

    def close(self) -> None:
        """Stop an in-flight trace and write it (idempotent)."""
        if self.active:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self._prof.stop()
                self._log(f"[profiler] trace written to {self.trace_dir}")
            except Exception as e:               # noqa: BLE001
                self._log(f"[profiler] stop failed ({e!r})")
            self.active = False
            self._prof = None
        self.done = True


def from_args(args, logger=None) -> Optional[StepProfiler]:
    """Build a StepProfiler from the CLI namespace (None when off)."""
    trace_dir = getattr(args, "profile_dir", None)
    if not trace_dir:
        return None
    return StepProfiler(trace_dir, getattr(args, "profile_start", 10),
                        getattr(args, "profile_steps", 5), logger=logger)
