"""Device trace of a window of training steps (counterpart of
``uvc_tpu/utils/profiler.py``), on ``torch.profiler``.

``--profile_dir`` captures a trace over a global-step window that starts
after the first steps have paid their set-up (the kernels' build, the
allocator's first blocks), so that the trace shows steady-state device
time.  The trace is a Chrome trace (``<host>_<pid>.<ns>.pt.trace.json``
in the directory), which TensorBoard's profiler plugin and
``chrome://tracing`` both read.
"""

from __future__ import annotations

from typing import Optional

import torch


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
