"""Metrics logging and the compression time-series dumps (counterpart of
``uvc_tpu/utils/logging.py``).

An append-only JSONL metrics stream (``metrics.jsonl``), the same
``s_`` / ``r_`` / ``gating_`` series files, the log lines on stdout and,
with ``enable_tensorboard``, the same float scalars as a TensorBoard event
file in ``<dir>/tb`` (``utils/tb_events.py``), written only from the main
process: rank 0 of the process group, or the one process when there is no
group.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from uvc_tpu_torch.utils.tb_events import EventFileWriter


class AverageMeter:
    """(joint_train.py:65-80)"""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(1, self.count)


def is_main_process() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _as_list(value):
    if torch.is_tensor(value):
        value = value.detach().float().cpu().numpy()
    return np.asarray(value).tolist()


class MetricLogger:
    def __init__(self, output_dir: str, name: str,
                 enable_series: bool = True,
                 enable_tensorboard: bool = False):
        self.dir = os.path.join(output_dir, name)
        self.enable_series = enable_series
        self.run_id = time.strftime("%Y%m%d-%H%M%S")
        self._tb = None
        if is_main_process():
            os.makedirs(self.dir, exist_ok=True)
            self.metrics_path = os.path.join(self.dir, "metrics.jsonl")
            if enable_tensorboard:
                # reference --enable_writer (joint_train.py:456-463): the
                # event file of utils/tb_events.py; a directory it cannot
                # write to raises
                self._tb = EventFileWriter(os.path.join(self.dir, "tb"))
        self._series: Dict[str, str] = {}

    def log_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
        if not is_main_process():
            return
        rec = {"step": int(step)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step" and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))
            self._tb.flush()

    def log_series(self, kind: str, step: int, value) -> None:
        """Append one {step: tensor} record to the s_/r_/gating_ series
        (reference file format: a growing JSON dict keyed by step)."""
        if not (is_main_process() and self.enable_series):
            return
        path = os.path.join(self.dir, f"{kind}_{self.run_id}.json")
        if path not in self._series:
            with open(path, "w") as f:
                f.write("{}")
            self._series[path] = path
        with open(path, "r+") as f:
            data = json.load(f)
            data[str(int(step))] = _as_list(value)
            f.seek(0)
            json.dump(data, f)
            f.truncate()

    def info(self, msg: str) -> None:
        if is_main_process():
            print(msg, flush=True)

    def close(self) -> None:
        """Closes the event file, if one is open."""
        if self._tb is not None:
            self._tb.close()
