"""The evidence harnesses (counterparts of the repo's ``scripts/``):
``e2e_accuracy`` (dense -> stage 1 -> stage 2 -> compact serving, gates
A1-A9) and ``trajectory_fidelity`` (the published logs' two FLOPs
regimes, gates T1-T6b and B1-B6).  Run each as ``python -m
uvc_tpu_torch.scripts.<name> --out <record>.json``; it computes on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import subprocess

import torch


def device_dtype(dev: torch.device) -> torch.dtype:
    """The compute dtype of ``dev``: bf16 on the card, whose sublayer
    kernels take bf16 only, f32 on the CPU."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def device_record(dev: torch.device):
    """``(backend, device)`` for a record: on the card ``"cuda"`` and its
    name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, else ``("cpu", "cpu")``."""
    if dev.type != "cuda":
        return "cpu", "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "cuda", out.stdout.strip().splitlines()[0]


def print_gates(gates):
    for name, passed in gates.items():
        print(f"{name}: {'PASS' if passed else 'FAIL'}")


def write_record(record, path):
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {path}")
