"""Tiny cells for the CPU tests: the workload files' hyperparameters on
models cut to a few blocks of small width, run through the same entries
on the CPU (the port's plain path)."""

from __future__ import annotations

import copy
import dataclasses

import torch

from uvcbench import cell as cells

TINY = {"deit_small": dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                           num_heads=2, num_classes=10),
        "t2t_vit_14": dict(img_size=32, embed_dim=64, depth=2, num_heads=2,
                           num_classes=10, qk_scale=64 ** -0.5)}
ARCH = {"deit_small": dict(skip=[1], heads=[2, 1], dims_pruned=[0, 4],
                           units=[256, 100]),
        "t2t_vit_14": dict(skip=[1], heads=[2, 1], dims_pruned=[0, 4],
                           units=[192, 100])}


class TinyCell(cells.Cell):
    def program_cfg(self):
        from uvc_tpu_torch.configs import get_config
        return get_config(self.config["registry"]).replace(
            **self.config["model"])


def tiny_cell(name: str, seed: int = 1, batch: int = 8) -> TinyCell:
    real = cells.load(name, seed, torch.device("cpu"))
    config = copy.deepcopy(real.config)
    config["model"].update(TINY[config["name"]])
    config["architecture"].update(ARCH[config["name"]])
    workload = copy.deepcopy(real.workload)
    workload.update(batch=batch, ring=4)
    if "train" in workload:
        workload["train"]["num_classes"] = config["model"]["num_classes"]
        workload["check"]["chunk"] = 3
    sizes = dataclasses.replace(real.sizes, **config["model"])
    return TinyCell(name, workload, config, sizes, seed, torch.device("cpu"))
