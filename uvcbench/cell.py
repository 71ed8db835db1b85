"""A cell of the benchmark: its workload file, its configuration file and
the sizes they state, found by name.

``uvcbench/workloads/<cell>.json`` names the configuration and the entry
and holds the cell's traffic and hyperparameters; ``uvcbench/configs/
<config>.json`` holds the model's published sizes and its compressed
architecture; ``uvcbench/entries/<entry>.py`` drives the program.  A new
cell, configuration or entry is a new file.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A model's sizes as its configuration file states them, under the
    names the reference, the FLOPs counts and the weights read."""

    name: str
    img_size: int
    patch_size: int
    in_chans: int
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float
    qkv_bias: bool
    num_classes: int
    distilled: bool
    layer_norm_eps: float
    tokens_type: str
    token_dim: int
    qk_scale: Optional[float]
    hybrid: bool = False
    cls_attn_layers: int = 0

    @property
    def head_size(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def grid_size(self) -> int:
        if self.tokens_type != "none":
            return self.img_size // 16
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (2 if self.distilled else 1)

    def tokens(self, ratio: Optional[float]) -> int:
        """Tokens entering the blocks after the top-k at ``ratio`` (the
        DeiT family; the T2T forward selects none)."""
        if ratio is None or self.tokens_type != "none":
            return self.seq_len
        return self.seq_len - self.num_patches \
            + int(ratio * self.num_patches)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    sizes: Sizes
    seed: int
    device: object

    def program_cfg(self):
        """The port's registry entry of the configuration, checked against
        the file's sizes field by field."""
        from uvc_tpu_torch.configs import get_config
        cfg = get_config(self.config["registry"])
        for key, value in self.config["model"].items():
            if getattr(cfg, key) != value:
                raise ValueError(f"{self.config['registry']}.{key} is "
                                 f"{getattr(cfg, key)!r}, the file says "
                                 f"{value!r}")
        return cfg

    def entry(self):
        return importlib.import_module(
            f"uvcbench.entries.{self.workload['entry']}")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, seed: int, device) -> Cell:
    workload = read_json(HERE / "workloads" / f"{name}.json")
    config = read_json(HERE / "configs" / f"{workload['config']}.json")
    return Cell(name, workload, config, Sizes(name=config["name"],
                                              **config["model"]),
                seed, device)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")
