"""The frozen counts against the bounds PERF.md's kernel table holds
(chip_smoke.py's counts, recomputed products included there), and the
model FLOPs and architectures the configuration files state."""

import pytest
import torch

from uvcbench import flops
from uvcbench.cell import load
from uvcbench.weights import arch_blocks


def _with_recompute(w):
    return flops.Work(w.flops + w.recompute, w.bytes, w.f32_flops)


@pytest.mark.parametrize("name,work,us,by", [
    ("K1 dense", flops.attention_fwd(64, 197, 384, 6, 64), 18.9,
     "operations"),
    ("A2 train", _with_recompute(flops.attention_bwd(64, 197, 384, 6, 64)),
     52.9, "operations"),
    ("A4 train", _with_recompute(flops.mlp_bwd(64, 197, 384, 1536,
                                               blend=True)), 75.2,
     "operations"),
    ("K2 compact", flops.mlp_fwd(64, 138, 384, 768), 10.5, "operations"),
    ("A10 t2t_stage1 forward", flops.performer_fwd(64, 3136, 192), 30.9,
     "bytes"),
    ("A10 t2t_stage1 backward",
     _with_recompute(flops.performer_bwd(64, 3136, 192)), 74.0,
     "operations"),
])
def test_bound_matches_kernel_table(name, work, us, by):
    assert round(work.bound_s() * 1e6, 1) == us, name
    assert work.bound_by() == by


def test_recompute_never_counts():
    a2 = flops.attention_bwd(64, 197, 384, 6, 64)
    assert a2.recompute > 0
    assert a2.bound_s() < _with_recompute(a2).bound_s()


def test_deit_small_forward_gflop():
    s = load("deit_small.stage1", 1, torch.device("cpu")).sizes
    one = flops.forward_flops(s, s.seq_len, flops.dense_blocks(s))
    assert round(one / 1e9, 1) == 9.2


@pytest.mark.parametrize("cell", ["deit_small.serve", "t2t_vit_14.stage1"])
def test_architecture_halves_the_flops(cell):
    c = load(cell, 1, torch.device("cpu"))
    s, arch = c.sizes, c.config["architecture"]
    dense = flops.forward_flops(s, s.seq_len, flops.dense_blocks(s))
    comp = flops.forward_flops(s, s.tokens(arch["token_ratio"]),
                               arch_blocks(s, arch),
                               scorer=s.tokens_type == "none")
    assert 0.45 <= comp / dense <= 0.55
