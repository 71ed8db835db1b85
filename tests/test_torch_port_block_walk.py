"""The ViT block walk over the stacked ``[L, ...]`` parameters
(uvc_tpu_torch/models/vit.py::transformer_encode, ``_per_block``).

The walk unbinds each stacked leaf once, so that the backward stacks the
blocks' gradients once; a select per block (``v[i]``) gives the same
gradients after filling and adding L dense ``[L, ...]`` gradients, whose
extra terms are exact zeros.  So a stage-1 step's gradients through the
two walks are equal bit for bit (``torch.equal``, which takes -0 for +0):
held here on the CPU in f32 on a narrow model of three blocks, with the
block-gating blend (K3's route), with part gating (the separate branches)
and with masks on the eval route.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import dataclasses

import numpy as np
import pytest
import torch

from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress.minimax import init_compression_state
from uvc_tpu_torch.compress.resource import build_macs_table
from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.train import step as tstep
from uvc_tpu_torch.train.state import TrainHParams, create_train_state
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

CFG = tconfigs.ViTConfig(name="walktest", img_size=32, patch_size=8,
                         embed_dim=16, depth=3, num_heads=2, mlp_ratio=2.0,
                         num_classes=10)
BATCH = 4
# bench.py's flagship stage-1 settings (block gating, Gumbel token top-k)
HP = MinimaxHParams(enable_patch_gating=2, gating_interval=100)
THP = TrainHParams(compute_dtype=torch.float32, num_classes=10)


def _selects(t, depth):
    """The walk before the unbind: one select per block."""
    return [None] * depth if t is None else [t[i] for i in range(depth)]


def _step_grads(hp, seed):
    """(the gradients of one stage-1 step, its metrics) from a state, a
    batch and draws made from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    params, teacher = (tvit.init_params(gen, CFG, device="cpu")
                       for _ in range(2))
    # zero-initialised heads would leave every block's gradient 0
    for p in (params, teacher):
        p["head"]["kernel"] = 0.5 * torch.randn(
            p["head"]["kernel"].shape, generator=gen)
    state = create_train_state(params, THP,
                               init_compression_state(CFG, hp, "cpu"))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (BATCH, CFG.img_size, CFG.img_size, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, BATCH))
    noise = tstep.draw_stage1_noise(gen, CFG, hp, THP, BATCH, "cpu")
    recorded = []
    clip = tstep.clip_global_norm

    def record(grads, max_norm):
        recorded.append(grads)
        return clip(grads, max_norm)

    step = tstep.build_stage1_step(CFG, build_macs_table(CFG), hp, THP,
                                   warmup=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstep, "clip_global_norm", record)
        _, metrics = step(state, teacher, x, labels, noise, 5.0)
    return recorded[0], metrics


@pytest.mark.parametrize("part_gating", [False, True],
                         ids=["block_gating", "part_gating"])
def test_stage1_gradients_through_the_unbound_walk_are_the_selects(
        monkeypatch, part_gating):
    hp = dataclasses.replace(HP, enable_part_gating=part_gating)
    grads, metrics = _step_grads(hp, 5)
    monkeypatch.setattr(tvit, "_per_block", _selects)
    ref, ref_metrics = _step_grads(hp, 5)
    ref = dict(tree_leaves_with_path(ref))
    leaves = list(tree_leaves_with_path(grads))
    assert len(leaves) == len(ref)
    for path, g in leaves:
        assert torch.equal(g, ref[path]), path
    assert any(path[0] == "blocks" and g.any() for path, g in leaves)
    for k in ("loss", "grad_norm"):
        assert torch.equal(metrics[k], ref_metrics[k]), k


def test_masked_eval_walk_is_the_selects(monkeypatch):
    """The eval route's per-block mask rows and gating distribution go
    through the same split: logits equal bit for bit."""
    gen = torch.Generator().manual_seed(6)
    params = tvit.init_params(gen, CFG, device="cpu")
    params["head"]["kernel"] = 0.5 * torch.randn(
        params["head"]["kernel"].shape, generator=gen)
    x = torch.randn(2, CFG.img_size, CFG.img_size, 3, generator=gen)
    masks = {"attn": (torch.rand(CFG.depth, CFG.embed_dim, generator=gen)
                      > 0.3).float(),
             "mlp": (torch.rand(CFG.depth, CFG.mlp_hidden, generator=gen)
                     > 0.3).float()}
    distrib = torch.softmax(torch.randn(CFG.depth, 2, generator=gen), -1)

    def logits():
        return tvit.apply(params, x, CFG, gating_distrib=distrib,
                          masks=masks).logits

    got = logits()
    monkeypatch.setattr(tvit, "_per_block", _selects)
    assert torch.equal(got, logits())
