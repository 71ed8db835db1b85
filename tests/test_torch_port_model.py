"""The port's configs, selection helpers, masks, MACs table and ViT eval
forward (uvc_tpu_torch) against the JAX package, on the CPU.

Inputs are made with numpy (or JAX's own init, carried across with
``interop.params_from_numpy``) and go through both packages.  Integer and
boolean results must be equal; f32 forwards agree to 2e-4 (the same
arithmetic in another summation order); the bf16 forward against the JAX
Pallas kernels in interpret mode agrees to 2e-2 relative Frobenius (one-ulp
bf16 flips of single elements from the summation order and the JAX
kernels' polynomial erf, carried through the blocks).
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress.resource import build_macs_table as j_macs
from uvc_tpu.compress.scores import group_scores as j_group_scores
from uvc_tpu.models import vit as jvit
from uvc_tpu.ops import attention as jattn
from uvc_tpu.ops import gumbel as jgumbel
from uvc_tpu.ops.stes import bottom_k_mask as j_bottom_k
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress import masks as tmasks
from uvc_tpu_torch.compress.resource import build_macs_table as t_macs
from uvc_tpu_torch.compress.scores import group_scores as t_group_scores
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.ops import gumbel as tgumbel
from uvc_tpu_torch.ops.stes import bottom_k_mask as t_bottom_k

CFG = jconfigs.get_config("testing").replace(
    embed_dim=16, num_heads=2, depth=3, num_classes=7, img_size=64)
TCFG = tconfigs.get_config("testing").replace(
    embed_dim=16, num_heads=2, depth=3, num_classes=7, img_size=64)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def setup_model(cfg=CFG, tcfg=TCFG, patch_gating=False):
    """JAX params with a random head, a pruned architecture and one block
    gated off; the same tree carried to the port."""
    params = jvit.init_params(jax.random.PRNGKey(0), cfg,
                              patch_gating=patch_gating)
    rng = np.random.default_rng(0)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape), jnp.float32)
    if cfg.distilled:
        params["head_dist"]["kernel"] = jnp.asarray(
            0.1 * rng.standard_normal(params["head_dist"]["kernel"].shape),
            jnp.float32)
    if patch_gating:
        params["patch_gating"] = jnp.asarray(
            rng.standard_normal(params["patch_gating"].shape), jnp.float32)
    s = jnp.array([[1.0, 32.0], [0.0, 20.0], [0.0, 40.0]])
    r = jnp.array([[0.0, 0.0], [2.0, 3.0], [1.0, 0.0]])
    masks = jmasks.build_masks(params, s, r, cfg)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [-1.0, 1.0],
                                        [1.0, -1.0]])
    tparams = params_from_numpy(np_tree(params), device="cpu")
    tm = masks_from_numpy(np_tree(masks), device="cpu")
    return params, masks, tparams, tm


def hard_gating(params):
    g = np.asarray(params["block_gating"])
    keep = (g[:, 1] > g[:, 0]).astype(np.float32)
    return np.stack([1.0 - keep, keep], axis=-1)


def images(seed, b, cfg=CFG):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.img_size, cfg.img_size, cfg.in_chans)).astype(np.float32)


def rel_fro(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("name", sorted(jconfigs.CONFIGS))
def test_config_registries_agree(name):
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("head_size", "mlp_hidden", "grid_size", "num_patches",
                 "num_prefix_tokens", "seq_len"):
        assert getattr(j, prop) == getattr(t, prop)
    assert sorted(jconfigs.CONFIGS) == sorted(tconfigs.CONFIGS)
    assert jconfigs.deit_family == tconfigs.deit_family


def test_bottom_k_mask_matches_with_ties():
    rng = np.random.default_rng(1)
    scores = rng.integers(0, 4, size=(3, 5, 9)).astype(np.float32)  # ties
    k = rng.integers(0, 10, size=(3, 5))
    ref = np.asarray(j_bottom_k(jnp.asarray(scores), jnp.asarray(k)))
    out = t_bottom_k(torch.from_numpy(scores), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        t_bottom_k(torch.from_numpy(scores), 4).numpy(),
        np.asarray(j_bottom_k(jnp.asarray(scores), 4)))


@pytest.mark.parametrize("k", [1, 6, 17])
def test_token_selection_helpers_match(k):
    rng = np.random.default_rng(k)
    scores = rng.standard_normal((4, 17)).astype(np.float32)
    scores[:, 0] = -10.0            # token 0 kept anyway
    np.testing.assert_array_equal(
        tgumbel.topk_token_mask(torch.from_numpy(scores), k).numpy(),
        np.asarray(jgumbel.topk_token_mask(jnp.asarray(scores), k)))
    idx_j = np.asarray(jgumbel.physical_topk_indices(jnp.asarray(scores), k))
    idx_t = tgumbel.physical_topk_indices(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)

    t = rng.standard_normal((4, 17, 8)).astype(np.float32)
    cls = rng.standard_normal((4, 1, 8)).astype(np.float32)
    pos = rng.standard_normal((1, 18, 8)).astype(np.float32)
    ref = jgumbel.gather_tokens_with_pos(
        jnp.asarray(t), jnp.asarray(idx_j), [jnp.asarray(cls)],
        jnp.asarray(pos), jnp.float32)
    out = tgumbel.gather_tokens_with_pos(
        torch.from_numpy(t), idx_t, [torch.from_numpy(cls)],
        torch.from_numpy(pos), torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    scorer = {"kernel": rng.standard_normal((8, 1)).astype(np.float32),
              "bias": rng.standard_normal(1).astype(np.float32)}
    np.testing.assert_allclose(
        tgumbel.token_scores(torch.from_numpy(t),
                             {k_: torch.from_numpy(v)
                              for k_, v in scorer.items()}).numpy(),
        np.asarray(jgumbel.token_scores(jnp.asarray(t), scorer)),
        rtol=1e-5, atol=1e-6)


def test_masks_scores_and_param_counts_match():
    params, masks, tparams, tm = setup_model()
    for a, b in zip(j_group_scores(params["blocks"], CFG.num_heads),
                    t_group_scores(tparams["blocks"], TCFG.num_heads)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    s = np.array([[1.0, 32.0], [0.0, 20.0], [0.0, 40.0]], np.float32)
    r = np.array([[0.0, 0.0], [2.0, 3.0], [1.0, 0.0]], np.float32)
    built = tmasks.build_masks(tparams, torch.from_numpy(s),
                               torch.from_numpy(r), TCFG)
    for key in ("attn", "mlp"):
        np.testing.assert_array_equal(built[key].numpy(),
                                      np.asarray(masks[key]))
        assert 0 < built[key].sum() < built[key].numel()
    assert tmasks.count_remaining_params(tparams, tm, TCFG) == float(
        jmasks.count_remaining_params(params, masks, CFG))
    pruned_j = jmasks.prune_weights(params, masks, CFG)["blocks"]
    pruned_t = tmasks.prune_weights(tparams, tm, TCFG)["blocks"]
    for name in ("proj", "fc1", "fc2"):
        np.testing.assert_array_equal(pruned_t[name]["kernel"].numpy(),
                                      np.asarray(pruned_j[name]["kernel"]))
    # the input tree is left as it was
    np.testing.assert_array_equal(tparams["blocks"]["fc2"]["kernel"].numpy(),
                                  np.asarray(params["blocks"]["fc2"]["kernel"]))


@pytest.mark.parametrize("name", ["deit_tiny_patch16_224",
                                  "deit_small_patch16_224",
                                  "deit_base_distilled_patch16_384",
                                  "t2t_vit_14"])
def test_macs_table_matches(name):
    j = j_macs(jconfigs.get_config(name))
    t = t_macs(tconfigs.get_config(name))
    assert t.embed == j.embed and t.dense_flops == j.dense_flops
    np.testing.assert_array_equal(t.block, j.block)
    if name == "deit_tiny_patch16_224":
        # the reference log's "Initial FLOP size: 2506.98M"
        assert abs(t.dense_flops / 1e6 - 2506.98) < 0.01


@pytest.mark.parametrize("distilled,patch_gating", [(False, False),
                                                    (True, True)])
def test_init_params_layout_matches(distilled, patch_gating):
    cfg, tcfg = (CFG.replace(distilled=distilled),
                 TCFG.replace(distilled=distilled))
    j = np_tree(jvit.init_params(jax.random.PRNGKey(0), cfg,
                                 patch_gating=patch_gating))
    t = tvit.init_params(torch.Generator().manual_seed(0), tcfg,
                         patch_gating=patch_gating, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(j)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda v: v.numpy(), t,
                     is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and b.dtype == np.float32, path
        name = jax.tree_util.keystr(path)
        if a.size > 100 and "kernel" in name and "head" not in name:
            # truncated normal, std 0.02 before the cut at 2 std
            assert np.abs(b).max() <= 0.04 + 1e-6
            assert 0.015 < b.std() < 0.02
        elif "head" in name or "bias" in name or "gating" in name \
                or "scale" in name:
            np.testing.assert_array_equal(b, a)


FORWARDS = {
    # the eval step's forward: hard gating, masks, physical top-k tokens
    "gated_masked_physical": dict(gating=True, masks=True, patch_gate_mode=2,
                                  patch_physical=True),
    # deterministic top-k with zero-masked ghost rows
    "masked_tokens": dict(gating=True, masks=True, patch_gate_mode=2),
    # ungated blocks, no masks, every block output summed
    "jumping": dict(jumping=True),
    # hard sigmoid patch gate
    "patch_gate": dict(gating=True, masks=True, patch_gate_mode=1,
                       patch_hard=True),
    # distilled two-token model
    "distilled": dict(gating=True, masks=True, patch_gate_mode=2,
                      patch_physical=True, distilled=True),
}


def _forwards(case, dtype_j, dtype_t, n_img=3):
    kw = dict(FORWARDS[case])
    distilled = kw.pop("distilled", False)
    cfg, tcfg = (CFG.replace(distilled=distilled),
                 TCFG.replace(distilled=distilled))
    params, masks, tparams, tm = setup_model(
        cfg, tcfg, patch_gating=kw.get("patch_gate_mode") == 1)
    gating = kw.pop("gating", False)
    use_masks = kw.pop("masks", False)
    x = images(4, n_img)
    g = hard_gating(params) if gating else None
    ref = jvit.apply(params, jnp.asarray(x), cfg,
                     gating_distrib=None if g is None else jnp.asarray(g),
                     masks=masks if use_masks else None, patch_ratio=0.7,
                     dtype=dtype_j, **kw)
    out = tvit.apply(tparams, torch.from_numpy(x), tcfg,
                     gating_distrib=None if g is None else torch.from_numpy(g),
                     masks=tm if use_masks else None, patch_ratio=0.7,
                     dtype=dtype_t, **kw)
    return ref, out, cfg


@pytest.mark.parametrize("case", sorted(FORWARDS))
def test_apply_matches_f32(case):
    ref, out, cfg = _forwards(case, jnp.float32, torch.float32)
    for a, b in ((ref.logits, out.logits), (ref.logits_kd, out.logits_kd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(
        tvit.eval_logits(out, cfg).numpy(),
        np.asarray(jvit.eval_logits(ref, cfg)), rtol=2e-4, atol=2e-4)
    if ref.token_mask is None:
        assert out.token_mask is None
    else:
        np.testing.assert_array_equal(out.token_mask.numpy(),
                                      np.asarray(ref.token_mask))


def test_apply_matches_pallas_interpret_bf16(monkeypatch):
    monkeypatch.setattr(jattn, "_FORCE_FUSED_INTERPRET", True)
    ref, out, _ = _forwards("gated_masked_physical", jnp.bfloat16,
                            torch.bfloat16, n_img=2)
    assert rel_fro(out.logits.numpy(), np.asarray(ref.logits)) <= 2e-2


def test_training_paths_raise_not_implemented():
    """A PRNG key as rng is refused (the port takes its draws as tensors);
    drop-path without its keep decisions is refused too."""
    _, _, tparams, _ = setup_model()
    x = torch.from_numpy(images(5, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tvit.apply(tparams, x, TCFG, patch_gate_mode=2, rng=0)
    with pytest.raises(ValueError, match="drop_path"):
        tvit.apply(tparams, x, TCFG, train=True, drop_path_rate=0.1)
