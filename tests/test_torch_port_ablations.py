"""The port's T2T architecture ablations (uvc_tpu_torch/models/
t2t_ablations.py: SE, Ghost, Dense) and the tree utilities that carry
their list-and-None parameter trees, against the JAX package on the CPU,
in f32.

The configurations are the three ablations cut to a CPU test: 32-pixel
images (4 patch tokens), token dim 16, 10 classes; SE and Ghost at width
32 with 2 heads and depth 2; Dense at width 32 with 2 heads, growth 16 and
one block per stage, and a Dense with 8 heads at width 40 and growth 8,
whose head dims (5, then 3 after the transition) are odd.

JAX's CPU route attends with ``reference_attention`` (softmax normalised
before P @ V) and the port with the core kernel's plain version
(normalised after): in f32 the same function in another rounding order.
Tolerances: logits and every parameter gradient 1e-5 relative Frobenius
(exact zeros of the unread gating logits to 1e-7 absolute); the 3-step
baseline trajectories as ``test_torch_port_baseline.py`` holds them: 1e-5
on the metrics, 1e-4 relative Frobenius per weight leaf.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.baselines import finetune as jfinetune
from uvc_tpu.baselines import pruning as jpruning
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.models import t2t_ablations as jabl
from uvc_tpu.train import state as jstate
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.baselines import finetune as tfinetune
from uvc_tpu_torch.baselines import pruning as tpruning
from uvc_tpu_torch.data.mixup import MixupDraw
from uvc_tpu_torch.interop import params_from_numpy, wmasks_from_numpy
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.models import t2t_ablations as tabl
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.utils.tree import (leaf_at, tree_leaves,
                                      tree_leaves_with_path, tree_map)

TOL = 1e-5
TRAJ_TOL = 1e-4
CUT = dict(img_size=32, token_dim=16, num_classes=10)
VARIANTS = {
    "se": ("t2t_vit_14_se", dict(embed_dim=32, depth=2, num_heads=2)),
    "ghost": ("t2t_vit_16_ghost", dict(embed_dim=32, depth=2, num_heads=2)),
    "dense": ("t2t_vit_dense", dict(embed_dim=32, num_heads=2,
                                    growth_rate=16,
                                    dense_block_config=(1, 1))),
    "dense_odd": ("t2t_vit_dense", dict(embed_dim=40, num_heads=8,
                                        growth_rate=8,
                                        dense_block_config=(1, 1))),
}


def cfgs(variant):
    name, kw = VARIANTS[variant]
    return (jconfigs.get_config(name).replace(**CUT, **kw),
            tconfigs.get_config(name).replace(**CUT, **kw))


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def t_(x):
    return torch.from_numpy(np.array(x, np.float32))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_init(seed, jcfg):
    return jax.jit(jabl.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)


def jax_params(seed, jcfg):
    params = jax_init(seed, jcfg)
    rng = np.random.default_rng(seed)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    return params


def images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def layout(tree, path=()):
    """{dotted path: shape, or None for a None node} of a tree of dicts
    and lists (JAX's with numpy leaves, or the port's)."""
    if tree is None:
        return {".".join(path): None}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {".".join(path): tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(layout(v, path + (str(k),)))
    return out


def test_get_model_dispatches_the_ablations():
    for name in ("t2t_vit_14_se", "t2t_vit_16_ghost", "t2t_vit_dense"):
        assert get_model(tconfigs.get_config(name)) is tabl
    for variant in VARIANTS:
        assert get_model(cfgs(variant)[1]) is tabl


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_params_layout_matches(variant):
    jcfg, tcfg = cfgs(variant)
    ref = layout(np_tree(jax_init(0, jcfg)))
    out = tabl.init_params(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    assert layout(out) == ref
    assert isinstance(out["ablation_blocks"], list)
    assert "blocks" not in out
    for _, leaf in tree_leaves_with_path(out):
        assert leaf.dtype == torch.float32
    if variant.startswith("dense"):
        plan, final = tabl.dense_plan(tcfg)
        assert plan == jabl.dense_plan(jcfg)[0]
        assert out["head"]["kernel"].shape == (final, 10)
        assert not out["head"]["kernel"].any()


def test_full_size_dense_plan_and_head_dims():
    """The published Dense config: widths 128 .. 592 in four stages, final
    width 584, eight heads whose dims include the odd 41, 49, 57, 65."""
    cfg = tconfigs.get_config("t2t_vit_dense")
    plan, final = tabl.dense_plan(cfg)
    widths = [d for kind, d in plan if kind == "block"]
    assert widths == [128, 192, 256, 160, 224, 288, 352, 416, 480, 272, 336,
                      400, 464, 528, 592, 328, 392, 456, 520]
    assert final == 584
    assert sorted({d // 8 for d in widths}) == [
        16, 20, 24, 28, 32, 34, 36, 41, 42, 44, 49, 50, 52, 57, 58, 60, 65,
        66, 74]
    assert plan == jabl.dense_plan(jconfigs.get_config("t2t_vit_dense"))[0]


def test_init_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tabl.init_params(torch.Generator().manual_seed(0), cfgs("se")[1])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_logits_and_param_grads_match_f32(variant):
    """Logits, and the gradients of a loss of the logits with respect to
    every parameter leaf (stem, ablation blocks, head, unread gating
    logits), against jax.grad of the JAX CPU forward."""
    jcfg, tcfg = cfgs(variant)
    params = jax_params(1, jcfg)
    x = images(1, 2)
    w = np.random.default_rng(2).standard_normal((2, 10)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jabl.apply(p, jnp.asarray(x), jcfg).logits * w)

    ref = jax.jit(jabl.apply, static_argnums=2)(params, jnp.asarray(x), jcfg)
    jg = np_tree(jax.jit(jax.grad(jloss))(params))
    tp = params_from_numpy(np_tree(params), device="cpu")
    leaves = [(path, leaf.requires_grad_())
              for path, leaf in tree_leaves_with_path(tp)]
    tops.reset_launch_counts()
    out = tabl.apply(tp, t_(x), tcfg, train=True, drop_path_rate=0.1,
                     drop_path=None)
    assert rel_fro(np_(out.logits), np_(ref.logits)) <= TOL
    assert out.token_mask is None
    assert all(v == 0 for v in tops.launch_counts().values())
    grads = torch.autograd.grad((out.logits * t_(w)).sum(),
                                [v for _, v in leaves], allow_unused=True)
    assert len(grads) == len(jax.tree.leaves(jg))
    for (path, leaf), g in zip(leaves, grads):
        r = leaf_at(jg, path)
        got = np.zeros_like(r) if g is None else np_(g)
        if np.any(r):
            assert rel_fro(got, r) <= TOL, path
        else:
            np.testing.assert_allclose(got, r, atol=1e-7, err_msg=path)


def test_qk_scale_wins_over_the_head_dim_scale():
    jcfg, tcfg = cfgs("dense")
    jcfg, tcfg = jcfg.replace(qk_scale=0.3), tcfg.replace(qk_scale=0.3)
    params = jax_params(3, jcfg)
    # sharpen the attention, so that its scale shows in the logits
    for blk in params["ablation_blocks"]:
        if "qkv" in blk:
            blk["qkv"]["kernel"] = 30.0 * blk["qkv"]["kernel"]
    x = images(3, 2)
    tp = params_from_numpy(np_tree(params), device="cpu")
    ref = jax.jit(jabl.apply, static_argnums=2)(params, jnp.asarray(x),
                                                jcfg).logits
    out = tabl.apply(tp, t_(x), tcfg).logits
    assert rel_fro(np_(out), np_(ref)) <= TOL
    plain = tabl.apply(tp, t_(x), tcfg.replace(qk_scale=None)).logits
    assert rel_fro(np_(plain), np_(ref)) > 100 * TOL


# ---------------------------------------------------------------------------
# the tree utilities on an ablation tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["se", "ghost", "dense"])
def test_mask_paths_and_flat_masks_match(variant):
    """Maskable paths and the flat mask checkpoint carry JAX's dotted
    paths letter for letter (list items by index); the SE gate's linears
    are maskable, the Ghost q / k / v, cheap scalars and the Dense growth
    and transition linears are not; the None biases stay None."""
    jcfg, _ = cfgs(variant)
    params = jax_params(4, jcfg)
    tp = params_from_numpy(np_tree(params), device="cpu")
    paths = tpruning.maskable_paths(tp)
    assert sorted(paths) == sorted(jpruning.maskable_paths(params))
    assert "ablation_blocks.0.mlp.fc2.kernel" in paths
    if variant == "se":
        assert "ablation_blocks.0.se.fc1.kernel" in paths
        assert "ablation_blocks.1.se.fc2.kernel" in paths
    if variant == "ghost":
        assert not any(p.endswith((".q.kernel", ".k.kernel", ".v.kernel"))
                       for p in paths)
    if variant == "dense":
        assert not any("dense_linear" in p or ".lin." in p for p in paths)
    jm = jpruning.global_threshold_mask(jpruning.magnitude_scores(params),
                                        0.5)
    tm = tpruning.global_threshold_mask(tpruning.magnitude_scores(tp), 0.5)
    flat = tpruning.masks_to_flat(tm)
    assert sorted(flat) == sorted(jpruning.maskable_paths(params))
    jflat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in p): np.asarray(m)
             for p, m in jax.tree_util.tree_leaves_with_path(jm)}
    assert sorted(jflat) == sorted(flat)
    for k, m in flat.items():
        np.testing.assert_array_equal(m, jflat[k], err_msg=k)
    back = tpruning.masks_from_flat(flat, tp)
    assert layout(back) == layout(tm)
    for (_, a), (_, b) in zip(tree_leaves_with_path(back),
                              tree_leaves_with_path(tm)):
        assert torch.equal(a, b)
    if variant != "dense":
        assert tm["ablation_blocks"][0]["qkv" if variant == "se" else "q"][
            "bias"] is None
    masked = tpruning.apply_weight_masks(tp, tm)
    assert layout(masked) == layout(tp)


def test_optimizer_and_clipping_keep_none_leaves():
    jcfg, tcfg = cfgs("ghost")
    tp = params_from_numpy(np_tree(jax_params(5, jcfg)), device="cpu")
    thp = tstate.TrainHParams(compute_dtype=torch.float32, num_classes=10)
    tx = tstate.make_weight_optimizer(thp, lr_fn=lambda _: 1e-3)
    opt = tx.init(tp)
    assert layout(opt.mu) == layout(tp) == layout(opt.nu)
    grads = tree_map(torch.ones_like, tp)
    clipped, total = tstate.clip_global_norm(grads, 1.0)
    n = sum(g.numel() for g in tree_leaves(tp))
    assert float(total) == pytest.approx(n ** 0.5, rel=1e-6)
    assert layout(clipped) == layout(tp)
    updates, opt = tx.update(clipped, opt, tp)
    updates = tstate.zero_frozen_updates(updates)
    assert layout(updates) == layout(tp)
    assert opt.count == 1
    assert not updates["t2t"]["attention1"]["prm_w"].any()
    assert updates["ablation_blocks"][1]["q"]["bias"] is None
    assert updates["ablation_blocks"][1]["q"]["kernel"].any()


# ---------------------------------------------------------------------------
# the baseline fine-tune and eval steps against the JAX package's
# ---------------------------------------------------------------------------

THP_FIELDS = dict(learning_rate=1e-2, warmup_steps=2, t_total=20,
                  mixup=0.8, cutmix=1.0, smoothing=0.1, num_classes=10,
                  distillation_type="none")


def _jax_mixup(key, jthp):
    """The mixup draw of one JAX baseline step, along its key chain."""
    k_mix, _, _ = jax.random.split(key, 3)
    lam, blend, box = jmixup._sample_one(
        k_mix, 32, 32, jthp.mixup, jthp.cutmix, jthp.mixup_prob,
        jthp.mixup_switch_prob, jthp.cutmix_minmax)
    return MixupDraw(t_(lam), torch.tensor(bool(blend)),
                     torch.from_numpy(np.array(box)))


@pytest.mark.parametrize("variant", ["se", "ghost", "dense"])
def test_baseline_trajectory_matches_jax(variant):
    """3 baseline fine-tune steps (mixup / cutmix with JAX's draws, label
    smoothing, AdamW; drop-path 0.1 passed and ignored by the ablation
    forward, as in JAX; SE under a half-density magnitude mask): metrics
    and every weight leaf after each step."""
    jcfg, tcfg = cfgs(variant)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP_FIELDS)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP_FIELDS)
    params = jax_params(6, jcfg)
    jstep = jfinetune.build_baseline_step(jcfg, jthp, donate=False,
                                          drop_path_rate=0.1)
    tstep = tfinetune.build_baseline_step(tcfg, tthp, drop_path_rate=0.1)
    jmasks = tmasks = None
    if variant == "se":
        jmasks = jpruning.global_threshold_mask(
            jpruning.magnitude_scores(params), 0.5)
        tmasks = wmasks_from_numpy(np_tree(jmasks), device="cpu")
    jst = jfinetune.create_baseline_state(params, jthp)
    tst = tfinetune.create_baseline_state(
        params_from_numpy(np_tree(params), device="cpu"), tthp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    keep = torch.ones(tcfg.depth, 2, 4, dtype=torch.bool)
    for i in range(3):
        key = jax.random.PRNGKey(80 + i)
        jst, jm = jstep(jst, None, jmasks, jnp.asarray(x),
                        jnp.asarray(labels), key, jnp.float32(-1.0))
        noise = tfinetune.BaselineNoise(mixup=_jax_mixup(key, jthp),
                                        erasing=None, token=None,
                                        drop_path=keep)
        tst, tm = tstep(tst, None, tmasks, t_(x),
                        torch.from_numpy(labels).long(), noise, -1.0)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(np_(tm[k]), np.asarray(jm[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        assert tst.step == int(jst.step)
        for path, leaf in tree_leaves_with_path(tst.params):
            ref = np.asarray(leaf_at(jst.params, path))
            if np.any(ref):
                assert rel_fro(np_(leaf), ref) <= TRAJ_TOL, path
            else:
                np.testing.assert_allclose(np_(leaf), ref, atol=TRAJ_TOL)
        assert layout(tst.params) == layout(np_tree(jst.params))
    if tmasks is not None:
        # no gradient reached a masked coordinate: its first moment is 0
        for path, m in tree_leaves_with_path(tmasks):
            mu = leaf_at(tst.opt_state.mu, path)
            assert not torch.any(mu[m == 0]), path


@pytest.mark.parametrize("variant", ["se", "ghost", "dense_odd"])
def test_baseline_eval_step_matches_jax(variant):
    jcfg, tcfg = cfgs(variant)
    params = jax_params(8, jcfg)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, num_classes=10)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, num_classes=10)
    jm = jpruning.global_threshold_mask(jpruning.magnitude_scores(params),
                                        0.5)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 5).astype(np.int32)
    labels[-1] = -1                         # a padding row
    ref = jfinetune.build_baseline_eval_step(jcfg, jthp)(
        params, jm, jnp.asarray(x), jnp.asarray(labels))
    out = tfinetune.build_baseline_eval_step(tcfg, tthp)(
        params_from_numpy(np_tree(params), device="cpu"),
        wmasks_from_numpy(np_tree(jm), device="cpu"), t_(x),
        torch.from_numpy(labels).long())
    assert int(out["correct"]) == int(ref["correct"])
    assert int(out["count"]) == int(ref["count"]) == 4
    np.testing.assert_allclose(float(out["loss_sum"]), float(ref["loss_sum"]),
                               rtol=TOL)
