"""The port's T2T-ViT (uvc_tpu_torch/models/t2t_vit.py) against the JAX
package on the CPU, in f32: the stem, the forward and every parameter
gradient, the 3-step stage-1 trajectory, the eval step, and compact
serving with the config's fixed attention scale.

The configuration is T2T-ViT-14 cut to a CPU test: 32-pixel images
(4 patch tokens), depth 2 and 10 classes, with its published widths
(D = 384, 6 heads, F = 1152, token dim 64) and ``qk_scale = 384 ** -0.5``.
The port's performer stem takes the accelerator layout (space-to-depth
stage 1 with masked LN1, permuted unfolds) where JAX's CPU route unfolds in
nn.Unfold order and composes the stage: the same function in another
summation order.

Tolerances: the stem's output and the logits 1e-5 (relative and absolute);
gradients 1e-5 relative Frobenius per leaf, except the key bias of the
blocks, whose gradient is zero in exact arithmetic (softmax is invariant to
a shift shared by all keys) and so is rounding noise: it is held to an
absolute 1e-7.  The trajectory and the eval step as in
``test_torch_port_train.py``: 1e-5 on the metrics and the minimax state,
1e-4 relative Frobenius per weight leaf, the key bias to the learning rate
times the steps.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress import minimax as jminimax
from uvc_tpu.compress import resource as jresource
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.models import t2t_vit as jt2t
from uvc_tpu.train import state as jstate
from uvc_tpu.train.step import build_eval_step
from uvc_tpu.train.step import build_stage1_step as j_build_stage1_step
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.compress import resource as tresource
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.infer import compact as tcompact
from uvc_tpu_torch.interop import (cstate_from_numpy, masks_from_numpy,
                                   params_from_numpy)
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.models import t2t_vit as tt2t
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import Stage1Noise, build_stage1_step, eval_step
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4
CUT = dict(img_size=32, depth=2, num_classes=10)
JCFG = jconfigs.get_config("t2t_vit_14").replace(**CUT)
TCFG = tconfigs.get_config("t2t_vit_14").replace(**CUT)
KINDS = {"performer": "t2t_vit_14", "transformer": "t2t_vit_t_14"}


def cfgs(kind):
    name = KINDS[kind]
    return (jconfigs.get_config(name).replace(**CUT),
            tconfigs.get_config(name).replace(**CUT))


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t_(x):
    return torch.from_numpy(np.array(x, np.float32))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(seed, cfg=JCFG):
    params = jt2t.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    return params


def images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def leaf_of(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_get_model_dispatches_the_t2t_family():
    from uvc_tpu_torch.models import t2t_ablations
    assert get_model(TCFG) is tt2t
    assert get_model(tconfigs.get_config("t2t_vit_t_14")) is tt2t
    for name in ("t2t_vit_14_se", "t2t_vit_dense"):
        assert get_model(tconfigs.get_config(name)) is t2t_ablations
    # the other backbones: the R50 hybrid is a ViT, CaiT its own module
    from uvc_tpu_torch.models import cait, vit
    assert get_model(tconfigs.get_config("R50-ViT-B_16")) is vit
    for name in tconfigs.CONFIGS:
        if name.startswith("cait_"):
            assert get_model(tconfigs.get_config(name)) is cait


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_init_params_layout_matches(kind):
    jcfg, tcfg = cfgs(kind)
    ref = np_tree(jt2t.init_params(jax.random.PRNGKey(0), jcfg))
    out = tt2t.init_params(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    jl = {tuple(getattr(k, "key", k) for k in p): v for p, v in
          jax.tree_util.tree_leaves_with_path(ref)}
    tl = dict(tree_leaves_with_path(out))
    assert sorted(tl) == sorted(jl)
    for path, leaf in tl.items():
        assert tuple(leaf.shape) == jl[path].shape, path
        assert leaf.dtype == torch.float32
    if kind == "performer":
        # orthogonal random features scaled by sqrt(m)
        w = out["t2t"]["attention1"]["prm_w"]
        np.testing.assert_allclose((w @ w.T).numpy(), 32 * np.eye(32),
                                   atol=1e-4)


def test_init_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt2t.init_params(torch.Generator().manual_seed(0), TCFG)


def test_sinusoid_and_unfolds_match():
    np.testing.assert_array_equal(tt2t.sinusoid_pos_embed(5, 384),
                                  jt2t.sinusoid_pos_embed(5, 384))
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 5)).astype(
        np.float32)
    for k, s, p in ((7, 4, 2), (3, 2, 1)):
        np.testing.assert_array_equal(
            tt2t._unfold(t_(x), k, s, p).numpy(),
            np.asarray(jt2t._unfold(jnp.asarray(x), k, s, p)))
        np.testing.assert_array_equal(
            tt2t._unfold_klast(t_(x), k, s, p).numpy(),
            np.asarray(jt2t._unfold_klast(jnp.asarray(x), k, s, p)))
    np.testing.assert_array_equal(tt2t._klast_perm(3, 5),
                                  jt2t._klast_perm(3, 5))


# block gating with one block half-kept, structural masks
GATING = np.array([[0.3, 0.7], [0.0, 1.0]], np.float32)


def _masks(seed, cfg=JCFG):
    rng = np.random.default_rng(seed)
    return {"attn": (rng.random((cfg.depth, cfg.embed_dim)) > 0.3).astype(
        np.float32),
        "mlp": (rng.random((cfg.depth, cfg.mlp_hidden)) > 0.3).astype(
        np.float32)}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stem_and_apply_match_f32(kind, gated):
    jcfg, tcfg = cfgs(kind)
    params = jax_params(1, jcfg)
    x = images(1, 3)
    kw_j, kw_t = {}, {}
    if gated:
        m = _masks(1, jcfg)
        kw_j = dict(gating_distrib=jnp.asarray(GATING),
                    masks={k: jnp.asarray(v) for k, v in m.items()})
        kw_t = dict(gating_distrib=t_(GATING),
                    masks={k: t_(v) for k, v in m.items()})
    tp = params_from_numpy(np_tree(params), device="cpu")
    np.testing.assert_allclose(
        np_(tt2t.t2t_stem(tp, t_(x), tcfg)),
        np_(jt2t.t2t_stem(params, jnp.asarray(x), jcfg)), rtol=TOL, atol=TOL)
    tops.reset_launch_counts()
    out = tt2t.apply(tp, t_(x), tcfg, **kw_t)
    ref = jt2t.apply(params, jnp.asarray(x), jcfg, **kw_j)
    np.testing.assert_allclose(np_(out.logits), np_(ref.logits), rtol=TOL,
                               atol=TOL)
    assert out.token_mask is None
    assert all(v == 0 for v in tops.launch_counts().values())


def _key_bias(path):
    return path == ("blocks", "qkv", "bias")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_apply_param_grads_match_f32(kind):
    """Gradients of a loss of the logits with respect to every parameter
    leaf (stem, blocks, head, gating), against jax.grad."""
    jcfg, tcfg = cfgs(kind)
    params = jax_params(2, jcfg)
    x = images(2, 2)
    w = np.random.default_rng(3).standard_normal((2, 10)).astype(np.float32)
    m = _masks(2, jcfg)

    def jloss(p):
        out = jt2t.apply(p, jnp.asarray(x), jcfg,
                         gating_distrib=jnp.asarray(GATING),
                         masks={k: jnp.asarray(v) for k, v in m.items()})
        return jnp.sum(out.logits * w)

    jg = np_tree(jax.grad(jloss)(params))
    tp = params_from_numpy(np_tree(params), device="cpu")
    leaves = [(path, leaf.requires_grad_())
              for path, leaf in tree_leaves_with_path(tp)]
    out = tt2t.apply(tp, t_(x), tcfg, gating_distrib=t_(GATING),
                     masks={k: t_(v) for k, v in m.items()})
    grads = torch.autograd.grad((out.logits * t_(w)).sum(),
                                [v for _, v in leaves], allow_unused=True)
    d = jcfg.embed_dim
    for (path, leaf), g in zip(leaves, grads):
        ref = leaf_of(jg, path)
        got = np.zeros_like(ref) if g is None else np_(g)
        if _key_bias(path):
            np.testing.assert_allclose(got[:, d:2 * d], ref[:, d:2 * d],
                                       atol=1e-7, rtol=0)
            got, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                        for a in (got, ref))
        if np.any(ref):
            assert rel_fro(got, ref) <= TOL, path
        else:
            np.testing.assert_allclose(got, ref, atol=1e-7, err_msg=path)


# ---------------------------------------------------------------------------
# the stage-1 step against build_stage1_step
# ---------------------------------------------------------------------------

HP_FIELDS = dict(
    budget=0.5, slr=0.05, rlr=0.05, glr=0.05, ylr=0.02, plr=0.02,
    zlr_schedule=(2.0,), sl2wd=1e-3, z_grad_clip=0.5, gating_weight=0.5,
    gating_interval=2, soptim="sgd", roptim="sgd", flops_with_mhsa=True,
    use_gumbel=True, eps=0.05, enable_block_gating=True,
    enable_part_gating=False, enable_patch_gating=2, patch_ratio=0.75,
    enable_pruning=True)
THP_FIELDS = dict(learning_rate=1e-2, warmup_steps=2, t_total=20,
                  mixup=0.0, cutmix=0.0, num_classes=10)


def _jax_stage1_noise(key, batch):
    k_mix, k_gate, k_part1, k_part2, k_tok, k_arch = jax.random.split(key, 6)
    k_res1, k_res2, _ = jax.random.split(k_arch, 3)

    def g(k, shape):
        return t_(jax.random.gumbel(k, shape, jnp.float32))

    l2 = (JCFG.depth, 2)
    return Stage1Noise(mixup=None, gate=g(k_gate, l2),
                       token=g(k_tok, (batch, JCFG.num_patches)),
                       res1=g(k_res1, l2), res2=g(k_res2, l2),
                       part_attn=g(k_part1, l2), part_mlp=g(k_part2, l2))


def _compare(tst, jst, lr):
    for f in ("s", "r", "y", "p", "z", "gating_accum"):
        np.testing.assert_allclose(np_(getattr(tst.cstate, f)),
                                   np_(getattr(jst.cstate, f)), rtol=1e-5,
                                   atol=1e-5)
    d = JCFG.embed_dim
    for path, leaf in tree_leaves_with_path(tst.params):
        ref = np.asarray(leaf_of(jst.params, path))
        leaf = np_(leaf)
        if _key_bias(path):
            np.testing.assert_allclose(leaf[:, d:2 * d], ref[:, d:2 * d],
                                       atol=lr * max(1, tst.step), rtol=0)
            leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                         for a in (leaf, ref))
        if np.any(ref):
            assert rel_fro(leaf, ref) <= TRAJ_TOL, path
        else:
            np.testing.assert_allclose(leaf, ref, atol=TRAJ_TOL)


def test_stage1_trajectory_matches_jax_three_steps():
    """3 stage-1 steps with JAX's draws (Gumbel block gating, the token
    draw the T2T forward ignores, the gating step at step 1): metrics,
    minimax state and every weight leaf after each step; prm_w stays put
    and the global gradient norm sees its zero gradient."""
    jhp, thp_ = JHParams(**HP_FIELDS), THParams(**HP_FIELDS)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP_FIELDS)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP_FIELDS)
    params, teacher = jax_params(5), jax_params(105)
    cstate = jminimax.init_compression_state(JCFG, jhp)
    jst = jstate.create_train_state(params, jthp, cstate)
    tst = tstate.create_train_state(
        params_from_numpy(np_tree(params), device="cpu"), tthp,
        cstate_from_numpy(np_tree(cstate), device="cpu"))
    tteacher = params_from_numpy(np_tree(teacher), device="cpu")
    jstep = j_build_stage1_step(JCFG, jresource.build_macs_table(JCFG), jhp,
                                jthp, warmup=False, donate=False)
    tstep = build_stage1_step(TCFG, tresource.build_macs_table(TCFG), thp_,
                              tthp, warmup=False)
    x = images(6, 4)
    labels = np.random.default_rng(6).integers(0, 10, 4).astype(np.int32)
    w0 = tst.params["t2t"]["attention1"]["prm_w"].clone()
    for i in range(3):
        key = jax.random.PRNGKey(70 + i)
        jst, jm = jstep(jst, teacher, jnp.asarray(x), jnp.asarray(labels),
                        key, jnp.float32(5.0))
        tst, tm = tstep(tst, tteacher, t_(x), torch.from_numpy(labels).long(),
                        _jax_stage1_noise(key, 4), 5.0)
        for k in ("loss", "grad_norm", "lr", "resource", "z"):
            np.testing.assert_allclose(np_(tm[k]), np_(jm[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        _compare(tst, jst, THP_FIELDS["learning_rate"])
    assert torch.equal(tst.params["t2t"]["attention1"]["prm_w"], w0)


@pytest.mark.parametrize("masked", [True, False])
def test_eval_step_matches(masked):
    params = jax_params(7)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [1.0, -1.0]])
    m = _masks(7)
    x = images(8, 6)
    labels = np.array([0, 3, 6, 2, -1, -1], np.int32)
    jhp = JHParams(enable_patch_gating=2, patch_ratio=0.7)
    thp = THParams(enable_patch_gating=2, patch_ratio=0.7)
    ref = build_eval_step(JCFG, jhp, jstate.TrainHParams(
        compute_dtype=jnp.float32), masked=masked)(
        params, {k: jnp.asarray(v) for k, v in m.items()}, jnp.asarray(x),
        jnp.asarray(labels), jax.random.PRNGKey(0))
    out = eval_step(params_from_numpy(np_tree(params), device="cpu"),
                    masks_from_numpy(m, device="cpu") if masked else None,
                    t_(x), torch.from_numpy(labels).long(), TCFG, thp,
                    dtype=torch.float32)
    assert int(out["count"]) == int(ref["count"]) == 4
    assert int(out["correct"]) == int(ref["correct"])
    assert float(out["loss_sum"]) == pytest.approx(float(ref["loss_sum"]),
                                                   rel=1e-5)


# ---------------------------------------------------------------------------
# compact serving with qk_scale
# ---------------------------------------------------------------------------


def test_compact_t2t_uses_the_config_attention_scale():
    """Compact T2T-ViT-14 (reduced depth 3, block 1 gated off, 3 of 6 heads
    and 576 of 1152 units kept, within-head dims pruned) against the
    port's and JAX's masked-dense ``t2t_vit.apply`` in f32: the compact
    forward attends with ``qk_scale``, as the trained forward does."""
    jcfg, tcfg = JCFG.replace(depth=3), TCFG.replace(depth=3)
    params = jax_params(9, jcfg)
    s = jnp.array([[3.0, 576.0]] * 3)
    r = jnp.array([[0.0, 2.0, 0.0, 5.0, 0.0, 1.0]] * 3)
    masks = jmasks.build_masks(params, s, r, jcfg)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [1.0, -1.0],
                                        [-1.0, 1.0]])
    gating = jnp.array([[0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    x = images(9, 3)
    ref = jt2t.apply(params, jnp.asarray(x), jcfg, gating_distrib=gating,
                     masks=masks).logits
    tp = params_from_numpy(np_tree(params), device="cpu")
    tm = masks_from_numpy(np_tree(masks), device="cpu")
    dense = tt2t.apply(tp, t_(x), tcfg, gating_distrib=t_(gating),
                       masks=tm).logits
    layers, top = tcompact.compact_model(tp, tm, tcfg, dtype=torch.float32,
                                         device="cpu")
    assert len(layers) == 2 and "t2t" in top
    assert [blk["num_heads"] for blk in layers] == [3, 3]
    assert [blk["fc1"]["kernel"].shape[1] for blk in layers] == [640, 640]
    out = tcompact.apply_compact(layers, top, t_(x), tcfg,
                                 dtype=torch.float32).logits
    np.testing.assert_allclose(np_(dense), np_(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=TOL, atol=TOL)
    # the head-size scale of the DeiT family would not agree
    unscaled = tcompact.apply_compact(layers, top, t_(x),
                                      tcfg.replace(qk_scale=None),
                                      dtype=torch.float32).logits
    assert rel_fro(np_(unscaled), np_(ref)) > 100 * TOL
