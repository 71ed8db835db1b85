"""The R50+ViT hybrid through the port (uvc_tpu_torch/models/vit.py with
models/resnet.py) against the JAX package on the CPU, in f32.

The configuration is R50-ViT-B/16 cut to a CPU test: 64-pixel images (a
4 x 4 grid after the stride-16 stem), the (1, 1, 1) stem at width 1 (1024
channels into the 1 x 1 patch kernel), depth 2, D = 64 in 2 heads, 7
classes.  The weights are drawn with numpy in JAX's layout (the shapes of
``vit.init_params`` through ``jax.eval_shape``) and carried across with
``params_from_numpy``; the Gumbel and mixup draws are JAX's, fed to the
port.

Tolerances as in ``test_torch_port_train.py``: the forward 1e-5 (2e-2 in
bf16), the trajectory's metrics and minimax state 1e-5, 1e-4 relative
Frobenius per weight leaf; the key bias and the token scorer's bias, whose
gradients are zero in exact arithmetic (the softmax over keys and the
token top-k see them only as a shift shared by all), are rounding noise
and held within the learning rate times the steps.  The stem's leaves are
held like every other leaf: stage 1 and stage 2 train them as JAX trains
them.
"""

from torch_port_env import capped_threads, default_threads  # noqa: F401
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
from uvc_tpu.infer import compact as jcompact
from uvc_tpu.models import convert as jconvert
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import compact_ft as jcft
from uvc_tpu.train import state as jstate
from uvc_tpu.train.step import build_eval_step
from uvc_tpu.train.step import build_stage1_step as j_build_stage1_step
from uvc_tpu.train.step import build_stage2_step as j_build_stage2_step
from uvc_tpu.utils.checkpoint import save_checkpoint as j_save
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress import resource as tresource
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.infer import compact as tcompact
from uvc_tpu_torch.interop import (cstate_from_numpy, masks_from_numpy,
                                   params_from_numpy)
from uvc_tpu_torch.models import convert as tconvert
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.train import compact_ft as tcft
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import (Stage1Noise, Stage2Noise,
                                      build_stage1_step, build_stage2_step,
                                      eval_step)
from uvc_tpu_torch.utils.checkpoint import (load_checkpoint, params_of,
                                            restore_like, save_checkpoint)
from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4
LR = 1e-2
CUT = dict(img_size=64, depth=2, embed_dim=64, num_heads=2, num_classes=7,
           resnet_layers=(1, 1, 1))
JCFG = jconfigs.get_config("R50-ViT-B_16").replace(**CUT)
TCFG = tconfigs.get_config("R50-ViT-B_16").replace(**CUT)
# one head and 100 units off layer 0, within-head dims off both layers
S = np.array([[1.0, 100.0], [0.0, 56.0]], np.float32)
R = np.array([[0.0, 4.0], [3.0, 0.0]], np.float32)


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


def jpath(p):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


def jax_params(seed, cfg=JCFG):
    """A hybrid tree of JAX's layout (lists in the stem) with numpy draws:
    He-normal stem kernels, N(0, 0.1) linear kernels, biases and heads,
    LayerNorm / GroupNorm scales near 1, the gating rows of the init."""
    shapes = jax.eval_shape(lambda k: jvit.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        keys = jpath(path)
        if keys[-1] in ("block_gating", "attn_gating", "mlp_gating"):
            return np.tile(np.array([-1.0, 1.0], np.float32),
                           (cfg.depth, 1))
        n = rng.standard_normal(s.shape)
        if keys[0] == "resnet" and len(s.shape) == 4:
            n = n * np.sqrt(2.0 / np.prod(s.shape[:3]))
        elif keys[-1] == "scale":
            n = 1.0 + 0.1 * n
        else:
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 64, 64, 3)).astype(np.float32)


def jmasks_of(params):
    return jmasks.build_masks(params, jnp.asarray(S), jnp.asarray(R), JCFG)


def test_get_model_and_init_layout_match():
    assert get_model(tconfigs.get_config("R50-ViT-B_16")) is tvit
    ref = jax.eval_shape(lambda k: jvit.init_params(k, JCFG),
                         jax.random.PRNGKey(0))
    out = tvit.init_params(torch.Generator().manual_seed(0), TCFG,
                           device="cpu")
    jl = {jpath(p): v.shape for p, v in
          jax.tree_util.tree_leaves_with_path(ref)}
    tl = {p: tuple(v.shape) for p, v in tree_leaves_with_path(out)}
    assert tl == jl
    assert out["patch_embed"]["kernel"].shape == (1, 1, 1024, 64)
    assert [len(out["resnet"][f"block{i}"]) for i in (1, 2, 3)] == [1, 1, 1]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_matches(dtype):
    """Gated, masked, with the physical top-k token drop."""
    jd, td, tol = {"f32": (jnp.float32, torch.float32, TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    params = jax_params(1)
    masks = jmasks_of(params)
    gating = np.array([[0.3, 0.7], [0.0, 1.0]], np.float32)
    x = images(1, 3)
    kw = dict(patch_gate_mode=2, patch_ratio=0.75, patch_physical=True)
    ref = jax.jit(lambda p, xb, g, m: jvit.apply(
        p, xb, JCFG, gating_distrib=g, masks=m, dtype=jd, **kw))(
        params, jnp.asarray(x), jnp.asarray(gating), masks)
    out = tvit.apply(params_from_numpy(params, device="cpu"), t_(x), TCFG,
                     gating_distrib=t_(gating),
                     masks=masks_from_numpy(np_tree(masks), device="cpu"),
                     dtype=td, **kw)
    assert rel_fro(np_(out.logits), np_(ref.logits)) <= tol


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

HP_FIELDS = dict(
    budget=0.5, slr=0.05, rlr=0.05, glr=0.05, ylr=0.02, plr=0.02,
    zlr_schedule=(2.0,), sl2wd=1e-3, z_grad_clip=0.5, gating_weight=0.5,
    gating_interval=2, soptim="sgd", roptim="sgd", flops_with_mhsa=True,
    use_gumbel=True, eps=0.05, enable_block_gating=True,
    enable_part_gating=False, enable_patch_gating=2, patch_ratio=0.75,
    enable_pruning=True)
THP_FIELDS = dict(learning_rate=LR, warmup_steps=2, t_total=20,
                  mixup=0.0, cutmix=0.0, num_classes=7)


def _jax_stage1_noise(key, batch):
    """The draws of JAX's stage-1 step (its key chain), as the port's."""
    k_mix, k_gate, k_part1, k_part2, k_tok, k_arch = jax.random.split(key, 6)
    k_res1, k_res2, _ = jax.random.split(k_arch, 3)

    def g(k, shape):
        return t_(jax.random.gumbel(k, shape, jnp.float32))

    l2 = (JCFG.depth, 2)
    return Stage1Noise(mixup=None, gate=g(k_gate, l2),
                       token=g(k_tok, (batch, JCFG.num_patches)),
                       res1=g(k_res1, l2), res2=g(k_res2, l2),
                       part_attn=g(k_part1, l2), part_mlp=g(k_part2, l2))


def compare_tree(ttree, jtree, n_steps, tol=TRAJ_TOL):
    jl = {jpath(p): np.asarray(v) for p, v in
          jax.tree_util.tree_leaves_with_path(jtree)}
    tl = dict(tree_leaves_with_path(ttree))
    assert sorted(tl) == sorted(jl)
    for path, leaf in tl.items():
        ref, leaf = jl[path], np_(leaf)
        assert leaf.shape == ref.shape, path
        if path[-2:] == ("qkv", "bias"):
            third = leaf.shape[-1] // 3
            mid = slice(third, 2 * third)
            np.testing.assert_allclose(leaf[..., mid], ref[..., mid],
                                       atol=LR * max(1, n_steps), rtol=0)
            leaf, ref = (np.concatenate([a[..., :third], a[..., 2 * third:]],
                                        axis=-1) for a in (leaf, ref))
        if path == ("token_scorer", "bias"):
            # shared by every token's score, which the top-k and its
            # softmax see only up to a shift: rounding noise as well
            np.testing.assert_allclose(leaf, ref, atol=LR * max(1, n_steps),
                                       rtol=0)
            continue
        if np.any(ref):
            assert rel_fro(leaf, ref) <= tol, path
        else:
            np.testing.assert_allclose(leaf, ref, atol=tol, err_msg=path)


def test_stage1_trajectory_matches_jax_three_steps(default_threads):
    """3 stage-1 steps with JAX's draws (Gumbel block gating, the Gumbel
    token top-k, the gating step at step 1): the metrics, the minimax
    state and every leaf, the stem's included, after each step.  On
    torch's own thread count: the stem's convolutions sum in another
    order on one thread, and its first convolution's weight then parts
    from JAX's by 1.3e-4 of its norm after three steps."""
    jhp, thp_ = JHParams(**HP_FIELDS), THParams(**HP_FIELDS)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP_FIELDS)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP_FIELDS)
    params, teacher = jax_params(5), jax_params(105)
    cstate = jminimax.init_compression_state(JCFG, jhp)
    jst = jstate.create_train_state(params, jthp, cstate)
    tst = tstate.create_train_state(
        params_from_numpy(params, device="cpu"), tthp,
        cstate_from_numpy(np_tree(cstate), device="cpu"))
    tteacher = params_from_numpy(teacher, device="cpu")
    jstep = j_build_stage1_step(JCFG, jresource.build_macs_table(JCFG), jhp,
                                jthp, warmup=False, donate=False)
    tstep = build_stage1_step(TCFG, tresource.build_macs_table(TCFG), thp_,
                              tthp, warmup=False)
    x = images(6, 4)
    labels = np.random.default_rng(6).integers(0, 7, 4).astype(np.int32)
    stem0 = tst.params["resnet"]["block2"][0]["conv2"].clone()
    for i in range(3):
        key = jax.random.PRNGKey(70 + i)
        jst, jm = jstep(jst, teacher, jnp.asarray(x), jnp.asarray(labels),
                        key, jnp.float32(5.0))
        tst, tm = tstep(tst, tteacher, t_(x), torch.from_numpy(labels).long(),
                        _jax_stage1_noise(key, 4), 5.0)
        for k in ("loss", "grad_norm", "lr", "resource", "z"):
            np.testing.assert_allclose(np_(tm[k]), np_(jm[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        for f in ("s", "r", "y", "p", "z", "gating_accum"):
            np.testing.assert_allclose(np_(getattr(tst.cstate, f)),
                                       np_(getattr(jst.cstate, f)),
                                       rtol=1e-5, atol=1e-5)
        compare_tree(tst.params, jst.params, i + 1)
    # the stem trains
    assert not torch.equal(tst.params["resnet"]["block2"][0]["conv2"], stem0)


def test_eval_step_matches():
    params = jax_params(7)
    params["block_gating"] = np.array([[-1.0, 1.0], [1.0, -1.0]], np.float32)
    masks = jmasks_of(params)
    x = images(8, 6)
    labels = np.array([0, 3, 6, 2, -1, -1], np.int32)
    hp = dict(enable_patch_gating=2, patch_ratio=0.75)
    ref = build_eval_step(JCFG, JHParams(**hp), jstate.TrainHParams(
        compute_dtype=jnp.float32), masked=True)(
        params, masks, jnp.asarray(x), jnp.asarray(labels),
        jax.random.PRNGKey(0))
    out = eval_step(params_from_numpy(params, device="cpu"),
                    masks_from_numpy(np_tree(masks), device="cpu"),
                    t_(x), torch.from_numpy(labels).long(), TCFG,
                    THParams(**hp), dtype=torch.float32)
    assert int(out["count"]) == int(ref["count"]) == 4
    assert int(out["correct"]) == int(ref["correct"])
    assert float(out["loss_sum"]) == pytest.approx(float(ref["loss_sum"]),
                                                   rel=1e-5)


# ---------------------------------------------------------------------------
# serving and stage 2
# ---------------------------------------------------------------------------


def _stage2_setup():
    params = jax_params(9)
    masks = jmasks_of(params)
    params["block_gating"] = np.array([[-1.0, 1.0], [-1.0, 1.0]], np.float32)
    return (params, masks, params_from_numpy(params, device="cpu"),
            masks_from_numpy(np_tree(masks), device="cpu"))


@pytest.mark.parametrize("ratio", [None, 0.75], ids=["tokens_all",
                                                     "token_drop"])
def test_compact_serving_matches_jax(ratio):
    """``compact_model`` + ``apply_compact`` against JAX's in f32: the
    served model carries the stem (f32 leaves, run in the serving
    dtype)."""
    params, masks, tp, tm = _stage2_setup()
    jl, jtop = jcompact.compact_model(params, masks, JCFG)
    ref = jax.jit(lambda xb: jcompact.apply_compact(
        jl, jtop, xb, JCFG, dtype=jnp.float32, token_ratio=ratio))(
        jnp.asarray(images(10, 3)))
    layers, top = tcompact.compact_model(tp, tm, TCFG, dtype=torch.float32,
                                         device="cpu")
    assert "resnet" in top and isinstance(top["resnet"]["block1"], list)
    assert [blk["num_heads"] for blk in layers] == [1, 2]
    out = tcompact.apply_compact(layers, top, t_(images(10, 3)), TCFG,
                                 dtype=torch.float32, token_ratio=ratio)
    np.testing.assert_allclose(np_(out.logits), np_(ref.logits), rtol=TOL,
                               atol=TOL)
    # and in bf16, the stem's leaves left f32
    layers16, top16 = tcompact.compact_model(tp, tm, TCFG, device="cpu")
    assert top16["resnet"]["conv_root"].dtype == torch.float32
    out16 = tcompact.apply_compact(layers16, top16, t_(images(10, 3)), TCFG,
                                   token_ratio=ratio)
    assert rel_fro(np_(out16.logits), np_(ref.logits)) <= 2e-2


def _thps():
    fields = dict(num_classes=7, learning_rate=LR, warmup_steps=1,
                  t_total=10, mixup=0.0, cutmix=0.0, smoothing=0.1)
    return (jstate.TrainHParams(compute_dtype=jnp.float32, **fields),
            tstate.TrainHParams(compute_dtype=torch.float32, **fields))


def test_stage2_and_compact_ft_steps_match_jax():
    """One dense stage-2 step and one compact_ft step (token drop on) from
    one state, each against JAX's: metrics and every leaf, the stem's
    included; ``scatter_to_dense`` of the compact result agrees with the
    dense step on the kept coordinates."""
    params, masks, tp, tm = _stage2_setup()
    jthp, tthp = _thps()
    hp = dict(enable_patch_gating=2, patch_ratio=0.75)
    teacher = jax_params(19)
    tteacher = params_from_numpy(teacher, device="cpu")
    x = images(11, 4)
    y = np.arange(4, dtype=np.int32) % 7
    key = jax.random.PRNGKey(3)

    jst = jstate.create_train_state(params, jthp, None)
    tst = tstate.create_train_state(tp, tthp)
    jst, jm = j_build_stage2_step(JCFG, JHParams(**hp), jthp, donate=False)(
        jst, teacher, masks, jnp.asarray(x), jnp.asarray(y), key)
    tst, tm_ = build_stage2_step(TCFG, THParams(**hp), tthp)(
        tst, tteacher, tm, t_(x), torch.from_numpy(y).long(),
        Stage2Noise(mixup=None))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(np_(tm_[k]), np_(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    compare_tree(tst.params, jst.params, 1)

    jtree, jmeta = jcft.compact_train_tree(params, masks, JCFG)
    ttree, tmeta = tcft.compact_train_tree(tp, tm, TCFG)
    assert isinstance(ttree["top"]["resnet"]["block3"], list)
    jcs = jstate.create_train_state(jtree, jthp, None)
    tcs = tstate.create_train_state(ttree, tthp)
    jcs, jcm = jcft.build_compact_stage2_step(JCFG, JHParams(**hp), jthp,
                                              jmeta, donate=False)(
        jcs, teacher, masks, jnp.asarray(x), jnp.asarray(y), key)
    tcs, tcm = tcft.build_compact_stage2_step(TCFG, THParams(**hp), tthp,
                                              tmeta)(
        tcs, tteacher, tm, t_(x), torch.from_numpy(y).long(),
        Stage2Noise(mixup=None))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(np_(tcm[k]), np_(jcm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
        np.testing.assert_allclose(np_(tcm[k]), np_(tm_[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    compare_tree(tcs.params, jcs.params, 1)
    dense = tcft.scatter_to_dense(tcs.params, tmeta, tp)
    for k in ("conv_root",):
        assert rel_fro(np_(dense["resnet"][k]),
                       np_(tst.params["resnet"][k])) <= TRAJ_TOL


# ---------------------------------------------------------------------------
# weights files
# ---------------------------------------------------------------------------


def test_load_npz_with_the_stem_matches_jax(tmp_path):
    """An upstream R50+ViT ``.npz`` (``to_npz_dict`` of a hybrid tree, the
    stem's ``block{i}/unit{u}`` keys) read by both packages: JAX's tree
    leaf for leaf, the written tree back bit for bit, the stem as
    lists."""
    params = jax_params(12)
    path = str(tmp_path / "r50.npz")
    np.savez(path, **tconvert.to_npz_dict(
        params_from_numpy(params, device="cpu"), TCFG))
    ref = jconvert.load_npz_checkpoint(path, JCFG)
    out = tconvert.load_npz_checkpoint(path, TCFG)
    assert isinstance(out["resnet"]["block1"], list)
    jl = {jpath(p): np.asarray(v) for p, v in
          jax.tree_util.tree_leaves_with_path(ref)}
    assert sorted(jl) == sorted(p for p, _ in tree_leaves_with_path(out))
    for path_, leaf in tree_leaves_with_path(out):
        assert leaf.is_contiguous(), path_
        np.testing.assert_array_equal(leaf.numpy(), jl[path_],
                                      err_msg=str(path_))
        if path_[0] not in ("block_gating", "attn_gating", "mlp_gating",
                            "token_scorer"):
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(leaf_at(params, path_)),
                err_msg=str(path_))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_round_trip_rebuilds_the_stem_lists(tmp_path, writer):
    """A hybrid ``.ckpt`` written by either package holds the stem's lists
    as maps of their indices (``to_state_dict``); read without a target,
    ``params_of`` makes them lists again and ``vit.apply`` runs on it
    (JAX's own reader leaves them maps: ROADMAP.md § C); read against a
    template, ``restore_like`` does the same."""
    params = jax_params(13)
    path = str(tmp_path / "h.ckpt")
    tree = {"params": params, "epoch": 1}
    if writer == "jax":
        j_save(path, tree)
    else:
        save_checkpoint(path, {"params": params_from_numpy(params,
                                                           device="cpu"),
                               "epoch": 1})
    ck = load_checkpoint(path)
    assert isinstance(ck["params"]["resnet"]["block1"], dict)
    got = params_of(ck)
    assert isinstance(got["resnet"]["block1"], list)
    like = restore_like(params_from_numpy(params, device="cpu"), ck["params"])
    x = images(14, 2)
    ref = jax.jit(lambda p, xb: jvit.apply(p, xb, JCFG).logits)(
        params, jnp.asarray(x))
    for tree_ in (got, like):
        out = tvit.apply(tree_, t_(x), TCFG, dtype=torch.float32).logits
        np.testing.assert_allclose(np_(out), np_(ref), rtol=TOL, atol=TOL)


def test_cli_runs_from_an_upstream_npz_and_resume(tmp_path, monkeypatch):
    """The registry's R50-ViT-B_16 cut to this test's size: ``joint_train``
    from an upstream ``.npz`` (stage 1 starts from its weights, the stem's
    included), ``post_train --compact_train`` from the port's stage-1
    ``.ckpt`` and from one JAX's ``save_checkpoint`` wrote, and a stage-2
    resume from the port's stage-2 checkpoint."""
    from uvc_tpu_torch.cli import joint_train as t_joint
    from uvc_tpu_torch.cli import post_train as t_post
    from uvc_tpu_torch.train import stage1
    cfg = TCFG.replace(num_classes=1000)
    monkeypatch.setitem(tconfigs.CONFIGS, "R50-ViT-B_16", cfg)
    params = jax_params(15, JCFG.replace(num_classes=1000))
    npz = str(tmp_path / "r50.npz")
    np.savez(npz, **tconvert.to_npz_dict(
        params_from_numpy(params, device="cpu"), cfg))
    seen = {}
    real = stage1.run_stage1

    def spy(*args, **kw):
        seen["params"] = kw["params"]
        return real(*args, **kw)

    monkeypatch.setattr(stage1, "run_stage1", spy)
    run = ["--model_type", "R50-ViT-B_16", "--dataset", "synthetic",
           "--img_size", "64", "--train_batch_size", "4",
           "--eval_batch_size", "4", "--synthetic_steps", "2", "--dp", "1",
           "--enable_patch_gating", "0", "--device", "cpu", "--output_dir",
           str(tmp_path)]
    t_joint.main(run + ["--num_epochs", "1", "--warmup_epochs", "1",
                        "--post_num_epochs", "0", "--warmup_steps", "1",
                        "--model_path", npz, "--name", "s1"])
    np.testing.assert_array_equal(
        seen["params"]["resnet"]["block3"][0]["conv_proj"].numpy(),
        params["resnet"]["block3"][0]["conv_proj"])
    s1 = str(tmp_path / "s1" / "R50-ViT-B_16_1.ckpt")
    jck = str(tmp_path / "jax_s1.ckpt")
    j_save(jck, {"params": params, "masks": jmasks.build_masks(
        params, jnp.asarray(S), jnp.asarray(R), JCFG)})
    for name, src in (("s2", s1), ("s2j", jck)):
        t_post.main(run + ["--num_epochs", "1", "--compact_train",
                           "--checkpoint_dir", src, "--name", name])
        ck = load_checkpoint(str(tmp_path / name / "R50-ViT-B_16_post_0.ckpt"))
        assert int(ck["global_step"]) == 2
        assert isinstance(params_of(ck)["resnet"]["block1"], list)
    # the resumed run starts at epoch 1: it writes no epoch-0 checkpoint
    first = tmp_path / "s2j" / "R50-ViT-B_16_post_0.ckpt"
    resume_from = tmp_path / "resume_from.ckpt"
    first.rename(resume_from)
    t_post.main(run + ["--num_epochs", "2", "--compact_train",
                       "--checkpoint_dir", jck, "--name", "s2j",
                       "--resume", str(resume_from)])
    assert not first.exists()
    ck = load_checkpoint(str(tmp_path / "s2j" / "R50-ViT-B_16_post_1.ckpt"))
    assert int(ck["global_step"]) == 4
