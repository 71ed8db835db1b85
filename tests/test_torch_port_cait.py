"""The port's CaiT (uvc_tpu_torch/models/cait.py) against the JAX
package's (uvc_tpu/models/cait.py) on the CPU, and CaiT through the
baseline suite: the baseline fine-tune step and its eval, and
``generate_mask`` / ``baseline_train`` through their CLIs.

The configuration is CaiT-S24-224 cut to a CPU test: 32-pixel images (4
patch tokens), depth 2, 10 classes, with its published widths (D = 384,
8 heads of 48, F = 1536, 2 class-attention blocks).  The weights are drawn
with numpy in JAX's layout (the shapes of ``cait.init_params`` through
``jax.eval_shape``; the LayerScale gammas and the talking-head mixers
drawn too, so that every branch carries signal) and carried across with
``params_from_numpy``.

Tolerances: the forward 1e-5 in f32 (2e-2 in bf16), gradients 1e-5
relative Frobenius per leaf, the 3-step trajectory 1e-5 on the metrics
and 1e-4 per leaf.  Three leaves have gradients that are zero in exact
arithmetic, because the softmax over keys sees them only as a shift
shared by all keys: the qkv bias's key third, the class attention's key
bias and the pre-softmax mixer's bias (``proj_l.bias``).  Theirs are
rounding noise, held to 1e-6 absolute, and their values in the trajectory
within the learning rate times the steps.  CaiT launches no kernel of
the port: its talking heads mix the logits across heads around the
softmax, so it is a composition, as in the JAX package.
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
from uvc_tpu.cli import generate_mask as j_gen
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.models import cait as jcait
from uvc_tpu.train import state as jstate
from uvc_tpu.utils.checkpoint import load_checkpoint as j_load
from uvc_tpu.utils.checkpoint import save_checkpoint as j_save
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.baselines import finetune as tfinetune
from uvc_tpu_torch.cli import baseline_train as t_base
from uvc_tpu_torch.cli import generate_mask as t_gen
from uvc_tpu_torch.compress import resource as tresource
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.data.mixup import MixupDraw
from uvc_tpu_torch.interop import params_from_numpy, wmasks_from_numpy
from uvc_tpu_torch.models import cait as tcait
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import build_stage1_step
from uvc_tpu_torch.utils.checkpoint import load_checkpoint
from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4
LR = 1e-2
CUT = dict(img_size=32, depth=2, num_classes=10)
JCFG = jconfigs.get_config("cait_S24_224").replace(**CUT)
TCFG = tconfigs.get_config("cait_S24_224").replace(**CUT)


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


def jpath(p):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


def jax_params(seed):
    """A CaiT tree of JAX's layout with numpy draws: N(0, 0.1) kernels,
    biases, tokens and heads, LayerNorm scales near 1, LayerScale gammas
    N(0.3, 0.1), the [H, H] mixers near the identity."""
    shapes = jax.eval_shape(lambda k: jcait.init_params(k, JCFG),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        keys = jpath(path)
        n = 0.1 * rng.standard_normal(s.shape)
        if keys[-1] == "scale":
            n = n + 1.0
        elif keys[-1] in ("gamma1", "gamma2"):
            n = n + 0.3
        elif keys[-2:] in (("proj_l", "kernel"), ("proj_w", "kernel")):
            n = n + np.eye(s.shape[-1])
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# the bound of a gradient that is rounding noise: sums of ~1e5 f32 terms
NOISE_GRAD = 1e-6


def _split_noise(path, got, ref, atol):
    """Hold the coordinates whose gradient is zero in exact arithmetic
    (the key bias of either attention, the pre-softmax mixer's bias)
    within ``atol``; return the rest of the leaf (None, None where
    nothing is left)."""
    d = JCFG.embed_dim
    if path in (("blocks", "proj_l", "bias"), ("blocks_ca", "k", "bias")):
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0,
                                   err_msg=str(path))
        return None, None
    if path == ("blocks", "qkv", "bias"):
        np.testing.assert_allclose(got[:, d:2 * d], ref[:, d:2 * d],
                                   atol=atol, rtol=0, err_msg=str(path))
        return (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                for a in (got, ref))
    return got, ref


def images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def test_get_model_and_init_layout_match():
    for name in tconfigs.CONFIGS:
        if name.startswith("cait_"):
            assert get_model(tconfigs.get_config(name)) is tcait
    ref = jax.eval_shape(lambda k: jcait.init_params(k, JCFG),
                         jax.random.PRNGKey(0))
    out = tcait.init_params(torch.Generator().manual_seed(0), TCFG,
                            patch_gating=True, device="cpu")
    jl = {jpath(p): v.shape for p, v in
          jax.tree_util.tree_leaves_with_path(ref)}
    assert {p: tuple(v.shape) for p, v in tree_leaves_with_path(out)} == jl
    np.testing.assert_array_equal(out["blocks"]["gamma1"].numpy(),
                                  np.full((2, 384), 1e-5, np.float32))
    assert not out["head"]["kernel"].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_matches(dtype):
    """The forward, the UVC arguments passed and ignored (as JAX ignores
    them), no kernel launched."""
    jd, td, tol = {"f32": (jnp.float32, torch.float32, TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    params = jax_params(1)
    x = images(1, 3)
    ref = jax.jit(lambda p, xb: jcait.apply(p, xb, JCFG, dtype=jd))(
        params, jnp.asarray(x))
    tops.reset_launch_counts()
    out = tcait.apply(params_from_numpy(params, device="cpu"), t_(x), TCFG,
                      dtype=td, gating_distrib=torch.ones(2, 2),
                      masks={"attn": None}, patch_gate_mode=2, train=True,
                      drop_path_rate=0.1, drop_path=None)
    assert all(v == 0 for v in tops.launch_counts().values())
    assert out.logits.shape == (3, 10) and out.token_mask is None
    assert torch.equal(out.logits, out.logits_kd)
    assert rel_fro(np_(out.logits), np_(ref.logits)) <= tol


def test_param_grads_match_jax_grad():
    """Gradients of a weighted sum of the logits with respect to every
    leaf, the talking-head mixers and the class-attention blocks'
    included (all nonzero)."""
    params = jax_params(2)
    x = images(2, 2)
    w = np.random.default_rng(3).standard_normal((2, 10)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jcait.apply(p, jnp.asarray(x), JCFG).logits * w)

    jg = jax.jit(jax.grad(jloss))(params)
    tp = params_from_numpy(params, device="cpu")
    leaves = [(p, t.requires_grad_()) for p, t in tree_leaves_with_path(tp)]
    out = tcait.apply(tp, t_(x), TCFG)
    grads = torch.autograd.grad((out.logits * t_(w)).sum(),
                                [t for _, t in leaves])
    for (path, _), g in zip(leaves, grads):
        ref, got = np_(leaf_at(jg, path)), np_(g)
        got, ref = _split_noise(path, got, ref, NOISE_GRAD)
        if got is None:
            continue
        assert np.any(ref), path
        assert rel_fro(got, ref) <= TOL, path


# ---------------------------------------------------------------------------
# the baseline fine-tune
# ---------------------------------------------------------------------------

THP_FIELDS = dict(learning_rate=LR, warmup_steps=2, t_total=20, mixup=0.8,
                  cutmix=1.0, smoothing=0.1, num_classes=10,
                  distillation_type="none")


def _jax_mixup(key, jthp):
    """The mixup draw of one JAX baseline step (``split(key, 3)[0]``)."""
    k_mix, _, _ = jax.random.split(key, 3)
    lam, blend, box = jmixup._sample_one(
        k_mix, 32, 32, jthp.mixup, jthp.cutmix, jthp.mixup_prob,
        jthp.mixup_switch_prob, jthp.cutmix_minmax)
    return MixupDraw(t_(lam), torch.tensor(bool(blend)),
                     torch.from_numpy(np.array(box)))


def test_masked_baseline_trajectory_matches_jax():
    """3 baseline steps under a half-density magnitude mask with mixup /
    cutmix and drop-path 0.1 (which CaiT ignores in both packages: the
    port's step gets no keep decisions): metrics and every leaf after each
    step, and AdamW's moments exactly zero at every masked coordinate."""
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP_FIELDS)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP_FIELDS)
    params = jax_params(4)
    jm = jpruning.global_threshold_mask(jpruning.magnitude_scores(params),
                                        0.5)
    tm = wmasks_from_numpy(jax.tree.map(
        lambda a: None if a is None else np.asarray(a), jm), device="cpu")
    jstep = jfinetune.build_baseline_step(JCFG, jthp, donate=False,
                                          drop_path_rate=0.1)
    tstep = tfinetune.build_baseline_step(TCFG, tthp, drop_path_rate=0.1)
    jst = jfinetune.create_baseline_state(params, jthp)
    tst = tfinetune.create_baseline_state(
        params_from_numpy(params, device="cpu"), tthp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    for i in range(3):
        key = jax.random.PRNGKey(60 + i)
        jst, jmet = jstep(jst, None, jm, jnp.asarray(x), jnp.asarray(labels),
                          key, jnp.float32(-1.0))
        noise = tfinetune.BaselineNoise(mixup=_jax_mixup(key, jthp),
                                        erasing=None, token=None,
                                        drop_path=None)
        tst, tmet = tstep(tst, None, tm, t_(x),
                          torch.from_numpy(labels).long(), noise, -1.0)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(np_(tmet[k]), np_(jmet[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)
        for path, leaf in tree_leaves_with_path(tst.params):
            ref, got = np.asarray(leaf_at(jst.params, path)), np_(leaf)
            got, ref = _split_noise(path, got, ref, LR * (i + 1))
            if got is not None:
                assert rel_fro(got, ref) <= TRAJ_TOL, path
    masked = 0
    for path, m in tree_leaves_with_path(tm):
        off = m == 0
        masked += int(off.sum())
        for moments in (tst.opt_state.mu, tst.opt_state.nu):
            assert not torch.any(leaf_at(moments, path)[off]), path
    assert masked > 0


def test_baseline_eval_step_matches_jax():
    params = jax_params(5)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, num_classes=10)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, num_classes=10)
    jm = jpruning.global_threshold_mask(jpruning.magnitude_scores(params),
                                        0.5)
    x = images(8, 5)
    labels = np.random.default_rng(8).integers(0, 10, 5).astype(np.int32)
    labels[-1] = -1                         # a padding row
    ref = jfinetune.build_baseline_eval_step(JCFG, jthp)(
        params, jm, jnp.asarray(x), jnp.asarray(labels))
    out = tfinetune.build_baseline_eval_step(TCFG, tthp)(
        params_from_numpy(params, device="cpu"),
        wmasks_from_numpy(jax.tree.map(
            lambda a: None if a is None else np.asarray(a), jm),
            device="cpu"), t_(x), torch.from_numpy(labels).long())
    assert int(out["correct"]) == int(ref["correct"])
    assert int(out["count"]) == int(ref["count"]) == 4
    np.testing.assert_allclose(float(out["loss_sum"]), float(ref["loss_sum"]),
                               rtol=TOL)


def test_stage1_refuses_cait():
    """No block gating, token scorer or structural masks: the stage-1 step
    refuses CaiT where it is built (JAX's step cannot run it either)."""
    with pytest.raises(ValueError, match="no block gating"):
        build_stage1_step(TCFG, tresource.build_macs_table(TCFG), THParams(),
                          tstate.TrainHParams(), warmup=False)


def test_generate_mask_mag_and_baseline_train_cli(tmp_path, monkeypatch,
                                                  capsys):
    """``generate_mask --type mag`` on CaiT (the registry's entry cut to
    this test's size in both packages) writes JAX's masks bit for bit;
    ``baseline_train`` fine-tunes under them with drop-path 0.1."""
    monkeypatch.setitem(jconfigs.CONFIGS, "cait_S24_224",
                        JCFG.replace(num_classes=1000))
    monkeypatch.setitem(tconfigs.CONFIGS, "cait_S24_224",
                        TCFG.replace(num_classes=1000))
    shapes = jax.eval_shape(
        lambda k: jcait.init_params(k, JCFG.replace(num_classes=1000)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    j_save(str(tmp_path / "w.ckpt"), {"params": jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)})
    argv = ["--model_type", "cait_S24_224", "--input_size", "32", "--type",
            "mag", "--sparsity", "0.5", "--pretrained",
            str(tmp_path / "w.ckpt")]
    j_gen.main(argv + ["--save_file", str(tmp_path / "jax.ckpt")])
    t_gen.main(argv + ["--save_file", str(tmp_path / "port.ckpt"),
                       "--device", "cpu"])
    jm, tm = j_load(str(tmp_path / "jax.ckpt")), load_checkpoint(
        str(tmp_path / "port.ckpt"))
    assert sorted(tm) == sorted(jm) and "blocks.qkv.kernel" in tm
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    assert "remain weight = 50.00" in capsys.readouterr().out

    t_base.main(["--model_type", "cait_S24_224", "--dataset", "synthetic",
                 "--img_size", "32", "--train_batch_size", "4",
                 "--eval_batch_size", "4", "--synthetic_steps", "2",
                 "--epochs", "1", "--drop-path", "0.1", "--init_mask",
                 str(tmp_path / "port.ckpt"), "--device", "cpu",
                 "--output_dir", str(tmp_path), "--name", "base"])
    ck = load_checkpoint(str(tmp_path / "base" /
                             "cait_S24_224_baseline_0.ckpt"))
    assert int(ck["step"]) == 2
