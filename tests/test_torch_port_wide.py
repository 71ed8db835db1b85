"""The port at the registry's widest model and its smallest head dim,
against the JAX package on the CPU: ViT-H/14 (dm 1280, 16 heads of 80,
F 5120), whose backward takes the fused backwards A2 and A4 (the
LayerNorm backward holds 1280 columns; the JAX package composes there for
its VMEM budget alone, and the port's composed routes stay held at this
width by ``test_torch_port_bwd_ctx.py``), and ``t2t_vit_14_resnext`` (32
heads of 12).

* A ViT-H/14 cut to depth 2 and 28-pixel images (patch 14: 4 patch
  tokens) and the resnext T2T-ViT cut to depth 2 and 32 pixels, each
  through 3 stage-1 steps against ``uvc_tpu/train/step.py::
  build_stage1_step`` in f32 with JAX's own draws fed in (Gumbel block
  gating, Gumbel token top-k, the gating step): metrics and the minimax
  state to 1e-5, every weight leaf to 1e-4 relative Frobenius, with two
  exceptions held to the learning rate times the steps: the key bias (see
  ``test_torch_port_train.py``) and the token scorer's bias.  Both shift
  every score of a softmax alike (the keys' logits; the tokens' scores,
  which enter the token draw through ``log_softmax``), so their gradients
  are zero in exact arithmetic and rounding noise in f32, which AdamW
  divides by its own magnitude.  The two packages' biases thus part by up
  to the learning rate per step, and the global gradient norm after them
  feels it: at ViT-H's widths it is held to 1e-4 (measured 1.3e-5 at step
  3 through the composed route and 1.6e-5 through the fused backward's
  plain version, the route the step takes since the LayerNorm backward
  holds 1280 columns).
* The sublayer kernels' plain versions (K1 / A2 / A7) at head dims 12 and
  80 against the Pallas kernels in interpret mode in bf16: 2e-2 relative
  Frobenius per output, as in ``test_torch_port_grads.py``.
* ViT-H/14's parameter tree at its full size on the meta device (no
  allocation) against ``jax.eval_shape`` of the JAX init.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import minimax as jminimax
from uvc_tpu.compress import resource as jresource
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.models import get_model as j_get_model
from uvc_tpu.ops import attention as jattn
from uvc_tpu.train import state as jstate
from uvc_tpu.train.step import build_stage1_step as j_build_stage1_step
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.compress import resource as tresource
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.interop import cstate_from_numpy, params_from_numpy
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.ops import attention as tatt
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import Stage1Noise, build_stage1_step
from uvc_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4
BF16_TOL = 2e-2
EPS = 1e-6
# (config, the cut): ViT-H/14 at patch 14 keeps 4 patch tokens at 28 px
MODELS = {"vit_h": ("ViT-H_14", dict(img_size=28, depth=2, num_classes=10)),
          "resnext": ("t2t_vit_14_resnext",
                      dict(img_size=32, depth=2, num_classes=10))}
HP_FIELDS = dict(
    budget=0.5, slr=0.05, rlr=0.05, glr=0.05, ylr=0.02, plr=0.02,
    zlr_schedule=(2.0,), sl2wd=1e-3, z_grad_clip=0.5, gating_weight=0.5,
    gating_interval=2, soptim="sgd", roptim="sgd", flops_with_mhsa=True,
    use_gumbel=True, eps=0.05, enable_block_gating=True,
    enable_part_gating=False, enable_patch_gating=2, patch_ratio=0.75,
    enable_pruning=True)
THP_FIELDS = dict(learning_rate=1e-2, warmup_steps=2, t_total=20,
                  mixup=0.0, cutmix=0.0, num_classes=10)


def cfgs(model):
    name, cut = MODELS[model]
    return (jconfigs.get_config(name).replace(**cut),
            tconfigs.get_config(name).replace(**cut))


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


def leaf_of(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def jax_params(seed, cfg):
    params = j_get_model(cfg).init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    return params


def _jax_stage1_noise(key, cfg, batch):
    k_mix, k_gate, k_part1, k_part2, k_tok, k_arch = jax.random.split(key, 6)
    k_res1, k_res2, _ = jax.random.split(k_arch, 3)

    def g(k, shape):
        return t_(jax.random.gumbel(k, shape, jnp.float32))

    l2 = (cfg.depth, 2)
    return Stage1Noise(mixup=None, gate=g(k_gate, l2),
                       token=g(k_tok, (batch, cfg.num_patches)),
                       res1=g(k_res1, l2), res2=g(k_res2, l2),
                       part_attn=g(k_part1, l2), part_mlp=g(k_part2, l2))


def _compare(tst, jst, cfg, lr):
    for f in ("s", "r", "y", "p", "z", "gating_accum"):
        np.testing.assert_allclose(np_(getattr(tst.cstate, f)),
                                   np_(getattr(jst.cstate, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    d = cfg.embed_dim
    for path, leaf in tree_leaves_with_path(tst.params):
        ref = np.asarray(leaf_of(jst.params, path))
        leaf = np_(leaf)
        # the key bias and the token scorer's bias: zero gradients up to
        # rounding (see the top)
        if path == ("blocks", "qkv", "bias"):
            np.testing.assert_allclose(leaf[:, d:2 * d], ref[:, d:2 * d],
                                       atol=lr * max(1, tst.step), rtol=0)
            leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                         for a in (leaf, ref))
        if path == ("token_scorer", "bias"):
            np.testing.assert_allclose(leaf, ref, atol=lr * max(1, tst.step),
                                       rtol=0)
            continue
        if np.any(ref):
            assert rel_fro(leaf, ref) <= TRAJ_TOL, path
        else:
            np.testing.assert_allclose(leaf, ref, atol=TRAJ_TOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_stage1_trajectory_matches_jax_three_steps(model):
    """3 stage-1 steps with JAX's draws: metrics, minimax state and every
    weight leaf after each step.  ViT-H/14's student backward takes the
    fused backwards' plain versions (A2, A4) at every block, no composed
    route: dm 1280 is within the LayerNorm backward's width."""
    jcfg, tcfg = cfgs(model)
    jhp, thp_ = JHParams(**HP_FIELDS), THParams(**HP_FIELDS)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP_FIELDS)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP_FIELDS)
    params, teacher = jax_params(5, jcfg), jax_params(105, jcfg)
    cstate = jminimax.init_compression_state(jcfg, jhp)
    jst = jstate.create_train_state(params, jthp, cstate)
    tst = tstate.create_train_state(
        params_from_numpy(np_tree(params), device="cpu"), tthp,
        cstate_from_numpy(np_tree(cstate), device="cpu"))
    tteacher = params_from_numpy(np_tree(teacher), device="cpu")
    jstep = j_build_stage1_step(jcfg, jresource.build_macs_table(jcfg), jhp,
                                jthp, warmup=False, donate=False)
    tstep = build_stage1_step(tcfg, tresource.build_macs_table(tcfg), thp_,
                              tthp, warmup=False)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, tcfg.img_size, tcfg.img_size, 3)).astype(
        np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    assert tcfg.embed_dim <= tatt._MAX_DM_BWD
    for i in range(3):
        key = jax.random.PRNGKey(80 + i)
        jst, jm = jstep(jst, teacher, jnp.asarray(x), jnp.asarray(labels),
                        key, jnp.float32(5.0))
        tops.reset_launch_counts()
        tst, tm = tstep(tst, tteacher, t_(x), torch.from_numpy(labels).long(),
                        _jax_stage1_noise(key, jcfg, 4), 5.0)
        assert tops.composed_counts() == {
            "layer_attention_ln_bwd_composed": 0, "mlp_ln_bwd_composed": 0,
            "mlp_ln_blend_bwd_composed": 0}
        for k in ("loss", "grad_norm", "lr", "resource", "z"):
            tol = TRAJ_TOL if k == "grad_norm" else TOL
            np.testing.assert_allclose(np_(tm[k]), np_(jm[k]), rtol=tol,
                                       atol=TOL, err_msg=k)
        _compare(tst, jst, jcfg, THP_FIELDS["learning_rate"])


# ---------------------------------------------------------------------------
# K1 / A2 / A7 plain versions at head dims 12 and 80
# ---------------------------------------------------------------------------

# (batch, tokens, model width, heads, head dim): dh 12 square and compact
# (da < dm), dh 80 square
SUBLAYER_CASES = [(2, 13, 48, 4, 12), (2, 11, 48, 2, 12), (1, 17, 160, 2, 80)]


def sublayer_inputs(seed, b, n, dm, da):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(da) > 0.3).astype(f32)
    mask[0] = 0.0
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        g1=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b1=(0.1 * rng.standard_normal(dm)).astype(f32),
        wqkv=(rng.standard_normal((dm, 3 * da)) / np.sqrt(dm)).astype(f32),
        bqkv=(0.1 * rng.standard_normal(3 * da)).astype(f32),
        wproj=(rng.standard_normal((da, dm)) / np.sqrt(da)).astype(f32),
        bproj=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=mask, do=(0.5 * rng.standard_normal((b, n, dm))).astype(f32))


LN_ORDER = ("x", "g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "mask")
BARE_ORDER = ("x", "wqkv", "bqkv", "wproj", "bproj", "mask")


def _args(inp, order):
    """(torch bf16 tensors, JAX bf16 arrays) of ``order``, LN parameters
    in f32."""
    f32 = ("g1", "b1")
    ts = [torch.from_numpy(inp[k]).to(torch.float32 if k in f32
                                      else torch.bfloat16) for k in order]
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.float32 if k in f32 else jnp.bfloat16) for k, t in zip(order, ts)]
    return ts, js


def _close(got, ref, names):
    for name, g, r in zip(names, got, ref):
        assert tuple(g.shape) == tuple(np.shape(r)), name
        err = rel_fro(np_(g), np_(r))
        assert err <= BF16_TOL, f"{name}: relative Frobenius {err:.2e}"


@pytest.mark.parametrize("b,n,dm,heads,dh", SUBLAYER_CASES)
def test_ln_sublayer_plain_matches_pallas_bf16(b, n, dm, heads, dh):
    """K1 and A2 at head dims 12 and 80: the plain forward and backward
    against ``fused_layer_attention_ln(..., interpret=True)`` and its
    ``jax.vjp`` (``_layer_ln_bwd_kernel``)."""
    inp = sublayer_inputs(30 + dh, b, n, dm, heads * dh)
    kw = dict(num_heads=heads, scale=dh ** -0.5, eps=EPS)
    ts, js = _args(inp, LN_ORDER)
    do = torch.from_numpy(inp["do"]).to(torch.bfloat16)
    out, vjp = jax.vjp(lambda *a: jattn.fused_layer_attention_ln(
        *a, interpret=True, **kw), *js)
    _close([tatt.layer_attention_ln_plain(*ts, **kw)], [out], ["out"])
    ref = vjp(jnp.asarray(do.float().numpy()).astype(jnp.bfloat16))
    _close(tatt.layer_attention_ln_bwd_plain(*ts, do, **kw), ref, LN_ORDER)


@pytest.mark.parametrize("b,n,dm,heads,dh", SUBLAYER_CASES)
def test_bare_sublayer_plain_matches_pallas_bf16(b, n, dm, heads, dh):
    """A7 at head dims 12 and 80: the plain forward and backward against
    ``fused_layer_attention(..., interpret=True)`` and its ``jax.vjp``
    (``_layer_bwd_kernel``)."""
    inp = sublayer_inputs(40 + dh, b, n, dm, heads * dh)
    kw = dict(num_heads=heads, scale=dh ** -0.5)
    ts, js = _args(inp, BARE_ORDER)
    do = torch.from_numpy(inp["do"]).to(torch.bfloat16)
    out, vjp = jax.vjp(lambda *a: jattn.fused_layer_attention(
        *a, interpret=True, **kw), *js)
    _close([tatt.layer_attention_plain(*ts, **kw)], [out], ["out"])
    ref = vjp(jnp.asarray(do.float().numpy()).astype(jnp.bfloat16))
    _close(tatt.layer_attention_bwd_plain(*ts, do, **kw), ref, BARE_ORDER)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("heads,dh,ok", [
    (32, 12, True), (16, 80, True), (6, 64, True), (4, 2, True),
    (8, 41, False), (4, 96, False), (3, 30, False)])
def test_sublayer_checks_take_even_head_dims_up_to_80(heads, dh, ok):
    """The kernels take the head dim from wqkv's width: even head dims up to
    80 whose attention width is a multiple of 8 (the GEMM's 16-byte
    rows)."""
    da = heads * dh
    dm = 64
    x = _meta(2, 13, dm)
    named = dict(x=x, g1=_meta(dm, dtype=torch.float32),
                 b1=_meta(dm, dtype=torch.float32), wqkv=_meta(dm, 3 * da),
                 bqkv=_meta(3 * da), wproj=_meta(da, dm), bproj=_meta(dm),
                 mask=_meta(da))
    if ok:
        assert tatt._check_attention(x, named, heads) == (2, 13, dm, da)
    else:
        with pytest.raises(ValueError, match="attention width"):
            tatt._check_attention(x, named, heads)


def test_vit_h_parameter_tree_matches_jax_at_full_size_on_meta():
    """ViT-H/14 at its published size (32 blocks, dm 1280, F 5120, 224 px,
    patch 14): the port's ``init_params`` on the meta device (shapes, no
    memory) against ``jax.eval_shape`` of the JAX init, leaf for leaf:
    632,047,273 parameters."""
    tcfg = tconfigs.get_config("ViT-H_14")
    jcfg = jconfigs.get_config("ViT-H_14")
    with torch.device("meta"):
        tp = tvit.init_params(torch.Generator(), tcfg, device="meta")
    jp = jax.eval_shape(lambda k: j_get_model(jcfg).init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    for path, leaf in tree_leaves_with_path(tp):
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == leaf_of(jp, path).shape, path
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert n == 632047273
    assert (tcfg.num_heads, tcfg.head_size, tcfg.mlp_hidden,
            tcfg.seq_len) == (16, 80, 5120, 257)
