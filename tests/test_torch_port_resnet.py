"""The port's ResNetV2 stem (uvc_tpu_torch/models/resnet.py) against the
JAX package's (uvc_tpu/models/resnet.py) on the CPU.

The weights are drawn with numpy in JAX's layout (the shapes of
``init_resnet_stem`` through ``jax.eval_shape``, He-normal kernels, GroupNorm
scales near 1) and carried across with ``params_from_numpy``; the images
come from numpy seeds.  Tolerance: 1e-4 relative Frobenius in f32, for
every function up to the full (3, 4, 9) stem at 224 px, whose 55 x 55 map
after the max-pool is where a padding error would show.  In bf16 the small
(1, 1, 1) stem is held to 2e-2 against JAX's bf16; the full stem is not,
as its sixteen units at random weights move by a third between bf16 and
f32 in either package (bf16 roundings through the residual stream).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.models import resnet as jr
from uvc_tpu_torch.interop import params_from_numpy
from uvc_tpu_torch.models import resnet as tr
from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

TOL = 1e-4
BF16_TOL = 2e-2


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def images(seed, b, size):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def stem_weights(units, seed=0):
    """A stem tree of JAX's layout with numpy draws: He-normal HWIO
    kernels, GroupNorm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    shapes = jax.eval_shape(lambda k: jr.init_resnet_stem(k, units, 1),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(s.shape) == 4:
            fan = s.shape[0] * s.shape[1] * s.shape[2]
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def both(tree):
    return tree, params_from_numpy(tree, device="cpu")


def kernel(rng, k, cin, cout):
    return (rng.standard_normal((k, k, cin, cout))
            * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)


@pytest.mark.parametrize("k,stride,cin,cout,size", [
    (1, 1, 64, 256, 16), (3, 1, 32, 32, 15), (3, 2, 32, 32, 15),
    (7, 2, 3, 64, 30)], ids=["1x1", "3x3s1", "3x3s2", "root7x7s2"])
def test_std_conv_matches(k, stride, cin, cout, size):
    """Weight standardisation (population variance, eps 1e-5) and the
    symmetric (k-1)//2 padding, at odd and even sizes."""
    rng = np.random.default_rng(k + stride)
    w = 0.3 + kernel(rng, k, cin, cout)          # a nonzero mean per kernel
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    ref = jr.std_conv(jnp.asarray(x), jnp.asarray(w), stride)
    out = tr.std_conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(out.shape) == ref.shape
    assert rel_fro(np_(out), np_(ref)) <= TOL


@pytest.mark.parametrize("c,groups", [(64, 32), (256, 256), (48, 32)],
                         ids=["32_groups", "groups_eq_channels",
                              "c_not_multiple"])
def test_group_norm_matches(c, groups):
    rng = np.random.default_rng(c)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 7, c))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jr.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                        groups=groups)
    out = tr.group_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), groups=groups)
    assert rel_fro(np_(out), np_(ref)) <= TOL


@pytest.mark.parametrize("cin,cout,stride", [(256, 256, 1), (64, 256, 1),
                                             (256, 512, 2)],
                         ids=["identity", "proj_width", "proj_stride"])
def test_bottleneck_matches(cin, cout, stride):
    p = jax.tree.map(np.asarray, jr.init_bottleneck(
        jax.random.PRNGKey(cin + stride), cin, cout, cout // 4, stride))
    assert ("conv_proj" in p) == (stride != 1 or cin != cout)
    jp, tp = both(p)
    x = np.random.default_rng(1).standard_normal((2, 9, 9, cin)).astype(
        np.float32)
    ref = jax.jit(jr.apply_bottleneck, static_argnums=2)(
        jp, jnp.asarray(x), stride)
    out = tr.apply_bottleneck(tp, torch.from_numpy(x), stride)
    assert tuple(out.shape) == ref.shape
    assert rel_fro(np_(out), np_(ref)) <= TOL


def test_init_layout_matches():
    """The port's draws have JAX's tree: the stages as lists, the
    projection in each stage's first unit only."""
    ref = jax.eval_shape(lambda k: jr.init_resnet_stem(k, (3, 4, 9), 1),
                         jax.random.PRNGKey(0))
    out = tr.init_resnet_stem(torch.Generator().manual_seed(0), (3, 4, 9), 1)
    for bi, n in enumerate((3, 4, 9)):
        assert isinstance(out[f"block{bi + 1}"], list)
        assert len(out[f"block{bi + 1}"]) == n
        assert ["conv_proj" in u for u in out[f"block{bi + 1}"]] == \
            [True] + [False] * (n - 1)
    paths = [p for p, _ in tree_leaves_with_path(out)]
    jpaths = [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
              for p, _ in jax.tree_util.tree_leaves_with_path(ref)]
    assert sorted(paths) == sorted(jpaths)
    for path in paths:
        assert tuple(leaf_at(out, path).shape) == leaf_at(ref, path).shape


def test_small_stem_matches_f32_and_bf16():
    jp, tp = both(stem_weights((1, 1, 1), seed=1))
    x = images(2, 2, 64)
    jstem = jax.jit(jr.apply_resnet_stem, static_argnums=2)
    ref = jstem(jp, jnp.asarray(x), (1, 1, 1))
    out = tr.apply_resnet_stem(tp, torch.from_numpy(x), (1, 1, 1))
    assert tuple(out.shape) == ref.shape == (2, 4, 4, 1024)
    assert out.is_contiguous()
    assert rel_fro(np_(out), np_(ref)) <= TOL
    # op by op, as the port rounds: under jit XLA's CPU backend keeps some
    # bf16 intermediates in f32
    ref16 = jr.apply_resnet_stem(jp, jnp.asarray(x, jnp.bfloat16), (1, 1, 1))
    out16 = tr.apply_resnet_stem(tp, torch.from_numpy(x).bfloat16(),
                                 (1, 1, 1))
    assert out16.dtype == torch.bfloat16
    assert rel_fro(np_(out16), np_(ref16)) <= BF16_TOL


def test_full_stem_at_224_matches_f32():
    """The (3, 4, 9) stem of R50-ViT-B/16 at 224 px: 112 -> 55 (the
    unpadded max-pool) -> 55 -> 28 -> 14."""
    jp, tp = both(stem_weights((3, 4, 9), seed=2))
    x = images(3, 1, 224)
    ref = jax.jit(jr.apply_resnet_stem, static_argnums=2)(
        jp, jnp.asarray(x), (3, 4, 9))
    out = tr.apply_resnet_stem(tp, torch.from_numpy(x), (3, 4, 9))
    assert tuple(out.shape) == ref.shape == (1, 14, 14, 1024)
    assert rel_fro(np_(out), np_(ref)) <= TOL


def test_stem_gradients_match_jax_grad():
    """Gradients of a weighted sum of the small stem's output with respect
    to the input and every leaf."""
    jp, tp = both(stem_weights((1, 1, 1), seed=4))
    x = images(5, 2, 32)
    w = np.random.default_rng(6).standard_normal((2, 2, 2, 1024)).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jr.apply_resnet_stem(p, xx, (1, 1, 1)) * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [(p, t.requires_grad_()) for p, t in tree_leaves_with_path(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    loss = (tr.apply_resnet_stem(tp, tx, (1, 1, 1))
            * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [tx] + [t for _, t in leaves])
    assert rel_fro(np_(grads[0]), np_(jgx)) <= TOL
    for (path, _), g in zip(leaves, grads[1:]):
        assert rel_fro(np_(g), np_(leaf_at(jg, path))) <= TOL, path
