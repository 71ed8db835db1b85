"""The port's checkpoint converters (uvc_tpu_torch/models/convert.py)
against the JAX package's (uvc_tpu/models/convert.py), on the CPU.

Every state dict, ``.pth`` and ``.npz`` is built in the test from seeded
draws.  The converted trees agree leaf for leaf: bit for bit where the
conversion only moves values (transposes, stacks, the fresh head's numpy
draws), and within 1e-5 where a position embedding is resized (JAX's
``jax.image.resize`` against ``F.interpolate(..., antialias=True)``).
The converted weights then give JAX's logits through the port's forward
(f32, 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.models import convert as jconvert
from uvc_tpu.models import t2t_vit as jt2t
from uvc_tpu.models import vit as jvit
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.models import convert as tconvert
from uvc_tpu_torch.models import t2t_vit as tt2t
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

RESIZE_TOL = 1e-5
KW = dict(name="convert", img_size=32, patch_size=8, embed_dim=16, depth=2,
          num_heads=2, num_classes=10)


def cfgs(**kw):
    args = dict(KW, **kw)
    return jconfigs.ViTConfig(**args), tconfigs.ViTConfig(**args)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def state_dict(cfg, seed=0):
    """A timm-layout state dict of seeded random weights (JAX's inverse
    converter on JAX-drawn params, every leaf redrawn)."""
    params = np_tree(jvit.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    return jconvert.to_torch_state_dict(params, cfg)


def assert_trees_equal(tparams, jparams, tol=0.0, resized=()):
    tpaths = {p for p, _ in tree_leaves_with_path(tparams)}
    jpaths = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
              for p, _ in jax.tree_util.tree_leaves_with_path(jparams)}
    assert tpaths == jpaths
    for path, leaf in tree_leaves_with_path(tparams):
        ref = np.asarray(leaf_at(jparams, path), np.float32)
        # contiguous: the card's kernels refuse strided operands
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
        assert leaf.is_contiguous(), path
        assert tuple(leaf.shape) == ref.shape, path
        if ".".join(path) in resized:
            np.testing.assert_allclose(leaf.numpy(), ref, rtol=0,
                                       atol=tol, err_msg=str(path))
        else:
            np.testing.assert_array_equal(leaf.numpy(), ref,
                                          err_msg=str(path))


def test_fresh_head_is_jax_draws():
    for seed in (0, 1):
        t = tconvert._fresh_head(16, 37, seed=seed)
        j = jconvert._fresh_head(16, 37, seed=seed)
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(t[k], j[k])
    assert np.abs(t["kernel"]).max() <= 0.04


@pytest.mark.parametrize("case", ["same", "class_mismatch", "no_head",
                                  "module_prefix", "stage1_leaves"])
def test_from_torch_state_dict_matches_jax(case):
    jcfg, tcfg = cfgs()
    sd = state_dict(jcfg, seed=1)
    if case == "class_mismatch":
        jcfg, tcfg = cfgs(num_classes=7)      # the 10-class head re-inits
    elif case == "no_head":
        sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
    elif case == "module_prefix":
        sd = {f"module.{k}": v for k, v in sd.items()}
    elif case == "stage1_leaves":
        sd["patch_gating"] = np.full((1, jcfg.num_patches, 1), 2.5,
                                     np.float32)
    else:
        # the UVC leaves of a plain DeiT checkpoint are synthesised
        for k in ("block_skip_gating", "gumbel.weight", "gumbel.bias"):
            del sd[k]
    ref = jconvert.from_torch_state_dict(sd, jcfg)
    # the same state dict as torch tensors
    out = tconvert.from_torch_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tcfg)
    assert_trees_equal(out, ref)
    if case in ("class_mismatch", "no_head"):
        assert out["head"]["kernel"].any()


@pytest.mark.parametrize("img,distilled_src,distilled_dst", [
    (64, False, False), (16, False, False), (48, True, False),
    (64, True, True), (16, True, True)])
def test_pos_embed_resize_and_prefixes_match_jax(img, distilled_src,
                                                 distilled_dst):
    """Transfer to another image size (the grid resized up or down) and
    between distilled and plain prefixes (2 / 1 token rows)."""
    jsrc, _ = cfgs(distilled=distilled_src)
    sd = state_dict(jsrc, seed=2)
    jcfg, tcfg = cfgs(img_size=img, distilled=distilled_dst)
    ref = jconvert.from_torch_state_dict(sd, jcfg)
    out = tconvert.from_torch_state_dict(sd, tcfg)
    assert out["pos_embed"].shape == (1, tcfg.seq_len, tcfg.embed_dim)
    resized = ("pos_embed",) if tcfg.seq_len != jsrc.seq_len else ()
    assert_trees_equal(out, ref, RESIZE_TOL, resized)
    # the class row carried over unscaled
    np.testing.assert_array_equal(out["pos_embed"][0, 0].numpy(),
                                  sd["pos_embed"][0, 0])


@pytest.mark.parametrize("old,new,prefix", [(14, 16, 1), (14, 12, 1),
                                            (4, 7, 2), (9, 3, 1)])
def test_resize_pos_embed_matches_jax(old, new, prefix):
    rng = np.random.default_rng(old * new)
    pos = rng.standard_normal((1, prefix + old * old, 8)).astype(np.float32)
    for new_prefix in (1, 2):
        ref = jconvert.resize_pos_embed(pos, new_prefix + new * new,
                                        new_prefix, prefix)
        out = tconvert.resize_pos_embed(pos, new_prefix + new * new,
                                        new_prefix, prefix)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=RESIZE_TOL)
    with pytest.raises(ValueError, match="not square"):
        tconvert.resize_pos_embed(pos, 1 + 10, 1, prefix)


@pytest.mark.parametrize("distilled", [False, True])
def test_to_torch_state_dict_round_trip(distilled):
    jcfg, tcfg = cfgs(distilled=distilled)
    params = jvit.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        params)
    from uvc_tpu_torch.interop import params_from_numpy
    tp = params_from_numpy(np_tree(params), device="cpu")
    ref = jconvert.to_torch_state_dict(np_tree(params), jcfg)
    out = tconvert.to_torch_state_dict(tp, tcfg)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == torch.float32 and out[k].is_contiguous()
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    back = tconvert.from_torch_state_dict(out, tcfg)
    for path, leaf in tree_leaves_with_path(back):
        if path[0] in ("attn_gating", "mlp_gating"):
            continue                    # not in a state dict: the init's
        assert torch.equal(leaf, leaf_at(tp, path)), path


@pytest.mark.parametrize("wrapper", [None, "model", "state_dict_ema",
                                     "state_dict"])
def test_load_torch_checkpoint_matches_jax(tmp_path, wrapper):
    jcfg, tcfg = cfgs(num_classes=7)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in state_dict(jcfg, seed=4).items()}
    obj = sd if wrapper is None else {wrapper: sd, "epoch": 3}
    path = str(tmp_path / "w.pth")
    torch.save(obj, path)
    ref = jconvert.load_torch_checkpoint(path, jcfg)
    out = tconvert.load_torch_checkpoint(path, tcfg)
    assert_trees_equal(out, ref)
    # the converted weights serve JAX's logits through the port's forward
    x = np.random.default_rng(5).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    jl = jvit.apply(ref, jnp.asarray(x), jcfg, train=False).logits
    tl = tvit.apply(out, torch.from_numpy(x), tcfg, train=False,
                    dtype=torch.float32).logits
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def fake_npz(path, cfg, grid_old, num_classes, hybrid=False):
    """An upstream-layout ViT ``.npz`` of seeded random weights."""
    d, f, h, dh, p = (cfg.embed_dim, cfg.mlp_hidden, cfg.num_heads,
                      cfg.head_size, cfg.patch_size)
    rng = np.random.default_rng(6)

    def rn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    w = {"embedding/kernel": (rn(1, 1, 1024, d) if hybrid
                              else rn(p, p, 3, d)),
         "embedding/bias": rn(d),
         "cls": rn(1, 1, d),
         "Transformer/posembed_input/pos_embedding":
             rn(1, grid_old * grid_old + 1, d),
         "Transformer/encoder_norm/scale": 1 + 0.1 * rn(d),
         "Transformer/encoder_norm/bias": rn(d),
         "head/kernel": rn(d, num_classes), "head/bias": rn(num_classes)}
    at = "MultiHeadDotProductAttention_1"
    for i in range(cfg.depth):
        pre = f"Transformer/encoderblock_{i}"
        for nm in ("query", "key", "value"):
            w[f"{pre}/{at}/{nm}/kernel"] = rn(d, h, dh)
            w[f"{pre}/{at}/{nm}/bias"] = rn(h, dh)
        w[f"{pre}/{at}/out/kernel"] = rn(h, dh, d)
        w[f"{pre}/{at}/out/bias"] = rn(d)
        w[f"{pre}/MlpBlock_3/Dense_0/kernel"] = rn(d, f)
        w[f"{pre}/MlpBlock_3/Dense_0/bias"] = rn(f)
        w[f"{pre}/MlpBlock_3/Dense_1/kernel"] = rn(f, d)
        w[f"{pre}/MlpBlock_3/Dense_1/bias"] = rn(d)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            w[f"{pre}/{ln}/scale"] = 1 + 0.1 * rn(d)
            w[f"{pre}/{ln}/bias"] = rn(d)
    if hybrid:
        # the ResNetV2 stem at width 1: HWIO kernels, unit-wise GroupNorms,
        # the projection in each stage's first unit
        w["conv_root/kernel"] = rn(7, 7, 3, 64)
        w["gn_root/scale"], w["gn_root/bias"] = 1 + 0.1 * rn(64), rn(64)
        cin = 64
        for bi, n_units in enumerate(cfg.resnet_layers):
            cmid, cout = 64 * 2 ** bi, 256 * 2 ** bi
            for u in range(n_units):
                pre = f"block{bi + 1}/unit{u + 1}"
                for j, (ci, co, k) in enumerate(
                        ((cin, cmid, 1), (cmid, cmid, 3), (cmid, cout, 1))):
                    w[f"{pre}/conv{j + 1}/kernel"] = rn(k, k, ci, co)
                    w[f"{pre}/gn{j + 1}/scale"] = 1 + 0.1 * rn(co)
                    w[f"{pre}/gn{j + 1}/bias"] = rn(co)
                if u == 0:
                    w[f"{pre}/conv_proj/kernel"] = rn(1, 1, cin, cout)
                    w[f"{pre}/gn_proj/scale"] = 1 + 0.1 * rn(cout)
                    w[f"{pre}/gn_proj/bias"] = rn(cout)
                cin = cout
    np.savez(path, **w)
    return path


@pytest.mark.parametrize("grid_old,num_classes", [(4, 10), (2, 10),
                                                  (7, 10), (4, 5)])
def test_load_npz_checkpoint_matches_jax(tmp_path, grid_old, num_classes):
    """The upstream ``.npz``: q / k / v fused, the blocks stacked, the
    grid resized bilinearly (4 x 4 is the config's own), another class
    count's head zeroed."""
    jcfg, tcfg = cfgs()
    path = fake_npz(str(tmp_path / "vit.npz"), jcfg, grid_old, num_classes)
    ref = jconvert.load_npz_checkpoint(path, jcfg)
    out = tconvert.load_npz_checkpoint(path, tcfg)
    resized = ("pos_embed",) if grid_old != 4 else ()
    assert_trees_equal(out, ref, RESIZE_TOL, resized)
    if num_classes != jcfg.num_classes:
        assert not out["head"]["kernel"].any()


def test_load_npz_hybrid_raises(tmp_path):
    """The R50+ViT ``.npz``: the stem's units read as JAX's converter reads
    them (the stages as lists), the weights serving JAX's logits through
    the port's forward; a file that lacks a unit of the config's stem
    raises."""
    jcfg, tcfg = cfgs(hybrid=True, resnet_layers=(1, 1, 1), img_size=64)
    path = fake_npz(str(tmp_path / "r50.npz"), jcfg, 4, 10, hybrid=True)
    ref = jconvert.load_npz_checkpoint(path, jcfg)
    out = tconvert.load_npz_checkpoint(path, tcfg)
    assert isinstance(out["resnet"]["block1"], list)
    assert_trees_equal(out, ref)
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jl = jax.jit(lambda p, xb: jvit.apply(p, xb, jcfg).logits)(
        ref, jnp.asarray(x))
    tl = tvit.apply(out, torch.from_numpy(x), tcfg,
                    dtype=torch.float32).logits
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    deeper = tcfg.replace(resnet_layers=(1, 2, 1))
    with pytest.raises(KeyError, match="block2/unit2"):
        tconvert.load_npz_checkpoint(path, deeper)


def t2t_state_dict(cfg, num_classes):
    """An upstream T2T-ViT state dict (token performer stages) of seeded
    random weights."""
    rng = np.random.default_rng(7)
    d, td, f = cfg.embed_dim, cfg.token_dim, cfg.mlp_hidden
    sd = {}

    def lin(name, fi, fo, bias=True):
        sd[name + ".weight"] = (0.2 * rng.standard_normal((fo, fi))).astype(
            np.float32)
        if bias:
            sd[name + ".bias"] = (0.1 * rng.standard_normal(fo)).astype(
                np.float32)

    def ln(name, n):
        sd[name + ".weight"] = (1 + 0.1 * rng.standard_normal(n)).astype(
            np.float32)
        sd[name + ".bias"] = (0.1 * rng.standard_normal(n)).astype(
            np.float32)

    for stage, dim in (("attention1", 3 * 7 * 7), ("attention2", td * 9)):
        pre = f"tokens_to_token.{stage}"
        lin(pre + ".kqv", dim, 3 * td)
        lin(pre + ".proj", td, td)
        ln(pre + ".norm1", dim)
        ln(pre + ".norm2", td)
        lin(pre + ".mlp.0", td, td)
        lin(pre + ".mlp.2", td, td)
        sd[pre + ".w"] = rng.standard_normal((td // 2, td)).astype(np.float32)
    lin("tokens_to_token.project", td * 9, d)
    sd["cls_token"] = rng.standard_normal((1, 1, d)).astype(np.float32)
    for i in range(cfg.depth):
        ln(f"blocks.{i}.norm1", d)
        lin(f"blocks.{i}.attn.qkv", d, 3 * d, bias=False)
        lin(f"blocks.{i}.attn.proj", d, d)
        ln(f"blocks.{i}.norm2", d)
        lin(f"blocks.{i}.mlp.fc1", d, f)
        lin(f"blocks.{i}.mlp.fc2", f, d)
    ln("norm", d)
    lin("head", d, num_classes)
    return sd


@pytest.mark.parametrize("num_classes", [5, 9])
def test_t2t_converter_matches_jax(tmp_path, num_classes):
    kw = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, token_dim=16,
              num_classes=5)
    jcfg = jconfigs.get_config("t2t_vit_7").replace(**kw)
    tcfg = tconfigs.get_config("t2t_vit_7").replace(**kw)
    sd = t2t_state_dict(jcfg, num_classes)
    path = str(tmp_path / "t2t.pth.tar")
    torch.save({"state_dict_ema": {f"module.{k}": torch.from_numpy(v)
                                   for k, v in sd.items()}}, path)
    ref = jconvert.from_t2t_state_dict(sd, jcfg)
    out = tconvert.load_torch_checkpoint(path, tcfg)   # detects T2T keys
    assert_trees_equal(out, ref)
    x = np.random.default_rng(8).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jl = jt2t.apply(ref, jnp.asarray(x), jcfg, train=False).logits
    tl = tt2t.apply(out, torch.from_numpy(x), tcfg, train=False,
                    dtype=torch.float32).logits
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
