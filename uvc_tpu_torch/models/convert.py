"""Convert DeiT / ViT / T2T-ViT checkpoints of other frameworks into the
port's parameter trees (counterpart of ``uvc_tpu/models/convert.py``).

A timm / DeiT ``state_dict`` (``.pth``; the reference's checkpoints keep
it under ``model`` or ``state_dict_ema``) maps onto the JAX package's
layout, which the port shares:

  patch_embed.proj.weight [D, C, P, P] -> patch_embed.kernel [P, P, C, D]
  blocks.N.attn.qkv.weight [3D, D]     -> blocks.qkv.kernel [L, D, 3D]
  blocks.N.attn.proj.weight [D, D]     -> blocks.proj.kernel [L, D, D]
  blocks.N.mlp.fc{1,2}.weight          -> blocks.fc{1,2}.kernel

(a torch ``Linear`` weight is ``[out, in]`` and transposes to ``[in,
out]``), the per-block tensors stacked on a leading layer axis and the
UVC leaves (block gating ``[-1, 1]``, the token scorer) filled in where
the checkpoint predates them.  A head whose class count differs from the
config's is re-initialised (truncated normal, std 0.02, from a seeded
numpy generator: the same draws as the JAX package's), and a learned
position embedding of another grid is resized bicubically, as
``jax.image.resize`` does it (``F.interpolate(..., antialias=True)``
uses the same Keys kernel, a = -0.5, widened when shrinking).  Upstream
ViT ``.npz`` files (already in this layout) load through
``load_npz_checkpoint``, the R50 hybrid's ResNetV2 stem with them.  The
structural masks of a torch stage-1 checkpoint are its ``*.mask``
buffers (``masks_from_torch_state_dict``).

The conversion runs in numpy on the host; every function returns a tree
of contiguous f32 CPU tensors (``to_torch_state_dict`` a flat dict of
them).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    # row-major: a transposed or stacked numpy view keeps its layout, and
    # the kernels' wrappers take contiguous operands only
    return torch.from_numpy(np.ascontiguousarray(tree, np.float32))


def _gating(l: int) -> np.ndarray:
    return np.tile(np.array([-1.0, 1.0], np.float32), (l, 1))


def _fresh_head(d: int, num_classes: int, seed: int = 0) -> dict:
    """A freshly initialised classifier head for transfer learning:
    truncated normal (std 0.02, draws past 2 std drawn again, not
    clipped), zero bias."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((d, num_classes))
    bad = np.abs(k) > 2.0
    while bad.any():
        k[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(k) > 2.0
    k = (k * 0.02).astype(np.float32)
    return {"kernel": k, "bias": np.zeros(num_classes, np.float32)}


def _resize_grid(grid: np.ndarray, size: int, mode: str) -> np.ndarray:
    """``[g, g, D]`` -> ``[size, size, D]`` as ``jax.image.resize`` with
    ``method="cubic"`` / ``"bilinear"`` computes it (half-pixel centres,
    the kernel widened by the scale when shrinking)."""
    t = torch.from_numpy(np.ascontiguousarray(grid, np.float32))
    out = F.interpolate(t.permute(2, 0, 1)[None], size=(size, size),
                        mode=mode, align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).numpy()


def resize_pos_embed(pos: np.ndarray, new_len: int, new_prefix: int = 1,
                     old_prefix: int = 1) -> np.ndarray:
    """Bicubic grid resize of a learned position embedding ``[1, N, D]``:
    the class (/ distillation) token rows are carried over unscaled and
    the patch-grid rows interpolated as an image.  A target with more
    prefix rows than the source (plain -> distilled) repeats the class
    row."""
    pos = _np(pos)
    tok, grid = pos[:, :old_prefix], pos[0, old_prefix:]
    gs_old = int(np.sqrt(grid.shape[0]))
    gs_new = int(np.sqrt(new_len - new_prefix))
    if gs_old * gs_old != grid.shape[0] or gs_new * gs_new != \
            new_len - new_prefix:
        raise ValueError(
            f"pos_embed grid not square: {grid.shape[0]} -> "
            f"{new_len - new_prefix} tokens")
    grid = _resize_grid(grid.reshape(gs_old, gs_old, -1), gs_new, "bicubic")
    if new_prefix <= old_prefix:
        tok = tok[:, :new_prefix]
    else:
        tok = np.concatenate(
            [tok] + [tok[:, :1]] * (new_prefix - old_prefix), axis=1)
    return np.concatenate([tok, grid.reshape(1, gs_new * gs_new, -1)],
                          axis=1)


def _stack_lin(sd: Mapping, fmt: str, l: int) -> dict:
    ks, bs = [], []
    for i in range(l):
        w = _np(sd[fmt.format(i) + ".weight"]).T      # [out, in] -> [in, out]
        bkey = fmt.format(i) + ".bias"
        ks.append(w)
        bs.append(_np(sd[bkey]) if bkey in sd
                  else np.zeros(w.shape[1], np.float32))
    return {"kernel": np.stack(ks), "bias": np.stack(bs)}


def _stack_ln(sd: Mapping, fmt: str, l: int) -> dict:
    return {"scale": np.stack([_np(sd[fmt.format(i) + ".weight"])
                               for i in range(l)]),
            "bias": np.stack([_np(sd[fmt.format(i) + ".bias"])
                              for i in range(l)])}


def _blocks(sd: Mapping, l: int) -> dict:
    return {
        "ln1": _stack_ln(sd, "blocks.{}.norm1", l),
        "qkv": _stack_lin(sd, "blocks.{}.attn.qkv", l),
        "proj": _stack_lin(sd, "blocks.{}.attn.proj", l),
        "ln2": _stack_ln(sd, "blocks.{}.norm2", l),
        "fc1": _stack_lin(sd, "blocks.{}.mlp.fc1", l),
        "fc2": _stack_lin(sd, "blocks.{}.mlp.fc2", l),
    }


def _head(sd: Mapping, name: str, d: int, num_classes: int,
          seed: int) -> dict:
    """The checkpoint's head where its class count is the config's, else
    a fresh one (also where the checkpoint deleted its head)."""
    if f"{name}.weight" in sd and \
            _np(sd[f"{name}.weight"]).shape[0] == num_classes:
        w = _np(sd[f"{name}.weight"]).T
        b = (_np(sd[f"{name}.bias"]) if f"{name}.bias" in sd
             else np.zeros(w.shape[1], np.float32))
        return {"kernel": w, "bias": b}
    return _fresh_head(d, num_classes, seed=seed)


def from_torch_state_dict(sd: Mapping, cfg) -> dict:
    """The parameter tree of a timm / DeiT state dict (tensors or numpy
    arrays; a ``module.`` prefix is dropped)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    l, d = cfg.depth, cfg.embed_dim
    pe = _np(sd["patch_embed.proj.weight"])             # [D, C, P, P]
    params: dict = {
        "patch_embed": {"kernel": pe.transpose(2, 3, 1, 0),   # [P, P, C, D]
                        "bias": _np(sd["patch_embed.proj.bias"])},
        "cls_token": _np(sd["cls_token"]),
    }
    pos = _np(sd["pos_embed"])
    if pos.shape[1] != cfg.seq_len:
        # transfer to another image size: the grid resized bicubically
        pos = resize_pos_embed(pos, cfg.seq_len,
                               new_prefix=2 if cfg.distilled else 1,
                               old_prefix=2 if "dist_token" in sd else 1)
    params["pos_embed"] = pos
    params["blocks"] = _blocks(sd, l)
    params["norm"] = {"scale": _np(sd["norm.weight"]),
                      "bias": _np(sd["norm.bias"])}
    params["head"] = _head(sd, "head", d, cfg.num_classes, seed=0)
    if cfg.distilled:
        params["dist_token"] = _np(sd["dist_token"])
        params["head_dist"] = _head(sd, "head_dist", d, cfg.num_classes,
                                    seed=1)
    # the UVC leaves: a stage-1 checkpoint's gating, else the init's
    params["block_gating"] = (_np(sd["block_skip_gating"])
                              if "block_skip_gating" in sd else _gating(l))
    params["attn_gating"] = _gating(l)
    params["mlp_gating"] = _gating(l)
    if "gumbel.weight" in sd:
        w = _np(sd["gumbel.weight"]).T
        params["token_scorer"] = {
            "kernel": w, "bias": (_np(sd["gumbel.bias"]) if "gumbel.bias"
                                  in sd else np.zeros(w.shape[1],
                                                      np.float32))}
    else:
        params["token_scorer"] = {"kernel": np.zeros((d, 1), np.float32),
                                  "bias": np.zeros(1, np.float32)}
    if "patch_gating" in sd:
        params["patch_gating"] = _np(sd["patch_gating"])
    return _to_torch(params)


def to_torch_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """The timm / DeiT state dict of a parameter tree (f32 CPU tensors):
    ``from_torch_state_dict``'s inverse on the leaves it reads."""
    sd: Dict[str, np.ndarray] = {}
    sd["patch_embed.proj.weight"] = _np(
        params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = _np(params["patch_embed"]["bias"])
    sd["cls_token"] = _np(params["cls_token"])
    sd["pos_embed"] = _np(params["pos_embed"])
    blocks = {g: {k: _np(v) for k, v in sub.items()}
              for g, sub in params["blocks"].items()}
    for i in range(cfg.depth):
        sd[f"blocks.{i}.norm1.weight"] = blocks["ln1"]["scale"][i]
        sd[f"blocks.{i}.norm1.bias"] = blocks["ln1"]["bias"][i]
        sd[f"blocks.{i}.norm2.weight"] = blocks["ln2"]["scale"][i]
        sd[f"blocks.{i}.norm2.bias"] = blocks["ln2"]["bias"][i]
        for src, dst in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                         ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            sd[f"blocks.{i}.{dst}.weight"] = blocks[src]["kernel"][i].T
            sd[f"blocks.{i}.{dst}.bias"] = blocks[src]["bias"][i]
    sd["norm.weight"] = _np(params["norm"]["scale"])
    sd["norm.bias"] = _np(params["norm"]["bias"])
    sd["head.weight"] = _np(params["head"]["kernel"]).T
    sd["head.bias"] = _np(params["head"]["bias"])
    if cfg.distilled:
        sd["dist_token"] = _np(params["dist_token"])
        sd["head_dist.weight"] = _np(params["head_dist"]["kernel"]).T
        sd["head_dist.bias"] = _np(params["head_dist"]["bias"])
    sd["block_skip_gating"] = _np(params["block_gating"])
    sd["gumbel.weight"] = _np(params["token_scorer"]["kernel"]).T
    sd["gumbel.bias"] = _np(params["token_scorer"]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def read_torch_state_dict(path: str) -> Mapping:
    """The state dict of a ``.pth`` / ``.pth.tar`` file (``torch.load`` on
    the CPU): its ``model``, else ``state_dict_ema``, else ``state_dict``
    entry, or the file itself."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("model", "state_dict_ema", "state_dict"):
            if key in ckpt:
                return ckpt[key]
    return ckpt


def load_torch_checkpoint(path: str, cfg) -> dict:
    """A ``.pth`` / ``.pth.tar`` file's state dict
    (``read_torch_state_dict``) converted (``params_from_state_dict``)."""
    return params_from_state_dict(read_torch_state_dict(path), cfg)


def params_from_state_dict(ckpt: Mapping, cfg) -> dict:
    """The parameter tree of a DeiT / ViT state dict, or of a T2T-ViT one
    (its key names go to ``from_t2t_state_dict``)."""
    if any(k.startswith(("tokens_to_token.", "module.tokens_to_token."))
           for k in ckpt):
        return from_t2t_state_dict(ckpt, cfg)
    return from_torch_state_dict(ckpt, cfg)


def load_npz_checkpoint(path: str, cfg) -> dict:
    """Upstream ViT ``.npz`` weights (already in this layout: kernels
    ``[in, out]``, convs HWIO, q / k / v kernels ``[D, H, dh]``): q, k
    and v fused into ``qkv``, the blocks stacked, a position embedding of
    another grid resized bilinearly, a head of another class count
    zeroed; for the R50 hybrid, the stem's units (``block{i}/unit{u}``,
    HWIO kernels, ``conv_proj`` / ``gn_proj`` where the file has them) as
    the lists ``resnet.block{i}``."""
    with np.load(path, allow_pickle=False) as f:
        w = dict(f)
    d, l = cfg.embed_dim, cfg.depth

    def arr(k):
        return np.asarray(w[k], np.float32)

    def block(i, name):
        return arr(f"Transformer/encoderblock_{i}/{name}")

    at = "MultiHeadDotProductAttention_1"
    names = {"qkv": [], "qkvb": [], "proj": [], "projb": [], "fc1": [],
             "fc1b": [], "fc2": [], "fc2b": [], "ln1": [], "ln1b": [],
             "ln2": [], "ln2b": []}
    for i in range(l):
        names["qkv"].append(np.concatenate(
            [block(i, f"{at}/{n}/kernel").reshape(d, d)
             for n in ("query", "key", "value")], axis=1))      # [D, 3D]
        names["qkvb"].append(np.concatenate(
            [block(i, f"{at}/{n}/bias").reshape(-1)
             for n in ("query", "key", "value")]))
        names["proj"].append(block(i, f"{at}/out/kernel").reshape(d, d))
        names["projb"].append(block(i, f"{at}/out/bias").reshape(-1))
        names["fc1"].append(block(i, "MlpBlock_3/Dense_0/kernel"))
        names["fc1b"].append(block(i, "MlpBlock_3/Dense_0/bias"))
        names["fc2"].append(block(i, "MlpBlock_3/Dense_1/kernel"))
        names["fc2b"].append(block(i, "MlpBlock_3/Dense_1/bias"))
        names["ln1"].append(block(i, "LayerNorm_0/scale"))
        names["ln1b"].append(block(i, "LayerNorm_0/bias"))
        names["ln2"].append(block(i, "LayerNorm_2/scale"))
        names["ln2b"].append(block(i, "LayerNorm_2/bias"))
    st = {k: np.stack(v) for k, v in names.items()}

    pos = arr("Transformer/posembed_input/pos_embedding")    # [1, N+1, D]
    if pos.shape[1] != cfg.seq_len:
        tok, grid = pos[:, :1], pos[0, 1:]
        gs_old = int(np.sqrt(grid.shape[0]))
        grid = _resize_grid(grid.reshape(gs_old, gs_old, -1), cfg.grid_size,
                            "bilinear")
        pos = np.concatenate(
            [tok, grid.reshape(1, cfg.grid_size * cfg.grid_size, -1)],
            axis=1)

    if arr("head/bias").size == cfg.num_classes:
        head = {"kernel": arr("head/kernel").reshape(d, -1),
                "bias": arr("head/bias").reshape(-1)}
    else:
        # fine-tuning to another label set zero-initialises the head
        head = {"kernel": np.zeros((d, cfg.num_classes), np.float32),
                "bias": np.zeros(cfg.num_classes, np.float32)}
    params = {
        "patch_embed": {"kernel": arr("embedding/kernel"),
                        "bias": arr("embedding/bias")},
        "cls_token": arr("cls").reshape(1, 1, d),
        "pos_embed": pos,
        "blocks": {
            "ln1": {"scale": st["ln1"], "bias": st["ln1b"]},
            "qkv": {"kernel": st["qkv"], "bias": st["qkvb"]},
            "proj": {"kernel": st["proj"], "bias": st["projb"]},
            "ln2": {"scale": st["ln2"], "bias": st["ln2b"]},
            "fc1": {"kernel": st["fc1"], "bias": st["fc1b"]},
            "fc2": {"kernel": st["fc2"], "bias": st["fc2b"]},
        },
        "norm": {"scale": arr("Transformer/encoder_norm/scale"),
                 "bias": arr("Transformer/encoder_norm/bias")},
        "head": head,
        "block_gating": _gating(l),
        "attn_gating": _gating(l),
        "mlp_gating": _gating(l),
        "token_scorer": {"kernel": np.zeros((d, 1), np.float32),
                         "bias": np.zeros((1,), np.float32)},
    }
    if cfg.hybrid:
        params["resnet"] = _npz_stem(arr, w, cfg.resnet_layers)
    return _to_torch(params)


def to_npz_dict(params: dict, cfg) -> Dict[str, np.ndarray]:
    """The upstream ``.npz`` layout of a ViT / R50+ViT parameter tree (f32
    numpy arrays, ``np.savez`` writes them): ``load_npz_checkpoint``'s
    inverse on the leaves it reads."""
    d, h, dh = cfg.embed_dim, cfg.num_heads, cfg.head_size
    b = {g: {k: _np(v) for k, v in sub.items()}
         for g, sub in params["blocks"].items()}
    w = {"embedding/kernel": _np(params["patch_embed"]["kernel"]),
         "embedding/bias": _np(params["patch_embed"]["bias"]),
         "cls": _np(params["cls_token"]),
         "Transformer/posembed_input/pos_embedding":
             _np(params["pos_embed"]),
         "Transformer/encoder_norm/scale": _np(params["norm"]["scale"]),
         "Transformer/encoder_norm/bias": _np(params["norm"]["bias"]),
         "head/kernel": _np(params["head"]["kernel"]),
         "head/bias": _np(params["head"]["bias"])}
    at = "MultiHeadDotProductAttention_1"
    for i in range(cfg.depth):
        pre = f"Transformer/encoderblock_{i}"
        for j, nm in enumerate(("query", "key", "value")):
            cols = slice(j * d, (j + 1) * d)
            w[f"{pre}/{at}/{nm}/kernel"] = \
                b["qkv"]["kernel"][i][:, cols].reshape(d, h, dh)
            w[f"{pre}/{at}/{nm}/bias"] = \
                b["qkv"]["bias"][i][cols].reshape(h, dh)
        w[f"{pre}/{at}/out/kernel"] = b["proj"]["kernel"][i].reshape(h, dh, d)
        w[f"{pre}/{at}/out/bias"] = b["proj"]["bias"][i]
        for k, nm in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            w[f"{pre}/MlpBlock_3/{nm}/kernel"] = b[k]["kernel"][i]
            w[f"{pre}/MlpBlock_3/{nm}/bias"] = b[k]["bias"][i]
        for k, nm in (("ln1", "LayerNorm_0"), ("ln2", "LayerNorm_2")):
            w[f"{pre}/{nm}/scale"] = b[k]["scale"][i]
            w[f"{pre}/{nm}/bias"] = b[k]["bias"][i]
    if cfg.hybrid:
        stem = params["resnet"]

        def put(pre, tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    put(f"{pre}{k}/", v)
                else:
                    w[f"{pre}{k}" + ("/kernel" if k.startswith("conv")
                                     else "")] = _np(v)

        put("", {k: v for k, v in stem.items() if not k.startswith("block")})
        for bi in range(len(cfg.resnet_layers)):
            for u, unit in enumerate(stem[f"block{bi + 1}"]):
                put(f"block{bi + 1}/unit{u + 1}/", unit)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in w.items()}


def _npz_stem(arr, w, block_units) -> dict:
    """The ResNetV2 stem of an upstream R50+ViT ``.npz``."""
    def gn(pre):
        return {"scale": arr(f"{pre}/scale").reshape(-1),
                "bias": arr(f"{pre}/bias").reshape(-1)}

    stem = {"conv_root": arr("conv_root/kernel"), "gn_root": gn("gn_root")}
    for bi, n_units in enumerate(block_units):
        units = []
        for u in range(n_units):
            pre = f"block{bi + 1}/unit{u + 1}"
            unit = {}
            for i in (1, 2, 3):
                unit[f"conv{i}"] = arr(f"{pre}/conv{i}/kernel")
                unit[f"gn{i}"] = gn(f"{pre}/gn{i}")
            if f"{pre}/conv_proj/kernel" in w:
                unit["conv_proj"] = arr(f"{pre}/conv_proj/kernel")
                unit["gn_proj"] = gn(f"{pre}/gn_proj")
            units.append(unit)
        stem[f"block{bi + 1}"] = units
    return stem


def masks_from_torch_state_dict(sd: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The structural masks ``{"attn": [L, D], "mlp": [L, F]}`` (f32 CPU
    tensors) of a reference stage-1 ``state_dict``, read from the binary
    ``mask`` buffers its weighted modules carry: a context dim is kept
    where the column of ``blocks.i.attn.proj.mask`` is, a hidden unit where
    the column of ``blocks.i.mlp.fc2.mask`` is.  Raises ValueError unless
    the buffers are the layout pruning gives them: 0 / 1 values, every row
    of a column mask equal, ``blocks.i.mlp.fc1.mask``'s rows the units of
    fc2's columns, every other ``*.mask`` all ones."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    l, d, f = cfg.depth, cfg.embed_dim, cfg.mlp_hidden

    def buffer(key, shape):
        if key not in sd:
            raise ValueError(f"the state dict has no {key}")
        m = _np(sd[key])
        if m.shape != shape:
            raise ValueError(f"{key} has shape {m.shape}, expected {shape}")
        if not np.isin(m, (0.0, 1.0)).all():
            raise ValueError(f"{key} holds values other than 0 and 1")
        return m

    def columns(key, shape):
        m = buffer(key, shape)
        if not (m == m[:1]).all():
            raise ValueError(f"{key}: its rows differ (a column mask "
                             "prunes whole input columns)")
        return m[0]

    attn, mlp = [], []
    read = set()
    for i in range(l):
        pre = f"blocks.{i}"
        attn.append(columns(f"{pre}.attn.proj.mask", (d, d)))
        mlp.append(columns(f"{pre}.mlp.fc2.mask", (d, f)))
        rows = buffer(f"{pre}.mlp.fc1.mask", (f, d))
        if not (rows == mlp[-1][:, None]).all():
            raise ValueError(f"{pre}.mlp.fc1.mask: its rows are not the "
                             f"units kept by {pre}.mlp.fc2.mask")
        read.update(f"{pre}.{k}.mask" for k in ("attn.proj", "mlp.fc2",
                                                  "mlp.fc1"))
    for key in sorted(k for k in sd if k.endswith(".mask")
                      and k not in read):
        if not (_np(sd[key]) == 1.0).all():
            raise ValueError(f"{key} prunes weights where the structural "
                             "masks cannot: only attn.proj, mlp.fc1 and "
                             "mlp.fc2 may hold zeros")
    return {"attn": torch.from_numpy(np.stack(attn).astype(np.float32)),
            "mlp": torch.from_numpy(np.stack(mlp).astype(np.float32))}


def _t2t_stage(sd: Mapping, prefix: str, performer: bool) -> dict:
    """One tokens-to-token stage: the token performer's or the token
    transformer's leaves."""

    def lin(name):
        w = _np(sd[f"{prefix}.{name}.weight"]).T
        bkey = f"{prefix}.{name}.bias"
        b = _np(sd[bkey]) if bkey in sd else np.zeros(w.shape[1], np.float32)
        return {"kernel": w, "bias": b}

    def ln(name):
        return {"scale": _np(sd[f"{prefix}.{name}.weight"]),
                "bias": _np(sd[f"{prefix}.{name}.bias"])}

    if performer:
        return {"kqv": lin("kqv"), "proj": lin("proj"),
                "norm1": ln("norm1"), "norm2": ln("norm2"),
                "mlp_fc1": lin("mlp.0"), "mlp_fc2": lin("mlp.2"),
                "prm_w": _np(sd[f"{prefix}.w"])}
    return {"qkv": lin("attn.qkv"), "proj": lin("attn.proj"),
            "norm1": ln("norm1"), "norm2": ln("norm2"),
            "mlp_fc1": lin("mlp.fc1"), "mlp_fc2": lin("mlp.fc2")}


def from_t2t_state_dict(sd: Mapping, cfg) -> dict:
    """The parameter tree of an upstream T2T-ViT state dict
    (``tokens_to_token.attention{1,2}``, ``tokens_to_token.project``,
    ``blocks.N.*`` named as DeiT's; its sinusoid position table is not a
    parameter)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    performer = cfg.tokens_type == "performer"
    l = cfg.depth
    params = {
        "cls_token": _np(sd["cls_token"]),
        "blocks": _blocks(sd, l),
        "norm": {"scale": _np(sd["norm.weight"]),
                 "bias": _np(sd["norm.bias"])},
        "head": _head(sd, "head", cfg.embed_dim, cfg.num_classes, seed=0),
        "t2t": {
            "attention1": _t2t_stage(sd, "tokens_to_token.attention1",
                                     performer),
            "attention2": _t2t_stage(sd, "tokens_to_token.attention2",
                                     performer),
            "project": {
                "kernel": _np(sd["tokens_to_token.project.weight"]).T,
                "bias": _np(sd["tokens_to_token.project.bias"]),
            },
        },
        "block_gating": (_np(sd["block_skip_gating"])
                         if "block_skip_gating" in sd else _gating(l)),
        "attn_gating": _gating(l),
        "mlp_gating": _gating(l),
    }
    return _to_torch(params)
