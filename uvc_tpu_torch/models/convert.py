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
``load_npz_checkpoint``; the R50 hybrid stem is not ported.

The conversion runs in numpy on the host; every function returns a tree
of contiguous f32 CPU tensors (``to_torch_state_dict`` a flat dict of
them).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

NOT_PORTED_HYBRID = ("the R50 hybrid stem needs models/resnet.py, which "
                     "is not ported yet; see ROADMAP.md queue A item 6")


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


def load_torch_checkpoint(path: str, cfg) -> dict:
    """A ``.pth`` / ``.pth.tar`` file through ``torch.load`` (on the CPU),
    converted: its ``model``, else ``state_dict_ema``, else
    ``state_dict`` entry, or the file itself; T2T-ViT key names go to
    ``from_t2t_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("model", "state_dict_ema", "state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    if any(k.startswith(("tokens_to_token.", "module.tokens_to_token."))
           for k in ckpt):
        return from_t2t_state_dict(ckpt, cfg)
    return from_torch_state_dict(ckpt, cfg)


def load_npz_checkpoint(path: str, cfg) -> dict:
    """Upstream ViT ``.npz`` weights (already in this layout: kernels
    ``[in, out]``, convs HWIO, q / k / v kernels ``[D, H, dh]``): q, k
    and v fused into ``qkv``, the blocks stacked, a position embedding of
    another grid resized bilinearly, a head of another class count
    zeroed.  The R50 hybrid stem raises (not ported)."""
    if cfg.hybrid:
        raise NotImplementedError(NOT_PORTED_HYBRID)
    with np.load(path, allow_pickle=False) as f:
        w = dict(f)
    if "conv_root/kernel" in w:
        raise NotImplementedError(NOT_PORTED_HYBRID)
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
    return _to_torch(params)


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
