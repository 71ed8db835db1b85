"""T2T-ViT backbone family with the token-performer or token-transformer
stem (counterpart of ``uvc_tpu/models/t2t_vit.py``).

Three soft splits (7/4/2, 3/2/1, 3/2/1) with two token-attention stages
between them and a final projection feed the DeiT block stack of
``models/vit.py`` (``transformer_encode``: the same sublayer kernels,
gating and masks), with a fixed sinusoid position embedding computed as a
constant.  The performer's random features ``prm_w`` sit in the parameter
tree and get no gradient (``train/state.py`` zeroes their updates).

The performer stem always takes the layout the JAX package uses on an
accelerator, on the card and on the CPU alike: stage 1 reads the
space-to-depth neighbourhoods of ``s2d_stage1_inputs`` (``[B, N, 64 C]``
with 49 C live slots and the LN1 statistics masked to them), stage 2 and
the final projection read the ``(kh, kw, c)``-ordered unfold with their
weight rows permuted by ``_klast_perm``.  Each performer stage is one
``fused_performer`` (kernels A10 / A11 on the card).  In f32 this equals
the JAX CPU route (nn.Unfold order and the composed stage) up to
summation order.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.models import vit
from uvc_tpu_torch.models.vit import (ForwardOutput, _layer_norm, _linear,
                                      _to_device, _trunc_normal)
from uvc_tpu_torch.ops.performer import fused_performer, s2d_stage1_inputs


@functools.lru_cache(maxsize=8)
def sinusoid_pos_embed(n_position: int, d_hid: int) -> np.ndarray:
    """get_sinusoid_encoding (transformer_block.py:115-125), ``[1, n, d]``."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


def _windows(x, k, s, p):
    """The k * k strided slices of the padded NHWC ``x``, row-major over
    (ki, kj), each ``[B, oh, ow, C]``."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, p, p, p, p))
    oh = (h + 2 * p - k) // s + 1
    ow = (w + 2 * p - k) // s + 1
    return [x[:, ki:ki + (oh - 1) * s + 1:s, kj:kj + (ow - 1) * s + 1:s]
            for ki in range(k) for kj in range(k)], oh * ow


def _unfold(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """nn.Unfold: ``[B, H, W, C] -> [B, L, C * k * k]`` in (c, kh, kw)
    feature order."""
    pieces, n = _windows(x, k, s, p)
    pat = torch.stack(pieces, dim=-1)                # [B, oh, ow, C, k*k]
    return pat.reshape(x.shape[0], n, x.shape[-1] * k * k)


def _unfold_klast(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """The patch gather in (kh, kw, c) feature order: each window slice is
    one contiguous c-wide chunk; consumers permute their weight rows with
    ``_klast_perm``."""
    pieces, n = _windows(x, k, s, p)
    return torch.cat(pieces, dim=-1).reshape(x.shape[0], n,
                                             k * k * x.shape[-1])


def _klast_perm(k: int, c: int) -> np.ndarray:
    """feat_idx mapping a (kh, kw, c) slot to its nn.Unfold (c, kh, kw)
    weight row: slot (ki * k + kj) * c + ch -> row ch * k^2 + ki * k + kj."""
    idx = np.empty((k * k * c,), np.int32)
    for ki in range(k):
        for kj in range(k):
            for ch in range(c):
                idx[(ki * k + kj) * c + ch] = ch * k * k + ki * k + kj
    return idx


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _ln(dim):
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def init_performer(generator: torch.Generator, dim: int, emb: int,
                   kernel_ratio: float = 0.5) -> dict:
    """Token_performer parameters (token_performer.py:8-29) on the CPU; the
    random features are orthogonal rows scaled by sqrt(m)."""
    m = int(emb * kernel_ratio)
    w = torch.randn((m, emb), generator=generator)
    q, _ = torch.linalg.qr(w.T)
    return {
        "kqv": _linear(generator, dim, 3 * emb),
        "proj": _linear(generator, emb, emb),
        "norm1": _ln(dim), "norm2": _ln(emb),
        "mlp_fc1": _linear(generator, emb, emb),
        "mlp_fc2": _linear(generator, emb, emb),
        "prm_w": q.T * math.sqrt(m),
    }


def init_token_transformer(generator: torch.Generator, dim: int,
                           in_dim: int) -> dict:
    """Token_transformer parameters (token_transformer.py:13-60), one head,
    mlp_ratio 1, on the CPU."""
    return {
        "qkv": _linear(generator, dim, 3 * in_dim),
        "proj": _linear(generator, in_dim, in_dim),
        "norm1": _ln(dim), "norm2": _ln(in_dim),
        "mlp_fc1": _linear(generator, in_dim, in_dim),
        "mlp_fc2": _linear(generator, in_dim, in_dim),
    }


def init_params(generator: torch.Generator, cfg: ViTConfig, *,
                device="cuda", **_ignored) -> dict:
    """A T2T-ViT parameter tree in the JAX package's layout: the ``t2t``
    stem, a class token and the DeiT block stack, head and gating logits
    (no patch embedding, position embedding or token scorer).  Extra
    keywords (``patch_gating``) are accepted and ignored, as in the JAX
    package.  ``generator`` is a CPU ``torch.Generator``."""
    dev = resolve_device(device)
    if cfg.tokens_type not in ("performer", "transformer"):
        raise NotImplementedError(
            f"backbone {cfg.name} is not ported yet; see ROADMAP.md")
    if cfg.t2t_variant != "none":
        raise ValueError(f"{cfg.name} is a T2T architecture ablation: its "
                         "model is models/t2t_ablations.py (get_model)")
    return _to_device(init_tree(generator, cfg), dev)


def init_tree(generator: torch.Generator, cfg: ViTConfig) -> dict:
    """The parameter tree of ``init_params`` on the CPU, for any model on
    the T2T stem (the architecture ablations replace its block stack)."""
    params = vit.init_tree(generator, cfg)
    for k in ("patch_embed", "pos_embed", "token_scorer", "dist_token",
              "head_dist"):
        params.pop(k, None)
    td = cfg.token_dim
    init = (init_performer if cfg.tokens_type == "performer"
            else init_token_transformer)
    params["t2t"] = {
        "attention1": init(generator, cfg.in_chans * 7 * 7, td),
        "attention2": init(generator, td * 3 * 3, td),
        "project": _linear(generator, td * 3 * 3, cfg.embed_dim),
    }
    params["cls_token"] = _trunc_normal(generator, (1, 1, cfg.embed_dim))
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_token_transformer(p: dict, x: torch.Tensor, dim: int,
                            dtype=torch.float32) -> torch.Tensor:
    """Token_transformer forward (token_transformer.py:31-60), composed in
    PyTorch as the JAX package composes it: one head with scale
    ``dim ** -0.5``, the v residual, a GELU MLP."""
    scale = dim ** -0.5
    xn = _layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], 1e-5)
    qkv = xn @ p["qkv"]["kernel"].to(dtype) + p["qkv"]["bias"].to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    logits = (q * scale).float() @ k.float().transpose(-1, -2)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    ctx = (attn.float() @ v.float()).to(dtype)
    x = v + (ctx @ p["proj"]["kernel"].to(dtype)
             + p["proj"]["bias"].to(dtype))
    h = _layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"], 1e-5)
    h = h @ p["mlp_fc1"]["kernel"].to(dtype) + p["mlp_fc1"]["bias"].to(dtype)
    h = F.gelu(h.float()).to(dtype)
    h = h @ p["mlp_fc2"]["kernel"].to(dtype) + p["mlp_fc2"]["bias"].to(dtype)
    return x + h


def apply_performer(p: dict, x: torch.Tensor, *, dtype=torch.float32,
                    feat_idx: Optional[np.ndarray] = None) -> torch.Tensor:
    """Token_performer forward (token_performer.py:31-69), dropout-free,
    under the JAX package's name: the fused stage of ``ops/performer.py``
    on either device."""
    return fused_performer(p, x, dtype=dtype, feat_idx=feat_idx)


def t2t_stem(params: dict, x: torch.Tensor, cfg: ViTConfig,
             dtype=torch.float32) -> torch.Tensor:
    """Tokens-to-token encoding (t2t_vit.py:84-105): ``[B, H, W, C] ->
    [B, N, D]``."""
    stem = params["t2t"]
    b = x.shape[0]
    g0 = cfg.img_size // 4
    performer = cfg.tokens_type == "performer"
    x = x.to(dtype)
    if performer:
        xs, feat_idx = s2d_stage1_inputs(x)
        if xs is None:
            raise ValueError(f"the stem needs square images of a multiple "
                             f"of 4 pixels, got {tuple(x.shape)}")
        t = apply_performer(stem["attention1"], xs, dtype=dtype,
                            feat_idx=feat_idx)
    else:
        t = apply_token_transformer(stem["attention1"], _unfold(x, 7, 4, 2),
                                    cfg.in_chans * 49, dtype)
    t = t.reshape(b, g0, g0, -1)
    td = t.shape[-1]
    if performer:
        t = apply_performer(stem["attention2"], _unfold_klast(t, 3, 2, 1),
                            dtype=dtype, feat_idx=_klast_perm(3, td))
    else:
        t = apply_token_transformer(stem["attention2"], _unfold(t, 3, 2, 1),
                                    td * 9, dtype)
    g1 = g0 // 2
    t = t.reshape(b, g1, g1, -1)
    kernel = stem["project"]["kernel"]
    if performer:
        t = _unfold_klast(t, 3, 2, 1)
        kernel = kernel[torch.as_tensor(_klast_perm(3, td), device=x.device)]
    else:
        t = _unfold(t, 3, 2, 1)
    return t @ kernel.to(dtype) + stem["project"]["bias"].to(dtype)


def embed(params: dict, x: torch.Tensor, cfg: ViTConfig,
          dtype=torch.float32) -> torch.Tensor:
    """The stem, the class token and the sinusoid position embedding:
    ``[B, H, W, C] -> [B, N + 1, D]``."""
    t = t2t_stem(params, x, cfg, dtype)
    cls = params["cls_token"].expand(x.shape[0], 1, cfg.embed_dim).to(dtype)
    pos = torch.as_tensor(sinusoid_pos_embed(cfg.num_patches + 1,
                                             cfg.embed_dim), device=x.device)
    return torch.cat([cls, t], dim=1) + pos.to(dtype)


def apply(params: dict, x: torch.Tensor, cfg: ViTConfig, *,
          gating_distrib: Optional[torch.Tensor] = None,
          attn_distrib: Optional[torch.Tensor] = None,
          mlp_distrib: Optional[torch.Tensor] = None, masks=None,
          tau: float = -1.0, patch_ratio: float = 0.9,
          patch_gate_mode: int = 0, patch_hard: bool = False,
          patch_physical: bool = False, jumping: bool = False, rng=None,
          train: bool = False, drop_path_rate: float = 0.0,
          drop_path: Optional[torch.Tensor] = None,
          dtype=torch.float32) -> ForwardOutput:
    """T2T-ViT forward (t2t_vit.py:168-208) with ``vit.apply``'s arguments.
    The T2T forward has no token selection or patch gating: those
    arguments (and the token noise ``rng``) are accepted and ignored, as in
    the JAX package.  Drop-path takes its ``[L, 2, B]`` keep decisions as
    ``drop_path``."""
    t = embed(params, x, cfg, dtype)
    t = vit.transformer_encode(
        params, t, cfg, gating_distrib=gating_distrib,
        attn_distrib=attn_distrib, mlp_distrib=mlp_distrib, masks=masks,
        jumping=jumping, drop_path_rate=drop_path_rate if train else 0.0,
        drop_path=drop_path, dtype=dtype)
    logits = t[:, 0].float() @ params["head"]["kernel"] \
        + params["head"]["bias"]
    return ForwardOutput(logits=logits, logits_kd=logits, token_mask=None)


eval_logits = vit.eval_logits
