"""The plain reference forward of DeiT and T2T-ViT with UVC's compression.

Plain PyTorch in float32, written from the published architectures (DeiT,
arXiv:2012.12877; T2T-ViT, arXiv:2101.11986 with its token performer) and
UVC's compression (masks on the attention columns and MLP units, the
block-gating blend, token selection by a linear scorer), in the port's
parameter layout (linear kernels stored (in, out), per-block tensors
stacked on a leading layer axis, NHWC images).  It imports nothing of the
program.

Every matrix product goes through ``Numerics.mm``: float32 with TF32 off,
or, for the control, each operand rounded to float8 e4m3 with a
per-tensor scale (the precision below the program's bfloat16), with the
straight-through gradient of the rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

F8_MAX = 448.0          # the largest finite float8 e4m3 value
PERFORMER_LN_EPS = 1e-5  # nn.LayerNorm's default, the token performer's
PERFORMER_D_EPS = 1e-8   # the performer's normaliser guard


def strict_f32() -> None:
    """No TF32 anywhere: every float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _f8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / F8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


class Numerics:
    """The reference's products: ``"f32"`` or the control's ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            a, b = _f8(a), _f8(b)
        return a @ b


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(pixels: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC pixels to the ImageNet-normalised float32 input."""
    mean = torch.tensor(IMAGENET_MEAN, device=pixels.device)
    std = torch.tensor(IMAGENET_STD, device=pixels.device)
    return (pixels.float() / 255.0 - mean) / std


def layer_norm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def linear(num: Numerics, x, p):
    return num.mm(x, p["kernel"]) + p["bias"]


class TokenChoice(NamedTuple):
    """How a forward selects patch tokens: ``"gumbel"`` (the stage-1 search:
    the straight-through top-k mask of the scores perturbed by ``noise``
    at temperature ``tau``, applied by multiplication) or ``"drop"`` (the
    frozen scorer's top-k, the others removed), keeping
    ``int(ratio * patches)`` of them."""

    kind: str
    ratio: float
    noise: Optional[torch.Tensor] = None
    tau: float = 1.0


def _topk_keep(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` best patches, patch 0 always among them, in
    ascending order."""
    boosted = scores.clone()
    boosted[:, 0] = float("inf")
    return torch.sort(torch.topk(boosted, k, dim=-1).indices, dim=-1).values


def _gumbel_mask(noise, scores, k: int, tau: float) -> torch.Tensor:
    y_soft = torch.softmax((torch.log_softmax(scores, dim=-1) + noise) / tau,
                           dim=-1)
    kth = torch.topk(y_soft, k, dim=-1).values[:, -1:]
    mask = (y_soft >= kth).float() + y_soft - y_soft.detach()
    first = torch.zeros_like(mask, dtype=torch.bool)
    first[:, 0] = True
    return torch.where(first, torch.ones_like(mask), mask)


def sinusoid_table(n: int, d: int) -> np.ndarray:
    """The fixed position table of T2T-ViT (``[1, n, d]``)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


def _unfold(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """``nn.Unfold`` of NHWC ``x``: ``[B, L, C k k]``, (c, kh, kw) order."""
    return F.unfold(x.permute(0, 3, 1, 2), k, padding=p,
                    stride=s).transpose(1, 2)


def performer(num: Numerics, p: dict, x: torch.Tensor) -> torch.Tensor:
    """T2T-ViT's Token_performer: ``attn = v + proj(y)`` of the linear
    attention with positive random features on LN1(x), then ``attn +
    MLP(LN2(attn))``."""
    emb = p["kqv"]["kernel"].shape[1] // 3
    xn = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"],
                    PERFORMER_LN_EPS)
    kqv = linear(num, xn, p["kqv"])
    k, q, v = kqv[..., :emb], kqv[..., emb:2 * emb], kqv[..., 2 * emb:]
    w = p["prm_w"].detach()          # fixed random features

    def prm(t):
        xd = (t * t).sum(dim=-1, keepdim=True) / 2
        return torch.exp(num.mm(t, w.T) - xd) / math.sqrt(w.shape[0])

    kp, qp = prm(k), prm(q)
    d = (qp * kp.sum(dim=1, keepdim=True)).sum(dim=-1, keepdim=True)
    kptv = num.mm(v.transpose(1, 2), kp)                # [B, emb, m]
    y = num.mm(qp, kptv.transpose(1, 2)) / (d + PERFORMER_D_EPS)
    attn = v + linear(num, y, p["proj"])
    h = layer_norm(attn, p["norm2"]["scale"], p["norm2"]["bias"],
                   PERFORMER_LN_EPS)
    return attn + linear(num, F.gelu(linear(num, h, p["mlp_fc1"])),
                         p["mlp_fc2"])


def t2t_embed(num: Numerics, params: dict, x: torch.Tensor, cfg):
    """The tokens-to-token stem, the class token and the sinusoid table."""
    stem = params["t2t"]
    b, g0 = x.shape[0], cfg.img_size // 4
    t = performer(num, stem["attention1"], _unfold(x, 7, 4, 2))
    t = performer(num, stem["attention2"],
                  _unfold(t.reshape(b, g0, g0, -1), 3, 2, 1))
    g1 = g0 // 2
    t = linear(num, _unfold(t.reshape(b, g1, g1, -1), 3, 2, 1),
               stem["project"])
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    pos = torch.as_tensor(sinusoid_table(cfg.num_patches + 1, cfg.embed_dim),
                          device=x.device)
    return torch.cat([cls, t], dim=1) + pos


def vit_embed(num: Numerics, params: dict, x: torch.Tensor, cfg,
              tokens: Optional[TokenChoice]):
    """Patchify, embed, select tokens, prepend the class token, add the
    learned positions."""
    b, p = x.shape[0], cfg.patch_size
    g = cfg.img_size // p
    patches = x.reshape(b, g, p, g, p, cfg.in_chans).permute(
        0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * cfg.in_chans)
    pe = params["patch_embed"]
    t = num.mm(patches, pe["kernel"].reshape(-1, cfg.embed_dim)) + pe["bias"]
    pos = params["pos_embed"]
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim) + pos[:, :1]
    if tokens is None:
        return torch.cat([cls, t + pos[:, 1:]], dim=1)
    k = int(tokens.ratio * cfg.num_patches)
    sc = params["token_scorer"]
    scores = linear(num, t, sc)[..., 0]
    if tokens.kind == "gumbel":
        mask = _gumbel_mask(tokens.noise, scores, k, tokens.tau)
        return torch.cat([cls, t * mask[..., None] + pos[:, 1:]], dim=1)
    idx = _topk_keep(scores, k)[..., None].expand(b, k, cfg.embed_dim)
    kept = torch.gather(t + pos[:, 1:], 1, idx)
    return torch.cat([cls, kept], dim=1)


def block(num: Numerics, blk: dict, h: torch.Tensor, cfg, *,
          attn_mask=None, mlp_mask=None) -> torch.Tensor:
    """One transformer block: pre-LN attention with its column mask on the
    heads' outputs, pre-LN MLP with its unit mask; both residual."""
    b, n, dm = h.shape
    heads, hs = cfg.num_heads, cfg.head_size
    scale = cfg.qk_scale if cfg.qk_scale is not None else hs ** -0.5
    eps = cfg.layer_norm_eps
    a = layer_norm(h, blk["ln1"]["scale"], blk["ln1"]["bias"], eps)
    qkv = linear(num, a, blk["qkv"]).reshape(b, n, 3, heads, hs)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    probs = torch.softmax(num.mm(q, k.transpose(-1, -2)) * scale, dim=-1)
    ctx = num.mm(probs, v).transpose(1, 2).reshape(b, n, dm)
    if attn_mask is not None:
        ctx = ctx * attn_mask
    z = h + linear(num, ctx, blk["proj"])
    a = layer_norm(z, blk["ln2"]["scale"], blk["ln2"]["bias"], eps)
    u = F.gelu(linear(num, a, blk["fc1"]))
    if mlp_mask is not None:
        u = u * mlp_mask
    return z + linear(num, u, blk["fc2"])


def forward(num: Numerics, params: dict, x: torch.Tensor, cfg, *,
            gating: Optional[torch.Tensor] = None, masks=None,
            tokens: Optional[TokenChoice] = None,
            skip_blocks=()) -> torch.Tensor:
    """The logits ``[B, classes]`` of a batch of NHWC images.

    ``gating`` ``[L, 2]`` blends each block as ``g1 * block(h) + g0 * h``;
    ``skip_blocks`` leaves those blocks out (the served model);
    ``masks`` ``{"attn": [L, D], "mlp": [L, F]}``; ``tokens`` the token
    selection (DeiT only: the T2T forward selects none)."""
    if cfg.tokens_type != "none":
        h = t2t_embed(num, params, x, cfg)
    else:
        h = vit_embed(num, params, x, cfg, tokens)
    blocks = params["blocks"]
    for i in range(cfg.depth):
        if i in skip_blocks:
            continue
        blk = {name: {k: v[i] for k, v in sub.items()}
               for name, sub in blocks.items()}
        out = block(num, blk, h, cfg,
                    attn_mask=None if masks is None else masks["attn"][i],
                    mlp_mask=None if masks is None else masks["mlp"][i])
        h = out if gating is None else gating[i, 1] * out + gating[i, 0] * h
    h = layer_norm(h, params["norm"]["scale"], params["norm"]["bias"],
                   cfg.layer_norm_eps)
    return linear(num, h[:, 0], params["head"])
