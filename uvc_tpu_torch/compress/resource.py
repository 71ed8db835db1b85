"""Closed-form MACs table and the differentiable FLOPs fraction
(counterpart of ``uvc_tpu/compress/resource.py``).

``build_macs_table`` reproduces the reference's runtime MACs probe for a
config (golden value: DeiT-Tiny dense probe 2506.98 MFLOPs);
``flops_fraction`` and ``flops2_fraction`` are the resource functions of
the minimax update, with straight-through gradients through the integer
rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.interop import host_to_device
from uvc_tpu_torch.ops.stes import (bottom_k_mask, ste_ceil, ste_floor,
                                    torch_clamp)


class MacsTable(NamedTuple):
    """Static MACs accounting for one backbone at probe batch size 1.

    ``block [L, 6]`` columns are (qkv, q@k, attn@v, proj, fc1, fc2), the
    exact order the reference forward appends them (model_distilled.py:
    177-189 attention, :115-121 mlp) and ``calc_flops`` consumes them
    (uvc_utils.py:454-460).
    """

    embed: float          # patch-embedding (or T2T stem) MACs
    block: np.ndarray     # [L, 6] float64 per-block MACs
    dense_flops: float    # 2 * (embed + block.sum()) — the normalizer

    @property
    def m01(self) -> np.ndarray:
        return self.block[:, 0] + self.block[:, 1]

    @property
    def m23(self) -> np.ndarray:
        return self.block[:, 2] + self.block[:, 3]

    @property
    def m45(self) -> np.ndarray:
        return self.block[:, 4] + self.block[:, 5]


def _t2t_stem_macs(cfg: ViTConfig) -> float:
    """MACs of the tokens-to-token stem, mirroring the reference's inline
    accounting (performer: UVC/T2TViT/models/token_performer.py:54-68;
    only the two attention stages are counted — t2t_vit.py:105 returns
    macs1+macs2, soft-splits and the final projection are not counted).

    Note: the reference mlp term ``x.shape[2]*emb*emb`` omits the token
    axis (a quirk of the hand accounting); we mirror it verbatim because
    the stem MACs only enter the resource function as an additive constant
    and parity with published trajectories requires the same constant.
    """
    g = cfg.img_size // 4  # after first 7x7 stride-4 soft split
    emb = cfg.token_dim
    m = int(emb * 0.5)
    total = 0.0
    for (t, dim) in (((g * g), cfg.in_chans * 7 * 7),
                     ((g // 2) * (g // 2), cfg.token_dim * 3 * 3)):
        single_attn = (
            t * dim * 3 * emb          # kqv
            + (t * emb + emb * t * emb) * 2  # prm_exp(k), prm_exp(q)
            + t * m                    # D
            + t * emb * m              # kptv
            + t * m * emb              # y
            + t * emb * emb            # proj
        )
        mlp = t * emb * emb + emb * emb * emb
        total += single_attn + mlp
    return float(total)


def build_macs_table(cfg: ViTConfig) -> MacsTable:
    """Analytic per-block MACs table for probe batch 1.

    Matches the reference runtime probe
    ``model(torch.ones(1,3,224,224))`` (joint_train.py:1010-1012):

    * embed: ``num_patches * D * patch^2 * in_chans``
      (model_distilled.py:458-460 — computed on the 196-token tensor
      *before* cls concat).
    * per block with N = seq_len tokens:
      qkv ``3D*N*D``, q@k ``N^2*D``, attn@v ``N^2*D``, proj ``N*D^2``,
      fc1 ``d_ff*N*D``, fc2 ``D*N*d_ff``.
    """
    d = cfg.embed_dim
    n = cfg.seq_len
    dff = cfg.mlp_hidden
    if cfg.tokens_type == "none":
        embed = float(cfg.num_patches * d * cfg.patch_size ** 2 * cfg.in_chans)
    else:
        embed = _t2t_stem_macs(cfg)
    row = np.array([
        3 * d * n * d,   # qkv
        n * n * d,       # q @ k^T  (N * B*H*N*head_size)
        n * n * d,       # attn @ v
        n * d * d,       # output proj
        dff * n * d,     # fc1
        d * n * dff,     # fc2
    ], dtype=np.float64)
    block = np.tile(row, (cfg.depth, 1))
    dense = 2.0 * (embed + float(block.sum()))
    return MacsTable(embed=embed, block=block, dense_flops=dense)


def flops_fraction(s: torch.Tensor, r: torch.Tensor, scores2: torch.Tensor,
                   distrib1, table: MacsTable, cfg: ViTConfig
                   ) -> torch.Tensor:
    """Compressed FLOPs over dense FLOPs, differentiable in ``s`` ``[L, 2]``
    (heads, MLP units removed), ``r`` ``[L, H]`` (within-head dims removed)
    and ``distrib1`` (``[L]`` block keep probabilities, or 1.0).  The heads
    in the bottom ``ceil(s0)`` by ``scores2`` count as wholly removed, the
    rest lose ``r`` dims each.  The ratios are clamped with
    ``torch_clamp`` so that at s = 0 (ratio exactly 1) they still pass the
    full gradient."""
    hs, d = cfg.head_size, cfg.embed_dim
    s_c, r_c = ste_ceil(s), ste_ceil(r)
    s_ub = (float(cfg.num_heads), float(cfg.mlp_hidden))
    s_ratio = torch_clamp(torch.stack(
        [(u - s_c[:, i]) / u for i, u in enumerate(s_ub)], dim=-1),
        0.0, 1.0)                                              # [L, 2]
    k_heads = torch.ceil(s[:, 0].detach()).long()
    pruned_head = bottom_k_mask(scores2, k_heads)             # [L, H]
    attn_keep = (d - s_c[:, 0] * hs
                 - torch.where(pruned_head, torch.zeros_like(r_c),
                               r_c).sum(dim=-1))
    r_ratio = torch_clamp(attn_keep / d, 0.0, 1.0)            # [L]

    def col(m):
        return host_to_device(torch.as_tensor(m, dtype=s.dtype), s.device)

    per_block = (col(table.m01) * s_ratio[:, 0] + col(table.m23) * r_ratio
                 + col(table.m45) * s_ratio[:, 1])
    macs = table.embed + (distrib1 * per_block).sum()
    return 2.0 * macs / table.dense_flops


def flops2_fraction(s: torch.Tensor, r: torch.Tensor, scores2: torch.Tensor,
                    cfg: ViTConfig) -> torch.Tensor:
    """The W1 / W3 linear-layer cost of ``--flops_with_mhsa 0`` (fc2 and
    the attention projection only, no gating), normalised by its value at
    s = r = 0; ``ste_floor`` keeps the identity gradients."""
    d, dff, hs = float(cfg.embed_dim), float(cfg.mlp_hidden), \
        float(cfg.head_size)
    term_w3 = 2.0 * ste_floor(dff - s[:, 1]) * d + d
    k_heads = torch.ceil(s[:, 0].detach()).long()
    pruned_head = bottom_k_mask(scores2, k_heads)
    r_f = ste_floor(r)
    attn_in = (d - ste_floor(s[:, 0]) * hs
               - torch.where(pruned_head, torch.zeros_like(r_f),
                             r_f).sum(dim=-1))
    term_w1 = 2.0 * attn_in * d + d
    ub = cfg.depth * (2.0 * dff * d + d + 2.0 * d * d + d)
    return (term_w3 + term_w1).sum() / ub
