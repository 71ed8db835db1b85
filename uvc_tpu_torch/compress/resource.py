"""Closed-form MACs table (counterpart of ``uvc_tpu/compress/resource.py``,
the numpy part).

``build_macs_table`` reproduces the reference's runtime MACs probe for a
config (golden value: DeiT-Tiny dense probe 2506.98 MFLOPs).  The
differentiable resource functions belong to training and come with it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from uvc_tpu_torch.configs import ViTConfig


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
