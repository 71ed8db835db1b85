"""The frozen yardstick: the H100's published peaks, each kernel's
operations and bytes from its shapes, and a model's FLOPs.

The sublayer counts are those of ``chip_smoke.py``'s kernel phase (K1, K2,
K3, A2, A4, A6), ``_performer_bound`` (A10 / A11) and ``_core_bound``,
copied here so that no later change to the program moves them.  Two
things differ: a product that a backward kernel computes again (the qkv
projection, the attention logits and P @ V, fc1) is returned apart as
``recompute`` and never counts towards a bound, and every count takes
its widths as arguments, so that a compact layer's sliced widths and the
performer's needed input width can be given.

Operations are multiply-adds times two.  Bytes count each input read
once and each output written once (bf16 activations and weights, f32
LayerNorm parameters and statistics).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

# NVIDIA H100 SXM5 data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


class Work(NamedTuple):
    """One kernel call's work: the operations it must do (bf16 tensor
    core), its f32 operations outside the tensor cores, the bytes it must
    move, and the products it does again (never counted)."""

    flops: float
    bytes: float
    f32_flops: float = 0.0
    recompute: float = 0.0

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the
        operations' time (the bf16 and the f32 units side by side) and the
        bytes' time."""
        return max(self.flops / PEAK_BF16_FLOPS,
                   self.f32_flops / PEAK_F32_FLOPS,
                   self.bytes / PEAK_BYTES)

    def bound_by(self) -> str:
        t_ops = max(self.flops / PEAK_BF16_FLOPS,
                    self.f32_flops / PEAK_F32_FLOPS)
        return "operations" if t_ops >= self.bytes / PEAK_BYTES else "bytes"


def attention_fwd(b: int, n: int, dm: int, heads: int, dh: int = 64, *,
                  ln: bool = True) -> Work:
    """K1 (``ln``) and A7's forward: LayerNorm, qkv, the core, the
    projection with its residual."""
    da, rows = heads * dh, b * n
    act = rows * dm * 2
    nbytes = 2 * act + 2 * dm * 4 + (4 * da * dm + 3 * da + dm + da) * 2
    if not ln:
        nbytes -= 2 * dm * 4
    flops = 2 * rows * dm * 3 * da + 4 * b * heads * n * n * dh \
        + 2 * rows * da * dm
    return Work(flops, nbytes)


def attention_bwd(b: int, n: int, dm: int, heads: int, dh: int = 64, *,
                  ln: bool = True) -> Work:
    """A2 (``ln``) and A7's backward: d a_in and dWqkv, dWproj and dctx,
    the core's dv, dp, dq, dk; the qkv projection, the logits and P @ V
    are recomputed."""
    da, rows = heads * dh, b * n
    act = rows * dm * 2
    nbytes = 3 * act + 2 * (4 * da * dm + 3 * da + dm + da) * 2 + 4 * dm * 4
    if not ln:
        nbytes -= 4 * dm * 4
    flops = 2 * rows * dm * 3 * da * 2 + 2 * rows * dm * da * 2 \
        + 8 * b * heads * n * n * dh
    recompute = 2 * rows * dm * 3 * da + 4 * b * heads * n * n * dh
    return Work(flops, nbytes, recompute=recompute)


def mlp_fwd(b: int, n: int, dm: int, f: int, *, blend: bool = False) -> Work:
    """K2, and K3 with the block-gating blend (``blend``)."""
    rows = b * n
    act = rows * dm * 2
    nbytes = 2 * act + 2 * dm * 4 + (2 * dm * f + 2 * f + dm) * 2
    if blend:
        nbytes += act + 8
    return Work(4 * rows * dm * f, nbytes)


def mlp_bwd(b: int, n: int, dm: int, f: int, *, blend: bool = False) -> Work:
    """A6, and A4 with the blend (``blend``): dW2, dh, dW1, d a_in; fc1
    is recomputed."""
    rows = b * n
    act = rows * dm * 2
    nbytes = 3 * act + 2 * (2 * dm * f + f + dm + f) * 2 + 4 * dm * 4
    if blend:
        nbytes += 2 * act + 16
    return Work(8 * rows * dm * f, nbytes, recompute=2 * rows * dm * f)


def performer_fwd(b: int, n: int, dim: int, emb: int = 64,
                  m: int = 32) -> Work:
    """A10 / A11 forward, one token-performer stage on ``[b, n, dim]``:
    kqv, the random features of q and k (f32), k'v, y, proj, the MLP."""
    rows = b * n
    weights = (dim * 3 * emb + 3 * emb + 3 * emb * emb + 3 * emb) * 2 \
        + (2 * dim + 4 * emb + m * emb) * 4
    mm = 2 * rows * (3 * dim * emb + 2 * emb * m + 3 * emb * emb)
    nbytes = rows * dim * 2 + rows * emb * 2 + weights \
        + b * (emb * m + m) * 4
    return Work(mm, nbytes, f32_flops=2 * 2 * rows * emb * m)


def performer_bwd(b: int, n: int, dim: int, emb: int = 64,
                  m: int = 32, *, dx: bool = True) -> Work:
    """A10 / A11 backward; the forward's kqv, features, y and proj are
    recomputed.  Without ``dx`` (the stem's first stage, whose input is the
    image) the input gradient's product is not needed."""
    rows = b * n
    weights = (dim * 3 * emb + 3 * emb + 3 * emb * emb + 3 * emb) * 2 \
        + (2 * dim + 4 * emb + m * emb) * 4
    mm = 2 * rows * (6 * emb * emb + 6 * emb * m + 8 * dim * emb)
    if not dx:
        mm -= 2 * rows * 3 * emb * dim
    recompute = 2 * rows * (3 * dim * emb + emb * m + 2 * emb * emb)
    nbytes = 2 * rows * dim * 2 + rows * emb * 2 + 2 * weights \
        + b * (emb * m + m) * 4
    return Work(mm, nbytes, f32_flops=2 * 2 * rows * emb * m,
                recompute=recompute)


def core(b: int, heads: int, n: int, dh: int, kind: str) -> Work:
    """The attention core alone (A9 forward / backward, A8 with ctx)."""
    flops = {"fwd": 4, "bwd": 8, "bwd_ctx": 8}[kind] * b * heads * n * n * dh
    recompute = {"fwd": 0, "bwd": 2, "bwd_ctx": 4}[kind] * b * heads * n * n \
        * dh
    nbytes = {"fwd": 4, "bwd": 7, "bwd_ctx": 8}[kind] * b * heads * n * dh * 2
    return Work(flops, nbytes, recompute=recompute)


# ---------------------------------------------------------------------------
# model FLOPs (an image's forward; multiply-adds times two)
# ---------------------------------------------------------------------------


class BlockWidths(NamedTuple):
    """One block's widths as the work requires them: the heads whose
    q / k / v are computed, the attention columns that reach the
    projection, the MLP units."""

    heads: int
    proj_in: int
    units: int


def block_flops(n: int, dm: int, w: BlockWidths, dh: int = 64) -> float:
    """One transformer block at ``n`` tokens."""
    da = w.heads * dh
    return (2 * n * dm * 3 * da + 4 * n * n * da + 2 * n * w.proj_in * dm
            + 4 * n * dm * w.units)


def vit_stem_flops(cfg) -> float:
    """The DeiT patch embedding of one image."""
    return 2 * cfg.num_patches * cfg.patch_size ** 2 * cfg.in_chans \
        * cfg.embed_dim


def t2t_stem_flops(cfg) -> float:
    """The T2T stem of one image: two performer stages (their needed
    input widths, 147 and 576) and the projection of 9 x 64 features."""
    g0 = cfg.img_size // 4
    td = cfg.token_dim
    one = performer_fwd(1, g0 * g0, cfg.in_chans * 49, td, td // 2)
    two = performer_fwd(1, (g0 // 2) ** 2, td * 9, td, td // 2)
    proj = 2 * cfg.num_patches * td * 9 * cfg.embed_dim
    return one.flops + one.f32_flops + two.flops + two.f32_flops + proj


def forward_flops(cfg, n: int, blocks: Sequence[BlockWidths], *,
                  scorer: bool = False) -> float:
    """An image's forward: the stem, the token scorer (``scorer``), the
    ``blocks`` at ``n`` tokens and the classifier heads."""
    stem = (t2t_stem_flops(cfg) if cfg.tokens_type != "none"
            else vit_stem_flops(cfg))
    heads = (2 if cfg.distilled else 1) * 2 * cfg.embed_dim * cfg.num_classes
    score = 2 * cfg.num_patches * cfg.embed_dim if scorer else 0
    return stem + score + heads + sum(
        block_flops(n, cfg.embed_dim, w, cfg.head_size) for w in blocks)


def dense_blocks(cfg):
    """Every block at full width."""
    return [BlockWidths(cfg.num_heads, cfg.embed_dim, cfg.mlp_hidden)] \
        * cfg.depth
