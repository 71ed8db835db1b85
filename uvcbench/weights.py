"""Weights, images and architectures made by the benchmark from the seed.

Everything a run hands to the program and to the reference is made here,
on the run's device, in a few large calls of one ``torch.Generator``:
the parameter tree in the port's layout (``models/vit.py::init_tree``,
``models/t2t_vit.py::init_tree``; a CPU test holds the two layouts
equal), the ring of input batches, and the kept coordinates of a
configuration's compressed architecture.  The sizes come from the
configuration file alone, so every seed gets the same shapes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from uvcbench.flops import BlockWidths

# standard deviation of the weights and tokens (timm's DeiT init) and of
# the biases and LayerNorm offsets; the heads are random, not zero, so
# that the logits and every gradient are nonzero from the first step
STD = 0.02


class _Draw:
    """Hands out slices of one standard-normal draw, cut at 2 standard
    deviations as a truncated normal is.  Without a generator it only
    counts what is asked of it (and hands out meta tensors)."""

    def __init__(self, gen=None, count: int = 0, device=None):
        self.flat = None if gen is None else torch.randn(
            count, generator=gen, device=device,
            dtype=torch.float32).clamp_(-2.0, 2.0)
        self.at = 0

    def take(self, shape, std=STD, mean=0.0) -> torch.Tensor:
        n = math.prod(shape)
        self.at += n
        if self.flat is None:
            return torch.empty(shape, device="meta")
        return self.flat[self.at - n:self.at].view(shape) * std + mean


def _linear(d: _Draw, lead, fan_in: int, fan_out: int) -> dict:
    return {"kernel": d.take((*lead, fan_in, fan_out)),
            "bias": d.take((*lead, fan_out))}


def _ln(d: _Draw, lead, dim: int) -> dict:
    return {"scale": d.take((*lead, dim), mean=1.0),
            "bias": d.take((*lead, dim))}


def _gating(depth: int, device) -> torch.Tensor:
    """The port's initial gating logits: (skip, keep) = (-1, 1)."""
    return torch.tensor([-1.0, 1.0], device=device).repeat(depth, 1)


def _performer(d: _Draw, gen, dim: int, emb: int, device) -> dict:
    """A token-performer stage; its random features ``prm_w`` are
    orthogonal rows scaled by sqrt(m), as the port initialises them."""
    m = emb // 2
    if gen is None:
        prm = torch.empty((m, emb), device="meta")
    else:
        q, _ = torch.linalg.qr(torch.randn((emb, m), generator=gen,
                                           device=device))
        prm = q.T.contiguous() * math.sqrt(m)
    return {"kqv": _linear(d, (), dim, 3 * emb),
            "proj": _linear(d, (), emb, emb),
            "norm1": _ln(d, (), dim), "norm2": _ln(d, (), emb),
            "mlp_fc1": _linear(d, (), emb, emb),
            "mlp_fc2": _linear(d, (), emb, emb),
            "prm_w": prm}


def _build(cfg, d: _Draw, gen, device) -> dict:
    dm, depth, f = cfg.embed_dim, cfg.depth, cfg.mlp_hidden
    lead = (depth,)
    params = {
        "cls_token": d.take((1, 1, dm)),
        "blocks": {"ln1": _ln(d, lead, dm),
                   "qkv": _linear(d, lead, dm, 3 * dm),
                   "proj": _linear(d, lead, dm, dm),
                   "ln2": _ln(d, lead, dm),
                   "fc1": _linear(d, lead, dm, f),
                   "fc2": _linear(d, lead, f, dm)},
        "norm": _ln(d, (), dm),
        "head": _linear(d, (), dm, cfg.num_classes),
        "block_gating": _gating(depth, device),
        "attn_gating": _gating(depth, device),
        "mlp_gating": _gating(depth, device),
    }
    if cfg.tokens_type != "none":
        td = cfg.token_dim
        params["t2t"] = {
            "attention1": _performer(d, gen, cfg.in_chans * 49, td, device),
            "attention2": _performer(d, gen, td * 9, td, device),
            "project": _linear(d, (), td * 9, dm)}
    else:
        p = cfg.patch_size
        params["patch_embed"] = {"kernel": d.take((p, p, cfg.in_chans, dm)),
                                 "bias": d.take((dm,))}
        params["pos_embed"] = d.take((1, cfg.seq_len, dm))
        params["token_scorer"] = _linear(d, (), dm, 1)
    return params


def make_params(cfg, gen: torch.Generator, device) -> dict:
    """A parameter tree of ``cfg`` in the port's layout, f32 on
    ``device``: one draw for every weight, one for each performer's
    random features."""
    if cfg.distilled or cfg.hybrid or cfg.cls_attn_layers:
        raise ValueError(f"{cfg.name}: no layout here for distilled, hybrid "
                         "or CaiT models")
    count = _Draw()
    _build(cfg, count, None, "cpu")
    return _build(cfg, _Draw(gen, count.at, device), gen, device)


def make_batches(cfg, gen: torch.Generator, ring: int, batch: int, device,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ring`` batches of ``batch`` distinct NHWC images and their labels:
    normalised f32 images (``dtype`` float), or uint8 pixels."""
    shape = (ring, batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    if dtype == torch.uint8:
        x = torch.randint(0, 256, shape, generator=gen, device=device,
                          dtype=torch.uint8)
    else:
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    y = torch.randint(0, cfg.num_classes, (ring, batch), generator=gen,
                      device=device)
    return x, y


# ---------------------------------------------------------------------------
# a configuration's compressed architecture
# ---------------------------------------------------------------------------


def arch_layout(cfg, arch: dict) -> List[dict]:
    """Each block's widths as the configuration file states them:
    ``{"keep": bool, "heads": kept heads, "dims_pruned": pruned dims in
    each kept head, "units": kept MLP units}``."""
    skip = set(arch["skip"])
    out = []
    for i in range(cfg.depth):
        heads, pruned, units = (arch["heads"][i], arch["dims_pruned"][i],
                                arch["units"][i])
        if not (1 <= heads <= cfg.num_heads and 0 <= pruned < cfg.head_size
                and 1 <= units <= cfg.mlp_hidden):
            raise ValueError(f"block {i}: widths {heads}, {pruned}, {units} "
                             f"out of range")
        out.append({"keep": i not in skip, "heads": heads,
                    "dims_pruned": pruned, "units": units})
    return out


def make_masks(cfg, arch: dict, gen: torch.Generator, device
               ) -> Dict[str, torch.Tensor]:
    """The masks ``{"attn": [L, D], "mlp": [L, F]}`` (0 / 1, f32) of the
    architecture, with the kept heads, dims and units drawn from ``gen``:
    the counts are the file's, only the coordinates vary by seed."""
    hs, h = cfg.head_size, cfg.num_heads
    attn = torch.zeros(cfg.depth, h, hs, device=device)
    mlp = torch.zeros(cfg.depth, cfg.mlp_hidden, device=device)
    for i, blk in enumerate(arch_layout(cfg, arch)):
        heads = torch.randperm(h, generator=gen, device=device)[:blk["heads"]]
        for hh in heads.tolist():
            dims = torch.randperm(hs, generator=gen, device=device)
            attn[i, hh, dims[blk["dims_pruned"]:]] = 1.0
        units = torch.randperm(cfg.mlp_hidden, generator=gen,
                               device=device)[:blk["units"]]
        mlp[i, units] = 1.0
    return {"attn": attn.reshape(cfg.depth, cfg.embed_dim), "mlp": mlp}


def gate_blocks(params: dict, cfg, arch: dict) -> dict:
    """``params`` with the gating logits of the skipped blocks set to
    (skip, keep) = (1, -1): the frozen decision ``g1 > g0`` skips them."""
    g = params["block_gating"].clone()
    for i in arch["skip"]:
        g[i] = torch.tensor([1.0, -1.0], device=g.device)
    return dict(params, block_gating=g)


def arch_blocks(cfg, arch: dict):
    """The kept blocks' widths for the FLOPs count (``flops.BlockWidths``):
    a pruned dim's projection row does no needed work."""
    return [BlockWidths(b["heads"], b["heads"] * (cfg.head_size
                                                  - b["dims_pruned"]),
                        b["units"])
            for b in arch_layout(cfg, arch) if b["keep"]]
