"""Stage-2 fine-tuning at physically sliced widths (counterpart of
``uvc_tpu/train/compact_ft.py``).

The dense stage-2 step computes at dense widths and masks the pruned
coordinates away.  This module trains the sliced architecture instead:
the blocks the frozen gating skips are removed, the fully pruned heads'
q/k/v columns and proj rows are gathered out, and the kept MLP units are
gathered and padded to a multiple of 128, by the plan serving
compaction uses (``infer/compact.py::layer_plans``).  Each kept layer runs
the LN-fused sublayer kernels at its own widths: K1 / A2 with ``da = 64 *
hk`` below ``dm`` and K2 / A6 at the padded ``fk``.

On the kept coordinates the trajectory is the masked-dense one: a masked
coordinate's gradient is exactly zero in the dense step, so dropping it
changes neither the gradient nor the global norm of the clip; the
within-head v-mask stays on the activations (the kernels' ctx mask), so
the kept heads' q / k columns keep their dense gradients while the masked
v / proj coordinates get none; the padding slots start at zero with zero
gradients and moments, so they stay zero; and AdamW's decoupled decay is
the same on every leaf of both trees.

Checkpoints and eval stay in the dense layout: ``scatter_to_dense``
writes a compact tree back into the stage-1 parameter tree.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.infer.compact import _check_stack, _embed_vit, layer_plans
from uvc_tpu_torch.models import t2t_vit
from uvc_tpu_torch.models.vit import ForwardOutput, _layer_norm
from uvc_tpu_torch.ops.attention import fused_layer_attention_ln
from uvc_tpu_torch.ops.mlp import fused_mlp_ln
from uvc_tpu_torch.train.state import TrainHParams
from uvc_tpu_torch.train.step import _distilled_loss, _stage2_step
from uvc_tpu_torch.utils.profiler import span
from uvc_tpu_torch.utils.tree import tree_leaves, tree_map


class CompactMeta(NamedTuple):
    """The static plan of a compact training tree."""
    plans: tuple          # per kept layer, the dicts of ``layer_plans``
    block_keep: tuple     # [L] bool, the frozen stage-2 gating decision
    dims: tuple           # (num_heads, head_size, embed_dim, mlp_hidden)


_TOP_KEYS = ("patch_embed", "cls_token", "pos_embed", "norm", "head",
             "dist_token", "head_dist", "resnet", "t2t", "token_scorer",
             "patch_gating")


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def compact_train_tree(params: dict, masks: Dict[str, torch.Tensor],
                       cfg: ViTConfig, *,
                       block_keep: Optional[np.ndarray] = None):
    """The trainable compact tree ``{"layers": [...], "top": {...}}`` and
    its ``CompactMeta``, on the parameters' device.

    The leaves keep the parameters' dtype (f32 master weights; the forward
    casts per call, as ``vit.apply`` does), unlike serving's
    ``compact_model``, which builds its layers in the serving dtype.  The
    within-head v-mask is not folded into proj's rows: the forward applies
    it to the activations, so those rows keep exactly-zero gradients.  The
    fc1 / fc2 padding slots are exact zeros.  ``block_keep`` defaults to
    the frozen gating decision ``g1 > g0``.  The T2T architecture
    ablations raise, as in ``compact_model``."""
    _check_stack(cfg)
    blocks = params["blocks"]
    d = masks["attn"].shape[1]
    if block_keep is None:
        g = params["block_gating"].detach().cpu()
        block_keep = (g[:, 1] > g[:, 0]).numpy()
    block_keep = np.asarray(block_keep)
    plans = layer_plans(masks, cfg, block_keep=block_keep)

    layers = []
    for plan in plans:
        i = plan["layer_id"]
        dev = blocks["fc1"]["kernel"].device
        cols, sel3, units = (torch.as_tensor(plan[k], device=dev)
                             for k in ("cols", "sel3", "kept_units"))
        fk, nk = plan["fk"], len(plan["kept_units"])
        w1, b1, w2 = (blocks["fc1"]["kernel"][i], blocks["fc1"]["bias"][i],
                      blocks["fc2"]["kernel"][i])
        fc1 = w1.new_zeros((d, fk))
        fc1_b = b1.new_zeros((fk,))
        fc2 = w2.new_zeros((fk, d))
        if nk:
            fc1[:, :nk] = w1[:, units]
            fc1_b[:nk] = b1[units]
            fc2[:nk, :] = w2[units, :]
        layers.append({
            "ln1": _copy({k: v[i] for k, v in blocks["ln1"].items()}),
            "qkv": {"kernel": blocks["qkv"]["kernel"][i][:, sel3],
                    "bias": blocks["qkv"]["bias"][i][sel3]},
            "proj": {"kernel": blocks["proj"]["kernel"][i][cols, :],
                     "bias": blocks["proj"]["bias"][i].clone()},
            "ln2": _copy({k: v[i] for k, v in blocks["ln2"].items()}),
            "fc1": {"kernel": fc1, "bias": fc1_b},
            "fc2": {"kernel": fc2, "bias": blocks["fc2"]["bias"][i].clone()},
        })

    top = {k: _copy(params[k]) for k in _TOP_KEYS if k in params}
    meta = CompactMeta(
        plans=tuple({**p, "cols": tuple(int(c) for c in p["cols"]),
                     "sel3": tuple(int(c) for c in p["sel3"]),
                     "vmask": tuple(float(v) for v in p["vmask"]),
                     "kept_units": tuple(int(u) for u in p["kept_units"])}
                    for p in plans),
        block_keep=tuple(bool(b) for b in block_keep),
        dims=(cfg.num_heads, cfg.head_size, cfg.embed_dim, cfg.mlp_hidden))
    return {"layers": layers, "top": top}, meta


@functools.lru_cache(maxsize=256)
def _layer_masks(vmask: tuple, fk: int, dtype, device):
    """A kept layer's ctx mask (its v-mask) and all-ones hidden mask, made
    once per layer, dtype and device: a copy from the host every step
    would wait for the card's queue to drain."""
    return (torch.tensor(vmask, dtype=dtype, device=device),
            torch.ones(fk, dtype=dtype, device=device))


def apply_compact_ft(ctree: dict, meta: CompactMeta, x: torch.Tensor,
                     cfg: ViTConfig, *, dtype=torch.bfloat16,
                     token_ratio: Optional[float] = None) -> ForwardOutput:
    """Differentiable forward of the compact stage-2 model: the dense
    stage-2 forward (hard gating, masks) at the sliced widths.

    Each kept layer is ``fused_layer_attention_ln`` with its v-mask as the
    ctx mask and ``num_heads=hk``, then ``fused_mlp_ln`` with an all-ones
    ``[fk]`` mask.  ``token_ratio`` drops tokens physically by the
    deterministic top-k of the frozen scorer (the rule of ``vit.apply``
    with ``patch_physical`` and of serving's ``apply_compact``; ViT/DeiT
    only).  The T2T family runs its trainable stem (the performer kernels),
    the class token and the sinusoid positions.  The JAX function's
    ``remat`` has no counterpart: the sublayers' autograd Functions already
    save only each sublayer's input, which is what its remat policy
    keeps."""
    top = ctree["top"]
    eps = cfg.layer_norm_eps
    if cfg.tokens_type != "none":
        t = t2t_vit.embed(top, x, cfg, dtype)
    else:
        t = _embed_vit(top, x, cfg, dtype, token_ratio)

    scale = cfg.qk_scale if cfg.qk_scale is not None else cfg.head_size ** -0.5
    for blk, plan in zip(ctree["layers"], meta.plans):
        vmask, ones = _layer_masks(plan["vmask"], plan["fk"], dtype, t.device)
        t = fused_layer_attention_ln(
            t, blk["ln1"]["scale"], blk["ln1"]["bias"],
            blk["qkv"]["kernel"].to(dtype), blk["qkv"]["bias"].to(dtype),
            blk["proj"]["kernel"].to(dtype), blk["proj"]["bias"].to(dtype),
            vmask, num_heads=plan["hk"], scale=scale, eps=eps)
        t = fused_mlp_ln(
            t, blk["ln2"]["scale"], blk["ln2"]["bias"],
            blk["fc1"]["kernel"].to(dtype), blk["fc1"]["bias"].to(dtype),
            blk["fc2"]["kernel"].to(dtype), blk["fc2"]["bias"].to(dtype),
            ones, eps=eps)

    t = _layer_norm(t, top["norm"]["scale"], top["norm"]["bias"], eps)
    logits = t[:, 0].float() @ top["head"]["kernel"] + top["head"]["bias"]
    if cfg.distilled and "head_dist" in top:
        logits_kd = (t[:, 1].float() @ top["head_dist"]["kernel"]
                     + top["head_dist"]["bias"])
    else:
        logits_kd = logits
    return ForwardOutput(logits=logits, logits_kd=logits_kd,
                         token_mask=None)


@torch.no_grad()
def scatter_to_dense(ctree: dict, meta: CompactMeta,
                     dense_template: dict) -> dict:
    """Write the compact tree back into the dense stage-1 layout.

    The kept coordinates take the compact values; masked and padded
    coordinates and the dropped blocks keep the template's.  Returns a new
    tree on the template's device and in its dtypes; the template is left
    untouched."""
    dense = _copy(dense_template)
    blocks = dense["blocks"]
    dev = blocks["qkv"]["kernel"].device
    for blk, plan in zip(ctree["layers"], meta.plans):
        i = plan["layer_id"]
        sel3, cols, units = (torch.as_tensor(plan[k], device=dev,
                                             dtype=torch.long)
                             for k in ("sel3", "cols", "kept_units"))
        nk = len(plan["kept_units"])

        def put(name, leaf, value, index=None):
            dst = blocks[name][leaf][i]
            value = value.to(dev, dst.dtype)
            if index is None:
                dst.copy_(value)
            else:
                dst[index] = value

        for ln in ("ln1", "ln2"):
            put(ln, "scale", blk[ln]["scale"])
            put(ln, "bias", blk[ln]["bias"])
        put("qkv", "kernel", blk["qkv"]["kernel"], (slice(None), sel3))
        put("qkv", "bias", blk["qkv"]["bias"], sel3)
        put("proj", "kernel", blk["proj"]["kernel"], cols)
        put("proj", "bias", blk["proj"]["bias"])
        if nk:
            put("fc1", "kernel", blk["fc1"]["kernel"][:, :nk],
                (slice(None), units))
            put("fc1", "bias", blk["fc1"]["bias"][:nk], units)
            put("fc2", "kernel", blk["fc2"]["kernel"][:nk], units)
        put("fc2", "bias", blk["fc2"]["bias"])
    for k in _TOP_KEYS:
        if k in ctree["top"]:
            dense[k] = tree_map(
                lambda c, t: c.detach().to(t.device, t.dtype).clone(),
                ctree["top"][k], dense_template[k])
    return dense


def build_compact_stage2_step(cfg: ViTConfig, hp: MinimaxHParams,
                              thp: TrainHParams, meta: CompactMeta, *,
                              micro: bool = False, mesh=None):
    """The compact counterpart of ``build_stage2_step``, with its signature
    ``step(state, teacher_params, masks, x, labels, noise)``, so that a
    stage-2 training loop can swap it in: ``masks`` is accepted and
    ignored (the slicing enforces them); ``mesh`` a data-parallel rank's
    step, the compact tree replicated (it has no ``'blocks'`` leaf to
    shard; on a mesh with a model axis the dense teacher is gathered).
    Under ``hp.enable_patch_gating == 2`` the student drops tokens at
    ``hp.patch_ratio`` and the scorer's updates are zeroed (frozen
    architecture, as in the dense step)."""
    ratio = hp.patch_ratio if hp.enable_patch_gating == 2 else None

    def loss_fn(ctree, teacher_params, masks, x, targets, labels):
        with span("uvc.forward"):
            out = apply_compact_ft(ctree, meta, x, cfg,
                                   dtype=thp.compute_dtype,
                                   token_ratio=ratio)
        return _distilled_loss(out, x, targets, labels, teacher_params, cfg,
                               thp)

    frozen = (("top", "token_scorer"),) if ratio is not None else ()
    return _stage2_step(thp, loss_fn, frozen_updates=frozen, micro=micro,
                        mesh=mesh)


def compact_param_count(ctree: dict) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(ctree))
