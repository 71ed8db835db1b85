"""The minimax architecture update (counterpart of
``uvc_tpu/compress/minimax.py``).

One ``arch_update`` call, after the weight optimizer's step:

  1. prox on the weights (shrink the bottom groups by the dual factor);
  2. primal gradients of s and r: grad(loss1) + z * grad(resource), the
     resource excess clamped to +-z_grad_clip before differentiation with
     ``torch_clamp``'s boundary-inclusive gradient;
  3. the block-gating gradient accumulated with weight ``step % interval``
     and the SGD-momentum step every ``gating_interval`` steps;
  4. boundary clamps, the inf-norm clip to 1, the s / r optimizer steps
     and the box clamps;
  5. dual ascent on (y, p, z) from the post-step s / r, then the
     projection onto >= 0.

In warmup only the prox runs and the resource is reported; with pruning
off only the dual-z ascent runs.  The JAX package's ``jax.grad`` calls
are ``torch.autograd.grad`` here, through ``utils/profiler.py::
grad_in_span``, so that their backward carries the caller's
``uvc.arch_update`` span in a trace.  The resource's Gumbel draws come in as
``noise = (res1, res2)`` ``[L, 2]`` tensors: ``res1`` is used twice (the
reported resource and the primal gradient), ``res2`` once (the z ascent),
as the JAX package uses its keys.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from uvc_tpu_torch.compress import optim
from uvc_tpu_torch.compress.masks import prox_weights
from uvc_tpu_torch.compress.resource import (MacsTable, flops2_fraction,
                                             flops_fraction)
from uvc_tpu_torch.compress.scores import group_scores
from uvc_tpu_torch.compress.state import (CompressionState, MinimaxHParams)
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.ops.gumbel import block_gating_distrib
from uvc_tpu_torch.ops.stes import least_k_sum, ste_ceil, torch_clamp
from uvc_tpu_torch.utils.profiler import grad_in_span


def init_compression_state(cfg: ViTConfig, hp: MinimaxHParams,
                           device="cuda") -> CompressionState:
    """The initial minimax state on ``device`` (the card unless the caller
    asks for the CPU; raises when CUDA is asked for and absent)."""
    l, h = cfg.depth, cfg.num_heads
    device = resolve_device(device)

    def full(shape, v):
        return torch.full(shape, float(v), dtype=torch.float32,
                          device=device)

    s, r = full((l, 2), 0.0), full((l, h), 0.0)
    return CompressionState(
        s=s, r=r, y=full((l, 2), hp.y_init), p=full((l, h), hp.p_init),
        z=full((), hp.z_init), eps=full((), hp.eps),
        zlr=full((), float(hp.zlr_schedule[0])),
        gating_accum=full((l, 2), 0.0),
        s_opt=optim.init_opt_state(hp.soptim, s),
        r_opt=optim.init_opt_state(hp.roptim, r),
        gating_opt=optim.init_opt_state("sgd", full((l, 2), 0.0)))


def s_r_upper_bounds(cfg: ViTConfig, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """s_ub = [H, d_ff] per layer, r_ub = head_size, on ``device``."""
    device = resolve_device(device)
    s_ub = torch.stack(
        [torch.full((cfg.depth,), float(v), device=device)
         for v in (cfg.num_heads, cfg.mlp_hidden)], dim=-1)
    r_ub = torch.full((cfg.depth, cfg.num_heads), float(cfg.head_size),
                      device=device)
    return s_ub, r_ub


def _loss1_grads(cstate: CompressionState, scores1, scores2, scores3,
                 s_ub, r_ub, sl2wd: float):
    """Gradients of sloss1 / rloss1 (the dual-weighted bottom-k score
    sums) plus the optional l2 pull toward zero."""
    y, p = cstate.y.detach(), cstate.p.detach()
    s = cstate.s.detach().requires_grad_()
    r = cstate.r.detach().requires_grad_()
    sc, rc = ste_ceil(s), ste_ceil(r)
    sloss = (y[:, 0] @ least_k_sum(sc[:, 0], scores2)
             + y[:, 1] @ least_k_sum(sc[:, 1], scores3))
    rloss = (p * least_k_sum(rc, scores1)).sum()
    (s_grad,) = grad_in_span(sloss, s)
    (r_grad,) = grad_in_span(rloss, r)
    return (s_grad + sl2wd * (cstate.s / s_ub),
            r_grad + sl2wd * (cstate.r / r_ub))


def _resource(noise, s, r, gating, scores2, eps, table, cfg, hp, *,
              gumbel_hard: bool):
    """One stochastic evaluation of the FLOPs fraction (the W1/W3 cost
    instead with ``flops_with_mhsa=False``, which ignores gating)."""
    if not hp.flops_with_mhsa:
        return flops2_fraction(ste_ceil(s), ste_ceil(r), scores2, cfg)
    if hp.enable_block_gating and gating is not None:
        distrib = block_gating_distrib(
            noise, gating, use_gumbel=hp.use_gumbel, gumbel_hard=gumbel_hard,
            eps=eps, warmup=False)[:, 1]
    else:
        distrib = 1.0
    return flops_fraction(ste_ceil(s), ste_ceil(r), scores2, distrib, table,
                          cfg)


def _inf_norm_clip(g: torch.Tensor, max_norm: float = 1.0) -> torch.Tensor:
    """torch ``clip_grad_norm_(_, max_norm, inf)``."""
    coef = torch.clamp(max_norm / (g.abs().max() + 1e-6), max=1.0)
    return g * coef


def _box_step(kind, x, grad, state, lr, ub):
    """Boundary-aware clamps, the inf-norm clip, one optimizer step and
    the box [0, ub - 1]."""
    x_max = torch.clamp(ub - 1.0 - 1e-8, min=0.0)
    over, under = x >= x_max, x <= 0.0
    grad = torch.where(over, torch.clamp(grad, min=0.0), grad)
    grad = torch.where(under, torch.clamp(grad, max=0.0), grad)
    new, state = optim.opt_step(kind, x, _inf_norm_clip(grad), state, lr)
    new = torch.where(over, x_max, torch.clamp(new, min=0.0))
    return new, state


def arch_update(params: dict, cstate: CompressionState, *,
                noise: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
                step: int, gating_loss_grad: Optional[torch.Tensor],
                main_lr, hp: MinimaxHParams, cfg: ViTConfig,
                table: MacsTable, warmup: bool, gumbel_hard: bool
                ) -> Tuple[dict, CompressionState, Dict[str, torch.Tensor]]:
    """One architecture update; returns (params', cstate', metrics).

    ``params`` already carry this step's weight update; the prox runs on
    them first.  ``step`` is the train step before this update."""
    res1, res2 = noise
    dev = cstate.s.device
    s_ub, r_ub = s_r_upper_bounds(cfg, dev)
    with torch.no_grad():
        if hp.enable_pruning:
            params = prox_weights(params, ste_ceil(cstate.s),
                                  ste_ceil(cstate.r), cstate.y, cstate.p,
                                  main_lr, cfg)
        scores1, scores2, scores3 = group_scores(params["blocks"],
                                                 cfg.num_heads)
        gating = (params.get("block_gating") if hp.enable_block_gating
                  else None)
        res_kw = dict(scores2=scores2, eps=cstate.eps, table=table, cfg=cfg,
                      hp=hp, gumbel_hard=gumbel_hard)
        metrics = {"resource": _resource(res1, cstate.s, cstate.r, gating,
                                         **res_kw)}
    if warmup:
        return params, cstate, metrics
    if not hp.enable_pruning:
        with torch.no_grad():
            z_excess = _resource(res2, cstate.s, cstate.r, gating,
                                 **res_kw) - hp.budget
            z = torch.clamp(cstate.z + cstate.zlr * z_excess, min=0.0)
        return params, cstate.replace(z=z), metrics

    # ---- primal gradients ----------------------------------------------
    with torch.enable_grad():
        s_grad1, r_grad1 = _loss1_grads(cstate, scores1, scores2, scores3,
                                        s_ub, r_ub, hp.sl2wd)
        s = cstate.s.detach().requires_grad_()
        r = cstate.r.detach().requires_grad_()
        g = None if gating is None else gating.detach().requires_grad_()
        excess = torch_clamp(_resource(res1, s, r, g, **res_kw) - hp.budget,
                             -hp.z_grad_clip, hp.z_grad_clip)
        wrt = (s, r) if g is None else (s, r, g)
        grads = grad_in_span(excess, wrt, allow_unused=True)
    s_grad2, r_grad2 = grads[0], grads[1]
    g_grad_resource = None
    if g is not None:
        g_grad_resource = (grads[2] if grads[2] is not None
                           else torch.zeros_like(g))

    with torch.no_grad():
        z = cstate.z.detach()
        s_grad = s_grad1 + z * s_grad2
        r_grad = r_grad1 + z * r_grad2

        # ---- gating interval update --------------------------------------
        gating_accum, gating_opt = cstate.gating_accum, cstate.gating_opt
        if gating is not None and gating_loss_grad is not None:
            g_grad = gating_loss_grad + z * hp.gating_weight * g_grad_resource
            # each window step's grad weighted by step % interval
            accum = gating_accum + g_grad * float(step % hp.gating_interval)
            if (step + 1) % hp.gating_interval == 0:
                gating_new, gating_opt = optim.opt_step(
                    "sgd", gating, accum / hp.gating_interval, gating_opt,
                    hp.glr, momentum=0.9, weight_decay=1e-4)
                gating_accum = torch.zeros_like(accum)
                params = dict(params, block_gating=gating_new)
            else:
                gating_accum = accum

        # ---- s / r steps ---------------------------------------------------
        s_new, s_opt = _box_step(hp.soptim, cstate.s, s_grad, cstate.s_opt,
                                 hp.slr, s_ub)
        r_new, r_opt = _box_step(hp.roptim, cstate.r, r_grad, cstate.r_opt,
                                 hp.rlr, r_ub)

        # ---- dual ascent on the post-step primal values --------------------
        sc, rc = torch.ceil(s_new), torch.ceil(r_new)
        least_s = torch.stack([least_k_sum(sc[:, 0], scores2),
                               least_k_sum(sc[:, 1], scores3)], dim=-1)
        least_r = least_k_sum(rc, scores1)
        y_new = torch.clamp(cstate.y + hp.ylr * least_s, min=0.0)
        p_new = torch.clamp(cstate.p + hp.plr * least_r, min=0.0)
        gating_for_z = (params.get("block_gating") if gating is not None
                        else None)
        z_excess = _resource(res2, s_new, r_new, gating_for_z,
                             **res_kw) - hp.budget
        z_new = torch.clamp(cstate.z + cstate.zlr * z_excess, min=0.0)

    cstate = cstate.replace(s=s_new, r=r_new, y=y_new, p=p_new, z=z_new,
                            gating_accum=gating_accum, s_opt=s_opt,
                            r_opt=r_opt, gating_opt=gating_opt)
    metrics["z"] = z_new
    return params, cstate, metrics
