"""The plain reference of UVC's stage-1 search step and stage-2 fine-tune
step: mixup, soft distillation, the global-norm clip, AdamW, and the
minimax architecture update of the UVC paper (prox on the bottom groups,
the primal steps of s and r against the FLOPs resource, the gating
interval step, dual ascent), in float32.

A frozen copy of the arithmetic the port's ``train/step.py``,
``compress/{minimax,masks,scores,resource,optim}.py``, ``ops/stes.py``,
``data/mixup.py`` and ``distill/losses.py`` implement, written over the
reference forward (``reference/model.py``); it imports nothing of the
program.  The gradient of a batch is summed over blocks of rows
(``chunk``), so that the float32 activations of a 512-image batch fit
beside nothing else on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from uvcbench.reference.model import Numerics, TokenChoice, forward


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def leaves(tree, prefix=""):
    """``[(path, tensor)]`` in a fixed order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def tmap(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# ---------------------------------------------------------------------------
# losses and mixup
# ---------------------------------------------------------------------------


def smooth_one_hot(labels, classes: int, smoothing: float):
    off = smoothing / classes
    on = 1.0 - smoothing + off
    return torch.nn.functional.one_hot(labels.long(), classes).float() \
        * (on - off) + off


def mix(x, labels, draw, thp) -> tuple:
    """timm's batch-mode Mixup / CutMix with one decision (``draw``: lam,
    use_blend, box), the partner of image i being image B-1-i; returns
    the images and the soft targets."""
    lam, use_blend, box = (t.to(x.device) for t in draw)
    t1 = smooth_one_hot(labels, thp["num_classes"], thp["smoothing"])
    x_flip, t2 = x.flip(0), t1.flip(0)
    out = torch.where(box[None, :, :, None], x_flip, x)
    out = torch.where(use_blend, lam * x + (1.0 - lam) * x_flip, out)
    return out, lam * t1 + (1.0 - lam) * t2


def loss_sum(logits, teacher_logits, targets, batch: int, thp):
    """This block of rows' share of the batch's loss: the soft-target
    cross-entropy's and the soft distillation's (KL times tau^2 over the
    number of logits of the whole batch), blended by alpha."""
    base = -(targets * torch.log_softmax(logits, dim=-1)).sum() / batch
    tau, alpha = thp["distillation_tau"], thp["distillation_alpha"]
    s_logp = torch.log_softmax(logits / tau, dim=-1)
    t_logp = torch.log_softmax(teacher_logits / tau, dim=-1)
    kl = (torch.exp(t_logp) * (t_logp - s_logp)).sum()
    distill = kl * tau * tau / (batch * logits.shape[-1])
    return base * (1.0 - alpha) + distill * alpha


def value_and_grad(params, teacher, x, targets, cfg, thp, num: Numerics,
                   chunk: int, student: Callable):
    """(loss, gradient tree) of the batch, summed over blocks of ``chunk``
    rows; ``student(params, rows)`` gives a block's logits."""
    names = [p for p, _ in leaves(params)]
    flat = dict(leaves(params))
    grads = {p: torch.zeros_like(t) for p, t in flat.items()}
    total = torch.zeros((), device=x.device)
    b = x.shape[0]
    for lo in range(0, b, chunk):
        rows = slice(lo, min(b, lo + chunk))
        with torch.no_grad():
            t_logits = forward(num, teacher, x[rows], cfg)
        live = {p: t.detach().requires_grad_() for p, t in flat.items()}
        tree = _unflatten(params, live)
        with torch.enable_grad():
            loss = loss_sum(student(tree, rows), t_logits, targets[rows], b,
                            thp)
            got = torch.autograd.grad(loss, [live[p] for p in names],
                                      allow_unused=True)
        for p, g in zip(names, got):
            if g is not None:
                grads[p] += g
        total += loss.detach()
    return total, _unflatten(params, grads)


def _unflatten(tree, flat: Dict[str, torch.Tensor], prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    return flat[prefix[:-1]]


def clip(grads, max_norm: float):
    total = torch.sqrt(sum((g * g).sum() for _, g in leaves(grads)))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return tmap(lambda g: g * scale, grads), total


def warmup_cosine(base: float, warmup: int, total: int) -> Callable:
    def lr(step: int) -> float:
        s = np.float32(step)
        if s < warmup:
            return float(np.float32(base) * s / np.float32(max(1, warmup)))
        prog = (s - warmup) / np.float32(max(1.0, total - warmup))
        return float(np.float32(base) * max(0.0, np.float32(
            0.5 * (1.0 + math.cos(math.pi * prog)))))
    return lr


@dataclasses.dataclass
class Adam:
    count: int
    mu: dict
    nu: dict


def adamw(grads, state: Adam, params, lr: float, thp, frozen=()):
    """optax's adamw (decoupled decay on every leaf); the updates of the
    leaves whose path holds a name of ``frozen`` are zero."""
    b1, b2, eps, wd = 0.9, 0.999, thp["opt_eps"], thp["weight_decay"]
    mu = tmap(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
    nu = tmap(lambda g, v: (1 - b2) * g * g + b2 * v, grads, state.nu)
    count = state.count + 1
    c = np.float32(count)
    bc1 = float(np.float32(1) - np.float32(b1) ** c)
    bc2 = float(np.float32(1) - np.float32(b2) ** c)
    new = {}
    for (path, p), (_, m), (_, v) in zip(leaves(params), leaves(mu),
                                         leaves(nu)):
        if any(f in path for f in frozen):
            new[path] = p
        else:
            new[path] = p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                                  + wd * p)
    return _unflatten(params, new), Adam(count, mu, nu)


# ---------------------------------------------------------------------------
# the minimax architecture update
# ---------------------------------------------------------------------------


class _Ceil(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        return torch.ceil(a)

    @staticmethod
    def backward(ctx, g):
        return g


class _LeastK(torch.autograd.Function):
    """The sum of the ceil(s) smallest scores; d/ds is the (k+1)-th
    smallest (the largest when k is all of them)."""

    @staticmethod
    def forward(ctx, s, scores):
        n = scores.shape[-1]
        srt = torch.sort(scores, dim=-1).values
        k = torch.clamp(torch.ceil(s), 0, n).long()
        idx = torch.arange(n, device=scores.device)
        ctx.save_for_backward(torch.gather(
            srt, -1, torch.clamp(k, max=n - 1)[..., None])[..., 0])
        return torch.where(idx < k[..., None], srt,
                           torch.zeros_like(srt)).sum(dim=-1)

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        return g * seed, None


class _Clamp(torch.autograd.Function):
    """clamp whose gradient passes on the boundary too."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward((x >= lo) & (x <= hi))
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return torch.where(inside, g, torch.zeros_like(g)), None, None


def bottom_k(scores, k) -> torch.Tensor:
    order = torch.argsort(scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < torch.as_tensor(k, device=scores.device)[..., None]


def group_scores(blocks: dict, heads: int):
    pk = blocks["proj"]["kernel"].detach()
    l, d, _ = pk.shape
    s1 = (pk * pk).sum(dim=-1).reshape(l, heads, d // heads)
    f2 = blocks["fc2"]["kernel"].detach()
    return s1, s1.sum(dim=-1), (f2 * f2).sum(dim=-1)


def macs_table(cfg) -> dict:
    """UVC's MACs accounting at batch 1 (the resource's table): the stem
    and, per block, (qkv + q k^T, attn v + proj, fc1 + fc2)."""
    d, n, f = cfg.embed_dim, cfg.seq_len, cfg.mlp_hidden
    if cfg.tokens_type == "none":
        embed = float(cfg.num_patches * d * cfg.patch_size ** 2
                      * cfg.in_chans)
    else:
        g, emb = cfg.img_size // 4, cfg.token_dim
        m = int(emb * 0.5)
        embed = 0.0
        for t, dim in ((g * g, cfg.in_chans * 49), ((g // 2) ** 2, emb * 9)):
            embed += (t * dim * 3 * emb + (t * emb + emb * t * emb) * 2
                      + t * m + t * emb * m + t * m * emb + t * emb * emb
                      + t * emb * emb + emb * emb * emb)
    row = [3 * d * n * d, n * n * d, n * n * d, n * d * d, f * n * d,
           d * n * f]
    return {"embed": embed, "m01": float(row[0] + row[1]),
            "m23": float(row[2] + row[3]), "m45": float(row[4] + row[5]),
            "dense": 2.0 * (embed + cfg.depth * float(sum(row)))}


def flops_fraction(s, r, scores2, distrib1, table, cfg):
    hs, d = cfg.head_size, cfg.embed_dim
    sc, rc = _Ceil.apply(s), _Ceil.apply(r)
    s_ratio = _Clamp.apply(torch.stack(
        [(u - sc[:, i]) / u for i, u in
         enumerate((float(cfg.num_heads), float(cfg.mlp_hidden)))], dim=-1),
        0.0, 1.0)
    pruned = bottom_k(scores2, torch.ceil(s[:, 0].detach()).long())
    keep = d - sc[:, 0] * hs - torch.where(pruned, torch.zeros_like(rc),
                                           rc).sum(dim=-1)
    r_ratio = _Clamp.apply(keep / d, 0.0, 1.0)
    per = (table["m01"] * s_ratio[:, 0] + table["m23"] * r_ratio
           + table["m45"] * s_ratio[:, 1])
    return 2.0 * (table["embed"] + (distrib1 * per).sum()) / table["dense"]


def gumbel_soft(noise, logits, tau: float = 0.5):
    return torch.softmax((logits + noise) / tau, dim=-1)


def prox(params, s, r, y, p, lr: float, cfg):
    s1, s2, s3 = group_scores(params["blocks"], cfg.num_heads)
    l = s2.shape[0]
    one = torch.ones((), device=s.device)
    shrink_r = torch.where(bottom_k(s1, torch.ceil(r).long()),
                           1.0 / (1.0 + 2.0 * lr * p[..., None]), one)
    shrink_s = torch.where(bottom_k(s2, torch.ceil(s[:, 0]).long())[..., None],
                           1.0 / (1.0 + 2.0 * lr * y[:, 0][:, None, None]),
                           one)
    col = (shrink_r * shrink_s).reshape(l, cfg.embed_dim)
    unit = torch.where(bottom_k(s3, torch.ceil(s[:, 1]).long()),
                       1.0 / (1.0 + 2.0 * lr * y[:, 1][:, None]), one)
    blocks = dict(params["blocks"])
    blocks["proj"] = dict(blocks["proj"],
                          kernel=blocks["proj"]["kernel"] * col[:, :, None])
    blocks["fc2"] = dict(blocks["fc2"],
                         kernel=blocks["fc2"]["kernel"] * unit[:, :, None])
    return dict(params, blocks=blocks)


def _box_step(x, grad, mom, lr: float, ub):
    """The boundary clamps, the inf-norm clip to 1, one plain SGD step and
    the box [0, ub - 1]."""
    x_max = torch.clamp(ub - 1.0 - 1e-8, min=0.0)
    over, under = x >= x_max, x <= 0.0
    grad = torch.where(over, torch.clamp(grad, min=0.0), grad)
    grad = torch.where(under, torch.clamp(grad, max=0.0), grad)
    grad = grad * torch.clamp(1.0 / (grad.abs().max() + 1e-6), max=1.0)
    new = x - lr * grad
    return torch.where(over, x_max, torch.clamp(new, min=0.0)), mom


def arch_update(params, cs: dict, res1, res2, step: int, gating_grad,
                lr: float, hp: dict, cfg, table):
    """One minimax update after the weights' step (the search phase, block
    gating on, s and r stepped by plain SGD); returns (params, cs)."""
    dev = cs["s"].device
    s_ub = torch.stack([torch.full((cfg.depth,), float(v), device=dev)
                        for v in (cfg.num_heads, cfg.mlp_hidden)], dim=-1)
    r_ub = torch.full((cfg.depth, cfg.num_heads), float(cfg.head_size),
                      device=dev)
    with torch.no_grad():
        params = prox(params, _Ceil.apply(cs["s"]), _Ceil.apply(cs["r"]),
                      cs["y"], cs["p"], lr, cfg)
        s1, s2, s3 = group_scores(params["blocks"], cfg.num_heads)
    gating = params["block_gating"]

    def resource(noise, s, r, g):
        d1 = gumbel_soft(noise, g)[:, 1]
        return flops_fraction(s, r, s2, d1, table, cfg)

    with torch.enable_grad():
        s = cs["s"].detach().requires_grad_()
        r = cs["r"].detach().requires_grad_()
        sc, rc = _Ceil.apply(s), _Ceil.apply(r)
        sloss = (cs["y"][:, 0] @ _LeastK.apply(sc[:, 0], s2)
                 + cs["y"][:, 1] @ _LeastK.apply(sc[:, 1], s3))
        rloss = (cs["p"] * _LeastK.apply(rc, s1)).sum()
        s_g1 = torch.autograd.grad(sloss, s)[0] + hp["sl2wd"] * cs["s"] / s_ub
        r_g1 = torch.autograd.grad(rloss, r)[0] + hp["sl2wd"] * cs["r"] / r_ub
        s = cs["s"].detach().requires_grad_()
        r = cs["r"].detach().requires_grad_()
        g = gating.detach().requires_grad_()
        excess = _Clamp.apply(resource(res1, s, r, g) - hp["budget"],
                              -hp["z_grad_clip"], hp["z_grad_clip"])
        s_g2, r_g2, g_g2 = torch.autograd.grad(excess, (s, r, g))
    with torch.no_grad():
        z = cs["z"]
        cs = dict(cs)
        g_grad = gating_grad + z * hp["gating_weight"] * g_g2
        accum = cs["gating_accum"] + g_grad * float(
            step % hp["gating_interval"])
        if (step + 1) % hp["gating_interval"] == 0:
            buf = 0.9 * cs["gating_mom"] + accum / hp["gating_interval"] \
                + 1e-4 * gating
            params = dict(params, block_gating=gating - hp["glr"] * buf)
            cs["gating_mom"], accum = buf, torch.zeros_like(accum)
        cs["gating_accum"] = accum
        s_new, _ = _box_step(cs["s"], s_g1 + z * s_g2, None, hp["slr"], s_ub)
        r_new, _ = _box_step(cs["r"], r_g1 + z * r_g2, None, hp["rlr"], r_ub)
        sc, rc = torch.ceil(s_new), torch.ceil(r_new)
        least_s = torch.stack([_LeastK.apply(sc[:, 0], s2),
                               _LeastK.apply(sc[:, 1], s3)], dim=-1)
        cs["y"] = torch.clamp(cs["y"] + hp["ylr"] * least_s, min=0.0)
        cs["p"] = torch.clamp(cs["p"] + hp["plr"] * _LeastK.apply(rc, s1),
                              min=0.0)
        excess = resource(res2, s_new, r_new, params["block_gating"]) \
            - hp["budget"]
        cs["z"] = torch.clamp(z + cs["zlr"] * excess, min=0.0)
        cs["s"], cs["r"] = s_new, r_new
    return params, cs


def init_cstate(cfg, hp: dict, device) -> dict:
    def full(shape, v):
        return torch.full(shape, float(v), device=device)
    l, h = cfg.depth, cfg.num_heads
    return {"s": full((l, 2), 0), "r": full((l, h), 0),
            "y": full((l, 2), hp["y_init"]), "p": full((l, h), hp["p_init"]),
            "z": full((), hp["z_init"]), "zlr": full((), hp["zlr"]),
            "gating_accum": full((l, 2), 0), "gating_mom": full((l, 2), 0)}


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


class Trace(NamedTuple):
    """What the reference gives to judge the program's first steps."""

    losses: List[float]
    grad: dict          # the first step's clipped gradient tree
    params: dict        # after the last step
    cstate: Optional[dict]


# the search the reference implements: plain SGD on s and r, the Gumbel
# block gating on, the MACs-table resource, pruning on
SEARCH = {"soptim": "sgd", "roptim": "sgd", "use_gumbel": True,
          "enable_block_gating": True, "enable_part_gating": False,
          "enable_jumping": False, "enable_pruning": True,
          "flops_with_mhsa": True, "enable_patch_gating": 2,
          "mixup_mode": "batch"}


def stage1(params, teacher, batches, noises, cfg, hp: dict, thp: dict,
           num: Numerics, chunk: int) -> Trace:
    """The stage-1 search steps over ``batches`` ``[(x, labels)]`` with
    ``noises`` (each: mixup draw, gate, token, res1, res2 noise) from the
    initial state: fresh AdamW, the minimax state at its start."""
    given = {**thp, **hp}
    for key, want in SEARCH.items():
        if given.get(key, want) != want:
            raise ValueError(f"the reference search step has {key}={want!r}, "
                             f"not {given[key]!r}")
    lr_fn = warmup_cosine(thp["learning_rate"], thp["warmup_steps"],
                          thp["t_total"])
    opt = Adam(0, tmap(torch.zeros_like, params), tmap(torch.zeros_like,
                                                       params))
    cs = init_cstate(cfg, hp, batches[0][0].device)
    table = macs_table(cfg)
    losses, first = [], None
    for step, ((x, labels), nz) in enumerate(zip(batches, noises)):
        x, targets = mix(x, labels, nz["mixup"], thp)

        def student(tree, rows):
            gating = gumbel_soft(nz["gate"], tree["block_gating"])
            tokens = TokenChoice("gumbel", hp["patch_ratio"],
                                 nz["token"][rows], nz["tau"])
            return forward(num, tree, x[rows], cfg, gating=gating,
                           tokens=tokens)

        loss, grads = value_and_grad(params, teacher, x, targets, cfg, thp,
                                     num, chunk, student)
        with torch.no_grad():
            grads, _ = clip(grads, thp["max_grad_norm"])
            first = grads if first is None else first
            params, opt = adamw(grads, opt, params, lr_fn(opt.count), thp,
                                frozen=("prm_w",))
        params, cs = arch_update(params, cs, nz["res1"], nz["res2"], step,
                                 grads["block_gating"], lr_fn(step), hp, cfg,
                                 table)
        losses.append(float(loss))
    return Trace(losses, first, params, cs)


def stage2(params, teacher, masks, batches, noises, cfg, hp: dict,
           thp: dict, num: Numerics, chunk: int) -> Trace:
    """The stage-2 fine-tune steps: the masks on the activations, the block
    gating frozen to its hard decision, the frozen scorer's token drop;
    the gating's gradient zeroed before the clip, its updates and the
    scorer's after AdamW."""
    lr_fn = warmup_cosine(thp["learning_rate"], thp["warmup_steps"],
                          thp["t_total"])
    opt = Adam(0, tmap(torch.zeros_like, params), tmap(torch.zeros_like,
                                                       params))
    g = params["block_gating"]
    keep = (g[:, 1] > g[:, 0]).float()
    gating = torch.stack([1.0 - keep, keep], dim=-1)
    losses, first = [], None
    for (x, labels), nz in zip(batches, noises):
        x, targets = mix(x, labels, nz["mixup"], thp)

        def student(tree, rows):
            return forward(num, tree, x[rows], cfg, gating=gating,
                           masks=masks,
                           tokens=TokenChoice("drop", hp["patch_ratio"]))

        loss, grads = value_and_grad(params, teacher, x, targets, cfg, thp,
                                     num, chunk, student)
        with torch.no_grad():
            grads = dict(grads, block_gating=torch.zeros_like(
                grads["block_gating"]))
            grads, _ = clip(grads, thp["max_grad_norm"])
            first = grads if first is None else first
            params, opt = adamw(grads, opt, params, lr_fn(opt.count), thp,
                                frozen=("prm_w", "block_gating",
                                        "token_scorer"))
        losses.append(float(loss))
    return Trace(losses, first, params, None)
