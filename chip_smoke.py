#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uvc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit on failure:

1. device  -- the card's name and power limit; exits 1 without CUDA.
2. build   -- compiles the hand-written kernels (``uvc_tpu_torch/csrc``).
3. kernels -- each kernel against its plain PyTorch version on the card,
   at the shapes the serving paths give it (B=64, dm=384: "eval", the
   masked-dense eval step after the token drop, N=138, 6 heads, F=1536;
   "compact", the compacted layers, N=138, 3 heads, F=768) and at the
   dense shape without the token drop (N=197, 6 heads, F=1536), with its
   time, the plain version's, one PyTorch library composition's (a
   yardstick only) and the least time the card could take.
4. serving -- DeiT-Small at full width with seeded random weights and a
   seeded discovered architecture (3 of 6 heads, random within-head dims
   and half the MLP units pruned; 2 of 12 blocks gated off): 5 passes
   over 8 request batches of 64 images through ``compact_model`` +
   ``apply_compact`` (token ratio 0.7) and through ``eval_step``, timed
   as one window, counting kernel launches;
   then compact vs masked-dense logits, device time by kernel for one
   batch of each path (torch.profiler), and the card vs the plain path on
   the CPU.

The last three lines are the card's name and power limit as nvidia-smi
reports them, one JSON object of per-kernel numbers (each kernel at the
shape of the path that launches it most: K1 and K3 at "eval", K2 at
"compact"; its other shapes under "other_shapes"), and
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# kernel vs plain, both bf16 on the card: they differ only by f32
# summation order, i.e. by one-ulp bf16 flips of single outputs
# (2**-8 relative each), so the relative Frobenius error stays far below
# 1e-2 and no output moves by more than 2 ulp of the largest one (1/64).
KERNEL_REL_TOL = 1e-2
KERNEL_MAX_TOL = 1.0 / 64
# whole-model logits, bf16 residual stream through 10-12 blocks: compact vs
# masked dense differ only by exact zeros, card vs CPU by summation order
MODEL_REL_TOL = 2e-2

N_BATCHES, BATCH, TOKEN_RATIO = 8, 64, 0.7
# tokens entering the blocks after the physical token drop: the class
# token and the top int(0.7 * 196) patches
N_KEPT = 1 + int(TOKEN_RATIO * 196)
N_PASSES = 5
SKIPPED_BLOCKS = (3, 8)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).norm() / ref.norm()).item(), \
        (out - ref).abs().max().item()


def time_ms(fn, iters):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def _inputs(gen, b, n, dm, heads, f):
    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dtype)

    def keep(k):
        return (torch.rand(k, generator=gen, device="cuda") > 0.25).to(
            torch.bfloat16)

    da = 64 * heads
    return dict(
        x=rn(b, n, dm), xin=rn(b, n, dm),
        g=1 + rn(dm, std=0.1, dtype=torch.float32),
        b=rn(dm, std=0.1, dtype=torch.float32),
        wqkv=rn(dm, 3 * da, std=dm ** -0.5), bqkv=rn(3 * da, std=0.1),
        wproj=rn(da, dm, std=da ** -0.5), bproj=rn(dm, std=0.1),
        amask=keep(da),
        w1=rn(dm, f, std=dm ** -0.5), b1=rn(f, std=0.1),
        w2=rn(f, dm, std=f ** -0.5), b2=rn(dm, std=0.1), fmask=keep(f),
        d=torch.tensor([0.25, 0.75], device="cuda"),
        heads=heads)


def _library_attention(t, eps):
    """One PyTorch composition of the attention sublayer (yardstick)."""
    x = t["x"]
    b, n, dm = x.shape
    heads = t["heads"]
    wqkv_t, wproj_t = t["wqkv"].t().contiguous(), t["wproj"].t().contiguous()

    def run():
        a = F.layer_norm(x.float(), (dm,), t["g"], t["b"], eps).to(x.dtype)
        qkv = F.linear(a, wqkv_t, t["bqkv"])
        q, k, v = qkv.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, scale=64 ** -0.5)
        ctx = ctx.transpose(1, 2).reshape(b, n, 64 * heads) * t["amask"]
        return x + F.linear(ctx, wproj_t, t["bproj"])
    return run


def _library_mlp(t, eps, blend):
    x = t["x"]
    dm = x.shape[-1]
    w1_t, w2_t = t["w1"].t().contiguous(), t["w2"].t().contiguous()

    def run():
        a = F.layer_norm(x.float(), (dm,), t["g"], t["b"], eps).to(x.dtype)
        h = F.gelu(F.linear(a, w1_t, t["b1"])) * t["fmask"]
        out = x + F.linear(h, w2_t, t["b2"])
        if blend:
            out = t["d"][1] * out + t["d"][0] * t["xin"]
        return out
    return run


def kernel_phase(eps):
    from uvc_tpu_torch.ops.attention import (layer_attention_ln,
                                             layer_attention_ln_plain)
    from uvc_tpu_torch.ops.mlp import (mlp_ln, mlp_ln_blend,
                                       mlp_ln_blend_plain, mlp_ln_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = {"eval": _inputs(gen, BATCH, N_KEPT, 384, 6, 1536),
              "compact": _inputs(gen, BATCH, N_KEPT, 384, 3, 768),
              "dense": _inputs(gen, BATCH, 197, 384, 6, 1536)}
    results = {}
    for shape, t in shapes.items():
        x = t["x"]
        b, n, dm = x.shape
        heads, da, f = t["heads"], 64 * t["heads"], t["w1"].shape[1]
        rows = b * n
        akw = dict(num_heads=heads, scale=64 ** -0.5, eps=eps)
        aargs = (x, t["g"], t["b"], t["wqkv"], t["bqkv"], t["wproj"],
                 t["bproj"], t["amask"])
        margs = (t["g"], t["b"], t["w1"], t["b1"], t["w2"], t["b2"],
                 t["fmask"])
        act = rows * dm * 2
        a_bytes = (2 * act + 2 * dm * 4 + (4 * da * dm + 3 * da + dm + da)
                   * 2)
        a_flops = (2 * rows * dm * 3 * da + 4 * b * heads * n * n * 64
                   + 2 * rows * da * dm)
        m_bytes = 2 * act + 2 * dm * 4 + (2 * dm * f + 2 * f + dm) * 2
        m_flops = 4 * rows * dm * f
        cases = {
            "layer_attention_ln": (
                lambda: layer_attention_ln(*aargs, **akw),
                lambda: layer_attention_ln_plain(*aargs, **akw),
                _library_attention(t, eps), a_flops, a_bytes),
            "mlp_ln": (
                lambda: mlp_ln(x, *margs, eps=eps),
                lambda: mlp_ln_plain(x, *margs, eps=eps),
                _library_mlp(t, eps, blend=False), m_flops, m_bytes),
            "mlp_ln_blend": (
                lambda: mlp_ln_blend(x, t["xin"], t["d"], *margs, eps=eps),
                lambda: mlp_ln_blend_plain(x, t["xin"], t["d"], *margs,
                                           eps=eps),
                _library_mlp(t, eps, blend=True), m_flops, m_bytes + act + 8),
        }
        for name, (kern, plain, library, flops, nbytes) in cases.items():
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            rel, mx = rel_err(out, ref)
            max_tol = KERNEL_MAX_TOL * ref.float().abs().max().item()
            check(torch.isfinite(out).all().item(),
                  f"{name} [{shape}]: non-finite output")
            check(rel <= KERNEL_REL_TOL and mx <= max_tol,
                  f"{name} [{shape}]: kernel vs plain rel_fro {rel:.3e} "
                  f"(tol {KERNEL_REL_TOL}), max_abs {mx:.3e} "
                  f"(tol {max_tol:.3e})")
            bound_ms, bound_by = bound(flops, nbytes)
            r = dict(shape=shape, rel_fro=rel, max_abs_err=mx,
                     ms=time_ms(kern, 50), plain_ms=time_ms(plain, 10),
                     library_ms=time_ms(library, 50), bound_ms=bound_ms,
                     bound_by=bound_by, flops=flops, bytes=nbytes)
            results[(name, shape)] = r
            print(f"kernel {name:18s} [{shape:7s} B={b} N={n} dm={dm} "
                  f"da={da} F={f}] rel_fro={rel:.2e} max_abs={mx:.2e} "
                  f"(tol {KERNEL_REL_TOL:g} / {max_tol:.2e}) "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound={bound_ms * 1e3:.1f}us ({bound_by})", flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def serving_phase(card):
    from uvc_tpu_torch.compress.masks import build_masks
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.infer.compact import (apply_compact,
                                             compact_flops_fraction,
                                             compact_model)
    from uvc_tpu_torch.models import vit
    from uvc_tpu_torch.ops import launch_counts, reset_launch_counts
    from uvc_tpu_torch.train.step import eval_step

    cfg = get_config("deit_small_patch16_224")
    check(cfg.seq_len - cfg.num_patches + int(TOKEN_RATIO * cfg.num_patches)
          == N_KEPT,
          "the kernel phase's token count is not the serving paths'")
    gen = torch.Generator().manual_seed(0)
    params = vit.init_params(gen, cfg)
    # the head is zero-initialised; randomise it so logits are not all 0
    params["head"]["kernel"] = 0.05 * torch.randn(
        params["head"]["kernel"].shape, generator=gen).cuda()
    ln = cfg.depth
    s = torch.tensor([[3.0, cfg.mlp_hidden / 2]] * ln)
    r = torch.randint(0, cfg.head_size // 4 + 1, (ln, cfg.num_heads),
                      generator=gen).float()
    masks = build_masks(params, s.cuda(), r.cuda(), cfg)
    for i in SKIPPED_BLOCKS:
        params["block_gating"][i] = torch.tensor([1.0, -1.0])
    kept = ln - len(SKIPPED_BLOCKS)
    layers, top = compact_model(params, masks, cfg)
    check(len(layers) == kept, f"compact model has {len(layers)} layers")
    for blk in layers:
        check(blk["num_heads"] == 3 and blk["fc1"]["kernel"].shape[1] == 768,
              "compact layer widths are not 3 heads / F=768")
    frac = compact_flops_fraction(layers, cfg, TOKEN_RATIO)

    igen = torch.Generator(device="cuda").manual_seed(2)
    images = [torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                          generator=igen, device="cuda")
              for _ in range(N_BATCHES)]
    labels = [torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                            device="cuda") for _ in range(N_BATCHES)]
    labels[-1][-5:] = -1                     # padding rows of the last batch
    hp = MinimaxHParams(enable_block_gating=True, enable_patch_gating=2,
                        patch_ratio=TOKEN_RATIO)
    n_img = N_BATCHES * BATCH

    def serve():
        return [apply_compact(layers, top, xb, cfg, token_ratio=TOKEN_RATIO)
                .logits for xb in images]

    def evaluate():
        # summed on the card, read once per pass, as a validation loop does
        tot = {"correct": 0, "loss_sum": 0.0, "count": 0}
        for xb, yb in zip(images, labels):
            m = eval_step(params, masks, xb, yb, cfg, hp)
            tot = {k: tot[k] + m[k] for k in tot}
        return {k: v.item() for k, v in tot.items()}

    def passes(fn):
        """N_PASSES passes over the request batches, timed as one window on
        the host clock from an idle card to the last pass's synchronise, so
        that a stall anywhere in it counts; CUDA events between the passes
        give each pass's share.  Returns (window seconds, per-pass seconds,
        the first pass's result)."""
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(N_PASSES + 1)]
        first = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(N_PASSES):
            res = fn()
            marks[i + 1].record()
            if first is None:
                first = res
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        return window, [a.elapsed_time(b) / 1e3
                        for a, b in zip(marks, marks[1:])], first

    with torch.no_grad():
        apply_compact(layers, top, images[0], cfg, token_ratio=TOKEN_RATIO)
        eval_step(params, masks, images[0], labels[0], cfg, hp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        reset_launch_counts()
        w_serve, p_serve, logits = passes(serve)
        serve_counts = launch_counts()

        reset_launch_counts()
        w_eval, p_eval, ev = passes(evaluate)
        eval_counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()

    runs = N_PASSES * N_BATCHES
    want_serve = {"layer_attention_ln": kept * runs, "mlp_ln": kept * runs,
                  "mlp_ln_blend": 0}
    want_eval = {"layer_attention_ln": ln * runs, "mlp_ln": 0,
                 "mlp_ln_blend": ln * runs}
    print(f"launches compact serving {serve_counts} (expected {want_serve})")
    print(f"launches eval_step       {eval_counts} (expected {want_eval})")
    check(serve_counts == want_serve, "compact serving launch counts differ")
    check(eval_counts == want_eval, "eval_step launch counts differ")
    for lg in logits:
        check(lg.shape == (BATCH, cfg.num_classes)
              and torch.isfinite(lg).all().item(),
              "compact logits not finite or of the wrong shape")
    check(ev["count"] == n_img - 5, f"eval count {ev['count']} != {n_img - 5}")
    check(0 <= ev["correct"] <= ev["count"]
          and ev["loss_sum"] == ev["loss_sum"], f"eval metrics {ev}")
    print(f"eval_step: correct={ev['correct']} count={ev['count']} "
          f"mean_loss={ev['loss_sum'] / ev['count']:.4f}")
    for label, window, secs in (
            (f"compact serving (token ratio {TOKEN_RATIO})", w_serve,
             p_serve),
            ("eval_step (masked dense)", w_eval, p_eval)):
        rates = ", ".join(f"{n_img / s:.1f}" for s in secs)
        print(f"{label}: {N_PASSES * n_img / window:.1f} img/s "
              f"({N_PASSES} passes of {N_BATCHES} batches of {BATCH} in "
              f"{window:.4f} s; per pass, CUDA events: {rates} img/s) "
              f"[{card}]")
    print(f"compact_flops_fraction={frac:.4f} (token ratio {TOKEN_RATIO})")
    print(f"max_memory_allocated={peak} bytes ({peak / 2**20:.1f} MiB) "
          f"[{card}]")

    # compact vs masked dense, with and without the token drop
    keep = (params["block_gating"][:, 1] > params["block_gating"][:, 0])
    gating = torch.stack([1.0 - keep.float(), keep.float()], dim=-1)
    x0 = images[0]
    with torch.no_grad():
        for ratio, mode in ((None, 0), (TOKEN_RATIO, 2)):
            dense = vit.apply(params, x0, cfg, gating_distrib=gating,
                              masks=masks, patch_gate_mode=mode,
                              patch_ratio=TOKEN_RATIO, patch_physical=True,
                              dtype=torch.bfloat16).logits
            comp = apply_compact(layers, top, x0, cfg,
                                 token_ratio=ratio).logits
            rel, mx = rel_err(comp, dense)
            print(f"compact vs masked dense (token ratio {ratio}): "
                  f"rel_fro={rel:.2e} max_abs={mx:.2e} "
                  f"(tol {MODEL_REL_TOL})")
            check(rel <= MODEL_REL_TOL, "compact and masked dense disagree")

        profile_phase(
            card, {"compact serving": lambda: apply_compact(
                layers, top, x0, cfg, token_ratio=TOKEN_RATIO),
                "eval_step": lambda: eval_step(params, masks, x0, labels[0],
                                               cfg, hp)})

        # the card against the plain path on the CPU, on 8 images
        def to_cpu(tree):
            if isinstance(tree, dict):
                return {k: to_cpu(v) for k, v in tree.items()}
            return tree.cpu() if torch.is_tensor(tree) else tree
        layers_cpu = [to_cpu(blk) for blk in layers]
        ref = apply_compact(layers_cpu, to_cpu(top), x0[:8].cpu(), cfg,
                            token_ratio=TOKEN_RATIO).logits
        rel, mx = rel_err(logits[0][:8].cpu(), ref)
        print(f"compact serving, card vs CPU plain path (8 images): "
              f"rel_fro={rel:.2e} max_abs={mx:.2e} (tol {MODEL_REL_TOL})")
        check(rel <= MODEL_REL_TOL, "card and CPU plain path disagree")
    return {k: serve_counts[k] + eval_counts[k] for k in serve_counts}


def profile_phase(card, runs):
    """Device time by kernel for one batch of each path (torch.profiler),
    and the device's busy share of the wall time (the profiler's own host
    overhead is inside the wall time, so the busy share is a lower
    bound)."""
    from torch.profiler import ProfilerActivity, profile

    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0), reverse=True)
        busy = sum(r[0] for r in rows)
        check(busy > 0, f"profile of {label}: no device time recorded")
        print(f"profile {label} (batch {BATCH}): device busy {busy:.1f} us "
              f"of {wall_us:.1f} us wall ({100 * busy / wall_us:.1f}%) "
              f"[{card}]")
        for t, n, key in rows[:8]:
            print(f"  {100 * t / busy:5.1f}%  {t:9.1f} us  x{n:<3d} "
                  f"{key[:70]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.ops import _cuda

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()} [{card}] "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    secs = _cuda.build()
    print(f"build: {secs:.1f} s -> {_cuda.build_dir()}")
    for name, log in _cuda.build_logs().items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    eps = get_config("deit_small_patch16_224").layer_norm_eps
    res = kernel_phase(eps)
    launches = serving_phase(card)

    # each kernel's headline shape is that of the path that launches it
    # most: K1 runs in both (12 blocks at "eval", 10 at "compact")
    meta = {
        "layer_attention_ln": ("uvc_tpu_torch/csrc/attention.cu",
                               "uvc_tpu/ops/attention.py:741", "eval"),
        "mlp_ln": ("uvc_tpu_torch/csrc/mlp.cu", "uvc_tpu/ops/mlp.py:71",
                   "compact"),
        "mlp_ln_blend": ("uvc_tpu_torch/csrc/mlp.cu",
                         "uvc_tpu/ops/mlp.py:147", "eval"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        r = res[(name, shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **{k: r[k] for k in keys}, "shape": shape,
            "other_shapes": {s: {k: o[k] for k in keys}
                             for (n, s), o in res.items()
                             if n == name and s != shape}})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
