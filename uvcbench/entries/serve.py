"""Compact serving: ``infer/compact.py::compact_model`` in set-up, then per
batch ``data/pipeline.py::normalize_on_device`` and ``apply_compact`` with
the configuration's token ratio, as a closed loop with a fixed number of
batches in flight.

Each batch starts as uint8 NHWC pixels in pinned host memory (a ring made
from the seed), is copied to the card, normalised there and served; its
top-1 class ids are copied back into pinned memory.  Batch k + 1 is
issued before batch k's ids are read.  A batch's latency runs from its
issue to its ids on the host.  The check takes the batches whose indices
a generator seeded from ``--seed`` picks among the first ``SAMPLE_FROM``
(their logits are kept, nothing else), and serves the same images through
the plain reference's masked dense forward with the skipped blocks left
out and the same token drop.
"""

from __future__ import annotations

import collections
import random
import sys
import time
from typing import Optional

import torch

from uvcbench import compare, flops
from uvcbench.reference.model import (Numerics, TokenChoice, forward,
                                      normalize)
from uvcbench.weights import (arch_blocks, gate_blocks, make_batches,
                              make_masks, make_params)

SAMPLE_FROM, SAMPLES = 200, 32


class Serve:
    kind, unit_name, trace_units = "serve", "batch", 40

    def __init__(self, cell):
        from uvc_tpu_torch.infer.compact import compact_model

        self.cell = cell
        w, s, dev = cell.workload, cell.sizes, cell.device
        self.cfg = cell.program_cfg()
        self.batch, self.ring = w["batch"], w["ring"]
        self.in_flight = w["in_flight"]
        self.arch = cell.config["architecture"]
        self.ratio = self.arch["token_ratio"]
        gen = torch.Generator(device=dev).manual_seed(cell.seed)
        params = make_params(s, gen, dev)
        self.masks = make_masks(s, self.arch, gen, dev)
        self.params = gate_blocks(params, s, self.arch)
        pixels, _ = make_batches(s, gen, self.ring, self.batch, dev,
                                 dtype=torch.uint8)
        pin = dev.type == "cuda"
        self.host = [torch.empty(pixels.shape[1:], dtype=torch.uint8,
                                 pin_memory=pin).copy_(pixels[i])
                     for i in range(self.ring)]
        del pixels
        self.out = [torch.empty(self.batch, dtype=torch.long, pin_memory=pin)
                    for _ in range(self.in_flight)]
        self.layers, self.top = compact_model(self.params, self.masks,
                                              self.cfg, device=dev)
        self.kept, self.sample = {}, set()
        self.k = 0
        self.images_per_unit = self.batch
        self.run(lambda: False, units=2 * self.in_flight)
        self.sample = {self.k + i for i in random.Random(cell.seed).sample(
            range(SAMPLE_FROM), SAMPLES)}

    def _serve(self, x):
        from uvc_tpu_torch.data.pipeline import normalize_on_device
        from uvc_tpu_torch.infer.compact import apply_compact

        logits = apply_compact(self.layers, self.top, normalize_on_device(x),
                               self.cfg, token_ratio=self.ratio).logits
        return logits, logits.argmax(dim=-1)

    def run(self, stop, units: Optional[int] = None) -> dict:
        dev = self.cell.device
        pending = collections.deque()
        lat, issue, n = [], [], 0

        def read_oldest():
            k, t0, ev, slot, logits = pending.popleft()
            if ev is not None:
                ev.synchronize()
            lat.append(time.perf_counter() - t0)
            if logits is not None:
                self.kept[k] = (logits, self.out[slot].clone())

        with torch.no_grad():
            while True:
                k, slot = self.k, self.k % self.in_flight
                t0 = time.perf_counter()
                with torch.profiler.record_function("uvcbench.feed"):
                    x = self.host[k % self.ring].to(dev, non_blocking=True)
                with torch.profiler.record_function("uvcbench.step"):
                    logits, ids = self._serve(x)
                    issue.append(time.perf_counter() - t0)
                with torch.profiler.record_function("uvcbench.read"):
                    self.out[slot].copy_(ids, non_blocking=True)
                    ev = None
                    if dev.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                pending.append((k, t0, ev, slot,
                                logits if k in self.sample else None))
                self.k += 1
                n += 1
                done = (n >= units) if units is not None else stop()
                while pending and (done or len(pending) >= self.in_flight):
                    read_oldest()
                if done:
                    break
        return {"units": n, "images": n * self.batch, "latencies_s": lat,
                "issue_s": issue}

    @property
    def flops_per_unit(self) -> float:
        s = self.cell.sizes
        return self.batch * flops.forward_flops(
            s, s.tokens(self.ratio), arch_blocks(s, self.arch),
            scorer=s.tokens_type == "none")

    def work(self) -> dict:
        """Each kernel wrapper's work a call: the mean over the kept
        layers, each launched once a batch, at the widths the compact model
        gives them (its heads, its padded units)."""
        s, b, n = self.cell.sizes, self.batch, self.cell.sizes.tokens(
            self.ratio)
        att = [flops.attention_fwd(b, n, s.embed_dim, blk["num_heads"],
                                   s.head_size) for blk in self.layers]
        mlp = [flops.mlp_fwd(b, n, s.embed_dim, blk["fc1"]["kernel"].shape[1])
               for blk in self.layers]
        return {name: flops.Work(*(sum(v) / len(ws) for v in zip(*ws)))
                for name, ws in (("layer_attention_ln", att),
                                 ("mlp_ln", mlp))}

    def describe(self) -> str:
        s = self.cell.sizes
        frac = self.flops_per_unit / (self.batch * flops.forward_flops(
            s, s.seq_len, flops.dense_blocks(s)))
        return (f"batch {self.batch}, {self.in_flight} in flight, "
                f"{len(self.layers)} kept blocks, {s.tokens(self.ratio)} "
                f"tokens, FLOPs fraction {frac:.4f} of the dense model")

    def readings(self, num: Optional[Numerics] = None) -> dict:
        """The sampled batches' logit errors and id gaps against the f32
        reference; with ``num`` the reference in that precision is judged
        in the program's place."""
        s, dev = self.cell.sizes, self.cell.device
        skip = set(self.arch["skip"])
        want = Numerics("f32")
        errs, gaps = [], []
        for k in sorted(self.kept):
            logits, ids = self.kept[k]
            x = normalize(self.host[k % self.ring].to(dev))
            tokens = TokenChoice("drop", self.ratio)
            with torch.no_grad():
                ref = forward(want, self.params, x, s, masks=self.masks,
                              tokens=tokens, skip_blocks=skip)
                if num is not None:
                    logits = forward(num, self.params, x, s,
                                     masks=self.masks, tokens=tokens,
                                     skip_blocks=skip)
                    ids = logits.argmax(dim=-1)
            errs.append(compare.logit_err(logits, ref))
            gaps.append(compare.id_gaps(ids, ref))
        return {"logit_err": max(errs, default=float("inf")),
                "id_gap": float(torch.cat(gaps).mean()) if gaps
                else float("inf"),
                "id_gap_widest": float(torch.cat(gaps).max()) if gaps
                else float("inf"),
                "batches": len(errs)}

    def check(self, control: Optional[str] = None) -> dict:
        self.layers = self.top = None
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()
        got = self.readings(None if control is None else Numerics(control))
        limits = self.cell.workload["check"]["limits"]
        print(f"check readings: {got['batches']} sampled batches of "
              f"{self.batch}; widest id gap {got['id_gap_widest']!r}",
              file=sys.stderr, flush=True)
        out = {k: {"value": got[k], "limit": limits[k]}
               for k in ("logit_err", "id_gap")}
        return out


Unit = Serve
