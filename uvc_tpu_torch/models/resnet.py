"""ResNetV2 stem of the R50+ViT hybrid (counterpart of
``uvc_tpu/models/resnet.py``).

Pre-activation bottlenecks with weight-standardised convolutions and
GroupNorm, on NHWC activations.  The parameters are in the JAX package's
layout: HWIO kernels (those of the upstream ``.npz`` files), the stages
``block1`` / ``block2`` / ``block3`` as lists of unit dicts, and
``conv_proj`` / ``gn_proj`` only in a unit whose stride or width
changes.  A convolution runs as ``F.conv2d`` on the NHWC tensor viewed as
channels-last NCHW, so its output permutes back to a contiguous NHWC
tensor; no kernel of the port is involved (the JAX package leaves the
convolutions to XLA too).

Architecture: a 7 x 7 / 2 root convolution, GroupNorm, ReLU and a 3 x 3 / 2
max-pool without padding, then ``block_units`` (3, 4, 9) bottlenecks with
strides (1, 2, 2), width ``64 * width_factor`` and ``16 * width`` output
channels: total stride 16 (224 -> 112 -> 55 -> 55 -> 28 -> 14).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def std_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1
             ) -> torch.Tensor:
    """Weight-standardised convolution of NHWC ``x`` with the HWIO kernel
    ``w``: the kernel normalised per output channel over (H, W, I) in f32
    (population variance, eps 1e-5 inside the rsqrt), cast to ``x``'s
    dtype; symmetric padding ``(k - 1) // 2`` on both sides, as the
    reference's torch convolution pads (not XLA's "SAME", which pads a
    stride-2 convolution (0, 1))."""
    w32 = w.float()
    m = w32.mean(dim=(0, 1, 2), keepdim=True)
    v = w32.var(dim=(0, 1, 2), keepdim=True, unbiased=False)
    w = ((w32 - m) * torch.rsqrt(v + 1e-5)).to(x.dtype)
    p = (w.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=p)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of NHWC ``x`` in f32 (``groups`` groups, or one group a
    channel where the channels do not divide), the affine in f32, cast to
    ``x``'s dtype."""
    c = x.shape[-1]
    g = groups if c % groups == 0 else c
    y = F.group_norm(x.float().permute(0, 3, 1, 2), g, scale.float(),
                     bias.float(), eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _conv_init(gen, kh, kw, cin, cout):
    fan = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen) * math.sqrt(
        2.0 / fan)


def _gn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_bottleneck(gen: torch.Generator, cin: int, cout: int, cmid: int,
                    stride: int = 1) -> dict:
    """One unit's parameters (He-normal kernels, unit GroupNorm scales);
    the projection only where the stride or the width changes."""
    p = {
        "conv1": _conv_init(gen, 1, 1, cin, cmid), "gn1": _gn_init(cmid),
        "conv2": _conv_init(gen, 3, 3, cmid, cmid), "gn2": _gn_init(cmid),
        "conv3": _conv_init(gen, 1, 1, cmid, cout), "gn3": _gn_init(cout),
    }
    if stride != 1 or cin != cout:
        p["conv_proj"] = _conv_init(gen, 1, 1, cin, cout)
        p["gn_proj"] = _gn_init(cout)
    return p


def apply_bottleneck(p: dict, x: torch.Tensor, stride: int = 1
                     ) -> torch.Tensor:
    """The pre-activation bottleneck; the projection's GroupNorm has one
    group a channel, as the reference's ``nn.GroupNorm(cout, cout)``."""
    residual = x
    if "conv_proj" in p:
        residual = std_conv(x, p["conv_proj"], stride)
        residual = group_norm(residual, p["gn_proj"]["scale"],
                              p["gn_proj"]["bias"],
                              groups=residual.shape[-1])
    y = F.relu(group_norm(std_conv(x, p["conv1"]), p["gn1"]["scale"],
                          p["gn1"]["bias"]))
    y = F.relu(group_norm(std_conv(y, p["conv2"], stride),
                          p["gn2"]["scale"], p["gn2"]["bias"]))
    y = group_norm(std_conv(y, p["conv3"]), p["gn3"]["scale"],
                   p["gn3"]["bias"])
    return F.relu(residual + y)


def init_resnet_stem(gen: torch.Generator,
                     block_units: Sequence[int] = (3, 4, 9),
                     width_factor: int = 1) -> dict:
    """The stem's parameters on the CPU, drawn from ``gen`` (the draws
    are the port's own; tests carry JAX's weights across instead)."""
    width = 64 * width_factor
    p = {"conv_root": _conv_init(gen, 7, 7, 3, width),
         "gn_root": _gn_init(width)}
    stages = [(width, width * 4, width, 1),
              (width * 4, width * 8, width * 2, 2),
              (width * 8, width * 16, width * 4, 2)]
    for bi, n_units in enumerate(block_units):
        cin, cout, cmid, stride = stages[bi]
        p[f"block{bi + 1}"] = [
            init_bottleneck(gen, cin if u == 0 else cout, cout, cmid,
                            stride if u == 0 else 1)
            for u in range(n_units)]
    return p


def apply_resnet_stem(p: dict, x: torch.Tensor,
                      block_units: Sequence[int] = (3, 4, 9)
                      ) -> torch.Tensor:
    """``[B, H, W, 3]`` -> ``[B, H / 16, W / 16, 16 * width]`` in ``x``'s
    dtype."""
    x = std_conv(x, p["conv_root"], stride=2)
    x = F.relu(group_norm(x, p["gn_root"]["scale"], p["gn_root"]["bias"]))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    for bi, n_units in enumerate(block_units):
        units = p[f"block{bi + 1}"]
        for u in range(n_units):
            x = apply_bottleneck(units[u], x, 2 if u == 0 and bi > 0 else 1)
    return x
