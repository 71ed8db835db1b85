"""Sublayer ops of the port and their launch counters.

Each kernel wrapper keeps a plain integer ``launches`` that it raises by one
where it launches its kernel.  ``launch_counts`` reads the forward kernels'
(the serving path's), ``backward_launch_counts`` the backward kernels'
(the training path's), and ``reset_launch_counts`` sets them all to 0, so a
run can show that its main path went through the kernels.  The wide-model
backward routes (``dm > 1280``, composed in PyTorch around kernel A8 as
the JAX package composes them) count their calls in ``calls``, read by
``composed_counts`` and reset with the rest.  While a profiler session
records, each wrapper's call is also the span ``uvc.op.<name>`` (its key
here; ``utils/profiler.py::span``), opened at the same boundary as its
counter, so that a trace ties each kernel to the wrapper that launched it.
"""

from uvc_tpu_torch.ops.attention import (layer_attention, layer_attention_bwd,
                                         layer_attention_ln,
                                         layer_attention_ln_bwd)
from uvc_tpu_torch.ops.mlp import (mlp_ln, mlp_ln_blend, mlp_ln_blend_bwd,
                                   mlp_ln_bwd)
# the modules, not their wrappers of the same names, are the package
# attributes
from uvc_tpu_torch.ops import attention as _attention
from uvc_tpu_torch.ops import mlp as _mlp
from uvc_tpu_torch.ops import performer as _performer

KERNEL_WRAPPERS = {
    "layer_attention_ln": layer_attention_ln,
    "mlp_ln": mlp_ln,
    "mlp_ln_blend": mlp_ln_blend,
    "layer_attention": layer_attention,
    "performer": _performer.performer,
    "attention": _attention.attention,
}
BACKWARD_KERNEL_WRAPPERS = {
    "layer_attention_ln_bwd": layer_attention_ln_bwd,
    "mlp_ln_bwd": mlp_ln_bwd,
    "mlp_ln_blend_bwd": mlp_ln_blend_bwd,
    "layer_attention_bwd": layer_attention_bwd,
    "performer_bwd": _performer.performer_bwd,
    "attention_bwd": _attention.attention_bwd,
    "attention_bwd_ctx": _attention.attention_bwd_ctx,
}
COMPOSED_ROUTES = {
    "layer_attention_ln_bwd_composed":
        _attention.layer_attention_ln_bwd_composed,
    "mlp_ln_bwd_composed": _mlp.mlp_ln_bwd_composed,
    "mlp_ln_blend_bwd_composed": _mlp.mlp_ln_blend_bwd_composed,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def backward_launch_counts() -> dict:
    return {name: fn.launches for name, fn in
            BACKWARD_KERNEL_WRAPPERS.items()}


def composed_counts() -> dict:
    return {name: fn.calls for name, fn in COMPOSED_ROUTES.items()}


def reset_launch_counts() -> None:
    for fn in (*KERNEL_WRAPPERS.values(), *BACKWARD_KERNEL_WRAPPERS.values()):
        fn.launches = 0
    for fn in COMPOSED_ROUTES.values():
        fn.calls = 0
