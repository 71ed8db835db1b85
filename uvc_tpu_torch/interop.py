"""Carry parameters, masks and the minimax state across from the JAX
package.

The JAX package keeps its parameters as a pytree of nested dicts; given
with numpy leaves (``jax.tree.map(np.asarray, params)``), the same tree
becomes the port's parameters here, leaf for leaf, in the same layout:
linear kernels stored (in, out), ``patch_embed.kernel`` ``[P, P, C, D]``,
per-block tensors stacked on a leading layer axis.  The counterpart in
role of ``uvc_tpu/models/convert.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from uvc_tpu_torch.compress.state import CompressionState, OptState


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and there is no
    usable card (the port never carries on on the CPU instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``.  To a card it goes through pinned
    memory as an asynchronous copy, so the host does not wait for the
    card's queue to drain (a copy from pageable memory would)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _to_tensor(leaf, device, dtype):
    t = torch.from_numpy(np.array(leaf))        # a writable copy
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def tree_to_torch(tree: Any, device, dtype: Optional[torch.dtype]) -> Any:
    """Nested dicts / lists of array-likes -> the same structure of tensors
    (floating leaves cast to ``dtype`` unless it is None)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device, dtype) for v in tree)
    if isinstance(tree, (int, float, bool, str)) or tree is None:
        return tree
    return _to_tensor(tree, device, dtype)


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype: Optional[torch.dtype] = torch.float32) -> dict:
    """The JAX package's parameter pytree (numpy leaves) as the port's
    parameters on ``device``.  Floating leaves become ``dtype`` (f32 by
    default, as the JAX package keeps them; the forward casts to its
    compute dtype)."""
    return tree_to_torch(tree, resolve_device(device), dtype)


def masks_from_numpy(masks: Optional[Dict[str, Any]], device="cuda"
                     ) -> Optional[Dict[str, torch.Tensor]]:
    """Structural keep masks ``{"attn": [L, D], "mlp": [L, F]}`` as f32
    tensors on ``device`` (None stays None)."""
    if masks is None:
        return None
    return tree_to_torch(dict(masks), resolve_device(device), torch.float32)


def wmasks_from_numpy(masks: Optional[Dict[str, Any]], device="cuda"
                      ) -> Optional[dict]:
    """The JAX package's weight-mask tree of the pruning baselines (numpy
    masks at the maskable kernels, None at every other leaf) as f32
    tensors on ``device``, the None leaves kept (None stays None)."""
    if masks is None:
        return None
    return tree_to_torch(masks, resolve_device(device), torch.float32)


def cstate_from_numpy(cstate: Any, device="cuda"):
    """The JAX package's ``CompressionState`` with numpy leaves
    (``jax.tree.map(np.asarray, cstate)``) as the port's
    ``CompressionState`` on ``device``: the same fields, f32 tensors, the
    optimizers' counts as ints."""
    dev = resolve_device(device)

    def t(a):
        return None if a is None else _to_tensor(a, dev, torch.float32)

    def opt(o):
        return OptState(m=t(o.m), v=t(o.v), count=int(np.asarray(o.count)))

    return CompressionState(
        s=t(cstate.s), r=t(cstate.r), y=t(cstate.y), p=t(cstate.p),
        z=t(cstate.z), eps=t(cstate.eps), zlr=t(cstate.zlr),
        gating_accum=t(cstate.gating_accum), s_opt=opt(cstate.s_opt),
        r_opt=opt(cstate.r_opt), gating_opt=opt(cstate.gating_opt))
