"""Ahead-of-time serving export of compacted models (counterpart of
``uvc_tpu/infer/export.py``).

``export_serving`` traces the compacted inference forward
(``infer/compact.py::apply_compact``) through ``torch.export`` into one
``ExportedProgram`` per batch size, serialized with ``torch.export.save``:

* the weights are embedded (the compact model's tensors are the module's
  buffers: nothing is trainable at serving);
* the input is pinned to f32 NHWC ``[batch, img, img, 3]``, cast to the
  serving dtype inside; a distilled model serves the mean of its heads;
* the sublayer kernels stay kernels: K1, K2 and the performer forward are
  the operators ``uvc_tpu_torch.layer_attention_ln``, ``mlp_ln`` and
  ``performer`` (``ops/_library.py``), so the graph calls them, and on the
  card they launch the hand-written kernels, not a decomposition.

``ServingModel`` / ``load_serving`` run the artifacts with no model code:
the load side imports ``uvc_tpu_torch.ops`` (the operators' registrations
and the kernels' loader) and nothing of ``models/``, ``infer/compact.py``
or ``train/``.  Several batch sizes can be packed into one file, stored as
the JAX package stores its artifacts (an ``.npz`` of uint8 arrays keyed
``b<batch>``); the loader picks the smallest exported batch at or above
the request and pads.

An artifact of this package is an ``ExportedProgram``, the JAX package's a
serialized StableHLO module: neither package loads the other's.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# the operators the exported graphs call; imported for their registrations
import uvc_tpu_torch.ops  # noqa: F401


class _CompactServing(torch.nn.Module):
    """``apply_compact`` over the compact model held as buffers: the tensor
    leaves of ``{"layers": ..., "top": ...}`` are registered in order and
    rebuilt into the trees at each call (``num_heads`` stays an int)."""

    def __init__(self, layers, top, cfg, dtype, token_ratio):
        super().__init__()
        self.cfg, self.dtype, self.token_ratio = cfg, dtype, token_ratio
        count = 0

        def hold(node):
            nonlocal count
            if torch.is_tensor(node):
                name = f"w{count}"
                count += 1
                # a buffer of its own storage: the compact layers' leaves
                # are views of the stacked dense tensors
                self.register_buffer(name, node.detach().clone())
                return name
            if isinstance(node, dict):
                return {k: hold(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [hold(v) for v in node]
            return node

        self._skeleton = hold({"layers": layers, "top": top})
        self._names = {f"w{i}" for i in range(count)}

    def _tree(self, node):
        if isinstance(node, str) and node in self._names:
            return getattr(self, node)
        if isinstance(node, dict):
            return {k: self._tree(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self._tree(v) for v in node]
        return node

    def forward(self, x):
        from uvc_tpu_torch.infer.compact import apply_compact
        tree = self._tree(self._skeleton)
        out = apply_compact(tree["layers"], tree["top"], x.to(self.dtype),
                            self.cfg, dtype=self.dtype,
                            token_ratio=self.token_ratio)
        if self.cfg.distilled:
            # deployed eval head = mean of both heads (vit.py eval fusion)
            return 0.5 * (out.logits + out.logits_kd)
        return out.logits


def export_serving(layers: List[dict], top: dict, cfg, *,
                   batch_sizes: Sequence[int] = (8,),
                   token_ratio: Optional[float] = None,
                   dtype=torch.bfloat16) -> Dict[str, bytes]:
    """Serialize ``apply_compact`` with ``torch.export``, one program per
    batch size, traced on the device that holds ``layers`` / ``top``.

    Returns ``{"b<batch>": serialized_bytes}``.  ``dtype`` is the one the
    model was compacted in (``compact_model``)."""
    module = _CompactServing(layers, top, cfg, dtype, token_ratio).eval()
    device = top["head"]["kernel"].device
    arts: Dict[str, bytes] = {}
    for b in batch_sizes:
        spec = torch.zeros((b, cfg.img_size, cfg.img_size, 3),
                           dtype=torch.float32, device=device)
        with torch.no_grad():
            program = torch.export.export(module, (spec,), strict=False)
        # the program keeps its example input, a whole batch of images,
        # which the artifact does not need
        program.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf)
        arts[f"b{b}"] = buf.getvalue()
    return arts


class ServingModel:
    """Deserialized serving artifacts: callable, no model code needed."""

    def __init__(self, artifacts: Dict[str, bytes]):
        self._fns = {}
        for key, data in artifacts.items():
            program = torch.export.load(io.BytesIO(
                data if isinstance(data, bytes) else bytes(data)))
            self._fns[int(key[1:])] = program.module()
        self._batches = sorted(self._fns)
        # the device the programs were traced on, which holds their weights
        self._device = next(self._fns[self._batches[0]].buffers()).device

    @property
    def batch_sizes(self) -> List[int]:
        return list(self._batches)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Run on ``[B, H, W, 3]`` images; pads B up to an exported
        batch."""
        b = x.shape[0]
        fit = next((s for s in self._batches if s >= b), None)
        if fit is None:
            raise ValueError(
                f"batch {b} exceeds largest exported size {self._batches[-1]}")
        x = x.to(self._device, torch.float32)
        if fit != b:
            x = torch.cat([x, x.new_zeros((fit - b,) + tuple(x.shape[1:]))])
        with torch.no_grad():
            return self._fns[fit](x)[:b]


def save_serving(path: str, artifacts: Dict[str, bytes]) -> None:
    """Write artifacts as an .npz (bytes stored as uint8 arrays)."""
    np.savez(path, **{k: np.frombuffer(v, np.uint8)
                      for k, v in artifacts.items()})


def load_serving(path: str) -> ServingModel:
    with np.load(path) as z:
        return ServingModel({k: z[k].tobytes() for k in z.files})
