"""The eval step (counterpart of ``uvc_tpu/train/step.py::build_eval_step``).

PyTorch runs eagerly, so the step is a plain function where the JAX
package returns a jitted program.  The training steps come with their
slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.models import get_model


@torch.no_grad()
def eval_step(params: dict, masks: Optional[Dict[str, torch.Tensor]],
              x: torch.Tensor, labels: torch.Tensor, cfg: ViTConfig,
              hp: MinimaxHParams, *, dtype=torch.bfloat16
              ) -> Dict[str, torch.Tensor]:
    """Validation step: the hard-gated forward (``keep = g1 > g0`` as the
    block-gating distribution when ``hp.enable_block_gating``), masks
    applied unless ``masks`` is None, and the deterministic top-k token
    drop applied physically.  Returns the top-1 ``correct`` count, the
    summed cross-entropy ``loss_sum`` and the ``count`` of rows; rows
    labelled -1 are padding and leave all three untouched."""
    gating_distrib = None
    if hp.enable_block_gating:
        g = params["block_gating"]
        keep = (g[:, 1] > g[:, 0]).float()
        gating_distrib = torch.stack([1.0 - keep, keep], dim=-1)
    tau = 1.0 if hp.enable_patch_gating == 2 else -1.0
    model = get_model(cfg)
    out = model.apply(params, x, cfg, gating_distrib=gating_distrib,
                      masks=masks, tau=tau, patch_ratio=hp.patch_ratio,
                      patch_gate_mode=hp.enable_patch_gating,
                      patch_hard=True, patch_physical=True, rng=None,
                      train=False, dtype=dtype)
    logits = model.eval_logits(out, cfg)
    valid = labels >= 0
    safe = labels.clamp(min=0)
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, safe[:, None])[:, 0]
    correct = (logits.argmax(dim=-1) == labels) & valid
    return {"correct": correct.sum(),
            "loss_sum": torch.where(valid, nll, torch.zeros_like(nll)).sum(),
            "count": valid.sum()}
