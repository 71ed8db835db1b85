"""Classification and knowledge-distillation losses (counterpart of
``uvc_tpu/distill/losses.py``): timm's SoftTargetCrossEntropy and
LabelSmoothingCrossEntropy, and the soft / hard distillation blend, whose
soft term is ``KL * T^2 / logits.numel()`` with a sum reduction (numel,
not batch, as the reference divides it)."""

from __future__ import annotations

from typing import Optional

import torch


def soft_target_cross_entropy(logits: torch.Tensor,
                              target_probs: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``-sum(target * log_softmax(logits))``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(target_probs * logp).sum(dim=-1).mean()


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def distillation_loss(base_loss: torch.Tensor,
                      student_kd_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, *,
                      kind: Optional[str], alpha: float,
                      tau: float) -> torch.Tensor:
    """``(1 - alpha) * base + alpha * distill``; the teacher is detached."""
    if kind is None or kind == "none":
        return base_loss
    teacher_logits = teacher_logits.detach()
    if kind == "soft":
        s_logp = torch.log_softmax(student_kd_logits / tau, dim=-1)
        t_logp = torch.log_softmax(teacher_logits / tau, dim=-1)
        kl = (torch.exp(t_logp) * (t_logp - s_logp)).sum()
        distill = kl * (tau * tau) / student_kd_logits.numel()
    elif kind == "hard":
        hard = teacher_logits.argmax(dim=-1)
        logp = torch.log_softmax(student_kd_logits, dim=-1)
        distill = -logp.gather(-1, hard[:, None]).mean()
    else:
        raise ValueError(f"unknown distillation type {kind!r}")
    return base_loss * (1.0 - alpha) + distill * alpha
