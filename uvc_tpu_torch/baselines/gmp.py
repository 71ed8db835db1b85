"""Gradual magnitude pruning schedule (counterpart of
``uvc_tpu/baselines/gmp.py``): after ``t_start`` steps, every ``delta_t``
steps re-score by magnitude and re-threshold globally at the cubic
sparsity ramp

    sparsity(t) = s_end + (s_start - s_end) * (1 - (t - t_0)/(n*dt))^3

for at most ``pruning_times`` events.
"""

from __future__ import annotations

import dataclasses

from uvc_tpu_torch.baselines.pruning import (global_threshold_mask,
                                             magnitude_scores)


def cubic_sparsity(s_start: float, s_end: float, t: int, t_0: int,
                   pruning_times: int, delta_t: int) -> float:
    """The cubic ramp, clamped at its end so that steps past the schedule
    hold ``s_end``."""
    frac = min(max((t - t_0) / (pruning_times * delta_t), 0.0), 1.0)
    coef = (1 - frac) ** 3
    return s_end + (s_start - s_end) * coef


@dataclasses.dataclass
class GMPSchedule:
    """Host-side GMP controller: call ``maybe_prune`` once per step."""

    sparsity: float            # final target sparsity (fraction removed)
    t_start: int               # first step eligible for pruning
    delta_t: int               # steps between pruning events
    pruning_times: int         # max number of pruning events
    events: int = 0

    def should_prune(self, step: int) -> bool:
        return (step > self.t_start
                and (step - self.t_start) % self.delta_t == 0
                and self.events < self.pruning_times)

    def maybe_prune(self, step: int, params):
        """New masks at a pruning event (magnitude scores, one global
        threshold at the ramp's density), else None."""
        if not self.should_prune(step):
            return None
        sp = cubic_sparsity(0.0, self.sparsity, step, self.t_start,
                            self.pruning_times, self.delta_t)
        self.events += 1
        return global_threshold_mask(magnitude_scores(params), 1.0 - sp)
