"""Kendall-style multi-task uncertainty weighting (counterpart of
``monoflex_tpu/losses/uncertainty.py``; reference:
model/layers/uncert_wrapper.py:17-57, constructed but not wired into the
shipped config): each loss term i gets a learned log-variance s_i and
contributes L_i * exp(-s_i) + 0.5 * s_i.

The log-variances are parameters the caller owns (``init_log_variances``
makes them, to hand to an optimizer); ``apply_uncertainty_weights`` is a
function of them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn


def init_log_variances(loss_names) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(torch.zeros(())) for name in loss_names})


def apply_uncertainty_weights(loss_dict: Dict[str, torch.Tensor],
                              log_variances: Dict[str, torch.Tensor],
                              enabled: Optional[Dict[str, bool]] = None
                              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (the weighted loss dict, the regulariser's sum)."""
    out = {}
    reg = torch.zeros(())
    for name, loss in loss_dict.items():
        if enabled is not None and not enabled.get(name, False):
            out[name] = loss
            continue
        s = log_variances[name]
        out[name] = loss * torch.exp(-s)
        reg = reg + 0.5 * s
    return out, reg
