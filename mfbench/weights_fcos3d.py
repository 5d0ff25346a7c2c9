"""The benchmark's part of FCOS3D's seeded weights, beyond ``weights.py``'s
(offset convs, BN biases), applied by parameter name to the program and to
the reference alike.

At the published class prior (-4.6) a seeded head scores almost no
location above the decode's 0.05, and the NMS would have nothing to do; a
trained head on a nuScenes sample passes some hundreds.  How many a seeded
head passes at a given bias swings with the seed (24 an image at one seed,
1,030 at another, at biases 0.2 apart), so the class bias is fitted, like
the BN statistics, to the cell's first input through the reference: the
bias at which ``pairs_per_image`` (candidate, class) pairs an image pass
the threshold.  The depth bias is fitted so that those pairs' boxes lie
``median_depth_m`` out at the median, a nuScenes object's typical
distance, so that they spread over the scene as trained ones do.  The
centerness bias is the configuration's."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

HEAD = "heads.predictor."
BIASES = {"cls_bias": "conv_cls.bias", "centerness_bias": "conv_centerness.bias",
          "depth_bias": "conv_regs.1.bias"}


@torch.no_grad()
def head_biases(model: nn.Module, weights: Dict) -> None:
    """The head's class, centerness and depth biases set to ``weights``'s
    (0 for a bias ``weights`` lacks: the fit's starting point)."""
    params = dict(model.named_parameters())
    for key, name in BIASES.items():
        params[HEAD + name].fill_(float(weights.get(key, 0.0)))


@torch.no_grad()
def fit(maps: List[torch.Tensor], fields: Dict[str, slice], nms_pre: int, score_thr: float,
        weights: Dict) -> Dict[str, float]:
    """{"cls_bias", "depth_bias"} for head maps computed with both at 0
    (one map a level, (B, channels, H, W)): the class bias by bisection on
    the mean count an image of the pairs over ``score_thr`` among each
    level's ``nms_pre`` best locations, then the depth bias from those
    pairs' median log-depth."""
    B = maps[0].shape[0]
    flat = [m.permute(0, 2, 3, 1).reshape(B, -1, m.shape[1]).float() for m in maps]

    def passing(bias: float):
        """(pairs an image, the log-depths of the pairs' candidates)."""
        count, depths = 0, []
        for f in flat:
            s = (f[..., fields["cls"]] + bias).sigmoid() * f[..., fields["centerness"]].sigmoid()
            idx = s.amax(-1).topk(min(nms_pre, f.shape[1]), dim=1).indices
            hit = s.gather(1, idx[..., None].expand(-1, -1, s.shape[-1])) > score_thr
            count += int(hit.sum())
            depth = f[..., fields["depth"]][..., 0].gather(1, idx)
            depths.append(depth[hit.any(-1)])
        return count / B, torch.cat(depths)

    lo, hi = -30.0, 30.0
    for _ in range(40):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if passing(mid)[0] < weights["pairs_per_image"] else (lo, mid)
    cls_bias = (lo + hi) / 2
    depths = passing(cls_bias)[1]
    median = float(depths.median()) if depths.numel() else 0.0
    return {"cls_bias": cls_bias, "depth_bias": math.log(weights["median_depth_m"]) - median}
