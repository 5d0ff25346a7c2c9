"""BEVFormer's decode on the device (the published ``NMSFreeCoder`` and
``BEVFormerHead.get_bboxes``), for the outputs of ``models/bevformer.py``.

Span ``decode.bevformer``: the sigmoid of the (NUM_QUERY, 10) class logits,
the ``MAX_BOXES`` best of the NUM_QUERY x 10 (query, class) scores (label =
index % 10, query = index // 10), that query's box code denormalised
(centre as the model mapped it onto the point-cloud range; w, l, h the
exponentials of their codes; yaw = atan2(sin, cos); the velocity as it
is), valid where the centre lies in ``POST_CENTER_RANGE``, and z moved to
the box's bottom (z - h / 2).  No NMS, no score threshold, no host sync.

Returns rows (1, MAX_BOXES, ``ROW``) in descending score, [x, y, z, w, l,
h, yaw, vx, vy, score, label] in the lidar frame, their validity (1,
MAX_BOXES), and extras: ``bev``, ``cls`` and ``boxes`` (the model's
outputs) and ``queries`` (1, MAX_BOXES), each row's query.

Counters, while the tracer records: ``bev.history_used`` (calls whose
forward took the path with the previous BEV, the model's ``history_used``)
and ``bev.scene_starts`` (the others), summed on the device
(``trace.add_on_device``): the decode reads nothing back from the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.bevformer import NUM_CLASSES
from ..utils import trace

MAX_BOXES = 300
POST_CENTER_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
ROW = 11


class BEVFormerDecoder:
    def __call__(self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 output_depth: Optional[str] = None):
        with trace.span("decode.bevformer"):
            cls, boxes = outputs["cls"], outputs["boxes"]
            scores, idx = cls.sigmoid().flatten().topk(MAX_BOXES)
            labels, query = idx % NUM_CLASSES, idx // NUM_CLASSES
            b = boxes[query]
            w, l, h = b[:, 2].exp(), b[:, 3].exp(), b[:, 5].exp()
            yaw = torch.atan2(b[:, 6], b[:, 7])
            centre = torch.stack([b[:, 0], b[:, 1], b[:, 4]], -1)
            valid = torch.ones_like(scores, dtype=torch.bool)
            for i in range(3):
                valid &= (centre[:, i] >= POST_CENTER_RANGE[i]) & (
                    centre[:, i] <= POST_CENTER_RANGE[i + 3])
            rows = torch.stack([centre[:, 0], centre[:, 1], centre[:, 2] - h * 0.5, w, l, h,
                                yaw, b[:, 8], b[:, 9], scores, labels.float()], -1)
        if trace.recording():
            used = outputs["history_used"]
            trace.add_on_device("bev.history_used", used)
            trace.add_on_device("bev.scene_starts", 1 - used)
        extras = {"bev": outputs["bev"], "cls": cls, "boxes": boxes, "queries": query[None]}
        return rows[None], valid[None], extras
