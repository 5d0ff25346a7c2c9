"""BEVFormer-base (Li et al., "BEVFormer: Learning Bird's-Eye-View
Representation from Multi-Camera Images via Spatiotemporal Transformers",
ECCV 2022, arXiv:2203.17270; ``projects/configs/bevformer/bevformer_base.py``
of github.com/fundamentalvision/BEVFormer), the port's third
meta-architecture (``MODEL.META_ARCHITECTURE`` "BEVFormer"), evaluation
path only.

One call is one sample: the six cameras' images (N, H, W, 3) uint8, each
camera's ``lidar2img`` (N, 4, 4), the sample's CAN-bus vector (18,) and a
scene-start flag (1,), all tensors on the model's device.

- Trunk and neck: FCOS3D's caffe ResNet-101 with DCNv2 in stages 3-4
  (``backbone/resnet.py``) on the normalised images padded to a multiple of
  32, and ``FPN(extra=1)``: P3-P6, each flattened per camera, plus the
  camera's and the level's embedding.
- BEV queries: ``bev_embedding`` (H_bev * W_bev, 256) plus the CAN-bus MLP
  of the CAN-bus vector; the learned positional encoding (column and row
  embeddings, 128 each).
- History: the previous call's BEV, kept in ``prev_bev`` (a buffer this
  forward reads and then overwrites with its own BEV), rotated by the yaw
  change ``can_bus[17]`` (degrees) about the grid's centre, nearest and
  zero-filled as torchvision's ``rotate`` (``rotation_index``: an index map
  built on the device from the device-side angle), and its reference points
  shifted by the ego translation (``bev_shift``, published ``use_shift``).
  Where ``scene_start`` is set the forward takes the no-history path by
  ``torch.where``: one graph for both paths, no host sync.
- Encoder, ``ENCODER_LAYERS`` post-norm layers: temporal self-attention
  (8 heads, 1 level, 4 points, 2 BEV queues), spatial cross-attention (8
  heads, 4 levels, 8 points over 4 pillar heights), FFN 256-512-256.
- Decoder, ``DECODER_LAYERS`` layers over ``NUM_QUERY`` queries:
  self-attention, deformable cross-attention on the BEV (8 heads, 1 level, 4
  points), FFN, each followed by a LayerNorm, and iterative box refinement
  by the per-layer regression branches.
- Returns ``{"bev": (H_bev * W_bev, 256), "cls": (NUM_QUERY, 10),
  "boxes": (NUM_QUERY, 10), "history_used": (1,)}``, the boxes' centre
  mapped onto ``PC_RANGE`` (``decode/bevformer.py`` decodes them), and 1
  where the forward took the path with the history, else 0.

The spatial cross-attention's queries are fixed in number: every camera
takes all H_bev * W_bev cells, and the cells whose four pillar points all
fall outside its image are masked in the kernel (``ops/msda.py``), which
sums a cell's visible cameras and divides by their count.  That is the
published rebatch (each camera's cells found by ``nonzero`` and padded to
the call's longest list) without its host sync and data-dependent shapes;
the offsets and attention weights are projected once per cell, since each
camera's rebatched query is the same cell's query.

Precision: under ``TPU.COMPUTE_DTYPE`` "bfloat16" the trunk and FPN run as
FCOS3D's, and every dense layer of the transformer takes its input and
weights in bf16 and returns bf16 (``layers.Linear``); the sampling
locations, reference points, camera projection, softmaxes and LayerNorm
statistics stay in f32, as do the CAN-bus MLP's and the reference-point
projections and the branches' last layers (the logits and box codes).
The deformable attention (``ops/msda.py``, 18 calls a forward) reads bf16
values and f32 locations and weights.  Spans: ``bev.encoder``,
``bev.decoder`` (on eager calls).

Widths and depths are module constants (no config key sets them; a test
patches them before the model is built).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda import msda_forward
from ..utils import trace
from .layers import LayerNorm, Linear, set_compute_dtype

EMBED = 256
HEADS = 8
FFN_DIM = 512
BEV_H = BEV_W = 200
ENCODER_LAYERS = 6
DECODER_LAYERS = 6
NUM_QUERY = 900
NUM_CLASSES = 10
CODE_SIZE = 10
NUM_CAMS = 6
NUM_LEVELS = 4
SCA_POINTS = 8
TSA_POINTS = 4
TSA_QUEUE = 2
DECODER_POINTS = 4
PILLAR_POINTS = 4
REG_FCS = 2
CAN_BUS_DIMS = 18
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
PROJECTION_EPS = 1e-5
CLS_PRIOR = 0.01


class Linear32(nn.Linear):
    """A dense layer that stays f32 whatever the model's compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """mmdet's: log(x / (1 - x)) with both clamped at ``eps``."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class FFN(nn.Module):
    """mmcv's FFN at 256-512-256 with its residual (ReLU; its dropouts are
    identities at eval)."""

    def __init__(self):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(Linear(EMBED, FFN_DIM), nn.ReLU()),
                                    Linear(FFN_DIM, EMBED))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layers(x)


def _ring(heads: int, levels: int, points: int) -> torch.Tensor:
    """The published sampling-offset bias: each head's direction on the
    unit square's boundary, times the point's index plus 1."""
    thetas = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = (grid / grid.abs().max(-1, keepdim=True)[0]).view(heads, 1, 1, 2)
    grid = grid.repeat(1, levels, points, 1)
    for i in range(points):
        grid[:, :, i, :] *= i + 1
    return grid.flatten()


class TemporalSelfAttention(nn.Module):
    """Deformable self-attention over two BEV queues: the (rotated) history
    and the layer-0 query, or twice the current query without history; the
    queues' results averaged."""
    levels, points, queue = 1, TSA_POINTS, TSA_QUEUE

    def __init__(self):
        super().__init__()
        n = HEADS * self.queue * self.levels * self.points
        self.sampling_offsets = Linear(EMBED * self.queue, n * 2)
        self.attention_weights = Linear(EMBED * self.queue, n)
        self.value_proj = Linear(EMBED, EMBED)
        self.output_proj = Linear(EMBED, EMBED)

    def ring(self) -> torch.Tensor:
        return _ring(HEADS, self.levels * self.queue, self.points)

    def forward(self, q, pos, hist, q0, start, ref, shift, bev_hw):
        Q = q.shape[0]
        v0 = torch.where(start, q, hist)
        v1 = torch.where(start, q, q0)
        value = self.value_proj(torch.stack([v0, v1])).view(self.queue, Q, HEADS, -1)
        x = torch.cat([v0, q + pos], -1)
        off = self.sampling_offsets(x).float().view(Q, HEADS, self.queue, self.levels,
                                                     self.points, 2)
        w = self.attention_weights(x).float().view(Q, HEADS, self.queue, -1).softmax(-1)
        w = w.view(Q, HEADS, self.queue, self.levels, self.points)
        refs = torch.stack([ref + torch.where(start, torch.zeros_like(shift), shift), ref])
        out = msda_forward(value, [bev_hw], refs[:, :, None], off, w, scale=1.0 / self.queue)
        return self.output_proj(out) + q


class MSDeformableAttention3D(nn.Module):
    """The spatial cross-attention's sampling: its 8 points a level are 2
    around each of the 4 pillar heights' projections; no output
    projection."""
    levels, points = NUM_LEVELS, SCA_POINTS

    def __init__(self):
        super().__init__()
        n = HEADS * self.levels * self.points
        self.sampling_offsets = Linear(EMBED, n * 2)
        self.attention_weights = Linear(EMBED, n)
        self.value_proj = Linear(EMBED, EMBED)

    def ring(self) -> torch.Tensor:
        return _ring(HEADS, self.levels, self.points)


class SpatialCrossAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.deformable_attention = MSDeformableAttention3D()
        self.output_proj = Linear(EMBED, EMBED)

    def forward(self, q, feats, shapes, ref_cam, visible):
        da = self.deformable_attention
        N, S, _ = feats.shape
        Q, L, P = q.shape[0], da.levels, da.points
        value = da.value_proj(feats).view(N, S, HEADS, -1)
        off = da.sampling_offsets(q).float().view(Q, HEADS, 1, L, P, 2)
        w = da.attention_weights(q).float().view(Q, HEADS, L * P).softmax(-1)
        out = msda_forward(value, shapes, ref_cam, off, w.view(Q, HEADS, 1, L, P),
                           mask=visible)
        return self.output_proj(out) + q


class CustomMSDeformableAttention(nn.Module):
    """The decoder's deformable cross-attention on the BEV."""
    levels, points = 1, DECODER_POINTS

    def __init__(self):
        super().__init__()
        n = HEADS * self.levels * self.points
        self.sampling_offsets = Linear(EMBED, n * 2)
        self.attention_weights = Linear(EMBED, n)
        self.value_proj = Linear(EMBED, EMBED)
        self.output_proj = Linear(EMBED, EMBED)

    def ring(self) -> torch.Tensor:
        return _ring(HEADS, self.levels, self.points)

    def forward(self, q, pos, bev, ref, bev_hw):
        x = q + pos
        n = q.shape[0]
        value = self.value_proj(bev).view(1, bev.shape[0], HEADS, -1)
        off = self.sampling_offsets(x).float().view(n, HEADS, 1, self.levels, self.points, 2)
        w = self.attention_weights(x).float().view(n, HEADS, -1).softmax(-1)
        out = msda_forward(value, [bev_hw], ref[None, :, None, :2],
                           off, w.view(n, HEADS, 1, self.levels, self.points))
        return self.output_proj(out) + q


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters and arithmetic in the compute
    dtype (its softmax in f32): q = k = query + pos, v = query."""
    compute_dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * EMBED, EMBED))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * EMBED))
        self.out_proj = Linear(EMBED, EMBED)

    def forward(self, q, k, v):
        dt, C, n, d = self.compute_dtype, EMBED, q.shape[0], EMBED // HEADS
        W, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        qh = F.linear(q.to(dt), W[:C], b[:C]).view(n, HEADS, d).transpose(0, 1)
        kh = F.linear(k.to(dt), W[C:2 * C], b[C:2 * C]).view(n, HEADS, d).transpose(0, 1)
        vh = F.linear(v.to(dt), W[2 * C:], b[2 * C:]).view(n, HEADS, d).transpose(0, 1)
        p = torch.bmm(qh * d ** -0.5, kh.transpose(1, 2)).float().softmax(-1)
        out = torch.bmm(p.to(dt), vh).transpose(0, 1).reshape(n, C)
        return self.out_proj(out)


class _SelfAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = MultiheadAttention()

    def forward(self, q, pos):
        return q + self.attn(q + pos, q + pos, q)


class EncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.attentions = nn.ModuleList([TemporalSelfAttention(), SpatialCrossAttention()])
        self.norms = nn.ModuleList(LayerNorm(EMBED) for _ in range(3))
        self.ffns = nn.ModuleList([FFN()])


class DecoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.attentions = nn.ModuleList([_SelfAttention(), CustomMSDeformableAttention()])
        self.norms = nn.ModuleList(LayerNorm(EMBED) for _ in range(3))
        self.ffns = nn.ModuleList([FFN()])


class _Layers(nn.Module):
    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PerceptionTransformer(nn.Module):
    def __init__(self):
        super().__init__()
        self.level_embeds = nn.Parameter(torch.empty(NUM_LEVELS, EMBED))
        self.cams_embeds = nn.Parameter(torch.empty(NUM_CAMS, EMBED))
        self.reference_points = Linear32(EMBED, 3)
        self.can_bus_mlp = nn.Sequential(Linear32(CAN_BUS_DIMS, EMBED // 2), nn.ReLU(),
                                         Linear32(EMBED // 2, EMBED), nn.ReLU())
        self.can_bus_mlp.add_module("norm", LayerNorm(EMBED))
        self.encoder = _Layers([EncoderLayer() for _ in range(ENCODER_LAYERS)])
        self.decoder = _Layers([DecoderLayer() for _ in range(DECODER_LAYERS)])


class _PositionalEncoding(nn.Module):
    """mmdet's LearnedPositionalEncoding: cat(column, row) embeddings."""

    def __init__(self, h: int, w: int):
        super().__init__()
        self.row_embed = nn.Embedding(h, EMBED // 2)
        self.col_embed = nn.Embedding(w, EMBED // 2)

    def forward(self) -> torch.Tensor:
        h, w = self.row_embed.num_embeddings, self.col_embed.num_embeddings
        return torch.cat([self.col_embed.weight[None].expand(h, w, -1),
                          self.row_embed.weight[:, None].expand(h, w, -1)], -1).reshape(h * w, -1)


def cls_branch() -> nn.Sequential:
    layers: List[nn.Module] = []
    for _ in range(REG_FCS):
        layers += [Linear(EMBED, EMBED), LayerNorm(EMBED), nn.ReLU()]
    return nn.Sequential(*layers, Linear32(EMBED, NUM_CLASSES))


def reg_branch() -> nn.Sequential:
    layers: List[nn.Module] = []
    for _ in range(REG_FCS):
        layers += [Linear(EMBED, EMBED), nn.ReLU()]
    return nn.Sequential(*layers, Linear32(EMBED, CODE_SIZE))


def bev_shift(can_bus: torch.Tensor, bev_h: int, bev_w: int) -> torch.Tensor:
    """The history's shift (x, y) in grid fractions from the CAN bus (the
    translation since the last sample in ``can_bus[0:2]``, the ego yaw in
    radians in ``can_bus[16]``), published ``use_shift``."""
    dx, dy = can_bus[0], can_bus[1]
    length = torch.sqrt(dx * dx + dy * dy)
    bev_angle = can_bus[16] - torch.atan2(dy, dx)
    cell_y = (PC_RANGE[4] - PC_RANGE[1]) / bev_h
    cell_x = (PC_RANGE[3] - PC_RANGE[0]) / bev_w
    return torch.stack([length * torch.sin(bev_angle) / cell_x / bev_w,
                        length * torch.cos(bev_angle) / cell_y / bev_h])


def rotation_index(angle_deg: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """For each cell of an (h, w) grid, the cell that torchvision's
    ``rotate(img, angle, center=(w / 2, h / 2))`` (nearest, zero fill)
    reads, flattened row-major, or -1 outside: the inverse rotation's
    affine grid and ``grid_sample``'s unnormalisation, rounded half to
    even as its nearest mode rounds, computed on the device from the
    device-side angle."""
    dev = angle_deg.device
    rad = angle_deg.double() * (math.pi / 180.0)      # its matrix: Python floats
    c, s = torch.cos(rad).float(), torch.sin(rad).float()
    x = (torch.arange(w, device=dev, dtype=torch.float32) - (w * 0.5 - 0.5))[None, :]
    y = (torch.arange(h, device=dev, dtype=torch.float32) - (h * 0.5 - 0.5))[:, None]
    gx = x * (c / (0.5 * w)) + y * (-s / (0.5 * w))
    gy = x * (s / (0.5 * h)) + y * (c / (0.5 * h))
    ix = torch.round(((gx + 1) * w - 1) / 2)
    iy = torch.round(((gy + 1) * h - 1) / 2)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    return torch.where(inside, iy * w + ix, torch.full_like(ix, -1)).long().flatten()


def rotate_bev(prev: torch.Tensor, angle_deg: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``prev`` (h * w, C) rotated by ``angle_deg`` (``rotation_index``)."""
    idx = rotation_index(angle_deg, h, w)
    return torch.where((idx >= 0)[:, None], prev[idx.clamp(min=0)], torch.zeros_like(prev[:1]))


def point_sampling(ref_3d: torch.Tensor, lidar2img: torch.Tensor, img_hw: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pillar points ``ref_3d`` (D, Q, 4), homogeneous lidar
    coordinates, projected by each camera's ``lidar2img`` (N, 4, 4) in f32
    (elementwise, no matrix unit): (ref_cam (N, Q, D, 2) pixel / image
    size, visible (N, Q): any point with depth over 1e-5 strictly inside
    the padded image)."""
    cam = (lidar2img.float()[:, None, None] * ref_3d[None, :, :, None, :]).sum(-1)
    depth = cam[..., 2:3]
    keep = depth > PROJECTION_EPS
    uv = cam[..., 0:2] / torch.maximum(depth, torch.full_like(depth, PROJECTION_EPS))
    uv = torch.stack([uv[..., 0] / img_hw[1], uv[..., 1] / img_hw[0]], -1)
    keep = (keep & (uv[..., 1:2] > 0.0) & (uv[..., 1:2] < 1.0)
            & (uv[..., 0:1] < 1.0) & (uv[..., 0:1] > 0.0))[..., 0]
    return uv.permute(0, 2, 1, 3).contiguous(), keep.any(1)


class BEVFormer(nn.Module):
    """BEVFormer-base (module docstring)."""

    arch = "BEVFormer"

    def __init__(self, backbone: nn.Module, fpn: nn.Module, size_divisor: int,
                 pixel_mean: Sequence[float], pixel_std: Sequence[float], to_bgr: bool):
        super().__init__()
        self.backbone, self.fpn = backbone, fpn
        self.bev_h, self.bev_w = BEV_H, BEV_W
        Q = self.bev_h * self.bev_w
        self.bev_embedding = nn.Embedding(Q, EMBED)
        self.query_embedding = nn.Embedding(NUM_QUERY, 2 * EMBED)
        self.positional_encoding = _PositionalEncoding(self.bev_h, self.bev_w)
        self.transformer = PerceptionTransformer()
        self.cls_branches = nn.ModuleList(cls_branch() for _ in range(DECODER_LAYERS))
        self.reg_branches = nn.ModuleList(reg_branch() for _ in range(DECODER_LAYERS))
        self.size_divisor, self.to_bgr = size_divisor, to_bgr
        self.mean_std = (tuple(pixel_mean), tuple(pixel_std))
        self.compute_dtype = torch.float32
        # not in the state dict: constants of the grid and the config
        for name, shape in (("pixel_mean", (3,)), ("pixel_std", (3,)), ("ref_2d", (Q, 2)),
                            ("ref_3d", (PILLAR_POINTS, Q, 4)), ("prev_bev", (Q, EMBED))):
            self.register_buffer(name, torch.empty(shape), persistent=False)

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """The trunk, FPN and transformer in ``dtype``; the history buffer
        holds the BEV in it."""
        for part in (self.backbone, self.fpn, self.transformer, self.cls_branches,
                     self.reg_branches):
            set_compute_dtype(part, dtype)
        self.compute_dtype = dtype
        self.prev_bev = torch.empty_like(self.prev_bev, dtype=dtype)

    @torch.no_grad()
    def reset_buffers(self) -> None:
        """The grid's reference points, the normalisation and an empty
        history."""
        dev, H, W = self.prev_bev.device, self.bev_h, self.bev_w
        self.pixel_mean.copy_(torch.tensor(self.mean_std[0]))
        self.pixel_std.copy_(torch.tensor(self.mean_std[1]))
        ys = (torch.arange(H, dtype=torch.float32) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32) + 0.5) / W
        y, x = torch.meshgrid(ys, xs, indexing="ij")
        self.ref_2d.copy_(torch.stack([x.flatten(), y.flatten()], -1))
        z_span = PC_RANGE[5] - PC_RANGE[2]
        zs = torch.linspace(0.5, z_span - 0.5, PILLAR_POINTS) / z_span
        lo, hi = torch.tensor(PC_RANGE[:3]), torch.tensor(PC_RANGE[3:])
        xyz = torch.stack([x.flatten()[None].expand(PILLAR_POINTS, -1),
                           y.flatten()[None].expand(PILLAR_POINTS, -1),
                           zs[:, None].expand(-1, H * W)], -1) * (hi - lo) + lo
        self.ref_3d.copy_(torch.cat([xyz, torch.ones(PILLAR_POINTS, H * W, 1)], -1).to(dev))
        self.prev_bev.zero_()

    def graph_inputs(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The forward's inputs from an evaluation batch."""
        return batch["image"], batch["lidar2img"], batch["can_bus"], batch["scene_start"]

    def carried(self) -> List[torch.Tensor]:
        """The state a forward reads and overwrites (``train/eval_graph.py``
        keeps it across a capture's warm-up)."""
        return [self.prev_bev]

    def features(self, images: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[Tuple[int, int]], Tuple[int, int]]:
        """(the cameras' P3-P6 flattened with their embeddings (N, S, 256),
        the levels' shapes, the padded image's (H, W))."""
        from .detector import normalize      # detector.py imports this module

        x = normalize(images, self.pixel_mean, self.pixel_std, self.to_bgr)
        d = self.size_divisor
        if d > 1:
            H, W = x.shape[1:3]
            x = F.pad(x, (0, 0, 0, -W % d, 0, -H % d))
        img_hw = (x.shape[1], x.shape[2])
        maps = self.fpn(self.backbone(x.permute(0, 3, 1, 2)))
        N, dt = images.shape[0], self.compute_dtype
        t = self.transformer
        flat, shapes = [], []
        for lvl, m in enumerate(maps):
            h, w = m.shape[2:]
            f = m.permute(0, 2, 3, 1).reshape(N, h * w, -1)
            f = f + t.cams_embeds[:N, None].to(f.dtype)
            flat.append(f + t.level_embeds[lvl].to(f.dtype))
            shapes.append((h, w))
        return torch.cat(flat, 1).to(dt), shapes, img_hw

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor, can_bus: torch.Tensor,
                scene_start: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats, shapes, img_hw = self.features(images)
        dt, t = self.compute_dtype, self.transformer
        H, W = self.bev_h, self.bev_w
        can_bus = can_bus.float().reshape(CAN_BUS_DIMS)
        start = scene_start.reshape(1).bool()
        with trace.span("bev.encoder"):
            q = self.bev_embedding.weight.to(dt) + t.can_bus_mlp(can_bus[None]).to(dt)
            pos = self.positional_encoding().to(dt)
            hist = rotate_bev(self.prev_bev, can_bus[17], H, W)
            shift = bev_shift(can_bus, H, W)
            ref_cam, visible = point_sampling(self.ref_3d, lidar2img, img_hw)
            q0 = q
            for layer in t.encoder.layers:
                tsa, sca = layer.attentions
                q = layer.norms[0](tsa(q, pos, hist, q0, start, self.ref_2d, shift, (H, W)))
                q = layer.norms[1](sca(q, feats, shapes, ref_cam, visible))
                q = layer.norms[2](layer.ffns[0](q))
            bev = q
        with trace.span("bev.decoder"):
            qpos, query = self.query_embedding.weight.to(dt).split(EMBED, -1)
            ref = t.reference_points(qpos).sigmoid()
            for k, layer in enumerate(t.decoder.layers):
                mha, msda = layer.attentions
                query = layer.norms[0](mha(query, qpos))
                query = layer.norms[1](msda(query, qpos, bev, ref, (H, W)))
                query = layer.norms[2](layer.ffns[0](query))
                tmp = self.reg_branches[k](query)
                xy = (tmp[:, 0:2] + inverse_sigmoid(ref[:, 0:2])).sigmoid()
                z = (tmp[:, 4:5] + inverse_sigmoid(ref[:, 2:3])).sigmoid()
                ref = torch.cat([xy, z], -1)
            cls = self.cls_branches[-1](query)
            centre = torch.stack([ref[:, i] * (PC_RANGE[i + 3] - PC_RANGE[i]) + PC_RANGE[i]
                                  for i in range(3)], -1)
            boxes = torch.cat([centre[:, 0:2], tmp[:, 2:4], centre[:, 2:3], tmp[:, 5:]], -1)
        self.prev_bev.copy_(bev)
        return {"bev": bev, "cls": cls, "boxes": boxes, "history_used": (~start).int()}


def _generator(seed: int, name: str) -> torch.Generator:
    """A parameter's own generator: its draws depend on the seed and its
    name alone, not on the order the model registers its modules."""
    return torch.Generator().manual_seed((int(seed) * 1000003 + zlib.crc32(name.encode()))
                                         % 2 ** 63)


@torch.no_grad()
def init_weights(model: BEVFormer, seed: int) -> None:
    """Seeded weights, each parameter drawn from its own generator
    (``_generator``), as the published ``init_weights`` draws them:
    convolutions lecun-normal, each DCN's offset/mask conv zero, norms at
    identity, every other matrix xavier-uniform with zero bias, the
    embeddings N(0, 1) (the positional ones U(0, 1)), the deformable
    attentions' sampling offsets zero with the direction ring as bias and
    their attention weights zero, the class branches' last bias at the
    prior 0.01; then the model's constant buffers."""
    norms = (nn.modules.batchnorm._BatchNorm, nn.LayerNorm, nn.GroupNorm)
    owner = {f"{m}.{p}" if m else p: mod for m, mod in model.named_modules()
             for p, _ in mod.named_parameters(recurse=False)}
    for name, p in model.named_parameters():
        mod, g = owner[name], _generator(seed, name)
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, norms):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif ".conv_offset_mask." in name or name.endswith(
                ("sampling_offsets.weight", "attention_weights.weight", "attention_weights.bias")):
            p.zero_()
        elif isinstance(mod, nn.Embedding):
            draw = torch.rand if "positional_encoding" in name else torch.randn
            p.copy_(draw(p.shape, generator=g))
        elif leaf in ("level_embeds", "cams_embeds"):
            p.copy_(torch.randn(p.shape, generator=g))
        elif p.dim() == 4:
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
        elif p.dim() == 2:
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
        else:
            p.zero_()
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif hasattr(m, "ring"):
            m.sampling_offsets.bias.copy_(m.ring())
    for branch in model.cls_branches:
        branch[-1].bias.fill_(-math.log((1 - CLS_PRIOR) / CLS_PRIOR))
    model.reset_buffers()
