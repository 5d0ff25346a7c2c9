"""BEVFormer-base in plain PyTorch: the reference that the port's BEVFormer
(``monoflex_tpu_torch``'s ``MODEL.META_ARCHITECTURE`` "BEVFormer") is held
to.  It imports neither JAX nor the port; its trunk and FPN are those of
the plain FCOS3D (``plain_fcos3d.py``).

What it is: ``projects/configs/bevformer/bevformer_base.py`` of
github.com/fundamentalvision/BEVFormer (Li et al., ECCV 2022,
arXiv:2203.17270) at its published widths, written as the published
modules compute, one sample (six cameras) at a time:

- the images caffe-normalised and zero-padded to a multiple of 32, a caffe
  ResNet-101 with modulated DCNv2 in stages 3-4 and frozen BN, an FPN on
  C3-C5 with one extra conv on P5's output: P3-P6, flattened per camera,
  plus ``cams_embeds`` and ``level_embeds``;
- ``get_bev_features``: the BEV queries ``bev_embedding`` plus the CAN-bus
  MLP (Linear 18-128, ReLU, Linear 128-256, ReLU, LayerNorm), the learned
  positional encoding (cat of column and row embeddings); with a history,
  the shift of the reference points from the CAN bus (in float64, as the
  published numpy) and the previous BEV rotated by ``can_bus[-1]`` degrees
  about the grid's centre by torchvision's tensor ``rotate`` (its inverse
  affine matrix, its affine grid and ``grid_sample``'s nearest mode, zero
  fill);
- the encoder: pillar points at 4 heights projected into each camera
  (``point_sampling``), ``ENCODER_LAYERS`` layers of temporal
  self-attention, norm, spatial cross-attention, norm, FFN, norm; the
  spatial cross-attention rebatches each camera's visible cells, found by
  ``nonzero`` and padded to the call's longest list, runs
  ``MSDeformableAttention3D`` on them and scatters the results back,
  divided by the number of cameras that see each cell;
- the decoder: 900 queries (``query_embedding`` split into position and
  query), reference points sigmoid(Linear(pos)), ``DECODER_LAYERS`` layers
  of self-attention, norm, deformable cross-attention on the BEV, norm, FFN,
  norm, with iterative box refinement by the per-layer regression branches;
  the last layer's class and regression branches give the outputs;
- ``decode``: ``NMSFreeCoder`` (the 300 best of the 900 x 10 sigmoid
  scores, denormalised, the post-centre range) and ``get_bboxes``'s move
  of z to the box's bottom.

Every deformable attention is mmcv's ``multi_scale_deformable_attn_pytorch``
(``F.grid_sample`` level by level).

Departures from the published code, each one the port shares:

- the DCN clamps each offset to +-``max_offset`` and samples x rounded to
  ``transfer_dtype`` (``plain_fcos3d.py``'s), and carries a zero bias;
- ``rotate_center`` is the grid's centre (W / 2, H / 2): the published
  (100, 100) at 200 x 200;
- the spatial cross-attention sums the cameras' results in float32 (the
  published sums in the query's dtype).

Precision: float32 with TF32 off, or, with ``compute_dtype`` bfloat16, the
port's bf16 mode mirrored: the trunk and FPN as ``plain_fcos3d.py``'s, and
every dense layer of the transformer in bf16 (its input, kernel and bias
cast), its values sampled in float32; the locations, reference points,
projection, softmaxes and LayerNorm statistics in float32, as are the
CAN-bus MLP, the reference-point projection and the branches' last
layers.  ``Linear.fake_quant`` rounds a layer's input and kernel for a
control.

Weights: ``init(model, seed)`` draws what the port's ``build_model`` draws
from the same seed: each parameter from its own generator, seeded by the
seed and the parameter's name, by the same rules (``init``).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

try:
    from ..reference_fcos3d import fcos3d as trunk     # the benchmark's frozen copy
except ImportError:
    import plain_fcos3d as trunk                        # the tests' copy

EMBED = 256
HEADS = 8
FFN_DIM = 512
NUM_QUERY = 900
NUM_CLASSES = 10
CODE_SIZE = 10
NUM_CAMS = 6
NUM_LEVELS = 4
PILLAR_POINTS = 4
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
POST_CENTER_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
MAX_BOXES = 300
CLS_PRIOR = 0.01


# ---------------------------------------------------------------------------
# layers


class Linear(nn.Linear):
    """A dense layer in ``compute_dtype`` (input, kernel and bias cast)."""
    compute_dtype = torch.float32
    fake_quant = None

    def forward(self, x):
        dt = self.compute_dtype
        q = self.fake_quant or (lambda t: t)
        return F.linear(q(x.to(dt)), q(self.weight.to(dt)), self.bias.to(dt))


class Linear32(nn.Linear):
    def forward(self, x):
        return F.linear(x.float(), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    compute_dtype = torch.float32

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


def multi_scale_deformable_attn(value, shapes, sampling_locations, attention_weights):
    """mmcv's ``multi_scale_deformable_attn_pytorch`` in float32: value (bs,
    keys, heads, dims), locations (bs, queries, heads, levels, points, 2),
    weights (bs, queries, heads, levels, points) -> (bs, queries, heads *
    dims)."""
    bs, _, num_heads, dims = value.shape
    _, nq, _, num_levels, num_points, _ = sampling_locations.shape
    value_list = value.float().split([h * w for h, w in shapes], dim=1)
    grids = 2 * sampling_locations - 1
    sampled = []
    for level, (h, w) in enumerate(shapes):
        v = value_list[level].flatten(2).transpose(1, 2).reshape(bs * num_heads, dims, h, w)
        g = grids[:, :, :, level].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
    aw = attention_weights.transpose(1, 2).reshape(bs * num_heads, 1, nq, num_levels * num_points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * aw).sum(-1).view(bs, num_heads * dims, nq)
    return out.transpose(1, 2).contiguous()


def _normalizer(shapes, device):
    s = torch.tensor(shapes, dtype=torch.float32, device=device)
    return torch.stack([s[..., 1], s[..., 0]], -1)


class TemporalSelfAttention(nn.Module):
    def __init__(self, num_levels=1, num_points=4, num_bev_queue=2):
        super().__init__()
        self.num_levels, self.num_points, self.num_bev_queue = num_levels, num_points, num_bev_queue
        n = HEADS * num_bev_queue * num_levels * num_points
        self.sampling_offsets = Linear(EMBED * num_bev_queue, n * 2)
        self.attention_weights = Linear(EMBED * num_bev_queue, n)
        self.value_proj = Linear(EMBED, EMBED)
        self.output_proj = Linear(EMBED, EMBED)

    def forward(self, query, value, query_pos, reference_points, shapes):
        if value is None:
            bs, len_bev, c = query.shape
            value = torch.stack([query, query], 1).reshape(bs * 2, len_bev, c)
        identity = query
        query = query + query_pos
        bs, nq, _ = query.shape
        _, nv, _ = value.shape
        query = torch.cat([value[:bs], query], -1)
        value = self.value_proj(value).reshape(bs * self.num_bev_queue, nv, HEADS, -1)
        off = self.sampling_offsets(query).float().view(
            bs, nq, HEADS, self.num_bev_queue, self.num_levels, self.num_points, 2)
        aw = self.attention_weights(query).float().view(
            bs, nq, HEADS, self.num_bev_queue, self.num_levels * self.num_points).softmax(-1)
        aw = aw.view(bs, nq, HEADS, self.num_bev_queue, self.num_levels, self.num_points)
        aw = aw.permute(0, 3, 1, 2, 4, 5).reshape(bs * self.num_bev_queue, nq, HEADS,
                                                  self.num_levels, self.num_points)
        off = off.permute(0, 3, 1, 2, 4, 5, 6).reshape(bs * self.num_bev_queue, nq, HEADS,
                                                       self.num_levels, self.num_points, 2)
        norm = _normalizer(shapes, off.device)
        loc = (reference_points[:, :, None, :, None, :]
               + off / norm[None, None, None, :, None, :])
        out = multi_scale_deformable_attn(value, shapes, loc, aw)
        out = out.permute(1, 2, 0).view(nq, EMBED, bs, self.num_bev_queue).mean(-1)
        out = self.output_proj(out.permute(2, 0, 1).to(identity.dtype))
        return out + identity


class MSDeformableAttention3D(nn.Module):
    def __init__(self, num_levels=NUM_LEVELS, num_points=8):
        super().__init__()
        self.num_levels, self.num_points = num_levels, num_points
        self.sampling_offsets = Linear(EMBED, HEADS * num_levels * num_points * 2)
        self.attention_weights = Linear(EMBED, HEADS * num_levels * num_points)
        self.value_proj = Linear(EMBED, EMBED)

    def forward(self, query, value, reference_points, shapes):
        bs, nq, _ = query.shape
        value = self.value_proj(value).view(bs, value.shape[1], HEADS, -1)
        off = self.sampling_offsets(query).float().view(bs, nq, HEADS, self.num_levels,
                                                        self.num_points, 2)
        aw = self.attention_weights(query).float().view(
            bs, nq, HEADS, self.num_levels * self.num_points).softmax(-1)
        aw = aw.view(bs, nq, HEADS, self.num_levels, self.num_points)
        norm = _normalizer(shapes, off.device)
        _, _, num_z, _ = reference_points.shape
        ref = reference_points[:, :, None, None, None, :, :]
        off = off / norm[None, None, None, :, None, :]
        off = off.view(bs, nq, HEADS, self.num_levels, self.num_points // num_z, num_z, 2)
        loc = (ref + off).view(bs, nq, HEADS, self.num_levels, self.num_points, 2)
        return multi_scale_deformable_attn(value, shapes, loc, aw)


class SpatialCrossAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.deformable_attention = MSDeformableAttention3D()
        self.output_proj = Linear(EMBED, EMBED)

    def forward(self, query, value, reference_points_cam, bev_mask, shapes):
        """query (1, Q, C); value (cams, S, C); reference_points_cam (cams,
        1, Q, D, 2); bev_mask (cams, 1, Q, D)."""
        inp_residual = query
        slots = torch.zeros(query.shape, dtype=torch.float32, device=query.device)
        bs, nq, _ = query.shape
        D = reference_points_cam.size(3)
        indexes = [m[0].sum(-1).nonzero().squeeze(-1) for m in bev_mask]
        max_len = max(len(i) for i in indexes)
        num_cams = len(indexes)
        queries_rebatch = query.new_zeros([bs, num_cams, max_len, EMBED])
        ref_rebatch = reference_points_cam.new_zeros([bs, num_cams, max_len, D, 2])
        for j in range(bs):
            for i, ref_i in enumerate(reference_points_cam):
                idx = indexes[i]
                queries_rebatch[j, i, :len(idx)] = query[j, idx]
                ref_rebatch[j, i, :len(idx)] = ref_i[j, idx]
        queries = self.deformable_attention(
            queries_rebatch.view(bs * num_cams, max_len, EMBED), value,
            ref_rebatch.view(bs * num_cams, max_len, D, 2), shapes
        ).view(bs, num_cams, max_len, EMBED)
        for j in range(bs):
            for i, idx in enumerate(indexes):
                slots[j, idx] += queries[j, i, :len(idx)]
        count = (bev_mask.sum(-1) > 0).permute(1, 2, 0).sum(-1).clamp(min=1.0)
        slots = slots / count[..., None]
        return self.output_proj(slots.to(query.dtype)) + inp_residual


class CustomMSDeformableAttention(nn.Module):
    def __init__(self, num_levels=1, num_points=4):
        super().__init__()
        self.num_levels, self.num_points = num_levels, num_points
        self.sampling_offsets = Linear(EMBED, HEADS * num_levels * num_points * 2)
        self.attention_weights = Linear(EMBED, HEADS * num_levels * num_points)
        self.value_proj = Linear(EMBED, EMBED)
        self.output_proj = Linear(EMBED, EMBED)

    def forward(self, query, value, query_pos, reference_points, shapes):
        identity = query
        query = query + query_pos
        bs, nq, _ = query.shape
        value = self.value_proj(value).view(bs, value.shape[1], HEADS, -1)
        off = self.sampling_offsets(query).float().view(bs, nq, HEADS, self.num_levels,
                                                        self.num_points, 2)
        aw = self.attention_weights(query).float().view(
            bs, nq, HEADS, self.num_levels * self.num_points).softmax(-1)
        aw = aw.view(bs, nq, HEADS, self.num_levels, self.num_points)
        norm = _normalizer(shapes, off.device)
        loc = reference_points[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        out = multi_scale_deformable_attn(value, shapes, loc, aw)
        return self.output_proj(out.to(identity.dtype)) + identity


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters and arithmetic (q scaled by
    head_dim^-0.5, softmax in float32)."""
    compute_dtype = torch.float32
    fake_quant = None

    def __init__(self):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * EMBED, EMBED))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * EMBED))
        self.out_proj = Linear(EMBED, EMBED)

    def forward(self, query, key, value):
        dt, C = self.compute_dtype, EMBED
        q8 = self.fake_quant or (lambda t: t)
        W, b = q8(self.in_proj_weight.to(dt)), self.in_proj_bias.to(dt)
        n, d = query.shape[1], C // HEADS

        def heads(x, part):
            y = F.linear(q8(x[0].to(dt)), W[part * C:(part + 1) * C], b[part * C:(part + 1) * C])
            return y.view(n, HEADS, d).transpose(0, 1)
        qh, kh, vh = heads(query, 0), heads(key, 1), heads(value, 2)
        p = torch.bmm(qh * d ** -0.5, kh.transpose(1, 2)).float().softmax(-1)
        out = torch.bmm(p.to(dt), vh).transpose(0, 1).reshape(1, n, C)
        return self.out_proj(out)


class _SelfAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = MultiheadAttention()

    def forward(self, query, query_pos):
        q = query + query_pos
        return query + self.attn(q, q, query)


class _FFN(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(Linear(EMBED, FFN_DIM), nn.ReLU()),
                                    Linear(FFN_DIM, EMBED))

    def forward(self, x):
        return x + self.layers(x)


class EncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.attentions = nn.ModuleList([TemporalSelfAttention(), SpatialCrossAttention()])
        self.norms = nn.ModuleList(LayerNorm(EMBED) for _ in range(3))
        self.ffns = nn.ModuleList([_FFN()])


class DecoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.attentions = nn.ModuleList([_SelfAttention(), CustomMSDeformableAttention()])
        self.norms = nn.ModuleList(LayerNorm(EMBED) for _ in range(3))
        self.ffns = nn.ModuleList([_FFN()])


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PerceptionTransformer(nn.Module):
    def __init__(self, encoder_layers, decoder_layers):
        super().__init__()
        self.level_embeds = nn.Parameter(torch.empty(NUM_LEVELS, EMBED))
        self.cams_embeds = nn.Parameter(torch.empty(NUM_CAMS, EMBED))
        self.reference_points = Linear32(EMBED, 3)
        self.can_bus_mlp = nn.Sequential(Linear32(18, EMBED // 2), nn.ReLU(),
                                         Linear32(EMBED // 2, EMBED), nn.ReLU())
        self.can_bus_mlp.add_module("norm", LayerNorm(EMBED))
        self.encoder = _Layers([EncoderLayer() for _ in range(encoder_layers)])
        self.decoder = _Layers([DecoderLayer() for _ in range(decoder_layers)])


class _PositionalEncoding(nn.Module):
    def __init__(self, h, w):
        super().__init__()
        self.row_embed = nn.Embedding(h, EMBED // 2)
        self.col_embed = nn.Embedding(w, EMBED // 2)

    def forward(self, h, w):
        x_embed = self.col_embed(torch.arange(w, device=self.col_embed.weight.device))
        y_embed = self.row_embed(torch.arange(h, device=self.row_embed.weight.device))
        pos = torch.cat((x_embed.unsqueeze(0).repeat(h, 1, 1),
                         y_embed.unsqueeze(1).repeat(1, w, 1)), dim=-1)
        return pos.reshape(h * w, EMBED)[None]      # (1, h * w, C), row-major


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _branches(n):
    cls, reg = [], []
    for _ in range(n):
        c: List[nn.Module] = []
        r: List[nn.Module] = []
        for _ in range(2):
            c += [Linear(EMBED, EMBED), LayerNorm(EMBED), nn.ReLU()]
            r += [Linear(EMBED, EMBED), nn.ReLU()]
        cls.append(nn.Sequential(*c, Linear32(EMBED, NUM_CLASSES)))
        reg.append(nn.Sequential(*r, Linear32(EMBED, CODE_SIZE)))
    return nn.ModuleList(cls), nn.ModuleList(reg)


# ---------------------------------------------------------------------------
# geometry


def rotate(img: torch.Tensor, angle: float, center: Sequence[float]) -> torch.Tensor:
    """torchvision's ``rotate(img, angle, center=center)`` of a (C, H, W)
    tensor: nearest, zero fill, the output the input's size."""
    C, H, W = img.shape
    center_f = [1.0 * (c - s * 0.5) for c, s in zip(center, [W, H])]
    rot = math.radians(-angle)
    a, b, c, d = math.cos(rot), -math.sin(rot), math.sin(rot), math.cos(rot)
    matrix = [d, -b, 0.0, -c, a, 0.0]
    matrix[2] += matrix[0] * (-center_f[0]) + matrix[1] * (-center_f[1])
    matrix[5] += matrix[3] * (-center_f[0]) + matrix[4] * (-center_f[1])
    matrix[2] += center_f[0]
    matrix[5] += center_f[1]
    theta = torch.tensor(matrix, dtype=torch.float32, device=img.device).reshape(1, 2, 3)
    base = torch.empty(1, H, W, 3, dtype=torch.float32, device=img.device)
    base[..., 0].copy_(torch.linspace(-W * 0.5 + 0.5, W * 0.5 + 0.5 - 1, steps=W,
                                      device=img.device))
    base[..., 1].copy_(torch.linspace(-H * 0.5 + 0.5, H * 0.5 + 0.5 - 1, steps=H,
                                      device=img.device).unsqueeze_(-1))
    base[..., 2].fill_(1)
    rescaled = theta.transpose(1, 2) / torch.tensor([0.5 * W, 0.5 * H], device=img.device)
    grid = base.view(1, H * W, 3).bmm(rescaled).view(1, H, W, 2)
    out = F.grid_sample(img[None].float(), grid, mode="nearest", padding_mode="zeros",
                        align_corners=False)
    return out[0].to(img.dtype)


def reference_points_3d(h, w, z=8.0, num=PILLAR_POINTS, device="cpu"):
    zs = torch.linspace(0.5, z - 0.5, num, device=device).view(-1, 1, 1).expand(num, h, w) / z
    xs = torch.linspace(0.5, w - 0.5, w, device=device).view(1, 1, w).expand(num, h, w) / w
    ys = torch.linspace(0.5, h - 0.5, h, device=device).view(1, h, 1).expand(num, h, w) / h
    ref_3d = torch.stack((xs, ys, zs), -1)
    ref_3d = ref_3d.permute(0, 3, 1, 2).flatten(2).permute(0, 2, 1)
    return ref_3d[None]                                  # (1, D, h * w, 3)


def reference_points_2d(h, w, device="cpu"):
    ref_y, ref_x = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, device=device),
                                  torch.linspace(0.5, w - 0.5, w, device=device), indexing="ij")
    ref_2d = torch.stack((ref_x.reshape(-1)[None] / w, ref_y.reshape(-1)[None] / h), -1)
    return ref_2d.unsqueeze(2)                           # (1, h * w, 1, 2)


def point_sampling(reference_points, lidar2img, img_hw):
    """Published ``point_sampling`` for one sample: (reference_points_cam
    (cams, 1, Q, D, 2), bev_mask (cams, 1, Q, D))."""
    pc = PC_RANGE
    ref = reference_points.clone()
    ref[..., 0:1] = ref[..., 0:1] * (pc[3] - pc[0]) + pc[0]
    ref[..., 1:2] = ref[..., 1:2] * (pc[4] - pc[1]) + pc[1]
    ref[..., 2:3] = ref[..., 2:3] * (pc[5] - pc[2]) + pc[2]
    ref = torch.cat((ref, torch.ones_like(ref[..., :1])), -1)
    ref = ref.permute(1, 0, 2, 3)                        # (D, 1, Q, 4)
    D, B, nq = ref.size()[:3]
    l2i = lidar2img.float()[None]                        # (1, cams, 4, 4)
    num_cam = l2i.size(1)
    ref = ref.view(D, B, 1, nq, 4).repeat(1, 1, num_cam, 1, 1).unsqueeze(-1)
    l2i = l2i.view(1, B, num_cam, 1, 4, 4).repeat(D, 1, 1, nq, 1, 1)
    cam = torch.matmul(l2i, ref).squeeze(-1)
    eps = 1e-5
    bev_mask = cam[..., 2:3] > eps
    cam = cam[..., 0:2] / torch.maximum(cam[..., 2:3], torch.ones_like(cam[..., 2:3]) * eps)
    cam[..., 0] /= img_hw[1]
    cam[..., 1] /= img_hw[0]
    bev_mask = (bev_mask & (cam[..., 1:2] > 0.0) & (cam[..., 1:2] < 1.0)
                & (cam[..., 0:1] < 1.0) & (cam[..., 0:1] > 0.0))
    bev_mask = torch.nan_to_num(bev_mask.float()).bool()
    return cam.permute(2, 1, 3, 0, 4), bev_mask.permute(2, 1, 3, 0, 4).squeeze(-1)


def shift_from_can_bus(can_bus: np.ndarray, bev_h: int, bev_w: int) -> np.ndarray:
    """The published shift (x, y), in float64."""
    delta_x, delta_y = can_bus[0], can_bus[1]
    ego_angle = can_bus[-2] / np.pi * 180
    grid_length_y = (PC_RANGE[4] - PC_RANGE[1]) / bev_h
    grid_length_x = (PC_RANGE[3] - PC_RANGE[0]) / bev_w
    translation_length = np.sqrt(delta_x ** 2 + delta_y ** 2)
    translation_angle = np.arctan2(delta_y, delta_x) / np.pi * 180
    bev_angle = ego_angle - translation_angle
    shift_y = translation_length * np.cos(bev_angle / 180 * np.pi) / grid_length_y / bev_h
    shift_x = translation_length * np.sin(bev_angle / 180 * np.pi) / grid_length_x / bev_w
    return np.array([shift_x, shift_y])


# ---------------------------------------------------------------------------
# the model


class BEVFormer(nn.Module):
    def __init__(self, bev_h=200, bev_w=200, encoder_layers=6, decoder_layers=6,
                 num_query=NUM_QUERY, max_offset=2.0, transfer_dtype=torch.bfloat16,
                 compute_dtype=torch.float32,
                 pixel_mean=(0.406, 0.456, 0.485), pixel_std=(1 / 255,) * 3, to_bgr=True,
                 size_divisor=32):
        super().__init__()
        dcn = (float(max_offset), transfer_dtype)
        self.backbone = trunk.ResNet(trunk.BLOCKS, (False, False, True, True), dcn)
        self.fpn = trunk.FPN([w * 4 for w in trunk.WIDTHS[1:]], EMBED, 1)
        self.bev_h, self.bev_w = bev_h, bev_w
        self.bev_embedding = nn.Embedding(bev_h * bev_w, EMBED)
        self.query_embedding = nn.Embedding(num_query, 2 * EMBED)
        self.positional_encoding = _PositionalEncoding(bev_h, bev_w)
        self.transformer = PerceptionTransformer(encoder_layers, decoder_layers)
        self.cls_branches, self.reg_branches = _branches(decoder_layers)
        self.mean, self.std = torch.tensor(pixel_mean), torch.tensor(pixel_std)
        self.to_bgr, self.size_divisor = to_bgr, size_divisor
        self.compute_dtype = compute_dtype
        for part in (self.backbone, self.fpn, self.transformer, self.cls_branches,
                     self.reg_branches):
            for m in part.modules():
                if hasattr(m, "compute_dtype"):
                    m.compute_dtype = compute_dtype

    def features(self, images):
        x = images.float() / 255.0
        if self.to_bgr:
            x = x.flip(-1)
        x = (x - self.mean.to(x.device)) / self.std.to(x.device)
        d = self.size_divisor
        x = F.pad(x, (0, 0, 0, -x.shape[2] % d, 0, -x.shape[1] % d))
        img_hw = (x.shape[1], x.shape[2])
        maps = self.fpn(self.backbone(x.permute(0, 3, 1, 2).contiguous()))
        t = self.transformer
        flat, shapes = [], []
        for lvl, feat in enumerate(maps):
            n, c, h, w = feat.shape
            f = feat.flatten(2).permute(0, 2, 1)                     # (cams, hw, c)
            f = f + t.cams_embeds[:n, None, :].to(f.dtype)
            f = f + t.level_embeds[None, lvl:lvl + 1, :].to(f.dtype)
            flat.append(f)
            shapes.append((h, w))
        return torch.cat(flat, 1).to(self.compute_dtype), shapes, img_hw

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor, can_bus: torch.Tensor,
                prev_bev: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One sample; ``prev_bev`` (Q, C) the last sample's BEV or None at a
        scene start.  Returns the BEV (Q, C), the class logits and the box
        codes (900, 10) of the last decoder layer (centres on the range)."""
        trunk.no_tf32()
        dt, t, H, W = self.compute_dtype, self.transformer, self.bev_h, self.bev_w
        dev = images.device
        feats, shapes, img_hw = self.features(images)
        bus = can_bus.detach().double().cpu().numpy()
        bev_queries = self.bev_embedding.weight.to(dt)[None]
        bev_pos = self.positional_encoding(H, W).to(dt)
        shift = torch.tensor(shift_from_can_bus(bus, H, W), dtype=torch.float32, device=dev)
        if prev_bev is not None:
            rotated = rotate(prev_bev.to(dt).reshape(H, W, -1).permute(2, 0, 1), float(bus[-1]),
                             center=(W / 2, H / 2))
            prev_bev = rotated.permute(1, 2, 0).reshape(1, H * W, -1)
        bus_t = torch.tensor(bus, dtype=torch.float32, device=dev)[None]
        bev_query = bev_queries + t.can_bus_mlp(bus_t).to(dt)[:, None]
        # the encoder
        ref_3d = reference_points_3d(H, W, PC_RANGE[5] - PC_RANGE[2], device=dev)
        ref_2d = reference_points_2d(H, W, device=dev)
        ref_cam, bev_mask = point_sampling(ref_3d, lidar2img, img_hw)
        shift_ref_2d = ref_2d + shift[None, None, None, :]
        if prev_bev is not None:
            prev = torch.stack([prev_bev, bev_query], 1).reshape(2, H * W, -1)
            hybrid = torch.stack([shift_ref_2d, ref_2d], 1).reshape(2, H * W, 1, 2)
        else:
            prev = None
            hybrid = torch.stack([ref_2d, ref_2d], 1).reshape(2, H * W, 1, 2)
        q = bev_query
        for layer in t.encoder.layers:
            tsa, sca = layer.attentions
            q = layer.norms[0](tsa(q, prev, bev_pos, hybrid, [(H, W)]))
            q = layer.norms[1](sca(q, feats, ref_cam, bev_mask, shapes))
            q = layer.norms[2](layer.ffns[0](q))
        bev = q
        # the decoder
        qpos, query = torch.split(self.query_embedding.weight.to(dt), EMBED, dim=1)
        qpos, query = qpos[None], query[None]
        ref = t.reference_points(qpos).sigmoid()
        tmp = None
        for lid, layer in enumerate(t.decoder.layers):
            mha, msda = layer.attentions
            query = layer.norms[0](mha(query, qpos))
            query = layer.norms[1](msda(query, bev, qpos, ref[..., :2].unsqueeze(2), [(H, W)]))
            query = layer.norms[2](layer.ffns[0](query))
            tmp = self.reg_branches[lid](query)
            new_ref = torch.zeros_like(ref)
            new_ref[..., :2] = tmp[..., :2] + inverse_sigmoid(ref[..., :2])
            new_ref[..., 2:3] = tmp[..., 4:5] + inverse_sigmoid(ref[..., 2:3])
            last_ref, ref = ref, new_ref.sigmoid()
        cls = self.cls_branches[-1](query)
        # the head's outputs of the last layer (its reference: the layer's input)
        reference = inverse_sigmoid(last_ref)
        out = self.reg_branches[-1](query).clone()
        out[..., 0:2] = (out[..., 0:2] + reference[..., 0:2]).sigmoid()
        out[..., 4:5] = (out[..., 4:5] + reference[..., 2:3]).sigmoid()
        pc = PC_RANGE
        out[..., 0:1] = out[..., 0:1] * (pc[3] - pc[0]) + pc[0]
        out[..., 1:2] = out[..., 1:2] * (pc[4] - pc[1]) + pc[1]
        out[..., 4:5] = out[..., 4:5] * (pc[5] - pc[2]) + pc[2]
        return {"bev": bev[0], "cls": cls[0], "boxes": out[0]}


# ---------------------------------------------------------------------------
# weights


def _generator(seed: int, name: str) -> torch.Generator:
    return torch.Generator().manual_seed((int(seed) * 1000003 + zlib.crc32(name.encode()))
                                         % 2 ** 63)


def _ring(heads, levels, points):
    thetas = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid_init = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid_init = (grid_init / grid_init.abs().max(-1, keepdim=True)[0]).view(
        heads, 1, 1, 2).repeat(1, levels, points, 1)
    for i in range(points):
        grid_init[:, :, i, :] *= i + 1
    return grid_init.view(-1)


@torch.no_grad()
def init(model: BEVFormer, seed: int) -> None:
    """The port's seeded weights (module docstring): each parameter from
    its own generator; convs lecun-normal, DCN offset/mask convs zero,
    norms identity, matrices xavier-uniform with zero bias, embeddings
    N(0, 1) (positional U(0, 1)), sampling offsets zero with the published
    direction ring as bias, attention weights zero, the class prior on the
    class branches' last bias."""
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
        elif isinstance(m, TemporalSelfAttention):
            m.sampling_offsets.bias.copy_(_ring(HEADS, m.num_levels * m.num_bev_queue,
                                                m.num_points))
        elif isinstance(m, (MSDeformableAttention3D, CustomMSDeformableAttention)):
            m.sampling_offsets.bias.copy_(_ring(HEADS, m.num_levels, m.num_points))
    for branch in model.cls_branches:
        branch[-1].bias.fill_(-math.log((1 - CLS_PRIOR) / CLS_PRIOR))


# ---------------------------------------------------------------------------
# the decode


def denormalize_bbox(b: torch.Tensor) -> torch.Tensor:
    rot = torch.atan2(b[..., 6:7], b[..., 7:8])
    w, l, h = b[..., 2:3].exp(), b[..., 3:4].exp(), b[..., 5:6].exp()
    return torch.cat([b[..., 0:1], b[..., 1:2], b[..., 4:5], w, l, h, rot, b[..., 8:9],
                      b[..., 9:10]], dim=-1)


def decode(cls: torch.Tensor, boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``NMSFreeCoder.decode_single`` and ``get_bboxes``: {"boxes" (K, 9)
    [x, y, z (bottom), w, l, h, yaw, vx, vy], "scores" (K,), "labels" (K,),
    "queries" (K,)} for the K of the 300 best inside the post-centre range,
    in descending score."""
    scores, idx = cls.sigmoid().view(-1).topk(MAX_BOXES)
    labels = idx % NUM_CLASSES
    query = torch.div(idx, NUM_CLASSES, rounding_mode="floor")
    final = denormalize_bbox(boxes[query])
    r = torch.tensor(POST_CENTER_RANGE, device=scores.device)
    mask = (final[..., :3] >= r[:3]).all(1) & (final[..., :3] <= r[3:]).all(1)
    out = final[mask].clone()
    out[:, 2] = out[:, 2] - out[:, 5] * 0.5
    return {"boxes": out, "scores": scores[mask], "labels": labels[mask], "queries": query[mask]}
