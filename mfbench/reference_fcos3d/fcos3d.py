"""FCOS3D in plain PyTorch: the reference that the port's FCOS3D
(``monoflex_tpu_torch``'s ``MODEL.META_ARCHITECTURE`` "FCOSMono3D") is held
to.  It imports neither JAX nor the port.

What it is: mmdetection3d's ``fcos3d_r101_caffe_fpn_gn-head_dcn_2x8_1x_nus-mono3d``
model (Wang et al., FCOS3D, ICCV 2021 Workshops, arXiv:2104.10956) at its
published widths:

- the input: uint8 RGB (B, H, W, 3), flipped to BGR, the caffe mean
  subtracted at std 1 (as x / 255 less mean / 255 over 1 / 255, the port's
  normalize), zero-padded at the bottom and right to a multiple of
  ``size_divisor``;
- a caffe ResNet-101 (the stride on the first bottleneck's 1x1), frozen BN,
  a modulated DCNv2 as every 3x3 of stages 3 and 4;
- an FPN on C3-C5 (1x1 laterals, nearest top-down sums, 3x3 outputs, P6 a
  3x3/2 on P5, P7 a 3x3/2 on ReLU(P6));
- the head shared over P3-P7: class and regression towers (conv, then
  DCNv2, each with GroupNorm(32) and ReLU), a 256-channel branch and a 1x1
  for class, attribute, offset, depth, size, rotation and direction, a 1x1
  on the tower for velocity, a 64-channel branch for centerness, a learned
  scale a level on offset, depth and size;
- the decode: the top ``nms_pre`` locations a level by class score x
  centerness, centre = point - offset x stride, exp of depth and size,
  unprojection with the camera, the direction classifier's yaw, then
  class-wise rotated NMS over the bird's-eye view, greedy and sequential,
  and the ``max_per_img`` best.

Departures from the published model, each one the port shares:

- the DCN clamps each offset to +-``max_offset`` (the port's kernels take a
  bounded window), and samples x rounded to ``transfer_dtype`` (bf16 under
  the kernels' bf16 transfer);
- the DCN layers carry a bias (zero: mmdetection's trunk DCN has none);
- the image keeps its own size (no resize: nuScenes' 1600x900 is the
  published test scale, scale factor 1);
- the box's BEV for the NMS is (x, z, size 0, size 2, -yaw) (mmdetection3d
  1.0's ``CameraInstance3DBoxes.bev``) and its IoU is taken on it directly,
  without the xyxyr round trip;
- rows give the bottom centre (the published boxes' origin) and the
  gravity centre's yaw.

Precision: float32 with TF32 off (``forward`` turns it off), or, with ``compute_dtype`` bfloat16, the port's bf16 mode mirrored (every
conv but the head's 1x1 outputs, the BN and GN outputs and the residual
sums in bf16; statistics, the DCN's arithmetic and the decode in f32).
``Conv.fake_quant`` rounds a conv's input and kernel for a control.

Weights: ``init(model, seed)`` draws what the port's ``build_model`` draws
from the same seed (convs lecun-normal with zero bias, norms at identity,
each DCN's kernel uniform and its offset conv zero, the class bias at the
prior, every scale 1), in the same module order, so the two models agree
parameter for parameter.

The NMS's IoU is exact polygon intersection in float64 (the corners of each
box inside the other and the crossings of their edges, sorted about their
centroid); a suppression whose IoU lies within ``BORDER`` of the threshold
is counted in ``borderline``, where float32 IoUs may decide otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

WIDTHS = (64, 128, 256, 512)
BLOCKS = (3, 4, 23, 3)
REG_DIMS = (2, 1, 3, 1, 2)
GN_GROUPS = 32
BORDER = 1e-5
NMS_PRE = 1000
SCORE_THR = 0.05


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# layers


class Conv(nn.Conv2d):
    """A conv in ``compute_dtype``, its bias added after, in that dtype."""
    compute_dtype = torch.float32
    fake_quant = None

    def forward(self, x):
        dt = self.compute_dtype
        q = self.fake_quant or (lambda t: t)
        y = F.conv2d(q(x.to(dt)), q(self.weight.to(dt)), None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(dt).view(1, -1, 1, 1)


class BN(nn.BatchNorm2d):
    """BatchNorm in f32 (running statistics in eval mode, the batch's in train
    mode), its output in ``compute_dtype``."""
    compute_dtype = torch.float32

    def forward(self, x):
        return super().forward(x.float()).to(self.compute_dtype)


class GN(nn.GroupNorm):
    compute_dtype = torch.float32

    def __init__(self, channels: int):
        super().__init__(GN_GROUPS, channels, eps=1e-5)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor, max_offset: float) -> torch.Tensor:
    """Modulated 3x3 deformable conv, stride 1, pad 1, in float32: x (B, C,
    H, W); offset (B, 18, H, W) as (dy, dx) for taps k = 3 * ky + kx; mask
    (B, 9, H, W); weight (Co, C, 3, 3).  Each offset is clamped to
    +-max_offset; a sample is the bilinear mix of its 4 neighbours, those
    off the map counting 0."""
    B, C, H, W = x.shape
    x = x.float()
    oy = offset[:, 0::2].float().clamp(-max_offset, max_offset)
    ox = offset[:, 1::2].float().clamp(-max_offset, max_offset)
    k = torch.arange(9, device=x.device)
    py = torch.arange(H, device=x.device).view(1, 1, H, 1) + (k // 3 - 1).view(1, 9, 1, 1) + oy
    px = torch.arange(W, device=x.device).view(1, 1, 1, W) + (k % 3 - 1).view(1, 9, 1, 1) + ox
    y0, x0 = torch.floor(py), torch.floor(px)
    flat = x.reshape(B, C, H * W)
    cols = torch.zeros(B, C, 9, H * W, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            wy = (py - y0) if dy else (1 - (py - y0))
            wx = (px - x0) if dx else (1 - (px - x0))
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            wgt = (wy * wx * inside * mask.float()).reshape(B, 1, 9, H * W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(B, 1, 9 * H * W)
            got = flat.gather(2, idx.expand(B, C, 9 * H * W)).view(B, C, 9, H * W)
            cols = cols + got * wgt
    out = torch.einsum("bckp,ock->bop", cols, weight.float().reshape(-1, C, 9))
    return out.view(B, -1, H, W) + bias.float().view(1, -1, 1, 1)


class DCN(nn.Module):
    """DCNv2 3x3 whose offsets and mask come from a conv on its input; f32 out."""

    def __init__(self, cin: int, cout: int, max_offset: float, transfer_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.conv_offset_mask = Conv(cin, 27, 3, padding=1, bias=True)
        self.max_offset, self.transfer_dtype = max_offset, transfer_dtype

    def forward(self, x):
        om = self.conv_offset_mask(x).float()
        xt = x.to(self.transfer_dtype).float()
        return deform_conv(xt, om[:, :18], torch.sigmoid(om[:, 18:]), self.weight, self.bias,
                           self.max_offset)


# ---------------------------------------------------------------------------
# the model


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, dcn):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv(cin, planes, 1, stride, bias=False)
        self.bn1 = BN(planes)
        self.conv2 = DCN(planes, planes, *dcn) if dcn else Conv(planes, planes, 3, 1, 1,
                                                               bias=False)
        self.bn2 = BN(planes)
        self.conv3 = Conv(planes, cout, 1, bias=False)
        self.bn3 = BN(cout)
        self.downsample = (nn.Sequential(Conv(cin, cout, 1, stride, bias=False), BN(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, blocks, stage_with_dcn, dcn):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BN(64)
        cin = 64
        for i, (n, planes, with_dcn) in enumerate(zip(blocks, WIDTHS, stage_with_dcn)):
            layer = []
            for b in range(n):
                layer.append(Bottleneck(cin, planes, (1 if i == 0 else 2) if b == 0 else 1,
                                        dcn if with_dcn else None))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        c3 = self.layer2(self.layer1(x))
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class ConvGNReLU(nn.Module):
    def __init__(self, cin, cout, dcn=None):
        super().__init__()
        self.conv = DCN(cin, cout, *dcn) if dcn else Conv(cin, cout, 3, padding=1)
        self.gn = GN(cout)

    def forward(self, x):
        return torch.relu(self.gn(self.conv(x)))


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(()))


def _seq(layers, x):
    for layer in layers:
        x = layer(x)
    return x


class Head(nn.Module):
    def __init__(self, ch, num_classes, num_attrs, num_levels, dcn):
        super().__init__()
        self.cls_convs = nn.ModuleList([ConvGNReLU(ch, ch), ConvGNReLU(ch, ch, dcn)])
        self.reg_convs = nn.ModuleList([ConvGNReLU(ch, ch), ConvGNReLU(ch, ch, dcn)])
        self.conv_cls_prev = nn.ModuleList([ConvGNReLU(ch, 256)])
        self.conv_cls = nn.Conv2d(256, num_classes, 1)
        self.conv_reg_prevs = nn.ModuleList(nn.ModuleList([ConvGNReLU(ch, 256)] if i < 4 else [])
                                            for i in range(5))
        self.conv_regs = nn.ModuleList(nn.Conv2d(256 if i < 4 else ch, d, 1)
                                       for i, d in enumerate(REG_DIMS))
        self.conv_dir_cls_prev = nn.ModuleList([ConvGNReLU(ch, 256)])
        self.conv_dir_cls = nn.Conv2d(256, 2, 1)
        self.conv_attr_prev = nn.ModuleList([ConvGNReLU(ch, 256)])
        self.conv_attr = nn.Conv2d(256, num_attrs, 1)
        self.conv_centerness_prev = nn.ModuleList([ConvGNReLU(ch, 64)])
        self.conv_centerness = nn.Conv2d(64, 1, 1)
        self.scales = nn.ModuleList(nn.ModuleList(Scale() for _ in range(3))
                                    for _ in range(num_levels))

    def forward_level(self, x, level):
        cls_feat, reg_feat = _seq(self.cls_convs, x), _seq(self.reg_convs, x)
        cls = self.conv_cls(_seq(self.conv_cls_prev, cls_feat).float())
        regs = [conv(_seq(prev, reg_feat).float())
                for prev, conv in zip(self.conv_reg_prevs, self.conv_regs)]
        for i in range(3):
            regs[i] = regs[i] * self.scales[level][i].scale
        direction = self.conv_dir_cls(_seq(self.conv_dir_cls_prev, reg_feat).float())
        attr = self.conv_attr(_seq(self.conv_attr_prev, cls_feat).float())
        ctr = self.conv_centerness(_seq(self.conv_centerness_prev, reg_feat).float())
        return torch.cat([cls, *regs, direction, attr, ctr], 1)


class FPN(nn.Module):
    def __init__(self, in_channels, ch, extra):
        super().__init__()
        self.lateral_convs = nn.ModuleList(Conv(c, ch, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(Conv(ch, ch, 3, padding=1) for _ in in_channels)
        self.extra_convs = nn.ModuleList(Conv(ch, ch, 3, 2, 1) for _ in range(extra))

    def forward(self, feats):
        lat = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=lat[i - 1].shape[-2:],
                                                    mode="nearest")
        outs = [conv(x) for conv, x in zip(self.fpn_convs, lat)]
        for i, conv in enumerate(self.extra_convs):
            outs.append(conv(outs[-1] if i == 0 else torch.relu(outs[-1])))
        return outs


class FCOS3D(nn.Module):
    """Returns one f32 map a level: class (C), offset (2), depth (1), size
    (3), rotation (1), velocity (2), direction (2), attributes (A),
    centerness (1) channels."""

    def __init__(self, stage_with_dcn=(False, False, True, True), max_offset=2.0,
                 transfer_dtype=torch.bfloat16, compute_dtype=torch.float32, num_classes=10,
                 num_attrs=9, strides=(8, 16, 32, 64, 128), pixel_mean=(0.406, 0.456, 0.485),
                 pixel_std=(1 / 255,) * 3, to_bgr=True, size_divisor=32, fpn_channels=256,
                 init_p=0.01):
        super().__init__()
        dcn = (float(max_offset), transfer_dtype)
        self.backbone = ResNet(BLOCKS, stage_with_dcn, dcn)
        self.heads = nn.ModuleDict({"predictor": Head(fpn_channels, num_classes, num_attrs,
                                                      len(strides), dcn)})
        self.fpn = FPN([w * 4 for w in WIDTHS[1:]], fpn_channels, len(strides) - 3)
        self.mean, self.std = torch.tensor(pixel_mean), torch.tensor(pixel_std)
        self.to_bgr, self.size_divisor, self.init_p = to_bgr, size_divisor, init_p
        head = self.heads["predictor"]
        bf16 = [self.backbone, self.fpn, head.cls_convs, head.reg_convs, head.conv_cls_prev,
                *head.conv_reg_prevs, head.conv_dir_cls_prev, head.conv_attr_prev,
                head.conv_centerness_prev]
        for part in bf16:
            for m in part.modules():
                if hasattr(m, "compute_dtype"):
                    m.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        no_tf32()
        x = images.float() / 255.0
        if self.to_bgr:
            x = x.flip(-1)
        x = (x - self.mean.to(x.device)) / self.std.to(x.device)
        d = self.size_divisor
        x = F.pad(x, (0, 0, 0, -x.shape[2] % d, 0, -x.shape[1] % d))
        feats = self.fpn(self.backbone(x.permute(0, 3, 1, 2).contiguous()))
        head = self.heads["predictor"]
        return [head.forward_level(f, i) for i, f in enumerate(feats)]


@torch.no_grad()
def init(model: FCOS3D, seed: int) -> None:
    """The port's seeded weights (module docstring)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, DCN):
            s = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.copy_((torch.rand(m.weight.shape, generator=g) * 2 - 1) * s)
            m.bias.zero_()
            m.conv_offset_mask.weight.zero_()
            m.conv_offset_mask.bias.zero_()
        elif isinstance(m, Scale):
            m.scale.fill_(1.0)
    model.heads["predictor"].conv_cls.bias.fill_(-math.log(1.0 / model.init_p - 1.0))


# ---------------------------------------------------------------------------
# the decode


def field_slices(num_classes: int = 10, num_attrs: int = 9) -> Dict[str, slice]:
    out, at = {}, 0
    for name, n in (("cls", num_classes), ("offset", 2), ("depth", 1), ("size", 3), ("rot", 1),
                    ("velo", 2), ("dir", 2), ("attr", num_attrs), ("centerness", 1)):
        out[name], at = slice(at, at + n), at + n
    return out


def quad(box) -> torch.Tensor:
    """(N, 4, 2) float64 counter-clockwise corners of BEV boxes (N, 5)."""
    x, z, dx, dz, r = box.double().unbind(-1)
    u = torch.stack([dx, -dx, -dx, dx], -1) / 2
    v = torch.stack([dz, dz, -dz, -dz], -1) / 2
    c, s = torch.cos(r)[:, None], torch.sin(r)[:, None]
    return torch.stack([x[:, None] + c * u - s * v, z[:, None] + s * u + c * v], -1)


def _cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def polygon_iou(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """(N,) IoU of counter-clockwise quads (N, 4, 2), float64: the
    intersection's vertices (each quad's corners inside the other, the edges'
    crossings) sorted by angle about their centroid, then the shoelace."""
    def inside(pts, q):
        e = q.roll(-1, 1) - q
        return (_cross(e[:, None], pts[:, :, None] - q[:, None]) >= -1e-12).all(-1)

    ea, eb = qa.roll(-1, 1) - qa, qb.roll(-1, 1) - qb
    p, r = qa[:, :, None], ea[:, :, None]
    q, s = qb[:, None], eb[:, None]
    rxs = _cross(r, s)
    safe = torch.where(rxs == 0, torch.ones_like(rxs), rxs)
    t, u = _cross(q - p, s) / safe, _cross(q - p, r) / safe
    hit = (rxs != 0) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross_pts = (p + t[..., None] * r).reshape(-1, 16, 2)
    pts = torch.cat([qa, qb, cross_pts], 1)
    ok = torch.cat([inside(qa, qb), inside(qb, qa), hit.reshape(-1, 16)], 1)
    n = ok.sum(1)
    centre = (pts * ok[..., None]).sum(1) / n.clamp(min=1)[:, None]
    ang = torch.atan2(pts[..., 1] - centre[:, None, 1], pts[..., 0] - centre[:, None, 0])
    ang = torch.where(ok, ang, torch.full_like(ang, 10.0))
    order = ang.argsort(1)
    pts = pts.gather(1, order[..., None].expand(-1, -1, 2))
    k = torch.arange(24)
    nxt = torch.where(k[None] + 1 >= n[:, None], torch.zeros_like(k[None]), k[None] + 1)
    term = _cross(pts, pts.gather(1, nxt[..., None].expand(-1, -1, 2)))
    inter = torch.where((k[None] < n[:, None]) & (n[:, None] >= 3), term, 0.0).sum(1).abs() / 2
    area = lambda qd: _cross(qd, qd.roll(-1, 1)).sum(1).abs() / 2
    return inter / (area(qa) + area(qb) - inter)


def greedy_nms(bev: torch.Tensor, scores: torch.Tensor, thr: float):
    """Sequential greedy NMS of one image and class, boxes by descending
    score (ties: the earlier first): (kept indices in visiting order, the
    count of suppression decisions whose IoU lies within BORDER of thr).
    The IoUs of every pair whose circumscribed circles meet are computed
    first (the others do not overlap)."""
    n = len(scores)
    order = sorted(range(n), key=lambda i: (-float(scores[i]), i))
    if not order:
        return [], 0
    q = quad(bev)
    centre = bev[:, :2].double()
    radius = 0.5 * torch.hypot(bev[:, 2].double(), bev[:, 3].double())
    near = ((centre[:, None] - centre[None]).square().sum(-1)
            <= (radius[:, None] + radius[None]).square() * (1 + 1e-9))
    ii, jj = torch.triu(near, diagonal=1).nonzero(as_tuple=True)
    nbrs = [[] for _ in range(n)]
    for a, b, v in zip(ii.tolist(), jj.tolist(), polygon_iou(q[ii], q[jj]).tolist()):
        nbrs[a].append((b, v))
        nbrs[b].append((a, v))
    rank = {i: k for k, i in enumerate(order)}
    keep, gone, border = [], set(), 0
    for i in order:
        if i in gone:
            continue
        keep.append(i)
        for j, v in nbrs[i]:
            if rank[j] > rank[i] and j not in gone:
                border += abs(v - thr) <= BORDER
                if v > thr:
                    gone.add(j)
    return keep, border


def limit_period(val, offset=0.0, period=math.pi):
    return val - torch.floor(val / period + offset) * period


@torch.no_grad()
def decode(maps: Sequence[torch.Tensor], cam: torch.Tensor, strides=(8, 16, 32, 64, 128),
           num_classes=10, num_attrs=9, nms_pre=NMS_PRE, score_thr=SCORE_THR, nms_thr=0.8,
           max_per_img=200, dir_offset=0.7854) -> Dict[str, object]:
    """The published decode of the head maps (one a level) with each image's
    camera (B, 3, 3).  Returns ``candidates`` (B, N, ch), ``locations`` (B,
    N), and per image ``boxes``: a list of (location, class, row) with row
    [x, y (bottom), z, size 0-2, yaw, vx, vz, score, class, attribute], in
    descending score, and ``borderline`` per image."""
    Fd = field_slices(num_classes, num_attrs)
    B = maps[0].shape[0]
    cands, locs, pts, strd = [], [], [], []
    base = 0
    for m, s in zip(maps, strides):
        _, ch, H, W = m.shape
        flat = m.permute(0, 2, 3, 1).reshape(B, H * W, ch).float()
        score = (flat[..., Fd["cls"]].sigmoid() * flat[..., Fd["centerness"]].sigmoid()).amax(-1)
        idx = score.topk(min(nms_pre, H * W), dim=1).indices
        cands.append(flat.gather(1, idx[..., None].expand(-1, -1, ch)))
        locs.append(idx + base)
        pts.append(torch.stack([(idx % W) * s + s // 2, (idx // W) * s + s // 2], -1).float())
        strd.append(torch.full(idx.shape, float(s), device=m.device))
        base += H * W
    cand, loc = torch.cat(cands, 1), torch.cat(locs, 1)
    point, stride = torch.cat(pts, 1), torch.cat(strd, 1)
    cam = cam.float()
    fx, fy, cx, cy = (cam[:, 0, 0, None], cam[:, 1, 1, None], cam[:, 0, 2, None],
                      cam[:, 1, 2, None])
    u = point[..., 0] - cand[..., Fd["offset"]][..., 0] * stride
    v = point[..., 1] - cand[..., Fd["offset"]][..., 1] * stride
    depth = cand[..., Fd["depth"]][..., 0].exp()
    size = cand[..., Fd["size"]].exp()
    x, y = (u - cx) * depth / fx, (v - cy) * depth / fy
    dirc = cand[..., Fd["dir"]].argmax(-1)
    yaw = (limit_period(cand[..., Fd["rot"]][..., 0] - dir_offset) + dir_offset
           + math.pi * dirc + torch.atan2(u - cx, fx))
    scores = cand[..., Fd["cls"]].sigmoid() * cand[..., Fd["centerness"]].sigmoid()
    attr = cand[..., Fd["attr"]].argmax(-1)
    velo = cand[..., Fd["velo"]]
    # each image's rows, one a candidate (a class's score apart), on the host
    table = torch.cat([torch.stack([x, y + size[..., 1] / 2, depth], -1), size, yaw[..., None],
                       velo], -1).cpu()
    bev = torch.stack([x, depth, size[..., 0], size[..., 2], -yaw], -1).cpu()
    scores, attr, loc_host = scores.cpu(), attr.cpu(), loc.cpu()
    boxes, borderline = [], []
    for b in range(B):
        found, border = [], 0
        for c in range(num_classes):
            idx = (scores[b, :, c] > score_thr).nonzero()[:, 0]
            if idx.numel() == 0:
                continue
            keep, n_border = greedy_nms(bev[b, idx], scores[b, idx, c], nms_thr)
            border += n_border
            for i in keep:
                n = int(idx[i])
                row = table[b, n].tolist() + [float(scores[b, n, c]), float(c), float(attr[b, n])]
                found.append((n, c, row))
        found.sort(key=lambda e: -e[2][9])
        boxes.append([(int(loc_host[b, n]), c, row) for n, c, row in found[:max_per_img]])
        borderline.append(border)
    return {"candidates": cand, "locations": loc, "boxes": boxes, "borderline": borderline}
