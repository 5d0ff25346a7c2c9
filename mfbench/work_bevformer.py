"""The yardstick's arithmetic for BEVFormer-base: the multi-scale deformable
attention's work and roofline bound a call, and the FLOPs of a forward.
Nothing here depends on how the program implements an operation beyond
what each call reads and writes.

A deformable-attention call (``msda_calls``) is described by its shape:
``groups`` value maps (cameras or BEV queues) of ``keys`` keys of 8 heads
x 32 channels, ``queries`` queries, ``levels`` x ``points`` samples a
head, ``anchors`` reference points a query and group, offsets and weights
per group (``offset_groups``, ``weight_groups``: the group count or 1),
``masked`` (a byte a group and query says which groups a query sums), and
``pairs``, the (group, query) pairs that are sampled: every pair, or the
visible ones of the spatial cross-attention, which the rig's geometry
fixes (``visible_pairs``).

- Bytes, each input read once and the output written once: the value maps
  (bf16), the offsets and weights (f32), the reference points (f32), the
  mask, the output (bf16).
- FLOPs: 32 channels x (4 corners x a multiply-add + the attention weight's
  multiply-add) = 320 a sample, on the CUDA cores' f32 rate (the blend is
  f32 arithmetic, no matrix unit).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .work import PEAK_HBM_BYTES_PER_S

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, at the 700 W limit
PEAK_F32_FLOPS = 67e12
HEADS, HEAD_DIM = 8, 32
FLOPS_PER_SAMPLE = HEAD_DIM * (4 * 2 + 2)
EMBED, FFN_DIM, NUM_QUERY, NUM_CLASSES, CODE_SIZE = 256, 512, 900, 10, 10


def msda_work(call: Dict, value_bytes: int = 2, out_bytes: int = 2) -> Dict[str, float]:
    G, Q, L, P = call["groups"], call["queries"], call["levels"], call["points"]
    C = HEADS * HEAD_DIM
    samples = call["pairs"] * HEADS * L * P
    nbytes = (G * call["keys"] * C * value_bytes
              + Q * HEADS * (call["offset_groups"] * L * P * 2 + call["weight_groups"] * L * P) * 4
              + G * Q * call["anchors"] * 2 * 4
              + (G * Q if call["masked"] else 0)
              + Q * C * out_bytes)
    return {"flops": float(samples * FLOPS_PER_SAMPLE), "bytes": float(nbytes)}


def bound_s(work: Dict[str, float]) -> float:
    """The least time: the blend at the f32 rate or the bytes at the memory
    rate, whichever is longer."""
    return max(work["flops"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_HBM_BYTES_PER_S)


def calls_bound_s(calls: Sequence[Dict], value_bytes: int = 2, out_bytes: int = 2) -> float:
    return sum(bound_s(msda_work(c, value_bytes, out_bytes)) for c in calls)


def msda_calls(level_shapes: Sequence[Tuple[int, int]], cams: int, sca_pairs: int,
               bev: Tuple[int, int] = (200, 200), encoder_layers: int = 6,
               decoder_layers: int = 6) -> List[Dict]:
    """BEVFormer's deformable-attention calls of one forward, in order."""
    Q = bev[0] * bev[1]
    tsa = {"groups": 2, "keys": Q, "queries": Q, "levels": 1, "points": 4, "anchors": 1,
           "offset_groups": 2, "weight_groups": 2, "masked": False, "pairs": 2 * Q}
    sca = {"groups": cams, "keys": sum(h * w for h, w in level_shapes), "queries": Q,
           "levels": len(level_shapes), "points": 8, "anchors": 4, "offset_groups": 1,
           "weight_groups": 1, "masked": True, "pairs": sca_pairs}
    dec = {"groups": 1, "keys": Q, "queries": NUM_QUERY, "levels": 1, "points": 4, "anchors": 1,
           "offset_groups": 1, "weight_groups": 1, "masked": False, "pairs": NUM_QUERY}
    return [tsa, sca] * encoder_layers + [dec] * decoder_layers


def level_shapes(height: int, width: int, divisor: int = 32) -> List[Tuple[int, int]]:
    """P3-P6 of an image padded to a multiple of ``divisor``."""
    h, w = -(-height // divisor) * divisor, -(-width // divisor) * divisor
    out = []
    for s in (8, 16, 32):
        out.append((h // s, w // s))
    out.append(((out[-1][0] + 1) // 2, (out[-1][1] + 1) // 2))
    return out


def dcn_calls(height: int, width: int, divisor: int = 32) -> List[List[int]]:
    """[H, W, C, Co] of the trunk's 26 DCNv2 calls (FCOS3D's ResNet-101,
    ``dcn_fwd_roofline.fcos3d``'s ``work.dcn_calls``): stage 3's 23 at a
    sixteenth of the padded image, stage 4's 3 at a thirty-second."""
    h, w = -(-height // divisor) * divisor, -(-width // divisor) * divisor
    return [[h // 16, w // 16, 256, 256]] * 23 + [[h // 32, w // 32, 512, 512]] * 3


def visible(traffic: Dict, height: int, width: int, bev: Tuple[int, int] = (200, 200)
            ) -> torch.Tensor:
    """(cameras, H_bev * W_bev): the cells each camera sees, by the
    reference's published ``point_sampling`` of the mix's rig."""
    from .reference_bevformer import bevformer as plain
    from .sources.camera_scene_batches import lidar2img

    l2i = torch.from_numpy(lidar2img(traffic["cameras"], traffic["mount"],
                                     traffic["mount_down"], height, width))
    ref_3d = plain.reference_points_3d(bev[0], bev[1], plain.PC_RANGE[5] - plain.PC_RANGE[2])
    padded = (-(-height // 32) * 32, -(-width // 32) * 32)
    _, mask = plain.point_sampling(ref_3d, l2i, padded)
    return mask[:, 0].any(-1)


def transformer_flops(level_shapes: Sequence[Tuple[int, int]], cams: int, rebatch: int,
                      bev: Tuple[int, int] = (200, 200), encoder_layers: int = 6,
                      decoder_layers: int = 6) -> float:
    """The products of the reference's transformer (the dense layers and the
    decoder's attention), as ``FlopCounterMode`` counts them (2 a
    multiply-add), the spatial cross-attention's projections on each
    camera's ``rebatch`` rows (the published padded lists)."""
    Q, C, n = bev[0] * bev[1], EMBED, NUM_QUERY
    S = sum(h * w for h, w in level_shapes)
    tsa = 2 * (2 * Q) * C * C + 2 * Q * 2 * C * (128 + 64) + 2 * Q * C * C
    sca = 2 * cams * S * C * C + 2 * cams * rebatch * C * (512 + 256) + 2 * Q * C * C
    ffn = 2 * 2 * C * FFN_DIM
    encoder = encoder_layers * (tsa + sca + Q * ffn)
    mha = 2 * n * C * 3 * C + 2 * 2 * n * n * C + 2 * n * C * C
    msda = 2 * Q * C * C + 2 * n * C * (64 + 32) + 2 * n * C * C
    branch = 2 * n * (2 * C * C + C * CODE_SIZE)
    decoder = decoder_layers * (mha + msda + n * ffn + branch)
    head = decoder_layers * 2 * 2 * n * (2 * C * C + C * NUM_CLASSES)
    small = 2 * n * C * 3 + 2 * (18 * 128 + 128 * 256)
    return float(encoder + decoder + head + small)


def trunk_flops(tree: Dict, cams: int, height: int, width: int) -> float:
    """The reference's trunk and FPN on ``cams`` images, by
    ``FlopCounterMode`` on meta tensors (no arithmetic runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference_bevformer import model as ref

    with torch.device("meta"):
        model = ref.plain.BEVFormer(bev_h=2, bev_w=2, encoder_layers=1, decoder_layers=1,
                                    compute_dtype=torch.float32)
    x = torch.zeros(cams, height, width, 3, dtype=torch.uint8, device="meta")
    model.mean, model.std = model.mean.to("meta"), model.std.to("meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.features(x)
    return float(counter.get_total_flops())


def count_work(tree: Dict, traffic: Dict, height: int = 900, width: int = 1600) -> Dict:
    """FLOPs per image of a forward of one sample of ``traffic``'s rig, and
    the trunk's DCN and the deformable-attention calls of one forward."""
    cams = len(traffic["cameras"])
    shapes = level_shapes(height, width)
    vis = visible(traffic, height, width)
    flops = trunk_flops(tree, cams, height, width) + transformer_flops(
        shapes, cams, int(vis.sum(1).max()))
    return {"forward_flops_per_image": flops / cams, "dcn_calls": dcn_calls(height, width),
            "msda_calls": msda_calls(shapes, cams, int(vis.sum()))}
