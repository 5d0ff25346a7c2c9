"""Official KITTI AP (R40 / R11) evaluation.

Faithful re-derivation of the metric engine (reference:
data/datasets/evaluation/kitti_object_eval_python/eval.py:7-727): 41-point
score-threshold construction, class/difficulty filtering with neighbor-class
ignores (Van<->Car, Person_sitting<->Pedestrian), DontCare suppression,
greedy TP matching, AOS, and the four metrics (bbox / bev / 3d / aos).

The matching loop is intentionally a near-literal port of the official
semantics (which are subtle and order-dependent); the hot overlap kernels
live in rotate_iou.py (numpy, with the C++ fast path of
monoflex_tpu_torch.native where g++ is found).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .rotate_iou import d3_box_overlap, image_box_overlap, rotate_iou_eval

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck"]
CLASS_TO_NAME = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                 4: "Person_sitting", 5: "Truck"}
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> np.ndarray:
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int,
               difficulty_scale: float = 1.0):
    # difficulty_scale divides the pixel min-height gates: reduced-resolution
    # fixtures (tests/synthetic_kitti.py scale=4) otherwise have EVERY ground
    # truth below MIN_HEIGHT and AP degenerates to 0 by construction
    min_height = [h / difficulty_scale for h in MIN_HEIGHT]
    current_cls_name = CLASS_NAMES[current_class]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        gt_name = gt_anno["name"][i].lower()
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= min_height[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < min_height[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy per-image matching; overlaps is (num_dt, num_gt)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [dt_scores[i] < thresh if compute_fp else False
                         for i in range(det_size)]

    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp) and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] in (-1, 1)
                    or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            dc = np.asarray(dc_bboxes, dtype=np.float64).reshape(-1, 4)
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, 0)
            for i in range(dc.shape[0]):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def _boxes_for_metric(annos, metric):
    if metric == 0:
        return np.concatenate([a["bbox"] for a in annos], 0) if annos else np.zeros((0, 4))
    loc = np.concatenate([a["location"] for a in annos], 0)
    dims = np.concatenate([a["dimensions"] for a in annos], 0)
    rots = np.concatenate([a["rotation_y"] for a in annos], 0)
    if metric == 1:
        return np.concatenate([loc[:, [0, 2]], dims[:, [0, 2]], rots[:, None]], axis=1)
    return np.concatenate([loc, dims, rots[:, None]], axis=1)


def calculate_iou(dt_annos, gt_annos, metric) -> List[np.ndarray]:
    """Per-image (num_dt, num_gt) overlap matrices."""
    overlaps = []
    for dt, gt in zip(dt_annos, gt_annos):
        dt_boxes = _boxes_for_metric([dt], metric)
        gt_boxes = _boxes_for_metric([gt], metric)
        if metric == 0:
            ov = image_box_overlap(dt_boxes, gt_boxes)
        elif metric == 1:
            ov = rotate_iou_eval(dt_boxes, gt_boxes)
        else:
            ov = d3_box_overlap(dt_boxes, gt_boxes)
        overlaps.append(ov.astype(np.float64))
    return overlaps


def _prepare_data(gt_annos, dt_annos, current_class, difficulty,
                  difficulty_scale=1.0):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt, dt, current_class, difficulty, difficulty_scale)
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dontcares.append(np.asarray(dc_bboxes, dtype=np.float64).reshape(-1, 4))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate([gt["bbox"], gt["alpha"][:, None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt["bbox"], dt["alpha"][:, None], dt["score"][:, None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
            total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False,
               difficulty_scale=1.0) -> Dict[str, np.ndarray]:
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_iou(dt_annos, gt_annos, metric)

    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    num_minoverlap = len(min_overlaps)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    aos = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])

    for m, current_class in enumerate(current_classes):
        for li, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
             total_num_valid_gt) = _prepare_data(gt_annos, dt_annos, current_class,
                                                 difficulty, difficulty_scale)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = compute_statistics(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i], metric,
                        min_overlap=min_overlap, thresh=0.0, compute_fp=False)
                    thresholdss += th.tolist()
                thresholds = get_thresholds(np.array(thresholdss), total_num_valid_gt)
                if len(thresholds) == 0:
                    continue
                pr = np.zeros([len(thresholds), 4])
                from ..native import compute_statistics_thresholds_native, load_native

                use_native = load_native() is not None
                for i in range(len(gt_annos)):
                    if use_native:
                        pr += compute_statistics_thresholds_native(
                            overlaps[i], dt_datas_list[i][:, -1],
                            dt_datas_list[i][:, 4], gt_datas_list[i][:, 4],
                            dt_datas_list[i][:, :4], ignored_gts[i],
                            ignored_dets[i], dontcares[i], metric, min_overlap,
                            thresholds, compute_aos)
                        continue
                    for t, thresh in enumerate(thresholds):
                        tp, fp, fn, similarity, _ = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i], metric,
                            min_overlap=min_overlap, thresh=thresh,
                            compute_fp=True, compute_aos=compute_aos)
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if similarity != -1:
                            pr[t, 3] += similarity
                for i in range(len(thresholds)):
                    recall[m, li, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, li, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, li, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, li, k, i] = np.max(precision[m, li, k, i:], axis=-1)
                    recall[m, li, k, i] = np.max(recall[m, li, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, li, k, i] = np.max(aos[m, li, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP_R11(prec: np.ndarray) -> np.ndarray:
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec: np.ndarray) -> np.ndarray:
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, metric="R40", difficulty_scale=1.0):
    difficultys = [0, 1, 2]
    get_map = get_mAP_R40 if metric == "R40" else get_mAP_R11

    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos,
                     difficulty_scale=difficulty_scale)
    mAP_bbox = get_map(ret["precision"])
    mAP_aos = get_map(ret["orientation"]) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps, difficulty_scale=difficulty_scale)
    mAP_bev = get_map(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps, difficulty_scale=difficulty_scale)
    mAP_3d = get_map(ret["precision"])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def do_coco_style_eval(gt_annos, dt_annos, current_classes, overlap_ranges,
                       compute_aos=False):
    """COCO-style AP averaged over an overlap sweep
    (reference: kitti_object_eval_python/eval.py:625-642).
    overlap_ranges: (3, num_metrics, num_classes) linspace specs."""
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            lo, hi, num = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(lo, hi, int(num))
    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """Reference COCO-style entry: overlap sweep 0.5:0.05:0.95 for Car,
    0.25:0.05:0.7 for Pedestrian/Cyclist
    (reference: kitti_object_eval_python/eval.py:729-787)."""
    name_to_class = {v: k for k, v in CLASS_TO_NAME.items()}
    current_classes = [name_to_class[c] if isinstance(c, str) else int(c)
                       for c in (current_classes if isinstance(current_classes, (list, tuple))
                                 else [current_classes])]
    class_to_range = {
        0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10], 2: [0.25, 0.7, 10],
        3: [0.5, 0.95, 10], 4: [0.25, 0.7, 10], 5: [0.5, 0.95, 10],
    }
    overlap_ranges = np.zeros([3, 3, len(current_classes)])
    for i, curcls in enumerate(current_classes):
        overlap_ranges[:, :, i] = np.array(class_to_range[curcls])[:, None]
    compute_aos = any(a["alpha"].shape[0] and a["alpha"][0] != -10
                      for a in dt_annos)
    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = do_coco_style_eval(
        gt_annos, dt_annos, current_classes, overlap_ranges, compute_aos)
    result = ""
    for j, curcls in enumerate(current_classes):
        cls_name = CLASS_TO_NAME[curcls]
        o_range = np.array(class_to_range[curcls])[:2]
        result += (f"{cls_name} coco AP@{o_range[0]:.2f}:0.05:{o_range[1]:.2f}:\n")
        result += (f"bbox AP:{mAP_bbox[j, 0]:.2f}, {mAP_bbox[j, 1]:.2f}, "
                   f"{mAP_bbox[j, 2]:.2f}\n")
        result += (f"bev  AP:{mAP_bev[j, 0]:.2f}, {mAP_bev[j, 1]:.2f}, "
                   f"{mAP_bev[j, 2]:.2f}\n")
        result += (f"3d   AP:{mAP_3d[j, 0]:.2f}, {mAP_3d[j, 1]:.2f}, "
                   f"{mAP_3d[j, 2]:.2f}\n")
        if compute_aos:
            result += (f"aos  AP:{mAP_aos[j, 0]:.2f}, {mAP_aos[j, 1]:.2f}, "
                       f"{mAP_aos[j, 2]:.2f}\n")
    return result, (mAP_bbox, mAP_bev, mAP_3d, mAP_aos)


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             metric="R40",
                             difficulty_scale=1.0) -> Tuple[str, Dict[str, float]]:
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)   # (2, 3, 6)

    name_to_class = {v: k for k, v in CLASS_TO_NAME.items()}
    current_classes = [name_to_class[c] if isinstance(c, str) else int(c)
                       for c in (current_classes if isinstance(current_classes, (list, tuple))
                                 else [current_classes])]
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        metric=metric, difficulty_scale=difficulty_scale)

    result = ""
    ret_dict: Dict[str, float] = {}
    for j, curcls in enumerate(current_classes):
        cls_name = CLASS_TO_NAME[curcls]
        for i in range(min_overlaps.shape[0]):
            result += (f"{cls_name} AP@{min_overlaps[i, 0, j]:.2f}, "
                       f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:\n")
            result += (f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, "
                       f"{mAPbbox[j, 2, i]:.4f}\n")
            result += (f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, "
                       f"{mAPbev[j, 2, i]:.4f}\n")
            result += (f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, "
                       f"{mAP3d[j, 2, i]:.4f}\n")
            if compute_aos:
                result += (f"aos  AP:{mAPaos[j, 0, i]:.2f}, {mAPaos[j, 1, i]:.2f}, "
                           f"{mAPaos[j, 2, i]:.2f}\n")
                if i == 0:
                    for d, dn in enumerate(["easy", "moderate", "hard"]):
                        ret_dict[f"{cls_name}_aos/{dn}"] = mAPaos[j, d, 0]
            for d, dn in enumerate(["easy", "moderate", "hard"]):
                ret_dict[f"{cls_name}_3d_{min_overlaps[i, 1, j]:.2f}/{dn}"] = mAP3d[j, d, i]
                ret_dict[f"{cls_name}_bev_{min_overlaps[i, 2, j]:.2f}/{dn}"] = mAPbev[j, d, i]
                ret_dict[f"{cls_name}_image/{dn}"] = mAPbbox[j, d, 0]
    return result, ret_dict
