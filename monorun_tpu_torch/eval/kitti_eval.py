"""Official KITTI AP evaluation protocol (bbox / BEV / 3D / AOS).

Re-implements the devkit rules the reference evaluates with
(core/evaluation/kitti_utils/eval.py): easy/moderate/hard difficulty
filtering, neighbour-class ignores (Van for Car, Person_sitting for
Pedestrian), DontCare regions, 41-recall-point score thresholds, matched
greedy assignment with ignore semantics, and R40/R11 AP averaging. Pure
numpy (the reference needs numba + numba-CUDA); an optional C++ kernel
accelerates the per-image statistics loop when built
(eval/_native).

The port's copy of ``monorun_tpu/eval/kitti_eval.py``: the same protocol,
flaws included (the AOS sentinel in ``eval_class``), so the two packages'
AP dicts can be held equal.

Lineage: the matching/threshold/filtering ALGORITHM here follows the
official KITTI devkit protocol as popularized by the public
kitti-object-eval-python project (which the reference's eval.py also
descends from) — the branch structure of `clean_data`/`get_thresholds`/
`compute_statistics` IS that specification; the implementation
(vectorized numpy overlaps, C-ABI kernels, function decomposition) is
original.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .rotated_iou_np import d3_box_overlap, rotate_iou_matrix

MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.30, 0.50)
NO_DETECTION = -10_000_000.0
DIFFICULTY_NAMES = ("easy", "moderate", "hard")

# neighbour classes that are ignored (not penalised) for a given class
_NEIGHBORS = {"car": ("van",), "pedestrian": ("person_sitting",)}


def clean_data(gt_anno, dt_anno, current_class: str, difficulty: int):
    """Per-image GT/det filtering. Returns (num_valid_gt, ignored_gt,
    ignored_dt, dc_bboxes). Codes: 0 counted, 1 ignored, -1 removed."""
    cls = current_class.lower()
    ignored_gt, dc_bboxes = [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        name = str(gt_anno["name"][i]).lower()
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if name == cls:
            valid_class = 1
        elif name in _NEIGHBORS.get(cls, ()):
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if name == "dontcare":
            dc_bboxes.append(gt_anno["bbox"][i])

    # Reference order (eval.py:67-78): the height check comes FIRST, so a
    # short detection of ANY class is ignored (1) — it can absorb a GT
    # during matching without scoring a TP — not removed (-1).
    ignored_dt = []
    for j in range(len(dt_anno["name"])):
        name = str(dt_anno["name"][j]).lower()
        height = abs(dt_anno["bbox"][j, 3] - dt_anno["bbox"][j, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif name == cls:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)

    return (
        num_valid_gt,
        np.asarray(ignored_gt, np.int32),
        np.asarray(ignored_dt, np.int32),
        np.asarray(dc_bboxes, np.float32).reshape(-1, 4),
    )


def image_box_overlap(boxes, qboxes, criterion=-1):
    """Axis-aligned 2D IoU / IoA matrix."""
    n, k = len(boxes), len(qboxes)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (qboxes[:, 2] - qboxes[:, 0]) * (qboxes[:, 3] - qboxes[:, 1])
    lt = np.maximum(boxes[:, None, :2], qboxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], qboxes[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    if criterion == -1:
        denom = area_a[:, None] + area_b[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a[:, None], inter.shape)
    else:
        denom = np.broadcast_to(area_b[None, :], inter.shape)
    return inter / np.clip(denom, 1e-8, None)


def _metric_overlap(gt_anno, dt_anno, metric: int) -> np.ndarray:
    """overlaps[dt, gt] for metric 0=bbox, 1=bev, 2=3d."""
    if metric == 0:
        return image_box_overlap(dt_anno["bbox"], gt_anno["bbox"])
    gt7 = np.concatenate(
        [gt_anno["location"], gt_anno["dimensions"],
         gt_anno["rotation_y"][:, None]], axis=1,
    ).astype(np.float64)
    dt7 = np.concatenate(
        [dt_anno["location"], dt_anno["dimensions"],
         dt_anno["rotation_y"][:, None]], axis=1,
    ).astype(np.float64)
    if metric == 1:
        return rotate_iou_matrix(
            dt7[:, [0, 2, 3, 5, 6]], gt7[:, [0, 2, 3, 5, 6]]
        )
    return d3_box_overlap(dt7, gt7)


def compute_statistics(
    overlaps,        # (num_dt, num_gt)
    gt_anno,
    dt_anno,
    ignored_gt,
    ignored_det,
    dc_bboxes,
    metric: int,
    min_overlap: float,
    thresh: float = 0.0,
    compute_fp: bool = False,
    compute_aos: bool = False,
):
    """Greedy matching with ignore semantics (eval.py:161-288)."""
    dt_scores = dt_anno["score"]
    dt_alphas = dt_anno["alpha"]
    gt_alphas = gt_anno["alpha"]
    dt_bboxes = dt_anno["bbox"]
    num_dt, num_gt = len(dt_scores), len(ignored_gt)

    ignored_threshold = dt_scores < thresh if compute_fp else np.zeros(
        num_dt, bool
    )
    assigned = np.zeros(num_dt, bool)
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []

    for i in range(num_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(num_dt):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            score = dt_scores[j]
            if not compute_fp:
                if overlap > min_overlap and score > valid_detection:
                    det_idx = j
                    valid_detection = score
            else:
                if (
                    overlap > min_overlap
                    and (overlap > max_overlap or assigned_ignored_det)
                    and ignored_det[j] == 0
                ):
                    max_overlap = overlap
                    det_idx = j
                    valid_detection = 1.0
                    assigned_ignored_det = False
                elif (
                    overlap > min_overlap
                    and valid_detection == NO_DETECTION
                    and ignored_det[j] == 1
                ):
                    det_idx = j
                    valid_detection = 1.0
                    assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        for j in range(num_dt):
            if not (
                assigned[j]
                or ignored_det[j] == -1
                or ignored_det[j] == 1
                or ignored_threshold[j]
            ):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(
                dt_bboxes, dc_bboxes, criterion=0
            )
            for dc in range(len(dc_bboxes)):
                for j in range(num_dt):
                    if (
                        assigned[j]
                        or ignored_det[j] in (-1, 1)
                        or ignored_threshold[j]
                    ):
                        continue
                    if overlaps_dt_dc[j, dc] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            # devkit edge case (reference eval.py:276-279): an image with
            # no TPs AND no FPs at this threshold contributes -1 to the
            # AOS numerator (not 0) — the official protocol's sentinel
            # is accumulated as-is by fused_compute_statistics
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            if tp > 0 or fp > 0:
                similarity = float(np.sum(tmp))
            else:
                similarity = -1.0

    return tp, fp, fn, similarity, thresholds


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts=41):
    """Score thresholds at ~41 evenly spaced recall points (eval.py:8-25)."""
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and (
            i < len(scores) - 1
        ):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.asarray(thresholds)


def _native_lib():
    from . import _native

    return _native.get_lib()


def eval_class(
    gt_annos,
    dt_annos,
    current_class: str,
    difficulty: int,
    metric: int,
    min_overlap: float,
    compute_aos: bool = False,
    num_sample_pts: int = 41,
    use_native: bool = True,
):
    """Precision/recall/AOS curves over the 41-point thresholds.

    The per-image greedy matching loop (the numba-JIT hot path of the
    reference) runs through the C++ kernels in eval/_native when the
    shared library builds; the pure-python implementation is the fallback
    and the correctness oracle (tested equal in tests/test_torch_eval.py).
    """
    assert len(gt_annos) == len(dt_annos)
    num_imgs = len(gt_annos)
    lib = _native_lib() if use_native else None

    cleaned = [
        clean_data(gt_annos[i], dt_annos[i], current_class, difficulty)
        for i in range(num_imgs)
    ]
    overlaps = [
        np.ascontiguousarray(
            _metric_overlap(gt_annos[i], dt_annos[i], metric), np.float32
        )
        for i in range(num_imgs)
    ]
    total_valid_gt = sum(c[0] for c in cleaned)

    all_thresholds = []
    for i in range(num_imgs):
        _, ig, idt, dc = cleaned[i]
        if lib is not None:
            num_dt = len(idt)
            scores = np.ascontiguousarray(dt_annos[i]["score"], np.float32)
            out = np.zeros(max(num_dt, 1), np.float32)
            cnt = lib.kitti_tp_scores(
                overlaps[i] if overlaps[i].size else
                np.zeros((1, 1), np.float32),
                num_dt, len(ig),
                scores if scores.size else np.zeros(1, np.float32),
                np.ascontiguousarray(ig, np.int32) if ig.size else
                np.zeros(1, np.int32),
                np.ascontiguousarray(idt, np.int32) if idt.size else
                np.zeros(1, np.int32),
                min_overlap, out,
            )
            all_thresholds += out[:cnt].tolist()
        else:
            _, _, _, _, th = compute_statistics(
                overlaps[i], gt_annos[i], dt_annos[i], ig, idt, dc, metric,
                min_overlap, thresh=0.0, compute_fp=False,
            )
            all_thresholds += th
    thresholds = get_thresholds(
        np.asarray(all_thresholds), total_valid_gt, num_sample_pts
    )

    pr = np.zeros((len(thresholds), 4))
    thr32 = np.ascontiguousarray(thresholds, np.float32)
    pr32 = np.zeros((max(len(thresholds), 1), 4), np.float32)
    for i in range(num_imgs):
        _, ig, idt, dc = cleaned[i]
        if lib is not None and len(thresholds):
            num_dt = len(idt)
            lib.kitti_stats_thresholds(
                overlaps[i] if overlaps[i].size else
                np.zeros((1, 1), np.float32),
                num_dt, len(ig),
                np.ascontiguousarray(dt_annos[i]["score"], np.float32)
                if num_dt else np.zeros(1, np.float32),
                np.ascontiguousarray(dt_annos[i]["alpha"], np.float32)
                if num_dt else np.zeros(1, np.float32),
                np.ascontiguousarray(gt_annos[i]["alpha"], np.float32)
                if len(ig) else np.zeros(1, np.float32),
                np.ascontiguousarray(dt_annos[i]["bbox"], np.float32)
                if num_dt else np.zeros((1, 4), np.float32),
                np.ascontiguousarray(dc, np.float32) if dc.size else
                np.zeros((1, 4), np.float32),
                len(dc),
                np.ascontiguousarray(ig, np.int32) if ig.size else
                np.zeros(1, np.int32),
                np.ascontiguousarray(idt, np.int32) if idt.size else
                np.zeros(1, np.int32),
                metric, min_overlap, thr32, len(thresholds),
                int(compute_aos), pr32,
            )
        else:
            for t, thr in enumerate(thresholds):
                tp, fp, fn, sim, _ = compute_statistics(
                    overlaps[i], gt_annos[i], dt_annos[i], ig, idt, dc,
                    metric, min_overlap, thresh=thr, compute_fp=True,
                    compute_aos=compute_aos,
                )
                pr[t, 0] += tp
                pr[t, 1] += fp
                pr[t, 2] += fn
                pr[t, 3] += sim
    if lib is not None:
        pr = pr32[: len(thresholds)].astype(np.float64)

    n_thr = len(thresholds)
    precision = np.zeros(num_sample_pts)
    recall = np.zeros(num_sample_pts)
    aos = np.zeros(num_sample_pts)
    for t in range(n_thr):
        precision[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 1], 1e-9)
        recall[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 2], 1e-9)
        if compute_aos:
            aos[t] = pr[t, 3] / max(pr[t, 0] + pr[t, 1], 1e-9)
    # right-max smoothing
    for t in range(num_sample_pts):
        precision[t] = precision[t:].max()
        recall[t] = recall[t:].max()
        if compute_aos:
            aos[t] = aos[t:].max()
    return dict(precision=precision, recall=recall, aos=aos)


def _ap(vals: np.ndarray, criteria: str) -> float:
    if criteria == "R40":
        return float(np.sum(vals[1:41]) / 40 * 100)
    return float(np.mean(vals[0:41:4]) * 100)


# min_overlaps[strictness, metric, class]: strict (0.7) and loose (0.5)
_OVERLAP_TABLES = {
    "Car": ((0.7, 0.7, 0.7), (0.7, 0.5, 0.5)),
    "Pedestrian": ((0.5, 0.5, 0.5), (0.5, 0.25, 0.25)),
    "Cyclist": ((0.5, 0.5, 0.5), (0.5, 0.25, 0.25)),
}
_METRIC_IDX = {"bbox": 0, "bev": 1, "3d": 2}


def kitti_eval(
    gt_annos,
    dt_annos,
    classes: Sequence[str],
    eval_types: Sequence[str] = ("bbox", "bev", "3d"),
    criteria: str = "R40",
) -> Tuple[str, Dict[str, float]]:
    """Full protocol: strict + loose overlaps, 3 difficulties, AP (+AOS).

    Returns (pretty summary string, {metric-name: AP}).
    """
    compute_aos = "bbox" in eval_types and all(
        len(a["alpha"]) == 0 or a["alpha"].min() > -8 for a in dt_annos
    )
    ap_dict: Dict[str, float] = {}
    lines: List[str] = []
    for cls in classes:
        strict, loose = _OVERLAP_TABLES.get(
            cls, ((0.5, 0.5, 0.5), (0.5, 0.25, 0.25))
        )
        for strict_name, table in (("strict", strict), ("loose", loose)):
            header_vals = {}
            for ev in eval_types:
                m = _METRIC_IDX[ev]
                min_ov = table[m]
                aps = []
                aos_aps = []
                for d in range(3):
                    r = eval_class(
                        gt_annos, dt_annos, cls, d, m, min_ov,
                        compute_aos=compute_aos and ev == "bbox",
                    )
                    aps.append(_ap(r["precision"], criteria))
                    if compute_aos and ev == "bbox":
                        aos_aps.append(_ap(r["aos"], criteria))
                key = f"{cls}_{ev}_{min_ov:.2f}"
                for d, v in enumerate(aps):
                    ap_dict[f"{key}_{DIFFICULTY_NAMES[d]}"] = v
                header_vals[ev] = aps
                if aos_aps:
                    for d, v in enumerate(aos_aps):
                        ap_dict[
                            f"{cls}_aos_{min_ov:.2f}_{DIFFICULTY_NAMES[d]}"
                        ] = v
                    header_vals["aos"] = aos_aps
            lines.append(
                f"{cls} AP{criteria}@"
                + ", ".join(f"{table[_METRIC_IDX[e]]:.2f}" for e in eval_types)
                + f" ({strict_name}):"
            )
            for ev, aps in header_vals.items():
                lines.append(
                    f"  {ev:>4}: " + " / ".join(f"{v:6.2f}" for v in aps)
                )
    return "\n".join(lines), ap_dict
