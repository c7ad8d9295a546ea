"""Evaluation metrics (NumPy, host).

Own copy of the JAX package's ``training/metrics.py``:

* pixel precision/recall/F1 for the mask head (reference train_seg.py:31-55)
* ICDAR-style detection matching at IoU >= 0.5 (DetectionIoUEvaluator,
  reference utils/db_utils.py:233-435) and its QuadMetric wrapper (:437-499),
  using this framework's convex polygon IoU (ops/geometry.py) in place of
  shapely / cv2.rotatedRectangleIntersection.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from comic_text_detector_tpu_torch.ops import geometry as geo


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        return self


def iou_rotate(box_a: np.ndarray, box_b: np.ndarray, method: str = "union") -> float:
    """IoU of the min-area rotated rects of two point sets (reference
    utils/db_utils.py iou_rotate :11-30, sans cv2.rotatedRectangleIntersection)."""
    ra, _ = geo.min_area_rect(np.asarray(box_a, np.float64))
    rb, _ = geo.min_area_rect(np.asarray(box_b, np.float64))
    inter = geo.intersection_area_convex(ra, rb)
    area_a = abs(geo.shoelace_area(np.asarray(box_a, np.float64)))
    area_b = abs(geo.shoelace_area(np.asarray(box_b, np.float64)))
    if inter == 0:
        return 0.0
    if method == "union":
        union = area_a + area_b - inter
        return inter / union if union > 0 else 0.0
    if method == "intersection":
        m = min(area_a, area_b)
        return inter / m if m > 0 else 0.0
    raise NotImplementedError(method)


def _poly_valid(points: np.ndarray) -> bool:
    points = np.asarray(points, np.float64)
    return len(points) >= 3 and abs(geo.shoelace_area(points)) > 0


class DetectionIoUEvaluator:
    """Greedy 1:1 matching of predictions to GT at IoU >= iou_constraint,
    with don't-care handling."""

    def __init__(self, is_output_polygon: bool = False, iou_constraint: float = 0.5, area_precision_constraint: float = 0.5):
        self.is_output_polygon = is_output_polygon
        self.iou_constraint = iou_constraint
        self.area_precision_constraint = area_precision_constraint

    def evaluate_image(self, gt: List[Dict], pred: List[Dict]) -> Dict:
        gt_pols, gt_dontcare = [], []
        for g in gt:
            pts = np.asarray(g["points"], np.float64)
            if not _poly_valid(pts):
                continue
            gt_pols.append(pts)
            if g.get("ignore", False):
                gt_dontcare.append(len(gt_pols) - 1)

        det_pols, det_dontcare = [], []
        for p in pred:
            pts = np.asarray(p["points"], np.float64)
            if not _poly_valid(pts):
                continue
            det_pols.append(pts)
            for dc in gt_dontcare:
                inter = geo.intersection_area_convex(gt_pols[dc], pts)
                area = abs(geo.shoelace_area(pts))
                if area > 0 and inter / area > self.area_precision_constraint:
                    det_dontcare.append(len(det_pols) - 1)
                    break

        det_matched = 0
        pairs = []
        if gt_pols and det_pols:
            gt_used = np.zeros(len(gt_pols), bool)
            det_used = np.zeros(len(det_pols), bool)
            iou_mat = np.zeros((len(gt_pols), len(det_pols)))
            for gi, gp in enumerate(gt_pols):
                for di, dp in enumerate(det_pols):
                    iou_mat[gi, di] = geo.iou_convex(dp, gp)
            for gi in range(len(gt_pols)):
                for di in range(len(det_pols)):
                    if (
                        not gt_used[gi]
                        and not det_used[di]
                        and gi not in gt_dontcare
                        and di not in det_dontcare
                        and iou_mat[gi, di] > self.iou_constraint
                    ):
                        gt_used[gi] = det_used[di] = True
                        det_matched += 1
                        pairs.append({"gt": gi, "det": di})

        num_gt_care = len(gt_pols) - len(gt_dontcare)
        num_det_care = len(det_pols) - len(det_dontcare)
        if num_gt_care == 0:
            recall = 1.0
            precision = 0.0 if num_det_care > 0 else 1.0
        else:
            recall = det_matched / num_gt_care
            precision = 0.0 if num_det_care == 0 else det_matched / num_det_care
        hmean = 0.0 if precision + recall == 0 else 2 * precision * recall / (precision + recall)
        return {
            "precision": precision,
            "recall": recall,
            "hmean": hmean,
            "pairs": pairs,
            "gtCare": num_gt_care,
            "detCare": num_det_care,
            "detMatched": det_matched,
        }

    def combine_results(self, results: List[Dict]) -> Dict:
        num_gt = sum(r["gtCare"] for r in results)
        num_det = sum(r["detCare"] for r in results)
        matched = sum(r["detMatched"] for r in results)
        recall = 0.0 if num_gt == 0 else matched / num_gt
        precision = 0.0 if num_det == 0 else matched / num_det
        hmean = 0.0 if recall + precision == 0 else 2 * recall * precision / (recall + precision)
        return {"precision": precision, "recall": recall, "hmean": hmean}


class QuadMetric:
    def __init__(self, is_output_polygon: bool = False):
        self.is_output_polygon = is_output_polygon
        self.evaluator = DetectionIoUEvaluator(is_output_polygon=is_output_polygon)

    def measure(self, batch: Dict, output, box_thresh: float = 0.6) -> List[Dict]:
        results = []
        gt_polygons_batch = batch["text_polys"]
        ignore_tags_batch = batch["ignore_tags"]
        pred_polygons_batch, pred_scores_batch = output
        for polygons, pred_polygons, pred_scores, ignore_tags in zip(
            gt_polygons_batch, pred_polygons_batch, pred_scores_batch, ignore_tags_batch
        ):
            gt = [
                dict(points=np.int64(polygons[i]), ignore=bool(ignore_tags[i]))
                for i in range(len(polygons))
            ]
            if self.is_output_polygon:
                pred = [dict(points=pred_polygons[i]) for i in range(len(pred_polygons))]
            else:
                pred = [
                    dict(points=pred_polygons[i].astype(np.int64))
                    for i in range(len(pred_polygons))
                    if pred_scores[i] >= box_thresh
                ]
            results.append(self.evaluator.evaluate_image(gt, pred))
        return results

    def validate_measure(self, batch, output, box_thresh: float = 0.6):
        return self.measure(batch, output, box_thresh)

    def gather_measure(self, raw_metrics: List) -> Dict:
        raw = [m for batch_metrics in raw_metrics for m in batch_metrics]
        result = self.evaluator.combine_results(raw)
        precision = AverageMeter().update(result["precision"], n=len(raw))
        recall = AverageMeter().update(result["recall"], n=len(raw))
        fmeasure = AverageMeter().update(
            2 * precision.val * recall.val / (precision.val + recall.val + 1e-8)
        )
        return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def pixel_prf1(tp: float, gt_sum: float, pred_sum: float):
    """Pixel metrics from accumulated sums (reference eval, train_seg.py:46-55)."""
    recall = tp / gt_sum if gt_sum > 0 else 0.0
    precision = tp / pred_sum if pred_sum > 0 else 0.0
    f1 = 2 * recall * precision / (recall + precision) if recall + precision > 0 else 0.0
    return recall, precision, f1


def _box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M,4) x (G,4) xyxy -> (M,G) IoU matrix."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def per_class_ap50(
    preds: List[np.ndarray], gts: List[np.ndarray], nc: int = 2, iou_gate: float = 0.5
) -> Dict:
    """Per-class detection AP at IoU >= ``iou_gate`` (VOC continuous AP).

    ``preds``: per image (M, 6) rows [x1, y1, x2, y2, conf, cls];
    ``gts``:   per image (G, 5) rows [cls, x1, y1, x2, y2].
    Classes follow constants.LANG_LIST order (eng=0, ja=1).  Greedy
    confidence-descending matching, one GT per detection, like the
    torchvision/yolov5 eval convention the reference's upstream uses.
    Returns {'ap50': (nc,), 'map50': float, 'n_gt': (nc,)}.
    """
    ap = np.zeros(nc, np.float64)
    n_gt_per = np.zeros(nc, np.int64)
    for c in range(nc):
        scored = []  # (conf, tp) over all images
        n_gt = 0
        for p, g in zip(preds, gts):
            p = np.asarray(p, np.float64).reshape(-1, 6)
            g = np.asarray(g, np.float64).reshape(-1, 5)
            pc = p[p[:, 5] == c]
            gc = g[g[:, 0] == c][:, 1:5]
            n_gt += len(gc)
            if len(pc) == 0:
                continue
            pc = pc[np.argsort(-pc[:, 4])]
            iou = _box_iou_xyxy(pc[:, :4], gc)
            taken = np.zeros(len(gc), bool)
            for i in range(len(pc)):
                j = int(np.argmax(iou[i])) if len(gc) else -1
                ok = j >= 0 and iou[i, j] >= iou_gate and not taken[j]
                if ok:
                    taken[j] = True
                scored.append((pc[i, 4], 1.0 if ok else 0.0))
        n_gt_per[c] = n_gt
        if n_gt == 0 or not scored:
            ap[c] = 0.0
            continue
        arr = np.asarray(sorted(scored, key=lambda t: -t[0]), np.float64)
        tp = np.cumsum(arr[:, 1])
        fp = np.cumsum(1.0 - arr[:, 1])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-12)
        # continuous AP: precision envelope integrated over recall
        mrec = np.concatenate([[0.0], recall, [1.0]])
        mpre = np.concatenate([[1.0], precision, [0.0]])
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        ap[c] = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    valid = n_gt_per > 0
    return {
        "ap50": ap,
        "map50": float(ap[valid].mean()) if valid.any() else 0.0,
        "n_gt": n_gt_per,
    }
