"""Segmentation metrics.

Re-implements the reference's two metric paths with identical semantics:

* Offline confusion-matrix evaluation with the UNKNOWN_ID=255 (ignored GT) and
  NO_FEATURE_ID=256 (prediction sentinel -> extra confusion row) conventions,
  where mean IoU divides by the number of classes, not seen classes
  (reference ``util/metric.py:9-104``).
* Streaming intersection/union/target histograms for in-training validation
  (reference ``util/util.py:117-145``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .labels import NO_FEATURE_ID, UNKNOWN_ID, labels_for_dataset


def confusion_matrix(pred_ids: np.ndarray, gt_ids: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """Confusion matrix with rows=pred, cols=gt; GT==255 ignored; pred==256
    counted in an extra (dropped) row."""
    assert pred_ids.shape == gt_ids.shape, (pred_ids.shape, gt_ids.shape)
    pred_ids = np.asarray(pred_ids)
    gt_ids = np.asarray(gt_ids)
    keep = gt_ids != UNKNOWN_ID
    pred = pred_ids[keep].astype(np.int64)
    gt = gt_ids[keep].astype(np.int64)
    if (pred == NO_FEATURE_ID).any():
        pred = np.where(pred == NO_FEATURE_ID, num_classes, pred)
        n = num_classes + 1
        conf = np.bincount(pred * n + gt, minlength=n * n).reshape(n, n)
        return conf[:num_classes, :num_classes].astype(np.uint64)
    n = num_classes
    return np.bincount(pred * n + gt, minlength=n * n).reshape(n, n).astype(np.uint64)


def class_iou(label_id: int, confusion: np.ndarray):
    """(iou, tp, tp+fp+fn) for one class; NaN-style None when denom == 0."""
    tp = int(confusion[label_id, label_id])
    fp = int(confusion[label_id, :].sum()) - tp
    fn = int(confusion[:, label_id].sum()) - tp
    denom = tp + fp + fn
    if denom == 0:
        return float("nan"), tp, denom
    return tp / denom, tp, denom


def evaluate(pred_ids: np.ndarray, gt_ids: np.ndarray,
             dataset: str = "scannet_3d", stdout: bool = False,
             return_details: bool = False):
    """Mean IoU over the dataset's labelset.

    Classes with zero GT points are skipped from the sum, but the mean still
    divides by the full class count (reference ``util/metric.py:70-83``).
    """
    class_labels = labels_for_dataset(dataset)
    n_classes = len(class_labels)
    conf = confusion_matrix(np.asarray(pred_ids).copy(), np.asarray(gt_ids),
                            n_classes)
    gt_ids = np.asarray(gt_ids)
    ious: Dict[str, Tuple[float, int, int]] = {}
    accs: Dict[str, float] = {}
    mean_iou = 0.0
    mean_acc = 0.0
    for i, name in enumerate(class_labels):
        gt_count = int((gt_ids == i).sum())
        if gt_count == 0:
            continue
        ious[name] = class_iou(i, conf)
        accs[name] = ious[name][1] / gt_count
        mean_iou += ious[name][0]
        mean_acc += accs[name]
    mean_iou /= n_classes
    mean_acc /= n_classes
    if stdout:
        print("classes          IoU")
        print("----------------------------")
        for name in class_labels:
            if name in ious:
                print("{0:<14s}: {1:>5.3f}   ({2:>6d}/{3:<6d})".format(
                    name, ious[name][0], ious[name][1], ious[name][2]))
        print("Mean IoU", mean_iou)
        print("Mean Acc", mean_acc)
    if return_details:
        return mean_iou, mean_acc, ious, accs
    return mean_iou


def intersection_and_union(output, target, num_classes: int,
                           ignore_index: int = UNKNOWN_ID):
    """Per-batch (intersection, union, target) histograms.

    Matches reference ``util/util.py:132-145``: predictions at ignored GT
    positions are set to the ignore index so they fall outside every class bin.
    """
    output = np.asarray(output).reshape(-1)
    target = np.asarray(target).reshape(-1)
    output = np.where(target == ignore_index, ignore_index, output)
    matches = output == target

    class_ids = np.arange(num_classes)
    # one-hot histograms; ignore_index falls outside [0, num_classes)
    out_hist = (output[:, None] == class_ids[None, :]).sum(axis=0)
    tgt_hist = (target[:, None] == class_ids[None, :]).sum(axis=0)
    inter_hist = ((output[:, None] == class_ids[None, :]) & matches[:, None]).sum(axis=0)
    union_hist = out_hist + tgt_hist - inter_hist
    return inter_hist, union_hist, tgt_hist


def miou_from_histograms(intersection: np.ndarray, union: np.ndarray,
                         target: np.ndarray):
    """(mIoU, mAcc, allAcc) from accumulated histograms
    (reference run/distill.py:439-443)."""
    intersection = np.asarray(intersection, dtype=np.float64)
    union = np.asarray(union, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    iou_class = intersection / (union + 1e-10)
    acc_class = intersection / (target + 1e-10)
    miou = float(np.mean(iou_class))
    macc = float(np.mean(acc_class))
    all_acc = float(intersection.sum() / (target.sum() + 1e-10))
    return miou, macc, all_acc
