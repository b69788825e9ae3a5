"""VidSTG evaluation metrics, host-side numpy (counterpart of
``vgqa_tpu/data/metrics/evaluator.py``).

The reference's VidSTG evaluator: per-item temporal IoU, vIoU (spatial IoU
summed over the predicted span's frames, over the union of the predicted
and ground-truth spans), vIoU@{0.3, 0.5}, gt_vIoU(@R), keyframe
precision/recall, averaged per question type (declar / inter).

Under data parallelism each process evaluates its slice of the test split;
``synchronize_between_processes`` gathers every process's predictions
(``parallel.distributed.all_gather_objects``, a JSON round-trip, where the
reference all_gathers pickled dicts) and merges them by item id, so every
process summarizes all items, each once.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...parallel.distributed import all_gather_objects, get_world_size, is_main_process
from ...utils.boxes import np_box_iou
from ..annotations import load_eval_annotations


def precision_recall(predicted: List[int], true: List[int]) -> Tuple[float, float]:
    """Keyframe selection precision/recall."""
    ps, ts = set(predicted), set(true)
    inter = len(ps & ts)
    precision = 0.0 if not ps else inter / len(ps)
    recall = 0.0 if not ts else inter / len(ts)
    return precision, recall


class VidSTGiouEvaluator:
    def __init__(
        self,
        data_dir: str,
        subset: str = "test",
        iou_thresholds: Optional[List[float]] = None,
    ):
        if subset not in ("train", "test", "val"):
            raise ValueError(f"Wrong VidSTG subset {subset}")
        gt = load_eval_annotations(data_dir, subset)
        self.vid2steds: Dict[int, List[int]] = {}
        self.vid2box: Dict[int, Dict[int, List[List[float]]]] = {}
        self.vid2names: Dict[int, Any] = {}
        self.vid2sents: Dict[int, str] = {}
        for item in gt:
            iid = item["item_id"]
            self.vid2steds[iid] = item["gt_temp_bound"]
            self.vid2box[iid] = {
                int(fid): [box] for fid, box in item["bboxs"].items()
            }
            self.vid2names[iid] = iid
            self.vid2sents[iid] = item["description"]
        self.iou_thresholds = iou_thresholds or [0.3, 0.5]

    def evaluate(self, predictions, video_predictions, pred_kf):
        vid_metrics: Dict[int, Dict[str, Any]] = {}
        for vid, vpred in video_predictions.items():
            if vid in vid_metrics:
                continue
            gt_sted = self.vid2steds[vid]
            pred_sted = vpred["sted"]
            qtype = vpred.get("qtype", "none")

            max_start = max(gt_sted[0], pred_sted[0])
            min_end = min(gt_sted[1], pred_sted[1])
            min_start = min(gt_sted[0], pred_sted[0])
            max_end = max(gt_sted[1], pred_sted[1])
            if min_end <= max_start:
                tiou = 0.0
            else:
                inter = min_end - max_start
                union = (
                    (gt_sted[1] - gt_sted[0])
                    + (pred_sted[1] - pred_sted[0])
                    - inter
                )
                tiou = inter / union

            union_predgt = set(range(min_start, max_end))
            inter_predgt = set(range(max_start, min_end))

            viou, gt_viou = 0.0, 0.0
            prediction = predictions.get(vid, {})
            for fid in self.vid2box[vid]:
                if fid not in prediction:
                    continue
                iou = np_box_iou(
                    np.array(prediction[fid]), np.array(self.vid2box[vid][fid])
                )[0][0]
                if fid in inter_predgt:
                    viou += iou
                gt_viou += iou

            viou = viou / max(len(union_predgt), 1)
            gt_viou = gt_viou / max(len(self.vid2box[vid]), 1)
            m = {
                "gt_sted": gt_sted,
                "pred_sted": pred_sted,
                "tiou": tiou,
                "qtype": qtype,
                "viou": viou,
                "gt_viou": gt_viou,
            }
            for th in self.iou_thresholds:
                m[f"viou@{th}"] = int(viou > th)
                m[f"gt_viou@{th}"] = int(gt_viou > th)
            vid_metrics[vid] = m

        for vid, kf in pred_kf.items():
            if vid in vid_metrics:
                vid_metrics[vid]["kf_pr"] = kf
        return vid_metrics, self.vid2names, self.vid2sents


class VidSTGEvaluator:
    """Accumulates per-batch predictions and summarizes."""

    def __init__(
        self,
        logger,
        data_dir: str,
        subset: str,
        iou_thresholds: Optional[List[float]] = None,
        save_pred: bool = False,
        save_dir: Optional[str] = None,
    ):
        self.evaluator = VidSTGiouEvaluator(data_dir, subset, iou_thresholds)
        self.iou_thresholds = iou_thresholds or [0.3, 0.5]
        self.logger = logger
        self.save_pred = save_pred
        self.save_dir = save_dir
        self.predictions: Dict[int, Dict[int, List[List[float]]]] = {}
        self.att_predictions: Dict[int, Any] = {}
        self.video_predictions: Dict[int, Dict[str, Any]] = {}
        self.kf_pred: Dict[int, Tuple[float, float]] = {}
        self.results = None

    def update(self, predictions):
        self.predictions.update(predictions)

    def update_att(self, predictions):
        self.att_predictions.update(predictions)

    def update_kf_pr(self, kf):
        self.kf_pred.update(kf)

    def video_update(self, video_predictions):
        self.video_predictions.update(video_predictions)

    def synchronize_between_processes(self):
        """Merge the predictions of every process of a data-parallel group
        into each (nothing to do on one). The payloads are gathered with
        their sizes first, so a whole split's predictions gather at any
        size."""
        if get_world_size() <= 1:
            return
        gathered = all_gather_objects({
            "predictions": self.predictions,
            "att": self.att_predictions,
            "video": self.video_predictions,
            "kf": self.kf_pred,
        })
        self._merge_gathered(gathered)

    def _merge_gathered(self, gathered):
        """Fold JSON-round-tripped payload dicts from every process back into
        the accumulators (keys arrive as strings, tuples as lists)."""
        for data in gathered:
            self.predictions.update({int(k): {int(f): b for f, b in v.items()}
                                     for k, v in data["predictions"].items()})
            self.att_predictions.update({int(k): v for k, v in data["att"].items()})
            self.video_predictions.update({int(k): v for k, v in data["video"].items()})
            self.kf_pred.update(
                {int(k): tuple(v) for k, v in data["kf"].items()}
            )

    def summarize(self):
        self.results, vid2names, vid2sents = self.evaluator.evaluate(
            self.predictions, self.video_predictions, self.kf_pred
        )
        categories = {x["qtype"] for x in self.results.values()}
        metrics = {c: {"tiou": 0.0, "viou": 0.0, "gt_viou": 0.0,
                       "kf_p": 0.0, "kf_r": 0.0} for c in categories}
        for c in categories:
            for th in self.iou_thresholds:
                metrics[c][f"viou@{th}"] = 0.0
                metrics[c][f"gt_viou@{th}"] = 0.0
        counter = {c: 0 for c in categories}
        for x in self.results.values():
            q = x["qtype"]
            metrics[q]["tiou"] += x["tiou"]
            metrics[q]["viou"] += x["viou"]
            metrics[q]["gt_viou"] += x["gt_viou"]
            for th in self.iou_thresholds:
                metrics[q][f"viou@{th}"] += x[f"viou@{th}"]
                metrics[q][f"gt_viou@{th}"] += x[f"gt_viou@{th}"]
            kf = x.get("kf_pr", (0.0, 0.0))
            metrics[q]["kf_p"] += kf[0]
            metrics[q]["kf_r"] += kf[1]
            counter[q] += 1
        for c in categories:
            for k in metrics[c]:
                metrics[c][k] = metrics[c][k] / max(counter[c], 1)
        out = {
            f"{q}_{name}": metrics[q][name] for q in metrics for name in metrics[q]
        }
        if self.logger:
            lines = "\n".join(
                f"{q} {k}: {metrics[q][k]:.4f}" for q in metrics for k in metrics[q]
            )
            self.logger.info("=" * 60 + "\n" + lines + "\n" + "=" * 60)
        if self.save_pred and self.save_dir and is_main_process():
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "test_results.json"), "w") as f:
                json.dump(
                    {
                        **out,
                        "predictions": self.predictions,
                        "video_predictions": self.video_predictions,
                        "vid_metrics": self.results,
                    },
                    f,
                    default=list,
                )
        return out


def build_evaluator(cfg, logger, mode="test", save_pred=False):
    """The reference's build_evaluator: IoU thresholds 0.3 and 0.5, the
    predictions saved under OUTPUT_DIR with ``save_pred``."""
    return VidSTGEvaluator(
        logger,
        cfg.DATA_DIR,
        mode,
        iou_thresholds=[0.3, 0.5],
        save_pred=save_pred,
        save_dir=cfg.OUTPUT_DIR,
    )
