"""VidSTG annotation preparation (counterpart of
``vgqa_tpu/data/annotations.py``: the same files, items and caches).

Merges the per-sentence temporal annotations with the per-video box
trajectories into a flat item list, builds the actioness mask and the
start/end pseudo-heatmaps, and caches the result as JSON, as the reference's
``VidSTGDataset.make_data_pairs`` / ``load_data`` do with pickles.

Layout under DATA_DIR (the reference's):
  sent_annos/{split}_annotations.json   per-sentence temporal annotations
  bbox_annos/{vid}.json                 per-video trajectories
  annos/{split}.json                    merged cache (written here)
  annos/{split}_meta.json               subject/verb/attribute metadata
  data_cache/                           item-list cache (written here)
  videos/{vid}.mp4                      raw videos
"""

from __future__ import annotations

import json
import os
import random
from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np

from .words import clean_description


def _atomic_json_dump(obj: Any, path: str) -> None:
    """Write-then-rename so concurrent readers (other ranks of a multi-host
    run sharing the data dir) never observe a partially-written cache; a
    reader that misses the file rebuilds the same content idempotently."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)

EPSILON = 1e-10


def _build_heatmaps(actioness: np.ndarray):
    """Start/end pseudo-heatmaps: 0.5 at the boundary, pseudo-prob at its
    neighbors, epsilon elsewhere."""
    action_idx = np.where(actioness)[0]
    start_idx, end_idx = action_idx[0], action_idx[-1]
    n = actioness.shape[0]
    pseudo = (1 - (n - 3) * EPSILON - 0.5) / 2

    start_hm = np.full(n, EPSILON)
    start_hm[start_idx] = 0.5
    if start_idx > 0:
        start_hm[start_idx - 1] = pseudo
    if start_idx < n - 1:
        start_hm[start_idx + 1] = pseudo

    end_hm = np.full(n, EPSILON)
    end_hm[end_idx] = 0.5
    if end_idx > 0:
        end_hm[end_idx - 1] = pseudo
    if end_idx < n - 1:
        end_hm[end_idx + 1] = pseudo
    return start_hm, end_hm


def make_data_pairs(data_dir: str, split: str) -> Dict[str, Any]:
    """Merge temporal + spatial GT into per-sentence pairs (the reference's
    make_data_pairs), cached in annos/{split}.json."""
    annos_dir = os.path.join(data_dir, "annos")
    merged_path = os.path.join(annos_dir, f"{split}.json")
    if os.path.exists(merged_path):
        with open(merged_path) as f:
            return json.load(f)
    os.makedirs(annos_dir, exist_ok=True)

    sent_file = os.path.join(data_dir, "sent_annos", f"{split}_annotations.json")
    with open(sent_file) as f:
        sent_annos = json.load(f)

    def get_bbox(bboxs, tid):
        for bbox in bboxs:
            if bbox.get("tid") == tid:
                return bbox
        return None

    out: Dict[str, Any] = {}
    pair_cnt = 0
    for anno in sent_annos:
        base = {
            "vid": anno["vid"],
            "fps": anno.get("fps", 30),
            "used_segment": anno["used_segment"],
            "width": anno["width"],
            "height": anno["height"],
            "ori_temp_gt": deepcopy(anno["temporal_gt"]),
            "frame_count": anno["used_segment"]["end_fid"]
            - anno["used_segment"]["begin_fid"]
            + 1,
        }
        bbox_path = os.path.join(data_dir, "bbox_annos", anno["vid"] + ".json")
        with open(bbox_path) as f:
            bbox_annos = json.load(f)

        for sent_type in ("captions", "questions"):
            for sent in anno.get(sent_type, []):
                pair = deepcopy(base)
                pair["id"] = pair_cnt
                pair["qtype"] = "declar" if sent_type == "captions" else "inter"
                pair["sentence"] = sent
                target_id = sent["target_id"]
                subj = get_bbox(anno.get("subject/objects", []), target_id)
                pair["target_category"] = subj["category"] if subj else ""

                trajectories = bbox_annos["trajectories"]
                pair["target_bboxs"] = []
                s = anno["temporal_gt"]["begin_fid"]
                e = min(anno["temporal_gt"]["end_fid"] + 1, anno["frame_count"])
                for idx in range(s, e):
                    bbox = get_bbox(trajectories[idx], target_id)
                    if bbox is None:
                        if pair["target_bboxs"]:
                            pair["target_bboxs"].append(pair["target_bboxs"][-1].copy())
                        else:
                            pair["target_bboxs"].append({})
                    else:
                        pair["target_bboxs"].append(bbox["bbox"])
                out[str(pair_cnt)] = pair
                pair_cnt += 1

    _atomic_json_dump(out, merged_path)
    return out


def load_items(
    data_dir: str, split: str, shuffle_seed: int = 0
) -> List[Dict[str, Any]]:
    """Build the flat training item list with masks/heatmaps, cached under
    data_cache/ (the reference's load_data)."""
    cache_dir = os.path.join(data_dir, "data_cache")
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(cache_dir, f"vidstg-{split}-input.json")
    anno_path = os.path.join(cache_dir, f"vidstg-{split}-anno.json")
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            items = json.load(f)
        for it in items:
            for k in ("actioness", "start_heatmap", "end_heatmap", "bboxs"):
                it[k] = np.asarray(it[k])
        return items

    pairs = make_data_pairs(data_dir, split)
    items: List[Dict[str, Any]] = []
    annos: List[Dict[str, Any]] = []
    for key in pairs:
        gt = pairs[key]
        span = gt["temp_gt"] if "temp_gt" in gt else None
        # the reference's validity filters
        if (
            len(gt["target_bboxs"])
            != min(gt["ori_temp_gt"]["end_fid"], gt["used_segment"]["end_fid"])
            - gt["ori_temp_gt"]["begin_fid"]
            + 1
        ):
            continue
        if (
            gt["ori_temp_gt"]["end_fid"] < gt["used_segment"]["begin_fid"]
            or gt["ori_temp_gt"]["begin_fid"] > gt["used_segment"]["end_fid"]
        ):
            continue
        if any(not b for b in gt["target_bboxs"]):
            continue

        start_fid = gt["used_segment"]["begin_fid"]
        end_fid = gt["used_segment"]["end_fid"]
        tg_begin = gt["ori_temp_gt"]["begin_fid"]
        tg_end = min(gt["ori_temp_gt"]["end_fid"], end_fid)
        frame_ids = list(range(start_fid, end_fid + 1))
        actioness = np.array(
            [int(tg_begin <= fid <= tg_end) for fid in frame_ids]
        )
        if actioness.sum() == 0:
            continue
        start_hm, end_hm = _build_heatmaps(actioness)
        bbox_array = np.array(
            [
                [b["xmin"], b["ymin"], b["xmax"], b["ymax"]]
                for b in gt["target_bboxs"]
            ],
            dtype=np.float64,
        )

        items.append(
            {
                "item_id": gt["id"],
                "vid": gt["vid"],
                "frame_ids": frame_ids,
                "width": gt["width"],
                "height": gt["height"],
                "actioness": actioness,
                "start_heatmap": start_hm,
                "end_heatmap": end_hm,
                "bboxs": bbox_array,
                "gt_temp_bound": [int(tg_begin), int(tg_end)],
                "segment_bound": [int(start_fid), int(end_fid)],
                "qtype": gt["qtype"],
                "description": clean_description(gt["sentence"]["description"]),
                "object": gt.get("target_category", ""),
            }
        )
        annos.append(
            {
                "item_id": gt["id"],
                "vid": gt["vid"],
                "bboxs": {
                    str(fid): bbox_array[fid - tg_begin].tolist()
                    for fid in range(tg_begin, tg_end + 1)
                },
                "description": items[-1]["description"],
                "qtype": gt["qtype"],
                "gt_temp_bound": [int(tg_begin), int(tg_end)],
                "segment_bound": [int(start_fid), int(end_fid)],
            }
        )

    rng = random.Random(shuffle_seed)
    order = list(range(len(items)))
    rng.shuffle(order)
    items = [items[i] for i in order]

    def jsonable(it):
        return {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in it.items()
        }

    _atomic_json_dump([jsonable(it) for it in items], cache_path)
    _atomic_json_dump(annos, anno_path)
    return items


def load_eval_annotations(data_dir: str, split: str) -> List[Dict[str, Any]]:
    """Ground truth for the evaluator (the anno cache the reference's
    VidSTG evaluator reads)."""
    path = os.path.join(data_dir, "data_cache", f"vidstg-{split}-anno.json")
    if not os.path.exists(path):
        load_items(data_dir, split)
    with open(path) as f:
        return json.load(f)


def load_meta(data_dir: str, split: str) -> Dict[str, Dict]:
    """Subject/verb/attribute metadata keyed by item id.

    The reference loads DATA_DIR/annos/{train,test}.json inside the model
    and reads 'sub', 'verb_index_list', 'adj_index_list'. Missing file ->
    empty dict (inference mode)."""
    path = os.path.join(data_dir, "annos", f"{split}_meta.json")
    if not os.path.exists(path):
        # fall back to the merged annotation file if it carries the fields
        path = os.path.join(data_dir, "annos", f"{split}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return data if isinstance(data, dict) else {}
