"""The evaluation loop (counterpart of ``vgqa_tpu/training/evaluator.py``):
the forward + postprocess of one half-clip pass, the host-side merge of
even/odd halves (boxes by linear interpolation, confidences by hold
interpolation, the span by union), and ``do_eval``, which runs both halves
of every test clip of a loader and summarizes the VidSTG metrics."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.collate import batch_to
from ..data.metrics.evaluator import precision_recall
from ..models.postprocess import postprocess
from ..utils import trace
from ..utils.containers import TextBatch, VideoBatch, normalize_uint8_video


def linear_interp(bbox_dict: Dict[int, List[List[float]]]):
    """Fill the frames between known boxes by linear interpolation."""
    fids = sorted(bbox_dict.keys())
    if len(fids) < 2:
        return bbox_dict
    for i in range(len(fids) - 1):
        left, right = fids[i], fids[i + 1]
        if right - left > 1:
            interval = right - left
            lb = np.asarray(bbox_dict[left][0], dtype=np.float64)
            rb = np.asarray(bbox_dict[right][0], dtype=np.float64)
            step_v = (rb - lb) / interval
            for s in range(1, interval):
                bbox_dict[left + s] = [(lb + s * step_v).tolist()]
    fids = sorted(bbox_dict.keys())
    if max(fids) - min(fids) + 1 != len(fids):
        raise ValueError("interpolated frame ids are not contiguous")
    return {f: bbox_dict[f] for f in fids}


def linear_interp_conf(conf_dict: Dict[int, Any]):
    """Hold interpolation: each gap takes the nearer known value."""
    fids = sorted(conf_dict.keys())
    if len(fids) < 2:
        return conf_dict
    for i in range(len(fids) - 1):
        left, right = fids[i], fids[i + 1]
        if right - left > 1:
            interval = right - left
            for s in range(1, interval):
                conf_dict[left + s] = (
                    conf_dict[left] if s <= interval // 2 else conf_dict[right])
    fids = sorted(conf_dict.keys())
    return {f: conf_dict[f] for f in fids}


def make_eval_forward(model: torch.nn.Module, pixel_stats=None,
                      params: Optional[Dict[str, torch.Tensor]] = None):
    """Forward + postprocess of one pass, packed as ``[V, T, 6]``
    ([boxes | att | select]) and ``[V, 2]`` span indices, both left on the
    model's device. ``params`` (a name -> tensor dict, e.g. the EMA) stands
    in for the model's own parameters. uint8 frames are normalized on the
    device in the parameters' dtype, with the letterbox and time padding
    re-zeroed."""
    dtype = next(iter(params.values())).dtype if params else next(model.parameters()).dtype

    @torch.inference_mode()
    def fwd(video: VideoBatch, text: TextBatch, ori_sizes, letterbox):
        if video.frames.dtype == torch.uint8:
            video = normalize_uint8_video(video, pixel_stats, dtype)
        if params:
            out = torch.func.functional_call(model, params, (video, text))
        else:
            out = model(video, text)
        boxes, s_idx, e_idx = postprocess(out["pred_boxes"], out["pred_sted"],
                                          ori_sizes, video.time_mask, letterbox=letterbox)
        packed = torch.cat([boxes.float(), out["att_sequences"].float()[..., None],
                            out["select_mask"].float()[..., None]], dim=-1)
        span = torch.stack([s_idx, e_idx], dim=-1).int()
        return packed, span

    return fwd


def dispatch_forward(fwd, video: VideoBatch, text: TextBatch, infos: List[Dict],
                     canvas=None):
    """Launch one half-clip pass; returns device tensors without a sync, so
    the host can go on (decode the next video) while the device works."""
    dev = video.frames.device
    ori = torch.tensor([list(i["ori_size"]) for i in infos], dtype=torch.float32)
    ch, cw = canvas if canvas is not None else (video.frames.shape[2], video.frames.shape[3])
    lb = np.asarray(
        [i.get("letterbox", [cw / i["ori_size"][1], ch / i["ori_size"][0], 0.0, 0.0])
         for i in infos], np.float32)
    lb = lb / np.array([cw, ch, cw, ch], np.float32)
    with trace.sync("forward.sizes"):
        ori, lb = ori.to(dev), torch.from_numpy(lb).to(dev)
    return fwd(video, text, ori, lb)


def convert_outputs(packed_dev, span_dev, infos: List[Dict], gt_actioness: np.ndarray):
    """Fetch a dispatched pass and convert it to per-video dicts."""
    with trace.sync("convert_outputs"):
        packed = packed_dev.cpu().numpy()
        span = span_dev.cpu().numpy()
    boxes = packed[..., :4]
    att = packed[..., 4]
    select = packed[..., 5] > 0.5
    starts, ends = span[..., 0], span[..., 1]

    bbox_pred, att_pred, temp_pred, kf_pred = {}, {}, {}, {}
    for i, info in enumerate(infos):
        vid = info["item_id"]
        fids = info["frame_ids"]
        dur = info["duration"]
        bbox_pred[vid] = {fids[t]: [boxes[i, t].tolist()] for t in range(dur)}
        att_pred[vid] = {fids[t]: [float(att[i, t])] for t in range(dur)}
        temp_pred[vid] = {
            "sted": [fids[int(starts[i])], fids[int(ends[i])] + 1],
            "qtype": info.get("qtype", "none"),
        }
        chosen = [t for t in range(dur) if select[i, t]]
        gt_idx = [t for t in range(dur) if gt_actioness[i, t] > 0]
        kf_pred[vid] = list(precision_recall(chosen, gt_idx))
    return bbox_pred, att_pred, temp_pred, kf_pred


def single_forward(fwd, video: VideoBatch, text: TextBatch, infos: List[Dict],
                   gt_actioness: np.ndarray, canvas=None):
    """dispatch_forward + convert_outputs in one synchronous call."""
    packed, span = dispatch_forward(fwd, video, text, infos, canvas=canvas)
    return convert_outputs(packed, span, infos, gt_actioness)


def do_eval(cfg, mode, logger, model, data_loader, evaluator,
            params: Optional[Dict[str, torch.Tensor]] = None):
    """The reference's do_eval: every test clip (2 x TRAIN_SAMPLE_NUM
    frames) runs as its even and its odd half, one forward each on the
    model's device; the halves merge on the host (boxes by linear
    interpolation, attention by hold interpolation, keyframe precision and
    recall averaged, the span by union) into ``evaluator``, which then
    summarizes. ``params`` (e.g. the EMA weights) stands in for the model's
    parameters. In a data-parallel group each rank evaluates its loader's
    slice and ``evaluator`` merges every rank's predictions before it
    summarizes, so every rank returns the metrics of all items. Returns the
    metrics dict."""
    if logger:
        logger.info(f"Start evaluation on the {mode} split of {cfg.DATASET.NAME}")
    fwd = make_eval_forward(model, pixel_stats=(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD),
                            params=params)
    device = next(model.parameters()).device

    for batch in data_loader:
        b = batch_to(batch, device)
        video, text = b["video"], b["text"]
        infos = batch["info"]
        act = batch["targets"]["actioness"].numpy()

        halves = []
        for start in (0, 1):
            infos_half = [{**info, "frame_ids": info["frame_ids"][start::2],
                           "duration": len(info["frame_ids"][start::2])} for info in infos]
            halves.append(single_forward(fwd, video.subsample(2, start), text, infos_half,
                                         act[:, start::2]))

        (b1, a1, t1, k1), (b2, a2, t2, k2) = halves
        for vid in b1:
            b1[vid].update(b2[vid])
            a1[vid].update(a2[vid])
            evaluator.update({vid: linear_interp(b1[vid])})
            evaluator.update_att({vid: linear_interp_conf(a1[vid])})
            evaluator.update_kf_pr(
                {vid: [(k1[vid][0] + k2[vid][0]) / 2, (k1[vid][1] + k2[vid][1]) / 2]})
            evaluator.video_update({vid: {
                "sted": [min(t1[vid]["sted"][0], t2[vid]["sted"][0]),
                         max(t1[vid]["sted"][1], t2[vid]["sted"][1])],
                "qtype": t1[vid].get("qtype", "none")}})

    evaluator.synchronize_between_processes()
    if logger:
        logger.info(f"Complete the inference on {mode} split of {cfg.DATASET.NAME}")
    return evaluator.summarize()
