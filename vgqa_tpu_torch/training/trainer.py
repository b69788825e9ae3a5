"""The grounding trainer (counterpart of the ``Trainer.setup``/``fit`` part
of ``tools/train.py``), over given batches.

    python -m vgqa_tpu_torch.training.trainer --steps N [--device cpu] [KEY VALUE ...]

trains on the fixed synthetic batch (``data/synthetic_batch.py``) and logs
the loss terms of every step. The VidSTG loader waits for the next slice.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Dict, Iterable, List

import torch

from ..data.synthetic_batch import synthetic_batch
from ..models import GroundingConfig, VSTGNet
from ..models.init_weights import init_weights
from ..models.loss import build_loss, build_weight_dict
from ..utils.containers import TextBatch, VideoBatch
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager
from .optimizer import GroupedAdamW
from .train_step import create_train_state, make_train_step

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
logger = logging.getLogger(__name__)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Move a collated batch's tensors to ``device``."""
    v, t = batch["video"], batch["text"]
    nb = device.type == "cuda"
    return {
        "video": VideoBatch(*(x.to(device, non_blocking=nb)
                              for x in (v.frames, v.pixel_mask, v.time_mask))),
        "text": TextBatch(t.token_ids.to(device, non_blocking=nb),
                          t.mask.to(device, non_blocking=nb)),
        "targets": {k: x.to(device, non_blocking=nb) for k, x in batch["targets"].items()},
    }


class Trainer:
    def __init__(self, cfg, device=None, seed: int = 2021):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed

    def setup(self, max_iter: int) -> None:
        """Model (seeded random weights, f32 masters on the device), the
        grouped optimizer, the EMA, the step, and resume from the
        ``last_checkpoint`` tag under ``OUTPUT_DIR`` when there is one."""
        c = self.cfg
        model = VSTGNet(GroundingConfig.from_cfg(c))
        init_weights(model, torch.Generator().manual_seed(self.seed))
        model = model.to(self.device)
        model.vis_encoder.to(memory_format=torch.channels_last)
        self.max_iter = max_iter
        optimizer = GroupedAdamW(c, model, max_iter)
        self.state = create_train_state(model, optimizer, use_ema=c.MODEL.EMA)
        n = sum(p.numel() for p in model.parameters())
        logger.info(f"Model parameters: {n / 1e6:.1f}M")
        self.weight_dict = build_weight_dict(c)
        self.step_fn = make_train_step(
            build_loss(c), self.weight_dict, c.MODEL.EMA_DECAY if c.MODEL.EMA else None,
            compute_dtype=_DTYPES[c.TPU.TRAIN_DTYPE],
            pixel_stats=(c.INPUT.PIXEL_MEAN, c.INPUT.PIXEL_STD))
        self.ckpt = CheckpointManager(c.OUTPUT_DIR) if c.OUTPUT_DIR else None
        if self.ckpt is not None and self.ckpt.load(self.state):
            logger.info(f"Resumed at iteration {self.state.step}")

    def fit(self, batches: Iterable[Dict[str, Any]], steps: int) -> List[Dict[str, float]]:
        """Run ``steps`` train steps over ``batches`` (cycled); returns the
        host-side metrics of every step (one host sync per step). Saves
        ``model_final`` (and every ``SOLVER.CHECKPOINT_PERIOD`` steps) when
        ``OUTPUT_DIR`` is set."""
        c = self.cfg
        batches = [batch_to(b, self.device) for b in batches]
        logged = []
        t0 = time.perf_counter()
        for i in range(steps):
            b = batches[i % len(batches)]
            metrics = self.step_fn(self.state, b["video"], b["text"], b["targets"], self.seed)
            step = self.state.step
            host = {k: float(v) for k, v in metrics.items()}   # the host sync
            logged.append({"step": step, **host})
            terms = "  ".join(f"{k} {v:.4f}" for k, v in host.items()
                              if k in self.weight_dict and not k[-1].isdigit())
            logger.info(f"iter {step}  loss {host['loss']:.4f}  "
                        f"grad_norm {host['grad_norm']:.4f}  {terms}  "
                        f"({(time.perf_counter() - t0) / (i + 1):.3f} s/it)")
            if self.ckpt is not None and step % c.SOLVER.CHECKPOINT_PERIOD == 0:
                self.ckpt.save(f"model_{step:06d}", self.state)
        if self.ckpt is not None:
            self.ckpt.save("model_final", self.state)
        return logged


def main(argv=None) -> int:
    from ..config import build_default_cfg

    ap = argparse.ArgumentParser(description="Train the grounding model on the synthetic batch")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--config-file", default="")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="config KEY VALUE pairs")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = build_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    trainer = Trainer(cfg, args.device, args.seed)
    trainer.setup(max_iter=max(1, args.steps))
    trainer.fit([synthetic_batch(cfg, seed=args.seed)], args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
