"""The grounding trainer (counterpart of ``Trainer`` in ``tools/train.py``).

``Trainer.setup`` builds the model (seeded random weights, f32 masters on
the device), the grouped optimizer, the EMA and the step; it resumes from
the ``last_checkpoint`` tag under ``OUTPUT_DIR``, or else warm-starts from
``MODEL.WEIGHT`` when that file exists (a port state dict, such as
``tools/export_torch_checkpoint.py`` writes). ``fit()`` trains over the
VidSTG loader from the resumed iteration: batches arrive in pinned host
memory and are uploaded without blocking, the device's metrics are read
only every 50 steps and at the last (the log's ``time`` and eta come from
the wall time between those synced reads), ``model_{step}`` /
``model_final`` are saved with their params twins ``*_params`` (the EMA
weights when ``MODEL.EMA`` is on), and ``validate`` runs ``do_eval`` on the
test split every ``SOLVER.VAL_PERIOD`` steps when ``SOLVER.TO_VAL`` holds.
Traced (``utils/trace``): ``vgqa.train.log`` around each synced read and its
logging; the step's spans are ``training/train_step.py``'s.
``fit(batches, steps)`` runs the same loop over given batches instead and
reads the metrics of every step. ``setup`` sets the port's float32 policy
(``utils/device.apply_precision_policy``: TF32 off in cuBLAS and cuDNN).

Data parallelism: in a ``torch.distributed`` group (``parallel.
initialize_multihost``, which ``tools/train`` calls first) the layout is
``build_mesh(TPU.MESH_DP, MESH_TP, MESH_SP)``: dp = the group's size, one
card per rank (``tp`` / ``sp`` above 1 raise). Each rank builds the same
seeded model, loads the same checkpoint, and reads its slice of a global
batch of dp videos (``max_iter`` = ceil(items / dp) x epochs); the step
averages the gradients (``training/train_step.py``); the metrics are
averaged over the group on the log cadence only, and only rank 0 logs,
writes tensorboard scalars and checkpoints; ``validate`` evaluates each
rank's slice and merges the predictions.

    python -m vgqa_tpu_torch.training.trainer --steps N [--device cpu] [KEY VALUE ...]

trains on the fixed synthetic batch (``data/synthetic_batch.py``) and logs
the loss terms of every step; ``python -m vgqa_tpu_torch.tools.train``
trains over the dataset.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import torch

from ..data.collate import batch_to
from ..data.loader import make_data_loader
from ..data.metrics import build_evaluator
from ..data.synthetic_batch import synthetic_batch
from ..models import GroundingConfig, VSTGNet
from ..models.init_weights import init_weights
from ..models.loss import build_loss, build_weight_dict
from ..parallel.distributed import is_main_process, reduce_mean
from ..parallel.mesh import build_mesh
from ..utils import trace
from ..utils.device import apply_precision_policy, resolve_device
from ..utils.metrics_logger import MetricLogger
from ..utils.tensorboard import SummaryWriter
from .checkpoint import CheckpointManager
from .evaluator import do_eval
from .optimizer import GroupedAdamW
from .train_step import create_train_state, make_train_step

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
LOG_PERIOD = 50          # steps between reads of the device's metrics


class Trainer:
    def __init__(self, cfg, device=None, seed: int = 2021,
                 logger: Optional[logging.Logger] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        self.logger = logger or logging.getLogger(__name__)
        # (step, loader wait s, step s by the host clock) of every loader step
        self.step_log: List[tuple] = []

    def _loader(self, mode: str = "train", start_iter: int = 0):
        return make_data_loader(self.cfg, mode, start_iter=start_iter,
                                global_batch=self.mesh.dp,
                                pin_memory=self.device.type == "cuda")

    def setup(self, max_iter: Optional[int] = None) -> None:
        """Build everything; ``max_iter`` defaults to the train loader's
        length (SOLVER.MAX_EPOCH epochs of the train split)."""
        c = self.cfg
        apply_precision_policy()
        self.mesh = build_mesh(c.TPU.MESH_DP, c.TPU.MESH_TP, c.TPU.MESH_SP)
        self.logger.info(f"Mesh: dp={self.mesh.dp}, sp={self.mesh.sp}, tp={self.mesh.tp}")
        if max_iter is None:
            max_iter = len(self._loader())
        model = VSTGNet(GroundingConfig.from_cfg(c))
        init_weights(model, torch.Generator().manual_seed(self.seed))
        model = model.to(self.device)
        model.vis_encoder.to(memory_format=torch.channels_last)
        self.max_iter = max_iter
        optimizer = GroupedAdamW(c, model, max_iter)
        self.state = create_train_state(model, optimizer, use_ema=c.MODEL.EMA)
        n = sum(p.numel() for p in model.parameters())
        self.logger.info(f"Model parameters: {n / 1e6:.1f}M")
        self.weight_dict = build_weight_dict(c)
        self.step_fn = make_train_step(
            build_loss(c), self.weight_dict, c.MODEL.EMA_DECAY if c.MODEL.EMA else None,
            compute_dtype=_DTYPES[c.TPU.TRAIN_DTYPE],
            pixel_stats=(c.INPUT.PIXEL_MEAN, c.INPUT.PIXEL_STD))
        self.ckpt = CheckpointManager(c.OUTPUT_DIR) if c.OUTPUT_DIR else None
        if self.ckpt is not None and self.ckpt.load(self.state):
            self.logger.info(f"Resumed at iteration {self.state.step}")
        elif c.MODEL.WEIGHT:
            self._warm_start(c.MODEL.WEIGHT)

    def _warm_start(self, path: str) -> None:
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; export it where JAX "
                "is installed with `python tools/export_torch_checkpoint.py grounding "
                f"{path} OUT.pt` and set MODEL.WEIGHT OUT.pt")
        if not os.path.exists(path):
            self.logger.info(f"MODEL.WEIGHT {path} not found: training from the seeded "
                             "initialization")
            return
        model = self.state.model
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                              strict=True)
        if self.state.ema is not None:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    self.state.ema[n].copy_(p)
        self.state.cast_cache.clear()
        self.logger.info(f"Warm started from {path}")

    def fit(self, batches: Optional[Iterable[Dict[str, Any]]] = None,
            steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Train from the resumed step over the loader (see the module
        docstring), or for ``steps`` steps over ``batches`` (cycled, uploaded
        once), reading the metrics of every step; returns the metrics read."""
        c = self.cfg
        start_iter = self.state.step
        if batches is None:
            source, last, period = (self._loader("train", start_iter=start_iter),
                                    self.max_iter, LOG_PERIOD)
        else:
            held = [batch_to(b, self.device) for b in batches]
            source = ({**held[i % len(held)], "iteration": start_iter + i}
                      for i in range(steps))
            last, period = start_iter + steps, 1
        meter = MetricLogger()
        writer = SummaryWriter(c.TENSORBOARD_DIR if is_main_process() else "")
        logged = []
        start_time = before = time.perf_counter()
        synced, synced_step = start_time, start_iter
        for batch in source:
            data_time = time.perf_counter() - before
            step = batch["iteration"] + 1
            b = batch_to(batch, self.device)
            metrics = self.step_fn(self.state, b["video"], b["text"], b["targets"], self.seed)
            del b
            batch_time = time.perf_counter() - before
            before = time.perf_counter()
            meter.update(data=data_time)
            self.step_log.append((step, data_time, batch_time))
            if step % period == 0 or step == last:
                with trace.span("vgqa.train.log"):
                    host = reduce_mean(metrics)   # the host sync (the group's mean under dp)
                    # the steps' time: wall time between two synced reads
                    now = time.perf_counter()
                    meter.meters["time"].update((now - synced) / (step - synced_step),
                                                step - synced_step)
                    synced, synced_step = now, step
                    logged.append({"step": step, **host})
                    verbose = {k: v for k, v in host.items()
                               if k in self.weight_dict and not k[-1].isdigit()}
                    meter.update(loss=host["loss"], **verbose)
                    eta = meter.time.global_avg * (last - step)
                    self.logger.info(f"eta: {datetime.timedelta(seconds=int(eta))}  "
                                     f"iter {step} / {last}  {meter}")
                    for k, v in host.items():
                        writer.add_scalar(k, v, step)
            if self.ckpt is not None and step % c.SOLVER.CHECKPOINT_PERIOD == 0:
                self.save(f"model_{step:06d}")
            if c.SOLVER.TO_VAL and step % c.SOLVER.VAL_PERIOD == 0:
                self.validate()
        if self.ckpt is not None:
            self.save("model_final")
        writer.close()
        total = time.perf_counter() - start_time
        self.logger.info(f"Total training time: {datetime.timedelta(seconds=int(total))} "
                         f"({total / max(1, last - start_iter):.4f} s / it)")
        return logged

    def eval_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The weights to evaluate: the EMA when ``MODEL.EMA`` is on, else
        None (the model's own parameters)."""
        return self.state.ema

    def params_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with :meth:`eval_params` in place of its
        parameters: what a params twin holds."""
        sd = self.state.model.state_dict()
        if self.state.ema is not None:
            sd.update(self.state.ema)
        return sd

    def save(self, name: str) -> None:
        """The train state as ``name`` (the resume tag moves to it) and its
        params twin ``name_params``; rank 0 writes both."""
        self.ckpt.save(name, self.state)
        self.ckpt.save_params(f"{name}_params", self.params_state_dict())

    def validate(self) -> Dict[str, float]:
        """``do_eval`` on the test split with :meth:`eval_params`: each rank
        evaluates its slice, and the metrics are those of all items, merged.
        The last step's gradients and the allocator's cached blocks are
        released first, so evaluation does not stack on the training peak."""
        c = self.cfg
        for p in self.state.model.parameters():
            p.grad = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        evaluator = build_evaluator(c, self.logger, mode="test")
        return do_eval(c, "test", self.logger, self.state.model, self._loader("test"),
                       evaluator, params=self.eval_params())

    def test(self) -> Dict[str, float]:
        return self.validate()


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
    cfg.SOLVER.TO_VAL = False              # no test split beside the synthetic batch
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    trainer = Trainer(cfg, args.device, args.seed)
    trainer.setup(max_iter=max(1, args.steps))
    trainer.fit([synthetic_batch(cfg, seed=args.seed)], args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
