"""Checkpoints of the train state (counterpart of
``vgqa_tpu/training/checkpoint.py``): ``torch.save`` of the step, the f32
master parameters, the optimizer moments and the EMA under
``OUTPUT_DIR/<name>``, with the JAX package's ``last_checkpoint`` tag file
naming the newest resumable checkpoint, and resume from it; and the
params-only twins (``<name>_params``): a model state dict that
``inference/grounding.load_model`` and ``tools/evaluate`` load, written
without moving the tag.

Under data parallelism every rank holds the same state: rank 0 writes, and
every rank waits at a barrier until the file and the tag are in place, so
no two ranks write one ``.tmp`` and a resume finds a whole checkpoint; every
rank loads.
"""

from __future__ import annotations

import logging
import os

import torch

from ..parallel.distributed import is_main_process, synchronize
from .train_step import TrainState

logger = logging.getLogger(__name__)


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    @property
    def _tag_path(self) -> str:
        return os.path.join(self.output_dir, "last_checkpoint")

    def get_checkpoint_file(self) -> str:
        try:
            with open(self._tag_path) as f:
                return f.read().strip()
        except OSError:
            return ""

    def save(self, name: str, state: TrainState) -> str:
        """Save ``state`` as ``name`` and point ``last_checkpoint`` at it
        (rank 0 writes; every rank returns after both are in place)."""
        path = os.path.join(self.output_dir, name)
        if is_main_process():
            logger.info(f"Saving checkpoint to {path}")
            torch.save({"step": state.step,
                        "model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "ema": state.ema}, f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
            with open(self._tag_path, "w") as f:
                f.write(path)
        synchronize()
        return path

    def save_params(self, name: str, state_dict) -> str:
        """Save a model state dict as ``name``; the tag file stays where it is
        (a params twin is not a resumable checkpoint); rank 0 writes, as in
        :meth:`save`."""
        path = os.path.join(self.output_dir, name)
        if is_main_process():
            logger.info(f"Saving parameters to {path}")
            torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
        synchronize()
        return path

    def load(self, state: TrainState, path: str = "") -> bool:
        """Restore into ``state`` in place, from ``path`` or else from the
        tag file; False when there is nothing to load."""
        if not path:
            path = self.get_checkpoint_file()
        if not path or not os.path.exists(path):
            return False
        logger.info(f"Loading checkpoint from {path}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(saved["model"], strict=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        if (saved["ema"] is None) != (state.ema is None):
            raise ValueError(f"{path}: EMA presence differs from this train state")
        if state.ema is not None:
            for n, t in saved["ema"].items():
                state.ema[n].copy_(t)
        state.step = int(saved["step"])
        state.cast_cache.clear()
        return True
