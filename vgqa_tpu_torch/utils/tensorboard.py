"""TensorBoard scalar logging (counterpart of ``vgqa_tpu/utils/tensorboard.py``).

Writes through ``torch.utils.tensorboard`` when the ``tensorboard`` package
imports, and does nothing otherwise, as the JAX copy does without
TensorFlow. An empty ``log_dir`` writes nothing.
"""

from __future__ import annotations


class SummaryWriter:
    def __init__(self, log_dir: str):
        self._writer = None
        if not log_dir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer
        except ImportError:       # no tensorboard package: scalars are dropped
            return
        self._writer = _Writer(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
