"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card. Without a
    visible CUDA device that raises: the caller asks for the CPU itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass device=\"cpu\" to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


def apply_precision_policy() -> None:
    """The port's float32 policy, which its entry points set (the trainer,
    ``inference/grounding.load_model``, ``tools/train`` and ``tools/evaluate``):
    TF32 off in cuBLAS and in cuDNN, so a float32 model
    (``TPU.TRAIN_DTYPE`` / ``TPU.COMPUTE_DTYPE float32``) runs every product,
    convolutions included, in float32, the setting the float32 kernels'
    1e-4 bound assumes; a bf16 model's products are bf16 either way, and its
    float32 side operations stay float32. PyTorch's own default runs cuDNN
    convolutions in TF32 instead."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
