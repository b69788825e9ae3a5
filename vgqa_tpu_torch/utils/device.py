"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card. Without a
    visible CUDA device that raises: the caller asks for the CPU itself. A
    card without an index is torch's current one, which in a data-parallel
    run is the rank's card (``parallel.initialize_multihost`` sets it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass device=\"cpu\" to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a data-parallel rank: ``device`` where it names a card
    or the CPU (``"cuda:0"`` puts every rank on card 0, which only the gloo
    backend accepts), else card ``local_rank``, which must be visible."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device=\"cpu\" to run on the CPU")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank} has no card: {torch.cuda.device_count()} "
                           "visible; start one rank per card or set LOCAL_RANK")
    return torch.device("cuda", local_rank)


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
