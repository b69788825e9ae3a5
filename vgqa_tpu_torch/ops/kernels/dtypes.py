"""The element types the hand-written kernels of the grounding paths take.

K1 / K1' (``swin_block``), K2 (``window_attention``) and K3
(``flash_train``) each have a bfloat16 and a float32 form, as the Pallas
kernels run in the model's dtype: bf16 for mixed-precision training and
bf16 serving, float32 for ``TPU.TRAIN_DTYPE float32`` (the default) and
``TPU.COMPUTE_DTYPE float32``. Their wrappers and the train step check
this one rule; anything else (float16, float64) raises ``TypeError``.
The QA kernels (K4-K6) serve bf16 only, as the JAX engine does.
"""

from __future__ import annotations

import torch

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def check_kernel_dtype(what: str, dtype: torch.dtype) -> None:
    """Raise ``TypeError`` unless ``dtype`` is one the kernels take."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} takes bfloat16 or float32 (TPU.TRAIN_DTYPE / "
                        f"TPU.COMPUTE_DTYPE), not {dtype}")
