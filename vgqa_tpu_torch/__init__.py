"""vgqa_tpu_torch — ``vgqa_tpu`` in PyTorch and CUDA: grounding serving and
training, and video QA serving.

A second package beside ``vgqa_tpu`` (the JAX reference, which stays as it
is). It mirrors that package's layout module for module: ``config``,
``utils``, ``ops`` (``ops/kernels`` is the counterpart of ``ops/pallas``),
``models``, ``training``, ``qa`` and ``inference``; ``csrc`` holds the CUDA sources
of the hand-written kernels. Public tensors keep the JAX layouts (frames
``[V, T, H, W, 3]``, masks True = valid, attention heads packed in the
channel dimension), and module names equal the flax names, so a JAX
parameter tree converts to a ``state_dict`` by one generic walk
(``models/convert_jax.py``).

The package imports ``torch`` and never JAX. PyYAML and OpenCV are imported
only inside the functions that need them (YAML config files, video files).
"""

__version__ = "0.1.0"
