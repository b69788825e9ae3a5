"""Hand-written CUDA kernels (counterpart of ``vgqa_tpu/ops/pallas``).

Each module holds the kernel's wrapper, its plain PyTorch version with the
same signature, and a launch counter (``<wrapper>.launches``). The CUDA
sources live in ``vgqa_tpu_torch/csrc`` and build at first use
(``build.load_library``)."""
