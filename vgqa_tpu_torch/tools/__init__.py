"""Command-line tools of the port (counterparts of ``tools/``), run as
``python -m vgqa_tpu_torch.tools.<name>``."""
