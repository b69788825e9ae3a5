"""The web interface over the port (``python -m vgqa_tpu_torch.app.server``)."""
