"""Grounding model family (counterpart of ``vgqa_tpu.models``)."""

from .postprocess import postprocess
from .vstgnet import GroundingConfig, VSTGNet

__all__ = ["GroundingConfig", "VSTGNet", "postprocess"]
