"""Configuration system: the same tree as ``vgqa_tpu.config``."""

from .defaults import build_default_cfg
from .node import CfgNode

__all__ = ["CfgNode", "build_default_cfg"]
