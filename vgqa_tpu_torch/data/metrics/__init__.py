"""VidSTG metrics (counterpart of ``vgqa_tpu/data/metrics``)."""

from .evaluator import (  # noqa: F401
    VidSTGEvaluator,
    VidSTGiouEvaluator,
    build_evaluator,
    precision_recall,
)
