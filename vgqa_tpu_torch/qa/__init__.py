"""The VideoQA model (InternViT + InternLM2.5) and its serving engine."""

from .engine import ByteTokenizer, GenerationConfig, QAEngine, YUVTiles  # noqa: F401
from .llm import LLM, LLMConfig, TokenEmbedding, init_kv_cache  # noqa: F401
from .vit import ViTConfig, VisionTower  # noqa: F401
