"""Inference v2: continuous ragged batching over a paged KV cache.

Port of ``deepspeed_tpu/inference/v2/`` (reference
``deepspeed/inference/v2/``, FastGen). See ``engine_v2.py``.
"""

from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig

__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig"]
