from .convert import init_params, param_shapes, params_from_jax
from .transformer import (TransformerConfig, apply_activation, apply_rope,
                          gpt2_config, llama_config, merge_partial_attention,
                          rope_table)

__all__ = ["TransformerConfig", "apply_activation", "apply_rope",
           "gpt2_config", "llama_config", "merge_partial_attention",
           "rope_table", "init_params", "param_shapes", "params_from_jax"]
