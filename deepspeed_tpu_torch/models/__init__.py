from .convert import init_params, param_shapes, params_from_jax
from .transformer import (TransformerConfig, TransformerLM, apply_activation,
                          apply_rope, attention_core, causal_lm_loss,
                          gpt2_config, llama_config, make_loss_fn,
                          merge_partial_attention, mixtral_config, rope_table)

__all__ = ["TransformerConfig", "TransformerLM", "apply_activation",
           "apply_rope", "attention_core", "causal_lm_loss", "gpt2_config",
           "llama_config", "make_loss_fn", "mixtral_config", "merge_partial_attention",
           "rope_table", "init_params", "param_shapes", "params_from_jax"]
