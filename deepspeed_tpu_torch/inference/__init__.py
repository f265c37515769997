"""Inference of the port: the v2 ragged engine (``v2/``), the HF checkpoint
loader (``hf.py``) and the Megatron-LM GPT checkpoint loader
(``megatron.py``)."""

from .hf import config_from_hf, params_from_hf
from .megatron import (load_megatron_checkpoint, megatron_config, megatron_params,
                       params_to_megatron)

__all__ = ["config_from_hf", "params_from_hf", "load_megatron_checkpoint",
           "megatron_config", "megatron_params", "params_to_megatron"]
