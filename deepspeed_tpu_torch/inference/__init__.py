"""Inference of the port: the v2 ragged engine (``v2/``) and the HF
checkpoint loader (``hf.py``)."""

from .hf import config_from_hf, params_from_hf

__all__ = ["config_from_hf", "params_from_hf"]
