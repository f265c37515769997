"""Mixture of experts: top-k gating with capacity, dispatch and combine, the
dropless grouped GEMM (``sharded_moe``) and the MoE block (``layer``).
Port of ``deepspeed_tpu/moe``."""

from .layer import MoEBlock, exp_counts, moe_block
from .sharded_moe import (compute_capacity, dropless_moe, expert_ffn, load_balance_aux,
                          moe_combine, moe_dispatch, quantized_ep_moe, quantized_ep_ready,
                          topk_gating)

__all__ = ["MoEBlock", "exp_counts", "moe_block", "compute_capacity", "dropless_moe",
           "expert_ffn", "load_balance_aux", "moe_combine", "moe_dispatch",
           "quantized_ep_moe", "quantized_ep_ready", "topk_gating"]
