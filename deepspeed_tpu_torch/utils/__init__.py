from .logging import log_dist, logger, print_rank_0
from .tensor_fragment import (safe_get_full_fp32_param, safe_get_full_grad,
                              safe_get_full_optimizer_state,
                              safe_get_local_fp32_param, safe_get_local_grad,
                              safe_get_local_optimizer_state,
                              safe_set_full_fp32_param, safe_set_full_grad,
                              safe_set_full_optimizer_state,
                              safe_set_local_fp32_param, safe_set_local_grad,
                              safe_set_local_optimizer_state)

__all__ = ["log_dist", "logger", "print_rank_0",
           "safe_get_full_fp32_param", "safe_set_full_fp32_param",
           "safe_get_full_grad", "safe_set_full_grad",
           "safe_get_full_optimizer_state", "safe_set_full_optimizer_state",
           "safe_get_local_fp32_param", "safe_set_local_fp32_param",
           "safe_get_local_grad", "safe_set_local_grad",
           "safe_get_local_optimizer_state", "safe_set_local_optimizer_state"]
