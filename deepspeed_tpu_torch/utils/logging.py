"""Rank-aware logging.

Port of ``deepspeed_tpu/utils/logging.py`` (``logger``, ``log_dist``,
``print_rank_0``); the rank comes from ``torch.distributed`` when a process
group is up, else 0.
"""

import logging
import os
import sys
from typing import Iterable, Optional

_LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def create_logger(name: str = "deepspeed_tpu_torch",
                  level: int = logging.INFO) -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        log.addHandler(handler)
    log.setLevel(os.environ.get("DSTPU_LOG_LEVEL", level))
    log.propagate = False
    return log


logger = create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (default: rank 0)."""
    my_rank = _process_index()
    ranks = list(ranks) if ranks is not None else [0]
    if my_rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message: str) -> None:
    if _process_index() == 0:
        print(message, flush=True)
