from .logging import log_dist, logger, print_rank_0

__all__ = ["log_dist", "logger", "print_rank_0"]
