from .cross_entropy import (resolve_loss_impl, sharded_lm_loss,
                            vocab_sequence_parallel_cross_entropy)

__all__ = ["resolve_loss_impl", "sharded_lm_loss", "vocab_sequence_parallel_cross_entropy"]
