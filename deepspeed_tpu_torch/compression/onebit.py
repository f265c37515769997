"""Error-feedback state of compressed reductions.

Port of the ``ErrorFeedbackState`` of ``deepspeed_tpu/compression/onebit.py``,
which ``comm.compressed.allreduce_feedback_init`` builds. The 1-bit
compressed all-reduce and the 1-bit optimizers of that module are not
ported yet (ROADMAP.md Queue A item 8).
"""

from typing import Any, NamedTuple


class ErrorFeedbackState(NamedTuple):
    """Residuals a compressed reduction carries into its next call:
    ``worker_error`` shaped like this rank's input, ``server_error`` like
    the shard it reduces."""
    worker_error: Any
    server_error: Any
