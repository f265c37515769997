"""LM loss implementation resolution.

Port of ``resolve_loss_impl`` from ``deepspeed_tpu/sequence/cross_entropy.py``
(the vocab-parallel losses come with the comm substrate, ROADMAP.md Queue A
item 8). The resolution order is the JAX package's: an explicit model field
wins, an ``auto`` field defers to the ``training_fastpath.loss_impl`` fleet
knob, and a still-``auto`` result picks the implementation.

The fused loss (the Pallas kernels of ``ops/pallas/fused_loss.py``, ROADMAP
Queue B items 4-6) is not ported yet: ``fused`` raises, and ``auto``
resolves to the dense ``xla`` loss with a one-time warning, as the JAX
package warns and falls back where the fused kernel cannot run.
"""

from typing import Optional

__all__ = ["resolve_loss_impl"]

_FUSED_NOT_PORTED = ("the fused LM loss (ops/pallas/fused_loss.py: _fwd_kernel, "
                     "_dh_kernel, _dk_kernel) is not ported yet: ROADMAP.md Queue "
                     "B items 4-6")
_WARNED = set()


def _warn_once(reason: str) -> None:
    if reason in _WARNED:
        return
    _WARNED.add(reason)
    from ..utils.logging import logger

    logger.warning(f"loss_impl=auto: {reason} — using the dense (xla) "
                   "cross-entropy (one-time notice)")


def resolve_loss_impl(impl: Optional[str] = None,
                      vocab_shard: Optional[int] = None) -> str:
    """``auto|xla|fused`` -> the implementation this call runs: ``xla``, or
    ``NotImplementedError`` for ``fused``."""
    impl = impl or "auto"
    if impl == "auto":
        from ..ops.fastpath import fastpath

        impl = fastpath("loss_impl")
    if impl == "auto":
        _warn_once(_FUSED_NOT_PORTED)
        impl = "xla"
    if impl == "fused":
        raise NotImplementedError(f"loss_impl='fused': {_FUSED_NOT_PORTED}")
    if impl != "xla":
        raise ValueError(f"loss_impl must be auto, xla or fused, got {impl!r}")
    return impl
