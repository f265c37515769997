"""The LM loss over hidden states and the head kernel, dense or fused.

Port of ``deepspeed_tpu/sequence/cross_entropy.py`` at tensor-parallel size
1: ``resolve_loss_impl``, ``sharded_lm_loss`` (the dense composition or the
fused kernels of ``ops/fused_loss.py``), the shared next-token shift and
``vocab_sequence_parallel_cross_entropy``. A vocab sharded over tp > 1
needs the comm substrate and raises naming ROADMAP.md Queue A item 8.

The resolution order is the JAX package's: an explicit model field wins,
an ``auto`` field defers to the ``training_fastpath.loss_impl`` fleet knob,
and a still-``auto`` result picks ``fused`` where the kernels are built for
the loss's tensors (CUDA, fp32 or bf16: ``ops.fused_loss.kernel_takes``) and
the dense ``xla`` loss elsewhere. The JAX rule also asks for a vocab shard
that is a multiple of 128 (the TPU's lane width); the CUDA kernels mask a
ragged vocab, so on the card neither ``auto`` nor an explicit ``fused``
does. Where the kernels cannot run (a head bias; on the CPU a ragged vocab;
on the card a dtype they are not built for), ``fused`` falls back to the
dense loss, with a one-time warning when it was requested explicitly.
:func:`_select_loss_impl` makes that whole choice once.
"""

from typing import Optional

import torch

__all__ = [
    "vocab_sequence_parallel_cross_entropy",
    "sharded_lm_loss",
    "resolve_loss_impl",
]

_TP_NOT_PORTED = ("a vocab sharded over tp > 1 is not ported yet: ROADMAP.md Queue A "
                  "item 8 (parallelism side paths, after the comm substrate)")


def resolve_loss_impl(impl: Optional[str] = None, vocab_shard: Optional[int] = None,
                      device=None, dtype=None) -> str:
    """``auto|xla|fused`` -> the implementation this call should run.
    ``device`` and ``dtype`` are those of the loss's hidden states: a
    still-``auto`` result is ``fused`` only where the kernels are built for
    them (and the vocab shard is known)."""
    impl = impl or "auto"
    if impl == "auto":
        from ..ops.fastpath import fastpath

        impl = fastpath("loss_impl")
    if impl == "auto":
        from ..ops.fused_loss import kernel_takes

        impl = "fused" if vocab_shard is not None and kernel_takes(device, dtype) else "xla"
    if impl not in ("xla", "fused"):
        raise ValueError(f"loss_impl must be auto, xla or fused, got {impl!r}")
    return impl


def _select_loss_impl(impl: Optional[str], vocab_shard: int, device, dtype,
                      head_bias: bool = False) -> str:
    """:func:`resolve_loss_impl`, then the fallback: ``fused`` becomes
    ``xla`` where the kernels cannot run these tensors, with a one-time
    warning when ``fused`` was asked for (the model field or the knob)."""
    resolved = resolve_loss_impl(impl, vocab_shard, device, dtype)
    if resolved != "fused":
        return resolved
    from ..ops.fused_loss import fused_loss_ready, kernel_takes

    on_cpu = device is None or torch.device(device).type == "cpu"
    reason = None
    if head_bias:
        reason = "the fused kernel takes no head bias"
    elif on_cpu and not fused_loss_ready(vocab_shard):
        reason = f"vocab shard {vocab_shard} is not a 128-multiple"
    elif not on_cpu and not kernel_takes(device, dtype):
        reason = f"the kernels are not built for {dtype} on {device}"
    if reason is None:
        return "fused"
    if impl == "fused" or (impl in (None, "auto") and _knob_is("fused")):
        _warn_fused_fallback(reason)
    return "xla"


_FUSED_FALLBACK_WARNED = set()


def _warn_fused_fallback(reason: str) -> None:
    if reason in _FUSED_FALLBACK_WARNED:
        return
    _FUSED_FALLBACK_WARNED.add(reason)
    from ..utils.logging import logger

    logger.warning(
        f"loss_impl=fused requested but {reason} — falling back to the XLA "
        f"cross-entropy for these call sites (one-time notice)")


def _tp_size(topo) -> int:
    return int(getattr(topo, "tp_size", 1) or 1)


def vocab_sequence_parallel_cross_entropy(logits, targets, *, z_loss: float = 0.0,
                                          topo=None):
    """``[B, S, V]`` logits -> per-token loss ``[B, S]`` (fp32). At tp 1 the
    plain logsumexp minus the target logit."""
    if _tp_size(topo) > 1:
        raise NotImplementedError(_TP_NOT_PORTED)
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = logz - tgt
    return nll + z_loss * torch.square(logz) if z_loss > 0 else nll


def _knob_is(impl: str) -> bool:
    from ..ops.fastpath import fastpath

    return fastpath("loss_impl") == impl


def sharded_lm_loss(hidden, head_kernel, tokens, *, loss_mask=None,
                    z_loss: float = 0.0, head_bias=None, topo=None,
                    logit_dtype=torch.float32, loss_impl: Optional[str] = None):
    """Head matmul + next-token cross entropy. ``hidden [B, S, E]``,
    ``head_kernel [E, V]`` (the tied head: ``embedding.T``), ``tokens
    [B, S]``; returns the masked mean loss.

    ``loss_impl``: ``auto`` (default), ``xla`` (the dense logits in
    ``logit_dtype``, then ``causal_lm_loss``) or ``fused``
    (``ops/fused_loss.py``: the logits never exist), chosen on ``hidden``
    by :func:`_select_loss_impl`."""
    if _tp_size(topo) > 1:
        raise NotImplementedError(_TP_NOT_PORTED)
    impl = _select_loss_impl(loss_impl, head_kernel.shape[-1], hidden.device, hidden.dtype,
                             head_bias is not None)
    if impl == "fused":
        return _fused_lm_loss(hidden, head_kernel, tokens, loss_mask=loss_mask,
                              z_loss=z_loss)
    from ..models.transformer import causal_lm_loss

    logits = hidden.to(logit_dtype) @ head_kernel.to(logit_dtype)
    if head_bias is not None:
        logits = logits + head_bias.to(logit_dtype)
    return causal_lm_loss(logits, tokens, loss_mask=loss_mask, z_loss=z_loss)


def _shifted_targets_and_weights(tokens, loss_mask):
    """Next-token shift keeping S full-length: targets shift with a dummy
    final position whose weight is zero, and the shift folds into the
    weight mask instead of slicing (the JAX package's convention, shared by
    its tp branch and the fused path)."""
    targets_full = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    w = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    w[:, -1] = 0.0
    if loss_mask is not None:
        lm = loss_mask.float()
        w = w * torch.cat([lm[:, 1:], torch.zeros_like(lm[:, -1:])], dim=1)
    return targets_full, w


def _fused_lm_loss(hidden, head_kernel, tokens, *, loss_mask, z_loss):
    """The fused path at tp 1: the kernels see the unshifted ``[B, S, E]``
    hidden states, and the per-token ``(lse, tgt)`` is the loss."""
    from ..ops.fused_loss import fused_vocab_nll

    targets_full, w = _shifted_targets_and_weights(tokens, loss_mask)
    nll = fused_vocab_nll(hidden, head_kernel, targets_full, z_loss=z_loss)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
