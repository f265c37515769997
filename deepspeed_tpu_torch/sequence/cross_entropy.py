"""The LM loss over hidden states and the head kernel, dense or fused.

Port of ``deepspeed_tpu/sequence/cross_entropy.py``: ``resolve_loss_impl``,
``sharded_lm_loss`` (the dense composition or the fused kernels of
``ops/fused_loss.py``), the shared next-token shift,
``vocab_parallel_cross_entropy`` and ``vocab_sequence_parallel_cross_entropy``.

Over a tensor-parallel axis of size > 1 the port has no global arrays: the
logits or the head kernel a function takes are this rank's contiguous vocab
shard (rank ``i`` holds ids ``[i * V/tp, (i + 1) * V/tp)``), the hidden
states and targets the same on every rank of the axis. The loss comes out
the same on every rank: a max (no gradient) and sums over the axis combine
the shards' partition functions and target logits, as the JAX package's
``pmax`` / ``psum`` do, with the sum's backward the identity. A sequence-
parallel axis (sp) is ROADMAP.md Queue A item 8.

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
    "vocab_parallel_cross_entropy",
    "vocab_sequence_parallel_cross_entropy",
    "sharded_lm_loss",
    "resolve_loss_impl",
]

_SP_NOT_PORTED = ("a sequence sharded over sp > 1 is not ported yet: ROADMAP.md Queue A "
                  "item 8 (sequence parallelism)")


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
    if topo is None:
        from ..parallel.topology import get_topology

        topo = get_topology()
    if int(getattr(topo, "sp_size", 1) or 1) > 1:
        raise NotImplementedError(_SP_NOT_PORTED)
    return int(getattr(topo, "tp_size", 1) or 1)


def vocab_parallel_cross_entropy(local_logits, targets, *, axis_name: str = "tp",
                                 z_loss: float = 0.0):
    """Per-token NLL against this rank's vocab shard ``local_logits [...,
    V/P]`` (shard ``i`` covers ids ``[i*V/P, (i+1)*V/P)``) with GLOBAL
    ``targets [...]``; fp32, the same on every rank of ``axis_name``,
    differentiable with respect to ``local_logits``. ``z_loss`` adds
    ``z_loss * log(Z)^2``."""
    from .. import comm
    from ..parallel.tensor_parallel import reduce_from_tp

    lg = local_logits.float()
    vloc = lg.shape[-1]
    offset = comm.axis_index(axis_name) * vloc
    # the stabilising max carries no gradient: it cancels in logZ - tgt
    lmax = comm.all_reduce(lg.detach().amax(dim=-1).contiguous(), axis_name, op="max")
    sumexp = reduce_from_tp(torch.exp(lg - lmax[..., None]).sum(dim=-1), axis_name)
    logz = torch.log(sumexp) + lmax
    t = targets.long() - offset
    in_shard = (t >= 0) & (t < vloc)
    tgt = torch.gather(lg, -1, t.clamp(0, vloc - 1)[..., None])[..., 0]
    tgt = reduce_from_tp(torch.where(in_shard, tgt, torch.zeros_like(tgt)), axis_name)
    nll = logz - tgt
    if z_loss > 0.0:
        nll = nll + z_loss * torch.square(logz)
    return nll


def vocab_sequence_parallel_cross_entropy(logits, targets, *, z_loss: float = 0.0,
                                          topo=None):
    """Logits -> per-token loss ``[B, S]`` (fp32). At tp 1 ``logits [B, S,
    V]`` and the plain logsumexp minus the target logit; at tp > 1
    ``logits [B, S, V/tp]`` is this rank's vocab shard
    (:func:`vocab_parallel_cross_entropy` over ``tp``)."""
    if _tp_size(topo) > 1:
        return vocab_parallel_cross_entropy(logits, targets, axis_name="tp", z_loss=z_loss)
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
    by :func:`_select_loss_impl`.

    At tp > 1 ``head_kernel [E, V/tp]`` (and ``head_bias [V/tp]``) are this
    rank's vocab shard and ``hidden`` the same on every rank; the loss's
    gradient with respect to ``hidden`` is the whole one on every rank
    (its column-parallel entry sums the shards' parts), that with respect
    to the shard its own."""
    tp = _tp_size(topo)
    impl = _select_loss_impl(loss_impl, head_kernel.shape[-1], hidden.device, hidden.dtype,
                             head_bias is not None)
    if tp > 1:
        from ..parallel.tensor_parallel import copy_to_tp

        hidden = copy_to_tp(hidden)
        if impl == "fused":
            return _fused_lm_loss(hidden, head_kernel, tokens, loss_mask=loss_mask,
                                  z_loss=z_loss, axis_name="tp")
        targets_full, w = _shifted_targets_and_weights(tokens, loss_mask)
        nll = _vocab_sharded_head_nll(hidden, head_kernel, targets_full,
                                      head_bias=head_bias, z_loss=z_loss,
                                      logit_dtype=logit_dtype)
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    if impl == "fused":
        return _fused_lm_loss(hidden, head_kernel, tokens, loss_mask=loss_mask,
                              z_loss=z_loss)
    from ..models.transformer import causal_lm_loss

    logits = hidden.to(logit_dtype) @ head_kernel.to(logit_dtype)
    if head_bias is not None:
        logits = logits + head_bias.to(logit_dtype)
    return causal_lm_loss(logits, tokens, loss_mask=loss_mask, z_loss=z_loss)


def _vocab_sharded_head_nll(hidden, head_kernel, targets, *, head_bias, z_loss,
                            logit_dtype):
    """This rank's head shard's logits and the vocab-parallel cross entropy."""
    lg = hidden.to(logit_dtype) @ head_kernel.to(logit_dtype)
    if head_bias is not None:
        lg = lg + head_bias.to(logit_dtype)
    return vocab_parallel_cross_entropy(lg, targets, axis_name="tp", z_loss=z_loss)


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


def _fused_lm_loss(hidden, head_kernel, tokens, *, loss_mask, z_loss, axis_name=None):
    """The fused path: the kernels see the unshifted ``[B, S, E]`` hidden
    states. At tp 1 the per-token ``(lse, tgt)`` is the loss; over
    ``axis_name`` the head is this rank's vocab shard and the shards'
    ``(lse, tgt)`` combine (``fused_vocab_nll(axis_name=)``)."""
    from ..ops.fused_loss import fused_vocab_nll

    targets_full, w = _shifted_targets_and_weights(tokens, loss_mask)
    nll = fused_vocab_nll(hidden, head_kernel, targets_full, axis_name=axis_name,
                          z_loss=z_loss)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
