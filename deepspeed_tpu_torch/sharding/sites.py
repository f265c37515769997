"""Activation/site PartitionSpecs: the layouts of the parallel paths.

Port of ``deepspeed_tpu/sharding/sites.py``, whole. In the port these name
the layouts the explicit collectives produce and consume (the JAX package
constrains them inside ``shard_map``): e.g. ``seq_sharded_act`` is what
``ops/collective_matmul.matmul_reduce_scatter`` leaves between two blocks,
``heads_sharded_act`` what a column-parallel projection gives each tp
rank, ``embed_act`` the replicated embedding output.

Param trees shard through :mod:`deepspeed_tpu.sharding.rules`; the *other*
half of the repo's sharding decisions — activation layouts inside
shard_map'd fast paths, KV caches, ZeRO flat shards, batch specs — used to
live as ``PartitionSpec`` literals scattered through ``models/``,
``sequence/``, ``moe/`` and ``runtime/zero/``.  They live here now, one
named helper per site, so the linter's R5 invariant ("no raw PartitionSpec
outside ``deepspeed_tpu/sharding/``") holds and an auditor can enumerate
every activation layout the system will ever constrain (``SITES``).

Helpers take axis *names* (or the composite dp-axes tuple the topology
exposes) and return specs; none of them reads global state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .rules import PartitionSpec as P


def replicated() -> P:
    """Fully replicated."""
    return P()


# --- Megatron TP / sequence-parallel ring paths (models/transformer.py,
# --- sequence/layer.py): activations cross the fast paths sequence-sharded
# --- over the contracting axis, weights ride their Megatron split ---------

def seq_sharded_act(dp, shard_axis: Optional[str]) -> P:
    """``[B, S, D]`` with the sequence dim sharded (Megatron-SP layout
    between a row-parallel output and the next column gather)."""
    return P(dp, shard_axis, None)


def heads_sharded_act(dp, head_axis: Optional[str]) -> P:
    """``[B, S, H, Dh]`` attention activations, heads column-sharded."""
    return P(dp, None, head_axis, None)


def ulysses_act(dp, sp_axis: str, head_axis: Optional[str]) -> P:
    """``[B, S, H, Dh]`` entering the Ulysses a2a: sequence over sp, heads
    optionally still over tp (the compose-with-TP layout)."""
    return P(dp, sp_axis, head_axis, None)


def col_kernel3(shard_axis: str) -> P:
    """DenseGeneral column kernel ``[D, H, Dh]``: shard heads."""
    return P(None, shard_axis, None)


def col_bias2(shard_axis: str) -> P:
    """DenseGeneral column bias ``[H, Dh]``: shard heads."""
    return P(shard_axis, None)


def row_kernel3(shard_axis: str) -> P:
    """DenseGeneral row kernel ``[H, Dh, D]``: shard heads (input dim)."""
    return P(shard_axis, None, None)


def col_kernel2(shard_axis: str) -> P:
    """Dense column kernel ``[D, F]``: shard the output dim."""
    return P(None, shard_axis)


def row_kernel2(shard_axis: str) -> P:
    """Dense row kernel ``[F, D]``: shard the input dim."""
    return P(shard_axis, None)


def col_bias1(shard_axis: str) -> P:
    """Column bias ``[F]``: shards with the column output."""
    return P(shard_axis)


def vocab_sharded_table(shard_axis: str) -> P:
    """Embedding table ``[V, D]`` vocab-sharded for the ring gather/tied
    head (the *ring* layout; the declarative table shards hidden)."""
    return P(shard_axis, None)


def tokens_act(dp) -> P:
    """``[B, S]`` token ids, batch over dp."""
    return P(dp, None)


def embed_act(dp) -> P:
    """``[B, S, E]`` embedding output, replicated over tp (ring result)."""
    return P(dp, None, None)


# --- KV cache (models/transformer.py v1 dense cache) ----------------------

def kv_cache_entry(dp_axis, tp_axis: Optional[str]) -> P:
    """One cache leaf ``[B, M, Hk, Dh]``: batch over dp, kv heads over tp."""
    return P(dp_axis, None, tp_axis, None)


# --- MoE (moe/layer.py, moe/sharded_moe.py) --------------------------------

MOE_DP_AXES = ("dp_outer",)


def moe_batch_act(ndim: int, *, ep_axis: str = "ep",
                  sp_axis: Optional[str] = None) -> P:
    """Token-major MoE activations/masks ``[G, (S,) ...]``: the token group
    dim shards over dp_outer x ep (ZeRO's fsdp axes reused as data axes),
    sequence optionally over sp."""
    tail = (None,) * (ndim - 2)
    return P(MOE_DP_AXES + (ep_axis,), sp_axis, *tail)


def moe_expert_major_act(ndim: int, *, ep_axis: str = "ep") -> P:
    """Expert-major dispatch ``[E, G, C, D]``: experts over ep, token
    groups over the remaining dp axes."""
    return P(ep_axis, MOE_DP_AXES, *((None,) * (ndim - 2)))


def moe_expert_weight(ep_axis: str = "ep") -> P:
    """Stacked expert weights ``[E, ...]``: shard the expert dim only (the
    shard_map boundary layout; TP splits happen inside the rules layer)."""
    return P(ep_axis)


# --- ZeRO / ZeRO++ flat shards (runtime/zero/zeropp.py) --------------------

def zero_flat_shard(dp_axis) -> P:
    """A flattened-and-padded parameter shard ``[dp, n/dp]`` layout: shard
    the leading dim over the data-parallel axis."""
    return P(dp_axis)


# --- engine batch layout (runtime/engine.py) -------------------------------

def batch_layout(dp_axes, sp_axis: Optional[str] = None) -> P:
    """The engine's batch spec: batch over the dp axes, sequence over sp
    when sequence parallelism is on."""
    return P(dp_axes, sp_axis) if sp_axis else P(dp_axes)


#: name -> helper: the enumerable registry (docs + audits walk this)
SITES: Dict[str, Any] = {
    "replicated": replicated,
    "seq_sharded_act": seq_sharded_act,
    "heads_sharded_act": heads_sharded_act,
    "ulysses_act": ulysses_act,
    "col_kernel3": col_kernel3,
    "col_bias2": col_bias2,
    "row_kernel3": row_kernel3,
    "col_kernel2": col_kernel2,
    "row_kernel2": row_kernel2,
    "col_bias1": col_bias1,
    "vocab_sharded_table": vocab_sharded_table,
    "tokens_act": tokens_act,
    "embed_act": embed_act,
    "kv_cache_entry": kv_cache_entry,
    "moe_batch_act": moe_batch_act,
    "moe_expert_major_act": moe_expert_major_act,
    "moe_expert_weight": moe_expert_weight,
    "zero_flat_shard": zero_flat_shard,
    "batch_layout": batch_layout,
}
