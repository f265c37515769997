"""Plan IR: collective sites and per-site implementation decisions.

Port of ``deepspeed_tpu/comm/planner/ir.py``, whole: the vocabulary, the
site signatures and the plan JSON are the JAX package's byte for byte, so
a plan written by one package reads in the other. GC3 (arxiv 2201.11840)
compiles collectives from a small IR; The Big Send-off (arxiv 2504.18658)
shows the *choice* of algorithm per topology and message size is itself
the optimization. A :class:`CollectiveSite` names one call site (op kind,
shape/dtype, mesh axes, consumer tag), a :class:`PlanDecision` one
implementation drawn from the menu, and a :class:`Plan` maps sites to
decisions for one mesh fingerprint. The implementation names are the JAX
package's (``xla`` is the library collective, ``pallas`` the hand-written
paged decode kernel). Dtypes may be given as torch dtypes, numpy dtypes or
names; a site stores the name (``"bfloat16"``, ``"int8"``).
"""

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# The implementation menu (the JAX package's names; in the port ``ici``
# links are the card's NVLink and ``xla`` is the library collective of
# torch.distributed):
#   xla          — the fused native collective (psum / all_gather /
#                  psum_scatter / all_to_all); today's default everywhere
#   ring         — p-1 ppermute chunk hops (ops/collective_matmul.py
#                  ring_all_gather / ring_reduce_scatter), exact
#   bidir_ring   — both ICI directions busy, half the ring steps, exact
#   hierarchical — two-level all-reduce: inner (ICI) axis exact, outer
#                  (DCN) hops int8 (comm/compressed.py)
#   int8         — block-quantized payload, nearest rounding
#   int8_sr      — block-quantized + stochastic rounding (gradient paths)
#   fused_matmul — collective matmul: the gather/reduction ring hidden
#                  behind the partial matmuls (all_gather_matmul /
#                  matmul_reduce_scatter)
#   program      — not a fixed impl at all: the decision carries an ordered
#                  multi-phase PROGRAM of PhaseStep entries (GC3-style
#                  synthesis) executed by comm.compressed.
#                  run_collective_program — e.g. exact reduce-scatter over
#                  the ICI axes, int8+error-feedback all-reduce over the
#                  DCN axis, all-gather back over ICI
#   einsum       — serving decode_attn only: the gathered-page dense
#                  reference path (inference/v2/model.paged_attention)
#   pallas       — serving decode_attn only: the resident-pool paged
#                  flash-decode kernel (ops/paged_attention.
#                  paged_flash_decode: the hand-written Hopper kernel on
#                  the card, int8 dequant fused in-kernel)
IMPLEMENTATIONS = ("xla", "ring", "bidir_ring", "hierarchical", "int8",
                   "int8_sr", "fused_matmul", "program", "einsum", "pallas")

# the phase vocabulary a program decision is built from; each phase lowers
# to one collective primitive over its own axes with its own wire dtype
# (all_to_all phases exist for the compiler's single-phase a2a-site
# programs — chunked/quantized variants of the flat exchange)
PHASE_OPS = ("reduce_scatter", "all_reduce", "all_gather", "all_to_all")
# exact     — native-dtype payload, bit-faithful transport
# int8      — block-quantized payload + one-lane scales, nearest rounding
# int8_sr   — block-quantized + stochastic rounding (unbiased per element)
# int8_ef   — block-quantized + ErrorFeedbackState residual carry (the DCN
#             gradient hop: quantization error re-injected next step)
WIRE_DTYPES = ("exact", "int8", "int8_sr", "int8_ef")
# how a phase lowers: the fused XLA collective, a ppermute chunk ring, a
# ppermute chunk ring BOUND to the matmul that produces/consumes the payload
# (T3-style: the hops ride between the compute site's tile steps and hide
# behind them — such phases must carry a FusedCompute descriptor), or a
# recursive-doubling/halving butterfly ("tree": log2(p) ppermute rounds
# instead of p-1 ring hops — the alpha-dominated regime's shape; the span
# must be a power of two, enforced at synthesis where the span is known)
PHASE_VIAS = ("xla", "ring", "bidir_ring", "fused_matmul", "tree")
# phase ops a fused_matmul via can realize: the all-gather side (consumer
# matmul eats the arriving chunks) and the reduce-scatter side (producer
# matmul feeds the departing chunks); a one-shot all_reduce has no tile
# stream to interleave with
FUSED_PHASE_OPS = ("all_gather", "reduce_scatter")
# which side of the matmul the fused phase binds to
FUSED_ROLES = ("producer", "consumer")
# link classes a phase's traffic is accounted under in the comms ledger
LINK_CLASSES = ("ici", "dcn", "host")

# op kind -> implementations that can realize it.
# all_gather/reduce_scatter "fused_matmul": the compute-bound quantized
# chunk ring (ops/collective_matmul.py fused_ring_all_gather /
# fused_ring_reduce_scatter) — int8 payload per hop AND the hops hidden
# behind the consuming/producing matmul tiles (the ZeRO-3 qwZ gather
# fusing into its projection, the qgZ scatter into the backward matmuls)
OP_MENU: Dict[str, Tuple[str, ...]] = {
    "all_reduce": ("xla", "int8", "int8_sr", "hierarchical"),
    "all_gather": ("xla", "ring", "bidir_ring", "int8", "fused_matmul"),
    "reduce_scatter": ("xla", "ring", "int8", "int8_sr", "fused_matmul"),
    "all_to_all": ("xla", "int8"),
    "gather_matmul": ("xla", "fused_matmul"),
    # the vocab-sharded embedding table gather (shape = the per-rank table
    # shard): xla is all_gather(table) + take, ring/bidir_ring hide the
    # chunk hops behind the resident chunk's row lookups
    # (ops/collective_matmul.py ring_embedding_gather / ring_tied_lm_head)
    "embed_gather": ("xla", "ring", "bidir_ring"),
    # serving fused-decode attention (inference/v2): not a collective at
    # all but a kernel choice with a decode-shape cost regime — the site
    # shape is the gathered pool view one decode step touches
    # ([S, B*bs, Hk, D] in the storage dtype), axes are empty. einsum
    # materializes a compute-dtype copy of it per step; pallas streams the
    # live pages of the resident pool in place (topo._estimate_decode_attn)
    "decode_attn": ("einsum", "pallas"),
}

# the wired consumers (PR 3's five + the PR 6 embedding site + the
# serving decode tier: decode_attn and the decode-TP projections'
# gather_matmul both resolve under "decode"; "autotp" is the sharding
# subsystem's load-time registration of the gather-class collectives a
# rule-sharded foreign param tree implies — sharding/autotp.py)
CONSUMERS = ("tp-linear", "ulysses", "moe-a2a", "dp-grad", "zeropp", "embed",
             "decode", "autotp")

# consumers whose payload is a gradient: stochastic rounding is admissible
# (unbiased compression matters there); activation exchanges keep nearest
GRADIENT_CONSUMERS = ("dp-grad", "zeropp")


#: byte widths of the dtype names numpy cannot parse without ml_dtypes
_ITEMSIZE = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1,
             "float8_e4m3fnuz": 1, "float8_e5m2fnuz": 1}


def dtype_name(dtype: Any) -> str:
    """The canonical name of a dtype-like: a torch dtype, a numpy dtype or
    type, or a name (``torch.bfloat16`` -> ``"bfloat16"``)."""
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    if isinstance(dtype, str) and dtype in _ITEMSIZE:
        return dtype
    return np.dtype(dtype).name


def itemsize(name: str) -> int:
    """Bytes an element of the dtype named ``name``."""
    if name in _ITEMSIZE:
        return _ITEMSIZE[name]
    return int(np.dtype(name).itemsize)


@dataclass(frozen=True)
class CollectiveSite:
    """One collective call site: what moves, over which axes, for whom.

    ``shape`` is the per-rank tensor the call site passes (the ledger's
    "logical" convention), ``axes`` the mesh axis names the collective runs
    over, ``consumer`` one of :data:`CONSUMERS`. ``axis_size`` overrides the
    mesh fingerprint's axis-size lookup — for sites living on a mesh other
    than the fleet topology (the zeropp factory takes its own ``mesh`` and
    ``dp_axis``); when set it is part of the site identity.
    """
    op: str
    shape: Tuple[int, ...]
    dtype: str
    axes: Tuple[str, ...]
    consumer: str
    axis_size: Optional[int] = None

    def __post_init__(self):
        if self.op not in OP_MENU:
            raise ValueError(f"unknown collective op {self.op!r}; "
                             f"known: {sorted(OP_MENU)}")
        if self.consumer not in CONSUMERS:
            raise ValueError(f"unknown consumer tag {self.consumer!r}; "
                             f"known: {CONSUMERS}")

    @property
    def nbytes(self) -> int:
        n = int(np.prod(self.shape)) if self.shape else 1
        return n * itemsize(self.dtype)

    def signature(self) -> str:
        """Canonical site key — the cache/ledger identity of this site."""
        dims = "x".join(str(d) for d in self.shape) or "scalar"
        axes = ",".join(self.axes)
        if self.axis_size is not None:
            axes += f"*{self.axis_size}"
        return f"{self.consumer}:{self.op}:{dims}:{self.dtype}@{axes}"


def make_site(*, op: str, shape: Sequence[int], dtype: Any,
              axes: Sequence[str], consumer: str,
              axis_size: Optional[int] = None) -> CollectiveSite:
    """Normalizing constructor: any shape sequence / dtype-like goes in,
    a canonical (hashable, JSON-stable) :class:`CollectiveSite` comes out."""
    return CollectiveSite(op=str(op),
                          shape=tuple(int(d) for d in shape),
                          dtype=dtype_name(dtype),
                          axes=tuple(str(a) for a in axes),
                          consumer=str(consumer),
                          axis_size=None if axis_size is None
                          else int(axis_size))


@dataclass(frozen=True)
class FusedCompute:
    """The compute-site binding of a ``via="fused_matmul"`` phase.

    ``role`` says which side of the matmul the hops interleave with:
    ``"consumer"`` — the matmul consumes the gathered operand (the
    all-gather side: each arriving chunk's partial product runs while the
    next chunk's permute is in flight); ``"producer"`` — the matmul
    produces the payload the reduction consumes (the reduce-scatter side:
    each departing partial sum's hop overlaps the next tile's matmul).
    ``site`` is a free-form tag naming the bound matmul site (shows up in
    flight-ring ``detail`` and the doctor's divergence report); ``tile``
    the per-hop chunk element count (0 = unbound: the executor's per-rank
    shard — the engine re-binds it to the real chunk size at compile).
    """
    role: str
    site: str = ""
    tile: int = 0

    def __post_init__(self):
        if self.role not in FUSED_ROLES:
            raise ValueError(f"unknown fused-compute role {self.role!r}; "
                             f"menu: {FUSED_ROLES}")

    def tag(self) -> str:
        """The flight-ring/doctor label: ``site@role`` (or just the role)."""
        return f"{self.site}@{self.role}" if self.site else self.role

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"role": self.role}
        if self.site:
            d["site"] = self.site
        if self.tile:
            d["tile"] = int(self.tile)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FusedCompute":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            # strict: a compute descriptor from a newer build must fail the
            # load (cache miss), never silently shed fields
            raise ValueError(f"unknown FusedCompute fields {sorted(unknown)}")
        return cls(**d)


@dataclass(frozen=True)
class PhaseStep:
    """One phase of a multi-phase collective program.

    ``phase_op`` is the collective primitive, ``axes`` the mesh axes THIS
    phase runs over (each phase gets its own axes — the whole point:
    different hops ride different links), ``wire_dtype`` what rides those
    links, ``via`` whether the phase lowers to the fused XLA collective, a
    ppermute chunk ring, or a compute-bound fused ring
    (``"fused_matmul"`` — requires ``compute``), and ``link`` the ledger
    hop class the phase's wire bytes are accounted under
    (``ici``/``dcn``/``host``; synthesis stamps it from the mesh
    fingerprint so the ledger can report DCN-class bytes without
    re-deriving topology at trace time).

    ``chunks`` > 1 column-splits the payload into K pipelined pieces so
    the next phase can start on chunk 1 while this phase streams chunk 2
    (priced alpha x K vs overlapped beta in ``topo.estimate_program``).
    The column layout keeps reduce_scatter/all_gather rank-placement
    identical to the flat collective, so a chunked exact phase stays
    bitwise-equal to its unchunked twin. Only the ``xla`` via chunks (the
    ring/tree/fused lowerings already stream per-hop pieces), and
    ``int8_ef`` never chunks (the residual is one full-tensor carry).
    """
    phase_op: str
    axes: Tuple[str, ...]
    wire_dtype: str = "exact"
    block: Optional[int] = None
    via: str = "xla"
    link: Optional[str] = None
    compute: Optional[FusedCompute] = None
    chunks: int = 1

    def __post_init__(self):
        if self.phase_op not in PHASE_OPS:
            raise ValueError(f"unknown phase op {self.phase_op!r}; "
                             f"menu: {PHASE_OPS}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire dtype {self.wire_dtype!r}; "
                             f"menu: {WIRE_DTYPES}")
        if self.via not in PHASE_VIAS:
            raise ValueError(f"unknown phase via {self.via!r}; "
                             f"menu: {PHASE_VIAS}")
        if self.link is not None and self.link not in LINK_CLASSES:
            raise ValueError(f"unknown link class {self.link!r}; "
                             f"menu: {LINK_CLASSES}")
        if not self.axes:
            raise ValueError("a PhaseStep needs at least one mesh axis")
        if int(self.chunks) < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.chunks > 1 and self.via != "xla":
            raise ValueError(
                f"chunked pipelining only lowers via 'xla' (the "
                f"{self.via!r} via already streams per-hop pieces)")
        if self.wire_dtype == "int8_ef" and self.chunks > 1:
            raise ValueError("int8_ef never chunks (the error-feedback "
                             "residual is one full-tensor carry)")
        if self.phase_op == "all_to_all" and self.via != "xla":
            raise ValueError("all_to_all phases lower via 'xla' only")
        if self.via in ("ring", "bidir_ring", "tree"):
            if self.wire_dtype == "int8_ef":
                raise ValueError(
                    "int8_ef rides xla all_reduce phases (the two-stage "
                    "server layout); hop-structured vias take "
                    "exact|int8|int8_sr")
        if self.via == "fused_matmul":
            if self.phase_op not in FUSED_PHASE_OPS:
                raise ValueError(
                    f"via='fused_matmul' only fuses {FUSED_PHASE_OPS} "
                    f"(a one-shot {self.phase_op} has no tile stream to "
                    f"interleave with)")
            if self.compute is None:
                raise ValueError("via='fused_matmul' needs a FusedCompute "
                                 "binding (which matmul hides the hops)")
            if self.wire_dtype == "int8_ef":
                raise ValueError(
                    "int8_ef rides the all_reduce phase (the residual is a "
                    "full-tensor carry); fused hops take exact|int8|int8_sr")
        elif self.compute is not None:
            raise ValueError(f"via={self.via!r} must not carry a "
                             "FusedCompute binding")

    @property
    def quantized(self) -> bool:
        return self.wire_dtype != "exact"

    @property
    def fused(self) -> bool:
        return self.via == "fused_matmul"

    def to_dict(self) -> Dict[str, Any]:
        d = {"phase_op": self.phase_op, "axes": list(self.axes)}
        if self.wire_dtype != "exact":
            d["wire_dtype"] = self.wire_dtype
        if self.block is not None:
            d["block"] = self.block
        if self.via != "xla":
            d["via"] = self.via
        if self.link is not None:
            d["link"] = self.link
        if self.compute is not None:
            d["compute"] = self.compute.to_dict()
        if self.chunks != 1:
            d["chunks"] = int(self.chunks)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PhaseStep":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            # strict: a phase from a newer plan format must fail the load
            # (the cache treats ValueError as a miss and re-tunes) — the
            # old behavior of silently dropping unknown fields could strip
            # the part of a phase that changes its semantics
            raise ValueError(f"unknown PhaseStep fields {sorted(unknown)}")
        kw = dict(d)
        kw["axes"] = tuple(str(a) for a in kw.get("axes", ()))
        comp = kw.get("compute")
        if comp is not None and not isinstance(comp, FusedCompute):
            kw["compute"] = FusedCompute.from_dict(comp)
        return cls(**kw)


def make_phase(phase_op: str, axes: Sequence[str], *,
               wire_dtype: str = "exact", block: Optional[int] = None,
               via: str = "xla", link: Optional[str] = None,
               compute: Optional[FusedCompute] = None,
               chunks: int = 1) -> PhaseStep:
    """Normalizing :class:`PhaseStep` constructor (the ``make_site`` twin)."""
    return PhaseStep(phase_op=str(phase_op),
                     axes=tuple(str(a) for a in axes),
                     wire_dtype=str(wire_dtype),
                     block=None if block is None else int(block),
                     via=str(via), link=link, compute=compute,
                     chunks=int(chunks))


def program_summary(program: Sequence[PhaseStep]) -> str:
    """Compact one-line program rendering for logs and the plan table:
    ``rs(ep)>ar.int8_ef(dp_outer)>ag(ep)`` (chunked phases carry ``xK``:
    ``ar.int8(dp_outer)x4``)."""
    short = {"reduce_scatter": "rs", "all_reduce": "ar", "all_gather": "ag",
             "all_to_all": "a2a"}
    parts = []
    for s in program:
        tag = short[s.phase_op]
        if s.wire_dtype != "exact":
            tag += f".{s.wire_dtype}"
        if s.via != "xla":
            tag += f"~{s.via}"
        tag += f"({','.join(s.axes)})"
        if s.chunks != 1:
            tag += f"x{s.chunks}"
        parts.append(tag)
    return ">".join(parts)


@dataclass(frozen=True)
class PlanDecision:
    """One site's resolved implementation.

    ``source`` records WHO decided: ``knob`` (an explicitly-set raw config
    knob — always wins), ``cache`` (loaded from the on-disk plan),
    ``cost-model`` (static alpha-beta ranking), ``measured`` (microbenchmark
    winner), or ``default`` (planner off — today's behavior).
    ``est_us`` is the model's (or measurement's) cost estimate.

    ``impl == "program"`` decisions carry the synthesized multi-phase
    ``program`` (a tuple of :class:`PhaseStep`) instead of naming a fixed
    implementation; every other impl keeps ``program is None``, so
    single-impl decisions serialize byte-identically to the pre-program
    plan-cache format.
    """
    impl: str
    block: Optional[int] = None
    source: str = "default"
    est_us: Optional[float] = None
    program: Optional[Tuple[PhaseStep, ...]] = None

    def __post_init__(self):
        if self.impl not in IMPLEMENTATIONS:
            raise ValueError(f"unknown implementation {self.impl!r}; "
                             f"menu: {IMPLEMENTATIONS}")
        if self.impl == "program":
            if not self.program:
                raise ValueError("impl='program' needs a non-empty program")
            object.__setattr__(self, "program", tuple(self.program))
        elif self.program is not None:
            raise ValueError(f"impl={self.impl!r} must not carry a program")

    @property
    def quantized(self) -> bool:
        if self.impl == "program":
            return any(s.quantized for s in self.program)
        return self.impl in ("int8", "int8_sr", "hierarchical")

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None and k != "program"}
        if self.program is not None:
            d["program"] = [s.to_dict() for s in self.program]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlanDecision":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            # strict (the PhaseStep.from_dict contract): version skew must
            # surface as a failed load, never a silently-narrowed decision
            raise ValueError(f"unknown PlanDecision fields {sorted(unknown)}")
        kw = dict(d)
        prog = kw.get("program")
        if prog is not None:
            kw["program"] = tuple(
                s if isinstance(s, PhaseStep) else PhaseStep.from_dict(s)
                for s in prog)
        return cls(**kw)


# On-disk plan format. 1 = the PR 8 shape (no version stamp, phase vias
# xla|ring|bidir_ring); 2 adds the fused_matmul via + FusedCompute compute
# bindings and stamps ``format`` into the serialized plan; 3 adds the
# compiler vocabulary — ``chunks`` pipelining, the ``tree`` via, and
# ``all_to_all`` phases. Loading:
#   - no stamp (a stale PR 8 ``plan_<digest>.json``): version-skew-migrated —
#     every decision re-parses under the STRICT from_dict vocabulary, so a
#     file whose content doesn't actually match the v1 vocabulary fails the
#     load (cache miss -> re-tune) instead of resolving into an executor
#     that doesn't understand it;
#   - stamp > PLAN_FORMAT (a plan written by a newer build): rejected
#     outright — its decisions may carry semantics this executor can't run.
PLAN_FORMAT = 3


class Plan:
    """Site signature -> :class:`PlanDecision` for one mesh fingerprint."""

    def __init__(self, fingerprint: str = "",
                 decisions: Optional[Dict[str, PlanDecision]] = None):
        self.fingerprint = fingerprint
        self.decisions: Dict[str, PlanDecision] = dict(decisions or {})

    def get(self, site: CollectiveSite) -> Optional[PlanDecision]:
        return self.decisions.get(site.signature())

    def set(self, site: CollectiveSite, decision: PlanDecision) -> None:
        self.decisions[site.signature()] = decision

    def __len__(self) -> int:
        return len(self.decisions)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Plan)
                and self.fingerprint == other.fingerprint
                and self.decisions == other.decisions)

    def to_dict(self) -> Dict[str, Any]:
        return {"format": PLAN_FORMAT,
                "fingerprint": self.fingerprint,
                "sites": {sig: d.to_dict()
                          for sig, d in sorted(self.decisions.items())}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Plan":
        fmt = int(d.get("format", 1))  # unstamped = the PR 8 v1 shape
        if fmt > PLAN_FORMAT:
            raise ValueError(
                f"plan format {fmt} is newer than this build's "
                f"{PLAN_FORMAT}; refusing to load (its decisions may name "
                f"implementations this executor doesn't understand)")
        return cls(fingerprint=d.get("fingerprint", ""),
                   decisions={sig: PlanDecision.from_dict(dd)
                              for sig, dd in d.get("sites", {}).items()})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        return cls.from_dict(json.loads(s))
