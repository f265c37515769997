"""Topology model: mesh fingerprint + alpha-beta cost model.

Port of ``deepspeed_tpu/comm/planner/topo.py``, whole. The formulas are
the JAX package's; what faces the device differs: the fingerprint reads
the card (``torch.cuda``) and the world (``torch.distributed``) in place of
``jax.devices()``, the accelerator platform is ``"gpu"`` where JAX tests
for ``"tpu"``, and the accelerator figures of the constant tables are the
H100's (each with its source below). The ``cpu`` and ``host`` entries are
JAX's, so a CPU fingerprint prices as in the JAX package.

The fingerprint identifies WHAT we are planning for — axis sizes, device
kind, host span, which mesh axes cross hosts (DCN) vs stay on-chip
interconnect (ICI) — and keys the on-disk plan cache. The cost model is a
classical alpha-beta (latency + inverse-bandwidth) estimate per (site,
implementation) pair, the Big-Send-off observation made executable: it is
deliberately coarse — its job is to PRUNE obviously-dominated candidates
(and rank the survivors in ``static`` mode), not to replace measurement.
``measure`` mode times the survivors for real (``planner/microbench.py``).
"""

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ir import (GRADIENT_CONSUMERS, OP_MENU, CollectiveSite, PhaseStep,
                 PlanDecision, itemsize)

# default quantization block (elements per scale) — matches ops/pallas/quant
_DEFAULT_BLOCK = 2048


@dataclass(frozen=True)
class LinkParams:
    alpha: float  # per-hop latency, seconds
    beta: float   # seconds per byte (inverse bandwidth)


# The card's platform name (JAX's name for a GPU backend).
ACCELERATOR = "gpu"

# Link classes by locality; the model only needs the RATIOS to rank
# candidates sanely. The class names are the JAX package's: ``ici`` is the
# within-host interconnect, ``dcn`` the network between hosts.
#   ici:  H100 SXM NVLink, 900 GB/s per card in both directions together
#         (NVIDIA H100 Tensor Core GPU data sheet), 450 GB/s a direction;
#   dcn:  one 400 Gb/s NDR InfiniBand port a card, 50 GB/s (ConnectX-7,
#         NVIDIA DGX H100 data sheet);
#   host: the JAX package's virtual CPU mesh (memcpy), unchanged.
# The per-hop latencies are orders of magnitude (no data sheet gives one;
# not measured here).
LINK_TABLE: Dict[str, LinkParams] = {
    "ici": LinkParams(alpha=1e-6, beta=1.0 / 4.5e11),
    "dcn": LinkParams(alpha=25e-6, beta=1.0 / 5e10),
    "host": LinkParams(alpha=5e-6, beta=1.0 / 2e10),
}

# int8 quantize+dequantize compute, seconds per (logical) byte processed —
# the term that makes exact transport win for small messages. Per platform:
# on the card, the block-quant kernel's measured 1.8305 ms over
# TinyLlama-1.1B's flat fp32 gradient of 1,100,048,384 elements
# (chip_smoke.py phase 10 on an H100 80GB HBM3 at 700 W, PERF.md row 10);
# the CPU entry is the JAX package's vectorized-numpy rate
QUANT_COST_PER_BYTE = {ACCELERATOR: 1.8305e-3 / (4 * 1_100_048_384),
                       "cpu": 1.0 / 1e10}
_QUANT_DEFAULT = 1.0 / 5e10
# fixed per-quantization-stage overhead (kernel launch, scale lanes): the
# term that keeps tiny alpha-dominated messages on the exact path
QUANT_FIXED = 5e-6
# fraction of the wire time a ring-chunked transfer hides behind compute
# (T3-style overlap); the credit the fused/chunked impls get over xla.
# This module constant is the DEFAULT — CostModel carries it as a field so
# the ``comm_planner.overlap_credit`` knob (or a measured fused-vs-sequenced
# probe pair, ``planner.calibrate_overlap_credit``) can track the real mesh
OVERLAP_CREDIT = 0.55
# extra per-chunk scheduling overhead of an explicit ppermute ring vs the
# fused XLA collective
RING_HOP_PENALTY = 1.5
# per-round scheduling overhead of a recursive-doubling/halving butterfly
# round vs one fused-collective alpha: each of the log2(p) rounds is a
# full-vector ppermute exchange that XLA schedules as an exposed step, so a
# round costs noticeably more than a pipelined ring hop. Calibrated so the
# tree wins the alpha-dominated DCN regime (log2(p) rounds beat 2(p-1) ring
# hops once p >= 4) without stealing the bandwidth-bound regime from the
# quantized xla path
TREE_ROUND_PENALTY = 2.8

# --- decode-shape regime (serving decode_attn) -----------------------------
# HBM streaming rates, bytes/s: decode attention moves no link traffic —
# the candidates differ only in pool bytes touched per step. The card's
# is the H100 SXM's 3.35 TB/s HBM3 (NVIDIA data sheet); the CPU entry is
# the JAX package's
HBM_BW = {ACCELERATOR: 3.35e12, "cpu": 2e10}
# fraction of the (power-of-two-sliced) block table's pages that are live
# mid-generation — what the pallas kernel's clamped index map actually DMAs
DECODE_LIVE_FRACTION = 0.75


@dataclass(frozen=True)
class MeshFingerprint:
    """What the planner keys plans on: if two jobs land on meshes with the
    same fingerprint, the same plan applies."""
    platform: str
    device_kind: str
    n_devices: int
    n_processes: int
    axis_sizes: Tuple[Tuple[str, int], ...]
    dcn_axes: Tuple[str, ...]

    @classmethod
    def capture(cls, topology=None) -> "MeshFingerprint":
        """Fingerprint the live world: the card (``torch.cuda``; platform
        ``"gpu"``, or ``"cpu"`` without a card), the ``torch.distributed``
        world (one device and one process a rank) and the axes of the
        port's ``parallel.topology``.

        An axis is DCN when stepping along it changes the host. The port
        runs one process a card, so the host is read from the rank: ranks
        are numbered host-major, ``LOCAL_WORLD_SIZE`` of them a host
        (torchrun's variable; without it every rank is on this host). The
        topology's only axis above size 1 is the data-parallel one, laid
        over the ranks in order, so it is DCN when it holds more ranks
        than a host does."""
        import os

        import torch

        from ... import comm
        from ...parallel.topology import ALL_AXES, get_topology

        topo = topology or get_topology()
        world = comm.get_world_size()
        if torch.cuda.is_available():
            platform, kind = ACCELERATOR, torch.cuda.get_device_name(0)
        else:
            platform = kind = "cpu"
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world)) or world
        sizes = tuple((n, int(topo.axis_size(n))) for n in ALL_AXES)
        dcn = []
        stride = 1
        for name, size in reversed(sizes):
            # ranks step by ``stride`` along this axis (the last axis is the
            # fastest); a step crosses a host boundary when some rank and
            # its neighbour along the axis sit on different hosts
            if size > 1 and any(r // per_host != (r + stride) // per_host
                                for r in range(world - stride)):
                dcn.append(name)
            stride *= size
        return cls(platform=platform, device_kind=str(kind),
                   n_devices=world, n_processes=world,
                   axis_sizes=sizes,
                   dcn_axes=tuple(n for n, _ in sizes if n in dcn))

    def axis_size(self, axes: Tuple[str, ...]) -> int:
        table = dict(self.axis_sizes)
        p = 1
        for a in axes:
            p *= int(table.get(a, 1))
        return p

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        """Short stable hash — the plan-cache file key."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


class CostModel:
    """Alpha-beta estimates per (site, implementation).

    ``assume_fleet`` plans AS the target fleet rather than as this host:
    quantization is costed at the accelerator's streaming rate even when
    the live platform is the virtual CPU mesh. Set when the operator
    force-marked DCN axes (``comm_planner.dcn_axes`` — rehearsing a
    multi-slice plan on a dev box); without it the CPU's vectorized-numpy
    quant rate would veto every compressed candidate the real fleet wants.
    """

    def __init__(self, fingerprint: MeshFingerprint,
                 block: int = _DEFAULT_BLOCK, assume_fleet: bool = False,
                 link_penalties: Optional[Dict[str, float]] = None,
                 overlap_credit: Optional[float] = None):
        self.fp = fingerprint
        self.block = block
        platform = ACCELERATOR if assume_fleet else fingerprint.platform
        self.platform = platform
        self.quant_cost = QUANT_COST_PER_BYTE.get(platform, _QUANT_DEFAULT)
        self.quant_fixed = QUANT_FIXED
        # the fused/chunked overlap credit: config- or measurement-settable
        # (clamped away from 1.0 — no transfer hides completely)
        if overlap_credit is None:
            overlap_credit = OVERLAP_CREDIT
        self.overlap_credit = min(0.95, max(0.0, float(overlap_credit)))
        # per-axis cost multipliers (alpha AND beta): the control plane's
        # straggler re-plan marks the slow host's link here so every
        # candidate that touches it is priced at its OBSERVED slowness,
        # not the link class's nominal figure
        self.link_penalties: Dict[str, float] = dict(link_penalties or {})

    def _penalized(self, lp: LinkParams,
                   axes: Tuple[str, ...]) -> LinkParams:
        f = 1.0
        for a in axes:
            f = max(f, float(self.link_penalties.get(a, 1.0)))
        if f == 1.0:
            return lp
        return LinkParams(alpha=lp.alpha * f, beta=lp.beta * f)

    def link(self, axes: Tuple[str, ...]) -> LinkParams:
        if any(a in self.fp.dcn_axes for a in axes):
            return self._penalized(LINK_TABLE["dcn"], axes)
        if self.fp.platform == ACCELERATOR or self.fp.dcn_axes:
            # a mesh that DISTINGUISHES DCN axes makes every other axis
            # slice-local interconnect by definition
            return self._penalized(LINK_TABLE["ici"], axes)
        return self._penalized(LINK_TABLE["host"], axes)

    def link_params(self, link: Optional[str],
                    axes: Tuple[str, ...]) -> LinkParams:
        """A phase's link params: the stamped link class when the program
        carries one (penalties still apply — a demoted slow axis stays
        expensive whatever class synthesis stamped), else by axes."""
        if link:
            return self._penalized(LINK_TABLE[link], axes)
        return self.link(axes)

    def dcn_split(self, site: CollectiveSite) -> Tuple[Tuple[str, ...],
                                                       Tuple[str, ...]]:
        """Partition ``site.axes`` into (inner slice-local axes, outer
        cross-slice axes) for hierarchical program synthesis. Programs only
        make sense when the span actually CROSSES ``fp.dcn_axes`` — on an
        all-ICI mesh the extra full-width phases buy nothing (the legacy
        single-impl ``hierarchical`` estimate already prices that shape and
        loses there), so either side empty means: no split, no program."""
        axes = site.axes
        if site.axis_size is not None or len(axes) < 2:
            return ((), ())
        outer = tuple(a for a in axes if a in self.fp.dcn_axes)
        inner = tuple(a for a in axes if a not in self.fp.dcn_axes)
        if not outer or not inner:
            return ((), ())
        return inner, outer

    def axis_size_of(self, site: CollectiveSite) -> int:
        """The collective's rank count: the site's explicit override (a
        foreign-mesh site, e.g. zeropp's own dp axis) or the fingerprint."""
        if site.axis_size is not None:
            return int(site.axis_size)
        return self.fp.axis_size(site.axes)

    # -- wire-byte model ---------------------------------------------------
    def _wire_ratio(self, dtype: str) -> float:
        """on-wire bytes / logical bytes for an int8 payload + one fp32
        scale lane per block (comm/compressed.py accounting)."""
        item = max(1, itemsize(dtype))
        return (1.0 + 4.0 / self.block) / item

    def _estimate_decode_attn(self, site: CollectiveSite, impl: str) -> float:
        """Decode-shape regime: ``site.shape`` is the gathered pool view one
        decode step touches ([S, B*bs, Hk, D] in the STORAGE dtype, one
        pool); K and V double it. The einsum path materializes a
        compute-dtype copy (read the pool, write the copy, read it back in
        the attention einsum — plus the dequant stream for int8 storage);
        the pallas kernel streams the live pages once, in place. No link
        term: decode_attn is a kernel choice, not a collective."""
        bw = HBM_BW.get(self.platform, HBM_BW["cpu"])
        n = 2.0 * float(site.nbytes)          # K and V pools
        item = max(1, itemsize(site.dtype))
        if impl == "einsum":
            # the gathered copy lands in the COMPUTE dtype: same width as
            # fp/bf16 storage, widened for int8 pools (bf16 is the serving
            # compute dtype on the card, so assume 2 bytes there)
            copy = n * (max(2.0, float(item)) / item)
            t = n / bw + 2.0 * copy / bw
            if site.dtype == "int8":
                t += n * self.quant_cost
            return t
        if impl == "pallas":
            if self.platform != ACCELERATOR:
                # off the card the wrapper runs its plain version: a
                # reference path, never a win
                return float("inf")
            return n * DECODE_LIVE_FRACTION / bw
        return float("inf")

    # -- per-impl estimate -------------------------------------------------
    def estimate(self, site: CollectiveSite, impl: str) -> float:
        """Predicted seconds for one execution of ``site`` via ``impl``."""
        if site.op == "decode_attn":
            return self._estimate_decode_attn(site, impl)
        p = self.axis_size_of(site)
        if p <= 1:
            return 0.0
        lp = self.link(site.axes)
        n = float(site.nbytes)
        q = self._wire_ratio(site.dtype)
        hops = p - 1

        if site.op == "all_reduce":
            exact = 2 * hops * lp.alpha + 2 * n * hops / p * lp.beta
            if impl == "xla":
                return exact
            if impl in ("int8", "int8_sr"):
                t = 2 * hops * lp.alpha + 2 * n * q * hops / p * lp.beta \
                    + 2 * n * self.quant_cost + 2 * self.quant_fixed
                return t * (1.02 if impl == "int8_sr" else 1.0)
            if impl == "hierarchical":
                # inner axis exact (cheap links), outer hops quantized
                p_in, p_out = self._split_axes(site)
                if p_in <= 1 or p_out <= 1:
                    return float("inf")
                inner = self.link(site.axes[-1:])
                t = 2 * (p_in - 1) * inner.alpha \
                    + 2 * n * (p_in - 1) / p_in * inner.beta
                outer = self.link(site.axes[:1])
                t += 2 * (p_out - 1) * outer.alpha \
                    + 2 * n * q * (p_out - 1) / p_out * outer.beta \
                    + 2 * n * self.quant_cost + 2 * self.quant_fixed
                return t
        elif site.op in ("all_gather", "embed_gather"):
            # site.shape is the local shard; (p-1)*n bytes ride per rank.
            # embed_gather (the vocab-sharded table ring) has the same wire
            # profile — its menu simply has no int8 arm, and ring means the
            # chunk hops hide behind the resident chunk's row lookups
            # (ops/collective_matmul.py ring_embedding_gather)
            if impl == "xla":
                return hops * lp.alpha + hops * n * lp.beta
            if impl == "ring":
                return (hops * lp.alpha * RING_HOP_PENALTY
                        + hops * n * lp.beta * (1 - self.overlap_credit))
            if impl == "bidir_ring":
                return (-(-hops // 2) * lp.alpha * RING_HOP_PENALTY
                        + hops * n * lp.beta * (1 - self.overlap_credit))
            if impl == "int8":
                return (hops * lp.alpha + hops * n * q * lp.beta
                        + n * self.quant_cost * p + self.quant_fixed)
            if impl == "fused_matmul":
                # the compute-bound quantized chunk ring (fused_ring_all_
                # gather): int8 wire AND the overlap credit at once — wins
                # the big-message regime where both terms matter, loses
                # tiny alpha-dominated sites to exact xla (ring penalty +
                # quant_fixed)
                return (hops * lp.alpha * RING_HOP_PENALTY
                        + hops * n * q * lp.beta * (1 - self.overlap_credit)
                        + n * self.quant_cost * p + self.quant_fixed)
        elif site.op == "reduce_scatter":
            # site.shape is the full local input; (p-1)/p*n bytes per rank
            frac = n * hops / p
            if impl == "xla":
                return hops * lp.alpha + frac * lp.beta
            if impl == "ring":
                return (hops * lp.alpha * RING_HOP_PENALTY
                        + frac * lp.beta * (1 - self.overlap_credit))
            if impl in ("int8", "int8_sr"):
                t = hops * lp.alpha + frac * q * lp.beta \
                    + n * self.quant_cost + self.quant_fixed
                return t * (1.02 if impl == "int8_sr" else 1.0)
            if impl == "fused_matmul":
                # quantized ring reduction bound to the producing matmul:
                # one re-quantization round per hop (the shard-sized
                # accumulator), hops hidden behind the tiles
                return (hops * lp.alpha * RING_HOP_PENALTY
                        + frac * q * lp.beta * (1 - self.overlap_credit)
                        + n * self.quant_cost + hops * self.quant_fixed)
        elif site.op == "all_to_all":
            frac = n * hops / p
            if impl == "xla":
                return hops * lp.alpha + frac * lp.beta
            if impl == "int8":
                return (hops * lp.alpha + frac * q * lp.beta
                        + 2 * n * self.quant_cost + 2 * self.quant_fixed)
        elif site.op == "gather_matmul":
            # the collective half of a TP/Ulysses linear: gather n bytes of
            # activations; fused_matmul hides the ring behind the matmul
            if impl == "xla":
                return hops * lp.alpha + hops * n * lp.beta
            if impl == "fused_matmul":
                return (hops * lp.alpha * RING_HOP_PENALTY
                        + hops * n * lp.beta * (1 - self.overlap_credit))
        return float("inf")

    def phase_span(self, site: CollectiveSite, st: PhaseStep) -> Optional[int]:
        """Rank count of one phase of a program at ``site``. A foreign-mesh
        site (explicit ``axis_size``) is one flat axis the fingerprint knows
        nothing about: only phases spanning exactly the site's own axes are
        estimable there (span = the override); any other phase axes make
        the program un-costable (None -> inf)."""
        if site.axis_size is not None:
            if tuple(st.axes) == tuple(site.axes):
                return int(site.axis_size)
            return None
        return self.fp.axis_size(st.axes)

    def estimate_phase(self, site: CollectiveSite, st: PhaseStep,
                       n: float) -> Tuple[float, float]:
        """(seconds, per-rank payload bytes AFTER the phase) for one phase
        of a program at ``site``, entered with ``n`` payload bytes.

        Via arms: ``xla`` pays one fused-collective alpha per hop; ``ring``
        / ``bidir_ring`` pay :data:`RING_HOP_PENALTY` per hop (bidir halves
        the hop count); ``fused_matmul`` additionally earns the overlap
        credit on bandwidth (hops hidden behind the bound matmul's tiles);
        ``tree`` is the recursive-doubling/halving butterfly — ceil(log2 p)
        rounds at :data:`TREE_ROUND_PENALTY` each instead of O(p) hops, the
        alpha-dominated DCN shape, at ring-equivalent bandwidth for
        reduce_scatter/all_gather but log2(p)/2x the ring's bandwidth for
        all_reduce (every round moves the full vector). ``chunks`` = K > 1
        pipelines an xla phase: K alphas, but the next phase starts on
        chunk 1 while this one streams chunk 2 — the bandwidth term earns
        ``overlap_credit x (K-1)/K`` (only the first chunk is exposed)."""
        p = self.phase_span(site, st)
        if p is None:
            return float("inf"), n
        if p <= 1:
            return 0.0, n
        lp = self.link_params(st.link, st.axes)
        hops = p - 1
        rounds = max(1, int(np.ceil(np.log2(p))))
        k = max(1, int(st.chunks))
        q = self._wire_ratio(site.dtype) if st.quantized else 1.0
        overlap = 1.0
        if st.via in ("ring", "fused_matmul"):
            alpha_t = hops * RING_HOP_PENALTY * lp.alpha
            if st.via == "fused_matmul":
                overlap = 1 - self.overlap_credit
        elif st.via == "bidir_ring":
            alpha_t = -(-hops // 2) * RING_HOP_PENALTY * lp.alpha
        elif st.via == "tree":
            alpha_t = rounds * TREE_ROUND_PENALTY * lp.alpha
        else:
            alpha_t = hops * lp.alpha * k
            if k > 1:
                overlap = 1 - self.overlap_credit * (k - 1) / k
        t = 0.0
        if st.phase_op == "reduce_scatter":
            # recursive halving moves the same n(p-1)/p bytes as the ring
            t += alpha_t + n * hops / p * q * lp.beta * overlap
            if st.quantized:
                t += n * self.quant_cost + k * self.quant_fixed
            n = n / p
        elif st.phase_op == "all_reduce":
            if st.via == "tree":
                # recursive doubling: every round exchanges the FULL vector
                t += alpha_t + rounds * n * q * lp.beta
            else:
                t += 2 * alpha_t + 2 * n * q * hops / p * lp.beta * overlap
            if st.quantized:
                t += 2 * n * self.quant_cost + 2 * k * self.quant_fixed
        elif st.phase_op == "all_gather":
            t += alpha_t + hops * n * q * lp.beta * overlap
            if st.quantized:
                t += n * p * self.quant_cost + k * self.quant_fixed
            n = n * p
        elif st.phase_op == "all_to_all":
            t += alpha_t + n * hops / p * q * lp.beta * overlap
            if st.quantized:
                t += 2 * n * self.quant_cost + 2 * k * self.quant_fixed
        if st.via == "tree" and st.quantized:
            # each butterfly round re-quantizes its sent piece
            t += (rounds - 1) * self.quant_fixed
        return t, n

    def estimate_program(self, site: CollectiveSite,
                         program: Tuple[PhaseStep, ...]) -> float:
        """Predicted seconds for one execution of a multi-phase program at
        ``site``. Each phase is costed with ITS OWN link params (the
        distinct DCN alpha/beta in :data:`LINK_TABLE` — the term that makes
        'exact on ICI, int8 on DCN' beat both flat variants the moment a
        slice boundary enters the span) and the per-rank payload tracks
        the phase algebra: a reduce-scatter shrinks it by the axis span, an
        all-gather grows it back. Fused phases (``via="fused_matmul"``)
        take the ring alpha penalty but earn the overlap credit on the
        bandwidth term — their hops ride behind the bound matmul's tiles,
        the term that lets a fused-hierarchical program beat its sequenced
        twin on the same cost scale. Foreign-mesh sites (explicit
        ``axis_size``) are estimable only for programs whose every phase
        spans exactly the site's axes (the compiler's single-phase
        tree/chunked shapes); anything else prices to inf."""
        n = float(site.nbytes)
        t = 0.0
        for st in program:
            dt, n = self.estimate_phase(site, st, n)
            t += dt
            if not np.isfinite(t):
                return float("inf")
        return t

    def _split_axes(self, site: CollectiveSite) -> Tuple[int, int]:
        """(inner, outer) sizes for the hierarchical split: last axis is the
        inner (ICI-local) hop, the rest the outer — the zeropp
        hierarchical_all_gather convention. A foreign-mesh site (explicit
        axis_size) is one flat axis: no split."""
        axes = site.axes
        if len(axes) < 2 or site.axis_size is not None:
            return (1, self.axis_size_of(site))
        return (self.fp.axis_size(axes[-1:]), self.fp.axis_size(axes[:-1]))

    # -- candidate enumeration + pruning -----------------------------------
    def candidates(self, site: CollectiveSite) -> List[str]:
        """Structurally-valid implementations for ``site``."""
        out = []
        for impl in OP_MENU[site.op]:
            if impl == "hierarchical":
                p_in, p_out = self._split_axes(site)
                if p_in <= 1 or p_out <= 1:
                    continue
            if impl == "int8_sr" and site.consumer not in GRADIENT_CONSUMERS:
                continue  # activations round to nearest, never dithered
            out.append(impl)
        return out

    def prune(self, site: CollectiveSite,
              margin: float = 3.0) -> List[Tuple[str, float]]:
        """Rank candidates by estimated cost; drop any whose estimate
        exceeds ``margin`` x the best (dominated — not worth measuring).
        Ties keep menu order (xla first), so ranking is deterministic."""
        ests = [(impl, self.estimate(site, impl))
                for impl in self.candidates(site)]
        ests.sort(key=lambda kv: kv[1])
        if not ests:
            raise ValueError(f"no candidate implementation for {site}")
        best = ests[0][1]
        cut = best * margin if best > 0 else float("inf")
        survivors = [(i, e) for i, e in ests if e <= cut]
        return survivors or ests[:1]

    def decide(self, site: CollectiveSite,
               margin: float = 3.0) -> PlanDecision:
        """Static-mode decision: the cost model's argmin."""
        impl, est = self.prune(site, margin=margin)[0]
        quantized = impl in ("int8", "int8_sr", "hierarchical") or (
            # the fused gather/scatter rings carry an int8 wire; the TP
            # gather_matmul fused impl is exact and needs no block
            impl == "fused_matmul"
            and site.op in ("all_gather", "reduce_scatter"))
        return PlanDecision(impl=impl,
                            block=self.block if quantized else None,
                            source="cost-model",
                            est_us=round(est * 1e6, 3))
