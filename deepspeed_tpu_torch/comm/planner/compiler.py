"""Collective-program compiler: generative synthesis + pruned beam search.

Port of ``deepspeed_tpu/comm/planner/compiler.py``, whole and pure: for
the same site and fingerprint it compiles the JAX package's programs. The
accelerator platform is the card's (``topo.ACCELERATOR``) where JAX tests
for ``"tpu"``. The port's wiring executes no program yet (its
``run_collective_program`` raises, ROADMAP.md Queue A item 9), so programs
are compiled, priced and recorded; measure mode cannot probe them.

PR 8 synthesized exactly five hand-written program shapes (hierarchical
twins + fused variants, all_reduce sites only). This module is the GC3
move done properly (arxiv 2201.11840): programs are *compiled* from a
grammar — axis orderings and groupings, per-phase algorithm shape
(xla | ring | bidir_ring | tree recursive-halving | fused_matmul),
per-phase wire dtype (exact | int8 | int8_ef under the existing
gradient-consumer rule), per-phase chunked pipelining — and ranked by
``topo.CostModel.estimate_phase`` on one alpha-beta scale, with "The Big
Send-off"'s topology-aware shapes (arxiv 2504.18658) as the option pool.

The search is slot-wise pruned: for each program *structure* (an ordered
grouping of the site's axes into shell/core phases) every slot keeps its
top-k options by per-phase estimate, the capped cross-product is priced
whole, and the global top ``beam_width`` programs survive. Static mode
takes the argmin; measure mode times the beam through the real executor
(``microbench.benchmark_site``). Everything is deterministic: stable
enumeration order + stable sorts, so two fresh planners on the same
fingerprint compile the identical beam.

``SEARCH_SPACE`` versions the generator. It is folded into the on-disk
winner-cache identity (``cache.PlanCache``), so widening the grammar in a
later PR invalidates persisted winners (clean miss -> re-tune) instead of
silently replaying a plan searched over a narrower space.

Tree and chunked options are only generated for DCN-class phase links:
the tree's log2(p) rounds buy alpha on high-latency cross-slice hops
(the regime a 3-axis mesh exposes), and chunk pipelining hides
wire time that is only *exposed* at a slice boundary. ICI/host phases
keep the PR 8/14 option set, so all-ICI meshes resolve exactly as before.
"""

import itertools
from typing import List, Optional, Tuple

from .ir import (GRADIENT_CONSUMERS, CollectiveSite, FusedCompute, PhaseStep,
                 make_phase)
from .topo import ACCELERATOR, CostModel

# Version of the generator grammar. Bump when the program space WIDENS
# (new vias, new wire dtypes, new structures): a cached winner searched
# over an older space may no longer be the argmin, so the plan cache keys
# files by this version and treats a mismatch as a miss.
SEARCH_SPACE = 1

# beam width the planner uses when the config leaves the default
DEFAULT_BEAM_WIDTH = 8
# per-slot option survivors before the cross-product (the prune that keeps
# the search linear-ish in structure count)
TOP_PER_SLOT = 2
# chunk-count options offered per xla phase (K=1 is the unchunked slot)
CHUNK_OPTIONS = (2, 4)
# don't chunk phases whose payload is too small to amortize K alphas
MIN_CHUNK_BYTES = 1 << 16

# (consumer, op) pairs whose wiring can EXECUTE a program decision
# (runtime/engine.py binds fused tiles + threads the feedback carry for
# the DP gradient reduction). Everything else still gets its programs
# compiled, priced and probed — but ``CollectivePlanner.resolve`` keeps
# the best single impl and records the search outcome, because handing
# a "program" decision to a wiring that dispatches on impl flags would
# silently degrade to the exact path.
PROGRAM_CAPABLE = (("dp-grad", "all_reduce"),)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _link_for(fp, axes) -> str:
    if any(a in fp.dcn_axes for a in axes):
        return "dcn"
    if fp.platform == ACCELERATOR or fp.dcn_axes:
        return "ici"
    return "host"


def _span(site: CollectiveSite, cost: CostModel, group) -> int:
    if site.axis_size is not None:
        return int(site.axis_size)
    return cost.fp.axis_size(tuple(group))


def _tree_ok(site: CollectiveSite, cost: CostModel, group) -> bool:
    """Tree phases need a power-of-two span on EVERY axis of the group
    (the butterfly partner is rank XOR 2^r, per axis)."""
    if site.axis_size is not None:
        return _is_pow2(int(site.axis_size))
    return all(_is_pow2(cost.fp.axis_size((a,)))
               for a in group)


def _ordered_set_partitions(axes: Tuple[str, ...], max_groups: int = 3):
    """All ordered partitions of ``axes`` into <= max_groups non-empty
    groups (group members keep the site's relative axis order). Order
    matters between groups — which axes scatter first is part of the
    program — and the enumeration order is deterministic."""
    axes = tuple(axes)
    if not axes:
        yield ()
        return
    n = len(axes)
    # choose a non-empty subset (as a bitmask, ascending) for the first
    # group, recurse on the remainder
    for mask in range(1, 1 << n):
        first = tuple(a for i, a in enumerate(axes) if mask >> i & 1)
        rest = tuple(a for i, a in enumerate(axes) if not mask >> i & 1)
        if not rest:
            yield (first,)
            continue
        if max_groups <= 1:
            continue
        for tail in _ordered_set_partitions(rest, max_groups - 1):
            yield (first,) + tail


def _compositions(axes: Tuple[str, ...], max_groups: int = 3):
    """Ordered partitions of ``axes`` into CONTIGUOUS segments, order
    preserved — the only groupings whose per-group collective chain
    reproduces the flat tiled placement for gather/scatter/exchange
    sites (an all_reduce's replicated result is placement-free, so it
    gets the full reordering space instead)."""
    axes = tuple(axes)
    n = len(axes)
    if n == 0:
        yield ()
        return
    for k in range(1, min(n, max_groups) + 1):
        for cuts in itertools.combinations(range(1, n), k - 1):
            bounds = (0,) + cuts + (n,)
            yield tuple(axes[bounds[i]:bounds[i + 1]] for i in range(k))


class _Options:
    """Per-slot option list builder (deterministic emission order)."""

    def __init__(self, site: CollectiveSite, cost: CostModel, block: int):
        self.site = site
        self.cost = cost
        self.block = block
        self.fp = cost.fp
        self.gradient = site.consumer in GRADIENT_CONSUMERS

    def _chunk_ks(self, n_in: float):
        return [k for k in CHUNK_OPTIONS if n_in >= MIN_CHUNK_BYTES * k]

    def _fast_link(self, group) -> Tuple[str, bool]:
        link = _link_for(self.fp, group)
        return link, link == "dcn"

    def rs_shell(self, group, n_in: float, fused_ok: bool) -> List[PhaseStep]:
        link, dcn = self._fast_link(group)
        opts = [make_phase("reduce_scatter", group, link=link)]
        if dcn:
            for k in self._chunk_ks(n_in):
                opts.append(make_phase("reduce_scatter", group, link=link,
                                       chunks=k))
            if _tree_ok(self.site, self.cost, group):
                opts.append(make_phase("reduce_scatter", group, via="tree",
                                       link=link))
        if fused_ok:
            opts.append(make_phase(
                "reduce_scatter", group, via="fused_matmul", link=link,
                compute=FusedCompute(role="producer",
                                     site=f"{self.site.consumer}/bwd")))
        if not self.gradient:
            opts.append(make_phase("reduce_scatter", group,
                                   wire_dtype="int8", block=self.block,
                                   link=link))
        return opts

    def ag_shell(self, group, n_in: float, fused_ok: bool) -> List[PhaseStep]:
        link, dcn = self._fast_link(group)
        opts = [make_phase("all_gather", group, link=link),
                make_phase("all_gather", group, via="bidir_ring", link=link)]
        if dcn:
            for k in self._chunk_ks(n_in):
                opts.append(make_phase("all_gather", group, link=link,
                                       chunks=k))
            if _tree_ok(self.site, self.cost, group):
                opts.append(make_phase("all_gather", group, via="tree",
                                       link=link))
        if fused_ok:
            opts.append(make_phase(
                "all_gather", group, via="fused_matmul", link=link,
                compute=FusedCompute(role="consumer",
                                     site=f"{self.site.consumer}/apply")))
        if not self.gradient:
            opts.append(make_phase("all_gather", group, wire_dtype="int8",
                                   block=self.block, link=link))
        return opts

    def ar_core(self, group, n_in: float) -> List[PhaseStep]:
        link, dcn = self._fast_link(group)
        opts = [make_phase("all_reduce", group, link=link)]
        if self.gradient:
            # the existing gradient-consumer rule: the quantized core hop
            # carries the error-feedback residual (full-tensor carry, so
            # xla-only and never chunked — IR validation)
            opts.append(make_phase("all_reduce", group,
                                   wire_dtype="int8_ef", block=self.block,
                                   link=link))
        else:
            opts.append(make_phase("all_reduce", group, wire_dtype="int8",
                                   block=self.block, link=link))
        if dcn:
            for k in self._chunk_ks(n_in):
                opts.append(make_phase("all_reduce", group, link=link,
                                       chunks=k))
                if not self.gradient:
                    opts.append(make_phase("all_reduce", group,
                                           wire_dtype="int8",
                                           block=self.block, link=link,
                                           chunks=k))
            if _tree_ok(self.site, self.cost, group):
                opts.append(make_phase("all_reduce", group, via="tree",
                                       link=link))
                if not self.gradient:
                    opts.append(make_phase("all_reduce", group, via="tree",
                                           wire_dtype="int8",
                                           block=self.block, link=link))
        return opts

    def gather(self, group, n_in: float) -> List[PhaseStep]:
        link, dcn = self._fast_link(group)
        opts = [make_phase("all_gather", group, link=link),
                make_phase("all_gather", group, via="ring", link=link),
                make_phase("all_gather", group, via="bidir_ring", link=link),
                make_phase("all_gather", group, wire_dtype="int8",
                           block=self.block, link=link)]
        if dcn:
            for k in self._chunk_ks(n_in):
                opts.append(make_phase("all_gather", group, link=link,
                                       chunks=k))
            if _tree_ok(self.site, self.cost, group):
                opts.append(make_phase("all_gather", group, via="tree",
                                       link=link))
                opts.append(make_phase("all_gather", group, via="tree",
                                       wire_dtype="int8", block=self.block,
                                       link=link))
        return opts

    def scatter(self, group, n_in: float) -> List[PhaseStep]:
        link, dcn = self._fast_link(group)
        wire = "int8_sr" if self.gradient else "int8"
        opts = [make_phase("reduce_scatter", group, link=link),
                make_phase("reduce_scatter", group, wire_dtype=wire,
                           block=self.block, link=link)]
        if dcn:
            for k in self._chunk_ks(n_in):
                opts.append(make_phase("reduce_scatter", group, link=link,
                                       chunks=k))
            if _tree_ok(self.site, self.cost, group):
                opts.append(make_phase("reduce_scatter", group, via="tree",
                                       link=link))
        return opts

    def exchange(self, group, n_in: float) -> List[PhaseStep]:
        link, dcn = self._fast_link(group)
        opts = [make_phase("all_to_all", group, link=link),
                make_phase("all_to_all", group, wire_dtype="int8",
                           block=self.block, link=link)]
        if dcn:
            for k in self._chunk_ks(n_in):
                opts.append(make_phase("all_to_all", group, link=link,
                                       chunks=k))
                opts.append(make_phase("all_to_all", group,
                                       wire_dtype="int8", block=self.block,
                                       link=link, chunks=k))
        return opts


def _structures(site: CollectiveSite):
    """The ordered-grouping skeletons for ``site``: a list of
    ``(kind, group)`` slot sequences (kinds: rs/ar/ag/a2a). A foreign-mesh
    site (explicit ``axis_size``) is one flat axis the fingerprint can't
    decompose — single-group structures only."""
    axes = tuple(site.axes)
    if site.axis_size is not None:
        parts_iter = [(axes,)] if axes else []
    elif site.op == "all_reduce":
        parts_iter = list(_ordered_set_partitions(axes))
    else:
        parts_iter = list(_compositions(axes))
    out = []
    if site.op == "all_reduce":
        for parts in parts_iter:
            shells, core = parts[:-1], parts[-1]
            slots = [("rs", g) for g in shells]
            slots.append(("ar", core))
            slots.extend(("ag", g) for g in reversed(shells))
            out.append(tuple(slots))
    elif site.op == "all_gather":
        for parts in parts_iter:
            # execution order: LAST placement group first (the per-group
            # chain that reproduces the flat tuple collective's tiled
            # placement — see run_collective_program's reversed chains)
            out.append(tuple(("ag", g) for g in reversed(parts)))
    elif site.op == "reduce_scatter":
        for parts in parts_iter:
            out.append(tuple(("rs", g) for g in parts))
    elif site.op == "all_to_all":
        # a2a placement does not decompose into per-group exchanges;
        # the program space is the single-phase option pool
        out.append((("a2a", axes),))
    return out


def _slot_options(kind: str, group, n_in: float, opts: "_Options",
                  fused_ok: bool, site_op: str) -> List[PhaseStep]:
    if site_op == "all_reduce":
        if kind == "rs":
            return opts.rs_shell(group, n_in, fused_ok)
        if kind == "ar":
            return opts.ar_core(group, n_in)
        return opts.ag_shell(group, n_in, fused_ok)
    if kind == "ag":
        return opts.gather(group, n_in)
    if kind == "rs":
        return opts.scatter(group, n_in)
    return opts.exchange(group, n_in)


def _is_flat_twin(program: Tuple[PhaseStep, ...]) -> bool:
    """A single-phase xla/unchunked program IS the flat single-impl menu
    entry — emitting it as a program would duplicate (and on ties shadow)
    the single-impl candidate the planner already prices."""
    if len(program) != 1:
        return False
    st = program[0]
    return st.via == "xla" and st.chunks == 1


def compile_programs(site: CollectiveSite, cost: CostModel, *,
                     block: int = 2048,
                     beam_width: int = DEFAULT_BEAM_WIDTH
                     ) -> List[Tuple[Tuple[PhaseStep, ...], float]]:
    """The searched program beam for ``site``: up to ``beam_width``
    ``(program, est_seconds)`` pairs, cost-ascending, deterministic.

    Covers any site op (all_reduce | all_gather | reduce_scatter |
    all_to_all), multi-axis AND foreign-axis (explicit ``axis_size``)
    spans. Slot-wise pruning: per structure, each slot keeps its
    ``TOP_PER_SLOT`` cheapest options by :meth:`CostModel.estimate_phase`;
    the cross-product is priced whole by ``estimate_program`` and the
    global top-``beam_width`` survives. The all-exact sequenced variant of
    each structure is always priced too (the parity/safety anchor), and
    PR 8's five legacy shapes are merged in verbatim so the old menu's
    winners can never be lost to slot pruning."""
    if site.op not in ("all_reduce", "all_gather", "reduce_scatter",
                      "all_to_all"):
        return []
    p_total = cost.axis_size_of(site)
    if p_total <= 1:
        return []
    if not any(a in cost.fp.dcn_axes for a in site.axes):
        # homogeneous links: a flat XLA collective is already
        # bandwidth-optimal and the decomposed phases only add launches —
        # same decline as the legacy menu's dcn_split gate. A foreign-mesh
        # site (zeropp's own ``dp``) qualifies when the operator marked its
        # axis via comm_planner.dcn_axes (that membership IS its link class)
        return []
    if site.op == "all_to_all" and site.axis_size is None:
        n_elems = 1
        for d in site.shape:
            n_elems *= int(d)
        if n_elems % p_total:
            return []  # uneven exchange: the wiring's xla fallback owns it
    fused_ok = (site.op == "all_reduce" and site.axis_size is None)
    opts = _Options(site, cost, block)
    seen = {}
    order = itertools.count()
    for slots in _structures(site):
        # payload walk (depends on structure only, never on options)
        n = float(site.nbytes)
        slot_opts: List[List[PhaseStep]] = []
        anchor: List[PhaseStep] = []
        ok = True
        for kind, group in slots:
            span = _span(site, cost, group)
            if span <= 1 and len(slots) > 1:
                ok = False  # degenerate group: same program exists without it
                break
            cands = _slot_options(kind, group, n, opts, fused_ok, site.op)
            ranked = sorted(
                ((cost.estimate_phase(site, st, n)[0], i, st)
                 for i, st in enumerate(cands)),
                key=lambda t: (t[0], t[1]))
            keep = [st for _, _, st in ranked[:TOP_PER_SLOT]]
            slot_opts.append(keep)
            anchor.append(cands[0])  # emission position 0 = exact xla
            if kind == "rs":
                n = n / span
            elif kind == "ag":
                n = n * span
        if not ok or not slot_opts:
            continue
        combos = [tuple(c) for c in itertools.product(*slot_opts)]
        combos.append(tuple(anchor))
        for prog in combos:
            if _is_flat_twin(prog) or prog in seen:
                continue
            est = cost.estimate_program(site, prog)
            if est != est or est == float("inf"):
                continue
            seen[prog] = (est, next(order))
    for prog in legacy_menu_programs(site, cost, block=block):
        prog = tuple(prog)
        if prog not in seen:
            est = cost.estimate_program(site, prog)
            if est != float("inf"):
                seen[prog] = (est, next(order))
    beam = sorted(seen.items(), key=lambda kv: (kv[1][0], kv[1][1]))
    return [(prog, est) for prog, (est, _) in beam[:max(1, int(beam_width))]]


def legacy_menu_programs(site: CollectiveSite, cost: CostModel,
                         block: int = 2048
                         ) -> List[Tuple[PhaseStep, ...]]:
    """PR 8/14's five hand-synthesized candidates, verbatim — kept both as
    the ``synthesize_programs`` compat shim's body and as a merge-in floor
    for :func:`compile_programs` (slot pruning can never lose the old
    menu's winners)."""
    if site.op != "all_reduce" or site.axis_size is not None:
        return []
    inner, outer = cost.dcn_split(site)
    if not inner or not outer:
        return []
    fp = cost.fp
    if fp.axis_size(inner) <= 1 or fp.axis_size(outer) <= 1:
        return []
    in_link = "ici" if (fp.platform == ACCELERATOR or fp.dcn_axes) else "host"
    out_link = ("dcn" if any(a in fp.dcn_axes for a in outer) else in_link)
    wire = "int8_ef" if site.consumer in GRADIENT_CONSUMERS else "int8"
    rs = make_phase("reduce_scatter", inner, link=in_link)
    ag = make_phase("all_gather", inner, link=in_link)
    ag_bidir = make_phase("all_gather", inner, via="bidir_ring", link=in_link)
    ar_exact = make_phase("all_reduce", outer, link=out_link)
    ar_int8 = make_phase("all_reduce", outer, wire_dtype=wire, block=block,
                         link=out_link)
    rs_f = make_phase("reduce_scatter", inner, via="fused_matmul",
                      link=in_link,
                      compute=FusedCompute(role="producer",
                                           site=f"{site.consumer}/bwd"))
    ag_f = make_phase("all_gather", inner, via="fused_matmul", link=in_link,
                      compute=FusedCompute(role="consumer",
                                           site=f"{site.consumer}/apply"))
    return [
        (rs, ar_int8, ag),          # hierarchical-int8-outer (the DCN shape)
        (rs, ar_exact, ag),         # hierarchical-exact
        (rs, ar_int8, ag_bidir),    # bidir-ring gather variant
        (rs_f, ar_int8, ag_f),      # fused-hierarchical (the t3 shape)
        (rs_f, ar_exact, ag_f),     # fused-hierarchical, exact outer
    ]


def program_capable(site: CollectiveSite) -> bool:
    """Whether a wiring exists that can EXECUTE a program decision at this
    site (see :data:`PROGRAM_CAPABLE`)."""
    return (site.consumer, site.op) in PROGRAM_CAPABLE
