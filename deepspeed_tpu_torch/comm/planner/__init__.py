"""Collective planner: topology-aware plan IR + microbenchmark autotuner.

Port of ``deepspeed_tpu/comm/planner/`` with the JAX exports: the plan IR,
the mesh fingerprint and alpha-beta cost model (the card's figures), the
on-disk plan cache, the program compiler, the planner in modes ``off``,
``static`` and ``measure``, and the probe memo. Measure mode times the
serving ``decode_attn`` site (the paged decode kernel against the
gathered-page einsum); the collective probes raise naming ROADMAP.md Queue
A item 8, and the planner keeps the cost model's pick there.
"""

from .cache import PlanCache, default_cache_dir
from .compiler import (DEFAULT_BEAM_WIDTH, PROGRAM_CAPABLE, SEARCH_SPACE,
                       compile_programs, legacy_menu_programs,
                       program_capable)
from .ir import (CONSUMERS, FUSED_PHASE_OPS, FUSED_ROLES, IMPLEMENTATIONS,
                 LINK_CLASSES, OP_MENU, PHASE_OPS, PHASE_VIAS, PLAN_FORMAT,
                 WIRE_DTYPES, CollectiveSite, FusedCompute, PhaseStep, Plan,
                 PlanDecision, make_phase, make_site, program_summary)
from .microbench import benchmark_site, probe_stats, reset_probe_memo
from .planner import (MODES, CollectivePlanner, configure_from_config,
                      configure_planner, get_planner, planner_active,
                      reset_planner, resolve_site, synthesize_programs)
from .topo import CostModel, LinkParams, MeshFingerprint

__all__ = [
    "CONSUMERS", "IMPLEMENTATIONS", "OP_MENU", "MODES",
    "PHASE_OPS", "PHASE_VIAS", "WIRE_DTYPES", "LINK_CLASSES",
    "FUSED_PHASE_OPS", "FUSED_ROLES", "PLAN_FORMAT",
    "CollectiveSite", "Plan", "PlanDecision", "PhaseStep", "FusedCompute",
    "make_site", "make_phase", "program_summary", "synthesize_programs",
    "SEARCH_SPACE", "DEFAULT_BEAM_WIDTH", "PROGRAM_CAPABLE",
    "compile_programs", "legacy_menu_programs", "program_capable",
    "MeshFingerprint", "CostModel", "LinkParams",
    "PlanCache", "default_cache_dir", "benchmark_site", "probe_stats",
    "reset_probe_memo",
    "CollectivePlanner", "configure_planner", "configure_from_config",
    "get_planner", "planner_active", "reset_planner", "resolve_site",
]
