"""Declarative sharding rules: regex paths over a parameter tree -> specs.

Port of ``deepspeed_tpu/sharding/rules.py``. A spec is a
:class:`PartitionSpec`, a tuple of per-dim entries (``None``, an axis name,
or a tuple of axis names), as the JAX ``PartitionSpec``; it is a pytree
leaf, and it compares equal to the plain tuple of its entries (the
state-dict factory's convention). The port lays a tensor-parallel tree
out explicitly from these specs (``runtime/engine.py`` slices each leaf to
its rank, ``models/transformer.py`` reads the layout back from the leaves'
shapes) where the JAX package hands them to GSPMD.

A :class:`Rule` is ``(pattern, spec[, priority, ndim, note])``: an
``re.search`` regex over the ``/``-joined parameter path, the spec, a
priority (higher wins; among equals an ``ndim``-conditioned rule beats a
generic one, and two different surviving specs raise
:class:`AmbiguousRuleError`) and an optional rank gate. Rule sets
serialize to versioned JSON, validate their axis names against a topology
and rename axes.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


#: serialized rule-set format; bump on breaking layout changes (readers
#: refuse anything newer — the plan-cache versioning convention)
RULES_FORMAT = 1


class PartitionSpec(tuple):
    """Per-dim sharding entries: ``PartitionSpec(None, "tp")``. A tuple
    (equal to the plain tuple of its entries) that tree utilities keep as
    one leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


class ShardingRuleError(ValueError):
    """Base class for every rules-layer failure (all named, none silent)."""


class UnknownAxisError(ShardingRuleError):
    """A rule names a mesh axis the target mesh does not have."""


class AmbiguousRuleError(ShardingRuleError):
    """Two same-priority rules matched one path with different specs."""


class UnmatchedParamError(ShardingRuleError):
    """``strict`` matching found a parameter no rule covers."""


class RulesFormatError(ShardingRuleError):
    """Serialized rule set written by a newer format than this reader."""


class ForeignModelShardingError(ShardingRuleError):
    """A model-parallel engine was handed a foreign (non-sharding-native)
    apply_fn + param tree with no sharding rules: refusing to silently
    replicate every parameter on every rank.  Pass ``param_specs="auto"``
    (AutoTP inference), a :class:`RuleSet`, an explicit spec tree — or use
    ``deepspeed_tpu.autotp_initialize`` for the end-to-end route."""


def _canon_entry(entry: Any) -> Any:
    """None | axis-name | tuple-of-axis-names, canonicalized."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry
    if isinstance(entry, (tuple, list)):
        return tuple(str(e) for e in entry)
    raise ShardingRuleError(f"bad spec entry {entry!r}: want None, an axis "
                            "name, or a tuple of axis names")


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, tuple):
        return entry
    return (entry,)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative sharding decision.  Immutable and hashable."""

    pattern: str
    spec: Tuple[Any, ...]
    priority: int = 0
    ndim: Optional[int] = None
    note: str = ""

    def __post_init__(self):
        object.__setattr__(self, "spec",
                           tuple(_canon_entry(e) for e in self.spec))
        try:
            object.__setattr__(self, "_rx", re.compile(self.pattern))
        except re.error as e:
            raise ShardingRuleError(
                f"rule pattern {self.pattern!r} is not a valid regex: {e}")

    def matches(self, path: str, ndim: int) -> bool:
        if self.ndim is not None and self.ndim != ndim:
            return False
        return self._rx.search(path) is not None

    def axes(self) -> Tuple[str, ...]:
        out: List[str] = []
        for e in self.spec:
            out.extend(_entry_axes(e))
        return tuple(out)

    def partition_spec(self) -> P:
        return P(*self.spec)

    def renamed(self, mapping: Mapping[str, str]) -> "Rule":
        def sub(entry):
            if entry is None:
                return None
            if isinstance(entry, tuple):
                return tuple(mapping.get(a, a) for a in entry)
            return mapping.get(entry, entry)

        return dataclasses.replace(self, spec=tuple(sub(e) for e in self.spec))

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"pattern": self.pattern,
                             "spec": [list(e) if isinstance(e, tuple) else e
                                      for e in self.spec]}
        if self.priority:
            d["priority"] = self.priority
        if self.ndim is not None:
            d["ndim"] = self.ndim
        if self.note:
            d["note"] = self.note
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Rule":
        return cls(pattern=d["pattern"],
                   spec=tuple(tuple(e) if isinstance(e, list) else e
                              for e in d["spec"]),
                   priority=int(d.get("priority", 0)),
                   ndim=d.get("ndim"),
                   note=str(d.get("note", "")))


def _leaf_paths(params) -> Tuple[List[Tuple[str, Any]], Any]:
    """``[(path, leaf)]`` with ``/``-joined string paths + the structure
    (``module_inject/auto_tp.flatten_with_paths``: dict keys sorted, as the
    JAX package flattens)."""
    from ..module_inject.auto_tp import flatten_with_paths

    paths, leaves, treedef = flatten_with_paths(params)
    return list(zip(paths, leaves)), treedef


def _leaf_ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


class RuleSet:
    """An ordered, named, versioned collection of :class:`Rule`."""

    def __init__(self, rules: Iterable[Rule], *, name: str = "",
                 axes: Optional[Iterable[str]] = None,
                 format_version: int = RULES_FORMAT):
        if format_version > RULES_FORMAT:
            raise RulesFormatError(
                f"rule set {name!r} has format {format_version}; this "
                f"reader understands <= {RULES_FORMAT} — upgrade before "
                "loading (refusing a silent misread)")
        self.rules: Tuple[Rule, ...] = tuple(
            r if isinstance(r, Rule) else Rule(*r) for r in rules)
        self.name = name
        self.axes: Optional[frozenset] = (
            frozenset(str(a) for a in axes) if axes is not None else None)
        self.format_version = int(format_version)
        if self.axes is not None:
            self.validate(self.axes)

    # -- validation ------------------------------------------------------
    def used_axes(self) -> frozenset:
        out = set()
        for r in self.rules:
            out.update(r.axes())
        return frozenset(out)

    def validate(self, axes: Iterable[str]) -> "RuleSet":
        """Every axis any rule names must exist in ``axes`` (a mesh's axis
        names, a topology, or an ``axis -> size`` mapping)."""
        known = set(str(a) for a in axes)
        for r in self.rules:
            bad = [a for a in r.axes() if a not in known]
            if bad:
                raise UnknownAxisError(
                    f"rule {r.pattern!r} ({self.name or 'unnamed'}) names "
                    f"mesh axis(es) {bad} not in {sorted(known)}")
        return self

    # -- matching --------------------------------------------------------
    def candidates(self, path: str, ndim: int) -> List[Rule]:
        return [r for r in self.rules if r.matches(path, ndim)]

    def match_path(self, path: str, ndim: int) -> Optional[Rule]:
        """Winning rule for one path, or None.  Precedence: priority desc,
        then ndim-conditioned over generic; surviving disagreement raises."""
        cands = self.candidates(path, ndim)
        if not cands:
            return None
        top_prio = max(r.priority for r in cands)
        top = [r for r in cands if r.priority == top_prio]
        if any(r.ndim is not None for r in top):
            top = [r for r in top if r.ndim is not None]
        distinct = {r.spec for r in top}
        if len(distinct) > 1:
            pats = ", ".join(f"{r.pattern!r} -> {r.spec}" for r in top)
            raise AmbiguousRuleError(
                f"param {path!r} (ndim={ndim}) matches {len(top)} rules at "
                f"priority {top_prio} with different specs: {pats} — give "
                "one a higher priority or tighten the patterns")
        return top[0]

    def match(self, params, *, axis_sizes: Optional[Mapping[str, int]] = None,
              strict: bool = False):
        """PartitionSpec pytree for ``params``.

        Unmatched leaves replicate (explicit ``P(None, ...)`` of the leaf's
        rank — the bitwise convention ``param_specs``/``tp_parser`` share);
        ``strict`` turns them into :class:`UnmatchedParamError`.  With
        ``axis_sizes``, axis names are validated against the mesh and a
        sharded dim whose size does not divide by its axes' product is
        downgraded to replicated (the AutoTP indivisible-dim rule).
        """
        if axis_sizes is not None:
            self.validate(axis_sizes)
        flat, treedef = _leaf_paths(params)
        specs = []
        for path, leaf in flat:
            nd = _leaf_ndim(leaf)
            rule = self.match_path(path, nd)
            if rule is None:
                if strict:
                    raise UnmatchedParamError(
                        f"no rule in {self.name or 'rule set'} covers param "
                        f"{path!r} (ndim={nd}); add a rule or drop strict")
                specs.append(P(*([None] * nd)))
                continue
            entries = list(rule.spec)
            if axis_sizes is not None:
                shape = getattr(leaf, "shape", ())
                for d, entry in enumerate(entries):
                    if entry is None or d >= len(shape):
                        continue
                    size = 1
                    for a in _entry_axes(entry):
                        size *= int(axis_sizes[a])
                    if size > 1 and shape[d] % size:
                        entries[d] = None  # indivisible: replicate this dim
            specs.append(P(*entries))
        from ..module_inject.auto_tp import unflatten

        return unflatten(treedef, specs)

    def overlap_report(self, params) -> List[Dict[str, Any]]:
        """Every path where more than one rule survives precedence — the
        ambiguity *detector* as a report (the matcher raises instead)."""
        out = []
        for path, leaf in _leaf_paths(params)[0]:
            nd = _leaf_ndim(leaf)
            cands = self.candidates(path, nd)
            if len(cands) > 1:
                out.append({"path": path, "ndim": nd,
                            "rules": [r.pattern for r in cands],
                            "specs": [r.spec for r in cands]})
        return out

    # -- transforms ------------------------------------------------------
    def renamed(self, mapping: Mapping[str, str]) -> "RuleSet":
        axes = (frozenset(mapping.get(a, a) for a in self.axes)
                if self.axes is not None else None)
        return RuleSet([r.renamed(mapping) for r in self.rules],
                       name=self.name, axes=axes,
                       format_version=self.format_version)

    def extended(self, rules: Iterable[Rule], *,
                 name: Optional[str] = None) -> "RuleSet":
        return RuleSet(self.rules + tuple(rules),
                       name=self.name if name is None else name,
                       axes=None if self.axes is None else self.axes,
                       format_version=self.format_version)

    # -- serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"format": self.format_version, "name": self.name,
                "axes": sorted(self.axes) if self.axes is not None else None,
                "rules": [r.to_dict() for r in self.rules]}

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RuleSet":
        fmt = int(d.get("format", 0))
        if fmt > RULES_FORMAT:
            raise RulesFormatError(
                f"serialized rule set {d.get('name')!r} has format {fmt}; "
                f"this reader understands <= {RULES_FORMAT}")
        return cls([Rule.from_dict(r) for r in d.get("rules", ())],
                   name=str(d.get("name", "")), axes=d.get("axes"),
                   format_version=fmt or RULES_FORMAT)

    @classmethod
    def from_json(cls, s: str) -> "RuleSet":
        return cls.from_dict(json.loads(s))

    # -- misc ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.rules)

    def __eq__(self, other) -> bool:
        return (isinstance(other, RuleSet) and self.rules == other.rules
                and self.name == other.name and self.axes == other.axes)

    def __repr__(self) -> str:
        return (f"RuleSet(name={self.name!r}, rules={len(self.rules)}, "
                f"axes={sorted(self.axes) if self.axes else None})")


def spec_tree_axis_sizes(topology=None) -> Dict[str, int]:
    """``axis -> size`` for the active (or given) topology — the validation
    argument :meth:`RuleSet.match` wants."""
    if topology is None:
        from ..parallel.topology import get_topology
        topology = get_topology()
    from ..parallel.topology import ALL_AXES

    return {a: int(topology.axis_size(a)) for a in ALL_AXES}
