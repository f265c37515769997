"""``derive_rules``: the AutoTP bridge, name inference -> explicit rules.

Port of ``deepspeed_tpu/sharding/derive.py`` on the name path: the port's
``tp_parser`` classifies leaves by the reference's name vocabulary
(``module_inject/auto_tp.py``), and this bridge compresses its spec tree
into a named :class:`RuleSet` (numeric path segments widened to ``\\d+``,
conflicting leaves kept exact, each rule noted ``autotp:name``). The JAX
package's dataflow path (``apply_fn=`` with example inputs) walks a
traced jaxpr, which the port does not have: it raises naming ROADMAP.md
Queue A item 9 (analysis).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


from .rules import Rule, RuleSet

_NUM_SEG = re.compile(r"(?:(?<=[/_.])|^)\d+(?=[/_.]|$)")


def _generalize(path: str) -> str:
    """Anchored pattern with numeric segments widened: ``layer_0/attn`` →
    ``^layer_\\d+/attn$`` — the repeated-block compressor.  Widening runs
    on the raw path and escaping on the literal stretches between, so
    dotted raw-HF keys (``model.layers.0...``) generalize too."""
    out, last = [], 0
    for m in _NUM_SEG.finditer(path):
        out.append(re.escape(path[last:m.start()]))
        out.append(r"\d+")
        last = m.end()
    out.append(re.escape(path[last:]))
    return "^" + "".join(out) + "$"


def _exact(path: str) -> str:
    return "^" + re.escape(path) + "$"


def derive_rules(params, apply_fn=None, example_inputs: Tuple = (),
                 *, axis: str = "tp", tp_size: Optional[int] = None,
                 name: str = "autotp-derived") -> RuleSet:
    """Run AutoTP inference over ``params`` and return it as an explicit,
    serializable rule set (same signature vocabulary as ``tp_parser``)."""
    from ..module_inject.auto_tp import flatten_with_paths, spec_leaves, tp_parser

    if apply_fn is not None:
        raise NotImplementedError(
            "derive_rules(apply_fn=...) needs a traced graph of the model, which the "
            "port does not have yet: ROADMAP.md Queue A item 9 (analysis/*)")
    spec_tree = tp_parser(params, axis=axis, tp_size=tp_size)
    paths, leaves, _ = flatten_with_paths(params)
    flat_specs = spec_leaves(spec_tree)
    # group identical (generalized pattern, ndim) decisions
    groups: Dict[Tuple[str, int], List[Tuple[str, Tuple]]] = defaultdict(list)
    order: List[Tuple[str, int]] = []
    for path, leaf, spec in zip(paths, leaves, flat_specs):
        nd = len(getattr(leaf, "shape", ()))
        key = (_generalize(path), nd)
        if key not in groups:
            order.append(key)
        groups[key].append((path, tuple(spec)))

    rules: List[Rule] = []
    for key in order:
        pat, nd = key
        members = groups[key]
        src = "autotp:name"
        distinct = {s for _, s in members}
        if len(distinct) == 1:
            spec = members[0][1]
            if any(e is not None for e in spec):
                rules.append(Rule(pat, spec, ndim=nd, note=src))
        else:
            # same generalized shape class, different decisions (e.g. one
            # indivisible layer downgraded): keep each path exact
            for path, spec in members:
                if any(e is not None for e in spec):
                    rules.append(Rule(_exact(path), spec, ndim=nd, note=src))
    return RuleSet(rules, name=name, axes=(axis,))


def derived_matches_parser(params, ruleset: RuleSet, spec_tree) -> bool:
    """Bitwise equality check between a derived rule set's match and a
    reference spec tree (the acceptance predicate the tests assert)."""
    from ..module_inject.auto_tp import spec_leaves

    got = spec_leaves(ruleset.match(params))
    want = spec_leaves(spec_tree)
    return len(got) == len(want) and all(tuple(a) == tuple(b) for a, b in zip(got, want))
