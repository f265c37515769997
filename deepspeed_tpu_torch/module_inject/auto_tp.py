"""Tensor-parallel specs of a checkpoint's leaves, by name.

Port of the part of ``deepspeed_tpu/module_inject/auto_tp.py`` that the
state-dict factory (``checkpoint/state_dict_factory.py``) uses: the tree
flattening with ``"/"``-joined paths, the reference's name vocabulary
(``_ROW_PATTERNS`` / ``_COL_PATTERNS`` / ...: reference ``auto_tp.py``
``tp_parser``) and the host-side slicing of one leaf to a tp rank's shard.

A spec is the plain tuple that ``runtime/zero/sharding.py`` uses, the JAX
``PartitionSpec``'s entries: one entry per dim, ``None``, an axis name or a
tuple of names; ``()`` replicates. Trees are nested dicts (and lists or
tuples) flattened as the JAX package flattens them: dict keys in sorted
order, ``None`` an empty node.

``tp_parser(params, tp_size=)`` is what the training engine's
``param_specs="auto"`` runs at tp > 1. The JAX package also classifies
weights by walking the model's traced jaxpr (``infer_tp_roles``,
``tp_parser(apply_fn=...)``); the port has no traced graph, so both raise
``NotImplementedError`` naming ROADMAP.md Queue A item 9 (analysis).
"""

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Reference name vocabulary (``auto_tp.py:303-351`` tp_parser): layers whose
# *output* is summed into the residual stream -> row-parallel. Everything
# else that is a matmul weight defaults to column-parallel.
_ROW_PATTERNS = (
    "o_proj", "out_proj", "down_proj", "dense_4h_to_h", "attention/dense",
    "attn/dense", "self_attention/dense", "fc2", "c_proj", "wo",
    "proj_out", "dense_out",
)
_COL_PATTERNS = (
    "q_proj", "k_proj", "v_proj", "query", "key", "value", "qkv",
    "gate_proj", "up_proj", "dense_h_to_4h", "fc1", "c_fc", "c_attn",
    "wi", "w1", "w3", "query_key_value",
)
_EMBED_PATTERNS = ("embed", "embedding", "embeddings", "wte",
                   "word_embeddings", "lm_head", "embed_out")
_NORM_PATTERNS = ("norm", "ln", "layernorm", "ln_f", "ln_1", "ln_2")

_TP_PATH = ("needs a traced graph of the model, which the port does not have yet: "
            "ROADMAP.md Queue A item 9 (analysis/*, module_inject/auto_tp.py's jaxpr "
            "analysis)")


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e)) for e in x)


@dataclasses.dataclass
class AutoTPResult:
    """Per-leaf outcome of the analysis.

    role: 'col' | 'row' | 'embed' | 'replicated'
    shard_dim: which dim of the leaf to shard (None for replicated)
    source: 'jaxpr' | 'name' -- which analysis decided it
    """
    role: str
    shard_dim: Optional[int]
    source: str

    def spec(self, ndim: int, axis: str = "tp") -> Tuple:
        dims: List[Optional[str]] = [None] * ndim
        if self.shard_dim is not None:
            dims[self.shard_dim] = axis
        return tuple(dims)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

class _Node:
    """One node of a flattened tree's structure: ``kind`` is ``dict``,
    ``list``, ``tuple``, ``None`` (an empty node) or ``leaf``."""
    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind, keys=(), children=()):
        self.kind, self.keys, self.children = kind, keys, children


def flatten_with_paths(tree) -> Tuple[List[str], List[Any], _Node]:
    """Flatten a tree to ('/'-joined path, leaf) with its structure (the
    ``treedef`` that :func:`unflatten` takes). A list or tuple entry's path
    component is ``[i]``, as the JAX package writes it."""
    return _flatten(tree)


def _flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None
             ) -> Tuple[List[str], List[Any], _Node]:
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, keys):
        if is_leaf is not None and is_leaf(node):
            paths.append("/".join(keys))
            leaves.append(node)
            return _Node("leaf")
        if node is None:
            return _Node(None)
        if isinstance(node, dict):
            ks = sorted(node)
            return _Node("dict", ks, [walk(node[k], keys + [str(k)]) for k in ks])
        if isinstance(node, (list, tuple)):
            kids = [walk(v, keys + [f"[{i}]"]) for i, v in enumerate(node)]
            return _Node(type(node).__name__, (), kids)
        paths.append("/".join(keys))
        leaves.append(node)
        return _Node("leaf")

    return paths, leaves, walk(tree, [])


def unflatten(treedef: _Node, leaves: Sequence[Any]):
    """The tree of ``treedef`` (from :func:`flatten_with_paths`) with
    ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(node):
        if node.kind == "leaf":
            return next(it)
        if node.kind is None:
            return None
        if node.kind == "dict":
            return {k: build(c) for k, c in zip(node.keys, node.children)}
        kids = [build(c) for c in node.children]
        return tuple(kids) if node.kind == "tuple" else kids

    return build(treedef)


def spec_leaves(specs) -> List[Tuple]:
    """The specs of a spec tree, in the flattening order of the tree they
    describe."""
    return _flatten(specs, is_leaf=_is_spec)[1]


def infer_tp_roles(apply_fn, params, *example_inputs) -> Dict[str, Tuple[str, int]]:
    """The JAX package classifies weights from the model's traced jaxpr;
    the port has no traced program to walk."""
    raise NotImplementedError("infer_tp_roles " + _TP_PATH)


# ---------------------------------------------------------------------------
# Name heuristics (the reference tp_parser vocabulary)
# ---------------------------------------------------------------------------


def _matches(patterns: Sequence[str], text: str) -> bool:
    """Pattern hit only at name-component boundaries ([/_.-] or ends), so
    e.g. 'wo' does not fire inside 'word_embeddings'. A '/' inside a pattern
    matches either path separator ('attention/dense' hits the dotted
    megatron-style 'h.0.attention.dense' too)."""
    return any(re.search(rf"(^|[/_.\-]){re.escape(p).replace('/', '[/.]')}([/_.\-]|$)",
                         text)
               for p in patterns)


def _spec_by_name(path: str, ndim: int) -> AutoTPResult:
    low = path.lower()
    if _matches(_NORM_PATTERNS, low) and ndim <= 1:
        return AutoTPResult("replicated", None, "name")
    if ndim >= 2:
        if _matches(_ROW_PATTERNS, low):
            return AutoTPResult("row", 0, "name")
        if _matches(_COL_PATTERNS, low):
            return AutoTPResult("col", ndim - 1, "name")
        if _matches(_EMBED_PATTERNS, low):
            return AutoTPResult("embed", ndim - 1, "name")
        return AutoTPResult("replicated", None, "name")
    if ndim == 1:
        # bias shards with a column-parallel owner, replicates with row.
        parent = low.rsplit("/", 1)[0] if "/" in low else low
        if _matches(_ROW_PATTERNS, parent):
            return AutoTPResult("replicated", None, "name")
        if _matches(_COL_PATTERNS + _EMBED_PATTERNS, parent):
            return AutoTPResult("col", 0, "name")
    return AutoTPResult("replicated", None, "name")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def tp_parser(params, apply_fn=None, example_inputs: Sequence[Any] = (),
              axis: str = "tp", tp_size: Optional[int] = None):
    """A spec tree for ``params`` from the leaves' names (the reference
    behaviour). ``tp_size`` (if given) replicates a leaf whose sharded dim
    it does not divide. ``apply_fn`` (the JAX package's jaxpr analysis)
    raises ``NotImplementedError``."""
    if apply_fn is not None:
        raise NotImplementedError("tp_parser(apply_fn=...) " + _TP_PATH)
    paths, leaves, treedef = flatten_with_paths(params)
    specs = []
    for path, leaf in zip(paths, leaves):
        shape = np.shape(leaf)
        res = _spec_by_name(path, len(shape))
        if tp_size and res.shard_dim is not None and shape[res.shard_dim] % tp_size != 0:
            res = AutoTPResult("replicated", None, res.source)
        specs.append(res.spec(len(shape), axis))
    return unflatten(treedef, specs)


def sharded_dim(spec: Tuple, axis: str):
    """First dim of ``spec`` sharded over ``axis`` (handles tuple axis
    entries), or None."""
    for dim, name in enumerate(spec):
        names = (name,) if isinstance(name, str) else (name or ())
        if axis in names:
            return dim
    return None


def shard_checkpoint_leaf(value, spec: Tuple, axis: str,
                          axis_index: int, axis_size: int):
    """Slice one checkpoint leaf (a numpy array or a tensor) to this tp
    rank's contiguous shard (reference ``ReplaceWithTensorSlicing.copy``).
    On the host a whole checkpoint never has to fit on the device; the
    training engine slices its parameters with it too."""
    if axis_size == 1:
        return value
    dim = sharded_dim(spec, axis)
    if dim is None:
        return value
    if value.shape[dim] % axis_size:
        raise ValueError(
            f"dim {dim} of shape {value.shape} not divisible by "
            f"tp={axis_size}")
    step = value.shape[dim] // axis_size
    idx = [slice(None)] * value.ndim
    idx[dim] = slice(axis_index * step, (axis_index + 1) * step)
    out = value[tuple(idx)]
    return np.ascontiguousarray(out) if isinstance(value, np.ndarray) else out.contiguous()
