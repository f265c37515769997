"""Checkpoint save/load: the port of ``deepspeed_tpu/checkpoint/engine.py``.

Reference: engine ``save_checkpoint``/``load_checkpoint``
(``runtime/engine.py:3140,2794``). The JAX package's pluggable
``CheckpointEngine`` base has one backend here, ``TorchCheckpointEngine``.

The layout is the JAX package's, with ``torch.save`` in place of orbax:

  ``<save_dir>/<tag>/state/state.pt``  the training state tree: the fp32
                                      master weights, the optimizer state
                                      (every leaf of the optimizer's state
                                      tree; a frozen leaf has none), the step
                                      (which is the LR schedule's position),
                                      the engine's rng stream position and
                                      the loss-scale state, on the host
  ``<save_dir>/<tag>/host_optimizer.pt``  under ZeRO-Offload's host-Adam
                                      tier: the host optimizer's step, fp32
                                      masters and moments (the JAX package's
                                      ``host_optimizer.npz``); the state tree
                                      then holds the compute-dtype params
  ``<save_dir>/<tag>/metadata.json``  config snapshot, topology, client_state,
                                      data sampler; the commit marker
  ``<save_dir>/latest``               the most recent tag

The stored tensors are always the whole state, laid out as at stage 0, so
a tag does not depend on the ZeRO stage or the world size it was saved at
(as the JAX package's orbax tags hold global arrays) and ``zero_to_fp32`` is
a read. Over several data-parallel ranks rank 0 writes the tag, every rank
waits at a barrier until it is committed, and every rank loads the same
files; at ZeRO stages 1-3 every rank first takes part in gathering the
masters and the optimizer state to full tensors, leaf by leaf, onto rank 0's
host, and on load every rank keeps its part of each. Loading copies into
the engine's existing master and moment tensors IN PLACE: the fused Adam
kernel caches its device table on their pointers. Checkpoints written by
the JAX package (orbax directories) are not read.
"""

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..utils.fs import fsync_write_json, fsync_write_text
from ..utils.logging import log_dist, logger

STATE_FILE = "state.pt"
HOST_OPTIMIZER_FILE = "host_optimizer.pt"


def _to_host(tree):
    """A host copy of every tensor in ``tree`` (the training state keeps
    changing in place after the save returns)."""
    return pytree.tree_map(
        lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, tree)


class CheckpointEngine:
    """Pluggable storage backend (reference ``CheckpointEngine`` ABC; the
    JAX package's base class)."""

    def save(self, tree: Any, path: str):
        raise NotImplementedError

    def load(self, path: str, template: Any = None, shardings: Any = None) -> Any:
        raise NotImplementedError

    def wait(self):
        pass


class TorchCheckpointEngine(CheckpointEngine):
    """Default engine (reference ``TorchCheckpointEngine``): ``torch.save``
    of the state tree. The tree is copied to the host before ``save``
    returns; with ``use_async`` the file is written by a background thread,
    which ``wait`` joins (and re-raises its error)."""

    def __init__(self, use_async: bool = False):
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree: Any, path: str):
        self.wait()
        os.makedirs(path, exist_ok=True)
        host = _to_host(tree)
        target = os.path.join(path, STATE_FILE)

        def write():
            try:
                tmp = target + ".tmp"
                with open(tmp, "wb") as f:
                    torch.save(host, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, target)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        if self.use_async:
            self._thread = threading.Thread(target=write, daemon=False)
            self._thread.start()
        else:
            write()
            self.wait()

    def load(self, path: str, template: Any = None, shardings: Any = None) -> Any:
        """The saved tree (``torch.load`` keeps its structure, so
        ``template`` is not needed). ``shardings``: a tree of the same
        structure whose leaves are specs (tuples of axis names per dim, e.g.
        ``(None, "tp")``; None or ``()`` keeps a leaf whole): each leaf is
        sliced to this rank's part along each axis of the live topology
        (JAX: the restore lays the global arrays out on the new shardings,
        so a tag written at one topology loads under any other)."""
        tree = self._read(path)
        if shardings is None:
            return tree
        from ..module_inject.auto_tp import _flatten, _is_spec, unflatten

        spaths, specs, _ = _flatten(shardings, is_leaf=lambda x: x is None or _is_spec(x))
        paths, leaves, treedef = _flatten(tree)
        by_path = dict(zip(spaths, specs))
        return unflatten(treedef, [_slice_to_rank(x, by_path.get(p)) for p, x in
                                   zip(paths, leaves)])

    def _read(self, path: str) -> Any:
        target = os.path.join(path, STATE_FILE)
        if not os.path.exists(target):
            what = ("an orbax directory (a JAX package checkpoint), which the port "
                    "does not read" if os.path.isdir(path) else "missing")
            raise FileNotFoundError(f"checkpoint state {target}: {what}")
        return torch.load(target, map_location="cpu", weights_only=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


# In-flight async commit threads, keyed by abspath(save_dir): a reader —
# possibly a different engine pointed at the same directory, as in
# restart-recovery — must be able to rendezvous with it.
_PENDING_COMMITS: Dict[str, threading.Thread] = {}
_PENDING_LOCK = threading.Lock()


def _slice_to_rank(x, spec):
    """This rank's part of ``x`` under ``spec`` (axis names per dim,
    resolved on the live topology): each split dim narrowed to the rank's
    contiguous block."""
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    from .. import comm
    from ..parallel.topology import get_topology

    topo = get_topology()
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        size = topo.axis_size(*names)
        if size == 1:
            continue
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split over "
                             f"{names} of size {size}")
        n = x.shape[dim] // size
        x = x.narrow(dim, comm.axis_index(names) * n, n)
    return x.contiguous()


def wait_pending_commits(ckpt_dir: str) -> None:
    """Join any in-flight async checkpoint commit targeting ``ckpt_dir``."""
    with _PENDING_LOCK:
        t = _PENDING_COMMITS.get(os.path.abspath(ckpt_dir))
    if t is not None and t is not threading.current_thread() and t.is_alive():
        t.join()


def _is_committed(ckpt_dir: str, tag: str) -> bool:
    # metadata.json doubles as the commit marker: it is written atomically
    # AFTER the state write lands, so its presence certifies the tag
    return os.path.exists(os.path.join(ckpt_dir, str(tag), "metadata.json"))


def read_latest_tag(ckpt_dir: str) -> Optional[str]:
    """The newest COMMITTED tag the ``latest`` pointer names. A pointed tag
    missing its commit marker (a torn write) is skipped in favor of the
    newest committed tag of the ``latest`` lineage; no pointer at all means
    None."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    wait_pending_commits(ckpt_dir)
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        tag = f.read().strip()
    if not tag:
        return None
    if _is_committed(ckpt_dir, tag):
        return tag
    candidates = []
    for name in os.listdir(ckpt_dir):
        meta = os.path.join(ckpt_dir, name, "metadata.json")
        if os.path.isdir(os.path.join(ckpt_dir, name)) and os.path.exists(meta):
            try:
                with open(meta) as f:
                    in_lineage = json.load(f).get("save_latest", True)
            except (OSError, json.JSONDecodeError):
                continue  # its own commit is damaged; not a fallback target
            if in_lineage:
                candidates.append((os.path.getmtime(meta), name))
    if not candidates:
        logger.warning(
            f"checkpoint tag {tag!r} in {ckpt_dir} has no commit marker "
            "(torn write?) and no earlier committed tag exists")
        return None
    newest = max(candidates)[1]
    logger.warning(
        f"checkpoint tag {tag!r} in {ckpt_dir} has no commit marker "
        f"(torn write?) — falling back to committed tag {newest!r}")
    return newest


def _state_to_tree(engine, keep) -> Dict[str, Any]:
    """The state in the stage-0 layout. At ZeRO stages 1-3 over several
    ranks, and over tp > 1, this gathers (every rank calls it) and passes
    each gathered tensor through ``keep``."""
    s = engine.state
    ls = s.loss_scale
    params, opt_state = s.params, s.opt_state
    if engine._zero is not None:
        params = engine._tree([keep(engine._full_param(i))
                               for i in range(len(engine._zero.shapes))])
        opt_state = engine._full_opt_state(keep)
    elif engine._tp_dims is not None:
        # tp > 1: every split leaf (and its optimizer state) gathered whole
        params = engine._tree([keep(engine._full_param(i))
                               for i in range(len(engine._masters))])
        leaves, spec = pytree.tree_flatten(opt_state)
        opt_state = pytree.tree_unflatten(
            [x if i is None else keep(engine._tp_gather(i, x))
             for x, i in zip(leaves, engine._state_owners(opt_state))], spec)
    return {"step": int(s.step), "rng_draws": engine._rng_draws, "params": params,
            "opt_state": {"leaves": pytree.tree_leaves(opt_state)},
            "loss_scale": {"scale": float(ls.scale), "good_steps": int(ls.good_steps),
                           "hysteresis": int(ls.hysteresis)}}


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None, save_latest: bool = True):
    """Reference ``engine.save_checkpoint:3140``: returns the tag's path."""
    from .. import comm

    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    save_dir = os.path.abspath(save_dir)
    path = os.path.join(save_dir, str(tag))
    writer = comm.get_rank() == 0
    # ZeRO 1-3: the full tensors go to rank 0's host, one leaf at a time
    keep = (lambda t: t.detach().to("cpu", copy=True)) if writer else (lambda t: None)
    tree = _state_to_tree(engine, keep)
    if not writer:
        comm.barrier("save_checkpoint")   # rank 0 has committed the tag
        return path
    ck = _get_ckpt_engine(engine)
    wait_pending_commits(save_dir)
    ck.save(tree, os.path.join(path, "state"))
    if engine._host_adam is not None:
        # the host optimizer's state lives outside the state tree; it is
        # written before save returns, since the next step changes it in place
        target = os.path.join(path, HOST_OPTIMIZER_FILE)
        with open(target + ".tmp", "wb") as f:
            torch.save(engine._host_adam.state_dict(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(target + ".tmp", target)
    meta = {
        "tag": str(tag),
        # recorded so the torn-pointer fallback can tell pointer-lineage
        # checkpoints from side saves the user never designated as latest
        "save_latest": bool(save_latest),
        "global_steps": engine.global_steps,
        "skipped_steps": engine.skipped_steps,
        "config": engine.config.to_dict(),
        "topology": {"pp": 1, "dp": engine.dp_world, "ep": 1, "sp": 1,
                     "tp": engine.topo.tp_size},
        "client_state": client_state or {},
    }
    sampler = getattr(engine, "data_sampler", None)
    if sampler is not None:
        meta["data_sampler"] = sampler.state_dict()

    def _commit():
        # 'latest' only ever points at a durable checkpoint: the state file
        # lands first, then metadata.json (the commit marker), then the
        # pointer, each written to a temp file, fsynced and renamed
        ck.wait()
        fsync_write_json(os.path.join(path, "metadata.json"), meta, indent=2, default=str)
        if save_latest:
            fsync_write_text(os.path.join(save_dir, "latest"), str(tag))
        log_dist(f"saved checkpoint {path}")

    if getattr(ck, "use_async", False):
        t = threading.Thread(target=_commit, daemon=False)
        with _PENDING_LOCK:
            _PENDING_COMMITS[save_dir] = t
        t.start()
    else:
        _commit()
    if comm.get_world_size() > 1:
        # the other ranks may read the tag once they pass the barrier
        wait_pending_commits(save_dir)
        comm.barrier("save_checkpoint")
    return path


def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if dst.shape != src.shape:
        raise ValueError(f"checkpoint {what}: shape {tuple(src.shape)} does not match "
                         f"the engine's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True, load_lr_scheduler_states: bool = True,
                    load_module_only: bool = False):
    """Reference ``engine.load_checkpoint:2794``: returns ``(path,
    client_state)``, or ``(None, {})`` when there is no ``latest``. The
    masters (and, unless ``load_module_only`` or not
    ``load_optimizer_states``, the optimizer state, step and loss scale) are
    copied into the engine's tensors in place. The LR schedule's position is
    the step, so ``load_lr_scheduler_states`` is accepted and the LR follows
    the loaded step, as in the JAX package."""
    load_dir = os.path.abspath(load_dir)
    wait_pending_commits(load_dir)
    if tag is None:
        tag = read_latest_tag(load_dir)
        if tag is None:
            logger.warning(f"no 'latest' file in {load_dir}; nothing loaded")
            return None, {}
    path = os.path.join(load_dir, str(tag))
    tree = _get_ckpt_engine(engine).load(os.path.join(path, "state"))

    saved, saved_spec = pytree.tree_flatten(tree["params"])
    if saved_spec != engine._spec:
        raise ValueError(f"checkpoint {path}: its parameter tree does not match the "
                         "engine's")
    if engine._zero is not None or engine._tp_dims is not None:
        for i, src in enumerate(saved):
            engine._set_full_param(i, src)
    else:
        for i, (dst, src) in enumerate(zip(engine._masters, saved)):
            _copy_into(dst, src, f"parameter {i}")
    if not (load_module_only or not load_optimizer_states):
        leaves = tree["opt_state"]["leaves"]
        if engine._zero is not None:
            engine._load_opt_state(leaves)
        else:
            cur, spec = pytree.tree_flatten(engine.state.opt_state)
            if len(leaves) != len(cur):
                raise ValueError(f"checkpoint {path}: optimizer state has {len(leaves)} "
                                 f"leaves, the engine's {len(cur)}")
            if engine._tp_dims is not None:
                owners = engine._state_owners(engine.state.opt_state)
                leaves = [src if o is None else engine._tp_slice(o, src)
                          for src, o in zip(leaves, owners)]
            new = []
            for i, (dst, src) in enumerate(zip(cur, leaves)):
                if isinstance(dst, torch.Tensor):
                    _copy_into(dst, src, f"optimizer leaf {i}")
                    new.append(dst)
                else:
                    new.append(src)
            engine.state.opt_state = pytree.tree_unflatten(new, spec)
        engine.state.step = int(tree["step"])
        engine._rng_draws = int(tree.get("rng_draws", 0))
        from ..runtime.loss_scaler import LossScaleState

        engine.state.loss_scale = LossScaleState(**tree["loss_scale"])
    if engine._host_adam is not None:
        host_file = os.path.join(path, HOST_OPTIMIZER_FILE)
        if not (load_module_only or not load_optimizer_states) and os.path.exists(host_file):
            engine._host_adam.load_state_dict(torch.load(host_file, map_location="cpu",
                                                         weights_only=True))
        else:
            # no host state here (a params-only load, or saved without
            # offload): the masters follow the loaded params, or the next
            # step would overwrite them with stale ones
            logger.warning("host optimizer state not restored — re-seeding fp32 masters "
                           "from the loaded params")
            engine._host_adam.reseed_masters(tree["params"])
    engine.zero_grad()   # gradients accumulated before the load are stale

    meta_path = os.path.join(path, "metadata.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    engine.global_steps = meta.get("global_steps", int(tree["step"]))
    engine.skipped_steps = meta.get("skipped_steps", 0)
    sampler = getattr(engine, "data_sampler", None)
    if sampler is not None:
        if meta.get("data_sampler"):
            sampler.load_state_dict(meta["data_sampler"])
        else:
            logger.warning("checkpoint has no data_sampler state — the loader "
                           "restarts from its first batch")
    log_dist(f"loaded checkpoint {path} (saved at topology {meta.get('topology')})")
    return path, meta.get("client_state", {})


def _get_ckpt_engine(engine) -> TorchCheckpointEngine:
    if getattr(engine, "_ckpt_engine", None) is None:
        engine._ckpt_engine = TorchCheckpointEngine(
            use_async=engine.config.checkpoint.async_save)
    return engine._ckpt_engine


# ---------------------------------------------------------------------------
# Offline tools
# ---------------------------------------------------------------------------


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def zero_to_fp32(checkpoint_dir: str, output_file: Optional[str] = None,
                 tag: Optional[str] = None):
    """Consolidate a checkpoint into a flat fp32 dict of numpy arrays keyed
    by parameter path (``"layer_0/attn/q_proj/kernel"``), written as an
    ``.npz`` when ``output_file`` is given (reference
    ``utils/zero_to_fp32.py``; at world size 1 this is a read)."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    if tag is None:
        tag = read_latest_tag(checkpoint_dir)
        if tag is None:
            raise FileNotFoundError(f"no 'latest' file in {checkpoint_dir}")
    tree = TorchCheckpointEngine().load(os.path.join(checkpoint_dir, str(tag), "state"))
    params = tree["params"]
    host_file = os.path.join(checkpoint_dir, str(tag), HOST_OPTIMIZER_FILE)
    if os.path.exists(host_file):
        # ZeRO-Offload: the fp32 masters live with the host optimizer
        params = torch.load(host_file, map_location="cpu", weights_only=True)["master"]
    flat = {k: v.float().numpy() for k, v in _flat_paths(params).items()}
    if output_file:
        np.savez(output_file, **flat)
        logger.info(f"wrote {len(flat)} fp32 tensors to {output_file}")
    return flat


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str, tag: Optional[str] = None):
    """Reference ``get_fp32_state_dict_from_zero_checkpoint`` API."""
    return zero_to_fp32(checkpoint_dir, output_file=None, tag=tag)
