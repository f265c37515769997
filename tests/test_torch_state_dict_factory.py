"""The port's state-dict factory and AutoTP name rules against the JAX
package's, bitwise, on the same seeded numpy trees.

Every public function of ``deepspeed_tpu_torch.checkpoint.state_dict_factory``
(``split_qkv`` / ``merge_qkv`` in both fused-QKV layouts,
``merge_state_dicts`` / ``split_state_dict``, ``megatron_specs`` with its
``strict`` refusal, ``save_shard_npz`` with the replicated-paths sidecar,
``SDLoaderFactory`` / ``SDLoader.load``) and of
``deepspeed_tpu_torch.module_inject.auto_tp`` (``flatten_with_paths``,
``tp_parser`` by name, ``sharded_dim``, ``shard_checkpoint_leaf``) gives
the JAX package's output exactly: the same paths, the same dtypes and the
same bits, a JAX ``PartitionSpec`` and the port's spec tuple the same
entries. The Megatron state dicts are the JAX exporter's
(``params_to_megatron``) of a tiny model at Megatron checkpoint versions 0,
1 and 2 (2 layers, hidden 48, 4 heads), written as 2 tp shards and loaded
at mp 1, 2 and 4. Everything here runs on numpy on the host.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.checkpoint import state_dict_factory as jsdf
from deepspeed_tpu.inference import megatron as jmeg
from deepspeed_tpu.module_inject import auto_tp as jtp
from deepspeed_tpu_torch.checkpoint import state_dict_factory as tsdf
from deepspeed_tpu_torch.module_inject import auto_tp as ttp

HEADS, HIDDEN = 4, 48
ARGS = {"vocab_size": 96, "hidden_size": HIDDEN, "ffn_hidden_size": 96, "num_layers": 2,
        "num_attention_heads": HEADS, "max_position_embeddings": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    """(path, leaf) pairs of a tree, through the port's flattening."""
    paths, leaves, _ = ttp.flatten_with_paths(tree)
    return list(zip(paths, leaves))


def _same(got, want):
    """Two trees of arrays: the same paths and every leaf bitwise equal."""
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def _same_specs(got, want):
    """A port spec tree against a JAX one: the same specs leaf for leaf."""
    assert ttp.spec_leaves(got) == [tuple(s) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, P))]


def flax_tree(seed=0):
    """A flax-layout tree (the JAX factory test's shapes, hidden 8, fused
    c_attn of 4 heads of 2), with a list node and a ``None``."""
    rng = np.random.RandomState(seed)
    d, qkv = 8, 24
    return {
        "h0": {"attn": {"c_attn": {"kernel": rng.randn(d, qkv).astype(np.float32)},
                        "c_proj": {"kernel": rng.randn(d, d).astype(np.float32)}},
               "mlp": {"c_fc": {"kernel": rng.randn(d, 4 * d).astype(np.float32),
                                "bias": rng.randn(4 * d).astype(np.float32)},
                       "c_proj": {"kernel": rng.randn(4 * d, d).astype(np.float32),
                                  "bias": rng.randn(d).astype(np.float32)}},
               "ln_1": {"scale": rng.randn(d).astype(np.float32)}},
        "wte": {"embedding": rng.randn(32, d).astype(np.float32)},
        "extra": [rng.randn(3).astype(np.float32), None],
    }


@pytest.fixture(scope="module")
def megatron_sds():
    """The JAX exporter's Megatron state dict of one seeded tiny model at
    checkpoint versions 0, 1 and 2."""
    from deepspeed_tpu.models.transformer import TransformerLM, init_params

    cfg = dataclasses.replace(jmeg.megatron_config(ARGS), dtype=jnp.float32)
    params = jax.tree.map(np.asarray, init_params(TransformerLM(cfg), seed=3, seq=16))
    return {v: jmeg.params_to_megatron(params, cfg, version=v) for v in (0, 1, 2)}


def test_flatten_and_unflatten_match_jax():
    tree = flax_tree()
    paths, leaves, treedef = ttp.flatten_with_paths(tree)
    jpaths, jleaves, _ = jtp.flatten_with_paths(tree)
    assert paths == jpaths
    assert all(a is b for a, b in zip(leaves, jleaves))
    back = ttp.unflatten(treedef, leaves)
    assert back["extra"][1] is None
    _same(back, tree)


@pytest.mark.parametrize("tp_size", [None, 2, 3])
def test_tp_parser_by_name_matches_jax(tp_size):
    tree = flax_tree()
    _same_specs(ttp.tp_parser(tree, tp_size=tp_size), jtp.tp_parser(tree, tp_size=tp_size))
    for path in ("h.0.self_attention.dense.weight".replace(".", "/"), "wte/embedding",
                 "h0/ln_1/scale", "h0/mlp/c_fc/bias", "h0/mlp/c_proj/bias", "w1", "x"):
        for nd in (1, 2, 3):
            assert (dataclasses.astuple(ttp._spec_by_name(path, nd))
                    == dataclasses.astuple(jtp._spec_by_name(path, nd)))
    assert ttp._matches(ttp._ROW_PATTERNS, "transformer.h.0.attention.dense.weight")
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        ttp.tp_parser(tree, apply_fn=lambda p, x: x)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        ttp.infer_tp_roles(lambda p, x: x, tree)


@pytest.mark.parametrize("spec", [(), ("tp",), (None, "tp"), (("dp", "tp"), None),
                                  (None, None, "sp")])
def test_sharded_dim_and_shard_leaf_match_jax(spec):
    value = np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)
    assert ttp.sharded_dim(spec, "tp") == jtp.sharded_dim(P(*spec), "tp")
    for rank in range(2):
        got = ttp.shard_checkpoint_leaf(value, spec, "tp", rank, 2)
        want = jtp.shard_checkpoint_leaf(value, P(*spec), "tp", rank, 2)
        assert got.shape == want.shape and np.array_equal(got, want)
    with pytest.raises(ValueError):
        ttp.shard_checkpoint_leaf(value[:3], ("tp",), "tp", 0, 2)


@pytest.mark.parametrize("layout", ["concat", "interleaved"])
@pytest.mark.parametrize("dim", [0, -1])
def test_split_and_merge_qkv_match_jax(layout, dim):
    rng = np.random.RandomState(1)
    w = rng.randn(24, 8).astype(np.float32) if dim == 0 else rng.randn(8, 24).astype(np.float32)
    for size in (1, 2, 4):
        shards = []
        for rank in range(size):
            got = tsdf.split_qkv(w, rank, size, num_heads=HEADS, layout=layout, dim=dim)
            want = jsdf.split_qkv(w, rank, size, num_heads=HEADS, layout=layout, dim=dim)
            assert got.shape == want.shape and np.array_equal(got, want)
            shards.append(got)
        merged = tsdf.merge_qkv(shards, layout=layout, dim=dim)
        assert np.array_equal(merged, jsdf.merge_qkv(shards, layout=layout, dim=dim))
        assert np.array_equal(merged, w)
    for fn in (tsdf.split_qkv, jsdf.split_qkv):
        with pytest.raises(ValueError):
            fn(w, 0, 3, num_heads=HEADS, layout=layout, dim=dim)     # 4 heads over 3
        with pytest.raises(ValueError):
            fn(w, 0, 2, num_heads=HEADS, layout="blocks", dim=dim)


def test_megatron_specs_match_jax(megatron_sds):
    for sd in megatron_sds.values():
        _same_specs(tsdf.megatron_specs(sd), jsdf.megatron_specs(sd))
    nested = {"transformer": {"layers": {"0": {"attention": {
        "dense": {"weight": np.zeros((8, 8), np.float32), "bias": np.zeros(8, np.float32)}}}}},
        "lm_head": {"bias": np.zeros(32, np.float32)}}
    _same_specs(tsdf.megatron_specs(nested, axis="mp"), jsdf.megatron_specs(nested, axis="mp"))
    tree = {"mystery_weight": np.zeros((4, 4), np.float32)}
    for fn in (tsdf.megatron_specs, jsdf.megatron_specs):
        with pytest.raises(ValueError, match="unmatched 2-D leaf"):
            fn(tree)
    _same_specs(tsdf.megatron_specs(tree, strict=False),
                jsdf.megatron_specs(tree, strict=False))


def _qkv_leaves(sd, layout):
    return {k: layout for k in sd if "query_key_value" in k}


@pytest.mark.parametrize("version", [0, 1, 2])
def test_split_and_merge_state_dicts_match_jax(megatron_sds, version):
    sd = megatron_sds[version]
    layout = "concat" if version == 0 else "interleaved"
    tspecs, jspecs = tsdf.megatron_specs(sd), jsdf.megatron_specs(sd)
    for size in (2, 4):
        tshards, jshards = [], []
        for rank in range(size):
            got, grep = tsdf.split_state_dict(sd, rank, size, tspecs,
                                              qkv_leaves=_qkv_leaves(sd, layout),
                                              num_heads=HEADS, return_replicated=True)
            want, wrep = jsdf.split_state_dict(sd, rank, size, jspecs,
                                               qkv_leaves=_qkv_leaves(sd, layout),
                                               num_heads=HEADS, return_replicated=True)
            _same(got, want)
            assert grep == wrep
            tshards.append(got)
            jshards.append(want)
        for repl in (None, grep):
            merged = tsdf.merge_state_dicts(tshards, tspecs, qkv_leaves=_qkv_leaves(sd, layout),
                                            replicated_paths=repl)
            _same(merged, jsdf.merge_state_dicts(jshards, jspecs,
                                                 qkv_leaves=_qkv_leaves(sd, layout),
                                                 replicated_paths=repl))
            _same(merged, sd)
    with pytest.raises(ValueError, match="num_heads"):
        tsdf.split_state_dict(sd, 0, 2, tspecs, qkv_leaves=_qkv_leaves(sd, layout))
    with pytest.raises(ValueError, match="no shards"):
        tsdf.merge_state_dicts([])


def test_name_inferred_specs_merge_and_split_as_jax():
    """No spec tree: both packages take the flax name rules (``tp_parser``)
    for the split and the merge, and the content heuristic for replicas."""
    tree = {k: v for k, v in flax_tree(2).items() if k != "extra"}
    shards = [tsdf.split_state_dict(tree, r, 2) for r in range(2)]
    for r in range(2):
        _same(shards[r], jsdf.split_state_dict(tree, r, 2))
    merged = tsdf.merge_state_dicts(shards)
    _same(merged, jsdf.merge_state_dicts(shards))
    _same(merged, tree)
    # a constant leaf sharded on an indivisible shard dim: the heuristic's
    # documented ambiguity, the same in both packages
    const = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
             "kv_bias": np.zeros((2, 4), np.float32)}
    specs = {"w": ("tp",), "kv_bias": ("tp",)}
    jspecs = {"w": P("tp"), "kv_bias": P("tp")}
    parts = [tsdf.split_state_dict(const, r, 2, specs) for r in range(2)]
    got = tsdf.merge_state_dicts(parts, specs)
    _same(got, jsdf.merge_state_dicts(parts, jspecs))
    assert got["kv_bias"].shape == (1, 4)


@pytest.mark.parametrize("version", [0, 1, 2])
def test_sd_loader_matches_jax_at_mp_1_2_and_4(megatron_sds, version, tmp_path):
    """Two shards written by ``save_shard_npz`` (with the sidecar) and held
    in memory, loaded at mp 1 (merge), 2 (as saved) and 4 (split)."""
    sd = megatron_sds[version]
    layout = "concat" if version == 0 else "interleaved"
    specs = tsdf.megatron_specs(sd)
    shards, files = [], []
    for r in range(2):
        shard, repl = tsdf.split_state_dict(sd, r, 2, specs, num_heads=HEADS,
                                            qkv_leaves=_qkv_leaves(sd, layout),
                                            return_replicated=True)
        path = str(tmp_path / f"mp_rank_{r:02d}.npz")
        tsdf.save_shard_npz(path, shard, replicated_paths=repl)
        jpath = str(tmp_path / f"jax_rank_{r:02d}.npz")
        jsdf.save_shard_npz(jpath, shard, replicated_paths=repl)
        with np.load(path) as a, np.load(jpath) as b:
            assert a.files == b.files
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
        shards.append(shard)
        files.append(path)
    for ckpt in (shards, files):
        for mp in (1, 2, 4):
            for rank in range(mp):
                got = tsdf.SDLoaderFactory.get_sd_loader(
                    ckpt, version=version, num_heads=HEADS, layout="megatron").load(mp, rank)
                want = jsdf.SDLoaderFactory.get_sd_loader(
                    ckpt, version=version, num_heads=HEADS, layout="megatron").load(mp, rank)
                _same(got, want)
                if mp == 1:
                    flat = dict(_flat(got))
                    assert set(flat) == set(sd)
                    assert all(np.array_equal(flat[k], sd[k]) for k in sd)
    for fn in (tsdf.SDLoaderFactory.get_sd_loader, jsdf.SDLoaderFactory.get_sd_loader):
        with pytest.raises(ValueError, match="sd_type"):
            fn(shards, sd_type="hf")
    loader = tsdf.SDLoader(shards, version=version, num_heads=HEADS, layout="megatron")
    with pytest.raises(ValueError, match="cannot split"):
        loader.load(3, 0)
    assert loader.qkv_layout == layout


def test_replicated_sidecar_decides_the_merge_as_in_jax(tmp_path):
    """The sidecar (even empty) is authoritative: a constant sharded leaf
    merges to its full shape with it and to the shard's without it, in both
    packages."""
    full = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
            "kv_bias": np.zeros((2, 4), np.float32)}
    specs = {"w": ("tp",), "kv_bias": ("tp",)}
    jspecs = {"w": P("tp"), "kv_bias": P("tp")}
    with_car, bare = [], []
    for r in range(2):
        shard, repl = tsdf.split_state_dict(full, r, 2, specs, return_replicated=True)
        assert repl == frozenset()
        with_car.append(str(tmp_path / f"s{r}.npz"))
        tsdf.save_shard_npz(with_car[-1], shard, replicated_paths=repl)
        bare.append(str(tmp_path / f"b{r}.npz"))
        tsdf.save_shard_npz(bare[-1], shard)
    for files, shape in ((with_car, (2, 4)), (bare, (1, 4))):
        got = tsdf.SDLoader(files, specs=specs).load(1, 0)
        _same(got, jsdf.SDLoader(files, specs=jspecs).load(1, 0))
        assert got["kv_bias"].shape == shape
        np.testing.assert_array_equal(got["w"], full["w"])
