"""The port's comm layer over ``torch.distributed``, on the CPU.

Gloo worlds of 2 and 4 processes (``tests/torch_dist_worker.py``, torch
only) run every collective of ``deepspeed_tpu_torch.comm`` on seeded
per-rank inputs; each result is recomputed here with numpy: all-reduce
sum, mean (a sum and a divide: gloo has no AVG), max and min, all-gather
tiled along dims 0 and 1 and untiled, reduce-scatter sum and mean,
all-to-all tiled and untiled, broadcast, ``broadcast_host_data``, a
``new_group`` subset, collectives over the topology's dp axis names, the
comms ledger, and the topology's dp axis and groups. The rooted (``reduce``,
``gather``, ``scatter``), coalesced and subset (``group_all_reduce`` over a
``MeshGroup``) collectives run in the same worlds and are held against the
JAX package's, run under ``shard_map`` over as many CPU devices on the same
inputs. In one process: every collective is the identity at world size 1
without a process group, and ``init_distributed`` at world size 1 with a
``file://`` rendezvous.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import deepspeed_tpu.comm.comm as jcomm

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import Topology, TopologySpec, get_topology

from .torch_dist_worker import run_world


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    w = request.param
    x = np.random.default_rng(w).standard_normal((w, 2 * w, 3)).astype(np.float32)
    outs = run_world("comm", w, tmp_path_factory.mktemp(f"comm{w}"), {"x": x}, timeout=90)
    return w, x, outs


def test_all_reduce_ops(world):
    w, x, outs = world
    for r, out in enumerate(outs):
        assert (out["rank"], out["world"], out["initialized"]) == (r, w, True)
        np.testing.assert_allclose(out["all_reduce_sum"], x.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["all_reduce_mean"], x.mean(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["all_reduce_max"], x.max(0))
        np.testing.assert_array_equal(out["all_reduce_min"], x.min(0))
        np.testing.assert_allclose(out["axis_all_reduce"], x.sum(0), rtol=1e-6, atol=1e-6)
        assert out["axis_index"] == r


def test_all_gather_and_broadcast(world):
    w, x, outs = world
    for out in outs:
        np.testing.assert_array_equal(out["all_gather_0"], np.concatenate(x, axis=0))
        np.testing.assert_array_equal(out["all_gather_into_tensor"], np.concatenate(x, axis=0))
        np.testing.assert_array_equal(out["all_gather_1"], np.concatenate(x, axis=1))
        np.testing.assert_array_equal(out["all_gather_untiled"], np.stack(x, axis=1))
        np.testing.assert_array_equal(out["broadcast"], x[w - 1])
        assert out["host_data"] == {"from": 1, "tag": "x"}


def test_reduce_scatter(world):
    w, x, outs = world
    total = x.sum(0)
    for r, out in enumerate(outs):
        tile = total[2 * r:2 * r + 2]
        np.testing.assert_allclose(out["reduce_scatter_sum"], tile, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["reduce_scatter_tensor"], tile, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["reduce_scatter_mean"], (tile / w).T, rtol=1e-6,
                                   atol=1e-6)


def test_all_to_all(world):
    w, x, outs = world
    for r, out in enumerate(outs):
        tiles = [x[i][2 * r:2 * r + 2] for i in range(w)]
        np.testing.assert_array_equal(out["all_to_all"], np.concatenate(tiles, axis=1))
        np.testing.assert_array_equal(out["all_to_all_single"], np.concatenate(tiles, axis=0))
        want = np.stack([x[i].reshape(w, 2, 3)[r] for i in range(w)], axis=1)
        np.testing.assert_array_equal(out["all_to_all_untiled"], want)


def test_new_group_ledger_and_topology(world):
    w, x, outs = world
    for r, out in enumerate(outs):
        if r < 2:
            np.testing.assert_allclose(out["group_sum"], x[0] + x[1], rtol=1e-6)
            assert out["group_size"] == 2
        assert out["topology"] == (w, w, ("dp_outer", "ep"), w, r, w, w)
        assert out["raised"] == [True, True, True]
        assert out["model_parallel"] == ("tp", 1)
        np.testing.assert_array_equal(out["send_next"], x[(r - 1) % w])
        np.testing.assert_array_equal(out["send_prev"], x[(r + 1) % w])
        np.testing.assert_array_equal(out["ppermute_partial"],
                                      x[0] if r == 1 else np.zeros_like(x[0]))
        ledger = out["ledger"]
        n_reduce = 5 + (r < 2)
        assert ledger["all_reduce"]["count"] == n_reduce
        assert ledger["all_reduce"]["bytes"] == n_reduce * x[0].nbytes
        assert ledger["all_reduce"]["wire_bytes"] == ledger["all_reduce"]["bytes"]
        assert ledger["all_gather"]["count"] == 4
        assert ledger["all_to_all"]["count"] == 3
        assert ledger["reduce_scatter"]["count"] == 3
        assert ledger["broadcast"]["count"] == 1 and ledger["barrier"]["count"] == 1


def test_world_of_one_needs_no_process_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    comm.init_distributed()
    assert not comm.is_initialized()
    assert comm.get_world_size() == comm.get_world_size(("dp_outer", "ep")) == 1
    assert comm.get_rank() == comm.axis_index() == 0
    x = torch.arange(6.0).reshape(2, 3)
    assert comm.all_reduce(x.clone(), op="mean").equal(x)
    assert comm.all_gather(x).equal(x)
    assert comm.all_gather(x, tiled=False).equal(x[None])
    assert comm.reduce_scatter(x).equal(x)
    assert comm.all_to_all_single(x).equal(x)
    assert comm.broadcast(x.clone()).equal(x)
    assert comm.broadcast_host_data({"a": 1}) == {"a": 1}
    comm.barrier()
    topo = get_topology()
    assert (topo.dp_size, topo.dp_group) == (1, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Topology(TopologySpec(sp=2))
    with pytest.raises(ValueError, match="not divisible"):
        Topology(TopologySpec(tp=2))        # a tp axis of 2 needs two ranks
    np.testing.assert_array_equal(comm.send_next_recv_prev(x, "tp"), x)
    with pytest.raises(ValueError):
        comm.all_reduce(torch.arange(3), op="mean")


def test_init_distributed_world_one_rendezvous(tmp_path):
    comm.init_distributed(dist_backend="gloo", init_method=f"file://{tmp_path}/store",
                          rank=0, world_size=1, timeout=30)
    try:
        assert comm.is_initialized() and comm.get_world_size() == 1
        x = torch.ones(4)
        assert comm.all_reduce(x).equal(torch.ones(4))
        comm.init_distributed()     # already up: a no-op
        mesh = comm.initialize_mesh_device((1, 1), ("a", "b"))
        assert mesh.mesh_dim_names == ("a", "b") and tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="holds 2 ranks"):
            comm.initialize_mesh_device((2,), ("a",))
    finally:
        comm.destroy_process_group()
    assert not comm.is_initialized()


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def rooted(request, tmp_path_factory):
    w = request.param
    rng = np.random.default_rng(10 + w)
    x = rng.standard_normal((w, 2 * w, 3)).astype(np.float32)
    n = rng.integers(-50, 50, (w, w)).astype(np.int32)
    outs = run_world("comm_rooted", w, tmp_path_factory.mktemp(f"rooted{w}"),
                     {"x": x, "n": n}, timeout=90)
    return w, x, n, outs


def _jax_per_rank(w, fn, *args):
    """``fn`` on each of ``w`` CPU devices under ``shard_map`` over the axis
    "dp", rank r holding ``args[i][r]``; the ranks' outputs stacked."""
    mesh = Mesh(np.array(jax.devices()[:w]), ("dp",))
    flat = [jnp.asarray(a.reshape((-1,) + a.shape[2:])) for a in args]
    out = shard_map(fn, mesh=mesh, in_specs=(P("dp"),) * len(flat), out_specs=P("dp"),
                    check_rep=False)(*flat)
    return jax.tree.map(lambda o: np.asarray(o).reshape((w, -1) + o.shape[1:]), out)


def test_rooted_collectives_match_jax(rooted):
    w, x, n, outs = rooted
    want = _jax_per_rank(w, lambda x: {
        "reduce_sum": jcomm.reduce(x, "dp", dst=w - 1),
        "reduce_max": jcomm.reduce(x, "dp", dst=0, op="max"),
        "reduce_mean": jcomm.reduce(x, "dp", dst=1, op="mean"),
        "gather_0": jcomm.gather(x, "dp", dst=1),
        "gather_1": jcomm.gather(x, "dp", dst=0, gather_dim=1),
        "scatter_0": jcomm.scatter(x, "dp", src=w - 1),
        "scatter_1": jcomm.scatter(x.T, "dp", src=0, scatter_dim=1)}, x)
    for r, out in enumerate(outs):
        for key in ("reduce_sum", "reduce_max", "reduce_mean", "gather_0", "gather_1",
                    "scatter_0"):
            np.testing.assert_allclose(out[key], want[key][r], rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        # the JAX function slices dim 1 of x^T [3, 2w] per rank: [3, 2]
        np.testing.assert_array_equal(out["scatter_1"], want["scatter_1"][r].reshape(3, 2))
        ledger = out["ledger"]
        assert (ledger["reduce"]["count"], ledger["gather"]["count"],
                ledger["scatter"]["count"], ledger["barrier"]["count"]) == (3, 2, 2, 1)


def test_coalesced_and_group_collectives_match_jax(rooted):
    w, x, n, outs = rooted
    group = jcomm.MeshGroup("dp", [0, w - 1], w)

    def body(x, n):
        red = jcomm.all_reduce_coalesced({"a": x, "b": [2 * x, n]}, "dp")
        gat = jcomm.all_gather_coalesced({"a": x, "b": [n]}, "dp")
        out = {"red": red, "gat": gat,
               "inference_all_reduce": jcomm.inference_all_reduce(x, "dp"),
               "group_int_max": jcomm.group_all_reduce(n, "dp", "max", group)}
        for op in ("sum", "mean", "max", "min"):
            out[f"group_{op}"] = jcomm.group_all_reduce(x, "dp", op, group)
        return out

    want = _jax_per_rank(w, body, x, n[:, None, :])
    for r, out in enumerate(outs):
        got_red, got_gat = out["coalesced_reduce"], out["coalesced_gather"]
        for got, ref in zip(got_red, (want["red"]["a"][r], want["red"]["b"][0][r],
                                      want["red"]["b"][1][r])):
            np.testing.assert_allclose(got, ref.reshape(got.shape), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_gat[0], want["gat"]["a"][r])
        np.testing.assert_array_equal(got_gat[1], want["gat"]["b"][0][r].reshape(-1))
        for key in ("inference_all_reduce", "group_sum", "group_mean", "group_max",
                    "group_min"):
            np.testing.assert_allclose(out[key], want[key][r], rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        np.testing.assert_array_equal(out["group_int_max"], want["group_int_max"][r][0])
        if 0 < r < w - 1:               # not a member: its own x, untouched
            np.testing.assert_array_equal(out["group_sum"], x[r])
        # one ledger entry per coalesced tensor, as the JAX package logs them
        assert out["ledger"]["all_reduce"]["count"] == 3 + 4 + 1 + 1
        assert out["ledger"]["all_gather"]["count"] == 2


def test_world_of_one_rooted_and_mesh(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE", raising=False)
    x = torch.arange(6.0).reshape(2, 3)
    assert comm.reduce(x.clone()).equal(x) and comm.gather(x).equal(x)
    assert comm.scatter(x).equal(x)
    assert comm.group_all_reduce(x.clone(), group=comm.MeshGroup(None, [0], 1)).equal(x)
    assert comm.all_reduce_coalesced([x.clone()])[0].equal(x)
    comm.monitored_barrier(timeout=5)
    assert comm.mpi_discovery() == jcomm.mpi_discovery() == (0, 1)
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    assert comm.mpi_discovery() == jcomm.mpi_discovery() == (3, 4)
    monkeypatch.delenv("OMPI_COMM_WORLD_RANK")
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    with pytest.raises(RuntimeError, match="init_distributed"):
        comm.initialize_mesh_device((1, 1), ("a", "b"))
    with pytest.raises(ValueError, match="duplicate"):
        comm.MeshGroup(None, [0, 0], 2)
    with pytest.raises(ValueError, match="outside"):
        comm.MeshGroup(None, [2], 2)
    assert (list(inspect.signature(comm.init_distributed).parameters)
            == list(inspect.signature(jcomm.init_distributed).parameters))
