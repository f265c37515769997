"""The port's comm layer over ``torch.distributed``, on the CPU.

Gloo worlds of 2 and 4 processes (``tests/torch_dist_worker.py``, torch
only) run every collective of ``deepspeed_tpu_torch.comm`` on seeded
per-rank inputs; each result is recomputed here with numpy: all-reduce
sum, mean (a sum and a divide: gloo has no AVG), max and min, all-gather
tiled along dims 0 and 1 and untiled, reduce-scatter sum and mean,
all-to-all tiled and untiled, broadcast, ``broadcast_host_data``, a
``new_group`` subset, collectives over the topology's dp axis names, the
comms ledger, and the topology's dp axis and groups. In one process: every
collective is the identity at world size 1 without a process group, and
``init_distributed`` at world size 1 with a ``file://`` rendezvous.
"""

import numpy as np
import pytest
import torch

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
        Topology(TopologySpec(tp=2))
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
    finally:
        comm.destroy_process_group()
    assert not comm.is_initialized()
