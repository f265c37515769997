"""Rank processes of the port's gloo-world tests (imports torch and the port
only, never JAX).

    python tests/torch_dist_worker.py SCENARIO RANK WORLD WORKDIR

Each rank joins a gloo world through a ``FileStore`` under ``WORKDIR``
(no ports, so parallel test workers cannot collide), runs ``SCENARIO`` on
the inputs the test wrote to ``WORKDIR/inputs.pt`` and writes its results
to ``WORKDIR/out_RANK.pt``. :func:`run_world` starts the ranks and waits for
them under a time limit, so a hang fails the test instead of stalling it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def run_world(scenario: str, world: int, workdir, inputs: dict, timeout: float = 120.0):
    """Run ``scenario`` in a gloo world of ``world`` processes; returns the
    ranks' results in rank order. Raises with the ranks' output when one
    fails or the world outlives ``timeout`` seconds."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    logs = [open(workdir / f"log_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, scenario, str(r), str(world),
                               str(workdir)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        text = []
        for r, f in enumerate(logs):
            f.seek(0)
            text.append(f"--- rank {r} (exit {codes[r]}) ---\n{f.read()[-4000:]}")
        raise RuntimeError(f"{scenario} world of {world} failed:\n" + "\n".join(text))
    for f in logs:
        f.close()
    return [torch.load(workdir / f"out_{r}.pt", weights_only=False) for r in range(world)]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def scenario_comm(rank, world, inputs, workdir):
    """Every collective of the comm layer on this rank's slice of seeded
    inputs; the test recomputes each with numpy."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import get_topology
    from deepspeed_tpu_torch.utils import groups

    x = torch.from_numpy(inputs["x"][rank])            # [2 world, 3]
    out = {"rank": comm.get_rank(), "world": comm.get_world_size(),
           "initialized": comm.is_initialized()}
    ledger = comm.get_comms_logger()
    ledger.configure(enabled=True, prof_all=True)
    ledger.reset()
    for op in ("sum", "mean", "max", "min"):
        out[f"all_reduce_{op}"] = _np(comm.all_reduce(x.clone(), op=op))
    out["all_gather_0"] = _np(comm.all_gather(x))
    out["all_gather_1"] = _np(comm.all_gather(x, gather_dim=1))
    out["all_gather_untiled"] = _np(comm.all_gather(x, tiled=False, gather_dim=1))
    out["all_gather_into_tensor"] = _np(comm.all_gather_into_tensor(x))
    out["reduce_scatter_sum"] = _np(comm.reduce_scatter(x))
    out["reduce_scatter_mean"] = _np(comm.reduce_scatter(x.t().contiguous(), scatter_dim=1,
                                                         op="mean"))
    out["reduce_scatter_tensor"] = _np(comm.reduce_scatter_tensor(x))
    out["all_to_all"] = _np(comm.all_to_all(x, split_dim=0, concat_dim=1))
    out["all_to_all_single"] = _np(comm.all_to_all_single(x))
    out["all_to_all_untiled"] = _np(comm.all_to_all(x.reshape(world, 2, 3), split_dim=0,
                                                    concat_dim=1, tiled=False))
    out["broadcast"] = _np(comm.broadcast(x.clone(), src=world - 1))
    out["host_data"] = comm.broadcast_host_data({"from": rank, "tag": "x"}, src=1)
    out["axis_all_reduce"] = _np(comm.all_reduce(x.clone(), ("dp_outer", "ep"), op="sum"))
    out["axis_index"] = comm.axis_index(("dp_outer", "ep"))
    sub = comm.new_group([0, 1])
    out["group_sum"] = (_np(comm.all_reduce(x.clone(), sub)) if rank < 2 else None)
    out["group_size"] = comm.get_world_size(sub) if rank < 2 else None
    comm.barrier()
    out["ledger"] = ledger.totals()
    ledger.configure(enabled=False)
    topo = get_topology()
    out["topology"] = (topo.dp_size, topo.axis_size(*topo.dp_axes), topo.dp_axes,
                       groups._get_data_parallel_world_size(),
                       groups._get_data_parallel_rank(),
                       comm.get_world_size(groups._get_data_parallel_group()),
                       comm.get_world_size(topo.dp_group))
    raised = []
    for fn in (lambda: comm.ppermute(x, "pp", [(0, 1)]),
               groups._get_model_parallel_group, groups._get_sequence_parallel_group):
        try:
            fn()
        except NotImplementedError as e:
            raised.append("ROADMAP" in str(e))
    out["raised"] = raised
    return out


def scenario_comm_rooted(rank, world, inputs, workdir):
    """The rooted, coalesced and subset collectives and the barrier with a
    timeout on this rank's slice of seeded inputs; the test holds them
    against the JAX package's under ``shard_map``."""
    from deepspeed_tpu_torch import comm

    x = torch.from_numpy(inputs["x"][rank])            # [2 world, 3]
    n = torch.from_numpy(inputs["n"][rank])            # int32 [world]
    ledger = comm.get_comms_logger()
    ledger.configure(enabled=True, prof_all=True)
    ledger.reset()
    out = {"reduce_sum": _np(comm.reduce(x.clone(), dst=world - 1)),
           "reduce_max": _np(comm.reduce(x.clone(), dst=0, op="max")),
           "reduce_mean": _np(comm.reduce(x.clone(), dst=1, op="mean")),
           "gather_0": _np(comm.gather(x, dst=1)),
           "gather_1": _np(comm.gather(x, dst=0, gather_dim=1)),
           "scatter_0": _np(comm.scatter(x, src=world - 1)),
           "scatter_1": _np(comm.scatter(x.t().contiguous(), src=0, scatter_dim=1))}
    bucket = {"a": x.clone(), "b": [2 * x.clone(), n.clone()]}
    red = comm.all_reduce_coalesced(bucket)
    out["coalesced_reduce"] = [_np(red["a"]), _np(red["b"][0]), _np(red["b"][1])]
    gat = comm.all_gather_coalesced({"a": x, "b": [n]}, gather_dim=0)
    out["coalesced_gather"] = [_np(gat["a"]), _np(gat["b"][0])]
    group = comm.MeshGroup(None, [0, world - 1], world)
    for op in ("sum", "mean", "max", "min"):
        out[f"group_{op}"] = _np(comm.group_all_reduce(x.clone(), op=op, group=group))
    out["group_int_max"] = _np(comm.group_all_reduce(n.clone(), op="max", group=group))
    out["inference_all_reduce"] = _np(comm.inference_all_reduce(x.clone()))
    comm.monitored_barrier(timeout=60)
    out["ledger"] = ledger.totals()
    ledger.configure(enabled=False)
    return out


def scenario_compressed(rank, world, inputs, workdir):
    """The compressed collectives on this rank's inputs."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.compression.onebit import ErrorFeedbackState
    from deepspeed_tpu_torch.comm.compressed import (allreduce_feedback_init,
                                                     quantized_all_gather,
                                                     quantized_all_reduce,
                                                     quantized_reduce_scatter)

    ledger = comm.get_comms_logger()
    ledger.configure(enabled=True, prof_all=True)
    out = {}
    for name, xs in inputs["cases"].items():
        x = torch.from_numpy(xs[rank])
        block = inputs["block"]
        ledger.reset()
        out[f"{name}/all_reduce"] = _np(quantized_all_reduce(x, block=block))
        out[f"{name}/all_reduce_ledger"] = ledger.totals()["quantized_all_reduce"]
        out[f"{name}/all_gather"] = _np(quantized_all_gather(x, block=block))
        out[f"{name}/reduce_scatter"] = _np(quantized_reduce_scatter(x, block=block))
        out[f"{name}/ledger"] = ledger.totals()
        # one feedback step from each of the reference's states, and the
        # port's own chain of residuals
        steps = []
        for we, se in inputs["feedback_states"][name]:
            fb = ErrorFeedbackState(torch.from_numpy(we[rank]), torch.from_numpy(se[rank]))
            o, nfb = quantized_all_reduce(x, block=block, feedback=fb)
            steps.append((_np(o), _np(nfb.worker_error), _np(nfb.server_error)))
        out[f"{name}/feedback_steps"] = steps
        fb = allreduce_feedback_init(tuple(x.shape), world, device="cpu")
        chain = []
        for _ in range(inputs["feedback_chain"]):
            o, fb = quantized_all_reduce(x, block=block, feedback=fb)
            chain.append(_np(o))
        out[f"{name}/feedback_chain"] = (np.stack(chain), _np(fb.worker_error))
    x = torch.from_numpy(inputs["sr"][rank])
    draws = [_np(quantized_all_reduce(x, block=inputs["block"], stochastic=True,
                                      generator=torch.Generator().manual_seed(i)))
             for i in range(inputs["sr_draws"])]
    out["sr"] = np.stack(draws)
    ledger.configure(enabled=False)
    return out


def _engine(inputs, overrides=None, training_data=None, device="cpu"):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import convert
    from deepspeed_tpu_torch.models import transformer as ttf

    cfg = ttf.TransformerConfig(**inputs["model"], dtype=torch.float32)
    params = convert.params_from_jax(inputs["params"], cfg, device=device)
    config = dict(inputs["config"], **(overrides or {}))
    return tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, params)),
                          model_parameters=params, config=config,
                          training_data=training_data, device=device)


def _masters(eng):
    return [_np(p).copy() for p in eng._masters]


def scenario_train(rank, world, inputs, workdir):
    """Data-parallel training of one tiny model: the exact reduction, the
    ``mode: none`` section, int8 and int8_sr, the imperative path, the gates,
    and a checkpoint save at world size 2 resumed bitwise."""
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    batches = [torch.from_numpy(b) for b in inputs["batches"]]
    out = {}

    def run(name, overrides=None):
        eng, *_ = _engine(inputs, overrides)
        out[name] = [float(eng.train_batch(b)) for b in batches]
        out[name + "/masters"] = _masters(eng)
        out[name + "/mode"] = eng._dp_grad_mode
        out[name + "/grad_norm"] = eng.get_global_grad_norm()
        reset_fastpath()
        return eng

    run("exact")
    eng, *_ = _engine(inputs)
    eng.train_batch(batches[0])
    out["exact_1step/masters"] = _masters(eng)
    reset_fastpath()
    run("none", {"compressed_collectives": {"mode": "none"}})
    for mode in ("int8", "int8_sr"):
        run(mode, {"compressed_collectives": {"mode": mode, "block": inputs["cc_block"]}})
    run("fp16_int8", {"compressed_collectives": "int8", "fp16": {"enabled": True}})

    # the imperative path, compressed and exact: each micro-batch reduced
    gas = inputs["config"]["gradient_accumulation_steps"]
    for name, over in (("imperative_exact", None),
                       ("imperative_int8", {"compressed_collectives": {
                           "mode": "int8", "block": inputs["cc_block"]}})):
        eng, *_ = _engine(inputs, over)
        losses = []
        for b in batches:
            for mb in b.reshape(gas, -1, b.shape[-1]):
                losses.append(eng.forward(mb))
                eng.backward()
                eng.step()
        out[name] = losses
        out[name + "/masters"] = _masters(eng)
        reset_fastpath()
    # no_sync defers the reduction to the last micro-batch of the window
    eng, *_ = _engine(inputs)
    b = batches[0].reshape(gas, -1, batches[0].shape[-1])
    with eng.no_sync():
        eng.forward(b[0])
        eng.backward()
    eng.forward(b[1])
    eng.backward()
    eng.step()
    out["no_sync/masters"] = _masters(eng)
    reset_fastpath()

    # the distributed loader feeds each rank its share of the global batch
    eng, _, dl, _ = _engine(inputs, training_data=list(inputs["dataset"]))
    it = iter(RepeatingLoader(dl))
    out["loader"] = [float(eng.train_batch(data_iter=it)) for _ in range(2)]
    out["loader/masters"] = _masters(eng)
    out["loader/len"] = len(dl)
    reset_fastpath()

    # gates
    gates = {}
    for name, over in (("stage1", {"zero_optimization": {"stage": 1}}),
                       ("hierarchical", {"compressed_collectives": {"mode": "int8",
                                                                    "hierarchical": True}})):
        try:
            _engine(inputs, over)
            gates[name] = "accepted"
        except NotImplementedError as e:
            gates[name] = str(e)
        reset_fastpath()
    out["gates"] = gates

    # save at world size 2 after 2 steps, a fresh engine resumes bitwise
    ckpt = os.path.join(workdir, "ckpt")
    sr = {"compressed_collectives": {"mode": "int8_sr", "block": inputs["cc_block"]}}
    first, *_ = _engine(inputs, sr)
    got = [float(first.train_batch(b)) for b in batches[:2]]
    first.save_checkpoint(ckpt, client_state={"step": 2})
    saved = _masters(first)
    resumed, *_ = _engine(inputs, sr)
    _, client = resumed.load_checkpoint(ckpt)
    out["ckpt/loaded_equal"] = all(np.array_equal(a, b) for a, b in
                                   zip(_masters(resumed), saved))
    out["ckpt/client"] = client
    got += [float(resumed.train_batch(b)) for b in batches[2:]]
    out["ckpt/losses"] = got
    out["ckpt/masters"] = _masters(resumed)
    out["ckpt/files"] = sorted(os.listdir(ckpt))
    reset_fastpath()
    return out


def scenario_cuda_step(rank, world, inputs, workdir):
    """Two ranks sharing cuda:0 over gloo: one int8-compressed step (the
    quant kernels run in both ranks)."""
    from deepspeed_tpu_torch.ops import quant

    eng, *_ = _engine(inputs, {"compressed_collectives": {"mode": "int8", "block": 512}},
                      device="cuda")
    quant.reset_launch_counts()
    loss = float(eng.train_batch(torch.from_numpy(inputs["batches"][0]).cuda()))
    return {"loss": loss, "masters": _masters(eng), "launches": dict(quant.launch_counts),
            "mode": eng._dp_grad_mode}


SCENARIOS = {"comm": scenario_comm, "comm_rooted": scenario_comm_rooted,
             "compressed": scenario_compressed,
             "train": scenario_train, "cuda_step": scenario_cuda_step}


def main():
    scenario, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    comm.init_distributed("gloo", init_method=f"file://{workdir}/store", rank=rank,
                          world_size=world, timeout=90)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = SCENARIOS[scenario](rank, world, inputs, workdir)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    comm.barrier()
    comm.destroy_process_group()


if __name__ == "__main__":
    main()
