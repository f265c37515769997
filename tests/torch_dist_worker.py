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


def _engine(inputs, overrides=None, training_data=None, device="cpu", model=None,
            frozen_params=None):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import convert
    from deepspeed_tpu_torch.models import transformer as ttf

    model = model or {}
    cfg = ttf.TransformerConfig(**dict(inputs["model"], **model.get("config", {})),
                                dtype=torch.float32)
    params = convert.params_from_jax(model.get("params", inputs["params"]), cfg,
                                     device=device)
    config = dict(inputs["config"], **(overrides or {}))
    return tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, params)),
                          model_parameters=params, config=config,
                          training_data=training_data, device=device,
                          frozen_params=frozen_params)


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

    _zero_stages(rank, inputs, workdir, batches, out)

    # gates
    gates = {}
    for name, over in (("mics", {"zero_optimization": {"stage": 3, "mics_shard_size": 2}}),
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


def _full_masters(eng):
    from deepspeed_tpu_torch.utils import safe_get_full_fp32_param

    return [_np(safe_get_full_fp32_param(eng, p)) for p in _paths(eng)]


def _paths(eng):
    """Every leaf's path in tree order ("layer_0/attn/q_proj/kernel")."""
    from torch.utils import _pytree as pytree

    paths, _ = pytree.tree_flatten_with_path(eng.state.params)
    return ["/".join(str(k.key) for k in kp) for kp, _ in paths]


def _full_moments(eng):
    from deepspeed_tpu_torch.utils import safe_get_full_optimizer_state

    return [_np(safe_get_full_optimizer_state(eng, p, k)) for k in ("exp_avg", "exp_avg_sq")
            for p in _paths(eng)]


def _zero_stages(rank, inputs, workdir, batches, out):
    """ZeRO stages 1-3 in the same world: training, the full masters read
    through ``safe_get_full_fp32_param``, the shard sizes, the imperative
    path and ``no_sync``, an fp16 overflow, the accessors, and a stage-3
    save resumed at stage 3 and at stage 0."""
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    gas = inputs["config"]["gradient_accumulation_steps"]
    zero = lambda stage, **kw: dict({"zero_optimization": {"stage": stage}}, **kw)
    for stage in (1, 2, 3):
        name = f"stage{stage}"
        eng, *_ = _engine(inputs, zero(stage))
        out[name] = [float(eng.train_batch(b)) for b in batches]
        out[name + "/full"] = _full_masters(eng)
        out[name + "/shapes"] = [tuple(p.shape) for p in eng._masters]
        m = eng.state.opt_state.exp_avg
        out[name + "/adam"] = [tuple(t.shape) for t in m]
        out[name + "/n"] = eng._zero.numel
        out[name + "/grad_norm"] = eng.get_global_grad_norm()
        units = eng._units
        out[name + "/grad_storage"] = {
            "full_buffer": eng._flat_grad is not None,
            "grads_on_masters": any(p.grad is not None for p in eng._masters),
            "shard_bytes": eng._shard_grad.numel() * eng._shard_grad.element_size(),
            "peak_buffer_bytes": None if units is None else units.peak_buffer_bytes,
            "largest_unit_bytes": None if units is None else max(
                (hi - lo) * 4 for _, _, _, lo, hi in units.units),
            "local": None if units is None else units.local is not None}
        reset_fastpath()
    # offload_optimizer cpu at world size 2: the storage tier (the JAX rule),
    # the stage-1 update on host-resident state
    eng, *_ = _engine(inputs, {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}})
    out["stage1_offload"] = [float(eng.train_batch(b)) for b in batches]
    out["stage1_offload/full"] = _full_masters(eng)
    out["stage1_offload/tier"] = [eng._host_adam is None, eng._offload_optimizer,
                                  [str(t.device) for t in eng.state.opt_state.exp_avg]]
    out["stage1_offload/moments"] = _full_moments(eng)
    reset_fastpath()
    # the imperative path (each micro-batch reduce-scattered) and no_sync
    for stage in (2, 3):
        eng, *_ = _engine(inputs, zero(stage))
        losses = []
        for b in batches:
            for mb in b.reshape(gas, -1, b.shape[-1]):
                losses.append(eng.forward(mb))
                eng.backward()
                eng.step()
        out[f"imperative_stage{stage}"] = losses
        out[f"imperative_stage{stage}/full"] = _full_masters(eng)
        reset_fastpath()
        eng, *_ = _engine(inputs, zero(stage))
        b = batches[0].reshape(gas, -1, batches[0].shape[-1])
        with eng.no_sync():
            eng.forward(b[0])
            eng.backward()
            try:
                tf.safe_get_full_grad(eng, "lm_head/kernel")
                out[f"no_sync_stage{stage}/pending"] = "read"
            except RuntimeError as e:
                out[f"no_sync_stage{stage}/pending"] = str(e)
        eng.forward(b[1])
        eng.backward()
        eng.step()
        out[f"no_sync_stage{stage}/full"] = _full_masters(eng)
        reset_fastpath()
    # an fp16 overflow (loss scale 2^32 against fp16's 65504): both ranks
    # skip the step and keep their masters
    eng, *_ = _engine(inputs, zero(3, fp16={"enabled": True, "initial_scale_power": 32}))
    before = _full_masters(eng)
    eng.train_batch(batches[0])
    out["fp16_stage3"] = {"skipped": eng.skipped_steps,
                          "kept": all(np.array_equal(a, b)
                                      for a, b in zip(before, _full_masters(eng))),
                          "scale": eng.loss_scale}
    reset_fastpath()

    # the accessors at stage 3 after the three steps, then inside an
    # imperative window on a fourth global micro-batch
    eng, *_ = _engine(inputs, zero(3))
    for b in batches:
        eng.train_batch(b)
    paths = inputs["paths"]
    acc = {"param": [_np(tf.safe_get_full_fp32_param(eng, p)) for p in paths],
           "local_param": [_np(tf.safe_get_local_fp32_param(eng, p)) for p in paths],
           "exp_avg": [_np(tf.safe_get_full_optimizer_state(eng, p, "exp_avg"))
                       for p in paths],
           "exp_avg_sq": [_np(tf.safe_get_full_optimizer_state(eng, p, "exp_avg_sq"))
                          for p in paths],
           "local_exp_avg": [_np(tf.safe_get_local_optimizer_state(eng, p, "exp_avg"))
                             for p in paths],
           "spans": [eng._zero.span(_paths(eng).index(p)) for p in paths],
           "grad_outside": tf.safe_get_full_grad(eng, paths[0])}
    eng.forward(torch.from_numpy(inputs["micro"]))
    eng.backward()
    acc["grad"] = [_np(tf.safe_get_full_grad(eng, p)) for p in paths]
    acc["local_grad"] = [_np(tf.safe_get_local_grad(eng, p)) for p in paths]
    # the setters: write, read back (full at every rank, local as fragments)
    # (full writes to paths[1], each rank's local writes to its fragment of
    # paths[0], which the ranks split)
    whole, split = paths[1], paths[0]
    shape = tuple(acc["param"][1].shape)
    tf.safe_set_full_fp32_param(eng, whole, torch.full(shape, 0.5))
    tf.safe_set_full_optimizer_state(eng, whole, torch.full(shape, 0.25), "exp_avg")
    tf.safe_set_full_grad(eng, whole, torch.full(shape, 2.0))
    frag = tf.safe_get_local_fp32_param(eng, split)
    tf.safe_set_local_fp32_param(eng, split, frag + 1.0)
    tf.safe_set_local_grad(eng, split, torch.zeros_like(frag))
    tf.safe_set_local_optimizer_state(eng, split, torch.ones_like(frag), "exp_avg_sq")
    acc["set"] = {"param": _np(tf.safe_get_full_fp32_param(eng, whole)),
                  "exp_avg": _np(tf.safe_get_full_optimizer_state(eng, whole, "exp_avg")),
                  "grad": _np(tf.safe_get_full_grad(eng, whole)),
                  "local_param": _np(tf.safe_get_full_fp32_param(eng, split)),
                  "local_grad": _np(tf.safe_get_full_grad(eng, split)),
                  "local_exp_avg_sq": _np(tf.safe_get_full_optimizer_state(
                      eng, split, "exp_avg_sq"))}
    out["accessors"] = acc
    reset_fastpath()
    # the same window at stage 2, whose units' gradients are reduced into
    # the shard accumulator as the backward makes them
    eng, *_ = _engine(inputs, zero(2))
    for b in batches:
        eng.train_batch(b)
    acc2 = {"param": [_np(tf.safe_get_full_fp32_param(eng, p)) for p in paths],
            "exp_avg": [_np(tf.safe_get_full_optimizer_state(eng, p, "exp_avg"))
                        for p in paths],
            "grad_outside": tf.safe_get_full_grad(eng, paths[0])}
    eng.forward(torch.from_numpy(inputs["micro"]))
    eng.backward()
    acc2["grad"] = [_np(tf.safe_get_full_grad(eng, p)) for p in paths]
    acc2["local_grad"] = [_np(tf.safe_get_local_grad(eng, p)) for p in paths]
    acc2["spans"] = [eng._zero.span(_paths(eng).index(p)) for p in paths]
    out["accessors2"] = acc2
    reset_fastpath()
    # the same window at stage 0, whose gradients sit in the reduced flat
    # accumulator
    eng, *_ = _engine(inputs)
    for b in batches:
        eng.train_batch(b)
    eng.forward(torch.from_numpy(inputs["micro"]))
    eng.backward()
    out["accessors0"] = {"param": [_np(tf.safe_get_full_fp32_param(eng, p)) for p in paths],
                         "grad": [_np(tf.safe_get_full_grad(eng, p)) for p in paths],
                         "local_grad": [_np(tf.safe_get_local_grad(eng, p)) for p in paths]}
    reset_fastpath()

    _stage3_units(inputs, workdir, batches, out)

    # a stage-3 save after two steps, resumed by fresh engines at stage 3
    # (bitwise against the uninterrupted run) and at stage 0
    ckpt = os.path.join(workdir, "ckpt3")
    first, *_ = _engine(inputs, zero(3))
    for b in batches[:2]:
        first.train_batch(b)
    first.save_checkpoint(ckpt, client_state={"stage": 3})
    saved = _full_masters(first)
    saved_m = _full_moments(first)
    for stage in (3, 0):
        eng, *_ = _engine(inputs, zero(stage))
        _, client = eng.load_checkpoint(ckpt)
        out[f"ckpt3_to{stage}"] = {
            "client": client,
            "loaded_equal": all(np.array_equal(a, b)
                                for a, b in zip(_full_masters(eng), saved)),
            "adam_equal": all(np.array_equal(a, b)
                              for a, b in zip(_full_moments(eng), saved_m)),
            "step": eng.state.step,
            "losses": [float(eng.train_batch(b)) for b in batches[2:]]}
        reset_fastpath()
    from deepspeed_tpu_torch.checkpoint.engine import zero_to_fp32

    flat = zero_to_fp32(ckpt)
    out["ckpt3/zero_to_fp32"] = all(np.array_equal(flat[p], a)
                                    for p, a in zip(_paths(first), saved))


def _mlp_loss(params, batch, rng=None):
    """A loss function that is not TransformerLM's: a two-layer MLP
    classifier on a nested tree (units ``hidden`` and ``out``)."""
    h = torch.tanh(batch["x"] @ params["hidden"]["w"] + params["hidden"]["b"])
    logits = h @ params["out"]["w"]
    return torch.nn.functional.cross_entropy(logits, batch["y"].long())


def _stage3_units(inputs, workdir, batches, out):
    """Stage 3's gather-on-use: the units gathered at once in the forward
    and the backward, with and without per-layer remat; per-layer remat
    under cpu_checkpointing against dots_saveable; a tied-embedding GPT-2
    family model at stages 0 and 3; a loss function that is not
    TransformerLM's at stages 0 and 3; the params offloaded to cpu and nvme
    and back between steps."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
    from deepspeed_tpu_torch.runtime import activation_checkpointing as tac

    zero = lambda stage: {"zero_optimization": {"stage": stage}}
    for name, model in (("units", None),
                        ("units_remat", {"config": {"remat": True}})):
        eng, *_ = _engine(inputs, zero(3), model=model)
        z = eng._z3
        out[name] = {"losses": [float(eng.train_batch(b)) for b in batches],
                     "peak_units": dict(z.peak_units), "peak_bytes": dict(z.peak_bytes),
                     "gathers": dict(z.gathers), "names": [u[0] for u in z.units],
                     "unit_bytes": list(z._nbytes), "live_after": z.live,
                     "storages": [s.size() for s in z._storages],
                     "whole_buffers": [hasattr(eng, "_gather_compute"),
                                       getattr(eng, "_g3", None) is not None,
                                       eng._flat_grad is not None]}
        reset_fastpath()
    # cpu_checkpointing (per-layer remat, no policy) against dots_saveable
    saved = tac.get_config()
    try:
        for name, policy, cpu in (("remat_dots", "dots_saveable", False),
                                  ("remat_cpu", None, True)):
            tac._config.update(policy=None, cpu_checkpointing=cpu)
            eng, *_ = _engine(inputs, zero(3), model={"config": {
                "remat": True, "remat_policy": policy}})
            out[name] = [float(eng.train_batch(b)) for b in batches]
            out[name + "/full"] = _full_masters(eng)
            reset_fastpath()
    finally:
        tac._config.update(saved)
    # a tied-embedding GPT-2 family model
    for stage in (0, 3):
        eng, *_ = _engine(inputs, zero(stage), model=inputs["gpt2"])
        out[f"gpt2_stage{stage}"] = [float(eng.train_batch(b)) for b in batches]
        out[f"gpt2_stage{stage}/full"] = _full_masters(eng)
        if stage == 3:
            out["gpt2_stage3/units"] = ([u[0] for u in eng._z3.units],
                                        dict(eng._z3.peak_units))
            out["gpt2/paths"] = _paths(eng)
        reset_fastpath()
    # a loss function that is not TransformerLM's
    mlp = inputs["mlp"]
    for stage in (0, 3):
        params = {k: {n: torch.from_numpy(v.copy()) for n, v in sub.items()}
                  for k, sub in mlp["params"].items()}
        config = dict(inputs["config"], **zero(stage))
        eng, *_ = tds.initialize(model=_mlp_loss, model_parameters=params, config=config,
                                 device="cpu")
        out[f"mlp_stage{stage}"] = [
            float(eng.train_batch({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}))
            for x, y in mlp["batches"]]
        out[f"mlp_stage{stage}/full"] = _full_masters(eng)
        if stage == 3:
            out["mlp_stage3/units"] = ([u[0] for u in eng._z3.units],
                                       dict(eng._z3.peak_units))
        reset_fastpath()
    # the params (this rank's shard) to cpu and nvme and back between steps
    for where in ("cpu", "nvme"):
        eng, *_ = _engine(inputs, zero(3))
        losses = [float(eng.train_batch(b)) for b in batches[:2]]
        before = [t.clone() for t in eng._masters]
        ids = [id(t) for t in eng._masters]
        eng.offload_states(include=("params",), device=where,
                           nvme_path=os.path.join(workdir, f"swap_{where}"))
        emptied = eng._master_shard.untyped_storage().size() == 0
        try:
            eng.train_batch(batches[2])
            refused = False
        except RuntimeError:
            refused = True
        eng.reload_states()
        out[f"params_{where}"] = {
            "emptied": emptied, "refused": refused,
            "same_objects": ids == [id(t) for t in eng._masters],
            "bitwise": all(torch.equal(a, b) for a, b in zip(eng._masters, before)),
            "losses": losses + [float(eng.train_batch(b)) for b in batches[2:]]}
        reset_fastpath()


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


def scenario_cuda_stage3(rank, world, inputs, workdir):
    """Two ranks sharing cuda:0 over gloo: stage 0, then stage 3 with and
    without per-layer remat, from the same weights on the same batches (the
    backward's gathers run on the autograd engine's device thread)."""
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath

    batches = [torch.from_numpy(b).cuda() for b in inputs["batches"]]
    out = {}
    for name, stage, model in (("stage0", 0, None), ("stage3", 3, None),
                               ("stage3_remat", 3, {"config": {"remat": True}})):
        eng, *_ = _engine(inputs, {"zero_optimization": {"stage": stage}}, device="cuda",
                          model=model)
        out[name] = [float(eng.train_batch(b)) for b in batches]
        if stage == 3:
            out[name + "/peaks"] = dict(eng._z3.peak_units)
            out[name + "/live_after"] = eng._z3.live
        reset_fastpath()
    return out


def scenario_zero_optimizers(rank, world, inputs, workdir):
    """LAMB, MuAdamW and frozen leaves at ZeRO stages 0-3 from the same
    weights on the same batches: the losses, the full masters, the
    frozen leaf, LAMB's trust ratios and the full first moments, the
    optimizer's fragments (empty ones and one across the rank boundary);
    a stage-2 LAMB run with a frozen leaf saved after two steps and resumed
    by a fresh engine."""
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath
    from deepspeed_tpu_torch.utils import (safe_get_full_optimizer_state,
                                           safe_set_full_optimizer_state)

    batches = [torch.from_numpy(b) for b in inputs["batches"]]
    out = {}
    for name, (optimizer, frozen) in inputs["runs"].items():
        for stage in (0, 1, 2, 3):
            eng, *_ = _engine(inputs, {"optimizer": optimizer,
                                       "zero_optimization": {"stage": stage}},
                              frozen_params=frozen)
            key = f"{name}/stage{stage}"
            out[key] = [float(eng.train_batch(b)) for b in batches]
            out["paths"] = _paths(eng)
            out[key + "/masters"] = _full_masters(eng)
            out[key + "/leafwise"] = eng._leafwise
            trust = getattr(eng.tx.update, "last_trust", None)
            out[key + "/trust"] = None if trust is None else _np(trust)
            out[key + "/exp_avg"] = [
                None if f else _np(safe_get_full_optimizer_state(eng, p, "exp_avg"))
                for p, f in zip(_paths(eng), eng._frozen)]
            if eng._zero is not None:
                out[key + "/spans"] = [eng._zero.span(i) for i in range(len(eng._frozen))]
                # a moment written in full and read back, on a leaf both
                # ranks hold part of
                part = eng._zero
                i = next(i for i in range(len(part.shapes))
                         if all(a < b for a, b in (part.span(i, r) for r in range(world))))
                value = torch.arange(part.numels[i], dtype=torch.float32).view(part.shapes[i])
                path = _paths(eng)[i]
                safe_set_full_optimizer_state(eng, path, value, "exp_avg")
                out[key + "/set_get"] = (path, torch.equal(
                    safe_get_full_optimizer_state(eng, path, "exp_avg"), value))
                out[key + "/state_elems"] = sum(
                    t.numel() for t in torch.utils._pytree.tree_leaves(eng.state.opt_state)
                    if isinstance(t, torch.Tensor))
            reset_fastpath()
    # the storage tier (offload_optimizer cpu over several ranks) with a
    # frozen leaf at stage 2: its state in host memory, none for the leaf
    optimizer, frozen = inputs["runs"]["frozen"]
    eng, *_ = _engine(inputs, {"optimizer": optimizer, "zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"}}}, frozen_params=frozen)
    out["frozen_offload"] = [float(eng.train_batch(b)) for b in batches]
    out["frozen_offload/masters"] = _full_masters(eng)
    out["frozen_offload/state"] = (
        eng._host_adam is None and eng._offload_optimizer,
        {t.device.type for t in torch.utils._pytree.tree_leaves(eng.state.opt_state)
         if isinstance(t, torch.Tensor)},
        sum(t.numel() for t in torch.utils._pytree.tree_leaves(eng.state.opt_state)
            if isinstance(t, torch.Tensor)))
    reset_fastpath()
    # save a stage-2 LAMB run with a frozen leaf after two steps; a fresh
    # engine resumes it
    optimizer, frozen = inputs["runs"]["lamb_frozen"]
    over = {"optimizer": optimizer, "zero_optimization": {"stage": 2}}
    ckpt = os.path.join(workdir, "ckpt")
    first, *_ = _engine(inputs, over, frozen_params=frozen)
    for b in batches[:2]:
        first.train_batch(b)
    first.save_checkpoint(ckpt)
    resumed, *_ = _engine(inputs, over, frozen_params=frozen)
    resumed.load_checkpoint(ckpt)
    out["resumed"] = float(resumed.train_batch(batches[2]))
    out["resumed/masters"] = _full_masters(resumed)
    reset_fastpath()
    return out


def scenario_moe(rank, world, inputs, workdir):
    """An MoE model at ZeRO stages 0, 1 and 3 from the same weights on the
    same batches (the losses and the full masters), stage 3's peak of
    gathered units, and the DP gradient site that a ``moe`` section keeps
    exact under ``compressed_collectives: int8``."""
    from deepspeed_tpu_torch.ops.fastpath import reset_fastpath

    batches = [torch.from_numpy(b) for b in inputs["batches"]]
    out = {}
    for stage in (0, 1, 3):
        eng, *_ = _engine(inputs, {"zero_optimization": {"stage": stage}})
        out[f"stage{stage}"] = [float(eng.train_batch(b)) for b in batches]
        out[f"stage{stage}/masters"] = _full_masters(eng)
        if stage == 3:
            out["stage3/peak_units"] = eng._z3.peak_units
        reset_fastpath()
    for moe in (False, True):
        eng, *_ = _engine(inputs, {"compressed_collectives": "int8",
                                   "moe": {"enabled": moe, "ep_size": 1}})
        out[f"dp_grad_mode/moe={moe}"] = eng._dp_grad_mode
        reset_fastpath()
    return out


SCENARIOS = {"comm": scenario_comm, "comm_rooted": scenario_comm_rooted,
             "compressed": scenario_compressed,
             "train": scenario_train, "cuda_step": scenario_cuda_step,
             "cuda_stage3": scenario_cuda_stage3,
             "zero_optimizers": scenario_zero_optimizers, "moe": scenario_moe}


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
