"""The port's Megatron-LM ingestion and its two checkpoint entry points
against the JAX package's, on the CPU.

A tiny Megatron GPT (2 layers, hidden 48, 4 heads, the JAX package's
``tests/unit/test_megatron.py`` sizes) is initialized by the JAX package and
exported at Megatron checkpoint versions 0, 1 and 2. Against the JAX
package:

* ``megatron_config`` field for field, dense and DeepSpeed-MoE args
  (expert counts as lists, ``topk``, the layer placement read from the
  state dict, the irregular placements both refuse);
* ``megatron_params`` and ``params_to_megatron`` bitwise at every version;
* the port's model on the converted tree: logits within ``LOGIT_TOL`` of
  ``jax.jit(model.apply)``, dense and MoE (dropless in both packages);
* a ``torch.save``d ``model_optim_rng.pt`` in Megatron's nesting (an
  ``argparse.Namespace`` of args, a numpy RNG state) read back by both
  loaders to the same args and bits, and a checkpoint with a pickled
  object of another type refused by both;
* ``python -m deepspeed_tpu_torch.checkpoint.ds_to_universal`` on two
  Megatron tp shards and the repository's ``bin/ds_to_universal`` on the
  same files: the port's universal tree (``load_universal``) bitwise the
  tree the JAX script's orbax checkpoint restores;
* ``python -m deepspeed_tpu_torch.utils.zero_to_fp32`` on a port engine's
  checkpoint and ``bin/zero_to_fp32`` on a JAX engine's checkpoint of the
  same parameters: the two ``.npz`` files hold the same keys and bits.

The four scripts run as subprocesses started together; the port's two
also run in this process (``main``), ``ds_to_universal`` with ``--format
raw`` and ``zero_to_fp32`` with ``--tag``.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.inference import megatron as jmeg
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.checkpoint import state_dict_factory as tsdf
from deepspeed_tpu_torch.inference import megatron as tmeg
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = {"vocab_size": 96, "hidden_size": 48, "ffn_hidden_size": 96, "num_layers": 2,
        "num_attention_heads": 4, "max_position_embeddings": 32}
MOE_ARGS = {**ARGS, "num_experts": [4], "topk": 2}
LOGIT_TOL = 1e-5
VERSIONS = (0, 1, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree))


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return ttf.TransformerConfig(**dict(fields, dtype=torch.float32))


def _same(got, want):
    """Two trees (or flat dicts) of arrays: the same keys and bits."""
    g, w = convert._flatten(got), convert._flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


@pytest.fixture(scope="module")
def models():
    """Per model (dense, MoE): the JAX config, its numpy params and the JAX
    logits of one token batch (one jitted apply each)."""
    out = {}
    toks = np.random.default_rng(0).integers(0, ARGS["vocab_size"], (2, 10))
    for name, args, seed in (("dense", ARGS, 3), ("moe", MOE_ARGS, 5)):
        jcfg = dataclasses.replace(jmeg.megatron_config(args), dtype=jnp.float32,
                                   moe_dropless=name == "moe")
        model = jtf.TransformerLM(jcfg)
        params = _np(jtf.init_params(model, seed=seed, seq=16))
        logits = np.asarray(jax.jit(model.apply)({"params": params},
                                                 jnp.asarray(toks, jnp.int32)))
        out[name] = (jcfg, params, logits)
    return out, toks


@pytest.mark.parametrize("args, sd_layers", [
    (ARGS, None), ({**ARGS, "num_experts": [1]}, None), ({**ARGS, "num_experts": 4}, None),
    ({**ARGS, "num_experts": [4]}, None), (MOE_ARGS, None),
    ({**ARGS, "num_layers": 4, "num_experts": [4]}, (1, 3)),
    ({**ARGS, "num_layers": 4, "num_experts": [4], "top_k": 2}, (0, 1, 2, 3)),
    ({**ARGS, "num_layers": 4, "num_experts": [4]}, ()),
    ({**ARGS, "num_layers": 6, "num_experts": [4]}, (2, 4)),
    ({**ARGS, "num_layers": 4, "num_experts": [4]}, (0, 1, 3)),
    ({**ARGS, "num_experts": [2, 4]}, None),
    ({**{k: v for k, v in ARGS.items() if k != "vocab_size"}, "padded_vocab_size": 128,
      "layernorm_epsilon": 1e-6}, None)])
def test_megatron_config_matches_jax(args, sd_layers):
    sd = None if sd_layers is None else {
        f"model.language_model.transformer.layers.{i}.mlp.deepspeed_moe.gate.wg.weight":
        np.zeros((4, 8)) for i in sd_layers}
    try:
        want = jmeg.megatron_config(args, sd=sd)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            tmeg.megatron_config(args, sd=sd)
        return
    got = tmeg.megatron_config(args, sd=sd)
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("head_dim", "qkv_bias", "out_bias", "ffn_bias"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("name", ["dense", "moe"])
@pytest.mark.parametrize("version", VERSIONS)
def test_megatron_params_and_export_match_jax(models, name, version):
    (jcfg, params, _), _ = models[0][name], models[1]
    tcfg = _port_cfg(jcfg)
    sd = jmeg.params_to_megatron(params, jcfg, version=version)
    _same(tmeg.params_to_megatron(params, tcfg, version=version), sd)
    got = tmeg.megatron_params(sd, tcfg, version=version)
    _same(got, jmeg.megatron_params(sd, jcfg, version=version))
    _same(got, params)
    # torch tensors in the state dict convert alike
    _same(tmeg.megatron_params({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tcfg,
                               version=version), got)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_port_model_logits_match_jax(models, name):
    """The tree ``megatron_params`` makes from a version-2 checkpoint (the
    dense one as two tp shards merged by ``SDLoader``; the Megatron layout
    table has no DeepSpeed-MoE leaves, so the MoE one whole) on the port's
    model (MoE through the port's ``moe`` package, dropless): logits within
    LOGIT_TOL of JAX's."""
    (jcfg, params, want), toks = models[0][name], models[1]
    tcfg = _port_cfg(jcfg)
    merged = sd = tmeg.params_to_megatron(params, tcfg, version=2)
    if name == "dense":
        specs = tsdf.megatron_specs(sd)
        qkv = {k: "interleaved" for k in sd if "query_key_value" in k}
        shards = [tsdf.split_state_dict(sd, r, 2, specs, qkv_leaves=qkv,
                                        num_heads=tcfg.num_heads) for r in range(2)]
        merged = tsdf.SDLoaderFactory.get_sd_loader(
            shards, version=2, num_heads=tcfg.num_heads, layout="megatron").load(1, 0)
    tree = convert.params_from_jax(tmeg.megatron_params(merged, tcfg, version=2), tcfg,
                                   device="cpu")
    # the converter's transposed views arrive as contiguous tensors (the
    # fused Adam kernel takes no other)
    assert all(t.is_contiguous() for t in convert._flatten(tree).values())
    with torch.no_grad():
        got = ttf.lm_forward(tcfg, tree, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


class Exotic:
    """A pickled object the safe loader refuses."""


def _nested(sd):
    """Megatron's on-disk nesting: ``ckpt["model"]["language_model"]...``
    with the exporter's leading ``model.`` taken off."""
    nested = {}
    for k, v in sd.items():
        node = nested
        parts = k.split(".")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return nested


def test_load_megatron_checkpoint_matches_jax(models, tmp_path):
    jcfg, params, _ = models[0]["dense"]
    sd = jmeg.params_to_megatron(params, jcfg, version=2)
    args = argparse.Namespace(hidden_size=48, num_layers=2, num_attention_heads=4,
                              max_position_embeddings=32, padded_vocab_size=96,
                              num_experts=[1], checkpoint_version=2.0, tokenizer=None,
                              micro_batch_sizes=(1, 2), skip={"a": 1})
    path = str(tmp_path / "model_optim_rng.pt")
    torch.save({"model": _nested(sd), "args": args, "iteration": 7,
                "checkpoint_version": 2.0,
                "rng_state": [{"np_rng_state": np.random.RandomState(0).get_state()}]},
               path)
    got_args, got = tmeg.load_megatron_checkpoint(path)
    want_args, want = jmeg.load_megatron_checkpoint(path)
    assert got_args == want_args and got_args["num_experts"] == [1]
    assert "skip" not in got_args
    _same(got, want)
    assert set(got) >= set(sd) and all(np.array_equal(got[k], sd[k]) for k in sd)
    bad = str(tmp_path / "exotic.pt")
    torch.save({"model": _nested(sd), "args": Exotic()}, bad)
    for load in (tmeg.load_megatron_checkpoint, jmeg.load_megatron_checkpoint):
        with pytest.raises(ValueError, match="trust_pickle"):
            load(bad)


def _script(cmd, env):
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def entry_points(models, tmp_path_factory):
    """Both packages' ds_to_universal on the same two Megatron tp shards,
    and both packages' zero_to_fp32 on their engines' checkpoints of the
    same parameters, all four started together."""
    jcfg, params, _ = models[0]["dense"]
    tmp = tmp_path_factory.mktemp("megatron_scripts")
    sd = tmeg.params_to_megatron(params, _port_cfg(jcfg), version=2)
    specs = tsdf.megatron_specs(sd)
    qkv = {k: "interleaved" for k in sd if "query_key_value" in k}
    shards = []
    for r in range(2):
        shard, repl = tsdf.split_state_dict(sd, r, 2, specs, qkv_leaves=qkv,
                                            num_heads=jcfg.num_heads, return_replicated=True)
        shards.append(str(tmp / f"mp_rank_{r:02d}.npz"))
        tsdf.save_shard_npz(shards[-1], shard, replicated_paths=repl)
    (tmp / "margs.json").write_text(json.dumps(ARGS))
    convert_args = ["--input", *shards, "--version", "2", "--num-heads", "4",
                    "--format", "megatron", "--config", str(tmp / "margs.json")]

    # the engines' checkpoints: the same fp32 parameters, step 0
    config = {"train_micro_batch_size_per_gpu": 1, "steps_per_print": 10**9}
    tcfg = _port_cfg(jcfg)
    tree = convert.params_from_jax(params, tcfg, device="cpu")
    teng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, tree)),
                              model_parameters=tree, config=config, device="cpu")
    teng.save_checkpoint(str(tmp / "port_ckpt"))
    jeng, *_ = jds.initialize(model=jtf.make_loss_fn(jtf.TransformerLM(jcfg)),
                              model_parameters=jax.tree.map(jnp.asarray, params),
                              config=config)
    jeng.save_checkpoint(str(tmp / "jax_ckpt"))

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    procs = {
        "port_universal": _script([sys.executable, "-m",
                                   "deepspeed_tpu_torch.checkpoint.ds_to_universal",
                                   *convert_args, "--output", str(tmp / "port_universal")],
                                  env),
        "jax_universal": _script([sys.executable, os.path.join(REPO, "bin", "ds_to_universal"),
                                  *convert_args, "--output", str(tmp / "jax_universal")], env),
        "port_fp32": _script([sys.executable, "-m", "deepspeed_tpu_torch.utils.zero_to_fp32",
                              str(tmp / "port_ckpt"), str(tmp / "port_fp32.npz")], env),
        "jax_fp32": _script([sys.executable, os.path.join(REPO, "bin", "zero_to_fp32"),
                             str(tmp / "jax_ckpt"), str(tmp / "jax_fp32.npz")], env),
    }
    outs = {k: _finish(p) for k, p in procs.items()}
    return tmp, params, outs


def test_ds_to_universal_entry_point_matches_jax(entry_points):
    from deepspeed_tpu.checkpoint.engine import OrbaxCheckpointEngine
    from deepspeed_tpu_torch.checkpoint.ds_to_universal import load_universal

    tmp, params, outs = entry_points
    assert "universal checkpoint written" in outs["port_universal"]
    got = load_universal(str(tmp / "port_universal"))
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in convert._flatten(got).values())
    got = _np({k: v.numpy() for k, v in convert._flatten(got).items()})
    want = _np(OrbaxCheckpointEngine().load(str(tmp / "jax_universal"), template=params))
    _same(got, convert._flatten(want))
    _same(got, convert._flatten(params))


def test_zero_to_fp32_entry_point_matches_jax(entry_points):
    tmp, params, outs = entry_points
    assert "wrote" in outs["port_fp32"]
    with np.load(tmp / "port_fp32.npz") as a, np.load(tmp / "jax_fp32.npz") as b:
        got, want = {k: a[k] for k in a.files}, {k: b[k] for k in b.files}
    _same(got, want)
    _same(got, convert._flatten(params))


def test_entry_points_in_process_raw_format_and_tag(entry_points, tmp_path, capsys):
    """The two entry points' ``main`` in this process: ``ds_to_universal``
    with ``--format raw`` on flax-layout shards split by the name rules
    gives back the tree bitwise, ``--format megatron`` without ``--config``
    exits, and ``zero_to_fp32 --tag`` writes what the subprocess wrote."""
    from deepspeed_tpu_torch.checkpoint import ds_to_universal
    from deepspeed_tpu_torch.utils import zero_to_fp32

    tmp, params, _ = entry_points
    shards = []
    for r in range(2):
        shard, repl = tsdf.split_state_dict(params, r, 2, return_replicated=True)
        shards.append(str(tmp_path / f"flax_{r}.npz"))
        tsdf.save_shard_npz(shards[-1], shard, replicated_paths=repl)
    ds_to_universal.main(["--input", *shards, "--output", str(tmp_path / "raw")])
    got = {k: v.numpy() for k, v in convert._flatten(
        ds_to_universal.load_universal(str(tmp_path / "raw"))).items()}
    _same(got, convert._flatten(params))
    megatron = [str(tmp / f"mp_rank_{r:02d}.npz") for r in range(2)]
    with pytest.raises(SystemExit, match="--config"):
        ds_to_universal.main(["--input", *megatron, "--output", str(tmp_path / "x"),
                              "--num-heads", "4", "--format", "megatron"])
    tag = (tmp / "port_ckpt" / "latest").read_text().strip()
    zero_to_fp32.main([str(tmp / "port_ckpt"), str(tmp_path / "tag.npz"), "--tag", tag])
    assert "wrote" in capsys.readouterr().out
    with np.load(tmp_path / "tag.npz") as a, np.load(tmp / "port_fp32.npz") as b:
        _same({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
