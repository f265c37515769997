"""The port's checkpoint save/load, on the CPU.

* Save, load into a fresh engine and continue equals the uninterrupted run
  bitwise (losses and final fp32 masters), at ZeRO stages 0-3 (all the same
  math at world size 1), with a synchronous and an async writer; right
  after the load every master, Adam moment, the step, the LR and the loss
  scale equal the saved engine's bitwise, and the loaded tensors are the
  engine's own (copied in place: the fused Adam kernel keys on them).
* ``latest`` and ``client_state``; a torn tag (no commit marker) is skipped;
  ``load_module_only`` loads the weights only; the data loader's position
  is saved and restored; ``zero_to_fp32`` returns the masters;
  ``DeepSpeedCheckpoint`` reads the layout.
* ``metadata.json`` carries the keys the JAX package writes (a JAX save on
  the CPU), and the JAX package's orbax directories are refused by name.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import Topology, TopologySpec
from deepspeed_tpu_torch.checkpoint import (DeepSpeedCheckpoint,
                                            get_fp32_state_dict_from_zero_checkpoint,
                                            zero_to_fp32)
from deepspeed_tpu_torch.checkpoint.engine import read_latest_tag
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.fastpath import reset_fastpath

BASE = dict(vocab_size=97, hidden_size=32, intermediate_size=48, num_layers=1,
            num_heads=4, num_kv_heads=2, max_seq_len=32)
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                       "warmup_max_lr": 1e-3,
                                                       "warmup_num_steps": 4}},
          "gradient_clipping": 1.0, "steps_per_print": 10**9}


@pytest.fixture(autouse=True)
def _fresh_fastpath():
    yield
    reset_fastpath()


@pytest.fixture(scope="module")
def params():
    jcfg = jtf.TransformerConfig(**BASE, dtype=jnp.float32)
    tree = jtf.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


def _engine(params, config=CONFIG, training_data=None):
    cfg = ttf.TransformerConfig(**BASE, dtype=torch.float32)
    p = convert.params_from_jax(params, cfg, device="cpu")
    eng, _, loader, _ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(cfg, p)),
                                       model_parameters=p, config=config, device="cpu",
                                       training_data=training_data)
    return eng, loader


def _batch(i):
    return torch.from_numpy(np.random.default_rng(10 + i).integers(0, 97, (4, 16)))


def _state(eng):
    """Every number of the training state, flattened."""
    leaves = list(eng._masters) + [x for x in torch.utils._pytree.tree_leaves(
        eng.state.opt_state)]
    return leaves + [eng.state.step, eng.get_lr()[0], tuple(eng.state.loss_scale),
                     eng.global_steps, eng.skipped_steps]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("stage,use_async", [(0, False), (1, False), (2, True), (3, False)])
def test_resume_equals_uninterrupted_run(tmp_path, params, stage, use_async):
    config = dict(CONFIG, zero_optimization={"stage": stage},
                  checkpoint={"async_save": use_async})
    whole, _ = _engine(params, config)
    want = [float(whole.train_batch(_batch(i))) for i in range(5)]
    first, _ = _engine(params, config)
    got = [float(first.train_batch(_batch(i))) for i in range(3)]
    path = first.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    assert path == os.path.join(str(tmp_path), "global_step3")
    resumed, _ = _engine(params, config)
    own = [m.data_ptr() for m in resumed._masters]
    own_opt = [x.data_ptr() for x in torch.utils._pytree.tree_leaves(resumed.state.opt_state)
               if isinstance(x, torch.Tensor)]
    assert resumed.load_checkpoint(str(tmp_path)) == (path, {"epoch": 7})
    _assert_same(_state(resumed), _state(first))
    assert [m.data_ptr() for m in resumed._masters] == own
    assert [x.data_ptr() for x in torch.utils._pytree.tree_leaves(resumed.state.opt_state)
            if isinstance(x, torch.Tensor)] == own_opt
    got += [float(resumed.train_batch(_batch(i))) for i in range(3, 5)]
    assert got == want
    _assert_same(_state(resumed), _state(whole))


def test_latest_tags_torn_tag_and_module_only(tmp_path, params):
    eng, _ = _engine(params)
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path), tag="a", client_state={"k": 1})
    eng.train_batch(_batch(1))
    eng.save_checkpoint(str(tmp_path), tag="side", save_latest=False)
    eng.save_checkpoint(str(tmp_path), tag="b", client_state={"k": 2})
    assert read_latest_tag(str(tmp_path)) == "b"
    assert DeepSpeedCheckpoint.get_tags(str(tmp_path)) == ["a", "b", "side"]
    # a torn save: 'latest' names a tag whose commit marker never landed
    os.remove(tmp_path / "b" / "metadata.json")
    assert read_latest_tag(str(tmp_path)) == "a"
    fresh, _ = _engine(params)
    assert fresh.load_checkpoint(str(tmp_path))[1] == {"k": 1}
    assert fresh.global_steps == 1 and fresh.state.step == 1
    # weights only: the optimizer state and step stay the fresh engine's
    module_only, _ = _engine(params)
    module_only.load_checkpoint(str(tmp_path), tag="side", load_module_only=True)
    for got, want in zip(module_only._masters, eng._masters):
        assert torch.equal(got, want)
    assert module_only.state.step == 0
    assert all(float(x.abs().max()) == 0 for x in torch.utils._pytree.tree_leaves(
        module_only.state.opt_state) if isinstance(x, torch.Tensor))


def test_data_loader_position_is_saved_and_restored(tmp_path, params):
    rng = np.random.default_rng(3)
    data = [rng.integers(0, 97, 16).astype(np.int64) for _ in range(12)]
    eng, loader = _engine(params, training_data=data)
    it = iter(loader)
    for _ in range(2):
        eng.train_batch(data_iter=it)
    eng.save_checkpoint(str(tmp_path))
    want = next(it)
    fresh, fresh_loader = _engine(params, training_data=data)
    fresh.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(next(iter(fresh_loader)), want)


def test_zero_to_fp32_and_inspector(tmp_path, params):
    eng, _ = _engine(params)
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path))
    out = tmp_path / "fp32.npz"
    flat = zero_to_fp32(str(tmp_path), output_file=str(out))
    masters = convert._flatten(eng.state.params)
    assert set(flat) == set(masters)
    for path, arr in flat.items():
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, masters[path].detach().numpy())
    with np.load(out) as saved:
        np.testing.assert_array_equal(saved["lm_head/kernel"], flat["lm_head/kernel"])
    again = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path), tag="global_step1")
    assert set(again) == set(flat)
    ck = DeepSpeedCheckpoint(str(tmp_path))
    ck.validate_files()
    assert ck.tag == "global_step1" and ck.global_steps == 1
    assert ck.get_layer_keys() == ["embed", "final_norm", "layer_0", "lm_head"]
    assert ck.show_3d_mapping() == {"tp": 1, "pp": 1, "dp": 1, "ep": 1, "sp": 1}
    assert ck.original_world_size == 1


def test_metadata_keys_match_jax_and_orbax_is_refused(tmp_path, params):
    """The same step saved by both packages: ``metadata.json`` has the JAX
    package's keys and topology, and the port names an orbax directory it
    will not read."""
    jcfg = jtf.TransformerConfig(**BASE, dtype=jnp.float32)
    jeng, *_ = jds.initialize(model=jtf.make_loss_fn(jtf.TransformerLM(jcfg)),
                              model_parameters=jax.tree.map(jnp.asarray, params),
                              config=CONFIG,
                              topology=Topology(TopologySpec(), devices=jax.devices()[:1]))
    jeng.train_batch(jnp.asarray(_batch(0).numpy(), jnp.int32))
    jeng.save_checkpoint(str(tmp_path / "jax"), client_state={"x": 1})
    eng, _ = _engine(params)
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path / "port"), client_state={"x": 1})
    meta = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "global_step1" / "metadata.json") as f:
            meta[name] = json.load(f)
    assert set(meta["port"]) == set(meta["jax"])
    for key in ("tag", "save_latest", "global_steps", "skipped_steps", "client_state",
                "topology"):
        assert meta["port"][key] == meta["jax"][key], key
    assert set(meta["port"]["config"]) == set(meta["jax"]["config"])
    with pytest.raises(FileNotFoundError, match="orbax"):
        _engine(params)[0].load_checkpoint(str(tmp_path / "jax"))
