"""The port's public names and signatures against the JAX package's.

For every name that the landed slices were missing (ROADMAP.md Queue C item
2), and for the ``runtime.zero`` package and the ``utils.tensor_fragment``
accessors, the port has it, and its parameters carry the JAX counterpart's names in
the JAX order (``inspect.signature``; defaults may differ where the port's
types do). A JAX ``mixtral_config`` constructs the port's
``TransformerConfig``, and the model (so the trainer) and the server refuse it
with ``NotImplementedError`` naming the ROADMAP.md Queue A item. The kernel
wrappers accept the Pallas ``interpret`` switch and ignore it; the block
kwargs refuse the sizes the JAX functions refuse, and every size they accept
gives the same result (on the CPU, the plain versions).
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtransformer
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM, init_params

# module -> names that Queue C item 2 lists for it
SURFACE = {
    "comm.comm": ["reduce", "gather", "scatter", "all_reduce_coalesced",
                  "all_gather_coalesced", "group_all_reduce", "monitored_barrier",
                  "inference_all_reduce", "mpi_discovery", "initialize_mesh_device",
                  "MeshGroup", "log_chunked", "init_distributed"],
    "comm.compressed": ["feedback_state", "store_feedback", "clear_feedback"],
    "checkpoint.engine": ["CheckpointEngine"],
    "utils.fs": ["fsync_dir"],
    "utils.groups": ["initialize"],
    "accelerator": ["set_accelerator", "set_accelerator_by_name"],
    "runtime.config": ["AUTO"],
    "runtime.zero": ["Init", "ZeroShardingRules", "shard_param_spec",
                     "estimate_zero_model_states_mem_needs",
                     "estimate_zero2_model_states_mem_needs_all_live",
                     "estimate_zero3_model_states_mem_needs_all_live", "tiled_matmul",
                     "ZeroPPState", "hierarchical_all_gather", "hpz_remat_policy",
                     "zeropp_train_step_factory"],
    "utils.tensor_fragment": ["safe_get_full_fp32_param", "safe_set_full_fp32_param",
                              "safe_get_full_grad", "safe_set_full_grad",
                              "safe_get_full_optimizer_state",
                              "safe_set_full_optimizer_state", "safe_get_local_fp32_param",
                              "safe_get_local_grad", "safe_get_local_optimizer_state",
                              "safe_set_local_fp32_param", "safe_set_local_grad",
                              "safe_set_local_optimizer_state"],
    "": ["add_config_arguments", "version"],
    # ZeRO-Offload's host libraries (DeepSpeedCPUAdam.step takes one more
    # keyword, out=, and the swapper's swap_in a device for shardings:
    # tests/test_torch_offload.py and test_torch_aio.py hold them)
    "ops.adam": ["CPUAdamBuilder"],
    "ops.aio": ["AsyncIOBuilder", "AsyncIOHandle"],
    # the optimizer library, the error-feedback compression and the
    # device-prefetch loader (ROADMAP.md Queue A items 7.5-7.6)
    "ops.optimizers": ["fused_adam", "fused_lamb", "fused_lion", "adagrad", "sgd",
                       "mu_optimizer", "build_optimizer", "ScaleByAdamState",
                       "ScaleByLionState", "ScaleByAdagradState"],
    "compression.onebit": ["ErrorFeedbackState", "init_error_feedback", "onebit_compress",
                           "compressed_allreduce", "server_error_shape"],
    "runtime.dataloader": ["PrefetchLoader", "RepeatingLoader"],
}
# kernel wrappers: port module -> (JAX module, names)
WRAPPERS = {
    "ops.flash_attention": ("ops.pallas.flash_attention", ["flash_attention"]),
    "ops.fused_loss": ("ops.pallas.fused_loss", ["fused_vocab_nll"]),
    "ops.paged_attention": ("ops.pallas.paged_attention",
                            ["paged_attention", "paged_flash_decode"]),
    "ops.quant": ("ops.pallas.quant", ["quantize_int8", "dequantize_int8"]),
    "ops.fused_adam": ("ops.pallas.fused_adam", ["adam_update"]),
    "ops.sparse_attention": ("ops.pallas.sparse_attention", ["sparse_attention"]),
}


def _module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}" if name else pkg)


def _params(obj):
    return list(inspect.signature(obj).parameters)


def _cases():
    for mod, names in SURFACE.items():
        for name in names:
            yield mod, mod, name
    for mod, (jmod, names) in WRAPPERS.items():
        for name in names:
            yield mod, jmod, name


@pytest.mark.parametrize("mod, jmod, name", list(_cases()),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_name_exists_with_the_jax_signature(mod, jmod, name):
    port = getattr(_module("deepspeed_tpu_torch", mod), name)
    ref = getattr(_module("deepspeed_tpu", jmod), name)
    if inspect.ismodule(ref):                       # the top level's ``version``
        assert inspect.ismodule(port) and port.__version__
    elif callable(ref):
        assert _params(port) == _params(ref), (mod, name)
        if inspect.isclass(ref):                    # the methods too
            for meth, fn in vars(ref).items():
                if inspect.isfunction(fn) and not meth.startswith("_"):
                    assert _params(getattr(port, meth)) == _params(fn), (name, meth)
    else:
        assert port == ref


def test_checkpoint_engine_is_the_base_class():
    from deepspeed_tpu_torch.checkpoint import CheckpointEngine, TorchCheckpointEngine

    assert issubclass(TorchCheckpointEngine, CheckpointEngine)
    with pytest.raises(NotImplementedError):
        CheckpointEngine().save({}, "unused")
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        TorchCheckpointEngine().load("unused", shardings={})


def test_feedback_registry(monkeypatch):
    from deepspeed_tpu_torch.comm import compressed

    compressed.clear_feedback()
    with pytest.raises(ValueError, match="shape"):
        compressed.feedback_state("g")
    if not torch.cuda.is_available():
        # (shape, world) builds the zero state on the card, as every entry
        # point does: on the host the caller passes ``init``
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compressed.feedback_state("g", shape=(5,), world=2)
    fb = compressed.feedback_state(
        "g", init=lambda: compressed.allreduce_feedback_init((5,), 2, device="cpu"))
    assert fb.worker_error.shape == (5,) and fb.server_error.shape == (3,)
    assert fb.worker_error.device.type == "cpu"
    assert compressed.feedback_state("g") is fb
    compressed.store_feedback("g", "next")
    assert compressed.feedback_state("g") == "next"
    compressed.clear_feedback("g")
    assert compressed.feedback_state("g", init=lambda: 7) == 7
    compressed.clear_feedback()


def test_small_names(tmp_path):
    from deepspeed_tpu_torch.accelerator import (CUDA_Accelerator, get_accelerator,
                                                 set_accelerator, set_accelerator_by_name)
    from deepspeed_tpu_torch.runtime.config import AUTO
    from deepspeed_tpu_torch.utils import fs, groups

    fs.fsync_dir(str(tmp_path))
    fs.fsync_dir(str(tmp_path / "missing"))          # best effort: no error
    groups.initialize(ep_size=1)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        groups.initialize(ep_size=2)
    before = get_accelerator()
    try:
        assert isinstance(set_accelerator_by_name("cuda"), CUDA_Accelerator)
        with pytest.raises(ValueError, match="cuda"):
            set_accelerator_by_name("tpu")
    finally:
        set_accelerator(before)
    assert get_accelerator() is before and AUTO == "auto"
    import argparse

    args = tds.add_config_arguments(argparse.ArgumentParser()).parse_args(
        ["--deepspeed", "--deepspeed_config", "ds.json"])
    assert (args.deepspeed, args.deepspeed_config) == (True, "ds.json")
    assert tds.version.__version__ == tds.__version__


def _port_config(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields.update(dtype=torch.float32, **over)
    return TransformerConfig(**fields)


def test_transformer_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(TransformerConfig)]
            == [f.name for f in dataclasses.fields(jtransformer.TransformerConfig)])


def test_mixtral_config_constructs_and_is_refused_by_name():
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig

    cfg = _port_config(jtransformer.mixtral_config("tiny", num_layers=1, vocab_size=128))
    assert cfg.num_experts == 4 and cfg.moe_top_k == 2
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        TransformerLM(cfg, seed=0, device="cpu")
    dense = dataclasses.replace(cfg, num_experts=0)
    params = init_params(dense, seed=0, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(kv_block_size=8),
                          device="cpu")


@pytest.mark.parametrize("field, value, item", [
    ("no_lm_head", True, 7), ("vocab_parallel_loss", True, 8),
    ("sequence_parallel", True, 8), ("embed_overlap", "ring", 8),
    ("overlap_collective_matmul", True, 8)])
def test_unported_config_fields_raise_naming_their_item(field, value, item):
    cfg = _port_config(jtransformer.TransformerConfig(vocab_size=128, hidden_size=32,
                                                      intermediate_size=64, num_layers=1,
                                                      num_heads=2), **{field: value})
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}"):
        TransformerLM(cfg, seed=0, device="cpu")


def test_default_blocks_match_jax():
    # the modules (both packages export the functions under the modules' names)
    jfa, jfl, tfa, tfl = (importlib.import_module(f"{pkg}.{mod}") for pkg, mod in (
        ("deepspeed_tpu.ops.pallas", "flash_attention"), ("deepspeed_tpu.ops.pallas",
                                                          "fused_loss"),
        ("deepspeed_tpu_torch.ops", "flash_attention"), ("deepspeed_tpu_torch.ops",
                                                         "fused_loss")))
    assert (tfa.DEFAULT_BLOCK_Q, tfa.DEFAULT_BLOCK_K) == (jfa.DEFAULT_BLOCK_Q,
                                                          jfa.DEFAULT_BLOCK_K) == (512, 512)
    assert (tfl.DEFAULT_BLOCK_T, tfl.DEFAULT_BLOCK_V) == (jfl.DEFAULT_BLOCK_T,
                                                          jfl.DEFAULT_BLOCK_V) == (256, 512)


@pytest.mark.parametrize("block_q, block_k, refused", [
    (512, 512, False), (128, 128, False), (300, 512, False), (64, 64, False),
    (100, 128, True), (0, 128, True), (256, 96, True), (200, 200, True), (-1, 512, True)])
def test_flash_blocks_refused_as_jax_refuses(block_q, block_k, refused):
    """At a sequence of 256 the JAX function raises for these sizes exactly
    (a ``ValueError``, or a ``ZeroDivisionError`` at 0); every size that it
    takes gives the port's one result, and ``interpret`` changes nothing."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    q = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 256, 2, 8))
                         .astype(np.float32))
    if refused:
        with pytest.raises(ValueError, match="block"):
            flash_attention(q, q, q, block_q=block_q, block_k=block_k)
        return
    want = flash_attention(q, q, q)
    got = flash_attention(q, q, q, block_q=block_q, block_k=block_k, interpret=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("block_t, block_v, refused", [
    (256, 512, False), (12, 512, False), (8, 128, False), (7, 512, False),
    (16, 256, False), (256, 384, False), (256, 192, False),
    (0, 512, True), (256, 0, True), (-8, 512, True), (256, 300, True), (256, 100, True)])
def test_fused_loss_blocks(block_t, block_v, refused):
    """The JAX function raises for a block of 0 or below; at block_v 300 or
    100 over a 384-column vocab it runs but skips the vocab's last columns
    (a wrong loss), which the port refuses. Every size taken gives the same
    loss."""
    from deepspeed_tpu_torch.ops.fused_loss import fused_vocab_nll

    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((16, 384)).astype(np.float32) * 0.1)
    t = torch.from_numpy(rng.integers(0, 384, 20).astype(np.int32))
    if refused:
        with pytest.raises(ValueError, match="block"):
            fused_vocab_nll(h, k, t, block_t=block_t, block_v=block_v)
        return
    got = fused_vocab_nll(h, k, t, block_t=block_t, block_v=block_v, interpret=False)
    assert torch.equal(got, fused_vocab_nll(h, k, t))


def test_wrappers_ignore_interpret():
    from deepspeed_tpu_torch.ops import fused_adam, quant
    from deepspeed_tpu_torch.ops.sparse_attention import fixed_layout, sparse_attention

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(300).astype(np.float32))
    q0, s0, shape = quant.quantize_int8(x, 128)
    q1, s1, _ = quant.quantize_int8(x, 128, True)
    assert torch.equal(q0, q1) and torch.equal(s0, s1)
    assert torch.equal(quant.dequantize_int8(q0, s0, shape, torch.float32, True),
                       quant.dequantize_int8(q0, s0, shape))
    args = (x, torch.zeros_like(x), torch.zeros_like(x), x, 1e-3, 0.9, 0.999, 1e-8, 0.01,
            True, True, 1)
    for a, b in zip(fused_adam.adam_update(*args, interpret=True),
                    fused_adam.adam_update(*args)):
        assert torch.equal(a, b)
    qs = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 128, 2, 8))
                          .astype(np.float32))
    layout = fixed_layout(2, 128 // 32, num_local_blocks=2)
    assert torch.equal(sparse_attention(qs, qs, qs, layout, block=32, interpret=True),
                       sparse_attention(qs, qs, qs, layout, block=32))
