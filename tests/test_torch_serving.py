"""The port's ragged engine and server against the JAX package's.

Both ``InferenceEngineV2`` implementations get the same tiny model's weights
(JAX-initialized, converted with ``params_from_jax``) and the same prompts;
greedy float32 generation must give identical tokens, with the prefix cache
off and on (a second ``generate`` over prompts sharing a prefix maps cached
pages). The port's ``LLMServer`` must answer with the engine's tokens, free
a cancelled request's KV pages, and keep the pool-conservation invariant;
its admission scheduler must preempt-and-requeue exactly as the JAX one.
A head dim the paged kernels do not build (112) resolves both attention
paths to the einsum with a one-time warning, on every device, and serves
the JAX engine's tokens. The head dims they build past 64 and 128 (80, 96
and 256) serve gpt_neox-shaped and phi3-shaped engines through them, with
the JAX engine's greedy tokens.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
from deepspeed_tpu.models.transformer import TransformerLM
from deepspeed_tpu.serving import scheduler as jsched
from deepspeed_tpu.serving.request import Request as JRequest
from deepspeed_tpu.serving.request import ServedResponse as JResp
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import engine_v2 as tengine_v2
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.serving import (FINISH_CANCELLED, FINISH_LENGTH,
                                         LLMServer, Request)
from deepspeed_tpu_torch.serving import scheduler as tsched
from deepspeed_tpu_torch.serving.request import ServedResponse as TResp
from tests.test_torch_model import tiny_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread computes them as
    fast, and under several test workers sharing the cores it keeps the
    file from waiting on other processes' threads at every parallel op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ENGINE = dict(token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
              num_kv_blocks=96, kv_block_size=4, max_blocks_per_seq=24,
              dtype="float32")


#: head dim 64, one the paged kernels build: ``auto`` engines run them
D64 = dict(hidden_size=128, num_heads=2)


def _engines(prefix_cache=False, model=D64, **over):
    jcfg, tcfg, params_np = tiny_pair("llama", **model)
    kw = dict(ENGINE, enable_prefix_cache=prefix_cache, **over)
    jeng = JEngine(TransformerLM(jcfg), params_np, JEC(**kw))
    teng = TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                   TEC(**kw), device="cpu")
    return jeng, teng


def _kernel_engines(prefix_cache=False, **over):
    """``_engines`` at D 64 whose port engine runs the paged kernels (their
    plain versions on the CPU) on both the packed and the decode path."""
    jeng, teng = _engines(prefix_cache, **over)
    assert teng.cfg.head_dim == 64
    assert (teng.attn_impl, teng.decode_attn_impl, teng.decode_attn_source) == \
        ("pallas", "pallas", "heuristic")
    return jeng, teng


def _prompts(seed=0, shared=0, lens=(7, 19, 30)):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 97, shared).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, 97, n).astype(np.int32)])
            for n in lens]


def _live_blocks(eng):
    return [s.blocks for s in eng.state_manager.all()]


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_generate_matches_jax_engine(prefix_cache):
    jeng, teng = _kernel_engines(prefix_cache)
    prompts = _prompts(shared=12)
    for _ in range(2):                    # the second call hits the cache
        want = jeng.generate(prompts, max_new_tokens=10)
        got = teng.generate(prompts, max_new_tokens=10)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        teng.kv.assert_conservation(_live_blocks(teng))
    assert teng.reuse.prefix_hits == jeng.reuse.prefix_hits
    assert teng.reuse.prefix_tokens_reused == jeng.reuse.prefix_tokens_reused
    assert teng.reuse.cow_forks == jeng.reuse.cow_forks
    if prefix_cache:
        assert teng.reuse.prefix_hits > 0


def test_generate_with_eos_and_decode_batch_matches_jax():
    jeng, teng = _kernel_engines()
    prompts = _prompts(seed=1, lens=(4, 9))
    plain = teng.generate(prompts, max_new_tokens=12)
    eos = int(plain[0][5])
    want = jeng.generate(prompts, max_new_tokens=12, eos_token_id=eos)
    got = teng.generate(prompts, max_new_tokens=12, eos_token_id=eos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0][-1] == eos and len(got[0]) <= 6


def test_server_answers_with_engine_tokens_and_conserves_kv():
    jeng, teng = _kernel_engines()
    prompts = _prompts(seed=2, lens=(3, 8, 15, 22, 5, 11))
    want = [np.asarray(w) for w in jeng.generate(prompts, max_new_tokens=9)]
    srv = LLMServer(teng, fused_decode_chunk=4)
    resps = [srv.submit(Request(p, max_new_tokens=9), block=True)
             for p in prompts]
    for r, w in zip(resps, want):
        np.testing.assert_array_equal(r.result(timeout=120), w)
        assert r.finish_reason == FINISH_LENGTH and r.ttft_s is not None
    assert srv.drain(timeout=60)
    assert not teng.state_manager.all()
    teng.kv.assert_conservation([])
    assert teng.kv.free_blocks == teng.kv.num_blocks - 1
    snap = srv.metrics.snapshot()
    assert snap["completed"] == len(prompts)
    assert snap["tokens_out"] == 9 * len(prompts)


def test_server_cancel_frees_kv():
    _, teng = _kernel_engines()
    srv = LLMServer(teng)
    resp = srv.submit(Request(_prompts(seed=3, lens=(20,))[0],
                              max_new_tokens=60))
    while not resp.tokens and not resp.done:
        resp.wait(0.01)
    srv.cancel(resp)
    assert resp.wait(timeout=60)
    assert resp.finish_reason == FINISH_CANCELLED
    with pytest.raises(RuntimeError):
        resp.result(0)
    assert srv.drain(timeout=60)
    teng.kv.assert_conservation([])
    assert teng.kv.free_blocks == teng.kv.num_blocks - 1
    assert srv.metrics.cancelled == 1


def _preempt_scenario(sched_mod, resp_cls, req_cls, eng):
    """A low-priority prefill holds the pool; a high-priority request that
    cannot fit beside it arrives."""
    s = sched_mod.ContinuousBatchScheduler(eng, "priority", clock=lambda: 0.0)
    low = resp_cls(req_cls(np.arange(40, dtype=np.int32), max_new_tokens=8,
                           priority=0), 0, 0.0)
    high = resp_cls(req_cls(np.arange(30, dtype=np.int32), max_new_tokens=8,
                            priority=5), 1, 0.0)
    s.add(low)
    first = [r.uid for r in s.admit(0.0)]
    s.add(high)
    second = [r.uid for r in s.admit(0.0)]
    return (first, second, sorted(s.inflight), [r.uid for r in s.pending],
            s.preemptions, low.preemptions)


def test_priority_preemption_matches_jax_scheduler():
    jeng, teng = _kernel_engines(num_kv_blocks=21)
    got = _preempt_scenario(tsched, TResp, Request, teng)
    want = _preempt_scenario(jsched, JResp, JRequest, jeng)
    assert got == want
    assert got[4] == 1                     # the prefill was thrown back
    teng.kv.assert_conservation(_live_blocks(teng))


@pytest.mark.parametrize("head_dim", [64, 96, 112])
def test_head_dims_the_paged_kernels_lack_take_the_einsum(head_dim):
    """The packed rule and the decode heuristic read the paged kernels' head
    dims (``ops/paged_attention.py``'s ``_HEAD_DIMS``): D 112, which they do
    not build, resolves both paths to ``einsum`` with one warning each
    (decode as a fallback, as the JAX engine bails at an off-tile D); D 64
    and D 96 keep the kernels. An explicit ``attn_backend="pallas"`` keeps
    both kernels at any D (at D 112 they raise on the card; here their
    plain versions run). All serve the JAX engine's greedy tokens."""
    model = dict(hidden_size=2 * head_dim, num_heads=2)
    tengine_v2._WARNED.clear()
    jeng, teng = _engines(model=model)
    assert teng.cfg.head_dim == head_dim
    lacks = head_dim not in tengine_v2._PAGED_HEAD_DIMS
    assert teng.attn_impl == ("einsum" if lacks else "pallas")
    assert (teng.decode_attn_impl, teng.decode_attn_source) == (
        ("einsum", "fallback") if lacks else ("pallas", "heuristic"))
    warned = lambda: [m for m in tengine_v2._WARNED if f"head_dim {head_dim}" in m]
    assert len(warned()) == (2 if lacks else 0)     # packed and decode, once each
    _engines(model=model)                           # no second warning
    assert len(warned()) == (2 if lacks else 0)
    pinned = _engines(model=model, attn_backend="pallas")[1]
    assert (pinned.attn_impl, pinned.decode_attn_impl, pinned.decode_attn_source) == \
        ("pallas", "pallas", "config")
    prompts = _prompts(seed=4, lens=(5, 11))
    want = jeng.generate(prompts, max_new_tokens=6)
    for eng in (teng, pinned):
        for g, w in zip(eng.generate(prompts, max_new_tokens=6), want):
            np.testing.assert_array_equal(g, np.asarray(w))


#: the serving shapes of the wide head dims, as the JAX ``inference/hf.py``
#: maps them: gpt_neox (Pythia: partial rotary, parallel residual, biased
#: LayerNorm and projections, untied head) and phi3 (RMSNorm, SwiGLU, MHA)
WIDE = {"gpt_neox": dict(norm="layernorm", activation="gelu", position="rope",
                         rotary_pct=0.25, parallel_residual=True,
                         tie_embeddings=False),
        "phi3": dict(norm="rmsnorm", activation="swiglu", position="rope",
                     tie_embeddings=False)}


@pytest.mark.parametrize("family,head_dim", [("gpt_neox", 80), ("phi3", 96),
                                             ("gpt_neox", 256)])
def test_wide_head_dims_serve_jax_tokens_through_the_paged_kernels(family, head_dim):
    """Pythia-2.8B's (80), phi-3-mini's (96) and Pythia-1B's (256) head dims
    in tiny engines of their families: the port resolves ``pallas`` for the
    packed and the decode path (``heuristic``) with no head-dim warning,
    and its greedy tokens (prompt chunks, fused decode) equal the JAX
    engine's."""
    model = dict(WIDE[family], hidden_size=2 * head_dim, num_heads=2)
    tengine_v2._WARNED.clear()
    jeng, teng = _engines(model=model)
    assert teng.cfg.head_dim == head_dim
    if family == "gpt_neox":
        assert teng.cfg.parallel_residual and teng.cfg.rotary_pct == 0.25
        assert "bias" in teng.params["layer_0"]["attn_norm"]
        assert "lm_head" in teng.params
    assert (teng.attn_impl, teng.decode_attn_impl, teng.decode_attn_source) == \
        ("pallas", "pallas", "heuristic")
    assert not [m for m in tengine_v2._WARNED if "head_dim" in m]
    prompts = _prompts(seed=5, lens=(5, 13, 22))
    want = jeng.generate(prompts, max_new_tokens=8)
    got = teng.generate(prompts, max_new_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    teng.kv.assert_conservation(_live_blocks(teng))
