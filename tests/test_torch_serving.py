"""The port's ragged engine and server against the JAX package's.

Both ``InferenceEngineV2`` implementations get the same tiny model's weights
(JAX-initialized, converted with ``params_from_jax``) and the same prompts;
greedy float32 generation must give identical tokens, with the prefix cache
off and on (a second ``generate`` over prompts sharing a prefix maps cached
pages). The port's ``LLMServer`` must answer with the engine's tokens, free
a cancelled request's KV pages, and keep the pool-conservation invariant;
its admission scheduler must preempt-and-requeue exactly as the JAX one.
"""

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
from deepspeed_tpu.models.transformer import TransformerLM
from deepspeed_tpu.serving import scheduler as jsched
from deepspeed_tpu.serving.request import Request as JRequest
from deepspeed_tpu.serving.request import ServedResponse as JResp
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.serving import (FINISH_CANCELLED, FINISH_LENGTH,
                                         LLMServer, Request)
from deepspeed_tpu_torch.serving import scheduler as tsched
from deepspeed_tpu_torch.serving.request import ServedResponse as TResp
from tests.test_torch_model import tiny_pair

ENGINE = dict(token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
              num_kv_blocks=96, kv_block_size=4, max_blocks_per_seq=24,
              dtype="float32")


def _engines(prefix_cache=False, **over):
    jcfg, tcfg, params_np = tiny_pair("llama")
    kw = dict(ENGINE, enable_prefix_cache=prefix_cache, **over)
    jeng = JEngine(TransformerLM(jcfg), params_np, JEC(**kw))
    teng = TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                   TEC(**kw), device="cpu")
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
    jeng, teng = _engines(prefix_cache)
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
    jeng, teng = _engines()
    prompts = _prompts(seed=1, lens=(4, 9))
    plain = teng.generate(prompts, max_new_tokens=12)
    eos = int(plain[0][5])
    want = jeng.generate(prompts, max_new_tokens=12, eos_token_id=eos)
    got = teng.generate(prompts, max_new_tokens=12, eos_token_id=eos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0][-1] == eos and len(got[0]) <= 6


def test_server_answers_with_engine_tokens_and_conserves_kv():
    jeng, teng = _engines()
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
    _, teng = _engines()
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
    jeng, teng = _engines(num_kv_blocks=21)
    got = _preempt_scenario(tsched, TResp, Request, teng)
    want = _preempt_scenario(jsched, JResp, JRequest, jeng)
    assert got == want
    assert got[4] == 1                     # the prefill was thrown back
    teng.kv.assert_conservation(_live_blocks(teng))
