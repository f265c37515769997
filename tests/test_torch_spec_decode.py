"""N-gram speculative decoding in the port against the JAX package's.

All in float32 on the CPU, on a tiny llama-family model (head dim 64, so
the port's engine resolves the paged kernels' path and ``verify_step`` runs
the packed kernel's wrapper, its plain version here) initialized by the JAX
package and handed to the port with ``params_from_jax``:

* ``_ngram_propose`` gives the JAX engine's drafts over seeded contexts;
* ``spec_decode_batch`` streams are bitwise the JAX engine's and the port's
  own ``decode_batch`` streams, and the ``ReuseStats`` spec counters are
  the JAX engine's, with drafts accepted on repetitive prompts;
* the configuration errors are the JAX engine's;
* ``LLMServer`` runs spec mode when the engine asks for it, answers with
  the plain engine's tokens, and its metrics snapshot carries the spec
  keys.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
from deepspeed_tpu.models.transformer import TransformerLM
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.serving import LLMServer, Request
from tests.test_torch_model import tiny_pair

ENGINE = dict(token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
              num_kv_blocks=96, kv_block_size=4, max_blocks_per_seq=24,
              dtype="float32")
D64 = dict(hidden_size=128, num_heads=2)
SPEC = ("spec_steps", "spec_drafted", "spec_accepted")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair("llama", **D64)


def _port_engine(pair, **over):
    _, tcfg, params_np = pair
    return TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                   TEC(**ENGINE, **over), device="cpu")


def _engines(pair, **over):
    jcfg, _, params_np = pair
    return (JEngine(TransformerLM(jcfg), params_np, JEC(**ENGINE, **over)),
            _port_engine(pair, **over))


def _repetitive_prompts(seed=0):
    """Each prompt a seeded random segment repeated, so drafts exist."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, 97, seg).astype(np.int32), reps)
            for seg, reps in ((5, 3), (7, 2), (4, 4))]


def _prefill(eng, prompts, max_new):
    eng.put(list(range(len(prompts))), prompts, max_new_tokens=max_new)
    while any(s.in_prefill for s in eng.state_manager.all()):
        eng.step()


def _drive(eng, decode):
    """Run ``decode`` until every sequence is done; the streams by uid."""
    while any(not s.done for s in eng.state_manager.all()):
        if not decode():
            break
    uids = sorted(s.uid for s in eng.state_manager.all())
    out = [eng.query(u)[1] for u in uids]
    for u in uids:
        eng.flush(u)
    return out


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_propose_matches_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(40):
        L = int(rng.integers(1, 30))
        ctx = rng.integers(0, 4, L).astype(np.int32)      # small alphabet: matches
        cut = int(rng.integers(1, L + 1))
        seq = SimpleNamespace(prompt_tokens=ctx[:cut], generated=[int(t) for t in ctx[cut:]])
        for k in (0, 1, 3, 6):
            want = JEngine._ngram_propose(SimpleNamespace(config=JEC(spec_ngram=n)), seq, k)
            got = TEngine._ngram_propose(SimpleNamespace(config=TEC(spec_ngram=n)), seq, k)
            assert got == want and len(got) <= k


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_spec_decode_streams_and_counters_match_jax_and_decode_batch(pair, prefix_cache):
    prompts = _repetitive_prompts()
    jeng, teng = _engines(pair, spec_decode_k=3, enable_prefix_cache=prefix_cache)
    streams = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        _prefill(eng, prompts, 24)
        streams[name] = _drive(eng, eng.spec_decode_batch)
    for name in SPEC + ("prefix_hits", "prefix_tokens_reused"):
        assert getattr(teng.reuse, name) == getattr(jeng.reuse, name), name
    assert teng.reuse.spec_accepted > 0 and teng.reuse.spec_drafted >= teng.reuse.spec_accepted
    teng.kv.assert_conservation([])
    _prefill(teng, prompts, 24)
    streams["decode_batch"] = _drive(teng, lambda: teng.decode_batch(4))
    for a, b, c in zip(streams["port"], streams["jax"], streams["decode_batch"]):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
        assert len(a) == 24


@pytest.mark.parametrize("over, exc", [
    (dict(spec_decode_k=-1), ValueError),            # at construction
    (dict(spec_ngram=0), ValueError),
    (dict(spec_decode_k=2, greedy=False), ValueError),
    (dict(greedy=False), RuntimeError),              # at spec_decode_batch
])
def test_spec_config_errors_match_jax(pair, over, exc):
    jcfg, tcfg, params_np = pair
    tparams = params_from_jax(params_np, tcfg, device="cpu")
    errors = []
    for make in (lambda: JEngine(TransformerLM(jcfg), params_np, JEC(**ENGINE, **over)),
                 lambda: TEngine(tcfg, tparams, TEC(**ENGINE, **over), device="cpu")):
        with pytest.raises(exc) as err:
            make().spec_decode_batch()
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_server_runs_spec_mode_with_engine_tokens_and_metrics(pair):
    prompts = _repetitive_prompts(seed=1)
    want = _port_engine(pair).generate(prompts, max_new_tokens=20)
    teng = _port_engine(pair, spec_decode_k=4)
    srv = LLMServer(teng, fused_decode_chunk=4)
    resps = [srv.submit(Request(p, max_new_tokens=20), block=True) for p in prompts]
    for r, w in zip(resps, want):
        np.testing.assert_array_equal(r.result(timeout=120), w)
    assert srv.drain(timeout=60)
    snap = srv.metrics.snapshot()
    assert snap["spec_steps"] == teng.reuse.spec_steps > 0
    assert snap["spec_drafted"] == teng.reuse.spec_drafted
    assert snap["spec_accepted"] == teng.reuse.spec_accepted > 0
    assert snap["spec_acceptance_rate"] == round(
        teng.reuse.spec_accepted / teng.reuse.spec_drafted, 4)
    assert srv.metrics.spec_acceptance_rate() is not None
    assert snap["tokens_out"] == 20 * len(prompts)
