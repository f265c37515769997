"""int8 and fp8 KV storage in the port against the JAX package.

The same numpy inputs (from seeds) go through both packages:

* ``BlockedKVCache`` with int8 storage (int8 pools, fp32 per-row scales of
  1.0, ``pool_nbytes`` counting the scales, ``cow_fork`` copying values and
  scales) and with a float8 storage cast;
* ``paged_flash_decode`` on ``(int8 values, fp32 scales)`` pools (JAX: the
  Pallas decode kernel's ``quantized`` mode in interpret mode; port: the
  wrapper, which takes its plain version on CPU tensors), and the gathered
  (einsum) path on the same pools. Tolerances as in
  ``test_torch_paged_attention.py``: 2e-5 in float32 (summation order only),
  2e-2 in bfloat16 (one bf16 ulp at magnitudes below ~2);
* ``ragged_forward`` and ``decode_loop`` of a 2-layer tiny model on int8
  pools: logits within 1e-4 (float32), greedy tokens equal, scales within
  1e-5 relative (each is a row's absmax / 127, and the rows come from fp32
  projections that sum in another order, ~1e-6 apart). An int8 code may differ by 1 where the two packages' fp32
  projections round a value onto the other side of a .5 boundary; the test
  allows a difference of at most 1 on at most 0.1% of the codes;
* the engine: the JAX package's ``test_int8_kv_cache_parity``,
  ``test_int8_kv_pallas_backend_fused_decode`` and float8 scenarios run in
  both packages, tokens compared; and the resolution table of the packed
  and the decode attention paths for kv dtype x backend. The JAX engine's
  "auto" heuristic picks its kernels only on a TPU, the port's wherever it
  runs (its kernels on a card, their plain versions on the CPU), so the JAX
  engine is resolved here with its backend reported as a TPU, at head_dim
  128 (the JAX engine's TPU head-dim clause has no counterpart in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JEC
from deepspeed_tpu.inference.v2 import model as jmodel
from deepspeed_tpu.inference.v2.ragged.kv_cache import BlockedKVCache as JCache
from deepspeed_tpu.models.transformer import TransformerLM
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_flash_decode as jax_paged_flash_decode
from deepspeed_tpu.ops.pallas.quant import quantize_rows as jax_quantize_rows
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig as TEC
from deepspeed_tpu_torch.inference.v2 import model as tmodel
from deepspeed_tpu_torch.inference.v2.ragged import BlockedKVCache as TCache
from deepspeed_tpu_torch.models import params_from_jax
from deepspeed_tpu_torch.ops import paged_attention as port
from tests.test_torch_model import ARGS, _batches, tiny_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread computes them as
    fast, and under several test workers sharing the cores it keeps the
    file from waiting on other processes' threads at every parallel op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["int8", "float8_e4m3fn", "bfloat16"])
def test_blocked_kv_cache_storage_matches_jax(name):
    shape = dict(num_layers=2, num_blocks=6, block_size=4, kv_heads=2,
                 head_dim=8)
    jc = JCache(**shape, dtype=jnp.dtype(name))
    tc = TCache(**shape, dtype=getattr(torch, name), device="cpu")
    assert tc.quantized == jc.quantized == (name == "int8")
    assert tuple(tc.k.shape) == jc.k.shape and str(tc.k.dtype) == f"torch.{name}"
    assert tc.pool_nbytes() == jc.pool_nbytes()
    assert not tc.k.float().any() and not tc.v.float().any()
    if name != "int8":
        assert tc.k_scale is None
        assert all(a is b for a, b in zip(tc.pool_args(), (tc.k, tc.v)))
        return
    assert tuple(tc.k_scale.shape) == jc.k_scale.shape == (2, 6, 2, 4)
    assert tc.k_scale.dtype == torch.float32
    assert torch.equal(tc.k_scale, torch.ones(2, 6, 2, 4))
    (k, ks), (v, vs) = tc.pool_args()
    assert k is tc.k and ks is tc.k_scale and v is tc.v and vs is tc.v_scale
    # write page 3 in both caches and fork it
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
    q, s = jax_quantize_rows(jnp.asarray(rows))
    q, s = np.asarray(q), np.asarray(s)
    jc.k = jc.k.at[:, 3].set(q)
    jc.k_scale = jc.k_scale.at[:, 3].set(s)
    jc.v = jc.v.at[:, 3].set(-q)
    jc.v_scale = jc.v_scale.at[:, 3].set(2 * s)
    tc.k[:, 3], tc.k_scale[:, 3] = _t(q), _t(s)
    tc.v[:, 3], tc.v_scale[:, 3] = _t(-q), _t(2 * s)
    jc.refs[3] = tc.refs[3] = 1
    jnew, tnew = jc.cow_fork(3), tc.cow_fork(3)
    assert jnew == tnew
    for a in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, a).numpy(),
                                      np.asarray(getattr(jc, a)), err_msg=a)
    tc.update(*tc.pool_args())
    with pytest.raises(ValueError, match="in place"):
        tc.update((tc.k.clone(), tc.k_scale), (tc.v, tc.v_scale))


def test_float8_cast_beyond_its_range():
    """Past float8_e4m3fn's largest finite value, 448, the JAX ``astype``
    gives NaN once a value rounds above 448 (from 464 up; 464 rounds to
    even, 448). torch's cast does the same on the card (torch 2.11,
    tests/test_torch_cuda.py), while this CPU build of torch saturates to
    +-448 (inf included): KV rows that large are outside what the storage
    cast holds, and the CPU plain path then differs from the reference."""
    x = np.array([448.0, 464.0, 470.0, 1000.0, -1000.0, np.inf], np.float32)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).float().numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn).astype(jnp.float32))
    np.testing.assert_array_equal(got, [448, 448, 448, 448, -448, 448])
    np.testing.assert_array_equal(want[:2], [448, 448])
    assert np.isnan(want[2:]).all()
    small = np.linspace(-440, 440, 97).astype(np.float32)   # in range: equal
    np.testing.assert_array_equal(
        torch.from_numpy(small).to(torch.float8_e4m3fn).float().numpy(),
        np.asarray(jnp.asarray(small).astype(jnp.float8_e4m3fn).astype(jnp.float32)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                                     "float8_e5m2fnuz"])
def test_float8_kv_write_matches_jax(storage, compute):
    """The port's ``_kv_write`` into a one-byte float pool against the JAX
    ``_kv_write`` (``vals.astype(pool.dtype)``) on the same rows, values
    past each format's range included: float8_e4m3fn stores NaN from 466
    up (464 rounds to even, 448), float8_e5m2 +-inf past 61440, and the
    result is bitwise equal wherever the row holds a number (NaN == NaN:
    the two frameworks carry NaN payloads through their casts differently)."""
    L, blocks, hk, bs, d = 2, 3, 2, 4, 8
    special = np.array([448, 464, 466, 470, 1000, -1000, np.inf, -np.inf, np.nan, -464,
                        -465, 240, 248, 57344, 61440, 61441, -1e6, 0.0, -0.0, 1e-9],
                       np.float32)
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((3, hk, d)).astype(np.float32) * 300
    vals.reshape(-1)[:special.size] = special
    blk, slot = np.array([2, 0, 2], np.int32), np.array([1, 3, 0], np.int32)
    jpool = jnp.zeros((L, blocks, hk, bs, d), getattr(jnp, storage))
    jpool = jmodel._kv_write(jpool, 1, jnp.asarray(blk), jnp.asarray(slot),
                             jnp.asarray(vals).astype(getattr(jnp, compute)))
    tpool = torch.zeros((L, blocks, hk, bs, d), dtype=torch.uint8).view(
        getattr(torch, storage))
    tmodel._kv_write(tpool, 1, torch.from_numpy(blk).long(), torch.from_numpy(slot).long(),
                     torch.from_numpy(vals).to(getattr(torch, compute)))
    want = np.asarray(jpool).view(np.uint8)
    got = tpool.view(torch.uint8).numpy()
    as_f32 = lambda a: np.asarray(jnp.asarray(a.view(getattr(jnp, storage)))
                                  .astype(jnp.float32))
    np.testing.assert_array_equal(as_f32(got), as_f32(want))     # NaN == NaN
    numbers = np.ones_like(want, bool)                             # all but the NaN inputs
    numbers[1, blk, :, slot] = ~np.isnan(vals)
    np.testing.assert_array_equal(got[numbers], want[numbers])    # bit for bit
    if storage == "float8_e4m3fn":                                 # the CPU cast saturates
        row = as_f32(got)[1, blk, :, slot].reshape(-1)[:special.size]
        assert row[1] == 448 and np.isnan(row[2:8]).all() and row[9] == -448


# ---------------------------------------------------------------------------
# the decode kernel's int8 mode and the gathered path
# ---------------------------------------------------------------------------


def _int8_decode_case(seed, L, S, Hq, Hk, D, bs, B, kv_lens, pos):
    from tests.test_torch_paged_attention import _tables

    rng = np.random.default_rng(seed)
    bt, used = _tables(S, B, bs, kv_lens)
    N = used + 2
    q = rng.standard_normal((S, Hq, D)).astype(np.float32)
    pools = []
    for _ in range(2):
        x = rng.standard_normal((L, N, Hk, bs, D)).astype(np.float32)
        x *= rng.uniform(0.1, 3.0, (L, N, Hk, bs, 1)).astype(np.float32)
        vals, scales = jax_quantize_rows(jnp.asarray(x))
        pools.append((np.asarray(vals), np.asarray(scales)))
    return q, pools, bt, np.asarray(pos, np.int32), np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_on_int8_pools_matches_jax(dtype, layer):
    """GQA 8/2, an empty slot, a partial last page, positions past kv_len
    and inside it; both packages get the same int8 values and scales."""
    q, ((kq, ks), (vq, vs)), bt, pos, kvl = _int8_decode_case(
        1, L=3, S=4, Hq=8, Hk=2, D=32, bs=8, B=8, kv_lens=[0, 7, 23, 40],
        pos=[0, 9, 11, 45])
    jq = jnp.asarray(q, getattr(jnp, dtype))
    tq = _t(q).to(getattr(torch, dtype))
    jpools = [(jnp.asarray(a), jnp.asarray(b)) for a, b in ((kq, ks), (vq, vs))]
    tpools = [(_t(a), _t(b)) for a, b in ((kq, ks), (vq, vs))]
    if layer == 0:     # the single-layer 4-D form
        jpools = [(a[0], b[0]) for a, b in jpools]
        tpools = [(a[0], b[0]) for a, b in tpools]
    ints = [(jnp.asarray(a), _t(a)) for a in (bt, pos, kvl)]
    for stats in (False, True):
        want = jax_paged_flash_decode(jq, *jpools, *[j for j, _ in ints],
                                      layer=layer, interpret=True,
                                      return_stats=stats)
        got = port.paged_flash_decode(tq, *tpools, *[t for _, t in ints],
                                      layer=layer, return_stats=stats)
        for g, w in zip(got if stats else [got], want if stats else [want]):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=TOL[dtype], atol=TOL[dtype])
    out = got[0]
    assert not out[0].float().any()             # kv_len 0 -> exact zero
    # the plain version is the fp plain version on the dequantized layer
    deq = [port.dequant_rows_tile(a[layer], b[layer], tq.dtype) for a, b in
           [(_t(kq), _t(ks)), (_t(vq), _t(vs))]]
    plain = port.paged_flash_decode_ref(tq, *deq, *[t for _, t in ints])
    assert torch.equal(plain, port.paged_flash_decode(
        tq, *tpools, *[t for _, t in ints], layer=layer))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [96, 256])
def test_decode_on_int8_pools_matches_jax_at_wide_head_dims(D, dtype):
    """The int8 mode at phi-3-mini's and Pythia-1B's head dims: layer 1 of
    a resident pool, GQA 4/2, an empty slot, a position inside the
    context; o, m and l against the JAX kernel."""
    q, ((kq, ks), (vq, vs)), bt, pos, kvl = _int8_decode_case(
        5 + D, L=2, S=3, Hq=4, Hk=2, D=D, bs=8, B=4, kv_lens=[0, 13, 30],
        pos=[0, 13, 21])
    jq = jnp.asarray(q, getattr(jnp, dtype))
    tq = _t(q).to(getattr(torch, dtype))
    jpools = [(jnp.asarray(a), jnp.asarray(b)) for a, b in ((kq, ks), (vq, vs))]
    tpools = [(_t(a), _t(b)) for a, b in ((kq, ks), (vq, vs))]
    ints = [(jnp.asarray(a), _t(a)) for a in (bt, pos, kvl)]
    want = jax_paged_flash_decode(jq, *jpools, *[j for j, _ in ints], layer=1,
                                  interpret=True, return_stats=True)
    got = port.paged_flash_decode(tq, *tpools, *[t for _, t in ints], layer=1,
                                  return_stats=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    assert not got[0][0].float().any()          # kv_len 0 -> exact zero


def test_gathered_path_on_int8_pools_matches_jax():
    """The einsum serving path (JAX ``model.paged_attention``) on one
    layer's int8 pool, and the port's ledger rows for its gathered copy."""
    q, ((kq, ks), (vq, vs)), bt, pos, kvl = _int8_decode_case(
        2, L=2, S=3, Hq=4, Hk=2, D=32, bs=8, B=6, kv_lens=[5, 17, 40],
        pos=[5, 16, 45])
    qg = q[:, None]                                 # [S, 1, Hq, D]
    valid = np.ones((3, 1), bool)
    want = jmodel.paged_attention(
        jnp.asarray(qg), (jnp.asarray(kq[1]), jnp.asarray(ks[1])),
        (jnp.asarray(vq[1]), jnp.asarray(vs[1])), jnp.asarray(bt),
        jnp.asarray(pos[:, None]), jnp.asarray(valid), jnp.asarray(kvl),
        return_stats=True)
    logger = comm.get_comms_logger()
    logger.configure(enabled=True)
    logger.reset()
    try:
        got = tmodel.paged_attention(
            _t(qg), (_t(kq[1]), _t(ks[1])), (_t(vq[1]), _t(vs[1])), _t(bt),
            _t(pos[:, None]), _t(valid), _t(kvl), return_stats=True)
        gathered = logger.totals()["paged_pool_gather"]
    finally:
        logger.configure(enabled=False)
        logger.reset()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    # k and v, each [S, B, Hk, bs, D] dequantized to float32
    assert gathered == {"count": 2, "bytes": 2 * 3 * 6 * 2 * 8 * 32 * 4,
                        "wire_bytes": 2 * 3 * 6 * 2 * 8 * 32 * 4,
                        "total_latency_ms": 0.0}


def test_int8_pools_refused_where_the_packed_kernel_runs():
    q, ((kq, ks), (vq, vs)), bt, pos, kvl = _int8_decode_case(
        3, L=1, S=2, Hq=4, Hk=2, D=32, bs=8, B=4, kv_lens=[3, 17],
        pos=[3, 17])
    kp, vp = (_t(kq[0]), _t(ks[0])), (_t(vq[0]), _t(vs[0]))
    with pytest.raises(ValueError, match="packed"):
        port.paged_attention(_t(q)[:, None], kp, vp, _t(bt), _t(pos),
                             _t(np.ones(2, np.int32)), _t(kvl))
    with pytest.raises(ValueError, match="both"):
        port.paged_flash_decode(_t(q), kp, _t(vq[0]).float(), _t(bt), _t(pos),
                                _t(kvl))


# ---------------------------------------------------------------------------
# the model functions on int8 pools
# ---------------------------------------------------------------------------


def _int8_pools(cfg, N, bs):
    shape = (cfg.num_layers, N, cfg.kv_heads, bs, cfg.head_dim)
    jp = [(jnp.zeros(shape, jnp.int8), jnp.ones(shape[:-1], jnp.float32))
          for _ in range(2)]
    tp = [(torch.zeros(shape, dtype=torch.int8), torch.ones(shape[:-1]))
          for _ in range(2)]
    return jp, tp


def _pools_close(tp, jp):
    for (tq, ts), (jq, js) in zip(tp, jp):
        diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, diff.max()
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("decode_impl", ["pallas", "einsum"])
def test_ragged_forward_and_decode_loop_on_int8_pools_match_jax(decode_impl):
    jcfg, tcfg, params_np = tiny_pair("llama")
    tparams = params_from_jax(params_np, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    bs, N = 4, 20
    (jk, jv), (tk, tv) = _int8_pools(tcfg, N, bs)
    steps, seqs = _batches(bs)
    for batch in steps:
        jl, jk, jv = jmodel.ragged_forward(
            jparams, jcfg, jk, jv, *[jnp.asarray(getattr(batch, a)) for a in ARGS],
            attn_impl="einsum")
        tl, tk2, tv2 = tmodel.ragged_forward(
            tparams, tcfg, tk, tv, *[_t(getattr(batch, a)) for a in ARGS],
            attn_impl="einsum")
        assert tk2 is tk and tv2 is tv                  # written in place
        rows = batch.sample_slots
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        _pools_close((tk, tv), (jk, jv))
    # the packed kernel path refuses quantized pools, as in JAX
    with pytest.raises(ValueError, match="compute-dtype"):
        tmodel.ragged_forward(tparams, tcfg, tk, tv,
                              *[_t(getattr(steps[1], a)) for a in ARGS],
                              attn_impl="pallas")

    S, B, n = 4, 8, 6
    tokens0, pos0 = np.zeros(S, np.int32), np.zeros(S, np.int32)
    bt, active = np.zeros((S, B), np.int32), np.zeros(S, bool)
    for i, s in enumerate(seqs):
        tokens0[i], pos0[i], active[i] = 3 + i, s.seen_tokens, True
        bt[i, :len(s.blocks)] = s.blocks
    jt, jk, jv = jmodel.decode_loop(
        jparams, jcfg, jk, jv, jnp.asarray(tokens0), jnp.asarray(pos0),
        jnp.asarray(bt), jnp.asarray(active), jax.random.PRNGKey(0),
        jnp.float32(1.0), n_steps=n, attn_impl=decode_impl)
    tt, _, _ = tmodel.decode_loop(
        tparams, tcfg, tk, tv, _t(tokens0), _t(pos0), _t(bt), _t(active),
        None, 1.0, n_steps=n, attn_impl=decode_impl)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _pools_close((tk, tv), (jk, jv))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

PROMPTS = [np.array([5, 6, 7, 8, 9], np.int32), np.array([40, 41, 42], np.int32),
           np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)]
ENGINE = dict(token_budget=16, max_ragged_sequence_count=4, max_chunk_size=8,
              num_kv_blocks=32, kv_block_size=8, max_blocks_per_seq=8)


#: head dim 64, one the paged kernels build (``ops/paged_attention.py``)
D64 = dict(hidden_size=128, num_heads=2)


def _engines(pair, **kw):
    jcfg, tcfg, params_np = pair
    cfg = dict(ENGINE, **kw)
    jeng = JEngine(TransformerLM(jcfg), params_np, JEC(**cfg))
    teng = TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                   TEC(**cfg), device="cpu")
    return jeng, teng


def _step_all(eng, prompts, n):
    eng.put(list(range(len(prompts))), prompts, max_new_tokens=n)
    while eng.has_work():
        eng.step()
    return [np.asarray(eng.query(u)[1]) for u in range(len(prompts))]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["int8", "float8_e4m3fn"])
def test_engine_steps_on_quantized_pools_match_jax(kv, compute):
    """The JAX ``test_int8_kv_cache_parity`` / fp8 scenarios (packed steps
    to the end): the same tokens in both packages. Head dim 64, one the
    paged kernels build: int8 pools keep the decode kernel."""
    jeng, teng = _engines(tiny_pair("llama", **D64), dtype=compute, kv_cache_dtype=kv)
    assert str(teng.kv.k.dtype) == f"torch.{kv}"
    assert teng.attn_impl == "einsum"
    assert (teng.decode_attn_impl, teng.decode_attn_source) == (
        ("pallas", "heuristic") if kv == "int8" else ("einsum", "fallback"))
    want = _step_all(jeng, PROMPTS, 8)
    got = _step_all(teng, PROMPTS, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    teng.kv.assert_conservation([s.blocks for s in teng.state_manager.all()])


@pytest.mark.parametrize("kv", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_engine_generate_on_quantized_pools_matches_jax(backend, kv):
    """The JAX ``test_int8_kv_pallas_backend_fused_decode`` scenario:
    prompt chunks on the gathered path, fused decode on the kernel path
    (int8) or the gathered path (float8, a warned fallback). Head dim 64,
    one the paged kernels build."""
    jeng, teng = _engines(tiny_pair("llama", **D64), dtype="float32", kv_cache_dtype=kv,
                          attn_backend=backend)
    assert teng.attn_impl == jeng.attn_impl == "einsum"
    assert (teng.decode_attn_impl, teng.decode_attn_source) == \
        (jeng.decode_attn_impl, jeng.decode_attn_source)
    want = jeng.generate(PROMPTS[:2], max_new_tokens=6)
    got = teng.generate(PROMPTS[:2], max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert teng.kv.free_blocks == teng.kv.num_blocks - 1


def _resolution(eng):
    return eng.attn_impl, eng.decode_attn_impl, eng.decode_attn_source


@pytest.mark.parametrize("kv", [None, "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("backend", [
    dict(attn_backend="auto"), dict(attn_backend="pallas"),
    dict(attn_backend="einsum"),
    dict(attn_backend="einsum", decode_attn_backend="pallas")],
    ids=["auto", "pallas", "einsum", "einsum+decode_pallas"])
def test_resolution_table_matches_jax_on_tpu(kv, backend, monkeypatch):
    pair = tiny_pair("llama", hidden_size=256, num_heads=2, num_kv_heads=1)
    cfg = dict(ENGINE, dtype="bfloat16", kv_cache_dtype=kv, **backend)
    teng = TEngine(pair[1], params_from_jax(pair[2], pair[1], device="cpu"),
                   TEC(**cfg), device="cpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jeng = JEngine(TransformerLM(pair[0]), pair[2], JEC(**cfg))
    assert _resolution(teng) == _resolution(jeng)


def test_unknown_kv_cache_dtype_raises():
    _, tcfg, params_np = tiny_pair("llama")
    for name in ("float7", "int32"):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            TEngine(tcfg, params_from_jax(params_np, tcfg, device="cpu"),
                    TEC(**ENGINE, kv_cache_dtype=name), device="cpu")
