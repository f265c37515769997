"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip here with a reason. On a
machine with a card (which has no JAX) run them without the JAX test
harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports only torch, numpy, the port and the gloo-world launcher
``tests/torch_dist_worker.py`` (torch only).
"""

import dataclasses
import gc
import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.transformer import attention_core
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_adam as adam
from deepspeed_tpu_torch.ops import paged_attention as port
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.ops.sparse_attention import (
    bigbird_layout, fixed_layout, launch_counts as sparse_launches,
    masked_dense_attention, sparse_attention)

from .torch_dist_worker import run_world

# the module (the package exports the op under the module's name)
sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _tables(S, B, bs, kv_lens):
    bt = np.zeros((S, B), np.int32)
    nxt = 1
    for s in range(S):
        for b in range(-(-max(int(kv_lens[s]), 1) // bs)):
            bt[s, b] = nxt
            nxt += 1
    return bt, nxt


def _packed(rng, dtype, S, Q, Hq, Hk, D, bs, B, kv_lens, chunk_lens):
    bt, used = _tables(S, B, bs, kv_lens)
    dev = torch.device("cuda")
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    kv = np.asarray(kv_lens)
    ch = np.asarray(chunk_lens)
    return (f(S, Q, Hq, D), f(used + 1, Hk, bs, D), f(used + 1, Hk, bs, D),
            i(bt), i(kv - ch), i(ch), i(kv))


#: the head dims the paged kernels build (both routes)
PAGED_DIMS = [64, 80, 96, 128, 256]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", PAGED_DIMS)
def test_kernels_match_plain_versions_on_card(dtype, D):
    """Both kernels against their plain versions: a GQA ratio, ragged
    lengths incl. 0 and a partial page, stats on and off."""
    _need_card()
    rng = np.random.default_rng(6)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    args = _packed(rng, dtype, S=4, Q=16, Hq=32, Hk=8, D=D, bs=32, B=8,
                   kv_lens=[16, 45, 200, 0], chunk_lens=[16, 13, 1, 0])
    for stats in (False, True):
        got = port.paged_attention(*args, return_stats=stats)
        want = port.paged_attention_ref(*args, return_stats=stats)
        for g, w in zip(got if stats else [got], want if stats else [want]):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    q, k, v, bt, _, _, kvl = args
    kr = torch.stack([k, k.flip(0)])
    vr = torch.stack([v, v.flip(0)])
    qd = q[:, 0].contiguous()
    for stats in (False, True):
        got = port.paged_flash_decode(qd, kr, vr, bt, kvl, kvl, layer=1,
                                      return_stats=stats)
        want = port.paged_flash_decode_ref(qd, kr, vr, bt, kvl, kvl, layer=1,
                                           return_stats=stats)
        for g, w in zip(got if stats else [got], want if stats else [want]):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def test_wrappers_count_launches_and_reject_bad_inputs():
    _need_card()
    rng = np.random.default_rng(7)
    args = _packed(rng, torch.bfloat16, S=2, Q=4, Hq=8, Hk=8, D=64, bs=16, B=4,
                   kv_lens=[4, 20], chunk_lens=[4, 2])
    port.reset_launch_counts()
    port.paged_attention(*args)
    assert port.launch_counts == {"paged_attention": 1, "paged_flash_decode": 0,
                                  "paged_flash_decode_int8": 0, "paged_combine": 0}
    q, k, v, *rest = args
    with pytest.raises(ValueError, match="dtype"):
        port.paged_attention(q, k.float(), v.float(), *rest)
    with pytest.raises(ValueError, match="head_dim"):
        port.paged_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                             v[..., :48].contiguous(), *rest)
    with pytest.raises(ValueError, match="int32"):
        port.paged_attention(q, k, v, rest[0].long(), *rest[1:])
    assert port.launch_counts["paged_attention"] == 1


def _int8_pools(k, v):
    """``(values, scales)`` pools quantized from fp pools (``quantize_rows``)."""
    return quant.quantize_rows(k), quant.quantize_rows(v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", PAGED_DIMS)
def test_decode_int8_mode_matches_plain_version_on_card(dtype, D):
    """The decode kernel's int8 mode against its plain version (dequantize
    the layer with ``dequant_rows_tile``, then the plain decode): GQA 32/8
    and MHA, layer 1 of 2, ragged lengths incl. 0 and a partial page."""
    _need_card()
    rng = np.random.default_rng(9)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for Hq, Hk in ((32, 8), (8, 8)):
        q, k, v, bt, _, _, kvl = _packed(
            rng, dtype, S=4, Q=1, Hq=Hq, Hk=Hk, D=D, bs=32, B=8,
            kv_lens=[16, 45, 200, 0], chunk_lens=[1, 1, 1, 0])
        kp, vp = _int8_pools(torch.stack([k.flip(0), k]), torch.stack([v.flip(0), v]))
        qd = q[:, 0].contiguous()
        port.reset_launch_counts()
        for stats in (False, True):
            got = port.paged_flash_decode(qd, kp, vp, bt, kvl, kvl, layer=1,
                                          return_stats=stats)
            want = port.paged_flash_decode_ref(qd, kp, vp, bt, kvl, kvl, layer=1,
                                               return_stats=stats)
            for g, w in zip(got if stats else [got], want if stats else [want]):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        assert port.launch_counts["paged_flash_decode_int8"] == 2
        assert port.launch_counts["paged_flash_decode"] == 0


def test_decode_int8_wrapper_rejects_bad_pools_on_card():
    _need_card()
    rng = np.random.default_rng(10)
    q, k, v, bt, _, _, kvl = _packed(rng, torch.bfloat16, S=2, Q=1, Hq=8, Hk=8,
                                     D=64, bs=16, B=4, kv_lens=[4, 20],
                                     chunk_lens=[1, 1])
    (kq, ks), (vq, vs) = _int8_pools(k, v)
    qd = q[:, 0].contiguous()
    with pytest.raises(ValueError, match="float32"):
        port.paged_flash_decode(qd, (kq, ks.double()), (vq, vs), bt, kvl, kvl)
    with pytest.raises(ValueError, match="float32"):
        port.paged_flash_decode(qd, (kq, ks[..., :-1].contiguous()), (vq, vs),
                                bt, kvl, kvl)
    with pytest.raises(ValueError, match="int8"):
        port.paged_flash_decode(qd, (kq.float(), ks), (vq.float(), vs), bt, kvl, kvl)
    with pytest.raises(ValueError, match="head_dim"):
        port.paged_flash_decode(qd[..., :32].contiguous(),
                                (kq[..., :32].contiguous(), ks),
                                (vq[..., :32].contiguous(), vs), bt, kvl, kvl)


@pytest.mark.parametrize("kv", ["int8", "float8_e4m3fn"])
def test_engine_on_quantized_pools_on_card(kv):
    """An int8 engine's fused decode launches the int8 mode (its prompt
    chunks take the gathered path); a float8 engine serves on the gathered
    path. Greedy float32 tokens equal those of the same engine with its
    decode on the gathered path."""
    _need_card()
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=97, hidden_size=256,
                            intermediate_size=192, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=256,
                            dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (7, 19, 40)]
    outs = []
    for decode in ("auto", "einsum"):
        eng = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
            num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=16,
            kv_cache_dtype=kv, decode_attn_backend=decode), device="cuda")
        assert eng.attn_impl == "einsum"
        kernel = kv == "int8" and decode == "auto"
        assert eng.decode_attn_impl == ("pallas" if kernel else "einsum")
        port.reset_launch_counts()
        outs.append(eng.generate(prompts, max_new_tokens=12))
        assert (port.launch_counts["paged_flash_decode_int8"] > 0) == kernel
        assert port.launch_counts["paged_attention"] == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


_SM90_PACKED = {
    "mixed": dict(S=5, Q=16, kv_lens=[300, 45, 700, 0, 33], chunk_lens=[1, 13, 16, 0, 1]),
    "all prompt": dict(S=3, Q=48, kv_lens=[48, 100, 77], chunk_lens=[48, 48, 40]),
    "all decode": dict(S=4, Q=1, kv_lens=[1, 64, 1000, 2047], chunk_lens=[1, 1, 1, 1]),
    "full table": dict(S=2, Q=8, kv_lens=[2048, 2048], chunk_lens=[1, 8]),
}


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("case", sorted(_SM90_PACKED))
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", PAGED_DIMS)
def test_sm90_packed_kernel_matches_plain_version_on_card(D, G, case, bs):
    """The packed kernel on the sm90 route against its plain version: bf16,
    every built D, GQA groups 1 / 4 / 8, mixed, all-prompt and all-decode
    chunks, a full table, every page size the route takes; at one query per
    sequence (all decode) the few (sequence, kv head) pairs split the
    contexts across blocks; stats on."""
    _need_card()
    rng = np.random.default_rng(21)
    spec = _SM90_PACKED[case]
    args = _packed(rng, torch.bfloat16, S=spec["S"], Q=spec["Q"], Hq=4 * G, Hk=4, D=D,
                   bs=bs, B=2048 // bs, kv_lens=spec["kv_lens"], chunk_lens=spec["chunk_lens"])
    q = args[0]
    out, m = torch.empty_like(q), torch.empty(q.shape[:3], device="cuda")
    l = torch.empty_like(m)
    port.reset_launch_counts()
    port.launch_paged_attention(*args, out, m, l, sm_scale=D ** -0.5, route="sm90")
    want = port.paged_attention_ref(*args, return_stats=True)
    torch.testing.assert_close(out.float(), want[0].float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(m, want[1], rtol=0, atol=1e-3)
    torch.testing.assert_close(l, want[2], rtol=1e-3, atol=1e-3)
    assert port.route_counts["paged_attention"] == {"sm90": 1, "cuda_core": 0}


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("D", PAGED_DIMS)
def test_sm90_decode_kernel_matches_plain_version_on_card(D, G, int8, bs):
    """The decode kernel (and its int8 mode) on the sm90 route against its
    plain version: layer 1 of 2, contexts of 0 to all the table's pages (64
    of 16 slots, 32 of 32, 16 of 64) split across blocks, positions at and
    inside the context; G 16 takes the instantiation with the 64-row
    consumer."""
    _need_card()
    rng = np.random.default_rng(22)
    kv = [0, 17, 1024, 1000, 1024]    # 1024 slots: the whole table
    q, k, v, bt, _, _, kvl = _packed(rng, torch.bfloat16, S=5, Q=1, Hq=4 * G, Hk=4, D=D,
                                     bs=bs, B=1024 // bs, kv_lens=kv, chunk_lens=[1] * 5)
    pos = torch.tensor([0, 17, 1024, 500, 1000], dtype=torch.int32, device="cuda")
    kr, vr = torch.stack([k.flip(0), k]), torch.stack([v.flip(0), v])
    if int8:
        kr, vr = _int8_pools(kr, vr)
    qd = q[:, 0].contiguous()
    assert port.paged_route(qd, kr, vr) == "sm90"
    port.reset_launch_counts()
    got = port.paged_flash_decode(qd, kr, vr, bt, pos, kvl, layer=1, return_stats=True)
    want = port.paged_flash_decode_ref(qd, kr, vr, bt, pos, kvl, layer=1, return_stats=True)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-3)
    name = "paged_flash_decode_int8" if int8 else "paged_flash_decode"
    assert port.route_counts[name] == {"sm90": 1, "cuda_core": 0}


@pytest.mark.parametrize("D", PAGED_DIMS)
def test_sm90_paged_kernels_are_bitwise_repeatable_on_card(D):
    """Two launches of each sm90 kernel give bitwise equal o, m and l: the
    split partials merge in split order, with no float atomics."""
    _need_card()
    rng = np.random.default_rng(23)
    args = _packed(rng, torch.bfloat16, S=4, Q=32, Hq=32, Hk=32, D=D, bs=32, B=64,
                   kv_lens=[2048, 900, 32, 1500], chunk_lens=[1, 32, 1, 1])
    runs = [port.paged_attention(*args, return_stats=True) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    q, k, v, bt, _, _, kvl = args
    qd = q[:, 0].contiguous()
    for kk, vv in ((k, v), _int8_pools(k, v)):
        runs = [port.paged_flash_decode(qd, kk, vv, bt, kvl, kvl, return_stats=True)
                for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("kernel", ["packed, mixed", "decode", "decode, int8"])
@pytest.mark.parametrize("split_tiles", [1, 2, 8])
def test_sm90_kernels_match_plain_versions_at_every_split_on_card(split_tiles, kernel):
    """The kernels held to the work-item decomposition that the CPU tests
    check in Python: runs of 1, 2 and 8 tiles per KV split through the
    launch helpers, over contexts of 0 to 2048 slots (0 to 32 tiles), a
    partial page and a prompt chunk beside the decode rows; the merge is
    counted as ``paged_combine`` exactly when the launch splits."""
    _need_card()
    rng = np.random.default_rng(25)
    kv, ch = [2048, 0, 33, 700, 1500], [1, 0, 1, 40, 1]
    args = _packed(rng, torch.bfloat16, S=5, Q=40, Hq=16, Hk=4, D=128, bs=32, B=64,
                   kv_lens=kv, chunk_lens=ch)
    q, k, v, bt, start, chunk, kvl = args
    n_splits = port.sm90_grid(5, 1, 4, 4, 64, 32, split_tiles)[2]
    out = torch.empty_like(q) if kernel == "packed, mixed" else torch.empty_like(q[:, 0])
    m = torch.empty(out.shape[:-1], device="cuda")
    l = torch.empty_like(m)
    port.reset_launch_counts()
    if kernel == "packed, mixed":
        port.launch_paged_attention(*args, out, m, l, sm_scale=128 ** -0.5,
                                    split_tiles=split_tiles)
        want = port.paged_attention_ref(*args, return_stats=True)
    else:
        qd = q[:, 0].contiguous()
        kr, vr = k[None], v[None]
        if kernel == "decode, int8":
            kr, vr = _int8_pools(kr, vr)
        port.launch_paged_flash_decode(qd, kr, vr, bt, kvl, kvl, out, m, l, layer=0,
                                       sm_scale=128 ** -0.5, split_tiles=split_tiles)
        want = port.paged_flash_decode_ref(qd, kr, vr, bt, kvl, kvl, return_stats=True)
    torch.testing.assert_close(out.float(), want[0].float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(m, want[1], rtol=0, atol=1e-3)
    torch.testing.assert_close(l, want[2], rtol=1e-3, atol=1e-3)
    assert n_splits == -(-32 // split_tiles)
    assert port.launch_counts["paged_combine"] == 1


def test_sm90_route_refuses_what_it_was_not_built_for_on_card(monkeypatch):
    """A forced sm90 launch on fp32 tensors raises (fp32 takes the CUDA-core
    tile); a launch whose host copy of the work items differs from the
    kernel's (rows per item, slots per tile) is refused."""
    _need_card()
    rng = np.random.default_rng(24)
    args = _packed(rng, torch.float32, S=2, Q=4, Hq=8, Hk=8, D=64, bs=16, B=4,
                   kv_lens=[4, 20], chunk_lens=[4, 2])
    out = torch.empty_like(args[0])
    with pytest.raises(ValueError, match="sm90"):
        port.launch_paged_attention(*args, out, None, None, sm_scale=0.125, route="sm90")
    qd, kd, vd = args[0][:, 0].contiguous(), args[1][None], args[2][None]
    with pytest.raises(ValueError, match="sm90"):
        port.launch_paged_flash_decode(qd, kd, vd, args[3], args[6], args[6],
                                       torch.empty_like(qd), None, None, layer=0,
                                       sm_scale=0.125, route="sm90")
    bf = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t for t in args)
    for name, value in (("SM90_ROWS", 32), ("SM90_TILE_SLOTS", 128)):
        with monkeypatch.context() as mp:
            mp.setattr(port, name, value)
            with pytest.raises(RuntimeError, match="launch failed"):
                port.paged_attention(*bf)
    port.paged_attention(*bf)   # the real tiles launch


@pytest.mark.parametrize("D", [80, 96, 256])
def test_paged_routes_at_the_wide_head_dims_on_card(D):
    """At D 80, 96 and 256 bf16 queries over bf16 and int8 pools take
    ``sm90``, fp32 takes ``cuda_core``; each launch is counted once on its
    route."""
    _need_card()
    rng = np.random.default_rng(26)
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "cuda_core")):
        args = _packed(rng, dtype, S=3, Q=8, Hq=8, Hk=2, D=D, bs=16, B=16,
                       kv_lens=[40, 9, 130], chunk_lens=[8, 1, 1])
        q, k, v, bt, _, _, kvl = args
        qd = q[:, 0].contiguous()
        port.reset_launch_counts()
        port.paged_attention(*args)
        port.paged_flash_decode(qd, k, v, bt, kvl, kvl)
        port.paged_flash_decode(qd, *_int8_pools(k, v), bt, kvl, kvl)
        for name in ("paged_attention", "paged_flash_decode", "paged_flash_decode_int8"):
            assert port.route_counts[name][route] == 1, (D, dtype, name)
            assert port.launch_counts[name] == 1


def test_unbuilt_head_dims_are_refused_by_both_routes_on_card(monkeypatch):
    """A head dim neither source builds (112) is refused by each entry with
    cudaErrorInvalidValue, never served by a neighbour's instantiation: the
    CUDA-core route through its launch helper, the sm90 route with the host
    list widened to let the launch through."""
    _need_card()
    rng = np.random.default_rng(27)
    args = _packed(rng, torch.bfloat16, S=2, Q=4, Hq=4, Hk=2, D=112, bs=16, B=4,
                   kv_lens=[4, 20], chunk_lens=[4, 1])
    q, k, v, bt, _, _, kvl = args
    qd = q[:, 0].contiguous()
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        port.launch_paged_attention(*args, out, None, None, sm_scale=0.1, route="cuda_core")
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        port.launch_paged_flash_decode(qd, *_int8_pools(k[None], v[None]), bt, kvl, kvl,
                                       torch.empty_like(qd), None, None, layer=0,
                                       sm_scale=0.1, route="cuda_core")
    monkeypatch.setattr(port, "_HEAD_DIMS", port._HEAD_DIMS + (112,))
    assert port.paged_route(q, k, v) == "sm90"
    # the sm90 libraries state no blocks per SM for it, so the split rule
    # refuses it; with the split given, the entries themselves refuse it
    for int8 in (False, True):
        with pytest.raises(ValueError, match="head_dim 112"):
            port.sm90_blocks_per_sm(112, 2, True, int8)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        port.launch_paged_attention(*args, out, None, None, sm_scale=0.1, split_tiles=1)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        port.launch_paged_flash_decode(qd, *_int8_pools(k[None], v[None]), bt, kvl, kvl,
                                       torch.empty_like(qd), None, None, layer=0,
                                       sm_scale=0.1, split_tiles=1)


@pytest.mark.parametrize("int8", [False, True])
def test_sm90_blocks_per_sm_come_from_the_instantiation_on_card(int8):
    """The blocks per SM that the split rule reads come from the library
    that holds the kernel, for every built head dim: the decode kernel at
    GQA groups of at most 8 heads takes its own instantiation, every other
    launch the 64-row one; D 256 fits one block an SM."""
    _need_card()
    per_sm = lambda D, G, decode: port.sm90_blocks_per_sm(D, G, decode, int8)
    for D in PAGED_DIMS:
        assert per_sm(D, 4, True) >= per_sm(D, 16, True) == per_sm(D, 4, False) >= 1
    assert per_sm(128, 4, True) == 3
    assert per_sm(128, 16, True) == 2
    assert per_sm(128, 4, False) == 2
    assert per_sm(64, 1, True) == 4
    assert per_sm(96, 1, True) == 3
    assert per_sm(256, 1, True) == 1
    assert per_sm(256, 1, False) == 1


def test_float8_cast_beyond_its_range_on_card():
    """On the card torch's float8_e4m3fn cast gives NaN once a value rounds
    above 448, as the JAX ``astype`` does (the CPU build of torch that the
    CPU tests run saturates instead; tests/test_torch_kv_quant.py)."""
    _need_card()
    x = torch.tensor([448.0, 464.0, 470.0, -1000.0, 3.0], device="cuda")
    y = x.to(torch.float8_e4m3fn).float().tolist()
    assert y[:2] == [448.0, 448.0] and y[4] == 3.0
    assert all(np.isnan(y[2:4]))


@pytest.mark.parametrize("route", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,block", [
    (64, 64), (64, 128), (128, 64), (128, 128), (128, 16), (128, 32), (128, 256),
    (80, 16), (96, 32), (256, 16), (80, 64), (96, 128), (256, 64), (64, 16)])
def test_sparse_kernel_matches_plain_version_on_card(D, block, dtype, causal, route):
    """The sparse forward kernel against the masked-dense plain version on a
    bigbird layout (random blocks above the diagonal) and a layout with
    empty q-blocks (inside live items below block 64): through the entry
    point (one launch, on the route ``sparse_route`` picks: wgmma for bf16,
    mma_sync for fp32) and forced onto ``route`` through the launch helper
    (a forced wgmma on fp32 raises before any launch); the backward through
    the entry point equals autograd through the plain version."""
    _need_card()
    B, S, H = 2, 1024, 4
    nb = S // block
    gen = torch.Generator(device="cuda").manual_seed(11)
    r = lambda: torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    q, k, v = r(), r(), r()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    chosen = "wgmma" if dtype == torch.bfloat16 else "mma_sync"
    empty = np.zeros((H, nb, nb), bool)
    empty[:, 2:, 1] = True                          # q-blocks 0, 1 have nothing
    for layout in (bigbird_layout(H, nb, seed=1), empty):
        sa.reset_launch_counts()
        got = sparse_attention(q, k, v, layout, causal=causal, block=block)
        assert sparse_launches["sparse_attention_fwd"] == 1
        assert sa.route_counts["sparse_attention_fwd"][chosen] == 1
        lo = layout if not causal else layout & np.tril(np.ones((nb, nb), bool))
        want = masked_dense_attention(*(x.transpose(1, 2) for x in (q, k, v)), lo,
                                      causal=causal, sm_scale=D ** -0.5,
                                      block_q=block, block_k=block).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        sl = sa._compact_layout(layout, causal, q.device)
        forced = dict(causal=causal, sm_scale=D ** -0.5, block=block, route=route)
        if route == "wgmma" and dtype == torch.float32:
            with pytest.raises(ValueError, match="wgmma route"):
                sa.launch_sparse_fwd(q, k, v, torch.empty_like(q), sl, **forced)
            continue
        out = torch.full_like(q, float("nan"))
        sa.launch_sparse_fwd(q, k, v, out, sl, **forced)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert not got[:, :2 * block].float().any()
    qg, kg, vg = (x.float().requires_grad_(True) for x in (q, k, v))
    layout = fixed_layout(H, nb, num_local_blocks=2)
    (sparse_attention(qg, kg, vg, layout, causal=causal, block=block) ** 2).sum().backward()
    ref = [x.detach().clone().requires_grad_(True) for x in (qg, kg, vg)]
    lo = layout if not causal else layout & np.tril(np.ones((nb, nb), bool))
    (masked_dense_attention(*(x.transpose(1, 2) for x in ref), lo, causal=causal,
                            sm_scale=D ** -0.5, block_q=block, block_k=block)
     ** 2).sum().backward()
    for a, b in zip((qg, kg, vg), ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D,block", [(64, 64), (128, 128), (128, 16), (256, 16), (80, 32),
                                     (96, 256)])
def test_sparse_wgmma_is_bitwise_repeatable_on_card(D, block):
    """One block computes each item over its key tiles in a fixed order,
    with no float atomics, whichever persistent block it is dealt to: two
    launches give the same bits."""
    _need_card()
    B, S, H = 2, 4096, 8
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    sl = sa._compact_layout(bigbird_layout(H, S // block, seed=2), True, q.device)
    outs = []
    for _ in range(2):
        out = torch.empty_like(q)
        sa.launch_sparse_fwd(q, k, v, out, sl, causal=True, sm_scale=D ** -0.5, block=block,
                             route="wgmma")
        outs.append(out)
    assert torch.equal(*outs)


def test_sparse_wgmma_refuses_a_wrong_item_count_on_card(monkeypatch):
    """The wgmma kernel holds the number of items the host dealt (from its
    ``SM90_ROWS``) against its own decode: with the host's item rows halved
    the launch raises instead of leaving rows unwritten."""
    _need_card()
    monkeypatch.setattr(sa, "SM90_ROWS", sa.SM90_ROWS // 2)
    q = torch.randn(1, 512, 2, 64, device="cuda").to(torch.bfloat16)
    sl = sa._compact_layout(bigbird_layout(2, 8, seed=3), True, q.device)
    with pytest.raises(RuntimeError, match="launch failed"):
        sa.launch_sparse_fwd(q, q, q, torch.empty_like(q), sl, causal=True, sm_scale=0.125,
                             block=64, route="wgmma")


def test_sparse_attention_takes_strided_views_on_card():
    """The public function on ``[B, H, S, D]`` tensors transposed to ``[B,
    S, H, D]`` and on a slice of a fused QKV tensor gives the output and
    gradients of their contiguous copies (the kernels read contiguous
    copies of such views); the launch helper itself refuses the views."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(19)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    qkv = r(2, 512, 4, 3 * 64)
    views = [r(2, 4, 512, 64).transpose(1, 2), r(2, 4, 512, 64).transpose(1, 2),
             qkv[..., 2 * 64:]]
    w = r(2, 512, 4, 64)
    layout = bigbird_layout(4, 8, seed=5)
    outs = []
    for make in (lambda t: t, lambda t: t.contiguous()):
        leaves = [make(t).detach().requires_grad_(True) for t in views]
        sa.reset_launch_counts()
        out = sparse_attention(*leaves, layout, causal=True, block=64)
        assert sa.route_counts["sparse_attention_fwd"] == {"wgmma": 1, "mma_sync": 0}
        (out.float() * w.float()).sum().backward()
        outs.append([out.detach()] + [t.grad for t in leaves])
    assert not any(t.is_contiguous() for t in views)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    sl = sa._compact_layout(layout, True, views[0].device)
    with pytest.raises(ValueError, match="contiguous"):
        sa._validate_cuda(*views, sl, 64)


def test_sparse_kernel_rejects_what_it_was_not_built_for_on_card():
    """Head dims and blocks outside the lists raise in the wrapper, and the
    C entries of both routes refuse them when the launch helper is called
    past the wrapper's check."""
    _need_card()
    lo = np.ones((2, 4, 4), bool)
    y = torch.randn(1, 256, 2, 64, device="cuda", dtype=torch.bfloat16)
    for d in (32, 112):
        x = torch.randn(1, 256, 2, d, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            sparse_attention(x, x, x, lo, block=64)
        sl = sa._compact_layout(lo, True, x.device)
        with pytest.raises(RuntimeError, match="launch failed"):
            sa.launch_sparse_fwd(x, x, x, torch.empty_like(x), sl, causal=True,
                                 sm_scale=0.1, block=64, route="mma_sync")
    for block in (8, 48):
        y_ = y[:, :240] if block == 48 else y
        nb = y_.shape[1] // block
        with pytest.raises(ValueError, match="block"):
            sparse_attention(y_, y_, y_, np.ones((2, nb, nb), bool), block=block)
    sl = sa._compact_layout(np.ones((2, 32, 32), bool), True, y.device)
    for route in ("wgmma", "mma_sync"):
        with pytest.raises(RuntimeError, match="launch failed"):
            sa.launch_sparse_fwd(y, y, y, torch.empty_like(y), sl, causal=True, sm_scale=0.1,
                                 block=8, route=route)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sparse_attention(y.half(), y.half(), y.half(), lo, block=64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,block", [(1040, 16), (1056, 32), (1008, 16)])
def test_sparse_kernel_takes_a_ragged_last_item_on_card(S, block, dtype):
    """Below block 64, S need only be a multiple of the block: the last
    64-row item (32-row on the fp32 tile) runs past S, its rows there are
    neither read nor written, on both routes."""
    _need_card()
    B, H, D = 1, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(S)
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    nb = S // block
    layout = bigbird_layout(H, nb, seed=4)
    want = masked_dense_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                  layout & np.tril(np.ones((nb, nb), bool)), causal=True,
                                  sm_scale=D ** -0.5, block_q=block,
                                  block_k=block).transpose(1, 2)
    sl = sa._compact_layout(layout, True, q.device)
    for route in ("wgmma", "mma_sync") if dtype == torch.bfloat16 else ("mma_sync",):
        out = torch.empty(B, S + 64, H, D, device="cuda", dtype=dtype)
        out[:, S:] = 7.0
        o = out[:, :S]   # a view with rows after it: they must stay untouched
        sa.launch_sparse_fwd(q, k, v, o, sl, causal=True, sm_scale=D ** -0.5, block=block,
                             route=route)
        torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
        assert (out[:, S:] == 7.0).all()


def test_engine_kernel_path_matches_einsum_path_on_card():
    """The engine's kernel path and its einsum path give the same greedy
    tokens in float32 on a small seeded model."""
    _need_card()
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=97, hidden_size=256,
                            intermediate_size=192, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=256,
                            dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (7, 19, 40)]
    outs = []
    for backend in ("pallas", "einsum"):
        eng = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
            num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=16,
            attn_backend=backend), device="cuda")
        outs.append(eng.generate(prompts, max_new_tokens=12))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_megatron_shards_serve_on_the_paged_kernels_at_d64_on_card(tmp_path):
    """Megatron GPT-2 345M's widths at 2 layers (hidden 1024, 16 heads of D
    64, ffn 4096, vocab 50304), fp32: seeded weights saved as two tp
    shards of ``model_optim_rng.pt`` in Megatron's nesting, read by
    ``load_megatron_checkpoint``, merged by ``SDLoaderFactory`` (version 2),
    converted by ``megatron_config`` / ``megatron_params`` and put on the
    card; the engine's kernel path gives the einsum path's greedy tokens,
    its paged launches on the ``cuda_core`` route (fp32), a whole number
    per layer, and the einsum path launches none."""
    _need_card()
    import argparse

    from deepspeed_tpu_torch.checkpoint.state_dict_factory import (SDLoaderFactory,
                                                                   megatron_specs,
                                                                   split_state_dict)
    from deepspeed_tpu_torch.inference.megatron import (load_megatron_checkpoint,
                                                        megatron_config, megatron_params,
                                                        params_to_megatron)
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import init_params, params_from_jax
    from deepspeed_tpu_torch.models.convert import _flatten, _nest

    args = dict(hidden_size=1024, num_layers=2, num_attention_heads=16, ffn_hidden_size=4096,
                max_position_embeddings=1024, padded_vocab_size=50304)
    cfg = megatron_config(args)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    host = _nest({k: v.numpy() for k, v in _flatten(
        init_params(cfg32, seed=2, device="cpu", dtype=torch.float32)).items()})
    sd = params_to_megatron(host, cfg, version=2)
    qkv = {k: "interleaved" for k in sd if "query_key_value" in k}
    files = []
    for r in range(2):
        shard = split_state_dict(sd, r, 2, megatron_specs(sd), qkv_leaves=qkv, num_heads=16)
        nested = {}
        for k, v in shard.items():
            node = nested
            parts = k.split(".")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.from_numpy(np.array(v))
        files.append(tmp_path / f"mp_rank_{r:02d}" / "model_optim_rng.pt")
        files[-1].parent.mkdir()
        torch.save({"model": nested, "args": argparse.Namespace(**args),
                    "checkpoint_version": 2.0}, files[-1])
    loaded = [load_megatron_checkpoint(str(f)) for f in files]
    merged = SDLoaderFactory.get_sd_loader([flat for _, flat in loaded], version=2,
                                           num_heads=16, layout="megatron").load(1, 0)
    assert megatron_config(loaded[0][0], sd=merged) == cfg
    params = params_from_jax(megatron_params(merged, cfg, version=2), cfg32, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 50304, n).astype(np.int32) for n in (9, 70, 200)]
    outs = []
    for backend in ("pallas", "einsum"):
        eng = InferenceEngineV2(cfg32, params, RaggedInferenceEngineConfig(
            token_budget=64, max_ragged_sequence_count=4, max_chunk_size=32,
            num_kv_blocks=64, kv_block_size=16, max_blocks_per_seq=16,
            attn_backend=backend, decode_attn_backend=backend), device="cuda")
        port.reset_launch_counts()
        outs.append(eng.generate(prompts, max_new_tokens=12))
        launches = {k: port.launch_counts[k] for k in ("paged_attention",
                                                         "paged_flash_decode")}
        routes = {k: dict(port.route_counts[k]) for k in launches}
        if backend == "pallas":
            for k, n in launches.items():
                assert n > 0 and n % cfg.num_layers == 0, (k, n)
                assert routes[k] == {"sm90": 0, "cuda_core": n}, (k, routes[k])
        else:
            assert not any(launches.values()), launches
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_verify_step_on_the_packed_kernel_matches_einsum_on_card():
    """``verify_step`` (speculative decoding's check) over chunks of 1 + k
    tokens: the packed kernel, launched once per layer, gives the einsum
    path's next tokens and pools in float32, and the engine's
    ``spec_decode_batch`` streams on the kernel path are the einsum path's."""
    _need_card()
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig, model)
    from deepspeed_tpu_torch.inference.v2.ragged import RaggedBatchWrapper
    from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import \
        DSSequenceDescriptor
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=97, hidden_size=256, intermediate_size=192,
                            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
                            dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(9)
    bs, S, B = 8, 4, 16
    seqs = []
    for s, (ctx, k) in enumerate(((30, 4), (7, 0), (53, 2), (16, 4))):
        seq = DSSequenceDescriptor(uid=s, prompt_tokens=rng.integers(
            0, 97, ctx + 1 + k).astype(np.int32))
        seq.seen_tokens = ctx
        seq.blocks = list(range(1 + s * B, 1 + s * B + -(-(ctx + 1 + k) // bs)))
        seqs.append((seq, 1 + k))
    batch = RaggedBatchWrapper(token_budget=64, max_seqs=S, max_chunk=16,
                               max_blocks_per_seq=B).pack(
        [(seq, seq.next_tokens(n)) for seq, n in seqs], bs)
    shape = (cfg.num_layers, 1 + S * B, cfg.kv_heads, bs, cfg.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(3)
    k0 = torch.randn(shape, generator=gen, device="cuda")
    v0 = torch.randn(shape, generator=gen, device="cuda")
    d = lambda a: torch.from_numpy(a).cuda()
    fields = ("tokens", "positions", "gather_idx", "block_table", "kv_len",
              "start_pos", "chunk_len")
    got = {}
    for impl in ("pallas", "einsum"):
        kk, vv = k0.clone(), v0.clone()
        port.reset_launch_counts()
        nxt, _, _ = model.verify_step(params, cfg, kk, vv,
                                      *[d(getattr(batch, f)) for f in fields],
                                      attn_impl=impl)
        got[impl] = (nxt.cpu().numpy(), kk, vv, port.launch_counts["paged_attention"])
    assert got["pallas"][3] == cfg.num_layers and got["einsum"][3] == 0
    np.testing.assert_array_equal(got["pallas"][0], got["einsum"][0])
    # layer 0's rows are the same products; later layers' sum in another order
    for i in (1, 2):
        torch.testing.assert_close(got["pallas"][i][0], got["einsum"][i][0], rtol=0, atol=0)
        torch.testing.assert_close(got["pallas"][i], got["einsum"][i], rtol=1e-4, atol=1e-4)

    prompts = [np.tile(rng.integers(0, 97, n).astype(np.int32), 3) for n in (5, 8, 11)]
    streams = []
    for backend in ("pallas", "einsum"):
        eng = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
            num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=16,
            attn_backend=backend, spec_decode_k=4), device="cuda")
        eng.put([0, 1, 2], prompts, max_new_tokens=16)
        while any(s.in_prefill for s in eng.state_manager.all()):
            eng.step()
        while any(not s.done for s in eng.state_manager.all()):
            eng.spec_decode_batch()
        streams.append([eng.query(u)[1] for u in (0, 1, 2)])
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


def _close(got, want, tol):
    """Within ``tol`` of the reference's largest magnitude: the kernels sum
    in another order, and in bf16 a value may round one ulp apart."""
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
def test_flash_kernels_match_plain_versions_on_card(D, dtype, causal):
    """Forward (O, L) and both backward kernels against the plain versions:
    GQA 8/2 and a sequence that is not a multiple of the tile."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    B, S, H, Hk = 2, 200, 8, 2
    q, k, v, do = r(B, S, H, D), r(B, S, Hk, D), r(B, S, Hk, D), r(B, S, H, D)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    _close(o, o_ref, tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    got = fa.flash_attention_backward(q, k, v, o_ref, lse_ref, do, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        _close(g, w, 2 * tol)


def test_flash_wrapper_counts_launches_and_rejects_bad_inputs():
    _need_card()
    q = torch.randn(1, 128, 4, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    fa.reset_launch_counts()
    fa.flash_attention(q, k, k).sum().backward()
    assert fa.launch_counts == {"flash_attention_fwd": 1,
                                "flash_attention_bwd_dkdv": 1,
                                "flash_attention_bwd_dq": 1}
    with pytest.raises(ValueError, match="dtype|float32 or bfloat16"):
        fa.flash_attention_forward(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_forward(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                   k[..., :32].contiguous())
    # a head dim no source builds: attn_impl flash raises, auto takes the
    # plain attention, nothing launches
    q48, k48 = q[..., :48].contiguous(), k[..., :48].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        attention_core(q48, k48, k48, impl="flash")
    assert not fa.kernel_takes(q48)
    attention_core(q48, k48, k48, impl="auto")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                                   k, k)
    assert fa.launch_counts["flash_attention_fwd"] == 1


def _dkdv_inputs(B, S, H, Hk, D, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return r(B, S, H, D), r(B, S, Hk, D), r(B, S, Hk, D), r(B, S, H, D)


def _dkdv(q, k, v, do, causal, route=None):
    """dK, dV from one launch of the dK/dV kernel on ``route``, with O and L
    from the plain forward and delta taken as the backward wrapper takes it."""
    o, lse = fa.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa.launch_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, causal=causal,
                       sm_scale=q.shape[-1] ** -0.5, route=route)
    return dk, dv, o, lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
def test_flash_wgmma_dkdv_matches_plain_version_on_card(D, G, causal):
    """The wgmma dK/dV kernel (csrc/flash_attention_sm90.cu) against the
    plain backward: GQA groups of 1, 4 and 8, S 1000 (no multiple of its
    128-key or 64-query tiles, so TMA zero-fills past S inside a batch),
    two batches; rel 2e-2 of the reference's largest magnitude (P and dS
    round to bf16, and dK/dV sum such terms over S and the group)."""
    _need_card()
    B, S, Hk = 2, 1000, 2
    q, k, v, do = _dkdv_inputs(B, S, G * Hk, Hk, D, seed=40 + D + G)
    assert fa.flash_route(q, k, v, do) == "wgmma"
    fa.reset_launch_counts()
    dk, dv, o, lse = _dkdv(q, k, v, do, causal)
    assert fa.route_counts["flash_attention_bwd_dkdv"] == {"wgmma": 1, "mma_sync": 0}
    _, dk_r, dv_r = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    _close(dk, dk_r, 2e-2)
    _close(dv, dv_r, 2e-2)


@pytest.mark.parametrize("D", [64, 80, 96, 256])
def test_flash_wgmma_dkdv_is_bitwise_repeatable_on_card(D):
    """Each unit of the persistent schedule is summed by one block in a fixed
    order, with no float atomics: two launches give the same bits."""
    _need_card()
    q, k, v, do = _dkdv_inputs(2, 1024, 16, 2, D, seed=5)
    first = _dkdv(q, k, v, do, True, route="wgmma")[:2]
    second = _dkdv(q, k, v, do, True, route="wgmma")[:2]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("case", ["tinyllama cut to T 2048", "ragged tied"])
def test_fused_loss_wgmma_forward_matches_plain_version_on_card(case):
    """The wgmma forward (csrc/fused_loss_sm90.cu) against the plain
    forward: TinyLlama's head cut to 2048 tokens, and T 3007 / E 1000 / a
    tied vocab of 50257 (no multiple of its 256-column tile: the columns
    TMA zero-fills past V must stay out of the max and the sums), targets
    incl. -1, and the loss with z_loss 1e-2 through ``fused_vocab_nll``.
    The ragged case also runs the mma_sync forward on the same inputs."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    T, E, V, tied = (2048, 2048, 32000, False) if case.startswith("tiny") else \
        (3007, 1000, 50257, True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    h = torch.randn(T, E, generator=gen, device="cuda").to(torch.bfloat16)
    k = 0.02 * torch.randn(*((V, E) if tied else (E, V)), generator=gen, device="cuda")
    k = k.to(torch.bfloat16).T if tied else k.to(torch.bfloat16)
    t = torch.randint(-1, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    assert fl.loss_route(h, fl._layout(k)[1]) == "wgmma"
    fl.reset_launch_counts()
    lse, tgt = fl.fused_nll_forward(h, k, t)
    assert fl.fwd_route_counts == {"wgmma": 1, "mma_sync": 0}
    assert fl.launch_counts["fused_loss_fwd"] == fl.launch_counts["fused_loss_fwd_combine"] == 1
    lse_r, tgt_r = fl.fused_nll_fwd_ref(h, k, t)
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(tgt, tgt_r, rtol=1e-5, atol=1e-4)
    assert torch.all(tgt[t < 0] == 0)
    nll = fl.fused_vocab_nll(h, k, t, z_loss=1e-2)
    torch.testing.assert_close(nll, lse_r - tgt_r + 1e-2 * lse_r ** 2, rtol=1e-5, atol=1e-4)
    if tied:
        lse_m, tgt_m = fl.fused_nll_forward(h, k, t, route="mma_sync")
        torch.testing.assert_close(lse, lse_m, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(tgt, tgt_m, rtol=1e-5, atol=1e-4)


def test_wgmma_forward_and_dkdv_refuse_what_they_were_not_built_for_on_card():
    """A forced wgmma launch on tensors TMA cannot serve raises before any
    launch: the fused-loss forward on an untied head of rows of 3862 bytes,
    dK/dV in fp32; an unknown route raises too."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    h = torch.zeros(64, 128, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(128, 1931, device="cuda", dtype=torch.bfloat16)
    t = torch.zeros(64, device="cuda", dtype=torch.int32)
    fl.reset_launch_counts()
    with pytest.raises(ValueError, match="wgmma route"):
        fl.fused_nll_forward(h, k, t, route="wgmma")
    with pytest.raises(ValueError, match="route must be"):
        fl.fused_nll_forward(h, k, t, route="tiles")
    assert sum(fl.fwd_route_counts.values()) == 0
    q = torch.zeros(1, 128, 4, 64, device="cuda")
    kv = torch.zeros(1, 128, 2, 64, device="cuda")
    lse = torch.zeros(1, 4, 128, device="cuda")
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="wgmma route"):
        fa.launch_bwd_dkdv(q, kv, kv, q, lse, lse, kv.clone(), kv.clone(), causal=True,
                           sm_scale=0.125, route="wgmma")
    with pytest.raises(ValueError, match="route must be"):
        fa.launch_bwd_dkdv(q, kv, kv, q, lse, lse, kv.clone(), kv.clone(), causal=True,
                           sm_scale=0.125, route="tiles")
    assert sum(fa.route_counts["flash_attention_bwd_dkdv"].values()) == 0
    assert fa.launch_counts["flash_attention_bwd_dkdv"] == 0


def _fwd_dq(q, k, v, do, causal, route=None):
    """O, L from one launch of the forward kernel and dQ from one of the dQ
    kernel on ``route``, the dQ launch on the plain forward's O and L and
    delta taken as the backward wrapper takes it."""
    sm = q.shape[-1] ** -0.5
    o, lse = torch.empty_like(q), torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                              device="cuda")
    fa.launch_fwd(q, k, v, o, lse, causal=causal, sm_scale=sm, route=route)
    o_r, lse_r = fa.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * o_r.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q)
    fa.launch_bwd_dq(q, k, v, do, lse_r, delta, dq, causal=causal, sm_scale=sm, route=route)
    return o, lse, dq, o_r, lse_r


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
def test_flash_wgmma_forward_and_dq_match_plain_versions_on_card(D, G, causal):
    """The Q-stationary wgmma forward and dQ (csrc/flash_attention_sm90.cu)
    against the plain versions: GQA groups of 1 and 8, S 1000 (no multiple
    of the 128-query or 64 / 128-key tiles, so TMA zero-fills past S inside
    a batch and the last tile's rows are not written), two batches; O and
    dQ within rel 2e-2 of the reference's largest magnitude (P and dS round
    to bf16), L within 1e-3."""
    _need_card()
    B, S, Hk = 2, 1000, 2
    q, k, v, do = _dkdv_inputs(B, S, G * Hk, Hk, D, seed=60 + D + G)
    assert fa.flash_route(q, k, v) == fa.flash_route(q, k, v, do) == "wgmma"
    fa.reset_launch_counts()
    o, lse, dq, o_r, lse_r = _fwd_dq(q, k, v, do, causal)
    assert fa.route_counts["flash_attention_fwd"] == {"wgmma": 1, "mma_sync": 0}
    assert fa.route_counts["flash_attention_bwd_dq"] == {"wgmma": 1, "mma_sync": 0}
    _close(o, o_r, 2e-2)
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=1e-3)
    dq_r = fa.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, causal=causal)[0]
    _close(dq, dq_r, 2e-2)


@pytest.mark.parametrize("D", [64, 80, 96, 256])
def test_flash_wgmma_forward_and_dq_are_bitwise_repeatable_on_card(D):
    """One block computes each query tile over its key tiles in a fixed
    order, with no float atomics: two launches give the same bits."""
    _need_card()
    q, k, v, do = _dkdv_inputs(2, 1024, 16, 2, D, seed=7)
    first = _fwd_dq(q, k, v, do, True, route="wgmma")[:3]
    second = _fwd_dq(q, k, v, do, True, route="wgmma")[:3]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_wgmma_forward_and_dq_refuse_fp32_on_card():
    """A forced wgmma launch of the forward or dQ on fp32 tensors raises
    before any launch."""
    _need_card()
    q = torch.zeros(1, 128, 4, 64, device="cuda")
    kv = torch.zeros(1, 128, 2, 64, device="cuda")
    lse = torch.zeros(1, 4, 128, device="cuda")
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="wgmma route"):
        fa.launch_fwd(q, kv, kv, q.clone(), lse, causal=True, sm_scale=0.125, route="wgmma")
    with pytest.raises(ValueError, match="wgmma route"):
        fa.launch_bwd_dq(q, kv, kv, q, lse, lse, q.clone(), causal=True, sm_scale=0.125,
                         route="wgmma")
    assert sum(launches for launches in fa.launch_counts.values()) == 0
    assert all(sum(r.values()) == 0 for r in fa.route_counts.values())


@pytest.mark.parametrize("D", [64, 80, 96, 256])
@pytest.mark.parametrize("tiles", ["stationary", "streamed"])
@pytest.mark.parametrize("kernel", sorted(fa.launch_counts))
def test_flash_wgmma_kernels_refuse_tiles_they_do_not_use_on_card(monkeypatch, kernel, tiles,
                                                                   D):
    """Each wgmma kernel holds the count of units and items that the host
    dealt from ``SM90_TILES`` against its own decode of the units: with the
    host's stationary tile halved (more units) or its streamed tile halved
    (more items), the launch raises instead of leaving rows unwritten."""
    _need_card()
    tile, step = fa.SM90_TILES[kernel][D]
    monkeypatch.setitem(fa.SM90_TILES[kernel], D,
                        (tile // 2, step) if tiles == "stationary" else (tile, step // 2))
    monkeypatch.setattr(fa, "_SCHEDULES", {})
    q, k, v, do = _dkdv_inputs(1, 512, 4, 2, D, seed=11)
    lse = torch.zeros(1, 4, 512, device="cuda")
    sm = dict(causal=True, sm_scale=0.125, route="wgmma")
    with pytest.raises(RuntimeError, match="launch failed"):
        if kernel == "flash_attention_fwd":
            fa.launch_fwd(q, k, v, torch.empty_like(q), lse.clone(), **sm)
        elif kernel == "flash_attention_bwd_dkdv":
            fa.launch_bwd_dkdv(q, k, v, do, lse, lse, torch.empty_like(k),
                               torch.empty_like(v), **sm)
        else:
            fa.launch_bwd_dq(q, k, v, do, lse, lse, torch.empty_like(q), **sm)


def test_flash_attention_takes_transposed_views_on_card():
    """The public function on ``[B, H, S, D]`` tensors transposed to ``[B,
    S, H, D]`` gives the output and gradients of their contiguous copies
    (the kernels read contiguous copies of such views)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    views = [r(2, 8, 256, 64).transpose(1, 2), r(2, 2, 256, 64).transpose(1, 2),
             r(2, 2, 256, 64).transpose(1, 2)]
    w = r(2, 256, 8, 64)
    outs = []
    for make in (lambda t: t, lambda t: t.contiguous()):
        leaves = [make(t).detach().requires_grad_(True) for t in views]
        out = fa.flash_attention(*leaves)
        (out.float() * w.float()).sum().backward()
        outs.append([out.detach()] + [t.grad for t in leaves])
    assert not views[0].is_contiguous()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_kernel_matches_plain_version_on_card(adam_w_mode, bias_correction):
    """One launch over odd-sized tensors (16-byte and scalar paths, several
    chunks) against the plain version, in place and into ``updates``."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    sizes = [1, 7, 4096, adam.CHUNK + 5, 3 * adam.CHUNK]
    r = lambda n, s=1.0: s * torch.randn(n, generator=gen, device="cuda")
    g = [r(n, 0.1) for n in sizes]
    p = [r(n) for n in sizes]
    m = [r(n, 0.01) for n in sizes]
    v = [r(n, 0.001).abs() for n in sizes]
    kw = dict(lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction, step=5)
    want = [adam.adam_update_ref(*a, 3e-4, 0.9, 0.95, 1e-8, 0.1, adam_w_mode,
                                 bias_correction, 5) for a in zip(g, m, v, p)]
    adam.reset_launch_counts()
    mu, vu, u = [x.clone() for x in m], [x.clone() for x in v], [torch.empty_like(x) for x in g]
    adam.multi_tensor_adam(g, mu, vu, p, updates=u, **kw)
    mi, vi, pi = [x.clone() for x in m], [x.clone() for x in v], [x.clone() for x in p]
    adam.multi_tensor_adam(g, mi, vi, pi, **kw)
    assert adam.launch_counts["fused_adam"] == 2
    for i, (wu, wm, wv) in enumerate(want):
        for got, ref in ((u[i], wu), (mu[i], wm), (vu[i], wv), (mi[i], wm), (vi[i], wv),
                         (pi[i], p[i] + wu)):
            _close(got, ref, 1e-6)
    with pytest.raises(ValueError, match="float32"):
        adam.multi_tensor_adam([g[0].half()], [m[0]], [v[0]], [p[0]], lr=1e-3)


def test_auto_attention_takes_flash_kernels_at_ragged_length_on_card():
    """``auto`` on the card runs the flash kernels at a sequence that is not
    a multiple of 128, and agrees with the plain attention."""
    _need_card()
    from deepspeed_tpu_torch.models.transformer import attention_core

    gen = torch.Generator(device="cuda").manual_seed(5)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda").requires_grad_(True)
    q, k, v = r(2, 200, 8, 64), r(2, 200, 2, 64), r(2, 200, 2, 64)
    fa.reset_launch_counts()
    out = attention_core(q, k, v, impl="auto")
    out.sum().backward()
    assert fa.launch_counts == {"flash_attention_fwd": 1,
                                "flash_attention_bwd_dkdv": 1,
                                "flash_attention_bwd_dq": 1}
    _close(out.detach(), attention_core(q, k, v, impl="xla").detach(), 1e-4)


def test_config_adamw_launches_fused_adam_kernel_on_card():
    """The config route (``build_optimizer``) takes the kernel for tensors
    on the card: one launch per step over the whole tree."""
    _need_card()
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer

    tx = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 0.1})
    params = {"a": torch.ones(5, device="cuda"), "b": {"c": torch.ones(3, 7, device="cuda")}}
    grads = {"a": torch.full((5,), 0.5, device="cuda"),
             "b": {"c": torch.full((3, 7), -0.5, device="cuda")}}
    state = tx.init(params)
    adam.reset_launch_counts()
    state = tx.apply(grads, state, params)
    assert adam.launch_counts["fused_adam"] == 1 and state.step == 1
    # step 1 with bias correction: u = -lr * sign(g) - lr * wd * p
    _close(params["a"], torch.full((5,), 1 - 1e-3 - 1e-4, device="cuda"), 1e-6)
    _close(params["b"]["c"], torch.full((3, 7), 1 + 1e-3 - 1e-4, device="cuda"), 1e-6)


@pytest.mark.parametrize("offset", [4 * adam.CHUNK, 2 * adam.CHUNK + 3])
def test_fused_adam_on_a_shard_view_of_a_flat_buffer_on_card(offset):
    """ZeRO's update: the config route over a one-leaf list holding a view
    at a non-zero offset of a flat master buffer (16-byte aligned, and
    not), one launch, against the plain version; the rest of the buffer is
    untouched."""
    _need_card()
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer

    gen = torch.Generator(device="cuda").manual_seed(6)
    n = 3 * adam.CHUNK + 11
    flat = torch.randn(offset + n + 17, generator=gen, device="cuda")
    before = flat.clone()
    shard = flat[offset:offset + n]
    g = 0.1 * torch.randn(n, generator=gen, device="cuda")
    tx = build_optimizer("adamw", {"lr": 3e-4, "weight_decay": 0.1})
    state = tx.init([shard])
    want_p = before[offset:offset + n]
    for step in (1, 2):
        u, m, v = adam.adam_update_ref(g, state.exp_avg[0].clone(), state.exp_avg_sq[0].clone(),
                                       want_p, 3e-4, 0.9, 0.999, 1e-8, 0.1, True, True, step,
                                       pow_correction=True)
        want_p = want_p + u
        adam.reset_launch_counts()
        state = tx.apply([g], state, [shard])
        assert adam.launch_counts["fused_adam"] == 1
        _close(state.exp_avg[0], m, 1e-6)
        _close(state.exp_avg_sq[0], v, 1e-6)
        _close(shard, want_p, 1e-6)
    assert torch.equal(flat[:offset], before[:offset])
    assert torch.equal(flat[offset + n:], before[offset + n:])


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loss_kernels_match_plain_versions_on_card(dtype, tied):
    """Forward (lse, tgt), dl, dh and dK against the plain versions at a
    ragged token count, hidden size and vocab (several backward chunks),
    untied [E, V] and tied [V, E] heads, targets incl. -1."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    gen = torch.Generator(device="cuda").manual_seed(7)
    T, E, V = 517, 200, 1931
    h = torch.randn(T, E, generator=gen, device="cuda").to(dtype)
    k = 0.05 * torch.randn(*((V, E) if tied else (E, V)), generator=gen, device="cuda")
    k = k.to(dtype).T if tied else k.to(dtype)
    t = torch.randint(-1, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    fl.reset_launch_counts()
    lse, tgt = fl.fused_nll_forward(h, k, t)
    lse_r, tgt_r = fl.fused_nll_fwd_ref(h, k, t)
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(tgt, tgt_r, rtol=1e-5, atol=1e-4)
    g_lse = torch.rand(T, generator=gen, device="cuda") / T
    g_tgt = -(torch.rand(T, generator=gen, device="cuda") > 0.5).float() / T
    old = fl.WORKSPACE_BYTES
    fl.WORKSPACE_BYTES = T * 512 * h.element_size()    # 4 chunks of 512 columns
    try:
        dh, dk = fl.fused_nll_backward(h, k, t, lse_r, g_lse, g_tgt)
    finally:
        fl.WORKSPACE_BYTES = old
    want = fl.fused_nll_bwd_ref(h, k, t, lse_r, g_lse, g_tgt)
    for g, w in zip((dh, dk), want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        _close(g, w, tol)
    # rows of 400 bytes (h, the tied [V, E] head) take TMA; an untied row of
    # V = 1931 bf16 (3862 bytes) does not, and fp32 never does. The wgmma
    # forward merges its partials in a second launch
    route = "wgmma" if dtype == torch.bfloat16 and tied else "mma_sync"
    assert fl.launch_counts == {"fused_loss_fwd": 1,
                                "fused_loss_fwd_combine": int(route == "wgmma"),
                                "fused_loss_dlogits": 4, "fused_loss_dh": 4, "fused_loss_dk": 4}
    assert fl.route_counts == {"wgmma": 0, "mma_sync": 0, route: 12}
    assert fl.fwd_route_counts == {"wgmma": 0, "mma_sync": 0, route: 1}


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("T, E, V, vc", [(517, 200, 1928, 512), (4103, 520, 4104, 1536)])
def test_fused_loss_wgmma_route_matches_plain_versions_on_card(T, E, V, vc, tied):
    """The wgmma route (TMA + wgmma, csrc/fused_loss_sm90.cu) against the
    plain versions at token counts and hidden sizes that are no multiple of
    its 128 x 256 x 64 tile, a vocab that is no multiple of 128, several
    chunks (the last one ragged), untied and tied heads and targets incl.
    -1; the larger shape gives each block several output tiles. dl, dh and
    dK on that route, and one dl chunk against the plain dl."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    gen = torch.Generator(device="cuda").manual_seed(9)
    h = torch.randn(T, E, generator=gen, device="cuda").to(torch.bfloat16)
    k = 0.05 * torch.randn(*((V, E) if tied else (E, V)), generator=gen, device="cuda")
    k = k.to(torch.bfloat16).T if tied else k.to(torch.bfloat16)
    t = torch.randint(-1, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    kvt, base = fl._layout(k)
    assert fl.backward_route(h, base) == "wgmma"
    lse, _ = fl.fused_nll_fwd_ref(h, k, t)
    g_lse = torch.rand(T, generator=gen, device="cuda") / T
    g_tgt = -(torch.rand(T, generator=gen, device="cuda") > 0.5).float() / T
    old = fl.WORKSPACE_BYTES
    fl.WORKSPACE_BYTES = T * vc * h.element_size()
    fl.reset_launch_counts()
    try:
        dh, dk = fl.fused_nll_backward(h, k, t, lse, g_lse, g_tgt)
    finally:
        fl.WORKSPACE_BYTES = old
    n_chunks = -(-V // vc)
    assert fl.route_counts == {"wgmma": 3 * n_chunks, "mma_sync": 0}
    want = fl.fused_nll_bwd_ref(h, k, t, lse, g_lse, g_tgt)
    for g, w in zip((dh, dk), want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        _close(g, w, 2e-2)
    # the last (ragged) chunk's dl, and the workspace columns past it hold 0
    v0 = (n_chunks - 1) * vc
    width = V - v0
    ws = torch.full((T, vc), float("nan"), device="cuda").to(torch.bfloat16)
    fl.launch_dlogits(h, base, t, lse, g_lse, g_tgt, ws, v0, width, kvt, "wgmma")
    _close(ws[:, :width], fl.fused_dlogits_ref(h, k, t, lse, g_lse, g_tgt, v0, width), 2e-2)
    tile_end = min(vc, -(-width // 256) * 256)
    assert torch.all(ws[:, width:tile_end] == 0)


def test_fused_loss_routes_refuse_what_they_were_not_built_for_on_card():
    """Forcing the wgmma route on operands TMA cannot describe raises before
    any launch; an unknown route raises too."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    T, E, V = 64, 128, 1931
    h = torch.zeros(T, E, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(E, V, device="cuda", dtype=torch.bfloat16)
    t = torch.zeros(T, device="cuda", dtype=torch.int32)
    f = torch.zeros(T, device="cuda")
    ws = torch.empty(T, 2048, device="cuda", dtype=torch.bfloat16)
    assert fl.backward_route(h, k) == "mma_sync"
    fl.reset_launch_counts()
    with pytest.raises(ValueError, match="wgmma route"):
        fl.launch_dlogits(h, k, t, f, f, f, ws, 0, V, 0, "wgmma")
    with pytest.raises(ValueError, match="route must be"):
        fl.launch_dk(h, ws, k, 0, V, 0, "tiles")
    assert sum(fl.route_counts.values()) == 0


def test_auto_loss_takes_fused_kernels_for_gpt2_vocab_on_card():
    """``loss_impl: auto`` on the card runs the fused kernels at a vocab of
    50257 (not a multiple of 128) and agrees with the dense loss."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl
    from deepspeed_tpu_torch.sequence import sharded_lm_loss

    gen = torch.Generator(device="cuda").manual_seed(8)
    h = torch.randn(2, 64, 96, generator=gen, device="cuda").requires_grad_(True)
    k = (0.05 * torch.randn(96, 50257, generator=gen, device="cuda")).requires_grad_(True)
    tokens = torch.randint(0, 50257, (2, 64), generator=gen, device="cuda")
    fl.reset_launch_counts()
    got = sharded_lm_loss(h, k, tokens)
    g_got = torch.autograd.grad(got, (h, k))
    assert fl.launch_counts["fused_loss_fwd"] == 1 and fl.launch_counts["fused_loss_dk"] >= 1
    want = sharded_lm_loss(h, k, tokens, loss_impl="xla")
    g_want = torch.autograd.grad(want, (h, k))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(g_got, g_want):
        _close(g, w, 1e-4)


def test_fp16_model_with_auto_loss_trains_through_dense_loss_on_card():
    """The fused-loss kernels are built for fp32 and bf16 only: an fp16
    model under an fp16 engine with ``loss_impl: auto`` trains through the
    dense loss, launching none of them, and its loss falls."""
    _need_card()
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerConfig, TransformerLM, init_params,
                                            make_loss_fn)
    from deepspeed_tpu_torch.ops import fused_loss as fl

    cfg = TransformerConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                            num_layers=2, num_heads=2, num_kv_heads=1, max_seq_len=64,
                            dtype=torch.float16, loss_impl="auto")
    params = init_params(cfg, seed=3, device="cuda", dtype=torch.float32)
    engine = dst.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                            model_parameters=params,
                            config={"train_micro_batch_size_per_gpu": 2,
                                    "gradient_accumulation_steps": 1,
                                    "optimizer": {"type": "adamw", "params": {"lr": 3e-3}},
                                    "fp16": {"enabled": True, "initial_scale_power": 8},
                                    "steps_per_print": 10**9})[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = torch.randint(0, 256, (2, 64), generator=gen, device="cuda")
    fl.reset_launch_counts()
    losses = [float(engine.train_batch(batch)) for _ in range(6)]
    assert all(n == 0 for n in fl.launch_counts.values()), fl.launch_counts
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_checkpoint_round_trip_is_bitwise_on_card(tmp_path):
    """Save after two steps, load into a fresh engine on the card: the
    masters, moments, step and LR are bitwise the saved ones, and the next
    step gives the same loss as the engine that was saved."""
    _need_card()
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import (TransformerConfig, TransformerLM, init_params,
                                            make_loss_fn)
    from torch.utils import _pytree as pytree

    cfg = TransformerConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                            num_layers=2, num_heads=2, num_kv_heads=1, max_seq_len=128,
                            dtype=torch.bfloat16)
    init = init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "bf16": {"enabled": True}, "steps_per_print": 10**9}
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = torch.randint(0, 256, (4, 128), generator=gen, device="cuda")

    def engine():
        p = pytree.tree_map(lambda x: x.clone(), init)
        return dst.initialize(model=make_loss_fn(TransformerLM(cfg, p)), model_parameters=p,
                              config=config)[0]

    def state(e):
        return list(e._masters) + pytree.tree_leaves(e.state.opt_state) + [
            e.state.step, e.get_lr()[0]]

    first = engine()
    for _ in range(2):
        first.train_batch(batch)
    first.save_checkpoint(str(tmp_path))
    resumed = engine()
    resumed.load_checkpoint(str(tmp_path))
    for a, b in zip(state(resumed), state(first)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert float(resumed.train_batch(batch)) == float(first.train_batch(batch))


@pytest.mark.parametrize("block", [2048, 512, 128])
@pytest.mark.parametrize("n", [1, 2048, 2048 * 37 + 37])
def test_quant_kernels_match_plain_versions_on_card(n, block):
    """quantize (nearest and stochastic) and dequantize bitwise against
    their plain versions; the stochastic kernel draws the plain version's
    Philox words, and its pad lanes stay 0."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n + block)
    x = torch.randn(n, generator=gen, device="cuda")
    nb = -(-n // block)
    quant.reset_launch_counts()
    q, s, shape = quant.quantize_int8(x, block)
    q_ref, s_ref = quant.quantize_ref(x, n, nb, block)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert torch.equal(quant.dequantize_int8(q, s, shape), quant.dequantize_ref(q, s, n))
    seed = quant.draw_seed(torch.Generator().manual_seed(3))
    q_sr, s_sr, _ = quant.quantize_int8(x, block, stochastic=True,
                                        key=torch.Generator().manual_seed(3))
    assert torch.equal(q_sr, quant.quantize_ref(x, n, nb, block, seed)[0])
    assert torch.equal(s_sr, s) and bool((q_sr.view(-1)[n:] == 0).all())
    assert quant.launch_counts == {"quantize_int8": 1, "quantize_int8_sr": 1,
                                   "dequantize_int8": 1}
    with pytest.raises(ValueError, match="block"):
        quant.quantize_int8(x, 100)


def test_two_rank_gloo_step_on_card(tmp_path):
    """Two ranks share cuda:0 over gloo for one int8-compressed step: 2
    quantize and 2 dequantize launches per rank, the masters bitwise equal
    across the ranks."""
    _need_card()
    rng = np.random.default_rng(0)
    from deepspeed_tpu_torch.models import convert, init_params
    from deepspeed_tpu_torch.models.transformer import TransformerConfig

    model = dict(vocab_size=97, hidden_size=64, intermediate_size=96, num_layers=2,
                 num_heads=4, num_kv_heads=2, max_seq_len=32)
    params = convert._flatten(init_params(TransformerConfig(**model), device="cpu",
                                          dtype=torch.float32))
    inputs = {"model": model, "params": convert._nest({k: v.numpy() for k, v in params.items()}),
              "batches": [rng.integers(0, 97, (8, 32)).astype(np.int64)],
              "config": {"train_micro_batch_size_per_gpu": 2,
                         "gradient_accumulation_steps": 2, "steps_per_print": 10**9,
                         "training_fastpath": {"attn_impl": "xla", "loss_impl": "xla"}}}
    r0, r1 = run_world("cuda_step", 2, tmp_path, inputs, timeout=300)
    assert r0["mode"] == "int8" and r0["loss"] == r1["loss"]
    want = {"quantize_int8": 2, "quantize_int8_sr": 0, "dequantize_int8": 2}
    assert r0["launches"] == r1["launches"] == want
    for a, b in zip(r0["masters"], r1["masters"]):
        np.testing.assert_array_equal(a, b)


def test_auto_attention_takes_flash_kernels_at_the_new_head_dims_on_card():
    """``attn_impl: auto`` picks the kernels at D 80, 96 and 256 on the card,
    bf16 on ``wgmma``: one launch of each kernel per forward and backward."""
    _need_card()
    for D in (80, 96, 256):
        q, k, v, do = _dkdv_inputs(1, 300, 4, 2, D, seed=D)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        fa.reset_launch_counts()
        attention_core(*leaves, impl="auto").backward(do)
        for name in fa.launch_counts:
            assert fa.route_counts[name] == {"wgmma": 1, "mma_sync": 0}, (D, name)


def test_engine_serves_phi3_widths_through_einsum_on_card():
    """A 2-layer model at phi-3-mini widths (hidden 3072, 32 / 32 heads, D
    96) serves to completion on the card through the paged kernels:
    ``auto`` resolves both attention paths to them and they launch (fp32:
    the CUDA-core route), with the tokens of the same engine on the einsum
    path (``attn_backend="einsum"``; float32 and exact tokens, as
    ``test_engine_kernel_path_matches_einsum_path_on_card``). At a head dim
    the kernels do not build (112) ``auto`` resolves both paths to the
    einsum, no paged kernel launches, and the tokens equal those of the same
    weights served on the CPU through the paged kernels' plain versions
    (``attn_backend="pallas"``, which take any D). An explicit ``"pallas"``
    there raises at the kernel on the card, on the packed path and on the
    decode path alone."""
    _need_card()
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    def weights(hidden):
        cfg = TransformerConfig(vocab_size=32064, hidden_size=hidden, intermediate_size=8192,
                                num_layers=2, num_heads=32, num_kv_heads=32, max_seq_len=256,
                                norm_eps=1e-5, dtype=torch.float32)
        return cfg, init_params(cfg, seed=0, device="cuda", dtype=torch.float32)

    def engine(weights, device="cuda", **backends):
        cfg, params = weights
        return InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            token_budget=32, max_ragged_sequence_count=4, max_chunk_size=16,
            num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=16, dtype="float32",
            **backends), device=device)

    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 32064, n).astype(np.int32) for n in (7, 19, 40)]
    phi3 = weights(3072)
    port.reset_launch_counts()
    auto = engine(phi3)
    assert auto.cfg.head_dim == 96
    assert (auto.attn_impl, auto.decode_attn_impl, auto.decode_attn_source) == \
        ("pallas", "pallas", "heuristic")
    got = auto.generate(prompts, max_new_tokens=12)
    assert port.launch_counts["paged_attention"] > 0
    assert port.launch_counts["paged_flash_decode"] > 0
    assert port.route_counts["paged_attention"]["sm90"] == 0   # fp32: the CUDA cores
    einsum = engine(phi3, attn_backend="einsum")
    assert (einsum.attn_impl, einsum.decode_attn_impl) == ("einsum", "einsum")
    for a, b in zip(got, einsum.generate(prompts, max_new_tokens=12)):
        assert len(a) == 12
        np.testing.assert_array_equal(a, b)
    del auto, einsum, phi3
    d112 = weights(32 * 112)
    unbuilt = engine(d112)
    assert unbuilt.cfg.head_dim == 112
    assert (unbuilt.attn_impl, unbuilt.decode_attn_impl) == ("einsum", "einsum")
    port.reset_launch_counts()
    got = unbuilt.generate(prompts, max_new_tokens=12)
    assert sum(port.launch_counts.values()) == 0
    plain = engine(d112, "cpu", attn_backend="pallas")
    assert (plain.attn_impl, plain.decode_attn_impl) == ("pallas", "pallas")
    for a, b in zip(got, plain.generate(prompts, max_new_tokens=12)):
        assert len(a) == 12
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="head_dim 112"):
        engine(d112, attn_backend="pallas").generate(prompts[:1], max_new_tokens=2)
    decode_only = engine(d112, attn_backend="einsum", decode_attn_backend="pallas")
    assert (decode_only.attn_impl, decode_only.decode_attn_impl) == ("einsum", "pallas")
    with pytest.raises(ValueError, match="head_dim 112"):
        decode_only.generate(prompts[:1], max_new_tokens=2)


@pytest.mark.parametrize("kernel", ["packed", "decode"])
def test_paged_functions_take_q_sliced_from_fused_qkv_on_card(kernel):
    """q sliced from a fused QKV tensor goes through the public paged
    functions on the card and gives the bits of its contiguous copy; the
    launch helpers refuse it before any launch."""
    _need_card()
    rng = np.random.default_rng(31)
    Hq, Hk, D = 8, 2, 128
    dev = torch.device("cuda")
    if kernel == "packed":
        q, k, v, bt, start, chunk, kvl = _packed(rng, torch.bfloat16, 3, 16, Hq, Hk, D, 32,
                                                 8, [40, 77, 130], [16, 9, 1])
        qkv = torch.randn(3, 16, Hq + 2 * Hk, D, device=dev).to(torch.bfloat16)
        ints = (bt, start, chunk, kvl)
        call = lambda qq: port.paged_attention(qq, k, v, *ints)
        launch = lambda qq: port.launch_paged_attention(
            qq, k, v, *ints, torch.empty(qq.shape, device=dev, dtype=qq.dtype), None, None,
            sm_scale=1.0)
    else:
        bt, used = _tables(3, 8, 32, [40, 77, 130])
        f = lambda *shape: torch.randn(shape, device=dev).to(torch.bfloat16)
        k, v = f(2, used + 1, Hk, 32, D), f(2, used + 1, Hk, 32, D)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        ints = (i(bt), i([39, 76, 129]), i([40, 77, 130]))
        qkv = f(3, Hq + 2 * Hk, D)
        call = lambda qq: port.paged_flash_decode(qq, k, v, *ints, layer=1)
        launch = lambda qq: port.launch_paged_flash_decode(
            qq, k, v, *ints, torch.empty(qq.shape, device=dev, dtype=qq.dtype), None, None,
            layer=1, sm_scale=1.0)
    q_view = qkv[..., :Hq, :]
    assert not q_view.is_contiguous()
    port.reset_launch_counts()
    got, want = call(q_view), call(q_view.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    launched = dict(port.launch_counts)
    with pytest.raises(ValueError, match="contiguous"):
        launch(q_view)
    assert port.launch_counts == launched


def test_fused_vocab_nll_takes_a_sliced_head_on_card(monkeypatch):
    """``kernel[:, :V]`` of a bf16 head padded past the vocab (E 1024, V
    32000 of 32128): the public function takes it, its value matches the
    plain version's and dK reaches the padded head's first V columns only,
    matching the plain backward; a tied ``[V, E]`` head is still read in
    place (no copy of the head is made)."""
    _need_card()
    from deepspeed_tpu_torch.ops import fused_loss as fl

    T, E, V, Vp = 1024, 1024, 32000, 32128
    gen = torch.Generator(device="cuda").manual_seed(13)
    h = torch.randn(T, E, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_(True)
    padded = (0.02 * torch.randn(E, Vp, generator=gen, device="cuda")).to(torch.bfloat16)
    padded.requires_grad_(True)
    t = torch.randint(0, V, (T,), generator=gen, device="cuda", dtype=torch.int32)
    view = padded[:, :V]
    assert not (view.is_contiguous() or view.T.is_contiguous())
    nll = fl.fused_vocab_nll(h, view, t)
    nll.sum().backward()
    kv = view.detach().contiguous()
    lse_r, tgt_r = fl.fused_nll_fwd_ref(h.detach(), kv, t)
    torch.testing.assert_close(nll.detach(), lse_r - tgt_r, rtol=1e-5, atol=1e-4)
    ones = torch.ones(T, device="cuda")
    dh_r, dk_r = fl.fused_nll_bwd_ref(h.detach(), kv, t, lse_r, ones, -ones)
    _close(h.grad, dh_r, 2e-2)
    _close(padded.grad[:, :V], dk_r, 2e-2)
    assert torch.all(padded.grad[:, V:] == 0)
    emb = (0.02 * torch.randn(V, E, generator=gen, device="cuda")).to(torch.bfloat16)
    heads, apply = [], fl._FusedNLL.apply
    monkeypatch.setattr(fl._FusedNLL, "apply",
                        lambda hh, kk, tt: heads.append(kk) or apply(hh, kk, tt))
    tied = fl.fused_vocab_nll(h.detach(), emb.T, t)
    assert heads[0].data_ptr() == emb.data_ptr() and fl._layout(heads[0])[0] == 1
    lse_r, tgt_r = fl.fused_nll_fwd_ref(h.detach(), emb.T, t)
    torch.testing.assert_close(tied, lse_r - tgt_r, rtol=1e-5, atol=1e-4)


def test_host_adam_matches_its_plain_version_on_the_cards_host():
    """The host Adam built with the card machine's g++: bitwise its plain
    version over three steps at odd sizes, AdamW and L2, fp32 and bf16
    gradients, with the bf16 emission."""
    _need_card()
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam, cpu_adam_reference

    gen = torch.Generator().manual_seed(3)
    sizes = [1, 3, 4097, 70001, 1 << 20]
    for adamw in (True, False):
        ps = [torch.randn(n, generator=gen) for n in sizes]
        opt = DeepSpeedCPUAdam(ps, lr=3e-4, betas=(0.9, 0.95), weight_decay=0.1,
                               adamw_mode=adamw)
        ref = [(p.clone(), torch.zeros_like(p), torch.zeros_like(p)) for p in ps]
        for step in range(1, 4):
            gs = [0.1 * torch.randn(n, generator=gen) for n in sizes]
            if step == 2:
                gs = [g.to(torch.bfloat16) for g in gs]
            out = opt.step(gs, emit_bf16=True)
            ref = [cpu_adam_reference(*r, g, 3e-4, (0.9, 0.95), 1e-8, 0.1, adamw, True, step)
                   for r, g in zip(ref, gs)]
        for got, (p, m, v), o in zip(zip(*opt.leaves()), ref, out):
            assert torch.equal(got[0], p) and torch.equal(got[1], m) and torch.equal(got[2], v)
            assert torch.equal(o, p.to(torch.bfloat16))


def test_offload_step_of_a_two_layer_model_on_card():
    """One host-Adam step of a 2-layer bf16 model on the card: no optimizer
    state on the card, no fused-Adam launch, the compute leaves bitwise the
    bf16 of the host masters after the step, and the loss finite."""
    _need_card()
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)

    cfg = llama_config("1b", num_layers=2, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    eng, *_ = tds.initialize(
        model=make_loss_fn(TransformerLM(cfg, params)), model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 2,
                "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
                "zero_optimization": {"offload_optimizer": {"device": "cpu",
                                                            "grad_dtype": "bfloat16"}},
                "steps_per_print": 10**9})
    assert eng._host_adam is not None and eng.state.opt_state == ()
    adam.reset_launch_counts()
    batch = torch.randint(0, cfg.vocab_size, (2, 1, 512), device="cuda")
    loss = float(eng.train_batch(batch))
    torch.cuda.synchronize()
    assert np.isfinite(loss) and adam.launch_counts["fused_adam"] == 0
    assert eng._host_adam.step_count == 1
    for leaf, master in zip(eng._masters, eng._host_adam.leaves()[0]):
        assert leaf.dtype == torch.bfloat16 and leaf.is_cuda
        assert torch.equal(leaf.detach().cpu(), master.to(torch.bfloat16))
    assert set(eng.offload_timings()) == {"d2h", "host_adam", "h2d"}


def test_stage3_gathers_units_on_use_on_card(tmp_path):
    """Two ranks share cuda:0 over gloo at ZeRO stage 3: the first loss
    bitwise stage 0's, the later close, with and without per-layer remat
    (whose recompute gathers each layer from the autograd engine's device
    thread), at most MAX_LIVE units at once, none left gathered."""
    _need_card()
    from deepspeed_tpu_torch.models import convert, init_params
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    from deepspeed_tpu_torch.runtime.zero.stage3 import MAX_LIVE

    rng = np.random.default_rng(1)
    model = dict(vocab_size=97, hidden_size=64, intermediate_size=96, num_layers=2,
                 num_heads=4, num_kv_heads=2, max_seq_len=32)
    params = convert._flatten(init_params(TransformerConfig(**model), device="cpu",
                                          dtype=torch.float32))
    inputs = {"model": model, "params": convert._nest({k: v.numpy() for k, v in params.items()}),
              "batches": [rng.integers(0, 97, (8, 32)).astype(np.int64) for _ in range(3)],
              "config": {"train_micro_batch_size_per_gpu": 2,
                         "gradient_accumulation_steps": 2, "steps_per_print": 10**9,
                         "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                         "training_fastpath": {"attn_impl": "xla", "loss_impl": "xla"}}}
    r0, r1 = run_world("cuda_stage3", 2, tmp_path, inputs, timeout=300)
    ref = r0["stage0"]
    for name in ("stage3", "stage3_remat"):
        got = r0[name]
        assert r1[name] == got and got[0] == ref[0]
        np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-5)
        for r in (r0, r1):
            assert max(r[name + "/peaks"].values()) <= MAX_LIVE
            assert r[name + "/live_after"] == []


def test_ring_walk_on_card_is_bitwise_the_walk_on_the_cpu(monkeypatch):
    """The host-Adam step through the pinned ring with 64 KiB chunks (leaves
    split across them): the same weights and gradients on the card and on
    the CPU (no clipping: the two devices' norms may round apart) give the
    same host masters and moments and the same bf16 leaves, bitwise; one
    step counted, a host launch per slice."""
    _need_card()
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)
    from deepspeed_tpu_torch.ops import adam as host_adam
    from deepspeed_tpu_torch.runtime import engine as teng

    monkeypatch.setattr(teng, "HOST_RING_CHUNK_BYTES", 1 << 16)
    cfg = llama_config("tiny", num_layers=2, dtype=torch.bfloat16)
    config = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 2,
              "bf16": {"enabled": True}, "gradient_clipping": 0.0,
              "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
              "zero_optimization": {"offload_optimizer": {"device": "cpu",
                                                          "grad_dtype": "bfloat16"}},
              "steps_per_print": 10**9}
    init = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    engines = {}
    for device in ("cuda", "cpu"):
        params = torch.utils._pytree.tree_map(lambda x: x.to(device, copy=True), init)
        engines[device], *_ = tds.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                                             model_parameters=params, config=config,
                                             device=device)
    card, cpu = engines["cuda"], engines["cpu"]
    slices = sum(len(c) for c in card._ring_plan)
    assert len(card._ring_plan) > 1 and slices > len(card._masters)
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        g = torch.randn(card._acc.numel(), generator=gen)
        host_adam.reset_launch_counts()
        for eng in (card, cpu):
            eng._acc.copy_(g)
            eng._apply()
        torch.cuda.synchronize()
        assert host_adam.launch_counts["cpu_adam"] == 2 * slices
    assert all(t.is_pinned() for side in card._ring for t in side)
    assert card._host_adam.step_count == cpu._host_adam.step_count == 2
    for a, b in zip(card._host_adam.leaves(), cpu._host_adam.leaves()):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(card._masters, cpu._masters):
        assert torch.equal(a.detach().cpu(), b.detach())
    assert set(card.offload_timings()) == {"d2h", "host_adam", "h2d"}


def test_offload_params_frees_the_cards_blocks_on_card():
    """offload_states(include=("params",)) at stage 0 on the card: the
    allocated memory drops by the allocator blocks that hold the params, the
    tensors come back the same objects, bitwise."""
    _need_card()
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import (TransformerLM, init_params, llama_config,
                                            make_loss_fn)

    cfg = llama_config("tiny", num_layers=2, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    eng, *_ = tds.initialize(model=make_loss_fn(TransformerLM(cfg, params)),
                             model_parameters=params,
                             config={"train_micro_batch_size_per_gpu": 1,
                                     "bf16": {"enabled": True}, "steps_per_print": 10**9})
    eng.train_batch(torch.randint(0, cfg.vocab_size, (1, 1, 64), device="cuda"))
    ids = [id(p) for p in eng._masters]
    before = [p.detach().clone() for p in eng._masters]
    # the allocator's blocks that hold the params (a block may exceed its
    # request: 512-byte granules, and a cached block whose remainder is too
    # small to split is handed out whole)
    starts = {p.untyped_storage().data_ptr() for p in eng._masters}
    blocks = 0
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for block in seg["blocks"]:
            if addr in starts and block["state"] == "active_allocated":
                blocks += block["size"]
            addr += block["size"]
    assert blocks >= sum(p.numel() * p.element_size() for p in eng._masters)
    gc.collect()              # the step's unreachable tensors go before the count
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng.offload_states(include=("params",), device="cpu")
    assert mem0 - torch.cuda.memory_allocated() == blocks
    eng.reload_states()
    assert [id(p) for p in eng._masters] == ids
    assert all(torch.equal(p.detach(), b) for p, b in zip(eng._masters, before))


def test_prefetch_loader_copies_on_a_side_stream_on_card():
    """PrefetchLoader's default device is the card: each yielded leaf is a
    CUDA tensor equal to its host batch, in order, over a pool of pinned
    buffers reused across more batches than it holds; the consumer's
    stream waited for the copies, so a kernel reading the batch sees it
    whole."""
    _need_card()
    from deepspeed_tpu_torch.runtime.dataloader import PrefetchLoader

    batches = [{"tokens": np.full((4, 2048), i, np.int64),
                "mask": np.full((4, 2048), i % 2, np.float32)} for i in range(9)]
    pf = PrefetchLoader(batches, depth=2)
    sums, devices = [], set()
    for b in pf:
        sums.append((b["tokens"].sum(), b["mask"].sum()))
        devices |= {b["tokens"].device.type, b["mask"].device.type}
    assert devices == {"cuda"}
    assert [(int(a), float(m)) for a, m in sums] == [(i * 4 * 2048, (i % 2) * 4 * 2048)
                                                     for i in range(9)]
    assert all(len(pool) <= pf.depth + 1 for pool in pf._pool.values())
    assert all(buf.is_pinned() for pool in pf._pool.values() for buf, _ in pool)


def test_lamb_step_on_card_matches_the_cpu():
    """One LAMB step (the config route) on tensors on the card equals the
    same step on the CPU within fp32 summation noise: the Adam direction,
    the per-tensor trust ratio and no fused-Adam launch."""
    _need_card()
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer

    gen = torch.Generator().manual_seed(0)
    host = {"w": torch.randn(300, 70, generator=gen), "b": torch.randn(70, generator=gen),
            "z": torch.zeros(5)}
    grads = {k: 0.1 * torch.randn(v.shape, generator=gen) for k, v in host.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        tx = build_optimizer("Lamb", {"lr": 1e-2, "weight_decay": 0.01})
        p = {k: v.to(dev) for k, v in host.items()}
        state = tx.init(p)
        adam.reset_launch_counts()
        u, state = tx.update({k: v.to(dev) for k, v in grads.items()}, state, p)
        assert adam.launch_counts["fused_adam"] == 0 and state.step == 1
        out[dev] = ({k: v.cpu() for k, v in u.items()}, tx.update.last_trust.cpu())
    for k in host:
        _close(out["cuda"][0][k], out["cpu"][0][k], 1e-5)
    _close(out["cuda"][1], out["cpu"][1], 1e-5)
    assert float(out["cuda"][1][2]) == 1.0        # ||p|| = 0: trust ratio 1


def test_two_replica_kill_drill_at_two_layers_on_card(tmp_path):
    """Two replicas of a 2-layer model at Llama-2-7B's widths (bf16) on
    ``cuda:0`` behind a ``ReplicaRouter``: a chaos ``replica_kill`` stops
    replica 1 mid-generation, its beacon ages past ``dead_after_s`` on an
    injected clock, ``check()`` takes it over, and every request finishes by
    length on replica 0, the requeued ones resumed (their tokens up to the
    checkpoint kept). Both paged kernels launched on ``sm90``, a whole
    number of times per layer."""
    _need_card()
    import time

    from deepspeed_tpu_torch.models import init_params, llama_config
    from deepspeed_tpu_torch.runtime.resilience import chaos
    from deepspeed_tpu_torch.runtime.resilience.heartbeat import FileHeartbeatTransport
    from deepspeed_tpu_torch.serving import (FINISH_LENGTH, LLMServer, ReplicaRouter,
                                             Request)

    cfg = llama_config("7b", dtype=torch.bfloat16, num_layers=2)
    block = {"policy": "deadline", "fused_decode_chunk": 8, "heartbeat_interval_s": 0.005,
             "engine": dict(token_budget=256, max_ragged_sequence_count=8,
                            max_chunk_size=128, kv_block_size=32, max_blocks_per_seq=16,
                            num_kv_blocks=96, dtype="bfloat16")}
    wall = [1000.0]
    servers = [LLMServer.from_config(cfg, init_params(cfg, seed=i, device="cuda",
                                                      dtype=torch.bfloat16),
                                     block, replica_id=i) for i in range(2)]
    router = ReplicaRouter(servers, transport=FileHeartbeatTransport(str(tmp_path)),
                           dead_after_s=5.0, clock=lambda: wall[0]).start()
    chaos.configure_chaos(chaos.ChaosSchedule([
        chaos.ChaosEvent(kind="replica_kill", site="replica1", at=10)]))
    try:
        port.reset_launch_counts()
        rng = np.random.default_rng(3)
        resps = [router.submit(Request(rng.integers(0, 32000, n).astype(np.int32),
                                       max_new_tokens=48), block=True)
                 for n in (40, 200, 90, 300, 17, 128)]
        deadline = time.monotonic() + 300
        while servers[1]._thread.is_alive():
            assert time.monotonic() < deadline, "the chaos kill never landed"
            time.sleep(0.01)
        held = [r for r in router._assigned[1].values() if not r.done]
        kept = {id(r): list(r.tokens[:r._ckpt_len]) for r in held}
        wall[0] += 10.0
        while servers[0].heartbeat.transport.read_all()[0]["wall_time"] < wall[0]:
            time.sleep(0.01)
        assert router.check() == [1] and router.requeues == len(held) > 0
        for r in resps:
            assert r.wait(300) and r.finish_reason == FINISH_LENGTH and len(r.tokens) == 48
        for r in held:
            assert r.preemptions >= 1 and r.replica_id == 0
            assert r.tokens[:len(kept[id(r)])] == kept[id(r)]
        assert router.drain(timeout=300)
    finally:
        chaos.configure_chaos(None)
    eng = servers[0].engine
    eng.kv.assert_conservation([s.blocks for s in eng.state_manager.all()])
    assert eng.kv.free_blocks == eng.kv.num_blocks - 1
    for kernel in ("paged_attention", "paged_flash_decode"):
        n = port.launch_counts[kernel]
        assert n > 0 and n % cfg.num_layers == 0, (kernel, n)
        assert port.route_counts[kernel] == {"sm90": n, "cuda_core": 0}
