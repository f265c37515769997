"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the port's ``flash_attention`` runs the plain versions of its
kernels (``flash_attention_ref`` forward, ``flash_attention_bwd_ref``
backward) through the same ``torch.autograd.Function`` the card uses. The
same seeded numpy inputs go through the JAX ``flash_attention`` (its Pallas
kernels in interpret mode, as the JAX package's own tests run them) and the
JAX ``attention_core(impl="xla")``: outputs, the logsumexp residual ``L``
and the gradients of q, k and v must agree within 2e-4 in float32, the
tolerance ``tests/unit/test_flash_attention.py`` uses (the packages sum in
different orders).

The host-side logic of the kernels' ``wgmma`` route runs here too:
``flash_route``, the one rule for all three kernels, on CPU tensors of the
dtypes, head dims, layouts and bases that decide it, and ``schedule``, the
persistent blocks' work, which must deal every unit of each kernel (dK/dV:
batch, kv head, key tile; forward and dQ: batch, query head, query tile)
to exactly one block (so each unit's sums run in one block, in a fixed
order), the same way on every call, and within one unit of the mean per
block.
"""

import importlib
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import attention_core as jax_attention_core
from deepspeed_tpu_torch.models.transformer import attention_core
from deepspeed_tpu_torch.ops import flash_attention as tfa

# the module (the package re-exports a function of the same name)
jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")
TOL = 2e-4


def _inputs(B, S, H, Hk, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(B, S, H, D), f(B, S, Hk, D), f(B, S, Hk, D), f(B, S, H, D)


def _torch_grads(fn, q, k, v, w):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _jax_grads(fn, q, k, v, w):
    loss = lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * w)
    out = fn(q, k, v)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


# causal and full, MHA and GQA 8/2, S 128 and 256: each appears twice; and
# the head dims of phi-2 / Pythia-2.8B (80), phi-3-mini (96) and Pythia-1B
# (256) at S 128
_CASES = [(True, 4, 4, 128, 32), (True, 8, 2, 256, 32), (False, 4, 4, 256, 32),
          (False, 8, 2, 128, 32), (True, 2, 1, 128, 80), (False, 2, 2, 128, 96),
          (True, 2, 1, 128, 256)]


@pytest.mark.parametrize("causal,H,Hk,S,D", _CASES, ids=[
    "-".join(map(str, c[:4])) + ("" if c[4] == 32 else f"-D{c[4]}") for c in _CASES])
def test_flash_forward_and_grads_match_jax(causal, H, Hk, S, D):
    q, k, v, w = _inputs(1, S, H, Hk, D, seed=S + H + int(causal) + (D if D != 32 else 0))
    got, got_g = _torch_grads(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal), q, k, v, w)
    pallas, pallas_g = _jax_grads(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal, interpret=True),
        q, k, v, w)
    xla, xla_g = _jax_grads(
        lambda a, b, c: jax_attention_core(a, b, c, causal=causal, impl="xla"),
        q, k, v, w)
    for want, want_g in ((pallas, pallas_g), (xla, xla_g)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for g, wg, name in zip(got_g, want_g, "qkv"):
            np.testing.assert_allclose(g, wg, rtol=TOL, atol=TOL,
                                       err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_logsumexp_residual_matches_jax(causal):
    """``L = m + log l`` of the forward, the residual the backward reads,
    against the Pallas forward's (lane-replicated) ``L``."""
    q, k, v, _ = _inputs(2, 128, 8, 2, 32, seed=3)
    _, lse = tfa.flash_attention_forward(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal)
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    _, jl = jfa._flash_forward(qt, kt, vt, causal, 1.0 / np.sqrt(32), 128, 128, True)
    assert lse.shape == (2, 8, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_attention_core_matches_jax(impl):
    """The port's ``attention_core`` (both implementations, a GQA group and
    an explicit scale) against the JAX ``xla`` reference."""
    q, k, v, _ = _inputs(2, 128, 8, 2, 32, seed=5)
    got = attention_core(*map(torch.from_numpy, (q, k, v)), causal=True,
                         impl=impl, scale=0.3)
    want = jax_attention_core(*map(jnp.asarray, (q, k, v)), causal=True,
                              impl="xla", scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_bwd_ref_rounds_like_the_kernels_in_bf16():
    """In bf16 the plain backward follows the kernels' roundings (P and dS
    rounded to the input dtype before each product), so it tracks an fp32
    autograd of the same attention within bf16 noise."""
    q, k, v, w = _inputs(1, 128, 4, 2, 32, seed=9)
    got, got_g = _torch_grads(
        lambda a, b, c: tfa.flash_attention(a.bfloat16(), b.bfloat16(),
                                            c.bfloat16()).float(), q, k, v, w)
    want, want_g = _torch_grads(
        lambda a, b, c: attention_core(a, b, c, impl="xla"), q, k, v, w)
    np.testing.assert_allclose(got, want, atol=3e-2)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(g, wg, atol=8e-2)


def test_shape_checks():
    q, k, v, _ = _inputs(1, 128, 6, 4, 32, seed=1)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k[:, :64]),
                            torch.from_numpy(v[:, :64]))


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_public_function_ignores_input_strides():
    """A ``[B, H, S, D]`` tensor transposed to ``[B, S, H, D]`` gives the
    public function the same output and gradients as its contiguous copy."""
    q, k, v, w = _inputs(2, 64, 4, 2, 32, seed=13)
    views = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)
             for x in (q, k, v)]
    assert not any(t.is_contiguous() for t in views)
    got, got_g = _torch_grads(tfa.flash_attention, *(t.contiguous().numpy() for t in views), w)
    leaves = [t.detach().requires_grad_(True) for t in views]
    out = tfa.flash_attention(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    assert torch.equal(out.detach(), torch.from_numpy(got))
    for leaf, g in zip(leaves, got_g):
        assert torch.equal(leaf.grad, torch.from_numpy(g))


@pytest.mark.parametrize("D, built", [(64, True), (80, True), (96, True), (128, True),
                                      (256, True), (32, False), (112, False),
                                      (160, False), (512, False)])
def test_kernels_take_the_head_dims_they_build(D, built):
    """``kernel_takes`` (the ``auto`` rule of ``attention_core``) and
    ``flash_route`` take every head dim that both kernel sources build, and
    no other: a CUDA bf16 or fp32 q at D 80, 96 and 256 takes the kernels,
    bf16 on ``wgmma``; fp16 or a CPU tensor never does. (A stand-in with
    ``is_cuda`` set carries the card's side of the rule here.)"""
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        on_card = types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(2, 128, 4, D))
        assert tfa.kernel_takes(on_card) == (built and dtype != torch.float16)
    assert not tfa.kernel_takes(torch.zeros(1, 8, 2, D, dtype=torch.bfloat16))
    q = torch.zeros(1, 64, 4, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, D, dtype=torch.bfloat16)
    assert tfa.flash_route(q, k, k, q) == ("wgmma" if built else "mma_sync")
    assert all((D in tfa.SM90_TILES[n]) == built for n in tfa.SM90_TILES)


def test_both_sources_build_the_listed_head_dims():
    """One C++ list of head dims (``csrc/flash_head_dims.cuh``), included by
    both kernel sources, names the dims of ``SM90_TILES`` and
    ``_HEAD_DIMS``, in order."""
    csrc = pathlib.Path(tfa.__file__).parent / "csrc"
    macro = re.search(r"#define FLASH_HEAD_DIMS\(X\)(.*)",
                      (csrc / "flash_head_dims.cuh").read_text()).group(1)
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", macro)) == tfa._HEAD_DIMS
    assert all(tuple(t) == tfa._HEAD_DIMS for t in tfa.SM90_TILES.values())
    for source in tfa._SOURCES.values():
        text = (csrc / source).read_text()
        assert '#include "flash_head_dims.cuh"' in text
        assert "#define FLASH_HEAD_DIMS" not in text


KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("case, route", [
    ("bf16 D64", "wgmma"), ("bf16 D128", "wgmma"), ("bf16 D80", "wgmma"),
    ("bf16 D96", "wgmma"), ("bf16 D256", "wgmma"), ("fp32 D64", "mma_sync"),
    ("fp32 D256", "mma_sync"),
    ("fp16 D64", "mma_sync"), ("bf16 D32", "mma_sync"), ("bf16 D64 strided", "mma_sync"),
    ("bf16 D64 base 2 B off", "mma_sync")])
def test_dkdv_route_choice(case, route, kernel):
    """The one rule picks each kernel's route from the tensors it reads: q,
    k, v for the forward, and dO too for the backward kernels."""
    D = int(case.split("D")[1].split()[0])
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}[case[:4].strip()]
    q = torch.zeros(2, 96, 8, D, dtype=dtype)
    k = torch.zeros(2, 96, 2, D, dtype=dtype)
    if "strided" in case:
        q = torch.zeros(2, 8, 96, D, dtype=dtype).transpose(1, 2)
    if "off" in case:
        k = torch.zeros(2 * 96 * 2 * D + 1, dtype=dtype)[1:].view(2, 96, 2, D)
    tensors = (q, k, k) if kernel == "flash_attention_fwd" else (q, k, k, q)
    assert tfa.flash_route(*tensors) == route


def _want_lengths(kernel, B, S, H, Hk, D, causal):
    """Items per unit, counted tile by tile: dK/dV's key tile meets the
    group's query tiles whose last query reaches its first key; a query
    tile of the forward or dQ meets the key tiles whose first key its last
    query reaches (all of them when not causal)."""
    tile, step = tfa.SM90_TILES[kernel][D]
    n_tiles, n_steps = -(-S // tile), -(-S // step)
    if kernel == "flash_attention_bwd_dkdv":
        return [H // Hk * sum(1 for iq in range(n_steps)
                              if not causal or iq * step + step - 1 >= u // (B * Hk) * tile)
                for u in range(n_tiles * B * Hk)]
    return [sum(1 for kt in range(n_steps)
                if not causal or kt * step <= u // (B * H) * tile + tile - 1)
            for u in range(n_tiles * B * H)]


@pytest.mark.parametrize("kernel, D", [("flash_attention_bwd_dkdv", 64),
                                       ("flash_attention_fwd", 64),
                                       ("flash_attention_bwd_dq", 64),
                                       ("flash_attention_bwd_dq", 128),
                                       ("flash_attention_bwd_dq", 80),
                                       ("flash_attention_bwd_dkdv", 256),
                                       ("flash_attention_fwd", 256),
                                       ("flash_attention_bwd_dq", 256)])
@pytest.mark.parametrize("B, S, Hk, G, causal, blocks", [
    (4, 2048, 4, 8, True, 132),      # TinyLlama's training shape
    (1, 2048, 32, 1, True, 132),     # Llama-2-7B heads
    (2, 1000, 2, 4, False, 132),     # ragged S, not causal
    (3, 700, 2, 2, True, 5),         # more units than blocks, ragged S
    (1, 100, 1, 1, True, 132),       # fewer units than blocks
    (2, 300, 1, 2, False, 1)])       # one block
def test_dkdv_schedule_covers_each_unit_once(B, S, Hk, G, causal, blocks, kernel, D):
    H = G * Hk
    items = tfa.unit_lengths(kernel, B, S, H, Hk, D, causal)
    assert items == _want_lengths(kernel, B, S, H, Hk, D, causal)
    tile = tfa.SM90_TILES[kernel][D][0]
    per_tile = B * (Hk if kernel == "flash_attention_bwd_dkdv" else H)
    assert len(items) == -(-S // tile) * per_tile
    offsets, ids = tfa.schedule(items, blocks)
    assert (offsets, ids) == tfa.schedule(items, blocks)
    assert len(offsets) == min(blocks, len(items)) + 1 and offsets[0] == 0
    assert offsets == sorted(offsets) and offsets[-1] == len(ids)
    assert sorted(ids) == list(range(len(items)))      # every unit exactly once
    loads = [sum(items[u] for u in ids[a:b]) for a, b in zip(offsets, offsets[1:])]
    for a, b in zip(offsets, offsets[1:]):
        mine = [items[u] for u in ids[a:b]]
        assert mine == sorted(mine, reverse=True)      # longest first
    # greedy on units sorted longest first: no block exceeds the mean by
    # more than the longest unit
    assert max(loads) <= sum(items) / len(loads) + max(items)
    if (B, S, Hk, G, D) == (4, 2048, 4, 8, 64) and kernel == "flash_attention_bwd_dkdv":
        # 272 items on the busiest block against a mean of 263.8, where one
        # block per 64-key tile gave the key-tile-0 blocks 256 of 64 x 64
        # against a mean of 132
        assert max(loads) == 272 and sum(items) == 34816
    if (B, S, Hk, G, D) == (4, 2048, 4, 8, 64) and kernel == "flash_attention_fwd":
        # 2048 units of 1-16 key tiles of 128: 17408 tiles, 132 on the
        # busiest block against a mean of 131.9
        assert max(loads) == 132 and sum(items) == 17408
