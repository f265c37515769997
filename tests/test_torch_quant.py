"""The port's block int8 quantization (``ops/quant.py``) against the JAX
package's (``ops/pallas/quant.py``, whose Pallas kernels run in interpret
mode on the CPU), on the CPU.

* ``quantize_int8`` round to nearest: the int8 payloads and the scales (the
  JAX package's lane-replicated scales, column 0) equal exactly, over sizes
  1, 127, 2048, 16 * 2048 + 5 and [33, 77] and blocks 2048, 512 and 128;
  ``dequantize_int8`` equals exactly, with ``[nb]`` scales and the one-lane
  wire form ``[nb, 1]``.
* ``shard_layout`` equals the JAX function over a grid of (n, world, block).
* Stochastic rounding (the plain version of the kernel's in-kernel Philox
  draw): the scales equal the nearest scales, every payload is floor or
  floor + 1 of x / scale, pad lanes are 0, the mean rounding error is
  within 3 / sqrt(N), and the Philox words are Random123's known answers.
* A block holding a NaN or an Inf decodes to NaN throughout.
* ``quantize_rows``, ``dequantize_rows``, ``pack_signs`` and
  ``unpack_signs`` equal the JAX functions exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import quant as jq
from deepspeed_tpu_torch.ops import quant as tq

SHAPES = [(1,), (127,), (2048,), (16 * 2048 + 5,), (33, 77)]
BLOCKS = [2048, 512, 128]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10, shape)).astype(np.float32)
    x.reshape(-1)[::97] = 0.0
    return x


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quantize_and_dequantize_match_jax_exactly(shape, block):
    x = _x(shape, seed=sum(shape) + block)
    jqv, js, jshape = jq.quantize_int8(jnp.asarray(x), block)
    q, s, tshape = tq.quantize_int8(torch.from_numpy(x), block)
    assert tshape == tuple(jshape) == shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:, 0])
    want = np.asarray(jq.dequantize_int8(jqv, js, jshape))
    np.testing.assert_array_equal(tq.dequantize_int8(q, s, tshape).numpy(), want)
    np.testing.assert_array_equal(tq.dequantize_int8(q, s[:, None], tshape).numpy(), want)
    half = tq.dequantize_int8(q, s, tshape, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and tuple(half.shape) == shape


def test_shard_layout_matches_jax():
    for n in (1, 127, 128, 129, 2048, 4095, 16 * 2048 + 5, 1_100_048_384):
        for world in (1, 2, 3, 4, 8):
            for block in (128, 512, 2048):
                assert tq.shard_layout(n, world, block) == jq.shard_layout(n, world, block)


def test_philox_words_are_random123_known_answers():
    # Philox4x32-10 known-answer vector (Random123 kat_vectors): counter 0,
    # key 0 -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8, the u of elements 0..3
    words = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    want = np.array([(w >> 8) * 2.0 ** -24 for w in words], np.float32)
    np.testing.assert_array_equal(tq.philox_uniform(0, 0, 4, "cpu").numpy(), want)
    u = tq.philox_uniform(123, 0, 1 << 16, "cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


@pytest.mark.parametrize("block", BLOCKS)
def test_stochastic_rounding_is_unbiased_and_bounded(block):
    n = 16 * 2048 + 5
    x = torch.from_numpy(_x((n,), seed=block))
    q, s, _ = tq.quantize_int8(x, block)
    gen = torch.Generator().manual_seed(11)
    qs, ss, _ = tq.quantize_int8(x, block, stochastic=True, key=gen)
    torch.testing.assert_close(ss, s, rtol=0, atol=0)
    nb = qs.shape[0]
    flat = torch.zeros(nb * block)
    flat[:n] = x
    y = flat.view(nb, block) / s[:, None]
    lo = torch.floor(y).clamp(-127, 127)
    hi = (torch.floor(y) + 1).clamp(-127, 127)
    qf = qs.float()
    assert bool(((qf == lo) | (qf == hi)).all())
    assert bool((qs.view(-1)[n:] == 0).all())               # pad lanes stay 0
    err = (qf.view(-1)[:n] - y.view(-1)[:n]).mean().abs().item()
    assert err < 3 / np.sqrt(n), err
    # the same generator state rounds the same way; another state does not
    again, _, _ = tq.quantize_int8(x, block, stochastic=True,
                                   key=torch.Generator().manual_seed(11))
    assert torch.equal(again, qs)
    other, _, _ = tq.quantize_int8(x, block, stochastic=True,
                                   key=torch.Generator().manual_seed(12))
    assert not torch.equal(other, qs)
    with pytest.raises(ValueError, match="Generator"):
        tq.quantize_int8(x, block, stochastic=True)


def test_non_finite_block_decodes_to_nan():
    x = torch.randn(3 * 512)
    x[10] = float("nan")
    x[600] = float("inf")
    q, s, shape = tq.quantize_int8(x, 512)
    assert np.isnan(s[0].item()) and np.isinf(s[1].item()) and np.isfinite(s[2].item())
    assert bool((q[:2] == 0).all())
    out = tq.dequantize_int8(q, s, shape)
    assert bool(out[:1024].isnan().all()) and bool(out[1024:].isfinite().all())


def test_rows_and_sign_packing_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    x[1, 2] = 0.0
    jqv, js = jq.quantize_rows(jnp.asarray(x))
    q, s = tq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_rows(q, s, dtype).float().numpy()
        want = np.asarray(jq.dequantize_rows(jqv, js, jdtype).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    v = rng.standard_normal(8 * 37).astype(np.float32)
    v[::5] = 0.0
    packed = tq.pack_signs(torch.from_numpy(v))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_signs(jnp.asarray(v))))
    np.testing.assert_array_equal(tq.unpack_signs(packed).numpy(),
                                  np.asarray(jq.unpack_signs(jnp.asarray(packed.numpy()))))
