"""Block int8 quantization: the port of ``deepspeed_tpu/ops/pallas/quant.py``.

The input is flattened, padded with zeros to whole blocks of ``block``
elements, and each block keeps one fp32 scale (``absmax / 127``) beside its
int8 payload. :func:`quantize_int8` and :func:`dequantize_int8` launch the
hand-written kernels of ``csrc/quant.cu`` for tensors on the card: round to
nearest (``quant_int8``), stochastic rounding with the uniforms drawn inside
the kernel from a Philox4x32-10 stream (``quant_int8_sr``), and the inverse
(``dequant_int8``). For tensors on the CPU they run the plain PyTorch
versions below (``quantize_ref``, ``dequantize_ref``), which compute the
same values bitwise: the same scale (absmax times fp32(1/127), as XLA
computes the JAX kernel's division by 127), IEEE division by the scale,
round half to even, the same Philox words. A CUDA tensor launches the kernel or raises.

The JAX package keeps its scales lane-replicated as ``[nb, 128]`` for the
TPU's tiling; here they are ``[nb]`` (``dequantize_int8`` also takes the
one-lane wire form ``[nb, 1]``). Stochastic rounding takes a
``torch.Generator`` in place of a JAX key: each call draws one 64-bit seed
from it, so the same generator state gives the same rounding on the card
and on the CPU.

A block holding a NaN or an Inf decodes to NaN throughout (the kernel's
note says why); the JAX kernel's result for such a block is not defined
(NaN cast to int8).

The row quantizers of the int8 KV cache (``quantize_rows`` ...) and the
sign packing of 1-bit compression are plain PyTorch, as they are plain
``jnp`` in the JAX package. ``quantized_all_gather`` and
``quantized_reduce_scatter`` are the ZeRO++ one-shots over the comm layer;
the ledger accounting lives in ``comm/compressed.py``.
"""

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

BLOCK = 2048  # elements per quantization block
#: quant blocks the kernel takes (TPB = block / 8 threads, a power of two
#: dividing the CTA's 256)
KERNEL_BLOCKS = (128, 256, 512, 1024, 2048)
#: fp32(1 / 127): the scale is absmax times this, which is how XLA computes
#: the JAX kernel's ``absmax / 127.0`` (a division by a constant becomes a
#: multiplication by its fp32 reciprocal), so the scales match it bitwise
RCP127 = float(np.float32(1.0) / np.float32(127.0))
#: plain version: elements per chunk, which bounds its temporaries on the card
_REF_CHUNK_ELEMS = 1 << 25

#: kernel launches (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"quantize_int8": 0, "quantize_int8_sr": 0,
                                 "dequantize_int8": 0}

_SOURCE = "quant.cu"
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "quant_int8": [_P, _LL, _LL, _I, _P, _P, _I, _P],
    "quant_int8_sr": [_P, _LL, _LL, _I, _P, _P, _I, ctypes.c_ulonglong, _P],
    "dequant_int8": [_P, _P, _P, _LL, _I, _I, _P],
}
_M64 = (1 << 64) - 1


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernel(name: str):
    from . import _build

    fn = getattr(_build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _launched(name: str, err: int) -> None:
    launch_counts["quantize_int8" if name == "quant_int8" else
                  "quantize_int8_sr" if name == "quant_int8_sr" else "dequantize_int8"] += 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def shard_layout(n: int, world: int, block: int) -> Tuple[int, int, int]:
    """(shard, shard_padded, block) for an n-element tensor split into equal
    per-rank shards: ceil-divide, pad each shard to the 128-element quantum,
    and fall back to 128-element blocks when the padded shard does not hold
    whole blocks. The one source of this arithmetic for the collectives
    here and the wire-bytes accounting of ``comm/compressed.py``."""
    shard = -(-n // world)
    shard_p = -(-shard // 128) * 128
    if shard_p % block != 0:
        block = 128
    return shard, shard_p, block


# ---------------------------------------------------------------------------
# seeds for stochastic rounding
# ---------------------------------------------------------------------------


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from ``seed`` and ``data`` (splitmix64 of their
    mix): the counter-based counterpart of ``jax.random.fold_in``."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def draw_seed(generator: torch.Generator) -> int:
    """One 64-bit seed drawn from ``generator`` (advancing it)."""
    r = torch.randint(-(1 << 63), (1 << 63) - 1, (), dtype=torch.int64,
                      generator=generator, device=generator.device)
    return int(r) & _M64


def seeded_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed`` (any 64-bit value)."""
    return torch.Generator().manual_seed(seed & ((1 << 63) - 1))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a * b`` for a 32-bit constant ``a`` and
    32-bit values ``b`` held in int64, without overflowing int64."""
    bl = b & 0xFFFF
    abl = a * bl
    t = a * (b >> 16) + (abl >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (abl & 0xFFFF)


def philox_uniform(seed: int, start: int, count: int, device) -> torch.Tensor:
    """The kernel's uniforms u in [0, 1) of elements ``start .. start +
    count`` (``start`` and ``count`` multiples of 4): Philox4x32-10 keyed by
    ``seed`` on counter ``(index / 4, 0, 0)``, word ``index % 4``, as
    ``(word >> 8) * 2^-24``."""
    j = torch.arange(start // 4, (start + count) // 4, dtype=torch.int64, device=device)
    c = [j & _MASK32, j >> 32, torch.zeros_like(j), torch.zeros_like(j)]
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    words = torch.stack(c, dim=1).reshape(-1)
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def quantize_ref(flat: torch.Tensor, n: int, nb: int, block: int,
                 seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``quant_int8`` (``seed`` None) and ``quant_int8_sr``:
    the first ``n`` fp32 values of ``flat``, zero-padded to ``nb * block``,
    -> (int8 ``[nb, block]``, fp32 scales ``[nb]``). Runs over chunks of
    whole blocks, which bounds its temporaries."""
    q = torch.empty(nb, block, dtype=torch.int8, device=flat.device)
    s = torch.empty(nb, dtype=torch.float32, device=flat.device)
    rows = max(1, _REF_CHUNK_ELEMS // block)
    for r0 in range(0, nb, rows):
        r1 = min(nb, r0 + rows)
        lo, hi = r0 * block, min(n, r1 * block)
        x = torch.zeros((r1 - r0) * block, dtype=torch.float32, device=flat.device)
        if hi > lo:
            x[:hi - lo] = flat[lo:hi]
        x = x.view(r1 - r0, block)
        absmax = x.abs().amax(dim=1, keepdim=True)           # propagates NaN
        scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax * RCP127)
        y = x / scale
        if seed is not None:
            y = torch.floor(y + philox_uniform(seed, lo, x.numel(), x.device).view_as(y))
        else:
            y = torch.round(y)                               # half to even
        y = torch.where(torch.isnan(y), torch.zeros_like(y), y.clamp(-127, 127))
        q[r0:r1] = y.to(torch.int8)
        s[r0:r1] = scale[:, 0]
    return q, s


def dequantize_ref(q: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of ``dequant_int8``: the first ``n`` values of
    ``q * scale`` in fp32."""
    nb, block = q.shape
    return (q.float() * s.reshape(nb, 1)).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _quantize(flat: torch.Tensor, n: int, nb: int, block: int,
              seed: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``n`` values of the fp32 vector ``flat`` into ``nb`` blocks
    of ``block`` (``nb * block >= n``; the rest quantizes as zeros)."""
    if flat.device.type == "cpu":
        return quantize_ref(flat, n, nb, block, seed)
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"quant kernel takes block in {KERNEL_BLOCKS}, got {block}")
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("quant kernel takes a contiguous float32 vector")
    q = torch.empty(nb, block, dtype=torch.int8, device=flat.device)
    s = torch.empty(nb, dtype=torch.float32, device=flat.device)
    aligned = int(flat.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    if seed is None:
        name = "quant_int8"
        err = _kernel(name)(flat.data_ptr(), n, nb, block, q.data_ptr(), s.data_ptr(),
                            aligned, stream)
    else:
        name = "quant_int8_sr"
        err = _kernel(name)(flat.data_ptr(), n, nb, block, q.data_ptr(), s.data_ptr(),
                            aligned, seed, stream)
    _launched(name, err)
    return q, s


def _dequantize(q: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` values of ``q * scale`` (fp32 vector)."""
    nb, block = q.shape
    if s.numel() != nb:
        raise ValueError(f"dequantize: {s.numel()} scales for {nb} blocks")
    if n > nb * block:
        raise ValueError(f"dequantize: {n} values from {nb} blocks of {block}")
    if q.device.type == "cpu":
        return dequantize_ref(q, s, n)
    if q.dtype != torch.int8 or s.dtype != torch.float32 or s.device != q.device:
        raise ValueError("dequant kernel takes int8 payloads and float32 scales on one device")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"dequant kernel takes block in {KERNEL_BLOCKS}, got {block}")
    q, s = q.contiguous(), s.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    aligned = int(q.data_ptr() % 4 == 0)
    err = _kernel("dequant_int8")(q.data_ptr(), s.data_ptr(), out.data_ptr(), n,
                                  block.bit_length() - 1, aligned,
                                  torch.cuda.current_stream(q.device).cuda_stream)
    _launched("dequant_int8", err)
    return out


def quantize_int8(x: torch.Tensor, block: int = BLOCK, interpret=None, *,
                  stochastic: bool = False, key: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """-> (int8 values ``[nb, block]``, fp32 scales ``[nb]``, original
    shape). ``stochastic=True`` rounds with uniform dither drawn from
    ``key`` (required; a ``torch.Generator``, the port's counterpart of the
    JAX PRNG key): each element rounds to a neighbouring int8 level with
    probability equal to its fractional part, so the compression is
    unbiased. ``interpret`` (the Pallas interpreter switch) is accepted and
    ignored."""
    shape = tuple(x.shape)
    n = x.numel()
    nb = -(-n // block)
    seed = None
    if stochastic:
        if key is None:
            raise ValueError("stochastic rounding needs a torch.Generator as key")
        seed = draw_seed(key)
    flat = x.reshape(-1).to(torch.float32).contiguous()
    q, s = _quantize(flat, n, nb, block, seed)
    return q, s, shape


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, shape,
                    dtype: torch.dtype = torch.float32, interpret=None) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: ``q`` ``[nb, block]``, scales
    ``[nb]`` or ``[nb, 1]`` -> ``shape`` in ``dtype``. ``interpret`` is
    accepted and ignored."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    out = _dequantize(q, s.reshape(-1), n).reshape(shape)
    return out if dtype == torch.float32 else out.to(dtype)


# ---------------------------------------------------------------------------
# row-wise quantization (int8 KV-cache storage)
# ---------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization over the last axis (the absmax / 127
    convention of :func:`quantize_int8`, one scale per ``[head_dim]`` row).
    Returns ``(int8 values x.shape, fp32 scales x.shape[:-1])``."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax * RCP127, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequant_rows_tile(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The :func:`quantize_rows` inverse: int8 values with one scale per row,
    the scale broadcast over the last axis."""
    return (q.float() * scale[..., None]).to(dtype)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`."""
    return dequant_rows_tile(q, scale, dtype)


# ---------------------------------------------------------------------------
# quantized collectives (ZeRO++ qwZ / qgZ)
# ---------------------------------------------------------------------------


def quantized_all_gather(x: torch.Tensor, axis=None, block: int = BLOCK, *,
                         stochastic: bool = False,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """qwZ-style all-gather: int8 payload and one scale per block over the
    wire, dequantized on arrival. Returns ``[world, *x.shape]`` fp32."""
    from .. import comm

    q, s, shape = quantize_int8(x, block, stochastic=stochastic, key=generator)
    nb = q.shape[0]
    qg = comm.gather_stack(q, axis)                   # [world, nb, block]
    sg = comm.gather_stack(s, axis)                   # [world, nb]
    world = qg.shape[0]
    n = x.numel()
    deq = _dequantize(qg.view(world * nb, block), sg.view(-1), world * nb * block)
    return deq.view(world, nb * block)[:, :n].reshape((world,) + shape)


def quantized_reduce_scatter(x: torch.Tensor, axis=None, block: int = BLOCK, *,
                             stochastic: bool = False,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """qgZ-style mean reduce-scatter: quantize the local full-size tensor,
    all-to-all the int8 shards, dequantize and average locally. Returns this
    rank's fp32 shard of the mean, ``[ceil(n / world)]``; the zero padding
    lands in the last rank's tail."""
    from .. import comm

    world = comm.get_world_size(axis)
    n = x.numel()
    shard, shard_p, block = shard_layout(n, world, block)
    parts = pad_parts(x.reshape(-1).to(torch.float32), world, shard, shard_p)
    seed = None
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        seed = draw_seed(generator)
    nb = world * shard_p // block
    q, s = _quantize(parts, parts.numel(), nb, block, seed)
    qt = comm.exchange(q, axis)
    st = comm.exchange(s, axis)
    deq = _dequantize(qt, st, world * shard_p).view(world, shard_p)[:, :shard]
    return deq.mean(dim=0)


def pad_parts(flat: torch.Tensor, world: int, shard: int, shard_p: int) -> torch.Tensor:
    """``flat`` (n fp32 values) laid out as ``world`` shards of ``shard``
    values, each zero-padded to ``shard_p``. When no shard needs padding
    this is ``flat`` itself (1-D): the quantizer reads the missing tail as
    zeros. Otherwise a ``[world, shard_p]`` copy."""
    n = flat.numel()
    if shard == shard_p:
        return flat.contiguous()
    parts = torch.zeros(world, shard_p, dtype=torch.float32, device=flat.device)
    full = torch.zeros(world * shard, dtype=torch.float32, device=flat.device)
    full[:n] = flat
    parts[:, :shard] = full.view(world, shard)
    return parts.view(-1)


# ---------------------------------------------------------------------------
# 1-bit sign packing (the transport of compression.onebit)
# ---------------------------------------------------------------------------


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """Sign bits of a flat tensor packed 8 per uint8: bit k of byte i is
    ``x[8 i + k] > 0`` (zeros encode as negative). ``x.numel()`` must be a
    multiple of 8."""
    bits = (x.reshape(-1, 8) > 0).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.uint8)


def unpack_signs(q: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_signs`: uint8 ``[m]`` -> ``{-1, +1}`` fp32
    ``[8 m]``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=q.device)
    bits = (q[:, None] >> shifts) & 1
    return (bits.float() * 2.0 - 1.0).reshape(-1)
