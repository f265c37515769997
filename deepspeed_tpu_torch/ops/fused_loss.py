"""Fused LM loss: the port of ``deepspeed_tpu/ops/pallas/fused_loss.py``.

:func:`fused_vocab_nll` computes the per-token NLL of ``hidden @ kernel``
logits without ever holding the ``[T, V]`` logits: a
``torch.autograd.Function`` at the JAX ``custom_vjp``'s ``(lse, tgt)``
boundary whose forward launches the forward kernel and whose backward
receives ``(g_lse, g_tgt)`` and launches the backward kernels
(``csrc/fused_loss.cu``). ``z_loss`` and the ``lse - tgt`` combine stay in
PyTorch around the Function, as in the JAX function.

The backward walks the vocab in chunks of ``Vc`` columns (the Hopper design;
the TPU keeps its ``dh``/``dK`` accumulators in VMEM, which no block here
can hold): per chunk one kernel computes the gradient tile ``dl`` once into
a ``[T, Vc]`` workspace of at most :data:`WORKSPACE_BYTES`, one adds
``dl K^T`` into ``dh`` (fp32 across chunks) and one writes that chunk of
``dK``. ``launch_counts`` counts launches: the forward once per call (on
the ``wgmma`` route also its combine, ``fused_loss_fwd_combine``, which
merges the per-tile partials), the three backward kernels once per chunk.

The forward and the backward each have two routes, chosen in the open by
one function, :func:`loss_route` (``backward_route`` is the same
function), and counted per launch in ``fwd_route_counts`` (the forward)
and ``route_counts`` (the backward): ``"wgmma"``
(``csrc/fused_loss_sm90.cu``: TMA loads and ``wgmma`` in a persistent,
warp-specialised block) for bf16 operands that TMA can describe (16-byte
aligned bases and row strides), and ``"mma_sync"`` (``csrc/fused_loss.cu``:
``mma.sync`` in bf16, the CUDA cores in fp32) for the rest, e.g. an untied
head whose vocab of 50257 gives rows of 100514 bytes. A launch that fails
raises; nothing falls back to the other route.

Each kernel has a plain PyTorch version beside it with the same roundings:
:func:`fused_nll_fwd_ref`, :func:`fused_dlogits_ref` and
:func:`fused_nll_bwd_ref`; :func:`fused_nll_fwd_tiled_ref` spells out the
``wgmma`` forward's partial-and-combine order. A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernels or raises.

Numerics (the JAX kernels'): logits are fp32 products of the storage-dtype
operands; ``lse = m + log(l)`` with ``l == 0`` dividing by 1; the target
logit is a column compare (a target outside ``[0, V)``, e.g. -1, matches
nothing); ``dl = g_lse * exp(s - lse) + g_tgt * onehot`` is rounded to the
kernel's dtype before each backward product; ``dh`` leaves in ``hidden``'s
dtype, ``dK`` in the kernel's.
"""

import ctypes
from typing import Dict, Optional

import torch

__all__ = ["fused_vocab_nll", "fused_loss_ready", "DEFAULT_BLOCK_T", "DEFAULT_BLOCK_V"]

#: kernel launches per wrapper (reset by callers that want a window's count)
launch_counts: Dict[str, int] = {"fused_loss_fwd": 0, "fused_loss_fwd_combine": 0,
                                 "fused_loss_dlogits": 0, "fused_loss_dh": 0,
                                 "fused_loss_dk": 0}

#: backward kernel launches per route (see :func:`loss_route`)
route_counts: Dict[str, int] = {"wgmma": 0, "mma_sync": 0}

#: forward kernel launches per route
fwd_route_counts: Dict[str, int] = {"wgmma": 0, "mma_sync": 0}

#: the JAX function's default tiles (the kernels here tile themselves)
DEFAULT_BLOCK_T = 256
DEFAULT_BLOCK_V = 512

#: bound on the backward's dl workspace ``[T, Vc]``, in bytes
WORKSPACE_BYTES = 64 << 20
_BN = 128                  # vocab columns per block tile (csrc/fused_loss.cu)
FWD_TILE = 256             # vocab columns per partial of the wgmma forward
_SOURCES = {"mma_sync": "fused_loss.cu", "wgmma": "fused_loss_sm90.cu"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fused_loss_fwd_splits": [_I] * 4,
    "fused_loss_fwd": [_P] * 7 + [_I] * 6 + [_P],
    "fused_loss_dl": [_P] * 7 + [_I] * 8 + [_P],
    "fused_loss_dh": [_P] * 4 + [_I] * 10 + [_P],
    "fused_loss_dk": [_P] * 3 + [_I] * 8 + [_P],
    "fused_loss_fwd_sm90": [_P] * 4 + [_I] * 5 + [_P],
    "fused_loss_fwd_combine_sm90": [_P] * 3 + [_I] * 2 + [_P],
    "fused_loss_dl_sm90": [_P] * 7 + [_I] * 7 + [_P],
    "fused_loss_dh_sm90": [_P] * 4 + [_I] * 9 + [_P],
    "fused_loss_dk_sm90": [_P] * 3 + [_I] * 7 + [_P],
}


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts, fwd_route_counts):
        for name in counts:
            counts[name] = 0


def fused_loss_ready(vocab_shard: int) -> bool:
    """The JAX package's structural gate: the vocab shard tiles into
    128-lane blocks (the TPU's lane width). The CUDA kernels mask a ragged
    vocab, so the port applies it only to the plain version (the CPU)."""
    return vocab_shard >= 128 and vocab_shard % 128 == 0


def kernel_takes(device, dtype) -> bool:
    """Whether the kernels are built for hidden states of ``dtype`` on
    ``device``: a CUDA device and fp32 or bf16 (any sizes)."""
    return (device is not None and torch.device(device).type == "cuda"
            and dtype in _DTYPES)


def _kernel(name: str, route: str = "mma_sync"):
    from . import _build

    fn = getattr(_build.load(_SOURCES[route]), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_launch(name: str, err: int) -> None:
    if err >= 10000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {err - 10000}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _logits(h, k):
    """fp32 logits from the storage-dtype operands (bf16 products are exact
    in fp32, so this is the kernels' arithmetic up to summation order)."""
    return h.float() @ k.float()


def fused_nll_fwd_ref(h, k, targets):
    """Plain version of the forward kernel: ``(lse, tgt)`` fp32 ``[T]`` for
    ``h [T, E]``, ``k [E, V]`` and int ``targets [T]``."""
    s = _logits(h, k)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[:, None]).sum(dim=-1)
    lse = m + torch.log(torch.where(l == 0, torch.ones_like(l), l))
    cols = torch.arange(s.shape[1], device=s.device)
    tgt = torch.where(cols[None, :] == targets[:, None].long(), s,
                      torch.zeros_like(s)).sum(dim=-1)
    return lse, tgt


def fused_nll_fwd_tiled_ref(h, k, targets, tile: int = FWD_TILE):
    """The ``wgmma`` forward's order of operations, in plain PyTorch: per
    row and ``tile``-column tile of the vocab the partial ``(m, l, tgt)``
    (the tile's max, its sum of ``exp(s - m)``, its target logit), merged in
    tile order (``m = max m_i``, ``l = sum l_i exp(m_i - m)``, ``tgt = sum
    tgt_i``, ``lse = m + log l`` with ``l == 0`` dividing by 1). The same
    function as :func:`fused_nll_fwd_ref` up to the order of the sums."""
    T, V = h.shape[0], k.shape[1]
    n = -(-V // tile)
    part = torch.empty((3, n, T), dtype=torch.float32, device=h.device)
    for i in range(n):
        v0 = i * tile
        s = _logits(h, k[:, v0:v0 + tile])
        m = s.amax(dim=-1)
        part[0, i] = m
        part[1, i] = torch.exp(s - m[:, None]).sum(dim=-1)
        cols = torch.arange(v0, v0 + s.shape[1], device=s.device)
        part[2, i] = torch.where(cols[None, :] == targets[:, None].long(), s,
                                 torch.zeros_like(s)).sum(dim=-1)
    m = part[0].amax(dim=0)
    l = torch.zeros(T, dtype=torch.float32, device=h.device)
    tgt = torch.zeros_like(l)
    for i in range(n):
        l = l + part[1, i] * torch.exp(part[0, i] - m)
        tgt = tgt + part[2, i]
    return m + torch.log(torch.where(l == 0, torch.ones_like(l), l)), tgt


def fused_dlogits_ref(h, k, targets, lse, g_lse, g_tgt, v0: int = 0,
                      width: Optional[int] = None):
    """Plain version of the dl kernel: ``dl = g_lse exp(s - lse) + g_tgt
    onehot`` over the vocab columns ``[v0, v0 + width)`` (default: all),
    rounded to ``k``'s dtype, ``[T, width]``."""
    width = k.shape[1] - v0 if width is None else width
    s = _logits(h, k[:, v0:v0 + width])
    cols = torch.arange(v0, v0 + width, device=s.device)
    onehot = (cols[None, :] == targets[:, None].long()).float()
    dl = g_lse.float()[:, None] * torch.exp(s - lse[:, None]) + g_tgt.float()[:, None] * onehot
    return dl.to(k.dtype)


def fused_nll_bwd_ref(h, k, targets, lse, g_lse, g_tgt):
    """Plain version of the backward kernels: ``(dh, dk)`` with dl rounded
    to ``k``'s dtype before each product."""
    dl = fused_dlogits_ref(h, k, targets, lse, g_lse, g_tgt).float()
    dh = (dl @ k.float().T).to(h.dtype)
    dk = (h.float().T @ dl).to(k.dtype)
    return dh, dk


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _layout(k):
    """``(kvt, base)``: 0 and ``k`` for a contiguous ``[E, V]`` head, 1 and
    the contiguous ``[V, E]`` tensor behind ``k = base.T`` (the tied head,
    read in place)."""
    if k.is_contiguous():
        return 0, k
    if k.T.is_contiguous():
        return 1, k.T
    raise ValueError("the head kernel must be a contiguous [E, V] tensor or the "
                     "transpose of a contiguous [V, E] one")


def _validate_cuda(tensors: Dict[str, torch.Tensor], dtype) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"fused loss kernels take float32 or bfloat16, got {dtype}")
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, expected a CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, others on {dev}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = {"targets": torch.int32, "lse": torch.float32, "g_lse": torch.float32,
                "g_tgt": torch.float32}.get(name, dtype)
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")


def _check_shapes(h, k, targets) -> None:
    if h.dim() != 2 or k.dim() != 2 or h.shape[1] != k.shape[0]:
        raise ValueError(f"fused loss takes h [T, E] and k [E, V]; got "
                         f"{tuple(h.shape)}, {tuple(k.shape)}")
    if targets.shape != (h.shape[0],):
        raise ValueError(f"targets {tuple(targets.shape)} do not match h {tuple(h.shape)}")


def chunk_width(T: int, V: int, itemsize: int) -> int:
    """Vocab columns per backward chunk: the widest multiple of 128 whose
    ``[T, Vc]`` workspace fits :data:`WORKSPACE_BYTES` (at least 128, at
    most the vocab rounded up)."""
    vc = (WORKSPACE_BYTES // max(T * itemsize, 1)) // _BN * _BN
    return max(_BN, min(vc, -(-V // _BN) * _BN))


def loss_route(h, base) -> str:
    """The route of the forward and of the backward for hidden states ``h
    [T, E]`` and the head ``base`` in its stored layout (``[E, V]``, or
    ``[V, E]`` tied): ``"wgmma"`` when TMA can describe every operand, that
    is bf16 with 16-byte-aligned bases and row strides (the workspace's
    rows, a multiple of 128 columns, always are); else ``"mma_sync"``. The
    same rule on any device, so the CPU tests can ask it."""
    tma = (h.dtype == base.dtype == torch.bfloat16 and h.numel() > 0 and base.numel() > 0
           and all(t.data_ptr() % 16 == 0 and t.stride(0) * t.element_size() % 16 == 0
                   for t in (h, base)))
    return "wgmma" if tma else "mma_sync"


#: the backward's name for :func:`loss_route` (one rule for both passes)
backward_route = loss_route


def launch_forward(h, base, targets, kvt: int, route: str):
    """One launch of the forward kernel on ``route``: ``(lse, tgt)`` fp32
    ``[T]`` (CUDA tensors that :func:`fused_nll_forward` has checked;
    ``base`` is the head in its stored layout, ``kvt`` says which)."""
    T, E = h.shape
    V = base.shape[0] if kvt else base.shape[1]
    fn = _entry("fwd", route, h, base)
    lse = torch.empty(T, dtype=torch.float32, device=h.device)
    tgt = torch.empty_like(lse)
    if route == "wgmma":
        # per-256-column partials, then their combine in tile order
        n = -(-V // FWD_TILE)
        part = torch.empty((3, n, T), dtype=torch.float32, device=h.device)
        err = fn(h.data_ptr(), base.data_ptr(), targets.data_ptr(), part.data_ptr(),
                 T, E, V, n, kvt, _stream(h))
        launch_counts["fused_loss_fwd"] += 1
        fwd_route_counts[route] += 1
        _check_launch(f"fused_loss_fwd ({route})", err)
        err = _kernel("fused_loss_fwd_combine_sm90", route)(
            part.data_ptr(), lse.data_ptr(), tgt.data_ptr(), T, n, _stream(h))
        launch_counts["fused_loss_fwd_combine"] += 1
        _check_launch("fused_loss_fwd_combine", err)
        return lse, tgt
    is_bf16 = _DTYPES[h.dtype]
    n = _kernel("fused_loss_fwd_splits")(T, V, kvt, is_bf16)
    _check_launch("fused_loss_fwd_splits", -min(n, 0))
    part = torch.empty((3, n, T), dtype=torch.float32, device=h.device)
    ticket = torch.zeros(-(-T // 64), dtype=torch.int32, device=h.device)
    err = fn(h.data_ptr(), base.data_ptr(), targets.data_ptr(), lse.data_ptr(),
             tgt.data_ptr(), part.data_ptr(), ticket.data_ptr(), T, E, V, n, kvt, is_bf16,
             _stream(h))
    launch_counts["fused_loss_fwd"] += 1
    fwd_route_counts[route] += 1
    _check_launch(f"fused_loss_fwd ({route})", err)
    return lse, tgt


def fused_nll_forward(h, k, targets, route: Optional[str] = None):
    """The forward kernel: ``(lse, tgt)`` fp32 ``[T]``, on ``route``
    (default :func:`loss_route`'s choice; a forced ``"wgmma"`` on operands
    TMA cannot describe raises). CPU tensors take
    :func:`fused_nll_fwd_ref`."""
    _check_shapes(h, k, targets)
    if h.device.type == "cpu":
        return fused_nll_fwd_ref(h, k, targets)
    kvt, base = _layout(k)
    _validate_cuda({"h": h, "k": base, "targets": targets}, h.dtype)
    if h.shape[0] == 0:
        return (torch.empty(0, dtype=torch.float32, device=h.device),
                torch.empty(0, dtype=torch.float32, device=h.device))
    return launch_forward(h, base, targets, kvt, route or loss_route(h, base))


def _entry(kind: str, route: str, h, base):
    if route not in _SOURCES:
        raise ValueError(f"route must be one of {sorted(_SOURCES)}, got {route!r}")
    if route == "wgmma" and loss_route(h, base) != "wgmma":
        raise ValueError("the wgmma route takes bf16 operands with 16-byte-aligned bases "
                         "and row strides (see loss_route)")
    return _kernel(f"fused_loss_{kind}" + ("_sm90" if route == "wgmma" else ""), route)


def _counted(name: str, route: str, err: int) -> None:
    launch_counts[name] += 1
    route_counts[route] += 1
    _check_launch(f"{name} ({route})", err)


def launch_dlogits(h, base, targets, lse, g_lse, g_tgt, ws, v0: int, width: int, kvt: int,
                   route: str):
    """One launch of the dl kernel on ``route``: the chunk ``[v0, v0 +
    width)`` of ``dl`` into the workspace ``ws [T, Vc]`` (CUDA tensors that
    :func:`fused_nll_backward` has checked; ``base`` is the head in its
    stored layout, ``kvt`` says which)."""
    T, E = h.shape
    V = base.shape[0] if kvt else base.shape[1]
    flags = (kvt,) if route == "wgmma" else (kvt, _DTYPES[h.dtype])
    err = _entry("dl", route, h, base)(
        h.data_ptr(), base.data_ptr(), targets.data_ptr(), lse.data_ptr(), g_lse.data_ptr(),
        g_tgt.data_ptr(), ws.data_ptr(), T, E, V, v0, ws.shape[1], width, *flags,
        _stream(h))
    _counted("fused_loss_dlogits", route, err)


def launch_dh(ws, base, dh_acc, dh, v0: int, width: int, first: bool, last: bool, kvt: int,
              route: str):
    """One launch of the dh kernel on ``route``: ``dh (+)= dl_chunk
    K_chunk^T``, in fp32 into ``dh_acc`` until the ``last`` chunk writes
    ``dh``."""
    T, E = dh.shape
    V = base.shape[0] if kvt else base.shape[1]
    flags = (kvt,) if route == "wgmma" else (kvt, _DTYPES[dh.dtype])
    err = _entry("dh", route, ws, base)(
        ws.data_ptr(), base.data_ptr(), 0 if dh_acc is None else dh_acc.data_ptr(),
        dh.data_ptr(), T, E, V, v0, ws.shape[1], width, int(first), int(last), *flags,
        _stream(dh))
    _counted("fused_loss_dh", route, err)


def launch_dk(h, ws, dk_base, v0: int, width: int, kvt: int, route: str):
    """One launch of the dK kernel on ``route``: the chunk's columns of
    ``dK = h^T dl`` into ``dk_base`` (the head's stored layout)."""
    T, E = h.shape
    V = dk_base.shape[0] if kvt else dk_base.shape[1]
    flags = (kvt,) if route == "wgmma" else (kvt, _DTYPES[h.dtype])
    err = _entry("dk", route, h, dk_base)(
        h.data_ptr(), ws.data_ptr(), dk_base.data_ptr(), T, E, V, v0, ws.shape[1], width,
        *flags, _stream(h))
    _counted("fused_loss_dk", route, err)


def fused_nll_backward(h, k, targets, lse, g_lse, g_tgt):
    """The backward kernels, chunk by chunk over the vocab: ``(dh, dk)``,
    ``dk`` in ``k``'s layout. CPU tensors take :func:`fused_nll_bwd_ref`."""
    _check_shapes(h, k, targets)
    if h.device.type == "cpu":
        return fused_nll_bwd_ref(h, k, targets, lse, g_lse, g_tgt)
    kvt, base = _layout(k)
    g_lse, g_tgt = g_lse.float().contiguous(), g_tgt.float().contiguous()
    _validate_cuda({"h": h, "k": base, "targets": targets, "lse": lse, "g_lse": g_lse,
                    "g_tgt": g_tgt}, h.dtype)
    T, E = h.shape
    V = k.shape[1]
    dh = torch.empty_like(h)
    dk_base = torch.empty_like(base)
    dk = dk_base.T if kvt else dk_base
    if T == 0 or V == 0:
        return dh.zero_(), dk.zero_()
    vc = chunk_width(T, V, h.element_size())
    n_chunks = -(-V // vc)
    ws = torch.empty((T, vc), dtype=h.dtype, device=h.device)
    dh_acc = (torch.empty((T, E), dtype=torch.float32, device=h.device)
              if n_chunks > 1 else None)
    route = loss_route(h, base)
    for c in range(n_chunks):
        v0 = c * vc
        width = min(vc, V - v0)
        launch_dlogits(h, base, targets, lse, g_lse, g_tgt, ws, v0, width, kvt, route)
        launch_dh(ws, base, dh_acc, dh, v0, width, c == 0, c == n_chunks - 1, kvt, route)
        launch_dk(h, ws, dk_base, v0, width, kvt, route)
    return dh, dk


class _FusedNLL(torch.autograd.Function):
    """Forward kernel, residuals ``(h, k, targets, lse)``, backward kernels;
    the JAX ``custom_vjp`` boundary."""

    @staticmethod
    def forward(ctx, h, k, targets):
        lse, tgt = fused_nll_forward(h, k, targets)
        ctx.save_for_backward(h, k, targets, lse)
        return lse, tgt

    @staticmethod
    def backward(ctx, g_lse, g_tgt):
        h, k, targets, lse = ctx.saved_tensors
        g_lse = torch.zeros_like(lse) if g_lse is None else g_lse
        g_tgt = torch.zeros_like(lse) if g_tgt is None else g_tgt
        dh, dk = fused_nll_backward(h, k, targets, lse, g_lse, g_tgt)
        return dh, dk, None


def _check_blocks(block_t: int, block_v: int, vloc: int) -> None:
    """Refuse the tiles the JAX function cannot run: a block that is not a
    positive int (it raises), and a ``block_v`` other than the default
    whose fitted size (the largest halving, down to 128, that divides the
    vocab) does not divide a vocab of 128-column tiles (the JAX kernel then
    skips the vocab's last columns and returns a wrong loss). The kernels
    here tile themselves, so every accepted value gives the same result."""
    for name, b in (("block_t", block_t), ("block_v", block_v)):
        if isinstance(b, bool) or not isinstance(b, int) or b <= 0:
            raise ValueError(f"{name} must be a positive int, got {b!r}")
    if block_v != DEFAULT_BLOCK_V and vloc % 128 == 0:
        fitted = min(block_v, vloc)
        while fitted > 128 and vloc % fitted:
            fitted //= 2
        if vloc % fitted:
            raise ValueError(f"block_v={block_v} does not tile the vocab shard {vloc} "
                             f"(fitted to {fitted})")


def fused_vocab_nll(hidden, kernel, targets, *, axis_name: Optional[str] = None,
                    z_loss: float = 0.0, block_t: int = DEFAULT_BLOCK_T,
                    block_v: int = DEFAULT_BLOCK_V, interpret: Optional[bool] = None):
    """Per-token NLL of ``hidden @ kernel`` logits, logits never
    materialized (JAX ``fused_vocab_nll``). ``hidden [..., E]``, ``kernel
    [E, V]`` (a contiguous tensor, or the transpose of a contiguous
    ``[V, E]`` one such as a tied embedding), ``targets [...]`` int ids.
    Returns fp32 ``[...]``, differentiable w.r.t. hidden and kernel. The
    kernel is cast to hidden's dtype, as in the JAX function.

    On the CPU the plain version follows the JAX contract: the vocab must
    satisfy :func:`fused_loss_ready`. The CUDA kernels mask ragged token
    and vocab edges, so any sizes take them. ``axis_name`` (a vocab-sharded
    head) needs the comm substrate. ``block_t`` / ``block_v`` are the JAX
    function's TPU tiles, checked (:func:`_check_blocks`) and otherwise
    unused; ``interpret`` (the Pallas interpreter switch) is accepted and
    ignored."""
    _check_blocks(block_t, block_v, kernel.shape[-1])
    if axis_name is not None:
        raise NotImplementedError(
            "fused_vocab_nll(axis_name=...) (a vocab-sharded head) is not ported "
            "yet: ROADMAP.md Queue A item 8 (parallelism side paths)")
    vloc = kernel.shape[-1]
    if hidden.device.type == "cpu" and not fused_loss_ready(vloc):
        raise ValueError(f"fused loss needs a 128-multiple vocab shard, got "
                         f"{vloc}; check fused_loss_ready() and fall back")
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    tg = targets.reshape(-1).to(torch.int32).contiguous()
    k2 = kernel.to(h2.dtype)
    if not (k2.is_contiguous() or k2.T.is_contiguous()):
        # a head _layout cannot read in place, e.g. kernel[:, :V] of a head
        # padded past the vocab: a contiguous copy (autograd returns dK to
        # the view); a tied [V, E] head is still read in place
        k2 = k2.contiguous()
    lse, tgt = _FusedNLL.apply(h2, k2, tg)
    nll = lse - tgt
    if z_loss > 0.0:
        nll = nll + z_loss * torch.square(lse)
    return nll.reshape(lead)
