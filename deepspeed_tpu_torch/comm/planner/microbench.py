"""Microbenchmark harness: time one (site, implementation) pair for real.

Port of ``deepspeed_tpu/comm/planner/microbench.py``: ``measure`` mode's
ground truth. The serving ``decode_attn`` site (a kernel choice, no mesh
axis) is probed here: the hand-written paged decode kernel against the
gathered-page einsum, on the card when there is one. The probe memo
(``probe_stats`` / ``reset_probe_memo``) is the JAX package's. The
collective probes and the probes of multi-phase programs need the port's
ring and program executors, which are not ported (ROADMAP.md Queue A item
8): ``build_probe`` raises for a site with mesh axes, and measure mode then
keeps the cost model's pick (the planner's own fallback).

A probe is timed as min-over-repeats of ``reps`` chained executions after
one untimed call (which builds the kernel), with ``torch.cuda.synchronize``
around the timed region on the card. A probe that fails on the card raises
``ProbeError``: a kernel that does not build or launch there is a fault,
never a candidate that merely loses to the einsum.
"""

import time
from typing import Optional

from .ir import CollectiveSite

#: page sizes the probe may use: the sm90 paged kernels stage pages of
#: 16, 32 and 64 slots (``ops/paged_attention.SM90_PAGE_SIZES``), where the
#: JAX probe pages by 8 or 128; the probe takes the nearest built size
PROBE_PAGE_SMALL = 16
PROBE_PAGE_LARGE = 64


class ProbeError(RuntimeError):
    """A probe failed on the card. The planner and the engine let it
    propagate, where a probe that fails on the CPU only loses."""


def probe_device():
    """The device the ``decode_attn`` probes run on: the card when there
    is one, else the CPU."""
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _decode_attn_probe(site: CollectiveSite, impl: str, *, reps: int,
                       max_elems: int, device=None):
    """Single-device probe for the serving ``decode_attn`` site: one
    fused-decode attention step at a capped version of the site's pool
    shape, the gathered-page einsum (``inference/v2/model.paged_attention``)
    against the paged flash-decode kernel (``ops/paged_attention.
    paged_flash_decode``: the kernel on the card when there is one, its
    plain version on the CPU otherwise). A float site probes in its own dtype; ``site.dtype == int8``
    probes the quantized ``(values, scales)`` pool form through both paths,
    with bf16 queries on the card (the serving compute dtype) and fp32 on
    the CPU. Returns ``(fn, q)``: ``fn(q)`` runs ``reps`` chained steps."""
    import torch

    from ...inference.v2.model import paged_attention as einsum_paged
    from ...ops.paged_attention import paged_flash_decode
    from ...ops.quant import quantize_rows

    device = probe_device() if device is None else torch.device(device)
    S, slots, Hk, D = (tuple(site.shape) + (4, 64, 2, 32))[:4]
    S = max(1, min(int(S), 4))
    Hk, D = int(Hk), int(D)
    bs = PROBE_PAGE_SMALL if slots < 128 else PROBE_PAGE_LARGE
    # cap the pool at max_elems total values
    slots = max(bs, min(int(slots), max(bs, int(max_elems) // (Hk * D))))
    B = -(-slots // bs)
    N = S * B + 1
    if site.dtype == "int8":
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    else:
        dtype = getattr(torch, site.dtype)
    gen = torch.Generator(device="cpu").manual_seed(0)
    kp = torch.randn((N, Hk, bs, D), generator=gen).to(device)
    vp = torch.randn((N, Hk, bs, D), generator=gen).to(device)
    if site.dtype == "int8":
        kp, vp = quantize_rows(kp), quantize_rows(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    bt = (1 + torch.arange(S * B, dtype=torch.int32)).reshape(S, B).to(device)
    kvl = torch.full((S,), B * bs - bs // 2, dtype=torch.int32,
                     device=device)    # partial last page
    pos = kvl  # the decode query sits one past the pool
    q = torch.randn((S, Hk, D), generator=gen).to(device=device, dtype=dtype)
    ones = torch.ones((S, 1), dtype=torch.bool, device=device)
    half = torch.tensor(0.5, dtype=dtype, device=device)

    def one(qv):
        if impl == "pallas":
            return paged_flash_decode(qv, kp, vp, bt, pos, kvl)
        if impl == "einsum":
            out = einsum_paged(qv[:, None], kp, vp, bt, pos[:, None], ones,
                               kvl)
            return out[:, 0]
        raise ValueError(f"unsupported decode_attn probe impl {impl!r}")

    def loop(qv):
        c = qv
        for _ in range(reps):
            c = one(c) * half + qv * half
        return c.reshape(-1)[0]

    return loop, q


def build_probe(site: CollectiveSite, impl: str, *, mesh=None,
                block: Optional[int] = None, reps: int = 4,
                max_elems: int = 1 << 16, program=None):
    """``(fn, probe)``: ``fn(probe)`` runs ``reps`` chained executions of
    ``impl`` for ``site``. Only the ``decode_attn`` site is probed; a site
    with mesh axes (the collective probes and programs) raises
    ``NotImplementedError`` naming ROADMAP.md Queue A item 8."""
    if site.op == "decode_attn":
        return _decode_attn_probe(site, impl, reps=reps, max_elems=max_elems)
    raise NotImplementedError(
        f"the {site.op} probe ({impl}) is not ported yet: ROADMAP.md Queue A "
        f"item 8 (the ring and program executors it times)")


# --------------------------------------------------------------------------
# process-level probe memo: measure-mode tuning resolves overlapping
# candidate sets (several planner instances in one process, replicas
# joining later) — each distinct probe SIGNATURE builds and times exactly
# once per process. Keyed by everything that changes the probe or its
# timing; the live topology rides in as its axis-size map so a
# set_topology() switch is a different signature, never a stale hit.
# --------------------------------------------------------------------------

_PROBE_MEMO: dict = {}
_PROBE_STATS = {"calls": 0, "built": 0, "hits": 0}


def _memo_key(site: CollectiveSite, impl: str, mesh, block, reps, repeats,
              max_elems, program):
    if mesh is None:
        try:
            from ...parallel.topology import ALL_AXES, get_topology

            topo = get_topology()
            mesh_key = tuple(sorted((a, topo.axis_size(a)) for a in ALL_AXES))
        except Exception:
            mesh_key = ()
    else:
        mesh_key = tuple(sorted(dict(mesh).items()))
    return (site.signature(), impl, mesh_key, block, int(reps), int(repeats),
            int(max_elems), tuple(program) if program else None)


def probe_stats() -> dict:
    """Counters for the process-level probe memo: ``calls`` (benchmark_site
    invocations), ``built`` (probes actually built+timed), ``hits``
    (answered from the memo). ``built`` is the cost that must shrink."""
    return dict(_PROBE_STATS)


def reset_probe_memo() -> None:
    _PROBE_MEMO.clear()
    _PROBE_STATS.update(calls=0, built=0, hits=0)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_site(site: CollectiveSite, impl: str, *, mesh=None,
                   block: Optional[int] = None, reps: int = 4,
                   repeats: int = 3, max_elems: int = 1 << 16,
                   program=None, memo: bool = True) -> float:
    """Min-of-``repeats`` wall-clock seconds per single execution of
    ``impl`` at (a capped version of) ``site``. The first call, which
    builds the kernel, is excluded.

    ``mesh`` is an axis-size mapping standing in for the live topology in
    the memo key (the JAX package passes its ``Mesh``). ``memo=False``
    bypasses the process-level memo both ways (no read, no write) — for
    callers that want a fresh wall-clock sample, e.g. drift re-checks."""
    _PROBE_STATS["calls"] += 1
    key = _memo_key(site, impl, mesh, block, reps, repeats, max_elems,
                    program) if memo else None
    if key is not None and key in _PROBE_MEMO:
        _PROBE_STATS["hits"] += 1
        return _PROBE_MEMO[key]
    try:
        fn, x = build_probe(site, impl, mesh=mesh, block=block, reps=reps,
                            max_elems=max_elems, program=program)
        device = x.device
        float(fn(x))  # build + drain
        best = float("inf")
        for _ in range(max(1, repeats)):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(x)
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / reps)
            float(out)
    except Exception as e:
        if site.op == "decode_attn" and probe_device().type == "cuda":
            raise ProbeError(f"{site.signature()} {impl} probe failed on the "
                             f"card: {type(e).__name__}: {e}") from e
        raise
    _PROBE_STATS["built"] += 1
    if key is not None:
        _PROBE_MEMO[key] = best
    return best
