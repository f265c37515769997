"""The port's compressed collectives (``comm/compressed.py``) against the JAX
package's, on the CPU.

Gloo worlds of 2 and 4 processes (``tests/torch_dist_worker.py``, torch
only) run ``quantized_all_reduce`` (int8, and with error feedback),
``quantized_all_gather`` and ``quantized_reduce_scatter`` on seeded
per-rank inputs; the JAX functions run on the same inputs under
``shard_map`` over a CPU mesh of the same size. The results agree within
1e-6 relative (only the order of the fp32 mean may differ), every rank
decodes the same reduced tensor, and the ledger's logical and wire bytes
equal the JAX ledger's exactly. With error feedback each call starts from
the JAX chain's residuals (XLA fuses the residual's multiply and subtract,
which moves it by an ulp of the input, enough to flip a later rounding tie
in a chain of calls), and the port's own chain has the JAX test's
properties: its time average beats one call, its residuals stay within a
quantization step. ``int8_sr`` is unbiased over repeated
calls, as the JAX package's test holds it. Cases: a ragged size whose
shards need padding, a size of whole shards, and an nd shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu.comm as jcomm
from deepspeed_tpu.comm import compressed as jcc
from deepspeed_tpu.utils.shard_map_compat import shard_map_nocheck

from .torch_dist_worker import run_world

BLOCK = 512
FEEDBACK_STEPS = 4
FEEDBACK_CHAIN = 8
SR_DRAWS = 40
RTOL = 1e-6


def _cases(world):
    rng = np.random.default_rng(world)
    return {"ragged": rng.standard_normal((world, 5000)).astype(np.float32),
            "whole": rng.standard_normal((world, world * 1024)).astype(np.float32),
            "nd": (rng.standard_normal((world, 33, 7)) * 5).astype(np.float32)}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    w = request.param
    cases = _cases(w)
    sr = np.random.default_rng(7).standard_normal((w, 2000)).astype(np.float32)
    chains = {name: _jax_feedback_chain(xs, w) for name, xs in cases.items()}
    inputs = {"cases": cases, "block": BLOCK, "sr": sr, "sr_draws": SR_DRAWS,
              "feedback_states": {n: [c[:2] for c in chain] for n, chain in chains.items()},
              "feedback_chain": FEEDBACK_CHAIN}
    outs = run_world("compressed", w, tmp_path_factory.mktemp(f"compressed{w}"), inputs,
                     timeout=120)
    return w, cases, sr, chains, outs


def _jax_feedback_chain(xs, world):
    """FEEDBACK_STEPS calls of the JAX all-reduce with error feedback:
    [(worker_error, server_error) before the call, output, new worker_error,
    new server_error], each stacked over the ranks."""
    shape = xs.shape[1:]
    fb0 = jcc.allreduce_feedback_init(shape, world)
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))

    @jax.jit
    def step(a, we, se):
        def body(x, we, se):
            out, nfb = jcc.quantized_all_reduce(x[0], "dp", block=BLOCK,
                                                feedback=type(fb0)(we[0], se[0]))
            return out[None], nfb.worker_error[None], nfb.server_error[None]

        return shard_map_nocheck(body, mesh, in_specs=(P("dp"),) * 3,
                                 out_specs=(P("dp"),) * 3)(a, we, se)

    we = np.zeros((world,) + shape, np.float32)
    se = np.zeros((world,) + fb0.server_error.shape, np.float32)
    chain = []
    for _ in range(FEEDBACK_STEPS):
        out, nwe, nse = (np.asarray(t) for t in step(xs, we, se))
        chain.append((we, se, out, nwe, nse))
        we, se = nwe, nse
    return chain


def _shard_map(fn, world, xs, *extra):
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    specs = (P("dp"),) + tuple(P("dp") for _ in extra)
    return shard_map_nocheck(fn, mesh, in_specs=specs, out_specs=P("dp"))(xs, *extra)


def _close(got, want, scale=None):
    """Within RTOL of ``scale`` (default: the reference's largest value)."""
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def test_quantized_all_reduce_matches_jax(world):
    w, cases, _, _, outs = world
    for name, xs in cases.items():
        want = np.asarray(jax.jit(lambda a: _shard_map(
            lambda x: jcc.quantized_all_reduce(x[0], "dp", block=BLOCK)[None], w, a))(xs))
        for r, out in enumerate(outs):
            _close(out[f"{name}/all_reduce"], want[r])
            np.testing.assert_array_equal(out[f"{name}/all_reduce"],
                                          outs[0][f"{name}/all_reduce"])
        bound = 2 * np.abs(xs).max() / 127 + 1e-6
        assert np.abs(outs[0][f"{name}/all_reduce"] - xs.mean(0)).max() <= bound


def test_quantized_all_gather_and_reduce_scatter_match_jax(world):
    w, cases, _, _, outs = world
    for name, xs in cases.items():
        gathered = np.asarray(jax.jit(lambda a: _shard_map(
            lambda x: jcc.quantized_all_gather(x[0], "dp", BLOCK)[None], w, a))(xs))
        scattered = np.asarray(jax.jit(lambda a: _shard_map(
            lambda x: jcc.quantized_reduce_scatter(x[0], "dp", BLOCK)[None], w, a))(xs))
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out[f"{name}/all_gather"], gathered[r])
            _close(out[f"{name}/reduce_scatter"], scattered[r])


def test_error_feedback_matches_jax(world):
    w, cases, _, chains, outs = world
    for name, xs in cases.items():
        scale = np.abs(xs).max()
        for t, (_, _, out, we, se) in enumerate(chains[name]):
            for r in range(w):
                got_out, got_we, got_se = outs[r][f"{name}/feedback_steps"][t]
                _close(got_out, out[r], scale)
                _close(got_we, we[r], scale)
                _close(got_se, se[r], scale)
        # the port's own chain: the time average beats one call, and the
        # residual stays within a quantization step
        ref = xs.mean(0)
        chain, worker = outs[0][f"{name}/feedback_chain"]
        one_shot = np.linalg.norm(chain[0] - ref)
        assert np.linalg.norm(chain.mean(0) - ref) < 0.7 * one_shot
        assert np.abs(worker).max() <= 2 * scale / 127


def test_ledger_bytes_match_jax(world):
    w, cases, _, _, outs = world
    ledger = jcomm.get_comms_logger()
    for name, xs in cases.items():
        ledger.configure(enabled=True, prof_all=True)
        ledger.reset()
        try:
            for fn in (lambda x: jcc.quantized_all_reduce(x[0], "dp", block=BLOCK)[None],
                       lambda x: jcc.quantized_all_gather(x[0], "dp", BLOCK)[None],
                       lambda x: jcc.quantized_reduce_scatter(x[0], "dp", BLOCK)[None]):
                jax.jit(lambda a: _shard_map(fn, w, a))(xs)
            want = {op: (t["count"], t["bytes"], t["wire_bytes"])
                    for op, t in ledger.totals().items()}
        finally:
            ledger.configure(enabled=False)
            ledger.reset()
        n = xs[0].size
        shard = -(-n // w)
        shard_p = -(-shard // 128) * 128
        b = BLOCK if shard_p % BLOCK == 0 else 128
        formula = (w * shard_p + 4 * w * (shard_p // b)) + (shard_p + 4 * (shard_p // b))
        assert want["quantized_all_reduce"] == (1, 4 * n, formula)
        for out in outs:
            got = {op: (t["count"], t["bytes"], t["wire_bytes"])
                   for op, t in out[f"{name}/ledger"].items()}
            assert got == want
            assert out[f"{name}/all_reduce_ledger"]["wire_bytes"] == formula


def test_stochastic_all_reduce_is_unbiased(world):
    w, _, sr, _, outs = world
    ref = sr.mean(0)
    draws = outs[0]["sr"]
    np.testing.assert_array_equal(draws, outs[-1]["sr"])   # every rank decodes the same
    single = np.abs(draws[0] - ref).max()
    avg_bias = np.abs(draws.mean(0) - ref).max()
    assert avg_bias < single / 2
    assert avg_bias < 2 * np.abs(sr).max() / 127 / np.sqrt(SR_DRAWS) * 6
    assert not np.array_equal(draws[0], draws[1])
