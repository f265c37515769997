"""The port's ring collectives, ppermute, TP decode projections and
vocab-sharded fused loss against the JAX package's, on the CPU.

One gloo world of ``W`` = 2 ranks (``tests/torch_dist_worker.py``, scenario
``tp_collectives``, a tp axis of 2) runs every function of
``ops/collective_matmul.py`` (exact and over the int8 wire, block 128),
``comm.ppermute`` / ``send_*_recv_*``, the five TP decode functions of
``inference/v2/model.py``, ``fused_vocab_nll(axis_name="tp")`` and
``vocab_parallel_cross_entropy`` on its shards of seeded numpy inputs. The
JAX functions run on the same shards on two CPU devices under ``shard_map``
over the axis ``"tp"``; the two losses' gradients are held against the JAX
gradients of the whole head or logits (each rank's ``dh`` is its share:
they sum to the whole; its ``dK`` and logit gradient are its columns). Tolerances: fp32 products in other summation orders, 1e-5
relative and 1e-5 absolute; the int8 wire against JAX's int8 wire (the
quantizers are bitwise the JAX kernel's, the products differ in order)
within 1e-4, and against the exact product within the block-quantization
bound (half a step, ``absmax / 254``, of each block on each hop);
``tp_greedy_token`` exactly, ties to the lowest global id.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.inference.v2 import model as jmodel
from deepspeed_tpu.ops import collective_matmul as jcm
from deepspeed_tpu.ops.pallas import fused_loss as jfl
from deepspeed_tpu.utils.shard_map_compat import shard_map_nocheck

from .torch_dist_worker import run_world

W = 2
RTOL = ATOL = 1e-5
INT8_RTOL = 1e-4
V_NLL = 256


def _per_rank(rng, shape, scale=1.0):
    return (rng.standard_normal((W,) + shape) * scale).astype(np.float32)


def _shared(x):
    return np.stack([x] * W)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(24)
    inp = {
        "x_rows": _per_rank(rng, (2, 4, 8)), "w_col": _per_rank(rng, (8, 6), 0.3),
        "x_k": _per_rank(rng, (2, 8, 6)), "w_row": _per_rank(rng, (6, 5), 0.3),
        "wq": _per_rank(rng, (8, 2, 4), 0.3), "wk": _per_rank(rng, (8, 1, 4), 0.3),
        "wv": _per_rank(rng, (8, 1, 4), 0.3), "head_dim": 4,
        "ring_x": _per_rank(rng, (3, 5)), "ring_y": _per_rank(rng, (6, 5)),
        "tokens": _shared(np.array([[0, 3, 8, 15, 9, 7, 12], [1, 1, 14, 6, 8, 0, 10]])),
        "table": _per_rank(rng, (8, 5)), "hid": _shared(rng.standard_normal((2, 7, 5))
                                                        .astype(np.float32)),
        "flat": _per_rank(rng, (300,)), "flat_rs": _per_rank(rng, (600,)),
        "perm": [(0, 1)],
        "dec_x": _per_rank(rng, (2, 8)), "dec_w": _per_rank(rng, (8, 6), 0.3),
        "dec_attn": _per_rank(rng, (4, 6)), "dec_wo": _per_rank(rng, (6, 8), 0.3),
        "dec_vocab": _per_rank(rng, (8, 10), 0.3),
        "nll_h": _shared((rng.standard_normal((6, 16)) * 0.5).astype(np.float32)),
        "nll_k": _per_rank(rng, (16, V_NLL // W), 0.5),
        # out-of-shard on every rank: -1, a negative id, an id past the vocab
        "nll_targets": _shared(np.array([0, 127, 128, 255, -1, 300], np.int32)),
        "z_loss": 1e-4,
        "vpce_logits": _per_rank(rng, (6, V_NLL // W), 2.0),
    }
    logits = rng.standard_normal((W, 5, 10)).astype(np.float32)
    logits[:, 0] = 0.0                          # a tie across every column
    logits[0, 1, 3] = logits[1, 1, 1] = 9.0     # a tie across shards: id 3 wins
    logits[1, 2, 4] = logits[1, 2, 7] = 9.0     # a tie inside one shard: id 14
    inp["dec_logits"] = logits
    cot = {"agmm": (2, 8, 6), "agmm_bidir": (2, 8, 6), "agmm_int8": (2, 8, 6),
           "mmrs": (2, 4, 5), "mmrs_int8": (2, 4, 5), "ring_ag": (6, 5),
           "ring_rs": (3, 5), "embed": (2, 7, 5), "tied": (2, 7, 16), "nll": (6,),
           "vpce": (6,)}
    for name, shape in cot.items():
        # the replicated results take the same cotangent on every rank
        same = name in ("embed", "tied", "nll", "vpce")
        inp[name + "/cot"] = (_shared(rng.standard_normal(shape).astype(np.float32)) if same
                              else _per_rank(rng, shape))
    return inp


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    return run_world("tp_collectives", W, tmp_path_factory.mktemp("tp_collectives"),
                     problem, timeout=240)


def _jax(fn, *args):
    """``fn`` on each of the W devices under ``shard_map`` over "tp", rank r
    holding ``args[i][r]``; each output stacked ``[W, ...]``."""
    mesh = Mesh(np.array(jax.devices()[:W]), ("tp",))
    flat = [jnp.asarray(a.reshape((-1,) + a.shape[2:])) for a in args]
    out = jax.jit(shard_map_nocheck(fn, mesh, (P("tp"),) * len(flat), P("tp")))(*flat)

    def split(o):
        o = np.asarray(o)
        return o.reshape((W, -1) + o.shape[1:])
    return jax.tree.map(split, out)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _stack(ranks, key):
    return np.stack([r[key] for r in ranks])


def _jax_vjp(fn, problem, name, *keys):
    """JAX's outputs and the gradients of sum(out * cot) per rank."""
    def body(*a):
        *args, cot = a
        y, vjp = jax.vjp(fn, *args)
        return (y,) + vjp(cot.astype(y.dtype))
    return _jax(body, *[problem[k] for k in keys], problem[name + "/cot"])


@pytest.mark.parametrize("name, kw", [("agmm", {}), ("agmm_bidir", {"bidirectional": True}),
                                      ("agmm_int8", {"wire_dtype": "int8", "block": 128})])
def test_all_gather_matmul_matches_jax(ranks, problem, name, kw):
    want = _jax_vjp(lambda x, w: jcm.all_gather_matmul(x, w, "tp", **kw), problem, name,
                    "x_rows", "w_col")
    tol = INT8_RTOL if "int8" in name else RTOL
    _close(_stack(ranks, name), want[0].reshape(W, 2, 8, 6), tol, tol)
    for i in (0, 1):
        _close(np.stack([r[name + "/grads"][i] for r in ranks]),
               want[1 + i].reshape((W,) + problem[["x_rows", "w_col"][i]].shape[1:]),
               tol, tol)
    # against the gathered product: exact, or within the int8 blocks' bound
    x_full = np.concatenate(list(problem["x_rows"]), axis=-2)
    dense = np.stack([x_full @ problem["w_col"][r] for r in range(W)])
    if "int8" in name:
        step = np.abs(problem["x_rows"]).max() / 254
        bound = step * np.abs(problem["w_col"]).sum(axis=1).max() + 1e-6
        assert np.abs(_stack(ranks, name) - dense).max() <= bound
        assert np.abs(_stack(ranks, name) - dense).max() > 0
    else:
        _close(_stack(ranks, name), dense)


@pytest.mark.parametrize("name, kw", [("mmrs", {}),
                                      ("mmrs_int8", {"wire_dtype": "int8", "block": 128})])
def test_matmul_reduce_scatter_matches_jax(ranks, problem, name, kw):
    want = _jax_vjp(lambda x, w: jcm.matmul_reduce_scatter(x, w, "tp", **kw), problem, name,
                    "x_k", "w_row")
    tol = INT8_RTOL if "int8" in name else RTOL
    _close(_stack(ranks, name), want[0].reshape(W, 2, 4, 5), tol, tol)
    for i in (0, 1):
        _close(np.stack([r[name + "/grads"][i] for r in ranks]),
               want[1 + i].reshape((W,) + problem[["x_k", "w_row"][i]].shape[1:]), tol, tol)
    total = sum(problem["x_k"][r] @ problem["w_row"][r] for r in range(W))
    dense = np.stack([total[:, 4 * r:4 * r + 4] for r in range(W)])
    if "int8" in name:
        # one quantization of the partial sum on the one hop
        part = np.abs(problem["x_k"][0] @ problem["w_row"][0]).max()
        assert np.abs(_stack(ranks, name) - dense).max() <= 2 * part / 254 + 1e-6
    else:
        _close(_stack(ranks, name), dense)


def test_fused_qkv_and_exact_rings_match_jax(ranks, problem):
    want = _jax(lambda x, q, k, v: jcm.fused_qkv_all_gather_matmul(x, q, k, v, (), 4, "tp"),
                problem["x_rows"], problem["wq"], problem["wk"], problem["wv"])
    for i in range(3):
        _close(np.stack([r["qkv"][i] for r in ranks]), want[i].reshape(
            (W,) + ranks[0]["qkv"][i].shape))
    for name, fn, key in (("ring_ag", jcm.ring_all_gather, "ring_x"),
                          ("ring_rs", jcm.ring_reduce_scatter, "ring_y")):
        want = _jax_vjp(lambda x, f=fn: f(x, "tp"), problem, name, key)
        _close(_stack(ranks, name), want[0].reshape((W,) + ranks[0][name].shape))
        _close(np.stack([r[name + "/grads"][0] for r in ranks]),
               want[1].reshape((W,) + problem[key].shape[1:]))
    np.testing.assert_array_equal(ranks[0]["ring_ag"],
                                  np.concatenate(list(problem["ring_x"])))


def test_embedding_ring_and_tied_head_match_jax(ranks, problem):
    table = np.concatenate(list(problem["table"]))               # [V, E]
    tok, hid = problem["tokens"][0], problem["hid"][0]
    want = _jax(lambda t, tab: jcm.ring_embedding_gather(t, tab, "tp"),
                problem["tokens"], problem["table"])
    for r in range(W):
        np.testing.assert_array_equal(ranks[r]["embed"], want[r].reshape(2, 7, 5))
        np.testing.assert_array_equal(ranks[r]["embed"], table[tok])
    want = _jax(lambda x, tab: jcm.ring_tied_lm_head(x, tab, "tp"),
                problem["hid"], problem["table"])
    for r in range(W):
        _close(ranks[r]["tied"], want[r].reshape(2, 7, 16))
    # gradients: the replicated outputs' whole cotangent on every rank
    cot_e, cot_t = problem["embed/cot"][0], problem["tied/cot"][0]
    d_table = np.zeros_like(table)
    np.add.at(d_table, tok.reshape(-1), cot_e.reshape(-1, 5))
    d_table += np.einsum("bsv,bse->ve", cot_t, hid)
    for r in range(W):
        _close(ranks[r]["embed/grads"][0] + ranks[r]["tied/grads"][1],
               d_table[8 * r:8 * r + 8])
        # dx of the tied head: bitwise the same on every rank
        np.testing.assert_array_equal(ranks[r]["tied/grads"][0], ranks[0]["tied/grads"][0])
        _close(ranks[r]["tied/grads"][0], cot_t @ table)


@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_fused_phase_rings_match_jax(ranks, problem, wire):
    ag = _jax(lambda x: jcm.fused_ring_all_gather(x, "tp", wire_dtype=wire, block=128),
              problem["flat"])
    rs = _jax(lambda x: jcm.fused_ring_reduce_scatter(x, "tp", wire_dtype=wire, block=128),
              problem["flat_rs"])
    tol = INT8_RTOL if wire == "int8" else RTOL
    for r in range(W):
        _close(ranks[r][f"fused_ag/{wire}"], ag[r].reshape(-1), tol, tol)
        _close(ranks[r][f"fused_rs/{wire}"], rs[r].reshape(-1), tol, tol)
    if wire == "exact":
        np.testing.assert_array_equal(ranks[0]["fused_ag/exact"],
                                      np.concatenate(list(problem["flat"])))


def test_fused_phase_rings_record_each_hop(ranks):
    """A fused phase leaves one flight record a hop, tagged by its caller,
    in the JAX package's ``tag:wire:hop h/hops`` form (world 2: one hop)."""
    for r in ranks:
        assert r["fused_records"] == [
            ("fused_ring_all_gather", "fused_matmul", "zpp:int8:hop1/1"),
            ("fused_ring_reduce_scatter", "fused_matmul", "zpp:exact:hop1/1")]


def test_ppermute_matches_jax(ranks, problem):
    from deepspeed_tpu.comm import comm as jcomm

    for key, fn in (("ppermute", lambda x: jcomm.ppermute(x, "tp", [(0, 1)])),
                    ("send_next", lambda x: jcomm.send_next_recv_prev(x, "tp")),
                    ("send_prev", lambda x: jcomm.send_prev_recv_next(x, "tp"))):
        want = _jax(fn, problem["ring_x"])
        for r in range(W):
            np.testing.assert_array_equal(ranks[r][key], want[r].reshape(3, 5))
    np.testing.assert_array_equal(ranks[0]["ppermute"], np.zeros((3, 5), np.float32))


@pytest.mark.parametrize("impl", ["xla", "fused_matmul"])
def test_tp_decode_projections_match_jax(ranks, problem, impl):
    assert ranks[0]["decode_impl"] == jmodel.resolve_decode_tp_impl(
        "tp", (2, 8), jnp.float32) == "xla"
    cases = (("decode_matmul", jmodel.tp_decode_matmul, ("dec_x", "dec_w")),
             ("decode_out", jmodel.tp_decode_out_proj, ("dec_attn", "dec_wo")),
             ("decode_logits", jmodel.tp_decode_logits, ("dec_x", "dec_vocab")))
    for name, fn, keys in cases:
        want = _jax(lambda a, b, f=fn: f(a, b, "tp", impl=impl), *[problem[k] for k in keys])
        got = _stack(ranks, f"{name}/{impl}")
        _close(got, want.reshape(got.shape))
    # the dense products
    x_full = np.concatenate(list(problem["dec_x"]))
    for r in range(W):
        _close(ranks[r][f"decode_matmul/{impl}"], x_full @ problem["dec_w"][r])
    total = sum(problem["dec_attn"][r] @ problem["dec_wo"][r] for r in range(W))
    for r in range(W):
        _close(ranks[r][f"decode_out/{impl}"], total[2 * r:2 * r + 2])


def test_tp_greedy_token_matches_dense_argmax(ranks, problem):
    want = _jax(lambda lg: jmodel.tp_greedy_token(lg, "tp"), problem["dec_logits"])
    dense = np.argmax(np.concatenate(list(problem["dec_logits"]), axis=-1), axis=-1)
    assert dense[0] == 0 and dense[1] == 3 and dense[2] == 14
    for r in range(W):
        np.testing.assert_array_equal(ranks[r]["greedy"], dense)
        np.testing.assert_array_equal(ranks[r]["greedy"], want[r].reshape(-1))


def test_vocab_sharded_fused_loss_matches_jax(ranks, problem):
    h, tg, z = problem["nll_h"][0], problem["nll_targets"][0], problem["z_loss"]
    kernel = np.concatenate(list(problem["nll_k"]), axis=-1)     # [E, V]
    want = _jax(lambda h_, k_, t_: jfl.fused_vocab_nll(h_, k_, t_, axis_name="tp",
                                                       z_loss=z),
                problem["nll_h"], problem["nll_k"], problem["nll_targets"])
    cot = problem["nll/cot"][0]

    def dense(h_, k_):
        return jnp.sum(jfl.fused_vocab_nll(h_, k_, jnp.asarray(tg), z_loss=z) * cot)

    whole = jfl.fused_vocab_nll(jnp.asarray(h), jnp.asarray(kernel), jnp.asarray(tg),
                                z_loss=z)
    dh, dk = jax.grad(dense, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(kernel))
    vloc = V_NLL // W
    for r in range(W):
        _close(ranks[r]["nll"], want[r].reshape(-1))
        _close(ranks[r]["nll"], np.asarray(whole))
        _close(ranks[r]["nll/grads"][1], np.asarray(dk)[:, r * vloc:(r + 1) * vloc])
    _close(sum(r["nll/grads"][0] for r in ranks), np.asarray(dh))
    # out-of-shard ids contribute no target logit on either shard: rows 4 and
    # 5 are logZ alone
    lse = np.log(np.exp(h @ kernel).sum(-1))
    _close(ranks[0]["nll"][4:], lse[4:] + z * lse[4:] ** 2)


def test_vocab_parallel_cross_entropy_matches_jax(ranks, problem):
    from deepspeed_tpu.sequence import cross_entropy as jce

    tg, z = problem["nll_targets"][0], problem["z_loss"]
    want = _jax(lambda lg, t_: jce.vocab_parallel_cross_entropy(lg, t_, axis_name="tp",
                                                                z_loss=z),
                problem["vpce_logits"], problem["nll_targets"])
    logits = np.concatenate(list(problem["vpce_logits"]), axis=-1)     # [6, V]
    cot = problem["vpce/cot"][0]

    def dense(lg):
        logz = jax.nn.logsumexp(lg, axis=-1)
        t_ = jnp.asarray(tg)
        hit = (t_ >= 0) & (t_ < lg.shape[-1])
        tgt = jnp.where(hit, jnp.take_along_axis(lg, jnp.clip(t_, 0, lg.shape[-1] - 1)[:, None],
                                                 axis=-1)[:, 0], 0.0)
        return jnp.sum((logz - tgt + z * logz ** 2) * cot)

    dlg = np.asarray(jax.grad(dense)(jnp.asarray(logits)))
    vloc = V_NLL // W
    for r in range(W):
        _close(ranks[r]["vpce"], want[r].reshape(-1))
        _close(ranks[r]["vpce/grads"][0], dlg[:, r * vloc:(r + 1) * vloc])
