"""The port's fused LM loss against the JAX package's, on the CPU.

* ``ops.fused_loss.fused_vocab_nll`` (the kernels' plain versions on CPU
  tensors) against JAX ``fused_vocab_nll`` run as ``tests/unit/
  test_fused_loss.py`` runs it (Pallas interpret mode on the CPU), at that
  file's float32 tolerances: values within 1e-5, gradients within
  rtol 1e-4 / atol 1e-6. Cases: ``z_loss`` 0 and 1e-2, a token count that
  the TPU kernel pads, rows masked through zero cotangent, bf16 operands,
  and the 128-multiple vocab gate raising for the plain version.
* ``make_loss_fn`` with ``loss_impl="fused"`` against the JAX package's in
  value (1e-5) and gradients (2e-4 absolute, the JAX test's bound), for an
  untied Llama and a tied model; ``sharded_lm_loss`` with a head bias warns
  once and gives the dense loss; ``resolve_loss_impl`` and the
  ``training_fastpath`` knob resolve as the JAX package's do (``auto`` is
  ``xla`` on the CPU and ``fused`` for fp32/bf16 tensors on the card), and
  the fallback rule (the 128 gate on the CPU only, fp16 and a head bias
  keep the dense loss) picks and warns as stated.
* ``loss_route`` (``backward_route`` is the same function), the choice
  between the ``wgmma`` and ``mma_sync`` kernels of the forward and the
  backward, on CPU tensors of the dtypes and strides that decide it (the
  same function runs on the card); and the ``wgmma`` forward's order of
  operations (``fused_nll_fwd_tiled_ref``: per-256-column partials merged in
  tile order) against the plain forward and the JAX ``fused_vocab_nll``
  (interpret mode) on vocabs that end in a partial tile, targets incl. -1,
  in float32 within rtol 1e-5 (only the order of the fp32 sums differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.fastpath import reset_fastpath as jreset_fastpath
from deepspeed_tpu.ops.pallas import fused_loss as jfl
from deepspeed_tpu.parallel import Topology, TopologySpec, set_topology
from deepspeed_tpu.sequence import cross_entropy as jce
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops import fused_loss as tfl
from deepspeed_tpu_torch.ops.fastpath import configure_fastpath, fastpath, reset_fastpath
from deepspeed_tpu_torch.sequence import cross_entropy as tce

VAL_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _fresh_state():
    yield
    set_topology(Topology(TopologySpec()))
    jreset_fastpath()
    reset_fastpath()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _both(*arrays, grad=True):
    """Each numpy array as a JAX array and a (grad-requiring) torch tensor."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a, requires_grad=grad) for a in arrays])


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
def test_fused_nll_value_and_grads_match_jax(z_loss):
    b, s, e, v = 2, 12, 24, 256
    (jh, jk), (th, tk) = _both(_rand((b, s, e), 0), _rand((e, v), 1, 0.1))
    tgt = np.random.default_rng(2).integers(0, v, (b, s)).astype(np.int32)
    jval = jfl.fused_vocab_nll(jh, jk, jnp.asarray(tgt), z_loss=z_loss)
    tval = tfl.fused_vocab_nll(th, tk, torch.from_numpy(tgt), z_loss=z_loss)
    assert tval.dtype == torch.float32 and tuple(tval.shape) == (b, s)
    _close(tval.detach(), jval, VAL_TOL, VAL_TOL)
    jg = jax.grad(lambda h_, k_: jnp.mean(jfl.fused_vocab_nll(
        h_, k_, jnp.asarray(tgt), z_loss=z_loss)), argnums=(0, 1))(jh, jk)
    tval.mean().backward()
    for t, j, name in zip((th.grad, tk.grad), jg, "hk"):
        _close(t, j, GRAD_RTOL, GRAD_ATOL, f"grad of {name}")


def test_fused_nll_token_padding_and_masked_rows_match_jax():
    """A token count the TPU kernel pads (10 -> 16 rows) and half the rows
    at zero cotangent: neither may leak into values or gradients."""
    e, v, t_count = 16, 128, 10
    (jh, jk), (th, tk) = _both(_rand((t_count, e), 3), _rand((e, v), 4, 0.1))
    tgt = np.random.default_rng(5).integers(0, v, (t_count,)).astype(np.int32)
    w = (np.arange(t_count) % 2).astype(np.float32)
    jloss = lambda h_, k_: jnp.sum(jfl.fused_vocab_nll(h_, k_, jnp.asarray(tgt)) * w)
    jval, jg = jax.value_and_grad(jloss, argnums=(0, 1))(jh, jk)
    tval = torch.sum(tfl.fused_vocab_nll(th, tk, torch.from_numpy(tgt)) * torch.from_numpy(w))
    tval.backward()
    _close(tval.detach(), jval, VAL_TOL, VAL_TOL)
    for t, j, name in zip((th.grad, tk.grad), jg, "hk"):
        _close(t, j, GRAD_RTOL, GRAD_ATOL, f"grad of {name}")
    assert torch.all(th.grad[w == 0] == 0)


def test_fused_nll_sliced_head_matches_jax():
    """``kernel[:, :V]`` of a head padded past the vocab is neither a
    contiguous ``[E, V]`` tensor nor the transpose of one: the public
    function takes it (a contiguous copy), its value and gradients match
    JAX's on the slice, and dK reaches the padded head's first V columns
    only."""
    e, v, vp = 24, 256, 384
    h, padded = _rand((2, 10, e), 6), _rand((e, vp), 7, 0.1)
    (jh, jk), (th, tk_full) = _both(h, padded[:, :v])[0], _both(h, padded)[1]
    view = tk_full[:, :v]
    assert not (view.is_contiguous() or view.T.is_contiguous())
    tgt = np.random.default_rng(8).integers(0, v, (2, 10)).astype(np.int32)
    jval, jg = jax.value_and_grad(lambda h_, k_: jnp.mean(jfl.fused_vocab_nll(
        h_, k_, jnp.asarray(tgt))), argnums=(0, 1))(jh, jk)
    tval = tfl.fused_vocab_nll(th, view, torch.from_numpy(tgt)).mean()
    tval.backward()
    _close(tval.detach(), jval, VAL_TOL, VAL_TOL)
    _close(th.grad, jg[0], GRAD_RTOL, GRAD_ATOL, "grad of h")
    _close(tk_full.grad[:, :v], jg[1], GRAD_RTOL, GRAD_ATOL, "grad of the head")
    assert torch.all(tk_full.grad[:, v:] == 0)


def test_fused_nll_bf16_matches_jax():
    """bf16 operands: both take fp32 logits of the bf16 values and round dl
    to bf16 before each backward product, so they agree to fp32 summation
    order in value and to one bf16 rounding (2^-8 of the largest gradient)
    in the bf16 gradients."""
    e, v = 32, 256
    h, k = _rand((2, 8, e), 6), _rand((e, v), 7, 0.1)
    tgt = np.random.default_rng(8).integers(0, v, (2, 8)).astype(np.int32)
    jh, jk = jnp.asarray(h, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    th = torch.tensor(h).to(torch.bfloat16).requires_grad_(True)
    tk = torch.tensor(k).to(torch.bfloat16).requires_grad_(True)
    jval, jg = jax.value_and_grad(
        lambda h_, k_: jnp.sum(jfl.fused_vocab_nll(h_, k_, jnp.asarray(tgt))),
        argnums=(0, 1))(jh, jk)
    tval = tfl.fused_vocab_nll(th, tk, torch.from_numpy(tgt))
    tval.sum().backward()
    _close(tval.detach().sum(), jval, VAL_TOL, VAL_TOL)
    for t, j in zip((th.grad, tk.grad), jg):
        assert t.dtype == torch.bfloat16
        j = np.asarray(j.astype(jnp.float32))
        _close(t.float(), j, 0, 2 ** -8 * np.abs(j).max())


def test_plain_dlogits_chunks_and_softmax_term_match_jax():
    """The dl kernel's plain version over vocab chunks (the last one
    ragged) joins into the full dl, and with the target term's cotangent at
    0 the plain backward is the gradient of ``sum(g_lse * logsumexp(h k))``
    in JAX (the softmax term alone, which the one-hot term hides at a mean
    loss's cotangent)."""
    t, e, v = 24, 16, 384
    h, k = _rand((t, e), 41), _rand((e, v), 42, 0.3)
    tg = np.random.default_rng(43).integers(-1, v, (t,)).astype(np.int32)
    g_lse = np.random.default_rng(44).random(t).astype(np.float32)
    ht, kt, tt, gt = map(torch.from_numpy, (h, k, tg, g_lse))
    lse, _ = tfl.fused_nll_fwd_ref(ht, kt, tt)
    zero = torch.zeros(t)
    full = tfl.fused_dlogits_ref(ht, kt, tt, lse, gt, -gt)
    parts = [tfl.fused_dlogits_ref(ht, kt, tt, lse, gt, -gt, v0, min(160, v - v0))
             for v0 in range(0, v, 160)]
    assert torch.equal(torch.cat(parts, dim=1), full)
    dh, dk = tfl.fused_nll_bwd_ref(ht, kt, tt, lse, gt, zero)
    jdh, jdk = jax.grad(lambda a, b: jnp.sum(jnp.asarray(g_lse)
                                             * jax.nn.logsumexp(a @ b, axis=-1)),
                        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(k))
    _close(dh, jdh, GRAD_RTOL, GRAD_ATOL)
    _close(dk, jdk, GRAD_RTOL, GRAD_ATOL)


ROUTE_CASES = [
    (torch.bfloat16, False, 32000, 64, "wgmma"),      # TinyLlama's head: rows of 64000 B
    (torch.bfloat16, True, 50257, 64, "wgmma"),       # tied [V, E]: rows of E, 128 B
    (torch.bfloat16, False, 50257, 64, "mma_sync"),   # rows of 100514 B: no TMA
    (torch.bfloat16, False, 32000, 60, "mma_sync"),   # h rows of 120 B
    (torch.float32, False, 32000, 64, "mma_sync"),    # fp32 never takes wgmma
    (torch.float32, True, 50257, 64, "mma_sync"),
]


@pytest.mark.parametrize("dtype, tied, V, E, route", ROUTE_CASES)
def test_backward_route_choice(dtype, tied, V, E, route):
    h = torch.zeros(8, E, dtype=dtype)
    k = torch.zeros(V, E, dtype=dtype).T if tied else torch.zeros(E, V, dtype=dtype)
    kvt, base = tfl._layout(k)
    assert kvt == int(tied)
    assert tfl.backward_route(h, base) == route


@pytest.mark.parametrize("dtype, tied, V, E, route", ROUTE_CASES)
def test_forward_route_choice(dtype, tied, V, E, route):
    """The forward takes the backward's route: one function decides both."""
    h = torch.zeros(8, E, dtype=dtype)
    k = torch.zeros(V, E, dtype=dtype).T if tied else torch.zeros(E, V, dtype=dtype)
    _, base = tfl._layout(k)
    assert tfl.backward_route is tfl.loss_route
    assert tfl.loss_route(h, base) == route


@pytest.mark.parametrize("V, tile", [(640, 256), (384, 256), (1000, 256), (640, 100)])
@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
def test_tiled_forward_matches_plain_forward_and_jax(V, tile, z_loss):
    """The wgmma forward's partial-and-combine order on a vocab whose last
    tile is partial (640 and 384 columns leave a 128-wide last tile of 256,
    1000 a 232-wide one), targets incl. -1 (which match no column, so tgt
    is 0), against the plain forward and, where the JAX gate takes the
    vocab (a multiple of 128), against JAX ``fused_vocab_nll`` in interpret
    mode; float32, rtol 1e-5."""
    t_count, e = 24, 32
    h, k = _rand((t_count, e), 20), _rand((e, V), 21, 0.5)
    tgt = np.random.default_rng(22).integers(-1, V, (t_count,)).astype(np.int32)
    tgt[:3] = -1
    th, tk, tt = torch.from_numpy(h), torch.from_numpy(k), torch.from_numpy(tgt)
    lse, tl = tfl.fused_nll_fwd_tiled_ref(th, tk, tt, tile)
    lse_r, tl_r = tfl.fused_nll_fwd_ref(th, tk, tt)
    _close(lse, lse_r, 1e-5, 0)
    _close(tl, tl_r, 1e-5, 1e-6)
    assert torch.all(tl[tt < 0] == 0)
    nll = lse - tl + z_loss * lse ** 2
    if V % 128 == 0:
        jnll = jfl.fused_vocab_nll(jnp.asarray(h), jnp.asarray(k), jnp.asarray(tgt),
                                   z_loss=z_loss, interpret=True)
        _close(nll, jnll, 1e-5, 1e-6)


def test_backward_route_needs_aligned_bases():
    """Rows of 64016 B (a multiple of 16) whose base lies 2 B past a
    16-byte boundary cannot be described by TMA either."""
    h = torch.zeros(8, 64, dtype=torch.bfloat16)
    padded = torch.zeros(64, 32008, dtype=torch.bfloat16)
    assert tfl.backward_route(h, padded[:, :32000]) == "wgmma"
    assert tfl.backward_route(h, padded[:, 1:32001]) == "mma_sync"
    assert tfl.backward_route(h[:, 1:], padded[:, :32000]) == "mma_sync"


def test_fused_loss_ready_gate_and_unported_axis():
    assert tfl.fused_loss_ready(256) == jfl.fused_loss_ready(256) is True
    assert tfl.fused_loss_ready(100) == jfl.fused_loss_ready(100) is False
    with pytest.raises(ValueError, match="128-multiple"):
        jfl.fused_vocab_nll(jnp.zeros((4, 8)), jnp.zeros((8, 100)), jnp.zeros((4,), jnp.int32))
    with pytest.raises(ValueError, match="128-multiple"):
        tfl.fused_vocab_nll(torch.zeros(4, 8), torch.zeros(8, 100),
                            torch.zeros(4, dtype=torch.int32))
    # over a tp axis of 1 the vocab shard is the whole head
    h, k = torch.randn(4, 8), torch.randn(8, 128)
    tg = torch.tensor([0, 5, 127, 64], dtype=torch.int32)
    torch.testing.assert_close(tfl.fused_vocab_nll(h, k, tg, axis_name="tp"),
                               tfl.fused_vocab_nll(h, k, tg), rtol=0, atol=0)
    # a sequence axis above 1 is not ported
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        tce.sharded_lm_loss(torch.zeros(1, 4, 8), torch.zeros(8, 128),
                            torch.zeros(1, 4, dtype=torch.long),
                            topo=dataclasses.make_dataclass("Topo", ["tp_size", "sp_size"])(
                                1, 2))


def _models(tie, vocab, seed):
    base = dict(vocab_size=vocab, hidden_size=32, intermediate_size=64, num_layers=1,
                num_heads=4, max_seq_len=16, tie_embeddings=tie)
    jcfg = jtf.TransformerConfig(**base, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**base, dtype=torch.float32)
    params = jax.device_get(jtf.init_params(jtf.TransformerLM(jcfg), seed=seed, seq=16))
    return jcfg, tcfg, params


def _leaves(tree):
    if hasattr(tree, "items"):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


@pytest.mark.parametrize("tie,vocab", [(False, 256), (True, 128)], ids=["untied", "tied"])
def test_model_fused_loss_matches_jax(tie, vocab):
    """make_loss_fn(loss_impl='fused') against the JAX package's fused
    model loss, and against the port's dense loss, in value and grads."""
    set_topology(Topology(TopologySpec()))
    jcfg, tcfg, params = _models(tie, vocab, seed=21)
    toks = np.random.default_rng(22).integers(0, vocab, (4, 16)).astype(np.int32)
    mask = (np.random.default_rng(23).random((4, 16)) > 0.3).astype(np.float32)
    batch = {"tokens": toks, "loss_mask": mask}
    jparams = jax.tree.map(jnp.asarray, params)
    jfused = jtf.TransformerLM(dataclasses.replace(jcfg, loss_impl="fused"))
    jval, jg = jax.value_and_grad(jtf.make_loss_fn(jfused))(
        jparams, jax.tree.map(jnp.asarray, batch))
    grads = {}
    for impl in ("fused", "xla"):
        cfg = dataclasses.replace(tcfg, loss_impl=impl)
        tparams = jax.tree.map(lambda x: torch.tensor(np.asarray(x), requires_grad=True),
                               params)
        model = ttf.TransformerLM(cfg, convert.params_from_jax(params, cfg, device="cpu"))
        val = ttf.make_loss_fn(model)(tparams, jax.tree.map(torch.from_numpy, batch))
        val.backward()
        np.testing.assert_allclose(val.item(), float(jval), rtol=VAL_TOL)
        grads[impl] = _leaves(jax.tree.map(lambda t: t.grad, tparams))
    for fused, dense, want in zip(grads["fused"], grads["xla"], _leaves(jg)):
        assert np.abs(fused - want).max() < 2e-4
        assert np.abs(fused - dense).max() < 2e-4


def test_head_bias_falls_back_to_dense_loss_with_one_warning(monkeypatch):
    """A head bias is outside the fused kernels: an explicit ``fused``
    request warns once and computes the dense loss (the JAX function's
    value at tp 1)."""
    set_topology(Topology(TopologySpec()))
    b, s, e, v = 4, 8, 16, 256
    hidden, kernel, bias = _rand((b, s, e), 17), _rand((e, v), 18, 0.1), _rand((v,), 19, 0.1)
    tokens = np.random.default_rng(20).integers(0, v, (b, s)).astype(np.int32)
    want = jce.sharded_lm_loss(jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(tokens),
                               head_bias=jnp.asarray(bias), loss_impl="xla")
    warned = []
    monkeypatch.setattr(tce, "_FUSED_FALLBACK_WARNED", set())
    monkeypatch.setattr("deepspeed_tpu_torch.utils.logging.logger.warning", warned.append)
    args = (torch.from_numpy(hidden), torch.from_numpy(kernel), torch.from_numpy(tokens))
    for impl in ("fused", "fused", "xla"):
        got = tce.sharded_lm_loss(*args, head_bias=torch.from_numpy(bias), loss_impl=impl)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert len(warned) == 1 and "head bias" in warned[0]


def test_resolve_loss_impl_and_fleet_knob_match_jax():
    bf16 = torch.bfloat16
    for impl, shard in (("xla", 512), ("fused", 100), ("auto", 512), (None, 512)):
        assert (tce.resolve_loss_impl(impl, shard, "cpu", torch.float32)
                == jce.resolve_loss_impl(impl, shard))
    assert tce.resolve_loss_impl("auto", 512, "cpu", torch.float32) == "xla"
    # on the card auto takes the kernels for the dtypes they are built for,
    # any vocab (they mask a ragged one)
    assert tce.resolve_loss_impl("auto", 512, "cuda", bf16) == "fused"
    assert tce.resolve_loss_impl("auto", 50257, torch.device("cuda", 0), torch.float32) == "fused"
    assert tce.resolve_loss_impl("auto", 512, "cuda", torch.float16) == "xla"
    assert tce.resolve_loss_impl("auto", None, "cuda", bf16) == "xla"
    configure_fastpath(loss_impl="fused")
    assert tce.resolve_loss_impl(None, 512, "cpu", torch.float32) == "fused"
    assert fastpath("loss_impl") == "fused"
    configure_fastpath(loss_impl="xla")
    assert tce.resolve_loss_impl("auto", 512, "cuda", bf16) == "xla"
    assert tce.resolve_loss_impl("fused", 512, "cpu", torch.float32) == "fused"   # explicit wins
    reset_fastpath()
    with pytest.raises(ValueError):
        tce.resolve_loss_impl("nope", 512, "cpu")
    with pytest.raises(ValueError):
        configure_fastpath(loss_impl="nope")


@pytest.mark.parametrize("impl,vocab,device,dtype,bias,want,warns", [
    ("auto", 256, "cpu", torch.float32, False, "xla", False),
    ("fused", 256, "cpu", torch.float32, False, "fused", False),
    ("fused", 100, "cpu", torch.float32, False, "xla", True),       # the plain version's gate
    ("fused", 50257, "cuda", torch.bfloat16, False, "fused", False),  # the kernels mask it
    ("auto", 50257, "cuda", torch.bfloat16, False, "fused", False),
    ("auto", 512, "cuda", torch.float16, False, "xla", False),
    ("fused", 512, "cuda", torch.float16, False, "xla", True),
    ("auto", 512, "cuda", torch.bfloat16, True, "xla", False),
    ("fused", 512, "cuda", torch.bfloat16, True, "xla", True),
], ids=["auto-cpu", "fused-cpu", "fused-cpu-ragged", "fused-card-ragged", "auto-card-ragged",
        "auto-card-fp16", "fused-card-fp16", "auto-card-bias", "fused-card-bias"])
def test_select_loss_impl_falls_back_where_kernels_cannot_run(
        monkeypatch, impl, vocab, device, dtype, bias, want, warns):
    """The one choice that ``make_loss_fn`` and ``sharded_lm_loss`` make:
    the 128-multiple gate only where the plain version runs, the kernels'
    dtypes on the card, a head bias anywhere; a warning only when ``fused``
    was asked for."""
    warned = []
    monkeypatch.setattr(tce, "_FUSED_FALLBACK_WARNED", set())
    monkeypatch.setattr("deepspeed_tpu_torch.utils.logging.logger.warning", warned.append)
    assert tce._select_loss_impl(impl, vocab, device, dtype, bias) == want
    assert bool(warned) == warns


def test_training_fastpath_fused_trains_like_jax():
    """``training_fastpath.loss_impl: fused`` reaches the knob through
    ``initialize`` and trains as the JAX engine does with the same knob."""
    set_topology(Topology(TopologySpec()))
    jcfg, tcfg, params = _models(False, 256, seed=24)
    config = {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 10**9,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "training_fastpath": {"loss_impl": "fused", "attn_impl": "xla"}}
    jeng, *_ = jds.initialize(model=jtf.make_loss_fn(jtf.TransformerLM(jcfg)),
                              model_parameters=jax.tree.map(jnp.asarray, params),
                              config=config,
                              topology=Topology(TopologySpec(), devices=jax.devices()[:1]))
    tparams = convert.params_from_jax(params, tcfg, device="cpu")
    teng, *_ = tds.initialize(model=ttf.make_loss_fn(ttf.TransformerLM(tcfg, tparams)),
                              model_parameters=tparams, config=config, device="cpu")
    assert fastpath("loss_impl") == "fused"
    toks = np.random.default_rng(25).integers(0, 256, (4, 16)).astype(np.int32)
    jl = [float(jeng.train_batch(jnp.asarray(toks))) for _ in range(3)]
    tl = [float(teng.train_batch(torch.from_numpy(toks))) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=VAL_TOL)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_vocab_sequence_parallel_cross_entropy_matches_jax_at_tp1(z_loss):
    set_topology(Topology(TopologySpec()))
    logits = _rand((2, 8, 128), 26, 3.0)
    tokens = np.random.default_rng(27).integers(0, 128, (2, 8)).astype(np.int32)
    want = jce.vocab_sequence_parallel_cross_entropy(jnp.asarray(logits), jnp.asarray(tokens),
                                                     z_loss=z_loss)
    got = tce.vocab_sequence_parallel_cross_entropy(torch.from_numpy(logits),
                                                    torch.from_numpy(tokens), z_loss=z_loss)
    _close(got, want, VAL_TOL, VAL_TOL)
