"""The port's differentiable layers against the JAX package's, on the CPU:
``flash_attention_cv``'s hand-written backward, ``flash_attention``'s
``remat_qchunk``, ``forward``'s ``remat`` / ``attn_remat`` / ``flash_cv``,
and the xLSTM recurrences' gradients (sLSTM's ``remat_chunk``, mLSTM's
chunkwise form).  Inputs are numpy draws from a seed; the JAX side runs
its own custom VJP and autodiff.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.configs import registry as ref_registry
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro.models import xlstm as ref_xlstm

from repro_torch import convert as cv
from repro_torch import configs
from repro_torch.models import layers, transformer as tf, xlstm
from repro_torch.train import step

# The shapes of the JAX package's own custom-VJP test, and its tolerances:
# outputs to 1e-5, the gradients of sum(out^2) to 2e-4.
FLASH_SHAPES = [
    (64, 8, 2, 16, 16, 16),
    (64, 4, 4, 8, 32, 16),     # MHA, rectangular chunks
    (32, 2, 1, 8, 32, 32),     # MQA, single chunk
]
OUT_TOL, GRAD_TOL = 1e-5, 2e-4
# Gradients of a whole block or model: each leaf to GRAD_RTOL of its
# largest magnitude, floored at GRAD_FLOOR of the largest gradient (a leaf
# whose exact gradient is 0, such as the mLSTM's b_i, holds rounding
# noise only; see tests/test_torch_train.py).
GRAD_RTOL, GRAD_FLOOR = 2e-4, 1e-6


def qkv(S, H, Hkv, hd, B=2, seed=None):
    rng = np.random.default_rng(S + H if seed is None else seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))


def torch_grads(fn, *arrays, dtype=torch.float32):
    """(fn's output, grads of sum(out^2) wrt each input) in PyTorch."""
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out ** 2).sum().backward()
    return out.detach(), [t.grad for t in ts]


def jax_grads(fn, *arrays):
    args = [jnp.asarray(a) for a in arrays]
    out = fn(*args)
    gs = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=tuple(range(len(args))))(*args)
    return np.asarray(out), [np.asarray(g) for g in gs]


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def assert_leaves_close(got: dict, want: dict, what=""):
    """Every leaf to GRAD_RTOL of its largest magnitude (floored)."""
    assert sorted(got) == sorted(want), what
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, w in want.items():
        w = np.asarray(w, dtype=np.float32)
        g = got[name].detach().float().numpy()
        assert g.shape == w.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        err = float(np.abs(g - w).max()) / scale
        assert err <= GRAD_RTOL, (what, name, err)


# ---------------------------------------------------------------------------
# flash_attention_cv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,Hkv,hd,cq,ck", FLASH_SHAPES)
def test_flash_cv_matches_reference(S, H, Hkv, hd, cq, ck):
    """Output and gradients against the JAX package's ``flash_attention_cv``
    and against the port's own ``flash_attention`` under autograd.  With
    several chunks the tiles past each query chunk's diagonal are fully
    masked; their gradients stay finite."""
    q, k, v = qkv(S, H, Hkv, hd)
    o_ref, g_ref = jax_grads(lambda *a: ref_layers.flash_attention_cv(*a, cq, ck), q, k, v)
    o_cv, g_cv = torch_grads(lambda *a: layers.flash_attention_cv(*a, cq, ck), q, k, v)
    o_fa, g_fa = torch_grads(lambda *a: layers.flash_attention(
        *a, causal=True, q_chunk=cq, kv_chunk=ck), q, k, v)
    assert_close(o_cv, o_ref, OUT_TOL, "out vs reference")
    assert_close(o_cv, o_fa, OUT_TOL, "out vs flash_attention")
    for name, a, b, c in zip("qkv", g_cv, g_ref, g_fa):
        assert bool(torch.isfinite(a).all()), name
        assert a.dtype == torch.float32
        assert_close(a, b, GRAD_TOL, f"d{name} vs reference")
        assert_close(a, c, GRAD_TOL, f"d{name} vs flash_attention")


def test_flash_cv_gradcheck_float64():
    """The hand-written backward against finite differences (float64 runs
    in float64 throughout)."""
    rng = np.random.default_rng(0)
    args = [torch.tensor(rng.normal(size=shape), dtype=torch.float64, requires_grad=True)
            for shape in ((1, 8, 2, 4), (1, 8, 1, 4), (1, 8, 1, 4))]
    assert torch.autograd.gradcheck(lambda q, k, v: layers.flash_attention_cv(q, k, v, 4, 2),
                                    args, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_flash_cv_bf16_keeps_dtypes():
    """bf16 inputs: the output and the gradients come back in bf16, and
    agree with the float32 computation to bf16 rounding."""
    q, k, v = qkv(32, 4, 2, 8)
    o32, g32 = torch_grads(lambda *a: layers.flash_attention_cv(*a, 16, 8), q, k, v)
    o16, g16 = torch_grads(lambda *a: layers.flash_attention_cv(*a, 16, 8), q, k, v,
                           dtype=torch.bfloat16)
    assert o16.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in g16)
    assert_close(o16.float(), o32, 2e-2)
    for a, b in zip(g16, g32):
        scale = float(b.abs().max())
        assert float((a.float() - b).abs().max()) <= 3e-2 * scale


def test_flash_cv_chunks_must_divide_s():
    """Hazard: the reference floors S // Cq with no check; the port asserts,
    as its ``flash_attention`` does."""
    q, k, v = (torch.from_numpy(a) for a in qkv(64, 4, 2, 8))
    with pytest.raises(AssertionError):
        layers.flash_attention_cv(q, k, v, 24, 16)
    with pytest.raises(AssertionError):
        layers.flash_attention_cv(q, k, v, 16, 48)


def test_fully_masked_rows_and_tied_scores_match_reference():
    """Hazards: NaN through ``where`` and ties in maxima.  With a window and
    no causal mask, rows 24 and up see nothing of the first key chunk, so
    its m is -inf: exp(s - m_safe) and exp(m - m_safe) must stay finite in
    both branches of every ``where``, or the backward gives 0 * inf = NaN.
    Zero query rows make every score of a row tie, where ``amax`` and
    ``maximum`` split the gradient as JAX's ``max`` does (the online
    softmax's m cancels in exact arithmetic, so a split elsewhere would
    only move rounding).  Values and gradients against the JAX package's
    ``flash_attention``, all finite."""
    q, k, v = qkv(64, 4, 2, 8, seed=5)
    q[:, :8] = 0.0
    kw = dict(causal=False, window=8, q_chunk=16, kv_chunk=16)
    o_ref, g_ref = jax_grads(lambda *a: ref_layers.flash_attention(*a, **kw), q, k, v)
    o, g = torch_grads(lambda *a: layers.flash_attention(*a, **kw), q, k, v)
    assert_close(o, o_ref, OUT_TOL, "out")
    for name, a, b in zip("qkv", g, g_ref):
        assert bool(torch.isfinite(a).all()), name
        assert_close(a, b, GRAD_TOL, f"d{name}")
    # causal, with zero queries: the cv backward's tied rows
    q, k, v = qkv(32, 4, 2, 8, seed=6)
    q[:, :4] = 0.0
    o_ref, g_ref = jax_grads(lambda *a: ref_layers.flash_attention_cv(*a, 8, 8), q, k, v)
    o, g = torch_grads(lambda *a: layers.flash_attention_cv(*a, 8, 8), q, k, v)
    assert_close(o, o_ref, OUT_TOL, "cv out")
    for name, a, b in zip("qkv", g, g_ref):
        assert_close(a, b, GRAD_TOL, f"cv d{name}")


def test_remat_qchunk_changes_nothing():
    """Each query chunk checkpointed: the same ops recomputed, so the same
    output and gradients, bit for bit, on the CPU."""
    q, k, v = qkv(64, 8, 2, 16)
    kw = dict(causal=True, q_chunk=16, kv_chunk=16)
    o0, g0 = torch_grads(lambda *a: layers.flash_attention(*a, **kw), q, k, v)
    o1, g1 = torch_grads(lambda *a: layers.flash_attention(*a, remat_qchunk=True, **kw), q, k, v)
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# forward's remat, attn_remat and flash_cv
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reduced_pair(aid: str):
    rcfg = ref_configs.reduced(ref_configs.ARCHS[aid])
    cfg = configs.reduced(configs.ARCHS[aid])
    params = jax.jit(functools.partial(ref_tf.init_params, rcfg))(jax.random.PRNGKey(0))
    spec = ref_registry.ShapeSpec("t", "train", 32, 2)
    batch = {k: np.asarray(v) for k, v in ref_registry.concrete_batch(rcfg, spec, seed=1).items()}
    return cfg, jax.tree.map(np.asarray, params), batch


@pytest.mark.parametrize("option", ["remat", "attn_remat", "flash_cv"])
@pytest.mark.parametrize("aid", ["qwen3_4b", "granite_3_2b"])
def test_forward_options_change_no_value_or_gradient(aid, option):
    """Each option against ``remat=False`` with the same 8-position
    chunks: the logits and every gradient leaf.  ``remat`` and
    ``attn_remat`` recompute the same ops (bit for bit on the CPU);
    ``flash_cv`` sums the backward in another order (GRAD_RTOL)."""
    cfg, tree, batch = reduced_pair(aid)
    model = cv.lm_params_from_tree(cfg, tree, device="cpu")
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    base = step.TrainConfig(remat=False, q_chunk=8, kv_chunk=8)
    tcfg = dataclasses.replace(base, **{option: True})
    fwd = {k: v for k, v in tb.items() if k != "labels"}
    with torch.no_grad():
        l0, a0 = tf.forward(model, cfg, fwd, remat=False, q_chunk=8, kv_chunk=8)
        l1, a1 = tf.forward(model, cfg, fwd, remat=tcfg.remat, q_chunk=8, kv_chunk=8,
                            attn_remat=tcfg.attn_remat, flash_cv=tcfg.flash_cv)
    assert_close(l1, l0, OUT_TOL, "logits")
    t0, _, g0 = step.value_and_grad(model, cfg, tb, base)
    t1, _, g1 = step.value_and_grad(model, cfg, tb, tcfg)
    np.testing.assert_allclose(float(t1), float(t0), rtol=1e-6)
    if option == "flash_cv":
        assert_leaves_close(g1, {n: g.numpy() for n, g in g0.items()}, option)
    else:
        assert all(torch.equal(g1[n], g0[n]) for n in g0), option
        assert float(t1) == float(t0)


def test_remat_acts_only_while_autograd_records(monkeypatch):
    """Serving under ``no_grad`` runs the layers as before: no checkpoint."""
    cfg, tree, batch = reduced_pair("qwen3_4b")
    model = cv.lm_params_from_tree(cfg, tree, device="cpu")
    calls = []
    real = tf.checkpoint
    monkeypatch.setattr(tf, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    fwd = {"tokens": torch.from_numpy(batch["tokens"].copy())}
    with torch.no_grad():
        tf.forward(model, cfg, fwd)
    assert not calls
    step.value_and_grad(model, cfg, dict(fwd, labels=torch.from_numpy(batch["labels"].copy())),
                        step.TrainConfig())
    n_periods = len(tf.stack_segments(cfg)[1])
    assert len(calls) == n_periods > 0
    assert not any(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# xLSTM recurrences
# ---------------------------------------------------------------------------

def block_pair(kind: str, seed: int = 0):
    """A JAX block's parameters (float32) and the port's block holding them."""
    d, H = 64, 4
    key = jax.random.PRNGKey(seed)
    if kind == "slstm":
        rp = ref_xlstm.slstm_init(key, d, H, jnp.float32)
        blk = xlstm.SLSTMBlock(d, H, torch.float32, "cpu")
    else:
        rp = ref_xlstm.mlstm_init(key, d, H, 4, jnp.float32)
        blk = xlstm.MLSTMBlock(d, H, 4, torch.float32, "cpu")
    rp = jax.tree.map(np.asarray, rp)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(rp[name], np.float32)))
            p.requires_grad_(True)
    return rp, blk


def run_block(kind, blk, x, w, **kw):
    """(y, {param or "x": grad}) of sum(y * w) through the port's block."""
    xt = torch.tensor(x, requires_grad=True)
    fn = xlstm.slstm_apply if kind == "slstm" else xlstm.mlstm_apply
    y, _ = fn(blk, xt, n_heads=4, **kw)
    (y * torch.from_numpy(w)).sum().backward()
    grads = {n: p.grad.clone() for n, p in blk.named_parameters()}
    grads["x"] = xt.grad
    for p in blk.parameters():
        p.grad = None
    return y.detach(), grads


@pytest.mark.parametrize("kind,kw", [("slstm", {"remat_chunk": 16}),
                                     ("mlstm", {"chunk": 8})], ids=["slstm", "mlstm"])
def test_xlstm_gradients_match_reference_and_sequential(kind, kw):
    """sLSTM with ``remat_chunk=16`` (each chunk of 16 steps checkpointed)
    and mLSTM's chunkwise form with ``chunk=8``: values and the gradients
    of every parameter and of x against the JAX package's same call, and
    against the port's sequential form.  The chunkwise stabilizer is a
    ``cummax``, which sends a tie's gradient to one index where JAX's
    splits it; the stabilizer's gradient cancels in exact arithmetic, so
    that is rounding-level and GRAD_RTOL covers it."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    w = rng.normal(size=(2, 32, 64)).astype(np.float32)
    rp, blk = block_pair(kind)
    rfn = ref_xlstm.slstm_apply if kind == "slstm" else ref_xlstm.mlstm_apply

    def ref_loss(p, xx):
        y, _ = rfn(p, xx, n_heads=4, **kw)
        return jnp.sum(y * w), y
    (_, y_ref), (gp, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, rp), jnp.asarray(x))
    want = dict(jax.tree.map(np.asarray, gp), x=np.asarray(gx))
    y, g = run_block(kind, blk, x, w, **kw)
    assert_close(y, y_ref, OUT_TOL, "y vs reference")
    assert_leaves_close(g, want, "vs reference")
    y_seq, g_seq = run_block(kind, blk, x, w)
    if kind == "slstm":          # the same steps, checkpointed: bit for bit
        assert torch.equal(y, y_seq)
        assert all(torch.equal(g[n], g_seq[n]) for n in g)
    else:
        assert_close(y, y_seq, OUT_TOL, "y vs sequential")
        assert_leaves_close(g, {n: t.numpy() for n, t in g_seq.items()}, "vs sequential")
