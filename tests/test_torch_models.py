"""The port's language-model serving stack (``repro_torch.models``,
``repro_torch.serving.decode``, ``repro_torch.configs``,
``repro_torch.data.tokens``) against the JAX package's, on the CPU.

For every reduced architecture, the reference's ``init_params(reduced(cfg),
PRNGKey(0))`` weights are carried into the port (``repro_torch.convert``)
and both packages run the same numpy inputs (``concrete_batch``, seed 1):
``forward`` over the prompt extended by one token, ``prefill`` over the
prompt, and ``decode_step`` at the prompt's end on the prefill's caches
grown by one position.  Every logit, the aux loss and every cache leaf
must agree within the float32 tolerances below; cache names, shapes and
dtypes must be the reference's.  The layers are also held one at a time,
on the cases that the reduced configs do not reach (several chunks,
windows, dropped tokens, ties, carried state, a ring wrap).  The bf16
cases are in ``tests/test_torch_models_bf16.py``.
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
from repro.data import tokens as ref_tokens
from repro.models import layers as ref_layers
from repro.models import rglru as ref_rglru
from repro.models import transformer as ref_tf
from repro.models import xlstm as ref_xlstm
from repro import serving as ref_serving

from repro_torch import convert as cv
from repro_torch import configs
from repro_torch.configs import registry
from repro_torch.data import tokens
from repro_torch.models import layers, rglru, transformer as tf, xlstm
from repro_torch.models.config import BLOCK_ATTN, FAMILY_AUDIO
from repro_torch import serving
from repro_torch.serving.decode import grow_caches

ALL_ARCHS = sorted(ref_configs.ARCHS)
B, S = 2, 32
# float32: the two packages sum in different orders (XLA against ATen), so
# values agree to about 1e-5 of a tensor's largest magnitude, not bit for
# bit.  Logits (largest about 0.8) are held to RTOL and ATOL; a cache leaf
# to RTOL and 1e-4 of its largest magnitude (values up to about 10).  The
# conv-state leaves are rounded to bf16 in both packages; a float32
# difference at a rounding boundary moves one bf16 ulp (2^-8 relative), so
# those leaves get a tolerance of one bf16 ulp.
RTOL, ATOL = 1e-4, 5e-5
CACHE_ATOL = 1e-4
CONV_RTOL = 2.0 ** -7


def np32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def ref_grow(rcfg, tree):
    """The reference's cache tree with every full-attention cache grown by
    one zero position (what ``grow_caches`` does in the port)."""
    top, layers_ = cv.split_layers(rcfg, jax.tree.map(np.asarray, tree))
    for i, c in enumerate(layers_):
        if rcfg.block_kind(i) == BLOCK_ATTN:
            for k in c:
                c[k] = np.concatenate([c[k], np.zeros_like(c[k][:, :1])], axis=1)
    return jax.tree.map(jnp.asarray, cv.join_layers(rcfg, top, layers_, stack=np.stack))


@dataclasses.dataclass
class Pair:
    """One architecture in both packages, with the reference's outputs."""
    cfg: object
    rcfg: object
    tree: dict            # the reference's parameters (numpy)
    batch: dict           # numpy inputs: prompt, extended prompt, next token
    ext: dict
    inp: dict
    ref: dict             # the reference's outputs (numpy)

    def model(self):
        return cv.lm_params_from_tree(self.cfg, self.tree, device="cpu")

    def tensors(self, d):
        return {k: cv.tensor_from_numpy(v) for k, v in d.items()}


def make_pair(aid: str, dtype: str = "float32") -> Pair:
    rcfg = dataclasses.replace(ref_configs.reduced(ref_configs.ARCHS[aid]),
                               param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[aid]),
                              param_dtype=dtype, compute_dtype=dtype)
    params = jax.jit(functools.partial(ref_tf.init_params, rcfg))(jax.random.PRNGKey(0))
    spec = ref_registry.ShapeSpec("tiny", "prefill", S, B)
    batch = {k: np.asarray(v) for k, v in ref_registry.concrete_batch(rcfg, spec, seed=1).items()}
    rng = np.random.default_rng(3)
    if rcfg.family == FAMILY_AUDIO:
        fe = rng.normal(size=(B, rcfg.frontend_dim())).astype(np.float32)
        ext = {"frame_embeds": np.concatenate([batch["frame_embeds"], fe[:, None]], axis=1)}
        inp = {"frame_embeds": fe}
    else:
        tok = rng.integers(0, rcfg.vocab, B).astype(np.int32)
        ext = dict(batch, tokens=np.concatenate([batch["tokens"], tok[:, None]], axis=1))
        inp = {"token": tok}
    fwd = jax.jit(functools.partial(ref_tf.forward, cfg=rcfg, remat=False))
    pre = jax.jit(functools.partial(ref_serving.prefill, cfg=rcfg))
    dec = jax.jit(functools.partial(ref_serving.decode_step, cfg=rcfg))
    logits, aux = fwd(params, batch=ext)
    last, caches = pre(params, batch=batch)
    grown = ref_grow(rcfg, caches)
    dlogits, dcaches = dec(params, caches=grown, inputs=inp, pos=jnp.int32(S))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return Pair(cfg, rcfg, np_tree(params), batch, ext, inp,
                {"logits": np.asarray(logits), "aux": float(aux),
                 "last": np.asarray(last), "caches": np_tree(caches),
                 "grown": np_tree(grown), "dlogits": np.asarray(dlogits),
                 "dcaches": np_tree(dcaches)})


@pytest.fixture(scope="module")
def pairs():
    """Each architecture's reference outputs, computed once, on first use."""
    return functools.lru_cache(maxsize=None)(make_pair)


def assert_caches_match(pair: Pair, ref_tree, caches, rtol, atol, conv_rtol):
    """Every leaf of every layer: the reference's name, shape and dtype, and
    values within ``rtol`` and ``atol`` times the leaf's largest magnitude
    (``m`` states compared where finite)."""
    _, ref_layers_ = cv.split_layers(pair.rcfg, ref_tree)
    assert len(caches) == len(ref_layers_) == pair.cfg.n_layers
    for li, (want, got) in enumerate(zip(ref_layers_, caches)):
        assert sorted(want) == sorted(got), (li, sorted(want), sorted(got))
        for name, w in want.items():
            g = got[name]
            assert tuple(g.shape) == w.shape, (li, name, tuple(g.shape), w.shape)
            assert cv.dtype_name(g.dtype) == cv.dtype_name(w.dtype), (li, name, g.dtype, w.dtype)
            w32, g32 = np32(w), t2np(g)
            np.testing.assert_array_equal(np.isfinite(g32), np.isfinite(w32), err_msg=f"{li} {name}")
            fin = np.isfinite(w32)
            scale = float(np.abs(w32[fin]).max(initial=1.0))
            np.testing.assert_allclose(g32[fin], w32[fin], err_msg=f"layer {li} {name}",
                                       rtol=conv_rtol if name == "conv" else rtol,
                                       atol=atol * scale)


# ---------------------------------------------------------------------------
# Whole models, float32, all ten reduced architectures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_forward_matches_reference(pairs, aid):
    pair = pairs(aid)
    logits, aux = tf.forward(pair.model(), pair.cfg, pair.tensors(pair.ext))
    assert logits.dtype == torch.float32 and logits.shape == pair.ref["logits"].shape
    np.testing.assert_allclose(t2np(logits), pair.ref["logits"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), pair.ref["aux"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_prefill_matches_reference(pairs, aid):
    pair = pairs(aid)
    last, caches = serving.prefill(pair.model(), pair.cfg, pair.tensors(pair.batch))
    np.testing.assert_allclose(t2np(last), pair.ref["last"], rtol=RTOL, atol=ATOL)
    assert_caches_match(pair, pair.ref["caches"], caches, RTOL, CACHE_ATOL, CONV_RTOL)


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_decode_matches_reference(pairs, aid):
    """On the reference's grown caches, carried across."""
    pair = pairs(aid)
    caches = cv.lm_caches_from_tree(pair.cfg, pair.ref["grown"], device="cpu")
    shapes = [{k: (tuple(t.shape), t.dtype) for k, t in c.items()} for c in caches]
    logits, caches = serving.decode_step(pair.model(), pair.cfg, caches,
                                         pair.tensors(pair.inp), S)
    np.testing.assert_allclose(t2np(logits), pair.ref["dlogits"], rtol=RTOL, atol=ATOL)
    assert shapes == [{k: (tuple(t.shape), t.dtype) for k, t in c.items()} for c in caches]
    assert_caches_match(pair, pair.ref["dcaches"], caches, RTOL, CACHE_ATOL, CONV_RTOL)


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_convert_round_trip(pairs, aid):
    """Parameters and caches: the reference's tree -> the port -> the tree
    layout again gives the same names, shapes, dtypes and values; the
    port's ``abstract_params`` / ``abstract_caches`` (on ``meta``) have the
    reference's shapes and dtypes, and ``grow_caches`` grows what the
    test's reference-side grow does."""
    pair = pairs(aid)
    model = pair.model()
    for tree, back in ((pair.tree, cv.lm_tree_from_params(pair.cfg, model)),
                       (pair.ref["caches"], cv.lm_tree_from_caches(
                           pair.cfg, cv.lm_caches_from_tree(pair.cfg, pair.ref["caches"],
                                                            device="cpu")))):
        want = jax.tree_util.tree_flatten_with_path(tree)[0]
        got = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in want] == [p for p, _ in got]
        for (path, w), (_, g) in zip(want, got):
            assert tuple(g.shape) == w.shape and cv.dtype_name(g.dtype) == cv.dtype_name(w.dtype), path
            np.testing.assert_array_equal(t2np(g), np32(w))
    abstract = tf.abstract_params(pair.cfg)
    assert all(p.device.type == "meta" for p in abstract.parameters())
    assert [(n, p.shape, p.dtype) for n, p in abstract.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in model.named_parameters()]
    ref_empty = jax.tree.map(np.asarray, ref_serving.init_caches(pair.rcfg, B, S))
    _, want = cv.split_layers(pair.rcfg, ref_empty)
    got = serving.abstract_caches(pair.cfg, B, S)
    assert [{k: (tuple(v.shape), cv.dtype_name(v.dtype)) for k, v in c.items()} for c in want] == \
        [{k: (tuple(v.shape), cv.dtype_name(v.dtype)) for k, v in c.items()} for c in got]
    grown = grow_caches(pair.cfg, cv.lm_caches_from_tree(pair.cfg, pair.ref["caches"],
                                                         device="cpu"), 1)
    _, want = cv.split_layers(pair.rcfg, pair.ref["grown"])
    for w, g in zip(want, grown):
        for k in w:
            np.testing.assert_array_equal(t2np(g[k]), np32(w[k]))


def test_conv_state_is_rounded_to_bf16_in_float32_configs(pairs):
    """Hazard: the reference rounds the mLSTM and RG-LRU conv states to
    bf16 even in float32 configs, then casts them to the compute dtype."""
    for aid in ("xlstm_125m", "recurrentgemma_9b"):
        pair = pairs(aid)
        _, caches = serving.prefill(pair.model(), pair.cfg, pair.tensors(pair.batch))
        convs = [c["conv"] for c in caches if "conv" in c]
        assert convs
        for c in convs:
            assert c.dtype == torch.float32
            assert torch.equal(c, c.to(torch.bfloat16).float())
            assert c.abs().max() > 0


def test_decode_past_the_cache_end_raises(pairs):
    """Hazard: ``dynamic_update_slice`` clamps a write at pos >= Smax to
    Smax - 1; the port raises instead."""
    pair = pairs("qwen2_1_5b")
    model = pair.model()
    caches = cv.lm_caches_from_tree(pair.cfg, pair.ref["caches"], device="cpu")
    with pytest.raises(IndexError, match="grow the caches"):
        serving.decode_step(model, pair.cfg, caches, pair.tensors(pair.inp), S)
    logits, _ = serving.decode_step(model, pair.cfg, grow_caches(pair.cfg, caches, 1),
                                    pair.tensors(pair.inp), S)
    np.testing.assert_allclose(t2np(logits), pair.ref["dlogits"], rtol=RTOL, atol=ATOL)


def test_decode_past_a_short_ring_raises(pairs):
    """Hazard: a prompt of 16 under the window of 32 leaves a ring of 16
    slots; the reference's decode at 16 wraps onto slot 0, whose position
    is still inside the window.  The port raises until the caches grow."""
    pair = pairs("recurrentgemma_9b")
    cfg, model = pair.cfg, pair.model()
    S0 = 16
    batch = {k: v[:, :S0] for k, v in pair.tensors(pair.batch).items()}
    _, caches = serving.prefill(model, cfg, batch)
    tok = {"token": batch["tokens"][:, -1]}
    with pytest.raises(IndexError, match="grow the caches"):
        serving.decode_step(model, cfg, caches, tok, S0)
    logits, _ = serving.decode_step(model, cfg, grow_caches(cfg, caches, 1), tok, S0)
    assert torch.isfinite(logits).all()


def test_ring_cache_after_a_wrap(pairs):
    """Hazard: the local ring cache.  A prompt of 48 > window 32 makes the
    prefill roll its last 32 positions by 16; decode then writes slot
    48 mod 32 and masks by absolute position."""
    pair = pairs("recurrentgemma_9b")
    rcfg, cfg = pair.rcfg, pair.cfg
    params = jax.tree.map(jnp.asarray, pair.tree)
    spec = ref_registry.ShapeSpec("ring", "prefill", 48, B)
    batch = {k: np.asarray(v) for k, v in ref_registry.concrete_batch(rcfg, spec, seed=5).items()}
    last, caches = jax.jit(functools.partial(ref_serving.prefill, cfg=rcfg))(params, batch=batch)
    tok = np.array([7, 11], np.int32)
    dl, dcaches = jax.jit(functools.partial(ref_serving.decode_step, cfg=rcfg))(
        params, caches=caches, inputs={"token": tok}, pos=jnp.int32(48))
    model = pair.model()
    tlast, tcaches = serving.prefill(model, cfg, pair.tensors(batch))
    np.testing.assert_allclose(t2np(tlast), np32(last), rtol=RTOL, atol=ATOL)
    ring = [c for i, c in enumerate(tcaches) if cfg.block_kind(i) == "local"]
    assert ring and all(c["k"].shape[1] == cfg.local_window for c in ring)
    assert_caches_match(pair, jax.tree.map(np.asarray, caches), tcaches, RTOL, CACHE_ATOL, CONV_RTOL)
    tdl, tcaches = serving.decode_step(model, cfg, tcaches, {"token": torch.from_numpy(tok)}, 48)
    np.testing.assert_allclose(t2np(tdl), np32(dl), rtol=RTOL, atol=ATOL)
    assert_caches_match(pair, jax.tree.map(np.asarray, dcaches), tcaches, RTOL, CACHE_ATOL, CONV_RTOL)


def test_ring_shorter_than_the_window_grows_to_the_window(pairs):
    """Hazard: a prompt of 16 under the window of 32 leaves the prefill a
    ring of 16 slots (position p at slot p).  ``grow_caches`` by 24 pads it
    to min(32, 40) slots, as the test pads the reference's ring here, so
    that decoding past 16 evicts nothing still inside the window (the
    reference's decode reads W from the cache).  The grown caches equal
    the padded reference tree bit for bit; 8 greedy steps (the
    reference's tokens fed to both) match its logits."""
    pair = pairs("recurrentgemma_9b")
    rcfg, cfg = pair.rcfg, pair.cfg
    S0, extra, steps = 16, 24, 8
    W = min(cfg.local_window, S0 + extra)
    params = jax.tree.map(jnp.asarray, pair.tree)
    spec = ref_registry.ShapeSpec("short", "prefill", S0, B)
    batch = {k: np.asarray(v) for k, v in ref_registry.concrete_batch(rcfg, spec, seed=7).items()}
    _, caches = jax.jit(functools.partial(ref_serving.prefill, cfg=rcfg))(params, batch=batch)
    top, layers_ = cv.split_layers(rcfg, jax.tree.map(np.asarray, caches))
    ring = [i for i in range(cfg.n_layers) if rcfg.block_kind(i) == "local"]
    assert ring and all(layers_[i]["k"].shape[1] == S0 for i in ring)
    for i in ring:
        for k, v in layers_[i].items():
            layers_[i][k] = np.concatenate(
                [v, np.zeros(v.shape[:1] + (W - S0,) + v.shape[2:], v.dtype)], axis=1)
    padded = cv.join_layers(rcfg, top, layers_, stack=np.stack)
    model = pair.model()
    _, tcaches = serving.prefill(model, cfg, pair.tensors(batch))
    tcaches = grow_caches(cfg, tcaches, extra)
    carried = grow_caches(cfg, cv.lm_caches_from_tree(cfg, jax.tree.map(np.asarray, caches),
                                                      device="cpu"), extra)
    _, want = cv.split_layers(rcfg, padded)
    for w, g in zip(want, carried):
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(t2np(g[k]), np32(w[k]))
    assert all(tcaches[i]["k"].shape[1] == W for i in ring)
    dec = jax.jit(functools.partial(ref_serving.decode_step, cfg=rcfg))
    rcaches = jax.tree.map(jnp.asarray, padded)
    tok = batch["tokens"][:, -1].copy()
    for t in range(steps):
        dl, rcaches = dec(params, caches=rcaches, inputs={"token": tok}, pos=jnp.int32(S0 + t))
        tdl, tcaches = serving.decode_step(model, cfg, tcaches,
                                           {"token": torch.from_numpy(tok)}, S0 + t)
        np.testing.assert_allclose(t2np(tdl), np32(dl), rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
        tok = np.asarray(dl).argmax(-1).astype(np.int32)
    assert_caches_match(pair, jax.tree.map(np.asarray, rcaches), tcaches, RTOL, CACHE_ATOL,
                        CONV_RTOL)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def qkv(seed, Sq=64, H=8, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(2, Sq, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(2, Sq, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kw", [{}, {"window": 24}, {"causal_skip": True}],
                         ids=["causal", "window", "causal_skip"])
def test_flash_attention_gqa_chunks(kw):
    """GQA G=4 over four query and four key chunks (the upper chunks fully
    masked), with a window and with the causal horizon skip."""
    q, k, v = qkv(0)
    want = ref_layers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      q_chunk=16, kv_chunk=16, **kw)
    got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), q_chunk=16, kv_chunk=16, **kw)
    np.testing.assert_allclose(t2np(got), np32(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError):
        layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_chunk=24)


def test_local_attention_past_the_window():
    """S = 64 > window 16 + Cq 16: the key slice moves with the chunk."""
    q, k, v = qkv(1)
    want = ref_layers.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      window=16, q_chunk=16)
    got = layers.local_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=16, q_chunk=16)
    np.testing.assert_allclose(t2np(got), np32(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention(window):
    q, k, v = qkv(2)
    q1 = q[:, 0]
    want = ref_layers.decode_attention(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                                       jnp.int32(40), window=window)
    got = layers.decode_attention(torch.from_numpy(q1), torch.from_numpy(k),
                                  torch.from_numpy(v), 40, window=window)
    np.testing.assert_allclose(t2np(got), np32(want), rtol=RTOL, atol=ATOL)


def moe_case(seed, N=24, d=16, E=4, f=8, zero_router=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, d)).astype(np.float32)
    router = (np.zeros((d, E)) if zero_router else rng.normal(size=(d, E))).astype(np.float32)
    wg, wu = (rng.normal(size=(E, d, f)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(E, f, d)).astype(np.float32)
    return x, router, wg, wu, wd


@pytest.mark.parametrize("zero_router", [False, True], ids=["drops", "ties"])
def test_moe_ffn(zero_router):
    """At capacity_factor 1.0 some (token, k) pairs are dropped, and which
    ones follows the stable sort by expert; with a zero router every
    probability ties and top-k takes the lowest experts first."""
    args = moe_case(4, zero_router=zero_router)
    want, waux = ref_layers.moe_ffn(*map(jnp.asarray, args), top_k=2, capacity_factor=1.0)
    got, aux = layers.moe_ffn(*map(torch.from_numpy, args), top_k=2, capacity_factor=1.0)
    np.testing.assert_allclose(t2np(got), np32(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=RTOL, atol=ATOL)
    x, router = torch.from_numpy(args[0]), torch.from_numpy(args[1])
    _, top_e = layers.top_k_stable(torch.softmax(x @ router, -1), 2)
    C = int(np.ceil(24 * 2 / 4 * 1.0))
    assert int(torch.bincount(top_e.reshape(-1), minlength=4).max()) > C   # some dropped
    if zero_router:
        assert (top_e == torch.tensor([0, 1])).all()


def test_mlstm_chunkwise_against_reference_and_sequential():
    """Chunk 8 over S = 32, from a carried state, against the reference's
    chunkwise form and the port's own sequential scan."""
    rng = np.random.default_rng(6)
    Bm, H, hd = 2, 2, 8
    q, k, v = (rng.normal(size=(Bm, 32, H, hd)).astype(np.float32) for _ in range(3))
    logi = rng.normal(size=(Bm, 32, H)).astype(np.float32)
    logf = np.log(1 / (1 + np.exp(-rng.normal(size=(Bm, 32, H)) - 2))).astype(np.float32)
    C0 = rng.normal(size=(Bm, H, hd, hd)).astype(np.float32) * 0.1
    n0 = rng.normal(size=(Bm, H, hd)).astype(np.float32) * 0.1
    m0 = rng.normal(size=(Bm, H)).astype(np.float32)
    args = (q, k, v, logi, logf)
    (wC, wn, wm), wh = ref_xlstm._mlstm_chunkwise(*map(jnp.asarray, args),
                                                   tuple(map(jnp.asarray, (C0, n0, m0))), 8)
    targs = tuple(map(torch.from_numpy, args))
    carry = tuple(map(torch.from_numpy, (C0, n0, m0)))
    (C, n, m), h = xlstm._mlstm_chunkwise(*targs, carry, 8)
    for g, w in ((C, wC), (n, wn), (m, wm), (h, wh)):
        np.testing.assert_allclose(t2np(g), np32(w), rtol=RTOL, atol=ATOL)
    seq = carry
    hs = []
    for t in range(32):
        seq, ht = xlstm._mlstm_step(seq, tuple(a[:, t] for a in targs))
        hs.append(ht)
    np.testing.assert_allclose(t2np(torch.stack(hs, 1)), t2np(h), rtol=1e-4, atol=1e-4)
    for g, w in zip(seq, (C, n, m)):
        np.testing.assert_allclose(t2np(g), t2np(w), rtol=1e-4, atol=1e-4)


def test_rglru_apply_with_a_carried_state(pairs):
    """S > 1 from a non-zero h and conv state (the fold into the first
    element, the log-depth scan), then one exact step."""
    pair = pairs("recurrentgemma_9b")
    li = next(i for i in range(pair.cfg.n_layers) if pair.cfg.block_kind(i) == "rglru")
    _, flat = cv.split_layers(pair.rcfg, pair.tree)
    p_ref = jax.tree.map(jnp.asarray, cv._nest(flat[li]))
    p = pair.model().layers[li]
    rng = np.random.default_rng(7)
    w = p.w_in.shape[1]
    x = rng.normal(size=(2, 24, pair.cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, w)).astype(np.float32)
    conv0 = rng.normal(size=(2, 3, w)).astype(np.float32)
    ref_apply = jax.jit(ref_rglru.rglru_apply)
    want = ref_apply(p_ref, jnp.asarray(x), {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)})
    got = rglru.rglru_apply(p, torch.from_numpy(x),
                            {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv0)})
    np.testing.assert_allclose(t2np(got[0]), np32(want[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t2np(got[1]["h"]), np32(want[1]["h"]), rtol=RTOL, atol=ATOL)
    assert got[1]["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(t2np(got[1]["conv"]), np32(want[1]["conv"]), rtol=CONV_RTOL)
    step = ref_apply(p_ref, jnp.asarray(x[:, :1]), want[1])
    tstep = rglru.rglru_apply(p, torch.from_numpy(x[:, :1]), got[1])
    np.testing.assert_allclose(t2np(tstep[0]), np32(step[0]), rtol=RTOL, atol=ATOL)


def test_rope_gelu_and_promotion():
    """Hazards: RoPE rotates the two halves of hd in float32; ``gelu`` is
    ``jax.nn.gelu``'s tanh form; a product of bf16 and float32 promotes to
    float32 as in JAX (``torch.matmul`` alone raises)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None] + 1000
    np.testing.assert_allclose(
        t2np(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
        np32(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2np(layers.gelu(torch.from_numpy(x))),
                               np32(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    a = torch.from_numpy(x[0, 0]).to(torch.bfloat16)             # [3, 8]
    b = torch.from_numpy(x[1, 0].T.copy())                       # [8, 3] float32
    with pytest.raises(RuntimeError):
        a @ b
    got = layers.matmul(a, b)
    want = jnp.asarray(np.asarray(x[0, 0]), jnp.bfloat16) @ jnp.asarray(x[1, 0].T)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(t2np(got), np32(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Registry and data
# ---------------------------------------------------------------------------

def test_registry_equals_reference():
    """ARCHS field by field, the aliases, SHAPES, shape_applicable,
    applicable_cells and reduced()."""
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    for aid, cfg in configs.ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_configs.ARCHS[aid]), aid
        assert dataclasses.asdict(configs.reduced(cfg)) == \
            dataclasses.asdict(ref_configs.reduced(ref_configs.ARCHS[aid])), aid
        assert cfg.n_params() == ref_configs.ARCHS[aid].n_params()
        assert configs.get_config(cfg.arch_id) is cfg
    assert registry.ALIASES == ref_registry.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert configs.applicable_cells() == ref_configs.applicable_cells()
    for aid in configs.ARCHS:
        for sh in configs.SHAPES.values():
            assert configs.shape_applicable(configs.ARCHS[aid], sh) == \
                ref_configs.shape_applicable(ref_configs.ARCHS[aid],
                                             ref_configs.SHAPES[sh.name])


def test_input_specs_and_concrete_batch_equal_reference():
    small = [ref_registry.ShapeSpec(n, k, 16, 3) for n, k in
             (("t", "train"), ("p", "prefill"), ("d", "decode"))]
    for aid in configs.ARCHS:
        for sh in list(configs.SHAPES.values()):
            want = ref_configs.input_specs(ref_configs.ARCHS[aid], sh)
            got = configs.input_specs(configs.ARCHS[aid], sh)
            assert {k: (tuple(v.shape), cv.dtype_name(v.dtype)) for k, v in want.items()} == \
                {k: (tuple(v.shape), cv.dtype_name(v.dtype)) for k, v in got.items()}, (aid, sh)
        for sh in small:
            rcfg = ref_configs.reduced(ref_configs.ARCHS[aid])
            want = ref_registry.concrete_batch(rcfg, sh, seed=4)
            got = registry.concrete_batch(configs.reduced(configs.ARCHS[aid]), sh, seed=4,
                                          device="cpu")
            assert list(want) == list(got)
            for k in want:
                assert cv.dtype_name(got[k].dtype) == cv.dtype_name(want[k].dtype)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_token_pipeline_and_frontend_batch_equal_reference():
    ref = ref_tokens.TokenPipeline(vocab=151936, batch=3, seq=40, seed=5)
    got = tokens.TokenPipeline(vocab=151936, batch=3, seq=40, seed=5)
    for step in (0, 7):
        w, g = ref.batch_at(step), got.batch_at(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert [b["tokens"].sum() for b in (got.next_batch(), got.next_batch())] == \
        [b["tokens"].sum() for b in (ref.next_batch(), ref.next_batch())]
    assert got.state_dict() == ref.state_dict()
    for aid in ("musicgen_medium", "llava_next_mistral_7b", "qwen2_1_5b"):
        w = ref_tokens.frontend_batch(ref_configs.ARCHS[aid], 2, 12, seed=3)
        g = tokens.frontend_batch(configs.ARCHS[aid], 2, 12, seed=3)
        assert list(w) == list(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
