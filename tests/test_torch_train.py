"""The port's language-model training (``repro_torch.train``) against the
JAX package's, on the CPU, for all ten reduced architectures in float32.

The reference's ``init_params(reduced(cfg), PRNGKey(0))`` weights are
carried into the port (``repro_torch.convert``) and both packages take the
same numpy batch (``concrete_batch``, "train", B=2, S=32, seed 1).  Once per
arch the reference runs ``jax.value_and_grad(loss_fn)`` and its jitted
``make_train_step``, both with ``remat=False`` (``jax.checkpoint``
recomputes the same ops); the port runs ``value_and_grad`` with ``remat``
on and off, and one ``train_step`` with ``remat`` on.  The optimizer is also held on its own, on
gradients that both packages are given.
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
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step

from repro_torch import convert as cv
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step

ALL_ARCHS = sorted(ref_configs.ARCHS)
B, S = 2, 32
# float32: the packages sum in different orders (XLA against ATen); the
# reduced configs' losses agree to a few ulps and every gradient leaf to
# 7e-5 of its largest magnitude (recurrentgemma's layer-2 wq, the worst).
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
# A leaf whose exact gradient is 0 holds rounding noise only: the mLSTM's
# input-gate bias b_i (a shift of every input-gate logit is absorbed by the
# stabilizer m, so the output does not depend on it) measures 1e-13 against
# 1e-6 for its neighbours.  So a leaf's scale is at least GRAD_FLOOR of the
# model's largest gradient.
GRAD_FLOOR = 1e-6


def np32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def leaf_errors(cfg, got: dict, want_tree, floor: float = GRAD_FLOOR) -> dict:
    """{name: max |got - want| / scale} over every parameter-shaped leaf;
    scale is the leaf's largest magnitude, floored at ``floor`` of the
    largest over all leaves."""
    want = {k: np32(v) for k, v in cv.lm_named_from_tree(cfg, want_tree).items()}
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    out = {}
    for name, w in want.items():
        g = t2np(got[name])
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), floor * top, 1e-30)
        out[name] = float(np.abs(g - w).max()) / scale
    return out


@dataclasses.dataclass
class Ref:
    """One architecture's inputs and the reference's results (numpy)."""
    cfg: object
    rcfg: object
    tree: dict
    batch: dict
    loss: float
    nll: float
    aux: float
    grads: dict
    after: dict          # params, m, v, step, metrics after one train_step

    def model(self):
        return cv.lm_params_from_tree(self.cfg, self.tree, device="cpu")

    def tensors(self):
        return {k: torch.from_numpy(v.copy()) for k, v in self.batch.items()}


def make_ref(aid: str) -> Ref:
    rcfg = ref_configs.reduced(ref_configs.ARCHS[aid])
    cfg = configs.reduced(configs.ARCHS[aid])
    params = jax.jit(functools.partial(ref_tf.init_params, rcfg))(jax.random.PRNGKey(0))
    spec = ref_registry.ShapeSpec("t", "train", S, B)
    batch = {k: np.asarray(v) for k, v in ref_registry.concrete_batch(rcfg, spec, seed=1).items()}
    tcfg = ref_step.TrainConfig(remat=False)
    vg = jax.value_and_grad(lambda p, b: ref_step.loss_fn(p, rcfg, b, tcfg), has_aux=True)
    train = ref_step.make_train_step(rcfg, tcfg)
    # one jit for both: XLA shares their forward and backward, which saves
    # a third of the compile time
    both = jax.jit(lambda p, o, b: (vg(p, b), train(p, o, b)))
    ((total, parts), grads), (new_p, new_o, metrics) = both(
        params, ref_opt.init_opt_state(params), batch)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    after = {"params": np_tree(new_p), "m": np_tree(new_o["m"]), "v": np_tree(new_o["v"]),
             "step": int(new_o["step"]), "metrics": {k: float(v) for k, v in metrics.items()}}
    return Ref(cfg, rcfg, np_tree(params), batch, float(total), float(parts["nll"]),
               float(parts["aux"]), np_tree(grads), after)


@pytest.fixture(scope="module")
def refs():
    """Each architecture's reference results, computed once, on first use."""
    return functools.lru_cache(maxsize=None)(make_ref)


# ---------------------------------------------------------------------------
# loss_fn and its gradients, all ten reduced architectures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_loss_and_grads_match_reference(refs, aid, remat):
    """The total, nll and aux, and every gradient leaf.  ``remat`` on the
    MoE configs also shows that checkpointing recomputes the MoE combine's
    ``index_add_`` to the same gradients on the CPU (on the card its
    atomics may leave them a rounding step apart)."""
    ref = refs(aid)
    total, parts, grads = step.value_and_grad(ref.model(), ref.cfg, ref.tensors(),
                                              step.TrainConfig(remat=remat))
    np.testing.assert_allclose(float(total), ref.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["nll"]), ref.nll, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), ref.aux, rtol=LOSS_RTOL, atol=1e-6)
    errs = leaf_errors(ref.cfg, grads, ref.grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_train_step_matches_reference(refs, aid):
    """One whole ``train_step`` (``TrainConfig()``: remat on) against the
    reference's jitted ``make_train_step``: the metrics (the global norm to
    the gradients' tolerance), ``step``, ``m``
    (0.1 x the clipped gradient) and ``v`` leaf by leaf, and the
    parameters.  Adam's first step is a sign: mh / sqrt(vh) = g / |g| for
    every element, so where a gradient is at rounding level (the mLSTM's
    b_i) the two packages move a parameter by +lr or -lr.  The parameters
    are therefore held only within 2 lr_1 plus the float32 tolerance; the
    update itself is held to ulps on shared gradients below."""
    ref = refs(aid)
    model = ref.model()
    state = opt.init_opt_state(model, device="cpu")
    metrics = step.make_train_step(ref.cfg, step.TrainConfig())(model, state, ref.tensors())
    want = ref.after["metrics"]
    assert set(metrics) == set(want) == {"loss", "nll", "aux", "grad_norm", "lr"}
    for k in ("loss", "nll", "lr"):
        np.testing.assert_allclose(float(metrics[k]), want[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"], rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), want["aux"], rtol=LOSS_RTOL, atol=1e-6)
    assert int(state["step"]) == ref.after["step"] == 1
    assert state["step"].dtype == torch.int32
    for key, floor in (("m", GRAD_FLOOR), ("v", GRAD_FLOOR ** 2)):
        errs = leaf_errors(ref.cfg, state[key], ref.after[key], floor)
        worst = max(errs, key=errs.get)
        # v = 0.05 g^2: twice the gradient's relative error
        assert errs[worst] <= 2 * GRAD_RTOL, (key, worst, errs[worst])
    lr1 = want["lr"]
    got = {n: t2np(p) for n, p in model.named_parameters()}
    for name, w in cv.lm_named_from_tree(ref.cfg, ref.after["params"]).items():
        w = np32(w)
        bound = 2 * lr1 + 1e-6 * np.abs(w) + 1e-7
        assert (np.abs(got[name] - w) <= bound).all(), name


# ---------------------------------------------------------------------------
# The optimizer on shared gradients
# ---------------------------------------------------------------------------

def _ref_tree(aid: str, dtype: str):
    rcfg = dataclasses.replace(ref_configs.reduced(ref_configs.ARCHS[aid]),
                               param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[aid]),
                              param_dtype=dtype, compute_dtype=dtype)
    params = jax.jit(functools.partial(ref_tf.init_params, rcfg))(jax.random.PRNGKey(0))
    return rcfg, cfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_on_shared_grads(dtype):
    """Three updates of the same parameters from the same gradients in both
    packages (warmup 2 of 3 steps, so the schedule warms up and decays;
    the second step's norm is above ``grad_clip``, so it is clipped).  The
    update is elementwise, but XLA may contract or reorder it, and where
    b1 m and (1 - b1) g, or p and lr delta, nearly cancel, the result is
    far smaller than its operands: a float32 parameter agrees to a few
    ulps of the leaf's largest magnitude.  The global norm sums the leaves
    in another order (1e-5), and from the clipped step on, m and v carry
    its error through the clip scale (1e-5 of the leaf's largest
    magnitude) and the Adam direction carries it into the parameters
    (1e-5 of lr).  A bf16 parameter is rounded every step, so a one-ulp float32 difference
    at a rounding boundary moves it one bf16 ulp (2^-8 relative)."""
    rcfg, cfg, params = _ref_tree("xlstm_125m", dtype)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=3, grad_clip=1.0)
    rocfg = ref_opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=3, grad_clip=1.0)
    assert dataclasses.asdict(ocfg) == dataclasses.asdict(rocfg)
    ref_update = jax.jit(functools.partial(ref_opt.adamw_update, rocfg))
    model = cv.lm_params_from_tree(cfg, jax.tree.map(np.asarray, params), device="cpu")
    state = opt.init_opt_state(model, device="cpu")
    rstate = ref_opt.init_opt_state(params)
    rng = np.random.default_rng(7)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    for i, norm in enumerate((0.3, 40.0, 0.5)):
        g = [rng.normal(size=l.shape).astype(np.float32) for l in leaves]
        total = np.sqrt(sum(float((x * x).sum()) for x in g))
        g = [(x * (norm / total)).astype(l.dtype) for x, l in zip(g, leaves)]
        gtree = jax.tree_util.tree_unflatten(treedef, g)
        params, rstate, rmet = ref_update(params, jax.tree.map(jnp.asarray, gtree), rstate)
        named = {k: cv.tensor_from_numpy(v) for k, v in
                 cv.lm_named_from_tree(cfg, jax.tree.map(np.asarray, gtree)).items()}
        met = opt.adamw_update(ocfg, model, named, state)
        np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]), rtol=2 * 2.0 ** -23)
        assert int(state["step"]) == int(rstate["step"]) == i + 1
        for key, got in (("m", state["m"]), ("v", state["v"])):
            want = cv.lm_named_from_tree(cfg, jax.tree.map(np.asarray, rstate[key]))
            for name, w in want.items():
                w = np32(w)
                np.testing.assert_allclose(t2np(got[name]), w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max(),
                                           err_msg=f"step {i + 1} {key} {name}")
        want = cv.lm_named_from_tree(cfg, jax.tree.map(np.asarray, params))
        for name, p in model.named_parameters():
            assert cv.dtype_name(p.dtype) == str(want[name].dtype)
            ulp = 2.0 ** -8 if p.dtype == torch.bfloat16 else 2.0 ** -23
            w = np32(want[name])
            np.testing.assert_allclose(t2np(p), w, rtol=ulp,
                                       atol=4 * ulp * np.abs(w).max() + 1e-5 * float(rmet["lr"]),
                                       err_msg=f"step {i + 1} {name}")
    assert float(met["grad_norm"]) < ocfg.grad_clip < 40.0
    assert any(p.dtype == getattr(torch, dtype) for p in model.parameters())


@pytest.mark.parametrize("at", ["0", "1", "warmup", "mid", "total", "past"])
def test_schedule_matches_reference(at):
    cfg = opt.OptConfig(warmup_steps=100, total_steps=1000)
    rcfg = ref_opt.OptConfig(warmup_steps=100, total_steps=1000)
    s = {"0": 0, "1": 1, "warmup": 100, "mid": 550, "total": 1000, "past": 1500}[at]
    got = opt.schedule(cfg, torch.tensor(s, dtype=torch.int32))
    want = ref_opt.schedule(rcfg, jnp.int32(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=2 * 2.0 ** -23, atol=0)


def test_decay_mask_matches_reference_on_every_config():
    """Hazard: the decay mask is by leaf name.  For every published config
    the decayed and undecayed leaves are the reference's, and the norms,
    biases and gates come out undecayed."""
    undecayed = set()
    for aid in ALL_ARCHS:
        rcfg, cfg = ref_configs.ARCHS[aid], configs.ARCHS[aid]
        abstract = ref_tf.abstract_params(rcfg)
        # each leaf's flag broadcast to its shape (a view), so that the
        # body's stacked leaves split into layers
        flags = jax.tree_util.tree_map_with_path(
            lambda path, x: np.broadcast_to(ref_opt._decay_mask(str(path[-1].key)),
                                            x.shape), abstract)
        want = {n: bool(f.flat[0]) for n, f in cv.lm_named_from_tree(cfg, flags).items()}
        got = {n: opt.decays(n) for n, _ in tf.abstract_params(cfg).named_parameters()}
        assert got == want, aid
        undecayed |= {n.rsplit(".", 1)[-1] for n, d in got.items() if not d}
    for leaf in ("b", "lam", "b_i", "b_f", "ln1", "ln2", "final_norm", "norm",
                 "out_norm", "q_norm", "k_norm", "bq", "bk", "bv"):
        assert leaf in undecayed
        assert not opt.decays(f"layers.3.{leaf}")
    assert opt.decays("layers.3.ffn.w_gate") and opt.decays("embed")


@pytest.mark.parametrize("mask", ["none", "zeros", "all_zero"])
def test_cross_entropy_matches_reference(mask):
    """Values and the gradient wrt the logits, with no mask, a mask with
    zeros, and an all-zero mask (the denominator is clamped to 1)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 8, 16)).astype(np.float32) * 3
    labels = rng.integers(0, 16, size=(2, 8)).astype(np.int32)
    m = {"none": None, "zeros": (rng.random((2, 8)) < 0.6).astype(np.float32),
         "all_zero": np.zeros((2, 8), np.float32)}[mask]
    rm = None if m is None else jnp.asarray(m)
    (want, wnll), wgrad = jax.value_and_grad(
        lambda x: ref_step.cross_entropy(x, jnp.asarray(labels), rm, 1e-2),
        has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got, nll = step.cross_entropy(x, torch.from_numpy(labels),
                                  None if m is None else torch.from_numpy(m), 1e-2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(nll.item(), float(wnll), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t2np(x.grad), np.asarray(wgrad), rtol=1e-5, atol=1e-8)
    if mask == "all_zero":
        assert float(got) == 0.0 and float(x.grad.abs().max()) == 0.0


def test_configs_equal_reference_field_by_field():
    for ours, theirs in ((step.TrainConfig, ref_step.TrainConfig),
                         (opt.OptConfig, ref_opt.OptConfig)):
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(theirs)]
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_causal_skip_is_passed_as_given(refs):
    """Hazard: the reference cannot differentiate ``causal_skip`` (a dynamic
    ``fori_loop`` bound), so the trainer's default is off; the port's loss
    takes it as given, and skipping the masked chunks changes no value."""
    assert step.TrainConfig().causal_skip is False
    ref = refs("qwen2_1_5b")
    model, batch = ref.model(), ref.tensors()
    tc = step.TrainConfig(q_chunk=8, kv_chunk=8)
    with torch.no_grad():
        full, _ = step.loss_fn(model, ref.cfg, batch, tc)
        skip, _ = step.loss_fn(model, ref.cfg, batch, dataclasses.replace(tc, causal_skip=True))
    np.testing.assert_allclose(float(skip), float(full), rtol=1e-6)
    np.testing.assert_allclose(float(full), ref.loss, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# The optimizer state across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_opt_state_round_trip(aid):
    """``lm_tree_from_opt_state`` gives the reference's ``init_opt_state``
    layout (paths, shapes, dtypes), and ``lm_opt_state_from_tree`` carries
    it back to the same names, shapes, dtypes and values."""
    rcfg, cfg = ref_configs.reduced(ref_configs.ARCHS[aid]), configs.reduced(configs.ARCHS[aid])
    model = tf.init_params(cfg, 0, device="cpu")
    state = opt.init_opt_state(model, device="cpu")
    g = torch.Generator().manual_seed(1)
    for key in ("m", "v"):
        for t in state[key].values():
            t.copy_(torch.randn(t.shape, generator=g))
    state["step"] += 5
    tree = cv.lm_tree_from_opt_state(cfg, state)
    want = jax.eval_shape(ref_opt.init_opt_state, ref_tf.abstract_params(rcfg))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, t) in zip(flat_w, flat_g):
        assert tuple(t.shape) == w.shape and cv.dtype_name(t.dtype) == str(w.dtype), path
    back = cv.lm_opt_state_from_tree(cfg, tree, model, device="cpu")
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 5
    for key in ("m", "v"):
        assert list(back[key]) == list(state[key])
        for name, t in state[key].items():
            assert back[key][name].dtype == torch.float32
            assert torch.equal(back[key][name], t)
    abstract = opt.abstract_opt_state(tf.abstract_params(cfg))
    assert all(t.device.type == "meta" for t in abstract["m"].values())
    assert {n: t.shape for n, t in abstract["v"].items()} == \
        {n: t.shape for n, t in state["v"].items()}


def test_training_entry_points_need_a_card(monkeypatch, tmp_path):
    """Without a card, ``init_opt_state`` and the train CLI without
    ``--device`` raise; with ``device="cpu"`` they run."""
    from repro_torch.launch import train as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced(configs.ARCHS["qwen2_1_5b"])
    model = tf.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.init_opt_state(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--smoke", "--arch", "qwen2_1_5b", "--steps", "1", "--batch", "2",
                  "--seq", "16"])
    assert opt.init_opt_state(model, device="cpu")["step"].device.type == "cpu"
    with pytest.raises(ValueError, match="model is on"):
        opt.init_opt_state(tf.abstract_params(cfg), device="cpu")
