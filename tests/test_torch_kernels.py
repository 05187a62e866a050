"""The PyTorch port's kernels — the fused frontier step, the frontier
expansion match and the label histogram — against the JAX package's
oracles and its Pallas kernels (interpret mode), on the CPU; the
evaluator's append op against the inline appends' rules, applied one
candidate at a time.

Inputs are made with numpy from fixed seeds and handed to both packages.
Every output is an integer or a mask, so every comparison is exact.  The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import dataclasses
import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core.plan import PlanArrays as RefPlanArrays
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core.engine import plan_to_device
from repro_torch.convert import plan_arrays_from_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import frontier_append as fa
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import fused_frontier as ff
from repro_torch.kernels import label_histogram as lh

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the append cases the card test shares)

_V = 1000   # global-id space of the random dgid column
SWEEP = [
    (4, 4, 4, 8),
    (16, 7, 6, 32),
    (32, 128, 8, 64),
    (8, 130, 5, 16),
    (1, 1, 1, 1),
]


def _random_plan(rng, S, Q):
    return RefPlanArrays(
        n_slots=Q, n_steps=S,
        start_slot=np.int32(0), start_label=np.int32(0),
        start_value_op=np.int32(0), start_value=np.float32(0),
        src_slot=rng.integers(0, Q, S).astype(np.int32),
        dst_slot=rng.integers(0, Q, S).astype(np.int32),
        edge_label=rng.integers(-1, 3, S).astype(np.int32),
        direction=rng.integers(0, 3, S).astype(np.int32),
        dst_label=rng.integers(-1, 3, S).astype(np.int32),
        dst_value_op=rng.integers(0, 7, S).astype(np.int32),
        dst_value=rng.normal(size=S).astype(np.float32),
        closes_cycle=rng.integers(0, 2, S).astype(np.int32),
    )


def _random_ell(rng, Np, W, n_labels=3):
    dst = rng.integers(-1, Np, size=(Np, W)).astype(np.int32)
    lab = rng.integers(-2, n_labels, size=(Np, W)).astype(np.int32)
    dire = rng.integers(0, 3, size=(Np, W)).astype(np.int32)
    dlab = rng.integers(-2, n_labels, size=(Np, W)).astype(np.int32)
    dval = rng.normal(size=(Np, W)).astype(np.float32)
    dval[rng.random((Np, W)) < 0.2] = np.nan
    dgid = np.where(dst >= 0, rng.integers(0, _V, size=(Np, W)), -1).astype(np.int32)
    return dst, lab, dire, dlab, dval, dgid


def _random_locality(rng, Np):
    g2l_row = np.full(_V, -1, np.int32)
    present = rng.choice(_V, size=min(Np, _V), replace=False)
    g2l_row[present] = rng.permutation(len(present)).astype(np.int32)
    owner = rng.integers(0, 4, _V).astype(np.int32)
    n_core = int(rng.integers(1, Np + 1))
    return g2l_row, owner, n_core


def _torch_plan(plan):
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    return plan_to_device(plan_arrays_from_numpy(**fields), "cpu")


def _case(seed, EB, W, Q, Np, m=None, plan_fn=None):
    """One random fused-frontier input set, as numpy arrays."""
    rng = np.random.default_rng(seed)
    plan = _random_plan(rng, 6, Q)
    if plan_fn is not None:
        plan = plan_fn(plan)
    tables = _random_ell(rng, Np, W)
    g2l_row, owner, n_core = _random_locality(rng, Np)
    rows = rng.integers(-1, _V, size=(EB, Q)).astype(np.int32)
    step = rng.integers(0, plan.n_steps + 2, size=EB).astype(np.int32)
    lidx = rng.integers(0, Np, size=EB).astype(np.int32)
    if m is None:
        m = rng.random(EB) < 0.8
    return dict(plan=plan, tables=tables, g2l_row=g2l_row, owner=owner,
                n_core=n_core, rows=rows, step=step, lidx=lidx, m=m,
                n_steps=5)


def _port_fused(c):
    t = torch.from_numpy
    return ops.fused_frontier(t(c["rows"]), t(c["step"]), t(c["lidx"]),
                              t(c["m"]), *[t(a) for a in c["tables"]],
                              t(c["g2l_row"]), t(c["owner"]), c["n_core"],
                              _torch_plan(c["plan"]), c["n_steps"])


def _port_oracle(c):
    t = torch.from_numpy
    return ops.fused_frontier_ref(t(c["rows"]), t(c["step"]), t(c["lidx"]),
                                  t(c["m"]), *[t(a) for a in c["tables"]],
                                  t(c["g2l_row"]), t(c["owner"]), c["n_core"],
                                  _torch_plan(c["plan"]), c["n_steps"])


def _jax_oracle(c):
    return ref_ops.fused_frontier_ref(
        c["rows"], c["step"], c["lidx"], c["m"], *c["tables"], c["g2l_row"],
        c["owner"], c["n_core"], c["plan"], np.int32(c["n_steps"]))


def _assert_fused_equal(got, want, c):
    """Masks bit-equal; dg where an edge exists; dest where routed out;
    done/keep/out disjoint and covering ok."""
    names = ("ok", "dg", "done", "keep", "out", "dest")
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    for i in (0, 2, 3, 4):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])
        assert got[i].dtype == np.bool_, names[i]
    edge = c["tables"][0][c["lidx"]] >= 0
    np.testing.assert_array_equal(got[1][edge], want[1][edge], err_msg="dg")
    out = want[4]
    np.testing.assert_array_equal(got[5][out], want[5][out], err_msg="dest")
    ok, done, keep, outm = got[0], got[2], got[3], got[4]
    assert not (done & keep).any() and not (done & outm).any() \
        and not (keep & outm).any()
    np.testing.assert_array_equal(done | keep | outm, ok)


@pytest.mark.parametrize("EB,W,Q,Np", SWEEP)
def test_fused_frontier_matches_jax_oracle(EB, W, Q, Np):
    c = _case(EB * 1000 + W + 7, EB, W, Q, Np)
    _assert_fused_equal(_port_fused(c), _jax_oracle(c), c)


@pytest.mark.parametrize("EB,W,Q,Np", SWEEP)
def test_torch_oracle_matches_jax_oracle(EB, W, Q, Np):
    c = _case(EB * 1000 + W + 11, EB, W, Q, Np)
    _assert_fused_equal(_port_oracle(c), _jax_oracle(c), c)


def test_fused_frontier_nan_and_finished_steps():
    """NaN destination values fail every op (OP_NE included), and rows at
    or past n_steps match nothing."""
    def ne_plan(plan):
        return dataclasses.replace(plan, dst_value_op=np.full(6, 2, np.int32),
                                   closes_cycle=np.zeros(6, np.int32),
                                   edge_label=np.full(6, -1, np.int32),
                                   dst_label=np.full(6, -1, np.int32),
                                   direction=np.zeros(6, np.int32))
    c = _case(21, 16, 9, 4, 12, m=np.ones(16, bool), plan_fn=ne_plan)
    c["tables"][4][:, ::2] = np.nan
    c["step"][:4] = [5, 6, 7, 5]
    got = _port_fused(c)
    _assert_fused_equal(got, _jax_oracle(c), c)
    ok = np.asarray(got[0])
    assert not ok[:, ::2].any()
    assert not ok[:4].any()
    assert ok.any()


def test_fused_frontier_empty_frontier():
    c = _case(11, 8, 16, 4, 8, m=np.zeros(8, bool))
    got = _port_fused(c)
    _assert_fused_equal(got, _jax_oracle(c), c)
    assert not any(np.asarray(got[i]).any() for i in (0, 2, 3, 4))


def test_fused_frontier_all_filtered_labels():
    c = _case(13, 8, 16, 4, 8, plan_fn=lambda p: dataclasses.replace(
        p, edge_label=np.full(6, 7, np.int32)))
    got = _port_fused(c)
    _assert_fused_equal(got, _jax_oracle(c), c)
    assert not np.asarray(got[0]).any()


def test_fused_frontier_matches_pallas_interpret():
    """The port against the Pallas kernel itself (interpret mode)."""
    c = _case(17, 16, 7, 6, 32)
    dlidx, downer = ref_ops.denorm_locality(jnp.asarray(c["tables"][5]),
                                            jnp.asarray(c["g2l_row"]),
                                            jnp.asarray(c["owner"]))
    want = ref_ops.fused_frontier(
        c["rows"], c["step"], c["lidx"], c["m"], *c["tables"], dlidx, downer,
        c["g2l_row"], c["owner"], c["n_core"], c["plan"],
        np.int32(c["n_steps"]), interpret=True)
    _assert_fused_equal(_port_fused(c), want, c)


# ---------------------------------------------------------------------------
# the step (one launch per evaluator loop) against the JAX engine's
# _expand_classify, lane by lane
# ---------------------------------------------------------------------------

def _step_case(seed, L, EB, W, Q, Np, P=2, empty_lane=None):
    """Random loop state for the step, as numpy arrays: P partitions whose
    ELL destination attributes are their nodes' (so the JAX engine's jnp
    path, which reads the node arrays, sees the same graph), a g2l row per
    partition (most work-row ids absent from it), one random plan per lane
    (cycle-closing steps included), work rows with steps past n_steps,
    unclipped lidx, a selection of EB work rows per lane and ``m``
    (all False on ``empty_lane``).  Destination values are 20% NaN."""
    rng = np.random.default_rng(seed)
    V = 4 * Np + 50
    parts, g2l = [], np.full((P, V), -1, np.int32)
    for p in range(P):
        gid = rng.choice(V, Np, replace=False).astype(np.int32)
        g2l[p, gid] = np.arange(Np, dtype=np.int32)
        label = rng.integers(0, 3, Np).astype(np.int32)
        value = rng.normal(size=Np).astype(np.float32)
        value[rng.random(Np) < 0.2] = np.nan
        ed = rng.integers(-1, Np, size=(Np, W)).astype(np.int32)
        d = np.clip(ed, 0, Np - 1)
        parts.append(dict(
            n_core=np.int32(rng.integers(1, Np + 1)), node_label=label,
            node_value=value, node_gid=gid, ell_dst=ed,
            ell_label=rng.integers(-2, 3, size=(Np, W)).astype(np.int32),
            ell_dir=rng.integers(0, 3, size=(Np, W)).astype(np.int32),
            ell_dlab=np.where(ed >= 0, label[d], -2).astype(np.int32),
            ell_dval=np.where(ed >= 0, value[d], np.nan).astype(np.float32),
            ell_dgid=np.where(ed >= 0, gid[d], -1).astype(np.int32)))
    N = EB + 7
    m = rng.random((L, EB)) < 0.8
    if empty_lane is not None:
        m[empty_lane] = False
    return dict(
        parts=parts, g2l=g2l, owner=rng.integers(0, 4, V).astype(np.int32),
        plans=[_random_plan(rng, 6, Q) for _ in range(L)],
        n_steps=rng.integers(3, 7, L).astype(np.int32),
        lane_part=rng.integers(0, P, L),
        wr=rng.integers(-1, V, size=(L, N + 1, Q)).astype(np.int32),
        ws=rng.integers(0, 8, size=(L, N + 1)).astype(np.int32),
        lidx=rng.integers(-2, Np + 2, size=(L, N)).astype(np.int32),
        sel=np.stack([rng.permutation(N)[:EB] for _ in range(L)]),
        m=m)


def _port_step_inputs(c):
    """(invariants, per-launch args, output buffers) of the port's step."""
    t = torch.from_numpy
    part = lambda k: t(np.stack([p[k] for p in c["parts"]]))  # noqa: E731
    plan = types.SimpleNamespace(**{
        f: t(np.stack([getattr(p, f) for p in c["plans"]]))
        for f in (*ff.PLAN_INT_FIELDS, "dst_value")})
    lane_part = t(c["lane_part"])
    inv = ops.step_invariants(
        [part(k) for k in ("ell_dst", "ell_label", "ell_dir", "ell_dlab",
                           "ell_dval", "ell_dgid")],
        t(c["g2l"]), t(c["owner"]), plan, lane_part,
        part("n_core")[lane_part], t(c["n_steps"]))
    L, EB = c["sel"].shape
    W, Q = c["parts"][0]["ell_dst"].shape[1], c["wr"].shape[2]
    args = (t(c["wr"]), t(c["ws"]), t(c["lidx"]), t(c["sel"]), t(c["m"]))
    return inv, args, ops.step_outputs(L, EB, W, Q, "cpu")


_jax_expand_classify = jax.jit(ref_engine._expand_classify,
                               static_argnames=("use_pallas",))

_STEP_CASES = [dict(seed=56, L=1, EB=16, W=7, Q=8, Np=32),
               dict(seed=43, L=3, EB=8, W=130, Q=5, Np=16, empty_lane=1),
               dict(seed=47, L=3, EB=12, W=9, Q=1, Np=24)]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", _STEP_CASES, ids=lambda k: f"L{k['L']}Q{k['Q']}W{k['W']}")
def test_frontier_step_matches_jax_expand_classify(case, use_pallas):
    """Lane by lane, the step's plain version equals the JAX engine's
    ``_expand_classify`` on that lane's selected rows, on its jnp path and
    through the Pallas kernel (interpret mode): masks and ns bit-equal; nr
    and dg where an edge exists (everywhere on the Pallas path, whose dg
    is ell_dgid like the port's); dest where routed out."""
    c = _step_case(**case)
    inv, args, out = _port_step_inputs(c)
    got = [x.numpy() for x in ff.frontier_step(inv, *args, out)]
    L, EB = c["sel"].shape
    W = c["parts"][0]["ell_dst"].shape[1]
    n_ok = 0
    for lane in range(L):
        part = c["parts"][c["lane_part"][lane]]
        g2l_row = c["g2l"][c["lane_part"][lane]]
        s = c["sel"][lane]
        aux = (ref_ops.denorm_locality(part["ell_dgid"], g2l_row, c["owner"])
               if use_pallas else None)
        want = _jax_expand_classify(
            c["wr"][lane][s], c["ws"][lane][s], c["lidx"][lane][s],
            c["m"][lane], part, g2l_row, c["owner"], aux, c["plans"][lane],
            c["n_steps"][lane], use_pallas=use_pallas)
        ok, dg, ns, nr, done, keep, outm, dest = (np.asarray(x) for x in want)
        g = [x[lane].reshape((EB, W) + x.shape[2:]) for x in got]
        for name, a, b in (("ok", g[0], ok), ("done", g[2], done),
                           ("keep", g[3], keep), ("outm", g[4], outm),
                           ("ns", g[7], ns)):
            np.testing.assert_array_equal(a, b, err_msg=f"lane {lane} {name}")
        edge = part["ell_dst"][np.clip(c["lidx"][lane][s], 0, part["ell_dst"].shape[0] - 1)] >= 0
        if use_pallas:
            edge = np.ones_like(edge)
        np.testing.assert_array_equal(g[1][edge], dg[edge], err_msg=f"lane {lane} dg")
        np.testing.assert_array_equal(g[6][edge], nr[edge], err_msg=f"lane {lane} nr")
        np.testing.assert_array_equal(g[5][outm], dest[outm], err_msg=f"lane {lane} dest")
        if not c["m"][lane].any():
            assert not g[0].any()
        n_ok += int(ok.sum())
    assert n_ok > 0


@pytest.mark.parametrize("EB,W,Q,Np", SWEEP[:3])
def test_denorm_locality_and_params_match_jax(EB, W, Q, Np):
    c = _case(EB + W + 3, EB, W, Q, Np)
    t = torch.from_numpy
    dl, do = ops.denorm_locality(t(c["tables"][5]), t(c["g2l_row"]), t(c["owner"]))
    rdl, rdo = ref_ops.denorm_locality(jnp.asarray(c["tables"][5]),
                                       jnp.asarray(c["g2l_row"]),
                                       jnp.asarray(c["owner"]))
    np.testing.assert_array_equal(dl.numpy(), np.asarray(rdl))
    np.testing.assert_array_equal(do.numpy(), np.asarray(rdo))
    pint, pflt, nsrc = ops._fused_params(
        t(c["rows"]), t(c["step"]), t(c["m"]), t(c["g2l_row"]), t(c["owner"]),
        c["n_core"], _torch_plan(c["plan"]), c["n_steps"])
    rpint, rpflt, rnsrc = ref_ops._fused_params(
        c["rows"], c["step"], c["m"], c["g2l_row"], c["owner"], c["n_core"],
        c["plan"], np.int32(c["n_steps"]))
    np.testing.assert_array_equal(pint.numpy(), np.asarray(rpint))
    np.testing.assert_array_equal(pflt.numpy(), np.asarray(rpflt))
    np.testing.assert_array_equal(nsrc.numpy(), np.asarray(rnsrc))
    assert pint.dtype == torch.int32 and pflt.dtype == torch.float32


@pytest.mark.parametrize("op", range(7))
def test_value_pred_matches_jax(op):
    vals = np.array([1.0, np.nan, 3.0, -2.0, 1.0], np.float32)
    got = ref.value_pred(torch.tensor(op), torch.from_numpy(vals), torch.tensor(1.0))
    want = ref_ref.value_pred(jnp.int32(op), jnp.asarray(vals), jnp.float32(1.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if op:
        assert not got[1]   # NaN fails every comparison


def test_frontier_expand_ref_matches_jax():
    c = _case(5, 16, 7, 6, 32)
    p = c["plan"]
    s = np.clip(c["step"], 0, 5)
    per_row = [a[s] for a in (p.edge_label, p.direction, p.dst_label,
                              p.dst_value_op, p.dst_value, p.dst_slot,
                              p.closes_cycle)]
    args = [c["rows"], c["step"], c["lidx"], c["m"], *c["tables"], *per_row]
    ok, dg = ref.frontier_expand_ref(*[torch.from_numpy(np.asarray(a)) for a in args], 5)
    rok, rdg = ref_ref.frontier_expand_ref(*args, np.int32(5))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    edge = c["tables"][0][c["lidx"]] >= 0
    np.testing.assert_array_equal(dg.numpy()[edge], np.asarray(rdg)[edge])


def test_wrapper_rejects_bad_inputs():
    c = _step_case(3, 2, 8, 5, 4, 8)
    inv, args, out = _port_step_inputs(c)
    with pytest.raises(ValueError):             # neither cpu nor cuda
        ff.frontier_step(inv, *[a.to("meta") for a in args],
                         [o.to("meta") for o in out])
    tables = list(inv.tables)
    pieces = (tables, inv.g2l, inv.owner, inv.plan_int, inv.plan_val, inv.lane,
              inv.node_pad)
    for i, bad in ((0, tables[:4] + [tables[4].int(), tables[5]]),  # dval f32
                   (3, inv.plan_int[:, :, :7].contiguous()),       # 8 columns
                   (5, inv.lane + torch.tensor([2, 0, 0], dtype=torch.int32)),
                   (6, 7)):                                        # Np | rows
        broken = list(pieces)
        broken[i] = bad
        with pytest.raises(ValueError):
            ff.make_step_invariants(*broken)
    for i, bad in ((0, args[0].transpose(1, 2)),      # wr rows not contiguous
                   (2, args[2].long()),                 # lidx must be int32
                   (3, args[3].int()),                  # sel must be int64
                   (4, args[4].int())):                 # m must be bool
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            ff.frontier_step(inv, *broken, out)
    with pytest.raises(ValueError):
        ff.frontier_step(inv, *args, tuple(out))        # not from step_outputs
    with pytest.raises(ValueError):                     # sized for EB = 4
        ff.frontier_step(inv, *args, ff.step_outputs(2, 4, 5, 4, "cpu"))


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    build.LAUNCHES.clear()
    inv, args, out = _port_step_inputs(_step_case(9, 2, 8, 5, 4, 8))
    got = ff.frontier_step(inv, *args, out)
    assert got is out
    for a, b in zip(got, ff.frontier_step_plain(inv, *args)):
        assert torch.equal(a, b)
    assert build.LAUNCHES[ff.NAME] == 0


def test_build_targets_hopper():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert ff.NAME in build.kernel_names()
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
    src = (build.CSRC / f"{ff.NAME}.cu").read_text()
    assert 'extern "C" int fused_frontier_launch' in src
    assert "torch/extension.h" not in src


# ---------------------------------------------------------------------------
# frontier_expand: the match alone
# ---------------------------------------------------------------------------

# the JAX adapter under jit, so interpret mode traces once per shape
_jax_frontier_expand = jax.jit(functools.partial(ref_ops.frontier_expand,
                                                 interpret=True))


def _port_expand(c):
    t = torch.from_numpy
    return ops.frontier_expand(t(c["rows"]), t(c["step"]), t(c["lidx"]),
                               t(c["m"]), *[t(a) for a in c["tables"]],
                               _torch_plan(c["plan"]), c["n_steps"])


def _assert_expand_equal(got, want, c):
    """ok bit-equal; dg where an edge exists (the Pallas kernel pads W to
    128 lanes, the port does not)."""
    ok, dg = (np.asarray(x) for x in got)
    wok, wdg = (np.asarray(x) for x in want)
    assert ok.dtype == np.bool_ and dg.dtype == np.int32
    np.testing.assert_array_equal(ok, wok, err_msg="ok")
    edge = c["tables"][0][c["lidx"]] >= 0
    np.testing.assert_array_equal(dg[edge], wdg[edge], err_msg="dg")


def _jax_expand(c):
    return _jax_frontier_expand(c["rows"], c["step"], c["lidx"], c["m"],
                                *c["tables"], c["plan"], np.int32(c["n_steps"]))


@pytest.mark.parametrize("EB,W,Q,Np", SWEEP)
def test_frontier_expand_matches_pallas_interpret(EB, W, Q, Np):
    c = _case(EB * 1000 + W + 13, EB, W, Q, Np)
    got = _port_expand(c)
    _assert_expand_equal(got, _jax_expand(c), c)
    # the adapter's oracle and the fused step's match agree with it too
    t = torch.from_numpy
    want = ops.frontier_expand_ref(t(c["rows"]), t(c["step"]), t(c["lidx"]),
                                   t(c["m"]), *[t(a) for a in c["tables"]],
                                   _torch_plan(c["plan"]), c["n_steps"])
    _assert_expand_equal(got, want, c)
    _assert_expand_equal(got, _port_fused(c)[:2], c)


def test_frontier_expand_empty_frontier_and_nan_values():
    c = _case(23, 8, 16, 4, 8, m=np.zeros(8, bool))
    got = _port_expand(c)
    _assert_expand_equal(got, _jax_expand(c), c)
    assert not got[0].any()

    def ne_plan(plan):
        return dataclasses.replace(plan, dst_value_op=np.full(6, 2, np.int32),
                                   closes_cycle=np.zeros(6, np.int32),
                                   edge_label=np.full(6, -1, np.int32),
                                   dst_label=np.full(6, -1, np.int32),
                                   direction=np.zeros(6, np.int32))
    c = _case(29, 16, 9, 4, 12, m=np.ones(16, bool), plan_fn=ne_plan)
    c["tables"][4][:, ::2] = np.nan
    got = _port_expand(c)
    _assert_expand_equal(got, _jax_expand(c), c)
    ok = got[0].numpy()
    assert not ok[:, ::2].any() and ok.any()   # NaN fails OP_NE


def _packed_expand(c):
    """The frontier_expand kernel-level inputs (lidx, pint, pflt, rows,
    six tables), packed as ops.frontier_expand packs them."""
    t = torch.from_numpy
    pint, pflt = ops._expand_params(t(c["step"]), t(c["m"]),
                                    _torch_plan(c["plan"]), c["n_steps"])
    Np = c["tables"][0].shape[0]
    return (t(c["lidx"]).clamp(0, Np - 1), pint, pflt, t(c["rows"]),
            *[t(a) for a in c["tables"]])


def test_frontier_expand_packing_matches_jax():
    """pint/pflt as the JAX adapter packs them (its _P_* columns)."""
    c = _case(31, 16, 7, 6, 32)
    lidx, pint, pflt = _packed_expand(c)[:3]
    assert pint.shape == (16, fe.N_PINT) and pint.dtype == torch.int32
    S = c["plan"].src_slot.shape[0]
    s = np.clip(c["step"], 0, S - 1)
    p = c["plan"]
    want = np.stack([p.edge_label[s], p.direction[s], p.dst_label[s],
                     p.dst_value_op[s], p.dst_slot[s], p.closes_cycle[s],
                     c["step"], (c["m"] & (c["step"] < c["n_steps"]))], 1)
    np.testing.assert_array_equal(pint.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(pflt.numpy(), p.dst_value[s])
    np.testing.assert_array_equal(lidx.numpy(), np.clip(c["lidx"], 0, 31))


def test_frontier_expand_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    args = list(_packed_expand(_case(37, 8, 5, 4, 8)))
    with pytest.raises(ValueError):
        fe.frontier_expand_kernel(*[a.to("meta") for a in args])
    for i, bad in ((8, args[8].int()),                     # ell_dval must be f32
                   (1, args[1][:, :7].contiguous()),       # pint has 8 columns
                   (3, args[3].t()),                       # rows: shape/layout
                   (0, args[0].long())):                   # lidx must be int32
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            fe.frontier_expand_kernel(*broken)
    with pytest.raises(ValueError):
        fe.frontier_expand_kernel(*args[:-1])              # a table missing
    build.LAUNCHES.clear()
    got = fe.frontier_expand_kernel(*args)
    for a, b in zip(got, fe.frontier_expand_plain(*args)):
        assert torch.equal(a, b)
    assert build.LAUNCHES[fe.NAME] == 0


# ---------------------------------------------------------------------------
# label_histogram
# ---------------------------------------------------------------------------

_jax_label_histogram = jax.jit(functools.partial(ref_ops.label_histogram,
                                                 interpret=True))
_LABELS = (-1, 2, 9)       # WILDCARD, a present label, an absent label


def _histogram_case(Np, seed):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 4, Np).astype(np.int32)
    val = rng.normal(size=Np).astype(np.float32)
    val[rng.random(Np) < 0.2] = np.nan
    core = (rng.random(Np) < 0.7).astype(np.int32)
    return lab, val, core


@pytest.mark.parametrize("Np", [1, 1023, 1024, 1025, 3000])
def test_label_histogram_matches_pallas_interpret(Np):
    """Every label kind x all seven value ops, with NaN values, across
    the 1024-node block edge."""
    lab, val, core = _histogram_case(Np, Np)
    t = torch.from_numpy
    value = float(np.nanmedian(val)) if Np > 1 else 0.1
    for label in _LABELS:
        for op in range(7):
            got = ops.label_histogram(t(lab), t(val), t(core), label, op, value)
            want = _jax_label_histogram(lab, val, core, np.int32(label),
                                        np.int32(op), np.float32(value))
            oracle = ref.label_histogram_ref(t(lab), t(val), t(core) == 1,
                                             label, op, value)
            assert got.dtype == torch.int32 and got.dim() == 0
            assert int(got) == int(want) == int(oracle), (Np, label, op)


def test_label_histogram_nan_fails_every_op_but_none():
    lab = np.zeros(4, np.int32)
    val = np.full(4, np.nan, np.float32)
    core = np.ones(4, np.int32)
    t = torch.from_numpy
    for op in range(7):
        got = int(ops.label_histogram(t(lab), t(val), t(core), -1, op, 0.0))
        assert got == (4 if op == 0 else 0), op


def test_label_histogram_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    lab, val, core = (torch.from_numpy(a) for a in _histogram_case(50, 3))
    with pytest.raises(ValueError):
        ops.label_histogram(lab, val, core.bool(), -1, 0, 0.0)   # mask dtype
    with pytest.raises(ValueError):
        lh.label_histogram_kernel(lab, val.double(), core, -1, 0, 0.0)
    with pytest.raises(ValueError):
        lh.label_histogram_kernel(lab, val[:-1], core, -1, 0, 0.0)
    with pytest.raises(ValueError):
        lh.label_histogram_kernel(lab[None], val, core, -1, 0, 0.0)
    with pytest.raises(ValueError):
        lh.label_histogram_kernel(lab.to("meta"), val.to("meta"),
                                  core.to("meta"), -1, 0, 0.0)
    build.LAUNCHES.clear()
    got = lh.label_histogram_kernel(lab, val, core, 2, 5, 0.0)
    assert torch.equal(got, lh.label_histogram_plain(lab, val, core, 2, 5, 0.0))
    assert build.LAUNCHES[lh.NAME] == 0


def test_every_kernel_targets_hopper_with_a_c_launcher():
    assert build.kernel_names() == sorted([ff.NAME, fe.NAME, lh.NAME, fa.NAME])
    for name in build.kernel_names():
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch' in src
        assert "torch/extension.h" not in src


def test_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared csrc/*.cuh header renames every library, so no
    stale build is reused."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._lib_path(n) for n in build.kernel_names()}
    header = tmp_path / "frontier_match.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._lib_path(n) for n in build.kernel_names()}
    assert all(before[n] != after[n] for n in before)


def _offset_histogram(offset, tail, seed):
    """Views at ``offset`` into longer arrays, of 2048 + ``tail`` nodes:
    misaligned for the 16-byte loads unless offset % 4 == 0, with an
    n % 4 tail."""
    n = 2048 + tail
    lab, val, core = _histogram_case(n + 4, seed)
    return tuple(a[offset:offset + n] for a in (lab, val, core))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("tail", [1, 2, 3])
def test_label_histogram_offset_views_and_tails(offset, tail):
    """Offset views ([1:], [2:], [3:]) and n % 4 tails against the Pallas
    kernel in interpret mode and the gather-based oracle."""
    lab, val, core = _offset_histogram(offset, tail, 10 * offset + tail)
    t = torch.from_numpy
    lab_t, val_t, core_t = (t(np.ascontiguousarray(a)) for a in (lab, val, core))
    # a torch view at the same offset is the kernel's real input
    full = [t(np.concatenate([np.zeros(offset, a.dtype), a])) for a in (lab, val, core)]
    views = [f[offset:] for f in full]
    assert all(v.is_contiguous() for v in views)
    value = float(np.nanmedian(val))
    for label, op in ((-1, 0), (1, 3), (2, 6), (9, 1), (0, 2)):
        got = ops.label_histogram(*views, label, op, value)
        want = _jax_label_histogram(lab, val, core, np.int32(label),
                                    np.int32(op), np.float32(value))
        oracle = ref.label_histogram_ref(lab_t, val_t, core_t == 1, label, op,
                                         value)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == int(want) == int(oracle), (offset, tail, label, op)
    assert not lh._SCRATCH          # CPU tensors make no kernel scratch


def test_use_vector_loads_needs_every_pointer_aligned():
    base = [torch.zeros(64, dtype=dt) for dt in (torch.int32, torch.float32,
                                                 torch.int32)]
    assert all(b.data_ptr() % lh.VECTOR_BYTES == 0 for b in base)
    assert lh.use_vector_loads(*base)
    for k in (1, 2, 3):
        assert not lh.use_vector_loads(*[b[k:] for b in base])
        mixed = list(base)
        mixed[k - 1] = base[k - 1][k:]
        assert not lh.use_vector_loads(*mixed), k
    assert lh.use_vector_loads(*[b[4:] for b in base])   # 16 bytes in
    assert lh.use_vector_loads(*[b[8:12] for b in base])


@pytest.mark.parametrize("W", [31, 32, 33])
@pytest.mark.parametrize("Q", [1, 8])
def test_frontier_expand_across_the_warp_width(W, Q):
    """W on each side of one warp (the kernel's lane-per-slot loop) and Q
    from one slot to the main path's 8, against the JAX adapter in
    interpret mode."""
    def open_steps(plan):        # every other step binds a fresh slot
        return dataclasses.replace(plan, closes_cycle=np.arange(6, dtype=np.int32) % 2)
    c = _case(100 * W + Q, 32, W, Q, 16, m=np.ones(32, bool), plan_fn=open_steps)
    got = _port_expand(c)
    _assert_expand_equal(got, _jax_expand(c), c)
    assert got[0].any()


# ---------------------------------------------------------------------------
# frontier_append: the evaluator's appends
# ---------------------------------------------------------------------------

def _looped_appends(st, rows, step, dest, done, outm, keep, work, free):
    """The inline appends' rules, candidate by candidate in candidate order
    and lane by lane, with no cumsum, scatter or trash row: a done row to
    the completed buffer and an outm row (with its step and destination)
    to the outgoing one while under cap, the r-th keep row to free slot
    ``free[r]`` while r < kfree; counts clamped at cap, overflow when a
    total passes cap or the keep rows outnumber the free work slots, and
    each lane's written rows added to ``landed``.  In place."""
    L, N = done.shape
    cap = st.comp_rows.shape[1] - 1
    for lane in range(L):
        wrote = 0
        ns = {"comp": int(st.comp_n[lane]), "out": int(st.out_n[lane])}
        for t in range(N):
            if done[lane, t]:
                if ns["comp"] < cap:
                    st.comp_rows[lane, ns["comp"]] = rows[lane, t]
                    wrote += 1
                ns["comp"] += 1
            if outm[lane, t]:
                if ns["out"] < cap:
                    st.out_rows[lane, ns["out"]] = rows[lane, t]
                    st.out_step[lane, ns["out"]] = step[lane, t]
                    st.out_dest[lane, ns["out"]] = dest[lane, t]
                    wrote += 1
                ns["out"] += 1
        over = ns["comp"] > cap or ns["out"] > cap
        if keep is not None:
            wr, ws, wv = work
            n_free = int((~wv[lane, :-1]).sum())
            r = 0
            for t in range(N):
                if keep[lane, t]:
                    if r < free.shape[1]:
                        slot = int(free[lane, r])
                        wr[lane, slot], ws[lane, slot] = rows[lane, t], step[lane, t]
                        wv[lane, slot] = True
                        wrote += 1
                    r += 1
            over = over or r > n_free
        st.comp_n[lane] = min(ns["comp"], cap)
        st.out_n[lane] = min(ns["out"], cap)
        st.overflow[lane] |= over
        st.landed[lane] += wrote


@pytest.mark.parametrize("keep", [True, False])
def test_frontier_append_plain_equals_the_inline_appends(keep):
    """The op on CPU tensors (its plain version, the cumsum + scatter form)
    against the inline appends' rules applied one candidate at a time
    (``_looped_appends``), over six lanes: sparse, empty, full (past cap
    and past the free slots) and half flags, counts just under cap, a
    nearly full work buffer; and the pre-classify's form (no keep, rows
    through a strided view).  Every output but the trash rows is equal:
    rows, steps, destinations, the work buffers, counts, overflow and the
    rows landed."""
    build.LAUNCHES.clear()
    st, args = chip_smoke.append_case(5, 6, 16, 5, 4, cap=24, WT=37,
                                      density=0.1, keep=keep, dev="cpu")
    want = chip_smoke.clone_append(st, args)
    _looped_appends(want[0], *want[1])
    landed0 = st.landed.clone()
    ops.frontier_append(st, *args)
    assert build.LAUNCHES[fa.NAME] == 0
    rec = chip_smoke.compare_append((st, args), want)
    assert rec["mismatches"] == 0, rec
    # every edge case occurred: overflow on some lanes only, rows landed
    # on some lanes, none on the frozen lane 1
    landed = st.landed - landed0
    assert 0 < rec["overflow_lanes"] < 6, rec
    assert int(landed.sum()) > 0 and int(landed[1]) == 0


def test_frontier_append_wrapper_rejects_bad_inputs():
    st, args = chip_smoke.append_case(6, 2, 4, 3, 4, cap=8, WT=9, dev="cpu")
    rows, step, dest, done, outm, keep, work, free = args
    with pytest.raises(ValueError):                      # neither cpu nor cuda
        meta = [a.to("meta") for a in args[:6]]
        fa.frontier_append(fa.AppendState(*(t.to("meta") for t in st)), *meta,
                           tuple(t.to("meta") for t in work), free.to("meta"))
    bad = {0: rows.long(), 1: step.to("meta"), 2: dest.long(), 3: done.int(),
           4: outm.to("meta"), 5: keep.to(torch.uint8), 7: free.int()}
    for i, b in bad.items():                             # dtypes, mixed devices
        broken = list(args)
        broken[i] = b
        with pytest.raises(ValueError):
            fa.frontier_append(st, *broken)
    with pytest.raises(ValueError):                      # wv on another device
        fa.frontier_append(st, *args[:6], (*work[:2], work[2].to("meta")), free)
    with pytest.raises(ValueError):                      # keep without work
        fa.frontier_append(st, *args[:6])
    with pytest.raises(ValueError):                      # free list too short
        fa.frontier_append(st, *args[:7], free[:, :-1])
    with pytest.raises(ValueError):                      # not from append_state
        fa.frontier_append(tuple(st), *args)
    with pytest.raises(ValueError):                      # sized for fewer candidates
        fa.frontier_append(st._replace(scratch=st.scratch[:1]), *args)
