"""The PyTorch port's fused frontier step against the JAX package's
oracles and its Pallas kernel (interpret mode), on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Every output is an integer or a mask, so every comparison is exact.  The
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against this plain version there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.plan import PlanArrays as RefPlanArrays
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core.engine import plan_to_device
from repro_torch.convert import plan_arrays_from_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import fused_frontier as ff

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
    tables = [t(a) for a in c["tables"]]
    g2l, owner = t(c["g2l_row"]), t(c["owner"])
    dlidx, downer = ops.denorm_locality(tables[5], g2l, owner)
    return ops.fused_frontier(t(c["rows"]), t(c["step"]), t(c["lidx"]),
                              t(c["m"]), *tables, dlidx, downer, g2l, owner,
                              c["n_core"], _torch_plan(c["plan"]), c["n_steps"])


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


def _packed(c):
    """The kernel-level inputs (lidx, pint, pflt, rows, eight tables)."""
    t = torch.from_numpy
    tables = [t(a) for a in c["tables"]]
    g2l, owner = t(c["g2l_row"]), t(c["owner"])
    pint, pflt, _ = ops._fused_params(t(c["rows"]), t(c["step"]), t(c["m"]),
                                      g2l, owner, c["n_core"],
                                      _torch_plan(c["plan"]), c["n_steps"])
    return (t(c["lidx"]), pint, pflt, t(c["rows"]), *tables,
            *ops.denorm_locality(tables[5], g2l, owner))


def test_wrapper_rejects_bad_inputs():
    args = list(_packed(_case(3, 8, 5, 4, 8)))
    with pytest.raises(ValueError):
        ff.fused_frontier_kernel(*[a.to("meta") for a in args])
    bad = list(args)
    bad[8] = bad[8].int()                       # ell_dval must be float32
    with pytest.raises(ValueError):
        ff.fused_frontier_kernel(*bad)
    bad = list(args)
    bad[3] = bad[3].t()                         # rows: wrong shape/layout
    with pytest.raises(ValueError):
        ff.fused_frontier_kernel(*bad)
    bad = list(args)
    bad[1] = bad[1][:, :11].contiguous()        # pint must have 12 columns
    with pytest.raises(ValueError):
        ff.fused_frontier_kernel(*bad)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    build.LAUNCHES.clear()
    args = _packed(_case(9, 8, 5, 4, 8))
    got = ff.fused_frontier_kernel(*args)
    want = ff.fused_frontier_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert build.LAUNCHES[ff.NAME] == 0


def test_build_targets_hopper():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert ff.NAME in build.kernel_names()
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
    src = (build.CSRC / f"{ff.NAME}.cu").read_text()
    assert 'extern "C" int fused_frontier_launch' in src
    assert "torch/extension.h" not in src

