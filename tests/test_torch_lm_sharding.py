"""The port's sharding rule resolver and LM mesh (``repro_torch.launch.
{sharding,mesh}``) against the JAX package's, on the CPU.

The resolver reads only a mesh's ``axis_names`` and ``shape``, so both
packages resolve on stand-in meshes (as ``tests/test_sharding.py`` does)
at the production shapes 16x16 and 2x16x16 and the test shapes (4, 1),
(1, 4) and (2, 2), for all ten configs at full width (the port's leaves
on the ``meta`` device, the reference's from ``jax.eval_shape``).  The
reference's ``ShardingRules.named`` is patched to hand back its
``PartitionSpec``; each spec is compared as a tuple.  The reference stacks
the body's leaves across periods, so a body leaf's spec there is the
port's with a leading None.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.launch import sharding as ref_sharding
from repro.models import transformer as ref_tf
from repro.serving import decode as ref_decode

from repro_torch import configs
from repro_torch.launch import mesh as lm_mesh
from repro_torch.launch import sharding as sh
from repro_torch.models.transformer import abstract_params, stack_segments


class FakeMesh:
    """A stand-in mesh: axis names, sizes, and this rank's coordinates."""

    def __init__(self, shape, axes=("data", "model"), coords=None):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self._coords = dict(zip(axes, coords or [0] * len(axes)))

    def index(self, axis):
        return self._coords[axis]


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
ALL_ARCHS = sorted(ref_configs.ARCHS)
CACHE_SHAPES = [(128, 32768), (1, 4096)]


# ---------------------------------------------------------------------------
# tests/test_sharding.py's resolver cases
# ---------------------------------------------------------------------------

RESOLVE = {
    "divisible_dims_sharded": ((8192, 64, 128), ("embed", "heads", None), ("data", "model")),
    # qwen2-1.5b: 12 heads % 16 != 0 -> heads replicated, embed still sharded
    "non_divisible_heads_fall_back": ((1536, 12, 128), ("embed", "heads", None), ("data",)),
    "kv_heads_replicated_when_small": ((8192, 8, 128), ("embed", "kv_heads", None), ("data",)),
    # [d, d] with both dims wanting 'data' -> second falls back to None
    "axis_never_reused": ((2048, 2048), ("embed", "embed"), ("data",)),
    "odd_vocab_replicated": ((49155, 2048), ("vocab", "embed"), (None, "data")),
    "experts_shard_over_model": ((64, 2048, 1408), ("experts", "embed", None),
                                 ("model", "data")),
    "stacked_leading_dim_gets_none": ((28, 2048, 8192), ("embed", "mlp"),
                                      (None, "data", "model")),
    "kv_cache_resolves_no_seq_axis": ((128, 32768, 8, 128), (None, None, "kv_heads", None), ()),
}


@pytest.mark.parametrize("case", sorted(RESOLVE))
def test_resolver_cases(case):
    shape, logical, want = RESOLVE[case]
    fm = FakeMesh((16, 16))
    got = sh.ShardingRules(fm).resolve(shape, logical)
    assert got == want
    assert got == tuple(ref_sharding.ShardingRules(fm).resolve(shape, logical))


def test_batch_dim_spec_and_scalars():
    fm = FakeMesh((16, 16))
    assert sh._batch_dim_spec(fm, 128) == "data" == ref_sharding._batch_dim_spec(fm, 128)
    assert sh._batch_dim_spec(fm, 1) is None
    assert sh._batch_dim_spec(FakeMesh((2, 16, 16), ("pod", "data", "model")), 64) \
        == ("pod", "data")
    tree = {"tokens": (8, 64), "pos": ()}
    assert sh.batch_shardings(FakeMesh((2, 2)), tree) == {"tokens": ("data", None), "pos": ()}


def test_all_param_leaves_have_rules():
    """Every leaf name of every arch's port model is covered by
    AXES_BY_NAME (a miss would fall back to replicated)."""
    assert sh.AXES_BY_NAME == ref_sharding.AXES_BY_NAME
    assert sh.LOGICAL_TO_MESH == ref_sharding.LOGICAL_TO_MESH
    for aid, cfg in configs.ARCHS.items():
        for name, _ in abstract_params(cfg).named_parameters():
            assert sh.leaf_name(name) in sh.AXES_BY_NAME, (aid, name)


def test_placements_and_blocks():
    fm = FakeMesh((2, 2), coords=[1, 0])
    rules = sh.ShardingRules(fm)
    assert rules.placements(("data", "model")) == [Shard(0), Shard(1)]
    assert rules.placements(("model", "data")) == [Shard(1), Shard(0)]
    assert rules.placements((None, "data")) == [Shard(1), Replicate()]
    assert rules.placements(()) == [Replicate(), Replicate()]
    full = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(rules.named((None, "data")).shard(full), full[:, 3:])
    assert torch.equal(rules.named(("data", "model")).shard(full), full[2:, :3])
    assert torch.equal(rules.named(()).shard(full), full)


# ---------------------------------------------------------------------------
# Parity: every parameter, optimizer and cache leaf, ten configs at full
# width, five meshes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_abstract_params(cfg):
    return ref_tf.abstract_params(cfg)


@functools.lru_cache(maxsize=None)
def _ref_abstract_caches(cfg, batch, s_max):
    return ref_decode.abstract_caches(cfg, batch, s_max)


@pytest.fixture
def ref_rules(monkeypatch):
    """The reference resolver with ``named`` (and ``batch_shardings``'
    ``NamedSharding``) handing back the spec, and its abstract trees
    computed once per config."""
    monkeypatch.setattr(ref_sharding.ShardingRules, "named", lambda self, spec: spec)
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(ref_sharding, "abstract_params", _ref_abstract_params)
    monkeypatch.setattr(ref_sharding, "abstract_caches", _ref_abstract_caches)
    return ref_sharding


def per_layer(cfg, template, specs, top_ok=True):
    """The reference's spec tree as {port name: spec tuple}: a body leaf's
    spec loses its leading None and serves every period's layer."""
    head, body, tail = stack_segments(cfg)
    treedef = jax.tree_util.tree_structure(template)
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(template)[0]]
    out = {}
    for path, spec in zip(paths, treedef.flatten_up_to(specs)):
        keys = [str(k.key) if hasattr(k, "key") else str(k.idx) for k in path]
        spec = tuple(spec)
        rest = ".".join(keys[2:])
        if keys[0] == "body":
            for period in body:
                out[f"layers.{period[int(keys[1])]}.{rest}"] = spec[1:]
        elif keys[0] in ("head_layers", "tail_layers"):
            li = (head if keys[0] == "head_layers" else tail)[int(keys[1])]
            out[f"layers.{li}.{rest}"] = spec
        else:
            assert top_ok, keys
            out[".".join(keys)] = spec
    return out


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_specs_match_reference(ref_rules, aid, mesh_id):
    """Every parameter (with and without ``embed_replicated``), optimizer
    and cache leaf resolves to the reference's spec."""
    cfg, rcfg = configs.ARCHS[aid], ref_configs.ARCHS[aid]
    fm = FakeMesh(*MESHES[mesh_id])
    template = _ref_abstract_params(rcfg)
    for vocab_shard in (True, False):
        want = per_layer(rcfg, template,
                         ref_rules.param_shardings(rcfg, fm, embed_vocab_shard=vocab_shard))
        got = sh.param_shardings(cfg, fm, embed_vocab_shard=vocab_shard)
        assert got == want, vocab_shard
        ref_opt_specs = ref_rules.opt_shardings(rcfg, fm, embed_vocab_shard=vocab_shard)
        opt = sh.opt_shardings(cfg, fm, embed_vocab_shard=vocab_shard)
        assert opt["step"] == tuple(ref_opt_specs["step"]) == ()
        for key in ("m", "v"):
            assert opt[key] == per_layer(rcfg, template, ref_opt_specs[key]), key
    for batch, s_max in CACHE_SHAPES:
        ctemplate = _ref_abstract_caches(rcfg, batch, s_max)
        for seq in (True, False):
            want = per_layer(rcfg, ctemplate, ref_rules.cache_shardings(
                rcfg, fm, batch, s_max, shard_cache_seq=seq), top_ok=False)
            got = sh.cache_shardings(cfg, fm, batch, s_max, shard_cache_seq=seq)
            assert {f"layers.{i}.{k}": v for i, c in enumerate(got) for k, v in c.items()} \
                == want, (batch, s_max, seq)
    tree = {"tokens": jax.ShapeDtypeStruct((16, 64), np.int32),
            "pos": jax.ShapeDtypeStruct((), np.int32)}
    ref_b = ref_rules.batch_shardings(fm, tree)
    assert sh.batch_shardings(fm, {"tokens": (16, 64), "pos": ()}) == \
        {k: tuple(v) for k, v in ref_b.items()}


def test_opt_state_specs_follow_the_parameters():
    """``opt_shardings``' m and v are the parameters' specs, name for name,
    on the port's (per layer) names."""
    cfg = configs.ARCHS["deepseek_moe_16b"]
    fm = FakeMesh((2, 2))
    params = sh.param_shardings(cfg, fm)
    opt = sh.opt_shardings(cfg, fm)
    assert opt["m"] == opt["v"] == params
    assert params["layers.1.ffn.e_gate"] == ("model", "data")


# ---------------------------------------------------------------------------
# The mesh and the activation closures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod, n", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_ranks(multi_pod, n):
    """Below 256 (512) ranks ``make_production_mesh`` raises the reference's
    ``RuntimeError`` (its message up to the hint on how to launch)."""
    with pytest.raises(RuntimeError) as got:
        lm_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError) as want:
        ref_mesh.make_production_mesh(multi_pod=multi_pod)
    assert str(got.value).split(" — ")[0] == str(want.value).split(" — ")[0]
    assert str(got.value).startswith(f"need {n} devices")


def test_test_mesh_needs_a_group_of_its_size():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_world"):
        lm_mesh.make_test_mesh((1, 1), device="cpu")
    lm_mesh.init_world("cpu")
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            lm_mesh.make_test_mesh((2, 1), device="cpu")
        mesh = lm_mesh.make_test_mesh((1, 1), device="cpu")
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.index("data") == 0 and mesh.device == torch.device("cpu")
        assert torch.distributed.get_world_size(mesh.group("model")) == 1
        assert lm_mesh.dp_axes(mesh) == ("data",) == ref_mesh.dp_axes(mesh)
    finally:
        lm_mesh.close_world()
    assert not torch.distributed.is_initialized()


def test_constraints_check_the_batch_shard():
    """The closures hand back this rank's block and refuse other shapes:
    its rows (the whole batch where it is replicated); the logits' vocab
    over ``model`` where M divides it ([B_local, S, V/M] on (2, 2), whole V
    where M does not divide it); the activations' d over ``model`` under
    ``tp_act`` ([B_local, S, d/M]), whole without it."""
    act = sh.act_constraint(FakeMesh((2, 1)), 4)
    x = torch.zeros(2, 8, 16)
    assert act(x) is x
    with pytest.raises(ValueError, match="2 of 4 rows"):
        act(torch.zeros(4, 8, 16))
    assert sh.logit_constraint(FakeMesh((2, 1)), 3, 128)(torch.zeros(3, 8, 128)).shape[0] == 3
    logits = sh.logit_constraint(FakeMesh((2, 2)), 4, 128)
    x = torch.zeros(2, 8, 64)
    assert logits(x) is x
    for bad in ((2, 8, 128), (4, 8, 64)):
        with pytest.raises(ValueError, match="not this rank's block"):
            logits(torch.zeros(bad))
    assert sh.logit_constraint(FakeMesh((2, 2)), 4, 127)(torch.zeros(2, 8, 127)).shape[-1] == 127
    tp_act = sh.act_constraint(FakeMesh((2, 2)), 4, tp_act=True, d_model=64)
    x = torch.zeros(2, 8, 32)
    assert tp_act(x) is x
    with pytest.raises(ValueError, match=r"\[2 of 4 rows, S, 32\]"):
        tp_act(torch.zeros(2, 8, 64))
    whole = sh.act_constraint(FakeMesh((1, 4)), 4, d_model=64)
    assert whole(torch.zeros(4, 8, 64)).shape[-1] == 64
    with pytest.raises(ValueError, match="not this rank's block"):
        whole(torch.zeros(4, 8, 16))
