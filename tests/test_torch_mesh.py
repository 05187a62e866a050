"""The port's part mesh (``repro_torch.core.mesh``) and what takes it: the
store's placed stacked loads, MapReduceMP's checks, shard launch counts
and shuffle bytes, and the profiler's cost of a group of shard launches,
on the CPU.

A CUDA mesh is checked here against a faked card count (``fake_cards``):
building one touches no card.  The MapReduceMP runs on CPU meshes are
held to the JAX package in ``tests/test_torch_mapreduce.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc
from repro_torch.core.mesh import PartMesh, default_part_mesh, make_part_mesh
from repro_torch.data.generators import subgen_like_graph, subgen_queries
from repro_torch.kernels import ops
from repro_torch.obs import ResourceProfiler, Tracer

CAP = 1024
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes at once).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_cards(monkeypatch):
    """``fake_cards(n)`` makes torch report n CUDA devices (none when 0)."""
    def fake(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return fake


@pytest.fixture(scope="module")
def graph():
    g = subgen_like_graph(n_nodes=300, n_edges=900, n_embed=10, seed=5)
    pg = tc.build_partitions(g, tc.partition_graph(g, 4, "kway_shem"), 4,
                             scheme="kway_shem")
    return g, pg, subgen_queries(g)


def _layout(mesh):
    return [(str(s.device), list(s.pids)) for s in mesh.shards]


# -- make_part_mesh ----------------------------------------------------------

@pytest.mark.parametrize("n,want", [
    (1, [[0, 1, 2, 3]]), (2, [[0, 1], [2, 3]]), (4, [[0], [1], [2], [3]])])
def test_k4_over_cpu_devices(n, want):
    mesh = make_part_mesh(4, devices=["cpu"] * n)
    assert _layout(mesh) == [("cpu", p) for p in want]
    assert mesh.k == 4 and mesh.lanes == tuple(len(p) for p in want)
    assert mesh.devices == (CPU,)


@pytest.mark.parametrize("cards,want", [
    (1, [("cuda:0", [0, 1, 2, 3])]),
    (2, [("cuda:0", [0, 1]), ("cuda:1", [2, 3])]),
    (4, [("cuda:0", [0]), ("cuda:1", [1]), ("cuda:2", [2]), ("cuda:3", [3])]),
    (8, [("cuda:0", [0]), ("cuda:1", [1]), ("cuda:2", [2]), ("cuda:3", [3])])])
def test_k4_spreads_over_the_visible_cards(fake_cards, cards, want):
    """The default mesh: one card holds one shard of four lanes (today's
    engine); more cards split the mappers evenly, never into empty shards."""
    fake_cards(cards)
    mesh = make_part_mesh(4)
    assert _layout(mesh) == want
    assert len(mesh.devices) == min(cards, 4)


def test_uneven_split_and_string_device():
    assert _layout(make_part_mesh(5, devices=["cpu", "cpu"])) == [
        ("cpu", [0, 1, 2]), ("cpu", [3, 4])]
    assert _layout(make_part_mesh(3, devices="cpu")) == [("cpu", [0, 1, 2])]
    assert str(make_part_mesh(2, devices=["cpu"] * 2)) == "cpu:[0] cpu:[1]"


def test_explicit_mesh_and_equality():
    mesh = PartMesh(((CPU, (0,)), ("cpu", [1, 2, 3])))
    assert _layout(mesh) == [("cpu", [0]), ("cpu", [1, 2, 3])]
    assert mesh == PartMesh(tuple(mesh.shards)) != make_part_mesh(4, ["cpu"] * 2)
    assert mesh.key == (("cpu", (0,)), ("cpu", (1, 2, 3)))
    assert mesh.peer_access() == {}


def test_default_mesh_follows_the_device(fake_cards):
    assert _layout(default_part_mesh(4, "cpu")) == [("cpu", [0, 1, 2, 3])]
    fake_cards(2)
    assert _layout(default_part_mesh(4, "cuda:1")) == [("cuda:1", [0, 1, 2, 3])]
    assert _layout(default_part_mesh(4, "cuda")) == [("cuda:0", [0, 1]),
                                                     ("cuda:1", [2, 3])]
    assert _layout(default_part_mesh(4, None)) == _layout(default_part_mesh(4, "cuda"))


BAD = {
    "missing_id": [("cpu", (0, 1)), ("cpu", (3,))],
    "id_twice": [("cpu", (0, 1)), ("cpu", (1, 2, 3))],
    "out_of_order": [("cpu", (2, 3)), ("cpu", (0, 1))],
    "not_contiguous": [("cpu", (0, 2)), ("cpu", (1, 3))],
    "not_from_zero": [("cpu", (1, 2))],
    "empty_shard": [("cpu", (0, 1)), ("cpu", ())],
    "no_shard": [],
    "mixed_types": [("cpu", (0, 1)), ("cuda:0", (2, 3))],
    "cuda_past_the_cards": [("cuda:0", (0, 1)), ("cuda:2", (2, 3))],
    "not_a_device_type": [("meta", (0,))],
}


@pytest.mark.parametrize("case", BAD)
def test_bad_mesh_raises(fake_cards, case):
    fake_cards(2)
    err = RuntimeError if case == "cuda_past_the_cards" else ValueError
    with pytest.raises(err):
        PartMesh(tuple(BAD[case]))


def test_cuda_without_a_card_raises(fake_cards):
    """No CPU fallback: a CUDA mesh with no card raises, by default and
    when named."""
    fake_cards(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_part_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_part_mesh(4, devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_part_mesh(4, None)


@pytest.mark.parametrize("k,devices", [(2, ["cpu"] * 3), (0, ["cpu"]), (2, [])])
def test_make_part_mesh_rejects_bad_sizes(k, devices):
    with pytest.raises(ValueError):
        make_part_mesh(k, devices=devices)


# -- the store's placed stacked loads ---------------------------------------

def test_stacked_load_over_a_mesh(graph):
    """One placed load is one counted load (cold, then warm, the bundle's
    bytes, as the JAX package counts a sharded one); each shard's stack
    equals its slice of the unplaced stack, and two shards on one device
    share no storage."""
    _, pg, _ = graph
    store = tc.PartitionStore(pg, device="cpu")
    plain = store.get_stacked((0, 1, 2, 3))
    cold = store.stats.copy()
    mesh = make_part_mesh(4, devices=["cpu"] * 2)
    entry = store.get_stacked((0, 1, 2, 3), device=mesh)
    delta = store.stats - cold
    assert (delta.misses, delta.hits, delta.bytes_cold) == (1, 0, plain.nbytes)
    assert entry.nbytes == plain.nbytes and entry.key == (0, 1, 2, 3)
    assert [s.key for s in entry.shards] == [(0, 1), (2, 3)]
    for s, lo in zip(entry.shards, (0, 2)):
        assert torch.equal(s.g2l, plain.g2l[lo:lo + 2])
        for k, v in plain.part.items():    # bitwise: node_value holds NaN
            assert s.part[k].numpy().tobytes() == v[lo:lo + 2].numpy().tobytes(), k
    a, b = entry.shards
    assert a.part["ell_dst"].data_ptr() != b.part["ell_dst"].data_ptr()
    assert store.get_stacked((0, 1, 2, 3), device=mesh) is entry
    assert (store.stats - cold).hits == 1


def test_placement_is_part_of_the_cache_key(graph):
    """A mesh change never serves a stale entry: each placement stages
    cold once; drop() removes every placement of the key."""
    _, pg, _ = graph
    store = tc.PartitionStore(pg, device="cpu")
    meshes = [make_part_mesh(4, devices=["cpu"] * n) for n in (1, 2, 4)]
    entries = [store.get_stacked(range(4), device=m) for m in meshes]
    assert store.stats.misses == 3 and store.stats.hits == 0
    assert [len(e.shards) for e in entries] == [1, 2, 4]
    assert store.get_stacked(range(4), device="cpu").shards == ()
    assert store.stats.misses == 4
    assert store.drop((0, 1, 2, 3)) and not store.contains((0, 1, 2, 3))
    with pytest.raises(ValueError, match="mesh of 4"):
        store.get_stacked((0, 1), device=meshes[0])


def test_owner_table_per_device(graph):
    _, pg, _ = graph
    store = tc.PartitionStore(pg, device="cpu")
    assert store.owner_on("cpu") is store.owner
    np.testing.assert_array_equal(store.owner.numpy(), np.asarray(pg.owner))


# -- the engine on a mesh -----------------------------------------------------

def test_engine_checks_its_mesh(graph, fake_cards):
    _, pg, _ = graph
    with pytest.raises(ValueError, match="one mapper per partition"):
        tc.MapReduceMPEngine(pg, device="cpu", mesh=make_part_mesh(3, devices="cpu"))
    fake_cards(1)
    with pytest.raises(ValueError, match="cannot serve a store on cpu"):
        tc.MapReduceMPEngine(pg, device="cpu", mesh=make_part_mesh(4))
    eng = tc.MapReduceMPEngine(pg, mesh=make_part_mesh(4, devices=["cpu"] * 4))
    assert eng.device == CPU and eng.store.device == CPU
    assert tc.MapReduceMPEngine(pg, device="cpu").mesh == make_part_mesh(4, "cpu")


@pytest.mark.parametrize("n,shards,devices", [(1, 0, 0), (2, 8, 0), (4, 12, 0)])
def test_shuffle_bytes(graph, n, shards, devices):
    """Ordered pairs of distinct shards exchange L_src x L_dst blocks of
    quota rows of Q + 2 int32; none crosses a device on the CPU."""
    _, pg, _ = graph
    eng = tc.MapReduceMPEngine(pg, tc.EngineConfig(cap=CAP), device="cpu",
                               mesh=make_part_mesh(4, devices=["cpu"] * n))
    block = eng.quota * (eng.cfg.q_pad + 2) * 4
    assert eng.shuffle_bytes() == {"shards": shards * block, "devices": devices * block}


@pytest.mark.parametrize("layout", [[[0, 1, 2, 3]], [[0], [1], [2], [3]], [[0], [1, 2, 3]]])
def test_profiled_mesh_stamps_a_launch_per_shard(graph, layout):
    """A profiled session on a mesh: each kernel.eval span stamps
    iterations x shards launches, each at the mean cost of the shards'
    launches, and answers equal the one-shard session's."""
    g, pg, qs = graph
    mesh = PartMesh(tuple(("cpu", p) for p in layout))
    one = tc.GraphSession(pg=pg, engine="mapreduce", config=tc.EngineConfig(cap=CAP),
                          device="cpu")
    sess = tc.GraphSession(pg=pg, engine="mapreduce", config=tc.EngineConfig(cap=CAP),
                           device="cpu", mesh=mesh, tracer=Tracer())
    for dq in qs:
        a, b = sess.submit(dq), one.submit(dq)
        np.testing.assert_array_equal(a.answers, b.answers)
        assert a.reports[0].stats.iterations == b.reports[0].stats.iterations
    spans = [s for s in sess.tracer.spans if s.name == "kernel.eval"]
    assert sum(s.attrs["launches"] for s in spans) == sess.engine.step_launches \
        == sess.engine.batched_iters * len(layout) > 0
    cost = sess.profiler.kernel_costs["mapreduce:eval"]
    shape = list(cost["shape"].values())
    lanes = [len(p) for p in layout]
    want = [ops.step_cost(L, *shape[1:]) for L in lanes]
    assert cost["flops"] == pytest.approx(np.mean([w[0] for w in want]))
    assert cost["bytes"] == pytest.approx(np.mean([w[1] for w in want]))
    assert cost.get("lanes") == (lanes if len(set(lanes)) > 1 else None)
    for sp in spans:
        assert sp.attrs["cost_bytes"] == cost["bytes"] * sp.attrs["launches"]


def test_attribute_kernel_lanes():
    """A group of launches that differ in L is costed at its mean; equal
    lanes cost what one shape does and record no ``lanes``."""
    prof = ResourceProfiler()
    shape = (2, 512, 20, 8, 12, 4096, 10_000)
    even = prof.attribute_kernel(("a", "even"), *shape, lanes=(2, 2))
    assert (even["flops"], even["bytes"]) == ops.step_cost(*shape)
    assert "lanes" not in even
    odd = prof.attribute_kernel(("a", "odd"), 1, *shape[1:], lanes=(1, 3))
    c1, c3 = ops.step_cost(1, *shape[1:]), ops.step_cost(3, *shape[1:])
    assert odd["flops"] == (c1[0] + c3[0]) / 2 and odd["bytes"] == (c1[1] + c3[1]) / 2
    assert odd["lanes"] == [1, 3]
