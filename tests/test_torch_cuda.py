"""The port's CUDA kernels against their plain PyTorch versions, its
sessions, language models and training against the CPU, MapReduceMP on
multi-shard part meshes against one shard, and the LM mesh (the FSDP
step, tensor parallelism and the expert-parallel MoE) against one card,
on a card (the two-card cases skip with fewer cards).

Imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device the test skips (decided inside the test).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke
from repro_torch.kernels import frontier_append as fa
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import fused_frontier as ff
from repro_torch.kernels import label_histogram as lh

CASES = [((4, 4, 4, 8), False), ((16, 7, 6, 32), False),
         ((32, 128, 8, 64), False), ((8, 130, 5, 16), False),
         ((1, 1, 1, 1), False), ((8, 16, 4, 8), True),
         ((512, 20, 8, 4096), False)]


@pytest.mark.cuda
def test_cuda_fused_frontier_matches_plain():
    """The frontier step: every output bit-equal to its plain version,
    done/keep/out disjoint and covering ok -- over the test sweep, an empty
    frontier and the main path's EB/W/Q, at one lane and at two and four
    lanes (MapReduceMP's) over as many stacked partitions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    for L in (1, 2, 4):
        for (EB, W, Q, Np), empty in CASES:
            inv, args = chip_smoke.step_case(rng, L, EB, W, Q, Np, P=L,
                                             V=1000 + 2 * Np, empty=empty)
            out = ff.step_outputs(L, EB, W, Q, "cuda")
            got = ff.frontier_step_cuda(inv, *args, out)
            torch.cuda.synchronize()
            rec = chip_smoke.compare_step(got, ff.frontier_step_plain(inv, *args))
            assert rec["mismatches"] == 0 and rec["max_abs_err"] == 0, rec
            assert rec["disjoint"] and rec["covers_ok"], rec
            if empty:
                assert rec["n_ok"] == 0


@pytest.mark.cuda
def test_cuda_frontier_expand_matches_plain():
    """Bit-equal ok, dg where an edge exists, over the sweep, an empty
    frontier and the main path's EB/W/Q."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    for (EB, W, Q, Np), empty in CASES:
        args = chip_smoke.expand_args(chip_smoke.engine_case(
            rng, EB, W, Q, Np, V=1000 + 2 * Np, empty=empty))
        got = fe.frontier_expand_cuda(*args)
        torch.cuda.synchronize()
        rec = chip_smoke.compare_expand(got, fe.frontier_expand_plain(*args), args)
        assert rec["mask_mismatches"] == 0 and rec["max_abs_err"] == 0, rec
        if empty:
            assert rec["n_ok"] == 0


@pytest.mark.cuda
def test_cuda_label_histogram_matches_plain():
    """Exact counts across the 1024-node block edge, every label kind and
    value op, NaN values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(2)
    for n in (1, 1023, 1024, 1025, 3000, 294_400):
        args = chip_smoke.histogram_case(rng, n)
        for label in (-1, 2, 9):
            for op in range(7):
                got = lh.label_histogram_cuda(*args, label, op, 0.1)
                want = lh.label_histogram_plain(*args, label, op, 0.1)
                assert got.dtype == torch.int32 and got.dim() == 0
                assert int(got) == int(want), (n, label, op)


@pytest.mark.cuda
def test_cuda_label_histogram_offset_views_and_tails():
    """Views at offsets 1-3 (every pointer misaligned: the scalar path) and
    at 0 (the 16-byte path), each at n % 4 = 0-3, exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    for n in (0, 3000, 294_400):
        for off, tail, args in chip_smoke.histogram_views(rng, n):
            assert lh.use_vector_loads(*args) == (off == 0 or n + tail == 0)
            for label, op, value in chip_smoke.HISTOGRAM_PROBES:
                got = lh.label_histogram_cuda(*args, label, op, value)
                want = lh.label_histogram_plain(*args, label, op, value)
                assert int(got) == int(want), (n, off, tail, label, op)


@pytest.mark.cuda
def test_cuda_label_histogram_two_streams_and_graph_replay():
    """Two streams at once draw from separate tickets; a captured CUDA graph
    whose stream's scratch is made inside the capture gives exact counts
    on every replay, and eager calls on that stream after it do too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    mis = tuple(a[1:] for a in chip_smoke.histogram_case(rng, 294_401))
    big = chip_smoke.histogram_case(rng, 294_400)
    streamed = chip_smoke.histogram_two_streams([(mis, 1, 5, 0.1), (big, -1, 0, 0.0)])
    assert len(streamed) == 40
    assert all(got == want for _, got, want in streamed), streamed
    replayed = chip_smoke.histogram_graph_replay(
        [(mis, 1, 5, 0.1), (big, 2, 3, -0.2),
         (chip_smoke.histogram_case(rng, 1025), -1, 0, 0.0)])
    assert len(replayed) == 6 * 3
    assert all(got == want for *_, got, want in replayed), replayed


@pytest.mark.cuda
@pytest.mark.parametrize("EB,W,Q,Np", chip_smoke.EXPAND_WARP_CASES)
def test_cuda_frontier_expand_across_the_warp_width(EB, W, Q, Np):
    """A warp per binding: W on each side of 32 and W = 130 (lanes loop),
    Q = 1 and 8, bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(W * 10 + Q)
    args = chip_smoke.expand_args(chip_smoke.engine_case(rng, EB, W, Q, Np, V=1000))
    got = fe.frontier_expand_cuda(*args)
    torch.cuda.synchronize()
    rec = chip_smoke.compare_expand(got, fe.frontier_expand_plain(*args), args)
    assert rec["mask_mismatches"] == 0 and rec["max_abs_err"] == 0, rec


# (name, (L, EB, W, Q), chip_smoke.append_case keywords): the shared
# scheduler's shape, an IMDB-wide row, one candidate, a lane count that is
# no multiple of 4 with Q = 5 (scalar row copies), and the pre-classify's
# form (no keep, rows through a strided view, N % 16 != 0: scalar mask
# loads).  Lanes cycle through sparse, empty (frozen), all-true and half
# flags; odd lanes start 3 under cap; lanes 3 mod 4 have a nearly full
# work buffer, so appends and keep placement overflow.
APPEND_CASES = [
    ("main", (32, 512, 20, 8), {"cap": 16384, "WT": 16384 + 4096}),
    ("imdb_row", (4, 512, 5140, 8), {"cap": 16384, "WT": 16384 + 18_560,
                                     "density": 2e-5}),
    ("one", (1, 1, 1, 1), {"cap": 4, "WT": 3, "density": 1.0}),
    ("lanes_not_mod4", (7, 64, 9, 5), {"cap": 300, "WT": 257}),
    ("preclassify", (6, 1, 16_391, 8), {"cap": 16384, "keep": False}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kw", APPEND_CASES, ids=[c[0] for c in APPEND_CASES])
def test_cuda_frontier_append_matches_plain(name, shape, kw):
    """The append kernel bit-equal to its plain version on every output but
    the trash rows: rows, steps, destinations, the work buffers, counts,
    overflow and rows landed.  Twice with the same scratch: the second
    launch finds the first one's tile statuses and must read them as
    stale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st, args = chip_smoke.append_case(7, *shape, **kw)
    want = chip_smoke.clone_append(st, args)
    fa.frontier_append_plain(want[0], *want[1])
    for launch in range(2):
        got_st, got_args = chip_smoke.clone_append(st, args)
        got_st = got_st._replace(scratch=st.scratch)
        fa.frontier_append_cuda(got_st, *got_args)
        torch.cuda.synchronize()
        rec = chip_smoke.compare_append((got_st, got_args), want)
        assert rec["mismatches"] == 0, (launch, rec)
        if shape[0] >= 4:
            assert 0 < rec["overflow_lanes"] < shape[0], rec
        assert rec["landed"] > 0, rec


@pytest.mark.cuda
def test_cuda_frontier_append_evaluator_sequence():
    """The evaluator's own order of appends on one state and one scratch:
    a pre-classify over the work buffer (six tiles, no keep), then a loop
    launch over 322 tiles with keep placement, twice.  In the pre-classify
    each tile's done count, and on odd tiles its outm count, is 5 to 7 with
    the count after it 0: packed in pairs, those counts read like the next
    launch's tile statuses wherever that launch looked for a status among
    them.  Bit-equal to the plain version after every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    L, EB, W, Q, cap = 8, 512, 5140, 8, 16384
    WT = 5 * fa.TILE + 96
    st, args = chip_smoke.append_case(11, L, EB, W, Q, cap=cap, WT=WT,
                                      density=2e-5)
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    done0, outm0 = (torch.zeros((L, WT), dtype=torch.bool, device="cuda")
                    for _ in range(2))
    for p in range(-(-WT // fa.TILE)):
        lo, n = p * fa.TILE, min(fa.TILE, WT - p * fa.TILE)
        for m, k in ((done0, 5 + p % 3), (outm0, (5 + p % 3) * (p % 2))):
            m[:, lo + torch.randperm(n, generator=g, device="cuda")[:k]] = True
    dest0 = torch.randint(-1, 4, (L, WT), generator=g, device="cuda",
                          dtype=torch.int32)
    sides = {fa.frontier_append_cuda: chip_smoke.clone_append(st, args),
             fa.frontier_append_plain: chip_smoke.clone_append(st, args)}
    for launch in range(4):
        for op, (s, (rows, step, dest, done, outm, keep, work, _)) in sides.items():
            wr, ws, wv = work
            if launch % 2 == 0:
                op(s, wr[:, :WT], ws[:, :WT], dest0, done0, outm0)
            else:
                free = torch.sort((~wv[:, :WT]).to(torch.uint8), dim=1,
                                  descending=True, stable=True)[1][:, :WT]
                op(s, rows, step, dest, done, outm, keep, work, free)
        torch.cuda.synchronize()
        rec = chip_smoke.compare_append(*sides.values())
        assert rec["mismatches"] == 0, (launch, rec)
        assert rec["landed"] > 0, rec


@pytest.mark.cuda
def test_cuda_mapreduce_matches_cpu():
    """MapReduceMP (four lanes of the card, one frontier-step launch per
    iteration) against the same engine on the CPU: identical answers,
    iterations and yield counters, exhaustive, under K=5 and gated to
    m_limit=2 under MAX-YIELD."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.data.generators import subgen_like_graph, subgen_queries
    from repro_torch.kernels import build
    g = subgen_like_graph(n_nodes=2000, n_edges=6000, n_embed=50, seed=0)
    qs = subgen_queries(g)
    from repro_torch.core import make_part_mesh
    build.LAUNCHES.clear()
    card = chip_smoke.mapreduce_small(g, qs, "cuda")
    # one launch per shard an iteration (one shard on one card)
    shards = len(make_part_mesh(4).shards)
    assert build.LAUNCHES[ff.NAME] == sum(r[3] for r in card) * shards
    assert chip_smoke.same_mapreduce(card, chip_smoke.mapreduce_small(g, qs, "cpu"))


def mesh_runs(g, qs, mesh) -> list:
    """``chip_smoke.mapreduce_small``'s runs (and gated RANDOM-SN) on the
    card, every engine on ``mesh``, each run's load counts appended."""
    from repro_torch.core import EngineConfig, GraphSession, MapReduceMPEngine, generate_plan
    sess = GraphSession(g, engine="mapreduce", config=EngineConfig(cap=16384),
                        device="cuda", mesh=mesh)
    engines = {"all": sess.engine,
               "m2_max-yield": MapReduceMPEngine(sess.pg, sess.config, m_limit=2,
                                                 heuristic="max-yield", store=sess.store,
                                                 mesh=mesh),
               "m2_random-sn": MapReduceMPEngine(sess.pg, sess.config, m_limit=2,
                                                 heuristic="random-sn", store=sess.store,
                                                 mesh=mesh)}
    out = []
    for dq in qs:
        plan = generate_plan(dq.disjuncts[0], g, sess.catalog)
        for run, K in (("all", None), ("all", 5), ("m2_max-yield", None),
                       ("m2_random-sn", None)):
            r = engines[run].run(plan, max_answers=K, seed=3)
            out.append((run, dq.name, r.answers, r.n_iterations, r.completed_from.tolist(),
                        r.spawned_from.tolist(), r.stats.cold_loads, r.stats.warm_loads,
                        r.stats.bytes_cold))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [[[0], [1], [2], [3]], [[0, 1], [2, 3]], [[0], [1, 2, 3]]])
def test_cuda_four_shards_on_one_card_equal_one_shard(layout):
    """MapReduceMP on a multi-shard mesh whose shards all lie on cuda:0
    (per-shard buffers and launches, the shuffle as copies between shards)
    against the default one-shard mesh: every run bit for bit equal
    (answers, iterations, yield counters, loads), and the step launched
    once per shard an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import PartMesh, make_part_mesh
    from repro_torch.data.generators import subgen_like_graph, subgen_queries
    from repro_torch.kernels import build
    g = subgen_like_graph(n_nodes=2000, n_edges=6000, n_embed=50, seed=0)
    qs = subgen_queries(g)
    mesh = PartMesh(tuple(("cuda:0", p) for p in layout))
    one = mesh_runs(g, qs, make_part_mesh(4, devices=["cuda:0"]))
    build.LAUNCHES.clear()
    many = mesh_runs(g, qs, mesh)
    assert build.LAUNCHES[ff.NAME] == sum(r[3] for r in many) * len(layout)
    assert len(one) == len(many)
    for a, b in zip(one, many):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2]) and a[3:] == b[3:], a[:2]


@pytest.mark.cuda
def test_cuda_kernels_launch_on_their_tensors_card():
    """Each wrapper launches on its tensors' card while another is
    current: the step, frontier_expand and label_histogram on cuda:1 with
    cuda:0 current, each bit-equal to its plain version."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(5)
    with torch.cuda.device(0):
        inv, args = chip_smoke.step_case(rng, 4, 512, 20, 8, 4096, P=4, dev="cuda:1")
        got = ff.frontier_step_cuda(inv, *args, ff.step_outputs(4, 512, 20, 8, "cuda:1"))
        torch.cuda.synchronize(1)
        rec = chip_smoke.compare_step(got, ff.frontier_step_plain(inv, *args))
        assert rec["mismatches"] == 0 and got[0].device == torch.device("cuda:1"), rec
        eargs = chip_smoke.expand_args(chip_smoke.engine_case(rng, 512, 20, 8, 4096, 9000,
                                                              dev="cuda:1"))
        ok, dg = fe.frontier_expand_cuda(*eargs)
        torch.cuda.synchronize(1)
        wok, _ = fe.frontier_expand_plain(*eargs)
        assert torch.equal(ok, wok)
        hargs = chip_smoke.histogram_case(rng, 294_400, dev="cuda:1")
        got = lh.label_histogram_cuda(*hargs, 2, 3, 0.1)
        assert int(got) == int(lh.label_histogram_plain(*hargs, 2, 3, 0.1))


@pytest.mark.cuda
def test_cuda_two_card_mesh_equals_one_card():
    """A mesh over two cards (the shuffle across them) equals the default
    one-shard run on one card, bit for bit."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core import make_part_mesh
    from repro_torch.data.generators import subgen_like_graph, subgen_queries
    g = subgen_like_graph(n_nodes=2000, n_edges=6000, n_embed=50, seed=0)
    qs = subgen_queries(g)
    mesh = make_part_mesh(4, devices=["cuda:0", "cuda:1"])
    one, many = mesh_runs(g, qs, make_part_mesh(4, devices=["cuda:0"])), mesh_runs(g, qs, mesh)
    for a, b in zip(one, many):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2]) and a[3:] == b[3:], a[:2]


@pytest.fixture(scope="module")
def small_graph_dir(tmp_path_factory):
    """A 20,000-node synthetic graph at k=4 saved as a graph directory
    (made only when there is a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import GraphSession
    from repro_torch.data.generators import subgen_like_graph
    g = subgen_like_graph(n_nodes=20_000, n_edges=60_000, n_embed=500, seed=0)
    gdir = tmp_path_factory.mktemp("cuda-ooc") / "graph"
    GraphSession(g, device="cpu").save(str(gdir))
    return gdir


@pytest.mark.cuda
def test_cuda_host_eviction_under_an_in_flight_copy(small_graph_dir):
    """A host tier of one partition: prefetch(a)'s side-stream copy is held
    behind a spin kernel while get(b) evicts a's pinned bundle and pins b's;
    both device entries equal their shards bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec = chip_smoke.evict_under_copy(small_graph_dir, 0, 1, sleep_cycles=3_000_000_000)
    assert rec["prefetch_issued"] and rec["a_evicted"], rec
    assert rec["copy_in_flight_at_eviction"], rec
    assert rec["a_equal"] and rec["b_equal"] and rec["prefetch_hits"] == 1, rec


@pytest.mark.cuda
def test_cuda_read_ahead_pinned_on_its_worker(small_graph_dir):
    """prefetch of a partition not in host RAM: a read-ahead whose worker
    thread pins the bundle, then one copy on the main stream at the get,
    bit-equal to the shard; no device copy at the prefetch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec = chip_smoke.read_ahead_pinned(small_graph_dir, 2)
    assert rec["read_ahead_issued"] and rec["pinned_on_worker"] and rec["equal"], rec
    assert rec["read_ahead_hits"] == 1 and rec["device_copy_on_prefetch"] == 0, rec
    assert rec["worker"].startswith("read-ahead-part-")


@pytest.mark.cuda
def test_cuda_opened_opat_matches_cpu(small_graph_dir):
    """An OPAT session opened from disk (device and host tiers of one
    partition) on the card equals the same session on the CPU: answers,
    loads, iterations and every LoadStats field; the step launches once
    per evaluator loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import build
    build.LAUNCHES.clear()
    card = chip_smoke.opened_small(small_graph_dir, "cuda")
    assert build.LAUNCHES[ff.NAME] > 0
    cpu = chip_smoke.opened_small(small_graph_dir, "cpu")
    assert chip_smoke.same_opened(card, cpu)
    assert sum(r[4]["disk_reads"] for r in card) > 0
    assert sum(r[4]["read_ahead_hits"] for r in card) > 0


@pytest.mark.cuda
def test_cuda_step_under_a_view_with_added_vertices(small_graph_dir):
    """An opened OPAT session whose view adds a vertex (a clone of one Q4
    binds, with its edges) and widens the ELL width: on the card it equals
    the CPU session (answers, loads, iterations, every LoadStats field,
    stale and compacted), and one step launch under the view reads the
    view's [V] owner table and g2l row and is bit-equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import build
    build.LAUNCHES.clear()
    card = chip_smoke.mutated_small(small_graph_dir, "cuda")
    assert build.LAUNCHES[ff.NAME] > 0
    assert chip_smoke.same_mutated(card, chip_smoke.mutated_small(small_graph_dir, "cpu"))
    step = card["step"]
    assert step["mismatches"] == 0 and step["max_abs_err"] == 0, step
    assert step["V"] == step["g2l_len"] == step["view_nodes"] > card["V0"], step
    assert step["matched_added"] > 0, step
    assert card["W"] > card["W0"]
    assert any((r[2] >= card["V0"]).any() for r in card["runs"])


@pytest.mark.cuda
def test_cuda_two_generations_of_one_partition(small_graph_dir):
    """A scheduler pinned to generation G and the session on G+1 (a vertex
    added and its partition compacted) hold two stagings of that partition
    on the card at once; each view's answers are its own oracle's, and
    equal the CPU run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = chip_smoke.two_generations(small_graph_dir, "cuda")
    assert card["resident_stagings"] == 2, card
    assert card["old_equal"] and card["new_equal"] and card["answers_differ"], card
    assert card["new_generation"] == card["old_generation"] + 1
    cpu = chip_smoke.two_generations(small_graph_dir, "cpu")
    assert np.array_equal(card["old"], cpu["old"]) and np.array_equal(card["new"], cpu["new"])


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["opat", "traditional", "mapreduce"])
def test_cuda_profiled_session_costs_every_span(engine):
    """A profiled session on the card (a Tracer attached): every
    kernel.eval span carries its kernel key, predicted cost, step launches
    and the store's live bytes, with no cost_error; the stamped launches
    are the step's launches; answers equal the unprofiled CPU session's;
    peak_device_bytes is within torch.cuda.max_memory_allocated()."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.data.generators import subgen_like_graph, subgen_queries
    from repro_torch.kernels import build
    from repro_torch.obs import Tracer
    g = subgen_like_graph(n_nodes=2000, n_edges=6000, n_embed=50, seed=0)
    qs = subgen_queries(g)
    cpu = GraphSession(g, engine=engine, config=EngineConfig(cap=16384), device="cpu")
    card = GraphSession(g, engine=engine, config=EngineConfig(cap=16384),
                        device="cuda", tracer=Tracer())
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    for dq in qs:
        np.testing.assert_array_equal(card.submit(dq).answers, cpu.submit(dq).answers)
    report = card.submit_many(qs)
    torch.cuda.synchronize()
    for res, dq in zip(report.results, qs):
        np.testing.assert_array_equal(res.answers, cpu.submit(dq).answers)
    spans = [s for s in card.tracer.spans if s.name == "kernel.eval"]
    assert spans
    for sp in spans:
        for attr in chip_smoke.COST_ATTRS:
            assert attr in sp.attrs, (attr, sp.attrs)
        assert "cost_error" not in sp.attrs
    assert sum(s.attrs["launches"] for s in spans) == build.LAUNCHES[ff.NAME] > 0
    peak = card.profiler.peak_device_bytes
    assert 0 < peak <= torch.cuda.max_memory_allocated()


LM_ARCHS = ["deepseek_moe_16b", "granite_3_2b", "granite_moe_1b_a400m",
            "llava_next_mistral_7b", "musicgen_medium", "qwen1_5_110b",
            "qwen2_1_5b", "qwen3_4b", "recurrentgemma_9b", "xlstm_125m"]


@pytest.mark.cuda
@pytest.mark.parametrize("aid", LM_ARCHS)
def test_cuda_lm_reduced_matches_cpu(aid):
    """A reduced config in float32 (TF32 off) on the card against the CPU
    from the same weights: forward, prefill (every cache leaf) and
    decode_step on the grown caches, within chip_smoke's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = chip_smoke.lm_card_against_cpu(aid, seed=0)
    assert set(errs) == {"logits", "aux", "last", "dlogits", "caches", "dcaches"}


@pytest.mark.cuda
@pytest.mark.parametrize("aid", LM_ARCHS)
def test_cuda_train_step_reduced_matches_cpu(aid):
    """One train_step of a reduced config in float32 (TF32 off) on the card
    against the CPU from the same weights and batch (remat; flash_cv on the
    attention configs): the loss terms and every leaf of m and v, within
    chip_smoke's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = chip_smoke.train_card_against_cpu(aid, seed=0)
    assert "remat" in rec


@pytest.mark.cuda
def test_cuda_flash_cv_grads_match_cpu():
    """flash_attention_cv's output and gradients at Qwen2-1.5B's attention
    shape, float32, on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = chip_smoke.flash_cv_card_against_cpu(seed=0)
    assert set(errs) == {"out", "dq", "dk", "dv"}


@pytest.mark.cuda
def test_cuda_one_rank_sharded_step_equals_unsharded():
    """In a one-rank NCCL group made in this process: the reduced Qwen2's
    FSDP step on make_test_mesh((1, 1)) against make_train_step (bit-equal,
    else within chip_smoke's MESH_TOL), and the reduced deepseek's moe_fn
    over the one-rank model axis against the dense moe_ffn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch.mesh import close_world, init_world, make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_world("cuda")
    try:
        mesh = make_test_mesh((1, 1), device=dev)
        qwen = reduced(ARCHS["qwen2_1_5b"])
        batches = chip_smoke.mesh_batches(qwen, 2, 64, 2, 0, dev)
        plain, want = chip_smoke.mesh_train(qwen, batches, 0, dev)
        sharded, got = chip_smoke.mesh_train(qwen, batches, 0, dev, mesh)
        assert chip_smoke.mesh_same_train(sharded, plain, got, want)["ok"]
        moe = chip_smoke.mesh_moe(reduced(ARCHS["deepseek_moe_16b"]), mesh, 0, dev, dense=True)
        assert moe["experts_per_card"] == 4
    finally:
        close_world()


@pytest.mark.cuda
def test_cuda_two_card_mesh_equals_one_card(tmp_path):
    """Two NCCL processes, one a card: Qwen2-1.5B (2 layers, published
    width) on (2, 1) against its one-card step, deepseek-moe-16b's moe_fn
    on (1, 2), 32 experts a card, against the dense forward, and Qwen2-1.5B
    and recurrentgemma-9b (3 layers) tensor parallel on (1, 2): every
    comparison of chip_smoke.mesh_rank within MESH_TOL."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import json
    import torch.multiprocessing as mp
    mp.spawn(chip_smoke.mesh_rank, args=(2, str(tmp_path), 0), nprocs=2)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert {r["device"] for r in ranks} == {"cuda:0", "cuda:1"}
    assert all(r["moe"]["experts_per_card"] == 32 for r in ranks)
    r0 = ranks[0]
    assert "logit_rel" in r0["moe"]
    assert r0["train_vs_one_card"]["ok"] and r0["raw_init_vs_one_card"]["ok"]
    for key in ("tp_qwen2", "tp_recurrentgemma"):
        assert r0[key]["train_vs_one_card"]["ok"], r0[key]["train_vs_one_card"]
        assert r0[key]["serve_vs_one_card"]["ok"], r0[key]["serve_vs_one_card"]


@pytest.mark.cuda
def test_cuda_two_card_tensor_parallel_reduced(tmp_path):
    """Reduced Qwen2 (float32) tensor parallel on (1, 2) NCCL ranks, one a
    card: two train steps and a prefill with three greedy decode steps
    against one card, within torch_mesh_ranks.TP_CARDS_TOL (float32
    bounds; greedy tokens equal)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import json
    import torch.multiprocessing as mp
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_mesh_ranks
    mp.spawn(torch_mesh_ranks.tp_cards, args=(2, str(tmp_path)), nprocs=2)
    rec = json.loads((tmp_path / "tp_cards.json").read_text())
    assert rec["train_vs_one_card"]["ok"], rec["train_vs_one_card"]
    assert rec["serve_vs_one_card"]["ok"], rec["serve_vs_one_card"]
    assert rec["train"]["mesh"] == [1, 2] and rec["train"]["sharded_leaves"] > 0


def test_lm_entry_points_need_a_card(monkeypatch):
    """Without a card, init_params, init_caches, concrete_batch and the
    weight carrier raise unless the caller asks for the CPU."""
    from repro_torch import convert
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.registry import ShapeSpec, concrete_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import init_caches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(ARCHS["qwen2_1_5b"])
    spec = ShapeSpec("t", "prefill", 8, 2)
    for call in (lambda: init_params(cfg), lambda: init_caches(cfg, 2, 8),
                 lambda: concrete_batch(cfg, spec),
                 lambda: convert.lm_caches_from_tree(cfg, {"body": []})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = init_params(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert init_caches(cfg, 2, 8, device="cpu")[0]["k"].device.type == "cpu"
    assert concrete_batch(cfg, spec, device="cpu")["tokens"].device.type == "cpu"
