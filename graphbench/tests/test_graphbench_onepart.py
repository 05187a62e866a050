"""The one-partition deployment (``imdb-74k-k4-onepart``) on the CPU at a
small size, and the readers of its store metrics on a hand-built window.

A traced run through ``run.run_cell`` serves every request correctly,
with cold loads and evictions; the same requests on an all-resident
session give the same answers; each new reader returns its number on a
window with known spans and device intervals, and nothing from a program
without the spans or from a run on the CPU."""
import dataclasses
from typing import Optional

import numpy as np
import pytest
import torch

from graphbench import bench, datasets, h2d, run, serve, traffic

CELL = "imdb-74k-k4-onepart.batch32"
# the configuration's scale cut to a CPU test's size, as conftest.SMALL
# cuts imdb-74k-k4
SMALL = {"n_movies": 300, "n_people": 400, "n_companies": 40}
SEED = 2**31 + 23
CPU = torch.device("cpu")
NEW = ["cold_loads_per_query.onepart", "prefetch_hit_pct.onepart",
       "h2d_roofline.onepart", "copy_exposed_pct.onepart"]


def small_config(**changes) -> dict:
    cfg = bench.load_config("imdb-74k-k4-onepart")
    cfg.update(SMALL, **changes)
    return cfg


@pytest.fixture(scope="module")
def traced():
    """One traced run of the cell, with the context its readers got."""
    b = bench.load_benchmark()
    got = {}
    real = bench.metric_reader

    def keeping(name):
        read = real(name)

        def reading(ctx):
            got["ctx"] = ctx
            return read(ctx)
        return reading
    bench.metric_reader = keeping
    try:
        res = run.run_cell(small_config(), bench.load_traffic("batch32"), SEED, 0.5, True,
                           CPU, b, CELL)
    finally:
        bench.metric_reader = real
    return res, got["ctx"]


def test_requests_correct(traced):
    res, _ = traced
    assert res["correct"] and res["attempted"] >= 32 and res["attempted"] % 32 == 0
    assert res["checks"]["wrong_answer_sets"]["value"] == 0
    assert res["checks"]["unserved_requests"]["value"] == 0
    # on the CPU only the host's counters and spans that need no card
    assert set(res["metrics"]) == {"loads_per_query.onepart", "round_ms.onepart"}


def test_cold_loads_and_evictions(traced):
    _, ctx = traced
    served, spans = ctx["served"], ctx["spans"]
    inside = [sp for sp in spans if served.t0 <= sp.t0 and sp.t1 <= served.t1]
    assert sum(sp.name == "store.load" and sp.attrs["tier"] == "cold" for sp in inside) > 0
    assert sum(sp.name == "store.evict" for sp in inside) > 0
    assert served.loads > 0


def test_answers_equal_all_resident(traced):
    """The window's batches, after the same warm-up, on a session that
    holds every partition (``cache_parts`` null)."""
    _, ctx = traced
    served = ctx["served"]
    cfg = small_config(cache_parts=None)
    gen = datasets.generator(cfg["generator"])
    g = gen.make(cfg, SEED)
    session = serve.build_session(cfg, serve.port_graph(g), CPU)
    front = serve.Frontend(session, cfg, 0.0)
    mix = bench.load_traffic("batch32")
    front.serve(traffic.warmup_requests(mix, cfg, gen, g, SEED), serve.Served())
    out = serve.Served()
    for lo in range(0, len(served.requests), 32):
        front.serve(served.requests[lo:lo + 32], out)
    assert out.requests == served.requests
    for a, b in zip(out.answers, served.answers):
        np.testing.assert_array_equal(a, b)


# -- the readers on a hand-built window --------------------------------------

BASE = 1_760_000_000 * 10**9
PINNED = "Memcpy HtoD (Pinned -> Device)"


@dataclasses.dataclass
class Sp:
    name: str
    t0: float
    t1: float
    attrs: dict = dataclasses.field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None


@dataclasses.dataclass
class Served:
    t0: float
    t1: float
    completed: int


def ns(t: float) -> int:
    """A time in the window (seconds from 100) on the profiler's clock."""
    return BASE + round((t - 100.0) * 1e9)


def window():
    """A window of [100, 110] s with 4 queries completed.

    Loads inside it: two cold of 32 GB, one served by a prefetch, one
    warm; two prefetches of 32 GB.  A cold load and a prefetch after it
    are left out.  The card: pinned copies over [101, 103], [102, 104] and
    [108, 109], a pageable one over [105, 106]; kernels over [103, 105]
    and [108.5, 108.7]."""
    gb = 32 * 10**9
    s = [Sp("store.load", 101.0, 101.1, {"pid": 0, "tier": "cold", "nbytes": gb}),
         Sp("store.prefetch", 101.1, 101.2, {"pid": 1, "nbytes": gb}),
         Sp("store.load", 102.0, 102.1, {"pid": 1, "tier": "prefetch"}),
         Sp("store.prefetch", 102.1, 102.2, {"pid": 2, "nbytes": gb}),
         Sp("store.load", 103.0, 103.1, {"pid": 3, "tier": "cold", "nbytes": gb}),
         Sp("store.evict", 103.1, 103.1, {"pid": 2, "nbytes": gb, "unread": True}),
         Sp("store.load", 104.0, 104.1, {"pid": 3, "tier": "warm"}),
         Sp("store.load", 110.5, 110.6, {"pid": 0, "tier": "cold", "nbytes": gb}),
         Sp("store.prefetch", 110.6, 110.7, {"pid": 1, "nbytes": gb})]
    ev = [(PINNED, ns(101.0), 2 * 10**9, 7), (PINNED, ns(102.0), 2 * 10**9, 8),
          ("Memcpy HtoD (Pageable -> Device)", ns(105.0), 10**9, 7),
          ("frontier_step_kernel", ns(103.0), 2 * 10**9, 7),
          (PINNED, ns(108.0), 10**9, 8),
          ("frontier_append_kernel", ns(108.5), 2 * 10**8, 7)]
    sl = {"device": True, "side_stream": 9, "t0": 100.0, "t1": 110.0,
          "t0_ns": ns(100.0), "t1_ns": ns(110.0), "events": ev}
    return {"served": Served(100.0, 110.0, 4), "spans": s, "slice": sl, "cfg": {}}


@pytest.mark.parametrize("name, want", [
    # two cold loads over four queries
    ("cold_loads_per_query.onepart", 0.5),
    # one load served by a prefetch of the two issued
    ("prefetch_hit_pct.onepart", 50.0),
    # four copies of 32 GB take 2 s at 64 GB/s; the pinned copies cover
    # [101, 104] and [108, 109], 4 s
    ("h2d_roofline.onepart", 50.0),
    # copies with no kernel: [101, 103], [108, 108.5], [108.7, 109] = 2.8 s of 10
    ("copy_exposed_pct.onepart", 28.0),
])
def test_reader_on_known_window(name, want):
    assert bench.metric_reader(name)(window()) == pytest.approx(want, rel=1e-9)


def test_peak_and_copy_names():
    assert h2d.PEAK_BYTES_S == 64e9 and h2d.bound_s(128 * 10**9) == 2.0
    assert h2d.is_pinned_h2d(PINNED)
    assert not h2d.is_pinned_h2d("Memcpy HtoD (Pageable -> Device)")
    assert not h2d.is_pinned_h2d("Memcpy DtoH (Device -> Pinned)")


@pytest.mark.parametrize("name", NEW[:3])
def test_program_without_spans_reads_nothing(name):
    """A program whose loads carry no tier or bytes, and one with no store
    spans at all, leave the span readers out without raising."""
    bare = window()
    bare["spans"] = [Sp(sp.name, sp.t0, sp.t1, {"pid": sp.attrs["pid"]})
                     for sp in bare["spans"] if sp.name == "store.load"]
    assert bench.metric_reader(name)(bare) is None
    bare["spans"] = []
    assert bench.metric_reader(name)(bare) is None


@pytest.mark.parametrize("name", NEW)
def test_cpu_reads_nothing(name):
    cpu = window()
    cpu["slice"] = dict(cpu["slice"], device=False)
    assert bench.metric_reader(name)(cpu) is None


def test_onepart_metrics_in_the_new_cell_only():
    b = bench.load_benchmark()
    names = {m["name"] for m in bench.cell_metrics(b, CELL, "per_layer")}
    assert names == set(NEW) | {"loads_per_query.onepart", "round_ms.onepart",
                                "device_idle_pct.onepart"}
    for cell in ("subgen-400k-k4.batch32", "imdb-74k-k4.batch32"):
        assert not any(m["name"].endswith(".onepart")
                       for m in bench.cell_metrics(b, cell, "per_layer"))
    cfg = bench.load_config("imdb-74k-k4-onepart")
    base = bench.load_config("imdb-74k-k4")
    differ = {k for k in set(cfg) | set(base) if cfg.get(k) != base.get(k)}
    assert differ == {"name", "source", "deployment", "assumed", "cache_parts"}
    assert cfg["cache_parts"] == 1 and cfg["prefetch"] is True
