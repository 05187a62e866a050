"""The one-partition device budget on the CPU: ``cache_parts=1`` with the
runner-up prefetch on, the paper's OPAT with memory for one partition.

While a partition is staged, at most one other partition's store entry
is alive (two with the one being staged), in the shared scheduler and in
``OPATEngine.run``: each round drops its entry once it is done, so the
entry the store evicts at the round's unpin is not held through the next
load.  A traced store records each LRU eviction as ``store.evict``
(``unread`` on a prefetch no load used), and each ``scheduler.round``
the ``tier`` and ``nbytes`` of its load.
"""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc
from repro_torch.data.generators import imdb_like_graph, imdb_queries
from repro_torch.obs import Tracer

CAP = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes at once).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    g = imdb_like_graph(seed=3)
    return g, imdb_queries(g, seed=3)


def _session(graph, tracer=None, cache_parts=1):
    g, _ = graph
    return tc.GraphSession(g, k=4, engine="opat", cache_parts=cache_parts, prefetch=True,
                           seed=1, config=tc.EngineConfig(cap=CAP), device="cpu",
                           tracer=tracer)


def _watch(store):
    """Weak references to every entry the store stages; for each staging,
    how many entries staged before it are still alive."""
    refs, alive = [], []
    real = store._stage

    def stage(pid, side_stream):
        alive.append(sum(r() is not None for r in refs))
        entry = real(pid, side_stream)
        refs.append(weakref.ref(entry))
        return entry
    store._stage = stage
    return alive


def _serve(sess, queries, path):
    """The queries, each twice, through the shared scheduler
    (``submit_many``) or one ``OPATEngine.run`` after another
    (``submit``); their answers in order."""
    qs = list(queries) * 2
    if path == "shared":
        return [r.answers for r in sess.submit_many(qs).results]
    return [sess.submit(q).answers for q in qs]


def _guess_wrong(store, k=4):
    """Stage the partition after the runner-up instead: a guess the next
    round may not use, so its load is cold and the guess is evicted
    unread, as on a graph where the heuristic's runner-up is often
    passed over."""
    real = store.prefetch
    store.prefetch = lambda pid: real((int(pid) + 1) % k)


@pytest.mark.parametrize("guess", ["runner_up", "wrong"])
@pytest.mark.parametrize("path", ["shared", "opat"])
def test_at_most_two_entries_alive(graph, path, guess):
    sess = _session(graph)
    alive = _watch(sess.store)
    if guess == "wrong":
        _guess_wrong(sess.store)
    got = _serve(sess, graph[1], path)
    stats = sess.store.stats
    assert stats.misses >= (3 if guess == "wrong" else 1)
    assert stats.evictions >= 2 and stats.prefetch_issued >= 2
    assert len(alive) >= 3 and max(alive) <= 1, alive
    want = _serve(_session(graph, cache_parts=None), graph[1], path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_evict_events_and_unread(graph):
    """An entry read and then evicted, then a prefetch evicted unread."""
    sess = _session(graph, tracer=Tracer())
    store = sess.store
    store.get(0)
    with store.pinned(0):
        assert store.prefetch(1)
    store.get(2)
    got = [(sp.attrs["pid"], sp.attrs["nbytes"], sp.attrs["unread"])
           for sp in sess.tracer.spans if sp.name == "store.evict"]
    assert got == [(0, store.host_nbytes(0), False), (1, store.host_nbytes(1), True)]
    assert store.resident_keys() == [2] and store.stats.evictions == 2


def test_round_tier_and_nbytes(graph):
    """Each traced round names its load's tier, that of the
    ``store.load`` inside it, and the partition's bytes; the evictions
    match the store's count."""
    sess = _session(graph, tracer=Tracer())
    _serve(sess, graph[1], "shared")
    spans = sess.tracer.spans
    loads = {sp.parent_id: sp for sp in spans if sp.name == "store.load"}
    rounds = [sp for sp in spans if sp.name == "scheduler.round"]
    assert rounds
    for sp in rounds:
        assert sp.attrs["tier"] == loads[sp.span_id].attrs["tier"]
        assert sp.attrs["nbytes"] == sess.store.host_nbytes(sp.attrs["pid"])
    assert {"cold", "prefetch"} <= {sp.attrs["tier"] for sp in rounds}
    evicts = [sp for sp in spans if sp.name == "store.evict"]
    assert len(evicts) == sess.store.stats.evictions > 0
    # every prefetch is read, evicted unread, or still resident unread
    stats = sess.store.stats
    unread_now = sum(e.prefetched for e in sess.store._cache.values())
    assert sum(sp.attrs["unread"] for sp in evicts) \
        == stats.prefetch_issued - stats.prefetch_hits - unread_now
