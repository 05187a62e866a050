"""Multilevel graph partitioning (METIS / KaHIP stand-ins).

The paper partitions with two external systems (METIS, KaHIP) in six named
configurations.  Those binaries are not available offline, so we implement a
faithful multilevel scheme — coarsen / initial-partition / uncoarsen+refine —
with the same knobs the paper varies:

  coarsening  : 'shem' (sorted heavy-edge matching, METIS-style) or
                'lp'   (label-propagation clustering, KaHIP *social-variant*)
  initial     : 'kway' (greedy k-region growing) or
                'rb'   (recursive bisection)
  refinement  : #boundary-FM rounds ('fast'=1, default=2, 'eco'=3)

The six paper schemes map onto these knobs in SCHEMES below.  The partitioner
is deliberately host-side numpy — partitioning is offline preprocessing in
the paper's pipeline too (Fig. 3's unshaded modules).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import Graph


@dataclasses.dataclass(frozen=True)
class PartitionScheme:
    name: str
    coarsening: str          # 'shem' | 'lp'
    initial: str             # 'kway' | 'rb'
    refine_rounds: int
    imbalance: float = 0.06  # allowed deviation from perfect balance
    seed: int = 0


SCHEMES: Dict[str, PartitionScheme] = {
    # METIS configurations used in the paper (Sec. 3)
    "kway_shem": PartitionScheme("kway_shem", "shem", "kway", 2, seed=11),
    "rb_shem": PartitionScheme("rb_shem", "shem", "rb", 2, seed=12),
    # KaHIP configurations used in the paper
    "fast": PartitionScheme("fast", "shem", "kway", 1, seed=13),
    "eco": PartitionScheme("eco", "shem", "kway", 3, seed=14),
    "fastsocial": PartitionScheme("fastsocial", "lp", "kway", 1, seed=15),
    "ecosocial": PartitionScheme("ecosocial", "lp", "kway", 3, seed=16),
}


# ---------------------------------------------------------------------------
# CSR helpers on (possibly weighted) host graphs
# ---------------------------------------------------------------------------

def _sym_csr(n: int, src: np.ndarray, dst: np.ndarray,
             w: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if w is None:
        w = np.ones(src.shape[0], dtype=np.int64)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    ww = np.concatenate([w, w])
    order = np.argsort(s, kind="stable")
    s, d, ww = s[order], d[order], ww[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, s + 1, 1)
    return np.cumsum(ptr), d.astype(np.int64), ww.astype(np.int64)


def _edge_cut(assign: np.ndarray, src: np.ndarray, dst: np.ndarray,
              w: Optional[np.ndarray] = None) -> int:
    cut = assign[src] != assign[dst]
    if w is None:
        return int(cut.sum())
    return int(w[cut].sum())


# ---------------------------------------------------------------------------
# Coarsening
# ---------------------------------------------------------------------------

def _match_shem(n: int, ptr, adj, w, vwgt, rng) -> np.ndarray:
    """Sorted heavy-edge matching: visit vertices in ascending-degree order,
    match each unmatched vertex with its heaviest-edge unmatched neighbour."""
    deg = np.diff(ptr)
    order = np.argsort(deg, kind="stable")
    match = np.full(n, -1, dtype=np.int64)
    for v in order:
        if match[v] != -1:
            continue
        best, best_w = -1, -1
        for idx in range(ptr[v], ptr[v + 1]):
            u = adj[idx]
            if u != v and match[u] == -1 and w[idx] > best_w:
                best, best_w = u, w[idx]
        if best == -1:
            match[v] = v
        else:
            match[v] = best
            match[best] = v
    return match


def _match_lp(n: int, ptr, adj, w, vwgt, rng, rounds: int = 2) -> np.ndarray:
    """Label-propagation clustering (size-constrained) — the coarsening used
    by KaHIP's *social* configurations for social-network-like graphs."""
    label = np.arange(n, dtype=np.int64)
    max_cluster = max(2, int(np.ceil(vwgt.sum() / max(1, n // 16))))
    csize = vwgt.astype(np.int64).copy()
    for _ in range(rounds):
        order = rng.permutation(n)
        for v in order:
            s, e = ptr[v], ptr[v + 1]
            if s == e:
                continue
            neigh = label[adj[s:e]]
            # accumulate edge weight toward each neighbouring label
            uniq, inv = np.unique(neigh, return_inverse=True)
            score = np.zeros(uniq.shape[0], dtype=np.int64)
            np.add.at(score, inv, w[s:e])
            # respect the size constraint so coarsening stays balanced
            ok = csize[uniq] + vwgt[v] <= max_cluster
            ok |= uniq == label[v]
            if not ok.any():
                continue
            score = np.where(ok, score, -1)
            tgt = int(uniq[int(np.argmax(score))])
            if tgt != label[v]:
                csize[label[v]] -= vwgt[v]
                csize[tgt] += vwgt[v]
                label[v] = tgt
    return label


def _contract(n: int, src, dst, w, vwgt, cluster_of) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    uniq, new_of = np.unique(cluster_of, return_inverse=True)
    cn = uniq.shape[0]
    cvw = np.zeros(cn, dtype=np.int64)
    np.add.at(cvw, new_of, vwgt)
    cs, cd = new_of[src], new_of[dst]
    keep = cs != cd
    cs, cd, cw = cs[keep], cd[keep], w[keep]
    # merge parallel edges
    lo, hi = np.minimum(cs, cd), np.maximum(cs, cd)
    key = lo * cn + hi
    uk, inv = np.unique(key, return_inverse=True)
    mw = np.zeros(uk.shape[0], dtype=np.int64)
    np.add.at(mw, inv, cw)
    return cn, (uk // cn).astype(np.int64), (uk % cn).astype(np.int64), mw, cvw, new_of


# ---------------------------------------------------------------------------
# Initial partitioning
# ---------------------------------------------------------------------------

def _greedy_grow_kway(n, ptr, adj, w, vwgt, k, rng, imbalance) -> np.ndarray:
    """Greedy k-region growing from spread-out seeds (METIS kway flavor)."""
    target = vwgt.sum() / k
    cap = target * (1.0 + imbalance)
    assign = np.full(n, -1, dtype=np.int64)
    sizes = np.zeros(k, dtype=np.int64)
    deg = np.diff(ptr)
    seeds = list(np.argsort(-deg)[: 4 * k])
    rng.shuffle(seeds)
    frontiers: List[List[int]] = [[] for _ in range(k)]
    si = 0
    for p in range(k):
        while si < len(seeds) and assign[seeds[si]] != -1:
            si += 1
        s = seeds[si] if si < len(seeds) else int(np.argmax(assign == -1))
        assign[s] = p
        sizes[p] += vwgt[s]
        frontiers[p].append(int(s))
    active = True
    while active:
        active = False
        for p in np.argsort(sizes):  # grow smallest region first
            f = frontiers[p]
            grew = False
            while f and not grew:
                v = f.pop()
                for idx in range(ptr[v], ptr[v + 1]):
                    u = int(adj[idx])
                    if assign[u] == -1 and sizes[p] + vwgt[u] <= cap:
                        assign[u] = p
                        sizes[p] += vwgt[u]
                        f.append(u)
                        grew = True
                        active = True
        if not active:
            break
    # orphans (disconnected leftovers) -> smallest partition
    for v in np.where(assign == -1)[0]:
        p = int(np.argmin(sizes))
        assign[v] = p
        sizes[p] += vwgt[v]
    return assign


def _bisect(n, ptr, adj, w, vwgt, rng, imbalance) -> np.ndarray:
    """Greedy BFS bisection + one FM sweep (building block of 'rb')."""
    total = vwgt.sum()
    half = total / 2.0
    deg = np.diff(ptr)
    seed = int(np.argmax(deg)) if n else 0
    side = np.ones(n, dtype=np.int64)
    size0 = 0
    queue = [seed]
    seen = np.zeros(n, dtype=bool)
    seen[seed] = True
    while queue and size0 < half:
        v = queue.pop(0)
        side[v] = 0
        size0 += vwgt[v]
        for idx in range(ptr[v], ptr[v + 1]):
            u = int(adj[idx])
            if not seen[u]:
                seen[u] = True
                queue.append(u)
    return side


def _initial_rb(n, ptr, adj, w, vwgt, k, rng, imbalance, src, dst) -> np.ndarray:
    """Recursive bisection down to k parts (requires k power-of-two-ish;
    uneven k splits proportionally)."""
    assign = np.zeros(n, dtype=np.int64)

    def rec(nodes: np.ndarray, lo: int, hi: int) -> None:
        if hi - lo <= 1 or nodes.size == 0:
            assign[nodes] = lo
            return
        mid = (lo + hi) // 2
        # build the induced subgraph
        remap = np.full(n, -1, dtype=np.int64)
        remap[nodes] = np.arange(nodes.size)
        mask = (remap[src] >= 0) & (remap[dst] >= 0)
        ssrc, sdst, sw = remap[src[mask]], remap[dst[mask]], w[mask]
        sptr, sadj, sww = _sym_csr(nodes.size, ssrc, sdst, sw)
        side = _bisect(nodes.size, sptr, sadj, sww, vwgt[nodes], rng, imbalance)
        rec(nodes[side == 0], lo, mid)
        rec(nodes[side == 1], mid, hi)

    rec(np.arange(n, dtype=np.int64), 0, k)
    return assign


# ---------------------------------------------------------------------------
# Refinement: boundary FM (gain-based moves under a balance constraint)
# ---------------------------------------------------------------------------

def _refine_fm(n, ptr, adj, w, vwgt, assign, k, rounds, imbalance) -> np.ndarray:
    target = vwgt.sum() / k
    cap = target * (1.0 + imbalance)
    sizes = np.zeros(k, dtype=np.int64)
    np.add.at(sizes, assign, vwgt)
    for _ in range(rounds):
        moved = 0
        for v in range(n):
            s, e = ptr[v], ptr[v + 1]
            if s == e:
                continue
            me = assign[v]
            neigh = assign[adj[s:e]]
            if (neigh == me).all():
                continue  # interior vertex
            uniq, inv = np.unique(neigh, return_inverse=True)
            gain_to = np.zeros(uniq.shape[0], dtype=np.int64)
            np.add.at(gain_to, inv, w[s:e])
            internal = gain_to[uniq == me].sum() if (uniq == me).any() else 0
            best_gain, best_p = 0, -1
            for ui, p in enumerate(uniq):
                if p == me:
                    continue
                if sizes[p] + vwgt[v] > cap:
                    continue
                g = gain_to[ui] - internal
                if g > best_gain:
                    best_gain, best_p = g, int(p)
            if best_p >= 0:
                sizes[me] -= vwgt[v]
                sizes[best_p] += vwgt[v]
                assign[v] = best_p
                moved += 1
        if moved == 0:
            break
    return assign


# ---------------------------------------------------------------------------
# Multilevel driver
# ---------------------------------------------------------------------------

def partition_graph(graph: Graph, k: int, scheme: str | PartitionScheme,
                    seed: Optional[int] = None,
                    edge_weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Partition ``graph`` into ``k`` parts; returns [V] assignment array.

    ``edge_weights`` (optional, [E] ints >= 1 aligned with ``graph.edge_src``)
    biases every phase — heavy edges are matched first during coarsening,
    resist the cut during initial partitioning, and dominate FM gains — which
    is how workload-aware repartitioning (core/repartition.py) steers the
    same multilevel machinery with observed traffic instead of topology
    alone.  ``None`` keeps the paper's unweighted behaviour bit-for-bit.
    """
    sch = SCHEMES[scheme] if isinstance(scheme, str) else scheme
    rng = np.random.default_rng(sch.seed if seed is None else seed)
    n = graph.n_nodes
    if k <= 1 or n <= k:
        return np.minimum(np.arange(n, dtype=np.int64), k - 1).astype(np.int32)

    src = graph.edge_src.astype(np.int64)
    dst = graph.edge_dst.astype(np.int64)
    if edge_weights is None:
        w = np.ones(src.shape[0], dtype=np.int64)
    else:
        w = np.asarray(edge_weights, dtype=np.int64)
        if w.shape != src.shape:
            raise ValueError(f"edge_weights shape {w.shape} != E {src.shape}")
        if w.size and w.min() < 1:
            raise ValueError("edge_weights must be >= 1 (0 would make the "
                             "coarsener blind to the edge)")
    vwgt = np.ones(n, dtype=np.int64)

    # --- coarsening phase ---------------------------------------------------
    levels: List[np.ndarray] = []   # new_of maps at each level
    cn, cs, cd, cw, cvw = n, src, dst, w, vwgt
    coarsen_target = max(30 * k, 64)
    while cn > coarsen_target:
        ptr, adj, ww = _sym_csr(cn, cs, cd, cw)
        if sch.coarsening == "lp":
            cluster = _match_lp(cn, ptr, adj, ww, cvw, rng)
        else:
            match = _match_shem(cn, ptr, adj, ww, cvw, rng)
            cluster = np.minimum(np.arange(cn, dtype=np.int64), match)
        nn, ns, nd, nw, nvw, new_of = _contract(cn, cs, cd, cw, cvw, cluster)
        if nn >= cn * 0.95:  # matching stalled; stop coarsening
            break
        levels.append(new_of)
        cn, cs, cd, cw, cvw = nn, ns, nd, nw, nvw

    # --- initial partitioning -------------------------------------------------
    ptr, adj, ww = _sym_csr(cn, cs, cd, cw)
    if sch.initial == "rb":
        # NB: pass cw (edge-aligned weights), not ww (symmetrized CSR order)
        assign = _initial_rb(cn, ptr, adj, cw, cvw, k, rng, sch.imbalance, cs, cd)
    else:
        assign = _greedy_grow_kway(cn, ptr, adj, ww, cvw, k, rng, sch.imbalance)
    assign = _refine_fm(cn, ptr, adj, ww, cvw, assign, k, sch.refine_rounds, sch.imbalance)

    # --- uncoarsen + refine ---------------------------------------------------
    for li in range(len(levels) - 1, -1, -1):
        assign = assign[levels[li]]          # project onto the finer level
        # rebuild the level-li graph by re-contracting from the finest level
        ls, ld, lw, lvw = src, dst, w, vwgt
        for m in levels[:li]:
            _, ls, ld, lw, lvw, _ = _contract(lvw.shape[0], ls, ld, lw, lvw, m)
        lvl_n = lvw.shape[0]
        ptr, adj, ww = _sym_csr(lvl_n, ls, ld, lw)
        assign = _refine_fm(lvl_n, ptr, adj, ww, lvw, assign, k,
                            sch.refine_rounds, sch.imbalance)

    return assign.astype(np.int32)


def partition_quality(graph: Graph, assign: np.ndarray, k: int) -> dict:
    sizes = np.bincount(assign, minlength=k)
    cut = _edge_cut(assign, graph.edge_src, graph.edge_dst)
    return {
        "cut": cut,
        "cut_frac": cut / max(1, graph.n_edges),
        "sizes": sizes.tolist(),
        "imbalance": float(sizes.max() / max(1.0, graph.n_nodes / k) - 1.0),
    }
