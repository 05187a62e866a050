"""Graph representation for PGQP-JAX.

The paper (Das et al., 2019) uses the Subdue representation: vertices are
<vID, vLabel> pairs, edges are <dir, s_vID, d_vID, eLabel> tuples, and the
partitioned representation adds a partition id (pID) per vertex plus the
one-edge cut-set extension replicated into each partition (Fig. 1b/1c).

Host side we keep a numpy ``Graph``; each partition is converted into a
fixed-shape, padded ``PartitionArrays`` bundle (CSR + ELLPACK adjacency)
that a single jitted evaluator can consume for *any* partition of the same
padded geometry — this is what lets OPAT / TraditionalMP / MapReduceMP share
one compiled program.

TPU adaptation note (see DESIGN.md): the adjacency is carried both as CSR
(reference/jnp path) and as ELLPACK (dense [n_nodes_padded, ell_width] edge
tiles).  ELLPACK trades padding for perfectly regular, vectorizable access —
the classic vector-machine sparse format — and is what the Pallas
``frontier_expand`` kernel tiles into VMEM.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

WILDCARD = -1  # label id for "?" wildcards in queries
NO_VALUE = np.float32(np.nan)

# edge direction encoding (paper supports directed + undirected edges)
DIR_UNDIRECTED = 0
DIR_FORWARD = 1   # stored edge goes src -> dst
DIR_BACKWARD = 2  # stored edge is the reverse view of a directed edge


class LabelVocab:
    """Interns string labels to dense int32 ids (separate node/edge spaces)."""

    def __init__(self) -> None:
        self._to_id: Dict[str, int] = {}
        self._to_str: List[str] = []

    def intern(self, label: str) -> int:
        got = self._to_id.get(label)
        if got is not None:
            return got
        new_id = len(self._to_str)
        self._to_id[label] = new_id
        self._to_str.append(label)
        return new_id

    def id_of(self, label: str) -> int:
        if label == "?":
            return WILDCARD
        return self._to_id[label]

    def get(self, label: str, default: int = WILDCARD) -> int:
        return self._to_id.get(label, default)

    def str_of(self, label_id: int) -> str:
        return "?" if label_id == WILDCARD else self._to_str[label_id]

    def __len__(self) -> int:
        return len(self._to_str)

    def __contains__(self, label: str) -> bool:
        return label in self._to_id


@dataclasses.dataclass
class Graph:
    """Whole-graph host representation (Subdue-style)."""

    n_nodes: int
    node_label: np.ndarray        # [V] int32
    node_value: np.ndarray        # [V] float32 (NaN when the node has no numeric value)
    edge_src: np.ndarray          # [E] int32
    edge_dst: np.ndarray          # [E] int32
    edge_label: np.ndarray        # [E] int32
    edge_directed: np.ndarray     # [E] bool
    node_vocab: LabelVocab
    edge_vocab: LabelVocab

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])

    def degree_view(self) -> np.ndarray:
        """Out-degree in the symmetrized adjacency (each undirected edge counts
        from both endpoints; each directed edge contributes a forward and a
        backward slot so that plans may traverse either direction)."""
        deg = np.zeros(self.n_nodes, dtype=np.int64)
        np.add.at(deg, self.edge_src, 1)
        np.add.at(deg, self.edge_dst, 1)
        return deg

    def validate(self) -> None:
        assert self.node_label.shape == (self.n_nodes,)
        assert self.node_value.shape == (self.n_nodes,)
        e = self.n_edges
        for arr in (self.edge_dst, self.edge_label, self.edge_directed):
            assert arr.shape == (e,)
        if e:
            assert self.edge_src.min() >= 0 and self.edge_src.max() < self.n_nodes
            assert self.edge_dst.min() >= 0 and self.edge_dst.max() < self.n_nodes


class GraphBuilder:
    """Convenience builder used by data generators and tests."""

    def __init__(self) -> None:
        self.node_vocab = LabelVocab()
        self.edge_vocab = LabelVocab()
        self._labels: List[int] = []
        self._values: List[float] = []
        self._src: List[int] = []
        self._dst: List[int] = []
        self._elabel: List[int] = []
        self._edir: List[bool] = []

    def add_node(self, label: str, value: Optional[float] = None) -> int:
        vid = len(self._labels)
        self._labels.append(self.node_vocab.intern(label))
        self._values.append(float("nan") if value is None else float(value))
        return vid

    def add_edge(self, src: int, dst: int, label: str, directed: bool = False) -> int:
        eid = len(self._src)
        self._src.append(src)
        self._dst.append(dst)
        self._elabel.append(self.edge_vocab.intern(label))
        self._edir.append(directed)
        return eid

    def build(self) -> Graph:
        g = Graph(
            n_nodes=len(self._labels),
            node_label=np.asarray(self._labels, dtype=np.int32),
            node_value=np.asarray(self._values, dtype=np.float32),
            edge_src=np.asarray(self._src, dtype=np.int32),
            edge_dst=np.asarray(self._dst, dtype=np.int32),
            edge_label=np.asarray(self._elabel, dtype=np.int32),
            edge_directed=np.asarray(self._edir, dtype=bool),
            node_vocab=self.node_vocab,
            edge_vocab=self.edge_vocab,
        )
        g.validate()
        return g


# ---------------------------------------------------------------------------
# Partitioned representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PartitionArrays:
    """One partition, padded to a uniform geometry shared by all partitions.

    Node order: the ``n_core`` owned nodes first, then ghost (cut-set) nodes,
    then padding.  Ghost nodes carry label/value/owner so predicates on a
    continuation node evaluate locally — exactly the paper's "one edge cut
    set information ... added to each partition" (Sec. 4.2).
    """

    pid: int
    n_core: int
    n_nodes: int                  # core + ghosts (<= padded size)
    node_gid: np.ndarray          # [Np] int32 global vertex id (-1 padding)
    node_label: np.ndarray        # [Np] int32 (-2 padding)
    node_value: np.ndarray        # [Np] float32
    node_owner: np.ndarray        # [Np] int32 owning partition id (-1 padding)
    # CSR over local node ids; only core nodes have adjacency.
    row_ptr: np.ndarray           # [Np + 1] int32
    edge_dst: np.ndarray          # [Ep] int32 local dst (-1 padding)
    edge_label: np.ndarray        # [Ep] int32
    edge_dir: np.ndarray          # [Ep] int32 (DIR_* from the traversal's view)
    # ELLPACK view (built lazily by to_ell) for the Pallas kernel path.
    # Destination-node attributes are DENORMALIZED into the edge tables
    # (ell_dlab/ell_dval/ell_dgid) so the frontier_expand kernel is fully
    # elementwise after one scalar-prefetch row gather — no data-dependent
    # gathers inside the kernel (TPU adaptation; see DESIGN.md).
    ell_width: int = 0
    ell_dst: Optional[np.ndarray] = None      # [Np, W] int32 local dst (-1 pad)
    ell_label: Optional[np.ndarray] = None    # [Np, W] int32
    ell_dir: Optional[np.ndarray] = None      # [Np, W] int32
    ell_dlab: Optional[np.ndarray] = None     # [Np, W] int32 dst node label
    ell_dval: Optional[np.ndarray] = None     # [Np, W] float32 dst node value
    ell_dgid: Optional[np.ndarray] = None     # [Np, W] int32 dst global id

    @property
    def n_ghost(self) -> int:
        return self.n_nodes - self.n_core

    def max_degree(self) -> int:
        deg = np.diff(self.row_ptr[: self.n_nodes + 1])
        return int(deg.max()) if deg.size else 0

    def to_ell(self, width: Optional[int] = None) -> None:
        """Build the ELLPACK adjacency (dense [Np, W] tiles; see module doc)."""
        w = int(width if width is not None else max(1, self.max_degree()))
        npad = self.node_gid.shape[0]
        dst = np.full((npad, w), -1, dtype=np.int32)
        lab = np.full((npad, w), -2, dtype=np.int32)
        dire = np.zeros((npad, w), dtype=np.int32)
        for v in range(self.n_nodes):
            s, e = int(self.row_ptr[v]), int(self.row_ptr[v + 1])
            d = min(e - s, w)
            dst[v, :d] = self.edge_dst[s : s + d]
            lab[v, :d] = self.edge_label[s : s + d]
            dire[v, :d] = self.edge_dir[s : s + d]
        self.ell_width = w
        self.ell_dst, self.ell_label, self.ell_dir = dst, lab, dire
        # denormalized destination-node attributes (see field comment)
        dsafe = np.clip(dst, 0, npad - 1)
        self.ell_dlab = np.where(dst >= 0, self.node_label[dsafe], -2).astype(np.int32)
        self.ell_dval = np.where(dst >= 0, self.node_value[dsafe],
                                 np.float32(np.nan)).astype(np.float32)
        self.ell_dgid = np.where(dst >= 0, self.node_gid[dsafe], -1).astype(np.int32)


@dataclasses.dataclass
class PartitionedGraph:
    """k partitions + global ownership/lookup tables.

    ``owner``   : [V] partition owning each global vertex.
    ``g2l``     : [k, V] local index of a global vertex inside a partition
                  (core or ghost), or -1.  For laptop-scale graphs this dense
                  table is cheap; at cluster scale it is sharded over the
                  "part" mesh axis exactly like the partitions themselves
                  (each device needs only its own row).
    """

    graph: Graph
    k: int
    assignment: np.ndarray            # [V] int32 partition of each vertex
    parts: List[PartitionArrays]
    owner: np.ndarray                 # [V] int32 (== assignment; kept for clarity)
    g2l: np.ndarray                   # [k, V] int32
    cut_edges: int
    node_pad: int
    edge_pad: int
    scheme: str = "?"                 # partitioning-scheme name (for RunStats)

    @property
    def ell_width(self) -> int:
        """The uniform ELLPACK width shared by every partition (the jitted
        evaluator's W dimension).  Out-of-core variants override this with
        the manifest value, so engines must read it here, not via
        ``parts[0]``."""
        w = self.parts[0].ell_width
        assert all(p.ell_width == w for p in self.parts), \
            "uniform ELL width required"
        return w

    def start_label_counts(self, label_id: int, value_op: int = 0,
                           value: float = 0.0) -> np.ndarray:
        """#core nodes matching (label, value predicate) per partition — the
        paper's one-pass start-node metric used to seed the SNI file.
        Computed from the whole-graph arrays + the assignment (a core node
        of p is exactly a vertex assigned to p), so it never touches
        ``parts`` — out-of-core graphs rank partitions without any shard
        resident."""
        return start_label_counts_from_arrays(
            self.graph.node_label, self.graph.node_value, self.assignment,
            self.k, label_id, value_op, value)

    def connected_components_per_partition(self) -> np.ndarray:
        """#connected components among each partition's *core* nodes using only
        intra-partition edges (paper Sec. 5.2 metric, computed in the same
        pass as partition construction)."""
        out = np.zeros(self.k, dtype=np.int64)
        for p in self.parts:
            out[p.pid] = _count_components(p)
        return out


def start_label_counts_from_arrays(node_label: np.ndarray,
                                   node_value: np.ndarray,
                                   assignment: np.ndarray, k: int,
                                   label_id: int, value_op: int = 0,
                                   value: float = 0.0) -> np.ndarray:
    """The SNI seed computed from whole-graph arrays alone — one
    implementation shared by ``PartitionedGraph.start_label_counts`` and
    the disk catalog (storage/format.py), so predicate semantics can
    never diverge between the in-RAM and out-of-core ranking paths."""
    from .state import apply_value_op  # local import to avoid cycle
    ok = (np.ones(node_label.shape[0], dtype=bool) if label_id == WILDCARD
          else node_label == label_id)
    if value_op:
        ok = ok & apply_value_op(int(value_op), node_value, float(value))
    return np.bincount(assignment[ok], minlength=k).astype(np.int64)


def _count_components(p: PartitionArrays) -> int:
    n = p.n_core
    if n == 0:
        return 0
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for v in range(n):
        s, e = int(p.row_ptr[v]), int(p.row_ptr[v + 1])
        for idx in range(s, e):
            d = int(p.edge_dst[idx])
            if 0 <= d < n:  # core-to-core edge
                ra, rb = find(v), find(d)
                if ra != rb:
                    parent[ra] = rb
    return int(sum(1 for v in range(n) if find(v) == v))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_partitions(graph: Graph, assignment: np.ndarray, k: int,
                     node_pad_multiple: int = 8,
                     edge_pad_multiple: int = 8,
                     uniform_pad: bool = True,
                     ell: bool = True,
                     ell_width: Optional[int] = None,
                     scheme: str = "?") -> PartitionedGraph:
    """Materialize ``PartitionArrays`` for every partition from a vertex
    assignment, replicating the one-edge cut set (ghost nodes) per Fig. 1.

    All partitions are padded to a shared (node_pad, edge_pad) geometry when
    ``uniform_pad`` so a single jitted evaluator handles every partition.
    ``scheme`` records the partitioning-scheme name that produced
    ``assignment`` so every engine's ``RunStats`` can report it.
    """
    V = graph.n_nodes
    assignment = assignment.astype(np.int32)
    assert assignment.shape == (V,)
    # Symmetrized adjacency with direction flags, CSR over global ids.
    src = np.concatenate([graph.edge_src, graph.edge_dst])
    dst = np.concatenate([graph.edge_dst, graph.edge_src])
    lab = np.concatenate([graph.edge_label, graph.edge_label])
    dire = np.concatenate([
        np.where(graph.edge_directed, DIR_FORWARD, DIR_UNDIRECTED),
        np.where(graph.edge_directed, DIR_BACKWARD, DIR_UNDIRECTED),
    ]).astype(np.int32)
    order = np.argsort(src, kind="stable")
    src, dst, lab, dire = src[order], dst[order], lab[order], dire[order]
    gptr = np.zeros(V + 1, dtype=np.int64)
    np.add.at(gptr, src + 1, 1)
    gptr = np.cumsum(gptr)

    cut = int(np.sum(assignment[graph.edge_src] != assignment[graph.edge_dst]))

    per_core: List[np.ndarray] = [np.where(assignment == p)[0] for p in range(k)]
    raw_parts: List[dict] = []
    for p in range(k):
        core = per_core[p]
        core_set_local = {int(g): i for i, g in enumerate(core)}
        ghosts: List[int] = []
        ghost_idx: Dict[int, int] = {}
        e_dst: List[int] = []
        e_lab: List[int] = []
        e_dir: List[int] = []
        rptr = [0]
        for g in core:
            s, e = int(gptr[g]), int(gptr[g + 1])
            for idx in range(s, e):
                d = int(dst[idx])
                li = core_set_local.get(d)
                if li is None:  # cut edge -> ghost node
                    gi = ghost_idx.get(d)
                    if gi is None:
                        gi = len(ghosts)
                        ghost_idx[d] = gi
                        ghosts.append(d)
                    li = len(core) + gi
                e_dst.append(li)
                e_lab.append(int(lab[idx]))
                e_dir.append(int(dire[idx]))
            rptr.append(len(e_dst))
        raw_parts.append(dict(core=core, ghosts=np.asarray(ghosts, dtype=np.int64),
                              rptr=np.asarray(rptr, dtype=np.int64),
                              e_dst=np.asarray(e_dst, dtype=np.int32),
                              e_lab=np.asarray(e_lab, dtype=np.int32),
                              e_dir=np.asarray(e_dir, dtype=np.int32)))

    if uniform_pad:
        node_pad = _round_up(max(1, max(len(r["core"]) + len(r["ghosts"]) for r in raw_parts)),
                             node_pad_multiple)
        edge_pad = _round_up(max(1, max(len(r["e_dst"]) for r in raw_parts)),
                             edge_pad_multiple)
    else:
        node_pad = edge_pad = 0  # per-partition sizes below

    parts: List[PartitionArrays] = []
    g2l = np.full((k, V), -1, dtype=np.int32)
    for p in range(k):
        r = raw_parts[p]
        n_core, n_ghost = len(r["core"]), len(r["ghosts"])
        n_nodes = n_core + n_ghost
        npad = node_pad if uniform_pad else _round_up(max(1, n_nodes), node_pad_multiple)
        epad = edge_pad if uniform_pad else _round_up(max(1, len(r["e_dst"])), edge_pad_multiple)
        gids = np.full(npad, -1, dtype=np.int32)
        labels = np.full(npad, -2, dtype=np.int32)
        values = np.full(npad, np.nan, dtype=np.float32)
        owners = np.full(npad, -1, dtype=np.int32)
        all_g = np.concatenate([r["core"], r["ghosts"]]).astype(np.int64) if n_nodes else np.zeros(0, np.int64)
        gids[:n_nodes] = all_g
        labels[:n_nodes] = graph.node_label[all_g]
        values[:n_nodes] = graph.node_value[all_g]
        owners[:n_nodes] = assignment[all_g]
        g2l[p, all_g] = np.arange(n_nodes, dtype=np.int32)

        rptr = np.full(npad + 1, r["rptr"][-1], dtype=np.int32)
        rptr[: n_core + 1] = r["rptr"]
        # ghosts + padding rows all get empty adjacency (== last value)
        edst = np.full(epad, -1, dtype=np.int32)
        elab = np.full(epad, -2, dtype=np.int32)
        edir = np.zeros(epad, dtype=np.int32)
        ne = len(r["e_dst"])
        edst[:ne], elab[:ne], edir[:ne] = r["e_dst"], r["e_lab"], r["e_dir"]

        pa = PartitionArrays(pid=p, n_core=n_core, n_nodes=n_nodes,
                             node_gid=gids, node_label=labels, node_value=values,
                             node_owner=owners, row_ptr=rptr, edge_dst=edst,
                             edge_label=elab, edge_dir=edir)
        parts.append(pa)

    if ell:
        w = ell_width if ell_width is not None else max(1, max(pa.max_degree() for pa in parts))
        for pa in parts:
            pa.to_ell(w)

    return PartitionedGraph(graph=graph, k=k, assignment=assignment, parts=parts,
                            owner=assignment.copy(), g2l=g2l, cut_edges=cut,
                            node_pad=node_pad if uniform_pad else -1,
                            edge_pad=edge_pad if uniform_pad else -1,
                            scheme=scheme)
