// The one-edge match shared by fused_frontier.cu and frontier_expand.cu:
// the label / direction / value-op encodings and the predicate algebra that
// decides whether candidate edge (i, w) extends binding i.  label_histogram.cu
// takes its encodings and value_ok from here too.
//
// Both kernels hold it against the JAX package's kernels: the match is
// src/repro/kernels/frontier_expand.py::_kernel, and the fused kernel adds
// its routing on top.  kernels/build.py hashes this header into every
// library's name, so an edit here rebuilds them all.

#pragma once

#include <stdint.h>

namespace frontier {

// label / direction / op encodings (core/graph.py, core/query.py)
constexpr int WILDCARD = -1;
constexpr int DIR_UNDIRECTED = 0, DIR_FORWARD = 1, DIR_BACKWARD = 2;
constexpr int QDIR_ANY = 0, QDIR_OUT = 1, QDIR_IN = 2;
constexpr int OP_NONE = 0, OP_EQ = 1, OP_NE = 2, OP_LT = 3, OP_LE = 4,
              OP_GT = 5, OP_GE = 6;

__device__ __forceinline__ bool value_ok(int op, float dv, float v) {
  // NaN fails every op but OP_NONE
  bool finite = dv == dv;
  bool cmp = (op == OP_EQ && dv == v) || (op == OP_NE && dv != v) ||
             (op == OP_LT && dv < v) || (op == OP_LE && dv <= v) ||
             (op == OP_GT && dv > v) || (op == OP_GE && dv >= v);
  return op == OP_NONE || (finite && cmp);
}

// The plan step's parameters for one binding.
struct StepParams {
  int el, dir, dlab, dop, dst, closes, active;
  float dval;
};

// One candidate edge: the ELL table values at [lidx[i], w].
struct Candidate {
  int ed, el, edir, dl, dg;
  float dv;
};

// Does the candidate extend binding row r[0:Q] under step p?
__device__ __forceinline__ bool edge_match(const StepParams& p,
                                           const Candidate& c,
                                           const int32_t* r, int Q) {
  const bool edge_exists = c.ed >= 0;
  const bool elabel_ok = p.el == WILDCARD || c.el == p.el;
  const bool dir_ok = p.dir == QDIR_ANY || c.edir == DIR_UNDIRECTED ||
                      (p.dir == QDIR_OUT && c.edir == DIR_FORWARD) ||
                      (p.dir == QDIR_IN && c.edir == DIR_BACKWARD);
  const bool dlabel_ok = p.dlab == WILDCARD || c.dl == p.dlab;
  const bool dval_ok = value_ok(p.dop, c.dv, p.dval);

  // injectivity: dg must differ from every bound slot of the row
  bool already = false;
  for (int q = 0; q < Q; ++q) already |= (c.dg == r[q]);
  // plan slots lie in [0, Q); the guard only keeps a bad plan in bounds
  const bool dst_in = p.dst >= 0 && p.dst < Q;
  const bool cyc_ok = p.closes == 1 && dst_in && c.dg == r[dst_in ? p.dst : 0];
  const bool new_ok = p.closes == 0 && dlabel_ok && dval_ok && !already;
  return p.active == 1 && edge_exists && elabel_ok && dir_ok &&
         (cyc_ok || new_ok);
}

}  // namespace frontier
