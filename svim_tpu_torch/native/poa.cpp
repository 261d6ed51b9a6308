// Partial-order alignment (POA) consensus.
//
// Native replacement for SPOA's role in insertion consensus
// (reference: SVIM_COMBINE.py:208 — poa(haplotypes, algorithm=1, m=2, n=-4,
// g=-4, e=-2, q=-24, c=-1)): sequences are aligned one after another to a
// growing DAG (global alignment, two-piece affine gaps, mismatches merged
// into "aligned rings" so alternatives share columns), and the consensus is
// the heaviest edge-weight path through the final graph.
//
// Exposed through svimnative.so (same translation unit set, C ABI).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace poa {

static const float kNegInf = -1e30f;
static const float kMatch = 2.0f, kMismatch = -4.0f;
static const float kGapOpen1 = -4.0f, kGapExt1 = -2.0f;
static const float kGapOpen2 = -24.0f, kGapExt2 = -1.0f;

struct Node {
  char base;
  std::vector<int> preds;                 // predecessor node ids
  std::vector<float> pred_weights;        // parallel edge weights
  std::vector<int> aligned;               // ring of nodes aligned to this one
  int coverage = 0;                       // sequences emitting this node

  int pred_index(int node_id) const {
    for (size_t k = 0; k < preds.size(); ++k)
      if (preds[k] == node_id) return (int)k;
    return -1;
  }
};

struct Graph {
  std::vector<Node> nodes;
  std::vector<int> topo;       // topological order (recomputed per sequence)
  std::vector<int> rank_of;    // node id -> topo rank

  int add_node(char base) {
    nodes.push_back(Node{base});
    return (int)nodes.size() - 1;
  }

  void add_edge(int from, int to, float weight) {
    if (from < 0) return;
    Node& node = nodes[to];
    int k = node.pred_index(from);
    if (k >= 0) {
      node.pred_weights[k] += weight;
    } else {
      node.preds.push_back(from);
      node.pred_weights.push_back(weight);
    }
  }

  void toposort() {
    int n = (int)nodes.size();
    std::vector<int> out_missing(n, 0);
    std::vector<std::vector<int>> succs(n);
    for (int v = 0; v < n; ++v)
      for (int u : nodes[v].preds) {
        succs[u].push_back(v);
        out_missing[v]++;
      }
    topo.clear();
    topo.reserve(n);
    for (int v = 0; v < n; ++v)
      if (out_missing[v] == 0) topo.push_back(v);
    for (size_t head = 0; head < topo.size(); ++head) {
      int u = topo[head];
      for (int v : succs[u])
        if (--out_missing[v] == 0) topo.push_back(v);
    }
    rank_of.assign(n, -1);
    for (int r = 0; r < (int)topo.size(); ++r) rank_of[topo[r]] = r;
  }
};

// One aligned column of the sequence-vs-graph alignment.
struct AlignStep {
  int node;     // matched node id, or -1 (insertion: seq char only)
  int seq_pos;  // seq index, or -1 (deletion: node consumed, no char)
};

// Global alignment of seq against the graph.  Returns false when the DP
// would exceed max_cells.  States: M, D1/D2 (consume node), I1/I2 (consume
// char); gap costs follow the two-piece scheme.
static bool align_to_graph(const Graph& graph, const char* seq, int64_t len,
                           std::vector<AlignStep>* steps, int64_t max_cells) {
  const int n = (int)graph.topo.size();
  const int64_t width = len + 1;
  if ((int64_t)(n + 1) * width > max_cells) return false;

  // DP rows indexed by topo rank + a virtual start row at rank 0.
  const int rows = n + 1;
  std::vector<float> M(rows * width, kNegInf), D1(rows * width, kNegInf),
      D2(rows * width, kNegInf), I1(rows * width, kNegInf),
      I2(rows * width, kNegInf), best(rows * width, kNegInf);
  // traceback: per cell the winning state; per state its source
  // state codes: 0 M, 1 D1, 2 D2, 3 I1, 4 I2
  std::vector<uint8_t> best_state(rows * width, 0);
  std::vector<int32_t> m_from(rows * width, -1);    // source row of M
  std::vector<int32_t> d1_from(rows * width, -1);   // source row of D1
  std::vector<int32_t> d2_from(rows * width, -1);   // source row of D2
  std::vector<uint8_t> d_ext(rows * width, 0);      // bit0: D1 extended, bit1: D2
  std::vector<uint8_t> i_ext(rows * width, 0);      // bit0: I1 extended, bit1: I2

  auto at = [width](int row, int64_t j) { return (int64_t)row * width + j; };

  // virtual start row: gaps consuming seq chars only
  best[at(0, 0)] = 0.0f;
  M[at(0, 0)] = 0.0f;
  for (int64_t j = 1; j < width; ++j) {
    float open1 = best[at(0, j - 1)] + kGapOpen1;
    float ext1 = I1[at(0, j - 1)] + kGapExt1;
    I1[at(0, j)] = std::max(open1, ext1);
    if (ext1 >= open1) i_ext[at(0, j)] |= 1;
    float open2 = best[at(0, j - 1)] + kGapOpen2;
    float ext2 = I2[at(0, j - 1)] + kGapExt2;
    I2[at(0, j)] = std::max(open2, ext2);
    if (ext2 >= open2) i_ext[at(0, j)] |= 2;
    best[at(0, j)] = std::max(I1[at(0, j)], I2[at(0, j)]);
    best_state[at(0, j)] = I1[at(0, j)] >= I2[at(0, j)] ? 3 : 4;
  }

  for (int r = 1; r < rows; ++r) {
    const Node& node = graph.nodes[graph.topo[r - 1]];
    const char base = node.base;
    // predecessor rows (virtual start when the node has no preds).
    // Leaked TLS pointer: non-trivial TLS destructors in a dlopen'd
    // library race with glibc teardown (see svimnative.cpp).
    static thread_local std::vector<int>* pred_rows_p = nullptr;
    if (!pred_rows_p) pred_rows_p = new std::vector<int>();
    std::vector<int>& pred_rows = *pred_rows_p;
    pred_rows.clear();
    if (node.preds.empty()) {
      pred_rows.push_back(0);
    } else {
      for (int p : node.preds) pred_rows.push_back(graph.rank_of[p] + 1);
    }
    for (int64_t j = 0; j < width; ++j) {
      const int64_t cell = at(r, j);
      // D: consume this node, no char (each gap piece tracks its own
      // predecessor and extend bit)
      float d1 = kNegInf, d2 = kNegInf;
      int d1_src = -1, d2_src = -1;
      uint8_t dext = 0;
      for (int pr : pred_rows) {
        float open1 = best[at(pr, j)] + kGapOpen1;
        float ext1 = D1[at(pr, j)] + kGapExt1;
        float cand1 = std::max(open1, ext1);
        if (cand1 > d1) {
          d1 = cand1;
          d1_src = pr;
          dext = (dext & ~1) | (ext1 >= open1 ? 1 : 0);
        }
        float open2 = best[at(pr, j)] + kGapOpen2;
        float ext2 = D2[at(pr, j)] + kGapExt2;
        float cand2 = std::max(open2, ext2);
        if (cand2 > d2) {
          d2 = cand2;
          d2_src = pr;
          dext = (dext & ~2) | (ext2 >= open2 ? 2 : 0);
        }
      }
      D1[cell] = d1;
      D2[cell] = d2;
      d1_from[cell] = d1_src;
      d2_from[cell] = d2_src;
      d_ext[cell] = dext;

      float m = kNegInf;
      int m_src = -1;
      if (j >= 1) {
        const float sub = (base == seq[j - 1]) ? kMatch : kMismatch;
        for (int pr : pred_rows) {
          float cand = best[at(pr, j - 1)] + sub;
          if (cand > m) { m = cand; m_src = pr; }
        }
      }
      M[cell] = m;
      m_from[cell] = m_src;

      float i1 = kNegInf, i2 = kNegInf;
      if (j >= 1) {
        float open1 = best[at(r, j - 1)] + kGapOpen1;
        float ext1 = I1[at(r, j - 1)] + kGapExt1;
        i1 = std::max(open1, ext1);
        if (ext1 >= open1) i_ext[cell] |= 1;
        float open2 = best[at(r, j - 1)] + kGapOpen2;
        float ext2 = I2[at(r, j - 1)] + kGapExt2;
        i2 = std::max(open2, ext2);
        if (ext2 >= open2) i_ext[cell] |= 2;
      }
      I1[cell] = i1;
      I2[cell] = i2;

      float b = m;
      uint8_t state = 0;
      if (d1 > b) { b = d1; state = 1; }
      if (d2 > b) { b = d2; state = 2; }
      if (i1 > b) { b = i1; state = 3; }
      if (i2 > b) { b = i2; state = 4; }
      best[cell] = b;
      best_state[cell] = state;
    }
  }

  // global end: best over rows whose node has no successor (or start row if
  // the graph is empty), at j = len
  std::vector<bool> has_succ(rows, false);
  for (int v = 0; v < (int)graph.nodes.size(); ++v)
    for (int u : graph.nodes[v].preds) has_succ[graph.rank_of[u] + 1] = true;
  int end_row = 0;
  float end_best = kNegInf;
  for (int r = 0; r < rows; ++r) {
    if (r > 0 && has_succ[r]) continue;
    if (best[at(r, len)] > end_best) { end_best = best[at(r, len)]; end_row = r; }
  }

  // traceback
  steps->clear();
  int r = end_row;
  int64_t j = len;
  int state = best_state[at(r, j)];
  while (r > 0 || j > 0) {
    const int64_t cell = at(r, j);
    if (state == 0) {  // match/mismatch
      steps->push_back({graph.topo[r - 1], (int)(j - 1)});
      int src = m_from[cell];
      j -= 1;
      r = src;
      state = best_state[at(r, j)];
    } else if (state == 1 || state == 2) {  // node consumed, no char
      steps->push_back({graph.topo[r - 1], -1});
      int src = state == 1 ? d1_from[cell] : d2_from[cell];
      bool extended = d_ext[cell] & (state == 1 ? 1 : 2);
      r = src;
      if (!extended) state = best_state[at(r, j)];
    } else {  // char consumed, no node
      steps->push_back({-1, (int)(j - 1)});
      bool extended = i_ext[cell] & (state == 3 ? 1 : 2);
      j -= 1;
      if (!extended) state = best_state[at(r, j)];
    }
  }
  std::reverse(steps->begin(), steps->end());
  return true;
}

// Longest-path depth per DP row (row 0 = virtual start).  A node's depth is
// its position along the deepest chain from a source — the band center for
// the banded alignment (similar sequences align near the diagonal
// j ~ depth).
static void compute_depths(const Graph& graph, std::vector<int64_t>* depth) {
  const int rows = (int)graph.topo.size() + 1;
  depth->assign(rows, 0);
  for (int r = 1; r < rows; ++r) {
    const Node& node = graph.nodes[graph.topo[r - 1]];
    int64_t d = 1;
    for (int p : node.preds)
      d = std::max(d, (*depth)[graph.rank_of[p] + 1] + 1);
    (*depth)[r] = d;
  }
}

// Banded variant of align_to_graph: per graph node only the DP columns
// within `band` of the node's depth are computed (similar sequences stay
// near that diagonal).  Sets *touched when the optimal traceback grazes a
// band edge — the caller then doubles the band, so the accepted result never
// depends on an artificially clipped path.  Returns false only when the
// banded cell count itself exceeds max_cells.
static bool align_to_graph_banded(const Graph& graph, const char* seq,
                                  int64_t len, int64_t band,
                                  std::vector<AlignStep>* steps,
                                  int64_t max_cells, bool* touched) {
  const int n = (int)graph.topo.size();
  const int rows = n + 1;
  *touched = false;

  std::vector<int64_t> depth;
  compute_depths(graph, &depth);
  std::vector<bool> has_succ(rows, false);
  for (int v = 0; v < (int)graph.nodes.size(); ++v)
    for (int u : graph.nodes[v].preds) has_succ[graph.rank_of[u] + 1] = true;

  std::vector<int64_t> lo(rows), hi(rows), row_base(rows + 1, 0);
  for (int r = 0; r < rows; ++r) {
    if (r == 0) {
      lo[r] = 0;  // virtual start row stays full: leading insertions
      hi[r] = len;
    } else {
      lo[r] = std::max<int64_t>(0, std::min(len, depth[r] - band));
      hi[r] = std::max<int64_t>(0, std::min(len, depth[r] + band));
      if (!has_succ[r]) hi[r] = len;  // global end lives at (end row, len)
      if (lo[r] > hi[r]) lo[r] = hi[r];
    }
    row_base[r + 1] = row_base[r] + (hi[r] - lo[r] + 1);
  }
  const int64_t cells = row_base[rows];
  if (cells > max_cells) return false;

  std::vector<float> M(cells, kNegInf), D1(cells, kNegInf), D2(cells, kNegInf),
      I1(cells, kNegInf), I2(cells, kNegInf), best(cells, kNegInf);
  std::vector<uint8_t> best_state(cells, 0);
  std::vector<int32_t> m_from(cells, -1), d1_from(cells, -1), d2_from(cells, -1);
  std::vector<uint8_t> d_ext(cells, 0), i_ext(cells, 0);

  auto at = [&](int r, int64_t j) { return row_base[r] + (j - lo[r]); };
  auto in_band = [&](int r, int64_t j) { return j >= lo[r] && j <= hi[r]; };
  auto get = [&](const std::vector<float>& a, int r, int64_t j) {
    return in_band(r, j) ? a[at(r, j)] : kNegInf;
  };

  best[at(0, 0)] = 0.0f;
  M[at(0, 0)] = 0.0f;
  for (int64_t j = 1; j <= len; ++j) {
    float open1 = best[at(0, j - 1)] + kGapOpen1;
    float ext1 = I1[at(0, j - 1)] + kGapExt1;
    I1[at(0, j)] = std::max(open1, ext1);
    if (ext1 >= open1) i_ext[at(0, j)] |= 1;
    float open2 = best[at(0, j - 1)] + kGapOpen2;
    float ext2 = I2[at(0, j - 1)] + kGapExt2;
    I2[at(0, j)] = std::max(open2, ext2);
    if (ext2 >= open2) i_ext[at(0, j)] |= 2;
    best[at(0, j)] = std::max(I1[at(0, j)], I2[at(0, j)]);
    best_state[at(0, j)] = I1[at(0, j)] >= I2[at(0, j)] ? 3 : 4;
  }

  for (int r = 1; r < rows; ++r) {
    const Node& node = graph.nodes[graph.topo[r - 1]];
    const char base = node.base;
    static thread_local std::vector<int>* pred_rows_p = nullptr;
    if (!pred_rows_p) pred_rows_p = new std::vector<int>();
    std::vector<int>& pred_rows = *pred_rows_p;
    pred_rows.clear();
    if (node.preds.empty()) {
      pred_rows.push_back(0);
    } else {
      for (int p : node.preds) pred_rows.push_back(graph.rank_of[p] + 1);
    }
    if (pred_rows.size() == 1) {
      // single-predecessor fast path (the overwhelming majority of nodes in
      // a near-linear graph): hoist the predecessor band tests out of the
      // inner loop by splitting j into segments where the (pr, j) and
      // (pr, j-1) in-band flags are constant.  Arithmetic per cell is
      // IDENTICAL to the general loop below — outputs are byte-equal.
      const int pr = pred_rows[0];
      const float* best_pr = best.data() + row_base[pr] - lo[pr];
      const float* D1_pr = D1.data() + row_base[pr] - lo[pr];
      const float* D2_pr = D2.data() + row_base[pr] - lo[pr];
      auto run_segment = [&](int64_t j0, int64_t j1, bool pd, bool pm) {
        for (int64_t j = j0; j <= j1; ++j) {
          const int64_t cell = at(r, j);
          const float bprj = pd ? best_pr[j] : kNegInf;
          float d1 = kNegInf, d2 = kNegInf;
          int d1_src = -1, d2_src = -1;
          uint8_t dext = 0;
          {
            float open1 = bprj + kGapOpen1;
            float ext1 = (pd ? D1_pr[j] : kNegInf) + kGapExt1;
            float cand1 = std::max(open1, ext1);
            if (cand1 > d1) {
              d1 = cand1;
              d1_src = pr;
              dext = (dext & ~1) | (ext1 >= open1 ? 1 : 0);
            }
            float open2 = bprj + kGapOpen2;
            float ext2 = (pd ? D2_pr[j] : kNegInf) + kGapExt2;
            float cand2 = std::max(open2, ext2);
            if (cand2 > d2) {
              d2 = cand2;
              d2_src = pr;
              dext = (dext & ~2) | (ext2 >= open2 ? 2 : 0);
            }
          }
          D1[cell] = d1;
          D2[cell] = d2;
          d1_from[cell] = d1_src;
          d2_from[cell] = d2_src;
          d_ext[cell] = dext;

          float m = kNegInf;
          int m_src = -1;
          if (j >= 1) {
            const float sub = (base == seq[j - 1]) ? kMatch : kMismatch;
            float cand = (pm ? best_pr[j - 1] : kNegInf) + sub;
            if (cand > m) { m = cand; m_src = pr; }
          }
          M[cell] = m;
          m_from[cell] = m_src;

          float i1 = kNegInf, i2 = kNegInf;
          if (j >= 1 && in_band(r, j - 1)) {
            float open1 = best[at(r, j - 1)] + kGapOpen1;
            float ext1 = I1[at(r, j - 1)] + kGapExt1;
            i1 = std::max(open1, ext1);
            if (ext1 >= open1) i_ext[cell] |= 1;
            float open2 = best[at(r, j - 1)] + kGapOpen2;
            float ext2 = I2[at(r, j - 1)] + kGapExt2;
            i2 = std::max(open2, ext2);
            if (ext2 >= open2) i_ext[cell] |= 2;
          }
          I1[cell] = i1;
          I2[cell] = i2;

          float b = m;
          uint8_t state = 0;
          if (d1 > b) { b = d1; state = 1; }
          if (d2 > b) { b = d2; state = 2; }
          if (i1 > b) { b = i1; state = 3; }
          if (i2 > b) { b = i2; state = 4; }
          best[cell] = b;
          best_state[cell] = state;
        }
      };
      // segment boundaries where (pr, j) / (pr, j-1) in-band flips
      int64_t cuts[4] = {lo[pr], hi[pr] + 1, lo[pr] + 1, hi[pr] + 2};
      int64_t j0 = lo[r];
      const int64_t j_end = hi[r];
      while (j0 <= j_end) {
        int64_t j1 = j_end;
        for (int64_t cut : cuts) {
          if (cut > j0 && cut - 1 < j1) j1 = cut - 1;
        }
        const bool pd = j0 >= lo[pr] && j0 <= hi[pr];
        const bool pm = j0 - 1 >= lo[pr] && j0 - 1 <= hi[pr];
        run_segment(j0, j1, pd, pm);
        j0 = j1 + 1;
      }
      continue;
    }
    for (int64_t j = lo[r]; j <= hi[r]; ++j) {
      const int64_t cell = at(r, j);
      float d1 = kNegInf, d2 = kNegInf;
      int d1_src = -1, d2_src = -1;
      uint8_t dext = 0;
      for (int pr : pred_rows) {
        float open1 = get(best, pr, j) + kGapOpen1;
        float ext1 = get(D1, pr, j) + kGapExt1;
        float cand1 = std::max(open1, ext1);
        if (cand1 > d1) {
          d1 = cand1;
          d1_src = pr;
          dext = (dext & ~1) | (ext1 >= open1 ? 1 : 0);
        }
        float open2 = get(best, pr, j) + kGapOpen2;
        float ext2 = get(D2, pr, j) + kGapExt2;
        float cand2 = std::max(open2, ext2);
        if (cand2 > d2) {
          d2 = cand2;
          d2_src = pr;
          dext = (dext & ~2) | (ext2 >= open2 ? 2 : 0);
        }
      }
      D1[cell] = d1;
      D2[cell] = d2;
      d1_from[cell] = d1_src;
      d2_from[cell] = d2_src;
      d_ext[cell] = dext;

      float m = kNegInf;
      int m_src = -1;
      if (j >= 1) {
        const float sub = (base == seq[j - 1]) ? kMatch : kMismatch;
        for (int pr : pred_rows) {
          float cand = get(best, pr, j - 1) + sub;
          if (cand > m) { m = cand; m_src = pr; }
        }
      }
      M[cell] = m;
      m_from[cell] = m_src;

      float i1 = kNegInf, i2 = kNegInf;
      if (j >= 1 && in_band(r, j - 1)) {
        float open1 = best[at(r, j - 1)] + kGapOpen1;
        float ext1 = I1[at(r, j - 1)] + kGapExt1;
        i1 = std::max(open1, ext1);
        if (ext1 >= open1) i_ext[cell] |= 1;
        float open2 = best[at(r, j - 1)] + kGapOpen2;
        float ext2 = I2[at(r, j - 1)] + kGapExt2;
        i2 = std::max(open2, ext2);
        if (ext2 >= open2) i_ext[cell] |= 2;
      }
      I1[cell] = i1;
      I2[cell] = i2;

      float b = m;
      uint8_t state = 0;
      if (d1 > b) { b = d1; state = 1; }
      if (d2 > b) { b = d2; state = 2; }
      if (i1 > b) { b = i1; state = 3; }
      if (i2 > b) { b = i2; state = 4; }
      best[cell] = b;
      best_state[cell] = state;
    }
  }

  int end_row = 0;
  float end_best = kNegInf;
  for (int r = 0; r < rows; ++r) {
    if (r > 0 && has_succ[r]) continue;
    if (best[at(r, len)] > end_best) { end_best = best[at(r, len)]; end_row = r; }
  }
  if (end_best <= kNegInf / 2) {  // band disconnected the problem entirely
    *touched = true;
    steps->clear();
    return true;
  }

  steps->clear();
  int r = end_row;
  int64_t j = len;
  int state = best_state[at(r, j)];
  while (r > 0 || j > 0) {
    if (r > 0 && ((j == lo[r] && lo[r] > 0) || (j == hi[r] && hi[r] < len)))
      *touched = true;  // optimal path grazes the band: widen and retry
    const int64_t cell = at(r, j);
    if (state == 0) {
      steps->push_back({graph.topo[r - 1], (int)(j - 1)});
      int src = m_from[cell];
      if (src < 0) { *touched = true; steps->clear(); return true; }
      j -= 1;
      r = src;
      state = best_state[at(r, j)];
    } else if (state == 1 || state == 2) {
      steps->push_back({graph.topo[r - 1], -1});
      int src = state == 1 ? d1_from[cell] : d2_from[cell];
      if (src < 0) { *touched = true; steps->clear(); return true; }
      bool extended = d_ext[cell] & (state == 1 ? 1 : 2);
      r = src;
      if (!extended) state = best_state[at(r, j)];
    } else {
      steps->push_back({-1, (int)(j - 1)});
      bool extended = i_ext[cell] & (state == 3 ? 1 : 2);
      j -= 1;
      if (!extended) state = best_state[at(r, j)];
    }
  }
  std::reverse(steps->begin(), steps->end());
  return true;
}

// Integrate an aligned sequence into the graph (SPOA add_alignment
// semantics: matches reuse nodes, mismatches join the aligned ring,
// insertions add fresh nodes; edges along the sequence gain weight 1).
static void integrate(Graph* graph, const char* seq, int64_t len,
                      const std::vector<AlignStep>& steps) {
  (void)len;
  int prev_node = -1;
  for (const AlignStep& step : steps) {
    if (step.seq_pos < 0) continue;  // deletion: nothing emitted
    const char base = seq[step.seq_pos];
    int node_id;
    if (step.node >= 0) {
      Node& node = graph->nodes[step.node];
      if (node.base == base) {
        node_id = step.node;
      } else {
        // find a ring member with this base
        node_id = -1;
        for (int other : node.aligned)
          if (graph->nodes[other].base == base) { node_id = other; break; }
        if (node_id < 0) {
          node_id = graph->add_node(base);
          // join the ring
          Node& fresh = graph->nodes[node_id];
          fresh.aligned = graph->nodes[step.node].aligned;
          fresh.aligned.push_back(step.node);
          for (int other : fresh.aligned)
            graph->nodes[other].aligned.push_back(node_id);
        }
      }
    } else {
      node_id = graph->add_node(base);
    }
    graph->nodes[node_id].coverage += 1;
    graph->add_edge(prev_node, node_id, 1.0f);
    prev_node = node_id;
  }
}

// Heaviest path by edge weight (node coverage breaks ties).
static void consensus_path(Graph* graph, std::string* out) {
  graph->toposort();
  int n = (int)graph->nodes.size();
  std::vector<float> score(n, 0.0f);
  std::vector<int> from(n, -1);
  float best_score = -1.0f;
  int best_node = -1;
  for (int rank = 0; rank < n; ++rank) {
    int v = graph->topo[rank];
    const Node& node = graph->nodes[v];
    float s = 0.0f;
    int src = -1;
    for (size_t k = 0; k < node.preds.size(); ++k) {
      int u = node.preds[k];
      float cand = score[u] + node.pred_weights[k];
      if (cand > s || (cand == s && src >= 0
                       && graph->nodes[u].coverage > graph->nodes[src].coverage)) {
        s = cand;
        src = u;
      }
    }
    score[v] = s;
    from[v] = src;
    if (s > best_score
        || (s == best_score && best_node >= 0
            && node.coverage > graph->nodes[best_node].coverage)) {
      best_score = s;
      best_node = v;
    }
  }
  out->clear();
  for (int v = best_node; v >= 0; v = from[v]) out->push_back(graph->nodes[v].base);
  std::reverse(out->begin(), out->end());
}

}  // namespace poa

extern "C" {

// Consensus of n_seqs sequences (concatenated, lengths in seq_lens).
// Alignments whose full DP fits in full_dp_cells run unbanded; larger ones
// run the banded aligner with band doubling (start 64, double whenever the
// optimal path grazes a band edge) — this is what lifts the former hard cell
// cap for long insertion clusters (reference capability: 10 kb haplotypes,
// SVIM_COMBINE.py:202).  Returns 0 on success, -1 when even the banded DP
// exceeds max_cells (caller falls back to the star MSA), -2 when out_cap is
// too small.
int poa_consensus_native(const char* seqs, const int64_t* seq_lens,
                         int n_seqs, int64_t max_cells, int64_t full_dp_cells,
                         char* out, int64_t out_cap, int64_t* out_len) {
  poa::Graph graph;
  int64_t offset = 0;
  // seed the graph with the first sequence as a chain
  if (n_seqs <= 0) return -1;
  {
    int prev = -1;
    for (int64_t c = 0; c < seq_lens[0]; ++c) {
      int node_id = graph.add_node(seqs[c]);
      graph.nodes[node_id].coverage = 1;
      graph.add_edge(prev, node_id, 1.0f);
      prev = node_id;
    }
    offset = seq_lens[0];
  }
  std::vector<poa::AlignStep> steps;
  // Adaptive band start: sequences of one cluster share noise statistics,
  // so the band that ACCEPTED the previous alignment is the best guess for
  // the next (sticky, up only).  Near-identical haplotypes stay at 16
  // (3-4x fewer cells than the old fixed 64); noisy clusters climb once
  // and stop retrying from the bottom.  Exactness is unchanged: the
  // never-graze acceptance rule decides per alignment regardless of the
  // ladder's starting rung.
  int64_t start_band = 16;
  for (int s = 1; s < n_seqs; ++s) {
    graph.toposort();
    const int64_t len = seq_lens[s];
    const int64_t full_cells = (int64_t)(graph.topo.size() + 1) * (len + 1);
    bool aligned = false;
    if (full_cells <= full_dp_cells) {
      aligned = poa::align_to_graph(graph, seqs + offset, len, &steps,
                                    max_cells);
    }
    if (!aligned) {
      for (int64_t band = start_band; band <= 2 * (len + 2); band *= 2) {
        bool touched = false;
        if (!poa::align_to_graph_banded(graph, seqs + offset, len, band,
                                        &steps, max_cells, &touched))
          return -1;  // banded cells exceed the budget: give up
        if (!touched) {
          aligned = true;
          start_band = band;
          break;
        }
      }
      if (!aligned) return -1;
    }
    poa::integrate(&graph, seqs + offset, seq_lens[s], steps);
    offset += seq_lens[s];
  }
  std::string consensus;
  poa::consensus_path(&graph, &consensus);
  if ((int64_t)consensus.size() > out_cap) return -2;
  std::memcpy(out, consensus.data(), consensus.size());
  *out_len = (int64_t)consensus.size();
  return 0;
}

}  // extern "C"
