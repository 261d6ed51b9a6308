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
#include <memory>
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

// The traceback byte of a DP cell: bits 0-2 the state that holds the
// cell's best score (0 M, 1 D1, 2 D2, 3 I1, 4 I2), then whether D1, D2, I1
// and I2 extended their own gap at the cell instead of opening it.
static const uint8_t kStateMask = 7;
static const uint8_t kD1Ext = 8, kD2Ext = 16, kI1Ext = 32, kI2Ext = 64;

// The DP of one poa_consensus_native call, grown to its largest alignment
// and reused by each of its haplotypes and band rungs.  Per cell: the best
// score and the two deletion states' scores (a later row reads them
// wherever its node's predecessors lie in topological order) and the
// traceback byte.  M, I1 and I2 live only while their row is filled.  A
// predecessor that won a cell is not stored: the traceback works it out
// again from the stored scores, in the same order and with the same ties.
struct Workspace {
  // per cell; grown without keeping their contents: each band rung
  // writes every cell of its own before it reads it
  template <typename T>
  struct Cells {
    std::unique_ptr<T[]> at;
    int64_t size = 0;
    void grow(int64_t n) {
      if (n <= size) return;
      at.reset();
      at.reset(new T[n]);
      size = n;
    }
  };
  Cells<float> best, d1, d2;
  Cells<uint8_t> trace;
  std::vector<float> m_row;                  // M of the row being filled
  std::vector<int32_t> dbits_row;            // its D1 and D2 extend bits
  // by column from the row's first: max(M, D1, D2), and the running
  // maxima that give I1 and I2
  std::vector<float> plain_row, run1_row, run2_row;
  std::vector<int64_t> lo, hi, row_base, depth;
  std::vector<uint8_t> has_succ;
  std::vector<int> pred_start, pred_rows;    // each row's predecessor rows
  std::vector<float> subs;                   // per base: score by column
  int sub_slot[256];

  // Rows of the graph against a sequence of `len` characters: row 0 the
  // virtual start, row r the node of topological rank r - 1.
  void prepare(const Graph& graph, int64_t len) {
    const int rows = (int)graph.topo.size() + 1;
    pred_start.assign(rows + 1, 0);
    pred_rows.clear();
    has_succ.assign(rows, 0);
    depth.assign(rows, 0);
    for (int r = 1; r < rows; ++r) {
      const Node& node = graph.nodes[graph.topo[r - 1]];
      pred_start[r] = (int)pred_rows.size();
      // a node without predecessors follows the virtual start
      if (node.preds.empty()) pred_rows.push_back(0);
      int64_t d = 1;
      for (int p : node.preds) {
        const int pr = graph.rank_of[p] + 1;
        pred_rows.push_back(pr);
        has_succ[pr] = 1;
        d = std::max(d, depth[pr] + 1);
      }
      depth[r] = d;  // the band's centre: similar sequences stay near it
    }
    pred_start[rows] = (int)pred_rows.size();
    std::fill(sub_slot, sub_slot + 256, -1);
    subs.clear();
    m_row.resize(len + 1);
    dbits_row.resize(len + 1);
    plain_row.resize(len + 1);
    run1_row.resize(len + 2);
    run2_row.resize(len + 2);
  }

  // The match score of `base` at each column (column j scores seq[j - 1]).
  const float* sub_row(char base, const char* seq, int64_t len) {
    int& slot = sub_slot[(uint8_t)base];
    if (slot < 0) {
      slot = (int)(subs.size() / (len + 1));
      subs.resize(subs.size() + len + 1);
      float* row = subs.data() + slot * (len + 1);
      row[0] = kNegInf;
      for (int64_t j = 1; j <= len; ++j)
        row[j] = seq[j - 1] == base ? kMatch : kMismatch;
    }
    return subs.data() + slot * (len + 1);
  }
};

// row[j] = value for the columns of [lo, hi] outside [a, b]
template <typename T>
static inline void fill_outside(T* row, int64_t lo, int64_t hi, int64_t a,
                                int64_t b, T value) {
  for (int64_t j = lo; j <= std::min(hi, a - 1); ++j) row[j] = value;
  for (int64_t j = std::max(lo, b + 1); j <= hi; ++j) row[j] = value;
}

// D1, D2 and M of row r from its predecessor rows, in list order, each
// taking a cell only with a strictly better score: elementwise over the
// columns, none depending on another of the row.
static void fill_from_predecessors(Workspace& ws, int r, const float* sub) {
  const int64_t lo = ws.lo[r], hi = ws.hi[r];
  const int64_t at = ws.row_base[r] - lo;  // cell of column j: at + j
  float* d1 = ws.d1.at.get() + at;
  float* d2 = ws.d2.at.get() + at;
  int32_t* dbits = ws.dbits_row.data();
  float* m = ws.m_row.data();
  for (int k = ws.pred_start[r]; k < ws.pred_start[r + 1]; ++k) {
    const int pr = ws.pred_rows[k];
    const int64_t pat = ws.row_base[pr] - ws.lo[pr];
    const float* pbest = ws.best.at.get() + pat;
    const float* pd1 = ws.d1.at.get() + pat;
    const float* pd2 = ws.d2.at.get() + pat;
    // columns the predecessor holds: (pr, j) for D, (pr, j - 1) for M;
    // outside them its scores are -inf and win no cell
    const int64_t a = std::max(lo, ws.lo[pr]), b = std::min(hi, ws.hi[pr]);
    const int64_t am = std::max(std::max(lo, ws.lo[pr] + 1), (int64_t)1);
    const int64_t bm = std::min(hi, ws.hi[pr] + 1);
    if (k == ws.pred_start[r]) {
      // the first predecessor: its scores, -inf outside its columns
      fill_outside(d1, lo, hi, a, b, kNegInf);
      fill_outside(d2, lo, hi, a, b, kNegInf);
      fill_outside(dbits, lo, hi, a, b, 0);
      fill_outside(m, lo, hi, am, bm, kNegInf);
      for (int64_t j = a; j <= b; ++j) {
        const float open1 = pbest[j] + kGapOpen1, ext1 = pd1[j] + kGapExt1;
        const float open2 = pbest[j] + kGapOpen2, ext2 = pd2[j] + kGapExt2;
        const float c1 = std::max(open1, ext1), c2 = std::max(open2, ext2);
        d1[j] = c1;
        d2[j] = c2;
        // an extend bit only where the piece is reached at all
        dbits[j] = ((c1 > kNegInf) & (ext1 >= open1)) * kD1Ext
                   | ((c2 > kNegInf) & (ext2 >= open2)) * kD2Ext;
      }
      for (int64_t j = am; j <= bm; ++j) m[j] = pbest[j - 1] + sub[j];
      continue;
    }
    for (int64_t j = a; j <= b; ++j) {
      const float open1 = pbest[j] + kGapOpen1, ext1 = pd1[j] + kGapExt1;
      const float open2 = pbest[j] + kGapOpen2, ext2 = pd2[j] + kGapExt2;
      const float c1 = std::max(open1, ext1), c2 = std::max(open2, ext2);
      const bool won1 = c1 > d1[j], won2 = c2 > d2[j];
      d1[j] = won1 ? c1 : d1[j];
      d2[j] = won2 ? c2 : d2[j];
      const int32_t bits = (ext1 >= open1) * kD1Ext | (ext2 >= open2) * kD2Ext;
      const int32_t keep = won1 * kD1Ext | won2 * kD2Ext;
      dbits[j] = (dbits[j] & ~keep) | (bits & keep);
    }
    for (int64_t j = am; j <= bm; ++j)
      m[j] = std::max(m[j], pbest[j - 1] + sub[j]);
  }
}

// The best of a cell's five scores (strict > in the order M, D1, D2, I1,
// I2: a state that beats every earlier one holds the cell until a later
// one beats it) and that state, in arithmetic the compiler vectorises.
static inline int32_t cell_best(float m, float d1, float d2, float i1,
                                float i2, float* best) {
  const float b1 = std::max(m, d1), b2 = std::max(b1, d2);
  const float b3 = std::max(b2, i1);
  const int32_t won1 = -(int32_t)(d1 > m), won2 = -(int32_t)(d2 > b1);
  const int32_t won3 = -(int32_t)(i1 > b2), won4 = -(int32_t)(i2 > b3);
  int32_t state = won1 & 1;
  state = (state & ~won2) | (won2 & 2);
  state = (state & ~won3) | (won3 & 3);
  state = (state & ~won4) | (won4 & 4);
  *best = std::max(b3, i2);
  return state;
}

typedef float Floats8 __attribute__((vector_size(32)));
typedef int32_t Ints8 __attribute__((vector_size(32)));

// x[t] = max(x[0], ..., x[t]) in place: eight columns at a time, each
// block's maxima by three shifted maxima, then the blocks' carried maximum.
static void running_max(float* x, int64_t n) {
  const Floats8 neg = {kNegInf, kNegInf, kNegInf, kNegInf,
                       kNegInf, kNegInf, kNegInf, kNegInf};
  Floats8 carry = neg, v, w;
  int64_t t = 0;
  for (; t + 8 <= n; t += 8) {
    std::memcpy(&v, x + t, sizeof v);
    w = __builtin_shuffle(v, neg, (Ints8){8, 0, 1, 2, 3, 4, 5, 6});
    v = v > w ? v : w;
    w = __builtin_shuffle(v, neg, (Ints8){8, 8, 0, 1, 2, 3, 4, 5});
    v = v > w ? v : w;
    w = __builtin_shuffle(v, neg, (Ints8){8, 8, 8, 8, 0, 1, 2, 3});
    v = v > w ? v : w;
    v = v > carry ? v : carry;
    std::memcpy(x + t, &v, sizeof v);
    carry = __builtin_shuffle(v, (Ints8){7, 7, 7, 7, 7, 7, 7, 7});
  }
  for (float c = carry[0]; t < n; ++t) c = x[t] = std::max(c, x[t]);
}

// I1, I2, the best score and its state along row r, column by column:
// I[j] = max(best[j-1] + open, I[j-1] + ext).
static void fill_insertions_in_order(Workspace& ws, int r) {
  const int64_t lo = ws.lo[r], width = ws.hi[r] - lo + 1;
  const int64_t at = ws.row_base[r];  // cell of column lo + t: at + t
  float* best = ws.best.at.get() + at;
  const float* d1 = ws.d1.at.get() + at;
  const float* d2 = ws.d2.at.get() + at;
  uint8_t* trace = ws.trace.at.get() + at;
  const float* m = ws.m_row.data() + lo;
  const int32_t* dbits = ws.dbits_row.data() + lo;
  float i1 = kNegInf, i2 = kNegInf;
  for (int64_t t = 0; t < width; ++t) {
    int32_t bits = dbits[t];
    if (t > 0) {
      const float open1 = best[t - 1] + kGapOpen1, ext1 = i1 + kGapExt1;
      const float open2 = best[t - 1] + kGapOpen2, ext2 = i2 + kGapExt2;
      i1 = std::max(open1, ext1);
      i2 = std::max(open2, ext2);
      bits |= (ext1 >= open1) * kI1Ext | (ext2 >= open2) * kI2Ext;
    }
    bits |= cell_best(m[t], d1[t], d2[t], i1, i2, &best[t]);
    trace[t] = (uint8_t)bits;
  }
}

// Every score of an alignment of `rows` rows against `len` characters is a
// whole number within 4 (rows + len) + 24 of 0 (a path pays at most 4 a
// step, a state's opening 24), and the closed form below adds at most two
// extensions a column to one: where 4 rows + 6 len + 64 stays under this
// span, every sum is a whole number under 2^24, exact in a float, and the
// closed form gives the recurrence's values.
#ifndef POA_CLOSED_FORM_SPAN
#define POA_CLOSED_FORM_SPAN (1 << 24)
#endif

// fill_insertions_in_order in closed form.  Opening an insertion piece
// from a cell held by an insertion scores below extending that insertion,
// so I2 opens from the best of M, D1 and D2 (`plain`) alone and I1 from
// the larger of plain and I2: each piece is then a running maximum of its
// sources, shifted by one extension a column.  The scores are whole
// numbers (or the absorbing -inf), so within POA_CLOSED_FORM_SPAN this
// gives the recurrence's values and extend bits exactly; only the running
// maxima go column by column, eight at a time.
static void fill_insertions(Workspace& ws, int r) {
  const int64_t lo = ws.lo[r];
  const int32_t width = (int32_t)(ws.hi[r] - lo + 1);
  const int64_t at = ws.row_base[r];  // cell of column lo + t: at + t
  float* __restrict best = ws.best.at.get() + at;
  const float* __restrict d1 = ws.d1.at.get() + at;
  const float* __restrict d2 = ws.d2.at.get() + at;
  uint8_t* __restrict trace = ws.trace.at.get() + at;
  const float* __restrict m = ws.m_row.data() + lo;
  int32_t* __restrict bits = ws.dbits_row.data() + lo;  // D's, then all
  float* __restrict plain = ws.plain_row.data();
  // from their index -1, which holds -inf: no I left of the row's first
  float* __restrict run1 = ws.run1_row.data() + 1;
  float* __restrict run2 = ws.run2_row.data() + 1;
  run1[-1] = run2[-1] = kNegInf;
  // I at column t: the running maximum up to t - 1 of source[t'] - t'·ext,
  // plus open + (t - 1)·ext
  auto i1_at = [&](int32_t t) {
    return run1[t - 1] + kGapOpen1 + (float)(t - 1) * kGapExt1;
  };
  auto i2_at = [&](int32_t t) {
    return run2[t - 1] + kGapOpen2 + (float)(t - 1) * kGapExt2;
  };
  for (int32_t t = 0; t < width; ++t) {
    plain[t] = std::max(std::max(m[t], d1[t]), d2[t]);
    run2[t] = plain[t] - (float)t * kGapExt2;
  }
  running_max(run2, width);
  for (int32_t t = 0; t < width; ++t)
    run1[t] = std::max(plain[t], i2_at(t)) - (float)t * kGapExt1;
  running_max(run1, width);
  bits[0] |= cell_best(m[0], d1[0], d2[0], kNegInf, kNegInf, &best[0]);
  for (int32_t t = 1; t < width; ++t) {
    const float p = plain[t - 1], y1 = i1_at(t - 1), y2 = i2_at(t - 1);
    bits[t] |= cell_best(m[t], d1[t], d2[t], i1_at(t), i2_at(t), &best[t])
               | (y1 + kGapExt1 >= std::max(p, y2) + kGapOpen1) * kI1Ext
               | (y2 + kGapExt2 >= p + kGapOpen2) * kI2Ext;
  }
  for (int32_t t = 0; t < width; ++t) trace[t] = (uint8_t)bits[t];
}

// Global alignment of seq against the graph (ws prepared for it), over the
// columns within `band` of each node's depth, or over every column when
// band < 0.  States: M, D1/D2 (consume a node), I1/I2 (consume a char);
// gap costs follow the two-piece scheme.  Returns false, computing
// nothing, when the cells exceed max_cells; else adds them to *cells.
// Sets *touched when the best path meets a band edge, or the band cut it
// off: the caller then doubles the band, so an accepted result never
// depends on a clipped path (the full matrix never touches).
static bool align_to_graph(const Graph& graph, Workspace& ws, const char* seq,
                           int64_t len, int64_t band,
                           std::vector<AlignStep>* steps, int64_t max_cells,
                           bool* touched, int64_t* cells) {
  const int rows = (int)graph.topo.size() + 1;
  *touched = false;
  ws.lo.resize(rows);
  ws.hi.resize(rows);
  ws.row_base.resize(rows + 1);
  ws.row_base[0] = 0;
  for (int r = 0; r < rows; ++r) {
    if (r == 0 || band < 0) {
      ws.lo[r] = 0;  // the virtual start row stays full: leading insertions
      ws.hi[r] = len;
    } else {
      ws.lo[r] = std::max<int64_t>(0, std::min(len, ws.depth[r] - band));
      ws.hi[r] = std::max<int64_t>(0, std::min(len, ws.depth[r] + band));
      if (!ws.has_succ[r]) ws.hi[r] = len;  // global end: (end row, len)
      if (ws.lo[r] > ws.hi[r]) ws.lo[r] = ws.hi[r];
    }
    ws.row_base[r + 1] = ws.row_base[r] + (ws.hi[r] - ws.lo[r] + 1);
  }
  const int64_t total = ws.row_base[rows];
  if (total > max_cells) return false;
  *cells += total;
  ws.best.grow(total);
  ws.d1.grow(total);
  ws.d2.grow(total);
  ws.trace.grow(total);

  // the virtual start row: characters of seq only
  ws.m_row[0] = 0.0f;
  for (int64_t j = 1; j <= len; ++j) ws.m_row[j] = kNegInf;
  std::fill(ws.d1.at.get(), ws.d1.at.get() + len + 1, kNegInf);
  std::fill(ws.d2.at.get(), ws.d2.at.get() + len + 1, kNegInf);
  std::fill(ws.dbits_row.begin(), ws.dbits_row.end(), 0);
  const bool closed_form = 4 * (int64_t)rows + 6 * len + 64
                           < POA_CLOSED_FORM_SPAN;
  const auto insertions =
      closed_form ? fill_insertions : fill_insertions_in_order;
  insertions(ws, 0);
  for (int r = 1; r < rows; ++r) {
    fill_from_predecessors(
        ws, r, ws.sub_row(graph.nodes[graph.topo[r - 1]].base, seq, len));
    insertions(ws, r);
  }

  auto value = [&](const float* a, int r, int64_t j) {
    return j >= ws.lo[r] && j <= ws.hi[r] ? a[ws.row_base[r] + j - ws.lo[r]]
                                          : kNegInf;
  };
  auto state_at = [&](int r, int64_t j) {
    return ws.trace.at[ws.row_base[r] + j - ws.lo[r]] & kStateMask;
  };
  // the predecessor row that gave M at (r, j), or -1 where none reached it
  auto m_source = [&](int r, int64_t j) {
    int src = -1;
    if (j < 1) return src;
    const float sub =
        graph.nodes[graph.topo[r - 1]].base == seq[j - 1] ? kMatch : kMismatch;
    float m = kNegInf;
    for (int k = ws.pred_start[r]; k < ws.pred_start[r + 1]; ++k) {
      const int pr = ws.pred_rows[k];
      const float cand = value(ws.best.at.get(), pr, j - 1) + sub;
      if (cand > m) { m = cand; src = pr; }
    }
    return src;
  };
  // the predecessor row that gave D1 (piece 1) or D2 at (r, j), or -1
  auto d_source = [&](int r, int64_t j, int piece) {
    const float* d = (piece == 1 ? ws.d1 : ws.d2).at.get();
    const float open = piece == 1 ? kGapOpen1 : kGapOpen2;
    const float ext = piece == 1 ? kGapExt1 : kGapExt2;
    int src = -1;
    float v = kNegInf;
    for (int k = ws.pred_start[r]; k < ws.pred_start[r + 1]; ++k) {
      const int pr = ws.pred_rows[k];
      const float cand = std::max(value(ws.best.at.get(), pr, j) + open,
                                  value(d, pr, j) + ext);
      if (cand > v) { v = cand; src = pr; }
    }
    return src;
  };

  int end_row = 0;
  float end_best = kNegInf;
  for (int r = 0; r < rows; ++r) {
    if (r > 0 && ws.has_succ[r]) continue;
    const float b = value(ws.best.at.get(), r, len);
    if (b > end_best) { end_best = b; end_row = r; }
  }
  steps->clear();
  if (end_best <= kNegInf / 2) {  // band disconnected the problem entirely
    *touched = true;
    return true;
  }

  int r = end_row;
  int64_t j = len;
  int state = state_at(r, j);
  while (r > 0 || j > 0) {
    if (r > 0 && ((j == ws.lo[r] && ws.lo[r] > 0)
                  || (j == ws.hi[r] && ws.hi[r] < len)))
      *touched = true;  // optimal path grazes the band: widen and retry
    const uint8_t cell = ws.trace.at[ws.row_base[r] + j - ws.lo[r]];
    if (state == 0) {
      steps->push_back({graph.topo[r - 1], (int)(j - 1)});
      const int src = m_source(r, j);
      if (src < 0) { *touched = true; steps->clear(); return true; }
      j -= 1;
      r = src;
      state = state_at(r, j);
    } else if (state == 1 || state == 2) {
      steps->push_back({graph.topo[r - 1], -1});
      const int src = d_source(r, j, state);
      if (src < 0) { *touched = true; steps->clear(); return true; }
      const bool extended = cell & (state == 1 ? kD1Ext : kD2Ext);
      r = src;
      if (!extended) state = state_at(r, j);
    } else {
      steps->push_back({-1, (int)(j - 1)});
      const bool extended = cell & (state == 3 ? kI1Ext : kI2Ext);
      j -= 1;
      if (!extended) state = state_at(r, j);
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
// run banded with band doubling (start 16, double whenever the optimal
// path grazes a band edge) — this is what lifts the former hard cell cap
// for long insertion clusters (reference capability: 10 kb haplotypes,
// SVIM_COMBINE.py:202).  *out_cells receives the DP cells computed, every
// rung and full matrix included.  Returns 0 on success, -1 when even the
// banded DP exceeds max_cells (caller falls back to the star MSA), -2 when
// out_cap is too small.
int poa_consensus_native(const char* seqs, const int64_t* seq_lens,
                         int n_seqs, int64_t max_cells, int64_t full_dp_cells,
                         char* out, int64_t out_cap, int64_t* out_len,
                         int64_t* out_cells) {
  poa::Graph graph;
  int64_t offset = 0;
  *out_cells = 0;
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
  poa::Workspace workspace;
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
    workspace.prepare(graph, len);
    const int64_t full_cells = (int64_t)(graph.topo.size() + 1) * (len + 1);
    bool aligned = false, touched = false;
    if (full_cells <= full_dp_cells) {
      aligned = poa::align_to_graph(graph, workspace, seqs + offset, len, -1,
                                    &steps, max_cells, &touched, out_cells);
    }
    if (!aligned) {
      for (int64_t band = start_band; band <= 2 * (len + 2); band *= 2) {
        if (!poa::align_to_graph(graph, workspace, seqs + offset, len, band,
                                 &steps, max_cells, &touched, out_cells))
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
