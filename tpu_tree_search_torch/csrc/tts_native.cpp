// tts_native — C++ host runtime of tpu_tree_search_torch.
//
// The reference implements its host path in C (pools: baselines/*/lib/Pool.c,
// bounds: baselines/pfsp/lib/c_bound_simple.c / c_bound_johnson.c, search
// programs: baselines/*/*.c). This library is the port's native equivalent: the
// host-side search primitives that surround the device kernels — BFS
// warm-up, DFS drain, full sequential search, and the prune/branch
// consumption of device results (generate_children). It is the same code
// as the JAX package's runtime, kept as the port's own copy, built with g++
// by `tpu_tree_search_torch/native/__init__.py` and bound with ctypes.
//
// It is NOT a translation of the reference C. Structural differences:
//   * pools are struct-of-arrays deques (contiguous per-field buffers that
//     cross the ctypes boundary as numpy arrays, no per-node marshalling),
//     not arrays of node structs;
//   * child bounds are computed incrementally from a once-per-parent state
//     (front/remain/fixed-set) in O(m) per child, instead of re-scanning the
//     whole prefix per child the way the reference's lb1_bound does
//     (c_bound_simple.c:143-158 re-runs schedule_front for every child);
//   * the per-instance lb tables (min_heads/min_tails, Johnson schedules,
//     lags, machine pairs) are built once in Python (bounds.py — the
//     port's semantic oracle) and passed in, so every tier shares
//     bit-identical tables.
//
// Counting/traversal parity: all loops visit children in ascending slot
// order and stacks pop from the back, exactly like the Python engines, so
// exploredTree/exploredSol/makespan match the golden tables for every
// (problem, lb, ub) configuration.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SoA node deques.  pop_front serves BFS warm-up, pop_back serves DFS;
// storage compacts lazily once the consumed prefix dominates.
// ---------------------------------------------------------------------------

template <typename T>
class SoaDeque {
 public:
  explicit SoaDeque(size_t row_width) : width_(row_width) {}

  size_t size() const { return count_; }
  size_t width() const { return width_; }

  void reserve_rows(size_t rows) { data_.reserve((start_ + count_ + rows) * width_); }

  // Append one row, returning a pointer to its storage for in-place fill.
  T* emplace_back() {
    maybe_compact();
    data_.resize((start_ + count_ + 1) * width_);
    ++count_;
    return &data_[(start_ + count_ - 1) * width_];
  }

  // Pop newest; pointer valid until the next mutation.
  const T* pop_back() {
    if (count_ == 0) return nullptr;
    --count_;
    return &data_[(start_ + count_) * width_];
  }

  // Pop oldest; pointer valid until the next mutation.
  const T* pop_front() {
    if (count_ == 0) return nullptr;
    const T* row = &data_[start_ * width_];
    ++start_;
    --count_;
    return row;
  }

  const T* row(size_t i) const { return &data_[(start_ + i) * width_]; }

 private:
  void maybe_compact() {
    if (start_ > 1024 && start_ >= count_) {
      std::memmove(data_.data(), data_.data() + start_ * width_,
                   count_ * width_ * sizeof(T));
      data_.resize(count_ * width_);
      start_ = 0;
    }
  }

  size_t width_;
  size_t start_ = 0;
  size_t count_ = 0;
  std::vector<T> data_;
};

// ---------------------------------------------------------------------------
// N-Queens
// ---------------------------------------------------------------------------

struct NqPool {
  explicit NqPool(int n) : depth(1), board(static_cast<size_t>(n)) {}
  SoaDeque<int32_t> depth;
  SoaDeque<uint8_t> board;
};

// Diagonal-safety of placing `row` as queen number `depth`.  The g-round
// repetition is the reference's artificial workload knob (--g); the compiler
// barrier keeps the redundant rounds from being folded away.
inline bool nq_is_safe(const uint8_t* board, int depth, int row, int g) {
  bool safe = true;
  for (int round = 0; round < g; ++round) {
    bool ok = true;
    for (int i = 0; i < depth; ++i) {
      const int other = board[i];
      const int gap = depth - i;
      ok &= (other != row - gap) & (other != row + gap);
    }
    safe = ok;
    asm volatile("" ::: "memory");
  }
  return safe;
}

// Expand one node onto the pool.  Returns children pushed; bumps *sol for a
// depth==N leaf.  Child order: ascending candidate slot (parity with the
// Python tier's j-ascending loop).
//
// For n <= 32 the parent's two diagonal occupancy masks are built once
// (O(depth)) and each child checks in O(1) — bit b of diag1 marks an
// occupied row-i+n anti-diagonal, bit b of diag2 a row+i diagonal; the
// per-child predicate is exactly nq_is_safe's (rows are distinct by the
// permutation invariant), so the explored tree is bit-identical. The
// g-round workload knob repeats the masked check with the same compiler
// barrier the scalar path uses.
int64_t nq_expand(NqPool& pool, int n, int g, int32_t depth,
                  const uint8_t* board, int64_t* sol) {
  if (depth == n) {
    ++*sol;
    return 0;
  }
  int64_t pushed = 0;
  uint64_t diag1 = 0, diag2 = 0;
  const bool masks = n <= 32;
  if (masks) {
    for (int i = 0; i < depth; ++i) {
      diag1 |= 1ull << (board[i] - i + n);
      diag2 |= 1ull << (board[i] + i);
    }
  }
  for (int j = depth; j < n; ++j) {
    if (masks) {
      const int row = board[j];
      bool safe = true;
      for (int round = 0; round < g; ++round) {
        // The barrier must clobber the REGISTER inputs: a plain "memory"
        // clobber would let LICM hoist this pure register arithmetic and
        // turn the --g workload knob into a no-op on the fast path.
        asm volatile("" : "+r"(diag1), "+r"(diag2));
        safe = !(((diag1 >> (row - depth + n)) |
                  (diag2 >> (row + depth))) & 1ull);
      }
      if (!safe) continue;
    } else if (!nq_is_safe(board, depth, board[j], g)) continue;
    *pool.depth.emplace_back() = depth + 1;
    uint8_t* child = pool.board.emplace_back();
    std::memcpy(child, board, static_cast<size_t>(n));
    child[depth] = board[j];
    child[j] = board[depth];
    ++pushed;
  }
  return pushed;
}

void nq_seed(NqPool& pool, int n, const int32_t* depth, const uint8_t* board,
             int64_t size) {
  pool.depth.reserve_rows(static_cast<size_t>(size));
  pool.board.reserve_rows(static_cast<size_t>(size));
  for (int64_t i = 0; i < size; ++i) {
    *pool.depth.emplace_back() = depth[i];
    std::memcpy(pool.board.emplace_back(), board + i * n,
                static_cast<size_t>(n));
  }
}

// DFS the pool to exhaustion.
void nq_run(NqPool& pool, int n, int g, int64_t* tree, int64_t* sol) {
  std::vector<uint8_t> cur(static_cast<size_t>(n));
  while (true) {
    const int32_t* d = pool.depth.pop_back();
    if (d == nullptr) break;
    const int32_t depth = *d;
    std::memcpy(cur.data(), pool.board.pop_back(), static_cast<size_t>(n));
    *tree += nq_expand(pool, n, g, depth, cur.data(), sol);
  }
}

// ---------------------------------------------------------------------------
// PFSP
// ---------------------------------------------------------------------------

struct PfspCtx {
  int n = 0;  // jobs
  int m = 0;  // machines
  int npairs = 0;
  int lb_kind = 0;  // 0 = lb1, 1 = lb1_d, 2 = lb2
  std::vector<int32_t> ptm;        // [m][n] processing times
  std::vector<int32_t> min_heads;  // [m]
  std::vector<int32_t> min_tails;  // [m]
  std::vector<int32_t> pairs;      // [npairs][2]
  std::vector<int32_t> lags;       // [npairs][n]
  std::vector<int32_t> jsched;     // [npairs][n] job ids in Johnson order
};

struct PfspPool {
  explicit PfspPool(int n) : meta(2), prmu(static_cast<size_t>(n)) {}
  SoaDeque<int32_t> meta;  // row = [depth, limit1]
  SoaDeque<int32_t> prmu;
};

// Per-call scratch, reused across nodes.  Exported calls may run
// concurrently from different host threads (the multi-device runtime), so
// nothing lives in globals.
struct PfspScratch {
  explicit PfspScratch(const PfspCtx& c)
      : front(static_cast<size_t>(c.m)),
        child_front(static_cast<size_t>(c.m)),
        remain(static_cast<size_t>(c.m)),
        fixed(static_cast<size_t>(c.n)),
        lb_begin(static_cast<size_t>(c.n)),
        prmu(static_cast<size_t>(c.n)) {}
  std::vector<int32_t> front;        // parent head-schedule completion times
  std::vector<int32_t> child_front;  // one append step beyond the parent
  std::vector<int32_t> remain;       // per-machine unscheduled work
  std::vector<uint8_t> fixed;        // job id -> scheduled in the prefix?
  std::vector<int32_t> lb_begin;     // per-job child bounds (lb1_d)
  std::vector<int32_t> prmu;         // working copy of the node permutation
};

// Extend a head schedule by one job: the classic flowshop recurrence.
inline void pfsp_append_job(const PfspCtx& c, int32_t* front, int job) {
  const int32_t* pt = c.ptm.data();
  int32_t prev = front[0] + pt[job];
  front[0] = prev;
  for (int k = 1; k < c.m; ++k) {
    prev = (prev > front[k] ? prev : front[k]) + pt[k * c.n + job];
    front[k] = prev;
  }
}

// Parent state shared by all of its children: true (zeros-based) head
// schedule of the prefix, per-machine remaining work, prefix membership.
void pfsp_parent_state(const PfspCtx& c, const int32_t* prmu, int limit1,
                       PfspScratch& s) {
  std::memset(s.front.data(), 0, sizeof(int32_t) * c.m);
  std::memset(s.fixed.data(), 0, static_cast<size_t>(c.n));
  for (int i = 0; i <= limit1; ++i) {
    pfsp_append_job(c, s.front.data(), prmu[i]);
    s.fixed[prmu[i]] = 1;
  }
  for (int k = 0; k < c.m; ++k) {
    int32_t acc = 0;
    const int32_t* row = c.ptm.data() + static_cast<size_t>(k) * c.n;
    for (int i = limit1 + 1; i < c.n; ++i) acc += row[prmu[i]];
    s.remain[k] = acc;
  }
}

// lb1 of the child that appends `job`: one fused register pass over the
// machines — the append step's running head (`cf_k = max(cf_{k-1},
// front[k]) + pt[k][job]`), the head+remain part, and the tail chain
// (back = min_tails, since forward branching keeps limit2 == n).
// Value-identical to a full recompute. ONE copy of the recurrence:
// kStoreFront additionally materializes the child front into
// s.child_front (the staged lb2 path reuses it when the child survives
// the prefilter); the pure-lb1 hot loop skips the stores.
template <bool kStoreFront>
int32_t pfsp_lb1_child_impl(const PfspCtx& c, PfspScratch& s, int job) {
  const int32_t* pt = c.ptm.data();
  const int32_t* front = s.front.data();
  int32_t* cf_out = s.child_front.data();
  int32_t cf = front[0] + pt[job];  // child head on machine 0
  if (kStoreFront) cf_out[0] = cf;
  int32_t chain = cf + s.remain[0] - pt[job];
  int32_t lb = chain + c.min_tails[0];
  for (int k = 1; k < c.m; ++k) {
    const int32_t fk = front[k];
    cf = (cf > fk ? cf : fk) + pt[k * c.n + job];
    if (kStoreFront) cf_out[k] = cf;
    const int32_t part = cf + s.remain[k] - pt[k * c.n + job];
    if (part > chain) chain = part;
    const int32_t cand = chain + c.min_tails[k];
    if (cand > lb) lb = cand;
  }
  return lb;
}

int32_t pfsp_lb1_child(const PfspCtx& c, PfspScratch& s, int job) {
  return pfsp_lb1_child_impl<true>(c, s, job);
}

int32_t pfsp_lb1_child_fused(const PfspCtx& c, PfspScratch& s, int job) {
  return pfsp_lb1_child_impl<false>(c, s, job);
}

// lb1_d ("children bounds in one pass"): the weaker O(m)-per-child bound that
// never materializes the child schedule.  The parent front here uses the
// reference's schedule_front special case (limit1 == -1 -> min_heads), which
// only the root hits.
void pfsp_lb1d_all_children(const PfspCtx& c, const int32_t* prmu, int limit1,
                            PfspScratch& s) {
  const int32_t* front = (limit1 == -1) ? c.min_heads.data() : s.front.data();
  const int32_t* pt = c.ptm.data();
  for (int i = limit1 + 1; i < c.n; ++i) {
    const int job = prmu[i];
    int32_t lb = front[0] + s.remain[0] + c.min_tails[0];
    int32_t chain = front[0] + pt[job];
    for (int k = 1; k < c.m; ++k) {
      const int32_t head = (chain > front[k] ? chain : front[k]);
      const int32_t cand = head + s.remain[k] + c.min_tails[k];
      if (cand > lb) lb = cand;
      chain = head + pt[k * c.n + job];
    }
    s.lb_begin[job] = lb;
  }
}

// lb2 (Johnson two-machine bound) of the child that appends `job`: the
// lag-augmented Johnson schedule of the free jobs per machine pair, seeded
// with the child head schedule; early-exits once the running max already
// prunes against `incumbent` (the returned value is then still >= incumbent,
// so the caller's prune decision is unaffected).
int32_t pfsp_lb2_child(const PfspCtx& c, PfspScratch& s, int job,
                       int32_t incumbent, bool have_front = false) {
  int32_t* cf = s.child_front.data();
  if (!have_front) {  // staged caller: pfsp_lb1_child already built it
    std::memcpy(cf, s.front.data(), sizeof(int32_t) * c.m);
    pfsp_append_job(c, cf, job);
  }
  s.fixed[job] = 1;
  const int32_t* pt = c.ptm.data();
  int32_t lb = 0;
  for (int p = 0; p < c.npairs; ++p) {
    const int ma0 = c.pairs[2 * p];
    const int ma1 = c.pairs[2 * p + 1];
    const int32_t* lag = c.lags.data() + static_cast<size_t>(p) * c.n;
    const int32_t* order = c.jsched.data() + static_cast<size_t>(p) * c.n;
    const int32_t* p0 = pt + static_cast<size_t>(ma0) * c.n;
    const int32_t* p1 = pt + static_cast<size_t>(ma1) * c.n;
    int32_t t0 = cf[ma0];
    int32_t t1 = cf[ma1];
    for (int j = 0; j < c.n; ++j) {
      const int jj = order[j];
      if (s.fixed[jj]) continue;
      t0 += p0[jj];
      const int32_t ready = t0 + lag[jj];
      if (ready > t1) t1 = ready;
      t1 += p1[jj];
    }
    const int32_t a = t1 + c.min_tails[ma1];
    const int32_t b = t0 + c.min_tails[ma0];
    const int32_t pair_lb = (a > b ? a : b);
    if (pair_lb > lb) lb = pair_lb;
    if (lb > incumbent) break;
  }
  s.fixed[job] = 0;
  return lb;
}

// Expand one node: evaluate every child, fold leaves into the incumbent,
// push survivors (bound < best, strict) in ascending slot order.
int64_t pfsp_expand(const PfspCtx& c, PfspPool& pool, const int32_t* prmu,
                    int depth, int limit1, int32_t* best, int64_t* sol,
                    PfspScratch& s) {
  pfsp_parent_state(c, prmu, limit1, s);
  if (c.lb_kind == 1) pfsp_lb1d_all_children(c, prmu, limit1, s);
  const bool child_is_leaf = (depth + 1 == c.n);
  int64_t pushed = 0;
  for (int i = limit1 + 1; i < c.n; ++i) {
    const int job = prmu[i];
    int32_t lb;
    switch (c.lb_kind) {
      case 0:
        lb = pfsp_lb1_child_fused(c, s, job);
        break;
      case 1:
        lb = s.lb_begin[job];
        break;
      default:
        // Staged lb2 (the host analogue of the device tiers' staging and
        // of the reference's per-pair early exit): the O(m) incremental
        // lb1 runs first, and only survivors pay the O(P*n) Johnson pair
        // loop. Exact — lb2 >= lb1 pointwise, so an lb1-pruned child is
        // lb2-pruned too, and the returned (>= best) value makes the same
        // prune decision. Leaves skip the filter: their reported value is
        // the makespan and must come from the lb2 evaluation itself.
        if (!child_is_leaf) {
          lb = pfsp_lb1_child(c, s, job);
          if (lb >= *best) break;
          // s.child_front still holds this child's head schedule.
          lb = pfsp_lb2_child(c, s, job, *best, /*have_front=*/true);
        } else {
          lb = pfsp_lb2_child(c, s, job, *best);
        }
        break;
    }
    if (child_is_leaf) {
      ++*sol;
      if (lb < *best) *best = lb;
    } else if (lb < *best) {
      int32_t* meta = pool.meta.emplace_back();
      meta[0] = depth + 1;
      meta[1] = limit1 + 1;
      int32_t* cp = pool.prmu.emplace_back();
      std::memcpy(cp, prmu, sizeof(int32_t) * c.n);
      cp[depth] = prmu[i];
      cp[i] = prmu[depth];
      ++pushed;
    }
  }
  return pushed;
}

void pfsp_seed(PfspPool& pool, int n, const int32_t* depth,
               const int32_t* limit1, const int32_t* prmu, int64_t size) {
  pool.meta.reserve_rows(static_cast<size_t>(size));
  pool.prmu.reserve_rows(static_cast<size_t>(size));
  for (int64_t i = 0; i < size; ++i) {
    int32_t* meta = pool.meta.emplace_back();
    meta[0] = depth[i];
    meta[1] = limit1[i];
    std::memcpy(pool.prmu.emplace_back(), prmu + i * n, sizeof(int32_t) * n);
  }
}

// DFS the pool to exhaustion.
void pfsp_run(const PfspCtx& c, PfspPool& pool, int32_t* best, int64_t* tree,
              int64_t* sol, PfspScratch& s) {
  while (true) {
    const int32_t* meta = pool.meta.pop_back();
    if (meta == nullptr) break;
    const int32_t depth = meta[0];
    const int32_t limit1 = meta[1];
    std::memcpy(s.prmu.data(), pool.prmu.pop_back(), sizeof(int32_t) * c.n);
    *tree += pfsp_expand(c, pool, s.prmu.data(), depth, limit1, best, sol, s);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// ---- N-Queens -------------------------------------------------------------

// Full DFS from the root (the sequential tier in one call).
void tts_nq_sequential(int32_t n, int32_t g, int64_t* tree, int64_t* sol) {
  NqPool pool(n);
  *pool.depth.emplace_back() = 0;
  uint8_t* root = pool.board.emplace_back();
  for (int i = 0; i < n; ++i) root[i] = static_cast<uint8_t>(i);
  *tree = 0;
  *sol = 0;
  nq_run(pool, n, g, tree, sol);
}

// BFS (pop-front) expansion until the frontier holds >= target nodes or goes
// empty.  The frontier enters and leaves through the caller's SoA buffers,
// whose capacity must be >= max(size_in, target + n - 1).  Returns the new
// frontier size; *tree / *sol receive the phase increments.
int64_t tts_nq_warmup(int32_t n, int32_t g, int64_t target, int32_t* depth,
                      uint8_t* board, int64_t size_in, int64_t* tree,
                      int64_t* sol) {
  NqPool pool(n);
  nq_seed(pool, n, depth, board, size_in);
  *tree = 0;
  *sol = 0;
  std::vector<uint8_t> cur(static_cast<size_t>(n));
  while (pool.depth.size() > 0 &&
         pool.depth.size() < static_cast<size_t>(target)) {
    const int32_t d = *pool.depth.pop_front();
    std::memcpy(cur.data(), pool.board.pop_front(), static_cast<size_t>(n));
    *tree += nq_expand(pool, n, g, d, cur.data(), sol);
  }
  const int64_t out = static_cast<int64_t>(pool.depth.size());
  for (int64_t i = 0; i < out; ++i) {
    depth[i] = *pool.depth.row(i);
    std::memcpy(board + i * n, pool.board.row(i), static_cast<size_t>(n));
  }
  return out;
}

// DFS a whole frontier batch to completion (the drain phase).
void tts_nq_drain(int32_t n, int32_t g, const int32_t* depth,
                  const uint8_t* board, int64_t size, int64_t* tree,
                  int64_t* sol) {
  NqPool pool(n);
  nq_seed(pool, n, depth, board, size);
  *tree = 0;
  *sol = 0;
  nq_run(pool, n, g, tree, sol);
}

// Consume device safety labels for a chunk of parents: emit surviving
// children into the caller's buffers (capacity count * n rows) in
// (parent, slot) ascending order.  Returns the child count; *sol_inc counts
// depth==N parents.
int64_t tts_nq_generate(int32_t n, const int32_t* pdepth,
                        const uint8_t* pboard, int64_t count,
                        const uint8_t* labels, int32_t* cdepth,
                        uint8_t* cboard, int64_t* sol_inc) {
  int64_t out = 0;
  *sol_inc = 0;
  for (int64_t i = 0; i < count; ++i) {
    const int32_t depth = pdepth[i];
    if (depth == n) {
      ++*sol_inc;
      continue;
    }
    const uint8_t* board = pboard + i * n;
    const uint8_t* lab = labels + i * n;
    for (int j = depth; j < n; ++j) {
      if (!lab[j]) continue;
      cdepth[out] = depth + 1;
      uint8_t* child = cboard + out * n;
      std::memcpy(child, board, static_cast<size_t>(n));
      child[depth] = board[j];
      child[j] = board[depth];
      ++out;
    }
  }
  return out;
}

// ---- PFSP -----------------------------------------------------------------

void* tts_pfsp_new(int32_t jobs, int32_t machines, int32_t lb_kind,
                   const int32_t* ptm, const int32_t* min_heads,
                   const int32_t* min_tails, int32_t npairs,
                   const int32_t* pairs, const int32_t* lags,
                   const int32_t* jsched) {
  auto* c = new PfspCtx();
  c->n = jobs;
  c->m = machines;
  c->npairs = npairs;
  c->lb_kind = lb_kind;
  c->ptm.assign(ptm, ptm + static_cast<size_t>(machines) * jobs);
  c->min_heads.assign(min_heads, min_heads + machines);
  c->min_tails.assign(min_tails, min_tails + machines);
  if (npairs > 0) {
    c->pairs.assign(pairs, pairs + static_cast<size_t>(npairs) * 2);
    c->lags.assign(lags, lags + static_cast<size_t>(npairs) * jobs);
    c->jsched.assign(jsched, jsched + static_cast<size_t>(npairs) * jobs);
  }
  return c;
}

void tts_pfsp_free(void* ctx) { delete static_cast<PfspCtx*>(ctx); }

// Full B&B DFS from the root (the sequential tier in one call).
void tts_pfsp_sequential(void* ctx, int32_t best_in, int64_t* tree,
                         int64_t* sol, int32_t* best_out) {
  const PfspCtx& c = *static_cast<PfspCtx*>(ctx);
  PfspPool pool(c.n);
  int32_t* meta = pool.meta.emplace_back();
  meta[0] = 0;
  meta[1] = -1;
  int32_t* prmu = pool.prmu.emplace_back();
  for (int i = 0; i < c.n; ++i) prmu[i] = i;
  PfspScratch s(c);
  int32_t best = best_in;
  *tree = 0;
  *sol = 0;
  pfsp_run(c, pool, &best, tree, sol, s);
  *best_out = best;
}

// BFS warm-up; same contract as tts_nq_warmup (buffer capacity
// >= max(size_in, target + n - 1)); *best_io carries the incumbent.
int64_t tts_pfsp_warmup(void* ctx, int64_t target, int32_t* depth,
                        int32_t* limit1, int32_t* prmu, int64_t size_in,
                        int64_t* tree, int64_t* sol, int32_t* best_io) {
  const PfspCtx& c = *static_cast<PfspCtx*>(ctx);
  PfspPool pool(c.n);
  pfsp_seed(pool, c.n, depth, limit1, prmu, size_in);
  PfspScratch s(c);
  int32_t best = *best_io;
  *tree = 0;
  *sol = 0;
  while (pool.meta.size() > 0 &&
         pool.meta.size() < static_cast<size_t>(target)) {
    const int32_t* meta = pool.meta.pop_front();
    const int32_t d = meta[0];
    const int32_t l1 = meta[1];
    std::memcpy(s.prmu.data(), pool.prmu.pop_front(), sizeof(int32_t) * c.n);
    *tree += pfsp_expand(c, pool, s.prmu.data(), d, l1, &best, sol, s);
  }
  const int64_t out = static_cast<int64_t>(pool.meta.size());
  for (int64_t i = 0; i < out; ++i) {
    const int32_t* meta = pool.meta.row(i);
    depth[i] = meta[0];
    limit1[i] = meta[1];
    std::memcpy(prmu + i * c.n, pool.prmu.row(i), sizeof(int32_t) * c.n);
  }
  *best_io = best;
  return out;
}

// DFS a whole frontier batch to completion (the drain phase).
void tts_pfsp_drain(void* ctx, const int32_t* depth, const int32_t* limit1,
                    const int32_t* prmu, int64_t size, int64_t* tree,
                    int64_t* sol, int32_t* best_io) {
  const PfspCtx& c = *static_cast<PfspCtx*>(ctx);
  PfspPool pool(c.n);
  pfsp_seed(pool, c.n, depth, limit1, prmu, size);
  PfspScratch s(c);
  int32_t best = *best_io;
  *tree = 0;
  *sol = 0;
  pfsp_run(c, pool, &best, tree, sol, s);
  *best_io = best;
}

// Consume device bounds for a chunk of parents: leaves fold into the
// incumbent first (whole chunk), then survivors (bound < folded best) are
// emitted in (parent, slot) ascending order into the caller's buffers
// (capacity count * n rows).  Mirrors PFSPProblem.generate_children.
int64_t tts_pfsp_generate(void* ctx, const int32_t* pdepth,
                          const int32_t* plimit1, const int32_t* pprmu,
                          int64_t count, const int32_t* bounds,
                          int32_t* cdepth, int32_t* climit1, int32_t* cprmu,
                          int64_t* sol_inc, int32_t* best_io) {
  const PfspCtx& c = *static_cast<PfspCtx*>(ctx);
  const int n = c.n;
  int32_t best = *best_io;
  *sol_inc = 0;
  // Pass 1: leaf slots update the incumbent before any pruning decision.
  for (int64_t i = 0; i < count; ++i) {
    if (pdepth[i] + 1 != n) continue;
    const int32_t* b = bounds + i * n;
    for (int j = plimit1[i] + 1; j < n; ++j) {
      ++*sol_inc;
      if (b[j] < best) best = b[j];
    }
  }
  // Pass 2: non-leaf survivors.
  int64_t out = 0;
  for (int64_t i = 0; i < count; ++i) {
    const int32_t depth = pdepth[i];
    if (depth + 1 == n) continue;
    const int32_t l1 = plimit1[i];
    const int32_t* prmu = pprmu + i * n;
    const int32_t* b = bounds + i * n;
    for (int j = l1 + 1; j < n; ++j) {
      if (b[j] >= best) continue;
      cdepth[out] = depth + 1;
      climit1[out] = l1 + 1;
      int32_t* cp = cprmu + out * n;
      std::memcpy(cp, prmu, sizeof(int32_t) * n);
      cp[depth] = prmu[j];
      cp[j] = prmu[depth];
      ++out;
    }
  }
  *best_io = best;
  return out;
}

}  // extern "C"
