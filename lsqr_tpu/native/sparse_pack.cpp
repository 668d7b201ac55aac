// Native sparse-ingest kernels for lsqr_tpu.
//
// The reference library is 100% compiled Fortran (SURVEY.md §2.1); here the
// device math is compiled by XLA, and THIS file is the compiled host-side
// runtime: packing COO triplets into the device layouts (ELL, blocked-ELL,
// CSR, JDIA) and preparing row partitions. These are
// the O(nnz) host loops that would otherwise run as interpreted Python for
// matrices with 10M+ nonzeros.
//
// Plain C ABI (called via ctypes); all index arrays are int32 (device
// convention), sizes are int64.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Row/column histogram; returns the max count (the ELL width k).
// ---------------------------------------------------------------------------
int64_t lsqr_row_counts(const int32_t* rows, int64_t nnz, int32_t m,
                        int64_t* counts /* size m, zeroed by caller */) {
  int64_t maxc = 0;
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t c = ++counts[rows[i]];
    if (c > maxc) maxc = c;
  }
  return maxc;
}

// ---------------------------------------------------------------------------
// ELL packing: out_vals/out_cols are (m, k) row-major, pre-zeroed.
// ---------------------------------------------------------------------------
#define DEFINE_ELL_PACK(SUFFIX, T)                                            \
  void lsqr_ell_pack_##SUFFIX(const int32_t* rows, const int32_t* cols,       \
                              const T* vals, int64_t nnz, int32_t m,          \
                              int64_t k, T* out_vals, int32_t* out_cols,      \
                              int64_t* fill /* size m, zeroed */) {           \
    (void)m;                                                                  \
    for (int64_t i = 0; i < nnz; ++i) {                                       \
      int32_t r = rows[i];                                                    \
      int64_t slot = fill[r]++;                                               \
      out_vals[r * k + slot] = vals[i];                                       \
      out_cols[r * k + slot] = cols[i];                                       \
    }                                                                         \
  }

DEFINE_ELL_PACK(f32, float)
DEFINE_ELL_PACK(f64, double)

// ---------------------------------------------------------------------------
// CSR from COO (rows need not be sorted): builds indptr and permutes
// cols/vals into CSR order. indptr has size m+1.
// ---------------------------------------------------------------------------
#define DEFINE_CSR_PACK(SUFFIX, T)                                            \
  void lsqr_csr_from_coo_##SUFFIX(                                            \
      const int32_t* rows, const int32_t* cols, const T* vals, int64_t nnz,   \
      int32_t m, int64_t* indptr /* m+1, zeroed */, int32_t* out_cols,        \
      T* out_vals) {                                                          \
    for (int64_t i = 0; i < nnz; ++i) indptr[rows[i] + 1]++;                  \
    for (int32_t r = 0; r < m; ++r) indptr[r + 1] += indptr[r];               \
    std::vector<int64_t> fill(indptr, indptr + m);                            \
    for (int64_t i = 0; i < nnz; ++i) {                                       \
      int64_t p = fill[rows[i]]++;                                            \
      out_cols[p] = cols[i];                                                  \
      out_vals[p] = vals[i];                                                  \
    }                                                                         \
  }

DEFINE_CSR_PACK(f32, float)
DEFINE_CSR_PACK(f64, double)

// ---------------------------------------------------------------------------
// Blocked-ELL packing.
// Pass 1 (count): number of distinct blocks per block-row; returns kb (max).
// Pass 2 (pack): fill blocks (mb, kb, bh, bw) and bcols (mb, kb), pre-zeroed.
// A slot map (block id -> slot) is rebuilt identically in both passes.
// ---------------------------------------------------------------------------
static inline int64_t block_id(int32_t br, int32_t bc, int64_t stride) {
  return (int64_t)br * stride + bc;
}

int64_t lsqr_block_count(const int32_t* rows, const int32_t* cols, int64_t nnz,
                         int32_t bh, int32_t bw, int32_t mb, int64_t stride,
                         int64_t* counts /* size mb, zeroed */) {
  std::unordered_map<int64_t, int32_t> seen;
  seen.reserve(nnz / 8 + 16);
  int64_t maxc = 0;
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t br = rows[i] / bh, bc = cols[i] / bw;
    int64_t id = block_id(br, bc, stride);
    auto it = seen.find(id);
    if (it == seen.end()) {
      seen.emplace(id, 1);
      int64_t c = ++counts[br];
      if (c > maxc) maxc = c;
    }
  }
  return maxc;
}

#define DEFINE_BLOCK_PACK(SUFFIX, T)                                          \
  void lsqr_block_pack_##SUFFIX(                                              \
      const int32_t* rows, const int32_t* cols, const T* vals, int64_t nnz,   \
      int32_t bh, int32_t bw, int32_t mb, int64_t stride, int64_t kb,         \
      T* blocks /* (mb, kb, bh, bw), zeroed */,                               \
      int32_t* bcols /* (mb, kb), zeroed */) {                                \
    std::unordered_map<int64_t, int64_t> slot_of;                             \
    slot_of.reserve(nnz / 8 + 16);                                            \
    std::vector<int64_t> next(mb, 0);                                         \
    const int64_t bsz = (int64_t)bh * bw;                                     \
    for (int64_t i = 0; i < nnz; ++i) {                                       \
      int32_t br = rows[i] / bh, bc = cols[i] / bw;                           \
      int64_t id = block_id(br, bc, stride);                                  \
      auto it = slot_of.find(id);                                             \
      int64_t slot;                                                           \
      if (it == slot_of.end()) {                                              \
        slot = next[br]++;                                                    \
        slot_of.emplace(id, slot);                                            \
        bcols[br * kb + slot] = bc;                                           \
      } else {                                                                \
        slot = it->second;                                                    \
      }                                                                       \
      int64_t lr = rows[i] - (int64_t)br * bh;                                \
      int64_t lc = cols[i] - (int64_t)bc * bw;                                \
      blocks[((int64_t)br * kb + slot) * bsz + lr * bw + lc] += vals[i];      \
    }                                                                         \
  }

DEFINE_BLOCK_PACK(f32, float)
DEFINE_BLOCK_PACK(f64, double)

// ---------------------------------------------------------------------------
// COO duplicate-sum: sorts by (row, col) and sums duplicates in place.
// Returns the deduplicated nnz.
// ---------------------------------------------------------------------------
#define DEFINE_DEDUP(SUFFIX, T)                                               \
  int64_t lsqr_coo_dedup_##SUFFIX(int32_t* rows, int32_t* cols, T* vals,      \
                                  int64_t nnz) {                              \
    if (nnz == 0) return 0;                                                   \
    std::vector<int64_t> order(nnz);                                          \
    for (int64_t i = 0; i < nnz; ++i) order[i] = i;                           \
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {         \
      if (rows[a] != rows[b]) return rows[a] < rows[b];                       \
      return cols[a] < cols[b];                                               \
    });                                                                       \
    std::vector<int32_t> r2(nnz), c2(nnz);                                    \
    std::vector<T> v2(nnz);                                                   \
    for (int64_t i = 0; i < nnz; ++i) {                                       \
      r2[i] = rows[order[i]];                                                 \
      c2[i] = cols[order[i]];                                                 \
      v2[i] = vals[order[i]];                                                 \
    }                                                                         \
    int64_t out = 0;                                                          \
    rows[0] = r2[0]; cols[0] = c2[0]; vals[0] = v2[0];                        \
    for (int64_t i = 1; i < nnz; ++i) {                                       \
      if (r2[i] == rows[out] && c2[i] == cols[out]) {                         \
        vals[out] += v2[i];                                                   \
      } else {                                                                \
        ++out;                                                                \
        rows[out] = r2[i]; cols[out] = c2[i]; vals[out] = v2[i];              \
      }                                                                       \
    }                                                                         \
    return out + 1;                                                           \
  }

DEFINE_DEDUP(f32, float)
DEFINE_DEDUP(f64, double)


// ---------------------------------------------------------------------------
// JDIA greedy slot assignment + slot-array fill
// (ops/jdia._pack_side's hot loop and scatter tail)
//
// Per row tile: repeatedly find the delta-window [c-J, c+J] covering the
// most unassigned entries (sliding count over sorted deltas, FIRST argmax,
// matching np.argmax), then assign at most one entry per row (first in
// original order, matching np.unique(return_index=True)) to that slot,
// writing the slot value and jitter offset directly into the output
// arrays. The pure-numpy form costs ~74 s at 11M nnz (per-tile sorts and
// 11M-element gathers through the interpreter); this is the production
// ingest path.
// ---------------------------------------------------------------------------

#define DEFINE_JDIA_ASSIGN(SFX, T)                                           \
  void lsqr_jdia_assign_##SFX(                                               \
      const int64_t* rows, const int64_t* deltas, const T* vals,             \
      int64_t nnz, int64_t m_pad, int32_t tm, int32_t ns_max,                \
      int32_t jitter, int32_t* assign_slot, int64_t* slot_d,                 \
      int32_t* slot_used, T* data, int8_t* eoff) {                           \
    const int64_t nt = m_pad / tm;                                           \
    for (int64_t i = 0; i < nnz; ++i) assign_slot[i] = -1;                   \
    for (int64_t t = 0; t < nt * (int64_t)ns_max; ++t) slot_d[t] = 0;        \
    for (int64_t t = 0; t < nt; ++t) slot_used[t] = 0;                       \
                                                                             \
    /* bucket entries by tile, preserving original order (stable) */         \
    std::vector<int64_t> counts(nt + 1, 0);                                  \
    for (int64_t i = 0; i < nnz; ++i) ++counts[rows[i] / tm + 1];            \
    for (int64_t t = 0; t < nt; ++t) counts[t + 1] += counts[t];             \
    std::vector<int64_t> order(nnz);                                         \
    {                                                                        \
      std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);         \
      for (int64_t i = 0; i < nnz; ++i) order[cursor[rows[i] / tm]++] = i;   \
    }                                                                        \
                                                                             \
    /* tiles are fully independent (disjoint entries, slot rows and       \
       data/eoff regions) — process them on a small thread pool */           \
    const int64_t n_threads = std::max<int64_t>(                             \
        1, std::min<int64_t>(                                                \
               nt, std::min<int64_t>(                                        \
                       16, std::thread::hardware_concurrency())));           \
    auto work = [&](int64_t t_begin, int64_t t_end) {                        \
    std::vector<int64_t> live_idx, live_next, ds;                            \
    std::vector<int64_t> row_seen(tm, -1);                                   \
    for (int64_t t = t_begin; t < t_end; ++t) {                              \
      const int64_t lo = counts[t], hi = counts[t + 1];                      \
      if (hi <= lo) continue;                                                \
      live_idx.assign(order.begin() + lo, order.begin() + hi);               \
      for (int32_t s = 0; s < ns_max && !live_idx.empty(); ++s) {            \
        ds.clear();                                                          \
        ds.reserve(live_idx.size());                                         \
        for (int64_t i : live_idx) ds.push_back(deltas[i]);                  \
        std::sort(ds.begin(), ds.end());                                     \
        /* first argmax of (upper_bound(ds, ds[i] + 2J) - i) */              \
        int64_t best = 0, best_cnt = -1;                                     \
        const int64_t* dbeg = ds.data();                                     \
        const int64_t* dend = dbeg + ds.size();                              \
        for (size_t i = 0; i < ds.size(); ++i) {                             \
          const int64_t* ub =                                                \
              std::upper_bound(dbeg + i, dend, ds[i] + 2 * (int64_t)jitter); \
          const int64_t cnt = (ub - dbeg) - (int64_t)i;                      \
          if (cnt > best_cnt) { best_cnt = cnt; best = (int64_t)i; }         \
        }                                                                    \
        const int64_t center = ds[best] + jitter;                            \
        const int64_t stamp_base = t * (int64_t)ns_max + s;                  \
        live_next.clear();                                                   \
        int64_t taken = 0;                                                   \
        for (int64_t i : live_idx) {                                         \
          const int64_t d = deltas[i];                                       \
          if (d < center - jitter || d > center + jitter) {                  \
            live_next.push_back(i);                                          \
            continue;                                                        \
          }                                                                  \
          const int64_t rl = rows[i] - t * (int64_t)tm;                      \
          if (row_seen[rl] == stamp_base) {                                  \
            live_next.push_back(i);  /* row already claimed this slot */     \
            continue;                                                        \
          }                                                                  \
          row_seen[rl] = stamp_base;                                         \
          assign_slot[i] = s;                                                \
          data[(int64_t)s * m_pad + rows[i]] = vals[i];                      \
          eoff[(int64_t)s * m_pad + rows[i]] = (int8_t)(d - center);         \
          ++taken;                                                           \
        }                                                                    \
        if (taken == 0) break;                                               \
        slot_d[t * (int64_t)ns_max + s] = center;                            \
        slot_used[t] = s + 1;                                                \
        live_idx.swap(live_next);                                            \
      }                                                                      \
    }                                                                        \
    };                                                                       \
    if (n_threads == 1) {                                                    \
      work(0, nt);                                                           \
    } else {                                                                 \
      std::vector<std::thread> pool;                                         \
      const int64_t chunk = (nt + n_threads - 1) / n_threads;                \
      for (int64_t w = 0; w < n_threads; ++w) {                              \
        const int64_t b = w * chunk;                                         \
        const int64_t e = std::min(nt, b + chunk);                           \
        if (b < e) pool.emplace_back(work, b, e);                            \
      }                                                                      \
      for (auto& th : pool) th.join();                                       \
    }                                                                        \
  }

DEFINE_JDIA_ASSIGN(f32, float)
DEFINE_JDIA_ASSIGN(f64, double)

}  // extern "C"
