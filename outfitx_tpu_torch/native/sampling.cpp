// Native CIR batch assembly: positive selection, partial-outfit shuffle,
// and same-category negative sampling.
//
// This is the framework's host-side hot loop (the TPU-native equivalent of
// the reference's DataLoader-worker __getitem__ path,
// polyvore_complementary_item_retrieval_dataset.py:50-67): per example, pick
// an eligible positive, shuffle the remaining members, and draw k distinct
// negatives sharing the positive's sampling key. The Python version walks
// the batch in a per-example numpy loop; this C++ version does the same work
// in one pass over preallocated output buffers and is loaded via ctypes
// (no pybind11 in this environment).
//
// Determinism: every example's randomness derives from splitmix64(seed,
// outfit index, epoch) — independent of batch composition or order, which
// is stronger than the reference's unseeded global `random`.

#include <cstdint>
#include <cstring>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t s) : state(s) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint32_t below(uint32_t n) {
    if (n <= 1) return 0;
    uint64_t x = next() & 0xFFFFFFFFull;
    uint64_t m = x * n;
    uint32_t l = static_cast<uint32_t>(m);
    if (l < n) {
      uint32_t t = (~n + 1) % n;  // 2^32 mod n
      while (l < t) {
        x = next() & 0xFFFFFFFFull;
        m = x * n;
        l = static_cast<uint32_t>(m);
      }
    }
    return static_cast<uint32_t>(m >> 32);
  }
};

inline uint64_t mix(uint64_t a, uint64_t b, uint64_t c) {
  SplitMix64 s(a ^ (b * 0x9E3779B97F4A7C15ull) ^ (c * 0xD1B54A32D192ED03ull));
  return s.next();
}

// k distinct same-key negatives excluding pos_row, from a CSR pool slice.
// Writes k entries to `on` and pad flags to `onm` (1 = pad).
inline void draw_negatives(SplitMix64& rng, int32_t pos_row,
                           const int32_t* pool_rows, int32_t lo, int32_t hi,
                           int32_t k, int32_t* on, uint8_t* onm) {
  const int32_t pool_n = hi - lo;
  int32_t got = 0;
  if (pool_n - 1 <= 0) {
    // no candidates at all
  } else if (pool_n - 1 <= k) {
    for (int32_t t = lo; t < hi && got < k; ++t)
      if (pool_rows[t] != pos_row) on[got++] = pool_rows[t];
  } else {
    // rejection sampling with a small linear-probe dedup (k is ~10)
    int32_t tries = 0;
    const int32_t max_tries = 64 * k;
    while (got < k && tries < max_tries) {
      ++tries;
      const int32_t cand =
          pool_rows[lo + rng.below(static_cast<uint32_t>(pool_n))];
      if (cand == pos_row) continue;
      bool dup = false;
      for (int32_t t = 0; t < got; ++t)
        if (on[t] == cand) { dup = true; break; }
      if (!dup) on[got++] = cand;
    }
  }
  for (int32_t t = 0; t < k; ++t) onm[t] = t < got ? 0 : 1;
  for (int32_t t = got; t < k; ++t) on[t] = 0;
}

}  // namespace

extern "C" {

// Assemble one CIR super-batch.
//
// Inputs (catalog-/split-level, shared across calls):
//   item_rows     (n_outfits, L) int32   full outfits, PAD-padded
//   lengths       (n_outfits,)   int32
//   pos_eligible  (n_outfits, L) uint8   1 = member may serve as positive
//   key_of_row    (n_rows,)      int32   sampling key per catalog row
//   pool_offsets  (n_keys+1,)    int32   CSR offsets into pool_rows
//   pool_rows     (nnz,)         int32   catalog rows grouped by key
// Per-call:
//   sel           (n_sel,)       int64   outfit indices for this super-batch
//   k                            int32   negatives per example
//   pad_row                      int32   catalog PAD row index
//   seed, epoch                  uint64  determinism scope
// Outputs (preallocated by caller):
//   out_item_idx  (n_sel, L) int32,  out_mask (n_sel, L) uint8 (1 = pad)
//   out_pos_idx   (n_sel,)   int32
//   out_neg_idx   (n_sel, k) int32,  out_neg_mask (n_sel, k) uint8
void cir_assemble(const int32_t* item_rows, const int32_t* lengths,
                  const uint8_t* pos_eligible, int64_t /*n_outfits*/,
                  int32_t L, const int64_t* sel, int64_t n_sel,
                  const int32_t* key_of_row, const int32_t* pool_offsets,
                  const int32_t* pool_rows, int32_t k, int32_t pad_row,
                  uint64_t seed, uint64_t epoch, int32_t* out_item_idx,
                  uint8_t* out_mask, int32_t* out_pos_idx,
                  int32_t* out_neg_idx, uint8_t* out_neg_mask) {
  // scratch for shuffling one outfit (L is small, stack-friendly)
  int32_t members[64];
  int32_t elig[64];

  for (int64_t j = 0; j < n_sel; ++j) {
    const int64_t i = sel[j];
    SplitMix64 rng(mix(seed, static_cast<uint64_t>(i), epoch));
    const int32_t len = lengths[i];
    const int32_t* row = item_rows + i * L;
    const uint8_t* ok = pos_eligible + i * L;

    int32_t n_elig = 0;
    for (int32_t t = 0; t < len; ++t)
      if (ok[t]) elig[n_elig++] = t;
    const int32_t p = elig[rng.below(static_cast<uint32_t>(n_elig))];
    const int32_t pos_row = row[p];
    out_pos_idx[j] = pos_row;

    int32_t m = 0;
    for (int32_t t = 0; t < len; ++t)
      if (t != p) members[m++] = row[t];
    // Fisher–Yates shuffle of the partial outfit
    for (int32_t t = m - 1; t > 0; --t) {
      const uint32_t r = rng.below(static_cast<uint32_t>(t + 1));
      const int32_t tmp = members[t];
      members[t] = members[r];
      members[r] = tmp;
    }
    int32_t* oi = out_item_idx + j * L;
    uint8_t* om = out_mask + j * L;
    for (int32_t t = 0; t < L; ++t) {
      oi[t] = t < m ? members[t] : pad_row;
      om[t] = t < m ? 0 : 1;
    }

    // negatives: k distinct draws from the positive's pool, excluding it
    const int32_t key = key_of_row[pos_row];
    draw_negatives(rng, pos_row, pool_rows, pool_offsets[key],
                   pool_offsets[key + 1], k, out_neg_idx + j * k,
                   out_neg_mask + j * k);
  }
}

// Batched negative sampling for fixed positives (the CIR eval-loss path:
// reference valid_epoch resamples negatives per query every epoch,
// complementary_item_retrieval_trainer.py:122-170). One pass, no Python
// per-query loop.
void negatives_assemble(const int32_t* pos_rows, int64_t n,
                        const int32_t* key_of_row,
                        const int32_t* pool_offsets, const int32_t* pool_rows,
                        int32_t k, uint64_t seed, uint64_t epoch,
                        int32_t* out_neg_idx, uint8_t* out_neg_mask) {
  for (int64_t j = 0; j < n; ++j) {
    SplitMix64 rng(mix(seed ^ 0xE7A1ull, static_cast<uint64_t>(j), epoch));
    const int32_t pos_row = pos_rows[j];
    const int32_t key = key_of_row[pos_row];
    draw_negatives(rng, pos_row, pool_rows, pool_offsets[key],
                   pool_offsets[key + 1], k, out_neg_idx + j * k,
                   out_neg_mask + j * k);
  }
}

// Deterministic positive choice for eval queries (no negatives, no shuffle):
// mirrors sampler.cir_eval_queries.
void cir_eval_assemble(const int32_t* item_rows, const int32_t* lengths,
                       const uint8_t* pos_eligible, int64_t n_outfits,
                       int32_t L, int32_t pad_row, uint64_t seed,
                       int32_t* out_item_idx, uint8_t* out_mask,
                       int32_t* out_pos_idx) {
  for (int64_t i = 0; i < n_outfits; ++i) {
    SplitMix64 rng(mix(seed, static_cast<uint64_t>(i), 0x5EEDull));
    const int32_t len = lengths[i];
    const int32_t* row = item_rows + i * L;
    const uint8_t* ok = pos_eligible + i * L;
    int32_t elig[64];
    int32_t n_elig = 0;
    for (int32_t t = 0; t < len; ++t)
      if (ok[t]) elig[n_elig++] = t;
    const int32_t p = elig[rng.below(static_cast<uint32_t>(n_elig))];
    out_pos_idx[i] = row[p];
    int32_t m = 0;
    int32_t* oi = out_item_idx + i * L;
    uint8_t* om = out_mask + i * L;
    for (int32_t t = 0; t < len; ++t)
      if (t != p) oi[m++] = row[t];
    for (int32_t t = m; t < L; ++t) oi[t] = pad_row;
    for (int32_t t = 0; t < L; ++t) om[t] = t < m ? 0 : 1;
  }
}
}  // extern "C"
