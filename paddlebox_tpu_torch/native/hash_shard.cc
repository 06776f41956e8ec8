// Native host hash shard: uint64 key → dense row id.
//
// TPU-native counterpart of the DRAM tier's per-shard hash map
// (reference: MemorySparseTable shards, ps/table/memory_sparse_table.h:39;
// GPU-side concurrent map hashtable.h:53).  Values stay in numpy SoA arrays
// owned by Python and indexed by the dense row ids this map hands out —
// the map only does key→row translation, so the C ABI stays tiny.
//
// Open addressing, power-of-two capacity, linear probing, 0.75 max load
// (the reference's load factor, hashtable.h:211).  The all-ones key marks a
// free slot, so that one key is kept beside the table (has_max / max_row):
// every uint64 feasign maps to its own row.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kEmpty = 0xFFFFFFFFFFFFFFFFull;

inline uint64_t mix(uint64_t k) {
  // splitmix64 finalizer — full-avalanche for clustered feasigns
  k += 0x9E3779B97F4A7C15ull;
  k = (k ^ (k >> 30)) * 0xBF58476D1CE4E5B9ull;
  k = (k ^ (k >> 27)) * 0x94D049BB133111EBull;
  return k ^ (k >> 31);
}

struct HashShard {
  std::vector<uint64_t> keys;   // capacity slots, kEmpty = free
  std::vector<int64_t> rows;
  std::vector<uint64_t> by_row;  // row id → key
  uint64_t mask = 0;
  int64_t size = 0;
  bool has_max = false;          // the key kEmpty, stored outside the slots
  int64_t max_row = -1;

  explicit HashShard(int64_t hint) {
    int64_t cap = 16;
    while (cap * 3 < hint * 4) cap <<= 1;  // cap >= hint / 0.75
    keys.assign(static_cast<size_t>(cap), kEmpty);
    rows.assign(static_cast<size_t>(cap), -1);
    mask = static_cast<uint64_t>(cap - 1);
  }

  void grow() {
    std::vector<uint64_t> old_keys;
    std::vector<int64_t> old_rows;
    old_keys.swap(keys);
    old_rows.swap(rows);
    size_t cap = old_keys.size() * 2;
    keys.assign(cap, kEmpty);
    rows.assign(cap, -1);
    mask = cap - 1;
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] == kEmpty) continue;
      uint64_t slot = mix(old_keys[i]) & mask;
      while (keys[slot] != kEmpty) slot = (slot + 1) & mask;
      keys[slot] = old_keys[i];
      rows[slot] = old_rows[i];
    }
  }

  int64_t upsert(uint64_t key) {
    if (key == kEmpty) {
      if (!has_max) {
        has_max = true;
        max_row = size;
        by_row.push_back(key);
        ++size;
      }
      return max_row;
    }
    if ((size + 1) * 4 > static_cast<int64_t>(keys.size()) * 3) grow();
    uint64_t slot = mix(key) & mask;
    while (true) {
      if (keys[slot] == key) return rows[slot];
      if (keys[slot] == kEmpty) {
        keys[slot] = key;
        rows[slot] = size;
        by_row.push_back(key);
        return size++;
      }
      slot = (slot + 1) & mask;
    }
  }

  int64_t find(uint64_t key) const {
    if (key == kEmpty) return has_max ? max_row : -1;
    uint64_t slot = mix(key) & mask;
    while (true) {
      if (keys[slot] == key) return rows[slot];
      if (keys[slot] == kEmpty) return -1;
      slot = (slot + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

void* pbox_hash_new(int64_t capacity_hint) {
  return new HashShard(capacity_hint < 16 ? 16 : capacity_hint);
}

void pbox_hash_free(void* h) { delete static_cast<HashShard*>(h); }

int64_t pbox_hash_size(void* h) { return static_cast<HashShard*>(h)->size; }

void pbox_hash_upsert(void* h, const uint64_t* in_keys, int64_t n,
                      int64_t* out_rows) {
  auto* m = static_cast<HashShard*>(h);
  for (int64_t i = 0; i < n; ++i) out_rows[i] = m->upsert(in_keys[i]);
}

void pbox_hash_find(void* h, const uint64_t* in_keys, int64_t n,
                    int64_t* out_rows) {
  auto* m = static_cast<HashShard*>(h);
  for (int64_t i = 0; i < n; ++i) out_rows[i] = m->find(in_keys[i]);
}

void pbox_hash_keys(void* h, uint64_t* out) {
  auto* m = static_cast<HashShard*>(h);
  memcpy(out, m->by_row.data(), m->by_row.size() * sizeof(uint64_t));
}

// Pass-key translation hot path (≙ DedupKeysAndFillIdx,
// box_wrapper_impl.h:129, done once per pass): key → insertion-row + 1,
// missing/zero keys → 0 (the reserved zero-embedding row).  Read-only over
// the table, so lookups fan out over threads.
void pbox_hash_find_rows1_i32(void* h, const uint64_t* in_keys, int64_t n,
                              int32_t* out_rows, int32_t n_threads) {
  auto* m = static_cast<HashShard*>(h);
  if (n_threads < 1) n_threads = 1;
  auto work = [m, in_keys, out_rows](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t k = in_keys[i];
      int64_t row = (k == 0) ? -1 : m->find(k);
      out_rows[i] = static_cast<int32_t>(row + 1);
    }
  };
  if (n_threads == 1 || n < (1 << 16)) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t step = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * step;
    int64_t hi = lo + step < n ? lo + step : n;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
