// Byte-level BPE encoder: the tokenize hot loop in C++.
//
// Same semantics as tokenizer/bpe.py's Python `_merge` (the golden reference,
// asserted equal in tests/test_torch_native.py): repeatedly apply the
// lowest-new-id (earliest-trained) merge, leftmost occurrence first, until no
// adjacent pair is mergeable. The Python loop rescans the sequence per merge
// (O(n^2)); here candidates live in a min-heap keyed by (new_id, position)
// over a doubly-linked symbol list — O(n log n), the same structure
// llama.cpp uses for its SPM tokenizer.

#include "text.h"

#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct BPE {
  std::unordered_map<uint64_t, int32_t> merges;
  int32_t n_special;
};

struct Cand {
  int32_t new_id;
  int32_t pos;  // index of the left symbol at push time
  int32_t a, b; // expected ids; stale entries are skipped on pop
};

struct CandOrder {
  bool operator()(const Cand &x, const Cand &y) const {
    if (x.new_id != y.new_id) return x.new_id > y.new_id; // min-heap by id
    return x.pos > y.pos;                                 // then leftmost
  }
};

} // namespace

extern "C" {

void *lsot_bpe_new(const int32_t *pairs, int32_t n_merges, int32_t n_special) {
  auto *bpe = new BPE;
  bpe->n_special = n_special;
  const int32_t base = n_special + 256;
  bpe->merges.reserve(static_cast<size_t>(n_merges) * 2);
  for (int32_t i = 0; i < n_merges; ++i) {
    bpe->merges.emplace(pair_key(pairs[2 * i], pairs[2 * i + 1]), base + i);
  }
  return bpe;
}

void lsot_bpe_free(void *h) { delete static_cast<BPE *>(h); }

int32_t lsot_bpe_encode(void *h, const uint8_t *bytes, int32_t n, int32_t *out,
                        int32_t cap) {
  const BPE *bpe = static_cast<const BPE *>(h);
  if (n <= 0) return 0;

  std::vector<int32_t> id(n), prev(n), next(n);
  for (int32_t i = 0; i < n; ++i) {
    id[i] = bpe->n_special + bytes[i];
    prev[i] = i - 1;
    next[i] = (i + 1 < n) ? i + 1 : -1;
  }
  std::vector<char> alive(n, 1);

  std::priority_queue<Cand, std::vector<Cand>, CandOrder> heap;
  auto push_pair = [&](int32_t i) {
    int32_t j = next[i];
    if (j < 0) return;
    auto it = bpe->merges.find(pair_key(id[i], id[j]));
    if (it != bpe->merges.end()) heap.push({it->second, i, id[i], id[j]});
  };
  for (int32_t i = 0; i + 1 < n; ++i) push_pair(i);

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    if (!alive[c.pos] || id[c.pos] != c.a) continue;
    int32_t r = next[c.pos];
    if (r < 0 || !alive[r] || id[r] != c.b) continue;
    // Merge: left symbol becomes the merged id, right symbol dies.
    id[c.pos] = c.new_id;
    alive[r] = 0;
    next[c.pos] = next[r];
    if (next[r] >= 0) prev[next[r]] = c.pos;
    if (prev[c.pos] >= 0) push_pair(prev[c.pos]);
    push_pair(c.pos);
  }

  int32_t count = 0;
  for (int32_t i = 0; i != -1; i = next[i]) {
    if (count >= cap) return -1;
    out[count++] = id[i];
  }
  return count;
}

} // extern "C"
