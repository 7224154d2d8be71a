// Host twin of the card's DEFLATE kernel (lrf_tpu_torch/csrc/deflate.cu):
// the same lazy parse and block coder (lrf_tpu_torch/csrc/deflate_core.h),
// with `prev` built by inserting the positions in a plain loop and each
// longest_match walk made by one thread over `prev` where the kernel walks
// a hash-sorted array a warp at a time. It is the plain version that the
// tests hold against `zlib.compress(fiber, 9)`, byte for byte; the encoder
// never runs it.
//
// Built at first use by lrf_tpu_torch/ops/deflate.py (g++ -O3 -std=c++17
// -fPIC -shared).

#include <cstdint>
#include <memory>
#include <vector>

#include "../csrc/deflate_core.h"

namespace {

using namespace lrf_deflate;

uint32_t adler32(const uint8_t* d, int64_t n) {
  uint32_t a = 1, b = 0;
  for (int64_t i = 0; i < n; i++) {
    a = (a + d[i]) % 65521u;
    b = (b + a) % 65521u;
  }
  return (b << 16) | a;
}

}  // namespace

extern "C" {

// The longest fiber the twin and the kernel take (zlib never slides its
// window below it).
int lrf_deflate_twin_max_fiber() { return kMaxFiber; }

// The zlib stream of the n bytes at `data` into `out` (cap bytes), its
// length to *out_len. Returns 0, 1 when n is out of range, 2 when the
// stream did not fit.
int lrf_deflate_twin(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int64_t* out_len) {
  if (n < 0 || n > kMaxFiber) return 1;
  const int len = static_cast<int>(n);
  std::vector<uint16_t> head(kHashSize, 0), prev(len > 0 ? len : 1, 0);
  for (int p = 0; p + kMinMatch <= len; p++) {
    const uint32_t h = hash3(data + p);
    prev[p] = head[h];
    head[h] = static_cast<uint16_t>(p);
  }
  std::vector<uint8_t> sym(3 * kSymEnd);
  auto coder = std::make_unique<Coder>();
  coder->begin(out, cap);
  auto walk = [&](int p, int chain) { return search(data, len, prev.data(), p, chain); };
  struct Emit {
    Coder* c;
    uint8_t* sym;
    const uint8_t* data;
    void tally(int i, unsigned dist, unsigned lc) { Coder::tally(sym, i, dist, lc); }
    void flush(int nsym, int block_start, int stored_len, int last) {
      flush_block(c->trees, c->w, sym, nsym, data + block_start, stored_len, last);
    }
  } emit{coder.get(), sym.data(), data};
  Lazy lazy;
  lazy.init(len);
  lazy.run(data, len, walk, emit);
  lazy.finish(data, emit);
  const int64_t got = coder->end(adler32(data, n));
  if (got < 0) return 2;
  *out_len = got;
  return 0;
}

}  // extern "C"
