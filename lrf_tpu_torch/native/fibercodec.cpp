// Native fiber codec of lrf_tpu_torch: thread-pooled per-fiber DEFLATE for
// factor serialization, the stream assembler and the entropy-transport
// decoder.
//
// The port's own copy of lrf_tpu/native/fibercodec.cpp, with the same
// exported entry points and the same bytes. The reference compresses every
// factor column with a separate Python-level zlib call (pashtari/lrf
// `lrf/compression/utils.py:374-378`); this library does the same work
// natively: split a row-major fiber block into fibers, deflate each at the
// requested level on a std::thread pool, and return per-fiber lengths.
//
// Compressor backends, all emitting standard zlib streams (decodable by
// the reference's CPython `zlib.decompress`):
//   backend 0: zlib - byte output identical to CPython's `zlib.compress`
//              when both link the same zlib (same deflate defaults).
//   backend 1: libdeflate - faster at equal-or-smaller output on factor
//              fibers.
//   backend 2: "best" - per fiber the smaller of zlib-9 and libdeflate-12.
// libdeflate is a compile-time option (`__has_include(<libdeflate.h>)`;
// -DLRF_NO_LIBDEFLATE leaves it out where the header exists).
// Without it backend 1 fails with kNoBackend, "best" is plain zlib-9, and
// inflation goes through zlib's `uncompress`; `lrf_backends()` reports
// what was compiled in.
//
// Built at first use by lrf_tpu_torch/native/fibercodec.py (g++ -O3
// -std=c++17 -fPIC -shared ... -lz [-ldeflate]).

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

#if __has_include(<libdeflate.h>) && !defined(LRF_NO_LIBDEFLATE)
#include <libdeflate.h>
#define LRF_HAVE_LIBDEFLATE 1
#else
#define LRF_HAVE_LIBDEFLATE 0
#endif

namespace {

// Return code of a libdeflate backend call in a build without libdeflate.
constexpr int kNoBackend = -100;

// Per-thread cached deflate/inflate states. `compress2`/`uncompress`
// allocate and free ~256 KiB of internal zlib state per call, which
// dominates when fibers are a few KiB; `deflateReset`/`inflateReset`
// restore a cached stream to its freshly-initialized state, so the output
// bytes are identical to one-shot `compress2` (same windowBits/memLevel/
// strategy defaults) at a fraction of the cost.
int compress_one(const uint8_t* src, int64_t src_len, uint8_t* dst,
                 int64_t dst_cap, int level, int64_t* out_len) {
  struct TlsDeflate {
    z_stream strm;
    int level = -1;
    bool live = false;
  };
  thread_local TlsDeflate tls;  // workers are detached process-lifetime
  if (!tls.live || tls.level != level) {
    if (tls.live) {
      deflateEnd(&tls.strm);
      tls.live = false;
    }
    std::memset(&tls.strm, 0, sizeof(tls.strm));
    if (deflateInit(&tls.strm, level) != Z_OK) return Z_MEM_ERROR;
    tls.live = true;
    tls.level = level;
  } else if (deflateReset(&tls.strm) != Z_OK) {
    return Z_STREAM_ERROR;
  }
  tls.strm.next_in = const_cast<Bytef*>(src);
  tls.strm.avail_in = static_cast<uInt>(src_len);
  tls.strm.next_out = dst;
  tls.strm.avail_out = static_cast<uInt>(dst_cap);
  int rc = deflate(&tls.strm, Z_FINISH);
  if (rc != Z_STREAM_END) return rc == Z_OK ? Z_BUF_ERROR : rc;
  *out_len = dst_cap - static_cast<int64_t>(tls.strm.avail_out);
  return Z_OK;
}

// libdeflate compressor, cached per (thread, level). Emits a zlib-wrapped
// DEFLATE stream: standard format, decodable by any zlib inflater.
int compress_one_libdeflate(const uint8_t* src, int64_t src_len, uint8_t* dst,
                            int64_t dst_cap, int level, int64_t* out_len) {
#if LRF_HAVE_LIBDEFLATE
  struct TlsComp {
    libdeflate_compressor* c = nullptr;
    int level = -1;
  };
  thread_local TlsComp tls;
  if (tls.c == nullptr || tls.level != level) {
    if (tls.c != nullptr) libdeflate_free_compressor(tls.c);
    tls.c = libdeflate_alloc_compressor(level);
    if (tls.c == nullptr) return Z_MEM_ERROR;
    tls.level = level;
  }
  size_t n = libdeflate_zlib_compress(tls.c, src, static_cast<size_t>(src_len),
                                      dst, static_cast<size_t>(dst_cap));
  if (n == 0) return Z_BUF_ERROR;
  *out_len = static_cast<int64_t>(n);
  return Z_OK;
#else
  (void)src, (void)src_len, (void)dst, (void)dst_cap, (void)level,
      (void)out_len;
  return kNoBackend;
#endif
}

// Inflate one blob whose output size is known exactly: libdeflate's one-shot
// API where it is built in (a null actual-out pointer makes it *check* that
// the stream inflates to exactly dst_cap bytes), else zlib's `uncompress`
// with the same exact-size check.
int decompress_one(const uint8_t* src, int64_t src_len, uint8_t* dst,
                   int64_t dst_cap) {
#if LRF_HAVE_LIBDEFLATE
  struct TlsDecomp {
    libdeflate_decompressor* d = nullptr;
  };
  thread_local TlsDecomp tls;
  if (tls.d == nullptr) {
    tls.d = libdeflate_alloc_decompressor();
    if (tls.d == nullptr) return Z_MEM_ERROR;
  }
  libdeflate_result rc = libdeflate_zlib_decompress(
      tls.d, src, static_cast<size_t>(src_len), dst,
      static_cast<size_t>(dst_cap), nullptr);
  return rc == LIBDEFLATE_SUCCESS ? Z_OK : Z_DATA_ERROR;
#else
  uLongf out_len = static_cast<uLongf>(dst_cap);
  int rc = uncompress(dst, &out_len, src, static_cast<uLong>(src_len));
  if (rc != Z_OK) return rc == Z_BUF_ERROR ? Z_DATA_ERROR : rc;
  return out_len == static_cast<uLongf>(dst_cap) ? Z_OK : Z_DATA_ERROR;
#endif
}

// Persistent thread pool: one zlib call per fiber is short, so per-call
// thread spawn would dominate. Workers live for the process lifetime.
class Pool {
 public:
  static Pool& instance() {
    // Intentionally leaked: a static instance would run its destructor at
    // process exit and tear down the mutex/cv under the detached workers.
    static Pool* pool = new Pool();
    return *pool;
  }

  template <typename Fn>
  void run(int64_t n, Fn&& fn) {
    if (n <= 0) return;
    if (n == 1 || workers_.empty()) {
      for (int64_t i = 0; i < n; ++i) fn(i);
      return;
    }
    // One parallel_for at a time: task_/next_/remaining_ are single shared
    // slots, so a second concurrent caller (e.g. two GIL-released
    // serializer threads) would overwrite the task the workers are still
    // draining. Callers queue here; each still fans out over all cores.
    std::lock_guard<std::mutex> submission(submit_mu_);
    std::unique_lock<std::mutex> lock(mu_);
    task_ = fn;
    total_ = n;
    next_ = 0;
    remaining_ = n;
    ++generation_;
    cv_.notify_all();
    done_cv_.wait(lock, [this] { return remaining_ == 0; });
    task_ = nullptr;
  }

 private:
  Pool() {
    unsigned hw = std::thread::hardware_concurrency();
    size_t num = hw ? hw : 4;
    for (size_t t = 0; t < num; ++t) {
      // Detached: workers live for the process lifetime and must not block
      // process exit (they hold no resources beyond the static pool state).
      std::thread th([this] { worker_loop(); });
      workers_.push_back(th.get_id());
      th.detach();
    }
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      std::unique_lock<std::mutex> lock(mu_);
      cv_.wait(lock, [&] { return generation_ != seen; });
      seen = generation_;
      for (;;) {
        int64_t i = next_;
        if (i >= total_) break;
        next_ = i + 1;
        lock.unlock();
        task_(i);
        lock.lock();
        if (--remaining_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread::id> workers_;
  std::mutex submit_mu_;  // serializes whole run() calls (see above)
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::function<void(int64_t)> task_;
  int64_t total_ = 0;
  int64_t next_ = 0;
  int64_t remaining_ = 0;
  uint64_t generation_ = 0;
};

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  Pool::instance().run(n, fn);
}

// ---- dpack segment decoder (shared by the decode entry point and the
// fused decode->deflate->frame serializer path) ----

struct HuffEntry {
  int8_t sym;
  int8_t len;
};

struct DpackTables {
  std::vector<HuffEntry> lut;  // next max_len bits (LSB-first) -> (sym, len)
  uint32_t lut_mask = 0;
  int64_t max_len = 0;
  int64_t main_bytes = 0, row_bytes = 0, main_bits = 0, row_bits = 0;
  int64_t max_rows = 0, chunk = 0;
};

int dpack_build_tables(const int32_t* lens, const uint32_t* codes,
                       int64_t alphabet, int64_t chunk, int64_t main_words,
                       int64_t row_words, int64_t max_len, DpackTables* t) {
  if (max_len <= 0 || max_len > 16) return 1;
  t->lut.assign(static_cast<size_t>(1) << max_len, HuffEntry{0, 0});
  for (int64_t s = 0; s < alphabet; ++s) {
    int L = lens[s];
    if (L <= 0 || L > max_len) return 1;
    uint32_t c = codes[s];
    for (uint32_t fill = 0; fill < (1u << (max_len - L)); ++fill) {
      t->lut[c | (fill << L)] = {static_cast<int8_t>(s),
                                 static_cast<int8_t>(L)};
    }
  }
  t->lut_mask = (1u << max_len) - 1;
  t->max_len = max_len;
  t->main_bytes = main_words * 4;
  t->row_bytes = row_words * 4;
  t->main_bits = main_words * 32;
  t->row_bits = row_words * 32;
  t->max_rows =
      (chunk * max_len - t->main_bits + t->row_bits - 1) / t->row_bits;
  t->chunk = chunk;
  return 0;
}

// Decode ONE segment (seg_vals values, rank stride r_stride, chunks starting
// at chunk id `chunk0`, continuation rows starting at `row_base`) into dst.
//
// Inner-loop design: per chunk, the main slot plus the WORST-CASE continuation
// rows (max_rows + 1, ~80 bytes total at the shipped tables) are copied
// into the scratch up front, removing the per-symbol refill check; the
// bit window is one unaligned 64-bit load (>= 57 usable bits >= max_len);
// full chunks skip the `i < take` tail guard; and the running-sum delta
// undo carries an incrementing rank counter instead of `v % r_stride`
// (an integer divide per symbol). Rows actually consumed are still counted from the
// final bit position, so over-copied rows stay available to later chunks.
void dpack_decode_segment(const DpackTables& t, const uint8_t* main,
                          const uint8_t* exc, int64_t n_exc_rows,
                          int64_t seg_vals, int64_t r_stride, int64_t chunk0,
                          int64_t row_base, int32_t* run_scratch,
                          uint8_t* buf_scratch, int8_t* dst) {
  const int64_t chunk = t.chunk;
  const int64_t worst_rows = t.max_rows + 1;
  int64_t remaining = seg_vals;
  int64_t cid = chunk0;
  int64_t row_cursor = row_base;
  int64_t ri = 0;  // rank counter (replaces v % r_stride)
  std::fill(run_scratch, run_scratch + r_stride, 0);
  while (remaining > 0) {
    std::memcpy(buf_scratch, main + cid * t.main_bytes,
                static_cast<size_t>(t.main_bytes));
    // all rows this chunk COULD need, copied unconditionally (cheaper
    // than a per-symbol availability check); rows past the stream's end
    // read as zeros, as before
    int64_t avail = n_exc_rows - row_cursor;
    if (avail > worst_rows) avail = worst_rows;
    if (avail < 0) avail = 0;
    if (avail > 0)
      std::memcpy(buf_scratch + t.main_bytes, exc + row_cursor * t.row_bytes,
                  static_cast<size_t>(avail * t.row_bytes));
    if (avail < worst_rows)
      std::memset(buf_scratch + t.main_bytes + avail * t.row_bytes, 0,
                  static_cast<size_t>((worst_rows - avail) * t.row_bytes));
    int64_t take = remaining < chunk ? remaining : chunk;
    int64_t bitpos = 0;
    if (take == chunk) {
      // one 64-bit window serves several symbols: after j codes the
      // in-window shift is at most 7 + j*max_len, so
      // n = (64 - 7 - max_len)/max_len + 1 codes always fit before a
      // reload (5 at the shipped max_len=10 tables) — the load leaves
      // the per-symbol dependency chain
      const int64_t per_load = (64 - 7 - t.max_len) / t.max_len + 1;
      int64_t i = 0;
      while (i < chunk) {
        const int64_t byte0 = bitpos >> 3;
        uint64_t window;
        std::memcpy(&window, buf_scratch + byte0, 8);
        int64_t shift = bitpos & 7;
        int64_t n = chunk - i;
        if (n > per_load) n = per_load;
        for (int64_t j = 0; j < n; ++j) {
          HuffEntry e = t.lut[(window >> shift) & t.lut_mask];
          int32_t zz = e.sym;
          int32_t d = (zz & 1) ? -((zz + 1) >> 1) : (zz >> 1);
          int32_t& a = run_scratch[ri];
          a += d;
          dst[i + j] = static_cast<int8_t>(a);
          if (++ri == r_stride) ri = 0;
          shift += e.len;
        }
        bitpos = (byte0 << 3) + shift;
        i += n;
      }
    } else {
      for (int64_t i = 0; i < chunk; ++i) {
        uint64_t window;
        std::memcpy(&window, buf_scratch + (bitpos >> 3), 8);
        HuffEntry e = t.lut[(window >> (bitpos & 7)) & t.lut_mask];
        if (i < take) {
          int32_t zz = e.sym;
          int32_t d = (zz & 1) ? -((zz + 1) >> 1) : (zz >> 1);
          int32_t& a = run_scratch[ri];
          a += d;
          dst[i] = static_cast<int8_t>(a);
          if (++ri == r_stride) ri = 0;
        }
        bitpos += e.len;
      }
    }
    if (bitpos > t.main_bits)
      row_cursor += (bitpos - t.main_bits + t.row_bits - 1) / t.row_bits;
    dst += take;
    remaining -= take;
    ++cid;
  }
}

// scratch bytes dpack_decode_segment needs in buf_scratch: main slot +
// worst-case rows (+1: when every code is max_len the final symbol's
// window can start in the byte past max_rows' end) + 8 slack for the
// unaligned 64-bit window load at the last bit position.
int64_t dpack_buf_bytes(const DpackTables& t) {
  return t.main_bytes + (t.max_rows + 1) * t.row_bytes + 8;
}

// ---- stream assembly (fused serializer) ----
//
// The byte container is the reference's recursive 4-byte-BE length-prefix
// fold (pashtari/lrf `lrf/compression/utils.py:246-321`): combining
// payloads p_1..p_n left-fold emits headers L_{n-1}..L_1 (L_k = total
// bytes of the fold of the first k payloads = sum(len(p_j), j<=k) +
// 4*(k-1)) followed by the payloads in order.

void write_be32(uint8_t*& dst, uint64_t v) {
  dst[0] = static_cast<uint8_t>(v >> 24);
  dst[1] = static_cast<uint8_t>(v >> 16);
  dst[2] = static_cast<uint8_t>(v >> 8);
  dst[3] = static_cast<uint8_t>(v);
  dst += 4;
}

// Compress one fiber with backend 0 (zlib), 1 (libdeflate) or 2 ("best":
// zlib-9 raced against libdeflate-12, ties to zlib — the container layer's
// payload-minimal default, byte-for-byte the same winner selection as
// container._compress_fibers; plain zlib-9 in a build without libdeflate).
int compress_fiber_dispatch(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int level, int backend,
                            int64_t* out_len, std::vector<uint8_t>* race) {
  if (backend == 0) return compress_one(src, n, dst, cap, level, out_len);
  if (backend == 1)
    return compress_one_libdeflate(src, n, dst, cap, level, out_len);
  int64_t lz = 0, ld = 0;
  int rc = compress_one(src, n, dst, cap, 9, &lz);
  if (rc != Z_OK) return rc;
  if (!LRF_HAVE_LIBDEFLATE) {
    *out_len = lz;
    return Z_OK;
  }
  if (race->size() < static_cast<size_t>(cap)) race->resize(cap);
  rc = compress_one_libdeflate(src, n, race->data(), cap, 12, &ld);
  if (rc != Z_OK) return rc;
  if (ld < lz) {
    std::memcpy(dst, race->data(), static_cast<size_t>(ld));
    *out_len = ld;
  } else {
    *out_len = lz;
  }
  return Z_OK;
}

// Deflate the r fibers (columns, stride r in the m-major (m, r) value
// block) of one (factor, image) segment into uniform-capacity blob slots.
int compress_segment_fibers(const int8_t* block, int64_t m, int64_t r,
                            int level, int backend, uint8_t* slots,
                            int64_t cap, int64_t* blob_lens) {
  thread_local std::vector<uint8_t> col;
  thread_local std::vector<uint8_t> race;
  if (col.size() < static_cast<size_t>(m)) col.resize(m);
  for (int64_t ri = 0; ri < r; ++ri) {
    const int8_t* src = block + ri;
    for (int64_t mi = 0; mi < m; ++mi) col[mi] = static_cast<uint8_t>(src[mi * r]);
    int rc = compress_fiber_dispatch(col.data(), m, slots + ri * cap, cap,
                                     level, backend, &blob_lens[ri], &race);
    if (rc != Z_OK) return rc;
  }
  return 0;
}

// Frame the per-image streams from compressed fiber blobs. Blob slot
// layout: factor k's fibers for image bi live at
// slots + slot_base[k] + bi * rs[k] * caps[k], one slot of caps[k] bytes
// each, their lengths at fiber_base[k] + bi * rs[k] in blob_lens.
// Returns 0, or 1 if out_cap is too small.
int assemble_frames(int64_t n_factors, int64_t b, const int64_t* rs,
                    const uint8_t* slots, const int64_t* blob_lens,
                    const int64_t* fiber_base, const int64_t* slot_base,
                    const int64_t* caps,
                    const uint8_t* metadata, int64_t metadata_len,
                    const uint8_t* inner_md_concat,
                    const int64_t* inner_md_lens, uint8_t* out,
                    int64_t out_cap, int64_t* stream_lens) {
  std::vector<int64_t> md_off(static_cast<size_t>(n_factors) + 1, 0);
  for (int64_t k = 0; k < n_factors; ++k)
    md_off[static_cast<size_t>(k) + 1] =
        md_off[static_cast<size_t>(k)] + inner_md_lens[k];
  // pass 1: exact stream lengths
  std::vector<int64_t> f_len(static_cast<size_t>(n_factors * b));
  for (int64_t bi = 0; bi < b; ++bi) {
    int64_t factors_len = 4 * (n_factors - 1);
    for (int64_t k = 0; k < n_factors; ++k) {
      const int64_t r = rs[k];
      const int64_t* lens_k = blob_lens + fiber_base[k] + bi * r;
      int64_t fc = 4 * (r - 1);
      for (int64_t ri = 0; ri < r; ++ri) fc += lens_k[ri];
      const int64_t fl = 4 + inner_md_lens[k] + fc;
      f_len[static_cast<size_t>(k * b + bi)] = fl;
      factors_len += fl;
    }
    stream_lens[bi] = 4 + metadata_len + factors_len;
  }
  int64_t total = 0;
  for (int64_t bi = 0; bi < b; ++bi) total += stream_lens[bi];
  if (total > out_cap) return 1;
  std::vector<int64_t> stream_off(static_cast<size_t>(b) + 1, 0);
  for (int64_t bi = 0; bi < b; ++bi)
    stream_off[static_cast<size_t>(bi) + 1] =
        stream_off[static_cast<size_t>(bi)] + stream_lens[bi];
  // pass 2: write (parallel over images; disjoint output ranges)
  parallel_for(b, [&](int64_t bi) {
    uint8_t* dst = out + stream_off[static_cast<size_t>(bi)];
    write_be32(dst, static_cast<uint64_t>(metadata_len));
    std::memcpy(dst, metadata, static_cast<size_t>(metadata_len));
    dst += metadata_len;
    // combine([f_0..f_{n-1}]) headers: L_k for k = n-1 .. 1
    for (int64_t k = n_factors - 1; k >= 1; --k) {
      int64_t lk = 4 * (k - 1);
      for (int64_t j = 0; j < k; ++j)
        lk += f_len[static_cast<size_t>(j * b + bi)];
      write_be32(dst, static_cast<uint64_t>(lk));
    }
    for (int64_t k = 0; k < n_factors; ++k) {
      const int64_t r = rs[k];
      const int64_t* lens_k = blob_lens + fiber_base[k] + bi * r;
      const int64_t cap = caps[k];
      const uint8_t* slots_k = slots + slot_base[k] + bi * r * cap;
      // f_k = combine([inner_md_k, fibers_combined])
      write_be32(dst, static_cast<uint64_t>(inner_md_lens[k]));
      std::memcpy(dst, inner_md_concat + md_off[static_cast<size_t>(k)],
                  static_cast<size_t>(inner_md_lens[k]));
      dst += inner_md_lens[k];
      // combine(blobs) headers: L_j for j = r-1 .. 1
      int64_t prefix = 0;  // sum of first j blob lens, built incrementally
      for (int64_t j = 0; j < r - 1; ++j) prefix += lens_k[j];
      for (int64_t j = r - 1; j >= 1; --j) {
        write_be32(dst, static_cast<uint64_t>(prefix + 4 * (j - 1)));
        prefix -= lens_k[j - 1];
      }
      for (int64_t ri = 0; ri < r; ++ri) {
        std::memcpy(dst, slots_k + ri * cap,
                    static_cast<size_t>(lens_k[ri]));
        dst += lens_k[ri];
      }
    }
  });
  return 0;
}

// assemble_frames over slots of one capacity, `cap`, in fiber order.
int assemble_frames_uniform(int64_t n_factors, int64_t b, const int64_t* rs,
                            const uint8_t* slots, const int64_t* blob_lens,
                            const int64_t* fiber_base, int64_t cap,
                            const uint8_t* metadata, int64_t metadata_len,
                            const uint8_t* inner_md_concat,
                            const int64_t* inner_md_lens, uint8_t* out,
                            int64_t out_cap, int64_t* stream_lens) {
  std::vector<int64_t> slot_base(static_cast<size_t>(n_factors));
  std::vector<int64_t> caps(static_cast<size_t>(n_factors), cap);
  for (int64_t k = 0; k < n_factors; ++k)
    slot_base[static_cast<size_t>(k)] = fiber_base[k] * cap;
  return assemble_frames(n_factors, b, rs, slots, blob_lens, fiber_base,
                         slot_base.data(), caps.data(), metadata,
                         metadata_len, inner_md_concat, inner_md_lens, out,
                         out_cap, stream_lens);
}

}  // namespace

extern "C" {

// Backends compiled in: bit 0 zlib (always), bit 1 libdeflate.
int lrf_backends() { return 1 | (LRF_HAVE_LIBDEFLATE ? 2 : 0); }

// Compress `num_fibers` contiguous fibers of `fiber_bytes` bytes each from
// `data`. Each fiber's deflate output goes to `out + i * out_cap`; its
// length to `out_lens[i]`. `backend`: 0 = zlib (CPython-byte-identical),
// 1 = libdeflate (faster, equal-or-smaller, still a zlib stream; kNoBackend
// in a build without it). Returns 0 on success.
int lrf_compress_fibers2(const uint8_t* data, int64_t num_fibers,
                         int64_t fiber_bytes, int level, int backend,
                         uint8_t* out, int64_t out_cap, int64_t* out_lens) {
  std::vector<int> rcs(static_cast<size_t>(num_fibers), Z_OK);
  parallel_for(num_fibers, [&](int64_t i) {
    rcs[static_cast<size_t>(i)] =
        backend == 1
            ? compress_one_libdeflate(data + i * fiber_bytes, fiber_bytes,
                                      out + i * out_cap, out_cap, level,
                                      &out_lens[i])
            : compress_one(data + i * fiber_bytes, fiber_bytes,
                           out + i * out_cap, out_cap, level, &out_lens[i]);
  });
  for (int rc : rcs)
    if (rc != Z_OK) return rc;
  return 0;
}

int lrf_compress_fibers(const uint8_t* data, int64_t num_fibers,
                        int64_t fiber_bytes, int level, uint8_t* out,
                        int64_t out_cap, int64_t* out_lens) {
  return lrf_compress_fibers2(data, num_fibers, fiber_bytes, level,
                              /*backend=*/0, out, out_cap, out_lens);
}

// Decode the device-side entropy coder's fixed-slot + exception-tail
// format (lrf_tpu_torch/ops/entropy.py): canonical LSB-first Huffman codes
// (lengths `lens[alphabet]` / codes `codes[alphabet]`, max length 12);
// `chunk` values per chunk; every chunk owns `main_words` uint32 in `main`
// at a fixed stride, and chunks whose codes exceed main_words*32 bits
// continue in a `tail_words`-word row of `exc`, rows assigned in chunk
// order (chunks are self-delimiting — the decoder discovers overflow from
// its own bit count). Segment s (one per factor x image) holds
// `seg_values[s]` values (chunk padding decoded and dropped) and its first
// exception row is `seg_ovf_base[s]`. Output: int8 values (symbol + lo),
// segments concatenated.
// Decode the delta+zigzag Huffman transport (lrf_tpu_torch/ops/entropy.py
// `pack_segments`): fixed `main_words`-word slot per chunk of 64 symbols +
// `row_words`-word continuation rows allocated densely in chunk order, with
// per-segment row bases. Emits factor VALUES: inverse zigzag then running
// sum along the segment's rank stride (the encoder differenced each
// (M, R) factor along M with rank-interleaved flattening).
int lrf_dpack_decode_segments(const uint8_t* main, const uint8_t* exc,
                              int64_t n_exc_rows, const int64_t* seg_row_base,
                              const int64_t* seg_values,
                              const int64_t* seg_ranks, int64_t num_segments,
                              const int32_t* lens, const uint32_t* codes,
                              int64_t alphabet, int64_t chunk,
                              int64_t main_words, int64_t row_words,
                              int64_t max_len, int8_t* out) {
  DpackTables t;
  if (dpack_build_tables(lens, codes, alphabet, chunk, main_words, row_words,
                         max_len, &t) != 0)
    return 1;
  // per-segment output offsets and first-chunk ids
  std::vector<int64_t> out_off(static_cast<size_t>(num_segments));
  std::vector<int64_t> chunk0(static_cast<size_t>(num_segments));
  int64_t acc = 0, chk = 0;
  for (int64_t s = 0; s < num_segments; ++s) {
    out_off[static_cast<size_t>(s)] = acc;
    chunk0[static_cast<size_t>(s)] = chk;
    acc += seg_values[s];
    chk += (seg_values[s] + chunk - 1) / chunk;
  }
  std::vector<int> rcs(static_cast<size_t>(num_segments), 0);
  const int64_t buf_bytes = dpack_buf_bytes(t);
  parallel_for(num_segments, [&](int64_t s) {
    const int64_t r_stride = seg_ranks[s];
    if (r_stride <= 0) {
      rcs[static_cast<size_t>(s)] = 2;
      return;
    }
    std::vector<int32_t> run(static_cast<size_t>(r_stride));
    // scratch: main slot + worst-case continuation rows + lookahead slack.
    // +1 row: when every code in a chunk is max_len the peek before the
    // final symbol can demand ((chunk*max_len + 7) >> 3) + 1 bytes, which
    // rounds up to one row beyond max_rows (the row itself is zero-padding
    // the decoder never consumes past the last code's end bit).
    std::vector<uint8_t> buf(static_cast<size_t>(buf_bytes), 0);
    dpack_decode_segment(t, main, exc, n_exc_rows, seg_values[s], r_stride,
                         chunk0[static_cast<size_t>(s)], seg_row_base[s],
                         run.data(), buf.data(),
                         out + out_off[static_cast<size_t>(s)]);
  });
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

// Assemble finished per-image container streams from (B, M_k, R_k)
// row-major int8 factor value blocks: per (factor, image) segment, gather +
// deflate the R_k column fibers, then emit the reference byte format
// (metadata | per-factor [inner metadata | per-fiber blobs], all framed
// with the 4-byte-BE recursive fold — `lrf/compression/utils.py:246-390`)
// in one pass. Replaces the per-factor numpy transpose + per-fiber Python
// bytes objects + Python framing loop of the layered serializer. `backend`:
// 0 zlib, 1 libdeflate, 2 "best" (zlib-9 vs libdeflate-12 race). Returns
// 0 ok, 1 out_cap too small, other nonzero = compression failure.
int lrf_assemble_streams(const int8_t* const* factor_bufs, int64_t n_factors,
                         int64_t b, const int64_t* ms, const int64_t* rs,
                         int64_t cap, const uint8_t* metadata,
                         int64_t metadata_len,
                         const uint8_t* inner_md_concat,
                         const int64_t* inner_md_lens, int level, int backend,
                         uint8_t* out, int64_t out_cap,
                         int64_t* stream_lens) {
  int64_t total_fibers = 0;
  std::vector<int64_t> fiber_base(static_cast<size_t>(n_factors));
  for (int64_t k = 0; k < n_factors; ++k) {
    fiber_base[static_cast<size_t>(k)] = total_fibers;
    total_fibers += b * rs[k];
  }
  // per-fiber blob capacity is supplied by the caller (single source of
  // truth in fibercodec.py: the Python out_cap bound uses the same
  // value); an undersized cap fails compression with Z_BUF_ERROR -> the
  // caller falls back to the layered path, never corrupts
  std::vector<uint8_t> slots(static_cast<size_t>(total_fibers * cap));
  std::vector<int64_t> blob_lens(static_cast<size_t>(total_fibers));
  const int64_t n_segments = n_factors * b;
  std::vector<int> rcs(static_cast<size_t>(n_segments), 0);
  parallel_for(n_segments, [&](int64_t si) {
    const int64_t k = si / b, bi = si % b;
    const int64_t m = ms[k], r = rs[k];
    const int64_t fb = fiber_base[static_cast<size_t>(k)] + bi * r;
    rcs[static_cast<size_t>(si)] = compress_segment_fibers(
        factor_bufs[k] + bi * m * r, m, r, level, backend,
        slots.data() + fb * cap, cap, blob_lens.data() + fb);
  });
  for (int rc : rcs)
    if (rc != 0) return rc == Z_BUF_ERROR ? 1 : rc;
  return assemble_frames_uniform(n_factors, b, rs, slots.data(),
                         blob_lens.data(), fiber_base.data(), cap, metadata,
                         metadata_len,
                         inner_md_concat, inner_md_lens, out, out_cap,
                         stream_lens);
}

// Frame finished per-image container streams from fiber blobs coded
// elsewhere (the card's DEFLATE kernel, lrf_tpu_torch/ops/deflate.py):
// factor k's slots follow factor k-1's, B * rs[k] slots of caps[k] bytes in
// (image, fiber) order, and blob_lens holds one length per slot in the
// same order. Same framing as lrf_assemble_streams. Returns 0 ok, 1 out_cap
// too small, 2 a length outside its slot.
int lrf_frame_streams(const uint8_t* slots, const int32_t* blob_lens,
                      int64_t n_factors, int64_t b, const int64_t* rs,
                      const int64_t* caps, const uint8_t* metadata,
                      int64_t metadata_len, const uint8_t* inner_md_concat,
                      const int64_t* inner_md_lens, uint8_t* out,
                      int64_t out_cap, int64_t* stream_lens) {
  std::vector<int64_t> fiber_base(static_cast<size_t>(n_factors));
  std::vector<int64_t> slot_base(static_cast<size_t>(n_factors));
  int64_t fibers = 0, bytes = 0;
  for (int64_t k = 0; k < n_factors; ++k) {
    fiber_base[static_cast<size_t>(k)] = fibers;
    slot_base[static_cast<size_t>(k)] = bytes;
    fibers += b * rs[k];
    bytes += b * rs[k] * caps[k];
  }
  std::vector<int64_t> lens(static_cast<size_t>(fibers));
  for (int64_t k = 0; k < n_factors; ++k) {
    for (int64_t i = 0; i < b * rs[k]; ++i) {
      const int64_t at = fiber_base[static_cast<size_t>(k)] + i;
      const int32_t len = blob_lens[at];
      if (len <= 0 || len > caps[k]) return 2;
      lens[static_cast<size_t>(at)] = len;
    }
  }
  return assemble_frames(n_factors, b, rs, slots, lens.data(),
                         fiber_base.data(), slot_base.data(), caps, metadata,
                         metadata_len, inner_md_concat, inner_md_lens, out,
                         out_cap, stream_lens);
}

// The fully fused serializer: device entropy-transport buffers (main /
// continuation rows / per-segment row bases, factor-major segment order as
// `lrf_tpu_torch.ops.entropy.segment_layout` lays them out) -> finished
// per-image container streams. Each (factor, image) segment Huffman-
// decodes into a thread-local block that its fibers deflate straight out
// of (cache-resident: the layered path writes all values to RAM, re-reads
// them through a numpy transpose, and pays a second pool dispatch). Same byte contract as lrf_assemble_streams.
int lrf_dpack_assemble_streams(
    const uint8_t* main, const uint8_t* exc, int64_t n_exc_rows,
    const int64_t* seg_row_base, int64_t n_factors, int64_t b,
    const int64_t* ms, const int64_t* rs, int64_t cap,
    const int32_t* lens,
    const uint32_t* codes, int64_t alphabet, int64_t chunk,
    int64_t main_words, int64_t row_words, int64_t max_len,
    const uint8_t* metadata, int64_t metadata_len,
    const uint8_t* inner_md_concat, const int64_t* inner_md_lens, int level,
    int backend, uint8_t* out, int64_t out_cap, int64_t* stream_lens) {
  DpackTables t;
  if (dpack_build_tables(lens, codes, alphabet, chunk, main_words, row_words,
                         max_len, &t) != 0)
    return -1;
  int64_t max_vals = 0, max_r = 0, total_fibers = 0;
  std::vector<int64_t> fiber_base(static_cast<size_t>(n_factors));
  std::vector<int64_t> chunk0(static_cast<size_t>(n_factors));
  int64_t chk = 0;
  for (int64_t k = 0; k < n_factors; ++k) {
    fiber_base[static_cast<size_t>(k)] = total_fibers;
    chunk0[static_cast<size_t>(k)] = chk;
    total_fibers += b * rs[k];
    chk += b * ((ms[k] * rs[k] + chunk - 1) / chunk);
    if (ms[k] * rs[k] > max_vals) max_vals = ms[k] * rs[k];
    if (rs[k] > max_r) max_r = rs[k];
  }
  // cap: caller-supplied per-fiber capacity (see lrf_assemble_streams)
  std::vector<uint8_t> slots(static_cast<size_t>(total_fibers * cap));
  std::vector<int64_t> blob_lens(static_cast<size_t>(total_fibers));
  const int64_t n_segments = n_factors * b;
  const int64_t buf_bytes = dpack_buf_bytes(t);
  std::vector<int> rcs(static_cast<size_t>(n_segments), 0);
  parallel_for(n_segments, [&](int64_t si) {
    const int64_t k = si / b, bi = si % b;
    const int64_t m = ms[k], r = rs[k];
    if (r <= 0) {
      rcs[static_cast<size_t>(si)] = 2;
      return;
    }
    thread_local std::vector<int8_t> block;
    thread_local std::vector<int32_t> run;
    thread_local std::vector<uint8_t> buf;
    if (block.size() < static_cast<size_t>(max_vals)) block.resize(max_vals);
    if (run.size() < static_cast<size_t>(max_r)) run.resize(max_r);
    if (buf.size() < static_cast<size_t>(buf_bytes)) buf.resize(buf_bytes);
    const int64_t per = m * r;
    const int64_t seg_chunks = (per + chunk - 1) / chunk;
    dpack_decode_segment(t, main, exc, n_exc_rows, per, r,
                         chunk0[static_cast<size_t>(k)] + bi * seg_chunks,
                         seg_row_base[k * b + bi], run.data(), buf.data(),
                         block.data());
    const int64_t fb = fiber_base[static_cast<size_t>(k)] + bi * r;
    rcs[static_cast<size_t>(si)] = compress_segment_fibers(
        block.data(), m, r, level, backend, slots.data() + fb * cap, cap,
        blob_lens.data() + fb);
  });
  for (int rc : rcs)
    if (rc != 0) return rc == Z_BUF_ERROR ? 1 : rc;
  return assemble_frames_uniform(n_factors, b, rs, slots.data(),
                         blob_lens.data(), fiber_base.data(), cap, metadata,
                         metadata_len,
                         inner_md_concat, inner_md_lens, out, out_cap,
                         stream_lens);
}

// Decompress `num_fibers` concatenated deflate blobs (lengths in
// `blob_lens`) into `out`, each fiber occupying `fiber_bytes` bytes.
int lrf_decompress_fibers(const uint8_t* blobs, const int64_t* blob_lens,
                          int64_t num_fibers, uint8_t* out,
                          int64_t fiber_bytes) {
  std::vector<int64_t> offsets(static_cast<size_t>(num_fibers));
  int64_t off = 0;
  for (int64_t i = 0; i < num_fibers; ++i) {
    offsets[static_cast<size_t>(i)] = off;
    off += blob_lens[i];
  }
  std::vector<int> rcs(static_cast<size_t>(num_fibers), Z_OK);
  parallel_for(num_fibers, [&](int64_t i) {
    rcs[static_cast<size_t>(i)] =
        decompress_one(blobs + offsets[static_cast<size_t>(i)], blob_lens[i],
                       out + i * fiber_bytes, fiber_bytes);
  });
  for (int rc : rcs)
    if (rc != Z_OK) return rc;
  return 0;
}

// Delta + zigzag static-Huffman encode of int8 factor values into the
// device entropy-transport layout (the H2D mirror of the encode-side
// `lrf_tpu_torch.ops.entropy.pack_segments`): per 64-value chunk, a fixed
// MAIN_WORDS slot in `main_out` plus ROW_WORDS-word continuation rows
// allocated densely in global chunk order in `exc_out`; per-chunk row
// counts in `chunk_rows_out` (the device decoder cumsums them into row
// bases). Segments are (factor, image) in factor-major order, each padded
// to a chunk multiple with the zz=0 pad symbol; the delta runs along M
// within each rank column (stream order is m-major, so the running value
// is tracked per column). Returns 1 if the total rows exceed
// `max_rows_budget` (caller falls back to the flat bit-pack).
int lrf_dpack_encode(const int8_t* const* factor_bufs, int64_t n_factors,
                     int64_t b, const int64_t* ms, const int64_t* rs,
                     const int32_t* lens, const uint32_t* codes,
                     int64_t alphabet, int64_t chunk, int64_t main_words,
                     int64_t row_words, int64_t max_rows_budget,
                     uint32_t* main_out, uint32_t* exc_out,
                     uint8_t* chunk_rows_out, int64_t* n_rows_out) {
  const int64_t main_bits = main_words * 32;
  const int64_t row_bits = row_words * 32;
  int64_t max_len = 0;
  for (int64_t s = 0; s < alphabet; ++s)
    if (lens[s] > max_len) max_len = lens[s];
  // chunk_rows_out is uint8: the worst-case rows/chunk must fit
  const int64_t worst_rows =
      (chunk * max_len - main_bits + row_bits - 1) / row_bits;
  if (worst_rows > 255) return 3;
  std::vector<int> seg_bad;
  // segment table: (factor, image) -> first chunk id
  std::vector<int64_t> seg_factor, seg_image, seg_chunk0;
  int64_t c_total = 0;
  for (int64_t k = 0; k < n_factors; ++k) {
    const int64_t per = ms[k] * rs[k];
    const int64_t chunks = (per + chunk - 1) / chunk;
    for (int64_t bi = 0; bi < b; ++bi) {
      seg_factor.push_back(k);
      seg_image.push_back(bi);
      seg_chunk0.push_back(c_total);
      c_total += chunks;
    }
  }
  const int64_t n_segments = static_cast<int64_t>(seg_factor.size());
  seg_bad.assign(static_cast<size_t>(n_segments), 0);

  // SINGLE emit pass (a two-pass form would count bits, then re-walk every
  // value to emit): each chunk's bits are built
  // once in a register; main words go straight to main_out (fixed slots),
  // continuation words go to a per-chunk worst-case staging area, and a
  // cheap serial cumsum + parallel memcpy compacts them into the dense
  // exc layout afterwards. Values are read through a per-segment
  // transposed block so the walk is sequential (the (ri*m + mi) form
  // strides by m every value).
  std::vector<uint32_t> stage(
      static_cast<size_t>(c_total * worst_rows * row_words));
  parallel_for(n_segments, [&](int64_t si) {
    const int64_t k = seg_factor[static_cast<size_t>(si)];
    const int64_t bi = seg_image[static_cast<size_t>(si)];
    const int64_t m = ms[k], r = rs[k], per = m * r;
    const int8_t* buf = factor_bufs[k] + bi * r * m;
    thread_local std::vector<int8_t> tr;  // (m, r) value-order transpose
    if (tr.size() < static_cast<size_t>(per)) tr.resize(per);
    for (int64_t ri = 0; ri < r; ++ri) {
      const int8_t* src = buf + ri * m;
      int8_t* dst = tr.data() + ri;
      for (int64_t mi = 0; mi < m; ++mi) dst[mi * r] = src[mi];
    }
    std::vector<int32_t> run(static_cast<size_t>(r), 0);
    int64_t cid = seg_chunk0[static_cast<size_t>(si)];
    // chunk register: worst case chunk * max_len bits (max_len from
    // the PASSED code table — a hardcoded cap would heap-overflow on
    // longer codes)
    std::vector<uint32_t> reg(
        static_cast<size_t>(main_words) +
        (static_cast<size_t>(chunk) * static_cast<size_t>(max_len) + 31) / 32 +
        2);
    std::fill(reg.begin(), reg.end(), 0u);
    int64_t bitpos = 0, in_chunk = 0, ri = 0;
    const int64_t padded = ((per + chunk - 1) / chunk) * chunk;
    for (int64_t v = 0; v < padded; ++v) {
      int32_t zz = 0;
      if (v < per) {
        const int32_t x = tr[static_cast<size_t>(v)];
        const int32_t d = x - run[static_cast<size_t>(ri)];
        run[static_cast<size_t>(ri)] = x;
        zz = d >= 0 ? 2 * d : -2 * d - 1;
        if (zz >= alphabet) {  // delta outside the static code's alphabet
          seg_bad[static_cast<size_t>(si)] = 1;
          zz = 0;
        }
        if (++ri == r) ri = 0;
      }
      const uint32_t code = codes[zz];
      const int32_t len = lens[zz];
      const int64_t w = bitpos >> 5, off = bitpos & 31;
      reg[static_cast<size_t>(w)] |= code << off;
      if (off != 0)
        reg[static_cast<size_t>(w) + 1] |= code >> (32 - off);
      bitpos += len;
      if (++in_chunk == chunk) {
        in_chunk = 0;
        uint32_t* mp = main_out + cid * main_words;
        for (int64_t j = 0; j < main_words; ++j)
          mp[j] = reg[static_cast<size_t>(j)];
        const int64_t rows = bitpos > main_bits
                                 ? (bitpos - main_bits + row_bits - 1) / row_bits
                                 : 0;
        chunk_rows_out[cid] = static_cast<uint8_t>(rows);
        uint32_t* sp = stage.data() + cid * worst_rows * row_words;
        for (int64_t j = 0; j < rows * row_words; ++j)
          sp[j] = reg[static_cast<size_t>(main_words + j)];
        std::fill(reg.begin(), reg.end(), 0u);
        bitpos = 0;
        ++cid;
      }
    }
  });
  // global row bases (exclusive cumsum over all chunks, chunk order)
  std::vector<int64_t> base(static_cast<size_t>(c_total) + 1, 0);
  for (int64_t c = 0; c < c_total; ++c)
    base[static_cast<size_t>(c) + 1] =
        base[static_cast<size_t>(c)] + chunk_rows_out[c];
  *n_rows_out = base[static_cast<size_t>(c_total)];
  if (*n_rows_out > max_rows_budget) return 1;
  for (int bad : seg_bad)
    if (bad) return 2;
  // compact the staged continuation rows into the dense exc layout
  parallel_for(n_segments, [&](int64_t si) {
    const int64_t k = seg_factor[static_cast<size_t>(si)];
    const int64_t per = ms[k] * rs[k];
    const int64_t chunks = (per + chunk - 1) / chunk;
    const int64_t c0 = seg_chunk0[static_cast<size_t>(si)];
    for (int64_t c = c0; c < c0 + chunks; ++c) {
      const int64_t rows = chunk_rows_out[c];
      if (rows)
        std::memcpy(exc_out + base[static_cast<size_t>(c)] * row_words,
                    stage.data() + c * worst_rows * row_words,
                    static_cast<size_t>(rows * row_words) * 4);
    }
  });
  return 0;
}

// Bit-pack int8 factor values into uint32 words for the decode H2D upload.
//
// Inputs are the per-factor FIBER-MAJOR inflate outputs (factor k: shape
// (B * R_k, M_k), row b*R_k + r = column r of image b) — i.e. exactly what
// `lrf_decompress_fibers` wrote, with no transpose/restack pass in between.
// Output: per image, the value stream [factor 0 row-major (m, r), factor 1,
// ...] packed `vals_per_word` values per uint32 (value v stored as
// (v - lo) << (bits * slot)), `words_per_image` words per image — the same
// layout `parallel/decode._inflate_streams` builds in numpy, fused into one
// C++ pass (no transpose, concat, widen or shift-reduce temporaries).
// Returns nonzero if any value falls outside [lo, lo + 2^bits):
// the caller then falls back to the unpacked upload (the correctness guard
// the numpy path implemented with a min/max scan).
int lrf_pack_values(const int8_t* const* factor_bufs, int64_t n_factors,
                    int64_t b, const int64_t* ms, const int64_t* rs,
                    int32_t lo, int32_t bits, int64_t words_per_image,
                    uint32_t* out) {
  const int vals_per_word = 30 / bits;
  const uint32_t limit = 1u << bits;
  std::vector<int> rcs(static_cast<size_t>(b), 0);
  parallel_for(b, [&](int64_t bi) {
    uint32_t* dst = out + bi * words_per_image;
    uint32_t acc = 0;
    int slot = 0;
    int bad = 0;
    for (int64_t k = 0; k < n_factors; ++k) {
      const int64_t m = ms[k], r = rs[k];
      const int8_t* buf = factor_bufs[k] + bi * r * m;
      for (int64_t mi = 0; mi < m; ++mi) {
        for (int64_t ri = 0; ri < r; ++ri) {
          uint32_t v =
              static_cast<uint32_t>(static_cast<int32_t>(buf[ri * m + mi]) - lo);
          bad |= (v >= limit);
          acc |= (v & (limit - 1)) << (bits * slot);
          if (++slot == vals_per_word) {
            *dst++ = acc;
            acc = 0;
            slot = 0;
          }
        }
      }
    }
    if (slot != 0) *dst++ = acc;
    rcs[static_cast<size_t>(bi)] = bad;
  });
  for (int rc : rcs)
    if (rc != 0) return 1;
  return 0;
}

}  // extern "C"
