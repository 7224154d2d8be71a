// Per-fiber zlib level-9 DEFLATE of a batch's int8 factors on the card,
// byte for byte `zlib.compress(fiber, 9)` (zlib 1.2.12 and later).
//
// A fiber is one column r of one image b of a (B, M, R) row-major factor:
// M bytes at stride R. One CTA codes one fiber, with the fiber in shared
// memory throughout:
//   1. load: the fiber's bytes gathered into shared memory;
//   2. sort: every position p <= M - 3 into S, ordered by (hash of
//      p..p+2, p): a counting sort, the per-hash counts summed to offsets,
//      then the positions scattered in chunks of the CTA's threads, each chunk
//      sorted by (hash, position) with a bitonic sort so that the scatter
//      keeps positions in order within a hash. A position's index in S
//      goes to `rank`, in shared memory where it fits (M up to about
//      32,000), else to a global scratch. The candidates of zlib's chain at
//      p are then S[rank[p] - 1], S[rank[p] - 2], ... while the hash holds:
//      the chain as an array, newest first;
//   3. Adler-32 of the fiber, summed over all threads;
//   4. parse: warp 0 runs zlib's lazy parse (deflate_core.h's `Lazy`, the
//      code the host twin runs), every lane holding the parser's state.
//      Where it asks for longest_match's walk at p, the warp compares 32
//      candidates at once, in chain order, 16 bytes a step; a chain that
//      goes on past kWarpCandidates is taken by the whole CTA, a candidate
//      a thread each round, the other warps waiting at a named barrier
//      until warp 0 posts a walk. A round keeps the first candidate of the
//      longest length, so every round after the first skips, as zlib does,
//      what cannot beat the best so far. The warp counts each block's
//      symbols; lane 0 codes the block (trees, stored/static/dynamic
//      choice, bits) into the fiber's output slot.
// Shared memory: the fiber, S and rank (2 bytes a position each), and a
// 64-KiB table (the per-hash counters while sorting; then the block's
// symbols and the coder's state). That bounds M at 54,857 on an H100
// (227 KiB a CTA; `lrf_deflate_max_fiber`), below the 65,273 past which
// zlib would slide its window.
//
// The host calls lrf_deflate_launch once per group of factors of one M, on
// its stream; it allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "deflate_core.h"

namespace {

using namespace lrf_deflate;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFactors = 8;
constexpr int kWarpCandidates = 32;  // a walk's first candidates, by warp 0 alone
constexpr int kTableBytes = 2 * kHashSize;  // uint16 counters per hash
constexpr int kCoderOffset = 49152;          // after the symbols, inside the table's room
constexpr unsigned kFull = 0xffffffffu;
static_assert(3 * kSymEnd <= kCoderOffset, "symbols overrun the coder");
static_assert(kCoderOffset + sizeof(Coder) <= kTableBytes, "the coder does not fit beside the symbols");

struct Factor {
  const int8_t* src;   // (B, M, R) row-major
  long long slot_base; // the factor's first output slot, in bytes
  long long lens_base; // the factor's first fiber in `lens`
  long long rank_base; // the factor's first position in the launch's `rank` scratch
  int m;
  int r;
  int cap;             // bytes of one output slot
  int cta0;            // the factor's first CTA in the launch
};

struct Params {
  Factor f[kMaxFactors];
  int nf;
  uint8_t* out;
  int* lens;
  int* rank;          // null where rank_in_smem
  int rank_in_smem;   // rank as 2 bytes a position in shared memory, not in `rank`
};

// A walk posted by warp 0 for the whole CTA.
struct Walk {
  int live;  // 0: the parse is over
  int p, idx, hash, nice, chain, i0, best, best_i;
  uint32_t head;  // bytes p..p+3
};

__host__ __device__ constexpr long long round16(long long x) { return (x + 15) & ~15ll; }

__host__ __device__ long long smem_bytes(int m, bool rank_in_smem) {
  return round16(m) + round16(2ll * m) * (rank_in_smem ? 2 : 1) + kTableBytes + 4ll * kThreads;
}

// Whether rank fits in shared memory beside the rest, at M = m on a device
// whose CTAs may opt in to `optin` bytes (1024: room for the static shared
// memory).
__host__ bool rank_fits(int m, int optin) { return smem_bytes(m, true) + 1024 <= optin; }

__device__ __forceinline__ void named_barrier() { asm volatile("bar.sync 1, %0;" ::"r"(kThreads) : "memory"); }

// Exclusive prefix sum (op 0) or inclusive max (op 1) over the CTA.
template <int Op>
__device__ uint32_t block_scan(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = Op == 0 ? x + y : max(x, y);
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? scratch[lane] : 0;
    for (int off = 1; off < kWarps; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w = Op == 0 ? w + y : max(w, y);
    }
    if (lane < kWarps) scratch[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp > 0 ? scratch[warp - 1] : 0;
  __syncthreads();
  return Op == 0 ? x - v + before : max(x, before);
}

__device__ void bitonic_sort(uint32_t* keys, int tid) {
  for (int k = 2; k <= kThreads; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int ixj = tid ^ j;
      if (ixj > tid) {
        const uint32_t a = keys[tid], b = keys[ixj];
        if (((tid & k) == 0) ? a > b : a < b) {
          keys[tid] = b;
          keys[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Four bytes of `d` from byte a on (little-endian), from two aligned words;
// `d` is 4-byte aligned and readable for 8 bytes past a (the fiber is
// followed by S and the table in shared memory).
__device__ __forceinline__ uint32_t word_at(const uint8_t* d, int a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(d) + (a >> 2);
  return __funnelshift_r(w[0], w[1], (a & 3) * 8);
}

// Bytes that the strings at q and p share from the start, at most `nice`,
// sixteen at a time (the loads of a step are independent); reads up to 20
// bytes past the shorter of them.
__device__ __forceinline__ int common_length(const uint8_t* d, int q, int p, int nice) {
  int len = 0;
  while (len < nice) {
    uint32_t x[4];
#pragma unroll
    for (int k = 0; k < 4; k++) x[k] = word_at(d, q + len + 4 * k) ^ word_at(d, p + len + 4 * k);
#pragma unroll
    for (int k = 0; k < 4; k++) {
      if (x[k] != 0) {
        len += 4 * k + ((__ffs(x[k]) - 1) >> 3);
        return len < nice ? len : nice;
      }
    }
    len += 16;
  }
  return nice;
}

// hash3 of the first three bytes of a word.
__device__ __forceinline__ int word_hash(uint32_t x) {
  return int((((x & 0xff) << 10) ^ (((x >> 8) & 0xff) << 5) ^ ((x >> 16) & 0xff)) & (kHashSize - 1));
}

// Candidate i of the walk at p: whether it is one (zlib's chain goes on to
// it), and, where it may beat `best`, its length as (len << 16) | (0xffff -
// i), so that the largest key is the first candidate of the longest length.
// `tail` is the word of p's bytes best - 3 .. best (best >= 3). A candidate
// that beats best matches p at bytes 0 .. best, so one that differs in
// bytes 0-1 (byte 2 then follows from the hash) or in that word is passed
// over before its bytes are compared: zlib's own quick check, four bytes
// wide.
__device__ __forceinline__ uint32_t candidate(const uint8_t* d, const uint16_t* S, const Walk& w, int i, int best,
                                              uint32_t tail, bool* valid) {
  *valid = false;
  if (i >= w.chain || i >= w.idx) return 0;
  const int q = S[w.idx - 1 - i];
  const int dist = w.p - q;
  if (q == 0 || dist > kMaxDist || (dist == kMaxDist && i > 0)) return 0;
  const uint32_t head = word_at(d, q);
  if (word_hash(head) != w.hash) return 0;
  *valid = true;
  if (((head ^ w.head) & 0xffff) != 0) return 0;
  if (best >= kMinMatch && word_at(d, q + best - 3) != tail) return 0;
  const int len = common_length(d, q, w.p, w.nice);
  return len > best ? (uint32_t(len) << 16) | uint32_t(0xffff - i) : 0u;
}

__device__ __forceinline__ uint32_t warp_max(uint32_t v) { return __reduce_max_sync(kFull, v); }

// The rounds of a walk from candidate w.i0 on, kThreads candidates each, by
// every thread of the CTA; leaves the result in w.best / w.best_i.
__device__ void cta_rounds(const uint8_t* d, const uint16_t* S, Walk& w, uint32_t (*red)[kWarps],
                           unsigned char (*redv)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = w.i0, par = 0;; i0 += kThreads, par ^= 1) {
    bool valid;
    const uint32_t tail = w.best >= kMinMatch ? word_at(d, w.p + w.best - 3) : 0;
    const uint32_t key = warp_max(candidate(d, S, w, i0 + int(threadIdx.x), w.best, tail, &valid));
    const bool all = __all_sync(kFull, valid);
    if (lane == 0) {
      red[par][warp] = key;
      redv[par][warp] = all;
    }
    named_barrier();
    uint32_t k = 0;
    bool round_all = true;
    for (int v = 0; v < kWarps; v++) {
      k = max(k, red[par][v]);
      round_all = round_all && redv[par][v];
    }
    if (int(k >> 16) > w.best) {
      w.best = int(k >> 16);
      w.best_i = 0xffff - int(k & 0xffff);
    }
    if (w.best >= w.nice || !round_all || i0 + kThreads >= w.chain) break;
  }
  named_barrier();  // everyone has read the last round before the next walk writes
}

// longest_match's walk for warp 0's parse: 32 candidates by the warp, the
// rest, if any, by the CTA.
struct WarpSearch {
  const uint8_t* d;
  const uint16_t* S;
  const uint16_t* rank16;  // in shared memory, or null: then `rank`
  const int* rank;
  int n;
  int lane;
  Walk* post;
  uint32_t (*red)[kWarps];
  unsigned char (*redv)[kWarps];
  int w0;  // the positions whose ranks the lanes hold: w0 + lane
  int rw;

  __device__ uint32_t operator()(int p, int chain) {
    if (p + kMinMatch > n) return kNoSearch;
    Walk w;
    w.p = p;
    if (rank16 != nullptr) {
      w.idx = rank16[p];
    } else {
      if (unsigned(p - w0) >= 32u) {
        w0 = p;
        rw = p + lane < n ? rank[p + lane] : 0;
      }
      w.idx = __shfl_sync(kFull, rw, p - w0);
    }
    w.head = word_at(d, p);
    w.hash = word_hash(w.head);
    if (w.idx == 0) return kNoSearch;
    const int q0 = S[w.idx - 1];
    if (q0 == 0 || word_hash(word_at(d, q0)) != w.hash || p - q0 > kMaxDist) return kNoSearch;
    w.nice = n - p < kMaxMatch ? n - p : kMaxMatch;
    w.chain = chain;
    w.best = kMinMatch - 1;
    w.best_i = -1;
    bool more = true;
    for (int i0 = 0; i0 < kWarpCandidates && more; i0 += 32) {
      bool valid;
      const uint32_t tail = w.best >= kMinMatch ? word_at(d, p + w.best - 3) : 0;
      const uint32_t key = warp_max(candidate(d, S, w, i0 + lane, w.best, tail, &valid));
      if (int(key >> 16) > w.best) {
        w.best = int(key >> 16);
        w.best_i = 0xffff - int(key & 0xffff);
      }
      more = w.best < w.nice && __all_sync(kFull, valid) && chain > i0 + 32;
    }
    if (more) {
      w.i0 = kWarpCandidates;
      w.live = 1;
      if (lane == 0) *post = w;
      __syncwarp();
      named_barrier();  // the other warps take the walk
      cta_rounds(d, S, w, red, redv);
    }
    return w.best_i >= 0 ? pack_match(w.best, S[w.idx - 1 - w.best_i]) : 0u;
  }
};

// Symbols and blocks from warp 0's parse: lane 0 writes, the warp waits.
struct WarpEmit {
  uint8_t* sym;
  Coder* coder;
  const uint8_t* d;
  int lane;

  __device__ void tally(int i, unsigned dist, unsigned lc) {
    if (lane == 0) Coder::tally(sym, i, dist, lc);
  }
  // The block's tallies by the warp (two uint16 counters a word: no count
  // of a block reaches 2^16), its coding by lane 0.
  __device__ void count(uint16_t* freq, int i) {
    atomicAdd(reinterpret_cast<unsigned*>(freq) + (i >> 1), 1u << ((i & 1) * 16));
  }
  __device__ void flush(int nsym, int block_start, int stored_len, int last) {
    Trees& t = coder->trees;
    for (int i = lane; i < kLCodes; i += 32) t.l.freq[i] = 0;
    if (lane < kDCodes) t.d.freq[lane] = 0;
    __syncwarp();
    for (int i = lane; i < nsym; i += 32) {
      const unsigned dist = unsigned(sym[3 * i]) | (unsigned(sym[3 * i + 1]) << 8);
      const int lc = sym[3 * i + 2];
      if (dist == 0) {
        count(t.l.freq, lc);
      } else {
        count(t.l.freq, length_code(lc) + kLiterals + 1);
        count(t.d.freq, dist_code(int(dist) - 1));
      }
    }
    __syncwarp();
    if (lane == 0) {
      flush_block(t, coder->w, sym, nsym, d + block_start, stored_len, last, true);
    }
    __syncwarp();
  }
};

__global__ void __launch_bounds__(kThreads) deflate_fibers_kernel(const Params prm) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long adler_a, adler_b;
  __shared__ uint32_t scan[kWarps];
  __shared__ uint32_t red[2][kWarps];
  __shared__ unsigned char redv[2][kWarps];
  __shared__ Walk post;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int k = 0;
  while (k + 1 < prm.nf && int(blockIdx.x) >= prm.f[k + 1].cta0) k++;
  const Factor f = prm.f[k];
  const int j = int(blockIdx.x) - f.cta0;
  const int bi = j / f.r, ri = j % f.r;
  const int n = f.m;

  uint8_t* data = smem;
  uint16_t* S = reinterpret_cast<uint16_t*>(smem + round16(n));
  uint16_t* rank16 = prm.rank_in_smem ? reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(S) + round16(2ll * n))
                                      : nullptr;
  uint8_t* table = reinterpret_cast<uint8_t*>(S) + round16(2ll * n) * (prm.rank_in_smem ? 2 : 1);
  uint32_t* keys = reinterpret_cast<uint32_t*>(table + kTableBytes);
  int* rank = prm.rank_in_smem ? nullptr : prm.rank + f.rank_base + (long long)j * n;

  // 1. load
  const int8_t* src = f.src + (long long)bi * n * f.r + ri;
  for (int i = tid; i < n; i += kThreads) data[i] = uint8_t(src[(long long)i * f.r]);
  uint32_t* table32 = reinterpret_cast<uint32_t*>(table);
  for (int i = tid; i < kTableBytes / 4; i += kThreads) table32[i] = 0;
  if (tid == 0) adler_a = adler_b = 0;
  __syncthreads();

  // 2. sort: counts per hash, their offsets, then the scatter in chunks
  const int inserted = n >= kMinMatch ? n - (kMinMatch - 1) : 0;
  for (int p = tid; p < inserted; p += kThreads) {
    const uint32_t h = hash3(data + p);
    atomicAdd(&table32[h >> 1], (h & 1) ? 0x10000u : 1u);
  }
  __syncthreads();
  uint16_t* cursor = reinterpret_cast<uint16_t*>(table);
  constexpr int kPer = kHashSize / kThreads;
  uint32_t sum = 0;
  for (int i = 0; i < kPer; i++) sum += cursor[tid * kPer + i];
  uint32_t running = block_scan<0>(sum, scan);
  for (int i = 0; i < kPer; i++) {
    const uint32_t c = cursor[tid * kPer + i];
    cursor[tid * kPer + i] = uint16_t(running);
    running += c;
  }
  __syncthreads();
  for (int c0 = 0; c0 < inserted; c0 += kThreads) {
    const int p = c0 + tid;
    keys[tid] = p < inserted ? (hash3(data + p) << 16) | uint32_t(p) : 0xffffffffu;
    __syncthreads();
    bitonic_sort(keys, tid);
    const uint32_t key = keys[tid];
    const bool valid = key != 0xffffffffu;
    const uint32_t h = key >> 16;
    const bool first = valid && (tid == 0 || (keys[tid - 1] >> 16) != h);
    const bool last = valid && (tid == kThreads - 1 || (keys[tid + 1] >> 16) != h);
    const int run_start = int(block_scan<1>(first ? uint32_t(tid) : 0u, scan));
    if (valid) {
      const int slot = cursor[h] + (tid - run_start);
      S[slot] = uint16_t(key & 0xffff);
      if (rank16 != nullptr)
        rank16[key & 0xffff] = uint16_t(slot);
      else
        rank[key & 0xffff] = slot;
    }
    __syncthreads();
    if (last) cursor[h] = uint16_t(cursor[h] + tid - run_start + 1);
    __syncthreads();
  }

  // 3. Adler-32: a = 1 + sum d_i, b = n + sum (n - i) d_i (mod 65521)
  unsigned long long sa = 0, sb = 0;
  for (int i = tid; i < n; i += kThreads) {
    sa += data[i];
    sb += (unsigned long long)(n - i) * data[i];
  }
  for (int off = 16; off > 0; off >>= 1) {
    sa += __shfl_down_sync(kFull, sa, off);
    sb += __shfl_down_sync(kFull, sb, off);
  }
  if (lane == 0) {
    atomicAdd(&adler_a, sa);
    atomicAdd(&adler_b, sb);
  }
  __syncthreads();

  // 4. parse, blocks and walks
  uint8_t* sym = table;
  Coder* coder = reinterpret_cast<Coder*>(table + kCoderOffset);
  if (warp == 0) {
    if (lane == 0) coder->begin(prm.out + f.slot_base + (long long)j * f.cap, f.cap);
    __syncwarp();
    WarpSearch search{data, S, rank16, rank, n, lane, &post, red, redv, -1000, 0};
    WarpEmit emit{sym, coder, data, lane};
    Lazy lazy;
    lazy.init(n);
    lazy.run(data, n, search, emit);
    lazy.finish(data, emit);
    if (lane == 0) {
      const uint32_t a = uint32_t((1 + adler_a) % 65521), b = uint32_t((n + adler_b) % 65521);
      prm.lens[f.lens_base + j] = int(coder->end((b << 16) | a));
      post.live = 0;
    }
    __syncwarp();
    named_barrier();  // releases the other warps
  } else {
    for (;;) {
      named_barrier();
      Walk w = post;
      if (!w.live) break;
      cta_rounds(data, S, w, red, redv);
    }
  }
}

}  // namespace

extern "C" {

int lrf_deflate_max_factors() { return kMaxFactors; }

// Whether a launch at M = m on the current device keeps rank in a global
// scratch (*out = 1), which the caller then passes to lrf_deflate_launch.
int lrf_deflate_global_rank(int m, int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *out = rank_fits(m, optin) ? 0 : 1;
  return 0;
}

// The longest fiber the kernel takes on the current device: zlib's slide
// bound, or what the device's shared memory holds.
int lrf_deflate_max_fiber(int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, deflate_fibers_kernel);
  if (err != cudaSuccess) return (int)err;
  int m = kMaxFiber;
  while (m > 0 && smem_bytes(m, false) + (long long)attr.sharedSizeBytes > optin) m -= 16;
  *out = m;
  return 0;
}

// Code the fibers of `nf` factors that share M, one CTA a fiber. Factor i:
// `srcs[i]` (B_i, M, R_i) int8 on the device; its fibers' streams go to
// out + slot_base[i] + (b R_i + r) cap, their lengths (-1: the slot was too
// small) to lens[lens_base[i] + b R_i + r]. `rank` is a scratch of
// M (sum of B_i R_i) ints where lrf_deflate_global_rank says so, else
// null. Returns the launch's CUDA error (0 on success).
int lrf_deflate_launch(int nf, const void* const* srcs, const int* bs, const int* rs, int m, int cap,
                       const long long* slot_base, const long long* lens_base, void* out, int* lens, int* rank,
                       void* stream) {
  if (nf < 1 || nf > kMaxFactors || m < 1 || m > kMaxFiber) return (int)cudaErrorInvalidValue;
  Params prm{};
  prm.nf = nf;
  prm.out = static_cast<uint8_t*>(out);
  prm.lens = lens;
  prm.rank = rank;
  int ctas = 0;
  for (int i = 0; i < nf; i++) {
    prm.f[i] = Factor{static_cast<const int8_t*>(srcs[i]), slot_base[i], lens_base[i], (long long)ctas * m, m, rs[i],
                      cap, ctas};
    ctas += bs[i] * rs[i];
  }
  if (ctas == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  prm.rank_in_smem = rank_fits(m, optin);
  if (!prm.rank_in_smem && rank == nullptr) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(m, prm.rank_in_smem != 0);
  err = cudaFuncSetAttribute(deflate_fibers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  deflate_fibers_kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

const char* lrf_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
