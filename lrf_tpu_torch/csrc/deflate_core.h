// zlib's level-9 DEFLATE of one fiber, byte for byte `zlib.compress(fiber, 9)`
// (zlib 1.2.12 and later: windowBits 15, memLevel 8, default strategy), in a
// form whose longest_match walks can run a warp at a time.
//
// Plain C++ that nvcc (csrc/deflate.cu, the card's kernel) and g++
// (native/deflate_twin.cpp, its host twin) both compile. It holds what both
// run alike: zlib's lazy parse (`Lazy`, deflate.c's `deflate_slow`), which
// asks its caller for each walk, and the block coder (`flush_block`: trees.c's
// `build_tree`, `_tr_flush_block` and the bits; `Coder`: the zlib header and
// trailer). `search` is the single-thread walk over `prev` that the twin
// runs; the kernel walks the same candidates from a hash-sorted array.
//
// The rules of zlib 1.2.13 (the same in 1.3) that let a walk run apart
// from the parse:
// - Every position p <= n - 3 is inserted into its hash chain before p + 1
//   is searched, inside matches too, and p before p itself is searched. So
//   the candidates of p never depend on the parse: the earlier positions q
//   with p's 15-bit hash h = ((h << 5) ^ c) & 0x7fff over p..p+2, newest
//   first. `prev[p]` is the newest (deflate.c's hash_head). q = 0 is never
//   a candidate (NIL is 0). The last two positions are neither inserted nor
//   searched.
// - The first candidate is taken at a distance up to MAX_DIST (32506), the
//   next ones below it (`longest_match`'s limit).
// - `longest_match` depends on the parse only through prev_length: the
//   chain is 4096 candidates, 1024 when prev_length >= 32 (good_length);
//   a candidate is taken only when longer than the best so far, which
//   starts at prev_length; the walk stops at the first length >= nice =
//   min(258, n - p). So a walk needs only its chain length: the first
//   candidate to reach the longest length gives zlib's result for any
//   prev_length, which the parser then compares.
// - Its comparison may read up to 258 bytes past the fiber's end, but a
//   length is only taken when it beats prev_length, and any candidate that
//   matches up to the end stops the walk; so what lies past the end never
//   changes the result, and `search` compares no further than nice.
// - The parse runs sequentially (`deflate_slow`, max_lazy 258) and asks
//   for a walk at each loop top it reaches, as zlib does, with TOO_FAR: a
//   length-3 match more than 4096 back is a literal.
// - A block ends after 16383 symbols (lit_bufsize - 1 with memLevel 8).
// - Up to kMaxFiber bytes, zlib reads the whole fiber into its 64 KiB
//   window at once and never slides it: deflate_slow calls fill_window at
//   every loop top with fewer than 262 bytes of lookahead, and that slides
//   once strstart >= wsize + MAX_DIST = 65274, the last loop top being at
//   strstart = n. A slide takes the window's first half away, so a stored
//   block that began there can no longer be chosen, and position 32768
//   becomes NIL. Longer fibers are refused.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LRF_HD __host__ __device__ __forceinline__
#else
#define LRF_HD inline
#endif

namespace lrf_deflate {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kWSize = 32768;
constexpr int kMaxDist = kWSize - (kMaxMatch + kMinMatch + 1);  // 32506
constexpr int kHashSize = 1 << 15;
constexpr int kMaxChain = 4096;
constexpr int kShortChain = kMaxChain >> 2;  // chain when prev_length >= kGoodLength
constexpr int kGoodLength = 32;
constexpr int kMaxLazy = 258;
constexpr int kTooFar = 4096;
constexpr int kSymEnd = 16383;  // symbols per block
constexpr int kMaxFiber = kWSize + kMaxDist - 1;  // 65273: the longest fiber zlib never slides
constexpr uint32_t kNoSearch = 0xFFFFFFFFu;  // a position zlib does not search

constexpr int kLiterals = 256;
constexpr int kEndBlock = 256;
constexpr int kLCodes = kLiterals + 1 + 29;  // 286
constexpr int kDCodes = 30;
constexpr int kBLCodes = 19;
constexpr int kHeapSize = 2 * kLCodes + 1;  // 573
constexpr int kMaxBits = 15;
constexpr int kMaxBLBits = 7;
constexpr int kRep3_6 = 16;
constexpr int kRepZ3_10 = 17;
constexpr int kRepZ11_138 = 18;

LRF_HD uint32_t hash3(const uint8_t* d) {
  return ((uint32_t(d[0]) << 10) ^ (uint32_t(d[1]) << 5) ^ uint32_t(d[2])) & (kHashSize - 1);
}

// A walk's result: the best length (>= 3) and its candidate, or 0.
LRF_HD uint32_t pack_match(int len, int pos) {
  return len >= kMinMatch ? (uint32_t(len) << 16) | uint32_t(pos) : 0u;
}

// longest_match's walk at p over `prev` (prev[q]: the newest earlier
// position with q's hash, 0 for none), `chain` candidates at most: the
// first candidate to reach the longest length, as pack_match, or kNoSearch
// where zlib calls no longest_match at p. The single-thread walk; the
// kernel walks the same candidates a warp or a CTA at a time.
LRF_HD uint32_t search(const uint8_t* d, int n, const uint16_t* prev, int p, int chain) {
  int q = p + kMinMatch <= n ? prev[p] : 0;
  if (q == 0 || p - q > kMaxDist) return kNoSearch;
  const int nice = n - p < kMaxMatch ? n - p : kMaxMatch;
  const int limit = p > kMaxDist ? p - kMaxDist : 0;
  const uint8_t* scan = d + p;
  int best = kMinMatch - 1, best_q = 0;
  for (int count = 0; count < chain; count++) {
    const uint8_t* m = d + q;
    if (m[best] == scan[best] && m[0] == scan[0] && m[1] == scan[1]) {
      int len = 2;
      while (len < nice && m[len] == scan[len]) ++len;
      if (len > best) {
        best = len;
        best_q = q;
        if (len >= nice) break;
      }
    }
    q = prev[q];
    if (q <= limit) break;
  }
  return pack_match(best, best_q);
}

LRF_HD int ilog2(unsigned v) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(int(v));
#else
  return 31 - __builtin_clz(v);
#endif
}

LRF_HD unsigned bi_reverse(unsigned code, int len) {
  unsigned res = 0;
  do {
    res |= code & 1;
    code >>= 1;
    res <<= 1;
  } while (--len > 0);
  return res >> 1;
}

// trees.c's tables, as arithmetic.
LRF_HD int length_code(int lc) {  // lc = length - 3, 0..255
  if (lc < 8) return lc;
  if (lc == 255) return 28;
  const int e = ilog2(unsigned(lc)) - 2;
  return 4 * e + 4 + ((lc >> e) & 3);
}
LRF_HD int extra_lbits(int code) { return code < 8 || code == 28 ? 0 : (code - 4) >> 2; }
LRF_HD int base_length(int code) {
  if (code < 8) return code;
  if (code == 28) return 255;
  const int e = (code - 4) >> 2;
  return (4 + (code & 3)) << e;
}
LRF_HD int dist_code(int d) {  // d = distance - 1, 0..32767
  if (d < 4) return d;
  const int e = ilog2(unsigned(d)) - 1;
  return 2 * e + 2 + ((d >> e) & 1);
}
LRF_HD int extra_dbits(int code) { return code < 4 ? 0 : (code >> 1) - 1; }
LRF_HD int base_dist(int code) { return code < 4 ? code : (2 + (code & 1)) << ((code >> 1) - 1); }
LRF_HD int extra_blbits(int code) { return code == 16 ? 2 : code == 17 ? 3 : code == 18 ? 7 : 0; }
LRF_HD int static_llen(int n) { return n < 144 ? 8 : n < 256 ? 9 : n < 280 ? 7 : 8; }
LRF_HD unsigned static_lcode(int n) {
  if (n < 144) return bi_reverse(48 + n, 8);
  if (n < 256) return bi_reverse(400 + n - 144, 9);
  if (n < 280) return bi_reverse(n - 256, 7);
  return bi_reverse(192 + n - 280, 8);
}
constexpr int kStaticDLen = 5;
LRF_HD unsigned static_dcode(int n) { return bi_reverse(n, 5); }

// LSB-first bit writer into a fixed-capacity slot.
struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos;
  uint64_t buf;
  int bits;
  int overflow;

  LRF_HD void init(uint8_t* o, int64_t c) {
    out = o;
    cap = c;
    pos = 0;
    buf = 0;
    bits = 0;
    overflow = 0;
  }
  LRF_HD void byte(unsigned b) {
    if (pos < cap)
      out[pos] = uint8_t(b);
    else
      overflow = 1;
    ++pos;
  }
  LRF_HD void send(unsigned value, int len) {
    buf |= uint64_t(value) << bits;
    bits += len;
    while (bits >= 8) {
      byte(unsigned(buf & 0xff));
      buf >>= 8;
      bits -= 8;
    }
  }
  LRF_HD void windup() {
    if (bits > 0) byte(unsigned(buf & 0xff));
    buf = 0;
    bits = 0;
  }
};

// One tree of trees.c: ct_data's Freq/Code and Dad/Len, kept apart.
struct TreeView {
  uint16_t* freq;
  uint16_t* len;
  uint16_t* dad;
  uint16_t* code;
  int elems;
  int max_length;
  int kind;  // 0 literal/length, 1 distance, 2 bit length
  int max_code;
};

template <int N>
struct TreeArrays {
  uint16_t freq[N];
  uint16_t len[N];
  uint16_t dad[N];
  uint16_t code[N];
};

// trees.c's state of one block.
struct Trees {
  TreeArrays<kHeapSize> l;
  TreeArrays<2 * kDCodes + 1> d;
  TreeArrays<2 * kBLCodes + 1> bl;
  uint16_t heap[kHeapSize];
  uint8_t depth[kHeapSize];
  uint16_t bl_count[kMaxBits + 1];
  int heap_len;
  int heap_max;
  uint64_t opt_len;
  uint64_t static_len;
  int l_max_code;
  int d_max_code;
};

LRF_HD int extra_bits(int kind, int n) {
  if (kind == 0) return n >= kLiterals + 1 ? extra_lbits(n - (kLiterals + 1)) : 0;
  if (kind == 1) return extra_dbits(n);
  return extra_blbits(n);
}

LRF_HD int static_len_of(int kind, int n) { return kind == 0 ? static_llen(n) : kStaticDLen; }

LRF_HD bool smaller(const uint16_t* freq, const uint8_t* depth, int n, int m) {
  return freq[n] < freq[m] || (freq[n] == freq[m] && depth[n] <= depth[m]);
}

LRF_HD void pqdownheap(Trees& s, const uint16_t* freq, int k) {
  const int v = s.heap[k];
  int j = k << 1;
  while (j <= s.heap_len) {
    if (j < s.heap_len && smaller(freq, s.depth, s.heap[j + 1], s.heap[j])) j++;
    if (smaller(freq, s.depth, v, s.heap[j])) break;
    s.heap[k] = s.heap[j];
    k = j;
    j <<= 1;
  }
  s.heap[k] = uint16_t(v);
}

LRF_HD void gen_bitlen(Trees& s, TreeView& t) {
  const int max_code = t.max_code;
  int overflow = 0;
  for (int bits = 0; bits <= kMaxBits; bits++) s.bl_count[bits] = 0;
  t.len[s.heap[s.heap_max]] = 0;
  int h;
  for (h = s.heap_max + 1; h < kHeapSize; h++) {
    const int n = s.heap[h];
    int bits = t.len[t.dad[n]] + 1;
    if (bits > t.max_length) bits = t.max_length, overflow++;
    t.len[n] = uint16_t(bits);
    if (n > max_code) continue;
    s.bl_count[bits]++;
    const int xbits = extra_bits(t.kind, n);
    const uint64_t f = t.freq[n];
    s.opt_len += f * unsigned(bits + xbits);
    if (t.kind != 2) s.static_len += f * unsigned(static_len_of(t.kind, n) + xbits);
  }
  if (overflow == 0) return;
  do {
    int bits = t.max_length - 1;
    while (s.bl_count[bits] == 0) bits--;
    s.bl_count[bits]--;
    s.bl_count[bits + 1] += 2;
    s.bl_count[t.max_length]--;
    overflow -= 2;
  } while (overflow > 0);
  for (int bits = t.max_length; bits != 0; bits--) {
    int n = s.bl_count[bits];
    while (n != 0) {
      const int m = s.heap[--h];
      if (m > max_code) continue;
      if (t.len[m] != unsigned(bits)) {
        s.opt_len += (uint64_t(bits) - t.len[m]) * t.freq[m];
        t.len[m] = uint16_t(bits);
      }
      n--;
    }
  }
}

LRF_HD void gen_codes(TreeView& t, const uint16_t* bl_count) {
  uint16_t next_code[kMaxBits + 1];
  unsigned code = 0;
  for (int bits = 1; bits <= kMaxBits; bits++) {
    code = (code + bl_count[bits - 1]) << 1;
    next_code[bits] = uint16_t(code);
  }
  for (int n = 0; n <= t.max_code; n++) {
    const int len = t.len[n];
    if (len == 0) continue;
    t.code[n] = uint16_t(bi_reverse(next_code[len]++, len));
  }
}

LRF_HD void build_tree(Trees& s, TreeView& t) {
  int max_code = -1;
  s.heap_len = 0;
  s.heap_max = kHeapSize;
  for (int n = 0; n < t.elems; n++) {
    if (t.freq[n] != 0) {
      s.heap[++s.heap_len] = uint16_t(max_code = n);
      s.depth[n] = 0;
    } else {
      t.len[n] = 0;
    }
  }
  while (s.heap_len < 2) {
    const int node = max_code < 2 ? ++max_code : 0;
    s.heap[++s.heap_len] = uint16_t(node);
    t.freq[node] = 1;
    s.depth[node] = 0;
    s.opt_len--;
    if (t.kind != 2) s.static_len -= static_len_of(t.kind, node);
  }
  t.max_code = max_code;
  for (int n = s.heap_len / 2; n >= 1; n--) pqdownheap(s, t.freq, n);
  int node = t.elems;
  do {
    const int n = s.heap[1];
    s.heap[1] = s.heap[s.heap_len--];
    pqdownheap(s, t.freq, 1);
    const int m = s.heap[1];
    s.heap[--s.heap_max] = uint16_t(n);
    s.heap[--s.heap_max] = uint16_t(m);
    t.freq[node] = uint16_t(t.freq[n] + t.freq[m]);
    s.depth[node] = uint8_t((s.depth[n] >= s.depth[m] ? s.depth[n] : s.depth[m]) + 1);
    t.dad[n] = t.dad[m] = uint16_t(node);
    s.heap[1] = uint16_t(node++);
    pqdownheap(s, t.freq, 1);
  } while (s.heap_len >= 2);
  s.heap[--s.heap_max] = s.heap[1];
  gen_bitlen(s, t);
  gen_codes(t, s.bl_count);
}

// Run-length pass over a tree's code lengths: scan_tree when `w` is null
// (counts into the bit-length tree), send_tree otherwise.
LRF_HD void scan_or_send(Trees& s, uint16_t* len, int max_code, BitWriter* w) {
  int prevlen = -1, nextlen = len[0], count = 0, max_count = 7, min_count = 4;
  uint16_t* blf = s.bl.freq;
  if (nextlen == 0) max_count = 138, min_count = 3;
  if (w == nullptr) len[max_code + 1] = 0xffff;  // guard
  for (int n = 0; n <= max_code; n++) {
    const int curlen = nextlen;
    nextlen = len[n + 1];
    if (++count < max_count && curlen == nextlen) continue;
    if (w == nullptr) {
      if (count < min_count) {
        blf[curlen] = uint16_t(blf[curlen] + count);
      } else if (curlen != 0) {
        if (curlen != prevlen) blf[curlen]++;
        blf[kRep3_6]++;
      } else if (count <= 10) {
        blf[kRepZ3_10]++;
      } else {
        blf[kRepZ11_138]++;
      }
    } else {
      const uint16_t* c = s.bl.code;
      const uint16_t* l = s.bl.len;
      if (count < min_count) {
        do {
          w->send(c[curlen], l[curlen]);
        } while (--count != 0);
      } else if (curlen != 0) {
        if (curlen != prevlen) {
          w->send(c[curlen], l[curlen]);
          count--;
        }
        w->send(c[kRep3_6], l[kRep3_6]);
        w->send(unsigned(count - 3), 2);
      } else if (count <= 10) {
        w->send(c[kRepZ3_10], l[kRepZ3_10]);
        w->send(unsigned(count - 3), 3);
      } else {
        w->send(c[kRepZ11_138], l[kRepZ11_138]);
        w->send(unsigned(count - 11), 7);
      }
    }
    count = 0;
    prevlen = curlen;
    if (nextlen == 0) {
      max_count = 138, min_count = 3;
    } else if (curlen == nextlen) {
      max_count = 6, min_count = 3;
    } else {
      max_count = 7, min_count = 4;
    }
  }
}

// trees.c's bl_order: {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15}.
LRF_HD int bl_order(int i) {
  switch (i) {
    case 0: return 16; case 1: return 17; case 2: return 18; case 3: return 0; case 4: return 8;
    case 5: return 7; case 6: return 9; case 7: return 6; case 8: return 10; case 9: return 5;
    case 10: return 11; case 11: return 4; case 12: return 12; case 13: return 3; case 14: return 13;
    case 15: return 2; case 16: return 14; case 17: return 1; default: return 15;
  }
}

// Symbols of a block as zlib's sym_buf: distance (0 for a literal) low and
// high byte, then the literal or length - 3.
LRF_HD void compress_block(BitWriter& w, const uint8_t* sym, int nsym, const uint16_t* lcode, const uint16_t* llen,
                           const uint16_t* dcode, const uint16_t* dlen, bool fixed) {
  for (int i = 0; i < nsym; i++) {
    unsigned dist = unsigned(sym[3 * i]) | (unsigned(sym[3 * i + 1]) << 8);
    int lc = sym[3 * i + 2];
    if (dist == 0) {
      if (fixed)
        w.send(static_lcode(lc), static_llen(lc));
      else
        w.send(lcode[lc], llen[lc]);
    } else {
      int code = length_code(lc);
      const int s = code + kLiterals + 1;
      if (fixed)
        w.send(static_lcode(s), static_llen(s));
      else
        w.send(lcode[s], llen[s]);
      int extra = extra_lbits(code);
      if (extra != 0) w.send(unsigned(lc - base_length(code)), extra);
      dist--;
      code = dist_code(int(dist));
      if (fixed)
        w.send(static_dcode(code), kStaticDLen);
      else
        w.send(dcode[code], dlen[code]);
      extra = extra_dbits(code);
      if (extra != 0) w.send(dist - unsigned(base_dist(code)), extra);
    }
  }
  if (fixed)
    w.send(static_lcode(kEndBlock), static_llen(kEndBlock));
  else
    w.send(lcode[kEndBlock], llen[kEndBlock]);
}

// trees.c's _tr_flush_block at level 9 with the default strategy: the
// block's symbols `sym` (nsym of them) covering `stored_len` bytes at `buf`.
// `counted`: the caller has already set the literal/length and distance
// frequencies of the symbols (without the end of block's).
LRF_HD void flush_block(Trees& s, BitWriter& w, const uint8_t* sym, int nsym, const uint8_t* buf, int64_t stored_len,
                        int last, bool counted = false) {
  // init_block and the tallies
  if (!counted) {
    for (int n = 0; n < kLCodes; n++) s.l.freq[n] = 0;
    for (int n = 0; n < kDCodes; n++) s.d.freq[n] = 0;
    for (int i = 0; i < nsym; i++) {
      const unsigned dist = unsigned(sym[3 * i]) | (unsigned(sym[3 * i + 1]) << 8);
      const int lc = sym[3 * i + 2];
      if (dist == 0) {
        s.l.freq[lc]++;
      } else {
        s.l.freq[length_code(lc) + kLiterals + 1]++;
        s.d.freq[dist_code(int(dist) - 1)]++;
      }
    }
  }
  for (int n = 0; n < kBLCodes; n++) s.bl.freq[n] = 0;
  s.l.freq[kEndBlock] = 1;
  s.opt_len = s.static_len = 0;
  TreeView lt{s.l.freq, s.l.len, s.l.dad, s.l.code, kLCodes, kMaxBits, 0, 0};
  TreeView dt{s.d.freq, s.d.len, s.d.dad, s.d.code, kDCodes, kMaxBits, 1, 0};
  TreeView bt{s.bl.freq, s.bl.len, s.bl.dad, s.bl.code, kBLCodes, kMaxBLBits, 2, 0};
  build_tree(s, lt);
  build_tree(s, dt);
  // build_bl_tree
  scan_or_send(s, s.l.len, lt.max_code, nullptr);
  scan_or_send(s, s.d.len, dt.max_code, nullptr);
  build_tree(s, bt);
  int max_blindex;
  for (max_blindex = kBLCodes - 1; max_blindex >= 3; max_blindex--)
    if (s.bl.len[bl_order(max_blindex)] != 0) break;
  s.opt_len += 3 * (uint64_t(max_blindex) + 1) + 5 + 5 + 4;

  uint64_t opt_lenb = (s.opt_len + 3 + 7) >> 3;
  const uint64_t static_lenb = (s.static_len + 3 + 7) >> 3;
  if (static_lenb <= opt_lenb) opt_lenb = static_lenb;
  if (uint64_t(stored_len) + 4 <= opt_lenb) {
    w.send(unsigned(last), 3);  // STORED_BLOCK << 1
    w.windup();
    w.byte(unsigned(stored_len) & 0xff);
    w.byte((unsigned(stored_len) >> 8) & 0xff);
    w.byte(~unsigned(stored_len) & 0xff);
    w.byte((~unsigned(stored_len) >> 8) & 0xff);
    for (int64_t i = 0; i < stored_len; i++) w.byte(buf[i]);
  } else if (static_lenb == opt_lenb) {
    w.send(unsigned(2 + last), 3);  // STATIC_TREES << 1
    compress_block(w, sym, nsym, nullptr, nullptr, nullptr, nullptr, true);
  } else {
    w.send(unsigned(4 + last), 3);  // DYN_TREES << 1
    const int lcodes = lt.max_code + 1, dcodes = dt.max_code + 1, blcodes = max_blindex + 1;
    w.send(unsigned(lcodes - 257), 5);
    w.send(unsigned(dcodes - 1), 5);
    w.send(unsigned(blcodes - 4), 4);
    for (int rank = 0; rank < blcodes; rank++) w.send(s.bl.len[bl_order(rank)], 3);
    scan_or_send(s, s.l.len, lcodes - 1, &w);
    scan_or_send(s, s.d.len, dcodes - 1, &w);
    compress_block(w, sym, nsym, s.l.code, s.l.len, s.d.code, s.d.len, false);
  }
  if (last) w.windup();
}

// The coder's side of a fiber: the zlib header, a block's symbols as
// zlib's sym_buf (distance low and high byte, then the literal or length -
// 3), each block's trees and bits, and the Adler-32 trailer.
struct Coder {
  Trees trees;
  BitWriter w;

  LRF_HD void begin(uint8_t* out, int64_t cap) {
    w.init(out, cap);
    w.byte(0x78);  // deflate.c's header for windowBits 15 at level 9
    w.byte(0xDA);
  }
  LRF_HD static void tally(uint8_t* sym, int i, unsigned dist, unsigned lc) {
    sym[3 * i] = uint8_t(dist);
    sym[3 * i + 1] = uint8_t(dist >> 8);
    sym[3 * i + 2] = uint8_t(lc);
  }
  // Returns the stream's length, or -1 when it did not fit the slot.
  LRF_HD int64_t end(uint32_t adler) {
    w.byte(adler >> 24);
    w.byte((adler >> 16) & 0xff);
    w.byte((adler >> 8) & 0xff);
    w.byte(adler & 0xff);
    return w.overflow ? -1 : w.pos;
  }
};

// deflate.c's deflate_slow, resumable at loop tops: `run` takes the loop
// tops before `stop`, `finish` ends the stream. It asks `search(p, chain)`
// for longest_match's walk at p (`chain` candidates at most: kMaxChain, or
// kShortChain when prev_length >= kGoodLength), which returns
// pack_match(length, candidate) of the first candidate to reach the longest
// length (0 under 3), or kNoSearch where zlib calls no longest_match; and
// it hands symbols to `emit.tally(i, dist, lc)` and blocks to
// `emit.flush(nsym, block_start, stored_len, last)`. Its state is a few
// integers, so every lane of a warp can hold its own copy.
struct Lazy {
  int n;
  int strstart;
  int lookahead;
  int match_length;
  int match_start;
  int prev_length;
  int prev_match;
  int match_available;
  int block_start;
  int nsym;

  LRF_HD void init(int fiber_len) {
    n = fiber_len;
    strstart = 0;
    lookahead = fiber_len;
    match_length = prev_length = kMinMatch - 1;
    match_start = prev_match = 0;
    match_available = 0;
    block_start = 0;
    nsym = 0;
  }

  template <class Emit>
  LRF_HD bool tally(Emit& emit, unsigned dist, unsigned lc) {
    emit.tally(nsym, dist, lc);
    return ++nsym == kSymEnd;
  }

  template <class Emit>
  LRF_HD void flush(Emit& emit, int last) {
    emit.flush(nsym, block_start, strstart - block_start, last);
    block_start = strstart;
    nsym = 0;
  }

  template <class Search, class Emit>
  LRF_HD void run(const uint8_t* data, int stop, Search& search, Emit& emit) {
    while (lookahead != 0 && strstart < stop) {
      const int p = strstart;
      prev_length = match_length;
      prev_match = match_start;
      match_length = kMinMatch - 1;
      if (prev_length < kMaxLazy) {
        const uint32_t r = search(p, prev_length >= kGoodLength ? kShortChain : kMaxChain);
        if (r != kNoSearch) {  // longest_match
          const int len = int(r >> 16);
          if (len > prev_length) {
            match_length = len;
            match_start = int(r & 0xffff);
          } else {
            match_length = prev_length < lookahead ? prev_length : lookahead;
          }
          if (match_length == kMinMatch && p - match_start > kTooFar) match_length = kMinMatch - 1;
        }
      }
      if (prev_length >= kMinMatch && match_length <= prev_length) {
        const bool full = tally(emit, unsigned(strstart - 1 - prev_match), unsigned(prev_length - kMinMatch));
        lookahead -= prev_length - 1;
        strstart += prev_length - 1;
        match_available = 0;
        match_length = kMinMatch - 1;
        if (full) flush(emit, 0);
      } else if (match_available) {
        if (tally(emit, 0, data[strstart - 1])) flush(emit, 0);
        strstart++;
        lookahead--;
      } else {
        match_available = 1;
        strstart++;
        lookahead--;
      }
    }
  }

  // The end of deflate_slow under Z_FINISH: the last literal, the last block.
  template <class Emit>
  LRF_HD void finish(const uint8_t* data, Emit& emit) {
    if (match_available) {
      tally(emit, 0, data[strstart - 1]);
      match_available = 0;
    }
    flush(emit, 1);
  }
};

}  // namespace lrf_deflate
