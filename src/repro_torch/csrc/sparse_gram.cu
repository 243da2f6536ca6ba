// sparse_gram: G[d] = E_d E_d^T of every padded-ELL block, in f32.
//
// Replaces the TPU kernel src/repro/kernels/sparse_gram.py
// (_sparse_gram_kernel / sparse_gram).  That kernel expands each tile of
// stored columns into a dense (M, block_c) panel and feeds the matrix
// unit, with the whole (M, M) accumulator resident on the core across a
// sequential grid.  Neither carries over: no SM holds an (M, M) f32
// accumulator once M reaches about 240, and the panel is >99.9% zeros at
// the paper's density.
//
// What bounds it on an H100: bytes.  The work is sum_c nnz_c^2 multiply-
// adds (a few per stored column), against D*M*M*4 bytes of output that
// must be written and 8 bytes per ELL slot that must be read.  This form
// also pays for building a row index and for latency (PERF.md).
//
// Design: one owner per output row, no floating-point atomics, each row
// written once.  Five kernels on the caller's stream:
//   1. zero_counts: the (D, M) row counts of the workspace set to 0.
//   2. count_cols: one thread per stored column; each non-zero slot adds 1
//      to the count of its (d, row) with an integer atomicAdd (a count
//      does not depend on the order of the adds) and keeps the old count
//      as its rank in the row; the column's length, its last non-zero slot
//      plus one, is kept.  It traps on a row outside [0, M).
//   3. scan_counts: one block turns the D*M counts into exclusive offsets
//      (in place, plus the total at the end) and lists the rows of more
//      than EPW entries ("heavy"), longest first by powers of two.
//   4. place_slots: one thread per slot; a non-zero slot writes its slot
//      index c*K + k at its row's offset plus its rank.  The order inside
//      a list depends on the timing of step 2; the gram pass sorts it.
//   5. row_gram: the first blocks take the heavy rows from a queue, a block
//      a row; every other row is one warp's (a block of WARPS rows).  A
//      row's list is taken in ascending slot order, (c, k): a warp's row
//      (at most EPW entries) is sorted by a bitonic network, in registers
//      up to 32 keys, else in shared memory; a heavy row goes in pieces of
//      at most SEG_CAP entries, each the next SEG_CAP smallest keys (the
//      whole list if it fits, else a radix select over the keys and a
//      filtered copy), sorted in shared memory.  nw = min(WARPS, ceil(n / SPLIT)) warps share a heavy row
//      (n its length), each a fixed contiguous part of every piece, so the
//      heaviest rows (266 entries at the paper's shape, 3,349 at 2048 x
//      1,048,576) are spread over a block.  A warp takes its entries 32 at
//      a time; their pairs (entry e, slot k2 < the length of e's column)
//      form one flat sequence, 32 a step (so a column longer than 32 takes
//      several steps, and padding past a column's last non-zero slot costs
//      nothing): lane (e, k2) forms v(r1, c) * v(r2, c).  Lanes that hit
//      the same r2 in one step are grouped (__match_any_sync); the group's
//      first lane adds the group's products in lane order and adds the sum
//      to the warp's private copy of row r1 in shared memory.  A heavy
//      row's copies are then summed in warp order.  The row is written
//      once, zeros included, with coalesced stores.
//   Every G[r1, r2] is thus summed in an order that the data alone fixes
//   (list order, step, lane, warp), with __fmul_rn / __fadd_rn (no
//   contraction into FMA): the same input gives the same bits on every
//   call, and tests/test_torch_kernel_numerics.py models the order on the
//   CPU.  0/1 data is exact (every partial sum is a small integer).  G is
//   not exactly symmetric for weighted data: G[r1, r2] and G[r2, r1] are
//   summed in their own orders (eigh reads one triangle).  Padding slots
//   (val 0) never enter a list nor a product; duplicate (column, row)
//   slots are two entries and add.
//
// Limits.  Shared memory holds WARPS copies of a row chunk of at most
// ROW_CHUNK floats (64 KB at M = 2048 with 8 warps) plus the sorted keys;
// for M above ROW_CHUNK a row's list is walked once per chunk of r2.  No M,
// K or row length is refused; slot indices and offsets are int32, so the
// workspace, 2 D M + 9 + D C + 2 D C K int32 (counters, offsets, heavy
// rows, column lengths, ranks, lists, sized from the shapes alone), must
// stay below 2^31 entries (the wrapper checks).  row_chunk is a multiple
// of 4.
//
// Precondition: every slot whose value is non-zero holds a row index in
// [0, M).  The containers check it on the host when they are built
// (sparse.check_ell_arrays); a slot that breaks it traps the kernel, so
// the next synchronization raises instead of returning a wrong gram (the
// plain version's scatter_add_ fails on the same input).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 1024;
constexpr int SLOT_THREADS = 256;
constexpr int UNROLL = 4;          // steps whose loads are in flight at once
constexpr int SLOT_ILP = 4;        // slots a thread of count / place takes
constexpr int SCAN_ITEMS = 16;     // counts a scan thread takes a round
constexpr int KEY_MAX = 0x7fffffff;

__global__ void zero_counts(int* cnt, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    cnt[i] = 0;
}

// One thread a stored column (grid stride): each non-zero slot adds 1 to
// the count of its (d, row) with an integer atomicAdd and keeps what the
// count was as its rank in the row (the counts do not depend on the order
// of the adds; the ranks do, and the gram pass sorts each row's list); the
// column's length, its last non-zero slot plus one, goes to len.
// SLOT_ILP slots' loads are in flight at once.
__global__ void count_cols(const int* __restrict__ rows,
                           const float* __restrict__ vals, int* cnt,
                           int* rank, int* len, int c, int k, int m,
                           long long cols) {
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < cols; q += (long long)gridDim.x * blockDim.x) {
    const long long base = q * k;
    int* row_cnt = cnt + q / c * m;
    int last = 0;
    for (int k0 = 0; k0 < k; k0 += SLOT_ILP) {
      float v[SLOT_ILP];
      int r[SLOT_ILP];
#pragma unroll
      for (int u = 0; u < SLOT_ILP; ++u) {
        v[u] = k0 + u < k ? vals[base + k0 + u] : 0.0f;
        r[u] = k0 + u < k ? rows[base + k0 + u] : 0;
      }
#pragma unroll
      for (int u = 0; u < SLOT_ILP; ++u) {
        if (v[u] == 0.0f) continue;
        if (r[u] < 0 || r[u] >= m) __trap();  // precondition broken
        rank[base + k0 + u] = atomicAdd(row_cnt + r[u], 1);
        last = k0 + u + 1;
      }
    }
    len[q] = last;
  }
}

// One thread takes SLOT_ILP slots a round, a grid stride apart (their
// loads all in flight); a non-zero slot writes its slot index c*K + k at
// its row's offset plus its rank.
__global__ void place_slots(const int* __restrict__ rows,
                            const float* __restrict__ vals,
                            const int* __restrict__ rank, const int* off,
                            int* list, int c, int k, int m,
                            long long total) {
  const long long per_block = (long long)c * k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i0 < total; i0 += SLOT_ILP * stride) {
    float v[SLOT_ILP];
    int r[SLOT_ILP], at[SLOT_ILP];
#pragma unroll
    for (int u = 0; u < SLOT_ILP; ++u) {
      const long long i = i0 + u * stride;
      v[u] = i < total ? vals[i] : 0.0f;
      r[u] = i < total ? rows[i] : 0;
      at[u] = i < total ? rank[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < SLOT_ILP; ++u) {
      if (v[u] == 0.0f) continue;
      const long long i = i0 + u * stride, dd = i / per_block;
      list[off[dd * m + r[u]] + at[u]] = (int)(i - dd * per_block);
    }
  }
}

__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive offsets of n counts, in place, off[n] = the total.  Rows of more than epw entries are listed in heavy[0, ctr[0]),
// longest first by powers of two (within one power in no particular order:
// which block takes a row changes no sum); the row gram's queue head
// ctr[2] is set to 0.  One block: each warp scans
// SCAN_ITEMS runs of 32 counts (coalesced, all loads in flight), the warp
// totals are scanned by warp 0.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_counts(int* off, int* heavy, int* ctr, long long n,
            int epw) {
  __shared__ int wsum[32];
  __shared__ int bucket[33];           // heavy rows by floor(log2 length)
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (t < 33) bucket[t] = 0;
  __syncthreads();
  int carry = 0;
  for (long long b0 = 0; b0 < n; b0 += (long long)SCAN_THREADS * SCAN_ITEMS) {
    const long long base = b0 + (long long)warp * 32 * SCAN_ITEMS + lane;
    int v[SCAN_ITEMS], ex[SCAN_ITEMS];
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i)
      v[i] = base + 32 * i < n ? off[base + 32 * i] : 0;
    int run = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const int incl = warp_incl_scan(v[i]);
      ex[i] = run + incl - v[i];
      run += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) wsum[warp] = run;
    __syncthreads();
    if (warp == 0) {
      const int x = wsum[lane], incl = warp_incl_scan(x);
      wsum[lane] = incl - x;
      if (lane == 31) bucket[32] = incl;   // this round's total
    }
    __syncthreads();
    const int start = carry + wsum[warp];
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const long long idx = base + 32 * i;
      if (idx < n) {
        off[idx] = start + ex[i];
        if (v[i] > epw) atomicAdd(bucket + 31 - __clz(v[i]), 1);
      }
    }
    carry += bucket[32];
    __syncthreads();
  }
  if (t == 0) {
    off[n] = carry;
    int acc = 0;                        // bucket starts, longest first
    for (int b = 31; b >= 0; --b) {
      const int c = bucket[b];
      bucket[b] = acc;
      acc += c;
    }
    ctr[0] = acc;
    ctr[2] = 0;
  }
  __syncthreads();
  for (long long i = t; i < n; i += SCAN_THREADS) {
    const int len = off[i + 1] - off[i];
    if (len > epw) heavy[atomicAdd(bucket + 31 - __clz(len), 1)] = (int)i;
  }
}

struct GramArgs {
  const int* rows;
  const float* vals;
  const int* off;       // (D*M + 1) list offsets
  const int* list;      // slot indices c*K + k, by row
  const int* len;       // (D*C) column lengths: last non-zero slot + 1
  const int* heavy;     // rows of more than epw entries
  const int* heavy_n;   // the number of heavy rows
  float* out;           // (D, M, M)
  long long nrows;      // D*M
  int c, k, m;
  int* next;            // queue head of the heavy rows (zeroed by scan)
  int heavy_blocks;     // blocks [0, heavy_blocks) take the heavy rows
  int warps, epw, split, seg_cap, row_chunk;
  int epw_p2;           // epw rounded up to a power of two
  unsigned kdiv_m;      // n / k = (t + ((n - t) >> 1)) >> (kdiv_l - 1),
  int kdiv_l;           // t = umulhi(n, kdiv_m) (k > 1)
  int key_bits;         // keys lie in [0, 2^key_bits)

  __device__ __forceinline__ unsigned div_k(unsigned n) const {
    if (k == 1) return n;
    const unsigned t = __umulhi(n, kdiv_m);
    return (t + ((n - t) >> 1)) >> (kdiv_l - 1);
  }
};

// Bitonic sort of s[0, p2) ascending (p2 a power of two) by `n` threads
// from thread `t`; BLOCK: the whole block (else one warp).
template <bool BLOCK>
__device__ void sort_keys(int* s, int p2, int t, int n) {
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < (p2 >> 1); i += n) {
        const int lo = 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        const int x = s[lo], y = s[hi];
        const bool up = (lo & size) == 0;
        if ((x > y) == up) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      if (BLOCK) __syncthreads(); else __syncwarp();
    }
  }
}

// The want-th smallest key above `last` (1-based) among keys[0, n), keys
// in [0, 2^bits): a radix select from the top, 8 bits (256 bins) a pass.
__device__ int select_key(const int* keys, int n, int last, int want,
                          int bits, int* hist, int* pick) {
  unsigned prefix = 0, mask = 0;
  for (int top = bits; top > 0; top -= 8) {
    const int width = min(8, top), shift = top - width;
    const unsigned digit = (1u << width) - 1;
    for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int key = keys[i];
      if (key > last && ((unsigned)key & mask) == prefix)
        atomicAdd(hist + (((unsigned)key >> shift) & digit), 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // the bin where the running count reaches `want`: 8 bins a lane
      const int lane = threadIdx.x;
      int sum = 0;
      for (int b = 8 * lane; b < 8 * lane + 8; ++b) sum += hist[b];
      const int incl = warp_incl_scan(sum);
      const unsigned hit = __ballot_sync(FULL, incl >= want);
      const int first = hit ? __ffs(hit) - 1 : 31;
      if (lane == first) {
        int acc = incl - sum, b = 8 * lane;
        for (; b < 8 * lane + 7 && acc + hist[b] < want; ++b) acc += hist[b];
        pick[0] = b;
        pick[1] = want - acc;
      }
    }
    __syncthreads();
    prefix |= (unsigned)pick[0] << shift;
    mask |= digit << shift;
    want = pick[1];
    __syncthreads();
  }
  return (int)prefix;
}

// One warp adds the products of entries seg[pb, pe) of a sorted list into
// its copy `row` of the output row, for r2 in [lo, lo + clen).  Entries go
// 32 at a time; their pairs (entry e, slot k2 < len of e's column) are
// taken as one flat sequence, 32 a step, so padding past a column's last
// non-zero slot costs nothing.  Lanes that hit one r2 in a step are summed
// by the group's first lane in lane order, and the sum is added to the
// row.  UNROLL steps' loads are issued before their sums.
__device__ void warp_products(const GramArgs& a, const int* rows,
                              const float* vals, const int* lens,
                              const int* seg, int pb, int pe, float* row,
                              float* stg, int lo, int clen) {
  const int lane = threadIdx.x % 32;
  // entry e0 + lane of a chunk: its slot, its column's first slot and length
  int s1 = 0, col0 = 0, n_k = 0;
  if (lane < pe - pb) {
    s1 = seg[pb + lane];
    const int col = (int)a.div_k(s1);
    col0 = col * a.k;
    n_k = lens[col];
  }
  for (int e0 = pb; e0 < pe; e0 += 32) {
    const int ne = min(32, pe - e0);
    int s1_next = 0, col0_next = 0, n_k_next = 0;   // the next chunk's
    if (lane < pe - e0 - 32) {
      s1_next = seg[e0 + 32 + lane];
      const int col = (int)a.div_k(s1_next);
      col0_next = col * a.k;
      n_k_next = lens[col];
    }
    const int incl = warp_incl_scan(n_k);
    const int excl = incl - n_k;
    const int total = __shfl_sync(FULL, incl, 31);
    for (int q0 = 0; q0 < total; q0 += 32 * UNROLL) {
      int r2[UNROLL];
      float p[UNROLL];
      bool on[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = q0 + 32 * u + lane;
        // the entry of pair q: the last lane whose first pair is <= q
        int j = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int ex = __shfl_sync(FULL, excl, j + step);
          if (j + step < ne && ex <= q) j += step;
        }
        const int ex_j = __shfl_sync(FULL, excl, j);
        const int c0_j = __shfl_sync(FULL, col0, j);
        const int s1_j = __shfl_sync(FULL, s1, j);
        on[u] = false;
        r2[u] = 0;
        p[u] = 0.0f;
        if (q < total) {
          const int slot2 = c0_j + q - ex_j;
          const float v2 = vals[slot2], v1 = vals[s1_j];
          r2[u] = rows[slot2] - lo;
          on[u] = v2 != 0.0f && r2[u] >= 0 && r2[u] < clen;
          p[u] = on[u] ? __fmul_rn(v1, v2) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (q0 + 32 * u >= total) break;              // warp-uniform
        const unsigned peers =
            __match_any_sync(FULL, on[u] ? r2[u] : -1 - lane);
        stg[lane] = p[u];
        __syncwarp();
        if (on[u] && lane == __ffs(peers) - 1) {
          float t = p[u];
          for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1)
            t = __fadd_rn(t, stg[__ffs(rest) - 1]);
          row[r2[u]] = __fadd_rn(row[r2[u]], t);
        }
        __syncwarp();
      }
    }
    s1 = s1_next;
    col0 = col0_next;
    n_k = n_k_next;
  }
}

// A row of more than epw entries, by the whole block: pieces of at most
// seg_cap keys in ascending order (the next seg_cap smallest: a radix
// select when the list does not fit), each sorted, nw warps taking fixed
// contiguous parts of every piece; the warps' copies summed in warp order.
__device__ void block_row(const GramArgs& a, long long row_id, float* copies,
                          int rc, int* seg, float* stage, int* hist,
                          int* misc) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int base = a.off[row_id];
  const int n = a.off[row_id + 1] - base;
  const int* keys = a.list + base;
  const int nw = min(a.warps, (n + a.split - 1) / a.split);
  const long long slot0 = row_id / a.m * a.c * (long long)a.k;
  const int* rows = a.rows + slot0;
  const float* vals = a.vals + slot0;
  const int* lens = a.len + row_id / a.m * a.c;
  for (int lo = 0; lo < a.m; lo += rc) {
    const int clen = min(rc, a.m - lo);
    for (int i = tid; i < nw * rc; i += blockDim.x) copies[i] = 0.0f;
    int last = -1;
    for (int done = 0; done < n;) {
      const int left = n - done;
      int plen = min(left, a.seg_cap);
      if (n <= a.seg_cap) {
        for (int i = tid; i < n; i += blockDim.x) seg[i] = keys[i];
      } else {
        const int thr = left <= a.seg_cap
            ? KEY_MAX
            : select_key(keys, n, last, a.seg_cap, a.key_bits, hist, misc);
        if (tid == 0) misc[2] = 0;
        __syncthreads();
        for (int i = tid; i < n; i += blockDim.x) {
          const int key = keys[i];
          if (key > last && key <= thr) seg[atomicAdd(misc + 2, 1)] = key;
        }
      }
      int p2 = 1;
      while (p2 < plen) p2 <<= 1;
      __syncthreads();
      for (int i = plen + tid; i < p2; i += blockDim.x) seg[i] = KEY_MAX;
      __syncthreads();
      sort_keys<true>(seg, p2, tid, blockDim.x);
      if (warp < nw)
        warp_products(a, rows, vals, lens, seg,
                      (int)((long long)warp * plen / nw),
                      (int)((long long)(warp + 1) * plen / nw),
                      copies + (size_t)warp * rc, stage + warp * 32, lo,
                      clen);
      __syncthreads();
      last = seg[plen - 1];
      done += plen;
      __syncthreads();
    }
    float* dst = a.out + row_id * a.m + lo;
    for (int j = tid; j < clen; j += blockDim.x) {
      float s = copies[j];
      for (int w = 1; w < nw; ++w)
        s = __fadd_rn(s, copies[(size_t)w * rc + j]);
      dst[j] = s;
    }
    __syncthreads();
  }
}

// A row of at most epw entries, by one warp (nw = 1): the list copied into
// the warp's key area and sorted there, one copy of the row, written once.
__device__ void warp_row(const GramArgs& a, long long row_id, float* row,
                         int rc, int* seg, float* stg) {
  const int lane = threadIdx.x % 32;
  const int base = a.off[row_id];
  const int n = a.off[row_id + 1] - base;
  const long long slot0 = row_id / a.m * a.c * (long long)a.k;
  if (n <= 32) {
    // one key a lane, sorted in registers (bitonic over shuffles)
    int key = lane < n ? a.list[base + lane] : KEY_MAX;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int other = __shfl_xor_sync(FULL, key, stride);
        const bool up = (lane & size) == 0 || size == 32;
        key = ((lane & stride) == 0) == up ? min(key, other)
                                           : max(key, other);
      }
    }
    seg[lane] = key;
  } else {
    int p2 = 1;
    while (p2 < n) p2 <<= 1;
    for (int i = lane; i < p2; i += 32) seg[i] = i < n ? a.list[base + i]
                                                       : KEY_MAX;
    __syncwarp();
    sort_keys<false>(seg, p2, lane, 32);
  }
  __syncwarp();
  for (int lo = 0; lo < a.m; lo += rc) {
    const int clen = min(rc, a.m - lo);
    for (int j = lane; j < clen; j += 32) row[j] = 0.0f;
    __syncwarp();
    warp_products(a, a.rows + slot0, a.vals + slot0,
                  a.len + row_id / a.m * a.c, seg, 0, n, row, stg, lo, clen);
    __syncwarp();
    float* dst = a.out + row_id * a.m + lo;
    if (a.m % 4 == 0) {        // rows, chunks and copies 16-byte aligned
      for (int j = 4 * lane; j < clen; j += 128)
        *reinterpret_cast<float4*>(dst + j) =
            *reinterpret_cast<const float4*>(row + j);
    } else {
      for (int j = lane; j < clen; j += 32) dst[j] = row[j];
    }
    __syncwarp();
  }
}

// Persistent: first the heavy rows, a block each; then every other row, a
// warp each.
__global__ void row_gram(const GramArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rc = (int)min((long long)a.m, (long long)a.row_chunk);
  const int seg_len = max(a.seg_cap, a.warps * a.epw_p2);
  float* copies = reinterpret_cast<float*>(smem_raw);        // [warps][rc]
  int* seg = reinterpret_cast<int*>(copies + (size_t)a.warps * rc);
  float* stage = reinterpret_cast<float*>(seg + seg_len);    // [warps][32]
  int* hist = reinterpret_cast<int*>(stage + a.warps * 32);  // [256]
  int* misc = hist + 256;                                    // [4]
  const int warp = threadIdx.x / 32;

  if (blockIdx.x < a.heavy_blocks) {
    // heavy rows, longest first among those not yet taken: a block each
    const int nh = *a.heavy_n;
    for (;;) {
      if (threadIdx.x == 0) misc[3] = atomicAdd(a.next, 1);
      __syncthreads();
      const int h = misc[3];
      __syncthreads();
      if (h >= nh) return;
      block_row(a, a.heavy[h], copies, rc, seg, stage, hist, misc);
    }
  }
  // every other row: a warp each, the blocks scheduled by the hardware
  const long long r =
      (long long)(blockIdx.x - a.heavy_blocks) * a.warps + warp;
  if (r < a.nrows && a.off[r + 1] - a.off[r] <= a.epw)
    warp_row(a, r, copies + (size_t)warp * rc, rc, seg + warp * a.epw_p2,
             stage + warp * 32);
}

inline int slot_grid(long long total, int sms) {
  const long long want = (total + SLOT_THREADS - 1) / SLOT_THREADS;
  return (int)std::max(1LL, std::min(want, (long long)sms * 8));
}

}  // namespace

// rows, vals: (D, C, K) contiguous; out: (D, M, M) contiguous, every
// element written; ws: workspace_ints(D, C, K, M) = 2*D*M + 9 + D*C +
// 2*D*C*K int32 (counters, offsets, heavy rows, column lengths, ranks,
// lists), uninitialised.  The launch plan (kernels/sparse_gram.py): warps
// (1..32), epw >= 1 (a row of at most epw entries is one warp's), split >=
// 1 (a longer row takes min(warps, ceil(n / split)) warps), seg_cap (a
// power of two), row_chunk (a multiple of 4).  Returns the first launch
// error, or 0.
extern "C" int ranky_sparse_gram(const void* rows, const void* vals,
                                 void* out, void* ws, int d, int c, int k,
                                 int m, int warps, int epw, int split,
                                 int seg_cap, int row_chunk, void* stream) {
  if (d <= 0 || m <= 0) return 0;
  if (warps < 1 || warps > 32 || epw < 1 || split < 1 || row_chunk < 4 ||
      row_chunk % 4 != 0 ||
      seg_cap < 1 ||
      (seg_cap & (seg_cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nrows = (long long)d * m;
  int* ctr = (int*)ws;                // [8]: heavy rows, queue head
  int* off = ctr + 8;
  int* heavy = off + nrows + 1;
  int* len = heavy + nrows;
  int* rank = len + (long long)d * c;
  int* list = rank + (long long)d * c * k;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  int epw_p2 = 1;
  while (epw_p2 < epw) epw_p2 <<= 1;
  const int rc = (int)std::min((long long)m, (long long)row_chunk);
  const int seg_len = std::max(seg_cap, warps * epw_p2);
  const size_t smem = 4 * ((size_t)warps * rc + seg_len + warps * 32 + 256
                           + 4);
  // blocks an SM at this shared-memory size (the query is cached: it costs
  // more host time than the launches)
  static int cache_key[3] = {-1, -1, -1}, cache_per_sm = 0;
  int per_sm = cache_per_sm;
  if (cache_key[0] != dev || cache_key[1] != (int)smem ||
      cache_key[2] != warps) {
    err = cudaFuncSetAttribute(row_gram,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(row_gram,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_gram, warps * 32, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cache_key[0] = dev;
    cache_key[1] = (int)smem;
    cache_key[2] = warps;
    cache_per_sm = per_sm;
  }

  zero_counts<<<slot_grid(nrows, sms), SLOT_THREADS, 0, st>>>(off, nrows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  count_cols<<<slot_grid((long long)d * c, sms), SLOT_THREADS, 0, st>>>(
      (const int*)rows, (const float*)vals, off, rank, len, c, k, m,
      (long long)d * c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_counts<<<1, SCAN_THREADS, 0, st>>>(off, heavy, ctr, nrows, epw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long slots = (long long)d * c * k;
  place_slots<<<slot_grid(slots, sms), SLOT_THREADS, 0, st>>>(
      (const int*)rows, (const float*)vals, rank, off, list, c, k, m,
      slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // n / k by a multiply (k > 1): l = ceil(log2 k), m = 2^32 (2^l - k) / k + 1
  int l = 0;
  while ((1LL << l) < k) ++l;
  const unsigned kdiv_m = k > 1
      ? (unsigned)((((unsigned long long)1 << 32) *
                    (((unsigned long long)1 << l) - k)) / k + 1)
      : 1u;
  int key_bits = 1;
  while (key_bits < 31 && ((long long)1 << key_bits) < (long long)c * k)
    ++key_bits;
  // half the resident blocks take the heavy rows from a queue; one block
  // for every `warps` rows follows
  const int heavy_blocks = std::max(1, sms * per_sm / 2);
  const long long grid = heavy_blocks + (nrows + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  GramArgs a{(const int*)rows, (const float*)vals, off, list, len, heavy,
             ctr, (float*)out, nrows, c, k, m, ctr + 2, heavy_blocks, warps,
             epw, split, seg_cap, row_chunk, epw_p2, kdiv_m, l, key_bits};
  row_gram<<<(unsigned)grid, warps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}
