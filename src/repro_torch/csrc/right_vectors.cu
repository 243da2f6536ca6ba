// right_vectors: V = A^T U diag(1/S) over every repaired padded-ELL block
// of a stack, in f32, V's rows in padded column order (row d*W + j is
// local column j of block d).
//
// Replaces no TPU kernel: the JAX package computes this as a jnp product
// (src/repro/core/svd.py:195, sparse_right_vectors: the (C, M) stored-column
// panel times U, scattered to the columns' ids, plus the repair rows of U).
// On the card that product was a dense float32 GEMM of a panel > 99.9 %
// zeros, block by block, beside a zeroed V and a float index_add_.
//
// What bounds it on an H100: bytes, of V.  V is (D*W, r) floats and is
// written once (8.6 GB at D*W = 1,048,576, r = 2,048); U (M, r) is read
// through L2 (16.8 MB at M = r = 2,048), the non-zero slots once (8 B
// each), and the work is one multiply-add a non-zero and column of U.
//
// Design: an integer index of the non-zero terms of every output row, then
// one owner per output row that writes it once.  Seven kernels and one
// memset on the caller's stream, no host sync, no floating-point atomic:
//   0. memset: the (D*W + 1) packed counts set to 0.
//   1. count_entries: one thread an entry.  Entry e < D*C is stored column
//      e (block e / C); it is live when one of its K slots is non-zero, and
//      lands in bin d*W + col_id with nt = its non-zero slots.  Entry
//      D*C + d*Mr + j is repair row j of block d; it lands, when its mask is
//      set, in bin d*W + repair_col with nt = 1.  Each live entry adds
//      (1 << 32) | nt to its bin's packed count with one integer atomicAdd
//      and keeps the old number of entries as its rank (the counts do not
//      depend on the order of the adds; the ranks do, and step 5 puts them
//      in order).  A bin outside [0, W) traps.
//   2. tile_sums, 3. scan_tiles: the exclusive scan of the packed counts
//      (entries in the high 32 bits, terms in the low: no carry crosses,
//      the terms stay below 2^31), a tile of SCAN_TILE counts a block; each
//      block of step 3 adds the sums of the tiles before its own.
//   4. place_entries: a live entry writes its index at its bin's entry
//      offset plus its rank.
//   5. fill_terms: a live entry finds where its terms start inside its
//      bin's list of terms, the bin's term offset plus the nt of every
//      entry of the bin with a lower index, and writes them: a stored
//      column its non-zero slots as (row, value) in slot order, a repair
//      (row, 1.0).  So a bin's terms run in the order the data alone fixes:
//      stored columns by index (one, where the ids are distinct, as the
//      containers make them), then repair rows in ascending row order.  A
//      row outside [0, M) traps.
//   6. masked_inverse: one block; 1/S where S > rcond * max(S), else 0,
//      as core/svd.py masked_inverse computes it (a NaN in S propagates
//      into the max as torch.max does; IEEE division).
//   7. row_sums: output row b belongs to tpr threads (a power of two, the
//      wrapper's plan from r): each sums value * U[row, :] over the bin's
//      terms in order, one rounded multiply and one rounded add a term
//      (__fmul_rn / __fadd_rn, no contraction), multiplies by 1/S and
//      stores the row once.  A thread holds GROUPS groups of VEC floats, a
//      group tpr apart; VEC = 4 (float4 loads and stores) where r, U's
//      and V's row strides are multiples of 4 floats and both start on 16
//      bytes, else VEC = 1.  A row with no terms is stored as zeros by the
//      same pass: V is never zeroed first.  At r = 2,048 a row is 128
//      threads of 4 float4 each (8 KB of U in flight a term), two rows a
//      block; at r = 16 one thread a row.
//   U is read through the read-only path (__ldg) and V stored evict-first
//   (__stcs), so the 8.6 GB of V passing through L2 does not push U out.
//   The same input gives the same bits on every call.
//
// Limits (the wrapper checks): D*W + 1, D*C + D*Mr and D*C*K + D*Mr below
// 2^31.  Workspace, uninitialised, each part from a 16-byte boundary:
// (D*W + 1) and ceil((D*W + 1) / SCAN_TILE) int64, (D*C + D*Mr) int4 and
// int32, (D*C*K + D*Mr) int2, r floats.
//
// Precondition: a non-zero slot names a row in [0, M) of a stored column
// whose id lies in [0, W), and a repaired row's column lies in [0, W).
// The containers check the ELL on the host when they are built
// (sparse.check_ell_arrays); a slot or repair that breaks it traps, so the
// next synchronization raises instead of returning a wrong V.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENTRY_THREADS = 256;
constexpr int SCAN_THREADS = 512;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int INV_THREADS = 1024;
constexpr int ROW_THREADS = 256;
constexpr int GROUPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long ONE_ENTRY = 1ull << 32;

__device__ __forceinline__ int lo32(unsigned long long x) {
  return (int)(x & 0xffffffffull);
}

__device__ __forceinline__ int hi32(unsigned long long x) {
  return (int)(x >> 32);
}

struct Entries {
  const int* ids;             // (D, C)
  const int* rows;            // (D, C, K)
  const float* vals;          // (D, C, K)
  const int* rcols;           // (D, Mr)
  const unsigned char* rmask; // (D, Mr), torch.bool
  int d, c, k, mr, w, m;
  long long stored;           // D*C
  long long total;            // D*C + D*Mr
};

// Bin and term count of entry e: -1 and 0 for a padding column or an
// unmasked repair row.
__device__ __forceinline__ void entry_bin(const Entries& a, long long e,
                                          int* bin, int* nt) {
  *bin = -1;
  *nt = 0;
  if (e < a.stored) {
    const float* v = a.vals + e * a.k;
    int n = 0;
    for (int q = 0; q < a.k; ++q) n += v[q] != 0.0f;
    if (n == 0) return;
    const int id = a.ids[e];
    if (id < 0 || id >= a.w) __trap();  // precondition broken
    *bin = (int)(e / a.c) * a.w + id;
    *nt = n;
  } else {
    const long long j = e - a.stored;
    if (!a.rmask[j]) return;
    const int col = a.rcols[j];
    if (col < 0 || col >= a.w) __trap();
    *bin = (int)(j / a.mr) * a.w + col;
    *nt = 1;
  }
}

__global__ void count_entries(Entries a, unsigned long long* cnt,
                              int4* info) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < a.total; e += (long long)gridDim.x * blockDim.x) {
    int bin, nt, rank = 0;
    entry_bin(a, e, &bin, &nt);
    if (bin >= 0)
      rank = hi32(atomicAdd(cnt + bin, ONE_ENTRY | (unsigned)nt));
    info[e] = make_int4(bin, rank, nt, 0);
  }
}

__device__ __forceinline__ unsigned long long warp_incl_scan(
    unsigned long long x) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned long long y = __shfl_up_sync(FULL, x, s);
    if (lane >= s) x += y;
  }
  return x;
}

// The sum of x over the block (every thread gets it).
__device__ unsigned long long block_sum(unsigned long long x,
                                        unsigned long long* smem) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  unsigned long long t = 0;
  for (int i = 0; i < (int)blockDim.x / 32; ++i) t += smem[i];
  __syncthreads();
  return t;
}

// Thread i of tile t owns counts t*SCAN_TILE + i*SCAN_ITEMS ... + SCAN_ITEMS.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_sums(const unsigned long long* cnt, unsigned long long* tsum,
          long long n) {
  __shared__ unsigned long long smem[SCAN_THREADS / 32];
  const long long base = blockIdx.x * (long long)SCAN_TILE
      + (long long)threadIdx.x * SCAN_ITEMS;
  unsigned long long x = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i)
    if (base + i < n) x += cnt[base + i];
  x = block_sum(x, smem);
  if (threadIdx.x == 0) tsum[blockIdx.x] = x;
}

// Exclusive offsets of the n counts, in place (the last count is 0, so
// cnt[n - 1] ends as the total).
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(unsigned long long* cnt, const unsigned long long* tsum,
           long long n) {
  __shared__ unsigned long long smem[SCAN_THREADS / 32];
  __shared__ unsigned long long wsum[SCAN_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned long long before = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += SCAN_THREADS)
    before += tsum[i];
  before = block_sum(before, smem);

  const long long base = blockIdx.x * (long long)SCAN_TILE
      + (long long)threadIdx.x * SCAN_ITEMS;
  unsigned long long v[SCAN_ITEMS], mine = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    v[i] = base + i < n ? cnt[base + i] : 0;
    mine += v[i];
  }
  const unsigned long long incl = warp_incl_scan(mine);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned long long run = before + incl - mine;
  for (int i = 0; i < warp; ++i) run += wsum[i];
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    if (base + i < n) cnt[base + i] = run;
    run += v[i];
  }
}

__global__ void place_entries(const int4* info,
                              const unsigned long long* off, int* elist,
                              long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int4 x = info[e];
    if (x.x >= 0) elist[hi32(off[x.x]) + x.y] = (int)e;
  }
}

__global__ void fill_terms(Entries a, const int4* info,
                           const unsigned long long* off, const int* elist,
                           int2* terms) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < a.total; e += (long long)gridDim.x * blockDim.x) {
    const int4 x = info[e];
    if (x.x < 0) continue;
    const unsigned long long lo = off[x.x], hi = off[x.x + 1];
    int at = lo32(lo);
    for (int i = hi32(lo); i < hi32(hi); ++i) {
      const int other = elist[i];
      if (other < e) at += info[other].z;
    }
    if (e < a.stored) {
      const long long s0 = e * a.k;
      for (int q = 0; q < a.k; ++q) {
        const float v = a.vals[s0 + q];
        if (v == 0.0f) continue;
        const int row = a.rows[s0 + q];
        if (row < 0 || row >= a.m) __trap();  // precondition broken
        terms[at++] = make_int2(row, __float_as_int(v));
      }
    } else {
      const int row = (int)((e - a.stored) % a.mr);
      if (row >= a.m) __trap();
      terms[at] = make_int2(row, __float_as_int(1.0f));
    }
  }
}

// torch.max's NaN rule: a NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(INV_THREADS)
masked_inverse(const float* s, float* inv, int r, float rcond) {
  __shared__ float wmax[INV_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float x = -__int_as_float(0x7f800000);  // -inf
  for (int i = threadIdx.x; i < r; i += INV_THREADS) x = nan_max(x, s[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = nan_max(x, __shfl_xor_sync(FULL, x, o));
  if (lane == 0) wmax[warp] = x;
  __syncthreads();
  float smax = wmax[0];
  for (int i = 1; i < INV_THREADS / 32; ++i) smax = nan_max(smax, wmax[i]);
  const float floor_ = __fmul_rn(rcond, smax);
  for (int i = threadIdx.x; i < r; i += INV_THREADS) {
    const float v = s[i];
    inv[i] = v > floor_ ? __fdiv_rn(1.0f, v == 0.0f ? 1.0f : v) : 0.0f;
  }
}

struct RowArgs {
  const unsigned long long* off;  // (D*W + 1) packed exclusive offsets
  const int2* terms;
  const float* u;
  const float* inv;
  float* out;
  long long nb;   // D*W
  long long ldu, ldo;
  int groups;     // r / VEC
  int tpr_log2;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
    __stcs(p, x[0]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) row_sums(const RowArgs a) {
  const int shift = a.tpr_log2, tpr = 1 << shift;
  const long long b = blockIdx.x * (long long)(ROW_THREADS >> shift)
      + (threadIdx.x >> shift);
  if (b >= a.nb) return;
  const int lane = threadIdx.x & (tpr - 1);
  const int t0 = lo32(a.off[b]), t1 = lo32(a.off[b + 1]);
  float* orow = a.out + b * a.ldo;
  for (int g0 = lane; g0 < a.groups; g0 += tpr * GROUPS) {
    float acc[GROUPS][VEC];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[j][q] = 0.0f;
    for (int t = t0; t < t1; ++t) {
      const int2 term = __ldg(a.terms + t);
      const float v = __int_as_float(term.y);
      const float* urow = a.u + term.x * a.ldu;
#pragma unroll
      for (int j = 0; j < GROUPS; ++j) {
        const int g = g0 + j * tpr;
        if (g < a.groups) {
          float x[VEC];
          load_vec<VEC>(urow + (long long)g * VEC, x);
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[j][q] = __fadd_rn(acc[j][q], __fmul_rn(v, x[q]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const int g = g0 + j * tpr;
      if (g < a.groups) {
        float inv[VEC], y[VEC];
        load_vec<VEC>(a.inv + (long long)g * VEC, inv);
#pragma unroll
        for (int q = 0; q < VEC; ++q) y[q] = __fmul_rn(acc[j][q], inv[q]);
        store_vec<VEC>(orow + (long long)g * VEC, y);
      }
    }
  }
}

unsigned grid_for(long long n, int threads, int sms) {
  const long long want = (n + threads - 1) / threads;
  const long long cap = (long long)sms * 32;
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// V rows (D*W, r) at out (row stride ldo) from the stack's ELL arrays ids
// (D, C), rows / vals (D, C, K), the repair side-band rcols (D, Mr) int32
// and rmask (D, Mr) bool, u (M, r) f32 at row stride ldu, s (r,) f32.  ws:
// the workspace of the note above, uninitialised.  vec is 4 or 1 and
// tpr_log2 in [0, 8] (the wrapper's plan).  Returns the first launch or
// runtime error, or 0.
extern "C" int ranky_right_vectors(const void* ids, const void* rows,
                                   const void* vals, const void* rcols,
                                   const void* rmask, const void* u,
                                   long long ldu, const void* s, void* out,
                                   long long ldo, void* ws, int d, int c,
                                   int k, int mr, int w, int m, int r,
                                   float rcond, int vec, int tpr_log2,
                                   void* stream) {
  if (d <= 0 || w <= 0 || r <= 0) return 0;
  if ((vec != 1 && vec != 4) || r % vec != 0 || tpr_log2 < 0 ||
      (ROW_THREADS >> tpr_log2) < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nb = (long long)d * w, n = nb + 1;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  const long long stored = (long long)d * c, total = stored + (long long)d * mr;
  char* at = (char*)ws;
  auto take = [&at](long long bytes) {
    char* p = at;
    at += (bytes + 15) / 16 * 16;
    return p;
  };
  auto* cnt = (unsigned long long*)take(8 * n);
  auto* tsum = (unsigned long long*)take(8 * tiles);
  auto* info = (int4*)take(16 * total);
  auto* elist = (int*)take(4 * total);
  auto* terms = (int2*)take(8 * (stored * k + (long long)d * mr));
  auto* inv = (float*)take(4LL * r);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  Entries ent{(const int*)ids, (const int*)rows, (const float*)vals,
              (const int*)rcols, (const unsigned char*)rmask,
              d, c, k, mr, w, m, stored, total};
  if ((err = cudaMemsetAsync(cnt, 0, n * sizeof(unsigned long long), st))
      != cudaSuccess) return (int)err;
  if (total > 0) {
    count_entries<<<grid_for(total, ENTRY_THREADS, sms), ENTRY_THREADS, 0,
                    st>>>(ent, cnt, info);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  tile_sums<<<(unsigned)tiles, SCAN_THREADS, 0, st>>>(cnt, tsum, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_tiles<<<(unsigned)tiles, SCAN_THREADS, 0, st>>>(cnt, tsum, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (total > 0) {
    place_entries<<<grid_for(total, ENTRY_THREADS, sms), ENTRY_THREADS, 0,
                    st>>>(info, cnt, elist, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fill_terms<<<grid_for(total, ENTRY_THREADS, sms), ENTRY_THREADS, 0,
                 st>>>(ent, info, cnt, elist, terms);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  masked_inverse<<<1, INV_THREADS, 0, st>>>((const float*)s, inv, r, rcond);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rpb = ROW_THREADS >> tpr_log2;
  const long long grid = (nb + rpb - 1) / rpb;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  RowArgs ra{cnt, terms, (const float*)u, inv, (float*)out, nb, ldu, ldo,
             r / vec, tpr_log2};
  if (vec == 4)
    row_sums<4><<<(unsigned)grid, ROW_THREADS, 0, st>>>(ra);
  else
    row_sums<1><<<(unsigned)grid, ROW_THREADS, 0, st>>>(ra);
  return (int)cudaGetLastError();
}
