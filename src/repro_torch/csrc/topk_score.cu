// topk_score: the top k_top of scores = (qs @ v^T) * scale per query row,
// columns >= valid_n masked to -inf, returned as (values descending, column
// index + index_offset), ties to the lowest column index.  The (B, N) score
// matrix is never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/topk_score.py
// (_topk_score_kernel / _select_topk / topk_score), which walks the column
// tiles in order on one core and carries a running (B, k_top) buffer in VMEM
// from one grid step to the next.  Here blocks run in parallel, so the
// running list lives per thread block and a second pass merges them.
//
// What bounds it on an H100: at the serving shapes, operations (2 B N k
// float32 multiply-adds against one read of v); at small B, bytes (v).
// The products are rounded and summed one by one (__fmul_rn, __fadd_rn, in
// ascending k) so that nvcc contracts nothing into an FMA and every score
// has the bits of the plain PyTorch version (kernels/topk_score.py:
// topk_score_ref): this kernel runs at most half the FMA rate by design
// (a multiply and an add per product: 1.03 ms at 256 x 1,048,576 x 64).
//
// Design (two passes, no atomics in device memory but one bound a query):
//   1. Grid (query tiles of QB rows, column chunks); about two blocks per
//      SM over all query tiles (one block's merges overlap the other's
//      scoring), the query tiles of a chunk adjacent so that they share its
//      v in L2.  The block keeps its QB queries in shared
//      memory and streams its chunk of v through a two-stage cp.async ring
//      (TC columns x up to KC factors a stage; int8 tiles are widened to
//      float32 once per block).  Each thread scores a 4 queries x 4 columns
//      register tile, so a factor costs two 16-byte shared loads for 32
//      floating-point operations.
//      Selection: each query keeps a sorted top-k_top list in shared
//      memory; its last entry is the threshold tau.  A score enters the
//      query's candidate buffer only if it beats tau under the strict total
//      order better(value desc, index asc) -- comparing values only would
//      lose ties.  When a buffer may not take another tile, the warp that
//      owns the query sorts it (bitonic, in registers) and merges it into
//      the list by rank (each entry's place is its own index plus the
//      number of entries of the other array ahead of it), which raises tau.
//      The warp then publishes tau for the query (atomicMax of an
//      order-preserving 64-bit key), and every block filters by the best
//      tau published so far as well as its own: the k_top entries behind a
//      published tau exist, so whatever is worse than it is in no top
//      k_top and may be dropped anywhere.  The per-chunk lists thus depend
//      on timing; the final top k_top does not, as the order is total.
//      Writes (B, chunks, k_top).
//   2. One warp per query reads its chunks' lists 32 entries at a time
//      (eight loads in flight a lane), keeps those that beat tau, and
//      merges them the same way; adds index_offset.
// Unfilled list slots hold (-inf, INT_MAX): they lose to every real column,
// -inf ones included, so they never surface while k_top <= N.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TC = 64;          // columns per tile (16 column groups x 4)
constexpr int KC = 64;          // factors per stage
constexpr int CAP = 128;        // candidate slots per query (a power of 2)
constexpr int MERGE_WARPS = 4;  // queries per block in pass 2
constexpr int UNROLL = 8;       // loads in flight per lane in pass 2
constexpr int SENTINEL = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

struct __align__(8) Entry {     // one (score, column) pair
  float v;
  int i;
};

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}
__device__ __forceinline__ bool better(Entry a, Entry b) {
  return better(a.v, a.i, b.v, b.i);
}

// Entries as 64-bit keys that order like `better` (larger is better): the
// value's bits made monotone (-0 taken as +0, which `better` calls equal),
// then the index inverted.  Key 0 is below every entry.
__device__ __forceinline__ unsigned long long key_of(Entry e) {
  unsigned u = __float_as_uint(e.v + 0.0f);
  u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;
  return ((unsigned long long)u << 32) | (unsigned)~e.i;
}
__device__ __forceinline__ Entry entry_of(unsigned long long key) {
  if (key == 0) return Entry{-CUDART_INF_F, SENTINEL};
  unsigned u = (unsigned)(key >> 32);
  u ^= (u >> 31) ? 0x80000000u : 0xffffffffu;
  return Entry{__uint_as_float(u), (int)~(unsigned)key};
}

// Bytes of one staged v row: whole 16-byte pieces, an odd number of them,
// so that 8 neighbouring rows read as 16-byte vectors hit distinct banks.
__host__ __device__ inline int row_bytes(int k, int vbytes) {
  const int kc = k < KC ? k : KC;
  int r = (kc * vbytes + 15) / 16 * 16;
  if ((r / 16) % 2 == 0) r += 16;
  return r;
}
__host__ __device__ inline int round16(int k) { return (k + 15) / 16 * 16; }

// Shared-memory layout of pass 1 (byte offsets): the v stages (16-byte
// aligned), an int8 tile widened to float32, q [k16][QB], the lists, the
// candidate buffers and their counts, the bounds read from other blocks.
struct Layout {
  int stage, vf, q, list, cand, cnt, bound, total;
  __host__ __device__ Layout(int qb, int k, int k_top, int vbytes) {
    stage = TC * row_bytes(k, vbytes);
    vf = 2 * stage;
    q = vf + (vbytes == 1 ? TC * row_bytes(k, 4) : 0);
    list = q + round16(k) * qb * 4;
    cand = list + qb * k_top * 8;
    cnt = cand + qb * CAP * 8;
    bound = (cnt + qb * 4 + 7) / 8 * 8;
    total = bound + qb * 8;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// How many leading entries of the sorted array `arr` (m long) satisfy
// `pred` (a prefix), in ceil(log2(m + 1)) steps without data-dependent
// branches.
template <typename Pred>
__device__ __forceinline__ int prefix(const Entry* arr, int m, Pred pred) {
  int pos = 0;
  for (int step = 1 << (31 - __clz(m)); step > 0; step >>= 1)
    if (pos + step <= m && pred(arr[pos + step - 1])) pos += step;
  return pos;
}

// Merge the n <= 32 R candidates `cand` into the sorted list `list` of
// k_top entries, keeping the best k_top; called by one whole warp.  The
// candidates are sorted in registers (bitonic over 32 R slots, R a lane,
// element e = 32 r + lane; shuffles for the strides below 32) and written
// back sorted.  A list entry goes to its index plus the number of
// candidates strictly better; a candidate to its index plus the number of
// list entries not worse (the list wins exact ties): a bijection onto
// [0, k_top + n).  List entries only move up, so they are moved top group
// first, then the candidates land.
template <int R>
__device__ __noinline__ void merge_sorted(Entry* list, int k_top, Entry* cand,
                                          int n, int lane) {
  Entry x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    x[r] = e < n ? cand[e] : Entry{-CUDART_INF_F, SENTINEL};
  }
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int rs = stride >> 5;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & rs) continue;
          const bool first = ((32 * r + lane) & size) == 0;
          const Entry a = x[r], b = x[r | rs];
          if (first ? better(b, a) : better(a, b)) { x[r] = b; x[r | rs] = a; }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = 32 * r + lane;
          const Entry o{__shfl_xor_sync(FULL, x[r].v, stride),
                        __shfl_xor_sync(FULL, x[r].i, stride)};
          // the lower index of a pair keeps the better one in a run
          // sorted best-first, the worse one otherwise
          const bool want_better = ((e & stride) == 0) == ((e & size) == 0);
          if (want_better ? better(o, x[r]) : better(x[r], o)) x[r] = o;
        }
      }
    }
  int pos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const Entry c = x[r];
    pos[r] = 32 * r + lane +
             prefix(list, k_top, [&](Entry l) { return !better(c, l); });
    cand[32 * r + lane] = c;
  }
  __syncwarp();
  for (int base = (k_top - 1) & ~31; base >= 0; base -= 32) {
    const int i = base + lane;
    Entry y{0.f, 0};
    int np = k_top;
    if (i < k_top) {
      y = list[i];
      np = i + prefix(cand, n, [&](Entry c) { return better(c, y); });
    }
    __syncwarp();
    if (np < k_top && np != i) list[np] = y;
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (32 * r + lane < n && pos[r] < k_top) list[pos[r]] = x[r];
  __syncwarp();
}

// merge_sorted with the fewest registers that hold n <= CAP candidates.
__device__ __forceinline__ void warp_merge(Entry* list, int k_top,
                                           Entry* cand, int n, int lane) {
  if (n <= 0) return;
  if (n <= 32) merge_sorted<1>(list, k_top, cand, n, lane);
  else if (n <= 64) merge_sorted<2>(list, k_top, cand, n, lane);
  else merge_sorted<CAP / 32>(list, k_top, cand, n, lane);
}

// Stage columns [c0, c0 + TC) x factors [f0, f0 + kc) of v (n, k) into a
// (TC, rb bytes) tile; columns >= c_end and factors >= kc are zeros.
template <typename VT>
__device__ __forceinline__ void load_slice(unsigned char* dst, const VT* v,
                                           int c0, int c_end, int f0, int kc,
                                           int k, int rb, bool vec, int tid,
                                           int threads) {
  if (vec) {                        // k * sizeof(VT) % 16 == 0, v aligned
    const int cpr = rb / 16;
    for (int idx = tid; idx < TC * cpr; idx += threads) {
      const int r = idx / cpr, c = idx - r * cpr;
      const int f = c * (16 / (int)sizeof(VT));
      const bool ok = c0 + r < c_end && f < kc;
      const VT* from = ok ? v + (size_t)(c0 + r) * k + f0 + f : v;
      cp_async16(dst + r * rb + c * 16, from, ok ? 16 : 0);
    }
  } else {
    const int epr = rb / (int)sizeof(VT);
    VT* out = reinterpret_cast<VT*>(dst);
    for (int idx = tid; idx < TC * epr; idx += threads) {
      const int r = idx / epr, f = idx - r * epr;
      out[r * epr + f] = (c0 + r < c_end && f < kc)
                             ? v[(size_t)(c0 + r) * k + f0 + f] : VT(0);
    }
  }
}

// Factors [i, i + 4) of the thread's 4 columns and 4 queries.
__device__ __forceinline__ void load_step(float4 (&x)[4], float4 (&q)[4],
                                          const float* vrow, int rf,
                                          const float* qcol, int qb, int i) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    x[c] = *reinterpret_cast<const float4*>(vrow + 16 * c * rf + i);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = *reinterpret_cast<const float4*>(qcol + (i + j) * qb);
}

__device__ __forceinline__ float comp(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

template <typename VT, int QB>
__global__ void __launch_bounds__(4 * QB)
topk_chunk_kernel(const float* __restrict__ qs, const VT* __restrict__ v,
                  const float* __restrict__ scale, Entry* lists,
                  unsigned long long* bounds, int b,
                  int k, int n, int valid_n, int chunk_cols, int chunks,
                  int k_top, int vec) {
  constexpr int THREADS = 4 * QB;
  constexpr int WARPS = THREADS / 32;
  constexpr bool I8 = sizeof(VT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(QB, k, k_top, sizeof(VT));
  float* s_vf = reinterpret_cast<float*>(smem + L.vf);  // int8 tile as f32
  float* s_q = reinterpret_cast<float*>(smem + L.q);    // [k16][QB]
  Entry* s_cand = reinterpret_cast<Entry*>(smem + L.cand);
  int* s_cnt = reinterpret_cast<int*>(smem + L.cnt);
  Entry* s_bound = reinterpret_cast<Entry*>(smem + L.bound);
  const int rb = row_bytes(k, sizeof(VT));   // staged row, bytes
  const int rf = row_bytes(k, 4) / 4;        // float row the scoring reads

  const int q0 = blockIdx.x * QB;
  const int chunk = blockIdx.y;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(n, c_begin + chunk_cols);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int qg = tid >> 4;          // queries 4 qg .. 4 qg + 3
  const int cg = tid & 15;          // columns cg + 16 c, c = 0..3
  const unsigned half = lane & 16;  // the 16 lanes that share qg

  const int k16 = round16(k);
  for (int e = tid; e < k16 * QB; e += THREADS) {
    const int i = e / QB, q = e - i * QB;
    s_q[e] = (q0 + q < b && i < k) ? qs[(size_t)(q0 + q) * k + i] : 0.0f;
  }
  Entry* s_list = reinterpret_cast<Entry*>(smem + L.list);   // [QB][k_top]
  for (int e = tid; e < QB * k_top; e += THREADS)
    s_list[e] = Entry{-CUDART_INF_F, SENTINEL};
  for (int e = tid; e < QB; e += THREADS) {
    s_cnt[e] = 0;
    s_bound[e] = Entry{-CUDART_INF_F, SENTINEL};
  }

  const int nks = (k + KC - 1) / KC;
  const int ntiles = (c_end - c_begin + TC - 1) / TC;
  const int units = ntiles * nks;   // (tile, factor slice), slices inner
  auto issue = [&](int u) {
    const int t0 = c_begin + (u / nks) * TC, f0 = (u % nks) * KC;
    load_slice<VT>(smem + (u & 1) * L.stage, v, t0, c_end, f0,
                   min(KC, k - f0), k, rb, vec != 0, tid, THREADS);
    cp_commit();
  };
  if (units > 0) issue(0);

  float acc[4][4];
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) { issue(u + 1); cp_wait<1>(); } else { cp_wait<0>(); }
    __syncthreads();                // (A) stage u landed; merges are done
    const int ks = u % nks;
    // The best bound any block has published for query tid, read now and
    // used from the next tile on.
    unsigned long long published = 0;
    if (tid < QB && q0 + tid < b && ks == nks - 1)
      published = *reinterpret_cast<volatile unsigned long long*>(
          bounds + q0 + tid);
    const int t0 = c_begin + (u / nks) * TC;
    const int f0 = ks * KC;
    const int kc = min(KC, k - f0);
    const unsigned char* stage = smem + (u & 1) * L.stage;
    const float* vs = reinterpret_cast<const float*>(stage);
    if constexpr (I8) {             // widen once per block, not per thread
      const int quads = rf / 4;
      for (int e = tid; e < TC * quads; e += THREADS) {
        const int r = e / quads, f = 4 * (e - r * quads);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (f < rb) {
          const char4 c = *reinterpret_cast<const char4*>(stage + r * rb + f);
          x = make_float4(c.x, c.y, c.z, c.w);
        }
        *reinterpret_cast<float4*>(s_vf + r * rf + f) = x;
      }
      __syncthreads();
      vs = s_vf;
    }
    if (ks == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
    }
    const float* vrow = vs + cg * rf;
    const float* qcol = s_q + f0 * QB + 4 * qg;
#pragma unroll 2
    for (int i = 0; i < kc; i += 4) {
      float4 x[4], qv[4];
      load_step(x, qv, vrow, rf, qcol, QB, i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qa[4] = {qv[j].x, qv[j].y, qv[j].z, qv[j].w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] = __fadd_rn(acc[a][c], __fmul_rn(qa[a], comp(x[c], j)));
      }
    }
    if (ks == nks - 1) {
      // Offer the tile: what beats the query's threshold is a candidate.
      // The 16 lanes of a query take their slots with one atomic.
      Entry tau[4];
      float sc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const Entry own = s_list[(4 * qg + a) * k_top + k_top - 1];
        const Entry other = s_bound[4 * qg + a];
        tau[a] = better(other, own) ? other : own;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = t0 + cg + 16 * c;
        sc[c] = (scale != nullptr && col < c_end) ? scale[col] : 1.0f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = 4 * qg + a;
          const int col = t0 + cg + 16 * c;
          float s = scale != nullptr ? __fmul_rn(acc[a][c], sc[c])
                                     : acc[a][c];
          if (col >= valid_n) s = -CUDART_INF_F;
          const bool keep = q0 + q < b && col < c_end &&
                            better(s, col, tau[a].v, tau[a].i);
          const unsigned m = __ballot_sync(FULL, keep);
          if (m == 0) continue;     // the whole warp
          const unsigned sub = (m >> half) & 0xffffu;
          const int leader = sub ? __ffs(sub) - 1 : 0;
          int base = 0;
          if (sub && (lane & 15) == leader)
            base = atomicAdd(&s_cnt[q], __popc(sub));
          base = __shfl_sync(FULL, base, half + leader);
          if (keep)
            s_cand[q * CAP + base +
                   __popc(sub & ((1u << (lane & 15)) - 1u))] = Entry{s, col};
        }
    }
    __syncthreads();                // (B) stage u read; candidates written
    if (published != 0) s_bound[tid] = entry_of(published);
    if (ks == nks - 1) {
      // A buffer that might not take another tile is merged now, and so is
      // any while the list is not full yet (tau is still the empty slot);
      // the list's raised tau is published.
      const bool last = u + 1 == units;
      for (int q = warp; q < QB; q += WARPS) {
        const int cnt = s_cnt[q];
        const bool filling = s_list[q * k_top + k_top - 1].i == SENTINEL;
        if (cnt > (last || filling ? 0 : CAP - TC)) {
          warp_merge(s_list + q * k_top, k_top, s_cand + q * CAP, cnt,
                     lane);
          if (lane == 0) {
            s_cnt[q] = 0;
            atomicMax(bounds + q0 + q,
                      key_of(s_list[q * k_top + k_top - 1]));
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < QB * k_top; e += THREADS) {
    const int q = e / k_top;
    if (q0 + q < b)
      lists[((size_t)(q0 + q) * chunks + chunk) * k_top + e % k_top] =
          s_list[e];
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge_kernel(const Entry* __restrict__ lists, float* __restrict__ out_v,
                  int* __restrict__ out_i, int b, int chunks, int k_top,
                  int index_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  Entry* list = reinterpret_cast<Entry*>(smem) + (size_t)warp * (k_top + CAP);
  Entry* cand = list + k_top;
  if (q >= b) return;                         // no block-wide sync below
  for (int j = lane; j < k_top; j += 32) list[j] = Entry{-CUDART_INF_F, SENTINEL};
  __syncwarp();
  const Entry* mine = lists + (size_t)q * chunks * k_top;
  const int total = chunks * k_top;
  Entry tau{-CUDART_INF_F, SENTINEL};
  int cnt = 0;
  for (int e0 = 0; e0 < total; e0 += 32 * UNROLL) {
    Entry x[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int e = e0 + 32 * r + lane;
      x[r] = e < total ? mine[e] : Entry{-CUDART_INF_F, SENTINEL};
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const bool keep = better(x[r], tau);
      const unsigned mask = __ballot_sync(FULL, keep);
      if (keep) cand[cnt + __popc(mask & ((1u << lane) - 1u))] = x[r];
      cnt += __popc(mask);
      if (cnt > CAP - 32) {
        __syncwarp();
        warp_merge(list, k_top, cand, cnt, lane);
        cnt = 0;
        tau = list[k_top - 1];
      }
    }
  }
  __syncwarp();
  warp_merge(list, k_top, cand, cnt, lane);
  for (int j = lane; j < k_top; j += 32) {
    out_v[(size_t)q * k_top + j] = list[j].v;
    out_i[(size_t)q * k_top + j] = list[j].i + index_offset;
  }
}

template <typename VT, int QB>
cudaError_t launch_chunks(const float* qs, const void* v, const float* scale,
                          Entry* lists, unsigned long long* bounds, int b,
                          int k, int n,
                          int valid_n, int chunk_cols, int chunks, int k_top,
                          int vec, cudaStream_t stream) {
  const int smem = Layout(QB, k, k_top, sizeof(VT)).total;
  auto kern = topk_chunk_kernel<VT, QB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, chunks);
  kern<<<grid, 4 * QB, smem, stream>>>(
      qs, static_cast<const VT*>(v), scale, lists, bounds, b, k, n, valid_n,
      chunk_cols, chunks, k_top, vec);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t launch_qb(int qb, const float* qs, const void* v,
                      const float* scale, Entry* lists,
                      unsigned long long* bounds, int b, int k, int n,
                      int valid_n, int chunk_cols, int chunks, int k_top,
                      int vec, cudaStream_t st) {
#define RANKY_TOPK_QB(QB)                                                    \
  if (qb == QB)                                                              \
    return launch_chunks<VT, QB>(qs, v, scale, lists, bounds, b, k, n,        \
                                 valid_n, chunk_cols, chunks, k_top, vec, st);
  RANKY_TOPK_QB(32)
  RANKY_TOPK_QB(8)
#undef RANKY_TOPK_QB
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory (bytes) pass 1 needs with qb queries a block (32
// or 8), factor dimension k, k_top and v elements of v_bytes (4 or 1);
// -1 when that does not fit an int.
extern "C" int ranky_topk_score_smem(int qb, int k, int k_top, int v_bytes) {
  const long long rough = 8LL * qb * ((long long)k + k_top + CAP)
                          + 4LL * TC * 16 * (KC + 16);
  if (rough > 0x3fffffffLL) return -1;
  return Layout(qb, k, k_top, v_bytes).total;
}

// qs: (b, k) f32; v: (n, k) f32, or int8 when v_is_int8; scale: (n,) f32 or
// NULL (no scaling); lists: (b, chunks, k_top) scratch of 8-byte (float
// value, int index) entries; bounds: (b,) 64-bit scratch (zeroed here);
// out_v / out_i: (b, k_top).  Column chunk c covers [c * chunk_cols, ...) and
// chunks * chunk_cols >= n.  qb: queries per block of pass 1 (32 or 8).  Requires 1 <= k_top <= n.  Returns cudaGetLastError() after the two
// launches.
extern "C" int ranky_topk_score(const void* qs, const void* v, int v_is_int8,
                                const void* scale, void* lists,
                                void* bounds, void* out_v, void* out_i, int b, int k, int n,
                                int valid_n, int index_offset, int k_top,
                                int chunk_cols, int chunks, int qb,
                                void* stream) {
  if (b <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(bounds, 0, (size_t)b * 8, st);
  if (err != cudaSuccess) return (int)err;
  const int vbytes = v_is_int8 ? 1 : 4;
  const int vec = ((size_t)k * vbytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0) ? 1 : 0;
  err = v_is_int8
      ? launch_qb<int8_t>(qb, (const float*)qs, v, (const float*)scale,
                          (Entry*)lists, (unsigned long long*)bounds, b, k,
                          n, valid_n,
                          chunk_cols, chunks, k_top, vec, st)
      : launch_qb<float>(qb, (const float*)qs, v, (const float*)scale,
                         (Entry*)lists, (unsigned long long*)bounds, b, k,
                         n, valid_n,
                         chunk_cols, chunks, k_top, vec, st);
  if (err != cudaSuccess) return (int)err;
  const int msmem = MERGE_WARPS * (k_top + CAP) * 8;
  err = cudaFuncSetAttribute(topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             msmem);
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(b + MERGE_WARPS - 1) / MERGE_WARPS,
                      MERGE_WARPS * 32, msmem, st>>>(
      (const Entry*)lists, (float*)out_v, (int*)out_i,
      b, chunks, k_top, index_offset);
  return (int)cudaGetLastError();
}
