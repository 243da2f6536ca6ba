// topk_score: the top k_top of scores = (qs @ v^T) * scale per query row,
// columns >= valid_n masked to -inf, returned as (values descending, column
// index + index_offset), ties to the lowest column index.  The (B, N) score
// matrix is never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/topk_score.py
// (_topk_score_kernel / _select_topk / topk_score), which walks the column
// tiles in order on one core and carries a running (B, k_top) buffer in VMEM
// from one grid step to the next.  Here blocks run in parallel, so the
// running buffer lives per thread block and a second pass merges them.
//
// What bounds it on an H100: at the serving shapes, operations (2 B N k
// float32 multiply-adds against one read of v); at small B, bytes (v).
// The products are rounded and summed one by one (__fmul_rn, __fadd_rn, in
// ascending k) so that nvcc contracts nothing into an FMA and every score
// has the bits of the plain PyTorch version (kernels/topk_score.py:
// topk_score_ref): this kernel runs at most half the FMA rate by design.
//
// Design (two passes, both deterministic, no atomics):
//   1. Grid (query tiles of QB rows, column chunks).  A chunk is a run of
//      whole block_n tiles chosen by the wrapper.  The block holds its QB
//      queries in shared memory, streams its chunk of v once in sub-tiles
//      of TC columns (v staged through shared memory in KC-wide slices of
//      the factor dimension), scores them (one column per thread, QB sums
//      in registers), and offers every score to its query's running top
//      k_top list in shared memory.  One warp owns a query's list: a score
//      enters only if it beats the list's last entry (ballot), and is then
//      inserted in place (count the better entries, shift the rest).  The
//      order is (value descending, index ascending), a strict total order on
//      distinct indices, so the list is exactly the top k_top of what was
//      offered whatever the offering order.  Writes (B, chunks, k_top).
//   2. One warp per query merges the chunks' lists in ascending chunk order
//      with the same insertion and adds index_offset.
// Unfilled list slots hold (-inf, INT_MAX): they lose to every real column,
// -inf ones included, so they never surface while k_top <= N.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int QB = 16;          // queries per block in pass 1
constexpr int TC = 256;         // columns per scoring sub-tile (one a thread)
constexpr int KC = 16;          // factor-dimension slice staged at a time
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MERGE_WARPS = 4;  // queries per block in pass 2
constexpr int SENTINEL = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
    return a > b || (a == b && ia < ib);
}

// Insert (s, c) into the list (rv, ri) of length k_top, sorted by `better`;
// (s, c) must beat the last entry, which falls off.  Called by a whole warp.
__device__ void warp_insert(float* rv, int* ri, int k_top, float s, int c,
                            int lane) {
    int pos = 0;
    for (int base = 0; base < k_top; base += 32) {
        const int j = base + lane;
        const bool b = j < k_top && better(rv[j], ri[j], s, c);
        pos += __popc(__ballot_sync(FULL, b));
    }
    // Move [pos, k_top - 1) one slot up, the highest slots first.
    for (int hi = k_top - 2; hi >= pos; hi -= 32) {
        const int j = hi - lane;
        const bool act = j >= pos;
        float tv = 0.0f;
        int ti = 0;
        if (act) { tv = rv[j]; ti = ri[j]; }
        __syncwarp();
        if (act) { rv[j + 1] = tv; ri[j + 1] = ti; }
        __syncwarp();
    }
    if (lane == 0) { rv[pos] = s; ri[pos] = c; }
    __syncwarp();
}

// Every lane offers (s, c) when `valid`; the warp inserts, in lane order,
// those that still beat the list's last entry when their turn comes.
__device__ void warp_offer(float* rv, int* ri, int k_top, float s, int c,
                           bool valid, int lane) {
    unsigned mask = __ballot_sync(
        FULL, valid && better(s, c, rv[k_top - 1], ri[k_top - 1]));
    while (mask) {
        const int l = __ffs(mask) - 1;
        const float sl = __shfl_sync(FULL, s, l);
        const int cl = __shfl_sync(FULL, c, l);
        if (better(sl, cl, rv[k_top - 1], ri[k_top - 1]))
            warp_insert(rv, ri, k_top, sl, cl, lane);
        mask &= mask - 1;
    }
}

template <typename VT>
__global__ void __launch_bounds__(THREADS)
topk_chunk_kernel(const float* __restrict__ qs, const VT* __restrict__ v,
                  const float* __restrict__ scale, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, int b, int k, int n, int valid_n,
                  int chunk_cols, int chunks, int k_top) {
    extern __shared__ float smem[];
    float* s_q = smem;                          // QB x k
    float* s_v = s_q + QB * k;                  // KC x (TC + 1)
    float* s_sc = s_v + KC * (TC + 1);          // QB x TC
    float* s_rv = s_sc + QB * TC;               // QB x k_top
    int* s_ri = reinterpret_cast<int*>(s_rv + QB * k_top);

    const int q0 = blockIdx.x * QB;
    const int chunk = blockIdx.y;
    const int c_begin = chunk * chunk_cols;
    const int c_end = min(n, c_begin + chunk_cols);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int e = tid; e < QB * k; e += THREADS) {
        const int q = e / k;
        s_q[e] = (q0 + q < b) ? qs[(size_t)(q0 + q) * k + e % k] : 0.0f;
    }
    for (int e = tid; e < QB * k_top; e += THREADS) {
        s_rv[e] = -CUDART_INF_F;
        s_ri[e] = SENTINEL;
    }
    __syncthreads();

    for (int t0 = c_begin; t0 < c_end; t0 += TC) {
        const int tc = min(TC, c_end - t0);
        float acc[QB];
#pragma unroll
        for (int q = 0; q < QB; ++q) acc[q] = 0.0f;
        for (int k0 = 0; k0 < k; k0 += KC) {
            const int kc = min(KC, k - k0);
            for (int e = tid; e < tc * kc; e += THREADS) {
                const int c = e / kc, i = e % kc;
                s_v[i * (TC + 1) + c] =
                    static_cast<float>(v[(size_t)(t0 + c) * k + k0 + i]);
            }
            __syncthreads();
            if (tid < tc) {
                for (int i = 0; i < kc; ++i) {
                    const float x = s_v[i * (TC + 1) + tid];
#pragma unroll
                    for (int q = 0; q < QB; ++q)
                        acc[q] = __fadd_rn(acc[q],
                                           __fmul_rn(s_q[q * k + k0 + i], x));
                }
            }
            __syncthreads();
        }
        if (tid < tc) {
            const int col = t0 + tid;
            const float sc = scale != nullptr ? scale[col] : 1.0f;
#pragma unroll
            for (int q = 0; q < QB; ++q) {
                float s = scale != nullptr ? __fmul_rn(acc[q], sc) : acc[q];
                if (col >= valid_n) s = -CUDART_INF_F;
                s_sc[q * TC + tid] = s;
            }
        }
        __syncthreads();
        for (int q = warp; q < QB; q += WARPS) {
            if (q0 + q >= b) continue;          // the whole warp skips
            float* rv = s_rv + q * k_top;
            int* ri = s_ri + q * k_top;
            for (int base = 0; base < tc; base += 32) {
                const int j = base + lane;
                const bool ok = j < tc;
                warp_offer(rv, ri, k_top, ok ? s_sc[q * TC + j] : 0.0f,
                           t0 + j, ok, lane);
            }
        }
        __syncthreads();
    }

    for (int e = tid; e < QB * k_top; e += THREADS) {
        const int q = e / k_top;
        if (q0 + q < b) {
            const size_t o =
                ((size_t)(q0 + q) * chunks + chunk) * k_top + e % k_top;
            cand_v[o] = s_rv[e];
            cand_i[o] = s_ri[e];
        }
    }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge_kernel(const float* __restrict__ cand_v,
                  const int* __restrict__ cand_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int b, int chunks, int k_top,
                  int index_offset) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int q = blockIdx.x * MERGE_WARPS + warp;
    float* rv = smem + (size_t)warp * 2 * k_top;
    int* ri = reinterpret_cast<int*>(rv + k_top);
    if (q >= b) return;                         // no block-wide sync below
    const float* cv = cand_v + (size_t)q * chunks * k_top;
    const int* ci = cand_i + (size_t)q * chunks * k_top;
    for (int j = lane; j < k_top; j += 32) { rv[j] = cv[j]; ri[j] = ci[j]; }
    __syncwarp();
    for (int ch = 1; ch < chunks; ++ch) {
        for (int base = 0; base < k_top; base += 32) {
            const int j = base + lane;
            const bool ok = j < k_top;
            const size_t o = (size_t)ch * k_top + j;
            warp_offer(rv, ri, k_top, ok ? cv[o] : 0.0f, ok ? ci[o] : 0, ok,
                       lane);
        }
    }
    for (int j = lane; j < k_top; j += 32) {
        out_v[(size_t)q * k_top + j] = rv[j];
        out_i[(size_t)q * k_top + j] = ri[j] + index_offset;
    }
}

template <typename VT>
cudaError_t launch_chunks(const float* qs, const void* v, const float* scale,
                          float* cand_v, int* cand_i, int b, int k, int n,
                          int valid_n, int chunk_cols, int chunks, int k_top,
                          size_t smem, cudaStream_t stream) {
    auto kern = topk_chunk_kernel<VT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((b + QB - 1) / QB, chunks);
    kern<<<grid, THREADS, smem, stream>>>(
        qs, static_cast<const VT*>(v), scale, cand_v, cand_i, b, k, n,
        valid_n, chunk_cols, chunks, k_top);
    return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory (bytes) pass 1 needs for factor dimension k, or -1
// when that does not fit an int.
extern "C" int ranky_topk_score_smem(int k, int k_top) {
    const long long bytes =
        4LL * (QB * (long long)k + KC * (TC + 1) + QB * TC
               + 2LL * QB * k_top);
    return bytes > 0x7fffffffLL ? -1 : (int)bytes;
}

// qs: (b, k) f32; v: (n, k) f32, or int8 when v_is_int8; scale: (n,) f32 or
// NULL (no scaling); cand_v / cand_i: (b, chunks, k_top) scratch; out_v /
// out_i: (b, k_top).  Column chunk c covers [c * chunk_cols, ...) and
// chunks * chunk_cols >= n.  Requires 1 <= k_top <= n.  Returns
// cudaGetLastError() after the two launches.
extern "C" int ranky_topk_score(const void* qs, const void* v, int v_is_int8,
                                const void* scale, void* cand_v, void* cand_i,
                                void* out_v, void* out_i, int b, int k, int n,
                                int valid_n, int index_offset, int k_top,
                                int chunk_cols, int chunks, void* stream) {
    if (b <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = (size_t)ranky_topk_score_smem(k, k_top);
    cudaError_t err = v_is_int8
        ? launch_chunks<int8_t>((const float*)qs, v, (const float*)scale,
                                (float*)cand_v, (int*)cand_i, b, k, n,
                                valid_n, chunk_cols, chunks, k_top, smem, st)
        : launch_chunks<float>((const float*)qs, v, (const float*)scale,
                               (float*)cand_v, (int*)cand_i, b, k, n, valid_n,
                               chunk_cols, chunks, k_top, smem, st);
    if (err != cudaSuccess) return (int)err;
    const size_t msmem = (size_t)MERGE_WARPS * 2 * k_top * 4;
    err = cudaFuncSetAttribute(topk_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)msmem);
    if (err != cudaSuccess) return (int)err;
    topk_merge_kernel<<<(b + MERGE_WARPS - 1) / MERGE_WARPS,
                        MERGE_WARPS * 32, msmem, st>>>(
        (const float*)cand_v, (const int*)cand_i, (float*)out_v, (int*)out_i,
        b, chunks, k_top, index_offset);
    return (int)cudaGetLastError();
}
