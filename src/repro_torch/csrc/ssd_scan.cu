// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (`_ssd_kernel` /
// `ssd_scan`) and its wrapper `ops.ssd_scan`.  The recurrence, per batch b
// and head h (B and C shared by the heads of a group, g = h / (H / G)):
//
//   h_t = exp(dt_t a_h) h_{t-1} + (dt_t x_t) outer B_t,   y_t = h_t C_t,
//
// computed chunk by chunk (Q steps): with la the cumulative sum of dt a
// over the chunk,
//
//   y_i   = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) dt_j x_j + exp(la_i) (h C_i)
//   h_out = exp(la_last) h + sum_j exp(la_last - la_j) dt_j x_j outer B_j.
//
// x, dt, B, C are float32 or bfloat16, a float32; every sum is float32; y
// comes out in x's type and the final state (B, H, P, N) in float32.
//
// What bounds it on an H100: at the LM path's shape, x (8, 1024, 80, 64)
// bf16, N 64, chunk 128, the bytes are x and y once, B, C, dt and the
// final state (182 MB: 0.054 ms) and the chunked algorithm's 32 GFLOP
// would take 0.033 ms on the tensor cores, so the bytes bound it.  This
// first kernel does its products on the CUDA cores in float32, one thread
// block per (b, h): it is bound by those FMAs and by one block per SM.
//
// Design.  The TPU kernel's sequential innermost grid axis (chunks) becomes
// a loop inside the thread block, which carries the (P x N) float32 state
// in shared memory from chunk to chunk; the B * H blocks (640 on the LM
// path) fill the 132 SMs without splitting the chunk axis.  Per chunk the
// block loads x (row-major) and B, C (transposed, step index fastest) into
// shared memory as float32, one warp forms la by a shuffle scan, then:
// G = (C B^T) o decay o dt (lower triangle only, 8 x 8 register tiles,
// stored transposed), y = G x + exp(la) (C h) (8 x 4 tiles), and the state
// update (4 x 4 tiles).  For i < j, la_i - la_j > 0 and exp could overflow:
// those entries are selected as 0 before any product.  A ragged last chunk
// is zero-filled past its end (dt = 0 keeps la flat there, x = 0 adds
// nothing), so every L is taken, not only multiples of the chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

inline int smem_floats(int q, int p, int n) {
  return q * p + 2 * n * q + q * q + n * p + 4 * q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y,
           float* __restrict__ hout, int L, int H, int G, int P, int N,
           int Q) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][P]
  float* bT = xs + Q * P;                         // [N][Q]
  float* cT = bT + N * Q;                         // [N][Q]
  float* gT = cT + N * Q;                         // [Q][Q]: gT[j][i] = G[i][j]
  float* hT = gT + Q * Q;                         // [N][P]: the state, transposed
  float* la = hT + N * P;                         // [Q]
  float* dts = la + Q;                            // [Q]
  float* wv = dts + Q;                            // [Q]: exp(la_last - la_j) dt_j
  float* ela = wv + Q;                            // [Q]: exp(la_i)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float ah = a[h];
  const int tid = threadIdx.x;
  const int T8 = Q / 8;        // 8-step tiles of the chunk
  const int TP = P / 4;
  const int TN = N / 4;

  for (int e = tid; e < N * P; e += THREADS) hT[e] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int qc = min(Q, L - c0);
    __syncthreads();           // the previous chunk is consumed
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P;
      const int p = e - i * P;
      xs[e] = i < qc ? to_f(x[(((long long)b * L + c0 + i) * H + h) * P + p])
                     : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int n = e / Q;
      const int i = e - n * Q;
      const long long at = (((long long)b * L + c0 + i) * G + g) * N + n;
      bT[e] = i < qc ? to_f(bm[at]) : 0.f;
      cT[e] = i < qc ? to_f(cm[at]) : 0.f;
    }
    for (int i = tid; i < Q; i += THREADS)
      dts[i] = i < qc ? to_f(dt[((long long)b * L + c0 + i) * H + h]) : 0.f;
    __syncthreads();

    if (tid < 32) {            // la = cumsum(dt * a): one warp, shuffle scan
      const int per = (Q + 31) / 32;
      float loc[4];
      float run = 0.f;
      for (int r = 0; r < per; ++r) {
        const int i = tid * per + r;
        run += i < Q ? dts[i] * ah : 0.f;
        loc[r] = run;
      }
      float tot = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += t;
      }
      const float base = tot - run;
      for (int r = 0; r < per; ++r) {
        const int i = tid * per + r;
        if (i < Q) la[i] = base + loc[r];
      }
    }
    __syncthreads();
    const float la_last = la[Q - 1];

    for (int i = tid; i < Q; i += THREADS) {
      ela[i] = expf(la[i]);
      wv[i] = expf(la_last - la[i]) * dts[i];
    }
    // G on and below the diagonal, in 8 x 8 tiles (ti >= tj).
    for (int t = tid; t < T8 * (T8 + 1) / 2; t += THREADS) {
      int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tj = t - ti * (ti + 1) / 2;
      const int i0 = ti * 8, j0 = tj * 8;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 c_lo = *reinterpret_cast<const float4*>(cT + n * Q + i0);
        const float4 c_hi = *reinterpret_cast<const float4*>(cT + n * Q + i0 + 4);
        const float4 b_lo = *reinterpret_cast<const float4*>(bT + n * Q + j0);
        const float4 b_hi = *reinterpret_cast<const float4*>(bT + n * Q + j0 + 4);
        const float cv[8] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w,
                             c_hi.x, c_hi.y, c_hi.z, c_hi.w};
        const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                             b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int j = j0 + s;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + r;
          // select before multiplying: exp(la_i - la_j) may be inf for i < j
          const float decay = i >= j ? expf(la[i] - la[j]) : 0.f;
          gT[j * Q + i] = i >= j ? acc[r][s] * decay * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = G x + exp(la) (C h), in (8 steps x 4 head dims) tiles.
    for (int t = tid; t < T8 * TP; t += THREADS) {
      const int ti = t / TP;
      const int tp = t - ti * TP;
      const int i0 = ti * 8, p0 = tp * 4;
      float yi[8][4], yc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[r][e] = yc[r][e] = 0.f;
      const int jend = min(i0 + 8, qc);
      for (int j = 0; j < jend; ++j) {
        const float4 g_lo = *reinterpret_cast<const float4*>(gT + j * Q + i0);
        const float4 g_hi = *reinterpret_cast<const float4*>(gT + j * Q + i0 + 4);
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
        const float gv[8] = {g_lo.x, g_lo.y, g_lo.z, g_lo.w,
                             g_hi.x, g_hi.y, g_hi.z, g_hi.w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) yi[r][e] = fmaf(gv[r], xx[e], yi[r][e]);
      }
      for (int n = 0; n < N; ++n) {
        const float4 c_lo = *reinterpret_cast<const float4*>(cT + n * Q + i0);
        const float4 c_hi = *reinterpret_cast<const float4*>(cT + n * Q + i0 + 4);
        const float4 hv = *reinterpret_cast<const float4*>(hT + n * P + p0);
        const float cv[8] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w,
                             c_hi.x, c_hi.y, c_hi.z, c_hi.w};
        const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) yc[r][e] = fmaf(cv[r], hh[e], yc[r][e]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + r;
        if (i >= qc) continue;
        T* yrow = y + (((long long)b * L + c0 + i) * H + h) * P + p0;
#pragma unroll
        for (int e = 0; e < 4; ++e) put(yrow + e, yi[r][e] + ela[i] * yc[r][e]);
      }
    }
    __syncthreads();

    // h <- exp(la_last) h + sum_j w_j x_j outer B_j, in (4 x 4) tiles.
    const float dec = expf(la_last);
    for (int t = tid; t < TN * TP; t += THREADS) {
      const int tn = t / TP;
      const int tp = t - tn * TP;
      const int n0 = tn * 4, p0 = tp * 4;
      float u[4][4];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) u[pp][nn] = 0.f;
      for (int j = 0; j < qc; ++j) {
        const float w = wv[j];
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
        float bb[4];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) bb[nn] = bT[(n0 + nn) * Q + j];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) u[pp][nn] = fmaf(xw[pp], bb[nn], u[pp][nn]);
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          float* hp = hT + (n0 + nn) * P + p0 + pp;
          *hp = dec * *hp + u[pp][nn];
        }
    }
  }
  __syncthreads();
  float* hb = hout + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N;
    const int n = e - p * N;
    hb[e] = hT[n * P + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* bm,
           const void* cm, void* y, float* hout, int batch, int L, int H,
           int G, int P, int N, int Q, cudaStream_t stream) {
  const int smem = smem_floats(Q, P, N) * (int)sizeof(float);
  auto kern = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, batch);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), hout, L, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ranky_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* hout, int is_bf16, int batch, int L,
                              int H, int G, int P, int N, int Q,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* hf = static_cast<float*>(hout);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, af, bm, cm, y, hf, batch, L, H, G, P,
                                 N, Q, s);
  return launch<float>(x, dt, af, bm, cm, y, hf, batch, L, H, G, P, N, Q, s);
}
