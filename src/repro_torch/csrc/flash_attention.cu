// flash_attention: fused multi-head attention with an online softmax,
// forward only, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`_attn_kernel` / `flash_attention`) and its wrapper `ops.flash_attention`.
//
//   out[b, h, i] = sum_j softmax_j(s_ij) v[b, h / group, j],
//   s_ij = scale * q[b, h, i] . k[b, h / group, j]   (then softcap * tanh(s / softcap))
//
// over the keys j that query i sees: queries are right-aligned against the
// keys (query i sits at key position i + sk - sq), `causal` hides j > that
// position, `window` > 0 hides j <= position - window.  A row that sees no
// key comes out as zeros.  Inputs are float32 or bfloat16, all sums are
// float32, the output is in the input's type.
//
// What bounds it on an H100: at the LM path's shape (8, 32, 1024, 80) bf16,
// causal, the work is 2 * 2 * B * H * D * (Sq * Sk / 2) = 43 GFLOP and the
// bytes are q, k, v and the output once (168 MB): the bytes bound it
// (0.050 ms at 3.35 TB/s; the operations take 0.043 ms on the tensor cores
// at 989 TFLOP/s).  This first kernel runs on the CUDA cores in float32,
// so it is bound by its float32 FMAs and the shared-memory reads that feed
// them, with one block per SM (the 64 scores of a tile live in registers).
//
// Design.  One thread block per (64-query tile, b * h); four threads per
// query row, each holding a quarter of the row's head dims (interleaved in
// groups of four, so that the four threads of a row read one contiguous
// 64-byte span of a key or value row as float4 and the eight rows of a
// warp read the same span: a broadcast, no bank conflict).  The block walks
// 64-key tiles of K and V held in shared memory as float32; the running
// max, denominator and output accumulator stay in float32 registers.  A
// score is the four threads' partial dot products summed by two shuffles.
// Tiles that no row of the block can see (beyond the causal frontier or
// before the window) are never visited: the tile range is computed up
// front, as the TPU kernel's `pl.when` skip does.
//
// Masking.  The TPU kernel uses the finite sentinel -1e30 for hidden
// scores and lets exp(-1e30 - -1e30) = 1 stand for hidden keys of a row
// that has seen no key yet (a later real maximum wipes it with alpha = 0).
// Here the running max starts at the same finite -1e30 (so alpha never is
// exp(-inf + inf) = NaN) and a hidden key's weight is set to 0 before it
// is used, so a row that sees no key keeps l == 0 and comes out as zeros.
// Rows that see a key get the same sums as the TPU kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;              // query rows per thread block
constexpr int BK = 64;              // keys per shared-memory tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr float NEG = -1e30f;       // the TPU kernel's finite sentinel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// DPT: head dims per thread, a multiple of 4; the row is padded to
// DS = 4 * DPT dims (zeros) in registers and shared memory.
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
            int sq, int sk, int d, int causal, int window, float softcap,
            float scale) {
  constexpr int DS = DPT * TPR;
  constexpr int C4 = DPT / 4;       // float4 groups per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * DS;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;        // b * hq + h
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = qt * BQ + row;
  const bool active = qi < sq;
  const int off = sk - sq;
  const int qpos = qi + off;

  float qr[DPT];
  float acc[DPT];
  const T* qrow = q + ((long long)bh * sq + (active ? qi : 0)) * d;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * (part + TPR * c) + e;
      qr[4 * c + e] = (active && dd < d) ? to_f(qrow[dd]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = NEG;
  float l = 0.f;

  // The keys any row of this block can see, in whole tiles.
  const int q_first = qt * BQ + off;
  const int q_last = min(qt * BQ + BQ, sq) - 1 + off;
  int k_end = causal ? min(sk, q_last + 1) : sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  const long long kv_base = ((long long)b * hkv + kvh) * (long long)sk * d;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                // the previous tile is consumed
    for (int e = tid; e < BK * DS; e += THREADS) {
      const int j = e / DS;
      const int dd = e - j * DS;
      const int kj = k0 + j;
      const bool ok = kj < sk && dd < d;
      const long long at = (long long)kj * d + dd;
      ks[e] = ok ? to_f(kb[at]) : 0.f;
      vs[e] = ok ? to_f(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mcur = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DS);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 kk = kr[part + TPR * c];
        dot = fmaf(qr[4 * c + 0], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float sj = dot * scale;
      if (softcap > 0.f) sj = softcap * tanhf(sj / softcap);
      const int kpos = k0 + j;
      const bool vis = kpos < sk && (!causal || qpos >= kpos) &&
                       (window <= 0 || qpos - kpos < window);
      s[j] = vis ? sj : NEG;
      mcur = fmaxf(mcur, s[j]);
    }
    const float mnew = fmaxf(m, mcur);
    const float alpha = expf(m - mnew);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // a hidden key weighs 0, whatever the running max is
      const float p = s[j] > NEG ? expf(s[j] - mnew) : 0.f;
      s[j] = p;
      psum += p;
    }
    l = alpha * l + psum;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * DS);
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 vv = vr[part + TPR * c];
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = mnew;
  }

  if (!active) return;
  const float den = l == 0.f ? 1.f : l;   // no visible key -> zeros
  T* orow = o + ((long long)bh * sq + qi) * d;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * (part + TPR * c) + e;
      if (dd < d) put(orow + dd, acc[4 * c + e] / den);
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int sq, int sk, int d, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  const int smem = 2 * BK * DPT * TPR * (int)sizeof(float);
  auto kern = attn_kernel<T, DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, batch * hq);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, d,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int hq, int hkv, int sq, int sk, int d, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  const int need = (d + 15) / 16 * 4;   // dims per thread, a multiple of 4
#define RANKY_FA_CASE(N)                                                     \
  if (need <= N)                                                             \
    return launch<T, N>(q, k, v, o, batch, hq, hkv, sq, sk, d, causal,       \
                        window, softcap, scale, stream);
  // Few instantiations keep the build short (each takes ptxas ~1.5 s);
  // 20 is zamba2's head dim 80 exactly.
  RANKY_FA_CASE(4)
  RANKY_FA_CASE(8)
  RANKY_FA_CASE(16)
  RANKY_FA_CASE(20)
  RANKY_FA_CASE(32)
#undef RANKY_FA_CASE
  return (int)cudaErrorInvalidValue;    // d > 128: the wrapper refuses it
}

}  // namespace

extern "C" int ranky_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int is_bf16,
                                     int batch, int hq, int hkv, int sq,
                                     int sk, int d, int causal, int window,
                                     float softcap, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, batch, hq, hkv, sq, sk, d,
                                   causal, window, softcap, scale, s);
  return dispatch<float>(q, k, v, o, batch, hq, hkv, sq, sk, d, causal,
                         window, softcap, scale, s);
}
