// flash_attention: fused multi-head attention with an online softmax,
// forward only, written by hand for Hopper (sm_90a) on the tensor cores.
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
// (0.050 ms at 3.35 TB/s; the operations take 0.043 ms at 989 TFLOP/s).
// This kernel does its products with `mma.sync.m16n8k16` (bf16 in, float32
// sums); P.V is done twice (below), so it issues 1.5x the operations.
//
// Design (the FlashAttention-2 form).  One block per (query tile, b * h),
// 4 warps for bf16 and 8 for float32; each warp owns 16 query rows (head
// dims up to 128; at 256 two warps share 16 rows, `Cfg` below).  Query
// tiles run in reverse order so the heavy causal tiles start first; the
// blocks of one head (and of the heads sharing a KV head) are adjacent, so
// they share K and V in L2.  Q is loaded once into tensor-core A fragments
// (at head dim 256 it stays in shared memory).  K and V arrive in 64-key
// tiles (32 for float32 at head dim 256) through a two-stage ring in shared
// memory filled by `cp.async` (the next tile loads while this one is used);
// rows are padded so that `ldmatrix` (`.trans` for V) has no bank conflict;
// head dims are zero-padded to DP, a multiple of 16.  S = Q K^T stays in the
// MMA's float32 accumulator fragments, where scale, softcap and the masks
// are applied (masks only on tiles that straddle a boundary); row max and
// row sum take two quad shuffles; the exponentials are `ex2.approx` (2
// ulp).  The float32 P fragment becomes the A operand of O += P V in
// registers.
//
// Accuracy.  Rounding P once to bf16 (what stock flash kernels do) moves a
// bf16 output by up to ~20 bf16 ulps against the float32 softmax; so P is
// split into bf16 terms P_hi + P_lo (P_lo = bf16(P - P_hi)) and both are
// multiplied by V: the output stays within one bf16 ulp of the plain
// version.  float32 inputs take the same kernel with q, k, v and P each
// split into three bf16 terms t0 + t1 + t2 (t_i = bf16 of what the earlier
// terms leave) and the products t_i u_j with i + j < 3 kept: about 2^-24
// relative, the float32 limits of the plain comparison.  For float32 the
// tiles are staged in shared memory as float32 (cp.async) and split while
// the fragments are built.  The denominator l is the float32 sum of P.
//
// Masking.  The TPU kernel uses the finite sentinel -1e30 for hidden
// scores.  Here the running max starts at the same finite -1e30 (so alpha
// never is exp(-inf + inf) = NaN) and a hidden key's weight is set to 0
// before it is used, so a row that sees no key keeps l == 0 and comes out
// as zeros.  Rows that see a key get the same sums as the TPU kernel.
//
// The wrapper hands over head dims padded to a multiple of 8 and 16-byte
// aligned rows, so every 16-byte copy is whole.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;       // the TPU kernel's finite sentinel
constexpr float LOG2E = 1.4426950408889634f;

// NT: bf16 terms of q, k, v; NP: bf16 terms of P; E: elements per 16
// bytes.
template <typename T> struct Terms;
template <> struct Terms<__nv_bfloat16> {
  static constexpr int NT = 1, NP = 2, E = 8;
};
template <> struct Terms<float> {
  static constexpr int NT = 3, NP = 3, E = 4;
};

// The launch shape at head dims padded to DP.  W warps a block; DS warps
// share 16 query rows, each owning DP / DS of the output's dims; BK keys a
// shared-memory tile; QSM: q stays in shared memory (its fragments are
// re-read for each key tile) instead of registers.  Up to DP = 128: bf16
// takes 4 warps (about 145 registers: three blocks an SM), float32 takes 8
// (about 230 registers), so a K/V tile serves 128 rows; one warp a row
// group.  At DP = 256 the output alone would be 128 floats a thread, so two
// warps share each row group (both compute the same scores and softmax, each
// multiplies P by its half of V), q is read from shared memory, and float32
// takes 32-key tiles so that two K/V stages and q fit 227 KiB.
template <typename T, int DP> struct Cfg {
  static constexpr bool BIG = DP > 128;
  static constexpr int W = (sizeof(T) == 2 && !BIG) ? 4 : 8;
  static constexpr int DS = BIG ? 2 : 1;
  static constexpr int BK = (sizeof(T) == 4 && BIG) ? 32 : 64;
  static constexpr bool QSM = BIG;
  static constexpr int BQ = 16 * W / DS;               // query rows a block
  static constexpr int KST = DP + 8;                   // K (and Q) row stride
  static constexpr int VST = sizeof(T) == 2 ? DP + 8 : DP + 4;
  static constexpr int STAGE = BK * (KST + VST);       // elements per stage
  // two K/V stages; Q passes through the same memory first unless QSM
  static constexpr int SMEM_ELEMS =
      QSM ? BQ * KST + 2 * STAGE
          : (2 * STAGE > BQ * KST ? 2 * STAGE : BQ * KST);
};

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x, 0 for x << 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as N bf16x2 terms (x in the low half): term i is bf16 of what
// terms 0..i-1 leave; each remainder is exact in float32.
template <int N>
__device__ __forceinline__ void split(float x, float y, uint32_t* out,
                                      int stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[i * stride] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

// Copy rows [row0, row0 + R) of a (rows, d) array into an (R, ST) tile;
// rows >= rows and dims >= d are zero-filled (dims up to DP).
template <typename T, int DP, int ST, int R, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int rows, int d, int tid) {
  constexpr int E = Terms<T>::E;
  constexpr int CPR = DP / E;       // 16-byte chunks per row
  for (int idx = tid; idx < R * CPR; idx += THREADS) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * E;
    const bool ok = row0 + r < rows && c < d;
    const T* from = ok ? src + (long long)(row0 + r) * d + c : src;
    cp_async16(dst + r * ST + c, from, ok ? 16 : 0);
  }
}

// A fragments of row group rg's 16 query rows, dims [16 kk, 16 kk + 16), NT
// terms.
template <typename T, int ST>
__device__ __forceinline__ void q_frag(uint32_t (*a)[4], const T* qs, int kk,
                                       int rg, int lane) {
  if constexpr (sizeof(T) == 2) {
    const int row = 16 * rg + (lane & 7) + (((lane >> 3) & 1) << 3);
    ldsm_x4(a[0], qs + row * ST + 16 * kk + ((lane >> 4) << 3));
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // a0: (g, 2t) a1: (g+8, 2t) a2: (g, 2t+8) a3
      const float2 x = *reinterpret_cast<const float2*>(
          qs + (16 * rg + g + 8 * (e & 1)) * ST + 16 * kk + 2 * t +
          8 * (e >> 1));
      split<Terms<T>::NT>(x.x, x.y, &a[0][e], 4);
    }
  }
}

// B fragments of K^T for keys [n0, n0 + 16) (two n-blocks of 8), dims
// [16 kk, 16 kk + 16): b[term][n-block][0..1].
template <typename T, int ST>
__device__ __forceinline__ void k_frag(uint32_t (*b)[2][2], const T* ks,
                                       int n0, int kk, int lane) {
  if constexpr (sizeof(T) == 2) {
    uint32_t r[4];
    const int key = n0 + (lane & 7) + ((lane >> 4) << 3);
    ldsm_x4(r, ks + key * ST + 16 * kk + (((lane >> 3) & 1) << 3));
    b[0][0][0] = r[0]; b[0][0][1] = r[1]; b[0][1][0] = r[2]; b[0][1][1] = r[3];
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = *reinterpret_cast<const float2*>(
            ks + (n0 + 8 * nb + g) * ST + 16 * kk + 2 * t + 8 * h);
        split<Terms<T>::NT>(x.x, x.y, &b[0][nb][h], 4);
      }
  }
}

// B fragments of V for keys [16 ks, 16 ks + 16), dims [d0, d0 + 16) (two
// n-blocks of 8): b[term][n-block][0..1].
template <typename T, int ST>
__device__ __forceinline__ void v_frag(uint32_t (*b)[2][2], const T* vs,
                                       int ks, int d0, int lane) {
  if constexpr (sizeof(T) == 2) {
    uint32_t r[4];
    const int key = 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3);
    ldsm_x4_t(r, vs + key * ST + d0 + ((lane >> 4) << 3));
    b[0][0][0] = r[0]; b[0][0][1] = r[1]; b[0][1][0] = r[2]; b[0][1][1] = r[3];
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p = vs + (16 * ks + 8 * h + 2 * t) * ST + d0 + 8 * nb + g;
        split<Terms<T>::NT>(p[0], p[ST], &b[0][nb][h], 4);
      }
  }
}

__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// DP: head dims padded to a multiple of 16 (the wrapper's d <= DP).
template <typename T, int DP>
__global__ void __launch_bounds__(32 * Cfg<T, DP>::W)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
            int sq, int sk, int d, int causal, int window, float softcap,
            float scale) {
  using C = Cfg<T, DP>;
  constexpr int NT = Terms<T>::NT;
  constexpr int NP = Terms<T>::NP;
  constexpr int THREADS = 32 * C::W;
  constexpr int BK = C::BK;
  constexpr int KST = C::KST, VST = C::VST, STAGE = C::STAGE;
  constexpr int KT = DP / 16;                          // k-steps of q.k
  constexpr int NBW = DP / 8 / C::DS;                  // output n-blocks a warp
  constexpr int BQ = C::BQ;
  constexpr int RG = C::W / C::DS;                     // row groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qsm = reinterpret_cast<T*>(smem_raw);
  T* smem = qsm + (C::QSM ? BQ * KST : 0);             // the K/V stages

  const int qt = gridDim.x - 1 - blockIdx.x;           // heavy tiles first
  const int bh = blockIdx.y;                           // b * hq + h
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // this warp's 16 rows and its output dims (one warp a row group up to
  // head dim 128: both folded, as if there were no sharing)
  const int rg = C::DS == 1 ? warp : warp % RG;
  const int d0 = C::DS == 1 ? 0 : (warp / RG) * (DP / C::DS);
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BQ;
  const int off = sk - sq;

  // The keys any row of this block can see, in whole tiles.
  const int q_first = q0 + off;
  const int q_last = min(q0 + BQ, sq) - 1 + off;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const long long kv_base = ((long long)b * hkv + kvh) * (long long)sk * d;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;

  // Q into its own shared memory (QSM), or through the stage memory into
  // registers.
  uint32_t qf[C::QSM ? 1 : KT][NT][4];
  load_tile<T, DP, KST, BQ, THREADS>(qsm, q + (long long)bh * sq * d, q0, sq,
                                     d, tid);
  if constexpr (!C::QSM) {
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) q_frag<T, KST>(qf[kk], qsm, kk, rg, lane);
    __syncthreads();
  }

  if (ntiles > 0) {
    load_tile<T, DP, KST, BK, THREADS>(smem, kb, k_begin, sk, d, tid);
    load_tile<T, DP, VST, BK, THREADS>(smem + BK * KST, vb, k_begin, sk, d,
                                       tid);
    if constexpr (!C::QSM) cp_commit();
  }
  if constexpr (C::QSM) cp_commit();   // Q arrives in this group too

  float m[2] = {NEG, NEG};          // running max (log2 units), rows g, g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  float acc[NBW][4];
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  const int row_pos = q0 + 16 * rg + g + off;          // key position of row g
  // scores in log2 units: s * scale * log2 e, or softcap * log2 e * tanh
  const float cap_log2 = softcap * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float to_log2 = softcap > 0.f ? 1.f : scale * LOG2E;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = k_begin + it * BK;
    if (it + 1 < ntiles) {
      T* nxt = smem + ((it + 1) & 1) * STAGE;
      load_tile<T, DP, KST, BK, THREADS>(nxt, kb, k0 + BK, sk, d, tid);
      load_tile<T, DP, VST, BK, THREADS>(nxt + BK * KST, vb, k0 + BK, sk, d,
                                         tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* ks = smem + (it & 1) * STAGE;
    const T* vs = ks + BK * KST;

    // S = Q K^T: BK / 8 n-blocks of 8 keys, float32 fragments.
    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[NT][4];
      if constexpr (C::QSM) {
        q_frag<T, KST>(qa, qsm, kk, rg, lane);
      } else {
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[i][e] = qf[kk][i][e];
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[NT][2][2];
        k_frag<T, KST>(kf, ks, 16 * np, kk, lane);
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int j = 0; i + j < NT; ++j)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              mma(s[2 * np + nb], qa[i], kf[j][nb][0], kf[j][nb][1]);
      }
    }

    // Softcap, masks; the tile's row max.  Without a softcap the scores
    // stay unscaled here: the max commutes with scale * log2 e > 0, which
    // then enters the exponent through one FMA.
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q_first) ||
                      (window > 0 && k0 <= q_last - window);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e];
        if (softcap > 0.f) x = cap_log2 * tanhf(x * cap_in);
        if (edge) {
          const int kpos = k0 + 8 * nb + 2 * t + (e & 1);
          const int qpos = row_pos + 8 * (e >> 1);
          const bool vis = kpos < sk && (!causal || qpos >= kpos) &&
                           (window <= 0 || qpos - kpos < window);
          if (!vis) x = NEG;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r] * to_log2);
      alpha[r] = fast_exp2(m[r] - mnew);
      m[r] = mnew;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a hidden key weighs 0, whatever the running max is
        const float p = s[nb][e] > NEG
            ? fast_exp2(fmaf(s[nb][e], to_log2, -m[e >> 1])) : 0.f;
        s[nb][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb) {
      acc[nb][0] *= alpha[0]; acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1]; acc[nb][3] *= alpha[1];
    }

    // O += P V on this warp's dims, P in NP bf16 terms, 16 keys at a time.
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      uint32_t pa[NP][4];
      split<NP>(s[2 * kq][0], s[2 * kq][1], &pa[0][0], 4);
      split<NP>(s[2 * kq][2], s[2 * kq][3], &pa[0][1], 4);
      split<NP>(s[2 * kq + 1][0], s[2 * kq + 1][1], &pa[0][2], 4);
      split<NP>(s[2 * kq + 1][2], s[2 * kq + 1][3], &pa[0][3], 4);
#pragma unroll
      for (int dp = 0; dp < NBW / 2; ++dp) {
        uint32_t vf[NT][2][2];
        v_frag<T, VST>(vf, vs, kq, d0 + 16 * dp, lane);
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int j = 0; j < NT && i + j < NP; ++j)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              mma(acc[2 * dp + nb], pa[i], vf[j][nb][0], vf[j][nb][1]);
      }
    }
    __syncthreads();                // this stage is refilled two tiles on
  }
  if constexpr (C::QSM)
    cp_wait<0>();                   // a block that sees no key still loaded Q

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;    // no visible key -> zeros
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * rg + g + 8 * r;
    if (qi >= sq) continue;
    T* orow = o + ((long long)bh * sq + qi) * d;
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb) {
      const int dd = d0 + 8 * nb + 2 * t;            // d is even
      if (dd < d)
        put2(orow + dd, acc[nb][2 * r] / l[r], acc[nb][2 * r + 1] / l[r]);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int sq, int sk, int d, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const int smem = C::SMEM_ELEMS * (int)sizeof(T);
  auto kern = attn_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + C::BQ - 1) / C::BQ, batch * hq);
  kern<<<grid, 32 * C::W, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, d,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int hq, int hkv, int sq, int sk, int d, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;  // the wrapper pads
#define RANKY_FA_CASE(N)                                                     \
  if (d <= N)                                                                \
    return launch<T, N>(q, k, v, o, batch, hq, hkv, sq, sk, d, causal,       \
                        window, softcap, scale, stream);
  // Few instantiations keep the build short; 80 is zamba2's head dim, 256
  // gemma2-9b's.
  RANKY_FA_CASE(32)
  RANKY_FA_CASE(64)
  RANKY_FA_CASE(80)
  RANKY_FA_CASE(128)
  RANKY_FA_CASE(256)
#undef RANKY_FA_CASE
  return (int)cudaErrorInvalidValue;    // d > 256: the wrapper refuses it
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
