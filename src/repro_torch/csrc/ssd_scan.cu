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
// bf16, N 64, the bytes are x and y once, B, C, dt and the final state
// (182 MB: 0.054 ms); the recurrence's 4 P N operations a step and head
// (10.7 GFLOP) take 0.011 ms on the tensor cores, so the bytes bound it.
//
// bf16 design (`ssd_kernel_mma`, launched at chunks of Q = 64 steps and
// NW = 4 warps a block).  One block per (b, h, P tile) walks the chunks in
// order and carries its (P tile x N) float32 state in registers: 16 x 64
// values a warp.  For N <= 64 a P tile is 64 head dims and warp w owns the
// state rows [16 w, 16 w + 16); for 64 < N <= 128 (mamba2-1.3b's N = 128)
// a P tile is 32 head dims and warp w owns rows [16 (w % 2), + 16) and
// columns [64 (w / 2), + 64), so the registers a thread holds stay as they
// are at N = 64.  P up to 128 takes several P tiles: a state row and an
// output column depend only on their own column of x, so the tiles only
// repeat C B^T and the dt a scan.  Per chunk:
//
// * x (Q x P tile), B and C (Q x N) arrive as bf16 through a two-stage
//   `cp.async` ring (chunk c + 1 loads while chunk c computes) into tiles of
//   64-element (x) and 64- or 128-element (B, C) rows with an XOR swizzle of
//   their 16-byte pieces, so that `ldmatrix` / `ldmatrix.trans` read them
//   without bank conflicts; dt comes a chunk ahead through a register.
//   Nothing is widened or transposed element by element.
// * Every warp forms la (log2 units) and w_j = exp(la_last - la_j) dt_j by
//   its own shuffle scan, into its own shared array: no one-warp phase.
// * The four products run on `mma.sync.m16n8k16` (bf16 in, float32 sums).
//   Each warp owns whole 16-row tiles of the chunk (one at 64 x 4; paired
//   (t, RT - 1 - t) when it owns two, so that the triangular work is even):
//   y = exp(la_i) C (h_hi + h_lo)^T, then for each 16-column tile j <= i:
//   S = C B^T on the accumulator fragments, G = S o exp(la_i - la_j) o dt_j
//   with the entries i < j selected to 0 inside the exponent (exp2(-inf) =
//   0, so nothing can overflow), G = G_hi + G_lo in bf16 as the A operand
//   in registers (the flash kernel's reuse of P), y += G_hi x + G_lo x.
//   Tiles above the diagonal are skipped whole.
// * h <- exp(la_last) h + (x o w)^T B with x o w split into hi + lo bf16
//   terms while its `ldmatrix.trans` fragments are built; then the state's
//   hi + lo copies go to shared memory for the next chunk's C h.
//
// Accuracy.  C B^T is exact (bf16 products, float32 sums).  G, h and x o w
// are float32 intermediates: rounding each once to bf16 moves a bf16 y by
// about 12 times its limit (tests/test_torch_kernel_numerics.py), so each
// enters as two bf16 terms (relative error about 2^-17), within one bf16
// ulp of the sequential recurrence.  The exponentials are `ex2.approx`.
// A ragged last chunk is zero-filled past its end (dt = 0 keeps la flat,
// x = B = C = 0 add nothing), so every L is taken.
//
// float32 design (`ssd_kernel_f32`, the first port's kernel, kept for the
// float32 in-model check): float32 FMAs on the CUDA cores, one 256-thread
// block per (b, h), x, B^T, C^T, G and the state in shared memory; the
// chunk follows N so that these fit (128 steps for N <= 64, 64 above).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x, 0 at -inf
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
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n");
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

// (x, y) as bf16x2 hi + lo terms (x in the low half); lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Element (row, col) of a [rows][W] bf16 tile (W = 64 or 128) whose 16-byte
// pieces are XOR-swizzled by row: the eight rows an `ldmatrix` reads at one
// column hit eight different bank groups.
template <int W>
__device__ __forceinline__ int sw(int row, int col) {
  return row * W + ((((col >> 3) ^ row) & (W / 8 - 1)) << 3) + (col & 7);
}

// Rows [0, Q) of a strided bf16 array (row r at src + r * stride), columns
// [0, cols), into a swizzled [Q][W] tile: rows >= valid and columns in
// [cols, 16 * ceil(cols / 16)) are zero-filled.  16-byte pieces when the
// array's rows are `width` elements with width and cols multiples of 8 (then
// every piece is aligned: the wrapper aligns the bases), else 8-byte pieces.
template <int Q, int THREADS, int W>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int valid,
                                          int cols, int width, int tid) {
  const int padded = (cols + 15) & ~15;
  if (((cols | width) & 7) == 0) {
    const int per = padded >> 3;
    for (int idx = tid; idx < Q * per; idx += THREADS) {
      const int r = idx / per;
      const int c = (idx - r * per) << 3;
      const bool ok = r < valid && c < cols;
      cp_async16(dst + sw<W>(r, c), ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    const int per = padded >> 2;
    for (int idx = tid; idx < Q * per; idx += THREADS) {
      const int r = idx / per;
      const int c = (idx - r * per) << 2;
      const bool ok = r < valid && c < cols;
      cp_async8(dst + sw<W>(r, c), ok ? src + r * stride + c : src,
                ok ? 8 : 0);
    }
  }
}

// Shared memory of `ssd_kernel_mma<Q, NW, DN, PTW>`: two stages of x (Q x
// 64), B and C (Q x DN), the state's hi + lo copies (PTW x DN), dt (two
// chunks) and each warp's la2 and w.
template <int Q, int NW, int DN, int PTW>
constexpr int mma_smem_bytes() {
  return (2 * (Q * 64 + 2 * Q * DN) + 2 * PTW * DN) * (int)sizeof(bf16) +
         (2 * Q + NW * 2 * Q) * (int)sizeof(float);
}

// Q: steps per chunk; NW: warps, each owning RT / NW row tiles of 16.  DN:
// the row width of the B and C tiles (N <= DN); PTW: the head dims a block
// takes (P is cut into ceil(P / PTW) tiles, one block each: a state row and
// an output column depend only on their own column of x, so only C B^T and
// the dt a scan are repeated per tile); ONE: P <= PTW, one tile, its offset
// folded at compile time.  Warp w owns state rows [16 (w % SPT), + 16) of
// the tile and state columns [64 (w / SPT), + 64).
template <int Q, int NW, int DN, int PTW, bool ONE>
__global__ void __launch_bounds__(32 * NW)
ssd_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, bf16* __restrict__ y,
               float* __restrict__ hout, int L, int H, int G, int P, int N) {
  constexpr int THREADS = 32 * NW;
  constexpr int DX = 64;                   // x tile row width: PTW <= 64
  constexpr int RT = Q / 16;               // row tiles of a chunk
  constexpr int TPW = RT / NW;             // row tiles per warp
  constexpr int KN = DN / 16;              // 16-wide steps over N
  constexpr int PB = PTW / 16;             // 16-wide steps over the P tile
  constexpr int SPT = PTW / 16;            // state row tiles
  constexpr int NQ = DN * SPT / NW;        // state columns per warp
  constexpr int XT = Q * DX, BT = Q * DN, STAGE = XT + 2 * BT;
  constexpr int PER = Q / 32;              // scan values per lane
  static_assert(RT % NW == 0 && THREADS >= Q && NW % SPT == 0 && NQ == 64 &&
                PTW <= DX, "launch shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);     // [2][x, B, C]
  bf16* hhi = stage + 2 * STAGE;                       // [PTW][DN]: (p, n)
  bf16* hlo = hhi + PTW * DN;
  float* dts = reinterpret_cast<float*>(hlo + PTW * DN);  // [2][Q]
  float* own = dts + 2 * Q;                            // per warp: la2, w

  const int ptiles = ONE ? 1 : (P + PTW - 1) / PTW;
  const int h = ONE ? blockIdx.x : blockIdx.x / ptiles;
  const int p0 = ONE ? 0 : (blockIdx.x - h * ptiles) * PTW;   // head dims
  const int pc = ONE ? P : min(PTW, P - p0);
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a2 = a[h] * LOG2E;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int PT = (pc + 15) >> 4, NT = (N + 15) >> 4;
  // state row tile and first state column (folded when one warp spans N)
  const int spt = NW == SPT ? warp : warp % SPT;
  const int nq0 = NW == SPT ? 0 : (warp / SPT) * NQ;
  const int nt0 = nq0 >> 4;                            // in 16-wide steps
  float* la2 = own + warp * 2 * Q;
  float* wv = la2 + Q;

  const long long xstride = (long long)H * P;
  const long long bstride = (long long)G * N;
  const bf16* xb = x + (long long)b * L * xstride + (long long)h * P + p0;
  const bf16* bb = bm + (long long)b * L * bstride + (long long)g * N;
  const bf16* cb = cm + (long long)b * L * bstride + (long long)g * N;
  const bf16* dtb = dt + (long long)b * L * H + h;
  bf16* yb = y + (long long)b * L * xstride + (long long)h * P + p0;

  auto load_chunk = [&](bf16* dst, int c0) {
    const int valid = min(Q, L - c0);
    load_rows<Q, THREADS, DX>(dst, xb + c0 * xstride, xstride, valid, pc, P,
                              tid);
    load_rows<Q, THREADS, DN>(dst + XT, bb + c0 * bstride, bstride, valid, N,
                              N, tid);
    load_rows<Q, THREADS, DN>(dst + XT + BT, cb + c0 * bstride, bstride,
                              valid, N, N, tid);
    cp_commit();
  };
  auto load_dt = [&](int c0) {
    return tid < Q && c0 + tid < L
               ? __bfloat162float(dtb[(long long)(c0 + tid) * H]) : 0.f;
  };

  for (int e = tid; e < 2 * PTW * DN; e += THREADS)
    hhi[e] = __float2bfloat16(0.f);
  float hacc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[nb][e] = 0.f;

  load_chunk(stage, 0);
  if (tid < Q) dts[tid] = load_dt(0);
  const int nchunks = (L + Q - 1) / Q;

  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * Q;
    const int qc = min(Q, L - c0);
    const int st = ci & 1;
    cp_wait_all();
    __syncthreads();     // stage st, dts[st] and the state copies are in
    float dt_next = 0.f;
    if (ci + 1 < nchunks) {   // every warp is past chunk ci - 1's reads
      load_chunk(stage + (st ^ 1) * STAGE, c0 + Q);
      dt_next = load_dt(c0 + Q);
    }
    const bf16* xs = stage + st * STAGE;
    const bf16* bs = xs + XT;
    const bf16* cs = bs + BT;
    const float* dtc = dts + st * Q;

    // la2 = cumsum(dt a) log2 e and w = 2^(la2_last - la2) dt, this warp's copy
    float run = 0.f, part[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      run += dtc[lane * PER + r] * a2;
      part[r] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, tot, off);
      if (lane >= off) tot += v;
    }
    const float last = __shfl_sync(0xffffffffu, tot, 31);
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = lane * PER + r;
      const float l2 = tot - run + part[r];
      la2[i] = l2;
      wv[i] = fast_exp2(last - l2) * dtc[i];
    }
    __syncwarp();

    // y for this warp's row tiles
#pragma unroll 1
    for (int k = 0; k < TPW; ++k) {
      const int r = k * NW + ((k & 1) ? NW - 1 - warp : warp);
      const int i0 = 16 * r;
      if (i0 >= qc) continue;
      uint32_t cf[KN][4];             // C rows i0.., k-steps over N
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        if (kk < NT)
          ldsm_x4(cf[kk], cs + sw<DN>(i0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                      16 * kk + ((lane >> 4) << 3)));
      float acc[2 * PB][4];
#pragma unroll
      for (int nb = 0; nb < 2 * PB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
      // inter: C (h_hi + h_lo)^T, then the rows scaled by 2^la2_i
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk >= NT) break;
#pragma unroll
        for (int pp = 0; pp < PB; ++pp) {
          if (pp >= PT) break;
          const int off = sw<DN>(16 * pp + (lane & 7) + ((lane >> 4) << 3),
                                 16 * kk + (((lane >> 3) & 1) << 3));
          uint32_t rh[4], rl[4];
          ldsm_x4(rh, hhi + off);
          ldsm_x4(rl, hlo + off);
          mma(acc[2 * pp], cf[kk], rh[0], rh[1]);
          mma(acc[2 * pp + 1], cf[kk], rh[2], rh[3]);
          mma(acc[2 * pp], cf[kk], rl[0], rl[1]);
          mma(acc[2 * pp + 1], cf[kk], rl[2], rl[3]);
        }
      }
      const int ia = i0 + gq, ib = ia + 8;
      const float la_a = la2[ia], la_b = la2[ib];
      const float ea = fast_exp2(la_a), eb = fast_exp2(la_b);
#pragma unroll
      for (int nb = 0; nb < 2 * PB; ++nb) {
        acc[nb][0] *= ea; acc[nb][1] *= ea;
        acc[nb][2] *= eb; acc[nb][3] *= eb;
      }
      // intra: 16-column tiles j <= i, the diagonal one masked
#pragma unroll 1
      for (int jt = 0; jt <= r; ++jt) {
        const int j0 = 16 * jt;
        float s[2][4];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          if (kk >= NT) break;
          uint32_t rb[4];
          ldsm_x4(rb, bs + sw<DN>(j0 + (lane & 7) + ((lane >> 4) << 3),
                                  16 * kk + (((lane >> 3) & 1) << 3)));
          mma(s[0], cf[kk], rb[0], rb[1]);
          mma(s[1], cf[kk], rb[2], rb[3]);
        }
        uint32_t ghi[4], glo[4];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int j = j0 + 8 * nb + 2 * t;
          const float l0 = la2[j], l1 = la2[j + 1];
          const float d0 = dtc[j], d1 = dtc[j + 1];
          // select before multiplying: 2^(la_i - la_j) may overflow for i < j
          const float g0 = s[nb][0] * fast_exp2(ia >= j ? la_a - l0 : -INFINITY) * d0;
          const float g1 = s[nb][1] * fast_exp2(ia >= j + 1 ? la_a - l1 : -INFINITY) * d1;
          const float g2 = s[nb][2] * fast_exp2(ib >= j ? la_b - l0 : -INFINITY) * d0;
          const float g3 = s[nb][3] * fast_exp2(ib >= j + 1 ? la_b - l1 : -INFINITY) * d1;
          // A fragment: a0 (row g, k 2t), a1 (row g+8, k 2t), a2 (g, 2t+8), a3
          split2(g0, g1, ghi[2 * nb], glo[2 * nb]);
          split2(g2, g3, ghi[2 * nb + 1], glo[2 * nb + 1]);
        }
#pragma unroll
        for (int pp = 0; pp < PB; ++pp) {
          if (pp >= PT) break;
          uint32_t rx[4];
          ldsm_x4_t(rx, xs + sw<DX>(j0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                    16 * pp + ((lane >> 4) << 3)));
          mma(acc[2 * pp], ghi, rx[0], rx[1]);
          mma(acc[2 * pp + 1], ghi, rx[2], rx[3]);
          mma(acc[2 * pp], glo, rx[0], rx[1]);
          mma(acc[2 * pp + 1], glo, rx[2], rx[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = ia + 8 * half;
        if (i >= qc) continue;
        bf16* yrow = yb + (long long)(c0 + i) * xstride;
#pragma unroll
        for (int nb = 0; nb < 2 * PB; ++nb) {
          const int p = 8 * nb + 2 * t;      // P is even
          if (p < pc)
            *reinterpret_cast<__nv_bfloat162*>(yrow + p) =
                __floats2bfloat162_rn(acc[nb][2 * half], acc[nb][2 * half + 1]);
        }
      }
    }
    __syncthreads();     // every warp has read the state copies

    // h <- 2^la2_last h + (x o w)^T B on this warp's state rows and columns
    const float dec = fast_exp2(last);
    if (spt < PT) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nb][e] *= dec;
#pragma unroll 1
      for (int ks = 0; ks < RT; ++ks) {
        if (16 * ks >= qc) break;
        uint32_t rx[4], xhi[4], xlo[4];
        // A = (x o w)^T: rows p, columns j; x is stored (j, p), so .trans
        ldsm_x4_t(rx, xs + sw<DX>(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                                  16 * spt + (((lane >> 3) & 1) << 3)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * ks + 2 * t + 8 * (e >> 1);
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&rx[e]));
          split2(xv.x * wv[j], xv.y * wv[j + 1], xhi[e], xlo[e]);
        }
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          if (nt0 + nn >= NT) break;
          uint32_t rb[4];
          ldsm_x4_t(rb, bs + sw<DN>(16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                                    nq0 + 16 * nn + ((lane >> 4) << 3)));
          mma(hacc[2 * nn], xhi, rb[0], rb[1]);
          mma(hacc[2 * nn + 1], xhi, rb[2], rb[3]);
          mma(hacc[2 * nn], xlo, rb[0], rb[1]);
          mma(hacc[2 * nn + 1], xlo, rb[2], rb[3]);
        }
      }
      // the state's hi + lo copies for the next chunk's C h
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (2 * nt0 + nb >= 2 * NT) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = sw<DN>(16 * spt + gq + 8 * half, nq0 + 8 * nb + 2 * t);
          uint32_t hi, lo;
          split2(hacc[nb][2 * half], hacc[nb][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(hhi + off) = hi;
          *reinterpret_cast<uint32_t*>(hlo + off) = lo;
        }
      }
    }
    if (ci + 1 < nchunks && tid < Q) dts[(st ^ 1) * Q + tid] = dt_next;
  }

  if (spt < PT) {
    float* hb = hout + ((long long)b * H + h) * P * N;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int n = nq0 + 8 * nb + 2 * t;    // N is even
      if (n >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * spt + gq + 8 * half;
        if (p < pc)
          *reinterpret_cast<float2*>(hb + (long long)(p0 + p) * N + n) =
              make_float2(hacc[nb][2 * half], hacc[nb][2 * half + 1]);
      }
    }
  }
}

// The bf16 kernel's launch shape: chunks of 64 steps, 4 warps a block; N <=
// 64 takes 64-wide B and C rows and whole 64-dim P tiles (P <= 64, as in
// zamba2, in one tile whose offset is folded), 64 < N <= 128 takes 128-wide
// rows and 32-dim P tiles (so that the state a warp holds stays 16 x 64 and
// two blocks fit an SM).
constexpr int MMA_CHUNK = 64;
constexpr int MMA_WARPS = 4;
constexpr int MAX_DIM = 128;     // P and N

template <int Q, int NW, int DN, int PTW, bool ONE>
int launch_mma(const void* x, const void* dt, const float* a, const void* bm,
               const void* cm, void* y, float* hout, int batch, int L, int H,
               int G, int P, int N, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<Q, NW, DN, PTW>();
  auto kern = ssd_kernel_mma<Q, NW, DN, PTW, ONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H * ((P + PTW - 1) / PTW), batch);
  kern<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt), a,
      static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
      static_cast<bf16*>(y), hout, L, H, G, P, N);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int F32_SMEM_MAX = 232448;   // bytes of shared memory a block may have

inline int f32_smem_floats(int q, int p, int n) {
  return q * p + 2 * n * q + q * q + n * p + 4 * q;
}

__global__ void __launch_bounds__(F32_THREADS)
ssd_kernel_f32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y,
               float* __restrict__ hout, int L, int H, int G, int P, int N,
               int Q) {
  constexpr int THREADS = F32_THREADS;
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
      xs[e] = i < qc ? x[(((long long)b * L + c0 + i) * H + h) * P + p] : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int n = e / Q;
      const int i = e - n * Q;
      const long long at = (((long long)b * L + c0 + i) * G + g) * N + n;
      bT[e] = i < qc ? bm[at] : 0.f;
      cT[e] = i < qc ? cm[at] : 0.f;
    }
    for (int i = tid; i < Q; i += THREADS)
      dts[i] = i < qc ? dt[((long long)b * L + c0 + i) * H + h] : 0.f;
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
        float* yrow = y + (((long long)b * L + c0 + i) * H + h) * P + p0;
#pragma unroll
        for (int e = 0; e < 4; ++e) yrow[e] = yi[r][e] + ela[i] * yc[r][e];
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

int launch_f32(const void* x, const void* dt, const float* a, const void* bm,
               const void* cm, void* y, float* hout, int batch, int L, int H,
               int G, int P, int N, int Q, cudaStream_t stream) {
  const int smem = f32_smem_floats(Q, P, N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, batch);
  ssd_kernel_f32<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), a,
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(y), hout, L, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Q: steps per chunk of the float32 kernel (Q <= 128, and its shared
// memory within the 227 KiB a block may have: the wrapper's chunk_for takes
// 128 for N <= 64 and 64 above); the bf16 kernel takes chunks of 64 steps
// and 4 warps a block (PERF.md: the launch shape measured fastest on an
// H100) and refuses another Q.  P and N: multiples of 4 up to 128; any other
// shape returns an error.
extern "C" int ranky_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* hout, int is_bf16, int batch, int L,
                              int H, int G, int P, int N, int Q,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* hf = static_cast<float*>(hout);
  if (P < 4 || P > MAX_DIM || P % 4 || N < 4 || N > MAX_DIM || N % 4)
    return (int)cudaErrorInvalidValue;
  if (!is_bf16) {
    if (Q < 1 || Q > 128 || f32_smem_floats(Q, P, N) * 4 > F32_SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    return launch_f32(x, dt, af, bm, cm, y, hf, batch, L, H, G, P, N, Q, s);
  }
  if (Q != MMA_CHUNK) return (int)cudaErrorInvalidValue;
  if (N <= 64 && P <= 64)
    return launch_mma<MMA_CHUNK, MMA_WARPS, 64, 64, true>(
        x, dt, af, bm, cm, y, hf, batch, L, H, G, P, N, s);
  if (N <= 64)
    return launch_mma<MMA_CHUNK, MMA_WARPS, 64, 64, false>(
        x, dt, af, bm, cm, y, hf, batch, L, H, G, P, N, s);
  return launch_mma<MMA_CHUNK, MMA_WARPS, 128, 32, false>(
      x, dt, af, bm, cm, y, hf, batch, L, H, G, P, N, s);
}
