// blockgram: G[d] = A_d A_d^T for a stack of short-and-fat dense blocks,
// float32 sums, float32 or bf16 input, written by hand for Hopper (sm_90a)
// on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/blockgram.py (_gram_kernel /
// blockgram), which streams (M, block_n) column panels and keeps the whole
// (M, M) accumulator on the core across a sequential grid.  On Hopper the
// blocks of a grid run in parallel and none can hold (M, M), so the OUTPUT
// is tiled and the W axis is cut into slices that run side by side.
//
// What bounds it on an H100: at the solver's shape, (8, 539, 21363) float32,
// the function needs D M (M + 1) W = 49.7 GFLOP (a multiply and an add for
// each entry on or above the diagonal) against 378 MB read and written once
// (0.113 ms at 3.35 TB/s).  On the CUDA cores (67 TFLOP/s) the operations
// would bound it at 0.742 ms; on the tensor cores a float32-accurate
// product costs t bf16 products (below), so the bound is max(bytes,
// operations / (989 TFLOP/s / t)): 0.302 ms for float32 input (t = 6),
// bytes for bf16 input and for float32 input whose values are all exact in
// bf16 (t = 1).
//
// Design: two passes and a small sum.
// * Pack.  A is read once and written as bf16 planes hi = bf16(x) and (for
//   float32 input) mid = bf16(x - hi) and lo = x - hi - mid, rows padded
//   with zeros to Wp, a multiple of 32, so that every row starts 16-byte
//   aligned (rows of A start at any element: W is odd at the solver's
//   shape).  hi + mid + lo is x exactly (24 bits of mantissa in three
//   terms of 8).  For each block d, 128-row tile and 32-column stage a flag
//   records whether any mid (bit 0) or any lo (bit 1) there is non-zero
//   (`atomicOr`: the result does not depend on the order).
// * Tiles.  One block computes one 128 x 128 tile (ti, tj) of G[d] with
//   ti <= tj (an enumerated list of the tiles on or above the diagonal, no
//   block that returns at once) over one slice of W.  8 warps, 2 x 4, each
//   own a 64 x 32 part in float32 accumulator fragments of
//   `mma.sync.m16n8k16` (bf16 in, float32 sums).  Both operands are rows of
//   the packed planes: the i tile's rows are the A operand and the j tile's
//   rows the column-major B operand, both read by non-transposed
//   `ldmatrix`.  A warp whose part lies wholly past M, or wholly below the
//   diagonal of a diagonal tile, skips its products (never stored).
// * A split over W.  `slices` slices of `slice_cols` columns (a multiple of
//   32) are chosen by the wrapper's launch plan from (D, M, W, dtype) alone,
//   so that the blocks fill the SMs several times over (12 slices at the
//   solver's shape).  With one slice the block writes G; else it writes its
//   slice's partial gram, and a third small kernel sums the partials in
//   slice order.  The sums take no atomics: the result is the same bits
//   from run to run.
// * Staging.  32 columns a stage through a `cp.async` ring of 16-byte
//   copies into XOR-swizzled planes (conflict-free `ldmatrix`), one barrier
//   a stage; rows past M are zero-filled.  The mid (lo) planes of a stage
//   are copied, and the products that take them done, only when the mid
//   (lo) flag of either tile is set: exact, since a zero term adds exactly
//   0.  A block whose whole slice has no flag set (0/1 data, bf16 input)
//   stages hi alone through a three-stage ring; the others take a
//   two-stage ring of the three planes (96 KB either way, two blocks an
//   SM).  The paper's 0/1 matrix thus takes one product, through the
//   deeper ring, and its gram is exact.
// * Products.  hi.hi + hi.mid + mid.hi + mid.mid + hi.lo + lo.hi (t = 6).
//   What they leave out, mid.lo + lo.mid + lo.lo, is below 2^-22 |x y| for
//   every product, so the split adds at most 2^-22 sum_k |x_k y_k| <=
//   2^-22 max|G| (Cauchy-Schwarz) to G, whatever W and the data.  Two
//   terms would not do: hi.hi + hi.mid + mid.hi errs up to 3.0e-5 |x y|,
//   and on rows of such values G errs as much
//   (tests/test_torch_kernel_numerics.py: leaving out mid.mid, or lo, misses
//   1e-5 of max|G|).  The rest of the error is float32 summation, as in any
//   float32 product.
// * Sums.  The tensor cores' float32 sums align every addend to the
//   largest and truncate: chained over a slice of thousands of columns
//   that biases G by several times 1e-5 of max|G| on an H100.  So each
//   16-column k-step's products start from zero, the smallest first, and
//   are added to the block's sums by a float32 add (round to nearest).
// * Symmetry.  A tile off the diagonal is stored as itself and mirrored; a
//   diagonal tile stores its entries i <= j as both (i, j) and (j, i).  So
//   G[j, i] is the very float G[i, j] is, and torch.equal(G, G^T) holds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;              // output tile edge
constexpr int KC = 32;                 // columns of A per stage
constexpr int THREADS = 256;           // 8 warps: 2 x 4 parts of 64 x 32
constexpr int ROWS = 2 * TILE;         // staged rows: the i tile, the j tile
constexpr int PLANE = ROWS * KC;       // bf16 elements of one staged plane
constexpr int PACK_COLS = 512;         // columns a pack block takes
constexpr int MID = 1, LO = 2;         // flag bits: some mid / lo non-zero

// Stages of the cp.async ring: HI_STAGES of the hi plane alone (bf16
// input, and a float32 block whose slice has no mid or lo), or ALL_STAGES
// of the three planes (a float32 block whose slice has some): 48 or 96 KB
// a block, two blocks an SM.
constexpr int HI_STAGES = 3;
constexpr int ALL_STAGES = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global memory, of which `src_bytes` (0 or 16) are read and
// the rest zero-filled.
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
// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of (row r, column k) in a staged [ROWS][32] bf16 plane:
// 16-byte pieces XOR-swizzled so that 8 rows at one piece hit 8 bank groups.
__device__ __forceinline__ int sw(int r, int k) {
  return r * KC + ((((k >> 3) ^ (r >> 1)) & 3) << 3) + (k & 7);
}

// Pack: row blockIdx.x of A (flat over D and M), columns [512 blockIdx.y,
// + 512), two a thread -> the hi (and mid, lo) planes (rows of wp, zeros
// past w); flags[d][tile][stage] |= MID / LO where a mid / lo of the stage
// is non-zero.
template <typename T>
__global__ void __launch_bounds__(256)
pack_kernel(const T* __restrict__ a, __nv_bfloat16* __restrict__ hi,
            __nv_bfloat16* __restrict__ mid, __nv_bfloat16* __restrict__ lo,
            int* __restrict__ flags, int m, int w, int wp, int tiles,
            int nstg) {
  const long long row = blockIdx.x;
  const int k = blockIdx.y * PACK_COLS + 2 * threadIdx.x;
  const bool in = k < wp;                    // wp is a multiple of 32
  const T* src = a + row * w;
  float x0 = 0.f, x1 = 0.f;
  if constexpr (sizeof(T) == 4) {
    if (k < w) x0 = src[k];
    if (k + 1 < w) x1 = src[k + 1];
  } else {
    if (k < w) x0 = __bfloat162float(src[k]);
    if (k + 1 < w) x1 = __bfloat162float(src[k + 1]);
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  if (in) *reinterpret_cast<__nv_bfloat162*>(hi + row * wp + k) = h;
  if constexpr (sizeof(T) == 4) {
    // each remainder is exact in float32; lo is exact in bf16
    const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
    const __nv_bfloat162 md = __floats2bfloat162_rn(r0, r1);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(r0 - __low2float(md), r1 - __high2float(md));
    if (in) {
      *reinterpret_cast<__nv_bfloat162*>(mid + row * wp + k) = md;
      *reinterpret_cast<__nv_bfloat162*>(lo + row * wp + k) = l;
    }
    const uint32_t mw = *reinterpret_cast<const uint32_t*>(&md);
    const uint32_t lw = *reinterpret_cast<const uint32_t*>(&l);
    const unsigned any_m = __ballot_sync(0xffffffffu, in && mw != 0u);
    const unsigned any_l = __ballot_sync(0xffffffffu, in && lw != 0u);
    const int lane = threadIdx.x & 31;
    // lanes 0-15 cover one 32-column stage, 16-31 the next
    const int bits = (((any_m >> lane) & 0xffffu) ? MID : 0) |
                     (((any_l >> lane) & 0xffffu) ? LO : 0);
    if ((lane & 15) == 0 && bits) {
      const int d = (int)(row / m), t = (int)(row % m) / TILE;
      atomicOr(&flags[((long long)d * tiles + t) * nstg + k / KC], bits);
    }
  }
}

// The sums of one block's tile pair over its slice: stages [0, nst) of
// the slice, columns from k_lo, into acc; PL: 1 (hi) or 3 (hi, mid, lo
// planes, each staged and multiplied where the stage's flags in fi / fj say
// it is non-zero); NS: stages of the ring.
template <int PL, int NS>
__device__ __forceinline__ void tile_sums(
    float (&acc)[4][4][4], __nv_bfloat16* smem,
    const __nv_bfloat16* __restrict__ hi,
    const __nv_bfloat16* __restrict__ mid,
    const __nv_bfloat16* __restrict__ lo, const int* fi, const int* fj,
    long long row0, int m, int wp, int i0, int j0, int k_lo, int nst,
    bool diag) {
  const int rows = diag ? TILE : ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3;
  const int brow = diag ? 0 : TILE;
  const bool live = i0 + wr * 64 < m && j0 + wc * 32 < m &&
                    !(diag && wr * 64 > wc * 32 + 31);
  // n-pairs of B fragments held at once: both for hi alone, one for the
  // three planes (so that the fragments of three terms fit the registers;
  // the A fragments are read twice)
  constexpr int NPB = PL == 1 ? 2 : 1;

  // MID / LO: stage c has a non-zero mid / lo in either tile (uniform)
  auto terms = [&](int c) { return PL == 1 ? 0 : (fi[c] | fj[c]); };
  auto load = [&](int c) {
    __nv_bfloat16* dst = smem + (c % NS) * PL * PLANE;
    const int k0 = k_lo + c * KC;
    const int f = terms(c);
    for (int idx = tid; idx < rows * 4; idx += THREADS) {
      const int r = idx >> 2, q = idx & 3;
      const int gr = r < TILE ? i0 + r : j0 + r - TILE;
      const bool ok = gr < m;
      const long long off = (row0 + gr) * wp + k0 + 8 * q;
      cp_async16(dst + sw(r, 8 * q), ok ? hi + off : hi, ok ? 16 : 0);
      if (f & MID)
        cp_async16(dst + PLANE + sw(r, 8 * q), ok ? mid + off : mid,
                   ok ? 16 : 0);
      if (f & LO)
        cp_async16(dst + 2 * PLANE + sw(r, 8 * q), ok ? lo + off : lo,
                   ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nst) load(c);
    cp_commit();
  }
  for (int c = 0; c < nst; ++c) {
    cp_wait<NS - 2>();
    __syncthreads();     // stage c is in; every warp is past stage c - 1
    if (c + NS - 1 < nst) load(c + NS - 1);
    cp_commit();
    if (!live) continue;
    const int f = terms(c);
    const bool wm = f & MID, wl = f & LO;
    const __nv_bfloat16* ph = smem + (c % NS) * PL * PLANE;
    const __nv_bfloat16* pm = ph + PLANE;
    const __nv_bfloat16* pl = ph + 2 * PLANE;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
#pragma unroll
      for (int n0 = 0; n0 < 2; n0 += NPB) {
        uint32_t bh[NPB][4], bm[NPB][4], bl[NPB][4];
#pragma unroll
        for (int q = 0; q < NPB; ++q) {
          const int r = brow + wc * 32 + (n0 + q) * 16 + (lane & 7) +
                        ((lane >> 4) << 3);
          const int k = 16 * ks + (((lane >> 3) & 1) << 3);
          ldsm_x4(bh[q], ph + sw(r, k));
          if (wm) ldsm_x4(bm[q], pm + sw(r, k));
          if (wl) ldsm_x4(bl[q], pl + sw(r, k));
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = wr * 64 + mt * 16 + (lane & 15);
          const int k = 16 * ks + ((lane >> 4) << 3);
          uint32_t ah[4], am[4], al[4];
          ldsm_x4(ah, ph + sw(r, k));
          if (wm) ldsm_x4(am, pm + sw(r, k));
          if (wl) ldsm_x4(al, pl + sw(r, k));
#pragma unroll
          for (int u = 0; u < 2 * NPB; ++u) {
            const int nt = 2 * n0 + u, q = u >> 1, h = (u & 1) * 2;
            // The k-step's products start from zero, the smallest first,
            // and are added to the block's sums by a float32 add.
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            if (wm) mma(p, am, bm[q][h], bm[q][h + 1]);
            if (wl) {
              mma(p, ah, bl[q][h], bl[q][h + 1]);
              mma(p, al, bh[q][h], bh[q][h + 1]);
            }
            if (wm) {
              mma(p, ah, bm[q][h], bm[q][h + 1]);
              mma(p, am, bh[q][h], bh[q][h + 1]);
            }
            mma(p, ah, bh[q][h], bh[q][h + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
          }
        }
      }
    }
  }
}

// One tile (blockIdx.x: the ti <= tj tiles in order), one slice of W
// (blockIdx.y), one block of the stack (blockIdx.z), from the packed
// planes; F32: the input has mid and lo planes.  A float32 block whose
// slice has no non-zero mid or lo (0/1 data) takes the ring of hi stages:
// the same sums, bit for bit, since the products it leaves out are zeros.
// `out` is G (one slice) or the partials (slices, D, M, M).
template <bool F32>
__global__ void __launch_bounds__(THREADS, 2)
gram_kernel(const __nv_bfloat16* __restrict__ hi,
            const __nv_bfloat16* __restrict__ mid,
            const __nv_bfloat16* __restrict__ lo,
            const int* __restrict__ flags, float* __restrict__ out, int m,
            int wp, int slice_cols, int tiles, int nstg) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];

  const int t = blockIdx.x;
  int tj = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (tj * (tj + 1) / 2 > t) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  const int ti = t - tj * (tj + 1) / 2;
  const int s = blockIdx.y, d = blockIdx.z;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const bool diag = ti == tj;
  const int k_lo = s * slice_cols;
  const int k_hi = min(wp, k_lo + slice_cols);
  const int nst = (k_hi - k_lo) / KC;
  const int g0 = k_lo / KC;                  // global stage of stage 0
  const long long row0 = (long long)d * m;
  const int* fi = flags + ((long long)d * tiles + ti) * nstg + g0;
  const int* fj = flags + ((long long)d * tiles + tj) * nstg + g0;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  bool all = false;
  if constexpr (F32) {
    int any = 0;
    for (int c = threadIdx.x; c < nst; c += THREADS) any |= fi[c] | fj[c];
    all = __syncthreads_or(any) != 0;
  }
  if (all)
    tile_sums<3, ALL_STAGES>(acc, smem, hi, mid, lo, fi, fj, row0, m, wp, i0,
                             j0, k_lo, nst, diag);
  else
    tile_sums<1, HI_STAGES>(acc, smem, hi, mid, lo, fi, fj, row0, m, wp, i0,
                            j0, k_lo, nst, diag);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  float* gd = out + ((long long)s * gridDim.z + d) * m * m;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wr * 64 + mt * 16 + g + 8 * (e >> 1);
        const int j = j0 + wc * 32 + nt * 8 + 2 * tq + (e & 1);
        if (i >= m || j >= m || (diag && i > j)) continue;
        gd[(long long)i * m + j] = acc[mt][nt][e];
        if (i != j) gd[(long long)j * m + i] = acc[mt][nt][e];
      }
}

// G = sum of the partials in slice order, one element per thread.
__global__ void sum_slices(const float* __restrict__ part,
                           float* __restrict__ out, long long n, int slices) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float v = part[e];
    for (int s = 1; s < slices; ++s) v += part[s * n + e];
    out[e] = v;
  }
}

template <typename T>
int launch(const void* a, void* out, void* part, void* hi, void* mid,
           void* lo, void* flags, int d, int m, int w, int slices,
           int slice_cols, cudaStream_t stream) {
  if (d <= 0 || m <= 0) return 0;
  constexpr int PL = sizeof(T) == 4 ? 3 : 1;
  const int nstg = (w + KC - 1) / KC;
  const int wp = nstg * KC;
  const int tiles = (m + TILE - 1) / TILE;
  if (w < 0 || slices < 1 || slices > 65535 || d > 65535 ||
      slice_cols <= 0 || slice_cols % KC != 0 ||
      (long long)slices * slice_cols < wp ||
      (slices > 1 && ((long long)(slices - 1) * slice_cols >= wp ||
                      part == nullptr)) ||
      (wp > 0 && (hi == nullptr || flags == nullptr ||
                  (PL == 3 && (mid == nullptr || lo == nullptr)))) ||
      reinterpret_cast<uintptr_t>(hi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mid) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lo) % 16 != 0)
    return (int)cudaErrorInvalidValue;     // the wrapper's plan keeps these
  if (wp > 0) {
    dim3 pg(d * m, (wp + PACK_COLS - 1) / PACK_COLS);
    pack_kernel<T><<<pg, 256, 0, stream>>>(
        static_cast<const T*>(a), static_cast<__nv_bfloat16*>(hi),
        static_cast<__nv_bfloat16*>(mid), static_cast<__nv_bfloat16*>(lo),
        static_cast<int*>(flags), m, w, wp, tiles, nstg);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem =
      (PL == 3 && 3 * ALL_STAGES > HI_STAGES ? 3 * ALL_STAGES : HI_STAGES) *
      PLANE * 2;
  auto kern = gram_kernel<PL == 3>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  float* dst = static_cast<float*>(slices > 1 ? part : out);
  kern<<<dim3(tiles * (tiles + 1) / 2, slices, d), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hi),
      static_cast<const __nv_bfloat16*>(mid),
      static_cast<const __nv_bfloat16*>(lo), static_cast<const int*>(flags),
      dst, m, wp, slice_cols, tiles, nstg);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long long n = (long long)d * m * m;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  sum_slices<<<blocks, 256, 0, stream>>>(dst, static_cast<float*>(out), n,
                                         slices);
  return (int)cudaGetLastError();
}

}  // namespace


// a: (D, M, W) contiguous f32 / bf16; out: (D, M, M) contiguous f32, every
// element written; hi (and mid, lo for f32): (D, M, Wp) bf16 scratch, Wp =
// W rounded up to a multiple of 32, 16-byte aligned; flags: (D, ceil(M /
// 128), Wp / 32) int32 scratch, zeroed; part: (slices, D, M, M) f32 scratch
// when slices > 1, else unused.  W is cut into `slices` slices of
// `slice_cols` columns (a multiple of 32; the last slice may be shorter).
// Returns cudaGetLastError() of the launches.
extern "C" int ranky_blockgram_f32(const void* a, void* out, void* part,
                                   void* hi, void* mid, void* lo, void* flags,
                                   int d, int m, int w, int slices,
                                   int slice_cols, void* stream) {
  return launch<float>(a, out, part, hi, mid, lo, flags, d, m, w, slices,
                       slice_cols, static_cast<cudaStream_t>(stream));
}

extern "C" int ranky_blockgram_bf16(const void* a, void* out, void* part,
                                    void* hi, void* mid, void* lo,
                                    void* flags, int d, int m, int w,
                                    int slices, int slice_cols,
                                    void* stream) {
  return launch<__nv_bfloat16>(a, out, part, hi, mid, lo, flags, d, m, w,
                               slices, slice_cols,
                               static_cast<cudaStream_t>(stream));
}
