// sketch_panel: out[d, l, c] = sum_k Omega_d[l, rows[d, c, k]] * vals[d, c, k]
// (Omega_d E_d restricted to the stored columns of every padded-ELL block),
// with one Omega shared by every block or one Omega_d per block (the power
// passes of the hierarchical tree's sketch leaves, whose Q_d differ).
//
// Replaces the TPU kernel src/repro/kernels/sketch_panel.py
// (_sketch_panel_kernel / sketch_panel), which expands each ELL tile into
// a dense (block_m, block_c) one-hot panel per M tile and feeds the
// matrix unit over a (C tiles, M tiles) grid.  Here the gather form is
// the natural one: no one-hot expansion and no grid axis over M.
//
// What bounds it on an H100: at the paper's shape, latency (46,007
// non-zero slots: a few gathers a thread, against 5.5 MB moved); where
// Omega is large (32,768 x 64 floats), the L2 traffic of the gathers (one
// 4 L-byte vector per non-zero slot, 1.1 GB at that shape) above the bytes
// of the inputs and output.
//
// Design.
// * Tiles.  The D x C stored columns are taken as one flat sequence, cut
//   into tiles of TC columns (TC <= 64; fewer when K or L is large).  A
//   block covers all of L (grid.y splits L only above 8,192 / (TC + 1)
//   values), so each slot is read once.  Blocks are persistent: a block
//   walks a contiguous run of tiles.
// * Slot staging.  A tile's rows and vals are one contiguous run of TC x K
//   elements in each array.  They reach shared memory through a ring of
//   `cp.async` stages (two to eight tiles ahead): 16-byte copies where the
//   run's 16-byte pieces lie inside the array and the array is aligned,
//   4-byte copies at its ends (at the paper's K = 5 the runs are odd).  A
//   column with more than STAGE_SLOTS slots is taken in pieces of
//   STAGE_SLOTS slots; its sums go on across the pieces.
// * Omega.  A slot's L-vector is gathered from L2 with 16-byte loads along
//   l (4-byte loads where L is not a multiple of 4), out of an
//   (M, L)-contiguous array, through Omega's strides:
//   - Omega's own memory when it comes as the transpose of an
//     (M, L)-contiguous tensor;
//   - when it comes (L, M)-contiguous, a workspace that the kernel fills
//     itself first (32 x 32 tiles through shared memory), behind a grid
//     barrier (a cooperative launch, all blocks resident), so that the
//     call stays one launch.  Both callers in the solver pass an
//     (L, M)-contiguous Omega (draw_omega, and q.T of the power passes,
//     whose QR factor is column-major): each of their calls transposes
//     Omega in the kernel (51.7 KB at the paper's shape, 8.4 MB at 32,768
//     x 64).
//   - Only an Omega contiguous in neither layout is copied by the wrapper
//     first (a second launch).
//   A per-block Omega_d is read the same way, at its block's offset: the
//   column's block is known from its place in the flat sequence.
//   Staging the paper's 51.7 KB Omega whole in each block's shared memory
//   was measured slower than these gathers on an H100 (PERF.md) and is not
//   done.
// * Threads.  The 256 threads run over the flattened (column, l) tile
//   (l in groups of 4 where L is a multiple of 4), so no lane idles at L =
//   24, 41 or 64 but in the last round; two rounds of accumulators are
//   kept in registers, and KU slots' gathers are issued before their sums.
//   Each output element sums its slots in ascending k, one rounded
//   multiply and one rounded add a slot (__fmul_rn / __fadd_rn: no
//   contraction into FMA), as the plain version does: the result is the
//   same bits on every call and equals the plain version's.  Val-0 slots
//   are skipped (their row is not read); duplicate slots add.
// * Store.  The tile's (L, TC) panel is turned through shared memory so
//   that the stores run along c, the contiguous axis of the output.
//
// Precondition: every slot whose value is non-zero holds a row index in
// [0, M) (checked on the host when a container is built,
// sparse.check_ell_arrays).  A slot that breaks it traps the kernel: the
// next synchronization raises, as the plain version's index_select does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TC_MAX = 64;          // stored columns per tile
constexpr int STAGE_SLOTS = 1152;   // slots per ring stage (32 x 36)
constexpr int RING_BYTES = 24 * 1024;
constexpr int RING_MAX = 8;
constexpr int OUT_FLOATS = 8192;    // (lc, TC + 1) output tile, 32 KB
constexpr int ROUNDS = 2;           // rounds of accumulators in registers
constexpr int KU = 4;               // slots whose gathers are in flight
constexpr int TR = 32;              // transpose tile edge

enum Mode { GATHER = 0, TRANSPOSE = 1 };

struct Args {
  const float* omega;     // (OD, L, M) through its strides
  long long s_d, s_l, s_m;
  const int* rows;        // (D, C, K) contiguous
  const float* vals;
  float* out;             // (D, L, C) contiguous
  float* ws;              // (OD, M, L) workspace of the TRANSPOSE mode
  const float* src;       // (OD, M, L) arrays gathered from, (M, L)-contiguous
  long long src_d;        // elements between two blocks' arrays (0: shared)
  int od;                 // 1 (one Omega for every block) or D
  int d, l, m, c, k;
  int mode, tc, kc, np, lc, ring, stage, out_elems, tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}
// Wait until at most n groups are in flight (n < RING_MAX).
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n"); break;
    default: asm volatile("cp.async.wait_group 7;\n"); break;
  }
}

// Piece i of the block's run: tile t (first column q0, ncols columns) and
// slots [k0, k0 + kn) of each column; its slots are the contiguous run
// [start, start + n) of rows / vals.
struct Piece {
  int t, j, ncols, kn;
  long long q0, start, n;
};

__device__ __forceinline__ Piece piece_of(const Args& a, int t0, int i) {
  Piece p;
  p.t = t0 + i / a.np;
  p.j = i % a.np;
  p.q0 = (long long)p.t * a.tc;
  const long long q_total = (long long)a.d * a.c;
  p.ncols = (int)min((long long)a.tc, q_total - p.q0);
  const int k0 = p.j * a.kc;
  p.kn = min(a.kc, a.k - k0);
  p.start = p.q0 * a.k + k0;
  p.n = a.np == 1 ? (long long)p.ncols * a.k : p.kn;
  return p;
}

// Copy elements [start & ~3, start + n) of rows / vals into a ring stage;
// element start + x lands at index (start & 3) + x.
__device__ __forceinline__ void stage_run(const Args& a, int* s_rows,
                                          float* s_vals, long long start,
                                          long long n) {
  const long long total = (long long)a.d * a.c * a.k;
  const long long a0 = start & ~3LL;
  const long long chunks = (start + n - a0 + 3) / 4;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.rows) |
        reinterpret_cast<uintptr_t>(a.vals)) & 15) == 0;
  for (long long ch = threadIdx.x; ch < chunks; ch += THREADS) {
    const long long g = a0 + 4 * ch;
    if (aligned && g + 4 <= total) {
      cp16(s_rows + 4 * ch, a.rows + g);
      cp16(s_vals + 4 * ch, a.vals + g);
    } else {
      for (int e = 0; e < 4; ++e) {
        if (g + e < total) {
          cp4(s_rows + 4 * ch + e, a.rows + g + e);
          cp4(s_vals + 4 * ch + e, a.vals + g + e);
        }
      }
    }
  }
}

// Omega_dd[l, r] for the VEC values of l from l_first on, from the (M, L)
// array of block dd.  Plain (coherent) loads: in the TRANSPOSE mode it was
// written earlier in this launch, by other blocks.
template <int VEC>
__device__ __forceinline__ void load_omega(const Args& a, int dd, int r,
                                           int l_first, float (&w)[VEC]) {
  const float* p = a.src + dd * a.src_d + (size_t)r * a.l + l_first;
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    w[0] = p[0];
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
sketch_panel_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_rows = reinterpret_cast<int*>(smem_raw);
  float* s_vals = reinterpret_cast<float*>(s_rows + a.ring * a.stage);
  float* s_out = s_vals + a.ring * a.stage;
  float* s_tr = s_out + a.out_elems;
  const int tid = threadIdx.x;
  const int l0 = blockIdx.y * a.lc;
  const int lc = min(a.lc, a.l - l0);
  const int tcp = a.tc + 1;

  if (a.mode == TRANSPOSE) {
    // Each Omega (L, M), M contiguous -> ws (M, L), 32 x 32 tiles through
    // shared memory; then every block waits for the whole array.
    const int ntl = (a.l + TR - 1) / TR, ntm = (a.m + TR - 1) / TR;
    const int per = ntl * ntm;
    const int nb = gridDim.x * gridDim.y;
    const int tx = tid % TR, ty = tid / TR;
    for (int t = blockIdx.y * gridDim.x + blockIdx.x; t < a.od * per;
         t += nb) {
      const int o = t / per, lt = (t % per) / ntm, mt = t % ntm;
      const float* om = a.omega + o * a.s_d;
      float* ws = a.ws + (size_t)o * a.m * a.l;
      for (int y = ty; y < TR; y += THREADS / TR) {
        const int ll = lt * TR + y, r = mt * TR + tx;
        if (ll < a.l && r < a.m)
          s_tr[y * (TR + 1) + tx] = om[(size_t)ll * a.s_l + r];
      }
      __syncthreads();
      for (int y = ty; y < TR; y += THREADS / TR) {
        const int r = mt * TR + y, ll = lt * TR + tx;
        if (ll < a.l && r < a.m)
          ws[(size_t)r * a.l + ll] = s_tr[tx * (TR + 1) + y];
      }
      __syncthreads();
    }
    cg::this_grid().sync();
  }

  const int t0 = (int)((long long)blockIdx.x * a.tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * a.tiles / gridDim.x);
  const int pieces = (t1 - t0) * a.np;
  for (int i = 0; i < a.ring - 1; ++i) {
    if (i < pieces) {
      const Piece p = piece_of(a, t0, i);
      stage_run(a, s_rows + (i % a.ring) * a.stage,
                s_vals + (i % a.ring) * a.stage, p.start, p.n);
    }
    cp_commit();
  }

  const int lv = lc / VEC;
  for (int i = 0; i < pieces; ++i) {
    const int nxt = i + a.ring - 1;
    if (nxt < pieces) {
      const Piece p = piece_of(a, t0, nxt);
      stage_run(a, s_rows + (nxt % a.ring) * a.stage,
                s_vals + (nxt % a.ring) * a.stage, p.start, p.n);
    }
    cp_commit();
    cp_wait(a.ring - 1);
    __syncthreads();

    const Piece p = piece_of(a, t0, i);
    const int off = (int)(p.start & 3);
    const int* sr = s_rows + (i % a.ring) * a.stage + off;
    const float* sv = s_vals + (i % a.ring) * a.stage + off;
    const int pairs = p.ncols * lv;
    for (int g0 = 0; g0 < pairs; g0 += THREADS * ROUNDS) {
      int cc[ROUNDS], lq[ROUNDS], dd[ROUNDS];
      bool ok[ROUNDS];
      float acc[ROUNDS][VEC];
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        const int q = g0 + u * THREADS + tid;
        ok[u] = q < pairs;
        cc[u] = ok[u] ? q / lv : 0;
        lq[u] = ok[u] ? q % lv : 0;
        dd[u] = a.od == 1 ? 0 : (int)((p.q0 + cc[u]) / a.c);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[u][v] = (p.j == 0 || !ok[u])
                          ? 0.0f
                          : s_out[(lq[u] * VEC + v) * tcp + cc[u]];
      }
      // KU slots at a time: every gather of the group is issued before
      // the sums, which then run in ascending k.
      for (int k0 = 0; k0 < p.kn; k0 += KU) {
        float w[KU][ROUNDS][VEC];
        float vv[KU][ROUNDS];
#pragma unroll
        for (int t = 0; t < KU; ++t) {
#pragma unroll
          for (int u = 0; u < ROUNDS; ++u) {
            vv[t][u] = 0.0f;
#pragma unroll
            for (int v = 0; v < VEC; ++v) w[t][u][v] = 0.0f;
            if (!ok[u] || k0 + t >= p.kn) continue;
            const int at = cc[u] * p.kn + k0 + t;
            const float val = sv[at];
            if (val == 0.0f) continue;
            const int r = sr[at];
            if (r < 0 || r >= a.m) __trap();   // precondition broken
            load_omega<VEC>(a, dd[u], r, l0 + lq[u] * VEC, w[t][u]);
            vv[t][u] = val;
          }
        }
#pragma unroll
        for (int t = 0; t < KU; ++t) {
#pragma unroll
          for (int u = 0; u < ROUNDS; ++u) {
            if (vv[t][u] == 0.0f) continue;
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[u][v] = __fadd_rn(acc[u][v],
                                    __fmul_rn(w[t][u][v], vv[t][u]));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          s_out[(lq[u] * VEC + v) * tcp + cc[u]] = acc[u][v];
      }
    }
    __syncthreads();

    if (p.j == a.np - 1) {
      // the tile's panel, stored along c
      const int n = lc * p.ncols;
      for (int idx = tid; idx < n; idx += THREADS) {
        const int ll = idx / p.ncols, cq = idx % p.ncols;
        const long long q = p.q0 + cq;
        const long long dd = q / a.c, col = q - dd * a.c;
        a.out[((size_t)dd * a.l + l0 + ll) * a.c + col] =
            s_out[ll * tcp + cq];
      }
    }
  }
}

template <int VEC>
cudaError_t launch(Args a, dim3 grid, size_t smem, cudaStream_t stream) {
  if (a.mode == TRANSPOSE) {
    void* params[] = {&a};
    return cudaLaunchCooperativeKernel(
        (const void*)sketch_panel_kernel<VEC>, grid, dim3(THREADS), params,
        smem, stream);
  }
  sketch_panel_kernel<VEC><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Blocks an SM at `smem` bytes of dynamic shared memory on device `dev`
// (the kernel is allowed all 227 KB first, as the occupancy query counts
// against that).  The answers are cached: the query costs more host time
// than the launch.
template <int VEC>
cudaError_t blocks_per_sm(int* n, int dev, size_t smem) {
  constexpr int SLOTS = 16;
  static int keys[SLOTS][2], vals[SLOTS], used = 0;
  static bool attr_set = false;
  for (int i = 0; i < used; ++i) {
    if (keys[i][0] == dev && keys[i][1] == (int)smem) {
      *n = vals[i];
      return cudaSuccess;
    }
  }
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        sketch_panel_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, sketch_panel_kernel<VEC>, THREADS, smem);
  if (err == cudaSuccess) {
    const int i = used < SLOTS ? used++ : 0;
    keys[i][0] = dev;
    keys[i][1] = (int)smem;
    vals[i] = *n;
  }
  return err;
}

inline int round4(long long x) { return (int)((x + 3) / 4 * 4); }

}  // namespace

// omega: od (L, M) f32 matrices with element strides (s_d, s_l, s_m): od
// is 1 (one Omega for every block; s_d is then ignored) or d (Omega_d for
// block d).  Each is contiguous in one of the two layouts: (M, L) memory
// (s_l == 1, s_m == L) is gathered from directly; (L, M) memory (s_m == 1,
// s_l == M) is first transposed by the kernel into ws, an (od, M, L) f32
// workspace, which is then required.  Any other Omega is refused
// (cudaErrorInvalidValue): the wrapper copies it first.  rows, vals:
// (D, C, K) contiguous; out: (D, L, C) contiguous f32, every element
// written.  Returns the launch's error code.
extern "C" int ranky_sketch_panel(const void* omega, long long s_d,
                                  long long s_l, long long s_m, int od,
                                  const void* rows, const void* vals,
                                  void* out, void* ws, int d, int l, int m,
                                  int c, int k, void* stream) {
  if (d <= 0 || l <= 0 || c <= 0) return 0;
  if (od != 1 && od != d) return (int)cudaErrorInvalidValue;
  Args a{};
  a.omega = (const float*)omega;
  a.od = od;
  a.s_d = od == 1 ? 0 : s_d;
  a.s_l = s_l;
  a.s_m = s_m;
  a.rows = (const int*)rows;
  a.vals = (const float*)vals;
  a.out = (float*)out;
  a.ws = (float*)ws;
  a.d = d; a.l = l; a.m = m; a.c = c; a.k = k;
  if (s_m == l && (s_l == 1 || l == 1)) {
    a.mode = GATHER;
    a.src = a.omega;
    a.src_d = a.s_d;
  } else if (s_m == 1 && s_l == m && ws != nullptr) {
    a.mode = TRANSPOSE;
    a.src = a.ws;
    a.src_d = od == 1 ? 0 : (long long)m * l;
  } else {
    return (int)cudaErrorInvalidValue;
  }

  // Tiles: TC columns, at most STAGE_SLOTS slots a stage (a column with
  // more slots is taken in pieces), an output tile of at most OUT_FLOATS.
  const int kk = k > 0 ? k : 1;
  a.tc = max(1, min(TC_MAX, STAGE_SLOTS / kk));
  a.tc = min(a.tc, max(8, OUT_FLOATS / l));
  a.kc = k > STAGE_SLOTS ? STAGE_SLOTS : kk;
  a.np = (kk + a.kc - 1) / a.kc;
  a.lc = min(l, OUT_FLOATS / (a.tc + 1));
  const bool vec_l = l % 4 == 0 && a.src_d % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(a.src) & 15) == 0;
  if (vec_l && a.lc >= 4) a.lc -= a.lc % 4;
  const bool vec = vec_l && a.lc % 4 == 0;
  a.stage = round4((long long)a.tc * a.kc + 8);
  a.ring = max(2, min(RING_MAX, RING_BYTES / (a.stage * 8)));
  a.out_elems = round4((long long)a.lc * (a.tc + 1));
  const int tr_elems = a.mode == TRANSPOSE ? TR * (TR + 1) : 0;
  const size_t smem = 4 * (2 * (size_t)a.ring * a.stage + a.out_elems
                           + tr_elems);
  const long long tiles = ((long long)d * c + a.tc - 1) / a.tc;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  const int ny = (l + a.lc - 1) / a.lc;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = vec ? blocks_per_sm<4>(&per_sm, dev, smem)
              : blocks_per_sm<1>(&per_sm, dev, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent blocks, all resident (the TRANSPOSE mode's barrier needs it)
  const long long cap = (long long)sms * per_sm;
  const int gx = (int)max(1LL, min(tiles, cap / ny));
  if ((long long)gx * ny > cap && a.mode == TRANSPOSE)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(gx, ny);
  err = vec ? launch<4>(a, grid, smem, (cudaStream_t)stream)
            : launch<1>(a, grid, smem, (cudaStream_t)stream);
  return (int)err;
}
