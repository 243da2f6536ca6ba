// sketch_panel: out[d, l, c] = sum_k Omega[l, rows[d, c, k]] * vals[d, c, k]
// (Omega E_d restricted to the stored columns of every padded-ELL block).
//
// Replaces the TPU kernel src/repro/kernels/sketch_panel.py
// (_sketch_panel_kernel / sketch_panel), which expands each ELL tile into
// a dense (block_m, block_c) one-hot panel per M tile and feeds the
// matrix unit over a (C tiles, M tiles) grid.  Here the gather form is
// the natural one: no one-hot expansion and no grid axis over M.
//
// What bounds it on an H100: bytes.  Two operations per (slot, l) pair
// against one gathered 4-byte Omega value each; L is a few tens, so the
// gathers of Omega rows dominate.
//
// Design: the wrapper passes Omega TRANSPOSED and contiguous, (M, L), so
// that the 32 threads of a warp (consecutive l) read one contiguous
// vector per slot.  A thread block owns a 32 (l) x 32 (c) output tile;
// each thread walks the K slots of its columns in order, so the sum has
// a fixed order and the result is deterministic.  The tile is turned
// through shared memory so that the store runs along c, the contiguous
// axis of the (D, L, C) output.  Val-0 slots are skipped (their row index
// is not read into Omega), duplicates add.
//
// Precondition: every slot whose value is non-zero holds a row index in
// [0, M) (checked on the host when a container is built,
// sparse.check_ell_arrays).  A slot that breaks it traps the kernel: the
// next synchronization raises, as the plain version's index_select does.
#include <cuda_runtime.h>

namespace {

constexpr int TL = 32;       // l values per tile (one warp wide)
constexpr int TC = 32;       // stored columns per tile
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sketch_panel_kernel(const float* __restrict__ omega_t,
                    const int* __restrict__ rows,
                    const float* __restrict__ vals,
                    float* __restrict__ out,
                    int l_total, int m, int c, int k) {
    __shared__ float tile[TL][TC + 1];

    const int d = blockIdx.z;
    const int l0 = blockIdx.y * TL;
    const int c0 = blockIdx.x * TC;
    const int x = threadIdx.x % 32;
    const int y = threadIdx.x / 32;          // 0..7

    const int l = l0 + x;
    for (int cc = y; cc < TC; cc += THREADS / 32) {
        const int col = c0 + cc;
        float acc = 0.0f;
        if (col < c && l < l_total) {
            const size_t base = ((size_t)d * c + col) * k;
            for (int s = 0; s < k; ++s) {
                const float v = vals[base + s];
                if (v == 0.0f) continue;
                const int r = rows[base + s];
                if (r < 0 || r >= m) __trap();   // precondition broken
                acc = fmaf(omega_t[(size_t)r * l_total + l], v, acc);
            }
        }
        tile[x][cc] = acc;
    }
    __syncthreads();

    // x now runs along c: coalesced stores.
    const int col = c0 + x;
    if (col >= c) return;
    for (int ll = y; ll < TL; ll += THREADS / 32) {
        const int lo = l0 + ll;
        if (lo < l_total)
            out[((size_t)d * l_total + lo) * c + col] = tile[ll][x];
    }
}

}  // namespace

// omega_t: (M, L) contiguous f32 (Omega transposed); rows, vals: (D, C, K)
// contiguous; out: (D, L, C) contiguous f32, every element written.
// Returns cudaGetLastError() of the launch.
extern "C" int ranky_sketch_panel(const void* omega_t, const void* rows,
                                  const void* vals, void* out, int d,
                                  int l, int m, int c, int k, void* stream) {
    if (d <= 0 || l <= 0 || c <= 0) return 0;
    dim3 grid((c + TC - 1) / TC, (l + TL - 1) / TL, d);
    sketch_panel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)omega_t, (const int*)rows, (const float*)vals,
        (float*)out, l, m, c, k);
    return (int)cudaGetLastError();
}
