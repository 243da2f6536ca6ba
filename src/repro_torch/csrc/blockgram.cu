// blockgram: G[d] = A_d A_d^T for a stack of short-and-fat dense blocks,
// f32 accumulation, f32 or bf16 input.
//
// Replaces the TPU kernel src/repro/kernels/blockgram.py (_gram_kernel /
// blockgram), which streams (M, block_n) column panels and keeps the whole
// (M, M) accumulator on the core across a sequential grid.  On Hopper the
// blocks of a grid run in parallel and none can hold (M, M), so the
// OUTPUT is tiled instead: one thread block owns one 64 x 64 tile of
// G[d], loops over the W columns in chunks of 32 staged through shared
// memory (the next chunk's global reads are issued into registers before
// the current chunk is multiplied), and keeps its 4 x 4 per-thread
// sub-tile in f32 registers.
//
// What bounds it on an H100: operations.  G is symmetric, so the function
// needs M*(M+1)*W f32 operations per block (a multiply and an add for each
// entry on or above the diagonal) against M*W*4 bytes read: at M = 539
// that is about 135 operations per byte, far above the card's f32 ridge
// (about 20).
//
// Design notes: the product is the kernel's own body (no cuBLAS).  Plain
// f32 FMAs keep the gram exact enough for eigh + sqrt; bf16 input is
// converted on load and accumulated in f32.  Ragged edges (M not a
// multiple of 64, W not a multiple of 32) are masked with zeros on load
// and skipped on store, so the wrapper pads nothing.  The sum over W runs
// in a fixed order inside one block (no split over W, no atomics), so the
// result is deterministic.  G is symmetric, so only the tiles on or above
// the diagonal are computed and each is stored twice, as itself and
// mirrored: G[j, i] gets the very float G[i, j] got, which halves the work
// and keeps the gram exactly symmetric.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // output tile edge
constexpr int CHUNK = 32;     // columns of A staged per step
constexpr int THREADS = 256;
constexpr int LD = TILE + 4;  // shared row stride: keeps float4 reads aligned
constexpr int LOADS = TILE * CHUNK / THREADS;  // values a thread stages per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blockgram_kernel(const T* __restrict__ a, float* __restrict__ out,
                 int m, int w) {
    if (blockIdx.x < blockIdx.y) return;  // below the diagonal: mirrored
    // Stored transposed ([k][row]) so that the inner product reads four
    // consecutive rows as one float4.
    __shared__ __align__(16) float tile_i[CHUNK][LD];
    __shared__ __align__(16) float tile_j[CHUNK][LD];

    const int d = blockIdx.z;
    const int row0 = blockIdx.y * TILE;   // rows of G
    const int col0 = blockIdx.x * TILE;   // columns of G (= rows of A)
    const bool diag = blockIdx.x == blockIdx.y;
    const T* ad = a + (size_t)d * m * w;

    // Compute mapping: a 4 x 4 sub-tile per thread.
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    // Staging mapping: a warp covers 8 columns x 4 rows, so that its global
    // reads are four 32-byte runs and its shared stores hit 32 banks
    // (bank = (4 k + row) mod 32 with the stride of 68).
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int kl = (warp % 4) * 8 + lane % 8;     // column within the chunk
    const int rl = (warp / 4) * 4 + lane / 8;     // row, plus 8 per load

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    float ri[LOADS], rj[LOADS];
    auto fetch = [&](int k0) {
        const int kk = k0 + kl;
#pragma unroll
        for (int t = 0; t < LOADS; ++t) {
            const int r = rl + 8 * t;
            const int gi = row0 + r;
            ri[t] = (gi < m && kk < w) ? to_f32(ad[(size_t)gi * w + kk]) : 0.0f;
            if (diag) {
                rj[t] = ri[t];
            } else {
                const int gj = col0 + r;
                rj[t] = (gj < m && kk < w)
                    ? to_f32(ad[(size_t)gj * w + kk]) : 0.0f;
            }
        }
    };

    fetch(0);
    for (int k0 = 0; k0 < w; k0 += CHUNK) {
#pragma unroll
        for (int t = 0; t < LOADS; ++t) {
            tile_i[kl][rl + 8 * t] = ri[t];
            tile_j[kl][rl + 8 * t] = rj[t];
        }
        __syncthreads();
        // The next chunk's global reads fly while this one is multiplied.
        if (k0 + CHUNK < w) fetch(k0 + CHUNK);
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            const float4 a4 = *reinterpret_cast<const float4*>(&tile_i[k][ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&tile_j[k][tx * 4]);
            const float ai[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bj[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* gd = out + (size_t)d * m * m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gi = row0 + ty * 4 + i;
        if (gi >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gj = col0 + tx * 4 + j;
            if (gj >= m) continue;
            gd[(size_t)gi * m + gj] = acc[i][j];
            if (!diag) gd[(size_t)gj * m + gi] = acc[i][j];
        }
    }
}

template <typename T>
int launch(const void* a, void* out, int d, int m, int w, void* stream) {
    if (d <= 0 || m <= 0) return 0;
    const int tiles = (m + TILE - 1) / TILE;
    dim3 grid(tiles, tiles, d);
    blockgram_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)a, (float*)out, m, w);
    return (int)cudaGetLastError();
}

}  // namespace

// a: (D, M, W) contiguous f32 / bf16; out: (D, M, M) contiguous f32,
// every element written.  Returns cudaGetLastError() of the launch.
extern "C" int ranky_blockgram_f32(const void* a, void* out, int d, int m,
                                   int w, void* stream) {
    return launch<float>(a, out, d, m, w, stream);
}

extern "C" int ranky_blockgram_bf16(const void* a, void* out, int d, int m,
                                    int w, void* stream) {
    return launch<__nv_bfloat16>(a, out, d, m, w, stream);
}
