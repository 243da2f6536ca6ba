// sparse_gram: G[d] = E_d E_d^T of every padded-ELL block, in f32.
//
// Replaces the TPU kernel src/repro/kernels/sparse_gram.py
// (_sparse_gram_kernel / sparse_gram).  That kernel expands each tile of
// stored columns into a dense (M, block_c) panel and feeds the matrix
// unit, with the whole (M, M) accumulator resident on the core across a
// sequential grid.  Neither carries over: no SM holds an (M, M) f32
// accumulator once M reaches about 240, and the panel is >99.9% zeros at
// the paper's density.
//
// What bounds it on an H100: bytes.  The work is sum_c nnz_c^2 multiply-
// adds (a few per stored column), against D*M*M*4 bytes of output that
// must be written and 8 bytes per ELL slot that must be read.
//
// Design: the nnz-proportional form.  One thread owns one stored column
// (d, c), reads its K slots and, for every ordered pair of slots (a, b)
// whose values are both non-zero, adds v_a * v_b to G[d, r_a, r_b] with
// an f32 atomicAdd into an output the wrapper has zeroed.  Duplicate
// (column, row) slots add and val-0 padding slots drop out by
// construction.  Plain f32 FMAs: no tensor cores, no TF32.
//
// Determinism: atomics make the order of the sum vary from run to run.
// For 0/1 matrices (the paper's) every partial sum is a small integer,
// exactly representable, so the result is bit-stable; for weighted
// matrices it is reproducible only to f32 rounding and is compared at a
// tolerance.
//
// Precondition: every slot whose value is non-zero holds a row index in
// [0, M).  The containers check it on the host when they are built
// (sparse.check_ell_arrays); a slot that breaks it traps the kernel, so
// the next synchronization raises instead of returning a wrong gram (the
// plain version's scatter_add_ fails on the same input).
#include <cuda_runtime.h>

namespace {

__global__ void sparse_gram_kernel(const int* __restrict__ rows,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out,
                                   int c, int k, int m) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int d = blockIdx.y;
    if (col >= c) return;
    const size_t base = ((size_t)d * c + col) * k;
    const int* r = rows + base;
    const float* v = vals + base;
    float* g = out + (size_t)d * m * m;
    for (int a = 0; a < k; ++a) {
        const float va = v[a];
        if (va == 0.0f) continue;
        const int ra = r[a];
        if (ra < 0 || ra >= m) __trap();  // precondition broken: fail loudly
        float* grow = g + (size_t)ra * m;
        for (int b = 0; b < k; ++b) {
            const float vb = v[b];
            if (vb == 0.0f) continue;
            const int rb = r[b];
            if (rb < 0 || rb >= m) __trap();
            atomicAdd(grow + rb, va * vb);
        }
    }
}

}  // namespace

// rows, vals: (D, C, K) contiguous; out: (D, M, M) contiguous, zeroed by
// the caller.  Returns cudaGetLastError() of the launch.
extern "C" int ranky_sparse_gram(const void* rows, const void* vals,
                                 void* out, int d, int c, int k, int m,
                                 void* stream) {
    if (d <= 0 || c <= 0 || k <= 0 || m <= 0) return 0;
    const int threads = 128;
    dim3 grid((c + threads - 1) / threads, d);
    sparse_gram_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int*)rows, (const float*)vals, (float*)out, c, k, m);
    return (int)cudaGetLastError();
}
