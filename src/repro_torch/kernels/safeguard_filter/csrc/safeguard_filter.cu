// Safeguard-filter kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/safeguard_filter/kernel.py:
//   * pairwise_sqdist_kernel / _gram_kernel          (B1): the (m, m) squared
//     distances of an (m, d) buffer, via its Gram matrix;
//   * fused_accumulate_sqdist_kernel / _fused_kernel (B2): the windowed
//     accumulate-and-reset  new = (reset ? 0 : acc) + g * scale, written in
//     place over acc, plus the (m, m) squared distances of new.
//
// What bounds them on an H100: device memory.  The safeguard runs them with
// m ~ 10 rows and d ~ 2e8 columns, so the Gram does about m/2 multiply-adds
// per byte read, far below the card's float32 balance.  B1 reads m*d
// elements once; B2 reads acc and g and writes new once.
//
// What the design does about it:
//   * the TPU grid walked d-tiles in order into one (m, m) VMEM scratch.
//     Here every block walks a contiguous range of d in tiles of TILE_D
//     columns and keeps its own partial sums, so all SMs stream at once;
//     a second one-block kernel adds the per-block partials in a fixed
//     order (split-K in two stages, no atomics: the same inputs give the
//     same bits on every run, so eviction decisions do not change from run
//     to run);
//   * each tile is read from device memory once, coalesced along d (the
//     fused kernel also writes new back in the same pass) and staged in
//     shared memory; the m(m+1)/2 products are IEEE float32 FMAs on the
//     CUDA cores (no TF32: the filter thresholds these distances), read
//     from shared memory four columns at a time;
//   * offsets are 64-bit (m * d exceeds 2^31 at full width), and the ragged
//     last tile is masked in the kernel instead of padding a copy.
//
// Every entry point returns cudaGetLastError() after its launches; the
// Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE_D = 128;              // columns staged per tile
constexpr int STRIDE = TILE_D + 4;       // shared row stride (16-byte rows, no bank conflicts)
constexpr int THREADS = 256;
constexpr int MAX_M = 64;
constexpr int MAX_PAIRS_PER_THREAD = (MAX_M * (MAX_M + 1) / 2 + THREADS - 1) / THREADS;  // 9
constexpr int MAX_GROUPS = TILE_D / 4;   // one float4 column group at least

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Pairs (i <= j) are split over the block: with P <= THREADS pairs, the
// block holds `groups` copies of the pair set, each over its own slice of
// the tile's columns; with more pairs, each thread takes several.
struct PairPlan {
    int P, groups, cols;     // pair count, column groups, columns per group
};

__host__ __device__ inline PairPlan plan_pairs(int m) {
    PairPlan pl;
    pl.P = m * (m + 1) / 2;
    int g = 1;
    while (pl.P <= THREADS && g * 2 * pl.P <= THREADS && g * 2 <= MAX_GROUPS) g *= 2;
    pl.groups = g;
    pl.cols = TILE_D / g;
    return pl;
}

__device__ inline void pair_of(int p, int m, int* i, int* j) {
    int row = 0, left = p;
    while (left >= m - row) { left -= m - row; ++row; }
    *i = row;
    *j = row + left;
}

// Stage 1: block b walks tiles [b * tiles_per_block, ...) of the columns and
// writes its (m, m) partial Gram into partial[b].  FUSED also applies the
// accumulate-and-reset to each element it reads and stores it back.
template <typename T, bool FUSED>
__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const T* __restrict__ a, float* acc, const float* __restrict__ g,
                    const int* __restrict__ reset_ptr, const float* __restrict__ scale_ptr,
                    int m, int64_t d, int64_t tiles_per_block, int64_t ntiles,
                    float* __restrict__ partial) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const int tid = threadIdx.x;
    const PairPlan pl = plan_pairs(m);

    bool do_reset = false;
    float scale = 0.f;
    if (FUSED) {
        do_reset = (*reset_ptr != 0);
        scale = *scale_ptr;
    }

    int group, pi[MAX_PAIRS_PER_THREAD], pj[MAX_PAIRS_PER_THREAD];
    bool active[MAX_PAIRS_PER_THREAD];
    float accum[MAX_PAIRS_PER_THREAD];
    if (pl.P <= THREADS) {
        group = tid / pl.P;
    } else {
        group = 0;
    }
#pragma unroll
    for (int q = 0; q < MAX_PAIRS_PER_THREAD; ++q) {
        int p = (pl.P <= THREADS) ? (q == 0 ? tid % pl.P : pl.P) : tid + q * THREADS;
        active[q] = (p < pl.P) && (group < pl.groups);
        pi[q] = pj[q] = 0;
        if (active[q]) pair_of(p, m, &pi[q], &pj[q]);
        accum[q] = 0.f;
    }

    const int64_t t_begin = (int64_t)blockIdx.x * tiles_per_block;
    int64_t t_end = t_begin + tiles_per_block;
    if (t_end > ntiles) t_end = ntiles;

    for (int64_t t = t_begin; t < t_end; ++t) {
        const int64_t k0 = t * TILE_D;
        for (int e = tid; e < m * TILE_D; e += THREADS) {
            const int r = e / TILE_D, c = e % TILE_D;
            const int64_t k = k0 + c;
            float v = 0.f;
            if (k < d) {
                const int64_t off = (int64_t)r * d + k;
                if (FUSED) {
                    // select, never a multiply: an inf/NaN accumulator of a
                    // Byzantine row must vanish at the window reset
                    const float kept = do_reset ? 0.f : acc[off];
                    v = __fadd_rn(kept, __fmul_rn(g[off], scale));
                    acc[off] = v;
                } else {
                    v = to_f32(a[off]);
                }
            }
            s[r * STRIDE + c] = v;
        }
        __syncthreads();
        const int c4_begin = group * (pl.cols / 4), c4_n = pl.cols / 4;
#pragma unroll
        for (int q = 0; q < MAX_PAIRS_PER_THREAD; ++q) {
            if (!active[q]) continue;
            const float4* ri = smem4 + (pi[q] * STRIDE) / 4 + c4_begin;
            const float4* rj = smem4 + (pj[q] * STRIDE) / 4 + c4_begin;
            float sum = accum[q];
            for (int c4 = 0; c4 < c4_n; ++c4) {
                const float4 x = ri[c4], y = rj[c4];
                sum = fmaf(x.x, y.x, sum);
                sum = fmaf(x.y, y.y, sum);
                sum = fmaf(x.z, y.z, sum);
                sum = fmaf(x.w, y.w, sum);
            }
            accum[q] = sum;
        }
        __syncthreads();
    }

    // reduce the column groups in a fixed order, then write both triangles
    float* red = s;   // groups * P floats (fits: see smem_bytes)
#pragma unroll
    for (int q = 0; q < MAX_PAIRS_PER_THREAD; ++q) {
        if (!active[q]) continue;
        const int p = (pl.P <= THREADS) ? tid % pl.P : tid + q * THREADS;
        red[group * pl.P + p] = accum[q];
    }
    __syncthreads();
    float* out = partial + (int64_t)blockIdx.x * m * m;
    for (int p = tid; p < pl.P; p += THREADS) {
        float v = 0.f;
        for (int gi = 0; gi < pl.groups; ++gi) v += red[gi * pl.P + p];
        int i, j;
        pair_of(p, m, &i, &j);
        out[i * m + j] = v;
        out[j * m + i] = v;
    }
}

// Stage 2: add the per-block partials in block order, then expand the
// diagonal: sqdist = max(G_ii + G_jj - 2 G_ij, 0) (NaN passes through, as
// in the plain version's clamp).
__global__ void __launch_bounds__(1024)
sqdist_finish_kernel(const float* __restrict__ partial, int nblocks, int m,
                     float* __restrict__ out) {
    extern __shared__ float gram[];
    const int mm = m * m;
    for (int e = threadIdx.x; e < mm; e += blockDim.x) {
        float v = 0.f;
        for (int b = 0; b < nblocks; ++b) v += partial[(int64_t)b * mm + e];
        gram[e] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < mm; e += blockDim.x) {
        const int i = e / m, j = e % m;
        const float x = __fsub_rn(__fadd_rn(gram[i * m + i], gram[j * m + j]),
                                  __fmul_rn(2.f, gram[e]));
        out[e] = (x < 0.f) ? 0.f : x;
    }
}

size_t stage1_smem_bytes(int m) {
    const PairPlan pl = plan_pairs(m);
    size_t tile = (size_t)m * STRIDE;
    size_t red = (size_t)pl.groups * pl.P;
    return 4 * (tile > red ? tile : red);
}

template <typename T, bool FUSED>
int launch(const T* a, float* acc, const float* g, const int* reset, const float* scale,
           int64_t m, int64_t d, float* partial, int nblocks, float* out, cudaStream_t stream) {
    if (m < 1 || m > MAX_M || d < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
    const int64_t ntiles = (d + TILE_D - 1) / TILE_D;
    const int64_t per = (ntiles + nblocks - 1) / nblocks;
    const size_t smem = stage1_smem_bytes((int)m);
    gram_partial_kernel<T, FUSED><<<nblocks, THREADS, smem, stream>>>(
        a, acc, g, reset, scale, (int)m, d, per, ntiles, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sqdist_finish_kernel<<<1, 1024, (size_t)m * m * 4, stream>>>(partial, nblocks, (int)m, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (m, d) row-major, dtype 0 = float32, 1 = bfloat16.  partial: nblocks*m*m
// float32 scratch.  out: (m, m) float32.
int sf_pairwise_sqdist(const void* a, int dtype, int64_t m, int64_t d, void* partial,
                       int nblocks, void* out, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float, false>(static_cast<const float*>(a), nullptr, nullptr, nullptr,
                                    nullptr, m, d, static_cast<float*>(partial), nblocks,
                                    static_cast<float*>(out), st);
    if (dtype == 1)
        return launch<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(a), nullptr,
                                            nullptr, nullptr, nullptr, m, d,
                                            static_cast<float*>(partial), nblocks,
                                            static_cast<float*>(out), st);
    return (int)cudaErrorInvalidValue;
}

// acc, g: (m, d) float32 row-major; acc is updated in place.  reset: one
// int32 on the device; scale: one float32 on the device.
int sf_fused_accumulate_sqdist(void* acc, const void* g, const void* reset, const void* scale,
                               int64_t m, int64_t d, void* partial, int nblocks, void* out,
                               void* stream) {
    return launch<float, true>(nullptr, static_cast<float*>(acc), static_cast<const float*>(g),
                               static_cast<const int*>(reset), static_cast<const float*>(scale),
                               m, d, static_cast<float*>(partial), nblocks,
                               static_cast<float*>(out), reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
