// Coordinate-wise robust statistics for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/robust_agg/kernel.py:
//   sorted_reduce_kernel / _sorted_reduce_kernel (B3): for each of the n
//   columns of an (m, n) float32 or bfloat16 matrix, order its m values in
//   float32 and write the median or the trimmed mean, as float32.
//
// Semantics are those of the JAX defense (core/aggregators.py, jnp.median
// and jnp.sort), bit for bit on finite inputs:
//   * median: (s[(m-1)/2] + s[m/2]) * 0.5f, the midpoint jnp.median takes
//     for odd and even m; a column holding a NaN gives NaN (the TPU kernel
//     sorts NaN last and would return a finite middle value instead);
//   * trimmed mean: NaN sorts last; ranks trim .. m-trim-1 are added in
//     rank order from 0.0f and multiplied by the float32 reciprocal of
//     their count, as XLA evaluates jnp.mean over the kept rows.  The
//     result is NaN when a NaN falls among the kept ranks.
//
// What bounds it on an H100: device memory.  Each coordinate is read once
// (m values) and written once; at m = 10 the sorting network is ~30
// compare-exchanges (two FMNMX each) per coordinate, well under the card's
// arithmetic per byte.
//
// What the design does about it (simple first; a faster version is later
// work):
//   * one thread per coordinate; row i is read at offset i*n + c, so the
//     threads of a warp read neighbouring addresses of each row, and the m
//     loads of a thread are independent, all in flight at once;
//   * the m values live in registers: the sort is Batcher's odd-even merge
//     network, pruned to m wires and fully unrolled per m by template
//     recursion (one instance per m in 1..64), so every index is a
//     compile-time constant and nothing goes to local memory;
//   * NaN is counted and replaced by +inf before the network (fminf/fmaxf
//     would drop it); the count then decides the NaN result, which leaves
//     every other rank exact;
//   * offsets are 64-bit: a stacked 22-layer MLP leaf is m*n = 2.5e9
//     elements;
//   * no atomics and no shared memory: the result does not depend on the
//     launch configuration.
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_M = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void compare_exchange(float& a, float& b) {
    const float lo = fminf(a, b), hi = fmaxf(a, b);
    a = lo;
    b = hi;
}

// Batcher's odd-even merge sort, in its iterative form:
//   for p = 1, 2, 4, ... < M:  for k = p, p/2, ..., 1:
//     for j = k % p; j + k < M; j += 2k:  for i < k:
//       if (i+j) / 2p == (i+j+k) / 2p:  compare_exchange(i+j, i+j+k)
// pruned to M wires: the network of the next power of two sorts M real
// values followed by +inf padding, and every comparator that touches a
// padding wire leaves both wires as they are, so it is dropped.
template <int M, int P, int K, int J>
__device__ __forceinline__ void merge_pass(float (&v)[M]) {
    if constexpr (J + K < M) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
            if (i + J + K < M && (i + J) / (2 * P) == (i + J + K) / (2 * P))
                compare_exchange(v[i + J], v[i + J + K]);
        }
        merge_pass<M, P, K, J + 2 * K>(v);
    }
}

template <int M, int P, int K>
__device__ __forceinline__ void merge_level(float (&v)[M]) {
    if constexpr (K >= 1) {
        merge_pass<M, P, K, K % P>(v);
        merge_level<M, P, K / 2>(v);
    }
}

template <int M, int P = 1>
__device__ __forceinline__ void sort_network(float (&v)[M]) {
    if constexpr (P < M) {
        merge_level<M, P, P>(v);
        sort_network<M, 2 * P>(v);
    }
}

template <typename T, int M>
__global__ void __launch_bounds__(THREADS)
sorted_reduce_kernel(const T* __restrict__ g, int64_t n, int trim, int median,
                     float* __restrict__ out) {
    const int64_t step = (int64_t)gridDim.x * THREADS;
    for (int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x; c < n; c += step) {
        float v[M];
        int nans = 0;
#pragma unroll
        for (int i = 0; i < M; ++i) {
            const float x = to_f32(g[(int64_t)i * n + c]);
            const bool is_nan = (x != x);
            nans += is_nan;
            v[i] = is_nan ? CUDART_INF_F : x;
        }
        sort_network<M>(v);
        float r;
        if (median) {
            r = __fmul_rn(__fadd_rn(v[(M - 1) / 2], v[M / 2]), 0.5f);
            if (nans > 0) r = CUDART_NAN_F;
        } else {
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < M; ++i)
                if (i >= trim && i < M - trim) sum = __fadd_rn(sum, v[i]);
            r = __fmul_rn(sum, __frcp_rn((float)(M - 2 * trim)));
            if (nans > trim) r = CUDART_NAN_F;
        }
        out[c] = r;
    }
}

template <typename T, int M>
int launch(const T* g, int64_t n, int trim, int median, float* out, cudaStream_t stream) {
    int64_t blocks = (n + THREADS - 1) / THREADS;
    if (blocks > (int64_t)1 << 24) blocks = (int64_t)1 << 24;   // grid-stride beyond
    sorted_reduce_kernel<T, M><<<(unsigned)blocks, THREADS, 0, stream>>>(g, n, trim, median, out);
    return (int)cudaGetLastError();
}

// One instance per m: the network is unrolled for its exact width.
template <typename T, int M = 1>
int dispatch(int64_t m, const T* g, int64_t n, int trim, int median, float* out,
             cudaStream_t stream) {
    if constexpr (M > MAX_M) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (m == M) return launch<T, M>(g, n, trim, median, out, stream);
        return dispatch<T, M + 1>(m, g, n, trim, median, out, stream);
    }
}

}  // namespace

extern "C" {

// g: (m, n) row-major, dtype 0 = float32, 1 = bfloat16, 1 <= m <= 64.
// median != 0: the coordinate median (trim is ignored); else the trimmed
// mean with 0 <= trim and 2 * trim < m.  out: (n,) float32.
int ra_sorted_reduce(const void* g, int dtype, int64_t m, int64_t n, int trim, int median,
                     void* out, void* stream) {
    if (m < 1 || m > MAX_M || n < 1) return (int)cudaErrorInvalidValue;
    if (!median && (trim < 0 || 2 * (int64_t)trim >= m)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    if (dtype == 0)
        return dispatch<float>(m, static_cast<const float*>(g), n, trim, median, o, st);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(m, static_cast<const __nv_bfloat16*>(g), n, trim, median,
                                       o, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
