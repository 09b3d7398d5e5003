// Causal flash attention with GQA and a sliding window, for Hopper
// (sm_90a), for float32 q, k and v, bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py:82
//   flash_attention_kernel / _flash_kernel (B4) for float32 inputs: for
//   q (B, H, L, D) and k, v (B, K, L, D), each query row attends causally
//   to the keys of kv head h / (H / K), within the last `window` positions
//   when window > 0; online softmax over key tiles in ascending order with
//   float32 running max, sum and output accumulator; output in float32.
//   bfloat16 inputs, which the model passes, go to the tensor-core kernel
//   of flash_attention_tc.cu.  This one serves the float32 checks: the
//   tensor cores would take float32 only as TF32, whose 10-bit mantissa
//   breaks the float32 tolerance of 2e-5.
//
// Semantics are the Pallas kernel's: scores times 1/sqrt(D), the finite
// -1e30 mask for kpos > qpos and, with a window, for kpos <= qpos - window;
// p = exp(s - m_new) kept in float32; out = acc / max(l, 1e-30).  A row
// whose keys in a tile are all masked before it has seen a valid key gets
// p = exp(0) = 1 there; the tiles go in ascending order and the row's own
// key always comes later, where alpha = exp(-1e30 - m) = 0 clears what was
// added.  That is the TPU kernel's behaviour, kept as it is.
//
// What bounds it on an H100: operations.  Causal attention does 4*D
// floating-point operations per reachable (query, key) pair on data that
// is read once: at the prefill shapes (L = 1984 and 8192, D = 64) that is
// hundreds of operations per byte.  In IEEE float32 the limit is the CUDA
// cores' FMA rate (67 TFLOP/s).
//
// What the design does about it (simple first):
//   * one block per (q tile of BQ = 64 rows, head h, batch b); the TPU's
//     sequential kv grid axis becomes a loop over key tiles of BK = 32
//     inside the block, from the first reachable tile to the diagonal:
//     tiles above the diagonal and tiles wholly before the window are never
//     visited (the TPU kernel's `reachable`);
//   * blocks of the longest q tiles start first (blockIdx.x counts down),
//     so the short tiles fill the tail of the launch;
//   * TPR = D / 32 neighbouring threads share one query row (one thread
//     for D <= 32), each holding 32 of its dims of q and of the float32 accumulator in registers; a
//     score is their partial dot products added by a butterfly of
//     __shfl_xor_sync, so every thread of the row holds the same bits of
//     s, m and l;
//   * each key tile of K and V is copied once into shared memory; a
//     thread reads its dims as float4 chunks interleaved with its row's
//     other threads (chunk i * TPR + part), so a warp reads TPR
//     neighbouring 16-byte words of one key: a broadcast, no bank conflict;
//   * K and V are read through the GQA map h / (H / K), never copied up to
//     H heads;
//   * the ragged edge of L is masked in the kernel: keys past L load as 0
//     and are masked by causality, rows past L are not stored, so the
//     wrapper pads nothing;
//   * every tensor is addressed through its four element strides with
//     64-bit offsets, so a (B, L, H, D) projection is passed as its
//     transpose(1, 2) view without a copy.
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows of a block
constexpr int BK = 32;              // keys of a shared-memory tile
constexpr int DS_MAX = 32;          // dims of a row that one thread holds
constexpr float NEG = -1e30f;       // the Pallas kernel's finite mask value

struct Strides {
    int64_t b, h, l, d;
};

// dims of a row that one thread holds, and threads of one query row
template <int D>
struct RowSplit {
    static constexpr int DS = D < DS_MAX ? D : DS_MAX;
    static constexpr int TPR = D / DS;
};

template <int D>
__global__ void __launch_bounds__(BQ * RowSplit<D>::TPR)
flash_kernel(const float* __restrict__ q, Strides sq, const float* __restrict__ k, Strides sk,
             const float* __restrict__ v, Strides sv, float* __restrict__ out, Strides so, int group,
             int64_t L, int64_t window, float scale, int n_q_tiles) {
    constexpr int DS = RowSplit<D>::DS;
    constexpr int TPR = RowSplit<D>::TPR;
    constexpr int NT = BQ * TPR;        // threads of the block
    constexpr int C4 = DS / 4;          // float4 chunks of a row a thread holds
    __shared__ float4 ks[BK][D / 4];
    __shared__ float4 vs[BK][D / 4];

    const int tid = threadIdx.x;
    const int row = tid / TPR;
    const int part = tid % TPR;
    const int64_t b = blockIdx.z, h = blockIdx.y, kh = blockIdx.y / group;
    const int64_t q_start = (int64_t)(n_q_tiles - 1 - (int)blockIdx.x) * BQ;
    const int64_t qpos = q_start + row;

    // this thread's dims of its query row, chunk c = i * TPR + part
    float qr[DS];
    const float* qrow = q + b * sq.b + h * sq.h + qpos * sq.l;
#pragma unroll
    for (int i = 0; i < C4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int64_t d = (int64_t)(i * TPR + part) * 4 + e;
            qr[i * 4 + e] = qpos < L ? qrow[d * sq.d] : 0.f;
        }

    float acc[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i) acc[i] = 0.f;
    float m = NEG, l = 0.f;

    const float* kbase = k + b * sk.b + kh * sk.h;
    const float* vbase = v + b * sv.b + kh * sv.h;
    float* ksf = reinterpret_cast<float*>(&ks[0][0]);
    float* vsf = reinterpret_cast<float*>(&vs[0][0]);

    // reachable key tiles: from the one holding the block's first key in
    // the window up to the one holding its last query's own key
    const int64_t q_last = (q_start + BQ < L ? q_start + BQ : L) - 1;
    const int64_t k_first = (window > 0 && q_start - window + 1 > 0) ? q_start - window + 1 : 0;
    for (int64_t kt = k_first / BK; kt <= q_last / BK; ++kt) {
        const int64_t k_start = kt * BK;
        __syncthreads();                // the last tile's readers are done
        for (int e = tid; e < BK * D; e += NT) {
            const int64_t kp = k_start + e / D, d = e % D;
            float kx = 0.f, vx = 0.f;
            if (kp < L) {
                kx = kbase[kp * sk.l + d * sk.d];
                vx = vbase[kp * sv.l + d * sv.d];
            }
            ksf[e] = kx;
            vsf[e] = vx;
        }
        __syncthreads();

        float s[BK];
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            float a = 0.f;
#pragma unroll
            for (int i = 0; i < C4; ++i) {
                const float4 kk = ks[j][i * TPR + part];
                a = fmaf(qr[i * 4 + 0], kk.x, a);
                a = fmaf(qr[i * 4 + 1], kk.y, a);
                a = fmaf(qr[i * 4 + 2], kk.z, a);
                a = fmaf(qr[i * 4 + 3], kk.w, a);
            }
#pragma unroll
            for (int off = 1; off < TPR; off <<= 1)
                a += __shfl_xor_sync(0xffffffffu, a, off);
            s[j] = a;
        }

        float m_new = m;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const int64_t kp = k_start + j;
            const bool ok = kp <= qpos && (window <= 0 || kp > qpos - window);
            s[j] = ok ? s[j] * scale : NEG;
            m_new = fmaxf(m_new, s[j]);
        }
        const float alpha = expf(m - m_new);
#pragma unroll
        for (int i = 0; i < DS; ++i) acc[i] *= alpha;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float p = expf(s[j] - m_new);
            psum += p;
#pragma unroll
            for (int i = 0; i < C4; ++i) {
                const float4 vv = vs[j][i * TPR + part];
                acc[i * 4 + 0] = fmaf(p, vv.x, acc[i * 4 + 0]);
                acc[i * 4 + 1] = fmaf(p, vv.y, acc[i * 4 + 1]);
                acc[i * 4 + 2] = fmaf(p, vv.z, acc[i * 4 + 2]);
                acc[i * 4 + 3] = fmaf(p, vv.w, acc[i * 4 + 3]);
            }
        }
        l = l * alpha + psum;
        m = m_new;
    }

    if (qpos < L) {
        const float lc = fmaxf(l, 1e-30f);
        float* orow = out + b * so.b + h * so.h + qpos * so.l;
#pragma unroll
        for (int i = 0; i < C4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int64_t d = (int64_t)(i * TPR + part) * 4 + e;
                orow[d * so.d] = acc[i * 4 + e] / lc;
            }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const int64_t* st,
           int64_t B, int64_t H, int64_t K, int64_t L, int64_t window, cudaStream_t stream) {
    const Strides sq{st[0], st[1], st[2], st[3]}, sk{st[4], st[5], st[6], st[7]},
        sv{st[8], st[9], st[10], st[11]}, so{st[12], st[13], st[14], st[15]};
    const int n_q_tiles = (int)((L + BQ - 1) / BQ);
    const float scale = (float)(1.0 / sqrt((double)D));   // as f32(1.0 / math.sqrt(D))
    flash_kernel<D><<<dim3(n_q_tiles, (unsigned)H, (unsigned)B), BQ * RowSplit<D>::TPR, 0, stream>>>(
        static_cast<const float*>(q), sq, static_cast<const float*>(k), sk,
        static_cast<const float*>(v), sv, static_cast<float*>(out), so, (int)(H / K), L, window, scale, n_q_tiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, L, D), k and v (B, K, L, D), out (B, H, L, D), all float32.
// strides: 16 element strides, (b, h, l, d) of q, k, v and out in that
// order.  K divides H; D in {16, 32, 64, 128}; window 0 means causal only.
int fa_flash_attention(const void* q, const void* k, const void* v, void* out,
                       const int64_t* strides, int64_t B, int64_t H, int64_t K, int64_t L,
                       int64_t D, int64_t window, void* stream) {
    if (B < 1 || B > 65535 || H < 1 || H > 65535 || K < 1 || H % K != 0 || L < 1 ||
        (L + BQ - 1) / BQ > 0x7fffffff || window < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D == 16) return launch<16>(q, k, v, out, strides, B, H, K, L, window, st);
    if (D == 32) return launch<32>(q, k, v, out, strides, B, H, K, L, window, st);
    if (D == 64) return launch<64>(q, k, v, out, strides, B, H, K, L, window, st);
    if (D == 128) return launch<128>(q, k, v, out, strides, B, H, K, L, window, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
