// Causal flash attention with GQA and a sliding window on Hopper's tensor
// cores (sm_90a), for bfloat16 q, k and v, bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py:82
//   flash_attention_kernel / _flash_kernel (B4) for bfloat16 inputs: for
//   q (B, H, L, D) and k, v (B, K, L, D), each query row attends causally
//   to the keys of kv head h / (H / K), within the last `window` positions
//   when window > 0; online softmax over key tiles in ascending order with
//   float32 running max, sum and output accumulator; output in bfloat16.
//   (float32 inputs go to the CUDA-core kernel of flash_attention.cu.)
//
// Semantics are the Pallas kernel's: the products of bfloat16 values are
// exact in float32 and summed in float32 (wgmma's accumulator), so
// s = q . k is the kernel's float32 dot, scaled after the product; the
// finite -1e30 mask for kpos > qpos and, with a window, for
// kpos <= qpos - window; m_new = max(m, rowmax(s)); p = exp(s - m_new),
// alpha = exp(m - m_new); l summed from the float32 p;
// out = acc / max(l, 1e-30).  The exponentials run in base 2 with log2(e)
// folded into the scale: x = s * f32(log2(e) / sqrt(D)), p = 2^(x - m_new)
// on the special function unit.  That moves p by a few parts in 10^6,
// far inside the bfloat16 checks (tests/test_torch_flash_attention.py
// emulates it).  The difference is taken first, so a row whose keys in a
// tile are all masked before it has seen a valid key gets
// (-1e30) - (-1e30) = 0 and p = 1 there, and alpha = 2^(-1e30 - m) = 0
// clears it at the row's own key, which always comes in a later tile, as
// on the TPU.
//
// p in bfloat16.  A tensor-core p @ v needs p in a 16-bit type; the Pallas
// kernel keeps it in float32.  Rounding p once to bfloat16 moves the
// float32 output by up to 3e-3 and breaks the port's bfloat16 checks
// (2e-5 + 2^-7 |ref| per element) by a factor of 30-55.  So p is split,
// hi = bf16(p) and lo = bf16(p - hi), and both halves are multiplied by the
// same V tile into one float32 accumulator: hi + lo holds p to about 2^-17
// of itself, which keeps every check
// (tests/test_torch_flash_attention.py emulates both choices on the CPU).
//
// What bounds it on an H100: operations.  Causal attention does 4*D
// floating-point operations per reachable (query, key) pair (2*D for
// q . k, 2*D for p @ v) on data read once; at the prefill shapes (L = 1984
// and 8192, D = 64) that is hundreds of operations per byte, so the bf16
// tensor-core peak (989 TFLOP/s dense) is the limit.  The split makes the
// kernel perform 6*D operations per pair, so it can reach at most 2/3 of
// that peak in useful work; the exp of every score (one MUFU.EX2 a pair)
// and the softmax's FP32 work per pair are the other limits.
//
// What the design does about it (simple first):
//   * one block per (q tile of BQ = 128 rows, head h, batch b), blocks of
//     the longest causal tiles scheduled first (the q tile is the slowest
//     grid axis and counts down); the TPU's sequential kv grid axis
//     becomes a loop over key tiles of BK = 128 keys (64 for D = 128) from
//     the first reachable tile to the diagonal (the TPU kernel's
//     `reachable`);
//   * three warpgroups: one producer, whose first thread issues every TMA
//     load, and two consumer warpgroups of 64 query rows each; setmaxnreg
//     gives the producer's registers to the consumers (24 and 240 a
//     thread);
//   * Q is loaded once; K and V tiles go through a ring of NST = 3 stages
//     in dynamic shared memory, each with a full barrier for K, one for V
//     and an empty barrier the 256 consumer threads arrive on, so the next
//     tiles are in flight while the current ones are multiplied.  The
//     tiles are swizzled as wgmma reads them (rows of 2*D bytes, 32B/64B/
//     128B swizzle; D = 128 goes as two panels of 64 columns);
//   * the 4-D tensor maps take the caller's strides, so the (B, L, H, D)
//     projections come as their transpose(1, 2) views, never copied, and K
//     and V are read through the GQA map h / (H / K); TMA fills rows past
//     L with zeros, which causality masks, so nothing is padded;
//   * S = Q K^T by wgmma m64nBKk16 with both operands K-major in shared
//     memory; scale, masks (only in tiles that cross the diagonal or the
//     window's edge) and the online softmax in float32 registers, the row
//     max reduced over the quad of threads that hold a row;
//   * O += P V by wgmma m64nDk16 with P (hi, then lo) from registers: the
//     accumulator fragment of S is the A fragment of a 16-bit operand, so
//     p never goes through shared memory; V is the MN-major B operand (the
//     transpose bit);
//   * the two consumer warpgroups take turns on the tensor cores (two
//     named barriers), two turns a tile, S and then P V: one warpgroup's
//     products run while the other computes its softmax, so the exp and
//     the split, which the tensor cores cannot do, overlap the products;
//   * the epilogue divides by l and stores bfloat16 pairs into the
//     caller's layout; rows past L are not stored;
//   * no atomics and no split of the keys: every output row belongs to one
//     block and is summed in one order, so two launches give the same bits.
//
// An mbarrier wait that lasts 10 s means a lost arrival: the kernel traps,
// so the launch fails with an error instead of holding the card.
//
// The entry point sets the dynamic shared memory limit before the launch
// and returns cudaGetLastError() after it; the Python wrapper raises when
// it is not 0.  cuTensorMapEncodeTiled is looked up through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;             // query rows of a block
constexpr int WG_ROWS = 64;         // query rows of a consumer warpgroup
constexpr int NST = 3;              // stages of the K/V ring
constexpr int THREADS = 384;        // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;      // threads that release a stage
constexpr float NEG = -1e30f;       // the Pallas kernel's finite mask value
constexpr double LOG2E_D = 1.4426950408889634;

struct Strides {
    int64_t b, h, l, d;
};

// Tile geometry of one head dim.  A tile of R rows is stored as PANELS
// panels of (R, DC) bfloat16, each row of a panel 2 * DC bytes, swizzled
// with that width (32B, 64B or 128B) as TMA writes it and wgmma reads it.
template <int D>
struct Cfg {
    static constexpr int BK = D == 128 ? 64 : 128;         // keys of a tile
    static constexpr int PANELS = D == 128 ? 2 : 1;
    static constexpr int DC = D / PANELS;                   // columns of a panel
    static constexpr int ROW = 2 * DC;                      // bytes of a panel row
    static constexpr int Q_PANEL = BQ * ROW;
    static constexpr int KV_PANEL = BK * ROW;
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;
    // descriptor fields: layout 1 = 128B, 2 = 64B, 3 = 32B swizzle; SBO is
    // the distance of two groups of 8 rows, in 16-byte units
    static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
    static constexpr uint32_t SBO = 8 * ROW / 16;
    // shared memory: Q, NST K tiles, NST V tiles, 8-byte barriers, and
    // room to align the start to the 1024-byte swizzle period
    static constexpr int BAR_BYTES = 8 * (1 + 3 * NST);
    static constexpr int SMEM = Q_BYTES + 2 * NST * KV_BYTES + BAR_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const uint64_t t0 = global_ns();
    while (!mbar_try_wait(bar, parity))
        if (global_ns() - t0 > 10000000000ull) __trap();
}

// ---- TMA ----------------------------------------------------------------

// a (rows, DC) box at (d0, row, head, batch) of a 4-D tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int d0, int row,
                                         int head, int batch, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(row), "r"(head),
           "r"(batch), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- wgmma --------------------------------------------------------------

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
           (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (m64 x n64, f32) {+}= A (64 x 16, shared, K-major) * B (n64 x 16,
// shared, K-major); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (m64 x n128, f32) {+}= A (64 x 16, shared, K-major) * B (n128 x 16,
// shared, K-major); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (m64 x n16, f32) += A (64 x 16, registers) * B (16 x n16, shared,
// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n32, f32) += A (64 x 16, registers) * B (16 x n32, shared,
// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n64, f32) += A (64 x 16, registers) * B (16 x n64, shared,
// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n128, f32) += A (64 x 16, registers) * B (16 x n128, shared,
// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the instances by accumulator size
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    wgmma_ss_n64(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    wgmma_ss_n128(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n16(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n32(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n64(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n128(d, a, db);
}

// ---- the consumers' pieces ----------------------------------------------

// named barriers 1 and 2: the consumer warpgroups' turns on the tensor
// cores (barrier 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}

// 2^x on the special function unit (MUFU.EX2, relative error about
// 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// over the quad of threads that hold one row of an accumulator fragment
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T (64 x BK, float32) of one warpgroup's rows of Q against the
// K tile at k_tile, issued (both operands K-major in shared memory)
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<D>::BK / 2], uint32_t q_wg,
                                        uint32_t k_tile) {
    using C = Cfg<D>;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int panel = kk / (C::DC / 16);
        const uint32_t off = (kk % (C::DC / 16)) * 32;
        wgmma_ss(sc, make_desc(q_wg + panel * C::Q_PANEL + off, 1, C::SBO, C::LAYOUT),
                 make_desc(k_tile + panel * C::KV_PANEL + off, 1, C::SBO, C::LAYOUT), kk > 0);
    }
}

// a consumer thread's place: its warpgroup's first row, its two rows and
// its first column of every 8 (the accumulator fragment of wgmma m64nN)
struct Rows {
    int r0, row_a, row_b, col, window;
    float scale_log2;
};

// the online softmax of a thread's two rows
struct Softmax {
    float m_a = NEG, m_b = NEG;           // running max of the rows (log2 domain)
    float l_a = 0.f, l_b = 0.f;           // running sums over the thread's columns
    float alpha_a = 1.f, alpha_b = 1.f;   // the last tile's rescale of acc

    // one S tile of BK keys from k0: scale (in the log2 domain), mask
    // where the tile crosses the diagonal or the window's edge, the new
    // max, alpha, l, and p
    // split into bfloat16 hi + lo, packed as the A fragments of BK / 16
    // steps: register j of step k holds the pair sc[8k + 2j], sc[8k + 2j + 1]
    // (rows a, b, a, b)
    template <int NS>
    __device__ __forceinline__ void tile(float (&sc)[NS], uint32_t (&p_hi)[NS / 8][4],
                                         uint32_t (&p_lo)[NS / 8][4], int k0, const Rows& r) {
        constexpr int BK = 2 * NS;
        const bool masked = k0 + BK - 1 > r.r0 ||
                            (r.window > 0 && k0 <= r.r0 + WG_ROWS - 1 - r.window);
        float n_a = m_a, n_b = m_b;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = sc[4 * c + e] * r.scale_log2;
                if (masked) {
                    const int kp = k0 + 8 * c + r.col + (e & 1);
                    const int qp = e < 2 ? r.row_a : r.row_b;
                    const bool ok = kp <= qp && (r.window <= 0 || kp > qp - r.window);
                    x = ok ? x : NEG;
                }
                sc[4 * c + e] = x;
                if (e < 2)
                    n_a = fmaxf(n_a, x);
                else
                    n_b = fmaxf(n_b, x);
            }
        n_a = quad_max(n_a);
        n_b = quad_max(n_b);
        alpha_a = ex2(m_a - n_a);
        alpha_b = ex2(m_b - n_b);
        m_a = n_a;
        m_b = n_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float m = (j & 1) ? n_b : n_a;
                const float p0 = ex2(sc[8 * k + 2 * j] - m);
                const float p1 = ex2(sc[8 * k + 2 * j + 1] - m);
                if (j & 1)
                    sum_b += p0 + p1;
                else
                    sum_a += p0 + p1;
                const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
                const float2 hf = __bfloat1622float2(hi);
                const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
                p_hi[k][j] = *reinterpret_cast<const uint32_t*>(&hi);
                p_lo[k][j] = *reinterpret_cast<const uint32_t*>(&lo);
            }
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
    }
};

// ---- the kernel ---------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                Strides so, int group, int L, int window, float scale_log2, int n_q_tiles) {
    using C = Cfg<D>;
    constexpr int BK = C::BK;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sQ = base;
    const uint32_t sK = sQ + C::Q_BYTES;
    const uint32_t sV = sK + NST * C::KV_BYTES;
    const uint32_t full_q = sV + NST * C::KV_BYTES;
    const uint32_t full_k = full_q + 8;                 // + 8 * stage
    const uint32_t full_v = full_k + 8 * NST;
    const uint32_t empty = full_v + 8 * NST;

    const int tid = threadIdx.x;
    const int h = blockIdx.x, b = blockIdx.y, kh = h / group;
    const int q_start = (n_q_tiles - 1 - (int)blockIdx.z) * BQ;
    const int q_last = min(q_start + BQ, L) - 1;
    // the block's key tiles: from the one holding its first query's first
    // key in the window to the one holding its last query's own key
    const int k_first = window > 0 ? max(0, q_start - window + 1) : 0;
    const int kt0 = k_first / BK;
    const int n_tiles = q_last / BK - kt0 + 1;

    if (tid == 0) {
        mbar_init(full_q, 1);
        for (int s = 0; s < NST; ++s) {
            mbar_init(full_k + 8 * s, 1);
            mbar_init(full_v + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid < 128) {
        // ---- producer warpgroup: one thread issues every load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid == 0) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
            for (int p = 0; p < C::PANELS; ++p)
                tma_load(sQ + p * C::Q_PANEL, &tq, p * C::DC, q_start, h, b, full_q);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % NST;
                const uint32_t phase = (i / NST) & 1;
                const int k0 = (kt0 + i) * BK;
                mbar_wait(empty + 8 * s, phase ^ 1);    // the stage's last readers are done
                mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
#pragma unroll
                for (int p = 0; p < C::PANELS; ++p)
                    tma_load(sK + s * C::KV_BYTES + p * C::KV_PANEL, &tk, p * C::DC, k0, kh, b,
                             full_k + 8 * s);
                mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
#pragma unroll
                for (int p = 0; p < C::PANELS; ++p)
                    tma_load(sV + s * C::KV_BYTES + p * C::KV_PANEL, &tv, p * C::DC, k0, kh, b,
                             full_v + 8 * s);
            }
        }
    } else {
        // ---- consumer warpgroups: 64 query rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int cw = tid / 128 - 1;
        const int t = tid % 128, warp = t / 32, lane = t % 32;
        const int r0 = q_start + cw * WG_ROWS;          // the warpgroup's first row
        // the thread's two rows and its first column of every 8 (the
        // accumulator fragment of wgmma m64nN)
        const int row_a = r0 + warp * 16 + lane / 4, row_b = row_a + 8;
        const int col = 2 * (lane % 4);
        const Rows rows{r0, row_a, row_b, col, window, scale_log2};

        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        Softmax sm;
        float sc[BK / 2];
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];

        const uint32_t q_wg = sQ + cw * WG_ROWS * C::ROW;   // the warpgroup's Q rows
        // The two warpgroups take turns on the tensor cores: each issues
        // its products only in its turn (named barrier 1 + cw) and then
        // hands the turn over, so one warpgroup's softmax runs while the
        // other's products do.  Each makes two turns a tile, S and then
        // P V.  The first turn is warpgroup 0's, and warpgroup 1 hands over
        // no turn after its last, so every barrier sees as many arrivals
        // as waits.
        const int my_turn = 1 + cw, other_turn = 2 - cw;
        if (cw == 1) named_arrive(other_turn);

        mbar_wait(full_q, 0);
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % NST;
            const uint32_t phase = (i / NST) & 1;
            // S = Q K^T of tile i, in this warpgroup's turn
            mbar_wait(full_k + 8 * s, phase);
            named_sync(my_turn);
            wgmma_fence();
            issue_s<D>(sc, q_wg, sK + s * C::KV_BYTES);
            wgmma_commit();
            named_arrive(other_turn);
            wgmma_wait_all();
            fence_regs(sc);

            sm.tile(sc, p_hi, p_lo, (kt0 + i) * BK, rows);
#pragma unroll
            for (int c = 0; c < D / 8; ++c) {
                o[4 * c + 0] *= sm.alpha_a;
                o[4 * c + 1] *= sm.alpha_a;
                o[4 * c + 2] *= sm.alpha_b;
                o[4 * c + 3] *= sm.alpha_b;
            }

            // O += P_hi V + P_lo V, V the MN-major B operand, in the next turn
            mbar_wait(full_v + 8 * s, phase);
            named_sync(my_turn);
            fence_regs(o);
            wgmma_fence();
            const uint32_t v_tile = sV + s * C::KV_BYTES;
#pragma unroll
            for (int j = 0; j < BK / 16; ++j) {
                const uint64_t dv =
                    make_desc(v_tile + j * 16 * C::ROW, C::KV_PANEL / 16, C::SBO, C::LAYOUT);
                wgmma_rs(o, p_hi[j], dv);
                wgmma_rs(o, p_lo[j], dv);
            }
            wgmma_commit();
            if (i + 1 < n_tiles || cw == 0) named_arrive(other_turn);
            wgmma_wait_all();
            fence_regs(o);
            mbar_arrive(empty + 8 * s);                 // K and V of tile i are read
        }
        // out = acc / max(l, 1e-30), l summed over the row's quad
        const float d_a = fmaxf(quad_sum(sm.l_a), 1e-30f);
        const float d_b = fmaxf(quad_sum(sm.l_b), 1e-30f);
        __nv_bfloat16* ob = out + (int64_t)b * so.b + (int64_t)h * so.h;
        if (row_a < L) {
            __nv_bfloat16* dst = ob + (int64_t)row_a * so.l + col;
#pragma unroll
            for (int c = 0; c < D / 8; ++c)
                *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
                    __floats2bfloat162_rn(o[4 * c] / d_a, o[4 * c + 1] / d_a);
        }
        if (row_b < L) {
            __nv_bfloat16* dst = ob + (int64_t)row_b * so.l + col;
#pragma unroll
            for (int c = 0; c < D / 8; ++c)
                *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
                    __floats2bfloat162_rn(o[4 * c + 2] / d_b, o[4 * c + 3] / d_b);
        }
    }
}

// ---- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// 4-D map of a (batch, heads, L, D) bfloat16 tensor with element strides
// st = (b, h, l, d), d = 1, read in boxes of (rows, DC)
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, const int64_t* st, int64_t batch,
              int64_t heads, int64_t L, int rows) {
    using C = Cfg<D>;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)heads, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                   (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::DC, (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle sw = C::ROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : C::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
    return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                     strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const int64_t* st, int64_t B,
           int64_t H, int64_t K, int64_t L, int64_t window, cudaStream_t stream) {
    using C = Cfg<D>;
    if (!encoder()) return (int)cudaErrorNotSupported;
    CUtensorMap mq, mk, mv;
    if (!make_map<D>(&mq, q, st, B, H, L, BQ) || !make_map<D>(&mk, k, st + 4, B, K, L, C::BK) ||
        !make_map<D>(&mv, v, st + 8, B, K, L, C::BK))
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const Strides so{st[12], st[13], st[14], st[15]};
    const int n_q_tiles = (int)((L + BQ - 1) / BQ);
    // 1/sqrt(D) with log2(e) folded in: p = 2^(s * scale_log2 - m)
    const float scale_log2 = (float)(LOG2E_D / sqrt((double)D));
    // window >= L masks nothing that causality does not
    const int win = window >= L ? 0 : (int)window;
    flash_tc_kernel<D><<<dim3((unsigned)H, (unsigned)B, (unsigned)n_q_tiles), THREADS, C::SMEM,
                         stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out), so, (int)(H / K),
                                   (int)L, win, scale_log2, n_q_tiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, L, D), k and v (B, K, L, D), out (B, H, L, D), all bfloat16.
// strides: 16 element strides, (b, h, l, d) of q, k, v and out in that
// order; every d stride is 1, every other one a multiple of 8 elements
// (16 bytes), and q, k, v start on 16 bytes (what TMA addresses).  K
// divides H; D in {16, 32, 64, 128}; window 0 means causal only.
int fa_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                          const int64_t* strides, int64_t B, int64_t H, int64_t K, int64_t L,
                          int64_t D, int64_t window, void* stream) {
    if (B < 1 || B > 65535 || H < 1 || H > 0x7fffffff || K < 1 || H % K != 0 || L < 1 ||
        (L + BQ - 1) / BQ > 65535 || window < 0)
        return (int)cudaErrorInvalidValue;
    for (int t = 0; t < 4; ++t) {
        const int64_t* s = strides + 4 * t;
        if (s[3] != 1) return (int)cudaErrorInvalidValue;
        if (t < 3 && (s[0] % 8 || s[1] % 8 || s[2] % 8 || s[0] <= 0 || s[1] <= 0 || s[2] <= 0))
            return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D == 16) return launch<16>(q, k, v, out, strides, B, H, K, L, window, st);
    if (D == 32) return launch<32>(q, k, v, out, strides, B, H, K, L, window, st);
    if (D == 64) return launch<64>(q, k, v, out, strides, B, H, K, L, window, st);
    if (D == 128) return launch<128>(q, k, v, out, strides, B, H, K, L, window, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
