// Hopper (sm_90a) primitives shared by the port's kernels: mbarriers, TMA
// copies and tensor maps, setmaxnreg, wgmma descriptors and products, and
// the f32 -> 16-bit packing and exp2 the softmaxes use.
//
// Included by flash_attention.cu (B2-B4), block_sparse_attention.cu (B5) and
// paged_attention.cu (B1); each is its own library (ops/builder.py), whose
// hash covers this header too.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {

constexpr int kPanel = 64;             // elements in one 128-byte swizzled row of a TMA box
constexpr int kSmemLimit = 232448;     // dynamic shared memory one block may take on an H100
constexpr int kSmemPerSm = 233472;     // shared memory of one SM; each resident block also holds 1 KB
constexpr int kNoTensorMap = -3, kBadTensorMap = -4;  // make_map's errors; the kernels' own codes differ

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
        "[%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// wgmma shared-memory descriptors for a 128-byte-swizzled panel written by
// TMA: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO). K-major: K
// runs along the row (a k16 step moves the start 32 bytes; LBO unused).
// MN-major: N runs along the row, the next 64 columns are the next panel,
// `panel_bytes` on (LBO); K runs down the rows (a k16 step moves 2048 bytes).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t panel_bytes) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(panel_bytes >> 4) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// keep reads of an accumulator after the wgmma.wait that completes it
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DSTT_F8(d, i) \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
        "+f"(d[i + 7])
#define DSTT_D32(d) DSTT_F8(d, 0), DSTT_F8(d, 8), DSTT_F8(d, 16), DSTT_F8(d, 24)
#define DSTT_D64(d) DSTT_D32(d), DSTT_F8(d, 32), DSTT_F8(d, 40), DSTT_F8(d, 48), DSTT_F8(d, 56)
#define DSTT_R32_BODY \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
    "%23, %24, %25, %26, %27, %28, %29, %30, %31"
#define DSTT_R32 "{" DSTT_R32_BODY "}"
#define DSTT_R64                                                                                                  \
    "{" DSTT_R32_BODY                                                                                             \
    ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
    "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// m64nNk16 products with f32 accumulators, N = 64 (32 registers a thread)
// or 128 (64): wgmma_ss reads A and B from shared memory, both K-major, and
// overwrites the accumulator when `acc` is 0; wgmma_rs takes A from
// registers and B MN-major, and accumulates. The last argument picks the
// 16-bit type.
#define DSTT_DEFINE_WGMMA(CT, TY)                                                                                  \
    __device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc, const CT*) {         \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                  \
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTT_R32                          \
                     ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                                             \
                     : DSTT_D32(d)                                                                                 \
                     : "l"(a), "l"(b), "r"(acc));                                                                  \
    }                                                                                                              \
    __device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc, const CT*) {         \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                  \
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " DSTT_R64                         \
                     ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                                             \
                     : DSTT_D64(d)                                                                                 \
                     : "l"(a), "l"(b), "r"(acc));                                                                  \
    }                                                                                                              \
    __device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, const CT*) {      \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                  \
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTT_R32                          \
                     ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                               \
                     : DSTT_D32(d)                                                                                 \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                                \
    }                                                                                                              \
    __device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, const CT*) {      \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                  \
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " DSTT_R64                         \
                     ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                               \
                     : DSTT_D64(d)                                                                                 \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                                \
    }

DSTT_DEFINE_WGMMA(__nv_bfloat16, "bf16")
DSTT_DEFINE_WGMMA(__half, "f16")

// two f32 values as one register of the 16-bit type, `lo` in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi, const __nv_bfloat16*) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, const __half*) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The accumulator of an m64nN wgmma: warp w of the warpgroup holds rows
// 16 w + lane / 4 (values with (i / 2) % 2 == 0) and that row + 8 (the
// others); value i sits in column 8 (i / 4) + 2 (lane % 4) + i % 2. So
// registers 2j and 2j + 1 packed into one 16-bit pair are exactly the A
// operand register j of an RS wgmma over the same columns as its K.

// ----------------------------------------------------------- tensor maps --
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time, so that the
// library needs no -lcuda
inline EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t err =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                            : nullptr;
    }();
    return fn;
}

template <typename T> constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
template <> constexpr CUtensorMapDataType kMapType<__half> = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;

// A contiguous 4-D tensor of 16-bit elements as a tensor map: `dims`
// innermost first (dims[0] = D, the contiguous one), read in boxes of 64
// columns x `rows` along dimension `row_dim` (1 or 2) with the 128-byte
// swizzle; coordinates past a dimension's end read as zeros. Returns 0,
// kNoTensorMap or kBadTensorMap.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, const int (&dims)[4], int row_dim, int rows) {
    const EncodeTiled fn = encode_tiled();
    if (!fn) return kNoTensorMap;
    const cuuint64_t size[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2], (cuuint64_t)dims[3]};
    const cuuint64_t strides[3] = {size[0] * 2, size[0] * size[1] * 2, size[0] * size[1] * size[2] * 2};
    cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, 1, 1};
    box[row_dim] = (cuuint32_t)rows;
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, kMapType<T>, 4, const_cast<void*>(ptr), size, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace dstt
