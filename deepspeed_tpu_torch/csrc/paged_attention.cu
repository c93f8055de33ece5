// Paged (blocked) attention over the ragged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/paged_attention.py::_kernel
// (called through paged_attention_update): for each ragged token, write its
// K/V into slot pos % bs of block table[seq, pos / bs] at layer `layer`, then
// attend causally (GQA) over positions 0..pos through the sequence's block
// table, with an f32 online softmax.
//
// Two launches on the caller's stream, in this order:
//   1. dstt_paged_kv_insert: one block per token copies its k/v [KVH, D]
//      into the cache.
//   2. dstt_paged_attention: one block per (token, kv head) serves the
//      rep = H / KVH query heads of that kv head. It walks the block table,
//      stages each [bs, D] K and V tile in shared memory with 16-byte loads,
//      and keeps the running max, sum and [rep, D] accumulator in f32.
// The Pallas grid runs tokens in order, so a token sees the inserts of the
// tokens before it. Blocks on the GPU run in parallel and in no order, so
// every insert finishes (kernel boundary) before any attention reads the
// cache. Positions after a token's own are masked, so reading the inserts of
// later tokens of the same chunk changes nothing.
//
// Semantics kept from the Pallas kernel: seq = min(token_seq, S - 1); a valid
// token attends nblocks = min(pos / bs + 1, MB) blocks; table entries of -1
// are read as block 0 (positions past pos are masked, never read here);
// invalid tokens write nothing and output 0; the insert goes to block
// max(table[seq, min(pos / bs, MB - 1)], 0).
//
// Bound on an H100 SXM: memory. A decode token reads its sequence's live K/V,
// 2 * (pos + 1) * KVH * D * sizeof(T) bytes, and does 4 * H * D * (pos + 1)
// flops, far below the 295 flops per byte at which the tensor cores would
// bound it; so the least time is the live KV bytes over 3.35 TB/s. This first
// version stages one tile at a time with a barrier between load and compute
// (no cp.async/TMA pipelining, no split over the context, no wgmma).
// Launch and build: ops/paged_attention.py and ops/builder.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// cache index of element (layer, kv, block, head, row, 0)
__device__ __forceinline__ int64_t tile_offset(int layer, int kv, int block, int head, int row,
                                               int NB, int KVH, int bs, int D) {
    return ((((int64_t)layer * 2 + kv) * NB + block) * KVH + head) * (int64_t)bs * D +
           (int64_t)row * D;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_kv_insert_kernel(
    const T* __restrict__ k_new, const T* __restrict__ v_new, T* __restrict__ cache,
    const int* __restrict__ table, int64_t table_stride, const int* __restrict__ token_seq,
    const int* __restrict__ token_pos, const int* __restrict__ token_valid, int layer, int NB,
    int KVH, int bs, int D, int S, int MB) {
    const int t = blockIdx.x;
    if (token_valid[t] <= 0) return;
    const int seq = min(token_seq[t], S - 1);
    const int pos = token_pos[t];
    const int block = max(table[seq * table_stride + min(pos / bs, MB - 1)], 0);
    const int off = pos % bs;
    const int64_t src = (int64_t)t * KVH * D;
    for (int i = threadIdx.x; i < KVH * D; i += blockDim.x) {
        const int h = i / D, d = i - h * D;
        cache[tile_offset(layer, 0, block, h, off, NB, KVH, bs, D) + d] = k_new[src + i];
        cache[tile_offset(layer, 1, block, h, off, NB, KVH, bs, D) + d] = v_new[src + i];
    }
}

// Shared memory: K tile [bs, D] and V tile [bs, D] in T, then f32 q [rep, D],
// acc [rep, D], scores [rep, bs] and m, l, alpha [rep]. Keep in step with
// paged_attention_smem_bytes in ops/paged_attention.py.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ cache, T* __restrict__ out,
    const int* __restrict__ table, int64_t table_stride, const int* __restrict__ token_seq,
    const int* __restrict__ token_pos, const int* __restrict__ token_valid, int H, int layer,
    int NB, int KVH, int bs, int D, int S, int MB, float scale) {
    const int t = blockIdx.x;
    const int g = blockIdx.y;  // kv head
    const int rep = H / KVH;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

    extern __shared__ __align__(16) unsigned char smem[];
    T* k_s = reinterpret_cast<T*>(smem);
    T* v_s = k_s + bs * D;
    float* q_s = reinterpret_cast<float*>(v_s + bs * D);
    float* acc_s = q_s + rep * D;
    float* p_s = acc_s + rep * D;
    float* m_s = p_s + rep * bs;
    float* l_s = m_s + rep;
    float* alpha_s = l_s + rep;

    T* out_t = out + ((int64_t)t * H + (int64_t)g * rep) * D;
    if (token_valid[t] <= 0) {
        for (int i = tid; i < rep * D; i += blockDim.x) out_t[i] = from_f32<T>(0.f);
        return;
    }
    const int seq = min(token_seq[t], S - 1);
    const int pos = token_pos[t];
    const int nblocks = min(pos / bs + 1, MB);
    const int last = min(pos, nblocks * bs - 1);  // last attended position

    const T* q_t = q + ((int64_t)t * H + (int64_t)g * rep) * D;
    for (int i = tid; i < rep * D; i += blockDim.x) {
        q_s[i] = to_f32(q_t[i]) * scale;
        acc_s[i] = 0.f;
    }
    if (tid < rep) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }

    const int vec_per_row = D * (int)sizeof(T) / 16;
    for (int b = 0; b < nblocks; ++b) {
        const int block = max(table[seq * table_stride + b], 0);
        const int rows = min(bs, last - b * bs + 1);
        const uint4* k_g = reinterpret_cast<const uint4*>(cache + tile_offset(layer, 0, block, g, 0, NB, KVH, bs, D));
        const uint4* v_g = reinterpret_cast<const uint4*>(cache + tile_offset(layer, 1, block, g, 0, NB, KVH, bs, D));
        __syncthreads();  // the previous tile is fully consumed
        for (int i = tid; i < rows * vec_per_row; i += blockDim.x) {
            reinterpret_cast<uint4*>(k_s)[i] = k_g[i];
            reinterpret_cast<uint4*>(v_s)[i] = v_g[i];
        }
        __syncthreads();

        // scores: one warp per row, lanes split D
        for (int r = warp; r < rows; r += nwarps) {
            const T* k_row = k_s + r * D;
            for (int h = 0; h < rep; ++h) {
                float s = 0.f;
                for (int d = lane; d < D; d += 32) s += q_s[h * D + d] * to_f32(k_row[d]);
                s = warp_sum(s);
                if (lane == 0) p_s[h * bs + r] = s;
            }
        }
        __syncthreads();

        // online softmax: one warp per query head
        for (int h = warp; h < rep; h += nwarps) {
            float mx = kNegInf;
            for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[h * bs + r]);
            mx = warp_max(mx);
            const float m_old = m_s[h];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
            for (int r = lane; r < rows; r += 32) {
                const float e = expf(p_s[h * bs + r] - m_new);
                p_s[h * bs + r] = e;
                sum += e;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                alpha_s[h] = alpha;
                l_s[h] = l_s[h] * alpha + sum;
                m_s[h] = m_new;
            }
        }
        __syncthreads();

        // acc = acc * alpha + P V: one thread per (head, d)
        for (int i = tid; i < rep * D; i += blockDim.x) {
            const int h = i / D, d = i - h * D;
            const float* p_h = p_s + h * bs;
            float a = acc_s[i] * alpha_s[h];
            for (int r = 0; r < rows; ++r) a += p_h[r] * to_f32(v_s[r * D + d]);
            acc_s[i] = a;
        }
    }
    __syncthreads();
    for (int i = tid; i < rep * D; i += blockDim.x) {
        out_t[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-20f));
    }
}

size_t smem_bytes(int bs, int D, int rep, size_t elem) {
    return 2 * (size_t)bs * D * elem + sizeof(float) * (2 * (size_t)rep * D + (size_t)rep * bs + 3 * (size_t)rep);
}

template <typename T>
int launch_insert(const void* k_new, const void* v_new, void* cache, const int* table,
                  int64_t table_stride, const int* token_seq, const int* token_pos,
                  const int* token_valid, int T_, int layer, int NB, int KVH, int bs, int D, int S,
                  int MB, cudaStream_t stream) {
    paged_kv_insert_kernel<T><<<T_, kThreads, 0, stream>>>(
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<T*>(cache), table,
        table_stride, token_seq, token_pos, token_valid, layer, NB, KVH, bs, D, S, MB);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_attention(const void* q, const void* cache, void* out, const int* table,
                     int64_t table_stride, const int* token_seq, const int* token_pos,
                     const int* token_valid, int T_, int H, int layer, int NB, int KVH, int bs,
                     int D, int S, int MB, float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes(bs, D, H / KVH, sizeof(T));
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(T_, KVH);
    paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(cache), static_cast<T*>(out), table,
        table_stride, token_seq, token_pos, token_valid, H, layer, NB, KVH, bs, D, S, MB, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16. Each function returns
// cudaGetLastError() after its launch (0 on success), or -1 for a bad dtype.
extern "C" {

int dstt_paged_kv_insert(const void* k_new, const void* v_new, void* cache, int dtype,
                         const int* table, int64_t table_stride, const int* token_seq,
                         const int* token_pos, const int* token_valid, int T, int layer, int NB,
                         int KVH, int bs, int D, int S, int MB, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_insert<float>(k_new, v_new, cache, table, table_stride, token_seq, token_pos, token_valid, T, layer, NB, KVH, bs, D, S, MB, s);
        case 1: return launch_insert<__half>(k_new, v_new, cache, table, table_stride, token_seq, token_pos, token_valid, T, layer, NB, KVH, bs, D, S, MB, s);
        case 2: return launch_insert<__nv_bfloat16>(k_new, v_new, cache, table, table_stride, token_seq, token_pos, token_valid, T, layer, NB, KVH, bs, D, S, MB, s);
        default: return -1;
    }
}

int dstt_paged_attention(const void* q, const void* cache, void* out, int dtype, const int* table,
                         int64_t table_stride, const int* token_seq, const int* token_pos,
                         const int* token_valid, int T, int H, int layer, int NB, int KVH, int bs,
                         int D, int S, int MB, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_attention<float>(q, cache, out, table, table_stride, token_seq, token_pos, token_valid, T, H, layer, NB, KVH, bs, D, S, MB, scale, s);
        case 1: return launch_attention<__half>(q, cache, out, table, table_stride, token_seq, token_pos, token_valid, T, H, layer, NB, KVH, bs, D, S, MB, scale, s);
        case 2: return launch_attention<__nv_bfloat16>(q, cache, out, table, table_stride, token_seq, token_pos, token_valid, T, H, layer, NB, KVH, bs, D, S, MB, scale, s);
        default: return -1;
    }
}

const char* dstt_error_string(int code) {
    return code < 0 ? "unsupported dtype" : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
