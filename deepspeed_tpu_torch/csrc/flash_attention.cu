// Flash attention (FlashAttention-2 schedule), forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   dstt_flash_fwd      <- _fwd_kernel      (B2): out and the per-row log-sum-exp
//   dstt_flash_bwd_dkv  <- _bwd_dkv_kernel  (B3): dK, dV
//   dstt_flash_bwd_dq   <- _bwd_dq_kernel   (B4): dQ
// with the same arithmetic: s = (q . k) * scale in f32, masked entries set to
// -1e30, an f32 online softmax with l floored at 1e-30, lse = m + log(l);
// the backward recomputes p = exp(s - lse) (0 where masked),
// ds = p * (dO . v - delta) * scale, dV += p^T dO, dK += ds^T q, dQ += ds k,
// with delta = rowsum(dO * out) computed by the caller (as the JAX package
// computes it in XLA, outside its kernels).
//
// Layout: q, out, dout, dq are [B, S, H, D]; k, v, dk, dv are [B, S, KVH, D]
// (all contiguous); lse and delta are f32 [B, H, S]. GQA is read in place:
// query head h reads KV head h / (H / KVH), and the dK/dV kernel sums the
// H / KVH query heads of its KV head in f32, so no repeated K/V is made.
// S may be any length: rows and columns past S are loaded as zeros, masked
// out of the softmax and never written.
//
// Design. The Pallas grid walks the KV blocks of one q block in order and
// carries its accumulators in VMEM scratch; here one thread block owns a
// 64-row tile (q rows for the forward and dQ, key rows for dK/dV) and walks
// the other side's 64-row tiles in a loop. Products run on the tensor cores
// through nvcuda::wmma (16x16x16 bf16/fp16 fragments, f32 accumulators):
// S = Q K^T, O += P V and, backward, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q and dQ += dS K. P and dS are rounded to the input type before
// their products, as FlashAttention-2 does; every sum is in f32. The
// forward's output accumulator lives in shared memory, because each KV tile
// rescales it by exp(m_old - m_new) row by row and a fragment's element to
// row mapping is opaque; the backward keeps its accumulators in fragments.
// Causal: a q tile visits KV tiles 0..its own index (tiles are square), and
// the dK/dV kernel starts at its own tile; the diagonal tile is masked.
//
// Bound on an H100 SXM: at the training shape (B = 8, S = 1024, H = 16,
// D = 128) a causal forward does 2 * 2 * B * H * S^2 * D / 2 = 34.4 GFLOP
// against 4 * B * S * H * D * 2 bytes plus the f32 lse, 134.7 MB: about 255
// flops per byte, under the card's ridge of about 295 (989 TFLOP/s over
// 3.35 TB/s). So memory bounds it, at 0.040 ms, with the tensor cores' 0.035 ms
// close behind. This first version stages each tile with plain 16-byte loads and a barrier
// (no cp.async/TMA pipeline, no wgmma, no warp specialisation), so it stays
// far from that bound. Launch and build: ops/flash_attention.py, ops/builder.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;        // rows of every tile, q and kv
constexpr int kLdS = kTile + 4;  // f32 score tiles
constexpr int kLdP = kTile + 8;  // 16-bit probability tiles

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Copy `rows` rows of D elements (row stride `stride` elements in global
// memory) into a [kTile, D + 8] shared tile, with zeros past `rows`. 16-byte
// vectors: D * sizeof(T) is a multiple of 16 and the tensors are 16-byte aligned.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride, int rows, int tid,
                                          int nthreads) {
    constexpr int kVec = D * (int)sizeof(T) / 16;
    constexpr int kLd = D + 8;
    for (int i = tid; i < kTile * kVec; i += nthreads) {
        const int r = i / kVec, c = i - r * kVec;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows) val = reinterpret_cast<const uint4*>(src + r * stride)[c];
        reinterpret_cast<uint4*>(dst + r * kLd)[c] = val;
    }
}

template <typename T>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
template <typename T>
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major>;
template <typename T>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
template <typename T>
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ------------------------------------------------------------------ forward --
constexpr int kFwdThreads = 128;  // 4 warps, 16 q rows each

template <int D>
constexpr size_t fwd_smem_bytes(size_t elem) {
    return 3 * (size_t)kTile * (D + 8) * elem          // Q, K, V tiles
           + (size_t)kTile * kLdS * 4                   // scores
           + (size_t)kTile * kLdP * elem                // probabilities
           + (size_t)kTile * (D + 4) * 4                // output accumulator
           + 2 * (size_t)kTile * 4;                     // m, l
}

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, int S, int H, int KVH, float scale, int causal) {
    constexpr int kLd = D + 8, kLdO = D + 4;
    const int n_tiles = (S + kTile - 1) / kTile;
    const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int g = h / (H / KVH);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = qt * kTile;

    extern __shared__ __align__(128) unsigned char smem[];
    T* q_s = reinterpret_cast<T*>(smem);
    T* k_s = q_s + kTile * kLd;
    T* v_s = k_s + kTile * kLd;
    float* s_s = reinterpret_cast<float*>(v_s + kTile * kLd);
    T* p_s = reinterpret_cast<T*>(s_s + kTile * kLdS);
    float* o_s = reinterpret_cast<float*>(p_s + kTile * kLdP);
    float* m_s = o_s + kTile * kLdO;
    float* l_s = m_s + kTile;

    const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KVH * D;
    load_tile<T, D>(q_s, q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * D, q_stride, S - q0, tid,
                    kFwdThreads);
    for (int i = tid; i < kTile * kLdO; i += kFwdThreads) o_s[i] = 0.f;
    if (tid < kTile) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    __syncthreads();

    const int row0 = warp * 16;  // this warp's rows of the tile
    FragA<T> qa[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qa[kk], q_s + row0 * kLd + kk * 16, kLd);

    const int last = causal ? qt : n_tiles - 1;
    for (int kt = 0; kt <= last; ++kt) {
        const int k0 = kt * kTile;
        __syncthreads();  // the previous K/V tiles are consumed
        const int64_t kv_off = ((int64_t)b * S + k0) * kv_stride + (int64_t)g * D;
        load_tile<T, D>(k_s, k + kv_off, kv_stride, S - k0, tid, kFwdThreads);
        load_tile<T, D>(v_s, v + kv_off, kv_stride, S - k0, tid, kFwdThreads);
        __syncthreads();

        // S = Q K^T for this warp's 16 rows
#pragma unroll
        for (int n = 0; n < kTile / 16; ++n) {
            FragC acc;
            wmma::fill_fragment(acc, 0.f);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                FragBt<T> kb;
                wmma::load_matrix_sync(kb, k_s + n * 16 * kLd + kk * 16, kLd);
                wmma::mma_sync(acc, qa[kk], kb, acc);
            }
            wmma::store_matrix_sync(s_s + row0 * kLdS + n * 16, acc, kLdS, wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax: lanes 2r and 2r + 1 share row r of the warp's 16,
        // each taking the columns of its parity, so the 16 rows run at once
        {
            const int row = row0 + (lane >> 1), par = lane & 1, qpos = q0 + row;
            float sv[kTile / 2];
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < kTile / 2; ++j) {
                const int c = 2 * j + par, kpos = k0 + c;
                const bool ok = kpos < S && (!causal || kpos <= qpos);
                sv[j] = ok ? s_s[row * kLdS + c] * scale : kNegInf;
                mx = fmaxf(mx, sv[j]);
            }
            const float m_old = m_s[row];
            const float m_new = fmaxf(m_old, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kTile / 2; ++j) {
                const float p = __expf(sv[j] - m_new);
                p_s[row * kLdP + 2 * j + par] = from_f32<T>(p);
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            const float alpha = __expf(m_old - m_new);
            for (int d = par; d < D; d += 2) o_s[row * kLdO + d] *= alpha;
            __syncwarp();  // both lanes of the pair have read m_s[row]
            if (par == 0) {
                l_s[row] = l_s[row] * alpha + sum;
                m_s[row] = m_new;
            }
        }
        __syncwarp();

        // O += P V for this warp's rows
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
            FragC acc;
            float* o_ptr = o_s + row0 * kLdO + n * 16;
            wmma::load_matrix_sync(acc, o_ptr, kLdO, wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < kTile / 16; ++kk) {
                FragA<T> pa;
                FragB<T> vb;
                wmma::load_matrix_sync(pa, p_s + row0 * kLdP + kk * 16, kLdP);
                wmma::load_matrix_sync(vb, v_s + kk * 16 * kLd + n * 16, kLd);
                wmma::mma_sync(acc, pa, vb, acc);
            }
            wmma::store_matrix_sync(o_ptr, acc, kLdO, wmma::mem_row_major);
        }
        __syncwarp();
    }

    for (int r = 0; r < 16; ++r) {
        const int row = row0 + r, qpos = q0 + row;
        if (qpos >= S) break;
        const float l = fmaxf(l_s[row], 1e-30f);
        const float inv = 1.f / l;
        T* o_g = out + ((int64_t)b * S + qpos) * q_stride + (int64_t)h * D;
        for (int d = lane; d < D; d += 32) o_g[d] = from_f32<T>(o_s[row * kLdO + d] * inv);
        if (lane == 0) lse[(int64_t)bh * S + qpos] = m_s[row] + logf(l);
    }
}

// ----------------------------------------------------------------- backward --
constexpr int kBwdThreads = 256;  // 8 warps

template <int D>
constexpr size_t bwd_smem_bytes(size_t elem) {
    return 4 * (size_t)kTile * (D + 8) * elem  // Q, dO, K, V tiles
           + 2 * (size_t)kTile * kLdS * 4       // S (then P), dP
           + 2 * (size_t)kTile * kLdP * elem    // P, dS in T
           + 2 * (size_t)kTile * 4;             // lse, delta
}

struct BwdSmem {
    void* q;
    void* dout;
    void* k;
    void* v;
    float* s;
    float* dp;
    void* p;
    void* ds;
    float* lse;
    float* delta;
};

template <typename T, int D>
__device__ __forceinline__ BwdSmem bwd_smem(unsigned char* smem) {
    constexpr int kLd = D + 8;
    BwdSmem m;
    T* base = reinterpret_cast<T*>(smem);
    m.q = base;
    m.dout = base + kTile * kLd;
    m.k = base + 2 * kTile * kLd;
    m.v = base + 3 * kTile * kLd;
    m.s = reinterpret_cast<float*>(base + 4 * kTile * kLd);
    m.dp = m.s + kTile * kLdS;
    m.p = m.dp + kTile * kLdS;
    m.ds = reinterpret_cast<T*>(m.p) + kTile * kLdP;
    m.lse = reinterpret_cast<float*>(reinterpret_cast<T*>(m.ds) + kTile * kLdP);
    m.delta = m.lse + kTile;
    return m;
}

// S = Q K^T and dP = dO V^T over the 64 x 64 tile: warp w computes the two
// 16 x 16 blocks at row block w / 2, column blocks 2 (w % 2) and 2 (w % 2) + 1.
template <typename T, int D>
__device__ __forceinline__ void scores_and_dp(const BwdSmem& m, int warp) {
    constexpr int kLd = D + 8;
    const T* q_s = static_cast<const T*>(m.q);
    const T* do_s = static_cast<const T*>(m.dout);
    const T* k_s = static_cast<const T*>(m.k);
    const T* v_s = static_cast<const T*>(m.v);
    const int rb = warp >> 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int cb = 2 * (warp & 1) + j;
        FragC s_acc, dp_acc;
        wmma::fill_fragment(s_acc, 0.f);
        wmma::fill_fragment(dp_acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            FragA<T> a;
            FragBt<T> bt;
            wmma::load_matrix_sync(a, q_s + rb * 16 * kLd + kk * 16, kLd);
            wmma::load_matrix_sync(bt, k_s + cb * 16 * kLd + kk * 16, kLd);
            wmma::mma_sync(s_acc, a, bt, s_acc);
            wmma::load_matrix_sync(a, do_s + rb * 16 * kLd + kk * 16, kLd);
            wmma::load_matrix_sync(bt, v_s + cb * 16 * kLd + kk * 16, kLd);
            wmma::mma_sync(dp_acc, a, bt, dp_acc);
        }
        wmma::store_matrix_sync(m.s + rb * 16 * kLdS + cb * 16, s_acc, kLdS, wmma::mem_row_major);
        wmma::store_matrix_sync(m.dp + rb * 16 * kLdS + cb * 16, dp_acc, kLdS, wmma::mem_row_major);
    }
}

// p = exp(s * scale - lse) (0 where masked), ds = p (dp - delta) scale, both
// rounded to T. Rows are q positions q0.., columns key positions k0...
template <typename T>
__device__ __forceinline__ void probabilities(const BwdSmem& m, int q0, int k0, int S, float scale,
                                              int causal, bool want_p, int tid) {
    T* p_s = static_cast<T*>(m.p);
    T* ds_s = static_cast<T*>(m.ds);
    for (int i = tid; i < kTile * kTile; i += kBwdThreads) {
        const int r = i / kTile, c = i - r * kTile;
        const int qpos = q0 + r, kpos = k0 + c;
        const bool ok = qpos < S && kpos < S && (!causal || kpos <= qpos);
        const float p = ok ? __expf(m.s[r * kLdS + c] * scale - m.lse[r]) : 0.f;
        const float ds = p * (m.dp[r * kLdS + c] - m.delta[r]) * scale;
        if (want_p) p_s[r * kLdP + c] = from_f32<T>(p);
        ds_s[r * kLdP + c] = from_f32<T>(ds);
    }
}

// Write a warp's 16 x 16 f32 fragment as T rows row0.. (those < S) of a
// [B, S, heads, D] tensor, through a per-warp 16 x 16 f32 scratch.
template <typename T>
__device__ __forceinline__ void store_fragment(const FragC& acc, float* scratch, T* dst, int64_t stride,
                                               int rows_left, int lane) {
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        if (r < rows_left) dst[r * stride + c] = from_f32<T>(scratch[e]);
    }
    __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int KVH, float scale, int causal) {
    constexpr int kLd = D + 8;
    constexpr int kCols = D / 32;  // 16-wide column blocks per warp (half of D)
    const int n_tiles = (S + kTile - 1) / kTile;
    const int kt = blockIdx.x;
    const int bg = blockIdx.y, b = bg / KVH, g = bg - b * KVH;
    const int rep = H / KVH;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int k0 = kt * kTile;

    extern __shared__ __align__(128) unsigned char smem[];
    const BwdSmem m = bwd_smem<T, D>(smem);
    const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KVH * D;
    const int64_t kv_off = ((int64_t)b * S + k0) * kv_stride + (int64_t)g * D;
    load_tile<T, D>(static_cast<T*>(m.k), k + kv_off, kv_stride, S - k0, tid, kBwdThreads);
    load_tile<T, D>(static_cast<T*>(m.v), v + kv_off, kv_stride, S - k0, tid, kBwdThreads);

    const int kr = warp & 3, ch = warp >> 2;  // key row block, half of D
    FragC dk_acc[kCols], dv_acc[kCols];
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
        wmma::fill_fragment(dk_acc[n], 0.f);
        wmma::fill_fragment(dv_acc[n], 0.f);
    }

    for (int hh = 0; hh < rep; ++hh) {
        const int h = g * rep + hh;
        const int64_t row_off = ((int64_t)b * H + h) * S;
        for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
            const int q0 = qt * kTile;
            __syncthreads();  // the previous q tile is consumed
            const int64_t q_off = ((int64_t)b * S + q0) * q_stride + (int64_t)h * D;
            load_tile<T, D>(static_cast<T*>(m.q), q + q_off, q_stride, S - q0, tid, kBwdThreads);
            load_tile<T, D>(static_cast<T*>(m.dout), dout + q_off, q_stride, S - q0, tid, kBwdThreads);
            if (tid < kTile) {
                const bool ok = q0 + tid < S;
                m.lse[tid] = ok ? lse[row_off + q0 + tid] : 0.f;
                m.delta[tid] = ok ? delta[row_off + q0 + tid] : 0.f;
            }
            __syncthreads();
            scores_and_dp<T, D>(m, warp);
            __syncthreads();
            probabilities<T>(m, q0, k0, S, scale, causal, true, tid);
            __syncthreads();

            // dV += P^T dO, dK += dS^T Q: rows are this warp's 16 keys
            const T* p_s = static_cast<const T*>(m.p);
            const T* ds_s = static_cast<const T*>(m.ds);
            const T* q_s = static_cast<const T*>(m.q);
            const T* do_s = static_cast<const T*>(m.dout);
#pragma unroll
            for (int kk = 0; kk < kTile / 16; ++kk) {
                FragAt<T> pt, dst;
                wmma::load_matrix_sync(pt, p_s + kk * 16 * kLdP + kr * 16, kLdP);
                wmma::load_matrix_sync(dst, ds_s + kk * 16 * kLdP + kr * 16, kLdP);
#pragma unroll
                for (int n = 0; n < kCols; ++n) {
                    const int col = (ch * kCols + n) * 16;
                    FragB<T> bf;
                    wmma::load_matrix_sync(bf, do_s + kk * 16 * kLd + col, kLd);
                    wmma::mma_sync(dv_acc[n], pt, bf, dv_acc[n]);
                    wmma::load_matrix_sync(bf, q_s + kk * 16 * kLd + col, kLd);
                    wmma::mma_sync(dk_acc[n], dst, bf, dk_acc[n]);
                }
            }
        }
    }

    __syncthreads();  // the score tiles become per-warp store scratch
    float* scratch = m.s + warp * 256;
    const int key0 = k0 + kr * 16;
    const int64_t out_off = ((int64_t)b * S + key0) * kv_stride + (int64_t)g * D;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
        const int col = (ch * kCols + n) * 16;
        store_fragment<T>(dk_acc[n], scratch, dk + out_off + col, kv_stride, S - key0, lane);
        store_fragment<T>(dv_acc[n], scratch, dv + out_off + col, kv_stride, S - key0, lane);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
    int KVH, float scale, int causal) {
    constexpr int kLd = D + 8;
    constexpr int kCols = D / 32;
    const int n_tiles = (S + kTile - 1) / kTile;
    const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int g = h / (H / KVH);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = qt * kTile;

    extern __shared__ __align__(128) unsigned char smem[];
    const BwdSmem m = bwd_smem<T, D>(smem);
    const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KVH * D;
    const int64_t q_off = ((int64_t)b * S + q0) * q_stride + (int64_t)h * D;
    load_tile<T, D>(static_cast<T*>(m.q), q + q_off, q_stride, S - q0, tid, kBwdThreads);
    load_tile<T, D>(static_cast<T*>(m.dout), dout + q_off, q_stride, S - q0, tid, kBwdThreads);
    if (tid < kTile) {
        const bool ok = q0 + tid < S;
        m.lse[tid] = ok ? lse[(int64_t)bh * S + q0 + tid] : 0.f;
        m.delta[tid] = ok ? delta[(int64_t)bh * S + q0 + tid] : 0.f;
    }

    const int qr = warp & 3, ch = warp >> 2;  // q row block, half of D
    FragC dq_acc[kCols];
#pragma unroll
    for (int n = 0; n < kCols; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

    const int last = causal ? qt : n_tiles - 1;
    for (int kt = 0; kt <= last; ++kt) {
        const int k0 = kt * kTile;
        __syncthreads();  // the previous K/V tiles are consumed
        const int64_t kv_off = ((int64_t)b * S + k0) * kv_stride + (int64_t)g * D;
        load_tile<T, D>(static_cast<T*>(m.k), k + kv_off, kv_stride, S - k0, tid, kBwdThreads);
        load_tile<T, D>(static_cast<T*>(m.v), v + kv_off, kv_stride, S - k0, tid, kBwdThreads);
        __syncthreads();
        scores_and_dp<T, D>(m, warp);
        __syncthreads();
        probabilities<T>(m, q0, k0, S, scale, causal, false, tid);
        __syncthreads();

        // dQ += dS K: rows are this warp's 16 q rows
        const T* ds_s = static_cast<const T*>(m.ds);
        const T* k_s = static_cast<const T*>(m.k);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
            FragA<T> dsa;
            wmma::load_matrix_sync(dsa, ds_s + qr * 16 * kLdP + kk * 16, kLdP);
#pragma unroll
            for (int n = 0; n < kCols; ++n) {
                FragB<T> kb;
                wmma::load_matrix_sync(kb, k_s + kk * 16 * kLd + (ch * kCols + n) * 16, kLd);
                wmma::mma_sync(dq_acc[n], dsa, kb, dq_acc[n]);
            }
        }
    }

    __syncthreads();
    float* scratch = m.s + warp * 256;
    const int row0 = q0 + qr * 16;
    const int64_t out_off = ((int64_t)b * S + row0) * q_stride + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
        store_fragment<T>(dq_acc[n], scratch, dq + out_off + (ch * kCols + n) * 16, q_stride, S - row0, lane);
    }
}

// ------------------------------------------------------------------ launch --
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int H,
               int KVH, float scale, int causal, cudaStream_t stream) {
    const size_t smem = fwd_smem_bytes<D>(sizeof(T));
    int err = set_smem(flash_fwd_kernel<T, D>, smem);
    if (err) return err;
    dim3 grid((S + kTile - 1) / kTile, B * H);
    flash_fwd_kernel<T, D><<<grid, kFwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), lse,
        S, H, KVH, scale, causal);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int S, int H, int KVH, float scale, int causal,
               cudaStream_t stream) {
    const size_t smem = bwd_smem_bytes<D>(sizeof(T));
    int err = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
    if (err) return err;
    dim3 grid((S + kTile - 1) / kTile, B * KVH);
    flash_bwd_dkv_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KVH, scale,
        causal);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int S, int H, int KVH, float scale, int causal,
              cudaStream_t stream) {
    const size_t smem = bwd_smem_bytes<D>(sizeof(T));
    int err = set_smem(flash_bwd_dq_kernel<T, D>, smem);
    if (err) return err;
    dim3 grid((S + kTile - 1) / kTile, B * H);
    flash_bwd_dq_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, H, KVH, scale, causal);
    return (int)cudaGetLastError();
}

constexpr int kBadDtype = -1, kBadHeadDim = -2;

}  // namespace

// dtype codes: 1 float16, 2 bfloat16; head_dim 64 or 128. Each function
// returns cudaGetLastError() after its launch (0 on success), -1 for an
// unsupported dtype or -2 for an unsupported head_dim.
#define DSTT_DISPATCH(FN, ...)                                                     \
    switch (dtype * 1000 + D) {                                                    \
        case 1064: return FN<__half, 64>(__VA_ARGS__);                             \
        case 1128: return FN<__half, 128>(__VA_ARGS__);                            \
        case 2064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                      \
        case 2128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                     \
        default: return (dtype == 1 || dtype == 2) ? kBadHeadDim : kBadDtype;      \
    }

extern "C" {

int dstt_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int dtype, int B,
                   int S, int H, int KVH, int D, float scale, int causal, void* stream) {
    DSTT_DISPATCH(launch_fwd, q, k, v, out, lse, B, S, H, KVH, scale, causal, static_cast<cudaStream_t>(stream))
}

int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int dtype, int B, int S, int H, int KVH, int D,
                       float scale, int causal, void* stream) {
    DSTT_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, S, H, KVH, scale, causal,
                  static_cast<cudaStream_t>(stream))
}

int dstt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int dtype, int B, int S, int H, int KVH, int D, float scale,
                      int causal, void* stream) {
    DSTT_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, S, H, KVH, scale, causal,
                  static_cast<cudaStream_t>(stream))
}

const char* dstt_flash_error_string(int code) {
    if (code == kBadDtype) return "unsupported dtype";
    if (code == kBadHeadDim) return "unsupported head_dim";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
