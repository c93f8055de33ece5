// Block-sparse flash attention, forward, for Hopper (sm_90a).
//
// Replaces deepspeed_tpu/ops/pallas/block_sparse_attention.py::_sparse_fwd_kernel (B5):
//   dstt_block_sparse_fwd <- _sparse_fwd_kernel, through _sparse_fwd_pallas
// with the same arithmetic: s = (q . k) * scale in f32; a score whose layout
// cell is off is set to -1e30; an f32 online softmax in which a row with no
// attended cell in a tile leaves m, l and the accumulator untouched (the
// guarded exp); l floored at 1e-30; rows that attend no cell anywhere write
// zeros; the output in q's dtype. The backward is torch ops
// (ops/block_sparse_attention.py), as the JAX package computes it in XLA.
//
// Layout: q, k, v, out are [B, H, S, D], contiguous, as the JAX function
// takes them (the flash kernels take [B, S, H, D]). The layout's cells are
// `lb` x `lb` tokens; S is a multiple of lb but need not be one of 64: rows
// and columns past S load as zeros, are masked and never written.
//
// Design. The Pallas grid walks, for each (head, q block), the KV blocks on a
// list prefetched into SMEM, and carries the softmax in VMEM scratch. Here one
// thread block owns a 64-row q tile of one (batch, head) and walks its own
// list of attended 64-row KV tiles in a loop; the wrapper builds the lists on
// the host once per layout and keeps them on the card. A list entry is
// kv_tile * 2 + partial. Where every layout cell a tile pair covers is on
// (always, when lb is a multiple of 64: a tile then lies inside one cell),
// the tile needs no mask but S's edge; where some is off (lb of 16: a tile
// pair covers 4 x 4 cells), the kernel reads each score's cell from the
// layout, a uint8 [H, nb, nb] tensor. So the work follows the layout's cells
// at 64-token grain, not the TPU's 256-token blocks and their 32-cell
// bitfield, which are limits of the TPU's SMEM. The products are B2's
// (flash_attention.cu): nvcuda::wmma 16x16x16 bf16/fp16 fragments with f32
// accumulators, P rounded to the input type before P V, the output
// accumulator in shared memory (rescaled row by row, which a fragment's
// opaque element-to-row mapping does not allow), two lanes per row in the
// softmax.
//
// Launch order and balance. A BigBird global row attends every KV tile while
// the others attend a handful, so the longest list sets the kernel's tail.
// The wrapper passes the (head, q tile) items sorted by decreasing list
// length, and block i takes the i-th item (of each batch row), so the long
// rows start first and the short ones run beside them; in index order a
// head's global row would wait behind the short rows of the heads before it
// (PERF.md gives B5's time in both orders, from chip_smoke.py). A long row
// still runs on one block alone: splitting it across blocks (and merging the
// partial softmaxes) is what this first version leaves on the table, with a
// cp.async/TMA pipeline of the K/V tiles and wgmma.
//
// Bound on an H100 SXM at the configuration bench.py measures (B = 1,
// H = 16, S = 8192, D = 128, lb = 64, BigBird): q, k, v and out are 134 MB,
// 0.040 ms at 3.35 TB/s; the products are 4 B H S^2 D x density flops,
// 5.5e11 x density, so a layout of density about 0.072 or more is bound by
// the tensor cores (989 TFLOP/s) and a sparser one by memory. Launch and
// build: ops/block_sparse_attention.py, ops/builder.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;        // rows of every tile, q and kv
constexpr int kLdS = kTile + 4;  // f32 score tile
constexpr int kLdP = kTile + 8;  // 16-bit probability tile
constexpr int kThreads = 128;    // 4 warps, 16 q rows each

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Copy `rows` rows of D contiguous elements into a [kTile, D + 8] shared
// tile, with zeros past `rows`. 16-byte vectors: D * sizeof(T) is a multiple
// of 16 and the tensors are 16-byte aligned.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows, int tid) {
    constexpr int kVec = D * (int)sizeof(T) / 16;
    constexpr int kLd = D + 8;
    for (int i = tid; i < kTile * kVec; i += kThreads) {
        const int r = i / kVec, c = i - r * kVec;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows) val = reinterpret_cast<const uint4*>(src + (int64_t)r * D)[c];
        reinterpret_cast<uint4*>(dst + r * kLd)[c] = val;
    }
}

template <typename T>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
template <typename T>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
template <typename T>
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
constexpr size_t smem_bytes(size_t elem) {
    return 3 * (size_t)kTile * (D + 8) * elem  // Q, K, V tiles
           + (size_t)kTile * kLdS * 4           // scores
           + (size_t)kTile * kLdP * elem        // probabilities
           + (size_t)kTile * (D + 4) * 4        // output accumulator
           + 2 * (size_t)kTile * 4;             // m, l
}

// steps [H, nt, max_steps]: kv_tile * 2 + partial; counts [H, nt]; order
// [H * nt]: items h * nt + qt, longest lists first; cells [H, nb, nb].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) block_sparse_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ steps, const int* __restrict__ counts, const int* __restrict__ order,
    const unsigned char* __restrict__ cells, int B, int H, int S, int lb, int nt, int max_steps,
    float scale) {
    constexpr int kLd = D + 8, kLdO = D + 4;
    const int rank = blockIdx.x / B, b = blockIdx.x - rank * B;
    const int item = order[rank];
    const int h = item / nt, qt = item - h * nt;
    const int n_steps = counts[item];
    const int* list = steps + (int64_t)item * max_steps;
    const int nb = S / lb;
    const unsigned char* lay = cells + (int64_t)h * nb * nb;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = qt * kTile;
    const int64_t head = ((int64_t)b * H + h) * S * D;

    extern __shared__ __align__(128) unsigned char smem[];
    T* q_s = reinterpret_cast<T*>(smem);
    T* k_s = q_s + kTile * kLd;
    T* v_s = k_s + kTile * kLd;
    float* s_s = reinterpret_cast<float*>(v_s + kTile * kLd);
    T* p_s = reinterpret_cast<T*>(s_s + kTile * kLdS);
    float* o_s = reinterpret_cast<float*>(p_s + kTile * kLdP);
    float* m_s = o_s + kTile * kLdO;
    float* l_s = m_s + kTile;

    load_tile<T, D>(q_s, q + head + (int64_t)q0 * D, S - q0, tid);
    for (int i = tid; i < kTile * kLdO; i += kThreads) o_s[i] = 0.f;
    if (tid < kTile) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    __syncthreads();

    const int row0 = warp * 16;  // this warp's rows of the tile
    FragA<T> qa[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qa[kk], q_s + row0 * kLd + kk * 16, kLd);

    // the softmax's row: lanes 2r and 2r + 1 share row r of the warp's 16
    const int row = row0 + (lane >> 1), par = lane & 1, qpos = q0 + row;
    const bool row_in = qpos < S;
    const unsigned char* lay_row = lay + (int64_t)(row_in ? qpos / lb : 0) * nb;

    for (int st = 0; st < n_steps; ++st) {
        const int entry = list[st];
        const int k0 = (entry >> 1) * kTile;
        const bool partial = entry & 1;
        __syncthreads();  // the previous K/V tiles are consumed
        load_tile<T, D>(k_s, k + head + (int64_t)k0 * D, S - k0, tid);
        load_tile<T, D>(v_s, v + head + (int64_t)k0 * D, S - k0, tid);
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

        // online softmax, each lane of a pair taking the columns of its parity
        {
            float sv[kTile / 2];
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < kTile / 2; ++j) {
                const int c = 2 * j + par, kpos = k0 + c;
                const bool ok = row_in && kpos < S && (!partial || lay_row[kpos / lb]);
                sv[j] = ok ? s_s[row * kLdS + c] * scale : kNegInf;
                mx = fmaxf(mx, sv[j]);
            }
            const float m_old = m_s[row];
            const float m_new = fmaxf(m_old, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
            // the guarded exp: a row with nothing attended so far keeps p = 0
            // and alpha = 1, so no exp(-1e30 + 1e30) = 1 enters l or O
            const bool live = m_new > 0.5f * kNegInf;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kTile / 2; ++j) {
                const float p = live ? __expf(sv[j] - m_new) : 0.f;
                p_s[row * kLdP + 2 * j + par] = from_f32<T>(p);
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            const float alpha = live ? __expf(m_old - m_new) : 1.f;
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

    // rows with no attended cell anywhere (m still -1e30) write zeros
    for (int r = 0; r < 16; ++r) {
        const int orow = row0 + r, opos = q0 + orow;
        if (opos >= S) break;
        const float inv = m_s[orow] > 0.5f * kNegInf ? 1.f / fmaxf(l_s[orow], 1e-30f) : 0.f;
        T* o_g = out + head + (int64_t)opos * D;
        for (int d = lane; d < D; d += 32) o_g[d] = from_f32<T>(o_s[orow * kLdO + d] * inv);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, const int* steps, const int* counts,
           const int* order, const unsigned char* cells, int B, int H, int S, int lb, int nt, int max_steps,
           float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>(sizeof(T));
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(block_sparse_fwd_kernel<T, D>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    block_sparse_fwd_kernel<T, D><<<dim3((unsigned)(B * H * nt)), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), steps,
        counts, order, cells, B, H, S, lb, nt, max_steps, scale);
    return (int)cudaGetLastError();
}

constexpr int kBadDtype = -1, kBadHeadDim = -2, kBadShape = -3;

}  // namespace

extern "C" {

// dtype codes: 1 float16, 2 bfloat16; head_dim 64 or 128. Returns
// cudaGetLastError() after the launch (0 on success), -1 for an unsupported
// dtype, -2 for an unsupported head_dim, -3 for S not a multiple of lb or a
// tile count that does not fit S.
int dstt_block_sparse_fwd(const void* q, const void* k, const void* v, void* out, const int* steps,
                          const int* counts, const int* order, const unsigned char* cells, int dtype, int B, int H,
                          int S, int D, int lb, int nt, int max_steps, float scale, void* stream) {
    if (lb <= 0 || S % lb != 0 || nt != (S + kTile - 1) / kTile || max_steps < 1) return kBadShape;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype * 1000 + D) {
        case 1064: return launch<__half, 64>(q, k, v, out, steps, counts, order, cells, B, H, S, lb, nt, max_steps, scale, st);
        case 1128: return launch<__half, 128>(q, k, v, out, steps, counts, order, cells, B, H, S, lb, nt, max_steps, scale, st);
        case 2064: return launch<__nv_bfloat16, 64>(q, k, v, out, steps, counts, order, cells, B, H, S, lb, nt, max_steps, scale, st);
        case 2128: return launch<__nv_bfloat16, 128>(q, k, v, out, steps, counts, order, cells, B, H, S, lb, nt, max_steps, scale, st);
        default: return (dtype == 1 || dtype == 2) ? kBadHeadDim : kBadDtype;
    }
}

const char* dstt_block_sparse_error_string(int code) {
    if (code == kBadDtype) return "unsupported dtype";
    if (code == kBadHeadDim) return "unsupported head_dim";
    if (code == kBadShape) return "S is not a multiple of the layout block, or the tile lists do not fit S";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
