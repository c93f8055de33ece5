// Flash attention, forward and backward, for Hopper (sm_90a).
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
// computes it in XLA, outside its kernels). P and dS are rounded to the
// input type before their products, as FlashAttention-2 does; every sum is
// in f32.
//
// Layout: q, out, dout, dq are [B, S, H, D]; k, v, dk, dv are [B, S, KVH, D]
// (all contiguous); lse and delta are f32 [B, H, S]. GQA is read in place:
// query head h reads KV head h / (H / KVH), and the dK/dV kernel sums the
// H / KVH query heads of its KV head in f32, so no repeated K/V is made.
// S may be any length: rows past S load as zeros, are masked out of the
// softmax where they would count, and are never written.
//
// Bound on an H100 SXM at the training shape (B = 8, S = 1024, H = 16,
// D = 128, causal, bf16): the forward does 2 * 2 * B * H * S^2 * D / 2 =
// 34.4 GFLOP against 134.7 MB (q, k, v, out once, f32 lse), about 255 flops
// per byte, under the card's ridge of about 295 (989 TFLOP/s over 3.35 TB/s):
// memory bounds it at 0.040 ms, the tensor cores' 0.035 ms close behind. The
// dK/dV kernel does twice the forward's products (68.7 GFLOP against 202 MB),
// so the tensor cores bound it, at 0.069 ms; so do they the dQ kernel's 51.5
// GFLOP, at 0.052 ms.
//
// Design (FlashAttention-3's shape), shared by B2, B3 and B4. A block has three
// warpgroups: one producer and two consumers. The producer's first thread
// copies tiles into shared memory by TMA (cp.async.bulk.tensor, one 64-column
// box per 128-byte-swizzled panel; rows past S arrive as zeros) into a ring
// of kStages stages, each signalled by an mbarrier; the consumers release a
// stage through a second mbarrier. setmaxnreg hands the producer's registers
// to the consumers. Each consumer warpgroup owns 64 rows and runs wgmma:
//  - B2: a block owns a 128-row q tile of one (b, h), longest causal rows
//    first, and walks 128-row K/V tiles (causal: up to the diagonal).
//    S = Q K^T is an SS wgmma (both K-major in shared memory); the softmax
//    runs on the accumulator registers (each thread holds parts of two rows;
//    two shuffles reduce a row), O stays in registers and is rescaled there,
//    and O += P V is an RS wgmma: P from registers as the A operand, V from
//    shared memory as an MN-major B operand. Only the diagonal and the ragged
//    last tile pay for the mask.
//  - B3: a block owns a 128-row K/V tile of one (b, KV head g), resident in
//    shared memory, and streams the 64-row Q and dO tiles (and their lse and
//    delta rows) of each of g's query heads (causal: from its diagonal on).
//    S^T = K Q^T and dP^T = V dO^T are SS wgmmas; P^T and dS^T are computed
//    in their accumulator registers (rows are keys) and feed dV += P^T dO and
//    dK += dS^T Q as RS wgmmas with dO and Q MN-major. dK and dV stay in f32
//    registers over all of g's query heads: no atomics, and the GQA head sum
//    is deterministic.
//  - B4: a block owns a 128-row q tile of one (b, h), longest causal rows
//    first, with its Q and dO tiles resident (one TMA load each, on their
//    own mbarrier), and streams the 64-row K and V tiles of KV head h / rep
//    (causal: up to the diagonal). S = Q K^T and dP = dO V^T are SS wgmmas;
//    each thread holds the lse and delta of its two rows in registers; P and
//    dS are computed on the accumulators (the mask only on the diagonal and
//    the ragged last tile), and dQ += dS K is an RS wgmma with dS packed
//    from registers and K as an MN-major B operand. dQ stays in f32
//    registers and is written once; GQA is read in place, with no atomics.
// The tensor maps are encoded on the host for every call (a few
// microseconds), through cuTensorMapEncodeTiled found with
// cudaGetDriverEntryPoint, so the library needs no -lcuda. The primitives
// (mbarriers, TMA, setmaxnreg, wgmma, tensor maps) are hopper.cuh's.
// Launch and build: ops/flash_attention.py, ops/builder.py.

#include "hopper.cuh"

namespace {

using namespace dstt;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------ block geometry --
constexpr int kStages = 2;             // ring stages of the streamed tiles
constexpr int kWsThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBarBytes = 64;

// ------------------------------------------------------------- forward B2 --
constexpr int kFwdRows = 128;  // q rows of a block; rows of each K/V tile

template <int D> struct FwdLayout {
    static constexpr int kBox = kFwdRows * kPanel * 2;   // one 64-column panel of a 128-row tile
    static constexpr int kTile = kFwdRows * D * 2;       // a whole tile (Q, K or V)
    static constexpr int kQ = 0, kK = kTile, kV = kK + kStages * kTile, kBar = kV + kStages * kTile;
    static constexpr int kBytes = kBar + kBarBytes + 1024;  // barriers, 1024-byte alignment slack
    static_assert(kBytes <= kSmemLimit, "B2's tiles do not fit a block's shared memory");
};

// One KV tile of the online softmax on the S accumulator (64 values: 2 rows
// x 128 columns of this thread), in the log2 domain: s * scale * log2(e).
// Rescales O, updates m and the thread's partial l, and leaves P packed as
// the A operand of O += P V.
template <bool kMask, typename T, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&o)[NO], float (&m)[2], float (&l)[2],
                                               uint32_t (&p)[32], int qpos0, int kpos0, int S, int causal,
                                               float scale_log2) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        float x = s[i] * scale_log2;
        if (kMask) {
            const int kpos = kpos0 + (i >> 2) * 8 + (i & 1), qpos = qpos0 + ((i >> 1) & 1) * 8;
            if (kpos >= S || (causal && kpos > qpos)) x = kNegInf;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < 32; ++j) p[j] = pack2(s[2 * j], s[2 * j + 1], static_cast<const T*>(nullptr));
}

template <typename T, int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, float* __restrict__ lse, int S,
                     int H, int KVH, float scale_log2, int causal) {
    using L = FwdLayout<D>;
    constexpr int kPanels = D / kPanel;
    const int n_tiles = (S + kFwdRows - 1) / kFwdRows;
    const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int g = h / (H / KVH);
    const int q0 = qt * kFwdRows;
    const int n_kv = causal ? qt + 1 : n_tiles;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-byte alignment
    const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;
    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(bar_full + 8 * s, 1);
            mbar_init(bar_empty + 8 * s, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: its first thread issues every copy
        setmaxnreg_dec<24>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
            for (int p = 0; p < kPanels; ++p) tma_load(base + L::kQ + p * L::kBox, &tm_q, bar_q, p * kPanel, h, q0, b);
            for (int it = 0; it < n_kv; ++it) {
                const int st = it % kStages;
                mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
                mbar_expect_tx(bar_full + 8 * st, 2 * L::kTile);
#pragma unroll
                for (int p = 0; p < kPanels; ++p) {
                    tma_load(base + L::kK + st * L::kTile + p * L::kBox, &tm_k, bar_full + 8 * st, p * kPanel, g,
                             it * kFwdRows, b);
                    tma_load(base + L::kV + st * L::kTile + p * L::kBox, &tm_v, bar_full + 8 * st, p * kPanel, g,
                             it * kFwdRows, b);
                }
            }
        }
    } else {  // two consumer warpgroups, 64 q rows each
        setmaxnreg_inc<240>();
        const T* tag = nullptr;
        const int w = threadIdx.x / 128 - 1, t = threadIdx.x & 127, lane = t & 31;
        const int row = w * 64 + (t >> 5) * 16 + (lane >> 2);  // this thread's first row; the second is row + 8
        const int col = 2 * (lane & 3);
        float o[D / 2], s[kFwdRows / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
        for (int i = 0; i < kFwdRows / 2; ++i) s[i] = 0.f;
        float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
        const uint32_t q_base = base + L::kQ + w * 64 * 128;
        mbar_wait(bar_q, 0);
        for (int it = 0; it < n_kv; ++it) {
            const int st = it % kStages, k0 = it * kFwdRows;
            mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
            const uint32_t k_base = base + L::kK + st * L::kTile, v_base = base + L::kV + st * L::kTile;
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
                const uint32_t off = (ks / 4) * L::kBox + (ks % 4) * 32;
                wgmma_ss(s, desc_kmajor(q_base + off), desc_kmajor(k_base + off), ks > 0, tag);
            }
            wgmma_commit();
            wgmma_wait0();
            fence_regs(s);
            uint32_t p[kFwdRows / 4];
            const bool edge = it == n_kv - 1 && (causal || S - k0 < kFwdRows);
            if (edge) {
                online_softmax<true, T>(s, o, m, l, p, q0 + row, k0 + col, S, causal, scale_log2);
            } else {
                online_softmax<false, T>(s, o, m, l, p, q0 + row, k0 + col, S, causal, scale_log2);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kFwdRows / 16; ++kk) {
                const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
                wgmma_rs(o, a, desc_mnmajor(v_base + kk * 16 * 128, L::kBox), tag);
            }
            wgmma_commit();
            wgmma_wait0();
            fence_regs(o);
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_empty + 8 * st);
        }

        const int64_t q_stride = (int64_t)H * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            const int qpos = q0 + row + 8 * r;
            if (qpos >= S) continue;
            const float lf = fmaxf(l[r], 1e-30f), inv = 1.f / lf;
            T* dst = out + ((int64_t)b * S + qpos) * q_stride + (int64_t)h * D + col;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv, tag);
            }
            if ((lane & 3) == 0) lse[(int64_t)bh * S + qpos] = m[r] * kLn2 + logf(lf);
        }
    }
}

// ---------------------------------------------------------- dK / dV B3 --
constexpr int kDkvRows = 128;  // key rows of a block
constexpr int kDkvQRows = 64;  // rows of each streamed Q / dO tile

template <int D> struct DkvLayout {
    static constexpr int kKvBox = kDkvRows * kPanel * 2;  // one panel of the K or V tile
    static constexpr int kQBox = kDkvQRows * kPanel * 2;  // one panel of a Q or dO tile
    static constexpr int kKv = kDkvRows * D * 2, kQT = kDkvQRows * D * 2;
    // a stage: Q tile, dO tile, then lse and delta (64 f32 each), padded to 1024 bytes
    static constexpr int kStage = 2 * kQT + 1024;
    static constexpr int kK = 0, kV = kKv, kStage0 = 2 * kKv, kBar = kStage0 + kStages * kStage;
    static constexpr int kBytes = kBar + kBarBytes + 1024;
    static_assert(kBytes <= kSmemLimit, "B3's tiles do not fit a block's shared memory");
};

// P^T and dS^T of one (64 keys x 64 q) tile on the accumulators of S^T (s)
// and dP^T (dp): columns are q positions, whose lse (times log2 e) and delta
// the stage holds. Leaves both packed as A operands, rows = keys.
template <bool kMask, typename T>
__device__ __forceinline__ void probabilities_t(const float (&s)[32], const float (&dp)[32], const float* lse_s,
                                                const float* delta_s, uint32_t (&pf)[16], uint32_t (&dsf)[16],
                                                int kpos0, int q0, int col, int S, int causal, float scale,
                                                float scale_log2) {
    float p[32], ds[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const int c = (i >> 2) * 8 + col + (i & 1);
        float x = exp2_approx(fmaf(s[i], scale_log2, -lse_s[c]));
        if (kMask) {
            const int qpos = q0 + c, kpos = kpos0 + ((i >> 1) & 1) * 8;
            if (qpos >= S || (causal && kpos > qpos)) x = 0.f;
        }
        p[i] = x;
        ds[i] = x * (dp[i] - delta_s[c]) * scale;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        pf[j] = pack2(p[2 * j], p[2 * j + 1], static_cast<const T*>(nullptr));
        dsf[j] = pack2(ds[2 * j], ds[2 * j + 1], static_cast<const T*>(nullptr));
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int KVH, float scale, float scale_log2, int causal) {
    using L = DkvLayout<D>;
    constexpr int kPanels = D / kPanel;
    const int kt = blockIdx.x;  // causal: the longest walk (tile 0) first
    const int bg = blockIdx.y, b = bg / KVH, g = bg - b * KVH;
    const int rep = H / KVH;
    const int k0 = kt * kDkvRows;
    const int n_q = (S + kDkvQRows - 1) / kDkvQRows;
    const int qt0 = causal ? k0 / kDkvQRows : 0;
    const int per_head = n_q - qt0, n_it = rep * per_head;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
    const uint32_t bar_kv = base + L::kBar, bar_full = bar_kv + 8, bar_empty = bar_full + 8 * kStages;
    if (threadIdx.x == 0) {
        mbar_init(bar_kv, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
            mbar_init(bar_empty + 8 * s, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: its first warp loads
        setmaxnreg_dec<24>();
        const int lane = threadIdx.x;
        if (threadIdx.x < 32) {
            if (lane == 0) {
                mbar_expect_tx(bar_kv, 2 * L::kKv);
#pragma unroll
                for (int p = 0; p < kPanels; ++p) {
                    tma_load(base + L::kK + p * L::kKvBox, &tm_k, bar_kv, p * kPanel, g, k0, b);
                    tma_load(base + L::kV + p * L::kKvBox, &tm_v, bar_kv, p * kPanel, g, k0, b);
                }
            }
            for (int it = 0; it < n_it; ++it) {
                const int hh = it / per_head, q0 = (qt0 + it - hh * per_head) * kDkvQRows;
                const int h = g * rep + hh, st = it % kStages;
                const uint32_t stage = base + L::kStage0 + st * L::kStage;
                float* lse_s = reinterpret_cast<float*>(smem + L::kStage0 + st * L::kStage + 2 * L::kQT);
                float* delta_s = lse_s + kDkvQRows;
                mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
                const int64_t row0 = ((int64_t)b * H + h) * S + q0;
                for (int i = lane; i < kDkvQRows; i += 32) {
                    const bool ok = q0 + i < S;
                    lse_s[i] = ok ? lse[row0 + i] * kLog2e : 0.f;
                    delta_s[i] = ok ? delta[row0 + i] : 0.f;
                }
                if (lane == 0) {
                    mbar_expect_tx(bar_full + 8 * st, 2 * L::kQT);
#pragma unroll
                    for (int p = 0; p < kPanels; ++p) {
                        tma_load(stage + p * L::kQBox, &tm_q, bar_full + 8 * st, p * kPanel, h, q0, b);
                        tma_load(stage + L::kQT + p * L::kQBox, &tm_do, bar_full + 8 * st, p * kPanel, h, q0, b);
                    }
                } else {
                    mbar_arrive(bar_full + 8 * st);
                }
            }
        }
    } else {  // two consumer warpgroups, 64 keys each
        setmaxnreg_inc<240>();
        const T* tag = nullptr;
        const int w = threadIdx.x / 128 - 1, t = threadIdx.x & 127, lane = t & 31;
        const int krow = w * 64 + (t >> 5) * 16 + (lane >> 2);  // this thread's first key row; the second + 8
        const int col = 2 * (lane & 3);
        const int kw0 = k0 + w * 64;  // this warpgroup's first key
        float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        const uint32_t k_base = base + L::kK + w * 64 * 128, v_base = base + L::kV + w * 64 * 128;
        mbar_wait(bar_kv, 0);
        for (int it = 0; it < n_it; ++it) {
            const int hh = it / per_head, q0 = (qt0 + it - hh * per_head) * kDkvQRows;
            const int st = it % kStages;
            mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
            if (!causal || q0 + kDkvQRows - 1 >= kw0) {  // else every key of this half is after every query
                const uint32_t q_s = base + L::kStage0 + st * L::kStage, do_s = q_s + L::kQT;
                const float* lse_s = reinterpret_cast<const float*>(smem + L::kStage0 + st * L::kStage + 2 * L::kQT);
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < D / 16; ++ks) {
                    const uint32_t kv_off = (ks / 4) * L::kKvBox + (ks % 4) * 32;
                    const uint32_t q_off = (ks / 4) * L::kQBox + (ks % 4) * 32;
                    wgmma_ss(s, desc_kmajor(k_base + kv_off), desc_kmajor(q_s + q_off), ks > 0, tag);
                    wgmma_ss(dp, desc_kmajor(v_base + kv_off), desc_kmajor(do_s + q_off), ks > 0, tag);
                }
                wgmma_commit();
                wgmma_wait0();
                fence_regs(s);
                fence_regs(dp);
                uint32_t pf[16], dsf[16];
                const bool edge = (causal && q0 < kw0 + 64) || q0 + kDkvQRows > S;
                if (edge) {
                    probabilities_t<true, T>(s, dp, lse_s, lse_s + kDkvQRows, pf, dsf, k0 + krow, q0, col, S, causal,
                                             scale, scale_log2);
                } else {
                    probabilities_t<false, T>(s, dp, lse_s, lse_s + kDkvQRows, pf, dsf, k0 + krow, q0, col, S,
                                              causal, scale, scale_log2);
                }
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kDkvQRows / 16; ++kk) {
                    const uint32_t a_p[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
                    const uint32_t a_ds[4] = {dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3]};
                    wgmma_rs(dv_acc, a_p, desc_mnmajor(do_s + kk * 16 * 128, L::kQBox), tag);
                    wgmma_rs(dk_acc, a_ds, desc_mnmajor(q_s + kk * 16 * 128, L::kQBox), tag);
                }
                wgmma_commit();
                wgmma_wait0();
                fence_regs(dv_acc);
                fence_regs(dk_acc);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_empty + 8 * st);
        }

        const int64_t kv_stride = (int64_t)KVH * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int kpos = k0 + krow + 8 * r;
            if (kpos >= S) continue;
            const int64_t off = ((int64_t)b * S + kpos) * kv_stride + (int64_t)g * D + col;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1], tag);
                *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1], tag);
            }
        }
    }
}

// ------------------------------------------------------------------- dQ B4 --
constexpr int kDqRows = 128;   // q rows of a block
constexpr int kDqKvRows = 64;  // rows of each streamed K / V tile

template <int D> struct DqLayout {
    static constexpr int kQBox = kDqRows * kPanel * 2;     // one panel of the Q or dO tile
    static constexpr int kKvBox = kDqKvRows * kPanel * 2;  // one panel of a K or V tile
    static constexpr int kQT = kDqRows * D * 2, kKvT = kDqKvRows * D * 2;
    static constexpr int kStage = 2 * kKvT;  // a stage: K tile, then V tile
    static constexpr int kQ = 0, kDo = kQT, kStage0 = 2 * kQT, kBar = kStage0 + kStages * kStage;
    static constexpr int kBytes = kBar + kBarBytes + 1024;
    static_assert(kBytes <= kSmemLimit, "B4's tiles do not fit a block's shared memory");
};

// dS of one (64 q x 64 keys) tile on the accumulators of S (s) and dP (dp):
// rows are this thread's two q rows, whose lse (times log2 e) and delta it
// holds in registers. Leaves dS packed as the A operand of dQ += dS K.
template <bool kMask, typename T>
__device__ __forceinline__ void dq_scores(const float (&s)[32], const float (&dp)[32], const float (&lse2)[2],
                                          const float (&delta)[2], uint32_t (&dsf)[16], int qpos0, int kpos0, int S,
                                          int causal, float scale, float scale_log2) {
    float ds[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_approx(fmaf(s[i], scale_log2, -lse2[r]));
        if (kMask) {
            const int kpos = kpos0 + (i >> 2) * 8 + (i & 1), qpos = qpos0 + 8 * r;
            if (kpos >= S || (causal && kpos > qpos)) p = 0.f;
        }
        ds[i] = p * (dp[i] - delta[r]) * scale;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) dsf[j] = pack2(ds[2 * j], ds[2 * j + 1], static_cast<const T*>(nullptr));
}

template <typename T, int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq, int S,
                        int H, int KVH, float scale, float scale_log2, int causal) {
    using L = DqLayout<D>;
    constexpr int kPanels = D / kPanel;
    const int n_tiles = (S + kDqRows - 1) / kDqRows;
    const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int g = h / (H / KVH);
    const int q0 = qt * kDqRows;
    const int n_kv_all = (S + kDqKvRows - 1) / kDqKvRows;
    const int n_kv = causal ? min((q0 + kDqRows) / kDqKvRows, n_kv_all) : n_kv_all;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;
    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(bar_full + 8 * s, 1);
            mbar_init(bar_empty + 8 * s, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: its first thread issues every copy
        setmaxnreg_dec<24>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(bar_q, 2 * L::kQT);
#pragma unroll
            for (int p = 0; p < kPanels; ++p) {
                tma_load(base + L::kQ + p * L::kQBox, &tm_q, bar_q, p * kPanel, h, q0, b);
                tma_load(base + L::kDo + p * L::kQBox, &tm_do, bar_q, p * kPanel, h, q0, b);
            }
            for (int it = 0; it < n_kv; ++it) {
                const int st = it % kStages;
                const uint32_t stage = base + L::kStage0 + st * L::kStage;
                mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
                mbar_expect_tx(bar_full + 8 * st, L::kStage);
#pragma unroll
                for (int p = 0; p < kPanels; ++p) {
                    tma_load(stage + p * L::kKvBox, &tm_k, bar_full + 8 * st, p * kPanel, g, it * kDqKvRows, b);
                    tma_load(stage + L::kKvT + p * L::kKvBox, &tm_v, bar_full + 8 * st, p * kPanel, g,
                             it * kDqKvRows, b);
                }
            }
        }
    } else {  // two consumer warpgroups, 64 q rows each
        setmaxnreg_inc<240>();
        const T* tag = nullptr;
        const int w = threadIdx.x / 128 - 1, t = threadIdx.x & 127, lane = t & 31;
        const int row = w * 64 + (t >> 5) * 16 + (lane >> 2);  // this thread's first q row; the second is row + 8
        const int col = 2 * (lane & 3);
        const int qw0 = q0 + w * 64;  // this warpgroup's first q row
        float lse2[2], dlt[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qpos = q0 + row + 8 * r;
            const bool ok = qpos < S;
            lse2[r] = ok ? lse[(int64_t)bh * S + qpos] * kLog2e : 0.f;
            dlt[r] = ok ? delta[(int64_t)bh * S + qpos] : 0.f;
        }
        float dq_acc[D / 2], s[32], dp[32];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        const uint32_t q_base = base + L::kQ + w * 64 * 128, do_base = base + L::kDo + w * 64 * 128;
        mbar_wait(bar_q, 0);
        for (int it = 0; it < n_kv; ++it) {
            const int st = it % kStages, k0 = it * kDqKvRows;
            mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
            if (!causal || k0 <= qw0 + 63) {  // else every key of the tile is after every query of this half
                const uint32_t k_base = base + L::kStage0 + st * L::kStage, v_base = k_base + L::kKvT;
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < D / 16; ++ks) {
                    const uint32_t q_off = (ks / 4) * L::kQBox + (ks % 4) * 32;
                    const uint32_t kv_off = (ks / 4) * L::kKvBox + (ks % 4) * 32;
                    wgmma_ss(s, desc_kmajor(q_base + q_off), desc_kmajor(k_base + kv_off), ks > 0, tag);
                    wgmma_ss(dp, desc_kmajor(do_base + q_off), desc_kmajor(v_base + kv_off), ks > 0, tag);
                }
                wgmma_commit();
                wgmma_wait0();
                fence_regs(s);
                fence_regs(dp);
                uint32_t dsf[16];
                const bool edge = (causal && k0 + kDqKvRows - 1 > qw0) || k0 + kDqKvRows > S;
                if (edge) {
                    dq_scores<true, T>(s, dp, lse2, dlt, dsf, q0 + row, k0 + col, S, causal, scale, scale_log2);
                } else {
                    dq_scores<false, T>(s, dp, lse2, dlt, dsf, q0 + row, k0 + col, S, causal, scale, scale_log2);
                }
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kDqKvRows / 16; ++kk) {
                    const uint32_t a[4] = {dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3]};
                    wgmma_rs(dq_acc, a, desc_mnmajor(k_base + kk * 16 * 128, L::kKvBox), tag);
                }
                wgmma_commit();
                wgmma_wait0();
                fence_regs(dq_acc);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_empty + 8 * st);
        }

        const int64_t q_stride = (int64_t)H * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qpos = q0 + row + 8 * r;
            if (qpos >= S) continue;
            T* dst = dq + ((int64_t)b * S + qpos) * q_stride + (int64_t)h * D + col;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack2(dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1], tag);
            }
        }
    }
}

// ------------------------------------------------------------------ launch --
constexpr int kBadDtype = -1, kBadHeadDim = -2;  // and hopper.cuh's kNoTensorMap, kBadTensorMap

// A [B, S, heads, D] tensor as the 4-D map (D, heads, S, B), read in boxes
// of 64 columns x `rows` positions of one head; positions past S read as zeros.
template <typename T>
int make_bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int rows) {
    return make_map<T>(map, ptr, {D, heads, S, B}, 2, rows);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int H, int KVH,
               float scale, int causal, cudaStream_t stream) {
    CUtensorMap mq, mk, mv;
    int err = make_bshd_map<T>(&mq, q, B, S, H, D, kFwdRows);
    if (!err) err = make_bshd_map<T>(&mk, k, B, S, KVH, D, kFwdRows);
    if (!err) err = make_bshd_map<T>(&mv, v, B, S, KVH, D, kFwdRows);
    if (!err) err = set_smem(flash_fwd_kernel<T, D>, FwdLayout<D>::kBytes);
    if (err) return err;
    dim3 grid((S + kFwdRows - 1) / kFwdRows, B * H);
    flash_fwd_kernel<T, D><<<grid, kWsThreads, FwdLayout<D>::kBytes, stream>>>(
        mq, mk, mv, static_cast<T*>(out), lse, S, H, KVH, scale * kLog2e, causal);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int S, int H, int KVH, float scale, int causal, cudaStream_t stream) {
    CUtensorMap mq, mk, mv, mdo;
    int err = make_bshd_map<T>(&mq, q, B, S, H, D, kDkvQRows);
    if (!err) err = make_bshd_map<T>(&mdo, dout, B, S, H, D, kDkvQRows);
    if (!err) err = make_bshd_map<T>(&mk, k, B, S, KVH, D, kDkvRows);
    if (!err) err = make_bshd_map<T>(&mv, v, B, S, KVH, D, kDkvRows);
    if (!err) err = set_smem(flash_bwd_dkv_kernel<T, D>, DkvLayout<D>::kBytes);
    if (err) return err;
    dim3 grid((S + kDkvRows - 1) / kDkvRows, B * KVH);
    flash_bwd_dkv_kernel<T, D><<<grid, kWsThreads, DkvLayout<D>::kBytes, stream>>>(
        mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KVH, scale, scale * kLog2e,
        causal);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
              void* dq, int B, int S, int H, int KVH, float scale, int causal, cudaStream_t stream) {
    CUtensorMap mq, mk, mv, mdo;
    int err = make_bshd_map<T>(&mq, q, B, S, H, D, kDqRows);
    if (!err) err = make_bshd_map<T>(&mdo, dout, B, S, H, D, kDqRows);
    if (!err) err = make_bshd_map<T>(&mk, k, B, S, KVH, D, kDqKvRows);
    if (!err) err = make_bshd_map<T>(&mv, v, B, S, KVH, D, kDqKvRows);
    if (!err) err = set_smem(flash_bwd_dq_kernel<T, D>, DqLayout<D>::kBytes);
    if (err) return err;
    dim3 grid((S + kDqRows - 1) / kDqRows, B * H);
    flash_bwd_dq_kernel<T, D><<<grid, kWsThreads, DqLayout<D>::kBytes, stream>>>(
        mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), S, H, KVH, scale, scale * kLog2e, causal);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 1 float16, 2 bfloat16; head_dim 64 or 128. Each function
// returns cudaGetLastError() after its launch (0 on success), -1 for an
// unsupported dtype, -2 for an unsupported head_dim, -3 if the driver has no
// cuTensorMapEncodeTiled, -4 if it refuses a tensor map.
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
    if (code == kNoTensorMap) return "the CUDA driver has no cuTensorMapEncodeTiled";
    if (code == kBadTensorMap) return "cuTensorMapEncodeTiled refused the tensor";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
