// Block-sparse flash attention, forward, for Hopper (sm_90a).
//
// Replaces deepspeed_tpu/ops/pallas/block_sparse_attention.py::_sparse_fwd_kernel (B5):
//   dstt_block_sparse_fwd <- _sparse_fwd_kernel, through _sparse_fwd_pallas
// with the same arithmetic: s = (q . k) * scale in f32; a score whose layout
// cell is off is set to -1e30; an f32 online softmax in which a row with no
// attended cell so far keeps m, l and the accumulator untouched (the guarded
// exp); l floored at 1e-30; rows that attend no cell anywhere write zeros;
// the output in q's dtype. The backward is torch ops
// (ops/block_sparse_attention.py), as the JAX package computes it in XLA.
//
// Layout: q, k, v, out are [B, H, S, D], contiguous, as the JAX function
// takes them (the flash kernels take [B, S, H, D]). The layout's cells are
// `lb` x `lb` tokens; S is a multiple of lb but need not be one of 64. The
// tensor maps are 4-D, (D, S, H, B), so rows past S come back from TMA as
// zeros (a flat [B H S, D] view would give the next head's rows); they are
// masked where they would count and never written.
//
// What bounds it, at bench.py's sparse leg (B = 1, H = 16, S = 8192,
// D = 128, lb = 64, BigBird with one global block at densities 0.046 and
// 0.113): the card's floor is q, k, v and out once, 134 MB, 0.040 ms at
// 3.35 TB/s, and the products over the attended cells, 4 D flops a
// (query, key) pair: 25 and 62 GFLOP, 0.026 and 0.063 ms at 989 TFLOP/s
// (chip_smoke.py::_bsa_bound). The work is 12,080 and 29,584 steps of a
// 64-row q tile against a 64-row K/V tile, over 2,048 (head, q tile) lists
// whose median is 5 and 14 steps; but each head's global q tile attends all
// 128 K/V tiles, so a kernel that gives each list one block waits 128 steps
// on 16 blocks, whatever the density. Each step also moves 32 KB of K and V
// from L2 into the SM: 0.40 and 0.97 GB, a second floor beside HBM's.
//
// Design.
//  - Work items, built on the host once per layout (build_work_items):
//    (head, q tile, first step, steps, split, splits, split row, first
//    slot). A list longer than the plan's split_steps (32 at the bench
//    layouts: only the 16 global rows, into 4 chunks each) is cut into
//    near-equal contiguous chunks, each its own item. Items run longest
//    first, one block per (item, batch row), so the long chunks start early
//    and the short lists fill in beside them (a persistent grid that walks
//    the units in fixed turns, the next Q tile loading behind the last
//    unit, measured slower at the low bench layout: PERF.md §6). A list with
//    no step is an item too: it writes its zero rows.
//  - A block is a producer warpgroup and one consumer warpgroup (64 q rows),
//    two blocks an SM. The producer's first thread loads the Q tile and then
//    the listed K and V tiles by TMA (one 64-column box per 128-byte-swizzled
//    panel) into a ring of kStages stages, each signalled by an mbarrier; the
//    consumer's warps release a stage through a second one. setmaxnreg hands
//    the producer's registers to the consumer.
//  - A step is B2's (flash_attention.cu): S = Q K^T an SS wgmma
//    (m64n64k16, both K-major); the online softmax on the accumulator
//    registers in the log2 domain (ex2); P packed from registers as the A
//    operand of O += P V, an RS wgmma (m64nDk16) with V MN-major; O stays in
//    f32 registers. K/V tiles stay at 64 rows: at lb = 64 a 128-row tile
//    would make every window edge partial and double the sparse rows' work.
//  - The cells are read only on a step marked partial (a tile pair that
//    some off cell touches: lb of 16, or cells that straddle tiles, as lb 48)
//    and on the ragged last K/V tile; a partial step reads each score's cell
//    from the uint8 layout [H, nb, nb].
//  - A chunk of a split row writes its f32 (m, l, O) to a per-stream
//    workspace and, after a fence, counts itself on the row's counter; the
//    chunk that arrives last merges every chunk in split order (the guarded
//    exp again: a row dead in every chunk writes zeros), writes the output
//    and resets the counter to 0, as B1's splits do (paged_attention.cu). No
//    float atomics, so a second run gives the same bits.
// Launch and build: ops/block_sparse_attention.py, ops/builder.py; the
// Hopper primitives are hopper.cuh's.

#include "hopper.cuh"

namespace {

using namespace dstt;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;          // rows of every tile, q and K/V
constexpr int kStages = 2;         // ring stages of the K/V tiles
constexpr int kThreads = 256;      // producer warpgroup + one consumer warpgroup
constexpr int kConsumerThreads = 128;
constexpr int kBlocksPerSm = 2;
constexpr int kItemInts = 8;       // fields of a work item, as ops/block_sparse_attention.py builds them
constexpr int kBarBytes = 64;      // mbarriers and the last-chunk flag

template <int D> struct Layout {
    static constexpr int kBox = kTile * kPanel * 2;  // one 64-column panel of a 64-row tile
    static constexpr int kTileBytes = kTile * D * 2;
    static constexpr int kQ = 0, kK = kTileBytes, kV = kK + kStages * kTileBytes;
    static constexpr int kBar = kV + kStages * kTileBytes;
    static constexpr int kBytes = kBar + kBarBytes + 1024;  // barriers, 1024-byte alignment slack
    // a chunk's partial in the workspace: O (D / 2 values a thread), then
    // m and l of the thread's two rows, value-major so the stores coalesce
    static constexpr int kPartFloats = (D / 2 + 4) * kConsumerThreads;
    static_assert(kBlocksPerSm * (kBytes + 1024) <= kSmemPerSm, "two blocks do not fit an SM's shared memory");
};

// the consumer warpgroup only (the producer may have left)
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

// One K/V tile of the online softmax on the S accumulator (32 values: 2 rows
// x 16 columns of this thread), in the log2 domain: s * scale * log2(e).
// Rescales O, updates m and the thread's partial l, and leaves P packed as
// the A operand of O += P V. kMask: the step is partial or the ragged last
// tile; a score is kept when its key is before S and its cell is on
// (lay_row[r]: the layout row of q row r, null past S), and a row with
// nothing kept so far keeps p = 0 and alpha = 1 (the guarded exp).
template <bool kMask, typename T, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&o)[NO], float (&m)[2], float (&l)[2],
                                               uint32_t (&p)[16], const unsigned char* const (&lay_row)[2],
                                               int kpos0, int S, int lb, float scale_log2) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int kpos = kpos0 + 8 * j + e;
            const int cell = kMask ? kpos / lb : 0;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int i = 4 * j + 2 * r + e;
                float x = s[i] * scale_log2;
                if (kMask && (kpos >= S || lay_row[r] == nullptr || !lay_row[r][cell])) x = kNegInf;
                s[i] = x;
                mx[r] = fmaxf(mx[r], x);
            }
        }
    }
    float alpha[2];
    bool live[2] = {true, true};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if (kMask) live[r] = mx[r] > 0.5f * kNegInf;
        alpha[r] = live[r] ? exp2_approx(m[r] - mx[r]) : 1.f;
        m[r] = mx[r];
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = live[r] ? exp2_approx(s[i] - m[r]) : 0.f;
        l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < 16; ++j) p[j] = pack2(s[2 * j], s[2 * j + 1], static_cast<const T*>(nullptr));
}

// O / l of this thread's two rows into out (zeros for a row with m still
// -1e30); rows past S are not written
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* out, const float (&o)[D / 2], const float (&m)[2], const float (&l)[2],
                                           int64_t head, int q0, int row, int col, int S) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = q0 + row + 8 * r;
        if (qpos >= S) continue;
        const float inv = m[r] > 0.5f * kNegInf ? 1.f / fmaxf(l[r], 1e-30f) : 0.f;
        T* dst = out + head + (int64_t)qpos * D + col;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                pack2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv, static_cast<const T*>(nullptr));
        }
    }
}

// steps [H, nt, max_steps]: kv_tile * 2 + partial (build_tile_lists);
// items [n_items, kItemInts], longest first: head, q tile, first step,
// steps, split, splits, split row, first slot; cells [H, nb, nb]; part
// [B, n_slots, kPartFloats] f32; counters [B, n_rows] int32, zero between
// launches.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    block_sparse_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
                            const int* __restrict__ steps, const int* __restrict__ items,
                            const unsigned char* __restrict__ cells, float* __restrict__ part,
                            int* __restrict__ counters, int B, int H, int S, int lb, int nt, int max_steps, int n_rows,
                            int n_slots, float scale_log2) {
    using L = Layout<D>;
    constexpr int kPanels = D / kPanel;
    const int rank = blockIdx.x / B, b = blockIdx.x - rank * B;
    const int* item = items + rank * kItemInts;
    const int h = item[0], qt = item[1], n = item[3];
    const int* list = steps + ((int64_t)h * nt + qt) * max_steps + item[2];
    const int q0 = qt * kTile;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-byte alignment
    const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;
    volatile int* last_flag = reinterpret_cast<volatile int*>(smem_raw + (bar_empty + 8 * kStages - smem_u32(smem_raw)));
    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(bar_full + 8 * s, 1);
            mbar_init(bar_empty + 8 * s, kConsumerThreads / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // producer warpgroup: its first thread issues every copy
        setmaxnreg_dec<24>();
        if (threadIdx.x == 0 && n > 0) {
            mbar_expect_tx(bar_q, L::kTileBytes);
#pragma unroll
            for (int p = 0; p < kPanels; ++p) tma_load(base + L::kQ + p * L::kBox, &tm_q, bar_q, p * kPanel, q0, h, b);
            for (int it = 0; it < n; ++it) {
                const int st = it % kStages, k0 = (list[it] >> 1) * kTile;
                mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
                mbar_expect_tx(bar_full + 8 * st, 2 * L::kTileBytes);
#pragma unroll
                for (int p = 0; p < kPanels; ++p) {
                    tma_load(base + L::kK + st * L::kTileBytes + p * L::kBox, &tm_k, bar_full + 8 * st, p * kPanel,
                             k0, h, b);
                    tma_load(base + L::kV + st * L::kTileBytes + p * L::kBox, &tm_v, bar_full + 8 * st, p * kPanel,
                             k0, h, b);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: 64 q rows
    setmaxnreg_inc<232>();
    const T* tag = nullptr;
    const int t = threadIdx.x - 128, lane = t & 31;
    const int row = (t >> 5) * 16 + (lane >> 2);  // this thread's first row of the tile; the second is row + 8
    const int col = 2 * (lane & 3);
    const int64_t head = ((int64_t)b * H + h) * S * D;
    const int nb = S / lb;
    const unsigned char* lay_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qpos = q0 + row + 8 * r;
        lay_row[r] = qpos < S ? cells + ((int64_t)h * nb + qpos / lb) * nb : nullptr;
    }
    float o[D / 2], s[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    if (n > 0) mbar_wait(bar_q, 0);
    for (int it = 0; it < n; ++it) {
        const int st = it % kStages, entry = list[it], k0 = (entry >> 1) * kTile;
        mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
        const uint32_t k_base = base + L::kK + st * L::kTileBytes, v_base = base + L::kV + st * L::kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t off = (ks / 4) * L::kBox + (ks % 4) * 32;
            wgmma_ss(s, desc_kmajor(base + L::kQ + off), desc_kmajor(k_base + off), ks > 0, tag);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        uint32_t p[16];
        if ((entry & 1) || k0 + kTile > S) {
            online_softmax<true, T>(s, o, m, l, p, lay_row, k0 + col, S, lb, scale_log2);
        } else {
            online_softmax<false, T>(s, o, m, l, p, lay_row, k0 + col, S, lb, scale_log2);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
            const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
            wgmma_rs(o, a, desc_mnmajor(v_base + kk * 16 * 128, L::kBox), tag);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int n_split = item[5];
    if (n_split == 1) {
        write_rows<T, D>(out, o, m, l, head, q0, row, col, S);
        return;
    }

    // a chunk of a split row: its partial to the workspace, then the chunk
    // that arrives last merges them all, in split order
    float* first = part + ((int64_t)b * n_slots + item[7]) * L::kPartFloats;
    float* mine = first + (int64_t)item[4] * L::kPartFloats;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) mine[i * kConsumerThreads + t] = o[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mine[(D / 2 + r) * kConsumerThreads + t] = m[r];
        mine[(D / 2 + 2 + r) * kConsumerThreads + t] = l[r];
    }
    __threadfence();
    consumer_sync();
    if (t == 0) {
        int* counter = counters + (int64_t)b * n_rows + item[6];
        const int done = atomicAdd(counter, 1) + 1;
        *last_flag = done == n_split;
        if (done == n_split) atomicExch(counter, 0);
    }
    consumer_sync();
    if (!*last_flag) return;
    __threadfence();
    float mt[2] = {kNegInf, kNegInf}, lt[2] = {0.f, 0.f};
    for (int c = 0; c < n_split; ++c) {
#pragma unroll
        for (int r = 0; r < 2; ++r) mt[r] = fmaxf(mt[r], __ldcg(first + c * L::kPartFloats + (D / 2 + r) * kConsumerThreads + t));
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int c = 0; c < n_split; ++c) {
        const float* pc = first + c * L::kPartFloats;
        float w[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            // the guarded exp: a row dead in every chunk stays at zero
            w[r] = mt[r] > 0.5f * kNegInf ? exp2_approx(__ldcg(pc + (D / 2 + r) * kConsumerThreads + t) - mt[r]) : 0.f;
            lt[r] += __ldcg(pc + (D / 2 + 2 + r) * kConsumerThreads + t) * w[r];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] += __ldcg(pc + i * kConsumerThreads + t) * w[(i >> 1) & 1];
    }
    write_rows<T, D>(out, o, mt, lt, head, q0, row, col, S);
}

constexpr int kBadDtype = -1, kBadHeadDim = -2, kBadShape = -5;  // and hopper.cuh's kNoTensorMap, kBadTensorMap

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, const int* steps, const int* items,
           const unsigned char* cells, float* part, int* counters, int B, int H, int S, int lb, int nt, int max_steps,
           int n_items, int n_rows, int n_slots, float scale, cudaStream_t stream) {
    CUtensorMap mq, mk, mv;
    // [B, H, S, D] as the map (D, S, H, B): 64-column x 64-row boxes of one (b, h)
    int err = make_map<T>(&mq, q, {D, S, H, B}, 1, kTile);
    if (!err) err = make_map<T>(&mk, k, {D, S, H, B}, 1, kTile);
    if (!err) err = make_map<T>(&mv, v, {D, S, H, B}, 1, kTile);
    if (!err) err = set_smem(block_sparse_fwd_kernel<T, D>, Layout<D>::kBytes);
    if (err) return err;
    block_sparse_fwd_kernel<T, D><<<dim3((unsigned)(n_items * B)), kThreads, Layout<D>::kBytes, stream>>>(
        mq, mk, mv, static_cast<T*>(out), steps, items, cells, part, counters, B, H, S, lb, nt, max_steps, n_rows,
        n_slots, scale * kLog2e);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 1 float16, 2 bfloat16; head_dim 64 or 128. Returns
// cudaGetLastError() after the launch (0 on success), -1 for an unsupported
// dtype, -2 for an unsupported head_dim, -3 if the driver has no
// cuTensorMapEncodeTiled, -4 if it refuses a tensor map, -5 for S not a
// multiple of lb, a tile count that does not fit S, or no list or item.
int dstt_block_sparse_fwd(const void* q, const void* k, const void* v, void* out, const int* steps, const int* items,
                          const unsigned char* cells, float* part, int* counters, int dtype, int B, int H, int S,
                          int D, int lb, int nt, int max_steps, int n_items, int n_rows, int n_slots, float scale,
                          void* stream) {
    if (lb <= 0 || S % lb != 0 || nt != (S + kTile - 1) / kTile || max_steps < 1 || n_items < 1) return kBadShape;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSTT_LAUNCH(T, DD) \
    launch<T, DD>(q, k, v, out, steps, items, cells, part, counters, B, H, S, lb, nt, max_steps, n_items, n_rows, n_slots, scale, st)
    switch (dtype * 1000 + D) {
        case 1064: return DSTT_LAUNCH(__half, 64);
        case 1128: return DSTT_LAUNCH(__half, 128);
        case 2064: return DSTT_LAUNCH(__nv_bfloat16, 64);
        case 2128: return DSTT_LAUNCH(__nv_bfloat16, 128);
        default: return (dtype == 1 || dtype == 2) ? kBadHeadDim : kBadDtype;
    }
#undef DSTT_LAUNCH
}

const char* dstt_block_sparse_error_string(int code) {
    if (code == kBadDtype) return "unsupported dtype";
    if (code == kBadHeadDim) return "unsupported head_dim";
    if (code == kNoTensorMap) return "the CUDA driver has no cuTensorMapEncodeTiled";
    if (code == kBadTensorMap) return "cuTensorMapEncodeTiled refused the tensor";
    if (code == kBadShape) return "S is not a multiple of the layout block, or the tile lists or items do not fit S";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
