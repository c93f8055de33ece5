// Paged (blocked) attention over the ragged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/paged_attention.py::_kernel
// (called through paged_attention_update): for each ragged token, write its
// K/V into slot pos % bs of block table[seq, pos / bs] at layer `layer`, then
// attend causally (GQA) over positions 0..pos through the sequence's block
// table, with an f32 online softmax.
//
// Two launches on the caller's stream, in this order:
//   1. dstt_paged_kv_insert: one thread per 16-byte vector of a token's new
//      k/v rows [KVH, D] copies it into the cache.
//   2. dstt_paged_attention: the split-context attention below.
// The Pallas grid runs tokens in order, so a token sees the inserts of the
// tokens before it. Blocks on the GPU run in parallel and in no order, so
// every insert finishes (kernel boundary) before any attention reads the
// cache. Positions after a token's own are masked, so reading the inserts of
// later tokens of the same chunk changes nothing.
//
// Semantics kept from the Pallas kernel: seq = min(token_seq, S - 1); a valid
// token attends positions 0..last, last = min(pos, min(pos / bs + 1, MB) * bs
// - 1); table entries of -1 are read as block 0; invalid tokens write nothing
// and output 0; the insert goes to block max(table[seq, min(pos / bs, MB -
// 1)], 0).
//
// Bound on an H100 SXM: memory. A decode token reads its sequence's live K/V,
// 2 * (last + 1) * KVH * D * sizeof(T) bytes, and does 4 * H * D * (last + 1)
// flops, far below the 295 flops per byte at which the tensor cores would
// bound it; so the least time is the live KV bytes over 3.35 TB/s. What the
// design does about it (split context, FlashDecoding's shape):
//  - Split the context. A block serves one (token, KV head, group of up to
//    4 query heads of that KV head, split), and a split is `span`
//    positions (256 unless the workspace would outgrow its budget; the
//    wrapper picks it). The grid is sized on the host from MB * bs: up to
//    kGridSplits (8) blocks per (token, head group), block j taking splits
//    j, j + 8, ...; so the number of live splits comes from the device:
//    blocks past a token's context exit at once, and no host sync is needed.
//    A decode step of 8 tokens thus puts some 770 live blocks, not 256, on
//    the 132 SMs, and the critical path of a sequence of up to 2048
//    positions is one split (4 stages), not its whole context.
//  - A split with company writes its partial (m, l, acc) in f32 to a
//    workspace and counts itself on a per-(token, head group) counter; the
//    block that arrives last merges every split's partial in split order
//    (deterministic: no float atomics) and resets the counter to 0 for the
//    next launch. A token whose context is one split writes its output
//    directly.
//  - Pipeline the loads. A producer warp copies each stage of kStagePos
//    positions (64; fewer only for rows over 512 bytes, so that two stages
//    fit) with cp.async.bulk, one copy per (cache block, K or V): a [bs, D]
//    tile of one (block, head) is contiguous in the cache. Completion is
//    signalled on the stage's mbarrier; the eight consumer warps release the
//    stage through a second one. kStages stages are in flight.
//  - No block barriers in the loop and no scalar loops through shared
//    memory. A group of `lp` lanes (16 for D = 128 in 16 bits) owns one
//    position at a time: each lane reads 16-byte vectors of the K and V rows
//    and the group's dot products reduce by shuffles. Each group keeps its own
//    online softmax over its positions; groups merge by shuffles and warps
//    through shared memory once, at the end of the split. The query heads a
//    block serves are a template parameter (1, 2 or 4: the next power of two
//    of H / KVH, capped by registers), so an MHA model pays for one head.
// Launch and build: ops/paged_attention.py and ops/builder.py.

#include "hopper.cuh"  // mbarriers, exp2_approx, kSmemLimit

namespace {

using namespace dstt;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kInsertThreads = 128;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (1 + kConsumerWarps);  // one producer warp, then the consumers
constexpr int kStages = 2;
constexpr int kStagePos = 64;       // positions a stage holds, when two stages fit
constexpr int kMaxBatch = 4;        // positions a lane group takes from one stage, at most (P <= 64, >= 16 groups)
constexpr int kHeaderBytes = 128;   // mbarriers and the last-block flag
constexpr int kMaxRowChunks = 128;  // 16-byte chunks of a K/V row the kernel takes (2048 bytes)
constexpr int kGridSplits = 8;      // blocks per (token, head group), each taking every 8th split
constexpr int kBadDtype = -1, kBadHeadDim = -2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// the 16 / sizeof(T) values of one 16-byte vector, as f32
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8], const __half*) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 x = __half22float2(h[j]);
        f[2 * j] = x.x;
        f[2 * j + 1] = x.y;
    }
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8], const __nv_bfloat16*) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(h[j]);
        f[2 * j] = x.x;
        f[2 * j + 1] = x.y;
    }
}
template <typename T, int E>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[E]) {
    if constexpr (sizeof(T) == 4) {
        unpack16(v, f);
    } else {
        unpack16(v, f, static_cast<const T*>(nullptr));
    }
}

// `bytes` contiguous bytes from global memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
                 "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
                 : "memory");
}

// the consumer warps only (the producer warp may have left)
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumerWarps) : "memory");
}

// cache index of element (layer, kv, block, head, row, 0)
__device__ __forceinline__ int64_t tile_offset(int layer, int kv, int block, int head, int row,
                                               int NB, int KVH, int bs, int D) {
    return ((((int64_t)layer * 2 + kv) * NB + block) * KVH + head) * (int64_t)bs * D +
           (int64_t)row * D;
}

// One thread per 16-byte vector of a token's new K (and V) rows: grid
// (T, ceil(KVH * row / 16 / kInsertThreads)). `vec` is 0 when k_new or
// v_new is not 16-byte aligned; then each thread copies its vector's
// elements one by one.
template <typename T>
__global__ void __launch_bounds__(kInsertThreads) paged_kv_insert_kernel(
    const T* __restrict__ k_new, const T* __restrict__ v_new, T* __restrict__ cache,
    const int* __restrict__ table, int64_t table_stride, const int* __restrict__ token_seq,
    const int* __restrict__ token_pos, const int* __restrict__ token_valid, int layer, int NB,
    int KVH, int bs, int D, int S, int MB, int vec) {
    constexpr int kEpc = 16 / (int)sizeof(T);
    const int t = blockIdx.x;
    const int chunks = D / kEpc, i = blockIdx.y * kInsertThreads + threadIdx.x;  // vector i of [KVH, chunks]
    if (token_valid[t] <= 0 || i >= KVH * chunks) return;
    const int seq = min(token_seq[t], S - 1);
    const int pos = token_pos[t];
    const int block = max(table[seq * table_stride + min(pos / bs, MB - 1)], 0);
    const int h = i / chunks, d = (i - h * chunks) * kEpc;
    const int64_t src = ((int64_t)t * KVH + h) * D + d;
    T* k_dst = cache + tile_offset(layer, 0, block, h, pos % bs, NB, KVH, bs, D) + d;
    T* v_dst = cache + tile_offset(layer, 1, block, h, pos % bs, NB, KVH, bs, D) + d;
    if (vec) {
        *reinterpret_cast<uint4*>(k_dst) = *reinterpret_cast<const uint4*>(k_new + src);
        *reinterpret_cast<uint4*>(v_dst) = *reinterpret_cast<const uint4*>(v_new + src);
    } else {
#pragma unroll
        for (int e = 0; e < kEpc; ++e) {
            k_dst[e] = k_new[src + e];
            v_dst[e] = v_new[src + e];
        }
    }
}

// Geometry of one launch, computed on the host (layout()) and mirrored by
// paged_attention_geometry in ops/paged_attention.py.
struct Geometry {
    int chunks;       // 16-byte chunks of a K/V row
    int lp;           // lanes of a group, one position at a time: min(16, next power of two >= chunks)
    int cpl;          // chunks a lane reads of each row: ceil(chunks / lp), a power of two
    int heads;        // query heads a block serves: min(next power of two >= rep, max_heads(cpl))
    int head_groups;  // ceil(rep / heads)
    int stage_pos;    // positions a stage holds
    int smem;         // dynamic shared memory bytes
};

// query heads a block serves at most: a lane keeps q and acc of cpl * 16 /
// itemsize values per head in f32 registers
__host__ __device__ constexpr int max_heads(int cpl, int itemsize) {
    return 32 / (cpl * (16 / itemsize)) < 1 ? 1 : (32 / (cpl * (16 / itemsize)) > 4 ? 4 : 32 / (cpl * (16 / itemsize)));
}

// blocks an SM should hold, which caps registers: three (the shared memory
// of two 64-position stages of 16-bit D = 128 rows allows three) when a lane
// holds one head of one chunk; two up to four head-chunks (a few spilled
// registers cost less than a second block); one beyond
__host__ __device__ constexpr int min_blocks(int cpl, int heads) {
    return cpl * heads == 1 ? 3 : (cpl * heads <= 4 ? 2 : 1);
}

Geometry layout(int D, int rep, int itemsize) {
    Geometry g{};
    const int row = D * itemsize;
    g.chunks = row / 16;
    g.lp = 1;
    while (g.lp < g.chunks && g.lp < 16) g.lp *= 2;
    g.cpl = 1;
    while (g.cpl * g.lp < g.chunks) g.cpl *= 2;
    g.heads = 1;
    while (g.heads < rep && g.heads < max_heads(g.cpl, itemsize)) g.heads *= 2;
    g.head_groups = (rep + g.heads - 1) / g.heads;
    const int merge = 4 * kConsumerWarps * g.heads * (D + 2);  // per warp: acc [heads, D], m, l in f32
    g.stage_pos = kStagePos;
    auto bytes = [&](int pos) { return kHeaderBytes + kStages * 2 * pos * row + merge; };
    while (g.stage_pos > 1 && bytes(g.stage_pos) > kSmemLimit) g.stage_pos /= 2;
    g.smem = bytes(g.stage_pos);
    return g;
}

// One block: item = (token t, KV head g, head group hg), query heads
// [g * rep + hg * R, + nh); blockIdx.x = item * n_grid + j, and the block
// takes splits j, j + n_grid, ... of the token's context (the positions
// [split * span, ...]), so a token with more live splits than n_grid (at
// most kGridSplits) has blocks that take several, and one with fewer has
// blocks that exit at once. The producer runs ahead across the block's
// splits. Shared memory: header (full[kStages], empty[kStages] mbarriers,
// the last-block flag), kStages stages of K rows [P, row] and V rows
// [P, row], then the consumer warps' merge area: acc [kConsumerWarps, R, D],
// m and l [kConsumerWarps, R]. Scores are kept in the log2 domain (q is
// scaled by scale * log2 e), so each exp is one ex2. Workspace of one
// (item, split): acc [R, D], m [R], l [R], f32.
template <typename T, int CPL, int R>
__global__ void __launch_bounds__(kThreads, min_blocks(CPL, R)) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ cache, T* __restrict__ out, float* __restrict__ part,
    int* __restrict__ counter, const int* __restrict__ table, int64_t table_stride, const int* __restrict__ token_seq,
    const int* __restrict__ token_pos, const int* __restrict__ token_valid, int H, int layer, int NB, int KVH, int bs,
    int D, int S, int MB, int NHG, int n_split, int n_grid, int span, int P, int lp, float scale_log2) {
    constexpr int kEpc = 16 / (int)sizeof(T);  // values per 16-byte chunk
    constexpr int kEpl = CPL * kEpc;           // values of a row a lane holds
    const int item = blockIdx.x / n_grid, j = blockIdx.x - item * n_grid;
    const int hg = item % NHG, g = (item / NHG) % KVH, t = item / (NHG * KVH);
    const int rep = H / KVH;
    const int nh = min(R, rep - hg * R);
    const int64_t out_row = (int64_t)t * H + g * rep + hg * R;
    if (token_valid[t] <= 0) {
        if (j == 0) {
            for (int i = threadIdx.x; i < nh * D; i += kThreads) out[out_row * D + i] = from_f32<T>(0.f);
        }
        return;
    }
    const int seq = min(token_seq[t], S - 1);
    const int pos = token_pos[t];
    const int last = min(pos, min(pos / bs + 1, MB) * bs - 1);  // last attended position
    const int n_act = last / span + 1;                          // live splits
    if (j >= n_act) return;
    const int row = D * (int)sizeof(T), chunks = row / 16;

    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t bar_full = smem_u32(smem), bar_empty = bar_full + 8 * kStages;
    int* flag = reinterpret_cast<int*>(smem + 64);
    unsigned char* stages = smem + kHeaderBytes;
    const int stage_bytes = 2 * P * row;
    float* merge_acc = reinterpret_cast<float*>(stages + kStages * stage_bytes);
    float* merge_m = merge_acc + kConsumerWarps * R * D;
    float* merge_l = merge_m + kConsumerWarps * R;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(bar_full + 8 * s, 1);
            mbar_init(bar_empty + 8 * s, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) {  // producer: lane i copies the i-th cache block of each stage, K and V
        int it = 0;   // stages over all of the block's splits
        for (int split = j; split < n_act; split += n_grid) {
            const int p_begin = split * span, p_last = min(last, p_begin + span - 1);
            for (int p0 = p_begin; p0 <= p_last; p0 += P, ++it) {
                const int st = it % kStages, p1 = min(p_last, p0 + P - 1);
                const uint32_t full = bar_full + 8 * st;
                const uint32_t dst = smem_u32(stages + st * stage_bytes);
                mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
                if (lane == 0) mbar_expect_tx(full, 2u * (p1 - p0 + 1) * row);
                __syncwarp();
                for (int b = p0 / bs + lane; b <= p1 / bs; b += 32) {
                    const int r0 = max(p0 - b * bs, 0), r1 = min(p1 - b * bs, bs - 1);
                    const int blk = max(table[seq * table_stride + b], 0);
                    const uint32_t at = dst + (uint32_t)(b * bs + r0 - p0) * row;
                    const uint32_t bytes = (uint32_t)(r1 - r0 + 1) * row;
                    bulk_load(at, cache + tile_offset(layer, 0, blk, g, r0, NB, KVH, bs, D), bytes, full);
                    bulk_load(at + P * row, cache + tile_offset(layer, 1, blk, g, r0, NB, KVH, bs, D), bytes, full);
                }
            }
        }
        return;
    }

    // consumers: warp cw, lane group gi of `lp` lanes, lane li in it
    const int cw = warp - 1, ng = 32 / lp, gi = lane / lp, li = lane - gi * lp;
    const int gamma = cw * ng + gi, ngt = kConsumerWarps * ng;  // this group; all groups
    const int batch = (P + ngt - 1) / ngt;                      // positions a group takes per stage
    const int ct = threadIdx.x - 32;
    float* part_item = part + (int64_t)item * n_split * R * (D + 2);
    float qr[R][kEpl];
    const T* q_t = q + out_row * D;
#pragma unroll
    for (int h = 0; h < R; ++h) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
            const int chunk = li + c * lp;
#pragma unroll
            for (int e = 0; e < kEpc; ++e) {
                qr[h][c * kEpc + e] =
                    (h < nh && chunk < chunks) ? to_f32(q_t[h * D + chunk * kEpc + e]) * scale_log2 : 0.f;
            }
        }
    }

    int it = 0;
    for (int split = j; split < n_act; split += n_grid) {
        const int p_begin = split * span, p_last = min(last, p_begin + span - 1);
        float acc[R][kEpl], m[R], l[R];
#pragma unroll
        for (int h = 0; h < R; ++h) {
            m[h] = kNegInf;
            l[h] = 0.f;
#pragma unroll
            for (int e = 0; e < kEpl; ++e) acc[h][e] = 0.f;
        }
        for (int p0 = p_begin; p0 <= p_last; p0 += P, ++it) {
            const int st = it % kStages;
            const int np = min(p_last - p0, P - 1) + 1;  // rows of this stage that are attended
            const unsigned char* ks = stages + st * stage_bytes;
            const unsigned char* vs = ks + P * row;
            mbar_wait(bar_full + 8 * st, (it / kStages) & 1);

            // scores of the group's positions gamma, gamma + ngt, ...
            float s[R][kMaxBatch];
#pragma unroll
            for (int k = 0; k < kMaxBatch; ++k) {
                if (k >= batch) break;
                const int i = gamma + k * ngt;
                float part_s[R];
#pragma unroll
                for (int h = 0; h < R; ++h) part_s[h] = 0.f;
                if (i < np) {
#pragma unroll
                    for (int c = 0; c < CPL; ++c) {
                        const int chunk = li + c * lp;
                        if (chunk < chunks) {
                            float kf[kEpc];
                            unpack<T>(*reinterpret_cast<const uint4*>(ks + i * row + chunk * 16), kf);
#pragma unroll
                            for (int h = 0; h < R; ++h) {
#pragma unroll
                                for (int e = 0; e < kEpc; ++e) part_s[h] = fmaf(qr[h][c * kEpc + e], kf[e], part_s[h]);
                            }
                        }
                    }
                }
#pragma unroll
                for (int h = 0; h < R; ++h) {
                    for (int o = lp >> 1; o > 0; o >>= 1) part_s[h] += __shfl_xor_sync(0xffffffffu, part_s[h], o);
                    s[h][k] = i < np ? part_s[h] : kNegInf;
                }
            }

            // the group's online softmax over them, then acc += p V
#pragma unroll
            for (int h = 0; h < R; ++h) {
                float mx = m[h];
#pragma unroll
                for (int k = 0; k < kMaxBatch; ++k) {
                    if (k >= batch) break;
                    mx = fmaxf(mx, s[h][k]);
                }
                const float alpha = exp2_approx(m[h] - mx);
                float sum = 0.f;
#pragma unroll
                for (int k = 0; k < kMaxBatch; ++k) {
                    if (k >= batch) break;
                    s[h][k] = gamma + k * ngt < np ? exp2_approx(s[h][k] - mx) : 0.f;
                    sum += s[h][k];
                }
                m[h] = mx;
                l[h] = l[h] * alpha + sum;
#pragma unroll
                for (int e = 0; e < kEpl; ++e) acc[h][e] *= alpha;
            }
#pragma unroll
            for (int k = 0; k < kMaxBatch; ++k) {
                if (k >= batch) break;
                const int i = gamma + k * ngt;
                if (i >= np) break;
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                    const int chunk = li + c * lp;
                    if (chunk < chunks) {
                        float vf[kEpc];
                        unpack<T>(*reinterpret_cast<const uint4*>(vs + i * row + chunk * 16), vf);
#pragma unroll
                        for (int h = 0; h < R; ++h) {
#pragma unroll
                            for (int e = 0; e < kEpc; ++e) {
                                acc[h][c * kEpc + e] = fmaf(s[h][k], vf[e], acc[h][c * kEpc + e]);
                            }
                        }
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_empty + 8 * st);
        }

        // merge the warp's groups (shuffles), then the warps (shared memory, in warp order)
#pragma unroll
        for (int h = 0; h < R; ++h) {
            for (int o = lp; o < 32; o <<= 1) {
                const float m_o = __shfl_xor_sync(0xffffffffu, m[h], o), l_o = __shfl_xor_sync(0xffffffffu, l[h], o);
                const float mn = fmaxf(m[h], m_o), a = exp2_approx(m[h] - mn), b = exp2_approx(m_o - mn);
                l[h] = l[h] * a + l_o * b;
#pragma unroll
                for (int e = 0; e < kEpl; ++e) {
                    const float acc_o = __shfl_xor_sync(0xffffffffu, acc[h][e], o);
                    acc[h][e] = acc[h][e] * a + acc_o * b;
                }
                m[h] = mn;
            }
        }
        consumer_sync();  // the previous split's reads of the merge area are done
        if (gi == 0) {
#pragma unroll
            for (int h = 0; h < R; ++h) {
                if (h >= nh) break;
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                    const int chunk = li + c * lp;
                    if (chunk < chunks) {
#pragma unroll
                        for (int e = 0; e < kEpc; ++e) {
                            merge_acc[(cw * R + h) * D + chunk * kEpc + e] = acc[h][c * kEpc + e];
                        }
                    }
                }
                if (li == 0) {
                    merge_m[cw * R + h] = m[h];
                    merge_l[cw * R + h] = l[h];
                }
            }
        }
        consumer_sync();

        for (int e = ct; e < nh * D; e += 32 * kConsumerWarps) {
            const int h = e / D, d = e - h * D;
            float mt = kNegInf;
#pragma unroll
            for (int w = 0; w < kConsumerWarps; ++w) mt = fmaxf(mt, merge_m[w * R + h]);
            float lt = 0.f, at = 0.f;
#pragma unroll
            for (int w = 0; w < kConsumerWarps; ++w) {
                const float f = exp2_approx(merge_m[w * R + h] - mt);
                lt += merge_l[w * R + h] * f;
                at += merge_acc[(w * R + h) * D + d] * f;
            }
            if (n_act == 1) {
                out[out_row * D + e] = from_f32<T>(at / fmaxf(lt, 1e-20f));
            } else {
                float* p = part_item + (int64_t)split * R * (D + 2);
                p[h * D + d] = at;
                if (d == 0) {
                    p[R * D + h] = mt;
                    p[R * D + R + h] = lt;
                }
            }
        }
        if (n_act == 1) continue;

        // the split that arrives last merges all of them, in split order
        __threadfence();
        consumer_sync();
        if (ct == 0) {
            const int done = atomicAdd(counter + item, 1) + 1;
            *flag = done == n_act;
            if (done == n_act) atomicExch(counter + item, 0);
        }
        consumer_sync();
        if (!*flag) continue;
        __threadfence();
        for (int e = ct; e < nh * D; e += 32 * kConsumerWarps) {
            const int h = e / D, d = e - h * D;
            float mt = kNegInf;
            for (int sp = 0; sp < n_act; ++sp) mt = fmaxf(mt, __ldcg(part_item + (int64_t)sp * R * (D + 2) + R * D + h));
            float lt = 0.f, at = 0.f;
            for (int sp = 0; sp < n_act; ++sp) {
                const float* p = part_item + (int64_t)sp * R * (D + 2);
                const float f = exp2_approx(__ldcg(p + R * D + h) - mt);
                lt += __ldcg(p + R * D + R + h) * f;
                at += __ldcg(p + h * D + d) * f;
            }
            out[out_row * D + e] = from_f32<T>(at / fmaxf(lt, 1e-20f));
        }
    }
}

template <typename T>
int launch_insert(const void* k_new, const void* v_new, void* cache, const int* table,
                  int64_t table_stride, const int* token_seq, const int* token_pos,
                  const int* token_valid, int T_, int layer, int NB, int KVH, int bs, int D, int S,
                  int MB, cudaStream_t stream) {
    const int vectors = KVH * D * (int)sizeof(T) / 16;
    const int vec = reinterpret_cast<uintptr_t>(k_new) % 16 == 0 && reinterpret_cast<uintptr_t>(v_new) % 16 == 0;
    dim3 grid(T_, (vectors + kInsertThreads - 1) / kInsertThreads);
    paged_kv_insert_kernel<T><<<grid, kInsertThreads, 0, stream>>>(
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<T*>(cache), table,
        table_stride, token_seq, token_pos, token_valid, layer, NB, KVH, bs, D, S, MB, vec);
    return (int)cudaGetLastError();
}

template <typename T, int CPL, int R>
int launch_attention_r(const Geometry& geo, const void* q, const void* cache, void* out, float* part, int* counter,
                       const int* table, int64_t table_stride, const int* token_seq, const int* token_pos,
                       const int* token_valid, int T_, int H, int layer, int NB, int KVH, int bs, int D, int S,
                       int MB, int n_split, int span, float scale, cudaStream_t stream) {
    if constexpr (R > max_heads(CPL, (int)sizeof(T))) {
        return kBadHeadDim;
    } else {
        auto kernel = paged_attention_kernel<T, CPL, R>;
        if (geo.smem > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
            if (err != cudaSuccess) return (int)err;
        }
        const int n_grid = n_split < kGridSplits ? n_split : kGridSplits;
        const int64_t blocks = (int64_t)T_ * KVH * geo.head_groups * n_grid;
        if (blocks > 0x7fffffff) return kBadHeadDim;
        kernel<<<(unsigned)blocks, kThreads, geo.smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(cache), static_cast<T*>(out), part, counter, table,
            table_stride, token_seq, token_pos, token_valid, H, layer, NB, KVH, bs, D, S, MB, geo.head_groups, n_split,
            n_grid, span, geo.stage_pos, geo.lp, scale * kLog2e);
        return (int)cudaGetLastError();
    }
}

template <typename T>
int launch_attention(const void* q, const void* cache, void* out, float* part, int* counter, const int* table,
                     int64_t table_stride, const int* token_seq, const int* token_pos, const int* token_valid,
                     int T_, int H, int layer, int NB, int KVH, int bs, int D, int S, int MB, int n_split, int span,
                     float scale, cudaStream_t stream) {
    if ((D * (int)sizeof(T)) % 16 || D * (int)sizeof(T) > 16 * kMaxRowChunks) return kBadHeadDim;
    const Geometry geo = layout(D, H / KVH, (int)sizeof(T));
    if (span % geo.stage_pos) return kBadHeadDim;
#define DSTT_PAGED_CASE(C, RR)                                                                                    \
    if (geo.cpl == C && geo.heads == RR)                                                                          \
        return launch_attention_r<T, C, RR>(geo, q, cache, out, part, counter, table, table_stride, token_seq,  \
                                            token_pos, token_valid, T_, H, layer, NB, KVH, bs, D, S, MB, n_split, \
                                            span, scale, stream);
    DSTT_PAGED_CASE(1, 1) DSTT_PAGED_CASE(1, 2) DSTT_PAGED_CASE(1, 4)
    DSTT_PAGED_CASE(2, 1) DSTT_PAGED_CASE(2, 2) DSTT_PAGED_CASE(2, 4)
    DSTT_PAGED_CASE(4, 1) DSTT_PAGED_CASE(4, 2)
    DSTT_PAGED_CASE(8, 1)
#undef DSTT_PAGED_CASE
    return kBadHeadDim;
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16. Each launch function returns
// cudaGetLastError() after its launch (0 on success), -1 for a bad dtype, -2
// for a head_dim the attention kernel does not take (D * itemsize not a
// multiple of 16 or over 2048 bytes, or a span that is not a multiple of the
// stage).
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
        default: return kBadDtype;
    }
}

// part: f32 workspace of T * KVH * head_groups * n_split * heads * (D + 2)
// values; counter: int32 [T * KVH * head_groups], zero before the first
// launch (each launch leaves it zero).
int dstt_paged_attention(const void* q, const void* cache, void* out, int dtype, float* part, int* counter,
                         const int* table, int64_t table_stride, const int* token_seq, const int* token_pos,
                         const int* token_valid, int T, int H, int layer, int NB, int KVH, int bs, int D, int S,
                         int MB, int n_split, int span, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_attention<float>(q, cache, out, part, counter, table, table_stride, token_seq, token_pos, token_valid, T, H, layer, NB, KVH, bs, D, S, MB, n_split, span, scale, s);
        case 1: return launch_attention<__half>(q, cache, out, part, counter, table, table_stride, token_seq, token_pos, token_valid, T, H, layer, NB, KVH, bs, D, S, MB, n_split, span, scale, s);
        case 2: return launch_attention<__nv_bfloat16>(q, cache, out, part, counter, table, table_stride, token_seq, token_pos, token_valid, T, H, layer, NB, KVH, bs, D, S, MB, n_split, span, scale, s);
        default: return kBadDtype;
    }
}

// The launch geometry for (head_dim, rep, itemsize), for the wrapper's
// mirror to be checked against: {chunks, lp, cpl, heads, head_groups,
// stage_pos, smem}. Returns 0, or -2 for a head_dim the kernel does not take.
int dstt_paged_attention_geometry(int D, int rep, int itemsize, int* out7) {
    if ((D * itemsize) % 16 || D * itemsize > 16 * kMaxRowChunks || rep < 1) return kBadHeadDim;
    const Geometry g = layout(D, rep, itemsize);
    const int v[7] = {g.chunks, g.lp, g.cpl, g.heads, g.head_groups, g.stage_pos, g.smem};
    for (int i = 0; i < 7; ++i) out7[i] = v[i];
    return 0;
}

const char* dstt_error_string(int code) {
    if (code == kBadDtype) return "unsupported dtype";
    if (code == kBadHeadDim) return "unsupported head_dim";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
