"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build: compile every CUDA source of deepspeed_tpu_torch/csrc with nvcc for
   sm_90a (one nvcc per source, in parallel), print ptxas's report and the
   card's name and power limit;
2. kernels: hold each hand-written kernel against its plain PyTorch version
   on the same inputs, in bf16, at the shapes the main paths give it and at
   the token mixes and sequence lengths it must handle (and run the paged
   kernel twice on the same inputs: the same bits); time kernel, plain
   version and the PyTorch library call for the same attention (and, for the
   flash kernels, the host time of a wrapper call), and compute the card's
   bound for the work;
3. block-sparse attention: hold B5 against its plain version at bench.py's
   sparse-attention leg (S=8192, BigBird at two densities) and four small
   cases, each with a control that must fail, and run it twice on the same
   inputs (the same bits); run the slice's path, one
   bf16 forward + backward through SparseSelfAttention at each layout, with
   B5's launch count zeroed just before and read just after, and hold it to
   the same step in f32 while two faulty controls fail; trace one step with
   torch.profiler; time B5 (in its launch order, in index order, and with
   its lists cut at several lengths), its plain version,
   scaled_dot_product_attention
   with the layout as a mask, the dense flash kernel and the whole step;
4. main path: serve 8 requests greedily through build_engine + generate
   (which drives the serving scheduler inline) on Llama-2-7B at full width
   (random weights from a seed, bf16), three times (the same tokens each
   time; median rates reported), with the paged kernels' launch count zeroed
   just before and read just after; trace a few decode steps with
   torch.profiler; then hold the first decode step's logits, through the
   kernel and through the gather path, to the dense model run in f32;
5. serving path: from the same weights, serve the same 8 prompts at once
   over HTTP (ServingServer on 127.0.0.1, ServingScheduler on its own
   thread, ticking once all are queued: six greedy JSON requests, one SSE
   stream, one prompt sampled three times), with B1's launch count zeroed
   just before and read just after, and B1 seen launching from the
   scheduler's thread; time TTFT, ITL, e2e and served tokens/s, the same mix
   submitted in-process, and the mix again under torch.profiler; then the
   same prompts on a pool too small for them, the scheduler stepped by hand
   (it offloads and restores), and one offload -> restore round trip; hold every served greedy token to the
   dense f32 model (teacher-forced), the SSE stream to its final document,
   the sampled runs to each other and the pool to its size after stop, each
   check with a control it must reject;
6. training path: train bench.py's headline program (the 530M Llama, full
   width and depth, S=1024, micro-batch 8, GAS 8, AdamW, bf16 over f32
   masters, ZeRO stage 3, remat "dots", flash attention) through
   deepspeed_tpu_torch.initialize + train_batch, with the flash kernels'
   launch counts zeroed just before the measured steps and read just after;
   trace one train_batch with torch.profiler; check the loss falls on a
   repeated batch; hold one step's loss, gradient norm and attention
   projections' gradients, through the kernels and through plain attention
   in bf16, to the same step in f32, and show that the check rejects the
   kernel step with dq, or dk and dv, zeroed or with attention replaced;
7. print one JSON line describing every kernel, then the result line.

The script imports the port only (never jax or deepspeed_tpu), needs one
GPU, and writes its full record to chiprun_out/chip_smoke.json.
"""

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, generate
from deepspeed_tpu_torch.inference.v2.model_implementations import transformer_base
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, MemoryConfig
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, LlamaModel, init_params
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import builder
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_update, paged_attention_update_plain
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig, FixedSparsityConfig, SparseSelfAttention,
                                                      layout_to_dense_mask)
from deepspeed_tpu_torch.serving import ServingConfig, ServingScheduler, ServingServer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PROMPT_LENS = (20, 64, 128, 256, 512, 768, 1024, 1536)
NEW_TOKENS = 32
REPEATS = 3  # generate runs in the measured main path (medians reported)
PROFILE_STEPS = 8  # decode steps traced by torch.profiler after the measured runs
BLOCK = 64
MAX_CONTEXT = 4096
KV_BYTES = 8 * 2**30  # per engine
# bf16 keeps 8 significant bits; kernel and plain version each round an f32
# result summed in another order, so they differ by at most about one bf16
# ulp of the output (2^-8 relative) plus the f32 summation-order noise
KERNEL_RTOL, KERNEL_ATOL = 2**-7, 2**-10
# first decode step logits of each bf16 attention path (kernel, gather)
# against the dense model in f32, as ||a - ref|| / ||ref|| over the batch.
# bf16 keeps 8 significant bits and 32 random-weight layers accumulate the
# rounding: the gather path (the JAX package's own prefill algorithm) lands
# near 7% on an H100. Each path must stay under 10%, and the kernel path may
# be at most 25% further from the reference than the gather path.
LOGITS_L2_TOL = 0.10
KERNEL_VS_GATHER_SLACK = 1.25

# flash attention (B2-B4): (name, B, S, H, KVH, causal, head_dim)
FLASH_CASES = (
    ("bench_train", 8, 1024, 16, 16, True, 128),  # the training path's shape
    ("bench_long", 1, 4096, 16, 16, True, 128),  # bench.py's long-sequence leg
    ("gqa_S300_causal", 2, 300, 32, 8, True, 128),  # S not a multiple of the 64- or 128-row tiles
    ("gqa_S256_full", 2, 256, 32, 8, False, 128),
    ("gqa_S1000_D64_causal", 4, 1000, 16, 4, True, 64),  # the 64-wide head, ragged last tile
)
# the kernels' designs, named in the kernels line
FLASH_DESIGN = {"fwd": "wgmma+tma", "dkv": "wgmma+tma", "dq": "wgmma+tma"}
PAGED_DESIGN = "split context, cp.async.bulk"
# Every element of out, dq, dk and dv is held to its plain value within
# FLASH_TILE_ATOL times the larger of its row's rms (the D values of one
# position and head) and its tile's (the 64 positions x D values of one head
# that a kernel block owns), plus FLASH_RTOL times its own size. The
# kernels round P and dS to bf16 before their tensor-core products, as
# FlashAttention-2 does (a relative error of up to 2^-9 per term, about
# 0.0011 rms), and each output once more (up to 2^-9 of itself); the plain
# versions keep f32 throughout. The first error scales with the terms summed,
# not with the element: an element near 0 is the cancellation of terms of
# its neighbours' size, and a whole row can be one (dq of query 0 in causal
# attention is ds = p (dO.v - delta) = 0 up to f32 noise). lse is f32 on
# both sides, from the same bf16 scores summed in another order.
FLASH_RTOL, FLASH_TILE_ATOL, FLASH_TILE = 2**-7, 2**-6, 64
FLASH_LSE_ATOL = 2**-10
# the check's control: each output with the positions of the last quarter of
# the sequence off by 2^-4 (6%) must fail it. On an H100 the sound outputs of
# the five cases use 0.56-0.75 of their allowance and the controls 5.5-6.2.
FLASH_CONTROL_ERR = 2**-4

# block-sparse attention (B5): bench.py's sparse-attention leg
# (bench.py:576-631): B=1, H=16, S=8192, D=128, layout block 64, bf16,
# BigBird with one global block at two densities, (num_random_blocks,
# num_sliding_window_blocks) = (1, 3) and (4, 9)
BSA_B, BSA_H, BSA_S, BSA_D, BSA_LB = 1, 16, 8192, 128, 64
BSA_BENCH = (("bigbird_low", 1, 3), ("bigbird_high", 4, 9))
# kernel checks besides (name, B, H, S, D, layout block, layout): the cell
# mask inside a tile (layout block 16, causal windows), an S that is not a
# multiple of the 64-row tile, rows and a head that attend nothing, and
# global rows split into chunks at layout block 16 and a ragged S (each
# head's first q tile walks all 65 K/V tiles, in 3 chunks)
BSA_EXTRA = (("fixed_uni_lb16", 1, 16, 1024, 64, 16, "fixed"),
             ("bigbird_lb16_S1040", 1, 8, 1040, 128, 16, "bigbird"),
             ("empty_rows_lb16", 2, 4, 256, 64, 16, "empty_rows"),
             ("bigbird_lb16_S4112_split", 2, 8, 4112, 128, 16, "bigbird"))
BSA_DESIGN = "tma+wgmma, split rows"
# B5's chunk lengths timed at the bench layouts (128: no list is cut)
BSA_SPLIT_SWEEP = (8, 16, 32, 64, 128)
# B5's output is held to its plain version by the flash kernels' element
# rule (_tile_tol_use), and the kernel run with one attended layout cell
# cleared in its lists (not in the plain version's) must fail that rule.
# One bf16 forward + backward through SparseSelfAttention at each bench
# layout, loss mean(out.float()^2) as in bench.py, is held to the same
# computation in f32 through autograd of the plain forward: the loss (as a
# relative error) and dq, dk, dv (as ||g - g_f32|| / ||g_f32||). Controls,
# which the check must reject: the layout with one attended cell cleared in
# every head (forward and backward), and dk and dv zeroed. A CPU emulation
# of the kernel's rounding (P and out in bf16) put the sound readings near
# 1e-5 (loss) and 0.002 (gradients), and the cleared cell at 8e-4 to 1.3e-3
# (loss) and 0.014 to 0.05 (gradients); each limit lies between.
BSA_LOSS_REL_TOL = 1e-4
BSA_GRAD_L2_TOL = 0.008

# training: bench.py's headline program (bench.py:869-873, 883-889)
TRAIN_S, TRAIN_MICRO, TRAIN_GAS, TRAIN_LR = 1024, 8, 8, 1e-4
TRAIN_WARMUP, TRAIN_MEASURED, TRAIN_REPEAT = 2, 4, 3
# one step (one micro-batch of 8 x 1024 tokens) of each bf16 path against
# the same step in f32: the loss, the global gradient norm, and the gradient
# of each attention projection (q_proj reads dq, k_proj dk, v_proj dv; all
# layers, as ||g - g_f32|| / ||g_f32||). The loss of random weights sits near
# ln(32000) whatever the attention does, and the global norm is mostly the
# embedding's and lm_head's, so the projections' gradients are what see a
# wrong attention gradient. Controls, which the checks must reject: the
# kernel step with dq zeroed, with dk and dv zeroed, and with the attention
# output replaced by v (each position attends to itself only). Readings on
# an H100 (bf16 paths against f32; kernels, plain attention): loss 3.1e-5,
# 2.0e-5; norm 3.1e-4, 2.1e-4; projections 0.028-0.032. Controls: identity
# attention moves the loss by 7.9e-4 (dq or dkv zeroed leave it alone), dq
# zeroed moves the norm by 5.9e-2 and dkv zeroed by 0.30, and each control
# puts the projections it corrupts at 1.0 (the others at 0.11 or more). Each
# limit lies between the sound readings and the nearest control's.
LOSS_REL_TOL = 2e-4
GRAD_NORM_REL_TOL = 5e-3
ATTN_GRAD_L2_TOL = 0.06
ATTN_PROJ = ("q_proj", "k_proj", "v_proj")


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 1 --
def build_kernels() -> dict:
    t0 = time.perf_counter()
    libs = builder.build()
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        log(f"[build] {name}: {path.name}")
        log(path.with_suffix(".log").read_text().strip())
    log(f"[build] {len(libs)} kernel libraries ready in {secs:.1f} s")
    return {"seconds": secs, "libraries": [p.name for p in libs.values()]}


# ----------------------------------------------------------------- phase 2 --
def _paged_case(name, H, KVH, bs, seqs, gen, cpu_gen):
    """Inputs of one paged-attention call, at layer 1 of a two-layer cache
    with head_dim 128. ``seqs`` lists, per sequence, the positions of its
    tokens (empty: a padding row). Tables hold distinct random blocks up to
    each sequence's last position, then -1."""
    layers, layer_idx, D = 2, 1, 128
    MB = MAX_CONTEXT // bs
    S = len(seqs)
    need = [(max(p) // bs + 1 if p else 0) for p in seqs]
    perm = torch.randperm(sum(need) + 8, generator=cpu_gen)
    table = torch.full((S, MB), -1, dtype=torch.int32)
    cursor = 0
    for s, n in enumerate(need):
        table[s, :n] = perm[cursor:cursor + n].to(torch.int32)
        cursor += n
    tok_seq, tok_pos, tok_valid = [], [], []
    for s, positions in enumerate(seqs):
        for p in positions:
            tok_seq.append(s)
            tok_pos.append(p)
            tok_valid.append(1)
    T = 8
    while T < len(tok_seq):
        T *= 2
    pad = T - len(tok_seq)
    tok_seq += [S - 1] * pad
    tok_pos += [0] * pad
    tok_valid += [0] * pad
    NB = perm.numel()
    dev = gen.device
    bf = dict(device=dev, dtype=torch.bfloat16)
    return dict(
        name=name, H=H, KVH=KVH, bs=bs, D=D, S=S, MB=MB, T=T, NB=NB,
        q=torch.empty((T, H, D), **bf).normal_(generator=gen),
        k_new=torch.empty((T, KVH, D), **bf).normal_(generator=gen),
        v_new=torch.empty((T, KVH, D), **bf).normal_(generator=gen),
        cache=torch.empty((layers, 2, NB, KVH, bs, D), **bf).normal_(generator=gen),
        layer_idx=layer_idx,
        table=table.to(dev),
        seq=torch.tensor(tok_seq, dtype=torch.int32, device=dev),
        pos=torch.tensor(tok_pos, dtype=torch.int32, device=dev),
        valid=torch.tensor(tok_valid, dtype=torch.int32, device=dev),
    )


def _attended(c):
    """Per valid token: (sequence, number of attended positions)."""
    out = []
    for s, p, v in zip(c["seq"].tolist(), c["pos"].tolist(), c["valid"].tolist()):
        if v:
            nblocks = min(p // c["bs"] + 1, c["MB"])
            out.append((min(s, c["S"] - 1), min(p, nblocks * c["bs"] - 1) + 1))
    return out


def _bound(c):
    """Least time on an H100 SXM: each input read once, each output written
    once (live KV: each sequence's attended positions once), against the
    flops of QK^T and PV."""
    T, H, KVH, D, S, MB = c["T"], c["H"], c["KVH"], c["D"], c["S"], c["MB"]
    att = _attended(c)
    live = {}
    for s, n in att:
        live[s] = max(live.get(s, 0), n)
    e = 2  # bf16
    nbytes = (T * H * D * e * 2  # q in, out
              + 2 * T * KVH * D * e  # k_new, v_new in
              + S * MB * 4 + 3 * T * 4  # table, token metadata
              + 2 * len(att) * KVH * D * e  # inserted K/V out
              + sum(live.values()) * 2 * KVH * D * e)  # live K/V in
    flops = sum(4 * H * D * n for _, n in att)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def _time_ms(fn, flush, iters=20, warmup=3):
    """Median device time of ``fn`` over ``iters`` launches, each after
    overwriting a 1 GiB buffer: the 50 MB L2 starts cold, as the main path
    finds it (each layer's KV is read once per step), and the overwrite
    keeps the card busy while the host enqueues the timed call."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _sdpa_inputs(c):
    """The same attention as one scaled_dot_product_attention call, on K/V
    gathered beforehand per valid token (padded to the longest, masked)."""
    att = _attended(c)
    rows = [t for t, v in enumerate(c["valid"].tolist()) if v]
    Lmax = max(n for _, n in att)
    li, bs, H, KVH, D = c["layer_idx"], c["bs"], c["H"], c["KVH"], c["D"]
    k = torch.zeros((len(rows), KVH, Lmax, D), dtype=torch.bfloat16, device=c["q"].device)
    v = torch.zeros_like(k)
    mask = torch.zeros((len(rows), 1, 1, Lmax), dtype=torch.bool, device=k.device)
    table = c["table"].long()
    for i, ((s, n), t) in enumerate(zip(att, rows)):
        blocks = table[s, :(n + bs - 1) // bs].clamp(min=0)
        kk = c["cache"][li, 0][blocks].permute(1, 0, 2, 3).reshape(KVH, -1, D)[:, :n]
        vv = c["cache"][li, 1][blocks].permute(1, 0, 2, 3).reshape(KVH, -1, D)[:, :n]
        k[i, :, :n], v[i, :, :n] = kk, vv
        mask[i, ..., :n] = True
    rep = H // KVH
    q = c["q"][rows].unsqueeze(2)  # [Tv, H, 1, D]
    return q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1), mask


def check_paged_attention(dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(1)
    cpu_gen = torch.Generator().manual_seed(1)
    long_mix = [[2047], [2500], [3071], [4000], list(range(100, 120)), [700], [], []]
    cases = [
        # the main path's first decode step: 8 sequences, one token each
        _paged_case("llama2_7b_decode", 32, 32, BLOCK, [[n] for n in PROMPT_LENS], gen, cpu_gen),
        # decode at >= 2k, a 20-token chunk of one sequence, -1 table tails,
        # padding rows
        _paged_case("llama2_7b_mix", 32, 32, BLOCK, long_mix, gen, cpu_gen),
        _paged_case("gqa_mix", 32, 8, 16, long_mix, gen, cpu_gen),
        # decode near the end of the 4096-position context: a bound of about
        # 0.16 ms of bytes, so the kernel's share of the bandwidth reads
        _paged_case("llama2_7b_decode_long", 32, 32, BLOCK, [[3960 + 5 * i] for i in range(8)], gen, cpu_gen),
    ]
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    results = []
    for c in cases:
        args = lambda cache: (c["q"], c["k_new"], c["v_new"], cache, c["layer_idx"], c["table"], c["seq"],
                              c["pos"], c["valid"])
        c_kernel, c_plain = c["cache"].clone(), c["cache"].clone()
        before = paged_attention_update.launches
        got, _ = paged_attention_update(*args(c_kernel))
        want, _ = paged_attention_update_plain(*args(c_plain))
        torch.cuda.synchronize()
        if paged_attention_update.launches != before + 2:
            raise RuntimeError("the wrapper did not launch its two kernels")
        if not torch.equal(c_kernel, c_plain):
            raise AssertionError(f"{c['name']}: cache after the kernel differs from the plain version's")
        # the splits merge in a fixed order: the same inputs give the same bits
        again, _ = paged_attention_update(*args(c_plain.clone()))
        if not torch.equal(again, got):
            raise AssertionError(f"{c['name']}: a second run on the same inputs gives other bits")
        del again
        err = (got.float() - want.float()).abs()
        bad = err > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
        if bad.any() or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{c['name']}: {int(bad.sum())} outputs outside rtol {KERNEL_RTOL} "
                                 f"atol {KERNEL_ATOL}; max abs err {err.max().item()}")
        del c_kernel, c_plain, got, want
        ms = _time_ms(lambda: paged_attention_update(*args(c["cache"])), flush)
        plain_ms = _time_ms(lambda: paged_attention_update_plain(*args(c["cache"])), flush, iters=5, warmup=1)
        q, k, v, mask = _sdpa_inputs(c)
        library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                              flush)
        del q, k, v, mask
        bound_ms, bound_by, nbytes, flops = _bound(c)
        r = dict(case=c["name"], H=c["H"], KVH=c["KVH"], D=c["D"], bs=c["bs"], T=c["T"], S=c["S"], MB=c["MB"],
                 valid_tokens=len(_attended(c)), max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
        log("[kernel] " + json.dumps(r))
        results.append(r)
    del flush, cases
    return results


def _flash_bounds(B, S, H, KVH, D, causal):
    """Per kernel: (bound ms, bound_by, bytes, flops) on an H100 SXM. Bytes:
    each input read once, each output written once (bf16 tensors, f32 lse
    and delta). Flops: 2 B H S^2 D per matrix product over the score matrix,
    half of it when causal; the forward does 2 (QK^T, PV), the dK/dV kernel
    4 (QK^T, dO V^T, P^T dO, dS^T Q), the dQ kernel 3 (QK^T, dO V^T, dS K).
    "backward" is FlashAttention-2's minimum for both gradients together:
    5 products, q, k, v, out, dO, lse in and dq, dk, dv out."""
    e, f32 = 2, 4
    qb, kvb, rows = B * S * H * D * e, B * S * KVH * D * e, B * H * S * f32
    mm = 2 * B * H * S * S * D * (0.5 if causal else 1.0)
    work = {"fwd": (qb + 2 * kvb + qb + rows, 2 * mm),
            "dkv": (2 * qb + 2 * kvb + 2 * rows + 2 * kvb, 4 * mm),
            "dq": (2 * qb + 2 * kvb + 2 * rows + qb, 3 * mm),
            "backward": (3 * qb + 2 * kvb + rows + qb + 2 * kvb, 5 * mm)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)
    return out


def _host_us(fn, n=50):
    """Mean host time of one call of ``fn`` in microseconds: a wrapper's
    checks, allocations, tensor maps and launch, with the card left to run
    the enqueued kernels behind it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _max_err(name, got, want, tol):
    """Max abs error of got against want; raises past ``tol`` (absolute)."""
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} (want {tuple(want.shape)}) or non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def _tile_rms(x):
    """``[B, S, H, 1]``: the rms of x [B, S, H, D] over the FLASH_TILE
    positions (the last tile: those left) and D values around each element."""
    B, S, H, D = x.shape
    n = -(-S // FLASH_TILE)
    sq = torch.zeros((B, n * FLASH_TILE, H), dtype=torch.float32, device=x.device)
    sq[:, :S] = x.float().square().sum(dim=-1)
    rows = torch.full((n, ), float(FLASH_TILE), device=x.device)
    rows[-1] = S - (n - 1) * FLASH_TILE
    ms = sq.reshape(B, n, FLASH_TILE, H).sum(dim=2) / (rows[None, :, None] * D)
    return ms.sqrt().repeat_interleave(FLASH_TILE, dim=1)[:, :S, :, None]


def _scale(x):
    """The size of the terms summed into each element of x [B, S, H, D]: the
    larger of its row's rms and its tile's (a row that is a cancellation has
    a small rms of its own; a row at the edge of a tile can be larger than
    the tile's rms)."""
    return torch.maximum(x.float().square().mean(dim=-1, keepdim=True).sqrt(), _tile_rms(x))


def _tile_tol_use(got, want):
    """Largest share of its allowance that any element of ``got`` [B, S, H, D]
    uses: |got - want| / (FLASH_TILE_ATOL _scale(want) + FLASH_RTOL |want|);
    at most 1 passes."""
    want = want.float()
    allowed = FLASH_TILE_ATOL * _scale(want) + FLASH_RTOL * want.abs()
    return ((got.float() - want).abs() / allowed.clamp(min=1e-30)).max().item()


def _flash_output_check(name, got, want):
    """Hold one kernel output to its plain value element by element, and show
    that the check rejects the output with its last quarter of positions off
    by FLASH_CONTROL_ERR. Returns the readings and what failed, if anything."""
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} (want {tuple(want.shape)}) or non-finite values")
    control = got.float().clone()
    control[:, control.shape[1] * 3 // 4:] *= 1 + FLASH_CONTROL_ERR
    r = dict(max_abs_err=(got.float() - want.float()).abs().max().item(), tol_use=_tile_tol_use(got, want),
             control_tol_use=_tile_tol_use(control, want))
    fails = []
    if not r["tol_use"] <= 1.0:
        fails.append(f"{name}: an element uses {r['tol_use']} of its allowance (rtol {FLASH_RTOL}, atol "
                     f"{FLASH_TILE_ATOL} x row or tile rms)")
    if not r["control_tol_use"] > 1.0:
        fails.append(f"{name}: the check passes the control with {FLASH_CONTROL_ERR} errors")
    return r, fails


def check_flash_attention(dev) -> list:
    """B2 (forward), B3 (dK/dV) and B4 (dQ) against their plain versions on
    the same inputs, in bf16: out and lse; then dq, dk and dv for a fixed dO
    over the kernel's out and lse. Times: each kernel, its plain version
    (the plain backward computes all three gradients, so dK/dV and dQ share
    its time), and scaled_dot_product_attention on the same work (the
    forward alone; forward + backward minus forward for the backward)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results, failures = [], []
    for name, B, S, H, KVH, causal, D in FLASH_CASES:
        bf = dict(device=dev, dtype=torch.bfloat16)
        q = torch.empty((B, S, H, D), **bf).normal_(generator=gen)
        k = torch.empty((B, S, KVH, D), **bf).normal_(generator=gen)
        v = torch.empty((B, S, KVH, D), **bf).normal_(generator=gen)
        dout = torch.empty((B, S, H, D), **bf).normal_(generator=gen)
        scale = D**-0.5
        before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches,
                  fa.flash_attention_bwd_dq.launches)
        out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
        delta = fa.attention_delta(dout, out)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
        dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
        torch.cuda.synchronize()
        after = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches,
                 fa.flash_attention_bwd_dq.launches)
        if after != tuple(n + 1 for n in before):
            raise RuntimeError(f"{name}: the wrappers did not launch their kernels once each")
        want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
        want_dq, want_dk, want_dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, causal)
        errs = {"lse": _max_err(f"{name} lse", lse, want_lse, FLASH_LSE_ATOL)}
        checks = {}
        for what, got, want in (("out", out, want_out), ("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
            checks[what], fails = _flash_output_check(f"{name} {what}", got, want)
            failures += fails
        errs.update({what: c["max_abs_err"] for what, c in checks.items()})
        del want_out, want_lse, want_dq, want_dk, want_dv, dq, dk, dv

        ms = {"fwd": _time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale, causal), flush),
              "dkv": _time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal), flush),
              "dq": _time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, causal), flush)}
        ms["backward"] = ms["dkv"] + ms["dq"]
        host_us = {"fwd": _host_us(lambda: fa.flash_attention_fwd(q, k, v, scale, causal)),
                   "dkv": _host_us(lambda: fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)),
                   "dq": _host_us(lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, causal))}
        host_us["backward"] = host_us["dkv"] + host_us["dq"]
        plain = {"fwd": _time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, scale, causal), flush, iters=5,
                                 warmup=1)}
        plain["dkv"] = plain["dq"] = plain["backward"] = _time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, causal), flush, iters=5, warmup=1)
        # the library call on the same work, [B, H, S, D] with the KV heads repeated
        qs, ks, vs = (t.repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2).contiguous() for t in (q, k, v))
        gs = dout.transpose(1, 2).contiguous()
        with torch.no_grad():
            sdpa_fwd = _time_ms(lambda: sdpa(qs, ks, vs, is_causal=causal), flush)
        qs, ks, vs = (t.requires_grad_() for t in (qs, ks, vs))
        sdpa_both = _time_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs, is_causal=causal), (qs, ks, vs), gs),
                             flush)
        library = {"fwd": sdpa_fwd, "dkv": sdpa_both - sdpa_fwd, "dq": sdpa_both - sdpa_fwd,
                   "backward": sdpa_both - sdpa_fwd}
        del qs, ks, vs, gs
        bounds = _flash_bounds(B, S, H, KVH, D, causal)
        r = dict(case=name, B=B, S=S, H=H, KVH=KVH, D=D, causal=causal, max_abs_err=errs, checks=checks,
                 **{kern: dict(ms=ms[kern], plain_ms=plain[kern], library_ms=library[kern], bound_ms=bounds[kern][0],
                               bound_by=bounds[kern][1], bytes=bounds[kern][2], flops=bounds[kern][3],
                               tflops_per_s=bounds[kern][3] / ms[kern] / 1e9, host_us=host_us[kern])
                    for kern in ("fwd", "dkv", "dq", "backward")})
        log("[kernel] " + json.dumps(r))
        results.append(r)
        del q, k, v, dout, out, lse, delta
    del flush
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return results


# ----------------------------------------------------------------- phase 3 --
def bsa_layout(kind, H, S, lb, num_random_blocks=1, num_sliding_window_blocks=3):
    """A layout [H, S // lb, S // lb] of B5's checks (here and in
    tests/test_torch_cuda_kernels.py): "bigbird" with one global block;
    "fixed", causal windows with a global pattern per head; "empty_rows"
    (H >= 3), head 0 the diagonal only, head 1 the first three columns but
    for row 2, which attends nothing, head 2 the last column, and the heads
    after it nothing at all."""
    if kind == "bigbird":
        return BigBirdSparsityConfig(num_heads=H, block=lb, num_random_blocks=num_random_blocks,
                                     num_sliding_window_blocks=num_sliding_window_blocks,
                                     num_global_blocks=1).make_layout(S)
    if kind == "fixed":
        return FixedSparsityConfig(num_heads=H, block=lb, attention="unidirectional", different_layout_per_head=True,
                                   num_different_global_patterns=2).make_layout(S)
    if kind != "empty_rows":
        raise ValueError(f"unknown layout kind {kind!r}")
    nb = S // lb
    layout = np.zeros((H, nb, nb), bool)
    layout[0] = np.eye(nb, dtype=bool)
    layout[1, :, :3] = True
    layout[1, 2] = False
    layout[2, :, -1] = True
    return layout


def _drop_cell(layout, every_head=False):
    """The layout with one attended cell cleared: the last cell of the middle
    row that attends two or more, in the first head that has one (or in every
    head)."""
    lay = np.array(layout, bool)
    for h in range(lay.shape[0]):
        rows = np.nonzero(lay[h].sum(-1) >= 2)[0]
        if len(rows):
            r = int(rows[len(rows) // 2])
            c = int(np.nonzero(lay[h, r])[0][-1])
            lay[slice(None) if every_head else h, r, c] = False
            return lay, dict(head="every" if every_head else h, row=r, col=c)
    raise ValueError("no layout row attends two cells")


def _bsa_bound(B, H, S, D, layout, lb):
    """Least time on an H100 SXM for B5: q, k and v read once and out written
    once (bf16), plus what of the kernel's lists it must read: each live list
    entry (int32) and, once each, the layout cells (uint8) of the tile pairs
    that are partial; QK^T and PV over the attended (query, key) pairs, 4 D
    flops each."""
    layout = np.asarray(layout, bool)
    steps, counts = bsa.build_tile_lists(layout, S, lb)
    start = np.arange(counts.shape[1]) * bsa.KERNEL_TILE
    lo, hi = start // lb, (np.minimum(start + bsa.KERNEL_TILE, S) - 1) // lb + 1  # the cells each tile covers
    read = np.zeros_like(layout)
    live = np.arange(steps.shape[2]) < counts[..., None]
    for h, qt, st in zip(*np.nonzero(live & (steps & 1 == 1))):
        kt = steps[h, qt, st] >> 1
        read[h, lo[qt]:hi[qt], lo[kt]:hi[kt]] = True
    nbytes = 4 * B * H * S * D * 2 + int(counts.sum()) * 4 + int(read.sum())
    flops = 4 * B * D * int(layout.sum()) * lb * lb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


class _IndexOrderPlan(bsa.BlockSparsePlan):
    """The plan with B5's work items launched in index order (head, q tile,
    split), not longest first: times what the sorted order gains."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.items = self.items[np.lexsort((self.items[:, 4], self.items[:, 1], self.items[:, 0]))]


def _bsa_output_check(name, got, want, control, layout, lb):
    """B5's output against its plain version by the flash kernels' element
    rule (over [B, S, H, D]); the control must fail it; rows whose layout
    row attends nothing must be exactly zero."""
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} (want {tuple(want.shape)}) or non-finite values")
    empty = torch.from_numpy(np.repeat(~np.asarray(layout, bool).any(-1), lb, axis=1)).to(got.device)  # [H, S]
    r = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
             tol_use=_tile_tol_use(got.transpose(1, 2), want.transpose(1, 2)),
             control_tol_use=_tile_tol_use(control.transpose(1, 2), want.transpose(1, 2)),
             empty_rows=int(empty.sum()), empty_rows_nonzero=int(got[:, empty].ne(0).sum()))
    fails = []
    if not r["tol_use"] <= 1.0:
        fails.append(f"{name}: an element uses {r['tol_use']} of its allowance")
    if not r["control_tol_use"] > 1.0:
        fails.append(f"{name}: the check passes the kernel with a layout cell cleared")
    if r["empty_rows_nonzero"]:
        fails.append(f"{name}: {r['empty_rows_nonzero']} outputs of rows that attend nothing are not zero")
    return r, fails


def _bsa_step(attn, q, k, v):
    """bench.py's step: the loss mean(out.float()^2) and its gradients with
    respect to q, k and v."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    loss = (attn(*leaves).float()**2).mean()
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _profile_sparse_step(attn, q, k, v):
    """One forward + backward step under torch.profiler: the card's busy
    share of the host wall time, B5's device time and the top items."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _bsa_step(attn, q, k, v)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    b5_us = sum(e.self_device_time_total for e in device if "block_sparse_fwd_kernel" in e.key)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    return dict(wall_ms=1e3 * wall, device_ms=busy_us / 1e3,
                device_busy_share=busy_us / 1e6 / wall if busy_us else "not measured", b5_ms=b5_us / 1e3,
                top_items=[dict(name=e.key[:100], calls=e.count, ms=e.self_device_time_total / 1e3) for e in top])


def _bsa_readings(loss, grads, ref_loss, ref_grads):
    r = dict(loss_rel_err=_rel(float(loss), ref_loss),
             **{f"d{n}_l2_rel_err": ((g.float() - rg).norm() / rg.norm()).item()
                for n, g, rg in zip("qkv", grads, ref_grads)})
    r["fails"] = [key for key, val in r.items()
                  if not val <= (BSA_LOSS_REL_TOL if key == "loss_rel_err" else BSA_GRAD_L2_TOL)]
    return r


def _sparse_attention_path(dev, inputs) -> dict:
    """The slice's path: one bf16 forward + backward through
    SparseSelfAttention at each bench layout, B5's launch count zeroed just
    before and read just after; then each held to f32, with its controls."""
    attns = {name: SparseSelfAttention(BigBirdSparsityConfig(num_heads=BSA_H, block=BSA_LB, num_random_blocks=nr,
                                                              num_sliding_window_blocks=nw, num_global_blocks=1))
             for name, nr, nw in BSA_BENCH}
    bsa.block_sparse_attention_fwd.launches = 0
    steps = {name: _bsa_step(attns[name], *inputs[name]) for name in attns}
    torch.cuda.synchronize()
    launches = bsa.block_sparse_attention_fwd.launches
    if launches != len(attns):
        raise AssertionError(f"{launches} B5 launches for {len(attns)} forward calls")
    res = dict(launches=launches, forward_calls=len(attns), layouts={})
    failures = []
    for name, attn in attns.items():
        q, k, v = inputs[name]
        layout = attn.get_layout(BSA_S)
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        ref_loss = (bsa.block_sparse_attention_fwd_plain(*ref, layout, BSA_LB, BSA_D**-0.5)**2).mean()
        ref_loss.backward()
        ref_loss, ref_grads = ref_loss.item(), [t.grad for t in ref]
        del ref
        loss, grads = steps[name]
        loss = loss.item()
        if not np.isfinite(loss) or any(not torch.isfinite(g.float()).all() for g in grads):
            raise AssertionError(f"{name}: non-finite loss or gradients")
        readings = {"kernel_bf16": _bsa_readings(loss, grads, ref_loss, ref_grads)}
        bad, cell = _drop_cell(layout, every_head=True)
        readings["control_cell_cleared"] = _bsa_readings(
            *_bsa_step(lambda *t: bsa.block_sparse_attention(*t, bad, BSA_LB), q, k, v), ref_loss, ref_grads)
        readings["control_cell_cleared"]["cell"] = cell
        bsa_bwd = bsa.block_sparse_attention_bwd
        zero_dkv = lambda q_, k_, v_, *a: (bsa_bwd(q_, k_, v_, *a)[0], torch.zeros_like(k_), torch.zeros_like(v_))
        with _patched("block_sparse_attention_bwd", zero_dkv, bsa):
            readings["control_dkv_zeroed"] = _bsa_readings(*_bsa_step(attn, q, k, v), ref_loss, ref_grads)
        res["layouts"][name] = dict(loss=loss, loss_f32=ref_loss, **readings)
        del grads, ref_grads
        steps[name] = None
        torch.cuda.empty_cache()
        if readings["kernel_bf16"]["fails"]:
            failures.append(f"{name}: the bf16 step against f32 fails {readings['kernel_bf16']}")
        for control in ("control_cell_cleared", "control_dkv_zeroed"):
            if not readings[control]["fails"]:
                failures.append(f"{name}: the check passes {control}: {readings[control]}")
    log("[sparse] main path: " + json.dumps(res))
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def check_block_sparse_attention(dev) -> dict:
    """B5 against its plain version on the same inputs, in bf16, at bench.py's
    two BigBird layouts and the BSA_EXTRA cases, each with its control, and
    again on the same inputs (the same bits, the split-row counters back at
    zero); then the slice's path (forward + backward through
    SparseSelfAttention) held to f32; then, at the bench layouts, the times
    of the kernel (its items launched longest first, then in index order,
    then longest first again; then with lists cut at each BSA_SPLIT_SWEEP
    length), its plain version, scaled_dot_product_attention with the layout
    as a dense mask, B2 (dense, not causal) on the same q, k, v, and a
    forward + backward step."""
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(name, BSA_B, BSA_H, BSA_S, BSA_D, BSA_LB, "bigbird", nr, nw) for name, nr, nw in BSA_BENCH]
    cases += [(*c, 1, 3) for c in BSA_EXTRA]
    results, failures, bench_inputs = [], [], {}
    bench_names = {name for name, *_ in BSA_BENCH}
    for name, B, H, S, D, lb, kind, nr, nw in cases:
        layout = bsa_layout(kind, H, S, lb, nr, nw)
        q, k, v = (torch.empty((B, H, S, D), device=dev, dtype=torch.bfloat16).normal_(generator=gen)
                   for _ in range(3))
        scale = D**-0.5
        plan = bsa.get_plan(layout, S, lb)
        before = bsa.block_sparse_attention_fwd.launches
        got = bsa.block_sparse_attention_fwd(q, k, v, plan, scale)
        torch.cuda.synchronize()
        if bsa.block_sparse_attention_fwd.launches != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch its kernel once")
        if any(counters.any() for counters, _ in bsa._WORKSPACES.values()):
            failures.append(f"{name}: a split-row counter is not back at zero after the launch")
        # the chunks of a split row merge in a fixed order: the same inputs give the same bits
        if not torch.equal(bsa.block_sparse_attention_fwd(q, k, v, plan, scale), got):
            failures.append(f"{name}: a second run on the same inputs gives other bits")
        want = bsa.block_sparse_attention_fwd_plain(q, k, v, layout, lb, scale)
        bad, cell = _drop_cell(layout)
        control = bsa.block_sparse_attention_fwd(q, k, v, bsa.get_plan(bad, S, lb), scale)
        check, fails = _bsa_output_check(name, got, want, control, layout, lb)
        failures += fails
        bound_ms, bound_by, nbytes, flops = _bsa_bound(B, H, S, D, layout, lb)
        r = dict(case=name, B=B, H=H, S=S, D=D, layout_block=lb, layout=kind, density=float(layout.mean()),
                 tile_steps=int(plan.tile_counts.sum()), longest_list=int(plan.tile_counts.max()),
                 split_steps=plan.split_steps, work_items=len(plan.items), split_rows=plan.n_rows,
                 control_cell=cell, **check, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
        del got, want, control
        if name in bench_names:
            bench_inputs[name] = (q, k, v)
            r["layout_args"] = dict(num_random_blocks=nr, num_sliding_window_blocks=nw, num_global_blocks=1)
        log("[sparse] " + json.dumps(r))
        results.append(r)
    if failures:
        raise AssertionError("; ".join(failures))

    path = _sparse_attention_path(dev, bench_inputs)

    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    for r in results[:len(BSA_BENCH)]:
        q, k, v = bench_inputs[r["case"]]
        attn = SparseSelfAttention(BigBirdSparsityConfig(num_heads=BSA_H, block=BSA_LB, **r["layout_args"]))
        layout = attn.get_layout(BSA_S)
        plan, scale = bsa.get_plan(layout, BSA_S, BSA_LB), BSA_D**-0.5
        r["ms"] = _time_ms(lambda: bsa.block_sparse_attention_fwd(q, k, v, plan, scale), flush)
        index_plan = _IndexOrderPlan(layout, BSA_S, BSA_LB, plan.block_q, plan.block_k)
        r["ms_index_order"] = _time_ms(lambda: bsa.block_sparse_attention_fwd(q, k, v, index_plan, scale), flush)
        r["ms_split_steps"] = {}
        for n in BSA_SPLIT_SWEEP:
            sweep_plan = bsa.BlockSparsePlan(layout, BSA_S, BSA_LB, plan.block_q, plan.block_k, split_steps=n)
            r["ms_split_steps"][n] = _time_ms(lambda: bsa.block_sparse_attention_fwd(q, k, v, sweep_plan, scale),
                                              flush)
        r["ms_sorted_again"] = _time_ms(lambda: bsa.block_sparse_attention_fwd(q, k, v, plan, scale), flush)
        r["plain_ms"] = _time_ms(lambda: bsa.block_sparse_attention_fwd_plain(q, k, v, layout, BSA_LB, scale), flush,
                                 iters=5, warmup=1)
        mask = layout_to_dense_mask(layout, BSA_LB).to(dev)[None]  # [1, H, S, S]
        with torch.no_grad():
            r["library_ms"] = _time_ms(lambda: sdpa(q, k, v, attn_mask=mask), flush)
        del mask
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        r["b2_dense_ms"] = _time_ms(lambda: fa.flash_attention_fwd(qs, ks, vs, scale, False), flush)
        del qs, ks, vs
        r["fwd_bwd_ms"] = _time_ms(lambda: _bsa_step(attn, q, k, v), flush, iters=10, warmup=2)
        # a trace now and then lacks a kernel's record (one read 0 ms for B5 at
        # the high layout on an H100): up to three traces
        for traces in range(1, 4):
            r["profile"] = dict(_profile_sparse_step(attn, q, k, v), traces=traces)
            if r["profile"]["b5_ms"] > 0:
                break
        log("[sparse] profile: " + json.dumps(r["profile"]))
        if not r["profile"]["b5_ms"] > 0:
            raise AssertionError(f"three traces find no time for B5 by name: {r['profile']['top_items']}")
        r["tflops_per_s"] = r["flops"] / r["ms"] / 1e9
        log("[sparse] times: " + json.dumps({key: r[key] for key in ("case", "density", "ms", "ms_index_order",
                                                                      "ms_sorted_again", "ms_split_steps",
                                                                      "bound_ms", "plain_ms",
                                                                      "library_ms", "b2_dense_ms", "fwd_bwd_ms")}))
    del flush, bench_inputs
    torch.cuda.empty_cache()
    lo, hi = results[0], results[1]
    scaling = dict(density_ratio=hi["density"] / lo["density"], kernel_time_ratio=hi["ms"] / lo["ms"],
                   fwd_bwd_time_ratio=hi["fwd_bwd_ms"] / lo["fwd_bwd_ms"])
    log("[sparse] scaling with density: " + json.dumps(scaling))
    return dict(cases=results, path=path, scaling=scaling, seconds=time.perf_counter() - t_start)


# ----------------------------------------------------------------- phase 4 --
def _engine(params, cfg, use_paged_kernel, dev):
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT, memory_config=MemoryConfig(size=KV_BYTES))
    return build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK,
                                                                 use_paged_kernel=use_paged_kernel),
                        device=dev)


def _timed(engine, name, record, work=None):
    """Wrap an engine method with a host clock between two synchronizes; each
    call appends its seconds to ``record`` (or ``(seconds, work(*args))``
    when ``work`` is given)."""
    inner = getattr(engine, name)

    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        record.append(secs if work is None else (secs, work(*args)))
        return out

    setattr(engine, name, call)


def _put_tokens(uids, tokens, *_):
    return sum(len(t) for t in tokens)


def _loop_steps(uids, tokens, n_steps, *_):
    return len(uids), n_steps


def _prefill(engine, prompts):
    """Prefill prompt i as sequence i, one request per put in chunks of the
    token budget, as generate does."""
    chunk = engine.config.state_manager.max_ragged_batch_size
    for uid, p in enumerate(prompts):
        for start in range(0, len(p), chunk):
            engine.put([uid], [p[start:start + chunk]])


def _first_decode_logits(engine, prompts, first_tokens):
    """Prefill every prompt, then one decode step for all of them in one
    put; returns that step's logits."""
    _prefill(engine, prompts)
    logits = engine.put(list(range(len(prompts))), [[t] for t in first_tokens]).float()
    engine.flush_all()
    return logits


def _l2_rel(a, ref):
    return ((a - ref).norm() / ref.norm()).item()


def _profile_decode(engine, prompts, first_tokens):
    """One greedy ``decode_loop`` of PROFILE_STEPS steps for all requests
    under torch.profiler: the card's busy share of the host wall time (sum of
    device records over the wall time) and the device time of the top
    kernels. Informational: an empty device trace is reported, not fatal.
    Also returns the loop's tokens ``[n_seqs, PROFILE_STEPS]``."""
    _prefill(engine, prompts)
    uids = list(range(len(prompts)))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop_tokens = engine.decode_loop(uids, [[t] for t in first_tokens], PROFILE_STEPS)  # ends in a device->host copy
        wall = time.perf_counter() - t0
    engine.flush_all()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    paged_us = sum(e.self_device_time_total for e in device if "paged_" in e.key)
    attention_us = sum(e.self_device_time_total for e in device if "paged_attention_kernel" in e.key)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return loop_tokens, dict(
        steps=PROFILE_STEPS, wall_ms_per_step=1e3 * wall / PROFILE_STEPS,
        device_ms_per_step=busy_us / 1e3 / PROFILE_STEPS,
        device_busy_share=busy_us / 1e6 / wall if busy_us else "not measured",
        paged_kernels_ms_per_step=paged_us / 1e3 / PROFILE_STEPS,
        paged_attention_kernel_ms_per_step=attention_us / 1e3 / PROFILE_STEPS,
        top_kernels=[dict(name=e.key[:80], calls_per_step=e.count / PROFILE_STEPS,
                          ms_per_step=e.self_device_time_total / 1e3 / PROFILE_STEPS) for e in top])


def main_params(dev) -> dict:
    """Llama-2-7B's bf16 weights, random from seed 0: the main path's and the
    serving phase's."""
    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[main] Llama-2-7B: {sum(p.numel() for p in params.values())} random bf16 parameters "
        f"({cfg.num_hidden_layers} layers) in {time.perf_counter() - t0:.1f} s")
    return params


def _dense_f32(params, cfg):
    """The dense model in f32 with the same weights, upcast: the reference
    both bf16 attention paths and the served tokens are held to."""
    with torch.device("meta"):
        model = LlamaModel(cfg)
    model.load_state_dict({k: v.float() for k, v in params.items()}, assign=True)
    return model


def run_main_path(dev, params=None) -> dict:
    """Serve PROMPT_LENS through generate (which drives the serving
    scheduler inline) REPEATS times; ``params`` defaults to
    :func:`main_params`."""
    cfg = LlamaConfig.llama2_7b()
    if params is None:
        params = main_params(dev)
    engine = _engine(params, cfg, None, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]

    # warm-up (cuBLAS handles, allocator pools), not counted
    generate(engine, [prompts[0], prompts[2]], max_new_tokens=4, decode_chunk=4)
    torch.cuda.synchronize()

    # generate drives the serving scheduler: the timers wrap the engine's
    # attributes, so they see the scheduler's calls
    times = {"put": [], "decode_loop": []}
    _timed(engine, "put", times["put"], _put_tokens)
    _timed(engine, "decode_loop", times["decode_loop"], _loop_steps)
    runs = []
    paged_attention_update.launches = 0
    for _ in range(REPEATS):
        times["put"].clear()
        times["decode_loop"].clear()
        t0 = time.perf_counter()
        tokens = generate(engine, prompts, max_new_tokens=NEW_TOKENS, decode_chunk=NEW_TOKENS)
        torch.cuda.synchronize()
        runs.append(dict(wall_s=time.perf_counter() - t0, prefill_s=sum(s for s, _ in times["put"]),
                         decode_s=sum(s for s, _ in times["decode_loop"]), puts=len(times["put"]),
                         put_tokens=[n for _, n in times["put"]],
                         decode_loops=[list(w) for _, w in times["decode_loop"]], tokens=tokens))
    launches = paged_attention_update.launches
    if launches <= 0:
        raise AssertionError("the main path launched no paged-attention kernel")
    if [len(t) for t in tokens] != [NEW_TOKENS] * len(prompts) or \
            not all(0 <= x < cfg.vocab_size for t in tokens for x in t):
        raise AssertionError(f"unexpected generate output: {[len(t) for t in tokens]}")
    if any(r.pop("tokens") != tokens for r in runs):
        raise AssertionError("greedy generate is not repeatable")
    # the scheduler's puts carry the prompt chunks (and the decode tokens of
    # requests whose prefill ended while others' went on); once all are
    # decoding, decode_loop runs the rest in chunks of NEW_TOKENS steps
    for r in runs:
        steps = sum(n for _, n in r["decode_loops"])
        r.update(prefill_tokens_per_s=sum(PROMPT_LENS) / r["prefill_s"],
                 decode_tokens_per_s=sum(s * n for s, n in r["decode_loops"]) / r["decode_s"],
                 ms_per_decode_step=1e3 * r["decode_s"] / steps)
    # B1 runs two launches per layer in each decode_loop step and in each put
    # of at most 32 tokens (a decode-sized bucket)
    expected_launches = 2 * cfg.num_hidden_layers * sum(
        sum(n for _, n in r["decode_loops"]) + sum(1 for n in r["put_tokens"] if n <= 32) for r in runs)
    res = dict(layers=cfg.num_hidden_layers, requests=len(prompts), prompt_tokens=sum(PROMPT_LENS),
               new_tokens=NEW_TOKENS, runs=runs,
               **{k: statistics.median(r[k] for r in runs)
                  for k in ("prefill_tokens_per_s", "decode_tokens_per_s", "ms_per_decode_step")},
               paged_attention_launches=launches, expected_launches=expected_launches)
    log("[main] " + json.dumps(res))
    del engine.put, engine.decode_loop  # unwrap the timers

    first = [t[0] for t in tokens]
    loop_tokens, prof = _profile_decode(engine, prompts, first)
    res["decode_profile"] = prof
    # the profiler slows the host, not the card: the device time per step
    # over the unprofiled step time is the busy share of the measured runs
    prof["device_share_of_measured_step"] = prof["device_ms_per_step"] / res["ms_per_decode_step"]
    log("[main] decode profile: " + json.dumps(res["decode_profile"]))
    if not prof["paged_attention_kernel_ms_per_step"] > 0:
        raise AssertionError("the decode profile finds no time for paged_attention_kernel by name")

    # first decode step: kernel path, gather path, dense f32 model
    paged = _first_decode_logits(engine, prompts, first)
    if not torch.isfinite(paged).all() or paged.shape != (len(prompts), cfg.vocab_size):
        raise AssertionError(f"bad logits {tuple(paged.shape)}")
    # both through the kernel, in one batch of the 8 requests: the served
    # second tokens may come from the gather branch (a put that also carried
    # other requests' prompt chunks), so decode_loop's own is the one to match
    if paged.argmax(-1).tolist() != [int(t) for t in loop_tokens[:, 0]]:
        raise AssertionError("put's first decode step disagrees with decode_loop's")
    del engine
    torch.cuda.empty_cache()
    gather_engine = _engine(params, cfg, False, dev)
    gathered = _first_decode_logits(gather_engine, prompts, first)
    del gather_engine
    torch.cuda.empty_cache()
    model = _dense_f32(params, cfg)
    with torch.no_grad():
        ref = torch.stack([model(torch.tensor([p + [f]], device=dev))[0, -1] for p, f in zip(prompts, first)])
    del model
    torch.cuda.empty_cache()
    res["logits_l2_rel_err_kernel_vs_f32"] = _l2_rel(paged, ref)
    res["logits_l2_rel_err_gather_vs_f32"] = _l2_rel(gathered, ref)
    res["logits_l2_rel_err_kernel_vs_gather"] = _l2_rel(paged, gathered)
    res["logits_max_abs_err_kernel_vs_f32"] = (paged - ref).abs().max().item()
    res["logits_max_abs_err_gather_vs_f32"] = (gathered - ref).abs().max().item()
    res["argmax_agree_kernel_vs_f32"] = int((paged.argmax(-1) == ref.argmax(-1)).sum())
    res["argmax_agree_gather_vs_f32"] = int((gathered.argmax(-1) == ref.argmax(-1)).sum())
    log("[main] first decode step: " + json.dumps({k: v for k, v in res.items() if "err" in k or "agree" in k}))
    for key in ("logits_l2_rel_err_kernel_vs_f32", "logits_l2_rel_err_gather_vs_f32"):
        if not res[key] <= LOGITS_L2_TOL:
            raise AssertionError(f"{key} = {res[key]} > {LOGITS_L2_TOL}")
    kernel_err, gather_err = res["logits_l2_rel_err_kernel_vs_f32"], res["logits_l2_rel_err_gather_vs_f32"]
    if not kernel_err <= KERNEL_VS_GATHER_SLACK * gather_err:
        raise AssertionError("the kernel path is further from the f32 reference than the gather path allows")
    return res


# ----------------------------------------------------------------- phase 5 --
# serving: the 8 prompts of PROMPT_LENS at once over HTTP, each for
# NEW_TOKENS tokens: six greedy JSON requests, one greedy SSE stream, and one
# prompt sampled at SERVE_TEMPERATURE, sent twice with SERVE_SEED and once
# with SERVE_SEED + 1 (the control that shows the seed decides the draw)
SERVE_SSE, SERVE_SAMPLED = 7, 0  # indices into PROMPT_LENS: the 1536- and 20-token prompts
SERVE_TEMPERATURE, SERVE_SEED = 0.8, 1234
# every served greedy token, teacher-forced through the dense f32 model: its
# logit lies within TF_SLACK x the bf16-vs-f32 logit error of the row's
# maximum. Argmax of the bf16 row, the served token's f32 logit trails the f32
# maximum by at most the two entries' errors, each at most the largest
# element error the main path measures (first decode step, kernel and gather
# paths against f32); TF_SLACK = 4 covers both entries with 2x margin for
# positions 32 tokens later. Control: the served tokens shifted by one
# position, which the check must reject.
TF_SLACK = 4.0
# KV pressure: a pool of this many 64-token blocks holds about half of the 8
# requests' 75 blocks, so the scheduler must offload and restore. The
# scheduler's choices depend on token counts alone: a tiny model on the CPU,
# stepped the same way, evicts 9 times at 40 blocks (and 114 at 32: the
# pool thrashes)
PRESSURE_BLOCKS = 40
PRESSURE_DECODE_CHUNK = 8


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def _http_generate(url, body, sse, out, key):
    """One client: POST /v1/generate; SSE events are read as they arrive,
    with the client's arrival clock for each."""
    import urllib.request
    req = urllib.request.Request(url + "/v1/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            if not sse:
                out[key] = dict(status=resp.status, doc=json.loads(resp.read()))
                return
            events, arrivals = [], []
            for line in resp:
                if line.startswith(b"data: "):
                    events.append(json.loads(line[len(b"data: "):]))
                    arrivals.append(time.perf_counter())
            out[key] = dict(status=resp.status, events=events, arrivals=arrivals)
    except Exception as e:  # reported by the checks below
        out[key] = dict(error=repr(e))


def _serve_bodies(prompts):
    """Request key -> (body, streamed) of the serving mix."""
    bodies = {}
    for i, p in enumerate(prompts):
        if i == SERVE_SAMPLED:
            for key, seed in (("sampled_a", SERVE_SEED), ("sampled_b", SERVE_SEED), ("sampled_c", SERVE_SEED + 1)):
                bodies[key] = (dict(prompt=p, max_new_tokens=NEW_TOKENS, temperature=SERVE_TEMPERATURE, seed=seed),
                               False)
        else:
            bodies[i] = (dict(prompt=p, max_new_tokens=NEW_TOKENS, stream=i == SERVE_SSE), i == SERVE_SSE)
    return bodies


def _direct_burst(sched, prompts, gate):
    """The same mix submitted to the scheduler in-process (no HTTP, no
    client threads); returns the burst's wall time."""
    t0 = time.perf_counter()
    reqs = [sched.submit(**{k: v for k, v in body.items() if k != "stream"})
            for body, _ in _serve_bodies(prompts).values()]
    gate(len(reqs))
    for r in reqs:
        r.result(timeout=600)
    return time.perf_counter() - t0


def _serve_burst(url, prompts, gate):
    """All requests at once from client threads, the sampled ones queued
    first; ``gate(n)`` waits until ``n`` are queued and, unless told to
    hold, lets the scheduler tick. Returns the results and the burst's wall
    time."""
    bodies = _serve_bodies(prompts)
    out = {}
    threads = {key: threading.Thread(target=_http_generate, args=(url, body, sse, out, key), daemon=True)
               for key, (body, sse) in bodies.items()}
    sampled = [k for k in bodies if str(k).startswith("sampled")]
    t0 = time.perf_counter()
    for k in sampled:
        threads[k].start()
    gate(len(sampled), release=False)
    for k, t in threads.items():
        if k not in sampled:
            t.start()
    gate(len(bodies))
    for t in threads.values():
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads.values()) or set(out) != set(bodies):
        raise AssertionError("a serving client did not finish")
    bad = {k: v for k, v in out.items() if v.get("status") != 200}
    if bad:
        raise AssertionError(f"serving requests failed: {bad}")
    return out, wall


def _served_tokens(out):
    """Request key -> the tokens of its final document."""
    return {k: (v["events"][-1]["tokens"] if "events" in v else v["doc"]["tokens"]) for k, v in out.items()}


def _sse_consistent(token_events, final):
    """The SSE check: the streamed token events, in index order, are the
    request's final (non-streamed) token list."""
    return ([e["index"] for e in token_events] == list(range(len(final)))
            and [e["token"] for e in token_events] == final)


def _teacher_forced(model, dev, sequences):
    """Each (prompt, tokens) through the dense f32 model in one forward over
    prompt + tokens[:-1]: per generated position, the gap between the row's
    maximum logit and the served token's."""
    gaps = []
    with torch.no_grad():
        for prompt, toks in sequences:
            ids = torch.tensor([list(prompt) + list(toks[:-1])], device=dev)
            rows = model(ids)[0, len(prompt) - 1:].float()
            served = rows[torch.arange(len(toks), device=dev), torch.tensor(toks, device=dev)]
            gaps.append((rows.max(-1).values - served).cpu())
    return torch.cat(gaps)


def _bits(t):
    return t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) else t.view(torch.int32)


def _offload_round_trip(engine, prompt, corrupt=False):
    """Prefill ``prompt`` as a live sequence, offload it to the host tier and
    restore it: True when its cache blocks come back bit for bit. With
    ``corrupt`` (the control) one element of the host copy is changed first."""
    sm = engine._state_manager
    uid = 10**6
    engine.put([uid], [prompt])
    seq = sm.get_sequence(uid)
    cache = sm.kv_cache.cache
    before = cache[:, :, torch.from_numpy(seq.kv_blocks).to(cache.device)].clone()
    engine.offload_sequence(uid)
    if corrupt:
        torch.cuda.synchronize()
        data, _ = sm.kv_cache.tiered_store.read(sm._offloaded[uid])
        flat = _bits(data).view(-1)
        flat[flat.numel() // 2] ^= 1
    engine._restore_offloaded([uid])
    after = cache[:, :, torch.from_numpy(seq.kv_blocks).to(cache.device)]
    same = bool(torch.equal(_bits(after), _bits(before)))
    engine.flush(uid)
    return same


def _count_calls(obj, name, record):
    inner = getattr(obj, name)

    def call(*args, **kw):
        record.append(args)
        return inner(*args, **kw)

    setattr(obj, name, call)


def run_serving_path(dev, params, main) -> dict:
    """Llama-2-7B served over HTTP through ServingScheduler + ServingServer on
    the main path's pool, from the main path's weights; the same prompts
    again under KV pressure, on a scheduler stepped by hand that must
    offload and restore. Checks each served greedy token against the dense
    f32 model, the SSE stream against its final document, the sampled runs
    against each other, B1's launches, the pool after stop, evictions, and
    one offload/restore round trip; each check with a control it rejects."""
    t_start = time.perf_counter()
    cfg = LlamaConfig.llama2_7b()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    failures = []

    # --- the measured burst: HTTP clients -> server threads -> scheduler
    engine = _engine(params, cfg, None, dev)
    capacity = engine.free_blocks
    generate(engine, [prompts[0], prompts[2]], max_new_tokens=4)  # warm-up, not counted
    times = {"put": [], "decode_loop": [], "tick": []}
    _timed(engine, "put", times["put"], _put_tokens)
    _timed(engine, "decode_loop", times["decode_loop"], _loop_steps)
    sched = ServingScheduler(engine, ServingConfig(queue_capacity=64))
    inner_step, inner_push = sched.step, sched._push_token
    pushes = {}  # request handle -> scheduler clock of each token pushed
    # a burst "at once" is one whose requests are all queued before the
    # scheduler's first tick, the sampled ones first: bf16 logits depend on
    # the batch a sequence rides in, so the two sampled runs of one seed
    # agree only when they share every batch, which needs them admitted and
    # prefilled in the same tick (arrival order alone can split them)
    ticking = threading.Event()

    def gate(n, release=True):
        deadline = time.perf_counter() + 120
        while sched.queue_depth < n:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{sched.queue_depth} of the burst's {n} requests arrived")
            time.sleep(0.0005)
        if release:
            ticking.set()

    def step():
        if not ticking.is_set():
            return False
        t0 = time.perf_counter()
        ran = inner_step()
        if ran:
            times["tick"].append(time.perf_counter() - t0)
        return ran

    def push(req, tok, record_itl=True):
        pushes.setdefault(req.handle, (req, []))[1].append(time.monotonic())
        return inner_push(req, tok, record_itl)

    sched.step, sched._push_token = step, push
    server = ServingServer(sched, host="127.0.0.1", port=0).start()
    threads = []
    spy_inner = transformer_base.paged_attention_update

    def spy(*args, **kw):
        threads.append(threading.current_thread().name)
        return spy_inner(*args, **kw)

    transformer_base.paged_attention_update = spy
    try:
        pa.paged_attention_update.launches = 0
        out, wall = _serve_burst(server.url, prompts, gate)
        ticking.clear()
        launches = pa.paged_attention_update.launches
        measured = {k: list(v) for k, v in times.items()}
        burst_pushes = {k: (r, list(ts)) for k, (r, ts) in pushes.items()}
        # the same mix again: submitted in-process (what HTTP costs), and
        # over HTTP under torch.profiler (the card's busy time)
        direct_wall = _direct_burst(sched, prompts, gate)
        ticking.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, profiled_wall = _serve_burst(server.url, prompts, gate)
    finally:
        transformer_base.paged_attention_update = spy_inner
        ticking.set()  # stop() drains through the loop
        server.stop()
    torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    times = measured
    served = _served_tokens(out)
    n_served = sum(len(t) for t in served.values())
    ttft = [ts[0] - req.arrival_s for req, ts in burst_pushes.values()]
    itl = [b - a for _, ts in burst_pushes.values() for a, b in zip(ts, ts[1:])]
    e2e = [v["doc"]["e2e_s"] for v in out.values() if "doc" in v]
    counters = sched.stats()["counters"]
    res = dict(requests=len(out), served_tokens=n_served, wall_s=wall, served_tokens_per_s=n_served / wall,
               ttft_p50_s=_percentile(ttft, 50), ttft_p99_s=_percentile(ttft, 99),
               itl_p50_s=_percentile(itl, 50), itl_p99_s=_percentile(itl, 99), e2e_p50_s=_percentile(e2e, 50),
               decode_chunks=len(times["decode_loop"]), puts=len(times["put"]), ticks=len(times["tick"]),
               tick_s=sum(times["tick"]), put_s=sum(s for s, _ in times["put"]),
               decode_loop_s=sum(s for s, _ in times["decode_loop"]), b1_launches=launches,
               b1_launch_threads=sorted(set(threads)), counters=counters,
               generate_decode_tokens_per_s=main["decode_tokens_per_s"], direct_submit_wall_s=direct_wall,
               profiled_wall_s=profiled_wall, device_busy_s=busy_us / 1e6 if busy_us else "not measured",
               device_share_of_measured_burst=busy_us / 1e6 / wall if busy_us else "not measured")
    res["scheduler_host_s"] = res["tick_s"] - res["put_s"] - res["decode_loop_s"]
    decode_ticks = [s for s, n in times["put"] if n <= 32]
    res["decode_put_ms_p50"] = 1e3 * _percentile(decode_ticks, 50) if decode_ticks else None
    del engine.put, engine.decode_loop

    # --- checks of the burst, each with its control
    sse = out[SERVE_SSE]
    token_events, final = sse["events"][:-1], sse["events"][-1]["tokens"]
    if not (sse["events"][-1].get("done") and _sse_consistent(token_events, final)):
        failures.append("the SSE token events differ from the request's final tokens")
    if _sse_consistent(token_events[:-1] + [dict(token_events[-1], token=(final[-1] + 1) % cfg.vocab_size)],
                       final):
        failures.append("control: a changed SSE token passed the SSE check")
    if served["sampled_a"] != served["sampled_b"]:
        failures.append("the two sampled runs with one seed differ")
    if served["sampled_a"] == served["sampled_c"]:
        failures.append("control: the sampled run with another seed passed the equality check")
    if not launches > 0:
        failures.append("B1 was not launched during the serving burst")
    if set(threads) != {"dstpu-serving-scheduler"}:
        failures.append(f"B1 was launched from threads {sorted(set(threads))}, not the scheduler's")
    counters_left = [int(c.abs().sum()) for c, _ in pa._WORKSPACES.values()]
    if any(counters_left):
        failures.append(f"B1's split counters are not zero after the burst: {counters_left}")
    if engine.free_blocks != capacity:
        failures.append(f"{capacity - engine.free_blocks} KV blocks still held after server.stop()")
    engine.put([10**6], [prompts[0]])  # control: a sequence still holds its blocks
    if engine.free_blocks == capacity:
        failures.append("control: a held sequence passed the pool check")
    engine.flush(10**6)
    gather = _engine(params, cfg, False, dev)  # control: a path without B1 launches none
    pa.paged_attention_update.launches = 0
    generate(gather, [prompts[0]], max_new_tokens=2)
    if pa.paged_attention_update.launches > 0:
        failures.append("control: the gather-only engine launched B1")
    del gather, engine, sched, server
    gc.collect()
    torch.cuda.empty_cache()

    # --- KV pressure: the same prompts on a pool of PRESSURE_BLOCKS blocks,
    # the scheduler stepped by hand as generate steps it (so its choices do
    # not depend on when the submits land)
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT,
                               memory_config=MemoryConfig(mode="allocate", size=PRESSURE_BLOCKS))
    small = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK),
                         device=dev)
    restores, loops = [], []
    _count_calls(small._state_manager, "restore_sequence", restores)
    _count_calls(small, "decode_loop", loops)
    pressured = ServingScheduler(small, ServingConfig(decode_chunk=PRESSURE_DECODE_CHUNK), start=False)
    pa.paged_attention_update.launches = 0
    try:
        t0 = time.perf_counter()
        reqs = [pressured.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        while not all(r.finished for r in reqs):
            pressured.step()
        torch.cuda.synchronize()
        pressure_wall = time.perf_counter() - t0
        pressure_tokens = [r.result(timeout=1) for r in reqs]
        pressure_counters = pressured.stats()["counters"]
    finally:
        pressured.stop(drain=False)
    res["pressure"] = dict(blocks=PRESSURE_BLOCKS, wall_s=pressure_wall, evictions=pressure_counters["evictions"],
                           restores=len(restores), decode_chunks=len(loops),
                           b1_launches=pa.paged_attention_update.launches, counters=pressure_counters)
    if not pressure_counters["evictions"] > 0:
        failures.append("the small pool evicted nothing")
    if not counters["evictions"] == 0:  # control: the main path's pool needs no eviction
        failures.append("control: the full pool evicted too")
    if small.free_blocks != PRESSURE_BLOCKS:
        failures.append("KV blocks still held after the pressured run")
    res["pressure"]["offload_round_trip_bit_exact"] = _offload_round_trip(small, prompts[3])
    if not res["pressure"]["offload_round_trip_bit_exact"]:
        failures.append("offload -> restore did not give back the cache bit for bit")
    if _offload_round_trip(small, prompts[3], corrupt=True):
        failures.append("control: a corrupted host copy passed the round-trip check")
    del small, pressured
    gc.collect()
    torch.cuda.empty_cache()

    # --- every served greedy token against the dense f32 model
    err = max(main["logits_max_abs_err_kernel_vs_f32"], main["logits_max_abs_err_gather_vs_f32"])
    tol = TF_SLACK * err
    greedy = [(prompts[k], served[k]) for k in range(len(prompts)) if k != SERVE_SAMPLED]
    greedy += list(zip(prompts, pressure_tokens))
    model = _dense_f32(params, cfg)
    gaps = _teacher_forced(model, dev, greedy)
    shifted = _teacher_forced(model, dev, [(p, t[1:] + t[:1]) for p, t in greedy])
    del model
    torch.cuda.empty_cache()
    res["teacher_forced"] = dict(tolerance=tol, max_abs_err_main=err, tokens=int(gaps.numel()),
                                 max_gap=gaps.max().item(), max_gap_over_tol=gaps.max().item() / tol,
                                 control_tokens_outside=int((shifted > tol).sum()),
                                 control_max_gap=shifted.max().item())
    if not gaps.max().item() <= tol:
        failures.append(f"a served token's f32 logit trails its row's maximum by {gaps.max().item()} > {tol}")
    if not shifted.max().item() > tol:
        failures.append("control: the shifted tokens passed the teacher-forced check")
    res["seconds"] = time.perf_counter() - t_start
    res["failures"] = failures
    log("[serve] " + json.dumps({k: v for k, v in res.items() if k not in ("counters", )}))
    log(f"[serve] TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms p99 {res['ttft_p99_s'] * 1e3:.1f} ms, "
        f"ITL p50 {res['itl_p50_s'] * 1e3:.2f} ms p99 {res['itl_p99_s'] * 1e3:.2f} ms, "
        f"e2e p50 {res['e2e_p50_s']:.3f} s, served {res['served_tokens_per_s']:.1f} tokens/s "
        f"(generate's direct decode: {res['generate_decode_tokens_per_s']:.1f} tokens/s)")
    log(f"[serve] decode chunks {res['decode_chunks']}, B1 launches {launches}; under pressure: "
        f"{res['pressure']['evictions']} evictions, {res['pressure']['restores']} restores, "
        f"{res['pressure']['decode_chunks']} decode chunks, {res['pressure']['b1_launches']} B1 launches")
    log(card_line())
    if failures:
        raise AssertionError("serving phase: " + "; ".join(failures))
    return res


# ----------------------------------------------------------------- phase 6 --
def bench_llama(**kw) -> LlamaConfig:
    """bench.py's headline model: the 530M Llama (``_llama_530m``) with
    remat "dots" and flash attention."""
    base = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5376, num_hidden_layers=8,
                num_attention_heads=16, num_key_value_heads=16, max_position_embeddings=TRAIN_S, remat=True,
                remat_policy="dots", use_flash_attention=True, dtype=torch.bfloat16)
    base.update(kw)
    return LlamaConfig(**base)


def _train_engine(cfg, micro, gas, bf16, dev):
    """initialize() on the bench config: weights drawn on the card from seed
    0, AdamW, ZeRO stage 3, bf16 over f32 masters (or f32 throughout)."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    config = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
              "optimizer": {"type": "AdamW", "params": {"lr": TRAIN_LR}}, "zero_optimization": {"stage": 3},
              "bf16": {"enabled": bf16}}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev)
    return engine


def _flash_launches():
    return {"fwd": fa.flash_attention_fwd.launches, "dkv": fa.flash_attention_bwd_dkv.launches,
            "dq": fa.flash_attention_bwd_dq.launches}


def _profile_train_batch(engine, batch):
    """One train_batch under torch.profiler: the card's busy share of the
    host wall time and the device time of the top items."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    flash_us = {kern: sum(e.self_device_time_total for e in device if f"flash_{kern}_kernel" in e.key)
                for kern in ("fwd", "bwd_dkv", "bwd_dq")}
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:12]
    return dict(wall_ms=1e3 * wall, device_ms=busy_us / 1e3,
                device_busy_share=busy_us / 1e6 / wall if busy_us else "not measured",
                flash_kernels_ms={k: v / 1e3 for k, v in flash_us.items()},
                top_items=[dict(name=e.key[:100], calls=e.count, ms=e.self_device_time_total / 1e3) for e in top])


def run_training_path(dev) -> dict:
    cfg = bench_llama()
    S, micro, gas, L = TRAIN_S, TRAIN_MICRO, TRAIN_GAS, cfg.num_hidden_layers
    t0 = time.perf_counter()
    engine = _train_engine(cfg, micro, gas, True, dev)
    n_params = sum(p.numel() for p in engine.params.values())
    torch.cuda.synchronize()
    log(f"[train] bench Llama: {n_params} parameters ({L} layers), engine ready in {time.perf_counter() - t0:.1f} s")
    # bench.py's batches: np.random.default_rng(0), 8 global batches of
    # [micro * gas, S] tokens, made up front and put on the card
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(8):
        ids = rng.integers(0, cfg.vocab_size, size=(micro * gas, S + 1), dtype=np.int64)
        batches.append(tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], ids[:, 1:])))

    for i in range(TRAIN_WARMUP):
        engine.train_batch(batch=batches[i % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the measured steps: kernel launch counts zeroed just before, read just after
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd_dkv.launches = fa.flash_attention_bwd_dq.launches = 0
    times, losses = [], []
    for i in range(TRAIN_MEASURED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batches[(TRAIN_WARMUP + i) % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = _flash_launches()
    # per train_batch: each of gas micro-batches runs L attention forwards,
    # L more in the remat recompute ("dots" saves only the projections), and
    # L backwards of two launches
    expected = {"fwd": TRAIN_MEASURED * gas * 2 * L, "dkv": TRAIN_MEASURED * gas * L,
                "dq": TRAIN_MEASURED * gas * L}
    if launches != expected:
        raise AssertionError(f"flash kernel launches {launches} != predicted {expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    step_s = statistics.median(times)
    tokens_per_s = micro * gas * S / step_s
    # bench.py:216 (PaLM appendix): 6 (N - N_embed) + 12 L S hidden per token
    flops_per_token = 6.0 * (n_params - cfg.vocab_size * cfg.hidden_size) + 12.0 * L * S * cfg.hidden_size
    res = dict(layers=L, hidden=cfg.hidden_size, params=n_params, seq_len=S, micro_batch=micro, gas=gas,
               step_ms=[1e3 * t for t in times], ms_per_train_batch=1e3 * step_s, tokens_per_s=tokens_per_s,
               mfu=tokens_per_s * flops_per_token / BF16_FLOPS, flops_per_token=flops_per_token, losses=losses,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=launches,
               expected_flash_launches=expected, grad_norm=engine.get_global_grad_norm())
    log("[train] " + json.dumps(res))

    res["profile"] = _profile_train_batch(engine, batches[0])
    res["profile"]["device_share_of_measured_step"] = res["profile"]["device_ms"] / res["ms_per_train_batch"]
    log("[train] profile: " + json.dumps(res["profile"]))
    if not all(ms > 0 for ms in res["profile"]["flash_kernels_ms"].values()):
        raise AssertionError(f"the profile finds no time for a flash kernel by name: {res['profile']['flash_kernels_ms']}")

    # the same global batch again and again: the loss must fall
    res["repeated_batch_losses"] = rep = [float(engine.train_batch(batch=batches[1])) for _ in range(TRAIN_REPEAT)]
    log(f"[train] repeated batch losses: {rep}")
    if not rep[-1] < rep[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: {rep}")
    del engine
    torch.cuda.empty_cache()

    res["first_step"] = check_first_step(dev, tuple(x[:micro] for x in batches[0]))
    return res


def check_first_step(dev, one) -> dict:
    """One step of one micro-batch: kernels and plain attention in bf16, and
    plain attention in f32 (the kernels take bf16 and fp16 only); then the
    controls, which the checks must reject."""
    readings, grads = {}, {}
    for name, flash, bf16, patch in (("kernel_bf16", True, True, None), ("plain_bf16", False, True, None),
                                     ("plain_f32", False, False, None), *CONTROLS):
        with _patched(*patch) if patch else contextlib.nullcontext():
            readings[name], grads[name] = _first_step(bench_llama(use_flash_attention=flash), bf16, dev, one)
    ref = grads.pop("plain_f32")
    for name, g in grads.items():
        readings[name]["attn_grad_l2_rel_err"] = {p: (g[p] - ref[p]).norm().item() / ref[p].norm().item()
                                                  for p in ATTN_PROJ}
        readings[name]["loss_rel_err"] = _rel(readings[name]["loss"], readings["plain_f32"]["loss"])
        readings[name]["grad_norm_rel_err"] = _rel(readings[name]["grad_norm"], readings["plain_f32"]["grad_norm"])
        readings[name]["fails"] = _first_step_failures(readings[name])
    del grads, ref
    readings["kernel_bf16_vs_plain_bf16"] = {
        "loss_rel_err": _rel(readings["kernel_bf16"]["loss"], readings["plain_bf16"]["loss"]),
        "grad_norm_rel_err": _rel(readings["kernel_bf16"]["grad_norm"], readings["plain_bf16"]["grad_norm"])}
    log("[train] first step: " + json.dumps(readings))
    for name in ("kernel_bf16", "plain_bf16"):
        if readings[name]["fails"]:
            raise AssertionError(f"{name} against f32 fails {readings[name]['fails']}: {readings[name]}")
    for name, *_ in CONTROLS:
        if not readings[name]["fails"]:
            raise AssertionError(f"the first-step checks pass the control {name}: {readings[name]}")
    return readings


def _rel(a, b):
    return abs(a - b) / abs(b)


def _first_step(cfg, bf16, dev, batch):
    """One optimizer step of one micro-batch through the micro-step API: the
    loss, the global gradient norm, and each attention projection's weight
    gradient over all layers (f32, flattened)."""
    engine = _train_engine(cfg, TRAIN_MICRO, 1, bf16, dev)
    loss = engine.forward(batch).item()
    engine.backward()
    grads = {p: torch.cat([engine.acc_grads[f"layers.{i}.self_attn.{p}.weight"].float().flatten()
                           for i in range(cfg.num_hidden_layers)]) for p in ATTN_PROJ}
    engine.step()
    reading = dict(loss=loss, grad_norm=engine.get_global_grad_norm())
    del engine
    torch.cuda.empty_cache()
    return reading, grads


def _first_step_failures(r):
    """The first-step checks that reading ``r`` (against f32) fails."""
    fails = [p for p in ATTN_PROJ if not r["attn_grad_l2_rel_err"][p] <= ATTN_GRAD_L2_TOL]
    if not r["loss_rel_err"] <= LOSS_REL_TOL:
        fails.append("loss")
    if not r["grad_norm_rel_err"] <= GRAD_NORM_REL_TOL:
        fails.append("grad_norm")
    return fails


@contextlib.contextmanager
def _patched(name, fn, module=fa):
    """Replace one function of an ops module (ops/flash_attention.py unless
    another is given) for a control."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def _identity_fwd(q, k, v, scale, causal):
    _, lse = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    return v.repeat_interleave(q.shape[2] // v.shape[2], dim=2).contiguous(), lse


# (name, flash, bf16, (wrapper, replacement)): the kernel step with one fault
CONTROLS = (
    ("control_dq_zeroed", True, True, ("flash_attention_bwd_dq", lambda q, *a: torch.zeros_like(q))),
    ("control_dkv_zeroed", True, True, ("flash_attention_bwd_dkv", lambda q, k, v, *a: (torch.zeros_like(k),
                                                                                          torch.zeros_like(v)))),
    ("control_attention_identity", True, True, ("flash_attention_fwd", _identity_fwd)),
)


# --------------------------------------------------------------------- main --
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    card = card_line()
    log(card)
    record = {"card": card, "device": torch.cuda.get_device_name(0)}
    record["build"] = build_kernels()
    record["paged_attention"] = check_paged_attention(dev)
    record["flash_attention"] = check_flash_attention(dev)
    record["block_sparse_attention"] = check_block_sparse_attention(dev)
    params = main_params(dev)
    record["main_path"] = run_main_path(dev, params)
    record["serving_path"] = run_serving_path(dev, params, record["main_path"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    record["training_path"] = run_training_path(dev)
    record["seconds"] = time.perf_counter() - t_start

    decode = record["paged_attention"][0]  # the serving path's decode shape
    kernels = [dict(name="paged_attention_update", route="cuda", design=PAGED_DESIGN,
                    source="deepspeed_tpu_torch/csrc/paged_attention.cu",
                    replaces="deepspeed_tpu/ops/pallas/paged_attention.py:37",
                    launches=record["main_path"]["paged_attention_launches"],
                    max_abs_err=max(r["max_abs_err"] for r in record["paged_attention"]),
                    ms=decode["ms"], plain_ms=decode["plain_ms"], bound_ms=decode["bound_ms"],
                    bound_by=decode["bound_by"], library_ms=decode["library_ms"],
                    cases=record["paged_attention"])]
    train = record["flash_attention"][0]  # the training path's shape
    for kern, fn, line, outputs in (("fwd", "flash_attention_fwd", 43, ("out", "lse")),
                                    ("dkv", "flash_attention_bwd_dkv", 253, ("dk", "dv")),
                                    ("dq", "flash_attention_bwd_dq", 299, ("dq", ))):
        kernels.append(dict(name=fn, route="cuda", design=FLASH_DESIGN[kern],
                            source="deepspeed_tpu_torch/csrc/flash_attention.cu",
                            replaces=f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}",
                            launches=record["training_path"]["flash_launches"][kern],
                            max_abs_err=max(r["max_abs_err"][o] for r in record["flash_attention"] for o in outputs),
                            ms=train[kern]["ms"], plain_ms=train[kern]["plain_ms"],
                            bound_ms=train[kern]["bound_ms"], bound_by=train[kern]["bound_by"],
                            library_ms=train[kern]["library_ms"],
                            cases=[dict(case=r["case"], **r[kern]) for r in record["flash_attention"]]))
    sparse = record["block_sparse_attention"]
    low = sparse["cases"][0]  # bench.py's low-density layout
    kernels.append(dict(name="block_sparse_attention_fwd", route="cuda", design=BSA_DESIGN,
                        source="deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
                        replaces="deepspeed_tpu/ops/pallas/block_sparse_attention.py:83",
                        launches=sparse["path"]["launches"],
                        max_abs_err=max(r["max_abs_err"] for r in sparse["cases"]), ms=low["ms"],
                        plain_ms=low["plain_ms"], bound_ms=low["bound_ms"], bound_by=low["bound_by"],
                        library_ms=low["library_ms"], cases=sparse["cases"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[done] {record['seconds']:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
