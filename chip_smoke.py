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
6. prefix path: from the same weights, with the prefix cache on, a
   1,024-token system prompt and 8 user turns of 8-24 tokens over HTTP on a
   hand-stepped scheduler: request 0 cold, the other 7 arriving one a tick
   (each hot suffix rides one put of at most 32 tokens through B1 with the
   running decodes), the 7 again at once, a prompt that differs at token 0,
   the bare prefix (a copy-on-write fork), two follow-up turns, and the 7
   under torch.profiler; hits and saved tokens held exactly to a host mirror
   of the trie, the shared blocks' bytes unchanged, the pool whole after
   stop; a 256-token request handed off from one engine to a second (same
   weights, its own pool) as a raw frame claimed once over HTTP, equal bit
   for bit to the request served whole, a parked request rehydrated with 16
   more prompt tokens; the serving phase's pressure mix with the tier
   ladder spilling to disk (every restore bit-exact) and a sequence through
   offload_path and the native AIO engine; every served greedy token
   teacher-forced, each check with a control it must reject;
7. speculative path: from the same weights, 8 prompts with repeated n-grams
   (random patterns tiled to 20-1536 tokens): the engine's greedy verify feeds
   of 1-4 drafts from the spec-off continuation, a rejected feed rolled back,
   finite garbage in every slot past the committed count (the next verify and
   decode logits bitwise unchanged through B1 and the gather branch), trees
   on a short context (a chain, two branches, compaction of an accepted
   branch) held to the dense f32 model and to linear verify, and one
   full-width verify_tree (8 trees of 8 nodes: its time and peak memory);
   the 8 prompts served over HTTP with speculation off, with prompt lookup
   at a 24-token draft budget (every verify through B1) and at the default
   budget, and hand-stepped with an oracle drafter (acceptance over 0.9,
   verify dispatches at most half of spec-off's decode dispatches); the
   learned drafter and auto (one fresh head at Llama-2-7B width: host ms a
   draft); sampled decode_loop (seeded draws, each draw's f32 probability
   above a floor, temperature 1e-6 inside the argmax set, a chi-square test
   of the sampler); a handoff whose frame carries the drafter state into a
   second engine; every served greedy token teacher-forced, each check with
   a control it must reject;
8. observe path: from the same weights, the per-layer tracer, the cost
   plane and the SLO engine. The 8 main-path requests through an untraced
   engine and a traced one (trace_enabled, CUDA events resolved once a
   forward): prefill puts (the gather branch), 8 decode puts of 8 tokens
   (B1, 64 launches each) and 3 more under torch.profiler, the last with its
   end events recorded at phase entry (the control); every decode put's
   summary has every phase timed, the phases of a profiled put sum to
   between the profiler's device time and the synchronized host wall, the
   Chrome trace holds 2 x 32 + 2 phase spans a put with its uids, ordered
   and apart, the greedy tokens are the untraced ones, and an untraced put
   creates no CUDA event and waits on nothing; a 768-token prefill put's
   observed dispatch seconds against its profiled device time (control: the
   end time taken before the wait). Then a telemetry session with the cost
   plane: 6 tiled-pattern prompts twice over HTTP (prefix hits, prompt
   lookup) billed to three tenants (header, JSON field, none), /v1/usage
   conserved (control: a charge dropped), each final document's cost folded
   into its tenant, billed plus amnesty seconds equal to the observed ones,
   the /v1/stats perf block on the H100 row with each first sight amnestied;
   and an SLO burst: an ITL objective of 1 ms breaches and slo_pressure lifts
   the brownout stage (control: a 10 s objective does not);
9. fleet path: from the same weights, replicas that share them on the card
   (each its own pool and scheduler thread) behind the FleetRouter over
   HTTP. (a) One prefill and two decode replicas serve the 8 prompts at once
   over SSE: prefill and first token on the prefill replica, the KV frame
   (524,288 bytes a token slot) handed to a decode replica; TTFT, ITL,
   served tokens/s, export/import GB/s and the router's host ms a request,
   B1's launches counted per engine (decode puts only on the decode
   replicas). (f) One request traced: the router's span and both replicas'
   request spans in one trace. (b) decode-0 is killed after 4 streamed decode
   tokens: the buffered frame resumes on decode-1, the client sees 32 tokens
   once each, decode-0's breaker opens. (c) Work stealing between two mixed
   replicas, one held: a queued request re-granted, a decoding one exported
   mid-stream, counters exact. (d) A turn pinned to a replica without the
   1,024-token prefix imports its 16 blocks from the peer that has them; a
   frame corrupted in transit is refused and the turn served cold. (e)
   `python -m deepspeed_tpu_torch.bin.dstpu_replica` (the entry point's own
   tiny model) supervised as a process on the card: ready, a routed
   request, SIGKILL, restart, a second request, both the tokens of an
   in-process engine from the same seed. Every served greedy token
   teacher-forced; each leg with a control that must fail;
10. breadth path (run_breadth_path): the decoder family and weights from
   disk. (a) Falcon-7B's published widths (71 query heads over one KV head
   of 64, hidden 4544, vocab 65024) at 8 of its 32 layers and (b) Phi-2's
   (32 heads of 80, rotary on 40% of each head) at 8 of 32, random bf16
   weights from seed 0, the main path's 8 requests through build_engine +
   generate, B1's launches against their prediction, the first decode
   step's logits and every served token held to the dense model in f32
   (control: the tokens shifted by one). (c) The main path's model
   quantized at build time to int8, then int4: the at-rest bytes against
   bf16's, the peak memory in generate, a decode step and the dequantize's
   share of it; the logits and tokens held to a bf16 engine on the same
   dequantized weights (control: int8 against the int4 weights). (d)
   Llama-2-7B's widths at 2 layers written as an HF directory by the
   port's safetensors writer: build_hf_engine, serialize ->
   build_engine_from_ds_checkpoint (int8 too, loaded back quantized), each
   bitwise build_engine's logits (control: int8 against bf16), and
   `python -m deepspeed_tpu_torch.bin.dstpu_replica --checkpoint` serving
   an in-process engine's tokens over HTTP;
11. MoE path (run_moe_path): Mixtral-8x7B's widths at 8 of its 32 layers
   (random bf16 weights from seed 0). (a) 8 requests of 125-850 prompt
   tokens through build_engine + generate on one rank, 32 greedy new tokens
   at capacity factor 4.0 (no assignment dropped), B1's launch count zeroed
   just before and read just after; rates, each layer's expert counts, one
   traced decode put (attn against moe_ffn); the first decode step's logits
   and every served token held to Mixtral's function in f32 (no capacity;
   the bf16 weights upcast a layer at a time), each check with a control it
   must reject (experts 0 and 1 swapped; the tokens shifted by one). (b) The
   same prompts under simulated gating at temperature 0.5: each layer's
   first choices over the decoded tokens within 4 sigma of
   simulated_expert_probs (control: the next layer's distribution). (c)
   Expert parallelism over two ranks of this script (--moe-rank-child, gloo
   on the one card, each rank holding half the experts), started before (a)
   so their imports overlap it: the requests split across them, no drop,
   each request's tokens against (a)'s or teacher-forced, the all-to-all
   bytes exactly the count from C, E, M and the layers, the rank done first
   running empty forwards, and the control (rank 1's experts swapped) failing
   the teacher-forced check. (d) MixtralForCausalLM at 1 layer (cut: depth; 2
   ran out of memory in the out-of-place AdamW) through
   initialize + train_batch at ZeRO 3, B 1, S 1024, three steps: the first
   step's loss and gradient norm against the same step in f32;
12. training path: train bench.py's headline program (the 530M Llama, full
   width and depth, S=1024, micro-batch 8, GAS 8, AdamW, bf16 over f32
   masters, ZeRO stage 3, remat "dots", flash attention) through
   deepspeed_tpu_torch.initialize + train_batch, with the flash kernels'
   launch counts zeroed just before the measured steps and read just after;
   trace one train_batch with torch.profiler; check the loss falls on a
   repeated batch; hold one step's loss, gradient norm and attention
   projections' gradients, through the kernels and through plain attention
   in bf16, to the same step in f32, and show that the check rejects the
   kernel step with dq, or dk and dv, zeroed or with attention replaced;
13. checkpoint path: on the same model cut to 2 layers (cut: depth, so the
   whole script stays inside its time) and the same batches, a save into
   tempfile.mkdtemp() and a resume in a fresh engine, its losses and f32
   masters bitwise those of the run that never stopped (the flash kernels'
   launch counts zeroed just before the resumed steps and read just after);
   an async save (nebula) committing beside two steps; two NaN steps from
   DSTPU_TRAIN_FAULTS under the anomaly sentinel, the first skipped bitwise,
   the second rolling back to the async tag; SIGTERM turned into a final
   checkpoint, PREEMPTED.json and TrainingPreempted, and a fresh engine
   resuming from it bitwise; the newest tag corrupted: a tag=None load falls
   back (counted), an explicit one raises, and an unverified load of it (the
   control) differs from the saved state; a tag without its manifest reads
   torn. Then every optimizer but AdamW on the model cut to 2 layers (3
   steps on one batch: finite, falling) and its f32 updates of a tiny
   config's tree on the card against the CPU's; save, load and CRC times;
14. train features path: on the same model, curriculum learning (each
   step's sequence length the scheduler's, B2-B4 launched as predicted at
   each length; the control at full length from the first step, with
   progressive layer drop's θ held to its formula), an MMapIndexedDataset
   indexed by DataAnalyzer feeding DeepSpeedDataSampler's batches (every row
   within its step's difficulty), PrefetchingLoader against train_batch on
   the same batches (losses bitwise, the same launches, both step times),
   training telemetry against none (events, gauges, spans, the cost a
   step), compression training (each transform within 1 ulp of the same
   transform on the CPU, none before its offset), the curvature probe
   raising through B2-B4 (C8), and on the model cut to 2 layers in f32 with
   plain attention: the probe converged, its Hessian-vector product against
   central differences (a product 10% off and one along another direction,
   the controls, fail), the eigenvalue gate below and above the probed value;
15. zero path (run_zero_path): ZeRO across ranks, NCCL at world 1 and two
   ranks sharing the card over gloo at stages 1-3, and dstpu_train with a
   killed rank;
16. zero+ path (run_zero_plus_path): the optimizer offloaded to pinned host
   memory beside the same steps on the card; NVMe offload into a directory
   under TMPDIR, bitwise CPU offload's; qwZ and qgZ over two gloo ranks held
   to their exact runs (losses, the first reduced gradients, masters, the
   bytes a rank sends), hpZ and MiCS over four held to world 1 and the
   placement rule; the pipeline engine over two stages, bitwise one rank;
17. parallel path (run_parallel_path): two ranks of this script over gloo,
   started once, run four legs: Llama-2-7B's widths at 8 layers served at TP
   2 (the main path's 8 requests, rank 0 scheduling and rank 1 following; B1
   at 16 heads a rank; every token teacher-forced through f32; the
   all-reduce bytes counted), the 530M model cut to 2 layers trained at TP
   2 and with Ulysses at sp 2 (S 2048, labels masked in one rank's half),
   each held to a world-1 run, and Mixtral-8x7B's widths at 1 layer trained
   with its experts over 2 ranks (capacity binding; the global gate, each
   token's first loss and picked entries of the expert banks' gradients held
   to a world-1 f32 step along the same routes, as is the first loss; the
   experts' outputs swapped between the ranks must fail the last three); each
   check with a control;
18. composed path (run_composed_path): four ranks of this script over gloo,
   started once, run three legs: Mixtral-8x7B's widths at 2 layers served at
   TP 2 x EP 2 (B1 at 16 heads over 4 KV heads; tokens against a one-rank
   engine's or teacher-forced through f32 along the served routes; the
   all-to-all and row all-reduce bytes counted; flipped banks on one expert
   rank, the control), Llama-2-7B's widths at 2 layers trained at TP 2 x SP
   2 (held to a world-1 run; RoPE at local positions, the control) whose
   tag, every array whole, a world-1 engine loads bitwise and steps on, and
   Mixtral's widths at 1 layer trained at SP 2 x EP 2 and ZeRO 3 (the global
   gate's drops against a world-1 f32 step along the same routes, a gate of
   each rank's own tokens the control; a quarter of each bank a rank);
19. print one JSON line describing every kernel, then the result line.

The main path and the serving, prefix, speculative, observe and fleet
phases run Llama-2-7B's widths at 16 of its 32 layers (SERVE_LAYERS), and
the features and MoE phases 4 layers: depth cuts that keep the whole script
inside the card's time.

The script imports the port only (never jax or deepspeed_tpu), needs one
GPU, and writes its full record to chiprun_out/chip_smoke.json.
"""

import contextlib
import copy
import fnmatch
import gc
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

import deepspeed_tpu_torch
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.compression.compress import init_compression
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.checkpoint import save_hf_checkpoint
from deepspeed_tpu_torch.inference.v2.config_v2 import QuantizationConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import (build_engine, build_engine_from_ds_checkpoint,
                                                             build_hf_engine, generate)
from deepspeed_tpu_torch.inference.v2.quantization import (dequantize_tree, is_quantized_leaf, quantize_tree,
                                                           tree_nbytes)
from deepspeed_tpu_torch.inference.v2.model_implementations import transformer_base
from deepspeed_tpu_torch.inference.v2.ragged.handoff import CONTENT_TYPE as HANDOFF_CONTENT_TYPE
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, MemoryConfig
from deepspeed_tpu_torch.inference.v2.model_implementations.transformer_base import sample_categorical
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import digest_chain
from deepspeed_tpu_torch.inference.v2.spec import TokenTree
from deepspeed_tpu_torch.models.convert import reference_names
from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderModel
from deepspeed_tpu_torch.models.decoder import init_params as decoder_init_params
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, apply_rotary,
                                              causal_attention, init_params, param_shapes, rms_norm, rotary_embedding)
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from deepspeed_tpu_torch.models.mixtral import init_params as mixtral_init_params
from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.inference.v2.config_v2 import DeepSpeedEPConfig
from deepspeed_tpu_torch.inference.v2.modules.moe import RaggedMoE, disable_simulated_gating, simulated_expert_probs
from deepspeed_tpu_torch.inference.v2.tracer import RECORD_NAMES
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import builder
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops.aio import aio_available
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_update, paged_attention_update_plain
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import recompute_disabled
from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as ckpt
from deepspeed_tpu_torch.runtime.data_pipeline import CurriculumScheduler, DeepSpeedDataSampler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import (DataAnalyzer, MMapIndexedDataset,
                                                                      MMapIndexedDatasetBuilder)
from deepspeed_tpu_torch.runtime.dataloader import PrefetchingLoader, StagedBatch
from deepspeed_tpu_torch.runtime.eigenvalue import block_hvp
from deepspeed_tpu_torch.runtime.engine import TrainingPreempted, _make_optimizer
from deepspeed_tpu_torch.runtime.faults import TrainFaultConfig, TrainFaultInjector
from deepspeed_tpu_torch.utils.timer import TRAIN_BATCH_TIMER
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig, FixedSparsityConfig, SparseSelfAttention,
                                                      layout_to_dense_mask)
from deepspeed_tpu_torch.bin import dstpu_replica
from deepspeed_tpu_torch.fleet import (FaultConfig, FleetConfig, FleetRouter, ReplicaManager, ReplicaSupervisor,
                                       SupervisorConfig)
from deepspeed_tpu_torch.fleet import router as fleet_router
from deepspeed_tpu_torch.serving import (KVTierConfig, PrefixCacheConfig, ServingConfig, ServingScheduler,
                                         ServingServer, SpeculativeConfig)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PROMPT_LENS = (20, 64, 128, 256, 512, 768, 1024, 1536)
NEW_TOKENS = 32
REPEATS = 3  # generate runs in the measured main path (medians reported)
PROFILE_STEPS = 8  # decode steps traced by torch.profiler after the measured runs
BLOCK = 64
MAX_CONTEXT = 4096
KV_BYTES = 8 * 2**30  # per engine
# the serving phases' model (the main path, serving, prefix, spec, observe and
# fleet phases share its weights): Llama-2-7B's widths at a cut depth (cut:
# depth, from 32 layers, for the card's time with the composed phase)
SERVE_LAYERS = 16


def serve_config() -> LlamaConfig:
    return LlamaConfig.llama2_7b(num_hidden_layers=SERVE_LAYERS)
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
    ("tp2_train", 8, 1024, 8, 8, True, 128),  # the parallel phase's TP leg: 8 of 16 heads a rank
    ("ulysses_sp2", 4, 2048, 8, 8, True, 128),  # its Ulysses leg: the whole sequence at 8 of 16 heads
    ("tp2_sp2_train", 4, 2048, 8, 8, True, 128),  # the composed phase's leg f: 8 of Llama-2-7B's 32 heads a rank
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
def _paged_case(name, H, KVH, bs, seqs, gen, cpu_gen, D=128):
    """Inputs of one paged-attention call, at layer 1 of a two-layer cache
    with head_dim ``D``. ``seqs`` lists, per sequence, the positions of its
    tokens (empty: a padding row). Tables hold distinct random blocks up to
    each sequence's last position, then -1."""
    layers, layer_idx = 2, 1
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
        # the MoE phase's first decode step: Mixtral's 32 heads over 8 KV
        # heads, 64-token blocks, one token at each of its prompts' ends
        _paged_case("mixtral_decode", 32, 8, BLOCK, [[n] for n in MOE_PROMPT_LENS], gen, cpu_gen),
        # decode near the end of the 4096-position context: a bound of about
        # 0.16 ms of bytes, so the kernel's share of the bandwidth reads
        _paged_case("llama2_7b_decode_long", 32, 32, BLOCK, [[3960 + 5 * i] for i in range(8)], gen, cpu_gen),
        # the parallel phase's TP 2 decode step: one rank's 16 of 32 heads
        _paged_case("llama2_7b_tp2_decode", 16, 16, BLOCK, [[n] for n in PROMPT_LENS], gen, cpu_gen),
        # the composed phase's TP 2 x EP 2 decode step: a Mixtral rank's 16
        # of 32 heads over 4 of 8 KV heads, its expert rank's 4 requests
        _paged_case("mixtral_tp2_ep2_decode", 16, 4, BLOCK, [[PROMPT_LENS[i]] for i in COMP_E_SPLIT[0]], gen,
                    cpu_gen),
        # the breadth phase's first decode steps (contexts of up to 6
        # splits): Falcon-7B's 71 query heads over one KV head of 64 (18 head
        # groups, the last of 3 heads), Phi-2's head_dim 80 (10 chunks a row
        # over 16-lane groups), and GPT-J-6B's 16 heads of 256 (2 chunks a lane)
        _paged_case("falcon7b_decode", 71, 1, BLOCK, [[n] for n in PROMPT_LENS], gen, cpu_gen, D=64),
        _paged_case("phi2_decode", 32, 32, BLOCK, [[n] for n in PROMPT_LENS], gen, cpu_gen, D=80),
        _paged_case("gptj6b_decode", 16, 16, BLOCK, [[n] for n in PROMPT_LENS], gen, cpu_gen, D=256),
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
def _engine(params, cfg, use_paged_kernel, dev, **state_manager):
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT, memory_config=MemoryConfig(size=KV_BYTES), **state_manager)
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
    """Llama-2-7B's bf16 weights at SERVE_LAYERS layers, random from seed 0:
    the main path's and the serving phases'."""
    cfg = serve_config()
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
    cfg = serve_config()
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
    res["tokens"] = tokens  # the parallel phase's one-rank tokens
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
    cfg = serve_config()
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
# the shared-prompt configuration (what chat and few-shot users send): a
# system prompt of PREFIX_TOKENS (16 blocks of BLOCK) and PREFIX_REQUESTS
# distinct user turns of PREFIX_SUFFIX tokens, NEW_TOKENS greedy tokens each.
# A hot suffix (at most 24 tokens) with the running decodes (at most 7) fits
# a put of at most 32 tokens, so it goes through B1; the same 7 at once
# (over 32 tokens) take the gather branch
PREFIX_TOKENS = 1024
PREFIX_SUFFIX = (8, 24)  # suffix lengths drawn from this closed range
PREFIX_REQUESTS = 8
TURN_TOKENS = 16  # new tokens of a multi-turn follow-up and of a rehydrate
HANDOFF_PROMPT = 256  # a 128 MiB frame at Llama-2-7B's 512 KiB a token
ROUND_TRIP_BLOCKS = 8  # the offload_path engine's pool


def _exchange(url, method="GET", data=None, headers=None):
    """One HTTP exchange: (status, content type, body bytes); an error
    status is returned, not raised."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


class _PutLog:
    """Wraps ``engine.put``: per put, the uids, the token count of each, the
    host seconds between two synchronizes and B1's launches."""

    def __init__(self, engine):
        self.rows = []
        inner = engine.put

        def put(uids, tokens, *args, **kw):
            torch.cuda.synchronize()
            t0, launches = time.perf_counter(), pa.paged_attention_update.launches
            out = inner(uids, tokens, *args, **kw)
            torch.cuda.synchronize()
            self.rows.append(dict(uids=list(uids), lens=[len(t) for t in tokens], s=time.perf_counter() - t0,
                                  launches=pa.paged_attention_update.launches - launches))
            return out

        engine.put = put

    def of(self, uid, n_tokens):
        """The puts that fed ``n_tokens`` tokens of sequence ``uid``."""
        return [r for r in self.rows if uid in r["uids"] and r["lens"][r["uids"].index(uid)] == n_tokens]


class _TrieMirror:
    """The prefix trie's contents computed on the host from what was served:
    a finished request publishes the full blocks of its prompt and of its
    history but the last token (fed only if decoding went on). ``expect`` is
    the prompt tokens the scheduler must serve from the cache."""

    def __init__(self):
        self.digests = set()

    def publish(self, prompt, tokens):
        self.digests.update(digest_chain(prompt, BLOCK))
        self.digests.update(digest_chain(list(prompt) + list(tokens)[:-1], BLOCK))

    def expect(self, prompt):
        chain = digest_chain(prompt, BLOCK)
        n = 0
        while n < len(chain) and chain[n] in self.digests:
            n += 1
        if n * BLOCK < len(prompt):
            return n * BLOCK
        return len(prompt) - 1  # fully cached: the last token is fed again


def _stepped(sched, threads, limit_s=600):
    """Step a hand-driven scheduler until every client thread has its answer."""
    deadline = time.perf_counter() + limit_s
    while any(t.is_alive() for t in threads):
        if time.perf_counter() > deadline:
            raise AssertionError("a prefix-phase client did not finish")
        if not sched.step():
            time.sleep(0.0005)


def _arrive(sched, url, out, items, limit_s=120):
    """POST each (key, body) from a client thread; returns once all of them
    are queued (the scheduler does not tick meanwhile)."""
    threads = []
    for key, body in items:
        t = threading.Thread(target=_http_generate, args=(url, body, False, out, key), daemon=True)
        t.start()
        threads.append(t)
    deadline = time.perf_counter() + limit_s
    while sched.queue_depth < len(items):
        if time.perf_counter() > deadline:
            raise AssertionError(f"{sched.queue_depth} of {len(items)} prefix-phase requests arrived")
        time.sleep(0.0005)
    return threads


def _shared_prompt_mix(params, cfg, dev, prompts, rng, failures) -> dict:
    """The shared system prompt over HTTP on a hand-stepped scheduler with
    the prefix cache: request 0 cold, the other 7 one a tick (hot suffixes
    through B1), the 7 at once, a control prompt that differs at token 0, the
    bare prefix (fully cached: copy-on-write fork), two follow-up turns of
    request 0, and the burst again under torch.profiler."""
    engine = _engine(params, cfg, None, dev)
    capacity = engine.free_blocks
    sm = engine._state_manager
    sched = ServingScheduler(engine, ServingConfig(queue_capacity=64, prefix_cache=PrefixCacheConfig(enabled=True)),
                             start=False)
    server = ServingServer(sched, host="127.0.0.1", port=0).start()
    putlog = _PutLog(engine)
    mirror = _TrieMirror()
    out, served, stages = {}, {}, {}
    body = lambda p: dict(prompt=p, max_new_tokens=NEW_TOKENS)

    def finish(keys, key_prompts):
        for k in keys:
            if out[k].get("status") != 200:
                raise AssertionError(f"prefix-phase request {k} failed: {out[k]}")
            served[k] = (key_prompts[k], out[k]["doc"]["tokens"])
        for k in keys:
            mirror.publish(*served[k])

    try:
        # cold: request 0 alone publishes the shared prefix
        stage_prompts = {"cold": prompts[0]}
        expected = {"cold": mirror.expect(prompts[0])}
        _stepped(sched, _arrive(sched, server.url, out, [("cold", body(prompts[0]))]))
        finish(["cold"], stage_prompts)
        trie = sorted(n.block for n in sched._prefix_cache._by_digest.values() if n.tier == "device")
        index = torch.from_numpy(np.asarray(trie, np.int64)).to(dev)
        shared_before = sm.kv_cache.cache[:, :, index].clone()

        # staggered: one arrival a tick, each hot suffix riding a put with the
        # running decodes
        keys = [f"staggered_{i}" for i in range(1, len(prompts))]
        for k, p in zip(keys, prompts[1:]):
            stage_prompts[k], expected[k] = p, mirror.expect(p)
        t0, threads = time.perf_counter(), []
        for k in keys:
            threads += _arrive(sched, server.url, out, [(k, body(stage_prompts[k]))])
            sched.step()
        _stepped(sched, threads)
        stages["staggered"] = time.perf_counter() - t0
        finish(keys, stage_prompts)

        # burst: the same 7 at once (buckets over 32 tokens: the gather branch)
        burst = [f"burst_{i}" for i in range(1, len(prompts))]
        for k, p in zip(burst, prompts[1:]):
            stage_prompts[k], expected[k] = p, mirror.expect(p)
        t0 = time.perf_counter()
        _stepped(sched, _arrive(sched, server.url, out, [(k, body(stage_prompts[k])) for k in burst]))
        stages["burst"] = time.perf_counter() - t0
        finish(burst, stage_prompts)

        # control: a prompt that differs at token 0 shares no block
        other = [(prompts[0][0] + 1) % cfg.vocab_size] + prompts[0][1:]
        stage_prompts["control"], expected["control"] = other, mirror.expect(other)
        _stepped(sched, _arrive(sched, server.url, out, [("control", body(other))]))
        finish(["control"], stage_prompts)

        # fully cached: the bare prefix forks its last block and re-feeds its
        # last token; then request 0's next two turns
        bare = prompts[0][:PREFIX_TOKENS]
        stage_prompts["fully_cached"], expected["fully_cached"] = bare, mirror.expect(bare)
        _stepped(sched, _arrive(sched, server.url, out, [("fully_cached", body(bare))]))
        finish(["fully_cached"], stage_prompts)
        history = list(prompts[0]) + served["cold"][1]
        for turn in ("turn_2", "turn_3"):
            p = history + rng.integers(0, cfg.vocab_size, TURN_TOKENS).tolist()
            stage_prompts[turn], expected[turn] = p, mirror.expect(p)
            _stepped(sched, _arrive(sched, server.url, out, [(turn, body(p))]))
            finish([turn], stage_prompts)
            history = p + served[turn][1]

        # the burst again under torch.profiler: the card's busy share
        again = [f"profiled_{i}" for i in range(1, len(prompts))]
        for k, p in zip(again, prompts[1:]):
            stage_prompts[k], expected[k] = p, mirror.expect(p)
        threads = _arrive(sched, server.url, out, [(k, body(stage_prompts[k])) for k in again])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _stepped(sched, threads)
            torch.cuda.synchronize()
            stages["profiled_burst"] = time.perf_counter() - t0
        finish(again, stage_prompts)
        counters = sched.stats()["counters"]
        trie_stats = sched.stats()["prefix_cache"]
        shared_after = sm.kv_cache.cache[:, :, index].clone()
    finally:
        server.stop()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)

    # --- exact hit accounting against the host mirror
    cached = {k: out[k]["doc"]["cached_tokens"] for k in stage_prompts}
    if cached != expected:
        failures.append(f"cached tokens differ from the host mirror: served {cached}, expected {expected}")
    want_hits = sum(1 for v in expected.values() if v > 0)
    want_saved = sum(expected.values())
    if (counters["prefix_hits"], counters["prefix_tokens_saved"]) != (want_hits, want_saved):
        failures.append(f"prefix counters {counters['prefix_hits']}/{counters['prefix_tokens_saved']} "
                        f"!= host-computed {want_hits}/{want_saved}")
    if expected["control"] != 0 or cached["control"] != 0:
        failures.append("control: the prompt that differs at token 0 was served from the cache")
    if not (expected["fully_cached"] == PREFIX_TOKENS - 1 and expected["turn_3"] > PREFIX_TOKENS):
        failures.append(f"the mirror expected no fork or no multi-turn hit past the prefix: {expected}")

    # --- B1 carried every hot suffix: one put of at most 32 tokens each, with
    # 2 launches a layer
    layers = cfg.num_hidden_layers
    hot, hot_puts = [], []  # the staggered suffixes' puts
    for k in keys + ["turn_2", "turn_3"]:
        doc = out[k]["doc"]
        rows = putlog.of(doc["uid"], len(stage_prompts[k]) - doc["cached_tokens"])
        hot.append(dict(key=k, suffix=len(stage_prompts[k]) - doc["cached_tokens"],
                        bucket=[sum(r["lens"]) for r in rows], launches=[r["launches"] for r in rows]))
        if k in keys:
            hot_puts += rows
    staggered_hot = [h for h in hot if h["key"].startswith("staggered")]
    if not all(len(h["launches"]) == 1 and h["bucket"][0] <= 32 and h["launches"][0] == 2 * layers
               for h in staggered_hot):
        failures.append(f"a staggered hot suffix did not ride one put of at most 32 tokens through B1: {hot}")
    cold_uid = out["cold"]["doc"]["uid"]
    cold_rows = [r for r in putlog.rows if cold_uid in r["uids"] and r["lens"][r["uids"].index(cold_uid)] > 1]
    if not cold_rows or all(r["launches"] == 2 * layers for r in cold_rows):
        failures.append("control: the cold prefill (the gather branch) passed the B1 check")
    fork_rows = putlog.of(out["fully_cached"]["doc"]["uid"], 1)
    fork_launches = fork_rows[0]["launches"] if fork_rows else 0

    # --- the shared blocks are the bytes they were: no write landed in them
    same = bool(torch.equal(_bits(shared_after), _bits(shared_before)))
    if not same:
        failures.append("a block shared with the trie changed while hot suffixes and the fork wrote around it")
    cache = sm.kv_cache.cache
    blk = int(trie[len(trie) // 2])
    flat = _bits(cache[0, 0, blk]).view(-1)
    keep = flat[7].clone()
    flat[7] ^= 1  # control: one element written into a shared block
    if torch.equal(_bits(cache[:, :, index]), _bits(shared_before)):
        failures.append("control: a write into a shared block passed the shared-bytes check")
    flat[7] = keep

    # --- after stop() cleared the trie: the pool is whole, every count 0
    refs = sm.kv_cache._allocator._refs

    def pool_whole():
        return engine.free_blocks == capacity and int(np.abs(refs).sum()) == 0

    if not pool_whole():
        failures.append(f"after stop: {capacity - engine.free_blocks} blocks held, "
                        f"{int((refs != 0).sum())} nonzero refcounts")
    spare = sm.kv_cache.reserve(1)
    sm.kv_cache.incref(spare)
    sm.kv_cache.free(spare)
    if pool_whole():
        failures.append("control: an extra reference passed the pool check")
    sm.kv_cache.free(spare)

    ttft = lambda ks: [out[k]["doc"]["ttft_s"] for k in ks]
    n_tok = lambda ks: sum(len(out[k]["doc"]["tokens"]) for k in ks)
    res = dict(prompt_tokens=[len(p) for p in prompts], expected_cached=expected, counters=counters,
               trie=trie_stats, ttft_cold_s=out["cold"]["doc"]["ttft_s"],
               ttft_staggered_p50_s=_percentile(ttft(keys), 50), ttft_staggered_p99_s=_percentile(ttft(keys), 99),
               ttft_burst_p50_s=_percentile(ttft(burst), 50), ttft_burst_p99_s=_percentile(ttft(burst), 99),
               ttft_fully_cached_s=out["fully_cached"]["doc"]["ttft_s"],
               ttft_turns_s=ttft(["turn_2", "turn_3"]),
               prefill_tokens_avoided=counters["prefix_tokens_saved"],
               staggered_wall_s=stages["staggered"], staggered_tokens_per_s=n_tok(keys) / stages["staggered"],
               burst_wall_s=stages["burst"], burst_tokens_per_s=n_tok(burst) / stages["burst"],
               hot_suffix_puts=hot, b1_launches_hot_puts=sum(r["launches"] for r in hot_puts),
               b1_launches_fork_put=fork_launches, b1_launches=sum(r["launches"] for r in putlog.rows),
               hot_put_ms=[1e3 * r["s"] for r in hot_puts], shared_blocks=len(trie), shared_blocks_unchanged=same,
               profiled_burst_wall_s=stages["profiled_burst"],
               device_busy_share_profiled_burst=busy_us / 1e6 / stages["profiled_burst"] if busy_us
               else "not measured")
    del engine, sched, server, shared_before, shared_after
    return res, list(served.values())


def _handoff_and_park(params, cfg, dev, rng, failures):
    """Engine A prefills a HANDOFF_PROMPT-token prompt with ``handoff`` and
    one new token; engine B (same weight tensors, its own pool) resumes the
    frame over HTTP as a raw body, claimed once from A; the same request
    served whole on A is the reference. Then a request parked on A is
    rehydrated on B with TURN_TOKENS more prompt tokens. Each side's server
    runs alone, so no second scheduler loop shares the host."""
    p = rng.integers(0, cfg.vocab_size, HANDOFF_PROMPT).tolist()
    engine_a, engine_b = _engine(params, cfg, None, dev), _engine(params, cfg, None, dev)
    sched_a = ServingScheduler(engine_a, ServingConfig())
    server_a = ServingServer(sched_a, host="127.0.0.1", port=0).start()
    server_b = None
    times = {"export": [], "import": [], "unpack": []}
    _timed(sched_a, "_export_handoff", times["export"])
    putlog = _PutLog(engine_b)
    json_post = lambda url, doc, extra=(): _exchange(url, "POST", json.dumps(doc).encode(),
                                                     dict([("Content-Type", "application/json"), *extra]))
    try:
        status, _, whole = json_post(server_a.url + "/v1/generate", dict(prompt=p, max_new_tokens=NEW_TOKENS))
        whole = json.loads(whole)["tokens"]
        status_h, _, doc = json_post(server_a.url + "/v1/generate",
                                     dict(prompt=p, max_new_tokens=1, handoff=True),
                                     [("X-DSTPU-Handoff-Transport", "ref")])
        doc = json.loads(doc)
        t0 = time.perf_counter()
        status_c, ctype, frame = _exchange(server_a.url + "/v1/handoff/" + doc["handoff_ref"])
        claim_s = time.perf_counter() - t0
        second_claim = _exchange(server_a.url + "/v1/handoff/" + doc["handoff_ref"])[0]
        parked = sched_a.submit(p, max_new_tokens=NEW_TOKENS, park=True)
        parked.result(timeout=600)
        server_a.stop()

        sched_b = ServingScheduler(engine_b, ServingConfig())
        _timed(sched_b, "_import_resume", times["import"])
        _timed(sched_b, "submit_resume", times["unpack"])
        server_b = ServingServer(sched_b, host="127.0.0.1", port=0).start()
        binary = {"Content-Type": HANDOFF_CONTENT_TYPE,
                  "X-DSTPU-Params": json.dumps(dict(max_new_tokens=NEW_TOKENS - 1))}
        t0 = time.perf_counter()
        status_r, _, resumed = _exchange(server_b.url + "/v1/resume", "POST", frame, binary)
        resume_s = time.perf_counter() - t0
        resumed = json.loads(resumed)
        corrupt = bytearray(frame)
        corrupt[-(len(frame) // 3)] ^= 1  # one KV byte
        status_x, _, refused = _exchange(server_b.url + "/v1/resume", "POST", bytes(corrupt), binary)
        # the parked request rehydrated on B, its history extended by TURN_TOKENS
        extended = p + parked.tokens + rng.integers(0, cfg.vocab_size, TURN_TOKENS).tolist()
        rehydrated = sched_b.submit_resume(parked.park_payload, prompt=extended, max_new_tokens=NEW_TOKENS)
        rehydrated.result(timeout=600)
    finally:
        server_a.stop()
        if server_b is not None:
            server_b.stop()
    statuses = (status, status_h, status_c, status_r)
    if statuses != (200, 200, 200, 200) or ctype != HANDOFF_CONTENT_TYPE:
        failures.append(f"handoff exchange statuses {statuses}, claim content type {ctype}")
    continued = doc["tokens"] + resumed.get("tokens", [])
    if continued != whole:
        failures.append(f"handoff continuation {continued} differs from the request served whole {whole}")
    if second_claim != 404:
        failures.append(f"control: a second claim of the handoff ref answered {second_claim}")
    if status_x != 400 or b"checksum" not in refused:
        failures.append(f"control: a frame with one KV byte flipped answered {status_x} {refused[:120]!r}")
    suffix = len(extended) - (HANDOFF_PROMPT + NEW_TOKENS - 1)  # the boundary token is fed again
    rows = putlog.of(rehydrated.uid, suffix)
    prefill = [r for r in putlog.rows if rehydrated.uid in r["uids"] and r["lens"][r["uids"].index(rehydrated.uid)] > 1]
    layers = cfg.num_hidden_layers
    if not (rehydrated.cached_tokens == HANDOFF_PROMPT + NEW_TOKENS - 1 and len(prefill) == 1 and len(rows) == 1
            and suffix <= 32 and rows[0]["launches"] == 2 * layers):
        failures.append(f"the rehydrate did not prefill only its {suffix}-token suffix in one put through B1: "
                        f"cached {rehydrated.cached_tokens}, prefill puts {prefill}")
    mb = len(frame) / 2**20
    res = dict(frame_mib=mb, export_ms=1e3 * times["export"][0], export_mib_per_s=mb / times["export"][0],
               claim_http_ms=1e3 * claim_s, claim_mib_per_s=mb / claim_s,
               submit_resume_ms=1e3 * times["unpack"][0], import_ms=1e3 * times["import"][0],
               import_mib_per_s=mb / times["import"][0], resume_http_ms_with_31_tokens=1e3 * resume_s,
               continuation_equal=continued == whole, rehydrate_suffix_tokens=suffix,
               rehydrate_b1_launches=rows[0]["launches"] if rows else 0,
               park_frame_mib=len(parked.park_payload) / 2**20)
    served = [(p, whole), (extended, list(rehydrated.tokens))]
    del engine_a, engine_b, sched_a, sched_b, server_a, server_b
    return res, served


def _disk_tier(params, cfg, dev, spill_root, failures):
    """The serving phase's pressure mix with the prefix cache and the tier
    ladder (host budget 0: everything spills to disk), every restore compared bit for bit
    with the blocks offloaded; then one HANDOFF_PROMPT-token sequence through
    an engine's offload_path (the native AIO engine) and back, and once more
    with a byte of its spill file flipped (the control)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT,
                               memory_config=MemoryConfig(mode="allocate", size=PRESSURE_BLOCKS))
    small = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK), device=dev)
    kv = small._state_manager.kv_cache
    snaps, restores = {}, []
    inner_offload, inner_restore = kv.offload, kv.restore

    def offload(blocks):
        before = kv.cache[:, :, torch.from_numpy(np.asarray(blocks, np.int64)).to(dev)].clone()
        handle = inner_offload(blocks)
        snaps[handle] = before
        return handle

    def restore(handle):
        new = inner_restore(handle)
        after = kv.cache[:, :, torch.from_numpy(np.asarray(new, np.int64)).to(dev)]
        restores.append(dict(tier=tiers.get(handle), same=bool(torch.equal(_bits(after), _bits(snaps.pop(handle))))))
        return new

    tiers = {}
    inner_read = kv.tiered_store.read

    def read(handle):
        data, tier = inner_read(handle)
        tiers[handle] = tier
        return data, tier

    kv.offload, kv.restore, kv.tiered_store.read = offload, restore, read
    cfg_tiers = ServingConfig(decode_chunk=PRESSURE_DECODE_CHUNK, prefix_cache=PrefixCacheConfig(enabled=True),
                              kv_tiers=KVTierConfig(enabled=True, host_bytes=0,
                                                    spill_dir=os.path.join(spill_root, "tiers")))
    pressured = ServingScheduler(small, cfg_tiers, start=False)
    try:
        t0 = time.perf_counter()
        reqs = [pressured.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        while not all(r.finished for r in reqs):
            pressured.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = [r.result(timeout=1) for r in reqs]
        stats = pressured.stats()
    finally:
        pressured.stop(drain=False)
    store = kv.tier_stats()
    res = dict(wall_s=wall, counters=stats["counters"], kv_tiers=stats["kv_tiers"], store=store,
               restores=len(restores), restores_from_disk=sum(r["tier"] == "disk" for r in restores),
               restores_bit_exact=all(r["same"] for r in restores))
    if not store["demotions"] > 0:
        failures.append(f"the tiered pressure mix demoted nothing to disk: {store}")
    if not (restores and res["restores_bit_exact"]):
        failures.append(f"a restore under the tier ladder differs from its offloaded blocks: {restores}")
    del small, pressured, kv
    gc.collect()

    # --- one sequence through offload_path (spill synchronously) and back
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT, offload_path=os.path.join(spill_root, "offload"),
                               memory_config=MemoryConfig(mode="allocate", size=ROUND_TRIP_BLOCKS))
    eng = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK), device=dev)
    sm = eng._state_manager
    p = rng.integers(0, cfg.vocab_size, HANDOFF_PROMPT).tolist()

    def round_trip(flip):
        uid = 7
        eng.put([uid], [p])
        blocks = torch.from_numpy(sm.get_sequence(uid).kv_blocks).to(dev)
        before = sm.kv_cache.cache[:, :, blocks].clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.offload_sequence(uid)
        demote_s = time.perf_counter() - t0
        tier, path = sm.sequence_tier(uid), sm.kv_cache.tiered_store._entries[sm._offloaded[uid]].path
        if flip:
            with open(path, "r+b") as f:
                f.seek(os.path.getsize(path) // 2)
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 1]))
        t0 = time.perf_counter()
        eng._restore_offloaded([uid])
        torch.cuda.synchronize()
        promote_s = time.perf_counter() - t0
        after = sm.kv_cache.cache[:, :, torch.from_numpy(sm.get_sequence(uid).kv_blocks).to(dev)]
        same = bool(torch.equal(_bits(after), _bits(before)))
        gb = before.numel() * before.element_size() / 1e9
        eng.flush(uid)
        return dict(tier=tier, same=same, gb=gb, demote_gb_per_s=gb / demote_s, promote_gb_per_s=gb / promote_s)

    trip = round_trip(flip=False)
    flipped = round_trip(flip=True)
    native = aio_available() and sm.kv_cache._aio is not None and sm.kv_cache._aio._handle is not None
    res.update(round_trip=trip, aio_native=native)
    if not (trip["tier"] == "disk" and trip["same"]):
        failures.append(f"the offload_path round trip was not bit-exact through disk: {trip}")
    if flipped["same"]:
        failures.append("control: a flipped byte in a spill file passed the round-trip check")
    if not native:
        failures.append("the native AIO engine did not load (aio_available() is false)")
    del eng
    return res, list(zip(prompts, tokens))


def run_prefix_path(dev, params, main) -> dict:
    """The KV-reuse and KV-movement features on Llama-2-7B under the ported
    scheduler and server: the shared-prompt mix with the prefix cache, the
    handoff and park/rehydrate between two engines, and the disk tier. Every
    served greedy token is held to the dense f32 model (teacher-forced);
    every check has a control it rejects."""
    import tempfile
    t_start = time.perf_counter()
    cfg = serve_config()
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_TOKENS).tolist()
    lens = rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1, PREFIX_REQUESTS)
    prompts = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    failures = []
    parts = {}
    t0 = time.perf_counter()
    res, served = _shared_prompt_mix(params, cfg, dev, prompts, rng, failures)
    gc.collect()
    torch.cuda.empty_cache()
    parts["shared_prompt_mix"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["handoff"], more = _handoff_and_park(params, cfg, dev, rng, failures)
    served += more
    gc.collect()
    torch.cuda.empty_cache()
    parts["handoff_and_park"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dstt_spill_") as spill_root:
        res["disk_tier"], more = _disk_tier(params, cfg, dev, spill_root, failures)
    served += more
    gc.collect()
    torch.cuda.empty_cache()
    parts["disk_tier"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # --- every served greedy token against the dense f32 model
    tol = TF_SLACK * max(main["logits_max_abs_err_kernel_vs_f32"], main["logits_max_abs_err_gather_vs_f32"])
    model = _dense_f32(params, cfg)
    gaps = _teacher_forced(model, dev, served)
    # the control needs only a few sequences to show that the check bites
    shifted = _teacher_forced(model, dev, [(p, t[1:] + t[:1]) for p, t in served[:4]])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["teacher_forced"] = dict(tolerance=tol, sequences=len(served), tokens=int(gaps.numel()),
                                 max_gap=gaps.max().item(), max_gap_over_tol=gaps.max().item() / tol,
                                 control_max_gap=shifted.max().item())
    if not gaps.max().item() <= tol:
        failures.append(f"a served token's f32 logit trails its row's maximum by {gaps.max().item()} > {tol}")
    if not shifted.max().item() > tol:
        failures.append("control: the shifted tokens passed the teacher-forced check")
    parts["teacher_forced"] = time.perf_counter() - t0
    res["seconds_by_part"] = parts
    res["seconds"] = time.perf_counter() - t_start
    res["failures"] = failures
    h, d = res["handoff"], res["disk_tier"]
    log("[prefix] " + json.dumps({k: v for k, v in res.items() if k not in ("counters", "hot_suffix_puts")}))
    log(f"[prefix] TTFT cold {res['ttft_cold_s'] * 1e3:.1f} ms; hot staggered p50 "
        f"{res['ttft_staggered_p50_s'] * 1e3:.1f} ms p99 {res['ttft_staggered_p99_s'] * 1e3:.1f} ms; burst p50 "
        f"{res['ttft_burst_p50_s'] * 1e3:.1f} ms p99 {res['ttft_burst_p99_s'] * 1e3:.1f} ms; "
        f"{res['prefill_tokens_avoided']} prefill tokens avoided; served {res['staggered_tokens_per_s']:.1f} "
        f"tokens/s staggered, {res['burst_tokens_per_s']:.1f} burst; card busy "
        f"{res['device_busy_share_profiled_burst']} of the profiled burst")
    log(f"[prefix] B1 launches in hot puts {res['b1_launches_hot_puts']} "
        f"({len(res['hot_suffix_puts'])} hot suffixes), {res['b1_launches']} in the whole mix")
    log(f"[prefix] handoff frame {h['frame_mib']:.1f} MiB: export {h['export_ms']:.1f} ms "
        f"({h['export_mib_per_s']:.0f} MiB/s), HTTP claim {h['claim_http_ms']:.1f} ms, import "
        f"{h['import_ms']:.1f} ms ({h['import_mib_per_s']:.0f} MiB/s); disk: demote "
        f"{d['round_trip']['demote_gb_per_s']:.2f} GB/s, promote {d['round_trip']['promote_gb_per_s']:.2f} GB/s, "
        f"{d['store']['demotions']} demotions in the pressure mix")
    log(card_line())
    if failures:
        raise AssertionError("prefix phase: " + "; ".join(failures))
    return res


# ----------------------------------------------------------------- phase 7 --
# speculative decoding on the main path's engine: 8 prompts with repeated
# n-grams (a random 8-16-token pattern tiled to PROMPT_LENS + SPEC_OFFSET),
# NEW_TOKENS greedy tokens each. The offset puts each prompt's end 40 tokens
# into a block, so a finished request publishes that block with 24 of its
# generated tokens, and the same prompt served again drafts them from the
# prefix trie. A verify feed of 8 decodes + 24 drafts fits a 32-token
# bucket and goes through B1; the default budget (8 x (1 + 4) = 40, bucket 64)
# takes the gather branch
SPEC_K = 4  # SpeculativeConfig.max_draft_tokens' default
SPEC_OFFSET = 40
SPEC_CONTROL_PROMPTS = 2  # the wrong-token oracle control's requests
SPEC_B1_BUDGET = 24
SPEC_TREE_NODES = 8  # the full-width verify_tree: 8 trees of 8 nodes (T = 64)
SPEC_SHORT_PROMPT, SPEC_LONG_BRANCH = 6, 20  # the tree and compaction checks' context
LEARNED_REQUESTS, LEARNED_NEW_TOKENS = 2, 8
# sampled decode_loop: SAMPLE_STEPS steps for the 8 sequences at
# SAMPLE_TEMPERATURE; every draw's probability under the dense f32 model must
# be at least SAMPLE_FLOOR_ALPHA / (vocab x draws), so a correct sampler fails
# the check with probability at most SAMPLE_FLOOR_ALPHA (0.1%) (a draw lands
# on tokens of total probability at most vocab x floor)
SAMPLE_STEPS, SAMPLE_TEMPERATURE, SAMPLE_FLOOR_ALPHA = 16, 0.3, 1e-3
# chi-square of CHI2_DRAWS draws of one real logits row at SAMPLE_TEMPERATURE,
# binned into its 15 likeliest tokens and the rest: 15 degrees of freedom,
# critical value 37.70 at p = 0.001
CHI2_DRAWS, CHI2_CHUNK, CHI2_CRITICAL = 100_000, 10_000, 37.70


def _spec_prompts(cfg, rng):
    """Prompt i: a random pattern of 8-16 tokens tiled to PROMPT_LENS[i] +
    SPEC_OFFSET tokens."""
    out = []
    for n in PROMPT_LENS:
        n += SPEC_OFFSET
        pattern = rng.integers(0, cfg.vocab_size, int(rng.integers(8, 17))).tolist()
        out.append((pattern * (n // len(pattern) + 1))[:n])
    return out


def _put_prompt(engine, uid, prompt):
    """Prefill ``prompt`` as ``uid`` in puts of the token budget; the last
    put's f32 logits row."""
    chunk = engine.config.state_manager.max_ragged_batch_size
    for start in range(0, len(prompt), chunk):
        logits = engine.put([uid], [prompt[start:start + chunk]])
    return logits[0].float()


class _OracleDrafter:
    """Proposes the spec-off run's own next tokens while the request's history
    is a prefix of that run's history, else nothing: acceptance is then
    certain whatever the random weights do (where bf16 verify and decode
    logits agree)."""

    def __init__(self, prompts, continuations, skip=0):
        self._runs = [list(p) + list(c) for p, c in zip(prompts, continuations)]
        self._skip = skip  # the control's wrong drafts: the run's tokens `skip` further on

    def draft(self, history, k, digests=None):
        history = [int(t) for t in history]
        for run in self._runs:
            if len(history) < len(run) and run[:len(history)] == history:
                start = len(history) + self._skip
                return np.asarray(run[start:start + k], np.int32)
        return np.empty(0, np.int32)


class _DispatchLog:
    """Wraps a scheduler's ``_execute`` and its engine's ``put``/``verify``/
    ``verify_tree``: per tick whether it carried decode work, per verify call
    its width and B1's launches."""

    def __init__(self, sched):
        self.decode_ticks, self.verifies, self.verify_trees, self.puts = 0, [], [], 0
        engine, inner_exec = sched._engine, sched._execute

        def execute(plan):
            if any(req.state.name == "DECODE" for req, _ in plan):
                self.decode_ticks += 1
            return inner_exec(plan)

        def wrap(name, rows):
            inner = getattr(engine, name)

            def call(uids, feeds, *args, **kw):
                before = pa.paged_attention_update.launches
                out = inner(uids, feeds, *args, **kw)
                rows.append(dict(sequences=len(uids), launches=pa.paged_attention_update.launches - before,
                                 tokens=int(sum(np.asarray(getattr(f, "tokens", f)).size for f in feeds))))
                return out

            setattr(engine, name, call)

        inner_put = engine.put

        def put(*args, **kw):
            self.puts += 1
            return inner_put(*args, **kw)

        sched._execute, engine.put = execute, put
        wrap("verify", self.verifies)
        wrap("verify_tree", self.verify_trees)

    def unwrap(self, sched):
        for name in ("put", "verify", "verify_tree"):
            del sched._engine.__dict__[name]
        del sched.__dict__["_execute"]


def _serve_spec(params, cfg, dev, prompts, spec, passes=1, oracle=None, sequential=False):
    """The 8 prompts, greedy, NEW_TOKENS each, through a fresh engine and a
    scheduler with ``spec`` (None: speculation off). With ``oracle`` None:
    over HTTP (a scheduler on its own thread behind ServingServer) with the
    prefix cache on, all 8 at once, ``passes`` times (the second pass drafts
    from the trie the first one published). ``sequential``: one request at a
    time, stepped by hand, so that a verify feed and a decode step see the
    same bucket (T = 8) and compute the same logits; ``oracle`` replaces the
    drafter. Returns per pass the tokens and the record."""
    engine = _engine(params, cfg, None, dev)
    capacity = engine.free_blocks
    http = not sequential
    config = ServingConfig(queue_capacity=64, prefix_cache=PrefixCacheConfig(enabled=http),
                           speculative=spec or SpeculativeConfig())
    sched = ServingScheduler(engine, config, start=http)
    if oracle is not None:
        sched._drafter = oracle
    server = ServingServer(sched, host="127.0.0.1", port=0).start() if http else None
    pushes = {}
    inner_push = sched._push_token

    def push(req, tok, record_itl=True):
        pushes.setdefault(req.uid, (req, []))[1].append(time.monotonic())
        return inner_push(req, tok, record_itl)

    sched._push_token = push
    # the loop idles until every request of a pass is queued, in the prompts'
    # order: the 8 requests then prefill and decode in the same ticks whatever
    # the client threads' timing, and the default budget's verify feeds are
    # up to 8 x (1 + k) tokens
    gate = threading.Event()
    if http:
        inner_step = sched.step
        sched.step = lambda: gate.is_set() and inner_step()
    runs = []
    try:
        for _ in range(passes):
            log_ = _DispatchLog(sched)
            pushes.clear()
            before = dict(sched.stats()["counters"])
            pa.paged_attention_update.launches = 0
            t0 = time.perf_counter()
            if http:
                gate.clear()
                out, threads = {}, []
                for i, q in enumerate(prompts):
                    t = threading.Thread(target=_http_generate, daemon=True,
                                         args=(server.url, dict(prompt=q, max_new_tokens=NEW_TOKENS), False, out, i))
                    t.start()
                    threads.append(t)
                    deadline = time.monotonic() + 60  # a failed request is reported below
                    while sched.queue_depth < i + 1 and t.is_alive() and time.monotonic() < deadline:
                        time.sleep(0.001)
                gate.set()
                for t in threads:
                    t.join(timeout=600)
                bad = {k: v for k, v in out.items() if v.get("status") != 200}
                if bad or len(out) != len(prompts):
                    raise AssertionError(f"speculative serving requests failed: {bad}")
                tokens = [out[i]["doc"]["tokens"] for i in range(len(prompts))]
                spec_field = [out[i]["doc"].get("spec") for i in range(len(prompts))]
            else:
                tokens, spec_field = [], []
                for q in prompts:
                    req = sched.submit(q, max_new_tokens=NEW_TOKENS)
                    while not req.finished:
                        sched.step()
                    tokens.append(req.result(timeout=1))
                    spec_field.append(dict(drafted=req.spec_drafted, accepted=req.spec_accepted,
                                           decode_steps=req.decode_steps))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log_.unwrap(sched)
            counters = {k: v - before[k] for k, v in sched.stats()["counters"].items()}
            ttft = [ts[0] - req.arrival_s for req, ts in pushes.values()]
            itl = [b - a for _, ts in pushes.values() for a, b in zip(ts, ts[1:])]
            n = sum(len(t) for t in tokens)
            drafted, accepted = counters["spec_drafted"], counters["spec_accepted"]
            runs.append((tokens, dict(
                wall_s=wall, served_tokens=n, served_tokens_per_s=n / wall, ttft_p50_s=_percentile(ttft, 50),
                ttft_p99_s=_percentile(ttft, 99), itl_p50_s=_percentile(itl, 50), itl_p99_s=_percentile(itl, 99),
                decode_ticks=log_.decode_ticks, verify_dispatches=len(log_.verifies),
                verify_tree_dispatches=len(log_.verify_trees), puts=log_.puts,
                b1_launches=pa.paged_attention_update.launches,
                b1_launches_per_verify=[r["launches"] for r in log_.verifies],
                verify_tokens=[r["tokens"] for r in log_.verifies], drafted=drafted, accepted=accepted,
                rolled_back=counters["spec_rollback"], verify_steps=counters["spec_steps"],
                acceptance=accepted / drafted if drafted else None,
                # per request and verify step: its accepted drafts and the token after them
                tokens_per_verify_step=((accepted + counters["spec_steps"]) / counters["spec_steps"]
                                        if counters["spec_steps"] else None),
                prefix_tokens_saved=counters["prefix_tokens_saved"], spec_field=spec_field,
                decode_steps=[f["decode_steps"] for f in spec_field] if not http else None,
                # tokens emitted after each request's first, per tick that carried decode work
                tokens_per_decode_tick=(n - len(prompts)) / max(1, log_.decode_ticks))))
    finally:
        if server is not None:
            server.stop()
        sched.stop(drain=False)
    for _, r in runs:
        r["pool_whole_after_stop"] = engine.free_blocks == capacity
    del engine, sched, server
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _stale_slots_check(engine, seq, uid, feed, failures, label):
    """Hazard of write-then-truncate: after a rejection the slots past the
    committed count hold stale K/V. Overwrite every one of them with finite
    garbage (random x 100; not NaN, which the gather branch's 0 x NaN would
    spread even under a correct mask) and run the next verify and decode:
    their logits must be bitwise those of the same run without the garbage.
    Control: garbage in the last committed slot must change them."""
    cache = engine._state_manager.kv_cache.cache
    blocks = torch.from_numpy(seq.kv_blocks).to(cache.device)
    saved = cache[:, :, blocks].clone()
    seen = seq.seen_tokens
    gen = torch.Generator(device=cache.device).manual_seed(7)

    def garbage(start):
        view = cache[:, :, blocks].clone()  # [L, 2, nb, KVH, bs, D]
        flat = view.permute(0, 1, 2, 4, 3, 5).reshape(view.shape[0], 2, -1, view.shape[3], view.shape[5])
        flat[:, :, start:] = (torch.randn(flat[:, :, start:].shape, generator=gen, device=cache.device)
                              * 100).to(cache.dtype)
        cache[:, :, blocks] = flat.reshape(view.shape[0], 2, view.shape[2], view.shape[4], view.shape[3],
                                           view.shape[5]).permute(0, 1, 2, 4, 3, 5)

    def run(start):
        cache[:, :, blocks] = saved
        if start is not None:
            garbage(start)
        rows = engine.verify([uid], [feed])[0]
        engine.rollback(uid, len(feed) - 1)
        dec = engine.put([uid], [[int(feed[1])]]).float().cpu().numpy()
        engine.rollback(uid, 2)  # back to `seen` for the next run
        return rows, dec

    clean, stale, control = run(None), run(seen), run(seen - 1)
    cache[:, :, blocks] = saved
    ok = all(np.array_equal(a, b) for a, b in zip(clean, stale))
    bites = not np.array_equal(clean[0], control[0])
    if not ok:
        failures.append(f"{label}: garbage past the committed count changed the next verify/decode logits")
    if not bites:
        failures.append(f"{label}: control: garbage in a committed slot left the logits unchanged")
    return dict(bitwise_equal=ok, control_changed=bites)


def _engine_legs(engine, cfg, prompts, failures):
    """Leg a: verify feeds of drafts k = 1..4 from the spec-off greedy
    continuation, a rejected feed, the stale-slot checks through B1 and the
    gather branch, verify_tree against linear verify (a chain, a two-branch
    tree and a control tree whose siblings see each other), compaction, and
    the peak memory and time of one full-width verify_tree."""
    res, served = {}, []
    p = prompts[3]
    t1 = int(_put_prompt(engine, 0, p).argmax())
    cont = [t1] + engine.decode_loop([0], [[t1]], NEW_TOKENS - 1)[0].tolist()
    engine.flush(0)

    # --- verify feeds of k = 1..4 drafts from the continuation, greedy ids
    _put_prompt(engine, 1, p)
    out, k, steps, b1 = [t1], 1, 0, []
    while len(out) < NEW_TOKENS:
        feed = np.asarray([out[-1]] + cont[len(out):len(out) + k], np.int32)
        before = pa.paged_attention_update.launches
        ids = engine.verify([1], [feed], greedy=True)[0]
        b1.append(pa.paged_attention_update.launches - before)
        acc = 0
        while acc < feed.size - 1 and int(ids[acc]) == int(feed[acc + 1]):
            acc += 1
        engine.rollback(1, feed.size - 1 - acc)
        out.extend(int(t) for t in ids[:acc + 1])
        k, steps = k % SPEC_K + 1, steps + 1
    out = out[:NEW_TOKENS]
    engine.flush(1)
    served.append((p, out))
    res["verify_feeds"] = dict(steps=steps, tokens=len(out), agree_with_decode=sum(a == b for a, b in zip(out, cont)),
                               b1_launches=b1)
    if not all(n == 2 * cfg.num_hidden_layers for n in b1):
        failures.append(f"a verify feed of at most 5 tokens did not launch B1 once per layer: {b1}")

    # --- a rejected feed rolls back and continues; then the stale slots
    _put_prompt(engine, 2, p)
    seq = engine._state_manager.get_sequence(2)
    wrong = np.asarray([t1] + [(t + 1) % cfg.vocab_size for t in cont[1:4]], np.int32)
    ids = engine.verify([2], [wrong], greedy=True)[0]
    engine.rollback(2, 3)
    nxt = int(ids[0])
    res["rejection"] = dict(seen_after_rollback=seq.seen_tokens, next_equals_continuation=nxt == cont[1])
    if seq.seen_tokens != len(p) + 1:
        failures.append(f"rollback left {seq.seen_tokens} committed tokens, not {len(p) + 1}")
    feed = np.asarray([nxt] + cont[2:4], np.int32)
    res["stale_b1"] = _stale_slots_check(engine, seq, 2, feed, failures, "B1")
    engine.config.use_paged_kernel = False  # the gather branch
    try:
        res["stale_gather"] = _stale_slots_check(engine, seq, 2, feed, failures, "gather")
    finally:
        engine.config.use_paged_kernel = None
    engine.flush(2)

    # --- trees on a short context (SPEC_SHORT_PROMPT tokens), where the
    # context a mask fault adds or drops moves the logits far past bf16's
    # noise: each set of rows is held to the dense f32 model on its own
    # context (rel. L2 <= LOGITS_L2_TOL, the main path's limit) and to the
    # linear verify of the same path (<= 2x that: each within it of f32)
    ps = prompts[0][:SPEC_SHORT_PROMPT]
    rng = np.random.default_rng(10)
    a_path = rng.integers(0, cfg.vocab_size, 2).tolist()
    b_path = rng.integers(0, cfg.vocab_size, SPEC_LONG_BRANCH).tolist()
    f32_checks = []

    def fresh(uid):
        return int(_put_prompt(engine, uid, ps).argmax())

    def linear(tokens):
        fresh(9)
        rows = engine.verify([9], [np.asarray(tokens, np.int32)])[0]
        engine.flush(9)
        return rows

    def tree_rows(tree, leaky=False):
        inner = engine.model._tree_visibility
        if leaky:  # control: a mask that lets every node see all nodes before it
            def chain_mask(tok_meta, seq_meta, tree_meta):
                visible, qm = inner(tok_meta, seq_meta, tree_meta)
                seen, n = int(seq_meta[0, 0]), int(seq_meta[0, 1])
                visible[0, :n, seen:seen + n] = np.tril(np.ones((n, n), bool))
                return visible, qm
            engine.model._tree_visibility = chain_mask
        try:
            fresh(8)
            rows = engine.verify_tree([8], [tree])[0]["rows"]
        finally:
            engine.model.__dict__.pop("_tree_visibility", None)
        engine.flush(8)
        return rows

    t1s = fresh(9)
    engine.flush(9)
    chain = [t1s] + b_path[:4]
    f32_checks.append(("tree_chain", ps + chain, tree_rows(TokenTree.chain(chain)), False))
    f32_checks.append(("linear_chain", ps + chain, linear(chain), False))
    # two branches, the long one first: a mask that lets siblings see each
    # other shows the short branch all of the long one
    sib = TokenTree([t1s] + b_path + a_path, [-1] + list(range(SPEC_LONG_BRANCH)) + [0, SPEC_LONG_BRANCH + 1])
    rows = tree_rows(sib)
    a_nodes = [0, SPEC_LONG_BRANCH + 1, SPEC_LONG_BRANCH + 2]
    f32_checks.append(("tree_branch_short", ps + [t1s] + a_path, rows[a_nodes], False))
    f32_checks.append(("tree_branch_long", ps + [t1s] + b_path, rows[:SPEC_LONG_BRANCH + 1], False))
    f32_checks.append(("control_leaky_branch_short", ps + [t1s] + a_path, tree_rows(sib, leaky=True)[a_nodes], True))
    f32_checks.append(("linear_branch_short", ps + [t1s] + a_path, linear([t1s] + a_path), False))
    f32_checks.append(("linear_branch_long", ps + [t1s] + b_path, linear([t1s] + b_path), False))
    pairs = [("tree_chain", "linear_chain"), ("tree_branch_short", "linear_branch_short"),
             ("tree_branch_long", "linear_branch_long")]

    # --- compaction: two long branches, the second accepted; then one decode.
    # The control leaves the first branch's KV where the accepted one belongs
    n = SPEC_LONG_BRANCH
    a_long = rng.integers(0, cfg.vocab_size, n).tolist()
    cmp_tree = TokenTree([t1s] + a_long + b_path, [-1] + list(range(n)) + [0] + list(range(n + 1, 2 * n)))
    accepted = list(range(n + 1, 2 * n + 1))
    x = b_path[0]

    def after_tree(compact):
        fresh(7)
        engine.verify_tree([7], [cmp_tree])
        if compact:
            engine.compact_accepted(7, cmp_tree.size, accepted)
        else:  # control: truncate to the path's length, leave its KV where it was
            engine.rollback(7, cmp_tree.size - 1 - SPEC_LONG_BRANCH)
        rows = engine.put([7], [[x]]).float().cpu().numpy()
        engine.flush(7)
        return rows

    f32_checks.append(("compacted_decode", ps + [t1s] + b_path + [x], after_tree(True), False))
    f32_checks.append(("control_uncompacted_decode", ps + [t1s] + b_path + [x], after_tree(False), True))
    fresh(6)
    engine.verify([6], [np.asarray([t1s] + b_path, np.int32)])
    f32_checks.append(("linear_decode", ps + [t1s] + b_path + [x], engine.put([6], [[x]]).float().cpu().numpy(),
                       False))
    engine.flush(6)
    pairs.append(("compacted_decode", "linear_decode"))

    # --- one full-width verify_tree: 8 trees of 8 nodes over the 8 prompts
    uids = list(range(20, 28))
    firsts = [int(_put_prompt(engine, uid, q).argmax()) for uid, q in zip(uids, prompts)]
    trees = [TokenTree([f] + [(f + j) % cfg.vocab_size for j in range(1, SPEC_TREE_NODES)],
                       [-1, 0, 0, 1, 1, 2, 2, 3]) for f in firsts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine.verify_tree(uids, trees, greedy=True)
    torch.cuda.synchronize()
    res["full_width_verify_tree"] = dict(
        sequences=len(uids), nodes=len(uids) * SPEC_TREE_NODES, max_context=max(len(q) for q in prompts) + 8,
        ms=1e3 * (time.perf_counter() - t0),
        peak_extra_mib=(torch.cuda.max_memory_allocated() - base_mem) / 2**20)
    for uid in uids:
        engine.flush(uid)
    return res, served, (f32_checks, pairs)


def _tree_checks(model, dev, f32_checks, pairs, failures):
    """The engine legs' tree and compaction rows against the dense f32 model
    on each row set's own context, and each tree against its linear
    counterpart; every control must exceed the limit."""
    rows = {}
    out = {}
    with torch.no_grad():
        for name, context, got, control in f32_checks:
            got = torch.as_tensor(got, device=dev).float()
            ref = model(torch.tensor([context], device=dev))[0, -got.shape[0]:].float()
            rows[name] = got
            err = _l2_rel(got, ref)
            out[name] = err
            if control and not err > LOGITS_L2_TOL:
                failures.append(f"control {name}: within {LOGITS_L2_TOL} of f32 ({err})")
            if not control and not err <= LOGITS_L2_TOL:
                failures.append(f"{name}: {err} from f32 > {LOGITS_L2_TOL}")
    for a, b in pairs:
        err = _l2_rel(rows[a], rows[b])
        out[f"{a}_vs_{b}"] = err
        if not err <= 2 * LOGITS_L2_TOL:
            failures.append(f"{a} differs from {b} by {err} > {2 * LOGITS_L2_TOL}")
    return out


def _sampled_legs(engine, cfg, dev, prompts, model, failures):
    """Leg e: sampled decode_loop seeded by a torch.Generator, the draws'
    f32 probabilities, T -> 0 against the argmax set, and a chi-square test
    of sample_categorical on one real logits row."""
    uids = list(range(len(prompts)))
    firsts = [int(_put_prompt(engine, uid, q).argmax()) for uid, q in zip(uids, prompts)]
    rows = engine.put(uids, [[f] for f in firsts]).float()  # one real decode step's logits
    engine.flush_all()

    def draw(seed):
        for uid, q in zip(uids, prompts):
            _put_prompt(engine, uid, q)
        g = torch.Generator(device=dev).manual_seed(seed)
        toks = engine.decode_loop(uids, [[f] for f in firsts], SAMPLE_STEPS, temperature=SAMPLE_TEMPERATURE,
                                  generator=g)
        engine.flush_all()
        return toks

    a, b, c = draw(1), draw(1), draw(2)
    res = dict(same_seed_equal=bool(np.array_equal(a, b)), other_seed_differs=not np.array_equal(a, c))
    if not res["same_seed_equal"]:
        failures.append("sampled decode_loop with one generator seed gave different tokens")
    if not res["other_seed_differs"]:
        failures.append("control: sampled decode_loop with another seed gave the same tokens")

    # every draw's probability under the dense f32 model, against the floor
    draws = a.shape[0] * a.shape[1]
    floor = SAMPLE_FLOOR_ALPHA / (cfg.vocab_size * draws)
    probs, argmin_probs = [], []
    with torch.no_grad():
        for q, f, toks in zip(prompts, firsts, a):
            seq = list(q) + [f] + toks.tolist()
            logits = model(torch.tensor([seq[:-1]], device=dev))[0, len(q):].float()
            p = torch.softmax(logits / SAMPLE_TEMPERATURE, -1)
            probs.append(p[torch.arange(len(toks), device=dev), torch.tensor(toks, device=dev)].cpu())
            argmin_probs.append(p.min(-1).values.cpu())
    probs, argmin_probs = torch.cat(probs), torch.cat(argmin_probs)
    res.update(floor=floor, draws=draws, min_draw_probability=probs.min().item(),
               control_argmin_max_probability=argmin_probs.max().item())
    if not probs.min().item() >= floor:
        failures.append(f"a sampled token's f32 probability {probs.min().item()} is under the floor {floor}")
    if not argmin_probs.max().item() < floor:
        failures.append("control: a row's argmin passed the probability floor")

    # temperature -> 0: each draw is in its row's argmax set (exact, ties kept)
    g = torch.Generator(device=dev).manual_seed(3)
    cold = sample_categorical(rows, 1e-6, g)
    warm = sample_categorical(rows, 1.0, g)
    top = rows == rows.max(-1, keepdim=True).values
    in_top = lambda ids: top[torch.arange(rows.shape[0], device=dev), ids.long()]
    res.update(cold_draws_in_argmax_set=int(in_top(cold).sum()), rows=rows.shape[0],
               control_warm_draws_in_argmax_set=int(in_top(warm).sum()))
    if not bool(in_top(cold).all()):
        failures.append("a draw at temperature 1e-6 is not a greedy token of its row")
    if bool(in_top(warm).all()):
        failures.append("control: every draw at temperature 1 was a greedy token")

    # chi-square of one row's draws, binned into its 15 likeliest tokens + rest
    row = rows[0]
    order = torch.argsort(row, descending=True)[:15]
    p = torch.softmax(row.double() / SAMPLE_TEMPERATURE, -1)
    expected = torch.cat([p[order], (1 - p[order].sum())[None]]) * CHI2_DRAWS
    counts = torch.zeros(16, dtype=torch.float64, device=dev)
    rank = torch.full((row.numel(), ), 15, dtype=torch.long, device=dev)
    rank[order] = torch.arange(15, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for _ in range(CHI2_DRAWS // CHI2_CHUNK):
        ids = sample_categorical(row.expand(CHI2_CHUNK, -1), SAMPLE_TEMPERATURE, g)
        counts += torch.bincount(rank[ids.long()], minlength=16).double()
    chi2 = float(((counts - expected)**2 / expected).sum())
    control = torch.bincount(rank[sample_categorical(row.expand(CHI2_CHUNK, -1), 1.0, g).long()],
                             minlength=16).double() * (CHI2_DRAWS // CHI2_CHUNK)
    chi2_control = float(((control - expected)**2 / expected).sum())
    res.update(chi2=chi2, chi2_critical=CHI2_CRITICAL, chi2_control=chi2_control,
               top_token_probability=float(p[order[0]]))
    if not chi2 < CHI2_CRITICAL:
        failures.append(f"sample_categorical's draws fail the chi-square test: {chi2} >= {CHI2_CRITICAL}")
    if not chi2_control >= CHI2_CRITICAL:
        failures.append("control: draws at temperature 1 passed the chi-square test at the phase's temperature")
    return res


def _learned_legs(params, cfg, dev, prompts, failures):
    """Leg d: the learned drafter (a fresh Medusa head at Llama-2-7B width,
    numpy on the host, built once and loaded by both schedulers from an
    ``.npz``) and ``auto``, LEARNED_REQUESTS requests of LEARNED_NEW_TOKENS
    greedy tokens each, stepped by hand; the host ms of each draft."""
    import tempfile
    from deepspeed_tpu_torch.inference.v2.spec import MedusaDraftHead
    res, served = {}, []
    t0 = time.perf_counter()
    head = MedusaDraftHead.fresh(cfg.hidden_size, cfg.vocab_size, num_heads=1)  # what the scheduler builds
    res["head_build_s"] = time.perf_counter() - t0
    res["head_bytes"] = sum(v.nbytes for p in head.params for v in p.values())
    tmp = tempfile.TemporaryDirectory(prefix="dstt_heads_")
    path = os.path.join(tmp.name, "heads.npz")
    head.save(path)
    del head
    for drafter in ("learned", "auto"):
        engine = _engine(params, cfg, None, dev)
        t0 = time.perf_counter()
        sched = ServingScheduler(engine, ServingConfig(speculative=SpeculativeConfig(
            enabled=True, drafter=drafter, draft_head_path=path)), start=False)
        build_s = time.perf_counter() - t0
        draft_s = []
        _timed(sched._learned, "draft_tree", draft_s)
        log_ = _DispatchLog(sched)
        reqs = [sched.submit(q, max_new_tokens=LEARNED_NEW_TOKENS) for q in prompts[:LEARNED_REQUESTS]]
        while not all(r.finished for r in reqs):
            sched.step()
        counters = sched.stats()["counters"]
        sched.stop(drain=False)
        log_.unwrap(sched)
        served += [(q, r.result(timeout=1)) for q, r in zip(prompts, reqs)]
        res[drafter] = dict(head_load_s=build_s, drafts=len(draft_s),
                            host_ms_per_draft=1e3 * statistics.median(draft_s) if draft_s else None,
                            verify_tree_dispatches=len(log_.verify_trees), tree_nodes=counters["spec_tree_nodes"],
                            drafted=counters["spec_drafted"], accepted=counters["spec_accepted"],
                            switches=counters["spec_drafter_switches"],
                            pool_whole_after_stop=engine.free_blocks == engine._state_manager.kv_cache.num_blocks)
        if not log_.verify_trees or not draft_s:
            failures.append(f"the {drafter} drafter ran no tree verify or no draft")
        if not res[drafter]["pool_whole_after_stop"]:
            failures.append(f"KV blocks still held after the {drafter} leg")
        del engine, sched
        gc.collect()
        torch.cuda.empty_cache()
    tmp.cleanup()
    return res, served


def _spec_handoff(params, cfg, dev, prompt, failures):
    """Leg f: a request drafting on engine A (from the prefix trie, which the
    same prompt served whole just filled) is handed off to engine B: B's
    scheduler adopts ``extra["spec"]`` (the acceptance EWMA, the drafted and
    accepted counts) before any step; a frame stripped of it (the control)
    adopts nothing. Returns the continuation and the request served whole
    on A, for the teacher-forced check."""
    from deepspeed_tpu_torch.inference.v2.ragged import handoff
    spec = SpeculativeConfig(enabled=True)
    engine_a = _engine(params, cfg, None, dev)
    sched_a = ServingScheduler(engine_a, ServingConfig(speculative=spec, prefix_cache=PrefixCacheConfig(enabled=True)),
                               start=False)
    whole = sched_a.submit(prompt, max_new_tokens=NEW_TOKENS)  # publishes: the head then drafts from the trie
    while not whole.finished:
        sched_a.step()
    head = sched_a.submit(prompt, max_new_tokens=NEW_TOKENS // 2, handoff=True)
    while not head.finished:
        sched_a.step()
    sched_a.stop(drain=False)
    del engine_a, sched_a
    gc.collect()
    torch.cuda.empty_cache()
    frame = head.handoff_payload
    header, kv = handoff.unpack(frame)
    stripped = handoff._frame(dict(header, extra={k: v for k, v in header["extra"].items() if k != "spec"}),
                              bytes(frame[len(frame) - kv.numel() * kv.element_size():]))
    engine_b = _engine(params, cfg, None, dev)
    sched_b = ServingScheduler(engine_b, ServingConfig(speculative=spec), start=False)
    state = lambda r: (r._spec_ewma, r.spec_drafted, r.spec_accepted, r.decode_steps)
    tail = sched_b.submit_resume(frame, max_new_tokens=NEW_TOKENS - NEW_TOKENS // 2)
    adopted = state(tail) == state(head)
    bare = sched_b.submit_resume(stripped, max_new_tokens=1)
    while not (tail.finished and bare.finished):
        sched_b.step()
    sched_b.stop(drain=False)
    res = dict(donor_spec=header["extra"].get("spec"), adopted=adopted, control_adopted=state(bare) == state(head),
               continuation_tokens_equal_whole=head.tokens + tail.tokens == whole.tokens,
               pool_whole_after_stop=engine_b.free_blocks == engine_b._state_manager.kv_cache.num_blocks)
    if not head.spec_drafted:
        failures.append("the handed-off request drafted nothing on engine A")
    if not adopted:
        failures.append(f"engine B did not adopt the donor's drafter state: {state(tail)} != {state(head)}")
    if res["control_adopted"]:
        failures.append("control: a frame without extra['spec'] passed the adoption check")
    del engine_b, sched_b
    gc.collect()
    torch.cuda.empty_cache()
    return res, [(prompt, head.tokens + tail.tokens), (prompt, whole.tokens)]


def run_spec_path(dev, params, main) -> dict:
    """Speculative decoding on Llama-2-7B under the ported scheduler and
    server: the engine's verify, verify_tree, rollback and compaction (with
    the stale-slot checks through B1 and the gather branch), the
    prompt-lookup drafter over HTTP with a 24-token draft budget (B1) and
    the default one (gather), an oracle drafter, the learned drafter and
    auto, sampled decode_loop and a handoff that carries the drafter state.
    Every served greedy token is held to the dense f32 model
    (teacher-forced); every check has a control it rejects."""
    t_start = time.perf_counter()
    cfg = serve_config()
    rng = np.random.default_rng(9)
    prompts = _spec_prompts(cfg, rng)
    err = max(main["logits_max_abs_err_kernel_vs_f32"], main["logits_max_abs_err_gather_vs_f32"])
    tol = TF_SLACK * err
    failures, parts, served = [], {}, []

    t0 = time.perf_counter()
    engine = _engine(params, cfg, None, dev)
    res, more, (f32_checks, pairs) = _engine_legs(engine, cfg, prompts, failures)
    served += more
    parts["engine_legs"] = time.perf_counter() - t0

    # --- b: over HTTP with the prefix cache, twice (the second pass drafts
    # from the trie): spec-off, prompt lookup at a 24-token budget (B1) and
    # at the default budget (gather); c: an oracle drafter, one at a time
    t0 = time.perf_counter()
    legs = {}
    for name, spec in (("spec_off", None),
                       ("lookup_b1", SpeculativeConfig(enabled=True, draft_token_budget=SPEC_B1_BUDGET)),
                       ("lookup_gather", SpeculativeConfig(enabled=True))):
        (cold_tokens, cold), (warm_tokens, warm) = _serve_spec(params, cfg, dev, prompts, spec, passes=2)
        legs[name] = warm_tokens
        res[name] = dict(warm, cold=cold)
        served += list(zip(prompts, cold_tokens)) + list(zip(prompts, warm_tokens))
    seq_prompts = prompts[::2]  # one at a time: half the prompts keep the phase short
    ((seq_off_tokens, seq_off), ) = _serve_spec(params, cfg, dev, seq_prompts, None, sequential=True)
    ((oracle_tokens, oracle), ) = _serve_spec(params, cfg, dev, seq_prompts, SpeculativeConfig(enabled=True),
                                              oracle=_OracleDrafter(seq_prompts, seq_off_tokens), sequential=True)
    ((_, wrong), ) = _serve_spec(params, cfg, dev, seq_prompts[:SPEC_CONTROL_PROMPTS], SpeculativeConfig(enabled=True),
                                 oracle=_OracleDrafter(seq_prompts, seq_off_tokens, skip=1), sequential=True)
    res["spec_off_sequential"], res["oracle"], res["control_wrong_oracle"] = seq_off, oracle, wrong
    served += list(zip(seq_prompts, seq_off_tokens)) + list(zip(seq_prompts, oracle_tokens))
    legs["oracle"] = oracle_tokens
    parts["served_legs"] = time.perf_counter() - t0
    for name in legs:
        leg = res[name]
        ref = legs["spec_off"] if name != "oracle" else seq_off_tokens
        leg["tokens_agreeing_with_spec_off"] = sum(a == b for t, o in zip(legs[name], ref) for a, b in zip(t, o))
        if not leg["pool_whole_after_stop"]:
            failures.append(f"{name}: KV blocks still held after stop")
    b1 = res["lookup_b1"]
    if not (b1["verify_dispatches"] and all(n > 0 for n in b1["b1_launches_per_verify"])
            and max(b1["verify_tokens"]) <= 32):
        failures.append(f"B1 was not launched in every verify tick of the budget-{SPEC_B1_BUDGET} leg: "
                        f"{b1['b1_launches_per_verify']} (tokens {b1['verify_tokens']})")
    gather = res["lookup_gather"]
    wide = [n for n, t in zip(gather["b1_launches_per_verify"], gather["verify_tokens"]) if t > 32]
    if not wide or any(wide):  # the default budget's wide feeds take the gather branch
        failures.append(f"the default-budget leg's verifies wider than 32 tokens launched B1 {wide} "
                        f"(tokens {gather['verify_tokens']})")
    # the oracle: acceptance over 0.9, and its decode dispatches (every one a
    # verify) at most half of spec-off's; the control drafts the wrong tokens
    for leg, control in ((oracle, False), (wrong, True)):
        off_ticks = sum(seq_off["decode_steps"][:len(leg["decode_steps"])])
        ok = (leg["acceptance"] or 0) > 0.9 and leg["decode_ticks"] <= off_ticks / 2
        if ok == control:
            failures.append(f"{'control: the wrong-token oracle' if control else 'the oracle drafter'}: acceptance "
                            f"{leg['acceptance']}, {leg['decode_ticks']} decode dispatches against spec-off's "
                            f"{off_ticks}")

    # --- d: the learned drafter and auto
    t0 = time.perf_counter()
    res["learned"], more = _learned_legs(params, cfg, dev, prompts, failures)
    served += more
    parts["learned_legs"] = time.perf_counter() - t0

    # --- f: handoff with drafter state
    t0 = time.perf_counter()
    res["handoff"], more = _spec_handoff(params, cfg, dev, prompts[5], failures)
    served += more
    parts["handoff"] = time.perf_counter() - t0

    # --- e: sampled decode_loop, and every served greedy token teacher-forced
    t0 = time.perf_counter()
    model = _dense_f32(params, cfg)
    res["sampled"] = _sampled_legs(engine, cfg, dev, prompts, model, failures)
    res["tree"] = _tree_checks(model, dev, f32_checks, pairs, failures)
    del engine
    gc.collect()
    parts["sampled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unique = list({(tuple(p), tuple(t)): (p, t) for p, t in served}.values())
    gaps = _teacher_forced(model, dev, unique)
    shifted = _teacher_forced(model, dev, [(p, t[1:] + t[:1]) for p, t in unique[:4]])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["teacher_forced"] = dict(tolerance=tol, sequences=len(unique), tokens=int(gaps.numel()),
                                 max_gap=gaps.max().item(), max_gap_over_tol=gaps.max().item() / tol,
                                 control_max_gap=shifted.max().item())
    if not gaps.max().item() <= tol:
        failures.append(f"a served token's f32 logit trails its row's maximum by {gaps.max().item()} > {tol}")
    if not shifted.max().item() > tol:
        failures.append("control: the shifted tokens passed the teacher-forced check")
    parts["teacher_forced"] = time.perf_counter() - t0
    res["seconds_by_part"] = parts
    res["seconds"] = time.perf_counter() - t_start
    res["failures"] = failures
    res["b1_launches"] = b1["b1_launches"]
    log("[spec] " + json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "counters"} if isinstance(v, dict) else v)
                                for k, v in res.items()}))
    for name in ("spec_off", "lookup_b1", "lookup_gather", "spec_off_sequential", "oracle"):
        leg = res[name]
        log(f"[spec] {name}: TTFT p50 {leg['ttft_p50_s'] * 1e3:.1f} ms, ITL p50 {leg['itl_p50_s'] * 1e3:.1f} ms, "
            f"{leg['served_tokens_per_s']:.1f} tokens/s; decode ticks {leg['decode_ticks']}, verify dispatches "
            f"{leg['verify_dispatches']}; drafted {leg['drafted']} accepted {leg['accepted']} rolled back "
            f"{leg['rolled_back']}; {leg['tokens_per_decode_tick']:.2f} tokens a decode tick; B1 "
            f"{leg['b1_launches']}; {leg.get('tokens_agreeing_with_spec_off')} tokens agree with spec-off")
    fw = res["full_width_verify_tree"]
    log(f"[spec] full-width verify_tree ({fw['nodes']} nodes): {fw['ms']:.1f} ms, peak +{fw['peak_extra_mib']:.0f} MiB; "
        f"learned drafter {res['learned']['learned']['host_ms_per_draft']} host ms a draft")
    log(card_line())
    if failures:
        raise AssertionError("speculative phase: " + "; ".join(failures))
    return res


# ----------------------------------------------------------------- phase 8 --
# observability: the per-layer tracer, the cost plane and the SLO engine on
# Llama-2-7B. OBSERVE_DECODE_PUTS decode puts of the 8 main-path requests (8
# tokens each: B1) with tracing off and on, then OBSERVE_PROFILED_PUTS more
# under torch.profiler, one at a time, the last of them the control (its end
# events recorded at phase entry). The cost plane serves OBSERVE_COST_PROMPTS
# tiled-pattern prompts twice over HTTP (the second wave hits the prefix
# cache) with prompt lookup at a B1-sized draft budget, across three tenants.
# The SLO leg serves a burst under an ITL objective of SLO_ITL_TARGET_S, which
# no decode put on the card meets, with overload.slo_pressure; its control
# objective is SLO_CONTROL_TARGET_S.
OBSERVE_DECODE_PUTS = 8
OBSERVE_PROFILED_PUTS = 3  # two held to the profiler and the wall, then the control
OBSERVE_PREFILL = 2048  # the engine-level prefill put whose observed seconds the profiler bounds
OBSERVE_COST_PROMPTS = 6
OBSERVE_NEW_TOKENS = 16
OBSERVE_TENANTS = (("header", "acme"), ("json", "globex"), ("none", "default"))
SLO_ITL_TARGET_S, SLO_CONTROL_TARGET_S = 0.001, 10.0
SLO_INTERVAL_S = 0.1
SLO_TAIL_S = 1.0  # /v1/stats read on after the burst: the breach outlives it by the fast window
PHASE_NAMES = ("embed", "attn", "ffn", "unembed")


class _CudaCalls:
    """Counts, while armed, every CUDA event constructed and every wait
    (``torch.cuda.synchronize``, an event's or a stream's ``synchronize``)."""

    def __init__(self):
        self.armed, self.events, self.waits = False, 0, 0
        self._saved = []
        calls, real_event = self, torch.cuda.Event

        class Event(real_event):

            def __new__(cls, *a, **k):
                if calls.armed:
                    calls.events += 1
                return super().__new__(cls, *a, **k)

            def synchronize(self):
                if calls.armed:
                    calls.waits += 1
                return super().synchronize()

        def counted(inner):

            def call(*a, **k):
                if calls.armed:
                    calls.waits += 1
                return inner(*a, **k)

            return call

        for owner, name, value in ((torch.cuda, "Event", Event),
                                   (torch.cuda, "synchronize", counted(torch.cuda.synchronize)),
                                   (torch.cuda.Stream, "synchronize", counted(torch.cuda.Stream.synchronize))):
            self._saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, value)

    def restore(self):
        for owner, name, value in self._saved:
            setattr(owner, name, value)


def _synced(fn):
    """``fn()``'s result and its host microseconds between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e6


def _profiled(fn, host=True):
    """``fn()`` under torch.profiler: its result, the device time of its
    kernels in microseconds (copies and memsets left out: the traced forward
    times kernels) and its synchronized host microseconds. ``host`` False
    traces the card's activity alone: the profiler then records no host op,
    so the launches keep about their unprofiled pace."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        activities.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=activities) as prof:
        out, wall_us = _synced(fn)
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.lower().startswith(("memcpy", "memset")))
    return out, device_us, wall_us


def _phase_us(s):
    return s.embed + s.unembed + sum(row[0] + row[1] for row in s.record_exec_times)


def _decode_puts(engine, first, n, wrap=None):
    """``n`` greedy decode puts of the 8 sequences from ``first``: per put
    its tokens, logits, synchronized host microseconds and B1 launches
    (``wrap(fn)`` replaces the synchronized timer)."""
    uids = list(range(len(first)))
    nxt, rows = list(first), []
    for _ in range(n):
        before = pa.paged_attention_update.launches
        feed = [[t] for t in nxt]
        out = (wrap or _synced)(lambda: engine.put(uids, feed))
        logits = out[0]
        nxt = logits.argmax(-1).tolist()
        rows.append(dict(tokens=nxt, logits=logits, launches=pa.paged_attention_update.launches - before,
                         timing=out[1:]))
    return rows


def _end_at_entry(name):
    """Control for the tracer: ``record`` with the end event recorded when
    the phase is entered, so every phase reads about zero."""
    from deepspeed_tpu_torch.inference.v2 import tracer as tracer_mod

    @contextlib.contextmanager
    def record(phase):
        tracer = tracer_mod.get_tracer()
        start = tracer_mod._timing_event()
        tracer.add_events(phase, start, tracer_mod._timing_event())
        yield

    return record


def _tracer_leg(params, cfg, dev, failures) -> dict:
    """The same 8 requests through an untraced engine and a traced one:
    prefill (the gather branch), OBSERVE_DECODE_PUTS decode puts of 8 tokens
    (B1), then OBSERVE_PROFILED_PUTS profiled puts on the traced engine."""
    from deepspeed_tpu_torch.inference.v2 import tracer as tracer_mod
    from deepspeed_tpu_torch.inference.v2.model_implementations import llama_v2

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    first = [int(t) for t in rng.integers(0, cfg.vocab_size, len(prompts))]
    n_puts = OBSERVE_DECODE_PUTS + OBSERVE_PROFILED_PUTS
    res = {}

    # untraced: no CUDA event, no wait inside a put
    engine = _engine(params, cfg, None, dev)
    _prefill(engine, prompts)
    calls = _CudaCalls()
    armed_put = engine.put

    def put(*a, **k):
        calls.armed = True
        try:
            return armed_put(*a, **k)
        finally:
            calls.armed = False

    engine.put = put
    try:
        plain = _decode_puts(engine, first, n_puts)
    finally:
        calls.restore()
    del engine.put
    res["untraced_events_and_waits_in_decode_puts"] = [calls.events, calls.waits]
    if calls.events or calls.waits:
        failures.append(f"untraced decode puts created {calls.events} CUDA events and {calls.waits} waits")
    res["untraced_decode_put_ms"] = [r["timing"][0] / 1e3 for r in plain[:OBSERVE_DECODE_PUTS]]
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # the engine-level dispatch timing: an observer's seconds for a
    # OBSERVE_PREFILL-token prefill put against the profiler's device time;
    # control: the end time taken before the wait. Without the wait the put
    # returns once its last launch is queued, so the check tells the two
    # apart only while the device runs behind the host: at 768 tokens a
    # kernel took about as long as its launch and the control read 0.79 and
    # 1.01 of the device time in two H100 runs; OBSERVE_PREFILL tokens make
    # each kernel several times longer (its own engine: the token budget)
    engine = _engine(params, cfg, None, dev, max_ragged_batch_size=OBSERVE_PREFILL)
    seen = []
    engine.dispatch_observer = lambda kind, n_seqs, n_tokens, s: seen.append(s)
    long_prompt = rng.integers(0, cfg.vocab_size, OBSERVE_PREFILL).tolist()
    prefill = {}
    for label, uid in (("observed", 100), ("control_end_before_wait", 101)):
        if label.startswith("control"):
            engine._wait_for_device = lambda: None
        _, device_us, wall_us = _profiled(lambda: engine.put([uid], [long_prompt]), host=False)
        prefill[label] = dict(observed_s=seen[-1], profiler_device_s=device_us / 1e6, wall_s=wall_us / 1e6)
        ok = seen[-1] >= device_us / 1e6
        if ok == label.startswith("control"):
            failures.append(f"{label}: a {OBSERVE_PREFILL}-token prefill put observed {seen[-1]:.6f} s against the "
                            f"profiler's {device_us / 1e6:.6f} s of device time")
    res["prefill_put_dispatch_timing"] = prefill
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # traced, with an engine-owned telemetry session for the spans
    ecfg = RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(max_context=MAX_CONTEXT, memory_config=MemoryConfig(size=KV_BYTES)),
        kv_block_size=BLOCK, trace_enabled=True, telemetry={"enabled": True})
    engine = build_engine(params, cfg, ecfg, device=dev)
    _prefill(engine, prompts)
    traced = _decode_puts(engine, first, OBSERVE_DECODE_PUTS)
    traced += _decode_puts(engine, traced[-1]["tokens"], OBSERVE_PROFILED_PUTS - 1, wrap=_profiled)
    saved = llama_v2.record
    llama_v2.record = transformer_base.record = _end_at_entry("control")
    try:
        traced += _decode_puts(engine, traced[-1]["tokens"], 1, wrap=_profiled)
    finally:
        llama_v2.record = transformer_base.record = saved
    summaries = engine.tracer.drain_summaries()
    n_prefill = len(summaries) - n_puts
    decode = summaries[n_prefill:]
    layers = cfg.num_hidden_layers
    res["prefill_puts"] = n_prefill
    for i, (s, r) in enumerate(zip(decode, traced)):
        label = "control" if i == n_puts - 1 else f"decode put {i}"
        if i < n_puts - 1:
            if not (len(s.record_exec_times) == layers and s.embed > 0 and s.unembed > 0
                    and all(row[0] > 0 and row[1] > 0 for row in s.record_exec_times)):
                failures.append(f"{label}: a phase of the summary is not timed")
            if r["launches"] != 2 * layers:
                failures.append(f"{label}: B1 launched {r['launches']} times, not {2 * layers}")
        if len(r["timing"]) == 2:  # profiled: device time <= the phases <= the host wall
            device_us, wall_us = r["timing"]
            total = _phase_us(s)
            ok = device_us <= total <= wall_us
            res.setdefault("profiled_puts", []).append(dict(label=label, phases_ms=total / 1e3,
                                                            profiler_device_ms=device_us / 1e3,
                                                            wall_ms=wall_us / 1e3))
            if ok == (label == "control"):
                failures.append(f"{label}: the phases sum to {total} us against the profiler's {device_us} us of "
                                f"device time and the synchronized {wall_us:.0f} us on the host")
    if [r["tokens"] for r in traced] != [r["tokens"] for r in plain]:
        failures.append("traced greedy tokens differ from untraced ones")
    res["traced_logits_bitwise_equal_untraced"] = all(torch.equal(_bits(a["logits"]), _bits(b["logits"]))
                                                      for a, b in zip(traced, plain))
    # the per-layer split of a decode put (the unprofiled ones)
    unprofiled = decode[:OBSERVE_DECODE_PUTS]
    attn = [sum(row[0] for row in s.record_exec_times) / 1e3 for s in unprofiled]
    ffn = [sum(row[1] for row in s.record_exec_times) / 1e3 for s in unprofiled]
    traced_ms = [r["timing"][0] / 1e3 for r in traced[:OBSERVE_DECODE_PUTS]]
    res["decode_put_split"] = dict(
        puts=len(unprofiled), tokens_per_put=len(prompts), attn_ms=statistics.median(attn),
        ffn_ms=statistics.median(ffn), embed_ms=statistics.median(s.embed / 1e3 for s in unprofiled),
        unembed_ms=statistics.median(s.unembed / 1e3 for s in unprofiled),
        phases_ms=statistics.median(_phase_us(s) / 1e3 for s in unprofiled),
        attn_ms_per_layer=statistics.median(attn) / layers, ffn_ms_per_layer=statistics.median(ffn) / layers,
        traced_put_ms=statistics.median(traced_ms), untraced_put_ms=statistics.median(res["untraced_decode_put_ms"]))
    split = res["decode_put_split"]
    split["attn_share"] = split["attn_ms"] / split["phases_ms"]
    split["tracing_overhead_ms_per_put"] = split["traced_put_ms"] - split["untraced_put_ms"]
    # the Chrome trace: 2 x layers + 2 phase spans a traced put, each with
    # the put's uids, ordered and apart within a batch
    os.makedirs("chiprun_out", exist_ok=True)
    path = engine._telemetry.spans.export_chrome_trace(os.path.join("chiprun_out", "observe_trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "inference" and e["name"] in PHASE_NAMES]
    res["trace_spans"] = len(events)
    for s in summaries:
        mine = sorted((e for e in events if e["args"]["batch_id"] == s.batch_id), key=lambda e: e["ts"])
        if len(mine) != 2 * layers + 2 or any(e["args"]["uids"] != s.uids for e in mine):
            failures.append(f"batch {s.batch_id}: {len(mine)} phase spans, uids {[e['args']['uids'] for e in mine[:1]]}"
                            f" against {s.uids}")
        elif any(a["ts"] + a["dur"] > b["ts"] for a, b in zip(mine, mine[1:])):
            failures.append(f"batch {s.batch_id}: phase spans overlap")
    engine.close()
    if tracer_mod.get_tracer() is not None:
        failures.append("close() left the tracer registered")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _post_tenant(url, body, how, tenant, out, key):
    """POST /v1/generate with the tenant in the header, in the JSON body, or
    not at all."""
    headers = {"Content-Type": "application/json"}
    if how == "header":
        headers["X-DSTPU-Tenant"] = tenant
    elif how == "json":
        body = dict(body, tenant=tenant)
    status, _, raw = _exchange(url + "/v1/generate", "POST", json.dumps(body).encode(), headers)
    out[key] = dict(status=status, doc=json.loads(raw))


def _ledger_numbers(ledger):
    """The ledger's own (unrounded) numbers: per tenant and for the
    aggregate, its integer fields and its seconds."""

    def numbers(c):
        ints = dict(**{f"tokens.{p}": n for p, n in c.tokens.items()}, drafted=c.drafted_tokens,
                    accepted=c.accepted_tokens, saved_prefix=c.saved_prefix_tokens,
                    saved_spec=c.saved_spec_tokens, requests=c.requests,
                    **{f"wire.{k}": v for k, v in c.wire_bytes.items()})
        secs = dict(device=c.device_seconds, amnesty=c.amnesty_seconds,
                    **{f"kv.{k}": v for k, v in c.kv_block_seconds.items()})
        return dict(ints=ints, secs=secs)

    return dict(tenants={t: numbers(c) for t, c in ledger.tenants.items()}, totals=numbers(ledger.totals))


def _conservation_failures(numbers, observed):
    """The usage invariants: every integer field over the tenants equals the
    aggregate, the seconds within 1e-9 relative, and the billed device
    seconds plus the amnesty equal the observed dispatch seconds."""
    out = []
    rows, totals = numbers["tenants"].values(), numbers["totals"]
    for key, want in totals["ints"].items():
        got = sum(r["ints"].get(key, 0) for r in rows)
        if got != want:
            out.append(f"{key}: tenants sum to {got}, the aggregate says {want}")
    for key, want in totals["secs"].items():
        got = sum(r["secs"].get(key, 0.0) for r in rows)
        if abs(got - want) > 1e-9 * max(abs(want), 1e-12):
            out.append(f"{key} seconds: tenants sum to {got!r}, the aggregate says {want!r}")
    billed = totals["secs"]["device"] + totals["secs"]["amnesty"]
    if abs(billed - sum(observed)) > 1e-9 * sum(observed):
        out.append(f"billed {billed!r} s (device + amnesty) against {sum(observed)!r} s observed")
    return out


def _cost_leg(params, cfg, dev, failures) -> dict:
    """OBSERVE_COST_PROMPTS tiled-pattern prompts over HTTP, twice (the second
    wave hits the prefix cache), with prompt lookup at a B1-sized budget,
    billed to three tenants; then the usage, stats and final documents."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.perf.observed import PerfObservedLedger, _bucket

    session = telemetry.configure({"enabled": True})
    engine = _engine(params, cfg, None, dev)
    sched = ServingScheduler(engine, ServingConfig(queue_capacity=64, prefix_cache=PrefixCacheConfig(enabled=True),
                                                   speculative=SpeculativeConfig(enabled=True,
                                                                                 draft_token_budget=SPEC_B1_BUDGET)))
    observed, sights = [], []
    inner = engine.dispatch_observer

    def observer(kind, n_seqs, n_tokens, seconds):
        observed.append(seconds)
        sights.append((kind, n_seqs, n_tokens))
        inner(kind, n_seqs, n_tokens, seconds)

    engine.dispatch_observer = observer
    server = ServingServer(sched, host="127.0.0.1", port=0).start()
    prompts = _spec_prompts(cfg, np.random.default_rng(10))[:OBSERVE_COST_PROMPTS]
    res, finals = {}, []
    try:
        for wave in range(2):
            out, threads = {}, []
            for i, q in enumerate(prompts):
                how, tenant = OBSERVE_TENANTS[i % len(OBSERVE_TENANTS)]
                t = threading.Thread(target=_post_tenant, daemon=True,
                                     args=(server.url, dict(prompt=q, max_new_tokens=OBSERVE_NEW_TOKENS), how, tenant,
                                           out, i))
                t.start()
                threads.append(t)
            for t in threads:
                t.join(timeout=600)
            if len(out) != len(prompts) or any(v["status"] != 200 for v in out.values()):
                raise AssertionError(f"cost-plane requests failed: {out}")
            finals += [out[i]["doc"] for i in range(len(prompts))]
        _, _, usage_raw = _exchange(server.url + "/v1/usage")
        _, _, stats_raw = _exchange(server.url + "/v1/stats")
    finally:
        server.stop()
        sched.stop(drain=False)
    usage, stats = json.loads(usage_raw), json.loads(stats_raw)
    ledger = sched._ledger
    tenants = usage["tenants"]
    res.update(tenants=sorted(tenants), totals=usage["totals"], pricing=usage["pricing"], dispatches=len(observed),
               observed_s=sum(observed))
    if sorted(tenants) != sorted(t for _, t in OBSERVE_TENANTS):
        failures.append(f"tenants billed: {sorted(tenants)}")
    totals = usage["totals"]
    if not (totals["saved_tokens"]["prefix"] > 0 and totals["speculative"]["drafted"] > 0):
        failures.append(f"no prefix hit or no draft was charged: {totals['saved_tokens']}, {totals['speculative']}")
    # the JSON document's integer fields, exactly
    for key in ("prefill", "decode", "verify", "tree_verify", "billed"):
        if sum(t["tokens"][key] for t in tenants.values()) != totals["tokens"][key]:
            failures.append(f"/v1/usage tokens.{key} do not sum over the tenants")
    numbers = _ledger_numbers(ledger)
    res["conservation_failures"] = _conservation_failures(numbers, observed)
    failures += res["conservation_failures"]
    # control: the same numbers with one decode charge of one tenant dropped
    # (its token and its share of a dispatch's seconds)
    dropped = copy.deepcopy(numbers)
    row = dropped["tenants"]["acme"]
    row["ints"]["tokens.decode"] -= 1
    row["secs"]["device"] -= next(s for s in observed if s > 0) / len(prompts)
    res["control_dropped_charge_failures"] = _conservation_failures(dropped, observed)
    if not res["control_dropped_charge_failures"]:
        failures.append("control: a usage ledger with one charge dropped passed the conservation check")
    # each request's final bill folds into its tenant
    by_tenant = {}
    for doc in finals:
        cost = doc["cost"]
        acc = by_tenant.setdefault(doc["tenant"], dict(tokens={}, device_seconds=0.0, requests=0))
        for k, v in cost["tokens"].items():
            acc["tokens"][k] = acc["tokens"].get(k, 0) + v
        acc["device_seconds"] += cost["device_seconds"]
        acc["requests"] += 1
    for tenant, acc in by_tenant.items():
        row = tenants[tenant]
        if acc["tokens"] != row["tokens"] or acc["requests"] != row["requests"] or \
                abs(acc["device_seconds"] - row["device_seconds"]) > 1e-6 * (acc["requests"] + 1):
            failures.append(f"tenant {tenant}: the final documents' costs do not fold into its usage row")
    # the perf block: the H100 row; each (program, bucket) first seen amnestied
    perf = stats["perf"]
    counts = {}
    for kind, n_seqs, n_tokens in sights:
        key = (PerfObservedLedger.program_for(kind, n_seqs, n_tokens), _bucket(n_tokens))
        counts[key] = counts.get(key, 0) + 1
    rows = {(r["program"], r["bucket"]): r for r in perf["programs"]}
    if perf["chip"] != "h100" or set(rows) != set(counts) or \
            any(rows[k]["dispatches"] != n - 1 for k, n in counts.items()):
        failures.append(f"perf block: chip {perf['chip']}, rows {sorted(rows)} against sights {counts}")
    res["perf"] = perf
    res["request_cost_example"] = finals[-1]["cost"]
    session.close()
    del engine, sched, server, ledger, dropped
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _slo_burst(params, cfg, dev, target_s) -> dict:
    """A burst of the 8 main-path prompts over HTTP with ``slo_pressure``
    under an ITL objective of ``target_s``; /v1/stats read every
    SLO_INTERVAL_S while it runs and for SLO_TAIL_S after."""
    from deepspeed_tpu_torch import telemetry

    objective = dict(name="itl", metric="itl", target_s=target_s, target_ratio=0.99, fast_window_s=1.0,
                     slow_window_s=3.0, burn_threshold=2.0)
    session = telemetry.configure({"enabled": True, "timeseries": {"enabled": True, "interval_s": SLO_INTERVAL_S},
                                   "slo": {"enabled": True, "objectives": [objective]}})
    engine = _engine(params, cfg, None, dev)
    sched = ServingScheduler(engine, ServingConfig(queue_capacity=64, overload=dict(slo_pressure=True)))
    server = ServingServer(sched, host="127.0.0.1", port=0).start()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    samples, out = [], {}
    try:
        threads = [threading.Thread(target=_http_generate, daemon=True,
                                    args=(server.url, dict(prompt=p, max_new_tokens=NEW_TOKENS), False, out, i))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        burst_end = None
        while burst_end is None or time.perf_counter() < burst_end + SLO_TAIL_S:
            _, _, raw = _exchange(server.url + "/v1/stats")
            doc = json.loads(raw)
            samples.append((doc["overload"]["brownout_stage"], bool(doc["slo"] and doc["slo"]["in_breach"]),
                            burst_end is None))
            if burst_end is None and not any(t.is_alive() for t in threads):
                burst_end = time.perf_counter()
            time.sleep(SLO_INTERVAL_S)
        for t in threads:
            t.join(timeout=600)
        _, _, raw = _exchange(server.url + "/v1/stats")
        final = json.loads(raw)
    finally:
        server.stop()
        sched.stop(drain=False)
        session.close()
    if len(out) != len(prompts) or any(v.get("status") != 200 for v in out.values()):
        raise AssertionError(f"SLO burst requests failed: {out}")
    del engine, sched, server
    gc.collect()
    torch.cuda.empty_cache()
    return dict(target_s=target_s, max_stage=max(s for s, _, _ in samples),
                max_stage_during_burst=max(s for s, _, during in samples if during),
                breached=any(b for _, b, _ in samples), breached_during_burst=any(b for _, b, d in samples if d),
                stats_reads=len(samples), slo=final["slo"],
                itl_p50_s=(final["latency"] or {}).get("itl_s", {}).get("p50"),
                timeseries_ticks=(final["timeseries"] or {}).get("ticks"))


def run_observe_path(dev, params, main) -> dict:
    """The per-layer tracer, the cost plane and the SLO engine on Llama-2-7B:
    traced decode puts through B1 held to the profiler and the host wall
    (bitwise the untraced tokens), billing over HTTP across three tenants
    with a prefix hit and prompt lookup (conserved, amnesty included), and an
    SLO breach that lifts the brownout stage; every check has a control that
    fails it."""
    t_start = time.perf_counter()
    cfg = serve_config()
    failures, parts = [], {}
    pa.paged_attention_update.launches = 0
    t0 = time.perf_counter()
    res = dict(tracer=_tracer_leg(params, cfg, dev, failures))
    parts["tracer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["cost"] = _cost_leg(params, cfg, dev, failures)
    parts["cost"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["slo"] = _slo_burst(params, cfg, dev, SLO_ITL_TARGET_S)
    res["slo_control"] = _slo_burst(params, cfg, dev, SLO_CONTROL_TARGET_S)
    parts["slo"] = time.perf_counter() - t0
    if not (res["slo"]["breached"] and res["slo"]["max_stage"] >= 1):
        failures.append(f"an ITL objective of {SLO_ITL_TARGET_S} s did not breach and lift brownout: {res['slo']}")
    if res["slo_control"]["breached"] or res["slo_control"]["max_stage"] != 0:
        failures.append(f"control: an ITL objective of {SLO_CONTROL_TARGET_S} s breached: {res['slo_control']}")
    res["b1_launches"] = pa.paged_attention_update.launches
    # the analytic price (a weight read per token) against the card
    book = res["cost"]["pricing"]
    prefill = res["tracer"]["prefill_put_dispatch_timing"]["observed"]
    predicted = OBSERVE_PREFILL * book["bytes_per_token"] / HBM_BYTES_PER_S
    res["pricebook_vs_card"] = dict(prefill_tokens=OBSERVE_PREFILL, predicted_s=predicted,
                                    observed_s=prefill["observed_s"], ratio=prefill["observed_s"] / predicted,
                                    main_path_ms_per_decode_step=main["ms_per_decode_step"])
    res["seconds_by_part"] = parts
    res["seconds"] = time.perf_counter() - t_start
    res["failures"] = failures
    split = res["tracer"]["decode_put_split"]
    log("[observe] " + json.dumps(res, default=str))
    log(f"[observe] traced decode put of 8 tokens: attn {split['attn_ms']:.2f} ms, ffn {split['ffn_ms']:.2f} ms, "
        f"embed {split['embed_ms']:.3f} ms, unembed {split['unembed_ms']:.3f} ms (phases {split['phases_ms']:.2f} ms; "
        f"put {split['traced_put_ms']:.2f} ms traced, {split['untraced_put_ms']:.2f} ms untraced); "
        f"B1 {res['b1_launches']} launches in the phase")
    log(card_line())
    if failures:
        raise AssertionError("observe phase: " + "; ".join(failures))
    return res


# ------------------------------------------------------------ fleet phase --
# the fleet (ROADMAP A6) over Llama-2-7B: every in-process replica is an
# engine over the main path's weight tensors with its own KV_BYTES pool, each
# with its own scheduler thread; the router speaks HTTP. A supervised process
# replica runs the entry point's own model (the reference's tiny Llama).
FLEET_DEATH_AFTER = 4  # decode tokens decode-0 streams before it dies
FLEET_STEAL_TOKENS = 16
FLEET_REPLICA_ARGS = ("--params-seed", "3")  # the process replica's model (its other arguments: the defaults)
FLEET_REPLICA_PROMPTS = ((1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11), (40, 41, 42, 43, 44))
FLEET_REPLICA_TOKENS = 12
FLEET_TIMEOUT_S = 600  # bound on every client exchange and wait of the phase


class _FleetGate:
    """Holds one replica's batches: while shut, its scheduler's ``step`` only
    services control calls (a steal, a prefix export) and returns False.
    ``after`` lets a request reach that many tokens first, and until it has
    them the scheduler services no control call at all (a steal the router
    sends meanwhile waits in the queue); ``hold_stream`` keeps the held
    tokens off its stream. So a steal or a death happens at a chosen point of
    a request, never at one that timing picks."""

    def __init__(self, sched, after=0, hold_stream=False):
        self.open = threading.Event()
        self.holding = threading.Event()
        inner_step, inner_push, inner_drain = sched.step, sched._push_token, sched._drain_control

        def drain():
            if self.open.is_set() or self.holding.is_set():
                inner_drain()

        def step():
            if self.open.is_set():
                return inner_step()
            if after == 0 or any(len(r.tokens) >= after for r in list(sched._active.values())):
                self.holding.set()
                sched._drain_control()
                return False
            return inner_step()

        def push(req, tok, record_itl=True):
            if hold_stream and not self.open.is_set():
                req.stream.put = lambda t: None
            return inner_push(req, tok, record_itl)

        sched.step, sched._push_token, sched._drain_control = step, push, drain


def _fleet(params, cfg, dev, roles, **config):
    """A ReplicaManager over in-process replicas with ids ``<role>-<i>``,
    built from one engine factory (the main path's weights, a pool of
    KV_BYTES each), and its router started on 127.0.0.1. The replicas opt out
    of the idle heartbeat (``LocalReplica``'s default keeps a pool member warm
    with ``empty_run``: on the port a whole forward of the smallest bucket,
    B1 included, every 50 ms on each idle replica, competing with the busy
    ones for the card and the interpreter)."""
    config.setdefault("probe_ttl_s", 0.0)
    config.setdefault("read_timeout_s", FLEET_TIMEOUT_S)
    config.setdefault("request_timeout_s", FLEET_TIMEOUT_S)
    manager = ReplicaManager(engine_factory=lambda: _engine(params, cfg, None, dev), config=FleetConfig(**config),
                             serving_config=ServingConfig(queue_capacity=64, heartbeat_enabled=False))
    counts = {}
    for role in roles:
        manager.add_local(role=role, replica_id=f"{role}-{counts.setdefault(role, 0)}")
        counts[role] += 1
    return manager, FleetRouter(manager).start()


def _close_fleet(manager, router):
    router.stop(drain=False)
    manager.close()
    gc.collect()
    torch.cuda.empty_cache()


def _sse_client(url, body, out, key, headers=None):
    """One SSE client of the router: its send time and each event with its
    arrival clock, appended as they come (``out[key]`` exists from the
    start)."""
    import urllib.request
    r = out[key] = dict(sent=time.perf_counter(), events=[], arrivals=[])
    req = urllib.request.Request(url + "/v1/generate", data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=FLEET_TIMEOUT_S) as resp:
            for line in resp:
                if line.startswith(b"data: "):
                    r["events"].append(json.loads(line[len(b"data: "):]))
                    r["arrivals"].append(time.perf_counter())
            r["status"] = resp.status
    except Exception as e:  # reported by the checks
        r["error"] = repr(e)


def _sse_once(url, body, headers=None):
    out = {}
    _sse_client(url, body, out, 0, headers)
    return out[0]


def _exactly_once(events, n):
    """The SSE check: ``n`` token events indexed 0..n-1, then a DONE final
    document whose tokens are the streamed ones, each once."""
    if not events or not events[-1].get("done"):
        return False
    *toks, final = events
    return ([e.get("index") for e in toks] == list(range(n)) and [e["token"] for e in toks] == final.get("tokens")
            and final.get("state") == "DONE")


def _legs_of(final):
    return [(leg["replica"], leg["kind"]) for leg in final.get("legs", [])]


def _frame_kv_check(frame, per_token):
    """A handoff frame's KV against the geometry: its bytes are whole blocks
    of ``per_token`` bytes a token slot, covering the seen tokens, and the
    frame ends where they do. Returns (ok, header, KV bytes)."""
    import struct
    hlen = struct.unpack_from("<I", frame, 8)[0]
    header = json.loads(bytes(frame[12:12 + hlen]))
    shape = header["kv"]["shape"]  # [L, 2, blocks, KVH, block size, D]
    kv_bytes = math.prod(shape) * 2  # bf16
    slots = shape[2] * shape[4]
    ok = (len(frame) == 12 + hlen + kv_bytes and kv_bytes == slots * per_token
          and slots - shape[4] < header["seen_tokens"] <= slots)
    return ok, header, kv_bytes


def _per_engine_b1(engine, counts, key):
    """Count B1's launches of one engine: two (insert, attention) for every
    layer forward its model sends down the kernel branch."""
    model = engine._model
    inner = model._use_paged_kernel

    def use(T):
        on = inner(T)
        if on and T > 0:  # an empty run (the idle heartbeat) launches nothing
            counts[key] += 2
        return on

    model._use_paged_kernel = use


def _fleet_disagg(params, cfg, dev, prompts, per_token, failures):
    """Leg a: one prefill and two decode replicas behind the router over HTTP,
    the serving mix at once over SSE. Then leg f (one traced request on the
    same replicas) and leg b (decode-0 dies mid-stream)."""
    manager, router = _fleet(params, cfg, dev, ("prefill", "decode", "decode"), breaker={"failure_threshold": 1})
    reps = {r.id: r for r in manager.replicas()}
    puts, loops, b1 = {rid: [] for rid in reps}, {rid: [] for rid in reps}, {rid: 0 for rid in reps}
    exports, imports, unpacks = [], [], []
    local = threading.local()
    put_s, empty_runs = {rid: [] for rid in reps}, {rid: [] for rid in reps}
    for rid, rep in reps.items():

        def put(*args, inner=rep.engine.put, rid=rid, **kw):
            # host seconds of the put: the scheduler waits for its logits
            # after it returns, so this is the launch side of the forward
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            put_s[rid].append(time.perf_counter() - t0)
            puts[rid].append(args)
            return out

        rep.engine.put = put
        _count_calls(rep.engine, "decode_loop", loops[rid])
        _count_calls(rep.engine, "empty_run", empty_runs[rid])
        _per_engine_b1(rep.engine, b1, rid)
        sched = rep.scheduler

        def export(req, inner=sched._export_handoff):
            t0 = time.perf_counter()
            payload = inner(req)
            secs = time.perf_counter() - t0
            ok, header, kv_bytes = _frame_kv_check(payload, per_token)
            exports.append(dict(tokens=header["seen_tokens"], frame_bytes=len(payload), kv_bytes=kv_bytes, s=secs,
                                kv_ok=ok, kv_shape=header["kv"]["shape"],
                                control_ok=_frame_kv_check(memoryview(payload)[:-per_token], per_token)[0]))
            return payload

        def import_(req, inner=sched._import_resume):
            nbytes = len(req._resume_payload or b"")
            t0 = time.perf_counter()
            out = inner(req)
            torch.cuda.current_stream().synchronize()
            imports.append(dict(frame_bytes=nbytes, s=time.perf_counter() - t0))
            return out

        def submit(*args, inner=None, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                local.inner = getattr(local, "inner", 0.0) + time.perf_counter() - t0

        def submit_resume(payload, *args, inner=sched.submit_resume, **kw):
            t0 = time.perf_counter()
            try:
                return inner(payload, *args, **kw)
            finally:
                secs = time.perf_counter() - t0
                unpacks.append(dict(frame_bytes=len(payload), s=secs))
                local.inner = getattr(local, "inner", 0.0) + secs

        sched._export_handoff, sched._import_resume = export, import_
        sched.submit = lambda *a, _inner=sched.submit, **kw: submit(*a, inner=_inner, **kw)
        sched.submit_resume = submit_resume
    host = {}  # routed request -> the router's own host seconds in its dispatches
    inner_dispatch = fleet_router.RoutedRequest._dispatch

    def dispatch(self, *args, **kw):
        local.inner = 0.0
        t0 = time.perf_counter()
        try:
            return inner_dispatch(self, *args, **kw)
        finally:
            host[id(self)] = host.get(id(self), 0.0) + time.perf_counter() - t0 - local.inner

    fleet_router.RoutedRequest._dispatch = dispatch
    res = {}
    try:
        # --- leg a: the serving mix at once
        out, threads = {}, []
        pa.paged_attention_update.launches = 0
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            threads.append(threading.Thread(target=_sse_client, args=(router.url, dict(prompt=p, max_new_tokens=NEW_TOKENS),
                                                                      out, i), daemon=True))
            threads[-1].start()
        for t in threads:
            t.join(timeout=FLEET_TIMEOUT_S)
        wall = time.perf_counter() - t0
        launches = pa.paged_attention_update.launches
        fleet_router.RoutedRequest._dispatch = inner_dispatch
        bad = {k: v.get("error") or v.get("status") for k, v in out.items() if v.get("status") != 200}
        if bad or len(out) != len(prompts):
            raise AssertionError(f"fleet burst requests failed: {bad}")
        finals = [out[i]["events"][-1] for i in range(len(prompts))]
        served = [(p, f.get("tokens") or []) for p, f in zip(prompts, finals)]
        ttft = [out[i]["arrivals"][0] - out[i]["sent"] for i in range(len(prompts))]
        itl = [b - a for i in range(len(prompts)) for a, b in zip(out[i]["arrivals"][:-2], out[i]["arrivals"][1:-1])]
        n_tokens = sum(len(t) for _, t in served)
        placement = {rid: dict(puts=len(puts[rid]), fed_tokens=sum(len(t) for args in puts[rid] for t in args[1]),
                               decode_inputs_of_one_token=all(len(t) == 1 for args in puts[rid] for t in args[1]),
                               decode_loops=len(loops[rid]), empty_runs=len(empty_runs[rid]), b1_launches=b1[rid],
                               put_host_ms_p50=1e3 * _percentile(put_s[rid], 50),
                               put_host_ms_p99=1e3 * _percentile(put_s[rid], 99)) for rid in reps}
        res["disaggregated"] = dict(
            requests=len(prompts), served_tokens=n_tokens, wall_s=wall, served_tokens_per_s=n_tokens / wall,
            ttft_p50_s=_percentile(ttft, 50), ttft_p99_s=_percentile(ttft, 99), itl_p50_s=_percentile(itl, 50),
            itl_p99_s=_percentile(itl, 99), b1_launches=launches, placement=placement,
            exports=[{k: v for k, v in e.items() if k != "control_ok"} for e in exports], imports=list(imports),
            unpacks=list(unpacks), router_host_ms=sorted(1e3 * s for s in host.values()),
            legs=[_legs_of(f) for f in finals], fleet=router.fleet_stats()["router"])
        d = res["disaggregated"]
        for e in d["exports"] + d["imports"] + d["unpacks"]:
            e["gb_per_s"] = e["frame_bytes"] / e["s"] / 1e9
        # --- checks of leg a, each with its control
        if not all(_exactly_once(out[i]["events"], NEW_TOKENS) for i in range(len(prompts))):
            failures.append("a routed SSE stream differs from its final document or is not 32 tokens")
        if any(_legs_of(f) != [("prefill-0", "prefill"), (_legs_of(f)[-1][0], "decode")]
               or not _legs_of(f)[-1][0].startswith("decode-") for f in finals):
            failures.append(f"a request did not run prefill -> decode: {[_legs_of(f) for f in finals]}")

        def placed(rid, role):
            p = placement[rid]
            if p["empty_runs"] or p["decode_loops"]:
                return False
            if role == "prefill":  # prompts only: every prompt token fed once, no decode input
                return p["fed_tokens"] == sum(PROMPT_LENS)
            return p["decode_inputs_of_one_token"] and p["b1_launches"] == 2 * cfg.num_hidden_layers * p["puts"]

        if not (placed("prefill-0", "prefill") and placed("decode-0", "decode") and placed("decode-1", "decode")):
            failures.append(f"prefill or decode ran on the wrong replica: {placement}")
        if placed("decode-0", "prefill") or placed("prefill-0", "decode"):
            failures.append("control: a decode replica's puts passed the prefill placement check")
        decode_fed = sum(placement[r]["fed_tokens"] for r in ("decode-0", "decode-1"))
        if decode_fed != len(prompts) * (NEW_TOKENS - 1):
            failures.append(f"the decode replicas fed {decode_fed} tokens, not {len(prompts)} x {NEW_TOKENS - 1}")
        if not (placement["decode-0"]["puts"] and placement["decode-1"]["puts"]):
            failures.append(f"the decode legs did not spread over both decode replicas: {placement}")
        if sum(b1.values()) != launches or not launches:
            failures.append(f"B1's launches by engine {b1} do not add up to the process's {launches}")
        if len(exports) != len(prompts) or not all(e["kv_ok"] for e in exports):
            failures.append(f"a handoff frame's KV is not {per_token} bytes a token slot: {exports}")
        if any(e["control_ok"] for e in exports):
            failures.append("control: a frame short of one token slot passed the KV bytes check")
        if len(imports) != len(prompts):
            failures.append(f"{len(imports)} imports for {len(prompts)} handoffs")

        # --- leg f: one disaggregated request traced across the router and both replicas
        session = telemetry.configure({"enabled": True})
        try:
            traced = FleetRouter(manager)  # a router built in a session has a trace collector
            doc = traced.route(dict(prompt=prompts[1], max_new_tokens=4)).result()
            other = traced.route(dict(prompt=prompts[0], max_new_tokens=4)).result()
            collector = traced.collect_traces()
            spans = collector.spans_for(doc["trace_id"])
            res["trace"] = _trace_check(spans, collector.spans_for(other["trace_id"]), doc, failures)
        finally:
            session.close()
        served.append((prompts[1], doc["tokens"]))

        # --- leg b: decode-0 dies after FLEET_DEATH_AFTER streamed decode tokens
        gate = _FleetGate(reps["decode-0"].scheduler, after=FLEET_DEATH_AFTER)
        box = {}
        client = threading.Thread(target=_sse_client, args=(router.url, dict(prompt=prompts[4],
                                                                             max_new_tokens=NEW_TOKENS), box, 0),
                                  daemon=True)
        client.start()
        deadline = time.perf_counter() + FLEET_TIMEOUT_S
        while not (gate.holding.is_set() and len(box.get(0, {}).get("events", ())) >= 1 + FLEET_DEATH_AFTER):
            if time.perf_counter() > deadline:
                raise AssertionError("decode-0 never reached the death point")
            time.sleep(0.001)
        t_death = time.perf_counter()
        reps["decode-0"].kill("chip smoke: a decode replica dies mid-stream")
        client.join(timeout=FLEET_TIMEOUT_S)
        r = box[0]
        if r.get("status") != 200:
            raise AssertionError(f"the request whose decode replica died failed: {r}")
        events, final = r["events"], r["events"][-1]
        after = [a for a in r["arrivals"][:-1] if a > t_death]
        streamed = [e["token"] for e in events[:-1]]
        before = sum(1 for a in r["arrivals"][:-1] if a <= t_death)
        res["death"] = dict(tokens=len(streamed), tokens_before_death=before,
                            death_to_next_token_s=after[0] - t_death if after else None,
                            legs=_legs_of(final), breaker=reps["decode-0"].breaker.describe()["state"],
                            fleet=router.fleet_stats()["router"])
        served.append((prompts[4], final.get("tokens") or []))
        if not _exactly_once(events, NEW_TOKENS):
            failures.append(f"after the death the client did not see {NEW_TOKENS} tokens once each: "
                            f"{streamed} / {final.get('tokens')}")
        if _exactly_once(events[:before] + events[before - 1:-1] + events[-1:], NEW_TOKENS):
            failures.append("control: a stream with a token repeated passed the exactly-once check")
        if _legs_of(final) != [("prefill-0", "prefill"), ("decode-1", "decode")] or before != 1 + FLEET_DEATH_AFTER:
            failures.append(f"the buffered frame was not re-dispatched to decode-1 after {FLEET_DEATH_AFTER} "
                            f"decode tokens: legs {_legs_of(final)}, {before} tokens before the death")
        if res["death"]["breaker"] != "OPEN" or reps["decode-1"].breaker.describe()["state"] != "CLOSED":
            failures.append(f"decode-0's breaker is {res['death']['breaker']}, not OPEN (decode-1's must stay "
                            f"CLOSED)")
    finally:
        fleet_router.RoutedRequest._dispatch = inner_dispatch
        _close_fleet(manager, router)
    return res, served


def _trace_check(spans, other_spans, doc, failures):
    """Leg f: the router's span, the prefill replica's request span and the
    decode replica's share the request's trace id, each replica's request
    parented under the router's hop to it. Control: the same check over a
    second request's spans added must fail."""

    def one_trace(spans):
        ids = {s["args"]["trace_id"] for s in spans}
        hops = {s["args"]["span_id"]: s["args"].get("replica") for s in spans if s["name"].startswith("dispatch:")}
        roots = [s for s in spans if s["name"] == "route"]
        requests = {hops.get(s["args"]["parent_id"]) for s in spans if s["name"] == "request"}
        return (len(ids) == 1 and len(roots) == 1 and requests >= {"prefill-0"}
                and any(r and r.startswith("decode-") for r in requests))

    ok = one_trace(spans)
    control = one_trace(spans + other_spans)
    if not ok:
        failures.append(f"the traced request's spans are not one trace over router, prefill and decode: "
                        f"{[(s['name'], s['args'].get('parent_id')) for s in spans]}")
    if control:
        failures.append("control: two requests' spans passed the one-trace check")
    return dict(trace_id=doc["trace_id"], spans=[dict(name=s["name"], pid=s["pid"], dur_us=s["dur"],
                                                      replica=s["args"].get("replica")) for s in spans],
                legs=_legs_of(doc))


def _fleet_steal(params, cfg, dev, prompts, failures):
    """Leg c: two mixed replicas, mixed-0 held (hot) and mixed-1 cold. A
    request still queued on mixed-0 is stolen and re-granted from scratch; one
    whose first token is held off its stream is exported mid-decode and
    resumed on mixed-1. Control: with mixed-0 open, nothing is stolen."""
    manager, router = _fleet(params, cfg, dev, ("mixed", "mixed"),
                             steal={"enabled": True, "wait_budget_s": 0.5, "load_ratio": 1.5})
    victim = manager.get("mixed-0")
    exports = []
    _timed(victim.scheduler, "_export_handoff", exports)
    res, served = {}, []
    try:
        for kind, gate_kw, p in (("queued", dict(after=0), prompts[2]),
                                 ("exported", dict(after=1, hold_stream=True), prompts[3]),
                                 ("control", None, prompts[1])):
            gate = _FleetGate(victim.scheduler, **gate_kw) if gate_kw is not None else None
            r = _sse_once(router.url, dict(prompt=p, max_new_tokens=FLEET_STEAL_TOKENS))
            if gate is not None:
                gate.open.set()
            if r.get("status") != 200:
                raise AssertionError(f"the {kind} steal request failed: {r}")
            final = r["events"][-1]
            res[kind] = dict(stolen=bool(final.get("stolen")), legs=[(leg["replica"], leg["kind"], leg["n_tokens"])
                                                                     for leg in final["legs"]],
                             e2e_s=r["arrivals"][-1] - r["sent"], exactly_once=_exactly_once(r["events"],
                                                                                            FLEET_STEAL_TOKENS))
            served.append((p, final.get("tokens") or []))
        stats = router.fleet_stats()
        res["router"] = {k: stats["router"][k] for k in ("steals", "steal_attempts")}
        res["scheduler_steals"] = {rid: manager.get(rid).scheduler.stats()["counters"]["steals"]
                                   for rid in ("mixed-0", "mixed-1")}
        res["steal_export_ms"] = [1e3 * s for s in exports]
    finally:
        _close_fleet(manager, router)
    q, e, c = res["queued"], res["exported"], res["control"]
    if not (q["stolen"] and [k for _, k, _ in q["legs"]] == ["steal-victim", "steal"] and q["legs"][0][2] == 0):
        failures.append(f"the queued request was not re-granted from scratch: {q}")
    if not (e["stolen"] and [k for _, k, _ in e["legs"]] == ["steal-victim", "steal"] and e["legs"][0][2] == 1
            and e["legs"][1][2] == FLEET_STEAL_TOKENS - 1):
        failures.append(f"the decoding request was not exported after its first token: {e}")
    if not (q["exactly_once"] and e["exactly_once"] and c["exactly_once"]):
        failures.append("a steal leg's stream differs from its final document")
    if res["router"] != {"steals": 2, "steal_attempts": 2} or res["scheduler_steals"] != {"mixed-0": 2, "mixed-1": 0}:
        failures.append(f"steal counters {res['router']} {res['scheduler_steals']}, not 2 / 2 and 2 / 0")
    if c["stolen"] or [r for r, _, _ in c["legs"]] != ["mixed-0"]:
        failures.append(f"control: a request on the open mixed-0 was stolen: {c}")
    return res, served


def _pin_session(target, other):
    """A session key whose rendezvous winner is ``target``."""
    for i in range(1000):
        key = f"pin{i}"
        if fleet_router._rendezvous_score(key, target) > fleet_router._rendezvous_score(key, other):
            return key
    raise AssertionError("rendezvous never favoured the target")


def _fleet_peer_fetch(params, cfg, dev, failures):
    """Leg d: replica A serves run_prefix_path's 1,024-token shared prompt;
    replica B then serves a turn on the same prefix (pinned to B), its 16
    blocks fetched from A's trie instead of prefilled. Then a frame the
    fault injector corrupts in transit is refused at import and B serves that
    turn cold (the control of the exact count)."""
    rng = np.random.default_rng(8)  # run_prefix_path's draws
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_TOKENS).tolist()
    lens = rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1, PREFIX_REQUESTS)
    turns = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    other_prefix = rng.integers(0, cfg.vocab_size, PREFIX_TOKENS).tolist()
    other_turns = [other_prefix + rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(2)]
    manager, router = _fleet(params, cfg, dev, ("mixed", "mixed"), prefix_cache={"enabled": True},
                             cache_route={"fetch_timeout_s": 60.0})
    a, b = manager.get("mixed-0"), manager.get("mixed-1")
    b_puts, fetches = [], []
    _count_calls(b.engine, "put", b_puts)
    _timed(a, "fetch_prefix", fetches)
    res, served = {}, []
    key = _pin_session("mixed-1", "mixed-0")
    try:
        for name, (warm, turn) in (("clean", turns[:2]), ("corrupt", other_turns)):
            if name == "corrupt":
                router.set_faults(FaultConfig(enabled=True, seed=5, peer_fetch_corrupt_p=1.0))
            w = _sse_once(router.url, dict(prompt=warm, max_new_tokens=NEW_TOKENS))
            before = dict(b.scheduler.stats()["counters"])
            n_puts = len(b_puts)
            r = _sse_once(router.url, dict(prompt=turn, max_new_tokens=NEW_TOKENS, routing="hash", session=key))
            if w.get("status") != 200 or r.get("status") != 200:
                raise AssertionError(f"a peer-fetch request failed: {w} {r}")
            counters = b.scheduler.stats()["counters"]
            final = r["events"][-1]
            fed = sum(len(args[1][args[0].index(final["uid"])]) for args in b_puts[n_puts:] if final["uid"] in args[0])
            res[name] = dict(warm_legs=_legs_of(w["events"][-1]), legs=_legs_of(final),
                             cached_tokens=final["cached_tokens"], prompt_tokens=len(turn), fed_tokens=fed,
                             ttft_s=r["arrivals"][0] - r["sent"], warm_ttft_s=w["arrivals"][0] - w["sent"],
                             **{k: counters[k] - before[k] for k in ("peer_fetch_hits", "peer_fetch_blocks",
                                                                    "peer_fetch_rejects", "prefix_tokens_saved")})
            served += [(warm, w["events"][-1].get("tokens") or []), (turn, final.get("tokens") or [])]
        res["fetch_ms"] = [1e3 * s for s in fetches]
    finally:
        _close_fleet(manager, router)
    clean, bad = res["clean"], res["corrupt"]

    def imported(leg):  # exactly the prefix's 16 blocks, and only the rest of the prompt prefilled
        return (leg["legs"] == [("mixed-1", "serve")] and leg["warm_legs"] == [("mixed-0", "serve")]
                and leg["cached_tokens"] == PREFIX_TOKENS and leg["peer_fetch_hits"] == 1
                and leg["peer_fetch_blocks"] == PREFIX_TOKENS // BLOCK
                and leg["fed_tokens"] == leg["prompt_tokens"] - PREFIX_TOKENS + NEW_TOKENS - 1)

    if not imported(clean):
        failures.append(f"the turn on mixed-1 did not import exactly the prefix's blocks from mixed-0: {clean}")
    if imported(bad) or bad["peer_fetch_rejects"] != 1 or bad["cached_tokens"] != 0:
        failures.append(f"control: the corrupted frame was not refused at import and served cold: {bad}")
    return res, served


def _fleet_process_replica(failures):
    """Leg e: ``python -m deepspeed_tpu_torch.bin.dstpu_replica`` on the card
    under the supervisor: readiness, registration, a routed request, SIGKILL,
    detection, a restart with backoff, re-registration and a second request;
    both requests' tokens are an in-process engine's from the same
    ``--params-seed`` (control: another seed's differ). Every child is killed
    in the ``finally``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    libs_before = sorted(p.name for p in builder.BUILD_DIR.glob("*.so"))
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.bin.dstpu_replica", "--port-file", "{port_file}",
           *FLEET_REPLICA_ARGS]
    manager = ReplicaManager(config=FleetConfig(probe_ttl_s=0.0, read_timeout_s=120.0, request_timeout_s=300.0))
    supervisor = ReplicaSupervisor(manager, SupervisorConfig(poll_interval_s=0.1, ready_timeout_s=240.0,
                                                             restart_backoff_base_s=0.5, restart_backoff_cap_s=2.0,
                                                             restart_jitter_frac=0.0, max_crashes=3,
                                                             crash_window_s=600.0))
    slot = supervisor.add_process(cmd, role="mixed", cwd=repo, env={"PYTHONPATH": repo})
    router = None
    procs, res, served = [], {}, []
    try:
        t0 = time.perf_counter()
        supervisor.start()
        if not supervisor.wait_ready(timeout=300):
            raise AssertionError(f"the process replica never became ready: {slot.describe()}")
        res["spawn_to_ready_s"] = time.perf_counter() - t0
        procs.append(slot.replica.proc)
        router = FleetRouter(manager).start()
        body = lambda p: dict(prompt=list(p), max_new_tokens=FLEET_REPLICA_TOKENS)
        first = _sse_once(router.url, body(FLEET_REPLICA_PROMPTS[0]))
        t_kill = time.perf_counter()
        os.kill(procs[0].pid, signal.SIGKILL)
        deadline = t_kill + 300
        while slot.state.name == "READY" and slot.restarts == 0:
            if time.perf_counter() > deadline:
                raise AssertionError("the supervisor never saw the SIGKILL")
            time.sleep(0.01)
        res["detect_s"] = time.perf_counter() - t_kill
        while not (slot.restarts >= 1 and slot.state.name == "READY"):
            if time.perf_counter() > deadline:
                raise AssertionError(f"the process replica was not restarted: {slot.describe()}")
            time.sleep(0.01)
        res["kill_to_ready_s"] = time.perf_counter() - t_kill
        procs.append(slot.replica.proc)
        second = _sse_once(router.url, body(FLEET_REPLICA_PROMPTS[1]))
        res["slot"] = slot.describe()
    finally:
        if router is not None:
            router.stop(drain=False)
        supervisor.stop()
        for proc in procs + ([slot.replica.proc] if slot.replica is not None else []):
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
    res["children_alive_after_stop"] = sum(1 for p in procs if p.poll() is None)
    got = [r["events"][-1].get("tokens") if r.get("status") == 200 else r for r in (first, second)]
    want = {}
    for seed in (FLEET_REPLICA_ARGS[1], "4"):
        args = dstpu_replica.parser().parse_args([*FLEET_REPLICA_ARGS, "--params-seed", seed])
        engine = dstpu_replica.build_engine_from_args(args)
        want[seed] = [generate(engine, [list(p)], max_new_tokens=FLEET_REPLICA_TOKENS,
                               decode_chunk=args.decode_chunk)[0] for p in FLEET_REPLICA_PROMPTS]
        engine.close()
        del engine
    res.update(tokens=got, in_process_tokens=want[FLEET_REPLICA_ARGS[1]],
               libraries_built_by_children=sorted(set(p.name for p in builder.BUILD_DIR.glob("*.so"))
                                                  - set(libs_before)))
    if got != want[FLEET_REPLICA_ARGS[1]] or not all(_exactly_once(r["events"], FLEET_REPLICA_TOKENS)
                                                    for r in (first, second)):
        failures.append(f"the process replica's tokens {got} are not the in-process engine's "
                        f"{want[FLEET_REPLICA_ARGS[1]]}")
    if got == want["4"]:
        failures.append("control: another --params-seed's tokens passed the equality check")
    if res["children_alive_after_stop"] or res["libraries_built_by_children"]:
        failures.append(f"{res['children_alive_after_stop']} children outlived the supervisor, or they built "
                        f"{res['libraries_built_by_children']}")
    if res["slot"]["restarts"] != 1 or procs[0].pid == procs[-1].pid:
        failures.append(f"the killed process replica was not restarted once: {res['slot']}")
    return res


def run_fleet_path(dev, params, main) -> dict:
    """The fleet (ROADMAP A6) on Llama-2-7B, on replicas that share the main
    path's weights on the card: a disaggregated burst through the router over
    HTTP (a), a decode replica's death mid-stream (b), work stealing (c), a
    peer prefix fetch and a corrupted one (d), a supervised process replica
    of the entry point (e), one trace across the router and both replicas
    (f). Every served greedy token is held to the dense f32 model; every leg
    has a control that fails its check."""
    t_start = time.perf_counter()
    cfg = serve_config()
    rng = np.random.default_rng(0)  # run_serving_path's prompts
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    per_token = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * (cfg.hidden_size // cfg.num_attention_heads) * 2
    failures, parts, served = [], {}, []
    pa.paged_attention_update.launches = 0
    t0 = time.perf_counter()
    res, more = _fleet_disagg(params, cfg, dev, prompts, per_token, failures)
    served += more
    gc.collect()
    torch.cuda.empty_cache()
    parts["disaggregated_trace_death"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["steal"], more = _fleet_steal(params, cfg, dev, prompts, failures)
    served += more
    gc.collect()
    torch.cuda.empty_cache()
    parts["steal"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["peer_fetch"], more = _fleet_peer_fetch(params, cfg, dev, failures)
    served += more
    gc.collect()
    torch.cuda.empty_cache()
    parts["peer_fetch"] = time.perf_counter() - t0
    res["b1_launches"] = pa.paged_attention_update.launches  # the process replica's launches are its own
    t0 = time.perf_counter()
    res["process_replica"] = _fleet_process_replica(failures)
    parts["process_replica"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # --- every served greedy token against the dense f32 model
    tol = TF_SLACK * max(main["logits_max_abs_err_kernel_vs_f32"], main["logits_max_abs_err_gather_vs_f32"])
    model = _dense_f32(params, cfg)
    gaps = _teacher_forced(model, dev, served)
    shifted = _teacher_forced(model, dev, [(p, t[1:] + t[:1]) for p, t in served[:4]])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["teacher_forced"] = dict(tolerance=tol, sequences=len(served), tokens=int(gaps.numel()),
                                 max_gap=gaps.max().item(), max_gap_over_tol=gaps.max().item() / tol,
                                 control_max_gap=shifted.max().item())
    if any(len(t) == 0 for _, t in served):
        failures.append("a fleet request served no tokens")
    if not gaps.max().item() <= tol:
        failures.append(f"a served token's f32 logit trails its row's maximum by {gaps.max().item()} > {tol}")
    if not shifted.max().item() > tol:
        failures.append("control: the shifted tokens passed the teacher-forced check")
    parts["teacher_forced"] = time.perf_counter() - t0
    res["seconds_by_part"] = parts
    res["seconds"] = time.perf_counter() - t_start
    res["failures"] = failures
    d, x, s, p, e = (res["disaggregated"], res["death"], res["steal"], res["peer_fetch"], res["process_replica"])
    log("[fleet] " + json.dumps(res, default=str))
    log(f"[fleet] disaggregated burst: TTFT p50 {d['ttft_p50_s'] * 1e3:.1f} ms p99 {d['ttft_p99_s'] * 1e3:.1f} ms, "
        f"ITL p50 {d['itl_p50_s'] * 1e3:.2f} ms p99 {d['itl_p99_s'] * 1e3:.2f} ms, served "
        f"{d['served_tokens_per_s']:.1f} tokens/s; frames {sum(x_['frame_bytes'] for x_ in d['exports']) / 2**30:.2f}"
        f" GiB; router host ms {d['router_host_ms']}")
    log(f"[fleet] death -> next token {x['death_to_next_token_s']} s; steals {s['router']}; peer fetch "
        f"{p['clean']['cached_tokens']} tokens in {p['fetch_ms']} ms; process replica ready in "
        f"{e['spawn_to_ready_s']:.1f} s, restarted in {e['kill_to_ready_s']:.1f} s; B1 {res['b1_launches']}")
    log(card_line())
    if failures:
        raise AssertionError("fleet phase: " + "; ".join(failures))
    return res


# ------------------------------------------------------------- MoE phase --
# Mixtral-8x7B's widths (hidden 4096, FFN 14336, 32 heads and 8 KV heads of
# 128, 8 experts, top-2, vocab 32000, rope theta 1e6), bf16, random weights
# from seed 0, 4 of its 32 layers (cut: depth; 8 layers, 11.87B parameters and
# 23.7 GB, until the composed phase needed the card's time).
MOE_LAYERS = 4
# leg d's depth cut: 1 layer, 1.71B parameters. At 2 (3.16B) the engine's
# out-of-place AdamW, which holds the old and the new state at once
# (ops/adam/fused_adam.py), ran out of the card's 80 GB (76.55 GiB allocated
# when it asked for 3.5 more; NVIDIA H100 80GB HBM3, 700.00 W)
MOE_TRAIN_LAYERS = 1
# 8 requests of 32-1024 prompt tokens (seeded), 32 greedy new tokens each
MOE_PROMPT_LENS = tuple(int(n) for n in np.random.default_rng(16).integers(32, 1025, 8))
MOE_NEW_TOKENS = 32
# capacity factor 4.0 = E / k: C is at least every token of the batch, so no
# assignment is ever dropped and the served function is Mixtral's (the
# reference's default 2.0 drops where a batch's routing is skewed)
MOE_CAPACITY = 4.0
MOE_KV_BYTES = 2 * 2**30
MOE_SIM_TEMPERATURE = 0.5
# the simulated router's first choices over the 8 x 32 decoded tokens, held to
# simulated_expert_probs a layer: each expert's share within MOE_SIM_SIGMAS
# binomial standard deviations (plus one token) of its probability
MOE_SIM_SIGMAS = 4.0
# a served route (the experts the bf16 engine chose) may differ from the f32
# router's only where the two nearly tie: the served pick's f32 logit lies
# below the f32 second best by at most what two logits' errors cover. The
# router and the head have the same weight scale (0.02 x sqrt(4096): logits
# of standard deviation 1.28) over the same drifting hidden state, so each
# router logit's error is taken as the largest error of the first decode
# step's logits against f32 (along the served routes), and a route's
# deficit is held to MOE_ROUTE_SLACK = 2 of them. Control: every route moved
# to the next expert.
MOE_ROUTE_SLACK = 2.0
MOE_CONTROL_TOKENS = 4  # leg c's control: new tokens a request with rank 1's experts swapped
MOE_TRAIN_S = 1024
MOE_TRAIN_STEPS = 3
MOE_TIMEOUT_S = 600  # bound on leg c's ranks
MOE_PREDICTED_S = 150.0  # the phase's predicted seconds, printed before it runs


def mixtral_config(layers=MOE_LAYERS, **kw) -> MixtralConfig:
    return MixtralConfig.mixtral_8x7b(num_hidden_layers=layers, max_position_embeddings=MAX_CONTEXT, **kw)


def _moe_params(cfg, dev, experts=None, dtype=torch.bfloat16) -> dict:
    """The Mixtral weights from seed 0 (``experts=(lo, hi)``: a rank's slice
    of the same draws)."""
    return mixtral_init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=dtype,
                               experts=experts)


def _moe_engine(params, cfg, dev, ep=1, **kw):
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT, memory_config=MemoryConfig(size=MOE_KV_BYTES))
    ep_cfg = DeepSpeedEPConfig(enabled=ep > 1, replica_num=ep, capacity_factor=MOE_CAPACITY)
    return build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK,
                                                                 expert_parallel=ep_cfg, **kw), device=dev)


def _moe_prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in MOE_PROMPT_LENS]


def _moe_stats(engine) -> dict:
    """The routing statistics of every layer since their last reset."""
    moes = engine.model.moes
    return dict(expert_counts=[m.expert_counts.tolist() for m in moes],
                first_choice_counts=[m.first_choice_counts.tolist() for m in moes],
                dropped=sum(int(m.dropped) for m in moes))


class _RoutingLog:
    """The experts the served engine chose: ``routes[(uid, position)][layer]
    = [first, second]`` for every token fed while it is open, recorded from
    each layer's ``RaggedMoE._top_k`` and the forward's batch (a host read a
    layer: for check runs, not timed ones). Routing is discontinuous: a
    token whose two best experts nearly tie can pick another one in bf16
    than in f32, which changes its output (and, through the KV, its
    sequence's) by far more than rounding; the f32 reference follows these
    routes, and the router's part is held apart (:func:`_mixtral_f32`)."""

    def __init__(self, engine):
        self.routes = {}
        self._model = model = engine.model
        keys = []
        begin = model._begin_forward

        def begin_forward(batch):
            n = batch["n_tokens"]
            uids = [d.tracking_id for d in engine._batch._seq_descs]
            keys[:] = [(uids[q], p) for q, p in zip(batch["token_seq"][:n].tolist(), batch["token_pos"][:n].tolist())]
            begin(batch)

        model._begin_forward = begin_forward
        for li, moe in enumerate(model.moes):

            def top_k(probs, li=li, inner=moe._top_k):
                w, e = inner(probs)
                for key, pick in zip(keys, e[:len(keys)].tolist()):
                    self.routes.setdefault(key, {})[li] = pick
                return w, e

            moe._top_k = top_k

    def close(self):
        del self._model._begin_forward
        for moe in self._model.moes:
            del moe._top_k

    def of(self, uid, length, layers):
        """``[length, layers, 2]`` experts of positions ``0..length-1``."""
        return [[self.routes[(uid, p)][li] for li in range(layers)] for p in range(length)]


def _mixtral_f32(params, cfg, sequences, starts, routes=None, swap=False):
    """The plain reference: Mixtral's function in f32 on the bf16 weights,
    upcast a layer at a time (the 8 layers in f32 would take 47 GB). Causal
    attention over each whole sequence, each token's top-2 experts with the
    router's f32 weights renormalised over the two, every expert run on the
    tokens routed to it: no capacity, no drop. The experts are the f32
    router's own, or ``routes[i]`` (``[len, layers, 2]``, the served ones:
    :class:`_RoutingLog`); then each served pick is held to the f32 router
    by its deficit, how far its f32 logit falls below the f32 second best
    (0 where the two agree). Returns per sequence the f32 logits of its
    positions from ``starts[i]`` on, and the largest deficit and the count of
    token-layers routed otherwise than the f32 router would. ``swap``
    exchanges experts 0 and 1 in every layer (a control)."""
    dev = params["embed_tokens.weight"].device
    H, KVH, D, E = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.num_local_experts
    cos, sin = rotary_embedding(max(len(s) for s in sequences), D, cfg.rope_theta, device=dev)
    xs = [params["embed_tokens.weight"][torch.tensor(s, device=dev)].float() for s in sequences]
    forced = None if routes is None else [torch.tensor(r, device=dev)[:len(s)] for r, s in zip(routes, sequences)]
    deficit, disagree = 0.0, 0
    with torch.no_grad():
        for li in range(cfg.num_hidden_layers):
            p = f"layers.{li}."
            w = {n: params[p + n].float() for n in ("input_layernorm.weight", "self_attn.q_proj.weight",
                                                     "self_attn.k_proj.weight", "self_attn.v_proj.weight",
                                                     "self_attn.o_proj.weight", "post_attention_layernorm.weight",
                                                     "block_sparse_moe.gate")}
            wi, wo = params[p + "block_sparse_moe.experts.wi"], params[p + "block_sparse_moe.experts.wo"]
            for i, x in enumerate(xs):
                S = x.shape[0]
                h = rms_norm(x, w["input_layernorm.weight"], cfg.rms_norm_eps)
                q = apply_rotary((h @ w["self_attn.q_proj.weight"].T).view(1, S, H, D), cos[:S], sin[:S])
                k = apply_rotary((h @ w["self_attn.k_proj.weight"].T).view(1, S, KVH, D), cos[:S], sin[:S])
                v = (h @ w["self_attn.v_proj.weight"].T).view(1, S, KVH, D)
                attn = causal_attention(q, k, v, scale=D**-0.5)[0].reshape(S, H * D)
                x = x + attn @ w["self_attn.o_proj.weight"].T
                h = rms_norm(x, w["post_attention_layernorm.weight"], cfg.rms_norm_eps)
                logits = h @ w["block_sparse_moe.gate"]
                probs = torch.softmax(logits, dim=-1)
                top_e = probs.topk(2, dim=-1).indices
                if forced is not None:
                    served = forced[i][:, li]
                    second = logits.topk(2, dim=-1).values[:, 1]
                    short = (second - logits.gather(1, served).min(-1).values).clamp(min=0)
                    deficit = max(deficit, short.max().item())
                    disagree += int((served.sort(-1).values != top_e.sort(-1).values).any(-1).sum())
                    top_e = served
                top_w = probs.gather(1, top_e)
                top_w = top_w / top_w.sum(-1, keepdim=True)
                y = torch.zeros_like(x)
                for e in range(E):
                    rows, slot = (top_e == e).nonzero(as_tuple=True)
                    if rows.numel():
                        src = (1 - e if e < 2 else e) if swap else e
                        gate, up = (h[rows] @ wi[src].float()).chunk(2, dim=-1)
                        y.index_add_(0, rows, (F.silu(gate) * up) @ wo[src].float() * top_w[rows, slot, None])
                xs[i] = x + y
        norm, head = params["norm.weight"].float(), params["lm_head.weight"].float()
        rows = [rms_norm(x[s0:], norm, cfg.rms_norm_eps) @ head.T for x, s0 in zip(xs, starts)]
    return rows, deficit, disagree


def _moe_gaps(rows, tokens):
    """Per served token, the f32 row's maximum less the token's logit."""
    return torch.cat([(r.max(-1).values - r[torch.arange(len(t), device=r.device), torch.tensor(t, device=r.device)])
                      .cpu() for r, t in zip(rows, tokens)])


def _moe_teacher_forced(params, cfg, prompts, tokens, routes):
    """Every served token through the f32 reference along its served routes,
    one pass a request: the f32 rows of the generated positions, the
    routes' deficit and disagreements (:func:`_mixtral_f32`)."""
    return _mixtral_f32(params, cfg, [list(p) + list(t[:-1]) for p, t in zip(prompts, tokens)],
                        [len(p) - 1 for p in prompts], routes=routes)


def _moe_leg_a(params, cfg, dev, prompts, start_ranks, failures) -> dict:
    """One rank through generate: rates, B1's launches, the routing, a traced
    decode put, and the served logits and tokens against the f32 reference,
    each check with its control. ``start_ranks()`` is called once the timed
    part is done."""
    engine = _moe_engine(params, cfg, dev)
    generate(engine, [prompts[0], prompts[1]], max_new_tokens=4, decode_chunk=4)  # warm-up, not counted
    torch.cuda.synchronize()
    times = {"put": [], "decode_loop": []}
    _timed(engine, "put", times["put"], _put_tokens)
    _timed(engine, "decode_loop", times["decode_loop"], _loop_steps)
    for m in engine.model.moes:
        m.reset_stats()
    paged_attention_update.launches = 0
    t0 = time.perf_counter()
    tokens = generate(engine, prompts, max_new_tokens=MOE_NEW_TOKENS, decode_chunk=MOE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention_update.launches
    del engine.put, engine.decode_loop
    steps = sum(n for _, (_, n) in times["decode_loop"])
    small_puts = sum(1 for _, n in times["put"] if n <= 32)
    res = dict(layers=cfg.num_hidden_layers, requests=len(prompts), prompt_tokens=sum(MOE_PROMPT_LENS),
               new_tokens=MOE_NEW_TOKENS, capacity_factor=MOE_CAPACITY, wall_s=wall, b1_launches=launches,
               b1_expected=2 * cfg.num_hidden_layers * (steps + small_puts), puts=[n for _, n in times["put"]],
               decode_loops=[list(w) for _, w in times["decode_loop"]],
               prefill_tokens_per_s=sum(MOE_PROMPT_LENS) / sum(s for s, _ in times["put"]),
               decode_tokens_per_s=sum(a * b for _, (a, b) in times["decode_loop"]) /
               sum(s for s, _ in times["decode_loop"]),
               ms_per_decode_step=1e3 * sum(s for s, _ in times["decode_loop"]) / max(steps, 1),
               **_moe_stats(engine))
    if launches <= 0 or launches != res["b1_expected"]:
        failures.append(f"a: B1 launched {launches} times, expected {res['b1_expected']}")
    if res["dropped"]:
        failures.append(f"a: {res['dropped']} assignments dropped at capacity factor {MOE_CAPACITY}")
    if [len(t) for t in tokens] != [MOE_NEW_TOKENS] * len(prompts):
        failures.append(f"a: generate returned {[len(t) for t in tokens]} tokens")
    first = [t[0] for t in tokens]
    # one traced decode put: attn against moe_ffn
    traced = _moe_engine(params, cfg, dev, trace_enabled=True)
    _prefill(traced, prompts)
    traced.tracer.drain_summaries()
    before = paged_attention_update.launches
    traced.put(list(range(len(prompts))), [[t] for t in first])
    summary = [s for s in traced.tracer.drain_summaries() if not s.is_empty_run][-1]
    attn = [row[RECORD_NAMES.index("attn")] for row in summary.record_exec_times]
    moe_ffn = [row[RECORD_NAMES.index("moe_ffn")] for row in summary.record_exec_times]
    res["traced_decode_put"] = dict(attn_us=sum(attn), moe_ffn_us=sum(moe_ffn), attn_us_per_layer=attn,
                                    moe_ffn_us_per_layer=moe_ffn, embed_us=summary.embed, unembed_us=summary.unembed,
                                    b1_launches=paged_attention_update.launches - before)
    traced.close()
    del traced
    torch.cuda.empty_cache()

    # the timed part is over: leg c's ranks may start (their imports load
    # the host's cores)
    start_ranks()
    # greedy generate again with the routes recorded (untimed), then the
    # first decode step of the 8 requests in one put through B1 (a served
    # second token may come from a put that also carried other requests'
    # prompt chunks, the gather branch), its routes recorded too
    log_gen = _RoutingLog(engine)
    again = generate(engine, prompts, max_new_tokens=MOE_NEW_TOKENS, decode_chunk=MOE_NEW_TOKENS)
    log_gen.close()
    if again != tokens:
        failures.append("a: greedy generate is not repeatable")
    log_fd = _RoutingLog(engine)
    served = _first_decode_logits(engine, prompts, first)
    log_fd.close()
    res["first_decode_argmax_equal_served"] = sum(a == t[1] for a, t in zip(served.argmax(-1).tolist(), tokens))
    del engine
    torch.cuda.empty_cache()

    # the first decode step against the f32 reference along the served
    # routes; each served route held to the f32 router (MOE_ROUTE_SLACK)
    L = cfg.num_hidden_layers
    fed = [p + [f] for p, f in zip(prompts, first)]
    routes_fd = [log_fd.of(i, len(s), L) for i, s in enumerate(fed)]
    rows, deficit, disagree = _mixtral_f32(params, cfg, fed, [len(p) for p in prompts], routes=routes_fd)
    ref = torch.cat(rows)
    res["logits_l2_rel_err_vs_f32"] = _l2_rel(served, ref)
    res["logits_max_abs_err_vs_f32"] = (served - ref).abs().max().item()
    res["argmax_agree_vs_f32"] = int((served.argmax(-1) == ref.argmax(-1)).sum())
    route_limit = MOE_ROUTE_SLACK * res["logits_max_abs_err_vs_f32"]
    res["routes"] = dict(token_layers=sum(len(s) for s in fed) * L, disagree=disagree, max_deficit=deficit,
                         limit=route_limit)
    if not res["logits_l2_rel_err_vs_f32"] <= LOGITS_L2_TOL:
        failures.append(f"a: logits {res['logits_l2_rel_err_vs_f32']} from f32 (L2) > {LOGITS_L2_TOL}")
    if not deficit <= route_limit:
        failures.append(f"a: a served route falls {deficit} below the f32 router's second expert > {route_limit}")
    own, _, _ = _mixtral_f32(params, cfg, fed, [len(p) for p in prompts])
    res["logits_l2_rel_err_vs_f32_own_routes"] = _l2_rel(served, torch.cat(own))
    wrong, _, _ = _mixtral_f32(params, cfg, fed, [len(p) for p in prompts], routes=routes_fd, swap=True)
    res["control_swapped_experts_l2_rel_err"] = _l2_rel(served, torch.cat(wrong))
    if res["control_swapped_experts_l2_rel_err"] <= LOGITS_L2_TOL:
        failures.append("a: the logits check passes the f32 reference with experts 0 and 1 swapped")
    off_by_one = [[[[(e + 1) % cfg.num_local_experts for e in pick] for pick in pos] for pos in r] for r in routes_fd]
    _, res["routes"]["control_next_expert_deficit"], _ = _mixtral_f32(params, cfg, fed, [len(p) for p in prompts],
                                                                        routes=off_by_one)
    if res["routes"]["control_next_expert_deficit"] <= route_limit:
        failures.append("a: the route check passes every route moved to the next expert")

    # every served token teacher-forced along its served routes
    limit = TF_SLACK * res["logits_max_abs_err_vs_f32"]
    rows, deficit, disagree = _moe_teacher_forced(
        params, cfg, prompts, tokens, [log_gen.of(i, len(p) + len(t) - 1, L)
                                       for i, (p, t) in enumerate(zip(prompts, tokens))])
    gaps = _moe_gaps(rows, tokens)
    shifted = _moe_gaps(rows, [t[1:] + t[:1] for t in tokens])
    res["teacher_forced"] = dict(limit=limit, max_gap=gaps.max().item(), tokens=gaps.numel(),
                                 exact=int((gaps == 0).sum()), routes_disagree=disagree, routes_max_deficit=deficit,
                                 control_shifted_max_gap=shifted.max().item())
    if not gaps.max().item() <= limit:
        failures.append(f"a: a served token trails the f32 maximum by {gaps.max().item()} > {limit}")
    if not deficit <= route_limit:
        failures.append(f"a: a generated route falls {deficit} below the f32 router's second expert > {route_limit}")
    if shifted.max().item() <= limit:
        failures.append("a: the teacher-forced check passes the served tokens shifted by one")
    return res, tokens


def _moe_leg_b(params, cfg, dev, prompts, tokens_a, failures) -> dict:
    """Simulated gating at MOE_SIM_TEMPERATURE on leg a's prompts: prefill,
    then a decode loop whose first choices (8 x 32 tokens a layer) must follow
    ``simulated_expert_probs``; the control holds each layer to the next
    layer's distribution."""
    engine = _moe_engine(params, cfg, dev, simulated_gating=True, simulated_gating_temperature=MOE_SIM_TEMPERATURE)
    try:
        _prefill(engine, prompts)
        first = engine.put(list(range(len(prompts))), [[t[0]] for t in tokens_a]).argmax(-1).tolist()
        for m in engine.model.moes:
            m.reset_stats()
        t0 = time.perf_counter()
        loop = engine.decode_loop(list(range(len(prompts))), [[t] for t in first], MOE_NEW_TOKENS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = _moe_stats(engine)
    finally:
        disable_simulated_gating()
        del engine
        torch.cuda.empty_cache()
    L, E, n = cfg.num_hidden_layers, cfg.num_local_experts, len(prompts) * MOE_NEW_TOKENS
    probs = [simulated_expert_probs(li, E, MOE_SIM_TEMPERATURE).double() for li in range(L)]

    def off(counts, p):
        share = torch.tensor(counts, dtype=torch.float64) / n
        return ((share - p).abs() - MOE_SIM_SIGMAS * (p * (1 - p) / n).sqrt() - 1 / n).max().item()

    worst = [off(c, probs[li]) for li, c in enumerate(stats["first_choice_counts"])]
    control = [off(c, probs[(li + 1) % L]) for li, c in enumerate(stats["first_choice_counts"])]
    sim_tokens = [[f] + row.tolist() for f, row in zip(first, loop)]
    res = dict(temperature=MOE_SIM_TEMPERATURE, decoded_tokens=n, decode_loop_s=secs, excess_over_bound=worst,
               control_next_layer_excess=control, probs=[p.tolist() for p in probs],
               tokens_differ_from_a=sum(a[1:] != s[:MOE_NEW_TOKENS - 1] for a, s in zip(tokens_a, sim_tokens)),
               **stats)
    if max(worst) > 0:
        failures.append(f"b: a layer's first choices leave simulated_expert_probs: excess {worst}")
    if max(control) <= 0:
        failures.append("b: the histogram check passes every layer against the next layer's distribution")
    if res["tokens_differ_from_a"] == 0:
        failures.append("b: simulated gating served leg a's tokens: the routing did not change")
    return res


def moe_rank_child(work, device="cuda:0") -> int:
    """One rank of leg c, started through the launcher: joins the gloo group,
    waits for the parent's plan, draws its experts of the seed-0 weights,
    serves its requests through generate on an EP engine, leaves the group,
    then serves again for MOE_CONTROL_TOKENS with rank 1's experts swapped
    (the control); writes its readings."""
    from deepspeed_tpu_torch import comm
    dev = torch.device(device)
    comm.init_distributed(dist_backend="gloo", device=dev, verbose=False)
    rank, world = comm.get_rank(), comm.get_world_size()
    deadline = time.monotonic() + MOE_TIMEOUT_S
    while not os.path.exists(os.path.join(work, "go")):
        if time.monotonic() > deadline:
            raise TimeoutError("leg c: no plan from the parent")
        time.sleep(0.2)
    with open(os.path.join(work, "go")) as f:
        plan = json.load(f)
    cfg = mixtral_config()
    per = cfg.num_local_experts // world
    t0 = time.perf_counter()
    params = _moe_params(cfg, dev, experts=(rank * per, (rank + 1) * per))
    torch.cuda.synchronize()
    out = dict(rank=rank, params=sum(p.numel() for p in params.values()), init_s=time.perf_counter() - t0)
    comm.configure(enabled=True)
    runs = {}
    for run, new_tokens in (("main", MOE_NEW_TOKENS), ("control", MOE_CONTROL_TOKENS)):
        if run == "control" and rank == 1:
            for li in range(cfg.num_hidden_layers):
                for bank in ("wi", "wo"):
                    t = params[f"layers.{li}.block_sparse_moe.experts.{bank}"]
                    t.copy_(t.flip(0))
        engine = _moe_engine(params, cfg, dev, ep=world)
        exchanged = []
        inner = engine.model.ep_sync.exchange
        engine.model.ep_sync.exchange = lambda n, inner=inner: exchanged.append(inner(n)) or exchanged[-1]
        comm.comm.comms_logger.comms_dict.clear()
        for m in engine.model.moes:
            m.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        routing = _RoutingLog(engine)
        tokens = generate(engine, plan["prompts"][rank], max_new_tokens=new_tokens, decode_chunk=new_tokens)
        routing.close()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        empty_runs = engine.leave_expert_group()
        a2a = comm.comm.comms_logger.comms_dict.get("all_to_all_single", {})
        runs[run] = dict(tokens=tokens, routes=[[u, p, li, *e] for (u, p), layers in routing.routes.items()
                                                for li, e in layers.items()],
                         serve_s=serve_s, empty_runs=empty_runs, forwards=len(exchanged),
                         exchanged=exchanged, a2a_count=sum(v[0] for v in a2a.values()),
                         a2a_bytes=sum(size * v[0] for size, v in a2a.items()),
                         a2a_ms=sum(sum(v[1]) for v in a2a.values()),
                         host_staged={op: list(v) for op, v in comm.comm.comms_logger.host_staged.items()},
                         **_moe_stats(engine))
        engine.close()
        del engine
        torch.cuda.empty_cache()
    out["runs"] = runs
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    comm.destroy_process_group()
    return 0


def _moe_predicted_a2a_bytes(cfg, exchanged) -> int:
    """What a rank's two all-to-alls a MoE layer move, over its forwards:
    ``[E, C, M]`` bf16 each, C from each forward's exchanged token count."""
    moe = RaggedMoE(num_experts=cfg.num_local_experts, top_k=cfg.num_experts_per_tok, capacity_factor=MOE_CAPACITY)
    return sum(2 * cfg.num_hidden_layers * cfg.num_local_experts * moe.capacity(t) * cfg.hidden_size * 2
               for t in exchanged)


def _moe_leg_c(params, cfg, prompts, tokens_a, limit, route_limit, proc, work, failures) -> dict:
    """EP over two ranks (started before leg a, waiting on the plan): leg a's
    requests split across them; each request's greedy tokens held to leg a's
    or, where they differ (the ranks' batches, and so bf16's rounding and a
    near-tie route, differ from leg a's), teacher-forced through f32 along
    the ranks' routes within ``limit`` (each route within ``route_limit`` of
    the f32 router's choice); no assignment dropped, the
    all-to-all bytes to the count predicted from C, E, M and the layers, the
    rank done first seen running more than one empty forward; the control
    (rank 1's experts swapped) must fail the teacher-forced check."""
    split = [[i for i in range(len(prompts)) if i % 3 == 0], [i for i in range(len(prompts)) if i % 3 != 0]]
    t0 = time.perf_counter()
    with open(os.path.join(work, "go.tmp"), "w") as f:
        json.dump({"prompts": [[prompts[i] for i in idx] for idx in split]}, f)
    os.rename(os.path.join(work, "go.tmp"), os.path.join(work, "go"))
    rc, out, err = _finish(proc, timeout=MOE_TIMEOUT_S)
    if rc != 0:
        raise AssertionError(f"moe c: the ranks failed (exit {rc}): {err[-3000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    res = dict(wall_s=time.perf_counter() - t0, split=split, ranks=ranks)

    def by_request(run):
        """Each request's tokens and served routes ``[len, layers, 2]`` (rank
        r's uid j is its j-th request: a fresh scheduler counts from 0)."""
        tokens, routes = [None] * len(prompts), [None] * len(prompts)
        for idx, r in zip(split, ranks):
            got = r["runs"][run]
            table = {(u, p, li): e for u, p, li, *e in got.pop("routes")}
            for j, (i, t) in enumerate(zip(idx, got["tokens"])):
                tokens[i] = t
                routes[i] = [[table[(j, p, li)] for li in range(cfg.num_hidden_layers)]
                             for p in range(len(prompts[i]) + len(t) - 1)]
        return tokens, routes

    main = [r["runs"]["main"] for r in ranks]
    for r, run in enumerate(main):
        if run["dropped"]:
            failures.append(f"c: rank {r} dropped {run['dropped']} assignments")
        run["a2a_bytes_predicted"] = _moe_predicted_a2a_bytes(cfg, run["exchanged"])
        run["a2a_count_predicted"] = 2 * cfg.num_hidden_layers * run["forwards"]
        if (run["a2a_bytes"], run["a2a_count"]) != (run["a2a_bytes_predicted"], run["a2a_count_predicted"]):
            failures.append(f"c: rank {r} moved {run['a2a_bytes']} bytes in {run['a2a_count']} all-to-alls, "
                            f"predicted {run['a2a_bytes_predicted']} in {run['a2a_count_predicted']}")
    if main[0]["exchanged"] != main[1]["exchanged"]:
        failures.append("c: the ranks ran different forwards")
    if max(run["empty_runs"] for run in main) <= 1:
        failures.append(f"c: the rank done first ran {[run['empty_runs'] for run in main]} empty forwards")
    served, routes = by_request("main")
    control, control_routes = by_request("control")
    res["tokens_equal_a"] = sum(s == a for s, a in zip(served, tokens_a))
    differ = [i for i in range(len(prompts)) if served[i] != tokens_a[i]]
    res["differ"] = differ
    if differ:
        rows, deficit, disagree = _moe_teacher_forced(params, cfg, [prompts[i] for i in differ],
                                                      [served[i] for i in differ], [routes[i] for i in differ])
        gaps = _moe_gaps(rows, [served[i] for i in differ])
        res["teacher_forced"] = dict(max_gap=gaps.max().item(), tokens=gaps.numel(), routes_disagree=disagree,
                                     routes_max_deficit=deficit)
        if not gaps.max().item() <= limit:
            failures.append(f"c: a served token trails the f32 maximum by {gaps.max().item()} > {limit}")
        if not deficit <= route_limit:
            failures.append(f"c: a served route falls {deficit} below the f32 router's second expert > "
                            f"{route_limit}")
    rows, deficit, _ = _moe_teacher_forced(params, cfg, prompts, control, control_routes)
    res["control_max_gap"] = _moe_gaps(rows, control).max().item()
    res["control_routes_max_deficit"] = deficit
    if res["control_max_gap"] <= limit:
        failures.append("c: the teacher-forced check passes the tokens served with rank 1's experts swapped")
    return res


@contextlib.contextmanager
def _gate_routes(num_experts, record=None, replay=None):
    """The training gates' expert choices: each one-hot of ``num_experts``
    classes that ``moe/sharded_moe.py`` makes (a gate's first and second
    experts, before capacity) appended to ``record`` as it is made, or,
    with ``replay``, those of a recorded run handed out in their place, in
    order."""
    inner = sharded_moe._one_hot
    handed = iter(replay or ())

    def one_hot(indices, num_classes):
        if num_classes != num_experts:
            return inner(indices, num_classes)
        if replay is not None:
            return next(handed)
        out = inner(indices, num_classes)
        record.append(out)
        return out

    sharded_moe._one_hot = one_hot
    try:
        yield
    finally:
        sharded_moe._one_hot = inner


@contextlib.contextmanager
def _token_nll(record):
    """Each token's loss (f32 negative log-likelihood, masked labels 0) of
    the Mixtral model's first loss in the block, appended to ``record``."""
    from deepspeed_tpu_torch.models import mixtral as mixtral_mod
    inner = mixtral_mod.cross_entropy_loss

    def loss(logits, labels):
        if not record:
            logp = torch.log_softmax(logits.detach().float(), dim=-1)
            valid = labels != -100
            ll = torch.gather(logp, -1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
            record.append((-(ll * valid)).cpu())
        return inner(logits, labels)

    mixtral_mod.cross_entropy_loss = loss
    try:
        yield
    finally:
        mixtral_mod.cross_entropy_loss = inner


def _moe_f32_step(cfg, dev, batch, replay=None, seeds=False, picks=None):
    """One forward (and, replaying routes, backward) of the f32 model from
    the seed-0 weights: the loss and gradient norm along ``replay``'s
    routes (with ``picks``, ``{name: flat indices}``, those entries of each
    named gradient too, and each token's loss), or with ``seeds`` the
    routes its own gates take under the engine's first noise seeds
    (returned recorded, no backward)."""
    with torch.device("meta"):
        model = MixtralForCausalLM(cfg)
    model.load_state_dict(_moe_params(cfg, dev, dtype=torch.float32), assign=True)
    ids = tuple(t.long() for t in batch)
    if replay is None:
        for i, m in enumerate(m for m in model.modules() if isinstance(m, MoE)):
            m.gating_seed = i if seeds else None
        own = []
        with torch.no_grad(), _gate_routes(cfg.num_local_experts, record=own):
            model(ids)
        return own
    nll = []
    with _gate_routes(cfg.num_local_experts, replay=replay), _token_nll(nll):
        loss = model(ids)
        loss.backward()
    out = dict(loss=loss.item(), grad_norm=torch.sqrt(sum(p.grad.float().pow(2).sum()
                                                          for p in model.parameters())).item())
    if picks is not None:
        out["picked_grads"] = {n: model.get_parameter(n).grad.reshape(-1)[idx.to(dev)].tolist()
                               for n, idx in picks.items()}
        out["token_nll"] = nll[0].tolist()
    del model, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_leg_d(dev, failures) -> dict:
    """Training: MixtralForCausalLM at the same widths cut to
    MOE_TRAIN_LAYERS, through initialize and train_batch at ZeRO 3 on one
    rank (B 1, S MOE_TRAIN_S, AdamW, bf16 over f32 masters), its gates'
    noise on. The first step's loss and gradient norm held to the same step
    in f32 within the training phase's limits, along the routes the bf16
    step's gates took (recorded; the f32 gates' own, under the same noise,
    are counted where they differ); every loss finite."""
    cfg = mixtral_config(MOE_TRAIN_LAYERS)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, size=(MOE_TRAIN_STEPS, 1, MOE_TRAIN_S + 1), dtype=np.int64)
    batches = [tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (b[:, :-1], b[:, 1:])) for b in ids]
    params = _moe_params(cfg, dev, dtype=torch.float32)
    res = dict(layers=cfg.num_hidden_layers, params=sum(p.numel() for p in params.values()), S=MOE_TRAIN_S,
               steps=MOE_TRAIN_STEPS)
    with torch.device("meta"):
        model = MixtralForCausalLM(cfg)
    config = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": TRAIN_LR}}, "zero_optimization": {"stage": 3},
              "bf16": {"enabled": True}}
    t0 = time.perf_counter()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, secs, norms = [], [], []
    routes = []
    for step, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _gate_routes(cfg.num_local_experts, record=routes) if step == 0 else contextlib.nullcontext():
            losses.append(engine.train_batch(batch=b).item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        norms.append(engine.get_global_grad_norm())
        if step == 0:
            res["max_memory_allocated_gib_step1"] = torch.cuda.max_memory_allocated() / 2**30
            # the same step in f32, between the engine's steps (its state
            # rests at about 25 GB then)
            ref = _moe_f32_step(cfg, dev, b, replay=routes)
            own = _moe_f32_step(cfg, dev, b, seeds=True)
            first = len(own)  # the forward's one-hots (then remat's replay of them)
            res["routes_disagree_f32_own"] = int(sum((a != o).any(-1).sum() for a, o in zip(routes[:first], own)))
            del own
    res.update(losses=losses, step_s=secs, grad_norms=norms, f32_first_step=ref,
               ms_per_step=1e3 * statistics.median(secs[1:]), tokens_per_s=MOE_TRAIN_S / statistics.median(secs[1:]),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               loss_rel_err=_rel(losses[0], ref["loss"]), grad_norm_rel_err=_rel(norms[0], ref["grad_norm"]))
    _free(engine)
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"d: losses {losses}")
    if not res["loss_rel_err"] <= LOSS_REL_TOL:
        failures.append(f"d: the first loss is {res['loss_rel_err']} from f32 > {LOSS_REL_TOL}")
    if not res["grad_norm_rel_err"] <= GRAD_NORM_REL_TOL:
        failures.append(f"d: the first gradient norm is {res['grad_norm_rel_err']} from f32 > {GRAD_NORM_REL_TOL}")
    return res


def run_moe_path(dev) -> dict:
    """Mixtral served and trained (legs a-d above). Leg c's two ranks start
    as soon as leg a's timed part is done, so that their imports overlap the
    rest of legs a and b."""
    t_phase = time.perf_counter()
    log(f"[moe] predicted: {MOE_PREDICTED_S:.0f} s for the phase")
    failures = []
    work = tempfile.mkdtemp(prefix="moe_ep_")
    procs = []

    def start_ranks():
        procs.append(_start(_ranks_cmd(["--moe-rank-child", work], world=2)))

    try:
        cfg = mixtral_config()
        t0 = time.perf_counter()
        params = _moe_params(cfg, dev)
        torch.cuda.synchronize()
        res = dict(layers=cfg.num_hidden_layers, params=sum(p.numel() for p in params.values()),
                   init_s=time.perf_counter() - t0, prompt_lens=list(MOE_PROMPT_LENS))
        prompts = _moe_prompts(cfg)
        t0 = time.perf_counter()
        res["a"], tokens = _moe_leg_a(params, cfg, dev, prompts, start_ranks, failures)
        res["a"]["seconds"] = time.perf_counter() - t0
        log("[moe] a: " + json.dumps(res["a"]))
        t0 = time.perf_counter()
        res["b"] = _moe_leg_b(params, cfg, dev, prompts, tokens, failures)
        res["b"]["seconds"] = time.perf_counter() - t0
        log("[moe] b: " + json.dumps(res["b"]))
        t0 = time.perf_counter()
        res["c"] = _moe_leg_c(params, cfg, prompts, tokens, res["a"]["teacher_forced"]["limit"],
                              res["a"]["routes"]["limit"], procs[0], work, failures)
        res["c"]["seconds"] = time.perf_counter() - t0
        log("[moe] c: " + json.dumps({k: v for k, v in res["c"].items() if k != "ranks"}) + " ranks: " +
            json.dumps([{k: v for k, v in r["runs"]["main"].items() if k not in ("tokens", "exchanged")}
                        for r in res["c"]["ranks"]]))
        log(f"[moe] failures so far: {failures}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["d"] = _moe_leg_d(dev, failures)
    res["d"]["seconds"] = time.perf_counter() - t0
    log("[moe] d: " + json.dumps(res["d"]))
    res["b1_launches"] = res["a"]["b1_launches"]
    res["seconds"] = time.perf_counter() - t_phase
    res["failures"] = failures
    a, c, d = res["a"], res["c"], res["d"]
    log(f"[moe] a: prefill {a['prefill_tokens_per_s']:.1f} tokens/s, decode {a['decode_tokens_per_s']:.1f} tokens/s, "
        f"B1 {a['b1_launches']} launches; traced decode put attn {a['traced_decode_put']['attn_us']} us, moe_ffn "
        f"{a['traced_decode_put']['moe_ffn_us']} us; logits {a['logits_l2_rel_err_vs_f32']:.4f} from f32")
    log(f"[moe] expert counts per layer: {a['expert_counts']}")
    log(f"[moe] c: tokens equal leg a's for {c['tokens_equal_a']} of {len(MOE_PROMPT_LENS)}; all-to-all bytes "
        f"{[r['runs']['main']['a2a_bytes'] for r in c['ranks']]}; empty forwards "
        f"{[r['runs']['main']['empty_runs'] for r in c['ranks']]}")
    log(f"[moe] d: {d['ms_per_step']:.1f} ms a step, {d['tokens_per_s']:.1f} tokens/s, losses {d['losses']}")
    log(f"[moe] {res['seconds']:.1f} s (predicted {MOE_PREDICTED_S:.0f})")
    log(card_line())
    if failures:
        raise AssertionError("moe phase: " + "; ".join(failures))
    return res


# ----------------------------------------------------------------- phase 9 --
def bench_llama(**kw) -> LlamaConfig:
    """bench.py's headline model: the 530M Llama (``_llama_530m``) with
    remat "dots" and flash attention."""
    base = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5376, num_hidden_layers=8,
                num_attention_heads=16, num_key_value_heads=16, max_position_embeddings=TRAIN_S, remat=True,
                remat_policy="dots", use_flash_attention=True, dtype=torch.bfloat16)
    base.update(kw)
    return LlamaConfig(**base)


def _train_engine(cfg, micro, gas, bf16, dev, optimizer=None, extra=None):
    """initialize() on the bench config: weights drawn on the card from seed
    0, AdamW (unless ``optimizer`` names another), ZeRO stage 3, bf16 over
    f32 masters (or f32 throughout), plus the ``extra`` config blocks."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    config = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
              "optimizer": optimizer or {"type": "AdamW", "params": {"lr": TRAIN_LR}},
              "zero_optimization": {"stage": 3}, "bf16": {"enabled": bf16}, **(extra or {})}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev)
    return engine


def _train_batches(cfg, dev):
    """bench.py's batches: np.random.default_rng(0), 8 global batches of
    [micro * gas, S] tokens, made up front and put on the card."""
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(8):
        ids = rng.integers(0, cfg.vocab_size, size=(TRAIN_MICRO * TRAIN_GAS, TRAIN_S + 1), dtype=np.int64)
        batches.append(tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], ids[:, 1:])))
    return batches


def _flash_launches():
    return {"fwd": fa.flash_attention_fwd.launches, "dkv": fa.flash_attention_bwd_dkv.launches,
            "dq": fa.flash_attention_bwd_dq.launches}


def _zero_flash_launches():
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd_dkv.launches = fa.flash_attention_bwd_dq.launches = 0


def _expected_flash_launches(steps, L):
    """Per train_batch: each of GAS micro-batches runs L attention forwards,
    L more in the remat recompute ("dots" saves only the projections), and L
    backwards of two launches."""
    return {"fwd": steps * TRAIN_GAS * 2 * L, "dkv": steps * TRAIN_GAS * L, "dq": steps * TRAIN_GAS * L}


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
    batches = _train_batches(cfg, dev)

    for i in range(TRAIN_WARMUP):
        engine.train_batch(batch=batches[i % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the measured steps: kernel launch counts zeroed just before, read just after
    _zero_flash_launches()
    times, losses = [], []
    for i in range(TRAIN_MEASURED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batches[(TRAIN_WARMUP + i) % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = _flash_launches()
    expected = _expected_flash_launches(TRAIN_MEASURED, L)
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


# ---------------------------------------------------------------- phase 10 --
# the checkpoint legs' depth cut: the bench model's width at 1 of its 8
# layers (2 layers wrote a 2.77 GB tag and 8 write 6.35 GB onto the 9p
# disk), so
# that the whole script, with the MoE phase, stays well inside its 1200 s
CKPT_LAYERS = 1  # cut: depth, from 2, for the card's time
CKPT_STEPS = 2  # steps after TRAIN_WARMUP before the save, and while the async commit runs
CKPT_RESUME = 3  # steps after the save, in run A and in the resumed run B
OPT_LAYERS = 1  # the optimizer leg's depth cut (from 2, for the card's time)
OPT_STEPS = 3
OPT_TINY_TOL = 1e-5  # card against CPU, f32, relative to each tensor's largest entry
# every optimizer but Adam/AdamW, at a lr that moves the bf16 weights in 3
# steps: Lamb's trust ratio scales its step by about |p| / |u| ~ 0.02, and
# SGD's step is lr times a gradient of about 1e-4 an entry; the 1-bit ones
# freeze after step 2, so step 3 runs compressed (a shorter warmup leaves
# the frozen variance of near-zero gradients tiny, and a compressed
# momentum of the tensor's mean size over it can raise the loss)
OPTIMIZERS = {
    "cpuadam": {"type": "CPUAdam", "params": {"lr": TRAIN_LR}},
    "lamb": {"type": "Lamb", "params": {"lr": 5e-3}},
    "lion": {"type": "Lion", "params": {"lr": TRAIN_LR}},
    "adagrad": {"type": "Adagrad", "params": {"lr": 1e-3}},
    "sgd": {"type": "SGD", "params": {"lr": 0.5, "momentum": 0.9}},
    "onebitadam": {"type": "OnebitAdam", "params": {"lr": TRAIN_LR, "freeze_step": 2}},
    "onebitlamb": {"type": "OnebitLamb", "params": {"lr": 5e-3, "freeze_step": 2}},
    "zerooneadam": {"type": "ZeroOneAdam", "params": {"lr": TRAIN_LR, "var_freeze_step": 2}},
}


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


@contextlib.contextmanager
def _timed_calls(module, names, out):
    """Add the seconds each named function of ``module`` takes to ``out``."""
    olds = {n: getattr(module, n) for n in names}

    def wrap(name, fn):

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                out[name] = out.get(name, 0.0) + time.perf_counter() - t0

        return timed

    for n, fn in olds.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield out
    finally:
        for n, fn in olds.items():
            setattr(module, n, fn)


def _state_of(engine):
    """Clones of the masters and every optimizer-state tensor, on the card."""
    return {path: t.clone() for path, t in ckpt._leaves({"params": engine.params, "opt_state": engine.opt_state})}


def _state_diff(engine, want):
    """Paths whose tensor is not bitwise ``want``'s."""
    got = dict(ckpt._leaves({"params": engine.params, "opt_state": engine.opt_state}))
    return [p for p, t in want.items() if p not in got or not torch.equal(got[p], t)]


def _masters_diff(engine, want):
    return [p for p in want if not torch.equal(engine.params[p], want[p])]


def _tag_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _steps(engine, batches, start, n, times=None):
    losses = []
    for i in range(start, start + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batches[i % len(batches)])))
        torch.cuda.synchronize()
        if times is not None:
            times.append(time.perf_counter() - t0)
    return losses


def _expect(cond, what):
    if not cond:
        raise AssertionError(f"checkpoint phase: {what}")


def _free(*engines):
    for e in engines:
        e.destroy()
    gc.collect()
    torch.cuda.empty_cache()


def _checkpoint_legs(dev, cfg, batches, save_dir, res):
    """Resume (sync), async, sentinel and preemption on the bench model, then
    the loud fallback with its controls (see run_checkpoint_path)."""
    L, k = cfg.num_hidden_layers, TRAIN_WARMUP + CKPT_STEPS
    # ---- resume: run A saves at step k and trains on; B resumes from the save
    a = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev)
    _steps(a, batches, 0, k)
    sync = {}
    with _timed_calls(ckpt, ("_host_snapshot", "array_checksums", "_write_state", "write_manifest"), sync):
        t0 = time.perf_counter()
        a.save_checkpoint(save_dir)
        sync["save_s"] = time.perf_counter() - t0
    tag_a = os.path.join(save_dir, f"global_step{k}")
    sync["bytes"] = _tag_bytes(tag_a)
    sync["GB_per_s"] = sync["bytes"] / sync["save_s"] / 1e9
    t0 = time.perf_counter()
    verdict = ckpt.verify_checkpoint(tag_a)
    sync["verify_s"] = time.perf_counter() - t0
    _expect(verdict[0] == "good", f"the sync save does not verify: {verdict}")
    res["sync_save"] = sync
    times_a = []
    losses_a = _steps(a, batches, k, CKPT_RESUME, times_a)
    masters_a = {n: p.clone() for n, p in a.params.items()}
    del a
    _free()

    nan_steps = [k + CKPT_RESUME + CKPT_STEPS, k + CKPT_RESUME + CKPT_STEPS + 1]
    with _env("DSTPU_TRAIN_FAULTS", json.dumps({"enabled": True, "nan_at_steps": nan_steps})):
        b = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev, extra={
            "nebula": {"enabled": True},
            "anomaly_sentinel": {"enabled": True, "max_consecutive": 2, "warmup_steps": 0}})
    t0 = time.perf_counter()
    path, _ = b.load_checkpoint(save_dir)
    res["load_s"] = time.perf_counter() - t0
    _expect(path == tag_a and b.global_steps == k, f"tag=None loaded {path} at step {b.global_steps}")
    times_b = []
    _zero_flash_launches()
    losses_b = _steps(b, batches, k, CKPT_RESUME, times_b)
    launches = _flash_launches()
    expected = _expected_flash_launches(CKPT_RESUME, L)
    res["resume"] = dict(losses_a=losses_a, losses_b=losses_b, flash_launches=launches,
                         expected_flash_launches=expected, masters_differ=_masters_diff(b, masters_a),
                         step_s_a=times_a, step_s_b=times_b)
    del masters_a
    _expect(launches == expected, f"resumed run's flash launches {launches} != predicted {expected}")
    _expect(losses_b == losses_a, f"resumed losses {losses_b} != uninterrupted {losses_a}")
    _expect(not res["resume"]["masters_differ"],
            f"{len(res['resume']['masters_differ'])} masters differ from the uninterrupted run's")

    # ---- async: dispatch at step k + CKPT_RESUME, CKPT_STEPS steps while it commits
    at_save = _state_of(b)
    s_async = b.global_steps
    wall0 = time.time()
    t0 = time.perf_counter()
    b.save_checkpoint(save_dir)
    dispatch_s = time.perf_counter() - t0
    in_flight = b._async_ckpt["thread"] is not None and b._async_ckpt["thread"].is_alive()
    times_async = []
    losses_async = _steps(b, batches, s_async, CKPT_STEPS, times_async)
    t0 = time.perf_counter()
    b.checkpoint_wait()
    wait_s = time.perf_counter() - t0
    tag_async = os.path.join(save_dir, f"global_step{s_async}")
    commit_s = os.path.getmtime(os.path.join(save_dir, ckpt.LATEST_FILE)) - wall0
    res["async_save"] = dict(dispatch_s=dispatch_s, commit_s=commit_s, wait_after_steps_s=wait_s,
                             in_flight_after_dispatch=in_flight, step_s_during_commit=times_async,
                             step_s_without=times_b, bytes=_tag_bytes(tag_async),
                             verdict=ckpt.verify_checkpoint(tag_async))
    _expect(in_flight, "the async save was not in flight after dispatch")
    _expect(res["async_save"]["verdict"][0] == "good", f"the async save does not verify: {res['async_save']}")
    _expect(ckpt.read_manifest(tag_async)["global_steps"] == s_async, "the async manifest is not the dispatch step's")

    # ---- sentinel: two poisoned steps (DSTPU_TRAIN_FAULTS), the second rolls back
    before = _state_of(b)
    s_nan = b.global_steps
    _expect(s_nan == nan_steps[0], f"the sentinel leg starts at step {s_nan}, not {nan_steps[0]}")
    poisoned = _steps(b, batches, s_nan, 1)
    skip = dict(loss=poisoned[0], skipped_steps=b.skipped_steps, anomalies=b._sentinel.anomalies,
                state_differs=_state_diff(b, before))
    t0 = time.perf_counter()
    _steps(b, batches, s_nan + 1, 1)
    rollback_s = time.perf_counter() - t0
    res["sentinel"] = dict(skip=skip, rollbacks=b._sentinel.rollbacks, rollback_step_s=rollback_s,
                           steps_after_rollback=b.global_steps, state_differs_from_async_save=_state_diff(b, at_save))
    _expect(not math.isfinite(skip["loss"]) and skip["skipped_steps"] == 1 and skip["anomalies"] == 1,
            f"the poisoned step was not skipped: {skip}")
    _expect(not skip["state_differs"], f"the skipped step changed {skip['state_differs'][:4]}")
    _expect(b._sentinel.rollbacks == 1 and b.global_steps == s_async,
            f"no rollback to the async tag: {res['sentinel']}")
    _expect(not res["sentinel"]["state_differs_from_async_save"], "the rollback did not restore the async save")
    # the async save resumes step-exact: the steps trained during its commit again
    res["async_save"]["losses_resumed"] = again = _steps(b, batches, s_async, CKPT_STEPS)
    _expect(again == losses_async, f"steps after the async tag {again} != during its commit {losses_async}")
    _expect(not _state_diff(b, before), "the run resumed from the async save diverged")

    # ---- preemption: SIGTERM between steps, the next step boundary exits
    prev = signal.getsignal(signal.SIGTERM)
    try:
        b.install_preemption_handler(save_dir)
        signal.raise_signal(signal.SIGTERM)
        t0 = time.perf_counter()
        try:
            b.train_batch(batch=batches[b.global_steps % len(batches)])
            raise AssertionError("checkpoint phase: SIGTERM did not raise TrainingPreempted")
        except TrainingPreempted as e:
            preempted = e
        preempt_s = time.perf_counter() - t0
    finally:
        signal.signal(signal.SIGTERM, prev)
    with open(os.path.join(save_dir, ckpt.PREEMPT_MARKER)) as f:
        marker = json.load(f)
    res["preemption"] = dict(tag=preempted.tag, step=preempted.step, code=preempted.code, marker=marker,
                             final_save_s=preempt_s)
    _expect(preempted.code == 143 and preempted.tag == f"preempt_step{s_nan}" == marker["tag"],
            f"preemption: {res['preemption']}")
    _free(b)
    del b

    g = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev)
    t0 = time.perf_counter()
    path, client = g.load_checkpoint(save_dir)
    res["preemption"]["resume_load_s"] = time.perf_counter() - t0
    res["preemption"]["state_differs"] = _state_diff(g, before)
    _expect(path.endswith(marker["tag"]) and g.global_steps == marker["global_steps"] and client == {"preempted": True},
            f"the resume from the marker loaded {path} at step {g.global_steps}")
    _expect(not res["preemption"]["state_differs"], "the preemption checkpoint does not resume step-exact")

    # ---- fallback: corrupt the newest tag's largest state file
    from deepspeed_tpu_torch import telemetry
    session = telemetry.configure({"enabled": True, "compile_watch": False})
    try:
        fallbacks = telemetry.get_registry().counter("checkpoint_load_fallbacks_total")
        newest = os.path.join(save_dir, marker["tag"])
        rel = TrainFaultInjector(TrainFaultConfig(enabled=True)).corrupt_checkpoint(newest, 0)
        n0 = fallbacks.value
        t0 = time.perf_counter()
        path, _ = g.load_checkpoint(save_dir)
        fall = dict(corrupted=rel, loaded=path, step=g.global_steps, fallbacks_counted=fallbacks.value - n0,
                    load_s=time.perf_counter() - t0, state_differs_from_async_save=_state_diff(g, at_save))
    finally:
        session.close()
    del at_save
    _expect(path == tag_async and g.global_steps == s_async and fall["fallbacks_counted"] == 1
            and not fall["state_differs_from_async_save"], f"tag=None over a corrupt newest tag: {fall}")
    try:
        g.load_checkpoint(save_dir, tag=marker["tag"])
        raise AssertionError("checkpoint phase: an explicit corrupt tag loaded")
    except ckpt.CheckpointCorruptionError as e:
        fall["explicit_tag_raises"] = str(e)[:200]
    _expect("CORRUPT" in fall["explicit_tag_raises"], fall["explicit_tag_raises"])
    # control: without verification the corrupt tag loads, and is not the saved state
    g._config.checkpoint_config.verify_on_load = False
    g.load_checkpoint(save_dir, tag=marker["tag"])
    g._config.checkpoint_config.verify_on_load = True
    fall["control_unverified_differs"] = _state_diff(g, before)
    _expect(len(fall["control_unverified_differs"]) == 1,
            f"control: the unverified corrupt load differs in {fall['control_unverified_differs'][:4]}")
    # a tag whose manifest is gone reads as torn, and an explicit load of it raises
    os.unlink(os.path.join(tag_async, ckpt.MANIFEST_FILE))
    fall["torn_verdict"] = ckpt.verify_checkpoint(tag_async)
    try:
        g.load_checkpoint(save_dir, tag=os.path.basename(tag_async))
        raise AssertionError("checkpoint phase: an explicit torn tag loaded")
    except ckpt.CheckpointCorruptionError as e:
        fall["torn_explicit_raises"] = str(e)[:200]
    _expect(fall["torn_verdict"][0] == "torn" and "TORN" in fall["torn_explicit_raises"], f"torn tag: {fall}")
    res["fallback"] = fall
    _free(g)
    del g


def _tiny_updates(spec, p0, grads, where):
    """init and one update a gradient tree on ``where``, in f32: every
    parameter and optimizer-state tensor by its key path."""
    opt = _make_optimizer(spec["type"], spec["params"])
    params = {k: torch.from_numpy(v).to(where) for k, v in p0.items()}
    state = opt.init(params)
    for g in grads:
        params, state = opt.update({k: torch.from_numpy(v).to(where) for k, v in g.items()}, state, params,
                                   spec["params"]["lr"])
    return dict(ckpt._leaves({"params": params, "opt_state": state}))


def _optimizer_legs(dev, batches, res):
    """Each optimizer but Adam/AdamW: the bench model cut to OPT_LAYERS, bf16,
    OPT_STEPS train_batch on one repeated batch (the loss must be finite and
    fall); then OPT_STEPS f32 updates of a tiny config's parameter tree on the
    card against the same updates on the CPU, with the same gradients on both
    (through a model the two devices' matmuls round apart, and a sign-based
    update turns a near-zero difference into a whole step)."""
    cfg = bench_llama(num_hidden_layers=OPT_LAYERS)
    tiny = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
    rng = np.random.default_rng(0)
    shapes = param_shapes(tiny)
    p0 = {k: rng.normal(scale=0.02, size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(scale=1e-3, size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(OPT_STEPS)]
    out = {}
    for name, spec in OPTIMIZERS.items():
        engine = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev, optimizer=spec)
        t0 = time.perf_counter()
        losses = [float(engine.train_batch(batch=batches[1])) for _ in range(OPT_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(t).all()) for _, t in ckpt._leaves({"p": engine.params, "s": engine.opt_state}))
        _free(engine)
        del engine
        card, host = (_tiny_updates(spec, p0, grads, where) for where in (dev, torch.device("cpu")))
        err = max(((card[p].cpu().double() - t.double()).abs().max() /
                   t.double().abs().max().clamp(min=1e-30)).item() for p, t in host.items())
        out[name] = dict(losses=losses, state_finite=finite, seconds=wall, tiny_card_vs_cpu_rel_err=err)
        log(f"[checkpoint] optimizer {name}: losses {losses}, card vs CPU {err:.2e}")
        _expect(finite and all(map(math.isfinite, losses)) and losses[-1] < losses[0], f"{name}: {out[name]}")
        _expect(err <= OPT_TINY_TOL, f"{name}: card against CPU {err} > {OPT_TINY_TOL}")
    res["optimizers"] = dict(layers=OPT_LAYERS, steps=OPT_STEPS, runs=out)


def run_checkpoint_path(dev) -> dict:
    """Checkpoints, the sentinel, preemption and the optimizers on the bench
    model (full width, cut to CKPT_LAYERS; the optimizer leg to OPT_LAYERS):

    - resume: run A trains TRAIN_WARMUP + CKPT_STEPS steps, saves (sync) and
      trains CKPT_RESUME more; a fresh engine B loads with tag=None and trains
      the same steps: losses and f32 masters bitwise A's, and the flash
      kernels launched as run_training_path predicts;
    - async (nebula.enabled): B saves, trains CKPT_STEPS steps while the
      commit runs, and waits;
    - sentinel: DSTPU_TRAIN_FAULTS poisons B's next two steps; the first is
      skipped (masters and optimizer state bitwise unchanged), the second
      rolls back to the async tag (bitwise its state), and the steps trained
      during the commit, trained again, give the same losses and state;
    - preemption: SIGTERM between steps; the next step writes
      preempt_step<N> and PREEMPTED.json and raises TrainingPreempted; a
      fresh engine resumes from the marker's tag, bitwise;
    - fallback: the newest tag's largest state file corrupted, a tag=None
      load falls back to the older tag (counted), an explicit load raises,
      and (the control) a load without verification loads the corrupt bytes;
      a tag without its manifest reads torn;
    - the optimizer legs (_optimizer_legs).
    """
    t_phase = time.perf_counter()
    cfg = bench_llama(num_hidden_layers=CKPT_LAYERS)
    batches = _train_batches(cfg, dev)
    root = tempfile.mkdtemp(prefix="dstt_ckpt_")
    res = dict(layers=cfg.num_hidden_layers, hidden=cfg.hidden_size, seq_len=TRAIN_S, micro_batch=TRAIN_MICRO,
               gas=TRAIN_GAS, save_dir_fs=subprocess.run(["df", "-T", root], capture_output=True,
                                                         text=True).stdout.strip().splitlines()[-1])
    try:
        t0 = time.perf_counter()
        _checkpoint_legs(dev, cfg, batches, os.path.join(root, "run"), res)
        res["checkpoint_legs_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    _optimizer_legs(dev, batches, res)
    res["optimizer_legs_s"] = time.perf_counter() - t0
    res["seconds"] = time.perf_counter() - t_phase
    log("[checkpoint] " + json.dumps(res, default=str))
    sync, asy = res["sync_save"], res["async_save"]
    log(f"[checkpoint] {sync['bytes'] / 1e9:.2f} GB a tag; sync save {sync['save_s']:.2f} s ({sync['GB_per_s']:.2f} GB/s: "
        f"snapshot {sync['_host_snapshot']:.2f} s, array CRC {sync['array_checksums']:.2f} s, write "
        f"{sync['_write_state']:.2f} s, file CRC + manifest {sync['write_manifest']:.2f} s); async dispatch "
        f"{asy['dispatch_s']:.2f} s, commit {asy['commit_s']:.2f} s; verify {sync['verify_s']:.2f} s; "
        f"load {res['load_s']:.2f} s; phase {res['seconds']:.1f} s")
    log(card_line())
    return res


# ---------------------------------------------------------------- phase 11 --
# fixed_linear from a quarter of the sequence (256) to all of it over 4 steps
FEAT_CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": TRAIN_S // 4,
                   "max_difficulty": TRAIN_S, "schedule_type": "fixed_linear",
                   "schedule_config": {"total_curriculum_step": 4, "difficulty_step": TRAIN_S // 4}}
FEAT_CURRICULUM_STEPS = 6
FEAT_SAMPLER_ROWS, FEAT_SAMPLER_STEPS, FEAT_PAD = 512, 2, 0
FEAT_PREFETCH_STEPS = 4
FEAT_TELEMETRY_STEPS = 4
FEAT_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}
FEAT_COMPRESSION_STEPS = 5
FEAT_COMPRESSION_MODULES = ["*q_proj*", "*down_proj*"]
FEAT_COMPRESSION = {
    "weight_quantization": {"shared_parameters": {"enabled": True, "schedule_offset": 2},
                            "different_groups": {"wq": {"params": {"target_bits": 8},
                                                        "modules": FEAT_COMPRESSION_MODULES}}},
    "sparse_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 3},
                       "different_groups": {"sp": {"params": {"dense_ratio": 0.5},
                                                   "modules": FEAT_COMPRESSION_MODULES}}},
}
FEAT_LAYERS = 2  # the phase's depth cut (from the bench model's 8, then 4; for the card's time)
FEAT_EIG_LAYERS = 2  # the eigenvalue leg's depth cut: the HVP's retained graph
# the engine's "eigenvalue" block: power iteration to the reference's
# stopping rule (loss_curvature itself stops after 8 iterations, as there)
FEAT_EIGENVALUE = {"enabled": True, "max_iter": 100, "tol": 1e-2}
# the HVP against (g(p + eps v) - g(p - eps v)) / 2 eps, f32 without TF32: the
# smallest relative L2 error over FEAT_FD_EPS within FEAT_FD_TOL; the controls
# (the product 10% too large, the product along another direction) exceed it
FEAT_FD_EPS = (1e-1, 3e-2, 1e-2)
FEAT_FD_TOL = 0.05


def _step_launches(engine, batch):
    """One timed train_batch: (loss, seconds, B2-B4 launches in it)."""
    _zero_flash_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(engine.train_batch(batch=batch))
    torch.cuda.synchronize()
    return loss, time.perf_counter() - t0, _flash_launches()


def _add(total, launches):
    for k, n in launches.items():
        total[k] += n


def _seq_lengths(engine):
    """The sequence length of every micro-batch the model sees."""
    seen = []
    engine.module.register_forward_pre_hook(lambda m, args: seen.append(int(args[0][0].shape[1])))
    return seen


def _ulps(got, want):
    """The largest distance of ``got`` from ``want``, in f32 ulps of ``want``."""
    want = want.float()
    spacing = torch.nextafter(want.abs(), torch.tensor(float("inf"))) - want.abs()
    return float(((got.float() - want).abs() / spacing).max())


def _curriculum_leg(dev, cfg, batches, total, failures):
    """Curriculum on from 256 to 1024, then the control without it (and with
    PLD on, whose θ is checked after the control's steps); then the offline
    index leg on the control engine."""
    L, out = cfg.num_hidden_layers, {}
    for name, extra in (("curriculum", {"curriculum_learning": dict(FEAT_CURRICULUM)}),
                        ("control", {"progressive_layer_drop": dict(FEAT_PLD)})):
        engine = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev, extra=extra)
        seen = _seq_lengths(engine)
        steps = []
        for i in range(FEAT_CURRICULUM_STEPS):
            predicted = engine.curriculum_scheduler.get_difficulty(engine.global_steps + 1) \
                if engine.curriculum_scheduler is not None else TRAIN_S
            n_seen = len(seen)
            loss, secs, launches = _step_launches(engine, batches[i % len(batches)])
            _add(total, launches)
            lengths = set(seen[n_seen:])
            steps.append(dict(seq_len=sorted(lengths), predicted=predicted, loss=loss, seconds=secs,
                              tokens_per_s=TRAIN_MICRO * TRAIN_GAS * predicted / secs, launches=launches))
            if lengths != {predicted}:
                failures.append(f"{name} step {i}: sequence lengths {sorted(lengths)} != predicted {predicted}")
            if launches != _expected_flash_launches(1, L):
                failures.append(f"{name} step {i}: B2-B4 launches {launches} != {_expected_flash_launches(1, L)}")
            if not math.isfinite(loss):
                failures.append(f"{name} step {i}: loss {loss}")
        out[name] = steps
        if name == "control":
            # where a short step's time goes: the same model at the shortest
            # curriculum length, profiled (run_training_path profiles the
            # full length)
            _zero_flash_launches()
            prof = _profile_train_batch(engine, tuple(x[:, :FEAT_CURRICULUM["min_difficulty"]] for x in batches[0]))
            _add(total, _flash_launches())
            out["profile_shortest"] = {k: prof[k] for k in ("wall_ms", "device_ms", "device_busy_share",
                                                            "flash_kernels_ms")}
            theta = engine.get_pld_theta()
            want = (1.0 - FEAT_PLD["theta"]) * math.exp(-FEAT_PLD["gamma"] * engine.global_steps) + FEAT_PLD["theta"]
            out["pld"] = dict(steps=engine.global_steps, theta=theta, formula=want)
            if not abs(theta - want) <= 1e-12:
                failures.append(f"PLD theta {theta} != {want} after {engine.global_steps} steps")
            out["sampler"] = _sampler_leg(engine, cfg, total, failures)
        _free(engine)
        del engine
    if [s["predicted"] for s in out["curriculum"]] != [q * TRAIN_S // 4 for q in (1, 2, 3, 4, 4, 4)]:
        failures.append(f"curriculum lengths {[s['predicted'] for s in out['curriculum']]}")
    return out


def _sampler_leg(engine, cfg, total, failures):
    """Token rows of seeded lengths (the rest PAD) in an MMapIndexedDataset,
    DataAnalyzer's non-pad count as the difficulty, DeepSpeedDataSampler's
    batches into train_batch: every sampled row within the step's
    difficulty."""
    root = tempfile.mkdtemp(prefix="dstt_data_")
    try:
        rng = np.random.default_rng(12)
        builder_ = MMapIndexedDatasetBuilder(os.path.join(root, "corpus"), dtype=np.int32)
        for _ in range(FEAT_SAMPLER_ROWS):
            row = np.full(TRAIN_S + 1, FEAT_PAD, np.int32)
            n = int(rng.integers(TRAIN_S // 16, TRAIN_S + 2))
            row[:n] = rng.integers(1, cfg.vocab_size, size=n)
            builder_.add_item(row)
        builder_.finalize()
        ds = MMapIndexedDataset(os.path.join(root, "corpus"))
        t0 = time.perf_counter()
        DataAnalyzer(ds, ["seqlen"], [lambda s: int((s != FEAT_PAD).sum())], save_path=os.path.join(root, "index"),
                     num_threads=4).run_map_reduce()
        analyze_s = time.perf_counter() - t0
        difficulties = DataAnalyzer.load_difficulties(os.path.join(root, "index"), "seqlen")
        sampler = DeepSpeedDataSampler(difficulties, TRAIN_MICRO * TRAIN_GAS,
                                       CurriculumScheduler(dict(FEAT_CURRICULUM)), seed=0)
        steps = []
        for _ in range(FEAT_SAMPLER_STEPS):
            idx = sampler.next_batch()
            limit = sampler.scheduler.get_current_difficulty()
            rows = np.stack([ds[int(i)] for i in idx])
            labels = np.where(rows[:, 1:] == FEAT_PAD, -100, rows[:, 1:])
            batch = tuple(torch.from_numpy(x.astype(np.int32)).to(engine.device) for x in (rows[:, :-1], labels))
            loss, secs, launches = _step_launches(engine, batch)
            _add(total, launches)
            worst = int(difficulties[idx].max())
            steps.append(dict(difficulty=limit, rows=len(idx), max_row_difficulty=worst, loss=loss, seconds=secs,
                              launches=launches))
            if worst > limit or not math.isfinite(loss):
                failures.append(f"sampler: a row of difficulty {worst} at difficulty {limit}, loss {loss}")
        return dict(rows=FEAT_SAMPLER_ROWS, eligible_at_first=int((difficulties <= TRAIN_S // 4).sum()),
                    analyze_s=analyze_s,
                    steps=steps)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _host_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, size=(TRAIN_MICRO * TRAIN_GAS, TRAIN_S + 1), dtype=np.int64)
        out.append(tuple(torch.from_numpy(x.astype(np.int32)) for x in (ids[:, :-1], ids[:, 1:])))
    return out


def _prefetch_and_telemetry_legs(dev, cfg, total, failures):
    """Prefetch: PrefetchingLoader(depth=2) against train_batch(batch=...) on
    the same host batches from the same starting state, alternated. Then
    telemetry: an engine with it on alternated with the direct engine."""
    host = _host_batches(cfg, FEAT_PREFETCH_STEPS, seed=31)
    direct = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev)
    staged = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev)
    it = iter(PrefetchingLoader(host, staged, depth=2))
    pf = dict(direct=[], prefetch=[])
    for i in range(FEAT_PREFETCH_STEPS):
        pf["direct"].append(_step_launches(direct, host[i]))
        item = next(it)
        if not isinstance(item, StagedBatch) or item.event is None:
            failures.append(f"prefetch step {i}: {type(item).__name__} without a staging event")
        pf["prefetch"].append(_step_launches(staged, item))
    for leg in pf.values():
        for _, _, launches in leg:
            _add(total, launches)
    out = {"prefetch": dict(
        losses_direct=[x[0] for x in pf["direct"]], losses_prefetch=[x[0] for x in pf["prefetch"]],
        step_s_direct=[x[1] for x in pf["direct"]], step_s_prefetch=[x[1] for x in pf["prefetch"]],
        launches_direct=[x[2] for x in pf["direct"]], launches_prefetch=[x[2] for x in pf["prefetch"]])}
    p = out["prefetch"]
    p["median_s_direct"], p["median_s_prefetch"] = statistics.median(p["step_s_direct"]), statistics.median(
        p["step_s_prefetch"])
    p["prefetch_minus_direct_s"] = p["median_s_prefetch"] - p["median_s_direct"]
    if p["losses_direct"] != p["losses_prefetch"] or p["launches_direct"] != p["launches_prefetch"]:
        failures.append(f"prefetch differs from direct: {p}")
    _free(staged)
    del staged

    root = tempfile.mkdtemp(prefix="dstt_tel_")
    try:
        tel_cfg = {"telemetry": {"enabled": True, "jsonl_path": os.path.join(root, "train.jsonl")}}
        tel = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev, extra=tel_cfg)
        spans_before = len(telemetry.get_span_recorder().tail(1 << 16))
        rows = dict(on=[], off=[])
        batches = _host_batches(cfg, FEAT_TELEMETRY_STEPS, seed=32)
        for i in range(FEAT_TELEMETRY_STEPS):
            rows["off"].append(_step_launches(direct, batches[i]))
            rows["on"].append(_step_launches(tel, batches[i]))
        for leg in rows.values():
            for _, _, launches in leg:
                _add(total, launches)
        spans = telemetry.get_span_recorder().tail(1 << 16)[spans_before:]
        snap = telemetry.get_registry().snapshot()
        tel.destroy()
        events = [json.loads(line) for line in open(os.path.join(root, "train.jsonl"))]
        steps = [e for e in events if e.get("event") == "train_step"]
        losses = [x[0] for x in rows["on"]]
        t = dict(step_s_on=[x[1] for x in rows["on"]], step_s_off=[x[1] for x in rows["off"]],
                 train_step_events=len(steps), event_losses=[e["loss"] for e in steps], losses=losses,
                 train_batch_spans=sum(s["name"] == TRAIN_BATCH_TIMER for s in spans),
                 gauges={k: snap[k][0][1] for k in ("train_loss", "train_global_steps", "train_lr",
                                                    "train_grad_norm", "train_samples_per_sec") if k in snap})
        t["median_s_on"], t["median_s_off"] = statistics.median(t["step_s_on"]), statistics.median(t["step_s_off"])
        t["cost_per_step_s"] = t["median_s_on"] - t["median_s_off"]
        out["telemetry"] = t
        if t["event_losses"] != losses or t["train_batch_spans"] != FEAT_TELEMETRY_STEPS:
            failures.append(f"telemetry: events {t['event_losses']} against losses {losses}, "
                            f"{t['train_batch_spans']} train_batch spans")
        if len(t["gauges"]) != 5 or t["gauges"].get("train_global_steps") != FEAT_TELEMETRY_STEPS or \
                t["gauges"].get("train_loss") != losses[-1]:
            failures.append(f"telemetry gauges {t['gauges']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _free(direct, tel)
    del direct, tel
    return out


def _compression_leg(dev, cfg, batches, total, failures):
    """Weight quantization at step 2 and sparse pruning at step 3 on the
    q_proj and down_proj masters: each transform's result on the card
    against init_compression of a host copy of the masters taken just before
    it, on the CPU; then the curvature probe on this flash model must raise
    (C8)."""
    L = cfg.num_hidden_layers
    engine = _train_engine(cfg, TRAIN_MICRO, TRAIN_GAS, True, dev,
                           extra={"compression_training": copy.deepcopy(FEAT_COMPRESSION)})
    layout = reference_names(engine.module)
    # the tensors the patterns name (by the JAX package's names): host copies
    # of these, device copies of the rest
    named = [k for k, (ref, _) in layout.items() if any(fnmatch.fnmatch(ref, p) for p in FEAT_COMPRESSION_MODULES)]
    applied, apply = [], engine.apply_compression_transform

    def spy(sub_cfg):
        host = {k: engine.params[k].detach().cpu() for k in named}
        rest = {k: v.clone() for k, v in engine.params.items() if k not in host}
        apply(sub_cfg)
        t0 = time.perf_counter()
        want = init_compression(host, sub_cfg, layout=layout)
        cpu_s = time.perf_counter() - t0
        changed = [k for k in want if want[k] is not host[k]]
        ulps = max(_ulps(engine.params[k].cpu(), want[k]) for k in changed)
        untouched = all(torch.equal(engine.params[k], t) for k, t in rest.items())
        applied.append(dict(step=engine.global_steps, techniques=sorted(sub_cfg["compression_training"]),
                            tensors=len(changed), max_ulps=ulps, others_unchanged=untouched, cpu_s=cpu_s))

    engine.apply_compression_transform = spy
    steps = []
    for i in range(FEAT_COMPRESSION_STEPS):
        loss, secs, launches = _step_launches(engine, batches[i % len(batches)])
        _add(total, launches)
        q, down = engine.params["layers.0.self_attn.q_proj.weight"], engine.params["layers.0.mlp.down_proj.weight"]
        steps.append(dict(loss=loss, seconds=secs, launches=launches,
                          q_proj_levels_col0=int(torch.unique(q[0]).numel()),
                          down_proj_zero_share=float((down == 0).float().mean())))
        if launches != _expected_flash_launches(1, L) or not math.isfinite(loss):
            failures.append(f"compression step {i}: launches {launches}, loss {loss}")
    out = dict(steps=steps, applied=applied)
    if [(a["step"], a["techniques"]) for a in applied] != [(2, ["weight_quantization"]), (3, ["sparse_pruning"])]:
        failures.append(f"compression applied {applied}")
    for a in applied:
        if a["tensors"] != 2 * L or not a["max_ulps"] <= 1.0 or not a["others_unchanged"]:
            failures.append(f"compression at step {a['step']}: {a}")
    rows = cfg.hidden_size  # q_proj's input features: its values along a column of the flax kernel
    if steps[0]["q_proj_levels_col0"] != rows or not steps[1]["q_proj_levels_col0"] <= 256:
        failures.append(f"q_proj levels along a channel, steps 1 and 2: {steps[0]['q_proj_levels_col0']}, "
                        f"{steps[1]['q_proj_levels_col0']} (all {rows} distinct before the offset, at most 256 after)")

    # C8: a second derivative through B2-B4 raises
    _zero_flash_launches()
    try:
        engine.loss_curvature()
        failures.append("loss_curvature on the flash model did not raise")
        out["c8"] = "no raise"
    except RuntimeError as e:
        out["c8"] = str(e)[:200]
        if "once_differentiable" not in str(e):
            failures.append(f"loss_curvature on the flash model raised another error: {e}")
    out["c8_launches"] = _flash_launches()
    _add(total, out["c8_launches"])
    _free(engine)
    del engine
    return out


def _fd_hvp(engine, v, eps):
    """(g(p + eps v) - g(p - eps v)) / 2 eps of the engine's loss at its kept
    micro-batch, through the masters, recomputation off."""
    grads = []
    for sign in (1.0, -1.0):
        p = {n: (t + sign * eps * v[n]).requires_grad_() for n, t in engine.params.items()}
        with recompute_disabled():
            loss = functional_call(engine.module, {n: t.to(engine.compute_dtype) for n, t in p.items()},
                                   (engine._last_batch, ))
        grads.append(dict(zip(p, torch.autograd.grad(loss, list(p.values())))))
    return {n: (grads[0][n] - grads[1][n]) / (2 * eps) for n in engine.params}


def _rel_l2(a, b):
    num = math.sqrt(sum(float(((a[n] - b[n]).double()**2).sum()) for n in b))
    return num / math.sqrt(sum(float((b[n].double()**2).sum()) for n in b))


def _eigenvalue_leg(dev, batches, failures):
    """loss_curvature on the bench width cut to FEAT_EIG_LAYERS, f32, plain
    attention: finite, converged; its HVP against a central difference (and
    the recomputed HVP, the control); the eigenvalue gate below and above the
    probed value."""
    cfg = bench_llama(num_hidden_layers=FEAT_EIG_LAYERS, use_flash_attention=False, dtype=torch.float32)
    one = tuple(x[:TRAIN_MICRO] for x in batches[0])
    engine = _train_engine(cfg, TRAIN_MICRO, 1, False, dev, extra={"eigenvalue": dict(FEAT_EIGENVALUE)})
    engine.forward(one)  # keeps the micro-batch the probes use
    engine.zero_grad()  # and drops the forward's graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    curvature = engine.loss_curvature()
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    eig, loss_fn, cache = engine._eig_state
    out = dict(layers=FEAT_EIG_LAYERS, curvature=curvature, probe_raw=eig.last_raw, probe_iters=eig.last_iters,
               probe_s=probe_s)
    # the configured power iteration, on the probe's loss and HVP closures
    t0 = time.perf_counter()
    vals = engine.eigenvalue.compute_eigenvalue(loss_fn, engine._eigenvalue_blocks(engine.params), engine._last_batch,
                                                generator=torch.Generator(dev).manual_seed(1), hvp_cache=cache)
    torch.cuda.synchronize()
    ev = engine.eigenvalue
    out.update(values=vals, raw=ev.last_raw, iters=ev.last_iters, converged=ev.last_converged,
               max_iter=ev.max_iter, tol=ev.tol, converge_s=time.perf_counter() - t0)
    if not (curvature is not None and math.isfinite(curvature) and all(map(math.isfinite, eig.last_raw.values()))
            and all(map(math.isfinite, ev.last_raw.values())) and all(ev.last_converged.values())):
        failures.append(f"eigenvalue: {out}")

    names = sorted(engine.params)
    gen = torch.Generator(dev).manual_seed(5)
    v = {n: torch.randn(engine.params[n].shape, generator=gen, device=dev) for n in names}
    norm = math.sqrt(sum(float((t.double()**2).sum()) for t in v.values()))
    v = {n: t / norm for n, t in v.items()}
    block = {"model": {n: engine.params[n] for n in names}}
    hv = dict(zip(names, block_hvp(loss_fn, "model")(block, engine._last_batch, [v[n] for n in names])))
    fd = {eps: _rel_l2(hv, _fd_hvp(engine, v, eps)) for eps in FEAT_FD_EPS}
    out["hvp_vs_central_difference"] = {str(k): e for k, e in fd.items()}
    out["hvp_norm"] = math.sqrt(sum(float((t.double()**2).sum()) for t in hv.values()))
    if not min(fd.values()) <= FEAT_FD_TOL:
        failures.append(f"HVP against the central difference {fd} > {FEAT_FD_TOL}")

    # the controls, which the check must reject: the product 10% too large,
    # and the product along another direction
    best = min(FEAT_FD_EPS, key=fd.get)
    fd_best = _fd_hvp(engine, v, best)
    other = [torch.randn(engine.params[n].shape, generator=gen, device=dev) for n in names]
    other_norm = math.sqrt(sum(float((t.double()**2).sum()) for t in other))
    hv_other = dict(zip(names, block_hvp(loss_fn, "model")(block, engine._last_batch,
                                                          [t / other_norm for t in other])))
    out["controls_vs_central_difference"] = ctl = {
        "scaled_1.1": _rel_l2({n: 1.1 * t for n, t in hv.items()}, fd_best),
        "other_direction": _rel_l2(hv_other, fd_best)}
    if not min(ctl.values()) > FEAT_FD_TOL:
        failures.append(f"a control passes the HVP check: {ctl}")
    _free(engine)
    del engine, hv, hv_other, fd_best, v, block

    # the gate: threshold below the probed value stays off, above it turns on
    gate = {}
    for threshold in (0.5 * curvature, 2.0 * curvature):
        comp = {"weight_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": 1, "eigenvalue_gated": True,
                                  "eigenvalue_threshold": threshold},
            "different_groups": {"g": {"params": {"target_bits": 8}, "modules": ["*q_proj*"]}}}}
        gated = _train_engine(cfg, TRAIN_MICRO, 1, False, dev, extra={"compression_training": comp})
        loss = float(gated.train_batch(batch=one))
        t = gated.compression_scheduler.techniques["weight_quantization"]
        gate[str(threshold)] = dict(active=t["active"], probed=gated.compression_scheduler._last_curvature,
                                    loss=loss)
        _free(gated)
        del gated
    out["gate"] = gate
    if [g["active"] for g in gate.values()] != [False, True]:
        failures.append(f"eigenvalue gate {gate}")
    return out


def run_train_features_path(dev) -> dict:
    """The rest of training on the bench model (full width, FEAT_LAYERS
    layers; the eigenvalue leg cut to FEAT_EIG_LAYERS), B2-B4 in every train_batch with
    their launch counts zeroed just before each step and read just after:

    - curriculum: fixed_linear 256 -> 1024 over 4 steps, 6 steps: each step's
      sequence length is the scheduler's prediction and its launches
      _expected_flash_launches'; tokens/s at each length; the control without
      curriculum runs 1024 from the first step (with PLD on: θ after its
      steps equals the formula to 1e-12);
    - offline index: seeded token rows in an MMapIndexedDataset, DataAnalyzer's
      non-pad count, DeepSpeedDataSampler's batches into 2 steps, every row
      within the step's difficulty;
    - prefetch: PrefetchingLoader(depth=2) against train_batch on the same
      host batches from the same state, alternated: losses bitwise, the same
      launches; both step times;
    - telemetry: an engine with it on alternated with one without: one
      train_step event a step carrying the returned loss, the gauges, one
      train_batch span a step; the cost a step;
    - compression: 8-bit quantization at step 2, sparse pruning at step 3 of
      5, each transform on the card within 1 ulp of init_compression on the
      CPU of a host copy taken just before; loss_curvature on this flash
      model raises (C8);
    - eigenvalue (_eigenvalue_leg).
    """
    t_phase = time.perf_counter()
    cfg = bench_llama(num_hidden_layers=FEAT_LAYERS)
    batches = _train_batches(cfg, dev)
    failures = []
    total = {"fwd": 0, "dkv": 0, "dq": 0}
    res = dict(layers=cfg.num_hidden_layers, hidden=cfg.hidden_size, seq_len=TRAIN_S, micro_batch=TRAIN_MICRO,
               gas=TRAIN_GAS)
    for leg, fn in (("curriculum", lambda: _curriculum_leg(dev, cfg, batches, total, failures)),
                    ("loaders", lambda: _prefetch_and_telemetry_legs(dev, cfg, total, failures)),
                    ("compression", lambda: _compression_leg(dev, cfg, batches, total, failures)),
                    ("eigenvalue", lambda: _eigenvalue_leg(dev, batches, failures))):
        t0 = time.perf_counter()
        res[leg] = fn()
        res[leg + "_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    res["flash_launches"] = total
    res["seconds"] = time.perf_counter() - t_phase
    log("[features] " + json.dumps(res, default=str))
    cur, ctl = res["curriculum"]["curriculum"], res["curriculum"]["control"]
    log("[features] curriculum tokens/s by length: " + ", ".join(
        f"{s['predicted']}: {s['tokens_per_s']:.0f}" for s in cur) + f"; control at {TRAIN_S}: " +
        ", ".join(f"{s['tokens_per_s']:.0f}" for s in ctl))
    prof = res["curriculum"]["profile_shortest"]
    log(f"[features] one step at {FEAT_CURRICULUM['min_difficulty']} profiled: wall {prof['wall_ms']:.1f} ms, "
        f"device {prof['device_ms']:.1f} ms")
    log(f"[features] PLD theta {res['curriculum']['pld']['theta']:.15f} after {res['curriculum']['pld']['steps']} "
        f"steps; sampler rows within difficulty: "
        f"{[(s['max_row_difficulty'], s['difficulty']) for s in res['curriculum']['sampler']['steps']]}")
    p, t = res["loaders"]["prefetch"], res["loaders"]["telemetry"]
    log(f"[features] prefetch: median step {p['median_s_prefetch']:.4f} s against {p['median_s_direct']:.4f} s direct "
        f"({p['prefetch_minus_direct_s']:+.4f} s); telemetry: {t['median_s_on']:.4f} s on, {t['median_s_off']:.4f} s "
        f"off ({t['cost_per_step_s']:+.4f} s a step)")
    c, e = res["compression"], res["eigenvalue"]
    log(f"[features] compression: {[(a['step'], a['techniques'], a['max_ulps']) for a in c['applied']]}; C8: "
        f"{c['c8'][:80]}")
    log(f"[features] eigenvalue: raw {e['raw']} in {e['iters']} iterations ({e['probe_s']:.1f} s); HVP against "
        f"central differences {e['hvp_vs_central_difference']}, controls {e['controls_vs_central_difference']}; "
        f"gate {[(k, g['active']) for k, g in e['gate'].items()]}; phase {res['seconds']:.1f} s")
    log(card_line())
    if failures:
        raise AssertionError("train features phase: " + "; ".join(failures))
    return res


# ------------------------------------------------------------ zero phase --
# data-parallel ZeRO training across ranks (ROADMAP A8, first half). The
# card is one H100: NCCL runs at world 1, and two ranks share the card over
# gloo, named explicitly (NCCL refuses two ranks on one device; leg b records
# its error). No multi-GPU speed is measured.
# train_batch steps of each leg (a) and (b) run (cut: steps, from 3, so that
# the whole script stays inside its time with the parallel phase)
ZERO_STEPS = 2
ZERO_B = 8  # the global batch: 8 rows of TRAIN_S tokens, 4 + 4 over two ranks
ZERO_CUT_LAYERS = 2  # legs (b) and (c): bench.py's width at a cut depth
ZERO_GANG_STEPS = 4  # leg (c): the gang trains to this global step
ZERO_TIMEOUT_S = 400  # bound on every process the phase starts
# bf16 compute over f32 masters, AdamW at TRAIN_LR: each step moves a weight
# by about one lr either way. Two ranks each run the model on 4 of the 8 rows
# and their gradients are summed over gloo, where one process runs all 8 and
# sums in its matmuls, so bf16 rounds at other places: the losses agree to
# ~1e-3 relative, and where a gradient is near zero its sign may flip, which
# moves the weight by up to two lr against the other run, at each step.
# Held: the losses within ZERO_LOSS_REL_TOL, 99% of each tensor's weights
# within a third of an lr step, every weight within two lr a step. (An H100
# read 0.99852 and 3.19 lr against a first limit of ZERO_STEPS lr, which
# forgot the flip's factor 2.) The same program at
# world 1 over NCCL is the single-device engine's arithmetic: held to it
# bit for bit.
ZERO_LOSS_REL_TOL = 1e-2
ZERO_STATE_RATIO = 0.55  # stage 3: a rank's params + grads + optimizer bytes against world 1's


def _zero_batches(cfg, dev, seed=0):
    """ZERO_STEPS global batches of ZERO_B rows, np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ZERO_STEPS):
        ids = rng.integers(0, cfg.vocab_size, size=(ZERO_B, TRAIN_S + 1), dtype=np.int64)
        out.append(tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], ids[:, 1:])))
    return out


def _zero_engine(cfg, stage, dev, optimizer=None, extra=None):
    """initialize() on ``cfg``: weights drawn on the card from seed 0, the
    global batch ZERO_B (the micro-batch is ZERO_B over the data-parallel
    ranks), bf16 over f32 masters, ZeRO ``stage``."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    config = {"train_batch_size": ZERO_B, "gradient_accumulation_steps": 1,
              "optimizer": optimizer or {"type": "AdamW", "params": {"lr": TRAIN_LR}},
              "zero_optimization": {"stage": stage}, "bf16": {"enabled": True}, **(extra or {})}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev)
    return engine


def _zero_train(engine, batches):
    """The steps, B2-B4's launches zeroed just before and read just after."""
    torch.cuda.synchronize()
    _zero_flash_launches()
    t0 = time.perf_counter()
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    torch.cuda.synchronize()
    return losses, _flash_launches(), time.perf_counter() - t0


def _masters_close(got, want, share_min=0.99, steps=None):
    """{name: (share within a third of an lr step, max abs diff)} and the
    names outside ZERO's bf16 tolerance (at least ``share_min`` within a
    third of a step, none further than two lr for each of the ``steps``
    steps, ZERO_STEPS by default)."""
    stats, bad = {}, []
    for name, w in want.items():
        d = (got[name].float().to(w.device) - w).abs()
        share, top = float((d <= TRAIN_LR / 3).float().mean()), float(d.max())
        stats[name] = (share, top)
        if not (share >= share_min and top <= 2 * (steps or ZERO_STEPS) * TRAIN_LR):
            bad.append(name)
    return stats, bad


def _start(cmd, env=None):
    """A process group of its own, so a timeout stops every process it starts."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
                            env=dict(os.environ, **(env or {})))


def _finish(proc, timeout=ZERO_TIMEOUT_S):
    """(exit code, stdout, stderr); at ``timeout`` the whole group is killed
    and the exit code is None."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return None, out, err
    return proc.returncode, out, err


def _ranks_cmd(args, world=2):
    """``chip_smoke.py`` as ``world`` ranks through the port's launcher
    (``launcher/launch.py``: one child a slot, the environment contract)."""
    from deepspeed_tpu_torch.launcher.launch import encode_world_info
    return [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch", "--world_info",
            encode_world_info({"localhost": list(range(world))}), "--master_port", str(_free_port()),
            os.path.abspath(__file__)] + list(args)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _zero_nccl_world1(dev, failures) -> dict:
    """Leg (a): the comm layer over NCCL at world 1, then ZERO_STEPS ZeRO-3
    steps of the 530M bench model through it, against the single-device
    engine (no process group) on the same batches."""
    from deepspeed_tpu_torch import comm
    cfg = bench_llama()
    batches = _zero_batches(cfg, dev)
    comm.destroy_process_group()
    ref = _zero_engine(cfg, 3, dev)
    ref_losses, _, _ = _zero_train(ref, batches)
    want = {k: v.clone() for k, v in ref.params.items()}
    _free(ref)

    comm.destroy_process_group()  # the engine joined a world of one without a process group
    comm.init_distributed(dist_backend="nccl", verbose=False)
    res = {"backend": torch.distributed.get_backend(), "world": comm.get_world_size()}
    comm.configure(enabled=True)
    trips = {}
    for dtype in (torch.float32, torch.int32):
        x = torch.arange(4096, device=dev).reshape(64, 64).to(dtype) - 1000
        for op, fn in (("all_reduce", lambda t: comm.all_reduce(t.clone())),
                       ("all_gather_into_tensor", comm.all_gather_into_tensor),
                       ("reduce_scatter_tensor", comm.reduce_scatter_tensor),
                       ("broadcast", lambda t: comm.broadcast(t.clone(), src=0))):
            got = fn(x)
            trips[f"{op}_{str(dtype).removeprefix('torch.')}"] = bool(got.is_cuda and torch.equal(got, x))
    res["round_trips"] = trips
    res["comms_logged"] = sorted(comm.comm.comms_logger.comms_dict)
    comm.configure(enabled=False)
    comm.comm.comms_logger.comms_dict.clear()
    if res["backend"] != "nccl" or not all(trips.values()):
        failures.append(f"zero (a): NCCL round trips at world 1: backend {res['backend']}, {trips}")
    engine = _zero_engine(cfg, 3, dev)
    losses, launches, secs = _zero_train(engine, batches)
    diff = _masters_diff(engine, want)
    res.update(losses=losses, single_device_losses=ref_losses, masters_differing=diff, flash_launches=launches,
               steps_s=secs, params=sum(p.numel() for p in engine.params.values()))
    _free(engine)
    del want
    comm.destroy_process_group()
    L = cfg.num_hidden_layers
    expected = {k: v // TRAIN_GAS for k, v in _expected_flash_launches(ZERO_STEPS, L).items()}
    if losses != ref_losses or diff:
        failures.append(f"zero (a): the NCCL world-1 engine is not the single-device engine: losses {losses} vs "
                        f"{ref_losses}, {len(diff)} masters differ")
    if launches != expected:
        failures.append(f"zero (a): flash launches {launches} != predicted {expected}")
    return res


def _zero_two_ranks(dev, failures) -> dict:
    """Leg (b): two ranks on the card. NCCL first (its refusal recorded),
    then gloo, named, through the launcher: stages 1, 2 and 3 for ZERO_STEPS
    steps each at the cut depth, held to a world-1 run of the same program."""
    res = {}
    nccl = _start(_ranks_cmd(["--zero-rank-child", "nccl"]))  # beside the world-1 run below
    cfg = bench_llama(num_hidden_layers=ZERO_CUT_LAYERS)
    work = tempfile.mkdtemp(prefix="zero_b_")
    try:
        ref = _zero_engine(cfg, 3, dev)
        batches = _zero_batches(cfg, dev)
        torch.cuda.reset_peak_memory_stats()
        ref_losses, ref_launches, _ = _zero_train(ref, batches)
        res["world1"] = dict(losses=ref_losses, state_bytes=ref.state_bytes(), flash_launches=ref_launches,
                             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        torch.save({k: v.cpu() for k, v in ref.params.items()}, os.path.join(work, "world1_masters.pt"))
        with open(os.path.join(work, "world1.json"), "w") as f:
            json.dump(res["world1"], f)
        _free(ref)
        rc, out, err = _finish(nccl, timeout=120)
        lines = [ln for ln in (out + err).splitlines() if "ZERO_NCCL" in ln or "Duplicate GPU" in ln]
        res["nccl_two_ranks"] = {"exit_code": rc, "lines": lines[-6:]}
        log(f"[zero] NCCL with two ranks on one card: exit {rc}; " + " | ".join(lines[-3:])[:600])
        t0 = time.perf_counter()
        rc, out, err = _finish(_start(_ranks_cmd(["--zero-rank-child", "gloo", work])))
        res["gloo_s"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"zero (b): the gloo ranks failed (exit {rc}): {err[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        res["ranks"] = ranks
    finally:
        shutil.rmtree(work, ignore_errors=True)
    w1 = res["world1"]
    expected = {k: v // TRAIN_GAS for k, v in _expected_flash_launches(ZERO_STEPS, ZERO_CUT_LAYERS).items()}
    for r in res["ranks"]:
        for stage, s in r["stages"].items():
            rel = max(abs(a - b) / abs(b) for a, b in zip(s["losses"], w1["losses"]))
            s["loss_rel_err"] = rel
            if rel > ZERO_LOSS_REL_TOL:
                failures.append(f"zero (b) rank {r['rank']} stage {stage}: losses {s['losses']} vs world 1 "
                                f"{w1['losses']}")
            if s["masters_outside"]:
                failures.append(f"zero (b) rank {r['rank']} stage {stage}: masters outside the bf16 tolerance: "
                                f"{s['masters_outside'][:4]}")
            if s["flash_launches"] != expected:
                failures.append(f"zero (b) rank {r['rank']} stage {stage}: flash launches {s['flash_launches']} != "
                                f"{expected}")
        s3 = r["stages"]["3"]["state_bytes"]
        ratio = sum(s3.values()) / sum(w1["state_bytes"].values())
        r["stage3_state_ratio"] = ratio
        if ratio > ZERO_STATE_RATIO:
            failures.append(f"zero (b) rank {r['rank']}: stage-3 state {ratio:.3f} of world 1's > {ZERO_STATE_RATIO}")
    return res


def _zero_gang_env(ckdir, faults, total=ZERO_GANG_STEPS, **extra):
    env = {"DSTPU_PORT_BASE": str(_free_port()), "DSTPU_GANG_CKPT": ckdir, "DSTPU_TOTAL_STEPS": str(total),
           "DSTPU_TRAIN_FAULTS": json.dumps(faults)}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _dstpu_train(args, env):
    """``python -m deepspeed_tpu_torch.bin.dstpu_train ARGS -- chip_smoke.py
    --zero-gang-child``, started (see _finish)."""
    return _start([sys.executable, "-m", "deepspeed_tpu_torch.bin.dstpu_train"] + args +
                  ["--", sys.executable, os.path.abspath(__file__), "--zero-gang-child"], env)


def _zero_gang_engine(dev):
    return _zero_engine(bench_llama(num_hidden_layers=ZERO_CUT_LAYERS), 3, dev,
                        optimizer={"type": "SGD", "params": {"lr": 0.05}},
                        extra={"checkpoint": {"gang_seal_timeout_s": 60.0}})


def _zero_gang_batch(step, dev):
    """The gang's batch for a global step: a pure function of the step."""
    rng = np.random.default_rng(1000 + step)
    ids = rng.integers(0, bench_llama().vocab_size, size=(ZERO_B, TRAIN_S + 1), dtype=np.int64)
    return tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], ids[:, 1:]))


def zero_gang_child() -> int:
    """One rank of leg (c)'s gang (started by dstpu_train's elastic agent):
    resume from the newest good tag, train to DSTPU_TOTAL_STEPS, save a tag
    a step; rank 0 writes the final masters where DSTPU_FINAL_PARAMS says."""
    from deepspeed_tpu_torch import comm
    nproc = int(os.environ.get("DSTPU_NUM_PROCESSES", "1") or 1)
    if nproc > 1:
        life = int(os.environ.get("DSTPU_ELASTIC_RESTART", "0") or 0)
        os.environ["DSTPU_COORDINATOR"] = f"127.0.0.1:{int(os.environ['DSTPU_PORT_BASE']) + life}"
    dev = torch.device(os.environ.get("DSTPU_DEVICE", "cuda"))
    comm.init_distributed(dist_backend="gloo", device=dev, verbose=False)  # two ranks share the card
    engine = _zero_gang_engine(dev)
    ckdir = os.environ["DSTPU_GANG_CKPT"]
    path, _ = engine.load_checkpoint(ckdir)
    print(f"GANG life={os.environ.get('DSTPU_RESTART_COUNT', '0')} world={comm.get_world_size()} "
          f"resumed_step={engine.global_steps} from={'fresh' if path is None else path}", flush=True)
    while engine.global_steps < int(os.environ["DSTPU_TOTAL_STEPS"]):
        engine.train_batch(batch=_zero_gang_batch(engine.global_steps, dev))
        engine.save_checkpoint(ckdir)
    full = engine.full_params()
    out = os.environ.get("DSTPU_FINAL_PARAMS")
    if out and comm.get_rank() == 0:
        torch.save({k: v.cpu() for k, v in full.items()}, out)
    engine.destroy()
    return 0


def _zero_gang(dev, failures) -> dict:
    """Leg (c): two gangs under dstpu_train's elastic agent, at the cut
    depth, side by side on the card. In one, rank 1 is killed inside step 3:
    the crash spends the budget (``--max-crashes 1``) and the agent relaunches
    at world 1, which finishes; its final masters bitwise those of the same
    run with no kill and the same world sizes (world 1 from the same last
    sealed tag). In the other, rank 1 dies during its second save: a torn
    tag, which a resume without `latest` skips loudly."""
    import logging
    res = {}
    work = tempfile.mkdtemp(prefix="zero_c_")
    try:
        ckdir, final, ckdir2 = os.path.join(work, "ck"), os.path.join(work, "final.pt"), os.path.join(work, "ck2")
        t0 = time.perf_counter()
        dying = _dstpu_train(["--procs", "2", "--max-crashes", "0", "--gang-dir", os.path.join(work, "gang2"),
                              "--term-grace", "10"],
                             _zero_gang_env(ckdir2, {"enabled": True, "die_during_save_at": [1],
                                                     "die_during_save_rank": 1}))
        env = _zero_gang_env(ckdir, {"enabled": True, "kill_rank_at_steps": [3], "kill_rank": 1},
                             DSTPU_FINAL_PARAMS=final)
        rc, out, err = _finish(_dstpu_train(["--procs", "2", "--max-crashes", "1", "--backoff-base", "0",
                                             "--gang-dir", os.path.join(work, "gang"), "--term-grace", "10"], env))
        res["kill_s"] = time.perf_counter() - t0
        res["kill_exit"] = [ln for ln in out.splitlines() if ln.startswith(("dstpu_train:", "GANG"))]
        log("[zero] gang under the agent: " + " | ".join(res["kill_exit"]))
        if rc != 0 or "dstpu_train: exit rc=0 restarts=1 world=1" not in out:
            raise AssertionError(f"zero (c): the killed gang did not shrink and finish (exit {rc}): {err[-3000:]}")
        with open(os.path.join(work, "gang", "gang_state.json")) as f:
            kinds = [ev["kind"] for ev in json.load(f)["events"]]
        res["events"] = kinds
        if kinds != ["crash", "shrink", "done"]:
            failures.append(f"zero (c): agent events {kinds}")
        # the same run with no kill: world 1 from the same last sealed tag
        ctrl = os.path.join(work, "ctrl")
        os.makedirs(ctrl)
        shutil.copytree(os.path.join(ckdir, "global_step2"), os.path.join(ctrl, "global_step2"))
        with open(os.path.join(ctrl, "latest"), "w") as f:
            f.write("global_step2")
        from deepspeed_tpu_torch import comm
        comm.destroy_process_group()
        engine = _zero_gang_engine(dev)
        engine.load_checkpoint(ctrl)
        resumed = engine.global_steps
        while engine.global_steps < ZERO_GANG_STEPS:
            engine.train_batch(batch=_zero_gang_batch(engine.global_steps, dev))
        got = torch.load(final, weights_only=True)
        diff = [k for k, v in engine.params.items() if not torch.equal(v.cpu(), got[k])]
        res.update(control_resumed_step=resumed, masters_differing=diff)
        _free(engine)
        if resumed != 2 or diff:
            failures.append(f"zero (c): the shrunk gang's masters are not the uninterrupted run's (resumed at "
                            f"{resumed}, {len(diff)} differ)")

        rc, out, err = _finish(dying)
        res["both_s"] = time.perf_counter() - t0
        torn = os.path.join(ckdir2, "global_step2")
        res["die_exit"] = rc
        res["torn"] = dict(dir=os.path.isdir(torn), manifest=os.path.isfile(os.path.join(torn, "MANIFEST.json")),
                           rank1_seal=os.path.isfile(os.path.join(torn, ".seals", "rank1.sealed")),
                           previous_sealed=os.path.isfile(os.path.join(ckdir2, "global_step1", "MANIFEST.json")))
        if rc == 0 or res["torn"] != dict(dir=True, manifest=False, rank1_seal=False, previous_sealed=True):
            failures.append(f"zero (c): death during save: exit {rc}, {res['torn']}")
        os.unlink(os.path.join(ckdir2, "latest"))
        records = []

        class Grab(logging.Handler):

            def emit(self, record):
                records.append(record.getMessage())

        from deepspeed_tpu_torch.utils.logging import logger as port_logger
        grab = Grab()
        port_logger.addHandler(grab)
        try:
            engine = _zero_gang_engine(dev)
            path, _ = engine.load_checkpoint(ckdir2)
        finally:
            port_logger.removeHandler(grab)
        res["resume_after_torn"] = dict(path=path, step=engine.global_steps,
                                        loud=[m[:160] for m in records if "TORN" in m])
        _free(engine)
        if not (path and path.endswith("global_step1") and res["resume_after_torn"]["loud"]):
            failures.append(f"zero (c): the resume did not skip the torn tag loudly: {res['resume_after_torn']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


def zero_rank_child(mode, work=None, device="cuda:0") -> int:
    """One rank of leg (b), started by the launcher: ``nccl`` tries NCCL
    with two ranks on the card (its error printed); ``gloo`` trains stages
    1-3 over gloo, named, both ranks on cuda:0, and writes its readings."""
    from deepspeed_tpu_torch import comm
    rank = int(os.environ["DSTPU_PROCESS_ID"])
    if mode == "nccl":
        try:
            comm.init_distributed(dist_backend="nccl", verbose=False)
            x = torch.ones(4, device="cuda")
            comm.all_reduce(x)
            torch.cuda.synchronize()
            print(f"ZERO_NCCL rank {rank}: all_reduce returned {x.tolist()}", flush=True)
        except BaseException as e:  # the refusal is what this records
            print(f"ZERO_NCCL error rank {rank}: {type(e).__name__}: {str(e)[:400]}", flush=True)
        return 0
    dev = torch.device(device)
    comm.init_distributed(dist_backend="gloo", device=dev, verbose=False)
    cfg = bench_llama(num_hidden_layers=ZERO_CUT_LAYERS)
    want = torch.load(os.path.join(work, "world1_masters.pt"), weights_only=True)
    out = {"rank": rank, "stages": {}}
    for stage in (1, 2, 3):
        engine = _zero_engine(cfg, stage, dev)
        batches = _zero_batches(cfg, dev)
        comm.comm.comms_logger.host_staged.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, launches, secs = _zero_train(engine, batches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats, bad = _masters_close(engine.full_params(), {k: v.to(dev) for k, v in want.items()})
        out["stages"][str(stage)] = dict(
            losses=losses, flash_launches=launches, steps_s=secs, state_bytes=engine.state_bytes(),
            max_memory_allocated_gib=peak, masters_outside=bad,
            masters_worst=min(stats.values()) if stats else None,
            host_staged={op: list(v) for op, v in comm.comm.comms_logger.host_staged.items()})
        _free(engine)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    comm.destroy_process_group()
    return 0


def run_zero_path(dev) -> dict:
    """Data-parallel ZeRO training across ranks (legs a-c above)."""
    t_phase = time.perf_counter()
    failures = []
    res = {}
    for leg, fn in (("nccl_world1", lambda: _zero_nccl_world1(dev, failures)),
                    ("two_ranks", lambda: _zero_two_ranks(dev, failures)),
                    ("gang", lambda: _zero_gang(dev, failures))):
        t0 = time.perf_counter()
        res[leg] = fn()
        res[leg + "_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    ranks = res["two_ranks"]["ranks"]
    res["flash_launches"] = {k: res["nccl_world1"]["flash_launches"][k] +
                             sum(s["flash_launches"][k] for r in ranks for s in r["stages"].values())
                             for k in ("fwd", "dkv", "dq")}
    log("[zero] " + json.dumps(res, default=str)[:4000])
    for r in ranks:
        log(f"[zero] rank {r['rank']}: " + "; ".join(
            f"stage {st}: loss rel err {s['loss_rel_err']:.2e}, state {sum(s['state_bytes'].values()) / 2**30:.3f} "
            f"GiB, peak {s['max_memory_allocated_gib']:.2f} GiB, launches {s['flash_launches']}, "
            f"{s['steps_s']:.1f} s" for st, s in r["stages"].items()) + f"; stage-3 ratio {r['stage3_state_ratio']:.3f}")
    log(f"[zero] world 1: state {sum(res['two_ranks']['world1']['state_bytes'].values()) / 2**30:.3f} GiB, peak "
        f"{res['two_ranks']['world1']['peak_memory_gib']:.2f} GiB; legs {res['nccl_world1_s']:.1f} / "
        f"{res['two_ranks_s']:.1f} / {res['gang_s']:.1f} s; phase {res['seconds']:.1f} s")
    log(card_line())
    if failures:
        raise AssertionError("zero phase: " + "; ".join(failures))
    return res


# ---------------------------------------------------------------- phase 13 --
# ZeRO-Offload to the host and to a local disk, ZeRO++ (qwZ, qgZ, hpZ, MiCS)
# and the pipeline engine (ROADMAP A8, second half), at the bench model's
# width with flash attention, bf16 over f32 masters. Leg a runs the whole
# 530M model at world 1 over NCCL; legs b-d cut its depth (b: the disk
# tier's 1.85 GB of state a step each way; c and d: two and four ranks
# share the one card over gloo, as run_zero_path's leg b).
ZPP_STEPS = 2  # legs a and b (cut: steps, from 3, as ZERO_STEPS)
ZPP_A_LAYERS = 4  # leg a: the bench model's width at a cut depth (cut: depth, from 8, for the card's time)
ZPP_RANK_STEPS = 2  # legs c and d
ZPP_PIPE_LAYERS, ZPP_PIPE_MICRO, ZPP_PIPE_GAS = 4, 2, 4  # leg d: two blocks a stage
# leg c's losses against the exact run of their stage (qwZ, qgZ) or world 1
# (hpZ, MiCS): the readings were within 2.6e-5 (PERF.md). One step moves
# the loss by about 2e-4 of itself, so this holds the losses, not the
# update: the first gradients and the masters below hold that
ZPP_LOSS_REL_TOL = 1e-3
# qwZ and qgZ against the exact run of their stage. The first micro-step's
# reduced gradients (the same masters and batch: they differ only by the
# int8 levels) within ZPP_QUANT_GRAD_REL_TOL in relative L2, tensor by
# tensor: a level is 1/127 of a row's or a block's largest value (the card
# read 0.0735 for qwZ and 0.0176 for qgZ), while a qgZ that leaves out a
# rank's contribution moves a tensor's by about 0.9 (two CPU ranks). The
# masters after the steps: AdamW moves an element by about lr in the
# direction of its gradient's sign, and int8 rounds the gradients near 0
# of a block with one large value (lm_head's, whose rows for the batch's
# target tokens dwarf the rest) to 0 or to the other sign, so a share of
# them moves apart by lr or 2 lr (0.966 and 0.849 of the worst tensor
# within lr / 3 in the first reading); held at ZPP_QUANT_MASTERS_SHARE of
# each tensor, none further apart than _masters_close allows.
ZPP_QUANT_GRAD_REL_TOL, ZPP_QUANT_MASTERS_SHARE = 0.1, 0.8
# the bytes a rank sends in every collective the comms logger counts (ring
# counts from its sizes: an all-gather's input chunk n - 1 times, a reduce-
# scatter's or an all-to-all's input (n - 1) / n of it, an all-reduce's
# 2 (n - 1) / n), against the exact run's. qwZ gathers int8 where the exact
# run gathers bf16 (the gathers 1/2, plus per-row f32 scales) and reduce-
# scatters the same gradients, so its whole is below the exact run's. qgZ's
# all-to-all moves int8 where the exact reduce-scatter moves the f32
# accumulation buffer (1/4, plus a scale a block of 512), then all-gathers
# the f32 sum as the reference's layout does: its gradient path sends 1.25
# times the exact one's, and with the masters' all-gather after each step
# (the same in both runs; GAS 1) the whole is (1/8 + 1/2 + 1/2) / (1/2 + 1/2)
ZPP_QWZ_GATHER_RATIO, ZPP_QWZ_BYTES_RATIO = 0.6, 1.0
ZPP_QGZ_INT8_RATIO, ZPP_QGZ_BYTES_RATIO = 0.3, (1.1, 1.15)


def _wire_bytes(comm_bytes, n):
    """The bytes a rank sends over a group of ``n`` ranks, from the comms
    logger's size of each op (see above)."""
    factor = {"all_gather_into_tensor": n - 1, "reduce_scatter_tensor": (n - 1) / n,
              "all_to_all_single": (n - 1) / n, "all_reduce": 2 * (n - 1) / n}
    return sum(b * factor.get(op, 1) for op, b in comm_bytes.items())


def _zpp_config(micro, gas, zero, opt=None):
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
            "optimizer": opt or {"type": "AdamW", "params": {"lr": TRAIN_LR}}, "zero_optimization": zero,
            "bf16": {"enabled": True}}


def _zpp_engine(cfg, dev, config, model=None):
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    if model is None:
        with torch.device("meta"):
            model = LlamaForCausalLM(cfg)
    else:
        from deepspeed_tpu_torch.models.convert import pipeline_state_from_llama
        params = pipeline_state_from_llama(params, cfg)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev)
    return engine


def _zpp_steps(engine, batches, after=None):
    """The steps with B2-B4's launches zeroed just before and read just
    after: (losses, launches, per-step seconds). ``after(i)``, if given,
    runs after step ``i``, outside its time."""
    torch.cuda.synchronize()
    _zero_flash_launches()
    losses, times = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=b)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if after is not None:
            after(i)
    return losses, _flash_launches(), times


def _zpp_offload_run(cfg, dev, batches, offload):
    """One engine's ZPP_STEPS steps (micro TRAIN_MICRO, GAS TRAIN_GAS, ZeRO
    2) with ``offload`` (None: the state on the card); its readings and
    masters."""
    zero = {"stage": 2, **({"offload_optimizer": offload} if offload else {})}
    engine = _zpp_engine(cfg, dev, _zpp_config(TRAIN_MICRO, TRAIN_GAS, zero))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    off = engine._offload
    swapped = dict(off.swapper.stats) if hasattr(off, "swapper") else None  # the init's swap-out excluded
    losses, launches, times = _zpp_steps(engine, batches)
    out = dict(losses=losses, flash_launches=launches, step_s=times, state_bytes=engine.state_bytes(),
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               optimizer_resting_bytes=off.resting_bytes(engine.opt_state),
               bytes_to_host_per_step=off.bytes_to_host, bytes_to_device_per_step=off.bytes_to_device)
    if swapped is not None:
        out["swapper"] = {k: v - swapped[k] for k, v in off.swapper.stats.items()}
    masters = {k: v.detach().clone() for k, v in engine.params.items()}
    _free(engine)
    return out, masters


def _zpp_cpu_offload(dev, failures) -> dict:
    """Leg a: the 530M model at world 1 over NCCL, ZPP_STEPS steps of
    run_training_path's batches on the card, then the same with the
    optimizer state in pinned host memory and its update on the host."""
    from deepspeed_tpu_torch import comm
    cfg = bench_llama(num_hidden_layers=ZPP_A_LAYERS)
    batches = _train_batches(cfg, dev)[:ZPP_STEPS]
    comm.destroy_process_group()
    comm.init_distributed(dist_backend="nccl", verbose=False)
    res = {"backend": torch.distributed.get_backend(), "layers": cfg.num_hidden_layers}
    res["device"], want = _zpp_offload_run(cfg, dev, batches, None)
    res["offload"], got = _zpp_offload_run(cfg, dev, batches, {"device": "cpu"})
    comm.destroy_process_group()
    stats, bad = _masters_close(got, want)
    res["masters_bitwise_equal"] = sum(torch.equal(got[k], want[k]) for k in want)
    res["masters_count"] = len(want)
    res["masters_worst"] = min(stats.values())
    del got, want
    expected = _expected_flash_launches(ZPP_STEPS, cfg.num_hidden_layers)
    rest = res["offload"]["optimizer_resting_bytes"]
    for name in ("device", "offload"):
        if res[name]["flash_launches"] != expected:
            failures.append(f"zero+ (a) {name}: flash launches {res[name]['flash_launches']} != {expected}")
        if not all(np.isfinite(res[name]["losses"])):
            failures.append(f"zero+ (a) {name}: non-finite losses {res[name]['losses']}")
    if rest["device"] != 0 or rest["pinned"] != rest["host"] or rest["host"] <= 0:
        failures.append(f"zero+ (a): the offloaded state does not rest in pinned host memory: {rest}")
    if bad:
        failures.append(f"zero+ (a): masters outside the host-vs-card Adam tolerance: {bad[:4]}")
    if max(_rel(a, b) for a, b in zip(res["offload"]["losses"], res["device"]["losses"])) > ZERO_LOSS_REL_TOL:
        failures.append(f"zero+ (a): losses {res['offload']['losses']} vs {res['device']['losses']}")
    return res


def _swap_dir():
    """The NVMe tier's directory, made under TMPDIR, and its ``df -T`` line."""
    swap = tempfile.mkdtemp(prefix="nvme_swap_")
    line = subprocess.run(["df", "-T", swap], capture_output=True, text=True, timeout=30).stdout.strip()
    return swap, line.splitlines()[-1] if line else ""


def _zpp_nvme(dev, failures) -> dict:
    """Leg b: at ZERO_CUT_LAYERS, CPU offload, then NVMe offload through the
    native aio engine onto a local disk: the same masters bit for bit (both
    update on the host), the bytes and requests a step swaps."""
    cfg = bench_llama(num_hidden_layers=ZERO_CUT_LAYERS)
    batches = _train_batches(cfg, dev)[:ZPP_STEPS]
    swap, df = _swap_dir()
    res = {"swap_dir": swap, "df": df, "layers": ZERO_CUT_LAYERS}
    try:
        res["cpu"], want = _zpp_offload_run(cfg, dev, batches, {"device": "cpu"})
        t0 = time.perf_counter()
        res["nvme"], got = _zpp_offload_run(cfg, dev, batches, {"device": "nvme", "nvme_path": swap})
        res["nvme_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(swap, ignore_errors=True)
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    res["masters_differing"] = diff
    st = res["nvme"]["swapper"]
    res["per_step"] = {k: v / ZPP_STEPS for k, v in st.items()}
    expected = _expected_flash_launches(ZPP_STEPS, ZERO_CUT_LAYERS)
    if res["nvme"]["flash_launches"] != expected:
        failures.append(f"zero+ (b): flash launches {res['nvme']['flash_launches']} != {expected}")
    if diff or res["nvme"]["losses"] != res["cpu"]["losses"]:
        failures.append(f"zero+ (b): NVMe's masters are not CPU offload's: {len(diff)} differ, losses "
                        f"{res['nvme']['losses']} vs {res['cpu']['losses']}")
    rest = res["nvme"]["optimizer_resting_bytes"]
    if rest["device"] or rest["host"] or rest["disk"] <= 0 or st["reads"] == 0 or st["writes"] == 0:
        failures.append(f"zero+ (b): the state does not rest on disk between steps: {rest}, {st}")
    return res


def _first_reduced_grads(engine):
    """A dict that receives, in f32, the first micro-step's gradients summed
    over the ranks as ``engine`` reduces them (this rank's chunks at stages
    2 and 3; a tensor the engine sums only at the boundary is summed here)."""
    seen, reduce = {}, engine._reduce_micro

    def first(grads):
        out = reduce(grads)
        if not seen:
            seen.update({k: g.detach().float().clone() if engine._reduced(k) else
                         engine._dp_all_reduce(g.detach().float().clone()) for k, g in out.items()})
        return out

    engine._reduce_micro = first
    return seen


def zero_plus_child(mode, work, device="cuda:0") -> int:
    """One rank of leg c (``zeropp``: world 2, qwZ and qgZ beside their exact
    runs, their masters held here to the exact ones; ``hpz``: world 4, hpZ
    and MiCS) or leg d (``pipe``: world 2, one pipeline stage a rank),
    started by the launcher; over gloo, every rank on cuda:0. Writes its
    readings as ``rank<r>.json`` under ``work``, and the masters the parent
    holds to its own runs as ``masters_<run>_rank<r>.pt``."""
    from deepspeed_tpu_torch import comm
    dev = torch.device(device)
    comm.init_distributed(dist_backend="gloo", device=dev, verbose=False)
    rank = comm.get_rank()
    out = {"rank": rank, "world": comm.get_world_size(), "backend": torch.distributed.get_backend(), "runs": {}}

    def save(name, tensors):
        torch.save({k: v.cpu() for k, v in tensors.items()}, os.path.join(work, f"masters_{name}_rank{rank}.pt"))

    if mode == "pipe":
        from deepspeed_tpu_torch.models.llama import llama_pipeline_module
        cfg = bench_llama(num_hidden_layers=ZPP_PIPE_LAYERS)
        batches = _zero_batches(cfg, dev)[:ZPP_RANK_STEPS]
        engine = _zpp_engine(cfg, dev, _zpp_config(ZPP_PIPE_MICRO, ZPP_PIPE_GAS, {"stage": 0}),
                             model=llama_pipeline_module(cfg, 2))
        comm.comm.comms_logger.host_staged.clear()
        losses, launches, times = _zpp_steps(engine, batches)
        out["runs"]["pipe"] = dict(losses=losses, flash_launches=launches, step_s=times, stage=engine.stage_id,
                                   sends=engine._executor.sends, recvs=engine._executor.recvs,
                                   host_staged={op: list(v) for op, v in comm.comm.comms_logger.host_staged.items()})
        save("pipe", engine.params)
        _free(engine)
    else:
        cfg = bench_llama(num_hidden_layers=ZERO_CUT_LAYERS)
        batches = _zero_batches(cfg, dev)[:ZPP_RANK_STEPS]
        runs = (("exact3", {"stage": 3}), ("qwz", {"stage": 3, "zero_quantized_weights": True}),
                ("exact2", {"stage": 2}), ("qgz", {"stage": 2, "zero_quantized_gradients": True})) \
            if mode == "zeropp" else (("hpz", {"stage": 3, "zero_hpz_partition_size": 2}),
                                      ("mics", {"stage": 3, "mics_shard_size": 2}))
        exact = exact_grads = None
        for name, zero in runs:
            engine = _zpp_engine(cfg, dev, _zpp_config(ZERO_B // comm.get_world_size(), 1, zero))
            first_grads = _first_reduced_grads(engine)
            comm.configure(enabled=True, prof_all=True)  # after the engine's own configure
            comm.comm.comms_logger.comms_dict.clear()
            comm.comm.comms_logger.host_staged.clear()
            losses, launches, times = _zpp_steps(engine, batches)
            comm.configure(enabled=False)
            z = engine._zero
            rule = dict(masters=sum(z.local_numel(n, z.param_dim) * 4 for n in z.shapes),
                        optimizer=sum(2 * z.local_numel(n, z.opt_dim) * 4 for n in z.shapes))
            held = dict(masters=sum(t.numel() * t.element_size() for t in engine.params.values()),
                        optimizer=sum(t.numel() * t.element_size() for f in ("exp_avg", "exp_avg_sq")
                                      for t in getattr(engine.opt_state, f).values()))
            run = out["runs"][name] = dict(
                losses=losses, flash_launches=launches, step_s=times, state_bytes=engine.state_bytes(),
                placement_rule_bytes=rule, held_bytes=held,
                param_group=list(z.pgroup.ranks) if z.pdegree > 1 else [rank],
                zero_group=list(z.group.ranks) if z.degree > 1 else [rank],
                qwz_gathers=z.qwz.gathers if z.qwz is not None else 0, qgz=engine._qgz is not None,
                comm_bytes={op: sum(size * v[0] for size, v in sizes.items())
                            for op, sizes in comm.comm.comms_logger.comms_dict.items()},
                host_staged={op: list(v) for op, v in comm.comm.comms_logger.host_staged.items()})
            comm.comm.comms_logger.comms_dict.clear()
            full = {k: v.detach().clone() for k, v in engine.full_params().items()}  # a collective at stage 3
            _free(engine)
            if name.startswith("exact"):
                exact, exact_grads = full, first_grads
            elif mode == "zeropp":  # qwZ and qgZ against the exact run just before
                stats, bad = _masters_close(full, exact, share_min=ZPP_QUANT_MASTERS_SHARE)
                run["masters_vs_exact"] = dict(worst=min(stats.values()), outside=bad)
                rel = {k: float((g - exact_grads[k]).norm() / exact_grads[k].norm().clamp_min(1e-30))
                       for k, g in first_grads.items()}
                run["first_grads_rel_l2_vs_exact"] = dict(worst=max(rel.values()), name=max(rel, key=rel.get),
                                                          outside=[k for k, v in rel.items()
                                                                   if v > ZPP_QUANT_GRAD_REL_TOL])
                exact = exact_grads = None
            elif rank == 0:  # hpZ and MiCS: held to world 1 by the parent
                save(name, full)
            del full
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    comm.destroy_process_group()
    return 0


def _zpp_start_gangs():
    """Legs c and d's gangs, started together (eight processes on the card):
    ``{mode: (process, world, work dir)}``."""
    gangs = {}
    for mode, world in (("zeropp", 2), ("hpz", 4), ("pipe", 2)):
        work = tempfile.mkdtemp(prefix=f"zpp_{mode}_")
        gangs[mode] = (_start(_ranks_cmd(["--zero-plus-child", mode, work], world=world)), world, work)
    return gangs


def _zpp_gang_results(gang, mode):
    """A started gang's ranks' readings and the masters they saved (``{run:
    {name: tensor}}``, a run's ranks merged), once it exits; its work dir
    removed."""
    proc, world, work = gang
    try:
        rc, out, err = _finish(proc)
        if rc != 0:
            raise AssertionError(f"zero+ {mode}: the ranks failed (exit {rc}): {err[-3000:]}")
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        masters = {}
        for fname in sorted(os.listdir(work)):
            if fname.startswith("masters_"):
                run = fname[len("masters_"):].rsplit("_rank", 1)[0]
                masters.setdefault(run, {}).update(torch.load(os.path.join(work, fname), weights_only=True))
        return ranks, masters
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _zpp_ranks(dev, gangs, failures) -> dict:
    """Leg c: qwZ (stage 3) and qgZ (stage 2) over two ranks beside the exact
    runs of their stage; hpZ and MiCS (stage 3, a secondary group of 2) over
    four, held to a world-1 run (made here, beside the gangs); each rank's
    state against the rule; the losses and masters of each run."""
    cfg = bench_llama(num_hidden_layers=ZERO_CUT_LAYERS)
    res = {}
    ref = _zpp_engine(cfg, dev, _zpp_config(ZERO_B, 1, {"stage": 2}))
    w1_losses, w1_launches, _ = _zpp_steps(ref, _zero_batches(cfg, dev)[:ZPP_RANK_STEPS])
    res["world1"] = dict(losses=w1_losses, flash_launches=w1_launches, state_bytes=ref.state_bytes())
    w1_masters = {k: v.detach().clone() for k, v in ref.params.items()}
    _free(ref)
    res["two_ranks"], _ = _zpp_gang_results(gangs["zeropp"], "zeropp")
    res["four_ranks"], saved = _zpp_gang_results(gangs["hpz"], "hpz")
    expected = {k: v // TRAIN_GAS for k, v in _expected_flash_launches(ZPP_RANK_STEPS, ZERO_CUT_LAYERS).items()}
    for r in res["two_ranks"]:
        runs = r["runs"]
        for name, exact in (("qwz", "exact3"), ("qgz", "exact2")):
            q, x = runs[name], runs[exact]
            q["loss_rel_err_vs_exact"] = max(_rel(a, b) for a, b in zip(q["losses"], x["losses"]))
            q["bytes_ratio_vs_exact"] = _wire_bytes(q["comm_bytes"], r["world"]) / \
                max(1, _wire_bytes(x["comm_bytes"], r["world"]))
            if q["loss_rel_err_vs_exact"] > ZPP_LOSS_REL_TOL:
                failures.append(f"zero+ (c) rank {r['rank']} {name}: losses {q['losses']} vs {x['losses']}")
            if q["masters_vs_exact"]["outside"] or q["first_grads_rel_l2_vs_exact"]["outside"]:
                failures.append(f"zero+ (c) rank {r['rank']} {name}: outside the tolerance of the exact run: "
                                f"masters {q['masters_vs_exact']}, first gradients {q['first_grads_rel_l2_vs_exact']}")
            if q["losses"] == x["losses"]:
                failures.append(f"zero+ (c) rank {r['rank']} {name}: the losses equal the exact run's (no quantizer)")
        qw, qg = runs["qwz"], runs["qgz"]
        qw["gather_ratio_vs_exact"] = qw["comm_bytes"].get("all_gather_into_tensor", 0) / \
            max(1, runs["exact3"]["comm_bytes"].get("all_gather_into_tensor", 0))
        qg["int8_ratio_vs_exact"] = qg["comm_bytes"].get("all_to_all_single", 0) / \
            max(1, runs["exact2"]["comm_bytes"].get("reduce_scatter_tensor", 0))
        lo, hi = ZPP_QGZ_BYTES_RATIO
        if not (0 < qw["gather_ratio_vs_exact"] <= ZPP_QWZ_GATHER_RATIO
                and qw["bytes_ratio_vs_exact"] < ZPP_QWZ_BYTES_RATIO
                and 0 < qg["int8_ratio_vs_exact"] <= ZPP_QGZ_INT8_RATIO and lo <= qg["bytes_ratio_vs_exact"] <= hi):
            failures.append(f"zero+ (c) rank {r['rank']}: bytes against the exact runs: qwZ gathers "
                            f"{qw['gather_ratio_vs_exact']:.4f}, all {qw['bytes_ratio_vs_exact']:.4f}; qgZ int8 "
                            f"{qg['int8_ratio_vs_exact']:.4f}, all {qg['bytes_ratio_vs_exact']:.4f}")
        if not (qw["qwz_gathers"] > 0 and qg["qgz"]):
            failures.append(f"zero+ (c) rank {r['rank']}: qwZ gathers {qw['qwz_gathers']}, qgZ {qg['qgz']}")
    for r in res["two_ranks"] + res["four_ranks"]:
        for name, run in r["runs"].items():
            if run["flash_launches"] != expected:
                failures.append(f"zero+ (c) rank {r['rank']} {name}: flash launches {run['flash_launches']} != "
                                f"{expected}")
    for name in ("hpz", "mics"):
        stats, bad = _masters_close(saved[name], w1_masters)
        res[f"{name}_masters_vs_world1"] = dict(worst=min(stats.values()), outside=bad)
        if bad:
            failures.append(f"zero+ (c) {name}: masters outside the tolerance of world 1's: {bad[:4]}")
    del saved, w1_masters
    for r in res["four_ranks"]:
        pair = [r["rank"] - r["rank"] % 2, r["rank"] - r["rank"] % 2 + 1]
        for name, run in r["runs"].items():
            run["loss_rel_err_vs_world1"] = max(_rel(a, b) for a, b in zip(run["losses"], w1_losses))
            if run["loss_rel_err_vs_world1"] > ZPP_LOSS_REL_TOL:
                failures.append(f"zero+ (c) rank {r['rank']} {name}: losses {run['losses']} vs world 1 {w1_losses}")
            groups_ok = run["param_group"] == pair and run["zero_group"] == (pair if name == "mics" else [0, 1, 2, 3])
            if not groups_ok or run["held_bytes"] != run["placement_rule_bytes"]:
                failures.append(f"zero+ (c) rank {r['rank']} {name}: groups {run['param_group']} / "
                                f"{run['zero_group']}, held {run['held_bytes']} vs rule {run['placement_rule_bytes']}")
    return res


def _zpp_pipe(dev, gangs, failures) -> dict:
    """Leg d: the pipeline engine, two stages as two ranks over gloo (the
    activations and their gradients through the host), held bitwise to the
    single-rank engine on the same model, weights and batches (run here,
    beside the gangs): each stage sums its micro-batches' gradients in the
    single rank's order."""
    from deepspeed_tpu_torch.models.convert import llama_state_from_pipeline
    cfg = bench_llama(num_hidden_layers=ZPP_PIPE_LAYERS)
    config = _zpp_config(ZPP_PIPE_MICRO, ZPP_PIPE_GAS, {"stage": 0})
    ref = _zpp_engine(cfg, dev, config)
    ref_losses, ref_launches, ref_times = _zpp_steps(ref, _zero_batches(cfg, dev)[:ZPP_RANK_STEPS])
    want = {k: v.detach().clone() for k, v in ref.params.items()}
    _free(ref)
    ranks, saved = _zpp_gang_results(gangs["pipe"], "pipe")
    got = {k: v.to(dev) for k, v in llama_state_from_pipeline(saved["pipe"], cfg).items()}
    stats, _ = _masters_close(got, want)
    res = dict(single_rank=dict(losses=ref_losses, flash_launches=ref_launches, step_s=ref_times),
               stages=[r["runs"]["pipe"] for r in ranks], backend=ranks[0]["backend"],
               masters_bitwise_equal=sum(torch.equal(got[k], want[k]) for k in want), masters_count=len(want),
               masters_worst=min(stats.values()))
    # each stage's blocks, every micro-batch: a forward and its remat
    # recompute, and one backward of two launches
    blocks = ZPP_PIPE_LAYERS // 2
    micro = ZPP_RANK_STEPS * ZPP_PIPE_GAS
    want_l = {"fwd": micro * 2 * blocks, "dkv": micro * blocks, "dq": micro * blocks}
    for st in res["stages"]:
        if st["losses"] != ref_losses:
            failures.append(f"zero+ (d) stage {st['stage']}: losses {st['losses']} are not the single rank's "
                            f"{ref_losses}")
        if st["flash_launches"] != want_l:
            failures.append(f"zero+ (d) stage {st['stage']}: flash launches {st['flash_launches']} != {want_l}")
        if not (st["host_staged"].get("send", [0])[0] and st["host_staged"].get("recv", [0])[0]):
            failures.append(f"zero+ (d) stage {st['stage']}: no send/recv went through the host: {st['host_staged']}")
    if res["masters_bitwise_equal"] != res["masters_count"]:
        failures.append(f"zero+ (d): {res['masters_count'] - res['masters_bitwise_equal']} of the stages' masters "
                        f"are not the single rank's bit for bit (worst {res['masters_worst']})")
    return res


def run_zero_plus_path(dev) -> dict:
    """ZeRO-Offload, NVMe, ZeRO++ and the pipeline (legs a-d above)."""
    t_phase = time.perf_counter()
    failures = []
    res = {}
    legs = [("cpu_offload", lambda: _zpp_cpu_offload(dev, failures)), ("nvme", lambda: _zpp_nvme(dev, failures)),
            ("ranks", lambda: _zpp_ranks(dev, gangs, failures)), ("pipeline", lambda: _zpp_pipe(dev, gangs, failures))]
    gangs = {}
    try:
        for leg, fn in legs:
            if leg == "ranks":
                # legs c and d's gangs start together once legs a and b (whose
                # host times are readings) are done; the references run beside
                gangs = _zpp_start_gangs()
            t0 = time.perf_counter()
            res[leg] = fn()
            res[leg + "_s"] = time.perf_counter() - t0
            log(f"[zero+] {leg}: {json.dumps(res[leg], default=str)[:3000]}")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for proc, _, work in gangs.values():  # a leg that raised leaves none running
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            shutil.rmtree(work, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    # every run of the phase: each zeroed B2-B4's counts just before its steps
    runs = [res["cpu_offload"]["device"], res["cpu_offload"]["offload"], res["nvme"]["cpu"], res["nvme"]["nvme"],
            res["ranks"]["world1"], res["pipeline"]["single_rank"]] + \
        [run for r in res["ranks"]["two_ranks"] + res["ranks"]["four_ranks"] for run in r["runs"].values()] + \
        res["pipeline"]["stages"]
    res["flash_launches"] = {k: sum(run["flash_launches"][k] for run in runs) for k in ("fwd", "dkv", "dq")}
    a, b = res["cpu_offload"], res["nvme"]
    log(f"[zero+] (a) 530M at world 1 over {a['backend']}: step {statistics.median(a['device']['step_s']):.2f} s on the "
        f"card, {statistics.median(a['offload']['step_s']):.2f} s offloaded; peak {a['device']['peak_memory_gib']:.2f} / "
        f"{a['offload']['peak_memory_gib']:.2f} GiB; state at rest {a['offload']['optimizer_resting_bytes']}; "
        f"{a['offload']['bytes_to_host_per_step'] / 2**30:.2f} GiB to the host and "
        f"{a['offload']['bytes_to_device_per_step'] / 2**30:.2f} GiB back a step; masters bitwise "
        f"{a['masters_bitwise_equal']}/{a['masters_count']}")
    log(f"[zero+] (b) NVMe at {b['swap_dir']} ({b['df']}): step {statistics.median(b['nvme']['step_s']):.2f} s against "
        f"{statistics.median(b['cpu']['step_s']):.2f} s on the host; per step {b['per_step']}")
    held = ("bytes_ratio_vs_exact", "gather_ratio_vs_exact", "int8_ratio_vs_exact", "loss_rel_err_vs_exact",
            "masters_vs_exact", "first_grads_rel_l2_vs_exact", "loss_rel_err_vs_world1")
    for r in res["ranks"]["two_ranks"] + res["ranks"]["four_ranks"]:
        log(f"[zero+] (c) rank {r['rank']}/{r['world']} over {r['backend']}: " + "; ".join(
            f"{n}: losses {run['losses']}, bytes {run['comm_bytes']}, state {run['state_bytes']}, "
            f"held {({k: run[k] for k in held if k in run})}" for n, run in r["runs"].items()))
    log(f"[zero+] (c) masters against world 1: hpZ {res['ranks']['hpz_masters_vs_world1']}, MiCS "
        f"{res['ranks']['mics_masters_vs_world1']}")
    for st in res["pipeline"]["stages"]:
        log(f"[zero+] (d) stage {st['stage']} over {res['pipeline']['backend']}: losses {st['losses']}, "
            f"{st['sends']} sends / {st['recvs']} recvs, staged {st['host_staged']}, launches {st['flash_launches']}, "
            f"steps {st['step_s']} s")
    log(f"[zero+] legs {res['cpu_offload_s']:.1f} / {res['nvme_s']:.1f} / {res['ranks_s']:.1f} / "
        f"{res['pipeline_s']:.1f} s (c and d's gangs run together from the start of c); phase {res['seconds']:.1f} s")
    log(card_line())
    if failures:
        raise AssertionError("zero+ phase: " + "; ".join(failures))
    return res


# --------------------------------------------------------------------- main --
# ----------------------------------------------------------------- phase 16 --
# model, sequence and expert ranks: two processes of this script
# (--par-rank-child) over gloo on the card, started once, run four legs in
# sequence: (a) Llama-2-7B's widths at PAR_A_LAYERS layers served at TP 2,
# (b) the 530M bench model trained at TP 2, (c) the same model trained with
# Ulysses at sp 2, (d) Mixtral-8x7B's
# widths trained with its experts over 2 expert ranks. The parent computes
# the world-1 runs they are held to.
PAR_PREDICTED_S = 150.0  # the phase's predicted seconds, printed before it runs
PAR_TIMEOUT_S = 900  # bound on the ranks
PAR_LAYERS = 2  # legs b and c: bench.py's widths at a cut depth (cut: depth, as the zero phase)
PAR_STEPS = 2  # legs b, c and d (cut: steps, from 3, for the card's time)
PAR_TP_B = 8  # leg b: the global batch, rows of TRAIN_S tokens
PAR_SP_B, PAR_SP_S = 4, 2048  # leg c: 4 rows of 2048 positions, 1024 a rank
PAR_SP_MASK = (100, 700)  # leg c's -100 span of labels: inside sequence rank 0's half
PAR_MOE_B = 2  # leg d: rows of MOE_TRAIN_S tokens, one a rank
PAR_MOE_CAPACITY = 1.0  # leg d: capacity binds
PAR_MOE_BANKS = ("layers.0.block_sparse_moe.experts.wi", "layers.0.block_sparse_moe.experts.wo")
PAR_MOE_PICKS = 8192  # leg d: entries of each expert bank's first gradient held to the f32 step's
PAR_MOE_GRAD_L2_TOL = 0.06  # their L2 error, relative (the attention gradients' bf16 limit, ATTN_GRAD_L2_TOL)
# leg d: each token's first loss against the f32 step's, in nats: bf16's relative step (2^-8) on logits of
# std 1.28 (Mixtral's lm_head, std 0.02 over 4096 features) at 5 standard deviations is 0.025; four times it
PAR_MOE_NLL_TOL = 0.1
PAR_CONTROL_TOKENS = 4  # leg a's control: new tokens a request, rank 1's o_proj shard rank 0's
PAR_A_LAYERS = 8  # leg a: Llama-2-7B's widths at a cut depth (cut: depth, from 32, for the card's time)
PAR_COLUMN = "layers.0.self_attn.q_proj.weight"  # leg b's control: rank 1's shard of it gets no gradient
_ONE_HOT = sharded_moe._one_hot


def _par_llama(sequence_parallel=False):
    return bench_llama(num_hidden_layers=PAR_LAYERS, sequence_parallel=sequence_parallel,
                       max_position_embeddings=PAR_SP_S)


def _par_batches(cfg, dev, rows, seq, seed, mask=None):
    """PAR_STEPS global batches of ``rows`` x ``seq`` tokens from
    np.random.default_rng(seed); ``mask`` = (lo, hi): labels -100 there."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(PAR_STEPS):
        ids = rng.integers(0, cfg.vocab_size, size=(rows, seq + 1), dtype=np.int64)
        labels = ids[:, 1:].copy()
        if mask is not None:
            labels[:, mask[0]:mask[1]] = -100
        out.append(tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], labels)))
    return out


def _par_engine(cfg, dev, rows, extra=None, tp=False):
    """initialize() on ``cfg`` with weights from seed 0 (as _zero_engine),
    ``rows`` a global batch, ZeRO 1, bf16 over f32 masters; ``tp`` places the
    model on the model axis with auto_tp_specs."""
    from deepspeed_tpu_torch.module_inject import auto_tp_specs
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    config = {"train_batch_size": rows, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": TRAIN_LR}}, "zero_optimization": {"stage": 1},
              "bf16": {"enabled": True}, **(extra or {})}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev,
                                                     param_specs=auto_tp_specs(model) if tp else None)
    return engine


def _par_train(engine, batches):
    """The steps, B2-B4's launches zeroed just before and read just after."""
    torch.cuda.synchronize()
    _zero_flash_launches()
    t0 = time.perf_counter()
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    torch.cuda.synchronize()
    return losses, _flash_launches(), time.perf_counter() - t0


def _par_references(dev, work) -> dict:
    """The world-1 runs of legs b and c (the same programs on one rank):
    losses and launches to work/ref_<leg>.json, masters to work/ref_<leg>.pt."""
    out = {}
    for leg, cfg, rows, seq, mask in (("b", _par_llama(), PAR_TP_B, TRAIN_S, None),
                                      ("c", _par_llama(True), PAR_SP_B, PAR_SP_S, PAR_SP_MASK)):
        engine = _par_engine(cfg, dev, rows)
        losses, launches, secs = _par_train(engine, _par_batches(cfg, dev, rows, seq, seed=17, mask=mask))
        out[leg] = dict(losses=losses, flash_launches=launches, seconds=secs)
        torch.save({k: v.cpu() for k, v in engine.params.items()}, os.path.join(work, f"ref_{leg}.pt.tmp"))
        os.rename(os.path.join(work, f"ref_{leg}.pt.tmp"), os.path.join(work, f"ref_{leg}.pt"))
        _free(engine)
    return out


def _wait_for(path, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {os.path.basename(path)} from the parent")
        time.sleep(0.2)


def _par_leg_a(dev, rank, plan) -> dict:
    """TP 2 serving: Llama-2-7B's widths at PAR_A_LAYERS layers, drawn from
    seed 0 as the main path's weights are, this rank's heads and MLP
    columns; rank 0 serves the main path's 8 requests through generate,
    rank 1 follows every engine call. Then the
    control: the same with rank 1's o_proj shards replaced by rank 0's."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.v2.config_v2 import DeepSpeedTPConfig
    from deepspeed_tpu_torch.inference.v2.engine_factory import serving_tp_slice
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=PAR_A_LAYERS)
    t0 = time.perf_counter()
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    params = {k: v.clone() for k, v in serving_tp_slice(full, cfg, rank, 2).items()}
    swap = {k: v.clone() for k, v in serving_tp_slice(full, cfg, 0, 2).items() if ".o_proj." in k} if rank == 1 else {}
    del full
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out = dict(params=sum(p.numel() for p in params.values()), init_s=time.perf_counter() - t0,
               param_gb=sum(p.numel() * p.element_size() for p in params.values()) / 1e9)
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT, memory_config=MemoryConfig(size=KV_BYTES))
    ecfg = RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK,
                                       tensor_parallel=DeepSpeedTPConfig(tp_size=2))
    for run in ("main", "control"):
        if run == "control":
            for k, v in swap.items():
                params[k].copy_(v)
        engine = build_engine(params, cfg, ecfg, device=dev)
        buckets = []
        inner = engine.model._forward_impl
        engine.model._forward_impl = lambda tok, seq, n, inner=inner: buckets.append(tok.shape[-1]) or \
            inner(tok, seq, n)
        comm.comm.comms_logger.comms_dict.clear()
        paged_attention_update.launches = 0
        times = {"put": [], "decode_loop": []}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rank == 0:
            _timed(engine, "put", times["put"], _put_tokens)
            _timed(engine, "decode_loop", times["decode_loop"], _loop_steps)
            tokens = generate(engine, plan["prompts"], max_new_tokens=NEW_TOKENS if run == "main" else
                              PAR_CONTROL_TOKENS, decode_chunk=NEW_TOKENS)
            calls = None
        else:
            tokens, calls = None, engine.follow()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rank == 0:
            engine.close()  # releases rank 1
        ar = comm.comm.comms_logger.comms_dict.get("tp_row", {})
        out[run] = dict(tokens=tokens, follower_calls=calls, wall_s=wall, b1_launches=paged_attention_update.launches,
                        forwards=len(buckets), bucket_tokens=buckets,
                        all_reduce_count=sum(v[0] for v in ar.values()),
                        all_reduce_bytes=sum(size * v[0] for size, v in ar.items()),
                        all_reduce_ms=sum(sum(v[1]) for v in ar.values()),
                        puts=[n for _, n in times["put"]], decode_loops=[list(w) for _, w in times["decode_loop"]],
                        prefill_s=sum(s for s, _ in times["put"]), decode_s=sum(s for s, _ in times["decode_loop"]),
                        heads=[engine.model.num_heads, engine.model.num_kv_heads],
                        cache_shape=list(engine._state_manager.kv_cache.cache.shape))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del params, swap
    return out


def _par_leg_train(dev, rank, leg, work, deadline) -> dict:
    """Leg b (TP 2) or c (Ulysses, sp 2): PAR_STEPS steps held to the
    world-1 run's masters; then the control (b: rank 1's shard of
    PAR_COLUMN without its gradient; c: RoPE at each slice's local
    positions), which must miss them."""
    tp = leg == "b"
    cfg = _par_llama(sequence_parallel=not tp)
    rows, seq, mask = (PAR_TP_B, TRAIN_S, None) if tp else (PAR_SP_B, PAR_SP_S, PAR_SP_MASK)
    extra = {"tensor_parallel_size": 2} if tp else {"sequence_parallel_size": 2}
    _wait_for(os.path.join(work, f"ref_{leg}.pt"), deadline)
    want = {k: v.to(dev) for k, v in torch.load(os.path.join(work, f"ref_{leg}.pt"), weights_only=True).items()}
    out = {}
    for run in ("main", "control"):
        engine = _par_engine(cfg, dev, rows, extra, tp=tp)
        batches = _par_batches(cfg, dev, rows, seq, seed=17, mask=mask)
        keep_rope = LlamaModel.rope
        if run == "control" and tp and rank == 1:
            inner = engine._boundary_grads

            def dropped(inner=inner):
                grads = inner()
                grads[PAR_COLUMN] = torch.zeros_like(grads[PAR_COLUMN])
                return grads

            engine._boundary_grads = dropped
        elif run == "control" and not tp:
            LlamaModel.rope = lambda self, n, device: rotary_embedding(n, self.cfg.head_dim, self.cfg.rope_theta,
                                                                       device=device)
        torch.cuda.reset_peak_memory_stats()
        try:
            losses, launches, secs = _par_train(engine, batches)
        finally:
            LlamaModel.rope = keep_rope
        stats, bad = _masters_close(engine.full_params(), want, steps=PAR_STEPS)
        local = {n: list(p.shape) for n, p in engine.params.items() if n in (PAR_COLUMN, "lm_head.weight")}
        out[run] = dict(losses=losses, flash_launches=launches, steps_s=secs, masters_outside=bad,
                        masters_worst=min(stats.values()), local_shapes=local,
                        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
        _free(engine)
    return out


def _moe_gate_log(record, seq=None):
    """Each global gate's (exp_counts, kept assignments) appended to
    ``record``, and the same gate of this rank's own tokens (the control's
    local gate: capacity and priority over its tokens only). The gate is
    over every rank of the world, in rank order; ``seq``: ``(sp, rows)``
    when the last ``sp`` ranks of each run are sequence ranks, each holding
    ``rows`` rows' slices (``sharded_moe._token_order``)."""
    inner = sharded_moe.top2gating

    def gating(logits, capacity_factor=1.0, min_capacity=4, generator=None):
        out = inner(logits, capacity_factor, min_capacity, generator)
        from deepspeed_tpu_torch import comm
        n, r = comm.get_world_size(), comm.get_rank()
        _, mine = sharded_moe._token_order(n, r, logits.shape[0] // n, *(seq or (1, 1)), device=logits.device)
        recording, sharded_moe._one_hot = sharded_moe._one_hot, _ONE_HOT  # the routes record the global gate's
        try:
            local = inner(logits[mine], capacity_factor, min_capacity, generator)
        finally:
            sharded_moe._one_hot = recording
        record.append(dict(counts=out[3].tolist(), kept=float(out[2].sum()), local_kept=float(local[2].sum()),
                           local_counts=local[3].tolist()))
        return out

    sharded_moe.top2gating = gating
    return inner


def _par_moe_picks(cfg) -> dict:
    """PAR_MOE_PICKS flat indices (seeded, sorted) into each whole expert
    bank of PAR_MOE_BANKS."""
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in MixtralForCausalLM(cfg).named_parameters() if n in PAR_MOE_BANKS}
    rng = np.random.default_rng(7)
    return {n: torch.from_numpy(np.unique(rng.integers(0, math.prod(shape), PAR_MOE_PICKS))) for n, shape in
            shapes.items()}


@contextlib.contextmanager
def _swapped_experts():
    """Leg d's control: the expert group's all-gather of the experts'
    outputs hands each rank's outputs back in the other rank's place (the
    backward follows the swap)."""
    inner = sharded_moe._GatherExperts

    class Swapped:
        @staticmethod
        def apply(x, group):
            return inner.apply(x, group).roll(x.shape[0], 0)

    sharded_moe._GatherExperts = Swapped
    try:
        yield
    finally:
        sharded_moe._GatherExperts = inner


def _par_picked_grads(engine, rank, picks) -> dict:
    """The entries of ``picks`` that this rank's experts hold, of the
    accumulated gradients as the optimizer step takes them (over the
    engine's loss scale, accumulation steps and ranks)."""
    inv = 1.0 / (engine.scale_state.cur_scale * engine.gradient_accumulation_steps() * engine._loss_group.size)
    out = {}
    for n, idx in picks.items():
        g = engine.acc_grads[n].reshape(-1)
        lo = rank * g.numel()
        mine = idx[(idx >= lo) & (idx < lo + g.numel())] - lo
        out[n] = (g[mine.to(g.device)].float() * inv).tolist()
    return out


def _par_leg_d(dev, rank) -> dict:
    """Mixtral-8x7B's widths at MOE_TRAIN_LAYERS, experts over 2 expert
    ranks (data 2, expert-data 1; 4 experts a rank), ZeRO 1, capacity
    factor PAR_MOE_CAPACITY, top-2, noise off: PAR_STEPS steps; the first
    step's gate records, routes, the collectives' bytes and the picked
    entries of the expert banks' gradients. First the control: the first
    batch's loss and gradients with the experts' outputs swapped between
    the ranks (no step)."""
    from deepspeed_tpu_torch import comm
    cfg = mixtral_config(MOE_TRAIN_LAYERS, capacity_factor=PAR_MOE_CAPACITY)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, size=(PAR_STEPS, PAR_MOE_B, MOE_TRAIN_S + 1), dtype=np.int64)
    batches = [tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (b[:, :-1], b[:, 1:])) for b in ids]
    params = _moe_params(cfg, dev, dtype=torch.float32)
    with torch.device("meta"):
        model = MixtralForCausalLM(cfg)
    config = {"train_batch_size": PAR_MOE_B, "gradient_accumulation_steps": 1, "expert_parallel_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": TRAIN_LR}}, "zero_optimization": {"stage": 1},
              "bf16": {"enabled": True}}
    t0 = time.perf_counter()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev)
    engine._seed_gates = lambda: None  # the noise off, as the f32 reference's
    comm.configure(enabled=True)  # the engine configured the comms logger from its (empty) block
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(init_s=time.perf_counter() - t0, local_params=sum(p.numel() for p in engine.params.values()),
               local_experts=int(engine.params["layers.0.block_sparse_moe.experts.wi"].shape[0]))
    picks = _par_moe_picks(cfg)
    nll = []
    with _swapped_experts(), _token_nll(nll):
        loss = engine.forward(batches[0])
        engine.backward(loss)
    out["control"] = dict(loss=engine._global_mean(loss).item(), picked_grads=_par_picked_grads(engine, rank, picks),
                          token_nll=nll[0].tolist())
    engine.acc_grads = None
    del loss
    apply = engine._apply

    def picked_apply():
        out["picked_grads"] = _par_picked_grads(engine, rank, picks)
        engine._apply = apply
        return apply()

    engine._apply = picked_apply
    torch.cuda.reset_peak_memory_stats()
    losses, secs, routes, gates = [], [], [], []
    comm.comm.comms_logger.comms_dict.clear()
    nll = []
    for step, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner = _moe_gate_log(gates) if step == 0 else None
        try:
            with _gate_routes(cfg.num_local_experts, record=routes) if step == 0 else contextlib.nullcontext(), \
                    _token_nll(nll) if step == 0 else contextlib.nullcontext():
                losses.append(engine.train_batch(batch=b).item())
        finally:
            if inner is not None:
                sharded_moe.top2gating = inner
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if step == 0:
            moved = {op: {str(size): v[0] for size, v in comm.comm.comms_logger.comms_dict.get(op, {}).items()}
                     for op in MOE_COLLECTIVES}
    out.update(losses=losses, step_s=secs, gates=gates, moved_step1=moved, token_nll=nll[0].tolist(),
               routes=[r.argmax(-1).tolist() for r in routes],
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               ms_per_step=1e3 * statistics.median(secs[1:]),
               tokens_per_s=PAR_MOE_B * MOE_TRAIN_S / statistics.median(secs[1:]))
    _free(engine)
    return out


def parallel_rank_child(work, device="cuda:0") -> int:
    """One rank of run_parallel_path, started through the launcher: joins the
    gloo group, waits for the parent's plan, runs legs a-d, writes its
    readings to work/rank<r>.json."""
    from deepspeed_tpu_torch import comm
    dev = torch.device(device)
    comm.init_distributed(dist_backend="gloo", device=dev, verbose=False)
    comm.configure(enabled=True)
    rank = comm.get_rank()
    deadline = time.monotonic() + PAR_TIMEOUT_S
    _wait_for(os.path.join(work, "go"), deadline)
    with open(os.path.join(work, "go")) as f:
        plan = json.load(f)
    out = {"rank": rank}
    for leg, fn in (("a", lambda: _par_leg_a(dev, rank, plan)),
                    ("b", lambda: _par_leg_train(dev, rank, "b", work, deadline)),
                    ("c", lambda: _par_leg_train(dev, rank, "c", work, deadline)),
                    ("d", lambda: _par_leg_d(dev, rank))):
        t0 = time.perf_counter()
        out[leg] = fn()
        out[leg]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        comm.barrier()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    comm.destroy_process_group()
    return 0


def _par_check_a(a, main, dev, failures) -> dict:
    """Leg a: every request's tokens pass the serving phase's teacher-forced
    check against the dense f32 model of the same weights (PAR_A_LAYERS
    layers; the limit from the main path's logit errors), and the control's
    tokens must fail it; B1 two launches a layer per decode step and small
    put on each rank; the all-reduce bytes two a layer a forward of the
    bucket's tokens x hidden x 4 (f32)."""
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=PAR_A_LAYERS)
    r0, r1 = a[0]["main"], a[1]["main"]
    res = dict(heads=r0["heads"], cache_shape=r0["cache_shape"], param_gb_per_rank=a[0]["param_gb"],
               follower_calls=r1["follower_calls"], wall_s=r0["wall_s"])
    steps = sum(n for _, n in r0["decode_loops"])
    res.update(prefill_tokens_per_s=sum(PROMPT_LENS) / r0["prefill_s"],
               decode_tokens_per_s=sum(s * n for s, n in r0["decode_loops"]) / r0["decode_s"],
               ms_per_decode_step=1e3 * r0["decode_s"] / steps)
    expected = 2 * cfg.num_hidden_layers * (steps + sum(1 for n in r0["puts"] if n <= 32))
    res["b1_launches"] = [r["main"]["b1_launches"] for r in a]
    res["b1_expected"] = expected
    for r, run in enumerate(a):
        if run["main"]["b1_launches"] != expected:
            failures.append(f"a: rank {r} launched B1 {run['main']['b1_launches']} times, expected {expected}")
        predicted = 2 * cfg.num_hidden_layers * sum(run["main"]["bucket_tokens"]) * cfg.hidden_size * 4
        count = 2 * cfg.num_hidden_layers * run["main"]["forwards"]
        run["main"]["all_reduce_predicted"] = [predicted, count]
        if [run["main"]["all_reduce_bytes"], run["main"]["all_reduce_count"]] != [predicted, count]:
            failures.append(f"a: rank {r} all-reduced {run['main']['all_reduce_bytes']} bytes in "
                            f"{run['main']['all_reduce_count']} calls, predicted {predicted} in {count}")
    res["all_reduce"] = [dict(bytes=r["main"]["all_reduce_bytes"], count=r["main"]["all_reduce_count"],
                              ms=r["main"]["all_reduce_ms"], predicted=r["main"]["all_reduce_predicted"]) for r in a]
    if r0["heads"] != [16, 16] or r0["cache_shape"][3] != 16:
        failures.append(f"a: rank 0 holds heads {r0['heads']} and a cache {r0['cache_shape']}")
    tokens = r0["tokens"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    model = _dense_f32(params, cfg)
    del params
    tol = TF_SLACK * max(main["logits_max_abs_err_kernel_vs_f32"], main["logits_max_abs_err_gather_vs_f32"])
    gaps = _teacher_forced(model, dev, list(zip(prompts, tokens)))
    res["teacher_forced_tokens"] = int(gaps.numel())
    res["teacher_forced_max_gap"] = gaps.max().item()
    if not gaps.max().item() <= tol:
        failures.append(f"a: a served token trails the f32 maximum by {gaps.max().item()} > {tol}")
    control = a[0]["control"]["tokens"]
    res["control_max_gap"] = _teacher_forced(model, dev, list(zip(prompts, control))).max().item()
    res["teacher_forced_limit"] = tol
    if not res["control_max_gap"] > tol:
        failures.append("a: the teacher-forced check passes the tokens served with rank 1's o_proj shards rank 0's")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _par_check_train(leg, ranks, ref, failures, steps=PAR_STEPS, layers=PAR_LAYERS) -> dict:
    """Legs b and c (and the composed phase's f, of ``steps`` steps and
    ``layers`` layers): every rank's losses within ZERO_LOSS_REL_TOL of
    world 1's and the masters within its bf16 tolerance; B2-B4 launched as
    the world-1 run launches them; the control must miss the masters."""
    expected = {k: v // TRAIN_GAS for k, v in _expected_flash_launches(steps, layers).items()}
    res = dict(world1=ref, expected_flash_launches=expected, ranks=ranks)
    for r, run in enumerate(ranks):
        main, control = run["main"], run["control"]
        main["loss_rel_err"] = max(abs(x - y) / abs(y) for x, y in zip(main["losses"], ref["losses"]))
        if main["loss_rel_err"] > ZERO_LOSS_REL_TOL:
            failures.append(f"{leg}: rank {r} losses {main['losses']} vs world 1 {ref['losses']}")
        if main["masters_outside"]:
            failures.append(f"{leg}: rank {r} masters outside the bf16 tolerance: {main['masters_outside'][:4]}")
        if main["flash_launches"] != expected or ref["flash_launches"] != expected:
            failures.append(f"{leg}: rank {r} flash launches {main['flash_launches']} (world 1 "
                            f"{ref['flash_launches']}) != {expected}")
        if not control["masters_outside"]:
            failures.append(f"{leg}: rank {r}'s control passes the masters check")
    return res


MOE_COLLECTIVES = ("moe_gate_logits", "moe_dispatch", "moe_experts_out", "moe_gate_logits_bwd", "moe_dispatch_bwd",
                   "moe_experts_out_bwd")


def _moe_bytes(cfg, tokens_local, n) -> dict:
    """The MoE layers' collectives in one training step (forward, remat's
    recomputed forward, backward), as (comms logger name, bytes of the
    input) -> count: the routing logits [S_l, E] f32 all-gathered, the
    dispatched buffer [E, C, M] f32 reduce-scattered, this rank's experts'
    outputs [E/n, C, M] all-gathered; in the backward their adjoints."""
    E, M, L = cfg.num_local_experts, cfg.hidden_size, cfg.num_hidden_layers
    C = sharded_moe._capacity(tokens_local * n, E, 2 * PAR_MOE_CAPACITY, 4)
    return {("moe_gate_logits", tokens_local * E * 4): 2 * L, ("moe_dispatch", E * C * M * 4): 2 * L,
            ("moe_experts_out", E // n * C * M * 4): 2 * L, ("moe_gate_logits_bwd", n * tokens_local * E * 4): L,
            ("moe_dispatch_bwd", E // n * C * M * 4): L, ("moe_experts_out_bwd", E * C * M * 4): L}


def _par_check_d(ranks, dev, failures) -> dict:
    """Leg d: the global gate's counts and kept assignments equal a world-1
    f32 step's along the same routes (recorded on rank 0, replayed); the
    first loss is within the training phase's limit of it and the picked
    entries of the expert banks' first gradients within
    PAR_MOE_GRAD_L2_TOL; every loss finite and the same on both ranks. The
    controls: the gate of each rank's own tokens must keep another number;
    the experts' outputs swapped between the ranks must fail the loss, the
    per-token and the gradient check. The collectives' bytes equal _moe_bytes's count."""
    cfg = mixtral_config(MOE_TRAIN_LAYERS, capacity_factor=PAR_MOE_CAPACITY)
    r0 = ranks[0]
    res = dict(ranks=[{k: v for k, v in r.items() if k not in ("routes", "gates", "picked_grads", "token_nll")}
                      for r in ranks], gates=r0["gates"])
    for r in res["ranks"]:
        r["control"] = dict(loss=r["control"]["loss"])
    global_gate = lambda r: [(g["counts"], g["kept"]) for g in r["gates"]]
    if r0["routes"] != ranks[1]["routes"] or global_gate(r0) != global_gate(ranks[1]):
        failures.append("d: the ranks' global gates disagree")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, size=(PAR_STEPS, PAR_MOE_B, MOE_TRAIN_S + 1), dtype=np.int64)[0]
    batch = tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], ids[:, 1:]))
    replay = [F.one_hot(torch.tensor(r, device=dev), cfg.num_local_experts).float() for r in r0["routes"]]
    record = []
    inner = sharded_moe.top2gating
    sharded_moe.top2gating = lambda *a, **k: record.append(inner(*a, **k)) or record[-1]
    picks = _par_moe_picks(cfg)
    try:
        ref = _moe_f32_step(cfg, dev, batch, replay=replay, picks=picks)
    finally:
        sharded_moe.top2gating = inner
    world1 = [dict(counts=g[3].tolist(), kept=float(g[2].sum())) for g in record]
    picked, picked_nll = ref.pop("picked_grads"), ref.pop("token_nll")
    want_grads = torch.tensor([x for n in PAR_MOE_BANKS for x in picked[n]], dtype=torch.float64)
    res["world1"] = dict(ref, gates=world1)
    first = world1[:cfg.num_hidden_layers]
    mine = r0["gates"][:cfg.num_hidden_layers]
    if [g["counts"] for g in mine] != [g["counts"] for g in first] or \
            [g["kept"] for g in mine] != [g["kept"] for g in first]:
        failures.append(f"d: the global gate {mine} != world 1's {first}")
    local_kept = [sum(r["gates"][i]["local_kept"] for r in ranks) for i in range(cfg.num_hidden_layers)]
    res["dropped"] = [2 * PAR_MOE_B * MOE_TRAIN_S - g["kept"] for g in first]
    res["control_dropped"] = [2 * PAR_MOE_B * MOE_TRAIN_S - k for k in local_kept]
    if res["control_dropped"] == res["dropped"]:
        failures.append("d: the gate of each rank's own tokens drops as many as the global gate")
    if not res["dropped"][0] > 0:
        failures.append("d: capacity does not bind")
    res["loss_rel_err"] = _rel(r0["losses"][0], ref["loss"])
    if not res["loss_rel_err"] <= LOSS_REL_TOL:
        failures.append(f"d: the first loss is {res['loss_rel_err']} from world 1's f32 step > {LOSS_REL_TOL}")
    if not all(math.isfinite(x) for x in r0["losses"]) or r0["losses"] != ranks[1]["losses"]:
        failures.append(f"d: the ranks' losses {[r['losses'] for r in ranks]}")
    res["control_loss_rel_err"] = _rel(r0["control"]["loss"], ref["loss"])
    if not res["control_loss_rel_err"] > LOSS_REL_TOL:
        failures.append("d: the first loss with the experts' outputs swapped between the ranks passes its check")

    def nll_err(run):  # each token's loss, the ranks' rows in order
        got = torch.tensor([x for r in ranks for row in run(r)["token_nll"] for x in row], dtype=torch.float64)
        return (got - want_nll).abs().max().item()

    want_nll = torch.tensor(picked_nll, dtype=torch.float64).reshape(-1)
    res["token_nll_max_abs_err"] = nll_err(lambda r: r)
    res["control_token_nll_max_abs_err"] = nll_err(lambda r: r["control"])
    if not res["token_nll_max_abs_err"] <= PAR_MOE_NLL_TOL:
        failures.append(f"d: a token's first loss is {res['token_nll_max_abs_err']} from world 1's f32 step > "
                        f"{PAR_MOE_NLL_TOL}")
    if not res["control_token_nll_max_abs_err"] > PAR_MOE_NLL_TOL:
        failures.append("d: each token's first loss with the experts' outputs swapped between the ranks passes "
                        "its check")

    def grads_err(run):  # the ranks' picked entries, rank 0's (the lower experts) first
        got = torch.tensor([x for n in PAR_MOE_BANKS for r in ranks for x in run(r)["picked_grads"][n]],
                           dtype=torch.float64)
        return _l2_rel(got, want_grads)

    res["picked_grads"] = int(want_grads.numel())
    res["grad_l2_rel_err"] = grads_err(lambda r: r)
    res["control_grad_l2_rel_err"] = grads_err(lambda r: r["control"])
    if not res["grad_l2_rel_err"] <= PAR_MOE_GRAD_L2_TOL:
        failures.append(f"d: the expert banks' first gradients are {res['grad_l2_rel_err']} from world 1's f32 "
                        f"step > {PAR_MOE_GRAD_L2_TOL}")
    if not res["control_grad_l2_rel_err"] > PAR_MOE_GRAD_L2_TOL:
        failures.append("d: the gradients with the experts' outputs swapped between the ranks pass their check")
    want = _moe_bytes(cfg, PAR_MOE_B // 2 * MOE_TRAIN_S, 2)
    for r, run in enumerate(ranks):
        got = {(op, int(size)): n for op, sizes in run["moved_step1"].items() for size, n in sizes.items()}
        run["moved_predicted"] = {f"{op}:{size}": n for (op, size), n in want.items()}
        if got != want:
            failures.append(f"d: rank {r} moved {got} in its MoE collectives, predicted {want}")
    res["moved_predicted"] = {f"{op}:{size}": n for (op, size), n in want.items()}
    return res


def run_parallel_path(dev, main) -> dict:
    """Training and serving across model, sequence and expert ranks (legs
    a-d above), the two ranks started once; ``main`` is run_main_path's
    record (its tokens and logit errors)."""
    t_phase = time.perf_counter()
    log(f"[parallel] predicted: {PAR_PREDICTED_S:.0f} s for the phase; leg d's ranks at about 32 GiB each "
        "(1.0B parameters a rank: f32 masters and AdamW moments, bf16 weights, f32 gradients, activations)")
    failures = []
    work = tempfile.mkdtemp(prefix="parallel_")
    proc = _start(_ranks_cmd(["--par-rank-child", work]))
    try:
        # the world-1 runs while the ranks import; then the plan starts them
        t0 = time.perf_counter()
        refs = _par_references(dev, work)
        refs["seconds"] = time.perf_counter() - t0
        with open(os.path.join(work, "go.tmp"), "w") as f:
            rng = np.random.default_rng(0)
            vocab = LlamaConfig.llama2_7b().vocab_size
            json.dump({"prompts": [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]}, f)
        os.rename(os.path.join(work, "go.tmp"), os.path.join(work, "go"))
        rc, out, err = _finish(proc, timeout=PAR_TIMEOUT_S)
        if rc != 0:
            raise AssertionError(f"parallel: the ranks failed (exit {rc}): {err[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    res = dict(references_s=refs["seconds"], legs_s={leg: [r[leg]["seconds"] for r in ranks] for leg in "abcd"})
    res["a"] = _par_check_a([r["a"] for r in ranks], main, dev, failures)
    log("[parallel] a: " + json.dumps(res["a"]))
    for leg in "bc":
        res[leg] = _par_check_train(leg, [r[leg] for r in ranks], refs[leg], failures)
        log(f"[parallel] {leg}: " + json.dumps(res[leg]))
    res["d"] = _par_check_d([r["d"] for r in ranks], dev, failures)
    log("[parallel] d: " + json.dumps(res["d"]))
    res["b1_launches"] = res["a"]["b1_launches"][0]
    res["flash_launches"] = {k: ranks[0]["b"]["main"]["flash_launches"][k] + ranks[0]["c"]["main"]["flash_launches"][k]
                             for k in ("fwd", "dkv", "dq")}
    res["seconds"] = time.perf_counter() - t_phase
    res["failures"] = failures
    a, d = res["a"], res["d"]
    log(f"[parallel] a: TP 2 prefill {a['prefill_tokens_per_s']:.1f} tokens/s, decode {a['decode_tokens_per_s']:.1f} "
        f"tokens/s, B1 {a['b1_launches']} launches, {a['teacher_forced_tokens']} tokens teacher-forced, worst gap "
        f"{a['teacher_forced_max_gap']:.3f}, "
        f"control gap {a['control_max_gap']:.3f} (limit {a['teacher_forced_limit']:.3f})")
    for leg in "bc":
        m = [r["main"] for r in res[leg]["ranks"]]
        control = [r["control"]["masters_worst"] for r in res[leg]["ranks"]]
        log(f"[parallel] {leg}: losses {m[0]['losses']} (world 1 {res[leg]['world1']['losses']}), worst masters "
            f"{[x['masters_worst'] for x in m]}, control worst {control}")
    log(f"[parallel] d: dropped {d['dropped']} (own-token gate: {d['control_dropped']}), first loss "
        f"{d['loss_rel_err']:.2e} from f32 (experts swapped: {d['control_loss_rel_err']:.2e}), a token's worst "
        f"{d['token_nll_max_abs_err']:.4f} (swapped {d['control_token_nll_max_abs_err']:.4f}, limit "
        f"{PAR_MOE_NLL_TOL}), picked expert gradients {d['grad_l2_rel_err']:.4f} (swapped "
        f"{d['control_grad_l2_rel_err']:.4f}, limit {PAR_MOE_GRAD_L2_TOL}), peak "
        f"{[r['max_memory_allocated_gib'] for r in d['ranks']]} GiB, "
        f"{[r['ms_per_step'] for r in d['ranks']]} ms a step")
    log(f"[parallel] {res['seconds']:.1f} s (predicted {PAR_PREDICTED_S:.0f}); legs {res['legs_s']}")
    log(card_line())
    if failures:
        raise AssertionError("parallel phase: " + "; ".join(failures))
    return res


# ----------------------------------------------------------------- phase 17 --
# the model-parallel axes composed: four processes of this script
# (--composed-rank-child) over gloo on the card, started once, run six legs
# in sequence: (e) Mixtral-8x7B's widths at 2 layers served at TP 2 x EP 2 (the
# (expert, model) mesh: ranks 0-1 expert rank 0, ranks 2-3 expert rank 1), (f)
# Llama-2-7B's widths at COMP_F_LAYERS trained at TP 2 x SP 2, its tag then
# loaded at world 1 by the parent, (g) Mixtral-8x7B's widths at 1 layer trained
# with Ulysses 2 and EP 2 at ZeRO 3 (seq 2 x expert 2), then the 530M bench
# model's widths (h) at pipe 2 x TP 2, its tag loaded at one stage by the
# parent, (i) at pipe 2 x data 2 at ZeRO 3, (j) at TP 2 x hpZ 2 and at TP 2
# with offload. The parent checks each leg as it lands. TP of a MoE model in
# training is held on the CPU only: its banks,
# whole on every model rank, cost about 25 GB of state a rank at these
# widths, which four ranks on one card cannot hold (PERF.md section 4).
COMP_PREDICTED_S = 400.0  # the phase's predicted seconds, printed before it runs
# each leg's predicted seconds and peak GiB a rank (printed before it runs)
COMP_PREDICTED = {"e": (40.0, 9.0), "f": (70.0, 9.0), "g": (45.0, 17.0)}
COMP_TIMEOUT_S = 900  # bound on the ranks
COMP_E_LAYERS = 2  # leg e: Mixtral-8x7B's widths at a cut depth (cut: depth)
COMP_F_LAYERS = 1  # leg f: Llama-2-7B's widths at a cut depth (cut: depth, from 2, for the card's time)
COMP_F_B, COMP_F_S = 2, 2048  # leg f: 2 rows of 2048 positions, 1024 a sequence rank
COMP_F_MASK = (100, 700)  # leg f's -100 span of labels: inside sequence rank 0's half
COMP_F_STEPS = 2  # leg f's steps before the save (cut: steps, from 3, as ZERO_STEPS)
COMP_F_CONTROL_STEPS = 1  # its control's
COMP_G_LAYERS = 1  # leg g: Mixtral-8x7B's widths at 1 layer (MOE_TRAIN_LAYERS)
# leg g: (rows of MOE_TRAIN_S tokens, axes). Ulysses 2 beside EP 2: each rank
# holds 4 experts, and a bank's ZeRO-3 partitions lie over its expert-data group
# of 2, its sequence ranks. Ulysses beside data ranks instead leaves every
# expert on each rank, and a unit then gathers all 8 banks (2.8 GB) beside
# their f32 copies in the experts' product (5.6 GB), which four ranks cannot hold
COMP_G_RUNS = {"sp2xep2_zero3": (4, {"sequence_parallel_size": 2, "expert_parallel_size": 2})}
COMP_G_STEPS = 1  # the checks read the first step's gates
COMP_E_SPLIT = ([0, 2, 4, 6], [1, 3, 5, 7])  # leg e: the main path's prompts of expert rank 0 and 1
# legs h-j: the pipeline, hpZ and offload composed with the model axis, at
# the 530M bench model's widths (bf16 over f32 masters, flash, remat "dots")
COMP_HIJ_PREDICTED = {"h": (75.0, 9.0), "i": (45.0, 7.0), "j": (75.0, 8.0)}  # seconds, peak GiB a rank
COMP_H_LAYERS = 8  # legs h (pipe 2 x TP 2) and i (pipe 2 x data 2 at ZeRO 3): 4 blocks a stage
COMP_J_LAYERS = 2  # leg j: TP 2 x hpZ 2, then TP 2 with offload (cut: depth, as ZERO_CUT_LAYERS)
COMP_PIPE_MICRO, COMP_PIPE_GAS = 2, 4  # legs h and i: rows a micro-batch, micro-batches a step
COMP_H_STEPS = 2  # leg h's steps before its save
COMP_IJ_STEPS = 1  # legs i and j's steps (cut: steps, for the card's time)


def _comp_llama(sequence_parallel=True):
    """Leg f's model: bench.py's training setup (remat "dots", flash) at
    Llama-2-7B's widths, COMP_F_LAYERS layers."""
    w = LlamaConfig.llama2_7b()
    return bench_llama(hidden_size=w.hidden_size, intermediate_size=w.intermediate_size,
                       num_attention_heads=w.num_attention_heads, num_key_value_heads=w.num_key_value_heads,
                       num_hidden_layers=COMP_F_LAYERS, sequence_parallel=sequence_parallel,
                       max_position_embeddings=COMP_F_S)


def _comp_f_batches(cfg, dev, n=COMP_F_STEPS + 1):
    """Leg f's global batches (the last one for the step after the save)."""
    rng = np.random.default_rng(19)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, size=(COMP_F_B, COMP_F_S + 1), dtype=np.int64)
        labels = ids[:, 1:].copy()
        labels[:, COMP_F_MASK[0]:COMP_F_MASK[1]] = -100
        out.append(tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], labels)))
    return out


def _comp_g_config(run):
    rows, axes = COMP_G_RUNS[run]
    return mixtral_config(COMP_G_LAYERS, capacity_factor=PAR_MOE_CAPACITY,
                          sequence_parallel="sequence_parallel_size" in axes), rows, axes


def _comp_g_batches(cfg, rows, dev):
    rng = np.random.default_rng(23)
    ids = rng.integers(0, cfg.vocab_size, size=(COMP_G_STEPS, rows, MOE_TRAIN_S + 1), dtype=np.int64)
    return [tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (b[:, :-1], b[:, 1:])) for b in ids]


def _comp_references(dev, work, plan) -> dict:
    """The parent's runs while the ranks serve leg e: leg e's one-rank Mixtral
    engine (every expert, no TP) through generate on the main path's
    prompts, and leg f's world-1 training run (losses, launches; masters to
    work/ref_f.pt)."""
    out = {}
    cfg = mixtral_config(COMP_E_LAYERS)
    params = _moe_params(cfg, dev)
    engine = _moe_engine(params, cfg, dev)
    t0 = time.perf_counter()
    out["e"] = dict(tokens=generate(engine, plan["prompts"], max_new_tokens=NEW_TOKENS, decode_chunk=NEW_TOKENS))
    out["e"]["seconds"] = time.perf_counter() - t0
    engine.close()
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _comp_llama()
    engine = _par_engine(_comp_llama(False), dev, COMP_F_B)
    losses, launches, secs = _par_train(engine, _comp_f_batches(cfg, dev)[:COMP_F_STEPS])
    out["f"] = dict(losses=losses, flash_launches=launches, seconds=secs)
    torch.save({k: v.cpu() for k, v in engine.params.items()}, os.path.join(work, "ref_f.pt.tmp"))
    os.rename(os.path.join(work, "ref_f.pt.tmp"), os.path.join(work, "ref_f.pt"))
    _free(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card from here on
    return out


def _comp_leg_e(dev, rank, plan) -> dict:
    """TP 2 x EP 2 serving: each rank draws its expert rank's 4 experts of
    the seed-0 weights (the attention whole: ``build_engine`` cuts this
    model rank's heads); the model rank 0 of expert rank ``e`` serves
    COMP_E_SPLIT[e] of the main path's prompts through generate, its model
    rank 1 follows every engine call, then both leave the expert group. Then
    the control: the same for MOE_CONTROL_TOKENS with expert rank 1's
    experts swapped (its banks flipped on both its model ranks)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.v2.config_v2 import DeepSpeedTPConfig
    cfg = mixtral_config(COMP_E_LAYERS)
    ep_rank, lead = rank // 2, rank % 2 == 0
    per = cfg.num_local_experts // 2
    t0 = time.perf_counter()
    params = _moe_params(cfg, dev, experts=(ep_rank * per, (ep_rank + 1) * per))
    torch.cuda.synchronize()
    out = dict(ep_rank=ep_rank, init_s=time.perf_counter() - t0)
    prompts = [plan["prompts"][i] for i in COMP_E_SPLIT[ep_rank]]
    for run, new_tokens in (("main", NEW_TOKENS), ("control", MOE_CONTROL_TOKENS)):
        if run == "control" and ep_rank == 1:
            for li in range(cfg.num_hidden_layers):
                for bank in ("wi", "wo"):
                    t = params[f"layers.{li}.block_sparse_moe.experts.{bank}"]
                    t.copy_(t.flip(0))
        torch.cuda.reset_peak_memory_stats()
        engine = _moe_engine(params, cfg, dev, ep=2, tensor_parallel=DeepSpeedTPConfig(tp_size=2))
        model = engine.model
        buckets, exchanged = [], []
        inner = model._forward_impl
        model._forward_impl = lambda tok, seq, n, inner=inner: buckets.append(tok.shape[-1]) or inner(tok, seq, n)
        sync = model.ep_sync.exchange
        model.ep_sync.exchange = lambda n, sync=sync: exchanged.append(sync(n)) or exchanged[-1]
        comm.comm.comms_logger.comms_dict.clear()
        paged_attention_update.launches = 0
        for m in model.moes:
            m.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        routing = _RoutingLog(engine) if lead else None
        if lead:
            tokens = generate(engine, prompts, max_new_tokens=new_tokens, decode_chunk=new_tokens)
            serve_s = time.perf_counter() - t0
            empty_runs = engine.leave_expert_group()
            calls = None
        else:
            tokens, serve_s, empty_runs, calls = None, None, None, engine.follow()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if routing is not None:
            routing.close()
        logged = comm.comm.comms_logger.comms_dict
        a2a, row = logged.get("all_to_all_single", {}), logged.get("tp_row", {})
        out[run] = dict(tokens=tokens, follower_calls=calls, serve_s=serve_s, wall_s=wall, empty_runs=empty_runs,
                        b1_launches=paged_attention_update.launches, forwards=len(buckets), bucket_tokens=buckets,
                        exchanged=exchanged, a2a_count=sum(v[0] for v in a2a.values()),
                        a2a_bytes=sum(size * v[0] for size, v in a2a.items()),
                        a2a_ms=sum(sum(v[1]) for v in a2a.values()), tp_row_count=sum(v[0] for v in row.values()),
                        tp_row_bytes=sum(size * v[0] for size, v in row.items()),
                        routes=None if routing is None else [[u, p, li, *e] for (u, p), layers in routing.routes.items()
                                                             for li, e in layers.items()],
                        heads=[model.num_heads, model.num_kv_heads],
                        bank_shape=list(model._params["layers.0.block_sparse_moe.experts.wi"].shape),
                        cache_shape=list(engine._state_manager.kv_cache.cache.shape),
                        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, **_moe_stats(engine))
        engine.close()
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    del params
    return out


def _comp_leg_f(dev, rank, work, deadline) -> dict:
    """TP 2 x SP 2 training (``initialize`` with auto_tp_specs, Ulysses over
    each model rank's 16 heads, 8 a rank after the all-to-all),
    COMP_F_STEPS steps held to the world-1 run's masters; then a save (every array whole,
    rank 0 writing) and one more step, whose loss the parent's world-1
    engine, loaded from the tag, must repeat; rank 0 records the CRC32 of
    each gathered master at the save. Then the control (RoPE at each
    slice's local positions, COMP_F_CONTROL_STEPS steps), which must miss
    the masters."""
    cfg = _comp_llama()
    extra = {"tensor_parallel_size": 2, "sequence_parallel_size": 2}
    _wait_for(os.path.join(work, "ref_f.pt"), deadline)
    want = {k: v.to(dev) for k, v in torch.load(os.path.join(work, "ref_f.pt"), weights_only=True).items()}
    batches = _comp_f_batches(cfg, dev)
    out = {}
    for run in ("main", "control"):
        torch.cuda.reset_peak_memory_stats()
        engine = _par_engine(cfg, dev, COMP_F_B, extra, tp=True)
        keep_rope = LlamaModel.rope
        if run == "control":
            LlamaModel.rope = lambda self, n, device: rotary_embedding(n, self.cfg.head_dim, self.cfg.rope_theta,
                                                                       device=device)
        try:
            losses, launches, secs = _par_train(engine, batches[:COMP_F_STEPS if run == "main" else
                                                                COMP_F_CONTROL_STEPS])
        finally:
            LlamaModel.rope = keep_rope
        full = engine.full_params()
        stats, bad = _masters_close(full, want, steps=COMP_F_STEPS)
        out[run] = dict(losses=losses, flash_launches=launches, steps_s=secs, masters_outside=bad,
                        masters_worst=min(stats.values()),
                        local_shapes={n: list(p.shape) for n, p in engine.params.items()
                                      if n in (PAR_COLUMN, "lm_head.weight", "embed_tokens.weight")},
                        heads_after_all_to_all=cfg.num_attention_heads // 4,
                        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
        if run == "main":
            out["masters_crc"] = {n: ckpt.tensor_crc32(p.detach().cpu()) for n, p in full.items()} if rank == 0 \
                else None
            del full
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.save_checkpoint(os.path.join(work, "tag_f"), tag="f")
            torch.cuda.synchronize()
            out["save_s"] = time.perf_counter() - t0
            out["tag_bytes"] = _tag_bytes(os.path.join(work, "tag_f", "f")) if rank == 0 else None
            _zero_flash_launches()
            out["next_loss"] = float(engine.train_batch(batch=batches[COMP_F_STEPS]))
            out["next_flash_launches"] = _flash_launches()
        else:
            del full
        _free(engine)
        del engine  # before the next run builds its own: destroy() keeps the state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _comp_leg_g(dev, rank) -> dict:
    """MoE across the composed axes, Mixtral-8x7B's widths at 1 layer,
    capacity binding (PAR_MOE_CAPACITY), noise off, ZeRO 3 (persistence
    threshold 0), each run of COMP_G_RUNS (Ulysses 2 beside EP 2: 4 experts
    a rank, each bank partitioned over its expert-data group, the 2
    sequence ranks).
    COMP_G_STEPS steps each; the first step's global gates (and, as the
    control, the same gates over each rank's own tokens), rank 0's routes,
    and the bytes of the banks' masters and optimizer state this rank
    holds."""
    from deepspeed_tpu_torch import comm
    out = {}
    for run in COMP_G_RUNS:
        cfg, rows, axes = _comp_g_config(run)
        batches = _comp_g_batches(cfg, rows, dev)
        torch.cuda.reset_peak_memory_stats()
        config = {"train_batch_size": rows, "gradient_accumulation_steps": 1, **axes,
                  "optimizer": {"type": "AdamW", "params": {"lr": TRAIN_LR}},
                  "zero_optimization": {"stage": 3, "stage3_param_persistence_threshold": 0},
                  "bf16": {"enabled": True}}
        t0 = time.perf_counter()
        # built on the card in bf16 from one seed (the same weights on every
        # rank), not drawn and copied in: a rank then holds the model once in
        # bf16 beside the engine's f32 masters while it builds, and four
        # ranks build at once (the groups are made by every rank together).
        # The checks read the gates' counts along replayed routes, which no
        # weight decides
        keep = torch.get_default_dtype()
        torch.manual_seed(0)
        torch.set_default_dtype(torch.bfloat16)
        try:
            with torch.device(dev):
                model = MixtralForCausalLM(cfg)
        finally:
            torch.set_default_dtype(keep)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=config, device=dev)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        engine._seed_gates = lambda: None  # the noise off, as the f32 reference's
        init_s = time.perf_counter() - t0
        losses, secs, routes, gates = [], [], [], []
        for step, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp = axes.get("sequence_parallel_size", 1)
            inner = _moe_gate_log(gates, (sp, rows // (comm.get_world_size() // sp)) if sp > 1 else None) \
                if step == 0 else None
            try:
                with _gate_routes(cfg.num_local_experts, record=routes) if step == 0 and rank == 0 \
                        else contextlib.nullcontext():
                    losses.append(engine.train_batch(batch=b).item())
            finally:
                if inner is not None:
                    sharded_moe.top2gating = inner
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        banks = [n for n in engine.params if n.endswith(("experts.wi", "experts.wo"))]
        opt = engine.opt_state._asdict() if hasattr(engine.opt_state, "_asdict") else dict(engine.opt_state)
        out[run] = dict(init_s=init_s, losses=losses, step_s=secs, gates=gates,
                        routes=[r.argmax(-1).tolist() for r in routes] if rank == 0 else None,
                        mesh={k: int(v) for k, v in engine.mesh.shape.items() if v > 1},
                        bank_master_elems=sum(engine.params[n].numel() for n in banks),
                        bank_opt_elems=sum(v[n].numel() for v in opt.values() if isinstance(v, dict) for n in banks),
                        bank_shapes={n: list(engine.params[n].shape) for n in banks},
                        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
        _free(engine)
        del engine  # before the next run builds its own: destroy() keeps the state
        gc.collect()
        torch.cuda.empty_cache()
        comm.barrier()
    return out


def _comp_pipe_batches(cfg, dev, n=COMP_H_STEPS + 1):
    """Legs h and i's global batches (micro x GAS rows of TRAIN_S tokens;
    the last one for the step after leg h's save)."""
    rng = np.random.default_rng(29)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, size=(COMP_PIPE_MICRO * COMP_PIPE_GAS, TRAIN_S + 1), dtype=np.int64)
        out.append(tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (ids[:, :-1], ids[:, 1:])))
    return out


def _comp_pipe_config(zero, **axes):
    return dict(_zpp_config(None, COMP_PIPE_GAS, zero), train_batch_size=COMP_PIPE_MICRO * COMP_PIPE_GAS, **axes)


def _crcs(tree):
    return {k: ckpt.tensor_crc32(t.detach().contiguous().cpu()) for k, t in tree.items()}


def _opt_crcs(engine):
    opt = engine.opt_state._asdict()
    return {f"{f}/{n}": ckpt.tensor_crc32(t.detach().contiguous().cpu())
            for f in ("exp_avg", "exp_avg_sq") for n, t in opt[f].items()}


def _comp_leg_h(dev, rank, work, carry) -> dict:
    """The pipeline over model ranks: pipe 2 x TP 2 at ZeRO 1 (each stage
    replicated over its 2 model ranks, which run the same micro-batches),
    COMP_H_LAYERS layers, GAS COMP_PIPE_GAS, COMP_H_STEPS steps; the
    CRC32 of each master and moment this rank holds (whole: no data
    ranks), then a save (each stage's first rank writes its stage) and one
    more step. The stage's masters after COMP_IJ_STEPS steps stay on the
    card in ``carry`` for leg i (they are the one-rank control's, bitwise,
    as the parent checks)."""
    from deepspeed_tpu_torch.models.llama import llama_pipeline_module
    cfg = bench_llama(num_hidden_layers=COMP_H_LAYERS)
    batches = _comp_pipe_batches(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    engine = _zpp_engine(cfg, dev, _comp_pipe_config({"stage": 1}, tensor_parallel_size=2),
                         model=llama_pipeline_module(cfg, 2))

    def keep(i):
        if i + 1 == COMP_IJ_STEPS:
            carry["h_masters"] = {k: v.detach().clone() for k, v in engine.params.items()}

    losses, launches, times = _zpp_steps(engine, batches[:COMP_H_STEPS], after=keep)
    out = dict(stage=engine.stage_id, losses=losses, flash_launches=launches, step_s=times,
               masters_crc=_crcs(engine.params), moments_crc=_opt_crcs(engine), steps=engine.global_steps,
               mesh={k: int(v) for k, v in engine.mesh.shape.items() if v > 1})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save_checkpoint(os.path.join(work, "tag_h"), tag="h")
    out["save_s"] = time.perf_counter() - t0
    out["tag_bytes"] = _tag_bytes(os.path.join(work, "tag_h", "h")) if rank == 0 else None
    out["next_loss"] = float(engine.train_batch(batch=batches[COMP_H_STEPS]))
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    _free(engine)
    del engine
    return out


def _comp_leg_i(dev, rank, carry) -> dict:
    """The pipeline at ZeRO 3: pipe 2 x data 2, leg h's model, each
    stage's layers partitioned over its 2 data ranks and gathered a layer
    at a time; the losses, the launches, the bytes this rank holds and its
    stage's whole, and its stage's gathered masters against leg h's after
    as many steps (``carry``) within _masters_close."""
    from deepspeed_tpu_torch.models.llama import llama_pipeline_module
    cfg = bench_llama(num_hidden_layers=COMP_H_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    engine = _zpp_engine(cfg, dev, _comp_pipe_config({"stage": 3, "stage3_param_persistence_threshold": 0}),
                         model=llama_pipeline_module(cfg, 2))
    losses, launches, times = _zpp_steps(engine, _comp_pipe_batches(cfg, dev)[:COMP_IJ_STEPS])
    z = engine._zero
    whole = sum(int(np.prod(s)) for s in z.shapes.values())
    held = dict(masters=sum(t.numel() * t.element_size() for t in engine.params.values()),
                optimizer=sum(t.numel() * t.element_size() for f in ("exp_avg", "exp_avg_sq")
                              for t in getattr(engine.opt_state, f).values()))
    stats, bad = _masters_close(engine.full_params(), carry.pop("h_masters"), steps=COMP_IJ_STEPS)  # a collective
    out = dict(stage=engine.stage_id, losses=losses, flash_launches=launches, step_s=times, held_bytes=held,
               stage_bytes=dict(masters=whole * 4, optimizer=whole * 8), units=len(z.units),
               zero_group=list(z.group.ranks), masters_worst_vs_control=min(s for s, _ in stats.values()),
               masters_max_abs_vs_control=max(t for _, t in stats.values()), masters_outside=bad,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    _free(engine)
    del engine
    return out


def _comp_j_config(zero, **axes):
    return dict({"train_batch_size": ZERO_B, "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "AdamW", "params": {"lr": TRAIN_LR}}, "zero_optimization": zero,
                 "bf16": {"enabled": True}}, **axes)


def _comp_j_engine(cfg, dev, config):
    from deepspeed_tpu_torch.module_inject import auto_tp_specs
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev,
                                                     param_specs=auto_tp_specs(model))
    return engine


def _comp_leg_j(dev, rank, work) -> dict:
    """hpZ and offload beside the model axis, COMP_J_LAYERS layers, ZERO_B
    rows a step: TP 2 x hpZ 2 at ZeRO 3 (mesh data 1 x hpz 2 x model 2),
    the parameter all-gathers counted during the steps and their group,
    the gathered masters' CRC32s, a save; then TP 2 x data 2 at ZeRO 2
    on the card, then with the optimizer state offloaded to pinned host
    memory, the offloaded run's gathered masters against the other's."""
    from deepspeed_tpu_torch import comm
    cfg = bench_llama(num_hidden_layers=COMP_J_LAYERS)
    batches = _zero_batches(cfg, dev)[:COMP_IJ_STEPS]
    out = {}
    torch.cuda.reset_peak_memory_stats()
    engine = _comp_j_engine(cfg, dev, _comp_j_config({"stage": 3, "zero_hpz_partition_size": 2,
                                                      "stage3_param_persistence_threshold": 0},
                                                     tensor_parallel_size=2))
    z = engine._zero
    per_pass = sum(z.local_numel(n, z.param_dim) * 2 for u in z.units for n in u.names if z.param_dim[n] is not None)
    comm.configure(enabled=True, prof_all=True)  # after the engine's own configure
    comm.comm.comms_logger.comms_dict.clear()
    losses, launches, times = _zpp_steps(engine, batches)
    gathered = {size: v[0] for size, v in comm.comm.comms_logger.comms_dict.get("all_gather_into_tensor", {}).items()}
    comm.comm.comms_logger.comms_dict.clear()
    comm.configure(enabled=False)
    crc = _crcs(engine.full_params())  # a collective
    # each unit's partitioned parameters gathered twice a micro-step (its
    # forward, its backward's recompute), bf16, over the hpz pair alone
    out["hpz"] = dict(losses=losses, flash_launches=launches, step_s=times,
                      gather_bytes=sum(size * n for size, n in gathered.items()),
                      gather_bytes_predicted=per_pass * 2 * COMP_IJ_STEPS,
                      param_group=list(z.pgroup.ranks), model_group=list(engine._mp_group.ranks),
                      masters_crc=crc if rank == 0 else None)
    t0 = time.perf_counter()
    engine.save_checkpoint(os.path.join(work, "tag_j"), tag="j")
    out["hpz"]["save_s"] = time.perf_counter() - t0
    out["hpz"]["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    _free(engine)
    del engine
    full = {}
    for run, zero in (("device", {"stage": 2}), ("offload", {"stage": 2, "offload_optimizer": {"device": "cpu"}})):
        engine = _comp_j_engine(cfg, dev, _comp_j_config(zero, tensor_parallel_size=2))
        losses, launches, times = _zpp_steps(engine, batches)
        full[run] = {k: v.detach().clone() for k, v in engine.full_params().items()}  # a collective
        out[run] = dict(losses=losses, flash_launches=launches, step_s=times,
                        resting=engine._offload.resting_bytes(engine.opt_state), cpu_offload=engine.zero_cpu_offload())
        _free(engine)
        del engine
    # the host's AdamW is not the card's bit for bit (run_zero_plus_path
    # leg a): held to the card's run by the same tolerance, the bitwise
    # count beside it
    stats, bad = _masters_close(full["offload"], full["device"], steps=COMP_IJ_STEPS)
    out["offload"].update(masters_worst_vs_device=min(stats.values()), masters_outside=bad,
                          masters_bitwise=sum(torch.equal(full["offload"][k], t) for k, t in full["device"].items()),
                          masters_count=len(full["device"]))
    del full
    return out


def composed_rank_child(work, device="cuda:0") -> int:
    """One rank of run_composed_path, started through the launcher: joins the
    gloo group, waits for the parent's plan, runs legs e-g, writes its
    readings to work/rank<r>.json."""
    from deepspeed_tpu_torch import comm
    dev = torch.device(device)
    comm.init_distributed(dist_backend="gloo", device=dev, verbose=False)
    comm.configure(enabled=True)
    rank = comm.get_rank()
    deadline = time.monotonic() + COMP_TIMEOUT_S
    _wait_for(os.path.join(work, "go"), deadline)
    with open(os.path.join(work, "go")) as f:
        plan = json.load(f)
    out = {"rank": rank}
    carry = {}  # leg h's masters for leg i, on the card
    for leg, fn in (("e", lambda: _comp_leg_e(dev, rank, plan)), ("f", lambda: _comp_leg_f(dev, rank, work, deadline)),
                    ("g", lambda: _comp_leg_g(dev, rank)), ("h", lambda: _comp_leg_h(dev, rank, work, carry)),
                    ("i", lambda: _comp_leg_i(dev, rank, carry)), ("j", lambda: _comp_leg_j(dev, rank, work))):
        t0 = time.perf_counter()
        out[leg] = fn()
        out[leg]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        comm.configure(enabled=True)  # an engine's init configured the comms logger from its (empty) block
        comm.barrier()
        # what is done survives a later leg's failure, and the parent reads
        # each leg as it lands (written whole, then renamed)
        with open(os.path.join(work, f"rank{rank}.json.tmp"), "w") as f:
            json.dump(out, f)
        os.replace(os.path.join(work, f"rank{rank}.json.tmp"), os.path.join(work, f"rank{rank}.json"))
    comm.destroy_process_group()
    return 0


def _comp_check_e(ranks, refs, main, plan, dev, failures) -> dict:
    """Leg e: each request's tokens equal the one-rank engine's or pass the
    teacher-forced check against the f32 Mixtral along the served routes,
    within leg a's limit (the control's tokens must fail it); no assignment
    dropped; B1 two launches a layer in every forward of a decode-sized
    bucket on every rank, at 16 heads over 4 KV heads; the all-to-all bytes
    to the count from C, E, M and the layers, over each rank's expert group;
    the row all-reduce's bytes one a layer a forward of the bucket's tokens
    x hidden x 4 (f32), over each model group."""
    cfg = mixtral_config(COMP_E_LAYERS)
    L = cfg.num_hidden_layers
    res = dict(ranks=[{k: v for k, v in r["main"].items() if k not in ("tokens", "routes", "bucket_tokens",
                                                                       "exchanged")} for r in ranks])
    for r, run in enumerate(ranks):
        m = run["main"]
        small = sum(1 for t in m["bucket_tokens"] if t <= 32)
        m["b1_expected"] = 2 * L * small
        res["ranks"][r]["b1_expected"] = m["b1_expected"]
        if m["b1_launches"] != m["b1_expected"] or not small:
            failures.append(f"e: rank {r} launched B1 {m['b1_launches']} times, expected {m['b1_expected']}")
        if m["heads"] != [16, 4] or m["cache_shape"][3] != 4 or m["bank_shape"][0] != cfg.num_local_experts // 2:
            failures.append(f"e: rank {r} holds heads {m['heads']}, a cache {m['cache_shape']}, "
                            f"banks {m['bank_shape']}")
        if m["dropped"]:
            failures.append(f"e: rank {r} dropped {m['dropped']} assignments")
        a2a = (_moe_predicted_a2a_bytes(cfg, m["exchanged"]), 2 * L * m["forwards"])
        row = (L * sum(m["bucket_tokens"]) * cfg.hidden_size * 4, L * m["forwards"])
        res["ranks"][r].update(a2a_predicted=a2a, tp_row_predicted=row)
        if (m["a2a_bytes"], m["a2a_count"]) != a2a:
            failures.append(f"e: rank {r} moved {m['a2a_bytes']} bytes in {m['a2a_count']} all-to-alls, "
                            f"predicted {a2a}")
        if (m["tp_row_bytes"], m["tp_row_count"]) != row:
            failures.append(f"e: rank {r} all-reduced {m['tp_row_bytes']} bytes in {m['tp_row_count']} calls, "
                            f"predicted {row}")
    for e in range(2):  # a model group runs its leader's forwards; an expert group pairs them
        if ranks[2 * e]["main"]["bucket_tokens"] != ranks[2 * e + 1]["main"]["bucket_tokens"]:
            failures.append(f"e: expert rank {e}'s model ranks ran different forwards")
    if ranks[0]["main"]["exchanged"] != ranks[2]["main"]["exchanged"]:
        failures.append("e: the expert ranks ran different forwards")
    prompts = plan["prompts"]

    def by_request(run):
        tokens, routes = [None] * len(prompts), [None] * len(prompts)
        for e in range(2):
            got = ranks[2 * e][run]
            table = {(u, p, li): x for u, p, li, *x in got["routes"]}
            for j, i in enumerate(COMP_E_SPLIT[e]):
                tokens[i] = got["tokens"][j]
                routes[i] = [[table[(j, p, li)] for li in range(L)]
                             for p in range(len(prompts[i]) + len(tokens[i]) - 1)]
        return tokens, routes

    served, routes = by_request("main")
    control, control_routes = by_request("control")
    one = refs["e"]["tokens"]
    limit = TF_SLACK * max(main["logits_max_abs_err_kernel_vs_f32"], main["logits_max_abs_err_gather_vs_f32"])
    res.update(teacher_forced_limit=limit, tokens_equal_one_rank=sum(s == o for s, o in zip(served, one)),
               differ=[i for i in range(len(prompts)) if served[i] != one[i]], one_rank_s=refs["e"]["seconds"])
    params = _moe_params(cfg, dev)
    if res["differ"]:
        idx = res["differ"]
        rows, deficit, disagree = _moe_teacher_forced(params, cfg, [prompts[i] for i in idx], [served[i] for i in idx],
                                                      [routes[i] for i in idx])
        gaps = _moe_gaps(rows, [served[i] for i in idx])
        res["teacher_forced"] = dict(max_gap=gaps.max().item(), tokens=gaps.numel(), routes_disagree=disagree,
                                     routes_max_deficit=deficit)
        if not gaps.max().item() <= limit:
            failures.append(f"e: a served token trails the f32 maximum by {gaps.max().item()} > {limit}")
    rows, deficit, _ = _moe_teacher_forced(params, cfg, prompts, control, control_routes)
    res["control_max_gap"] = _moe_gaps(rows, control).max().item()
    if not res["control_max_gap"] > limit:
        failures.append("e: the teacher-forced check passes the tokens served with expert rank 1's experts swapped")
    del params, rows
    gc.collect()
    torch.cuda.empty_cache()
    res["b1_launches"] = ranks[0]["main"]["b1_launches"]
    return res


def _comp_check_f(ranks, ref, work, dev, failures) -> dict:
    """Leg f: legs b and c's checks (losses, masters, B2-B4's launches at 8
    heads a rank, the control), then the tag: a world-1 engine loads it,
    its masters' CRC32s equal those of the ranks' gathered masters at the
    save, and its next step's loss equals the ranks' within
    ZERO_LOSS_REL_TOL."""
    res = _par_check_train("f", [{k: r[k] for k in ("main", "control")} for r in ranks], ref, failures,
                           steps=COMP_F_STEPS, layers=COMP_F_LAYERS)
    res["heads_after_all_to_all"] = ranks[0]["main"]["heads_after_all_to_all"]
    if res["heads_after_all_to_all"] != 8:
        failures.append(f"f: {res['heads_after_all_to_all']} heads a rank in the attention")
    res.update(save_s=[r["save_s"] for r in ranks], tag_bytes=ranks[0]["tag_bytes"],
               next_losses=[r["next_loss"] for r in ranks])
    t0 = time.perf_counter()
    engine = _par_engine(_comp_llama(False), dev, COMP_F_B)
    engine.load_checkpoint(os.path.join(work, "tag_f"), tag="f")
    res["load_s"] = time.perf_counter() - t0
    crc = {n: ckpt.tensor_crc32(p.detach().cpu()) for n, p in engine.params.items()}
    res["masters_bitwise"] = crc == ranks[0]["masters_crc"]
    if not res["masters_bitwise"]:
        failures.append("f: the masters loaded at world 1 differ from the ranks' gathered masters")
    _zero_flash_launches()
    res["world1_next_loss"] = float(engine.train_batch(batch=_comp_f_batches(_comp_llama(False), dev)[COMP_F_STEPS]))
    res["next_loss_rel_err"] = max(abs(x - res["world1_next_loss"]) / abs(res["world1_next_loss"])
                                   for x in res["next_losses"])
    if not res["next_loss_rel_err"] <= ZERO_LOSS_REL_TOL:
        failures.append(f"f: the next step's losses {res['next_losses']} vs world 1's {res['world1_next_loss']}")
    _free(engine)
    return res


def _comp_check_g(ranks, dev, failures) -> dict:
    """Leg g, each run: the global gate's counts and kept assignments equal
    a world-1 f32 step's along the same routes (recorded on rank 0,
    replayed) and agree on every rank; the gate of each rank's own tokens
    (the control) must keep another number; every loss finite and the same
    on every rank; each rank holds a quarter of each bank's masters and
    optimizer state (the banks over 2 expert ranks, each partitioned over
    its 2 sequence ranks)."""
    res = {}
    for run in COMP_G_RUNS:
        cfg, rows, _ = _comp_g_config(run)
        mine = [r[run] for r in ranks]
        out = dict(ranks=[{k: v for k, v in m.items() if k not in ("routes", "gates")} for m in mine])
        first = lambda m: [(g["counts"], g["kept"]) for g in m["gates"][:cfg.num_hidden_layers]]
        if any(first(m) != first(mine[0]) for m in mine):
            failures.append(f"g {run}: the ranks' global gates disagree")
        batch = _comp_g_batches(mixtral_config(COMP_G_LAYERS, capacity_factor=PAR_MOE_CAPACITY), rows, dev)[0]
        replay = [F.one_hot(torch.tensor(r, device=dev), cfg.num_local_experts).float() for r in mine[0]["routes"]]
        record = []
        inner = sharded_moe.top2gating
        sharded_moe.top2gating = lambda *a, **k: record.append(inner(*a, **k)) or record[-1]
        try:
            _moe_f32_step(mixtral_config(COMP_G_LAYERS, capacity_factor=PAR_MOE_CAPACITY), dev, batch, replay=replay)
        finally:
            sharded_moe.top2gating = inner
        world1 = [(g[3].tolist(), float(g[2].sum())) for g in record][:cfg.num_hidden_layers]
        tokens = 2 * rows * MOE_TRAIN_S
        out["dropped"] = [tokens - kept for _, kept in first(mine[0])]
        out["world1_dropped"] = [tokens - kept for _, kept in world1]
        out["control_dropped"] = [tokens - sum(m["gates"][i]["local_kept"] for m in mine)
                                  for i in range(cfg.num_hidden_layers)]
        if first(mine[0]) != world1:
            failures.append(f"g {run}: the global gate {first(mine[0])} != world 1's {world1}")
        if not out["dropped"][0] > 0:
            failures.append(f"g {run}: capacity does not bind")
        if out["control_dropped"] == out["dropped"]:
            failures.append(f"g {run}: the gate of each rank's own tokens drops as many as the global gate")
        if not all(math.isfinite(x) for x in mine[0]["losses"]) or any(m["losses"] != mine[0]["losses"] for m in mine):
            failures.append(f"g {run}: the ranks' losses {[m['losses'] for m in mine]}")
        whole = cfg.num_hidden_layers * cfg.num_local_experts * 3 * cfg.hidden_size * cfg.intermediate_size
        out["bank_share"] = [m["bank_master_elems"] / whole for m in mine]
        out["bank_opt_share"] = [m["bank_opt_elems"] / (2 * whole) for m in mine]
        if any(x != 0.25 for x in out["bank_share"] + out["bank_opt_share"]):
            failures.append(f"g {run}: a rank holds {out['bank_share']} of the banks' masters and "
                            f"{out['bank_opt_share']} of their optimizer state, not a quarter")
        res[run] = out
    return res


def _comp_hij_references(dev) -> dict:
    """The parent's runs while the ranks train legs f-j: legs h and i's
    control (the pipeline's model as one LlamaForCausalLM at world 1, the
    same micro-batches: its losses, its masters' CRC32s under the
    pipeline's names, one more step) and leg j's world-1 run."""
    from deepspeed_tpu_torch.models.convert import pipeline_state_from_llama
    cfg = bench_llama(num_hidden_layers=COMP_H_LAYERS)
    batches = _comp_pipe_batches(cfg, dev)
    engine = _zpp_engine(cfg, dev, _comp_pipe_config({"stage": 1}))
    losses, launches, times = _zpp_steps(engine, batches[:COMP_H_STEPS])
    out = {"h": dict(losses=losses, flash_launches=launches, step_s=times,
                     masters_crc=_crcs(pipeline_state_from_llama(engine.params, cfg)))}
    out["h"]["next_loss"] = float(engine.train_batch(batch=batches[COMP_H_STEPS]))
    _free(engine)
    del engine
    cfg = bench_llama(num_hidden_layers=COMP_J_LAYERS)
    engine = _comp_j_engine(cfg, dev, _comp_j_config({"stage": 2}))
    losses, launches, times = _zpp_steps(engine, _zero_batches(cfg, dev)[:COMP_IJ_STEPS])
    out["j"] = dict(losses=losses, flash_launches=launches, step_s=times,
                    masters={k: v.detach().clone() for k, v in engine.params.items()})
    _free(engine)
    del engine
    return out


def _comp_pipe_launches(steps):
    """B2-B4 on a stage of legs h and i: each of its blocks, every
    micro-batch, a forward and its recompute (remat, or a ZeRO-3 unit's),
    and one backward of two launches."""
    blocks, micro = COMP_H_LAYERS // 2, steps * COMP_PIPE_GAS
    return {"fwd": micro * 2 * blocks, "dkv": micro * blocks, "dq": micro * blocks}


def _comp_check_h(h, ctl, work, dev, failures) -> dict:
    """Leg h: each stage's losses, masters and next step bitwise the
    one-rank control's (the stages sum a micro-batch's gradients in its
    order), its model ranks' masters bitwise equal, B2-B4 as
    _comp_pipe_launches; the tag loaded by a one-stage engine here (while
    the ranks go on to legs i and j): masters and moments bitwise the
    ranks', its next step the control's."""
    from deepspeed_tpu_torch.models.llama import llama_pipeline_module
    want_l = _comp_pipe_launches(COMP_H_STEPS)
    res = dict(ranks=[{k: v for k, v in x.items() if not k.endswith("_crc")} for x in h],
               control=dict(losses=ctl["losses"], next_loss=ctl["next_loss"], step_s=ctl["step_s"]))
    masters = {**h[0]["masters_crc"], **h[2]["masters_crc"]}
    moments = {**h[0]["moments_crc"], **h[2]["moments_crc"]}
    res["masters_bitwise_control"] = masters == ctl["masters_crc"]
    res["model_ranks_equal"] = h[0]["masters_crc"] == h[1]["masters_crc"] and \
        h[2]["masters_crc"] == h[3]["masters_crc"]
    for r, x in enumerate(h):
        if x["losses"] != ctl["losses"] or x["next_loss"] != ctl["next_loss"]:
            failures.append(f"h: rank {r}'s losses {x['losses']} + {x['next_loss']} are not the control's "
                            f"{ctl['losses']} + {ctl['next_loss']}")
        if x["flash_launches"] != want_l:
            failures.append(f"h: rank {r}'s flash launches {x['flash_launches']} != {want_l}")
    if not (res["masters_bitwise_control"] and res["model_ranks_equal"]):
        failures.append(f"h: masters bitwise the control's {res['masters_bitwise_control']}, the model ranks' "
                        f"equal {res['model_ranks_equal']}")
    cfg = bench_llama(num_hidden_layers=COMP_H_LAYERS)
    t0 = time.perf_counter()
    engine = _zpp_engine(cfg, dev, _comp_pipe_config({"stage": 1}), model=llama_pipeline_module(cfg, 1))
    engine.load_checkpoint(os.path.join(work, "tag_h"), tag="h")
    res["load_s"] = time.perf_counter() - t0
    res["tag_bytes"] = h[0]["tag_bytes"]
    res["loaded_bitwise"] = _crcs(engine.params) == masters and _opt_crcs(engine) == moments
    res["loaded_steps"] = engine.global_steps
    res["one_stage_next_loss"] = float(engine.train_batch(batch=_comp_pipe_batches(cfg, dev)[COMP_H_STEPS]))
    _free(engine)
    del engine
    if not (res["loaded_bitwise"] and res["loaded_steps"] == COMP_H_STEPS
            and res["one_stage_next_loss"] == ctl["next_loss"]):
        failures.append(f"h: the tag at one stage: bitwise {res['loaded_bitwise']}, steps "
                        f"{res['loaded_steps']}, next loss {res['one_stage_next_loss']} vs {ctl['next_loss']}")
    return res


def _comp_check_ij(i, j, refs, work, dev, failures) -> dict:
    """Leg i: the losses within ZPP_LOSS_REL_TOL of leg h's control's, the
    stage's masters within _masters_close of leg h's after as many steps
    (the control's, bitwise), a rank's masters and moments exactly half
    its stage's, the launches as h's a step. j: hpZ's losses within ZPP_LOSS_REL_TOL of world 1's, its
    masters within _masters_close, its parameter gathers over the hpz pair
    and their bytes the count, its tag loaded at world 1 bitwise;
    offload's masters within the host-vs-card tolerance of the same TP
    run's on the card (leg a's), its state at rest in pinned host memory."""
    ctl = refs["h"]
    want_l = _comp_pipe_launches(COMP_IJ_STEPS)
    res = {}
    res["i"] = dict(ranks=i)
    for r, x in enumerate(i):
        rel = max(_rel(a, b) for a, b in zip(x["losses"], ctl["losses"]))
        x["loss_rel_err_vs_control"] = rel
        if rel > ZPP_LOSS_REL_TOL:
            failures.append(f"i: rank {r}'s losses {x['losses']} vs the control's {ctl['losses']}")
        if x["masters_outside"]:
            failures.append(f"i: rank {r}'s masters outside the tolerance of leg h's after {COMP_IJ_STEPS} "
                            f"step(s): {x['masters_outside'][:4]} (worst share {x['masters_worst_vs_control']})")
        if any(2 * x["held_bytes"][k] != x["stage_bytes"][k] for k in ("masters", "optimizer")):
            failures.append(f"i: rank {r} holds {x['held_bytes']} of its stage's {x['stage_bytes']}, not half")
        if x["flash_launches"] != want_l or len(x["zero_group"]) != 2:
            failures.append(f"i: rank {r}'s flash launches {x['flash_launches']} != {want_l}, ZeRO group "
                            f"{x['zero_group']}")
    w1 = refs["j"]
    res["j"] = dict(ranks=[{run: {k: v for k, v in x[run].items() if k != "masters_crc"}
                            for run in ("hpz", "offload", "device")} for x in j],
                    world1=dict(losses=w1["losses"], step_s=w1["step_s"]))
    L = COMP_J_LAYERS
    want_j = {"fwd": COMP_IJ_STEPS * 2 * L, "dkv": COMP_IJ_STEPS * L, "dq": COMP_IJ_STEPS * L}
    for r, x in enumerate(j):
        hp = x["hpz"]
        hp["loss_rel_err_vs_world1"] = max(_rel(a, b) for a, b in zip(hp["losses"], w1["losses"]))
        if hp["loss_rel_err_vs_world1"] > ZPP_LOSS_REL_TOL:
            failures.append(f"j: rank {r}'s hpZ losses {hp['losses']} vs world 1's {w1['losses']}")
        if hp["param_group"] != [r % 2, r % 2 + 2] or hp["gather_bytes"] != hp["gather_bytes_predicted"]:
            failures.append(f"j: rank {r}'s parameter gathers over {hp['param_group']}, {hp['gather_bytes']} bytes "
                            f"(the count {hp['gather_bytes_predicted']})")
        if x["offload"]["masters_outside"] or not x["offload"]["cpu_offload"]:
            failures.append(f"j: rank {r}'s offloaded masters outside the host-vs-card tolerance of the run on the "
                            f"card: {x['offload']['masters_outside'][:4]}")
        rest = x["offload"]["resting"]
        if rest["device"] != 0 or rest["pinned"] != rest["host"] or rest["host"] <= 0:
            failures.append(f"j: rank {r}'s offloaded state does not rest in pinned host memory: {rest}")
        for run in ("hpz", "offload", "device"):
            if x[run]["flash_launches"] != want_j:
                failures.append(f"j {run}: rank {r}'s flash launches {x[run]['flash_launches']} != {want_j}")
    cfg = bench_llama(num_hidden_layers=COMP_J_LAYERS)
    t0 = time.perf_counter()
    engine = _comp_j_engine(cfg, dev, _comp_j_config({"stage": 2}))
    engine.load_checkpoint(os.path.join(work, "tag_j"), tag="j")
    res["j"]["load_s"] = time.perf_counter() - t0
    res["j"]["loaded_bitwise"] = _crcs(engine.params) == j[0]["hpz"]["masters_crc"]
    stats, bad = _masters_close(engine.params, w1["masters"], steps=COMP_IJ_STEPS)
    res["j"]["masters_worst_vs_world1"] = min(stats.values())
    _free(engine)
    del engine
    if not res["j"]["loaded_bitwise"] or bad:
        failures.append(f"j: the hpZ tag at world 1: bitwise {res['j']['loaded_bitwise']}, masters outside "
                        f"world 1's tolerance {bad[:4]}")
    res["flash_launches_ij"] = {k: i[0]["flash_launches"][k] +
                                sum(j[0][run]["flash_launches"][k] for run in ("hpz", "offload", "device"))
                                for k in ("fwd", "dkv", "dq")}
    return res


def _comp_wait_for_leg(work, leg, proc, deadline):
    """Every rank's readings of ``leg`` once all four have written them, or
    None if the ranks' launcher exits first (its failure is read after)."""
    paths = [os.path.join(work, f"rank{r}.json") for r in range(4)]
    while time.monotonic() < deadline and proc.poll() is None:
        if all(os.path.exists(p) for p in paths):
            readings = []
            for p in paths:
                with open(p) as f:
                    readings.append(json.load(f).get(leg))
            if all(r is not None for r in readings):
                return readings
        time.sleep(0.5)
    return None


def run_composed_path(dev, main) -> dict:
    """The model-parallel axes composed (legs e-g above), the four ranks
    started once; ``main`` is run_main_path's record (its logit errors)."""
    t_phase = time.perf_counter()
    log(f"[composed] predicted: {COMP_PREDICTED_S:.0f} s for the phase; each leg's seconds and peak GiB a rank: "
        + json.dumps(dict(COMP_PREDICTED, **COMP_HIJ_PREDICTED)))
    failures, res = [], {}
    work = tempfile.mkdtemp(prefix="composed_")
    # four ranks share the card: the allocator's expandable segments keep each
    # rank's cached blocks from fragmenting into memory the others need
    proc = _start(_ranks_cmd(["--composed-rank-child", work], world=4),
                  env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    try:
        rng = np.random.default_rng(0)
        plan = {"prompts": [rng.integers(0, LlamaConfig.llama2_7b().vocab_size, n).tolist() for n in PROMPT_LENS]}
        # the plan first: the ranks serve leg e while the parent runs its
        # references (leg f's ranks wait for ref_f.pt)
        with open(os.path.join(work, "go.tmp"), "w") as f:
            json.dump(plan, f)
        os.rename(os.path.join(work, "go.tmp"), os.path.join(work, "go"))
        t0 = time.perf_counter()
        refs = _comp_references(dev, work, plan)
        refs["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        # leg e's checks while the ranks train legs f and g
        e_ranks = _comp_wait_for_leg(work, "e", proc, time.monotonic() + COMP_TIMEOUT_S)
        if e_ranks is not None:
            res["e"] = _comp_check_e(e_ranks, refs, main, plan, dev, failures)
            gc.collect()
            torch.cuda.empty_cache()
        # legs h-j's references while the ranks train, then the checks of
        # legs f and h (each loads its tag here) while they go on
        t0 = time.perf_counter()
        refs.update(_comp_hij_references(dev))
        refs["hij_seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        for leg in "fh":
            got = _comp_wait_for_leg(work, leg, proc, time.monotonic() + COMP_TIMEOUT_S)
            if got is not None:
                res[leg] = _comp_check_f(got, refs["f"], work, dev, failures) if leg == "f" else \
                    _comp_check_h(got, refs["h"], work, dev, failures)
                gc.collect()
                torch.cuda.empty_cache()
        rc, out, err = _finish(proc, timeout=COMP_TIMEOUT_S)
        if rc != 0:
            os.makedirs("chiprun_out", exist_ok=True)
            with open(os.path.join("chiprun_out", "composed_ranks.err"), "w") as f:
                f.write(err)
            for r in range(4):
                if os.path.exists(os.path.join(work, f"rank{r}.json")):
                    shutil.copy(os.path.join(work, f"rank{r}.json"),
                                os.path.join("chiprun_out", f"composed_rank{r}.json"))
            raise AssertionError(f"composed: the ranks failed (exit {rc}; their stderr in "
                                 f"chiprun_out/composed_ranks.err): {err[-3000:]}")
        ranks = []
        for r in range(4):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        res.update(references_s=refs["seconds"], hij_references_s=refs["hij_seconds"],
                   legs_s={leg: [r[leg]["seconds"] for r in ranks] for leg in "efghij"})
        if "e" not in res:
            res["e"] = _comp_check_e([r["e"] for r in ranks], refs, main, plan, dev, failures)
        log("[composed] e: " + json.dumps(res["e"]))
        if "f" not in res:
            res["f"] = _comp_check_f([r["f"] for r in ranks], refs["f"], work, dev, failures)
        log("[composed] f: " + json.dumps(res["f"]))
        if "h" not in res:
            res["h"] = _comp_check_h([r["h"] for r in ranks], refs["h"], work, dev, failures)
        res.update(_comp_check_ij([r["i"] for r in ranks], [r["j"] for r in ranks], refs, work, dev, failures))
        log("[composed] h-j: " + json.dumps({k: res[k] for k in "hij"}, default=str)[:6000])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    res["g"] = _comp_check_g([r["g"] for r in ranks], dev, failures)
    log("[composed] g: " + json.dumps(res["g"]))
    res["b1_launches"] = res["e"]["b1_launches"]
    # rank 0's legs f and h-j
    res["flash_launches"] = {k: ranks[0]["f"]["main"]["flash_launches"][k] + ranks[0]["h"]["flash_launches"][k] +
                             res["flash_launches_ij"][k] for k in ("fwd", "dkv", "dq")}
    res["seconds"] = time.perf_counter() - t_phase
    res["failures"] = failures
    e, f, g = res["e"], res["f"], res["g"]
    log(f"[composed] e: TP 2 x EP 2 tokens equal one rank's for {e['tokens_equal_one_rank']} of {len(PROMPT_LENS)} "
        f"(teacher-forced {e.get('teacher_forced')}, limit {e['teacher_forced_limit']:.3f}, control gap "
        f"{e['control_max_gap']:.3f}), B1 {[r['b1_launches'] for r in e['ranks']]} launches, all-to-all bytes "
        f"{[r['a2a_bytes'] for r in e['ranks']]}, peak {[r['max_memory_allocated_gib'] for r in e['ranks']]} GiB")
    log(f"[composed] f: losses {f['ranks'][0]['main']['losses']} (world 1 {f['world1']['losses']}), worst masters "
        f"{[r['main']['masters_worst'] for r in f['ranks']]}, control worst "
        f"{[r['control']['masters_worst'] for r in f['ranks']]}; tag {f['tag_bytes']} bytes saved in {f['save_s']} s, "
        f"loaded at world 1 in {f['load_s']:.1f} s, bitwise {f['masters_bitwise']}, next loss "
        f"{f['next_losses'][0]} (world 1 {f['world1_next_loss']})")
    for run, r in g.items():
        log(f"[composed] g {run}: dropped {r['dropped']} (world 1 {r['world1_dropped']}, own-token gate "
            f"{r['control_dropped']}), bank share {r['bank_share']}, peak "
            f"{[x['max_memory_allocated_gib'] for x in r['ranks']]} GiB, steps {r['ranks'][0]['step_s']} s")
    h, i, j = res["h"], res["i"], res["j"]
    log(f"[composed] h: pipe 2 x TP 2 losses {h['ranks'][0]['losses']} (control {h['control']['losses']}), "
        f"masters bitwise {h['masters_bitwise_control']}, model ranks equal {h['model_ranks_equal']}; "
        f"tag {h['tag_bytes']} bytes saved in {[x['save_s'] for x in h['ranks']]} s, loaded at one "
        f"stage in {h['load_s']:.1f} s, bitwise {h['loaded_bitwise']}; peak "
        f"{[x['max_memory_allocated_gib'] for x in h['ranks']]} GiB, steps {h['ranks'][0]['step_s']} s")
    log(f"[composed] i: pipe 2 x data 2 at ZeRO 3 losses {i['ranks'][0]['losses']}, held "
        f"{i['ranks'][0]['held_bytes']} of {i['ranks'][0]['stage_bytes']}, peak "
        f"{[x['max_memory_allocated_gib'] for x in i['ranks']]} GiB, steps {i['ranks'][0]['step_s']} s")
    jr = j["ranks"][0]
    log(f"[composed] j: TP 2 x hpZ 2 losses {jr['hpz']['losses']} (world 1 {j['world1']['losses']}), gathers "
        f"{jr['hpz']['gather_bytes']} bytes (count {jr['hpz']['gather_bytes_predicted']}) over {jr['hpz']['param_group']}, "
        f"tag loaded at world 1 bitwise {j['loaded_bitwise']}; offload steps {jr['offload']['step_s']} s against "
        f"{jr['device']['step_s']} s on the card, masters worst {jr['offload']['masters_worst_vs_device']}, bitwise "
        f"{jr['offload']['masters_bitwise']}/{jr['offload']['masters_count']}")
    log(f"[composed] {res['seconds']:.1f} s (predicted {COMP_PREDICTED_S:.0f}); legs {res['legs_s']}")
    log(card_line())
    if failures:
        raise AssertionError("composed phase: " + "; ".join(failures))
    return res


# ----------------------------------------------------------------- breadth --
# the ragged engine's model breadth and weights from disk: the decoder family
# at two published widths (B1 at 71 query heads over one KV head of 64, and at
# head_dim 80), the main path's model quantized to int8 and int4, and weights
# written to disk in HF layout and in the serialize format, then served
BREADTH_PREDICTED_S = 120.0  # the phase's predicted seconds, printed before it runs
BREADTH_PREDICTED = {"a": (20.0, 22.0), "b": (15.0, 14.0), "c": (45.0, 20.0), "d": (35.0, 11.0)}  # s, peak GiB
BREADTH_FALCON_LAYERS = 8  # leg a: Falcon-7B's widths at 8 of its 32 layers (cut: depth, for the card's time)
BREADTH_PHI_LAYERS = 8  # leg b: Phi-2's widths at 8 of its 32 layers (cut: depth, for the card's time)
BREADTH_DISK_LAYERS = 2  # leg d: Llama-2-7B's widths at 2 layers (cut: depth; 1.33 GB on the 9p disk)
BREADTH_KV_BYTES = 2 * 2**30  # per engine
BREADTH_REPLICA_TOKENS = 16
BREADTH_REPLICA_ARGS = ("--max-context", "256", "--num-blocks", "64", "--block-size", "64")
# leg c: the at-rest bytes of the quantized tree over the bf16 tree's, with
# its f32 scales (one per output channel) and the norms kept in bf16
BREADTH_BYTES_RATIO = {8: (0.45, 0.55), 4: (0.20, 0.30)}


def falcon7b_config(layers=BREADTH_FALCON_LAYERS) -> DecoderConfig:
    """Falcon-7B's published widths (``tiiuae/falcon-7b`` ``config.json``:
    hidden 4544, 71 heads over one KV head of 64, 32 layers, vocab 65024,
    parallel attention and MLP off one LayerNorm, no biases, rotary), FFN 4 x
    hidden, in the reference's ``DecoderConfig.falcon`` form (tanh gelu)."""
    return DecoderConfig.falcon(vocab_size=65024, hidden_size=4544, intermediate_size=18176, num_hidden_layers=layers,
                                num_attention_heads=71, num_key_value_heads=1, max_position_embeddings=2048,
                                dtype=torch.bfloat16)


def phi2_config(layers=BREADTH_PHI_LAYERS) -> DecoderConfig:
    """Phi-2's published widths (``microsoft/phi-2`` ``config.json``: hidden
    2560, FFN 10240, 32 heads of 80, 32 layers, vocab 51200,
    ``partial_rotary_factor`` 0.4), in the reference's ``DecoderConfig.phi``
    form (no ``lm_head`` bias)."""
    return DecoderConfig.phi(vocab_size=51200, hidden_size=2560, intermediate_size=10240, num_hidden_layers=layers,
                             num_attention_heads=32, num_key_value_heads=32, rotary_pct=0.4,
                             max_position_embeddings=2048, dtype=torch.bfloat16)


def _breadth_config(**kw) -> RaggedInferenceEngineConfig:
    mgr = DSStateManagerConfig(max_context=MAX_CONTEXT, memory_config=MemoryConfig(size=BREADTH_KV_BYTES))
    return RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK, **kw)


def _served(engine, prompts):
    """``generate`` of the prompts (NEW_TOKENS greedy, decode_loop in one
    chunk) after a warm-up, B1's launch count zeroed just before and read
    just after: ``(tokens, stats)`` with the launches predicted from the
    scheduler's calls (2 a layer in each decode step and each put of at most
    32 tokens), the rates, a decode step's ms and the peak memory."""
    generate(engine, [prompts[0], prompts[2]], max_new_tokens=4, decode_chunk=4)  # warm-up, not counted
    torch.cuda.synchronize()
    times = {"put": [], "decode_loop": []}
    _timed(engine, "put", times["put"], _put_tokens)
    _timed(engine, "decode_loop", times["decode_loop"], _loop_steps)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    paged_attention_update.launches = 0
    t0 = time.perf_counter()
    tokens = generate(engine, prompts, max_new_tokens=NEW_TOKENS, decode_chunk=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention_update.launches
    del engine.put, engine.decode_loop
    steps = sum(n for _, (_, n) in times["decode_loop"])
    decode_s = sum(s for s, _ in times["decode_loop"])
    small_puts = sum(1 for _, n in times["put"] if n <= 32)
    return tokens, dict(wall_s=wall, b1_launches=launches,
                        b1_expected=2 * engine.model.num_layers * (steps + small_puts),
                        puts=[n for _, n in times["put"]], decode_loops=[list(w) for _, w in times["decode_loop"]],
                        ms_per_decode_step=1e3 * decode_s / max(steps, 1),
                        decode_tokens_per_s=sum(a * b for _, (a, b) in times["decode_loop"]) / decode_s,
                        prefill_tokens_per_s=sum(len(p) for p in prompts) / sum(s for s, _ in times["put"]),
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                        peak_over_weights_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)


def _tf_gaps(model, dev, sequences):
    """Every served token teacher-forced through the dense f32 ``model``, one
    forward a request: the gaps between each row's maximum logit and the
    served token's, and (the control) the same for the tokens shifted by
    one position."""
    gaps, shifted = [], []
    with torch.no_grad():
        for prompt, toks in sequences:
            rows = model(torch.tensor([list(prompt) + list(toks[:-1])], device=dev))[0, len(prompt) - 1:].float()
            top = rows.max(-1).values
            at = torch.arange(len(toks), device=dev)
            gaps.append((top - rows[at, torch.tensor(toks, device=dev)]).cpu())
            shifted.append((top - rows[at, torch.tensor(toks[1:] + toks[:1], device=dev)]).cpu())
    return torch.cat(gaps), torch.cat(shifted)


def _dense_decoder_f32(params, cfg):
    with torch.device("meta"):
        model = DecoderModel(cfg)
    model.load_state_dict({k: v.float() for k, v in params.items()}, assign=True)
    return model


def _breadth_decoder_leg(leg, cfg, dev, prompts, failures) -> dict:
    """Legs a and b: a decoder-family model at published widths through
    build_engine + generate, B1's launches against their prediction (at the
    model's head shape), the first decode step's logits (one put of the 8
    requests through B1) against the dense model in f32, and every served
    token teacher-forced through it (control: the tokens shifted by one)."""
    t0 = time.perf_counter()
    params = decoder_init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = build_engine(params, cfg, _breadth_config(), device=dev)
    tokens, res = _served(engine, prompts)
    res.update(model=cfg.model_type, layers=cfg.num_hidden_layers,
               parameters=sum(p.numel() for p in params.values()), heads=cfg.num_attention_heads,
               kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
               b1_geometry=pa.paged_attention_geometry(cfg.head_dim, cfg.num_attention_heads // cfg.num_key_value_heads,
                                                       2))
    if res["b1_launches"] <= 0 or res["b1_launches"] != res["b1_expected"]:
        failures.append(f"{leg}: B1 launched {res['b1_launches']} times, expected {res['b1_expected']}")
    if [len(t) for t in tokens] != [NEW_TOKENS] * len(prompts) or \
            not all(0 <= x < cfg.vocab_size for t in tokens for x in t):
        failures.append(f"{leg}: generate returned {[len(t) for t in tokens]} tokens")
    first = [t[0] for t in tokens]
    before = paged_attention_update.launches
    served = _first_decode_logits(engine, prompts, first)
    res["first_decode_b1_launches"] = paged_attention_update.launches - before
    engine.close()
    del engine
    torch.cuda.empty_cache()
    model = _dense_decoder_f32(params, cfg)
    with torch.no_grad():
        ref = torch.stack([model(torch.tensor([p + [f]], device=dev))[0, -1] for p, f in zip(prompts, first)]).float()
    res["logits_l2_rel_err_vs_f32"] = _l2_rel(served, ref)
    res["logits_max_abs_err_vs_f32"] = (served - ref).abs().max().item()
    res["argmax_agree_vs_f32"] = int((served.argmax(-1) == ref.argmax(-1)).sum())
    if not torch.isfinite(served).all() or not res["logits_l2_rel_err_vs_f32"] <= LOGITS_L2_TOL:
        failures.append(f"{leg}: first decode logits {res['logits_l2_rel_err_vs_f32']} from f32 (L2) > {LOGITS_L2_TOL}")
    # B1 takes the decode put of the 8 requests and every prefill chunk of at
    # most 32 tokens (_prefill puts a prompt in chunks of the token budget)
    budget = _breadth_config().state_manager.max_ragged_batch_size
    small_chunks = sum(1 for p in prompts for start in range(0, len(p), budget) if len(p[start:start + budget]) <= 32)
    res["first_decode_b1_expected"] = 2 * cfg.num_hidden_layers * (1 + small_chunks)
    if res["first_decode_b1_launches"] != res["first_decode_b1_expected"]:
        failures.append(f"{leg}: the first decode step's puts launched B1 {res['first_decode_b1_launches']} times, "
                        f"expected {res['first_decode_b1_expected']}")
    limit = TF_SLACK * res["logits_max_abs_err_vs_f32"]
    gaps, shifted = _tf_gaps(model, dev, list(zip(prompts, tokens)))
    res["teacher_forced"] = dict(limit=limit, tokens=int(gaps.numel()), max_gap=gaps.max().item(),
                                 exact=int((gaps == 0).sum()), control_shifted_max_gap=shifted.max().item())
    if not gaps.max().item() <= limit:
        failures.append(f"{leg}: a served token trails the f32 maximum by {gaps.max().item()} > {limit}")
    if not shifted.max().item() > limit:
        failures.append(f"{leg}: control: the shifted tokens passed the teacher-forced check")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"[breadth] {leg} " + json.dumps(res))
    return res


def _dequantize_ms(engine, names, reps=3) -> float:
    """Device ms to dequantize every quantized weight once, as a forward
    reads each once (CUDA events around ``reps`` passes)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        for name in names:
            engine.model._params[name]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _breadth_quantized_leg(params, cfg, dev, prompts, main, failures) -> dict:
    """Leg c: the main path's model quantized at build time to int8, then
    int4, served through generate: the at-rest bytes (``tree_nbytes``)
    against the bf16 tree's, the peak memory in generate, a decode step's
    ms and the dequantize's share of it; the first decode step's logits and
    the greedy tokens held to a bf16 engine on
    ``dequantize_tree(quantize_tree(params))`` (the same weights): logits
    bit for bit, tokens equal, or teacher-forced through the dense f32 model
    of those weights where they differ (control: int8's tokens against the
    int4 weights' engine)."""
    t0 = time.perf_counter()
    bf16_bytes = tree_nbytes(params)
    res, tokens_by_bits, logits_by_bits, ref_by_bits = dict(bf16_bytes=bf16_bytes), {}, {}, {}
    tol = TF_SLACK * max(main["logits_max_abs_err_kernel_vs_f32"], main["logits_max_abs_err_gather_vs_f32"])
    for bits in (8, 4):
        r = res[f"int{bits}"] = {}
        engine = build_engine(params, cfg, _breadth_config(quantization=QuantizationConfig(enabled=True, bits=bits)),
                              device=dev)
        stored = dict(engine.model._params.items())
        names = [n for n, v in stored.items() if is_quantized_leaf(v)]
        r.update(weight_bytes=tree_nbytes(stored), quantized_tensors=len(names))
        r["bytes_ratio_to_bf16"] = r["weight_bytes"] / bf16_bytes
        del stored
        tokens, r["served"] = _served(engine, prompts)
        r["dequantize_ms"] = _dequantize_ms(engine, names)
        r["dequantize_share_of_decode_step"] = r["dequantize_ms"] / r["served"]["ms_per_decode_step"]
        first = [t[0] for t in tokens]
        q_logits = _first_decode_logits(engine, prompts, first)
        engine.close()
        del engine
        torch.cuda.empty_cache()
        lo, hi = BREADTH_BYTES_RATIO[bits]
        if not lo <= r["bytes_ratio_to_bf16"] <= hi:
            failures.append(f"c: int{bits} weights at rest are {r['bytes_ratio_to_bf16']:.4f} of bf16's, "
                            f"outside [{lo}, {hi}]")
        if r["served"]["b1_launches"] <= 0 or r["served"]["b1_launches"] != r["served"]["b1_expected"]:
            failures.append(f"c: int{bits}: B1 launched {r['served']['b1_launches']} times, "
                            f"expected {r['served']['b1_expected']}")
        deq = dequantize_tree(quantize_tree(params, bits=bits))
        ref_engine = build_engine(deq, cfg, _breadth_config(), device=dev)
        ref_tokens, r["dequantized_bf16_served"] = _served(ref_engine, prompts)
        ref_logits = _first_decode_logits(ref_engine, prompts, first)
        ref_engine.close()
        del ref_engine
        r["first_decode_logits_bitwise"] = bool(torch.equal(q_logits, ref_logits))
        differ = [i for i, (a, b) in enumerate(zip(tokens, ref_tokens)) if a != b]
        r["requests_with_equal_tokens"] = len(prompts) - len(differ)
        if not r["first_decode_logits_bitwise"]:
            failures.append(f"c: int{bits}: the first decode logits differ from the dequantized bf16 engine's "
                            f"(max {(q_logits - ref_logits).abs().max().item()})")
        if differ:
            model = _dense_f32(deq, cfg)
            gaps, _ = _tf_gaps(model, dev, [(prompts[i], tokens[i]) for i in differ])
            del model
            r["teacher_forced"] = dict(requests=differ, limit=tol, max_gap=gaps.max().item())
            if not gaps.max().item() <= tol:
                failures.append(f"c: int{bits}: a token that differs from the dequantized engine's trails the f32 "
                                f"maximum by {gaps.max().item()} > {tol}")
        del deq
        gc.collect()
        torch.cuda.empty_cache()
        tokens_by_bits[bits], logits_by_bits[bits], ref_by_bits[bits] = tokens, q_logits, (ref_tokens, ref_logits)
    # control: int8's logits and tokens against the int4 weights' engine
    res["control_int8_vs_int4_logits_equal"] = bool(torch.equal(logits_by_bits[8], ref_by_bits[4][1]))
    res["control_int8_vs_int4_requests_equal"] = sum(a == b for a, b in zip(tokens_by_bits[8], ref_by_bits[4][0]))
    if res["control_int8_vs_int4_logits_equal"] or res["control_int8_vs_int4_requests_equal"] == len(prompts):
        failures.append("c: control: the int4 weights' engine passed the int8 engine's checks")
    res["seconds"] = time.perf_counter() - t0
    log("[breadth] c " + json.dumps(res))
    return res


def _breadth_disk_leg(params, dev, prompts, failures) -> dict:
    """Leg d: Llama-2-7B's widths at BREADTH_DISK_LAYERS written as an HF
    directory by the port's own safetensors writer; ``build_hf_engine`` on it
    against ``build_engine`` on the same weights, ``serialize`` then
    ``build_engine_from_ds_checkpoint``, and the same for the int8 engine
    (loaded back quantized, C24), each first decode step bit for bit
    (control: the int8 logits against bf16's); then ``python -m
    deepspeed_tpu_torch.bin.dstpu_replica --checkpoint`` on the card answers
    a request over HTTP with an in-process engine's tokens from the same
    arguments (control: the int8 engine's tokens). Everything written goes
    under one ``tempfile.mkdtemp()`` and is removed."""
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=BREADTH_DISK_LAYERS)
    small = {k: v for k, v in params.items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < BREADTH_DISK_LAYERS}
    first = [int(p[-1]) for p in prompts]
    config, qconfig = _breadth_config(), _breadth_config(quantization=QuantizationConfig(enabled=True, bits=8))
    root = tempfile.mkdtemp()
    res = dict(layers=BREADTH_DISK_LAYERS, parameters=sum(v.numel() for v in small.values()))
    proc = None
    try:
        hf, ds, dsq = (os.path.join(root, n) for n in ("hf", "ds", "ds_int8"))
        t = time.perf_counter()
        save_hf_checkpoint(hf, small, cfg)
        res["hf_write_s"] = time.perf_counter() - t
        res["hf_bytes"] = os.path.getsize(os.path.join(hf, "model.safetensors"))
        engine = build_engine(small, cfg, config, device=dev)
        want = _first_decode_logits(engine, prompts, first)
        engine.close()
        t = time.perf_counter()
        engine = build_hf_engine(hf, config, device=dev)
        torch.cuda.synchronize()
        res["hf_load_s"] = time.perf_counter() - t
        res["hf_bitwise"] = bool(torch.equal(_first_decode_logits(engine, prompts, first), want))
        t = time.perf_counter()
        engine.serialize(ds)
        res["serialize_s"] = time.perf_counter() - t
        engine.close()
        t = time.perf_counter()
        engine = build_engine_from_ds_checkpoint(ds, config, device=dev)
        torch.cuda.synchronize()
        res["ds_load_s"] = time.perf_counter() - t
        res["ds_bitwise"] = bool(torch.equal(_first_decode_logits(engine, prompts, first), want))
        engine.close()
        quantized = build_engine(small, cfg, qconfig, device=dev)
        want_q = _first_decode_logits(quantized, prompts, first)
        quantized.serialize(dsq)
        stored = dict(quantized.model._params.items())
        again = build_engine_from_ds_checkpoint(dsq, qconfig, device=dev)
        loaded = dict(again.model._params.items())
        res["int8_leaves_back_quantized"] = sum(
            1 for n, v in stored.items() if is_quantized_leaf(v) and is_quantized_leaf(loaded[n])
            and all(torch.equal(v[k], loaded[n][k]) for k in v))
        res["int8_leaves"] = sum(1 for v in stored.values() if is_quantized_leaf(v))
        res["int8_ds_bitwise"] = bool(torch.equal(_first_decode_logits(again, prompts, first), want_q))
        res["control_int8_vs_bf16_equal"] = bool(torch.equal(want_q, want))
        again.close()
        del engine, again, stored, loaded
        torch.cuda.empty_cache()
        for key in ("hf_bitwise", "ds_bitwise", "int8_ds_bitwise"):
            if not res[key]:
                failures.append(f"d: {key} is false")
        if res["int8_leaves_back_quantized"] != res["int8_leaves"] or not res["int8_leaves"]:
            failures.append(f"d: {res['int8_leaves_back_quantized']} of {res['int8_leaves']} int8 leaves loaded "
                            "back quantized (C24)")
        if res["control_int8_vs_bf16_equal"]:
            failures.append("d: control: the int8 engine's logits passed the bitwise check against bf16's")

        # the replica entry point on the card, over HTTP
        repo = os.path.dirname(os.path.abspath(__file__))
        port_file = os.path.join(root, "replica.port")
        args = ["--checkpoint", hf, *BREADTH_REPLICA_ARGS]
        prompt = list(prompts[0])
        t = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.bin.dstpu_replica", "--port-file",
                                 port_file, *args], cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
        while not os.path.exists(port_file):
            if proc.poll() is not None or time.perf_counter() - t > 300:
                raise AssertionError(f"d: the replica exited ({proc.poll()}) or never announced its port")
            time.sleep(0.05)
        res["replica_spawn_to_port_s"] = time.perf_counter() - t
        with open(port_file) as f:
            host, port = f.read().split()
        status, _, body = _exchange(f"http://{host}:{port}/v1/generate", "POST",
                                    json.dumps(dict(prompt=prompt, max_new_tokens=BREADTH_REPLICA_TOKENS)).encode(),
                                    {"Content-Type": "application/json"})
        served = json.loads(body).get("tokens") if status == 200 else None
        proc.terminate()
        proc.wait(timeout=120)
        in_process = dstpu_replica.build_engine_from_args(dstpu_replica.parser().parse_args(args))
        want_tokens = generate(in_process, [prompt], max_new_tokens=BREADTH_REPLICA_TOKENS)[0]
        in_process.close()
        control = generate(quantized, [prompt], max_new_tokens=BREADTH_REPLICA_TOKENS)[0]
        quantized.close()
        del in_process, quantized
        res.update(replica_status=status, replica_tokens=served, in_process_tokens=want_tokens,
                   control_int8_tokens=control)
        if served != want_tokens:
            failures.append(f"d: the replica served {served}, the in-process engine {want_tokens}")
        if control == want_tokens:
            failures.append("d: control: the int8 engine's tokens passed the replica's equality check")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log("[breadth] d " + json.dumps(res))
    return res


def run_breadth_path(dev, params, main) -> dict:
    """The breadth phase (module doc, phase 10): legs a (Falcon-7B's widths),
    b (Phi-2's), c (the main path's model at int8 and int4) and d (weights
    from disk), each leg's seconds and peak memory beside its prediction."""
    log(f"[breadth] predicted {BREADTH_PREDICTED_S:.0f} s; legs (s, peak GiB): " + json.dumps(BREADTH_PREDICTED))
    t0 = time.perf_counter()
    rng = np.random.default_rng(20)
    failures, res = [], dict(predicted_s=BREADTH_PREDICTED_S, predicted_legs=BREADTH_PREDICTED)
    for leg, cfg in (("a", falcon7b_config()), ("b", phi2_config())):
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
        torch.cuda.reset_peak_memory_stats()
        res[leg] = _breadth_decoder_leg(leg, cfg, dev, prompts, failures)
        res[leg]["leg_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    cfg = serve_config()
    prompts = [np.random.default_rng(0).integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats()
    res["c"] = _breadth_quantized_leg(params, cfg, dev, prompts, main, failures)
    res["c"]["leg_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    res["d"] = _breadth_disk_leg(params, dev, prompts, failures)
    res["d"]["leg_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["b1_launches"] = res["a"]["b1_launches"] + res["b"]["b1_launches"] + sum(
        res["c"][f"int{b}"]["served"]["b1_launches"] for b in (8, 4))
    res["seconds"] = time.perf_counter() - t0
    res["failures"] = failures
    log("[breadth] legs (s, peak GiB): " + json.dumps({k: (round(res[k]["seconds"], 1), round(res[k]["leg_peak_gib"], 2))
                                                       for k in "abcd"}) + f"; {res['seconds']:.1f} s")
    log(card_line())
    if failures:
        raise AssertionError("breadth phase: " + "; ".join(failures))
    return res


def _phase(record, name, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``record["phase_seconds"]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    record.setdefault("phase_seconds", {})[name] = time.perf_counter() - t0
    log(f"[phase] {name} {record['phase_seconds'][name]:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    # the zero phase's ranks (legs b and c) are this script, started again
    if sys.argv[1:2] == ["--zero-rank-child"]:
        return zero_rank_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--zero-gang-child"]:
        return zero_gang_child()
    if sys.argv[1:2] == ["--zero-plus-child"]:
        return zero_plus_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--moe-rank-child"]:
        return moe_rank_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--par-rank-child"]:
        return parallel_rank_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--composed-rank-child"]:
        return composed_rank_child(*sys.argv[2:])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    card = card_line()
    log(card)
    record = {"card": card, "device": torch.cuda.get_device_name(0)}
    record["build"] = _phase(record, "build", build_kernels)
    record["paged_attention"] = _phase(record, "paged_attention", check_paged_attention, dev)
    record["flash_attention"] = _phase(record, "flash_attention", check_flash_attention, dev)
    record["block_sparse_attention"] = _phase(record, "block_sparse_attention", check_block_sparse_attention, dev)
    params = main_params(dev)
    record["main_path"] = _phase(record, "main_path", run_main_path, dev, params)
    record["serving_path"] = _phase(record, "serving_path", run_serving_path, dev, params, record["main_path"])
    record["prefix_path"] = _phase(record, "prefix_path", run_prefix_path, dev, params, record["main_path"])
    record["spec_path"] = _phase(record, "spec_path", run_spec_path, dev, params, record["main_path"])
    record["observe_path"] = _phase(record, "observe_path", run_observe_path, dev, params, record["main_path"])
    record["fleet_path"] = _phase(record, "fleet_path", run_fleet_path, dev, params, record["main_path"])
    record["fleet_path"]["single_replica"] = {k: record["serving_path"][k] for k in (
        "ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s", "served_tokens_per_s")}
    record["breadth_path"] = _phase(record, "breadth_path", run_breadth_path, dev, params, record["main_path"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    record["moe_path"] = _phase(record, "moe_path", run_moe_path, dev)
    gc.collect()
    torch.cuda.empty_cache()
    record["training_path"] = _phase(record, "training_path", run_training_path, dev)
    gc.collect()
    torch.cuda.empty_cache()
    record["checkpoint_path"] = _phase(record, "checkpoint_path", run_checkpoint_path, dev)
    gc.collect()
    torch.cuda.empty_cache()
    record["train_features_path"] = _phase(record, "train_features_path", run_train_features_path, dev)
    gc.collect()
    torch.cuda.empty_cache()
    record["zero_path"] = _phase(record, "zero_path", run_zero_path, dev)
    gc.collect()
    torch.cuda.empty_cache()
    record["zero_plus_path"] = _phase(record, "zero_plus_path", run_zero_plus_path, dev)
    gc.collect()
    torch.cuda.empty_cache()
    record["parallel_path"] = _phase(record, "parallel_path", run_parallel_path, dev, record["main_path"])
    gc.collect()
    torch.cuda.empty_cache()
    record["composed_path"] = _phase(record, "composed_path", run_composed_path, dev, record["main_path"])
    record["seconds"] = time.perf_counter() - t_start

    decode = record["paged_attention"][0]  # the serving path's decode shape
    kernels = [dict(name="paged_attention_update", route="cuda", design=PAGED_DESIGN,
                    source="deepspeed_tpu_torch/csrc/paged_attention.cu",
                    replaces="deepspeed_tpu/ops/pallas/paged_attention.py:37",
                    launches=record["main_path"]["paged_attention_launches"],
                    launches_prefix_path=record["prefix_path"]["b1_launches"],
                    launches_spec_path=record["spec_path"]["b1_launches"],
                    launches_observe_path=record["observe_path"]["b1_launches"],
                    launches_fleet_path=record["fleet_path"]["b1_launches"],
                    launches_breadth_path=record["breadth_path"]["b1_launches"],
                    launches_moe_path=record["moe_path"]["b1_launches"],
                    launches_parallel_path=record["parallel_path"]["b1_launches"],
                    launches_composed_path=record["composed_path"]["b1_launches"],
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
                            launches_train_features_path=record["train_features_path"]["flash_launches"][kern],
                            launches_zero_path=record["zero_path"]["flash_launches"][kern],
                            launches_zero_plus_path=record["zero_plus_path"]["flash_launches"][kern],
                            launches_parallel_path=record["parallel_path"]["flash_launches"][kern],
                            launches_composed_path=record["composed_path"]["flash_launches"][kern],
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
    log(f"[done] {record['seconds']:.1f} s; phases " + json.dumps({k: round(v, 1) for k, v in
                                                               record["phase_seconds"].items()}))
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
