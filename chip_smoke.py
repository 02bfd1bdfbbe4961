#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``outfitx_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only dsv2   # env, build and the dsv2 phase alone
    python3 chip_smoke.py --only resnet # env, build and the resnet phase alone
    python3 chip_smoke.py --only kimivl # env, build, the dsv2 and kimivl phases

Each phase's seconds print at the end (``phase_seconds``).
Phases, each printing one JSON line:
1. env      torch and CUDA versions, the card's name and power limit;
2. build    compile every CUDA kernel (forward and backward attention, the
            fused attention block, the fused tower MLP, LayerNorm) with nvcc
            for sm_90a, one process per source, all started together; ptxas
            registers and spills by kernel, the Hopper kernels' dynamic
            shared memory;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the set transformer's shapes and at the towers' (attention at
            L=196, 50, 77 causal and 256, and at the shapes that test the
            bfloat16 forward's tiling: a ragged last pack of slabs at L=17,
            L=21, 32, 33 (3, 2, 1 slabs a tile), 64, 65 and 129 (N=128 and
            256 score widths), 256 at Dh=128, Dh=16; the backward at the
            shapes that test its tiling: a ragged last pack at L=17, L=9,
            13, 21, 32 (7, 4, 3, 2 slabs a tile), 33 and 64 (one slab, the
            64-slot softmax tree), Dh=16, 48, 64 and 128, and the full batch
            at L=9, 13 and 17, causal and not; attn_block at the SigLIP text
            tower's 2048x64x768 with fully and almost fully masked rows, and
            at B=2047; mlp_fused at 131072 and 401408 (vision) x768x3072 and
            at 130,001 rows; layernorm at 136, 69,632 and 401,408 rows,
            ragged widths, constant and 1e4 rows, and its closed-form
            backward against autograd; the attention forward at MiniLM's
            (64,12,64,32) with tail-padded keys and at (4096,16,17,8), the
            set transformer over resnet_sbert embeddings on the bfloat16
            narrow-head route, causal and not; layernorm at MiniLM's
            131,072 x 384 rows with eps 1e-12; the original-CP path's
            shapes: the backward at (350,16,17,8) (Dh=8, the narrow route)
            causal and not, the forward at MiniLM's (5600,12,16,32)
            tail-padded, layernorm at 89,600 x 384 (eps 1e-12) and 5,950 x
            128 with its closed-form backward); the narrow-head
            route (bfloat16, Dh=8, L <= 32): first its division against
            IEEE division for every float sum in [1, 32), then its P
            against the plain version's bit for bit (the in-thread tree
            against torch.softmax), then forward and backward at L=1, 2,
            9, 16, 17, 31, 32 with a ragged last group, a fully masked row
            and tail-padded keys, causal and not, and the backward at the
            resnet_sbert step's (3072,16,17,8); the stream a wrapper hands
            its kernel is PyTorch's current one;
4. serve    the serving engine at full width (d=1536, 6 layers, 16 heads,
            random weights from seed 0) answers CP, CIR (both routes), FITB
            and similar-item requests; the kernel launch counts of that run
            are checked (6 attention and 12 LayerNorm launches a forward),
            and the answers are held against the same engine on the CPU in
            float32; then an engine with ``attn="block"`` answers the CP
            requests through the fused attention block (6 launches a
            forward) within the CPU tolerance of the default engine; then
            an int8 engine (``quantize_model=True``, the W8A8 forward) on
            the same catalog: CP within 0.05 of the bfloat16 engine, CIR
            top-10 overlap of 7 in 10 on average, FITB in range, 6
            attention and 12 LayerNorm launches a forward; then the
            default engine's CP and CIR weights written as checkpoints from
            before the QKV fusion (``best_auc`` and ``best_recall@1`` with
            per-projection wq/wk/wv and bq/bk/bv) and an engine built from
            them (``build_engine(checkpoint_dir=...)``): weights, CP scores
            and CIR top-10 answers bit-equal to the default engine's, 6
            attention and 12 LayerNorm launches a forward; the seconds the
            writes, the restore and the build took, on a line of its own;
5. train    (a) one CP train step at full width (B=64, A=2, bf16) against
            the same step on the CPU in float32 from the same weights;
            (b) ``CPTrainer`` at the reference envelope (B=3072, A=4,
            dropout 0.3, d=1536, 6 layers) for 3 optimizer steps, a
            validation pass and the final checkpoint; (c) ``CIRTrainer``
            warm-started from that checkpoint for 2 steps at B=512 and one
            recall evaluation; the launch counts of (b) and (c) are checked;
            (d) ``FITBTrainer`` restores (c)'s final checkpoint and answers
            the FITB split (6 attention and 12 LayerNorm launches a
            forward), 64 picks against the CPU in float32 with the near-tie
            rule; saves are asynchronous (``async_saves``), the final
            checkpoint equals the live parameters; then the CP train step's
            time, outfits/s, peak memory, a profile by kernel and the
            attention backward's device ms a step; (e) remat: the CP step
            at B=3072 x A=4 with each policy ('full', 'masks', 'dots')
            against the plain step from the same weights and dropout seed
            (loss and every gradient bit-equal or within a bfloat16
            rounding, exact launches: the layers' forward kernels launch
            again in the backward), step ms and peak memory each, then a
            'full' step at B=16,384 x A=1 beside the peak the plain step
            would need there; (f) the CIR trainer's host assembly of one
            epoch of 36,864 outfits on the native route (which must build)
            and the python route, seconds an epoch and a step, each held
            to the batch invariants; (g) a resume at the envelope:
            ``CPTrainer`` A trains 2 epochs with a rolling ``latest``, B
            (the same config) resumes A's first-epoch ``latest`` and
            trains the second: B's parameters, Adam moments and count
            bit-equal to A's final ones, exact steps and launches; the
            saved optimizer state in optax's layout (the JAX package's
            skeleton, ``mu`` of ``jax_params_from_state_dict``'s shapes);
            the checkpoint's bytes, a synchronous save's and the resume's
            seconds;
6. precompute  ``PrecomputeRunner`` with the SigLIP item encoder at full
            width (ViT-B/16 at 196 tokens, text at L=64, d=768, 12 layers,
            random weights from seed 0): 4,096 synthetic items at batch 2048
            with the fused attention block as the text tower's route, shards
            written and read back, launch counts checked exactly, every
            embedding finite with unit-norm halves; the first 32 items
            against the CPU in float32 (cosine per half); one batch with the
            fused MLP in both towers against the first pass; one small batch
            of the CLIP pair (L=50 and causal L=77); items/s, seconds per
            batch, peak memory and a profile of one batch by kernel kind;
            then the resnet_sbert encoder at full width (ResNet-18 at 224
            x 224, MiniLM 6 x 384 at T=64): 4,096 items at batch 2048 with
            exact launch counts (6 attention and 13 LayerNorm a MiniLM
            pass), 32 items against the CPU in float32, items/s and peak
            memory, and the set transformer at d_embed 128 (Dh=8) scoring
            outfits drawn from those embeddings against the CPU;
7. http     ``serve()`` at full width in a thread, spare rows and the three
            coalescers on: concurrent clients on /api/cp, /api/cir,
            /api/similar, /api/fitb and /api/cp_batch against the engine's
            direct answers, fewer batched calls than requests; a live update
            and an append over HTTP that the next request sees, no sentinel
            row returned; whole-catalog CIR requests racing updates; the
            stats and OpenAPI routes; exact launch counts; an age drain that
            lets an in-flight request finish and ends with exit code 81;
8. retrieval  300,000 items x 1536 (above the default chunk threshold):
            top-10 neighbours of 8 items by the dense, chunked, int8 and
            int8-chunked routes (chunked equals dense, int8 overlaps it),
            each route's ms and peak memory, ``torch.topk`` alone, and a
            live update of 1,500 rows against a full requantisation;
9. original_cp  ``OriginalCPTrainer`` at full width (ResNet-18 at 224 x
            224 and MiniLM 6 x 384 at T=16 inside the train step, the set
            transformer at d_embed 128, bf16) on a synthetic raw source at
            the reference envelope B=350 x A=10: one small step card against
            CPU (loss, head gradients), 2 optimizer steps, a validation pass
            and asynchronous best checkpoints, exact launch counts a
            microbatch (12 attention forwards, 6 backwards, 25 LayerNorms),
            frozen backbones bit-identical; step seconds, outfits/s, tower
            items/s, peak memory, the host gather's share of the step and a
            profile of one step;
10. cli     the command line in child processes on the card: ``cp``,
            ``cir`` warm-started from it, ``fitb`` from the CIR checkpoint,
            ``export-torch`` (the .pth loads strictly and scores as the
            checkpoint), ``pes --shards 2`` (shards read back),
            ``original-cp`` at a small batch, ``demo --max-age`` (one
            request, then exit 81), each with the launches it made;
11. parallel  the device mesh on the one card (ranks and shards share it:
            no time here measures scaling): the retrieval phase's 300,001
            rows row-sharded over 1, 2 and 4 shards (2 and 4 pad them) by
            ``retrieve_sharded`` and ``retrieve_quantized_sharded``, equal
            to ``retrieve`` and ``retrieve_quantized`` (indices; distances
            to 1e-5 relative), with ms each; the engine at full width on a
            4-shard mesh, bfloat16 and int8 catalogs, answering CP, CIR,
            FITB and similar items as the one-device engine does, before
            and after the same updates and appends, with exact launch
            counts (6 attention and 12 LayerNorm a forward); the CP step at
            B=768 x A=1 in 2-rank gloo groups (``chip_smoke.py
            --parallel-worker``, CUDA tensors) at mesh (1, 2), (2, 1) and
            (2, 1) with FSDP (on a machine with several cards, NCCL with
            a card a rank, and every mesh of all the cards too): the CP
            and CIR steps in float32 against the one-rank step (loss,
            whole gradients, and to 1e-4 the parameters whose one-rank
            gradient is not within the gradient check's tolerance of 0),
            then in bfloat16 the launches a rank and their shapes
            ((768,8,17,96) under model=2, (384,16,17,96) under data=2), the
            collective bytes a step, step ms and peak memory a rank; on the
            FSDP meshes the step with remat against the plain step (loss,
            the rank's gradients, launches, and exactly the recomputed
            all-gathers and g all-reduces more collective bytes); and a
            one-rank NCCL group (the launcher's environment) training the
            CP trainer at B=3072 x A=4 for 3 steps, with its step time;
12. timing  kernel, plain version and the PyTorch library call at the
            serving bucket (B=8), the training and throughput shapes and
            the towers' shapes at batch 2048 (attention also at the CLIP
            towers' L=50 and causal L=77; the bytes that attn_block and
            mlp_fused read through L2 per launch, beside the earlier
            one-block design's); the CP forward's outfits/s at B=4096, the
            cp_score latency, and the host microseconds per call of the
            layernorm wrapper and of F.layer_norm at the serving bucket;
            the int8 route beside the bfloat16 one (CP forward at B=4096
            with its device time split into the int8 products, the
            quantize and dequantize passes, attention and LayerNorm; its
            cp_score p50/p99) and ``torch._int_mm`` against ``torch.matmul``
            in bfloat16 at (69632, 1536) x (1536, 4608); attention also at
            MiniLM's (2048,12,64,32) and at Dh=8, layernorm at 384; the
            original-CP path's attention (5600,12,16,32) and
            (350,16,17,8) forward and backward (the launch-bound rows:
            medians of five turns), layernorm at 89,600 x 384 and 5,950 x
            128; the meshed step's shapes a rank, attention (768,8,17,96)
            and (384,16,17,96) forward and backward, layernorm at 13,056
            and 6,528 rows; the backward at (3072,16,17,8), and the
            set transformer over resnet_sbert embeddings end to end, its
            CP forward at B=4096 and one CP train step at B=3072 x A=4,
            each with a profile by kernel kind, whose attention kernels
            must all be the narrow route's.
Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without the last line. It needs a CUDA card
and the repository around it; it imports nothing of JAX. Checkpoints and
logs go under the checkout's ``build/chip_smoke/``.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter
import math
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel against plain version on the card. float32: same arithmetic, other
# summation order. bfloat16: P and the output round to bfloat16, so one
# rounding flip of either gives up to 2 ulps at O(1).
F32_TOL = 1e-5
BF16_REL = 2.0**-7
# Card (bfloat16 compute) against CPU (float32 compute), same weights.
CP_PROB_TOL = 0.02
CIR_TOP1_MIN = 0.9
# Where the top-1 differs, the card's pick must be a near-tie on the CPU:
# among the CPU's top 10, at a squared distance within 2% of the CPU's best
# (the bf16 forward moves the query by about 1%).
CIR_TIE_REL = 0.02
FITB_MIN = 0.75
SIM_OVERLAP_MIN = 0.9

# attn_block and mlp_fused in float32 sum 768 or 3072 products of O(0.1..1)
# in another order than cuBLAS does in the plain version (chunks of 64 or 128,
# heads one after another); at float32's 6e-8 a sum of 3072 such terms moves
# by up to a few 1e-6 and the largest of 1e8 outputs by more, so these two
# get 5e-5 in float32. The attention kernels sum at most 256 terms and keep
# F32_TOL.
F32_SUM_TOL = 5e-5
# Precompute: card (bfloat16) against CPU (float32), same weights, cosine of
# each modality's unit-norm half; and the fused-MLP pass against the plain one
# (both bfloat16 on the card; they round the MLP's mid tensor at other places).
PRECOMPUTE_COS_MIN = 0.99
FUSED_COS_MIN = 0.999

# The meshed train step's shapes a rank (B=768): 8 heads under model=2,
# 384 rows under data=2.
PARALLEL_MHA_SHAPES = {"tp": (768, 8, 17, 96), "dp": (384, 16, 17, 96)}
KERNEL_SHAPES = [(8, 16, 17, 96), (4096, 16, 17, 96), (3, 4, 9, 16)] + list(
    PARALLEL_MHA_SHAPES.values()
)
# The forward at tower lengths: SigLIP ViT-B/16 (196 patches), CLIP ViT-B/32
# (50 tokens), CLIP text (77, causal), and the kernel's largest L and Dh.
TOWER_MHA_SHAPES = [
    ((64, 12, 196, 64), False), ((64, 12, 50, 64), False),
    ((64, 8, 77, 64), True), ((2, 4, 256, 128), False),
]
# The bfloat16 forward's tiling (csrc/masked_mha_fwd.cu dispatch_tiles):
# B*H = 35 slabs at L=17 leave the last pack of 3 ragged; L=21, 32 and 33
# pack 3, 2 and 1 slabs a tile; L=64 is the last packed length, 65 and 129
# the first at score widths 128 and 256; L=256 at Dh=128 causal; Dh=16 (one
# k16 step). Then the packed kernel at full batch where rows have few keys
# (L=9: 7 slabs a tile; L=13: 4, 52 of 64 rows), causal and not: there a P
# near 1 rounds on the last bit of S and of the row's sum.
FWD_TILE_SHAPES = [
    ((7, 5, 17, 96), False), ((7, 5, 17, 96), True), ((5, 4, 21, 64), False),
    ((6, 4, 32, 32), True), ((4, 3, 33, 48), False), ((4, 3, 64, 64), True),
    ((4, 3, 65, 64), False), ((4, 3, 129, 64), True), ((2, 4, 256, 128), True),
    ((5, 3, 17, 16), False),
    ((4096, 16, 9, 96), False), ((4096, 16, 9, 96), True),
    ((4096, 16, 13, 96), False), ((4096, 16, 13, 96), True),
]
# The forward at the shapes the int8 forward's and resnet_sbert's paths
# give it: MiniLM (T=64, Dh=32) with keys padded at each row's tail as the
# tokenizer pads them, and the set transformer over resnet_sbert embeddings
# (d_embed 128, 16 heads: Dh=8, bfloat16 on the narrow route), causal and
# not. (shape, causal, tail-padded keys).
SLICE8_MHA_SHAPES = [
    ((64, 12, 64, 32), False, True),
    ((4096, 16, 17, 8), False, False), ((4096, 16, 17, 8), True, False),
]
# The original-CP path's shapes: MiniLM at T=16 over the 5,600 texts of one
# microbatch (350 outfits x 16 items), keys padded at each row's tail; the
# set transformer over its embeddings (d_embed 128, Dh=8) forward and
# backward (the bfloat16 narrow route of both kernels), with padded keys; and
# LayerNorm at MiniLM's 89,600 rows (eps 1e-12) and the set transformer's
# 5,950 (eps 1e-5). (shape, causal, tail-padded keys) for the forward.
OCP_MHA_SHAPES = [((5600, 12, 16, 32), False, True)]
OCP_BWD_SHAPES = [(350, 16, 17, 8)]
OCP_LAYERNORM_SHAPES = [((89600, 384), 1e-12), ((5950, 128), 1e-5)]
# The narrow-head route (bfloat16, Dh = 8, 1 <= L <= 32; csrc/narrow_mha.cuh):
# groups of 256 // L slabs forward and 128 // L backward, a thread a row. B*H
# leaves the last group ragged in both at every L here but the first L=17
# shape, ragged forward only (slabs; slabs a group forward, backward: L=1:
# 536; 256, 128; 2: 296; 128, 64; 9: 65; 28, 14; 16: 35; 16, 8; 17: 35 and
# 40; 15, 7; 31 and 32: 15; 8, 4); row 0 of each batch has every key masked
# (uniform P), and L=9 and 17 also run with keys padded at the tail.
# (shape, tail-padded keys), each causal and not, forward and backward; the
# backward also at the resnet_sbert CP step's microbatch (3072,16,17,8), 49,152
# slabs, ragged too (the forward's (4096,16,17,8) is in SLICE8_MHA_SHAPES).
NARROW_SHAPES = [
    ((67, 8, 1, 8), False), ((37, 8, 2, 8), False), ((13, 5, 9, 8), False),
    ((13, 5, 9, 8), True), ((7, 5, 16, 8), False), ((7, 5, 17, 8), False),
    ((8, 5, 17, 8), True), ((5, 3, 31, 8), False), ((5, 3, 32, 8), False),
]
NARROW_BWD_FULL = (3072, 16, 17, 8)
# The narrow forward's P against the plain version's, bit for bit (V one-hot
# on 8 keys at a time makes the output P itself): the tree-order check.
NARROW_P_SHAPES = [(4096, 16, 17, 8), (67, 8, 1, 8), (13, 5, 9, 8), (5, 3, 32, 8)]
# Attention timing rows whose bound is below LAUNCH_BOUND_MS are launch-bound
# (one reading of (350,16,17,8) gave 0.0754 ms, another 0.0321): medians of
# LAUNCH_BOUND_TURNS turns.
LAUNCH_BOUND_MS = 0.005
LAUNCH_BOUND_TURNS = 5
# The forward's timing rows at the towers' lengths, batch 2048: SigLIP
# ViT-B/16, CLIP ViT-B/32, CLIP text (causal), MiniLM; and the set
# transformer over resnet_sbert embeddings at B=4096.
TOWER_MHA_TIMING = [
    ("vision_tower", (2048, 12, 196, 64), False),
    ("clip_vision_tower", (2048, 12, 50, 64), False),
    ("clip_text_tower", (2048, 8, 77, 64), True),
    ("minilm_text_tower", (2048, 12, 64, 32), False),
    ("resnet_sbert_set_transformer", (4096, 16, 17, 8), False),
    ("original_cp_minilm", (5600, 12, 16, 32), False),
    ("original_cp_set_transformer", (350, 16, 17, 8), False),
]
# Host time of one layernorm launch at the serving bucket, by the host clock
# over this many calls with one synchronisation at the end, in this many
# turns each for the wrapper and F.layer_norm; the device times of the
# layernorm timing rows in this many turns each.
HOST_CALLS = 2000
HOST_TURNS = 5
LAYERNORM_TURNS = 3
# attn_block (B, L, d, H, causal): the SigLIP text tower, the set transformer
# in eval, a small causal case, and the tower's shape at a batch whose token
# rows (131,008) leave the GEMM's last 128-row tile ragged.
ATTN_BLOCK_SHAPES = [
    (2048, 64, 768, 12, False), (8, 17, 1536, 16, False), (3, 16, 64, 4, True),
    (2047, 64, 768, 12, False),
]
# mlp_fused (rows, d, d_mlp, act): the SigLIP text tower's rows, the CLIP
# text tower's widths, ragged row counts (1000; 130,001 is no multiple of
# the GEMM's 128-row tile), and the vision tower's rows (more than one chunk
# of the bfloat16 kernel's mid scratch).
MLP_SHAPES = [
    (131072, 768, 3072, "gelu_tanh"), (4096, 512, 2048, "quick_gelu"),
    (1000, 64, 96, "gelu"), (130001, 768, 3072, "gelu_tanh"),
    (401408, 768, 3072, "gelu_tanh"),
]
# layernorm ((rows..., d), eps): the serving bucket's and the B=4096 set
# transformer's rows, the vision tower's rows with SigLIP's eps, a narrow
# width, widths that are no multiple of the vector width (the scalar kernel,
# in bfloat16 also d=100), a 3-D input, a d above the register kernel's,
# and MiniLM's rows at batch 2048 (d=384, BERT's eps).
LAYERNORM_SHAPES = [
    ((136, 1536), 1e-5), ((69632, 1536), 1e-5), ((401408, 768), 1e-6),
    ((1000, 96), 1e-5), ((257, 100), 1e-5), ((33, 1531), 1e-5),
    ((8, 17, 1536), 1e-5), ((5, 4096), 1e-5), ((131072, 384), 1e-12),
    ((13056, 1536), 1e-5), ((6528, 1536), 1e-5),  # a meshed step's rows a rank
]
# The bound shapes of the timing phase: B=4096 and B=3072 set-transformer
# rows, the vision and the text tower's rows at batch 2048, MiniLM's rows.
LAYERNORM_TIMING_SHAPES = [
    (69632, 1536), (52224, 1536), (401408, 768), (131072, 768), (136, 1536),
    (131072, 384), (89600, 384), (5950, 128), (13056, 1536), (6528, 1536),
]
LAYERNORM_EPS = {1536: 1e-5, 768: 1e-6, 384: 1e-12, 128: 1e-5}
KERNELS = ["masked_mha_fwd", "masked_mha_bwd", "attn_block", "mlp_fused", "layernorm",
           "resnet_nhwc"]
# Precompute: the JAX CLI's default synthetic catalog and PrecomputeConfig's
# batch; the fused-MLP pass and the CLIP pair run one smaller sweep each.
PRECOMPUTE_ITEMS = 4096
FUSED_ITEMS = 2048
CLIP_ITEMS = 64
CPU_CHECK_ITEMS = 32
# The backward is also held at the training envelope's microbatch.
BWD_SHAPES = KERNEL_SHAPES + [(3072, 16, 17, 96)]
# The bfloat16 backward's tiling (csrc/masked_mha_bwd.cu dispatch_tiles):
# B*H = 35 slabs at L=17 leave the last pack of 3 ragged; L=9, 13, 21 and 32
# pack 7, 4, 3 and 2 slabs a tile; L=33 and 64 take one slab a tile and the
# softmax's 64-slot tree; Dh=16 (one 32-column box, half of it TMA's
# zeros), 48, 64 and 128 (four boxes). Then the full batch at L=9 and 13
# (L=17 is in BWD_SHAPES), where a P near 1 rounds on the last bit of S and
# of the row's sum and Pb feeds dV directly. Each in float32 and bfloat16,
# causal and not.
BWD_TILE_SHAPES = [
    (7, 5, 17, 96), (5, 4, 9, 96), (4, 5, 13, 64), (5, 4, 21, 64),
    (6, 4, 32, 32), (4, 3, 33, 48), (4, 3, 64, 64), (5, 3, 17, 16),
    (3, 4, 17, 128), (2, 3, 64, 128),
    (4096, 16, 9, 96), (4096, 16, 13, 96),
]

# The http phase: serve() with spare rows and the three coalescers on, its
# clients, the age after which the replica drains (the phase's checks must
# finish before it), and the tolerances against the engine's direct answers.
HTTP_SPARE_ROWS = 64
HTTP_COALESCE_MS = 3.0
HTTP_CLIENTS = 8
HTTP_AGE_S = 15.0
HTTP_CP_TOL = 5e-3
HTTP_OVERLAP_MIN = 0.9
# The retrieval phase: a catalog above the default chunk threshold (262,144).
RETRIEVAL_ITEMS = 300_000
RETRIEVAL_QUERIES = 8
RETRIEVAL_UPDATE_ROWS = 1500
INT8_OVERLAP_MIN = 0.9
# The int8 (W8A8) engine against the bfloat16 one at full width: the JAX
# package's own engine bars (CP within 0.05, CIR top-10 overlap of 7 of 10).
INT8_CP_TOL = 0.05
INT8_CIR_OVERLAP_MIN = 7.0
# torch._int_mm against a bfloat16 product at the B=4096 forward's QKV shape.
INT_MM_SHAPE = (69632, 1536, 4608)
INT8_OPS_PER_S = 1979e12
# The resnet_sbert precompute sweep, and the set transformer over its
# embeddings (d_embed 128) scoring this many outfits.
RESNET_SBERT_OUTFITS = 512

# Training: the reference envelope (CP: B=3072 per microbatch, A=4) for 3
# optimizer steps; CIR at its default B=512, A=1 for 2 steps.
TRAIN_B, TRAIN_A, TRAIN_STEPS = 3072, 4, 3
CIR_STEPS = 2
# 4,096 items per category, so every CIR candidate pool holds 3,000
# distinct items as in the reference.
CATALOG_ITEMS = 32768
# Card (bfloat16) against CPU (float32), one CP train step, same weights,
# dropout 0 (the two devices' generators give different masks).
CHECK_B, CHECK_A = 64, 2
TRAIN_LOSS_REL = 0.02
GRAD_COS_MIN = 0.99
# FITB from the train phase's CIR checkpoint: the card's picks against the
# CPU's (float32) on this many questions.
FITB_CPU_QUESTIONS = 64

# Original-CP at the reference envelope (B=350 outfits of 16 items a
# microbatch, A=10) for 2 optimizer steps over a synthetic raw source of
# 2,000 items (the JAX CLI's synthetic catalog); one step at B=4, A=2 card
# (bfloat16) against CPU (float32).
OCP_B, OCP_A, OCP_STEPS = 350, 10, 2
OCP_ITEMS = 2000
OCP_CHECK_B, OCP_CHECK_A = 4, 2
# Remat in the train phase: one CP step at the envelope under each policy,
# from the plain step's weights and dropout seed, held against it to
# REMAT_GRAD_REL of each gradient's largest element (a bfloat16 rounding);
# timed over REMAT_TIMED_STEPS after one warm step; then one 'full' step
# at a microbatch of REMAT_BIG_B outfits, which the plain step cannot hold.
REMAT_POLICIES = ("full", "masks", "dots")
REMAT_GRAD_REL = 2.0 ** -8
REMAT_TIMED_STEPS = 3
REMAT_BIG_B = 16384
# The CIR trainer's host assembly of one epoch, native and python routes,
# over the CP data's CIR split (36,864 outfits) at the CIR batch.
HOST_ROUTE_BATCH = 512
# The CLI phase: each command a child process, with this time limit.
CLI_TIMEOUT_S = 300
CLI_DEMO_AGE_S = 10.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# Kernel kinds for the profile's summary, by a substring of the kernel's
# name; the first match wins, and what matches none is "other". The Hopper
# GEMM's kernels are named by their epilogue (hg::gemm_kernel<BN, Epi>).
KERNEL_KINDS = (
    ("masked_mha_fwd", ("masked_mha_fwd",)),
    ("masked_mha_bwd", ("masked_mha_bwd",)),
    ("attn_block", ("attn_block", "AttnQkvEpi", "attn_core_kernel", "AttnOutEpi")),
    ("mlp_fused", ("mlp_fused", "MlpMidEpi", "MlpOutEpi")),
    ("layernorm", ("layernorm_",)),
    ("int8_matmul", ("gemm_s8", "i16832gemm", "imma", "s8s8")),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("random", ("distribution", "philox", "random")),
    ("reduce", ("reduce_kernel",)),
    ("host_transfer", ("Memcpy", "Memset")),
    ("copy", ("copy",)),
    ("elementwise", ("elementwise",)),
)


def _kind(name: str) -> str:
    return next(
        (kind for kind, keys in KERNEL_KINDS if any(k in name for k in keys)),
        "other",
    )


def profile_call(fn, top: int = 10, names: bool = False):
    """Device time by kernel over one call of ``fn``, from torch.profiler:
    the call's wall time, the device's busy time, the time by kernel kind
    and the ``top`` kernels (with ``names``, also every attention kernel's
    whole name, which tells its route)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    rows = {}
    for e in kernels:
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    kinds = {}
    for name, (ms, n) in rows.items():
        k_ms, k_n = kinds.get(_kind(name), (0.0, 0))
        kinds[_kind(name)] = (k_ms + ms, k_n + n)
    busy = sum(ms for ms, _ in rows.values())
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]
    extra = {}
    if names:
        extra["attention_kernels"] = sorted(n for n in rows if "masked_mha" in n)
    return {
        **extra,
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "by_kind": {
            k: {"device_ms": ms, "calls": n}
            for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])
        },
        "kernels": [
            {"name": name[:90], "device_ms": ms, "calls": n}
            for name, (ms, n) in ranked
        ],
    }


def attention_inputs(shape, dtype, seed: int):
    b, h, l, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )
    pad = torch.rand((b, l), generator=gen, device="cuda") < 0.3
    pad[:, 0] = False  # the prefix token is never masked on the model path
    if b >= 3:
        pad[0] = True  # a fully masked row: uniform weights, not NaN
        pad[1] = True
        pad[1, 0] = False  # only key 0 kept, as the JAX batch padding does
        pad[2, 1:] = True
    return q, k, v, pad


def tail_padded_attention_inputs(shape, dtype, seed: int):
    """q, k, v ~ N(0, 1) and keys padded at the tail of each row, as a
    tokenizer pads a text: lengths drawn from 1..L, row 0 unpadded, row 1
    one real token."""
    b, h, l, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )
    lengths = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
    lengths[0], lengths[1] = l, 1
    pad = torch.arange(l, device="cuda")[None, :] >= lengths[:, None]
    return q, k, v, pad


def attention_bound(shape, dtype, backward: bool = False):
    """Least time (ms) for the function on these inputs, at the dtype's
    peak. Forward: q, k, v read and out written once, plus the mask;
    4*B*H*L*L*Dh operations (two products). Backward: q, k, v, g read and
    dq, dk, dv written once, plus the mask; 10*B*H*L*L*Dh operations (S,
    dP, dV, dQ and dK)."""
    b, h, l, dh = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    tensors, products = (7, 5) if backward else (4, 2)
    nbytes = tensors * b * h * l * dh * elem + b * l
    ops = 2 * products * b * h * l * l * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _uniform(shape, bound, gen, dtype):
    return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * bound).to(dtype)


def attn_block_inputs(shape, dtype, seed: int):
    """y ~ N(0, 1) as after a LayerNorm; weights uniform(+-1/sqrt(d)) as the
    towers' init; a key-padding mask that keeps the first few tokens of each
    row, as the hash tokenizer pads a 64-token row, with row 0 fully masked
    and, from B = 3 on, row 1 keeping only its first key and row 2 only its
    last (the token SigLIP pools)."""
    b, l, d, h, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bound = 1.0 / math.sqrt(d)
    y = torch.randn((b, l, d), generator=gen, device="cuda").to(dtype)
    wqkv = _uniform((d, 3, d), bound, gen, dtype)
    bqkv = _uniform((3, d), bound, gen, dtype)
    wo = _uniform((d, d), bound, gen, dtype)
    kept = torch.randint(2, max(3, l // 8) + 1, (b,), generator=gen, device="cuda")
    pad = torch.arange(l, device="cuda")[None, :] >= kept[:, None]
    pad[0] = True
    if b >= 3:
        pad[1] = True
        pad[1, 0] = False
        pad[2] = True
        pad[2, -1] = False
    return y, wqkv, bqkv, wo, pad, h, causal


def attn_block_bound(shape, dtype):
    """Least time (ms): y, the weights and the mask read once, the float32
    output written once; 2 B L d 3d (q, k, v) + 4 B H L L Dh (scores and
    P v) + 2 B L d d (out-projection) operations."""
    b, l, d, h, _ = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * l * d + 4 * d * d + 3 * d) * elem + b * l + b * l * d * 4
    ops = 2 * b * l * d * 3 * d + 4 * b * l * l * d + 2 * b * l * d * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def mlp_inputs(shape, dtype, seed: int):
    rows, d, d_mlp, act = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w1 = _uniform((d, d_mlp), 1.0 / math.sqrt(d), gen, dtype)
    b1 = _uniform((d_mlp,), 1.0 / math.sqrt(d), gen, dtype)
    w2 = _uniform((d_mlp, d), 1.0 / math.sqrt(d_mlp), gen, dtype)
    b2 = _uniform((d,), 1.0 / math.sqrt(d_mlp), gen, dtype)
    return x, w1, b1, w2, b2, act


def mlp_bound(shape, dtype):
    """Least time (ms): x, both weights and biases read once, the output
    written once; 4 rows d d_mlp operations (two products)."""
    rows, d, d_mlp, _ = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * rows * d + 2 * d * d_mlp + d + d_mlp) * elem
    ops = 4 * rows * d * d_mlp
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gemm_l2_bytes(m, n, k):
    """Bytes the bfloat16 GEMM of csrc/hopper_gemm.cuh reads through L2 for
    C (m, n) = A (m, k) B (k, n): each (128, BN) output tile loads its A rows
    and B columns over the whole of k (BN = 256 where it divides n, else
    128)."""
    bn = 256 if n % 256 == 0 else 128
    return -(-m // 128) * -(-n // bn) * (128 + bn) * k * 2


def mlp_l2_bytes(shape):
    """(this design, the earlier design) bytes through L2 per bfloat16 launch:
    two GEMMs (the mid tensor written once between them), against a block of
    32 rows that re-read both weight matrices."""
    rows, d, d_mlp, _ = shape
    design = gemm_l2_bytes(rows, d_mlp, d) + gemm_l2_bytes(rows, d, d_mlp)
    return design, -(-rows // 32) * 2 * d * d_mlp * 2


def attn_block_l2_bytes(shape):
    """(this design, the earlier design) bytes through L2 per bfloat16 launch:
    the QKV and out-projection GEMMs and the attention phase's q, k, v boxes
    (64 token rows, 64 columns at a time) and ctx, against a block of 64
    token rows that streamed y for each of 3 H products, all the weights, and
    its ctx rows once per 64 output columns."""
    b, l, d, h, _ = shape
    dh, rows = d // h, b * l
    core = 3 * b * h * -(-dh // 64) * 64 * 64 * 2 + rows * d * 2
    design = gemm_l2_bytes(rows, 3 * d, d) + core + gemm_l2_bytes(rows, d, d)
    per_block = 3 * h * 64 * d * 2 + 4 * d * d * 2 + (d // 64) * 64 * d * 2
    return design, -(-rows // 64) * per_block


def layernorm_inputs(shape, dtype, seed: int):
    """x ~ N(0.5, 2) of ``shape``; weight 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1)
    in float32, as the models keep them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    weight = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    return x, weight, bias


def layernorm_bound(shape, dtype):
    """Least time (ms): x read and the output written once, the two float32
    parameters read once; about 8 float32 operations an element."""
    n = math.prod(shape)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * n * elem + 2 * shape[-1] * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * n / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_env():
    smi = nvidia_smi_line()
    emit({
        "phase": "env",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    })
    return smi


def _ptxas_by_function(log: str):
    """nvcc's ``-Xptxas -v`` report as one entry a kernel: its (mangled)
    name, registers, spill stores and loads, static shared memory."""
    import re

    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"function": m.group(1)[:120]}
            out.append(cur)
        elif cur is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("static_smem", r"(\d+) bytes smem")):
                m = re.search(pat, ln)
                if m:
                    cur[key] = int(m.group(1))
    return out


def _dynamic_smem():
    """Dynamic shared memory of the Hopper kernels, from their libraries."""
    from outfitx_tpu_torch.ops import _build

    out = {}
    for name in ("mlp_fused", "attn_block"):
        lib = _build.load(name)
        out[f"{name}: gemm BN=256"] = lib.hopper_gemm_smem_bytes(256)
        out[f"{name}: gemm BN=128"] = lib.hopper_gemm_smem_bytes(128)
    lib = _build.load("attn_block")
    for dh in (64, 128):
        out[f"attn_block: attention Dh<={dh}"] = lib.attn_block_core_smem_bytes(dh)
    lib = _build.load("masked_mha_fwd")
    for dh in (64, 128):
        out[f"masked_mha_fwd: packed, Dh<={dh}"] = lib.masked_mha_fwd_smem_bytes(dh, 32)
        for keys in (64, 128, 256):
            out[f"masked_mha_fwd: query tiles, Dh<={dh}, keys={keys}"] = (
                lib.masked_mha_fwd_smem_bytes(dh, keys)
            )
    lib = _build.load("masked_mha_bwd")
    for dh in (32, 64, 96, 128):
        for slots in (32, 64):
            out[f"masked_mha_bwd: tiles, Dh<={dh}, slots={slots}"] = (
                lib.masked_mha_bwd_smem_bytes(dh, slots)
            )
    return out


# ---------------------------------------------------------------- dsv2 --
# DeepSeek-V2-Lite's text tower in original-CP (B=64 outfits x 16 items, T =
# 16): MLA's forward on masked_mha's split route and the mixture's grouped
# expert products, at the tower's widths.
DSV2_MLA_SHAPE = (1024, 16, 16, 192, 128)
DSV2_SPLIT_SHAPES = [DSV2_MLA_SHAPE, (7, 3, 1, 24, 16), (33, 4, 17, 40, 24),
                     (64, 2, 64, 256, 128), (16, 16, 64, 192, 128)]
DSV2_TOKENS, DSV2_D, DSV2_F, DSV2_E, DSV2_K = 16384, 2048, 1408, 64, 6


def _split_inputs(shape, dtype, seed):
    b, h, l, dqk, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn((b, h, l, dqk), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    v = torch.randn((b, h, l, dv), generator=gen, device="cuda").to(dtype)
    lengths = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
    pad = torch.arange(l, device="cuda")[None, :] >= lengths[:, None]
    return q, k, v, pad


def _grouped_inputs(seed):
    """A mixture's pairs sorted by expert from a router over random tokens:
    x (N k, d), the stacked gate_up and down weights, the groups' ends."""
    from outfitx_tpu_torch.ops import moe

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((DSV2_TOKENS, DSV2_D), generator=gen, device="cuda").to(torch.bfloat16)
    router = torch.randn((DSV2_E, DSV2_D), generator=gen, device="cuda") * 0.02
    gate_up, down = (
        (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        for shape in ((DSV2_E, 2 * DSV2_F, DSV2_D), (DSV2_E, DSV2_D, DSV2_F))
    )
    _, idx = moe.route(x, router, DSV2_K)
    order, counts, ends = moe.permute(idx, DSV2_E)
    return x[order // DSV2_K].contiguous(), gate_up, down, ends, counts


def phase_dsv2():
    """masked_mha's split route against mha_reference at MLA's shape and
    others (ragged L, L = 1 and 64, Dqk up to 256), bfloat16 and float32,
    causal and not; the grouped expert products against the per-expert
    loop; then each at the tower's shape timed beside its bound, its plain
    version and SDPA."""
    import torch.nn.functional as F

    from outfitx_tpu_torch.ops import moe
    from outfitx_tpu_torch.ops.attention import masked_mha, mha_reference

    cases = []
    for si, shape in enumerate(DSV2_SPLIT_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v, pad = _split_inputs(shape, dtype, 70 + si)
                scale = 0.1147 if shape == DSV2_MLA_SHAPE else 1.0 / math.sqrt(shape[3])
                got = masked_mha(q, k, v, pad, causal, scale=scale)
                ref = mha_reference(q, k, v, pad, causal, scale)
                torch.cuda.synchronize()
                tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": causal}
                check(bool(torch.isfinite(got.float()).all()), f"non-finite split output at {tag}")
                err, ok = _compare(got, ref, dtype)
                cases.append({**tag, "max_abs_err": err, "ok": ok})
                check(ok, f"masked_mha split route disagrees with its plain version: {cases[-1]}")
    xs, gate_up, down, ends, counts = _grouped_inputs(80)
    grouped = []
    for name, a, w in (("gate_up", xs, gate_up), ("down", xs[:, :DSV2_F].contiguous(), down)):
        got = moe.grouped_mm(a, w, ends)
        ref = moe.grouped_mm_reference(a, w, ends)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        ok = bool(((got.float() - ref.float()).abs()
                   <= BF16_REL * ref.float().abs().clamp_min(1.0)).all())
        grouped.append({"projection": name, "shape": [a.shape[0], a.shape[1], w.shape[1]],
                        "max_abs_err": err, "ok": ok})
        check(ok, f"grouped_mm disagrees with the per-expert loop: {grouped[-1]}")

    b, h, l, dqk, dv = DSV2_MLA_SHAPE
    q, k, v, pad = _split_inputs(DSV2_MLA_SHAPE, torch.bfloat16, 90)
    nbytes = b * h * l * (2 * dqk + 2 * dv) * 2 + b * l
    ops = 2 * b * h * l * l * (dqk + dv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[torch.bfloat16] * 1e3
    keep = (~pad)[:, None, None, :] & torch.ones(l, l, dtype=torch.bool, device="cuda").tril()
    mla = {
        "shape": list(DSV2_MLA_SHAPE),
        "ms": cuda_ms(lambda: masked_mha(q, k, v, pad, True, scale=0.1147), 50),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "plain_ms": cuda_ms(lambda: mha_reference(q, k, v, pad, True, 0.1147), 3, warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=0.1147), 50),
    }
    flops_gu = 2.0 * xs.shape[0] * DSV2_D * 2 * DSV2_F
    flops_dn = 2.0 * xs.shape[0] * DSV2_F * DSV2_D
    a_dn = xs[:, :DSV2_F].contiguous()
    expert_ms = cuda_ms(lambda: (moe.grouped_mm(xs, gate_up, ends), moe.grouped_mm(a_dn, down, ends)),
                        20)
    plain_ms = cuda_ms(lambda: (moe.grouped_mm_reference(xs, gate_up, ends),
                                moe.grouped_mm_reference(a_dn, down, ends)), 3, warmup=1)
    experts = {
        "pairs": int(xs.shape[0]), "experts": DSV2_E,
        "tokens_per_expert_min_max": [int(counts.min()), int(counts.max())],
        "ms": expert_ms, "bound_ms": (flops_gu + flops_dn) / PEAK_FLOPS[torch.bfloat16] * 1e3,
        "bound_by": "operations", "plain_ms": plain_ms,
        "launches": moe.grouped_mm.launches,
    }
    emit({"phase": "dsv2", "masked_mha_fwd_split": cases, "grouped_mm": grouped,
          "timing": {"masked_mha_fwd_split": mla, "grouped_mm": experts},
          "nvidia_smi": nvidia_smi_line()})


# -------------------------------------------------------------- kimivl --
# Kimi-VL-A3B's joint encoder in original-CP (B=32 outfits x 16 items):
# MoonViT's attention at (512, 16, 256, 72) on the bfloat16 tile route, the
# decoder's MLA over 64 image tokens and 16 of title on the split route at
# L = 80, and the sigmoid router, at the encoder's widths.
KIMIVL_VIT_SHAPE = (512, 16, 256, 72)
KIMIVL_MLA_SHAPE = (512, 16, 80, 192, 128)
KIMIVL_VIT_CHECKS = [(KIMIVL_VIT_SHAPE, False), ((7, 3, 100, 72), True), ((5, 2, 256, 24), False),
                     ((4, 2, 65, 8), True), ((6, 2, 200, 40), False)]
KIMIVL_SPLIT_CHECKS = [KIMIVL_MLA_SHAPE, (3, 2, 70, 24, 16), (9, 4, 80, 40, 24),
                       (33, 4, 65, 192, 128)]
KIMIVL_TOKENS, KIMIVL_BIAS_STD = 40960, 0.05


def _joint_inputs(shape, dtype, seed):
    """q, k, v of the split route over 64 image tokens and a title padded
    at the tail: the last L - 64 keys drawn 4..16 long (every key at L <=
    64 a title's, 1..L long)."""
    b, h, l, dqk, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn((b, h, l, dqk), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    v = torch.randn((b, h, l, dv), generator=gen, device="cuda").to(dtype)
    first = 64 if l > 64 else 0
    lo = min(first + 4, l)
    lengths = torch.randint(lo, l + 1, (b,), generator=gen, device="cuda")
    pad = torch.arange(l, device="cuda")[None, :] >= lengths[:, None]
    return q, k, v, pad


def phase_kimivl():
    """masked_mha's bfloat16 tile route at MoonViT's (512, 16, 256, 72) and at
    other Dh % 16 != 0 above L = 64, and its split route at the joint L =
    80 (and ragged L up to 80), against mha_reference, bfloat16 (the tile
    route; float32 too on the split route); ``moe.route_sigmoid`` on the
    card against its float64 plain version on a mixture's tokens; then each
    attention at the encoder's shape timed beside its bound, its plain
    version and SDPA."""
    import torch.nn.functional as F

    from outfitx_tpu_torch.ops import moe
    from outfitx_tpu_torch.ops.attention import masked_mha, mha_reference

    vit_cases, split_cases = [], []
    for si, (shape, causal) in enumerate(KIMIVL_VIT_CHECKS):
        q, k, v, pad = attention_inputs(shape, torch.bfloat16, 100 + si)
        if shape == KIMIVL_VIT_SHAPE:
            pad.zero_()  # MoonViT attends over every patch
        before = masked_mha.launches
        got = masked_mha(q, k, v, pad, causal)
        ref = mha_reference(q, k, v, pad, causal)
        torch.cuda.synchronize()
        tag = {"shape": list(shape), "dtype": "bfloat16", "causal": causal}
        check(masked_mha.launches == before + 1, f"no kernel launch at {tag}")
        check(bool(torch.isfinite(got.float()).all()), f"non-finite tile output at {tag}")
        err, ok = _compare(got, ref, torch.bfloat16)
        vit_cases.append({**tag, "max_abs_err": err, "ok": ok})
        check(ok, f"masked_mha tile route disagrees with its plain version: {vit_cases[-1]}")
    for si, shape in enumerate(KIMIVL_SPLIT_CHECKS):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pad = _joint_inputs(shape, dtype, 110 + si)
            scale = 1.0 / math.sqrt(shape[3])
            got = masked_mha(q, k, v, pad, True, scale=scale)
            ref = mha_reference(q, k, v, pad, True, scale)
            torch.cuda.synchronize()
            tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": True}
            check(bool(torch.isfinite(got.float()).all()), f"non-finite split output at {tag}")
            err, ok = _compare(got, ref, dtype)
            split_cases.append({**tag, "max_abs_err": err, "ok": ok})
            check(ok, f"masked_mha split route disagrees with its plain version: {split_cases[-1]}")

    gen = torch.Generator(device="cuda").manual_seed(120)
    x = torch.randn((KIMIVL_TOKENS, DSV2_D), generator=gen, device="cuda").to(torch.bfloat16)
    weight = (torch.randn((DSV2_E, DSV2_D), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    bias = torch.randn(DSV2_E, generator=gen, device="cuda") * KIMIVL_BIAS_STD
    w, idx = moe.route_sigmoid(x, weight, bias, DSV2_K, 2.446)
    s = torch.sigmoid(x.double() @ weight.double().T)
    want_idx = torch.topk(s + bias.double(), DSV2_K, dim=-1).indices
    same = (idx.sort(dim=-1).values == want_idx.sort(dim=-1).values).all(dim=-1)
    sel = s.gather(-1, idx)
    want_w = sel / (sel.sum(dim=-1, keepdim=True) + 1e-20) * 2.446
    w_err = float((w.double() - want_w).abs().max())
    router = {"tokens": KIMIVL_TOKENS, "sets_equal_share": float(same.double().mean()),
              "weights_max_abs_err": w_err,
              "ms": cuda_ms(lambda: moe.route_sigmoid(x, weight, bias, DSV2_K, 2.446), 20)}
    check(router["sets_equal_share"] > 0.99 and w_err < 1e-5,
          f"route_sigmoid disagrees with its float64 plain version: {router}")

    timing = {}
    q, k, v, pad = attention_inputs(KIMIVL_VIT_SHAPE, torch.bfloat16, 130)
    pad.zero_()
    bound_ms, bound_by = attention_bound(KIMIVL_VIT_SHAPE, torch.bfloat16)
    timing["masked_mha_fwd_vit"] = {
        "shape": list(KIMIVL_VIT_SHAPE), "route": "tile (long_tile<2, 256>)",
        "ms": cuda_ms(lambda: masked_mha(q, k, v, pad), 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "plain_ms": cuda_ms(lambda: mha_reference(q, k, v, pad), 2, warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
    }
    b, h, l, dqk, dv = KIMIVL_MLA_SHAPE
    q, k, v, pad = _joint_inputs(KIMIVL_MLA_SHAPE, torch.bfloat16, 131)
    scale = dqk ** -0.5
    nbytes = b * h * l * (2 * dqk + 2 * dv) * 2 + b * l
    ops = 2 * b * h * l * l * (dqk + dv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[torch.bfloat16] * 1e3
    keep = (~pad)[:, None, None, :] & torch.ones(l, l, dtype=torch.bool, device="cuda").tril()
    timing["masked_mha_fwd_split"] = {
        "shape": list(KIMIVL_MLA_SHAPE),
        "ms": cuda_ms(lambda: masked_mha(q, k, v, pad, True, scale=scale), 20),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "plain_ms": cuda_ms(lambda: mha_reference(q, k, v, pad, True, scale), 2, warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=scale), 20),
    }
    emit({"phase": "kimivl", "masked_mha_fwd_tile": vit_cases, "masked_mha_fwd_split": split_cases,
          "route_sigmoid": router, "timing": timing, "nvidia_smi": nvidia_smi_line()})


# -------------------------------------------------------------- resnet --
# ResNet-18 on its NHWC route (models/towers/resnet.py, csrc/resnet_nhwc.cu)
# at an original-CP microbatch: 5,600 images of 224 x 224. The kernels
# against their plain versions (bit for bit; the bfloat16 stem within
# stem_bound) at RESNET_CHECK_B images and odd sizes, then at the
# microbatch's shapes (the stem's input, its 112 x 112 x 64 map and stage
# 1's 56 x 56 x 64) over the whole microbatch, the plain versions
# RESNET_F32_CHUNK images at a time, and timed there; the tower on the route and on the
# NCHW eager math it replaced, each against the float32 tower (NCHW, TF32
# off, in chunks), on random images under BatchNorm statistics calibrated
# on the first 64 of them.
RESNET_B, RESNET_CHECK_B, RESNET_F32_CHUNK = 5600, 64, 700
RESNET_PLAIN_B = 1400  # the plain stem pass in float32 temporaries: a quarter
RESNET_ERR_RATIO_MAX = 1.5
RESNET_TURNS = 5


def _resnet_nchw_features(model, x, calibrate: bool = False):
    """ResNet-18's pooled features on the NCHW eager math that the NHWC
    route replaced: each BatchNorm a multiply-add after its convolution,
    its scale and bias rounded to x's dtype; in float32 the float32 tower.
    ``calibrate`` first sets each BatchNorm's statistics to its input's
    over ``x``."""
    def bn(m, y):
        if calibrate:
            m.running_mean.copy_(y.float().mean(dim=(0, 2, 3)))
            m.running_var.copy_(y.float().var(dim=(0, 2, 3), unbiased=False))
        scale = (m.weight * torch.rsqrt(m.running_var + m.eps)).to(y.dtype)
        bias = (m.bias - m.running_mean * scale).to(y.dtype)
        return y * scale[None, :, None, None] + bias[None, :, None, None]

    def conv(c, y):
        return F.conv2d(y, c.weight.to(y.dtype), stride=c.stride, padding=c.padding)

    x = F.max_pool2d(F.relu(bn(model.bn1, conv(model.conv1, x))), 3, 2, padding=1)
    for stage in model.stages():
        for blk in stage:
            y = bn(blk.bn2, conv(blk.conv2, F.relu(bn(blk.bn1, conv(blk.conv1, x)))))
            if blk.downsample is not None:
                x = bn(blk.downsample[1], conv(blk.downsample[0], x))
            x = F.relu(x + y)
    return x.mean(dim=(2, 3))


def stem_bound(x, w, want):
    """What the bfloat16 stem may differ by from its plain version ``want``
    (cuDNN's convolution, rounded, then the stem's pool) at each output:
    2^-7 (max(1, |want|) + |m|), m the plain version's pooled convolution
    before the bias. Only the convolution's float32 sum order differs; it
    can move a sum across a bfloat16 rounding point, one unit in the last
    place of the pooled value (at most 2^-7 |m|), and the epilogue's own
    rounding adds one of the output (2^-7 max(1, |want|)). Everything after
    the convolution's rounding is exact."""
    m = F.max_pool2d(F.conv2d(x, w, stride=2, padding=3), 3, 2, padding=1).float()
    return 2.0 ** -7 * (want.float().abs().clamp(min=1) + m.abs())


def _stem_operands(x_uint8, b, gen):
    """The stem's operands: the normaliser's bfloat16 NHWC images, a
    He-normal weight and a bias."""
    from outfitx_tpu_torch.core.config import ENCODER_PAIRS
    from outfitx_tpu_torch.ops import resnet_nhwc as rn

    row = ENCODER_PAIRS["resnet_sbert"]
    mean, std = (torch.tensor(v, dtype=torch.float32, device="cuda")
                 for v in (row.mean, row.std))
    x = rn.normalize(x_uint8[:b], mean, std, torch.bfloat16)
    w = (torch.randn((64, 3, 7, 7), generator=gen, device="cuda") * math.sqrt(2 / 147)).to(
        torch.bfloat16)
    return x, w, 0.5 * torch.randn(64, generator=gen, device="cuda")


def _stem_checks(images, gen):
    """The stem against its plain version and against the route it replaced
    (cuDNN's convolution then ``stem_pool``): bfloat16 within stem_bound,
    float32 (cuDNN's convolution, then ``stem_pool``) bit for bit; at the
    tower's widths and at odd heights and narrow widths; one launch a
    bfloat16 call, none a float32 one."""
    from outfitx_tpu_torch.ops import resnet_nhwc as rn

    cases = []
    odd = torch.randint(0, 256, (3, 3, 37, 40), generator=gen, device="cuda", dtype=torch.uint8)
    tall = torch.randint(0, 256, (2, 3, 45, 8), generator=gen, device="cuda", dtype=torch.uint8)
    wide = torch.randint(0, 256, (2, 3, 23, 120), generator=gen, device="cuda", dtype=torch.uint8)
    for imgs in (images[:RESNET_CHECK_B], odd, tall, wide):
        x, w, bias = _stem_operands(imgs, imgs.shape[0], gen)
        for dtype in (torch.bfloat16, torch.float32):
            xd, wd = x.to(dtype, memory_format=torch.channels_last), w.to(dtype)
            before = rn.stem_conv_pool.launches
            got = rn.stem_conv_pool(xd, wd, bias)
            launched = rn.stem_conv_pool.launches - before
            want = rn.stem_conv_pool_reference(xd, wd, bias)
            today = rn.stem_pool(F.conv2d(xd, wd, stride=2, padding=3), bias)
            diff = (got.float() - want.float()).abs()
            over = int((diff > stem_bound(xd, wd, want)).sum()) if dtype == torch.bfloat16 \
                else int((got != want).sum())
            cases.append({
                "kernel": "stem_conv_pool", "dtype": _dtype_name(dtype), "shape": list(x.shape),
                "launches": launched, "max_abs_err": float(diff.max()),
                "unequal": int((got != want).sum()), "over_bound": over,
                "over_bound_today": int((diff > stem_bound(xd, wd, today)).sum()),
                # past the output's own rounding alone, 2^-7 max(1, |want|)
                "over_output_rounding": int(
                    (diff > 2.0 ** -7 * want.float().abs().clamp(min=1)).sum()),
            })
            check(over == 0 and cases[-1]["over_bound_today"] == 0
                  and launched == (dtype == torch.bfloat16),
                  f"the stem disagrees with its plain version: {cases[-1]}")
    torch.cuda.synchronize()
    return cases


def _resnet_kernel_checks(images):
    """Each kernel against its plain version, bit for bit, float32 and
    bfloat16: the normaliser against the float32 normaliser then a cast
    (what the tower took before), the epilogue with and without a
    residual and the stem's pool at the tower's widths and at odd sizes;
    the stem (``_stem_checks``)."""
    from outfitx_tpu_torch.core.config import ENCODER_PAIRS
    from outfitx_tpu_torch.data.preprocess import make_normalizer
    from outfitx_tpu_torch.ops import resnet_nhwc as rn

    row = ENCODER_PAIRS["resnet_sbert"]
    mean, std = (torch.tensor(v, dtype=torch.float32, device="cuda")
                 for v in (row.mean, row.std))
    b = RESNET_CHECK_B
    gen = torch.Generator(device="cuda").manual_seed(22)
    cases = []

    def case(kernel, dtype, shape, got, want):
        cases.append({"kernel": kernel, "dtype": _dtype_name(dtype), "shape": list(shape),
                      "unequal": int((got != want).sum())})
        check(torch.equal(got, want), f"resnet_nhwc disagrees with its plain version: {cases[-1]}")

    odd = torch.randint(0, 256, (3, 3, 37, 41), generator=gen, device="cuda", dtype=torch.uint8)
    for dtype in (torch.float32, torch.bfloat16):
        for x in (images[:b], odd):
            got = rn.normalize(x, mean, std, dtype)
            check(got.is_contiguous(memory_format=torch.channels_last), "normalize is not NHWC")
            case("normalize", dtype, x.shape, got,
                 make_normalizer("resnet_sbert")(x).to(dtype))
        for shape in ((b, 64, 112, 112), (b, 64, 56, 56), (b, 128, 28, 28), (b, 256, 14, 14),
                      (b, 512, 7, 7), (3, 64, 37, 41), (2, 64, 1, 2)):
            y, res = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                      .contiguous(memory_format=torch.channels_last) for _ in range(2))
            bias = torch.randn(shape[1], generator=gen, device="cuda")
            case("bias_add_relu", dtype, shape, rn.bias_add_relu(y.clone(), bias, res),
                 rn.bias_add_relu_reference(y, bias, res))
            case("bias_relu", dtype, shape, rn.bias_add_relu(y.clone(), bias),
                 rn.bias_add_relu_reference(y, bias))
            if shape[1] == 64:
                case("stem_pool", dtype, shape, rn.stem_pool(y, bias),
                     rn.stem_pool_reference(y, bias))
    torch.cuda.synchronize()
    return cases + _stem_checks(images, gen)


def _against_plain(kernel, got, plain, checks, bound=None):
    """The kernel's output over the whole microbatch against ``plain(s)``,
    its plain version over the images of slice ``s``, RESNET_F32_CHUNK
    images at a time: the largest absolute difference and the unequal
    elements, appended to ``checks``; equal bit for bit or it fails, or,
    given ``bound(s, want)`` (the largest difference allowed at each
    element), within it."""
    err, unequal, over = 0.0, 0, 0
    for i in range(0, got.shape[0], RESNET_F32_CHUNK):
        s = slice(i, i + RESNET_F32_CHUNK)
        want = plain(s)
        diff = (got[s].float() - want.float()).abs()
        err = max(err, float(diff.max()))
        unequal += int((got[s] != want).sum())
        over += int((diff > bound(s, want)).sum()) if bound else int((got[s] != want).sum())
        del want, diff
    checks.append({"kernel": kernel, "shape": list(got.shape), "elements": got.numel(),
                   "max_abs_err": err, "unequal": unequal, "over_bound": over})
    check(over == 0, f"resnet_nhwc disagrees with its plain version: {checks[-1]}")


def _resnet_kernel_timing(images):
    """The kernels at the microbatch's shapes (bfloat16). Each first against
    its plain version over the whole microbatch, chunked (the stem's
    tensors hold 4.5e9 elements, past 32-bit offsets); then ms (CUDA
    events), the bytes bound (each byte read once and written once), the
    plain version and, for the pool, PyTorch's max-pool alone over the same
    NHWC tensor (which also writes int64 indices). Returns the timings and
    the full-size checks."""
    from outfitx_tpu_torch.core.config import ENCODER_PAIRS
    from outfitx_tpu_torch.ops import resnet_nhwc as rn

    dt, cl, n = torch.bfloat16, torch.channels_last, RESNET_B
    gen = torch.Generator(device="cuda").manual_seed(23)
    row = ENCODER_PAIRS["resnet_sbert"]
    mean, std = (torch.tensor(v, dtype=torch.float32, device="cuda")
                 for v in (row.mean, row.std))
    checks = []

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    def activation(shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dt).contiguous(
            memory_format=cl)

    _against_plain("normalize", rn.normalize(images, mean, std, dt),
                   lambda s: rn.normalize_reference(images[s], mean, std, dt), checks)
    out = {"normalize": {
        "shape": list(images.shape),
        "ms": cuda_ms(lambda: rn.normalize(images, mean, std, dt), 10),
        "bound_ms": bound(images.numel() * 3), "bound_by": "bytes",
        "plain_ms": cuda_ms(lambda: rn.normalize_reference(images, mean, std, dt), 3, warmup=1),
    }}
    # The stem: its operations (K = 147, as the convolution needs them)
    # against its bytes (the input read once, the pooled output written once).
    x, w, bias = _stem_operands(images, n, gen)
    got = rn.stem_conv_pool(x, w, bias)
    _against_plain("stem_conv_pool", got, lambda s: rn.stem_conv_pool_reference(x[s], w, bias),
                   checks, bound=lambda s, want: stem_bound(x[s], w, want))
    oh, ph = 112, 56
    flops = 2 * n * oh * oh * 64 * 147
    nbytes = (x.numel() + got.numel()) * 2
    del got
    torch.cuda.empty_cache()
    part = x[:RESNET_PLAIN_B]
    out["stem_conv_pool"] = {
        "shape": list(x.shape), "out_shape": [n, 64, ph, ph],
        "ms": cuda_ms(lambda: rn.stem_conv_pool(x, w, bias), 10),
        "bound_ms": max(flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / PEAK_FLOPS[dt] > nbytes / HBM_BYTES_PER_S
        else "bytes",
        "flops_bound_ms": flops / PEAK_FLOPS[dt] * 1e3, "bytes_bound_ms": bound(nbytes),
        "plain_ms": cuda_ms(lambda: rn.stem_conv_pool_reference(part, w, bias), 3, warmup=1),
        "plain_images": RESNET_PLAIN_B,
        "library_ms": cuda_ms(
            lambda: rn.stem_pool(F.conv2d(x, w, stride=2, padding=3), bias), 5, warmup=2),
        "library": "cuDNN's F.conv2d, then stem_pool",
    }
    out["stem_conv_pool"]["bound_share"] = (out["stem_conv_pool"]["bound_ms"]
                                            / out["stem_conv_pool"]["ms"])
    del x, part
    torch.cuda.empty_cache()
    y, res = activation((n, 64, 112, 112)), activation((n, 64, 112, 112))
    bias = torch.randn(64, generator=gen, device="cuda")
    _against_plain("stem_pool", rn.stem_pool(y, bias),
                   lambda s: rn.stem_pool_reference(y[s], bias), checks)
    got = rn.bias_add_relu(y.clone(), bias)
    _against_plain("bias_relu", got, lambda s: rn.bias_add_relu_reference(y[s], bias), checks)
    rn.bias_add_relu(got.copy_(y), bias, res)
    _against_plain("bias_add_relu", got,
                   lambda s: rn.bias_add_relu_reference(y[s], bias, res[s]), checks)
    del got, res
    torch.cuda.empty_cache()
    part = y[:RESNET_PLAIN_B]
    out["stem_pool"] = {
        "shape": list(y.shape), "ms": cuda_ms(lambda: rn.stem_pool(y, bias), 10),
        "bound_ms": bound(y.numel() * 2 * 1.25), "bound_by": "bytes",
        "plain_ms": cuda_ms(lambda: rn.stem_pool_reference(part, bias), 3, warmup=1),
        "plain_images": RESNET_PLAIN_B,
        "library_ms": cuda_ms(lambda: F.max_pool2d(y, 3, 2, padding=1), 10),
    }
    out["bias_add_relu_stem"] = {
        "shape": list(y.shape), "residual": False,
        "ms": cuda_ms(lambda: rn.bias_add_relu(y, bias), 10),
        "bound_ms": bound(y.numel() * 2 * 2), "bound_by": "bytes",
        "plain_ms": cuda_ms(lambda: rn.bias_add_relu_reference(part, bias), 3, warmup=1),
        "plain_images": RESNET_PLAIN_B,
    }
    del y, part
    torch.cuda.empty_cache()
    y, res = activation((n, 64, 56, 56)), activation((n, 64, 56, 56))
    for r in (res, None):
        _against_plain("bias_add_relu" if r is not None else "bias_relu",
                       rn.bias_add_relu(y.clone(), bias, r),
                       lambda s: rn.bias_add_relu_reference(
                           y[s], bias, r[s] if r is not None else None), checks)
    for name, r in (("bias_add_relu_stage1", res), ("bias_relu_stage1", None)):
        out[name] = {
            "shape": list(y.shape), "residual": r is not None,
            "ms": cuda_ms(lambda: rn.bias_add_relu(y, bias, r), 10),
            "bound_ms": bound(y.numel() * 2 * (3 if r is not None else 2)), "bound_by": "bytes",
            "plain_ms": cuda_ms(lambda: rn.bias_add_relu_reference(y, bias, r), 3, warmup=1),
        }
    del y, res
    torch.cuda.empty_cache()
    return out, checks


def _row_errors(got, ref):
    """Each item's ||got - ref|| / ||ref|| over its pooled features."""
    return ((got.float() - ref).norm(dim=1) / ref.norm(dim=1)).cpu()


def phase_resnet():
    """The NHWC route's kernels against their plain versions and timed; the
    tower at an original-CP microbatch on the route and on the NCHW math it
    replaced: each one's error against the float32 tower (the route's
    worst item within RESNET_ERR_RATIO_MAX of the other's), their forward
    ms (medians of RESNET_TURNS), peak memory and the route's launches."""
    from outfitx_tpu_torch.data.preprocess import make_normalizer
    from outfitx_tpu_torch.models.item_encoder import resnet_normalizer
    from outfitx_tpu_torch.models.towers.resnet import ResNet18, ResNet18Config
    from outfitx_tpu_torch.ops import resnet_nhwc as rn

    gen = torch.Generator(device="cuda").manual_seed(21)
    images = torch.randint(0, 256, (RESNET_B, 3, 224, 224), generator=gen, device="cuda",
                           dtype=torch.uint8)
    cases = _resnet_kernel_checks(images)
    timing, full_size = _resnet_kernel_timing(images)

    model = ResNet18(ResNet18Config())
    model.init_weights_(torch.Generator().manual_seed(21))
    model = model.to("cuda").eval()
    to_f32 = make_normalizer("resnet_sbert")
    to_route = resnet_normalizer("resnet_sbert", torch.bfloat16)
    with torch.no_grad():
        _resnet_nchw_features(model, to_f32(images[:64]), calibrate=True)
        ref = torch.cat([_resnet_nchw_features(model, to_f32(images[i:i + RESNET_F32_CHUNK]))
                         for i in range(0, RESNET_B, RESNET_F32_CHUNK)])

        def route():
            return model.features(to_route(images))

        def nchw():
            return _resnet_nchw_features(model, to_f32(images).to(torch.bfloat16))

        def kernel_counts():
            return (rn.normalize.launches, rn.stem_conv_pool.launches, rn.stem_pool.launches,
                    rn.bias_add_relu.launches)

        counts = kernel_counts()
        feats = route()
        torch.cuda.synchronize()
        launches = [a - b for a, b in zip(kernel_counts(), counts)]
        check(launches == [1, 1, 0, 16],
              f"the NHWC route launched {launches} (normalize, stem_conv_pool, stem_pool, "
              "bias_add_relu), not [1, 1, 0, 16]")
        err_route = _row_errors(feats, ref)
        del feats
        err_nchw = _row_errors(nchw(), ref)
        torch.cuda.empty_cache()
        peaks = {}
        for name, fn in (("route", route), ("nchw", nchw)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated()
        ms = {name: _median_ms(fn, 1, RESNET_TURNS) for name, fn in (("route", route),
                                                                     ("nchw", nchw))}
        profile = {name: profile_call(fn, top=8) for name, fn in (("route", route),
                                                                  ("nchw", nchw))}
    ratio = float(err_route.max() / err_nchw.max())
    emit({
        "phase": "resnet", "images": list(images.shape), "kernel_checks": cases,
        "full_size_checks": full_size, "kernels": timing,
        "tower": {
            "rel_err_vs_float32_worst": {"route": float(err_route.max()),
                                         "nchw": float(err_nchw.max())},
            "rel_err_vs_float32_median": {"route": float(err_route.median()),
                                          "nchw": float(err_nchw.median())},
            "worst_ratio": ratio, "worst_ratio_max": RESNET_ERR_RATIO_MAX,
            "forward_ms_median": {k: v[0] for k, v in ms.items()},
            "forward_ms_turns": {k: v[1] for k, v in ms.items()},
            "peak_memory_bytes": peaks, "launches_a_forward": launches,
            "profile": profile,
        },
        "nvidia_smi": nvidia_smi_line(),
    })
    check(ratio <= RESNET_ERR_RATIO_MAX,
          f"the NHWC route's worst error is {ratio:.3f}x the NCHW route's")
    del images, ref
    torch.cuda.empty_cache()
    return timing, max(c["max_abs_err"] for c in full_size)


def phase_build():
    from outfitx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build(KERNELS)
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "per_kernel_seconds": {n: r["seconds"] for n, r in report.items()},
        "ptxas": {name: _ptxas_by_function(r["ptxas"]) for name, r in report.items()},
        "dynamic_smem_bytes": _dynamic_smem(),
    })


def _compare(got, ref, dtype, f32_tol=F32_TOL):
    """(max |got - ref|, within the dtype's limit) for one output."""
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= f32_tol).all())
    else:
        ok = bool((err <= BF16_REL * torch.clamp_min(ref.float().abs(), 1.0)).all())
    return float(err.max()), ok


def _cases(shapes):
    for si, shape in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                yield si, shape, dtype, causal


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def _mha_fwd_checks(shapes):
    """masked_mha_fwd against its plain version on the card at each (shape,
    causal, tail-padded keys), float32 and bfloat16."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

    mha_cases = []
    for si, (shape, causal, tail) in enumerate(shapes):
        inputs = tail_padded_attention_inputs if tail else attention_inputs
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pad = inputs(shape, dtype, seed=20 + si)
            got = _masked_mha_cuda(q, k, v, pad, causal)
            ref = mha_reference(q, k, v, pad, causal)
            torch.cuda.synchronize()
            tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": causal}
            if tail:
                tag["tail_padded_keys"] = True
            check(bool(torch.isfinite(got.float()).all()),
                  f"non-finite masked_mha_fwd output at {tag}")
            err, ok = _compare(got, ref, dtype)
            case = {**tag, "max_abs_err": err, "ok": ok}
            mha_cases.append(case)
            check(ok, f"masked_mha_fwd disagrees with its plain version: {case}")
    return mha_cases


NARROW_FWD_CASES = [
    (shape, causal, tail) for shape, tail in NARROW_SHAPES for causal in (False, True)
]


def _tower_kernel_checks():
    """The forward attention at tower lengths, the tilings' and the narrow
    route's shapes, attn_block and mlp_fused, each against its plain version
    on the card, float32 and bfloat16."""
    from outfitx_tpu_torch.ops.attn_block import _attn_block_cuda, attn_block_reference
    from outfitx_tpu_torch.ops.mlp import _mlp_fused_cuda, mlp_fused_reference

    block_cases, mlp_cases = [], []
    shapes = [(shape, causal, False) for shape, causal in TOWER_MHA_SHAPES + FWD_TILE_SHAPES]
    mha_cases = _mha_fwd_checks(
        shapes + SLICE8_MHA_SHAPES + OCP_MHA_SHAPES + NARROW_FWD_CASES
    )
    for si, shape in enumerate(ATTN_BLOCK_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            y, wqkv, bqkv, wo, pad, h, causal = attn_block_inputs(shape, dtype, 30 + si)
            scale = 1.0 / math.sqrt(shape[2] // h)
            got = _attn_block_cuda(y, wqkv, bqkv, wo, pad, h, scale, causal)
            ref = attn_block_reference(y, wqkv, bqkv, wo, pad, h, causal=causal)
            torch.cuda.synchronize()
            tag = {"shape": list(shape[:4]), "dtype": _dtype_name(dtype), "causal": causal}
            check(got.dtype == torch.float32, f"attn_block output is {got.dtype}")
            check(bool(torch.isfinite(got).all()), f"non-finite attn_block output at {tag}")
            err, ok = _compare(got, ref, dtype, F32_SUM_TOL)
            case = {**tag, "max_abs_err": err, "ok": ok}
            block_cases.append(case)
            check(ok, f"attn_block disagrees with its plain version: {case}")
            del y, wqkv, bqkv, wo, got, ref
    for si, shape in enumerate(MLP_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, w1, b1, w2, b2, act = mlp_inputs(shape, dtype, 40 + si)
            got = _mlp_fused_cuda(x, w1, b1, w2, b2, act)
            ref = mlp_fused_reference(x, w1, b1, w2, b2, act=act)
            torch.cuda.synchronize()
            tag = {"shape": list(shape[:3]), "act": act, "dtype": _dtype_name(dtype)}
            check(got.dtype == dtype, f"mlp_fused output is {got.dtype}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"non-finite mlp_fused output at {tag}")
            err, ok = _compare(got, ref, dtype, F32_SUM_TOL)
            case = {**tag, "max_abs_err": err, "ok": ok}
            mlp_cases.append(case)
            check(ok, f"mlp_fused disagrees with its plain version: {case}")
            del x, got, ref
    torch.cuda.empty_cache()
    return mha_cases, block_cases, mlp_cases


def _layernorm_checks():
    """layernorm against its plain version on the card, float32 and
    bfloat16; constant and 1e4 rows; the closed-form backward against
    autograd through the plain version."""
    from outfitx_tpu_torch.ops.layernorm import (
        LayerNormFn,
        _layer_norm_cuda,
        layer_norm_bwd_reference,
        layer_norm_reference,
    )

    cases = []
    for si, (shape, eps) in enumerate(LAYERNORM_SHAPES + OCP_LAYERNORM_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = layernorm_inputs(shape, dtype, seed=50 + si)
            got = _layer_norm_cuda(x, weight, bias, eps)
            ref = layer_norm_reference(x, weight, bias, eps)
            torch.cuda.synchronize()
            tag = {"shape": list(shape), "eps": eps, "dtype": _dtype_name(dtype)}
            check(got.dtype == dtype and got.shape == x.shape,
                  f"layernorm output {got.dtype} {tuple(got.shape)} at {tag}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"non-finite layernorm output at {tag}")
            err, ok = _compare(got, ref, dtype)
            case = {**tag, "max_abs_err": err, "ok": ok}
            cases.append(case)
            check(ok, f"layernorm disagrees with its plain version: {case}")
            del x, got, ref
    torch.cuda.empty_cache()

    # Rows of one value (variance 0) give exactly the bias; a row around the
    # catalog's spare-row sentinel, 1e4, stays finite in bfloat16.
    special = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1536, 100):
            x, weight, bias = layernorm_inputs((8, d), dtype, seed=60)
            x[0], x[1], x[2], x[3] = 0.5, 1.0e4, 0.0, -2.5
            x[4] = (1.0e4 + torch.randn(d, device="cuda")).to(dtype)
            got = _layer_norm_cuda(x, weight, bias, 1e-5)
            torch.cuda.synchronize()
            exact = all(torch.equal(got[r], bias.to(dtype)) for r in range(4))
            finite = bool(torch.isfinite(got.float()).all())
            special.append({"dtype": _dtype_name(dtype), "d": d,
                            "constant_rows_equal_bias": exact, "finite": finite})
            check(exact, f"layernorm of a constant row is not the bias: {special[-1]}")
            check(finite, f"layernorm of a 1e4 row is not finite: {special[-1]}")

    # The closed form against autograd through the plain version, and the
    # autograd.Function end to end (kernel forward, closed-form backward).
    bwd = []
    for shape, dtype, eps in (
        ((64, 17, 1536), torch.float32, 1e-5), ((64, 17, 1536), torch.bfloat16, 1e-6),
        ((5950, 128), torch.float32, 1e-5), ((5950, 128), torch.bfloat16, 1e-5),
    ):
        x, weight, bias = layernorm_inputs(shape, dtype, seed=70)
        g = torch.randn(x.shape, device="cuda").to(dtype)
        xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
        want = torch.autograd.grad(layer_norm_reference(xr, wr, br, eps), (xr, wr, br), g)
        closed = layer_norm_bwd_reference(x, weight, bias, g, eps)
        xf, wf, bf = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
        through = torch.autograd.grad(LayerNormFn.apply(xf, wf, bf, eps), (xf, wf, bf), g)
        torch.cuda.synchronize()
        case = {"shape": list(x.shape), "eps": eps, "dtype": _dtype_name(dtype)}
        for name, a, f, r in zip(("dx", "dweight", "dbias"), closed, through, want):
            # dweight and dbias are float32 sums over 1,088 (5,950) rows in
            # another order than autograd's: relative 1e-4 of the largest
            # entry.
            tol = 1e-4 * float(r.float().abs().max()) if name != "dx" else None
            for label, t in (("closed", a), ("function", f)):
                err = float((t.float() - r.float()).abs().max())
                ok = err <= tol if tol is not None else _compare(t, r, dtype, 1e-4)[1]
                case[f"{name}_{label}_max_abs_err"] = err
                check(ok, f"layernorm backward {name} ({label}) off by {err}: {case}")
        bwd.append(case)
    return cases, special, bwd


def _stream_check():
    """The stream handle the wrappers hand their kernels is PyTorch's
    current stream, on the default stream and inside ``torch.cuda.stream``;
    a launch there agrees with the plain version."""
    from outfitx_tpu_torch.ops import _launch
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

    dev = torch.cuda.current_device()
    default_ok = _launch.current_stream(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream()
    q, k, v, pad = attention_inputs((8, 16, 17, 96), torch.bfloat16, seed=90)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        side_ok = _launch.current_stream(dev) == side.cuda_stream
        got = _masked_mha_cuda(q, k, v, pad, False)
    torch.cuda.current_stream().wait_stream(side)
    err, ok = _compare(got, mha_reference(q, k, v, pad), torch.bfloat16)
    torch.cuda.synchronize()
    out = {"default_stream": default_ok, "side_stream": side_ok,
           "side_stream_max_abs_err": err}
    check(default_ok and side_ok and ok, f"kernel launch stream: {out}")
    return out


def _bwd_kernel_checks():
    """masked_mha_bwd against its plain version on the card at BWD_SHAPES,
    BWD_TILE_SHAPES, OCP_BWD_SHAPES and the narrow route's shapes, float32
    and bfloat16, causal and not: dq,
    dk and dv finite and within the dtype's limit, masked keys' dk and dv
    exactly 0."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_bwd_cuda, mha_bwd_reference

    shapes = BWD_SHAPES + BWD_TILE_SHAPES + OCP_BWD_SHAPES
    cases = []
    for si, (shape, tail), dtype, causal in _cases(
        [(shape, False) for shape in shapes] + NARROW_SHAPES + [(NARROW_BWD_FULL, False)]
    ):
        inputs = tail_padded_attention_inputs if tail else attention_inputs
        q, k, v, pad = inputs(shape, dtype, seed=si)
        tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": causal}
        if tail:
            tag["tail_padded_keys"] = True
        gen = torch.Generator(device="cuda").manual_seed(100 + si)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        got = _masked_mha_bwd_cuda(q, k, v, pad, g, causal)
        ref = mha_bwd_reference(q, k, v, pad, g, causal)
        torch.cuda.synchronize()
        case = dict(tag)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            check(bool(torch.isfinite(a.float()).all()),
                  f"non-finite masked_mha_bwd {name} at {tag}")
            case[f"{name}_max_abs_err"], case[f"{name}_ok"] = _compare(a, r, dtype)
        # A masked key of a row that keeps any key has P == 0 exactly, so
        # its dk and dv must be exactly 0 (a fully masked row is uniform).
        masked = (pad & ~pad[:, :1])[:, None, :, None].expand(shape)
        case["masked_keys_zero"] = all(bool((t[masked] == 0).all()) for t in got[1:])
        case["max_abs_err"] = max(case[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv"))
        cases.append(case)
        check(all(case[f"{n}_ok"] for n in ("dq", "dk", "dv")),
              f"masked_mha_bwd disagrees with its plain version: {case}")
        check(case["masked_keys_zero"], f"masked_mha_bwd: masked keys not zero: {case}")
        del q, k, v, g, got, ref
    torch.cuda.empty_cache()
    return cases


def _narrow_p_check():
    """The narrow forward's P against the plain version's, bit for bit, at
    NARROW_P_SHAPES, causal and not: with V one-hot on keys j0 .. j0 + 7
    (every other key's row 0) the output's column c is P[:, j0 + c] rounded
    to bfloat16, exactly. This holds the in-thread 64-slot tree, expf and
    the division against torch.softmax on the card, apart from the walk's
    other steps; a check of the outputs that fails where this one passes
    points at the walk."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, _probs

    cases = []
    for si, shape in enumerate(NARROW_P_SHAPES):
        b, h, l, dh = shape
        for causal in (False, True):
            q, k, _, pad = attention_inputs(shape, torch.bfloat16, seed=110 + si)
            want = _probs(q, k, pad, causal).to(torch.bfloat16)
            got = torch.empty_like(want)
            for j0 in range(0, l, dh):
                n = min(dh, l - j0)
                v = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
                v[:, :, j0:j0 + n, :n] = torch.eye(n, dtype=torch.bfloat16, device="cuda")
                got[..., j0:j0 + n] = _masked_mha_cuda(q, k, v, pad, causal)[..., :n]
            torch.cuda.synchronize()
            flips = int((got != want).sum())
            case = {"shape": list(shape), "causal": causal, "p_entries": want.numel(),
                    "p_entries_differing": flips}
            cases.append(case)
            check(flips == 0, f"narrow forward's P differs from the plain version's: {case}")
    return cases


def _narrow_div_check():
    """The narrow route's division (csrc/narrow_mha.cuh div_fast: the fast
    path of the compiler's IEEE division with the reciprocal shared by a
    row, and no range check) against that division on the card: every float
    sum in [1, 32), each against 17 numerators in [2^-64, 1]."""
    import ctypes

    from outfitx_tpu_torch.ops import _build

    fn = _build.load("masked_mha_fwd").masked_mha_fwd_div_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    bad = torch.zeros(1, dtype=torch.int32, device="cuda")
    err = fn(bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    out = {"sums": 0x42000000 - 0x3F800000, "numerators_each": 17,
           "mismatches": int(bad.item())}
    check(err == 0 and out["mismatches"] == 0,
          f"the narrow route's division differs from IEEE division: {out}")
    return out


def phase_kernels():
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

    narrow_div = _narrow_div_check()
    narrow_p = _narrow_p_check()  # the tree order next
    fwd_cases = []
    for si, shape, dtype, causal in _cases(KERNEL_SHAPES):
        q, k, v, pad = attention_inputs(shape, dtype, seed=si)
        tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": causal}
        got = _masked_mha_cuda(q, k, v, pad, causal)
        ref = mha_reference(q, k, v, pad, causal)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              f"non-finite masked_mha_fwd output at {tag}")
        err, ok = _compare(got, ref, dtype)
        case = {**tag, "max_abs_err": err, "ok": ok}
        fwd_cases.append(case)
        check(ok, f"masked_mha_fwd disagrees with its plain version: {case}")
    bwd_cases = _bwd_kernel_checks()
    tower_mha, block_cases, mlp_cases = _tower_kernel_checks()
    fwd_cases += tower_mha
    ln_cases, ln_special, ln_bwd = _layernorm_checks()
    emit({
        "phase": "kernels", "masked_mha_fwd": fwd_cases,
        "masked_mha_bwd": bwd_cases, "attn_block": block_cases,
        "mlp_fused": mlp_cases, "layernorm": ln_cases,
        "layernorm_special_rows": ln_special, "layernorm_backward": ln_bwd,
        "launch_stream": _stream_check(), "narrow_forward_p": narrow_p,
        "narrow_division": narrow_div,
    })

    def main_err(cases, shape):
        return next(
            c["max_abs_err"] for c in cases
            if c["shape"] == list(shape) and c["dtype"] == "bfloat16" and not c["causal"]
        )

    return {
        "masked_mha_fwd": main_err(fwd_cases, KERNEL_SHAPES[0]),
        "masked_mha_bwd": main_err(bwd_cases, (TRAIN_B, 16, 17, 96)),
        "attn_block": next(
            c["max_abs_err"] for c in block_cases
            if c["shape"] == list(ATTN_BLOCK_SHAPES[0][:4]) and c["dtype"] == "bfloat16"
        ),
        "mlp_fused": next(
            c["max_abs_err"] for c in mlp_cases
            if c["shape"] == list(MLP_SHAPES[0][:3]) and c["dtype"] == "bfloat16"
        ),
        "layernorm": next(
            c["max_abs_err"] for c in ln_cases
            if c["shape"] == list(LAYERNORM_SHAPES[0][0]) and c["dtype"] == "bfloat16"
        ),
    }


def _requests(catalog, rng):
    """Outfits, CIR (outfit, target) pairs and FITB questions drawn from the
    catalog with a numpy seed."""
    ids = catalog.item_ids

    def outfit():
        n = int(rng.integers(2, 9))
        return [int(i) for i in rng.choice(ids, n, replace=False)]

    def in_category(cid):
        rows = np.flatnonzero(catalog.category_id == cid)
        return int(ids[int(rng.choice(rows))])

    n_cat = int(catalog.category_id.max()) + 1
    cp = [outfit() for _ in range(4)]
    cp_batch = [outfit() for _ in range(12)]
    cir = [(outfit(), in_category(i % n_cat)) for i in range(16)]
    cir_batch = [(outfit(), in_category(i % n_cat)) for i in range(24)]
    fitb = [(outfit(), [in_category(i)] + [in_category(i) for _ in range(3)])
            for i in range(4)]
    sim = [int(i) for i in rng.choice(ids, 3, replace=False)]
    return cp, cp_batch, cir, cir_batch, fitb, sim


def _serve(engine, reqs):
    cp, cp_batch, cir, cir_batch, fitb, sim = reqs
    return {
        "cp": [engine.cp_score(o) for o in cp],
        "cp_batch": engine.cp_score_batch(cp_batch),
        "cir": [engine.cir_top10(o, t) for o, t in cir],
        "cir_batch": engine.cir_top10_batch(cir_batch),
        "fitb": [engine.fitb_pick(o, c) for o, c in fitb],
        "sim": [engine.similar_items(i) for i in sim],
    }


def _expected_forwards(engine, reqs):
    cp, cp_batch, cir, cir_batch, fitb, _ = reqs
    bucket = engine.cp_batch_bucket

    def chunks(n):
        return -(-n // bucket)

    pools = engine.pools.pools if engine.pools is not None else {}
    pooled = sum(
        int(engine.catalog.category_id[engine.lookup_row(t)]) in pools
        for _, t in cir_batch
    )
    return (
        len(cp) + chunks(len(cp_batch)) + len(cir)
        + chunks(pooled) + chunks(len(cir_batch) - pooled) + len(fitb)
    )


def _ln_per_forward(cfg) -> int:
    """LayerNorms of one set-transformer forward: two a layer (pre-LN), and
    the terminal one where the configuration has it."""
    t = cfg.transformer
    return 2 * t.n_layers + (1 if t.final_norm else 0)


def _block_route(cfg, reqs, cp_want):
    """An engine whose set transformer runs the fused attention block
    (``attn="block"``) at full width: its CP answers against the default
    engine's, and exactly one ``attn_block`` launch a layer a forward (and no
    ``masked_mha``)."""
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.attn_block import attn_block
    from outfitx_tpu_torch.serve.app import build_engine

    engine = build_engine(synthetic=True, model_cfg=cfg, device="cuda", attn="block")
    cp, cp_batch = reqs[0], reqs[1]
    torch.cuda.synchronize()
    attn_block.launches = masked_mha.launches = 0
    got = [engine.cp_score(o) for o in cp] + list(engine.cp_score_batch(cp_batch))
    torch.cuda.synchronize()
    launches, mha = attn_block.launches, masked_mha.launches
    forwards = len(cp) + -(-len(cp_batch) // engine.cp_batch_bucket)
    n_layers = cfg.transformer.n_layers
    check(launches == n_layers * forwards and mha == 0,
          f"attn route 'block': {launches} attn_block and {mha} masked_mha "
          f"launches for {forwards} forwards of {n_layers} layers")
    err = float(np.abs(np.asarray(got) - np.asarray(cp_want)).max())
    check(err <= CP_PROB_TOL, f"attn route 'block': CP probability off by {err}")
    return {"forwards": forwards, "attn_block_launches": launches,
            "cp_prob_max_abs_err_vs_mha_route": err}


def _int8_route(cfg, reqs, got):
    """An engine with ``quantize_model=True`` (the int8 W8A8 forward) at full
    width on the same synthetic catalog: its answers against the bfloat16
    engine's (``got``), and exactly 6 ``masked_mha_fwd`` and 12
    ``layernorm`` launches a forward."""
    from outfitx_tpu_torch.models.quantized import QuantizedOutfitX
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.serve.app import build_engine

    t0 = time.perf_counter()
    engine = build_engine(synthetic=True, model_cfg=cfg, device="cuda", quantize_model=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(isinstance(engine.cp_model, QuantizedOutfitX) and engine.cir_model is engine.cp_model,
          "the int8 engine does not serve one shared QuantizedOutfitX")
    engine.pools.pools.pop(0)  # the same routes as the bfloat16 engine
    torch.cuda.synchronize()
    masked_mha.launches = layer_norm.launches = 0
    q8 = _serve(engine, reqs)
    torch.cuda.synchronize()
    launches, ln_launches = masked_mha.launches, layer_norm.launches
    forwards = _expected_forwards(engine, reqs)
    n_layers = cfg.transformer.n_layers
    check(launches == n_layers * forwards and ln_launches == _ln_per_forward(cfg) * forwards,
          f"int8 route: {launches} masked_mha_fwd and {ln_launches} layernorm launches "
          f"for {forwards} forwards")
    cp_q8 = np.asarray(q8["cp"] + list(q8["cp_batch"]))
    cp_bf16 = np.asarray(got["cp"] + list(got["cp_batch"]))
    check(bool(np.isfinite(cp_q8).all()), "non-finite int8 CP score")
    cp_err = float(np.abs(cp_q8 - cp_bf16).max())
    check(cp_err <= INT8_CP_TOL, f"int8 CP probability off the bfloat16 engine's by {cp_err}")
    cir_q8, cir_bf16 = q8["cir"] + q8["cir_batch"], got["cir"] + got["cir_batch"]
    check(all(len(r) == 10 for r in cir_q8), "int8 CIR answer without 10 items")
    # Pools repeat items, so a top-10 can hold an item more than once: the
    # overlap counts items with their multiplicity (identical lists give 10).
    overlap = float(np.mean([
        sum((Counter(x["item_id"] for x in a) & Counter(x["item_id"] for x in b)).values())
        for a, b in zip(cir_q8, cir_bf16)
    ]))
    check(overlap >= INT8_CIR_OVERLAP_MIN, f"int8 CIR top-10 overlap {overlap} of 10")
    n_cands = [len(c) for _, c in reqs[4]]
    check(all(0 <= p < n for p, n in zip(q8["fitb"], n_cands)), "int8 FITB pick out of range")
    fitb = float(np.mean(np.asarray(q8["fitb"]) == np.asarray(got["fitb"])))
    check(q8["sim"] == got["sim"], "similar items differ: they take no model")
    return engine, {
        "engine_build_s": build_s, "forwards": forwards,
        "masked_mha_launches": launches, "layernorm_launches": ln_launches,
        "cp_prob_max_abs_err_vs_bf16": cp_err, "cir_top10_overlap_vs_bf16": overlap,
        "fitb_agree_with_bf16": fitb,
    }


def _save_legacy(path: pathlib.Path, sd) -> None:
    """An ``OutfitXModel`` state dict as a checkpoint from before the QKV
    fusion: the JAX tree (``jax_params_from_state_dict``) with ``wqkv`` and
    ``bqkv`` split back into per-projection ``wq``/``wk``/``wv`` and
    ``bq``/``bk``/``bv``, written in the ``state.npz`` format."""
    from outfitx_tpu_torch.models.from_jax import jax_params_from_state_dict
    from outfitx_tpu_torch.train.checkpoint import CheckpointManager, _flatten

    tree = jax_params_from_state_dict(sd)
    attn = tree["layers"]["attn"]
    wqkv, bqkv = attn.pop("wqkv"), attn.pop("bqkv")  # (L, d, 3, d), (L, 3, d)
    for j, n in enumerate("qkv"):
        attn[f"w{n}"], attn[f"b{n}"] = wqkv[:, :, j], bqkv[:, j]
    leaves: list = []
    skeleton = _flatten({"params": tree}, leaves)
    CheckpointManager._write(path, {
        "skeleton": skeleton,
        "specs": [[list(x.shape), str(x.dtype)] for x in leaves],
        "leaves": leaves,
        "meta": {"step": 0, "epoch": 0, "metrics": {}},
    })


def _legacy_route(cfg, reqs, gpu, got):
    """An engine built from legacy-layout (pre-QKV-fusion) ``best_auc`` and
    ``best_recall@1`` checkpoints of the default engine's weights: its
    set-transformer weights, CP scores and CIR top-10 answers bit-equal to
    the default engine's (``got``: the same weights through the same
    kernels), and exactly 6 ``masked_mha_fwd`` and 12 ``layernorm``
    launches a forward."""
    from outfitx_tpu_torch.models.from_jax import load_jax_checkpoint
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.serve.app import build_engine

    root = ROOT / "build" / "chip_smoke" / "legacy_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    dirs = {"cp": root / f"{cfg.model_name}-cp" / "best_auc",
            "cir": root / f"{cfg.model_name}-cir" / "best_recall@1"}
    t0 = time.perf_counter()
    for task, path in dirs.items():
        _save_legacy(path, getattr(gpu, f"{task}_params"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for path in dirs.values():
        load_jax_checkpoint(path)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = build_engine(synthetic=True, model_cfg=cfg, checkpoint_dir=str(root), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(engine.cir_model is not engine.cp_model,
          "legacy checkpoints: the engine did not load its CIR weights apart")
    for attr in ("cp_model", "cir_model"):
        a, b = getattr(engine, attr).state_dict(), getattr(gpu, attr).state_dict()
        check(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in b),
              f"legacy checkpoints: the {attr} weights differ from the fused engine's")
    engine.pools.pools.pop(0)  # the same routes as the default engine
    torch.cuda.synchronize()
    masked_mha.launches = layer_norm.launches = 0
    legacy = _serve(engine, reqs)
    torch.cuda.synchronize()
    launches, ln_launches = masked_mha.launches, layer_norm.launches
    forwards = _expected_forwards(engine, reqs)
    check(launches == cfg.transformer.n_layers * forwards
          and ln_launches == _ln_per_forward(cfg) * forwards,
          f"legacy checkpoints: {launches} masked_mha_fwd and {ln_launches} layernorm "
          f"launches for {forwards} forwards")
    check(legacy["cp"] == got["cp"] and list(legacy["cp_batch"]) == list(got["cp_batch"]),
          "legacy checkpoints: CP scores differ from the fused engine's")
    check(legacy["cir"] == got["cir"] and legacy["cir_batch"] == got["cir_batch"],
          "legacy checkpoints: CIR top-10 answers differ from the fused engine's")
    check(legacy["fitb"] == got["fitb"] and legacy["sim"] == got["sim"],
          "legacy checkpoints: FITB picks or similar items differ from the fused engine's")
    shutil.rmtree(root, ignore_errors=True)
    result = {
        "phase": "serve_legacy_checkpoints",
        "checkpoints_write_s": write_s, "restore_s": restore_s,
        "engine_build_s": build_s, "forwards": forwards,
        "masked_mha_launches": launches, "layernorm_launches": ln_launches,
        "weights_and_answers_bit_equal": True,
    }
    emit(result)
    return result


def phase_serve():
    from outfitx_tpu_torch.core.config import OutfitXConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.serve.app import build_engine

    cfg = OutfitXConfig()
    t0 = time.perf_counter()
    gpu = build_engine(synthetic=True, model_cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cpu = build_engine(
        synthetic=True,
        model_cfg=OutfitXConfig(compute_dtype="float32"),
        device="cpu",
    )
    # Category 0 loses its pool in both engines, so its targets take the
    # whole-catalog route and the others the pool route.
    for eng in (gpu, cpu):
        eng.pools.pools.pop(0)
    reqs = _requests(gpu.catalog, np.random.default_rng(1))

    masked_mha.launches = layer_norm.launches = 0
    t0 = time.perf_counter()
    got = _serve(gpu, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, ln_launches = masked_mha.launches, layer_norm.launches

    forwards = _expected_forwards(gpu, reqs)
    n_layers = cfg.transformer.n_layers
    check(launches == n_layers * forwards,
          f"masked_mha_fwd launched {launches} times for {forwards} forwards "
          f"of {n_layers} layers")
    check(ln_launches == _ln_per_forward(cfg) * forwards,
          f"layernorm launched {ln_launches} times for {forwards} forwards "
          f"of {_ln_per_forward(cfg)} LayerNorms")
    want = _serve(cpu, reqs)

    cp_got = np.asarray(got["cp"] + got["cp_batch"])
    cp_want = np.asarray(want["cp"] + want["cp_batch"])
    check(bool(np.isfinite(cp_got).all()), "non-finite CP score")
    check(bool(((cp_got >= 0) & (cp_got <= 1)).all()), "CP score outside [0, 1]")
    cp_err = float(np.abs(cp_got - cp_want).max())
    check(cp_err <= CP_PROB_TOL, f"CP probability off by {cp_err}")

    cir_got = got["cir"] + got["cir_batch"]
    cir_want = want["cir"] + want["cir_batch"]
    check(all(len(r) == 10 for r in cir_got), "CIR answer without 10 items")
    check(all(np.isfinite([x["score"] for x in r]).all() for r in cir_got),
          "non-finite CIR distance")
    top1 = float(np.mean([
        g[0]["item_id"] == w[0]["item_id"] for g, w in zip(cir_got, cir_want)
    ]))
    check(top1 >= CIR_TOP1_MIN, f"CIR top-1 agrees on {top1} of requests")
    worst_gap = 0.0
    for g, w in zip(cir_got, cir_want):
        cpu_d2 = {x["item_id"]: x["score"] for x in w}
        check(g[0]["item_id"] in cpu_d2, "CIR top-1 outside the CPU's top 10")
        gap = (cpu_d2[g[0]["item_id"]] - w[0]["score"]) / max(w[0]["score"], 1e-6)
        worst_gap = max(worst_gap, gap)
    check(worst_gap <= CIR_TIE_REL, f"CIR top-1 no near-tie: gap {worst_gap}")
    fitb = float(np.mean(np.asarray(got["fitb"]) == np.asarray(want["fitb"])))
    check(fitb >= FITB_MIN, f"FITB picks agree on {fitb} of requests")
    overlap = float(np.mean([
        len({x["item_id"] for x in g} & {x["item_id"] for x in w}) / len(w)
        for g, w in zip(got["sim"], want["sim"])
    ]))
    check(overlap >= SIM_OVERLAP_MIN, f"similar items overlap {overlap}")
    block = _block_route(cfg, reqs, got["cp"] + list(got["cp_batch"]))
    q8_engine, int8 = _int8_route(cfg, reqs, got)

    emit({
        "phase": "serve",
        "d_embed": cfg.d_embed, "n_layers": n_layers,
        "n_heads": cfg.transformer.n_heads,
        "catalog_items": gpu.catalog.n_items,
        "pool_size": gpu.pools.pool_size,
        "engine_build_s": build_s, "requests_s": serve_s,
        "forwards": forwards, "masked_mha_launches": launches,
        "layernorm_launches": ln_launches,
        "cp_prob_max_abs_err": cp_err, "cir_requests": len(cir_got),
        "cir_top1_agree": top1, "cir_top1_worst_rel_gap": worst_gap,
        "fitb_agree": fitb, "similar_overlap": overlap,
        "attn_block_route": block,
        "int8_route": int8,
    })
    legacy = _legacy_route(cfg, reqs, gpu, got)
    return gpu, q8_engine, {
        "serve": {"masked_mha_fwd": launches, "layernorm": ln_launches,
                  "attn_block": block["attn_block_launches"]},
        "serve_int8": {"masked_mha_fwd": int8["masked_mha_launches"],
                       "layernorm": int8["layernorm_launches"]},
        "serve_legacy": {"masked_mha_fwd": legacy["masked_mha_launches"],
                         "layernorm": legacy["layernorm_launches"]},
    }


def _cp_step_grads(model, catalog, split, device):
    """One CP train step (B=CHECK_B, A=CHECK_A) from the model's weights:
    (loss, {name: mean gradient on the CPU})."""
    from outfitx_tpu_torch.core.config import OptimizerConfig
    from outfitx_tpu_torch.data.sampler import cp_train_batches
    from outfitx_tpu_torch.train.optim import AdamW
    from outfitx_tpu_torch.train.state import TrainState
    from outfitx_tpu_torch.train.steps import cp_train_step

    batch = next(cp_train_batches(
        split, batch_size=CHECK_B, accum_steps=CHECK_A, epoch=0, seed=0
    ))
    state = TrainState.create(
        model, AdamW(model.parameters(), OptimizerConfig(), 1), seed=0
    )
    out = cp_train_step(
        state, torch.as_tensor(catalog, device=device),
        {k: torch.as_tensor(v, device=device) for k, v in batch.items()},
    )
    grads = {
        n: p.grad.detach().double().cpu().reshape(-1)
        for n, p in model.named_parameters() if p.grad is not None
    }
    return float(out["loss"]), grads


def _train_step_check(cfg, data):
    """(a): the card's bf16 CP train step against the CPU's float32 one."""
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel

    cfg0 = dataclasses.replace(
        cfg, transformer=dataclasses.replace(cfg.transformer, dropout=0.0)
    )
    gpu = OutfitXModel(cfg0, device="cuda", seed=0, trainable=True)
    cpu = OutfitXModel(
        dataclasses.replace(cfg0, compute_dtype="float32"), device="cpu",
        trainable=True,
    )
    cpu.load_state_dict(gpu.state_dict())
    emb = data.catalog.embeddings
    loss_gpu, grads_gpu = _cp_step_grads(gpu, emb, data.cp_train, "cuda")
    loss_cpu, grads_cpu = _cp_step_grads(cpu, emb, data.cp_train, "cpu")
    check(sorted(grads_gpu) == sorted(grads_cpu), "gradients of other parameters")
    cos = {
        n: float(F.cosine_similarity(grads_gpu[n], grads_cpu[n], dim=0))
        for n in grads_cpu
    }
    worst = min(cos, key=cos.get)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    check(math.isfinite(loss_gpu), "non-finite card train loss")
    check(rel <= TRAIN_LOSS_REL, f"card train loss {loss_gpu} vs CPU {loss_cpu}")
    check(cos[worst] >= GRAD_COS_MIN, f"gradient of {worst}: cosine {cos[worst]}")
    return {
        "batch": CHECK_B, "accumulation": CHECK_A,
        "loss_card": loss_gpu, "loss_cpu": loss_cpu, "loss_rel_err": rel,
        "grads_compared": len(cos), "worst_grad_cosine": cos[worst],
        "worst_grad": worst,
    }


def _logged(log_dir, run_name, split):
    path = pathlib.Path(log_dir) / f"{run_name}_metrics.jsonl"
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    return [r for r in recs if r["split"] == split]


def _expected_launches(cfg, trainer, steps):
    """(attention forward, attention backward, layernorm) launches of
    ``steps`` train steps and one validation sweep over the trainer's staged
    eval batches. LayerNorm's backward is the closed form in plain torch, so
    only forwards launch its kernel."""
    n_layers = cfg.transformer.n_layers
    micro = trainer.cfg.accumulation_steps * steps
    forwards = micro + len(trainer._eval_batches)
    return (n_layers * forwards, n_layers * micro, _ln_per_forward(cfg) * forwards)


def _cp_trainer_run(cfg, data, root):
    """(b): CPTrainer at the reference envelope."""
    from outfitx_tpu_torch.core.config import CPTrainConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.train.checkpoint import adam_state
    from outfitx_tpu_torch.train.cp_trainer import CPTrainer

    tcfg = CPTrainConfig(
        n_epochs=1, batch_size=TRAIN_B, accumulation_steps=TRAIN_A,
        checkpoint_dir=str(root / "ckpt"), log_dir=str(root / "logs"),
    )
    trainer = CPTrainer(
        tcfg, cfg, catalog=data.catalog, train_split=data.cp_train,
        valid_split=data.cp_valid, device="cuda",
    )
    with trainer as t:
        before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        masked_mha.launches = masked_mha.bwd_launches = layer_norm.launches = 0
        t0 = time.perf_counter()
        valid = t.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = (masked_mha.launches, masked_mha.bwd_launches, layer_norm.launches)
        peak = torch.cuda.max_memory_allocated()
        want = _expected_launches(cfg, t, TRAIN_STEPS)
        check(t.state.step == TRAIN_STEPS, f"CPTrainer took {t.state.step} steps")
        check(launches == want, f"CPTrainer launches {launches}, expected {want}")
        on_path = [n for n, p in t.model.named_parameters() if p.grad is not None]
        unchanged = [
            n for n, p in t.model.named_parameters()
            if n in on_path and torch.equal(p.detach(), before[n])
        ]
        check(not unchanged, f"parameters unchanged by training: {unchanged}")
    train = _logged(tcfg.log_dir, t.model_name, "train")
    losses = [r["loss"] for r in train] + [valid["loss"]]
    check(all(math.isfinite(x) for x in losses), f"non-finite CP loss {losses}")

    final = t.ckpt.restore("final")
    live = t.model.state_dict()
    check(sorted(final["params"]) == sorted(live), "checkpoint parameter names")
    check(all(torch.equal(final["params"][n], live[n].float().cpu()) for n in live),
          "checkpoint parameters differ from the model's")
    count, _, _ = adam_state(final["opt_state"])  # optax's two counts, equal
    check(count == TRAIN_STEPS, "checkpoint optimizer count")
    check(tcfg.async_saves, "CPTrainer saves are not asynchronous")
    best = t.ckpt.restore("best_auc")
    check(best["meta"]["epoch"] == 0 and sorted(best["params"]) == sorted(live),
          f"best_auc checkpoint {best['meta']}")
    return t, {
        "batch": TRAIN_B, "accumulation": TRAIN_A, "steps": t.state.step,
        "dropout": cfg.transformer.dropout, "train_outfits": len(data.cp_train),
        "valid_outfits": len(data.cp_valid), "run_s": run_s,
        "train_loss": train[-1]["loss"], "valid": valid,
        "masked_mha_fwd_launches": launches[0],
        "masked_mha_bwd_launches": launches[1],
        "layernorm_launches": launches[2],
        "peak_memory_bytes": peak, "params_on_path": len(on_path),
        "checkpoint": "final round-trips; best_auc written by the async writer",
    }


def _cir_trainer_run(cfg, data, cp_trainer, root):
    """(c): CIRTrainer warm-started from the CP trainer's final checkpoint."""
    from outfitx_tpu_torch.core.config import CIRTrainConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.train.cir_trainer import CIRTrainer

    tcfg = CIRTrainConfig(
        n_epochs=1, checkpoint_dir=str(root / "ckpt"), log_dir=str(root / "logs"),
        warm_start_from=str(cp_trainer.ckpt.path("final")),
    )
    check(len(data.cir_train) == tcfg.batch_size * CIR_STEPS, "CIR split size")
    trainer = CIRTrainer(
        tcfg, cfg, catalog=data.catalog, train_split=data.cir_train,
        valid_split=data.cir_valid, pool_threshold=1, device="cuda",
    )
    cp_params = cp_trainer.model.state_dict()
    with trainer as t:
        warm = t.model.state_dict()
        check(all(torch.equal(warm[n], cp_params[n]) for n in cp_params),
              "CIR warm start differs from the CP checkpoint")
        masked_mha.launches = masked_mha.bwd_launches = layer_norm.launches = 0
        t0 = time.perf_counter()
        valid = t.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = (masked_mha.launches, masked_mha.bwd_launches, layer_norm.launches)
        want = _expected_launches(cfg, t, CIR_STEPS)
        check(t.state.step == CIR_STEPS, f"CIRTrainer took {t.state.step} steps")
        check(launches == want, f"CIRTrainer launches {launches}, expected {want}")
    train = _logged(tcfg.log_dir, t.model_name, "train")
    recall = {k: v for k, v in valid.items() if k.startswith("recall@")}
    check(len(recall) == len(tcfg.recall_ks), f"no recall computed: {valid}")
    check(all(0.0 <= x <= 1.0 for x in recall.values()), f"recall {recall}")
    losses = [r["loss"] for r in train] + [valid["loss"]]
    check(all(math.isfinite(x) for x in losses), f"non-finite CIR loss {losses}")
    from outfitx_tpu_torch import native

    return t, {
        "batch": tcfg.batch_size, "steps": t.state.step, "run_s": run_s,
        # the samplers' 'auto' route, which the trainer takes
        "sampler_route": "native" if native.available() else "python",
        "train_loss": train[-1]["loss"], "valid": valid,
        "pools": len(t._pools.pools), "pool_size": t._pools.pool_size,
        "masked_mha_fwd_launches": launches[0],
        "masked_mha_bwd_launches": launches[1],
        "layernorm_launches": launches[2],
    }


def _fitb_run(cfg, data, cir_trainer, root):
    """FITBTrainer restores the CIR trainer's final checkpoint at full width
    and answers the FITB split in one forward of 512 (6 attention and 12
    LayerNorm launches); the first FITB_CPU_QUESTIONS picks against the
    CPU's in float32 from the same checkpoint: the share that agree at least
    FITB_MIN, and where they differ the card's pick a near-tie on the CPU
    (squared distance within CIR_TIE_REL of the CPU's best)."""
    from outfitx_tpu_torch.core.config import FITBTrainConfig
    from outfitx_tpu_torch.data.splits import FITBSplit
    from outfitx_tpu_torch.train.fitb_trainer import FITBTrainer
    from outfitx_tpu_torch.train.steps import gather

    path = str(cir_trainer.ckpt.path("final"))
    fcfg = FITBTrainConfig(checkpoint_from=path, checkpoint_dir=str(root / "ckpt"),
                           log_dir=str(root / "logs"))
    split = data.fitb_test
    with FITBTrainer(fcfg, cfg, catalog=data.catalog, test_split=split,
                     device="cuda") as t:
        _reset_ocp_counts()
        acc = t.run()
        torch.cuda.synchronize()
        counts = _ocp_counts()
        forwards = -(-len(split) // t.eval_batch_size)
        n_layers = cfg.transformer.n_layers
        want = {"masked_mha_fwd": n_layers * forwards, "masked_mha_bwd": 0,
                "layernorm": _ln_per_forward(cfg) * forwards}
        check(counts == want, f"FITB launches {counts}, expected {want}")
        del counts["masked_mha_bwd"]  # evaluation: not a kernel of this path
        card = t.predict()
    check(0.0 <= acc["accuracy"] <= 1.0, f"FITB accuracy {acc}")
    n = FITB_CPU_QUESTIONS
    sub = FITBSplit(split.item_rows[:n], split.mask[:n], split.cand_rows[:n],
                    split.answer_idx[:n])
    cpu_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    with FITBTrainer(fcfg, cpu_cfg, catalog=data.catalog, test_split=sub,
                     eval_batch_size=n, device="cpu") as c, torch.no_grad():
        cpu = c.predict()
        cat, d = c.catalog_dev, data.catalog.d_embed
        answer_rows = torch.as_tensor(sub.cand_rows[np.arange(n), sub.answer_idx])
        pred = c.model.eval().cir_forward(
            gather(cat, torch.as_tensor(sub.item_rows)), torch.as_tensor(sub.mask),
            gather(cat, answer_rows)[:, d // 2:],
        )
        d2 = ((pred[:, None, :] - gather(cat, torch.as_tensor(sub.cand_rows))) ** 2).sum(-1)
        d2 = d2.numpy()
    check(np.array_equal(np.argmin(d2, axis=1), cpu["picks"]), "CPU FITB picks")
    picks = card["picks"][:n]
    agree = float(np.mean(picks == cpu["picks"]))
    rows = np.arange(n)
    gaps = (d2[rows, picks] - d2[rows, cpu["picks"]]) / np.maximum(d2[rows, cpu["picks"]], 1e-6)
    check(agree >= FITB_MIN, f"FITB picks agree with the CPU's on {agree}")
    check(float(gaps.max()) <= CIR_TIE_REL, f"FITB pick no near-tie: gap {gaps.max()}")
    return {
        "checkpoint": "the CIR trainer's final", "questions": len(split),
        "accuracy": acc["accuracy"], "launches": counts,
        "cpu_questions": n, "agree_with_cpu_f32": agree,
        "worst_rel_gap": float(gaps.max()),
    }, counts


def _leaf_shapes(tree, path=""):
    """(path, shape) of every leaf of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_shapes(tree[k], f"{path}/{k}")]
    return [(path, tuple(np.shape(tree)))]


def _resume_run(cfg, data, root):
    """(g): a resume at the envelope. Trainer A (CPTrainer, B=TRAIN_B x
    A=TRAIN_A, 2 epochs, ``save_every_epochs=1``) keeps its first epoch's
    ``latest``; trainer B, the same config, resumes it and trains epoch 1.
    B's parameters, Adam moments and count must be bit-equal to A's final
    ones, its steps and launches exact. The saved optimizer state must have
    optax's skeleton (the JAX package's), its counts 0-d int32 and its
    ``mu`` leaves the shapes of ``jax_params_from_state_dict``'s. Returns
    the numbers (the checkpoint's bytes, a synchronous save's and B's
    resume's seconds) and B's launches."""
    from outfitx_tpu_torch.core.config import CPTrainConfig
    from outfitx_tpu_torch.models.from_jax import jax_params_from_state_dict
    from outfitx_tpu_torch.train.checkpoint import read_checkpoint_tree
    from outfitx_tpu_torch.train.cp_trainer import CPTrainer

    base = root / "resume"
    kept = base / "latest_epoch0"

    class FirstLatestKept(CPTrainer):
        def maybe_save_latest(self, epoch):
            super().maybe_save_latest(epoch)
            if epoch == 0:
                self.ckpt.wait()
                shutil.copytree(self.ckpt.path("latest"), kept)

    def trainer(cls, side):
        tcfg = CPTrainConfig(
            n_epochs=2, batch_size=TRAIN_B, accumulation_steps=TRAIN_A, save_every_epochs=1,
            checkpoint_dir=str(base / side / "ckpt"), log_dir=str(base / side / "logs"),
        )
        return cls(tcfg, cfg, catalog=data.catalog, train_split=data.cp_train,
                   valid_split=data.cp_valid, device="cuda")

    with trainer(FirstLatestKept, "a") as a:
        _reset_ocp_counts()
        a.run()
        torch.cuda.synchronize()
        a_launches = tuple(_ocp_counts().values())
        want = tuple(2 * n for n in _expected_launches(cfg, a, TRAIN_STEPS))
        check(a.state.step == 2 * TRAIN_STEPS, f"resume trainer A took {a.state.step} steps")
        check(a_launches == want, f"resume trainer A launches {a_launches}, expected {want}")
        opt = a.state.optimizer
        a_final = {
            "params": {n: p.detach().cpu().clone() for n, p in a.model.named_parameters()},
            "mu": [m.cpu().clone() for m in opt.mu], "nu": [m.cpu().clone() for m in opt.nu],
            "count": opt.count,
        }
        want_shapes = _leaf_shapes(jax_params_from_state_dict(a.model.state_dict()))
        t0 = time.perf_counter()
        a._save("timed", with_optimizer=True, sync=True, epoch=1)
        save_s = time.perf_counter() - t0

    saved = read_checkpoint_tree(kept)["opt_state"]
    clip, (adam, decay, schedule) = saved
    check(clip == [] and decay == [] and len(adam) == 3 and len(schedule) == 1,
          "the saved optimizer state does not have optax's skeleton")
    for c in (adam[0], schedule[0]):
        check(c.shape == () and c.dtype == np.int32 and int(c) == TRAIN_STEPS,
              f"saved optimizer count {c!r}")
    for i, key in ((1, "mu"), (2, "nu")):
        check(_leaf_shapes(adam[i]) == want_shapes,
              f"saved {key} leaves differ from jax_params_from_state_dict's")
    nbytes = (kept / "state.npz").stat().st_size

    with trainer(CPTrainer, "b") as b:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.resume(str(kept))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        check(b.epoch == 1 and b.state.step == b.state.optimizer.count == TRAIN_STEPS,
              f"resumed at epoch {b.epoch}, step {b.state.step}")
        _reset_ocp_counts()
        b.run()
        torch.cuda.synchronize()
        b_launches = _ocp_counts()
        want = dict(zip(b_launches, _expected_launches(cfg, b, TRAIN_STEPS)))
        check(b.state.step == 2 * TRAIN_STEPS, f"resumed trainer took {b.state.step} steps")
        check(b_launches == want, f"resumed trainer launches {b_launches}, expected {want}")
        opt = b.state.optimizer
        check(opt.count == a_final["count"], "resumed optimizer count")
        check(all(torch.equal(p.detach().cpu(), a_final["params"][n])
                  for n, p in b.model.named_parameters()),
              "resumed parameters differ from the uninterrupted run's")
        for key in ("mu", "nu"):
            check(all(torch.equal(m.cpu(), w) for m, w in zip(getattr(opt, key), a_final[key])),
                  f"resumed Adam {key} differs from the uninterrupted run's")
        b.run_mode = "test"  # no final save
    shutil.rmtree(base, ignore_errors=True)
    return {
        "epochs": 2, "resumed_at_epoch": 1, "steps_a_run": a.state.step,
        "checkpoint_bytes": nbytes, "checkpoint_leaves": len(want_shapes),
        "sync_save_s": save_s, "resume_s": resume_s,
        "bit_equal": "parameters, mu, nu and count of B equal A's final ones",
        "launches_a": dict(zip(b_launches, a_launches)), "launches": b_launches,
    }, b_launches


def _step_timing(cp_trainer, profile: bool = True):
    """The CP train step at B=TRAIN_B x A=TRAIN_A: host clock around
    synchronised steps, and a profile of one step by kernel."""
    from outfitx_tpu_torch.train.steps import cp_train_step

    t = cp_trainer
    batch = next(t._iter_train_batches(0))

    def step():
        return cp_train_step(
            t.state, t.catalog_dev, batch,
            alpha=t.cfg.focal_alpha, gamma=t.cfg.focal_gamma,
        )

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.mean(times))
    out = {
        "train_step_ms": ms,
        "train_step_peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "train_step_ms_each": times,
        "trained_outfits_per_s": TRAIN_B * TRAIN_A / (ms / 1e3),
    }
    if profile:
        out["train_step_profile"] = profile_call(step, top=14)
    return out


def _remat_launches(cfg, micro: int, remat: bool):
    """(attention forward, backward, layernorm) launches of ``micro``
    microbatches of a train step: under remat each layer's forward runs
    again in the backward, its two LayerNorms and its attention with it
    (the final LayerNorm, outside the layers, runs once)."""
    n_layers = cfg.transformer.n_layers
    again = n_layers if remat else 0
    return {"masked_mha_fwd": (n_layers + again) * micro,
            "masked_mha_bwd": n_layers * micro,
            "layernorm": (_ln_per_forward(cfg) + 2 * again) * micro}


def _grad_errors(grads, ref):
    """Per-parameter max |g - ref| over max |ref|, and whether every
    gradient is bit-equal to its reference."""
    rel = {}
    for n, g in grads.items():
        scale = float(ref[n].abs().max())
        rel[n] = float((g - ref[n]).abs().max()) / max(scale, 1e-30)
    worst = max(rel, key=rel.get)
    return {
        "bit_equal": all(torch.equal(g, ref[n]) for n, g in grads.items()),
        "worst_grad": worst, "worst_grad_rel_err": rel[worst],
    }


def _remat_step(cfg, snapshot, seed, step, catalog, batch, timed: bool):
    """One CP train step from ``snapshot`` (weights, dropout seed and step
    of the plain run) with ``cfg``: its host ms (a first call at its
    shapes), loss, gradients, launches; with
    ``timed``, then the step's device ms (CUDA events, after one warm
    step) and peak memory over the timed steps, beside the memory held
    before them."""
    from outfitx_tpu_torch.core.config import OptimizerConfig
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
    from outfitx_tpu_torch.train.optim import AdamW
    from outfitx_tpu_torch.train.state import TrainState
    from outfitx_tpu_torch.train.steps import cp_train_step

    model = OutfitXModel(cfg, device="cuda", seed=0, trainable=True)
    model.load_state_dict(snapshot)
    state = TrainState.create(
        model, AdamW(model.parameters(), OptimizerConfig(), 10), seed=seed
    )
    state.step = step

    def run():
        return cp_train_step(state, catalog, batch)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_ocp_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    res = {
        "first_step_ms": (time.perf_counter() - t0) * 1e3,
        "loss": float(out["loss"]), "launches": _ocp_counts(),
        "first_step_peak_bytes": torch.cuda.max_memory_allocated(),
        "resident_bytes": resident,
        "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                  if p.grad is not None},
    }
    if timed:
        res["ms"] = cuda_ms(run, REMAT_TIMED_STEPS, warmup=1)
        torch.cuda.synchronize()
        res["resident_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del model, state, out
    torch.cuda.empty_cache()
    return res


def _remat_checks(cfg, cp_trainer):
    """The CP step at B=TRAIN_B x A=TRAIN_A with each remat policy against
    the plain step from the same weights, dropout seed and step: loss and
    every gradient (bit-equal, or within REMAT_GRAD_REL), exact launches,
    step ms and peak memory; then one 'full' step at B=REMAT_BIG_B x A=1
    beside the peak the plain step would need there, scaled from its
    measured activations."""
    t = cp_trainer
    snapshot = {n: v.detach().clone() for n, v in t.model.state_dict().items()}
    seed, step = t.state.seed, t.state.step
    batch = next(t._iter_train_batches(0))
    out = {}
    plain = _remat_step(cfg, snapshot, seed, step, t.catalog_dev, batch, timed=True)
    want = _remat_launches(cfg, TRAIN_A, remat=False)
    check(plain["launches"] == want, f"plain step launches {plain['launches']}, expected {want}")
    check(math.isfinite(plain["loss"]), f"plain step loss {plain['loss']}")
    ref = plain.pop("grads")
    out["plain"] = plain
    for policy in REMAT_POLICIES:
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        got = _remat_step(rcfg, snapshot, seed, step, t.catalog_dev, batch, timed=True)
        want = _remat_launches(cfg, TRAIN_A, remat=True)
        check(got["launches"] == want,
              f"remat {policy} launches {got['launches']}, expected {want}")
        grads = got.pop("grads")
        check(sorted(grads) == sorted(ref), f"remat {policy}: gradients of other parameters")
        got.update(_grad_errors(grads, ref))
        got["loss_abs_err"] = abs(got["loss"] - plain["loss"])
        check(got["loss_abs_err"] <= REMAT_GRAD_REL * abs(plain["loss"]),
              f"remat {policy}: loss {got['loss']} vs plain {plain['loss']}")
        check(got["worst_grad_rel_err"] <= REMAT_GRAD_REL,
              f"remat {policy}: gradient of {got['worst_grad']} off by "
              f"{got['worst_grad_rel_err']} of its largest element")
        out[policy] = got
        del grads
    del ref
    torch.cuda.empty_cache()

    # one 'full' step at a microbatch of REMAT_BIG_B outfits
    s = t._train_dev
    check(len(s["label"]) >= REMAT_BIG_B, "train split smaller than the big microbatch")
    rows = {k: v[:REMAT_BIG_B][None] for k, v in s.items()}
    big = _remat_step(dataclasses.replace(cfg, remat=True), snapshot, seed, step,
                      t.catalog_dev, rows, timed=False)
    big.pop("grads")
    want = _remat_launches(cfg, 1, remat=True)
    check(big["launches"] == want, f"remat B={REMAT_BIG_B} launches {big['launches']}, expected {want}")
    check(math.isfinite(big["loss"]), f"remat B={REMAT_BIG_B} loss {big['loss']}")
    activations = plain["peak_bytes"] - plain["resident_bytes"]
    big["plain_peak_bytes_computed"] = (
        big["resident_bytes"] + activations * REMAT_BIG_B / TRAIN_B
    )
    big["card_memory_bytes"] = torch.cuda.get_device_properties(0).total_memory
    big["batch"] = REMAT_BIG_B
    out["full_big_microbatch"] = big
    del snapshot
    torch.cuda.empty_cache()
    return out


def _cir_invariants(split, catalog, batches, order, k):
    """The CIR batches of one epoch (rows in ``order``'s outfits): shapes,
    the pad row in padded slots, the positive an eligible member and the
    partial outfit the others, negatives of the positive's semantic key,
    never the positive, distinct, and padded only where the key's pool
    has fewer than k others."""
    b, length = HOST_ROUTE_BATCH, split.item_rows.shape[1]
    for x in batches:
        shapes = {key: v.shape for key, v in x.items()}
        check(shapes == {"item_idx": (1, b, length), "mask": (1, b, length), "pos_idx": (1, b),
                         "neg_idx": (1, b, k), "neg_mask": (1, b, k)}, f"CIR batch shapes {shapes}")
    cat = lambda key: np.concatenate([x[key].reshape(len(x[key][0]), -1) for x in batches])
    item, mask, neg, negm = cat("item_idx"), cat("mask"), cat("neg_idx"), cat("neg_mask")
    pos = cat("pos_idx")[:, 0]
    outfit = order[: len(pos)]
    rows, lengths = split.item_rows[outfit], split.lengths[outfit]
    members = np.arange(length)[None, :] < lengths[:, None]
    check(bool((item[mask] == catalog.pad_row).all()), "padded slots hold other rows than the pad row")
    check(bool(((~mask).sum(1) == lengths - 1).all()), "partial outfits of other lengths")
    eligible = (rows == pos[:, None]) & split.pos_eligible[outfit] & members
    check(bool(eligible.any(1).all()), "a positive that is no eligible member")
    big = np.iinfo(np.int32).max
    whole = np.sort(np.where(members, rows, big), axis=1)
    parts = np.sort(np.concatenate([np.where(mask, big, item), pos[:, None]], axis=1), axis=1)
    check(np.array_equal(parts[:, :length], whole), "partial outfit plus positive is not the outfit")
    key = catalog.semantic_category
    pool = np.bincount(key)[key[pos]]
    check(bool(((~negm).sum(1) == np.minimum(k, pool - 1)).all()), "negatives padded wrongly")
    check(bool((neg[negm] == 0).all()), "padded negatives not row 0")
    check(bool(((key[neg] == key[pos][:, None]) | negm).all()), "a negative of another key")
    check(bool(((neg != pos[:, None]) | negm).all()), "the positive drawn as its own negative")
    srt = np.sort(np.where(negm, -1 - np.arange(k)[None, :], neg), axis=1)
    check(bool((np.diff(srt, axis=1) != 0).all()), "a negative drawn twice")


def _host_routes(data):
    """The CIR trainer's host assembly of one epoch over the CP data's CIR
    split, on the native route (which must build here) and the python
    route: seconds an epoch and a step, each route's batches held to the
    invariants. The two routes draw other streams and are not compared."""
    from outfitx_tpu_torch import native
    from outfitx_tpu_torch.data import sampler as S

    native.load()  # raises with g++'s message
    split, catalog = data.cir_train, data.catalog
    seed, k = 42, 10
    sampler = S.NegativeSampler(catalog, "easy")
    order = S._epoch_rng(seed, 0, 1).permutation(len(split))
    out = {"outfits": len(split), "batch": HOST_ROUTE_BATCH, "negatives": k}
    for impl in ("native", "python"):
        t0 = time.perf_counter()
        batches = list(S.cir_train_batches(
            split, catalog, batch_size=HOST_ROUTE_BATCH, accum_steps=1, epoch=0, seed=seed,
            n_negatives=k, sample_mode="easy", max_len=split.item_rows.shape[1],
            sampler=sampler, impl=impl,
        ))
        epoch_s = time.perf_counter() - t0
        _cir_invariants(split, catalog, batches, order, k)
        out[impl] = {"epoch_s": epoch_s, "steps": len(batches),
                     "step_s": epoch_s / len(batches)}
    out["python_over_native"] = out["python"]["epoch_s"] / out["native"]["epoch_s"]
    return out


def phase_train():
    from outfitx_tpu_torch.core.config import OutfitXConfig
    from outfitx_tpu_torch.data.synthetic import make_synthetic

    cfg = OutfitXConfig()
    root = ROOT / "build" / "chip_smoke"
    shutil.rmtree(root, ignore_errors=True)

    def synthetic(n_outfits):
        return make_synthetic(
            n_items=CATALOG_ITEMS, d_embed=cfg.d_embed, n_outfits=n_outfits,
            outfit_len=(3, cfg.max_outfit_len), max_len=cfg.max_outfit_len,
            seed=0,
        )

    t0 = time.perf_counter()
    cp_data = synthetic(TRAIN_B * TRAIN_A * TRAIN_STEPS)
    # The same seed and catalog size give the same catalog.
    cir_data = synthetic(512 * CIR_STEPS)
    check(np.array_equal(cp_data.catalog.embeddings, cir_data.catalog.embeddings),
          "the two synthetic catalogs differ")
    data_s = time.perf_counter() - t0

    step_check = _train_step_check(cfg, cp_data)
    cp_trainer, cp = _cp_trainer_run(cfg, cp_data, root)
    cir_trainer, cir = _cir_trainer_run(cfg, cir_data, cp_trainer, root)
    fitb, fitb_counts = _fitb_run(cfg, cir_data, cir_trainer, root)
    timing = _step_timing(cp_trainer)
    bwd_kind = timing["train_step_profile"]["by_kind"].get("masked_mha_bwd", {})
    timing["masked_mha_bwd_ms_per_step"] = bwd_kind.get("device_ms", 0.0)
    timing["masked_mha_bwd_launches_per_step"] = bwd_kind.get("calls", 0)
    t0 = time.perf_counter()
    remat = _remat_checks(cfg, cp_trainer)
    remat["seconds"] = time.perf_counter() - t0
    remat_launches = Counter()
    for policy in REMAT_POLICIES + ("full_big_microbatch",):
        remat_launches.update(remat[policy]["launches"])
    t0 = time.perf_counter()
    host = _host_routes(cp_data)
    host["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resume, resume_launches = _resume_run(cfg, cp_data, root)
    resume["seconds"] = time.perf_counter() - t0
    emit({
        "phase": "train",
        "d_embed": cfg.d_embed, "n_layers": cfg.transformer.n_layers,
        "catalog_items": cp_data.catalog.n_items, "data_s": data_s,
        "step_check": step_check, "cp_trainer": cp, "cir_trainer": cir,
        "fitb": fitb, **timing, "remat": remat, "host_routes": host,
        "resume": resume,
    })
    return {
        "train": {
            "masked_mha_fwd": cp["masked_mha_fwd_launches"] + cir["masked_mha_fwd_launches"],
            "masked_mha_bwd": cp["masked_mha_bwd_launches"] + cir["masked_mha_bwd_launches"],
            "layernorm": cp["layernorm_launches"] + cir["layernorm_launches"],
        },
        "fitb": fitb_counts,
        "train_remat": dict(remat_launches),
        "train_resume": resume_launches,
    }


def _ocp_counts(resnet: bool = False):
    """The attention and LayerNorm launches since ``_reset_ocp_counts``; with
    ``resnet`` (the paths that run ResNet-18) the NHWC passes' too."""
    from outfitx_tpu_torch.ops import resnet_nhwc as rn
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm

    counts = {
        "masked_mha_fwd": masked_mha.launches,
        "masked_mha_bwd": masked_mha.bwd_launches,
        "layernorm": layer_norm.launches,
    }
    if resnet:
        counts["resnet_nhwc"] = (rn.normalize.launches + rn.stem_conv_pool.launches
                                 + rn.stem_pool.launches + rn.bias_add_relu.launches)
        counts["stem_conv_pool"] = rn.stem_conv_pool.launches
    return counts


def _reset_ocp_counts():
    from outfitx_tpu_torch.ops import resnet_nhwc as rn
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm

    masked_mha.launches = masked_mha.bwd_launches = layer_norm.launches = 0
    rn.normalize.launches = rn.stem_pool.launches = rn.bias_add_relu.launches = 0
    rn.stem_conv_pool.launches = 0


def _ocp_step_grads(net, source, split, device):
    """One original-CP train step (B=OCP_CHECK_B, A=OCP_CHECK_A, the first
    outfits of ``split``) from ``net``'s weights: (loss, {name: gradient on
    the CPU})."""
    from outfitx_tpu_torch.core.config import OptimizerConfig
    from outfitx_tpu_torch.train.optim import AdamW
    from outfitx_tpu_torch.train.original_cp_trainer import RawBatchStager
    from outfitx_tpu_torch.train.state import TrainState
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    stage = RawBatchStager(source, torch.device(device))
    state = TrainState.create(net, AdamW(net.parameters(), OptimizerConfig(), 1), seed=0)
    b = OCP_CHECK_B
    mbs = (
        stage(split.item_rows[i * b:(i + 1) * b], mask=split.mask[i * b:(i + 1) * b],
              label=split.labels[i * b:(i + 1) * b])
        for i in range(OCP_CHECK_A)
    )
    out = original_cp_train_step(state, mbs)
    grads = {
        n: p.grad.detach().double().cpu().reshape(-1)
        for n, p in net.named_parameters() if p.grad is not None
    }
    return float(out["loss"]), grads


def _ocp_step_check(model_cfg, encoder, source, split):
    """The card's bfloat16 original-CP step against the CPU's float32 one,
    from the same weights, dropout 0: the loss and the gradients (the
    encoder heads' held to GRAD_COS_MIN; the worst of all reported)."""
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPModel

    cfg0 = dataclasses.replace(
        model_cfg, transformer=dataclasses.replace(model_cfg.transformer, dropout=0.0)
    )

    def twin(device, dtype):
        """``encoder``'s weights on ``device``, its towers computing in
        ``dtype``."""
        enc = ItemEncoderModel(
            encoder.cfg,
            vision_cfg=dataclasses.replace(encoder.vision.cfg, compute_dtype=dtype),
            text_cfg=dataclasses.replace(encoder.text.cfg, compute_dtype=dtype),
            device=device,
        )
        enc.load_state_dict(encoder.state_dict())
        return enc

    gpu = OriginalCPModel(OutfitXModel(cfg0, device="cuda", seed=1, trainable=True),
                          twin("cuda", encoder.vision.cfg.compute_dtype))
    cpu = OriginalCPModel(OutfitXModel(
        dataclasses.replace(cfg0, compute_dtype="float32"), device="cpu", trainable=True
    ), twin("cpu", "float32"))
    cpu.model.load_state_dict(gpu.model.state_dict())
    loss_gpu, grads_gpu = _ocp_step_grads(gpu, source, split, "cuda")
    loss_cpu, grads_cpu = _ocp_step_grads(cpu, source, split, "cpu")
    check(sorted(grads_gpu) == sorted(grads_cpu), "original-CP gradients of other parameters")
    cos = {
        n: float(F.cosine_similarity(grads_gpu[n], grads_cpu[n], dim=0)) for n in grads_cpu
    }
    heads = {n: c for n, c in cos.items() if n.startswith("encoder.")}
    check(len(heads) == 4, f"original-CP head gradients: {sorted(heads)}")
    worst, worst_head = min(cos, key=cos.get), min(heads, key=heads.get)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    check(math.isfinite(loss_gpu), "non-finite original-CP card loss")
    check(rel <= TRAIN_LOSS_REL, f"original-CP card loss {loss_gpu} vs CPU {loss_cpu}")
    check(heads[worst_head] >= GRAD_COS_MIN,
          f"original-CP gradient of {worst_head}: cosine {heads[worst_head]}")
    return {
        "batch": OCP_CHECK_B, "accumulation": OCP_CHECK_A,
        "loss_card": loss_gpu, "loss_cpu": loss_cpu, "loss_rel_err": rel,
        "head_grad_cosines": heads, "grads_compared": len(cos),
        "worst_grad": worst, "worst_grad_cosine": cos[worst],
    }


def _ocp_step_timing(t):
    """One optimizer step at B=OCP_B x A=OCP_A: host clock around
    synchronised steps, the host gather's seconds within them, peak memory,
    and a profile of one step by kernel."""
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    split = t._train_split
    sels = next(t.step_selections(split, 0))

    def step():
        return original_cp_train_step(
            t.state, (t.microbatch(split, sel) for sel in sels),
            alpha=t.cfg.focal_alpha, gamma=t.cfg.focal_gamma,
        )

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, gathers = [], []
    for _ in range(2):
        g0 = t.stage.gather_s
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        gathers.append(t.stage.gather_s - g0)
    step_s = float(np.mean(times))
    items = OCP_B * OCP_A * t.model_cfg.max_outfit_len
    return {
        "step_s": step_s, "step_s_each": times,
        "outfits_per_s": OCP_B * OCP_A / step_s,
        "tower_items_per_s": items / step_s,
        "host_gather_s_each": gathers,
        "host_gather_share_of_step": float(np.mean(gathers)) / step_s,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "step_profile": profile_call(step, top=14),
    }


def phase_original_cp():
    """``OriginalCPTrainer`` at full width: ResNet-18 at 224 x 224 and MiniLM
    6 x 384 at T=16 inside the train step, the set transformer at d_embed 128
    (6 layers, 16 heads of Dh=8), bfloat16, on a synthetic raw source at the
    reference envelope (B=350 x A=10) for OCP_STEPS optimizer steps, one
    validation pass and its asynchronous best checkpoints, then the final
    one. Checks: one small step card against CPU, the frozen backbones
    bit-identical after training, exact launch counts a microbatch (MiniLM 6
    attention and 13 LayerNorm; the set transformer 6 forward and 6 backward
    attention and 12 LayerNorm), finite metrics, the final checkpoint equal
    to the live parameters in the JAX trainer's tree."""
    from outfitx_tpu_torch.core.config import CPTrainConfig, ItemEncoderConfig, OutfitXConfig
    from outfitx_tpu_torch.data.synthetic import make_synthetic
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.models.towers.common import LayerNorm
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource

    root = ROOT / "build" / "chip_smoke" / "original_cp"
    shutil.rmtree(root, ignore_errors=True)
    model_cfg = OutfitXConfig(item_encoder=ItemEncoderConfig.for_type("resnet_sbert"))
    t0 = time.perf_counter()
    encoder = ItemEncoderModel(model_cfg.item_encoder, device="cuda", seed=0)
    vc, tc = encoder.vision.cfg, encoder.text.cfg
    check((vc.image_size, vc.stage_channels, tc.d_model, tc.n_heads, tc.n_layers, tc.d_mlp)
          == (224, (64, 128, 256, 512), 384, 12, 6, 1536),
          f"original-CP towers are not ResNet-18 and MiniLM-L6: {vc} {tc}")
    text_len = min(16, tc.max_len)
    data = make_synthetic(
        n_items=OCP_ITEMS, d_embed=model_cfg.d_embed, n_outfits=OCP_B * OCP_A * OCP_STEPS,
        outfit_len=(3, model_cfg.max_outfit_len), max_len=model_cfg.max_outfit_len, seed=0,
    )
    source = RawItemSource.synthetic(
        n_items=data.catalog.n_items, image_size=encoder.image_size, text_len=text_len,
        vocab=encoder.text_vocab_size,
    )
    data_s = time.perf_counter() - t0

    step_check = _ocp_step_check(model_cfg, encoder, source, data.cp_train)

    cfg = CPTrainConfig(
        n_epochs=1, batch_size=OCP_B, accumulation_steps=OCP_A,
        checkpoint_dir=str(root / "ckpt"), log_dir=str(root / "logs"),
    )
    check(cfg.async_saves, "original-CP saves are not asynchronous")
    trainer = OriginalCPTrainer(
        cfg, model_cfg, encoder=encoder, source=source, train_split=data.cp_train,
        valid_split=data.cp_valid, device="cuda",
    )
    frozen = {n: p.detach().clone() for n, p in encoder.named_parameters()
              if not p.requires_grad}
    with trainer as t:
        heads_before = {n: p.detach().clone() for n, p in encoder.named_parameters()
                        if p.requires_grad}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_ocp_counts()
        t0 = time.perf_counter()
        valid = t.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _ocp_counts(resnet=True)
        run_peak = torch.cuda.max_memory_allocated()
        check(t.state.step == OCP_STEPS, f"OriginalCPTrainer took {t.state.step} steps")
        micro = OCP_A * OCP_STEPS
        evals = -(-len(data.cp_valid) // OCP_B)
        minilm_ln = sum(isinstance(m, LayerNorm) for m in encoder.text.modules())
        check(minilm_ln == 13, f"MiniLM has {minilm_ln} LayerNorms")
        want = {
            "masked_mha_fwd": (tc.n_layers + model_cfg.transformer.n_layers) * (micro + evals),
            "masked_mha_bwd": model_cfg.transformer.n_layers * micro,
            "layernorm": (minilm_ln + _ln_per_forward(model_cfg)) * (micro + evals),
            # the normaliser, the stem, two epilogues a block
            "resnet_nhwc": (2 + 2 * 4 * vc.blocks_per_stage) * (micro + evals),
            "stem_conv_pool": micro + evals,  # one a bfloat16 ResNet forward
        }
        check(counts == want, f"original-CP launches {counts}, expected {want}")
        changed = [n for n, p in encoder.named_parameters()
                   if n in frozen and not torch.equal(p.detach(), frozen[n])]
        check(not changed, f"frozen backbone parameters changed: {changed[:5]}")
        still = [n for n, p in encoder.named_parameters()
                 if n in heads_before and torch.equal(p.detach(), heads_before[n])]
        check(not still, f"encoder heads unchanged by training: {still}")
        check(all(math.isfinite(v) for v in valid.values()) and "auc" in valid,
              f"original-CP valid metrics {valid}")
        timing = _ocp_step_timing(t)
        live = {k: v.detach().float().cpu() for k, v in t.model.state_dict().items()}
        live_heads = {k: {a: b.detach().cpu().numpy() for a, b in v.items()}
                      for k, v in t.checkpoint_params()["enc_heads"].items()}
        # the final save below holds the state after the timed steps
    train = _logged(cfg.log_dir, t.model_name, "train")
    losses = [r["loss"] for r in train] + [valid["loss"]]
    check(all(math.isfinite(x) for x in losses), f"non-finite original-CP loss {losses}")
    final = t.ckpt.restore("final")
    check(all(torch.equal(final["params"][k], live[k]) for k in live),
          "original-CP final checkpoint differs from the live set transformer")
    check(all(np.array_equal(final["enc_heads"][h][a], live_heads[h][a])
              for h in live_heads for a in live_heads[h]),
          "original-CP final checkpoint differs from the live encoder heads")
    best = t.ckpt.restore("best_auc")
    check(best["meta"]["epoch"] == 0 and sorted(best["enc_heads"]) == ["fc", "proj"],
          f"original-CP best_auc checkpoint {best['meta']}")
    del trainer, t
    torch.cuda.empty_cache()
    emit({
        "phase": "original_cp",
        "vision": "ResNet-18 at 224x224", "text": f"MiniLM 6 x 384, T={text_len}",
        "d_embed": model_cfg.d_embed, "n_layers": model_cfg.transformer.n_layers,
        "head_dim": model_cfg.d_embed // model_cfg.transformer.n_heads,
        "batch": OCP_B, "accumulation": OCP_A, "steps": OCP_STEPS,
        "items_per_microbatch": OCP_B * model_cfg.max_outfit_len,
        "raw_items": data.catalog.n_items, "data_s": data_s,
        "train_outfits": len(data.cp_train), "valid_outfits": len(data.cp_valid),
        "step_check": step_check, "run_s": run_s, "run_peak_memory_bytes": run_peak,
        "launches": counts, "train_loss": train[-1]["loss"], "valid": valid,
        "checkpoints": "final and best_auc restored; final equals the live state",
        **timing,
    })
    return counts


def _reset_tower_counts():
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.attn_block import attn_block
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.ops.mlp import mlp_fused

    masked_mha.launches = attn_block.launches = mlp_fused.launches = 0
    layer_norm.launches = 0


def _tower_counts():
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.attn_block import attn_block
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.ops.mlp import mlp_fused

    return {
        "masked_mha_fwd": masked_mha.launches,
        "attn_block": attn_block.launches,
        "mlp_fused": mlp_fused.launches,
        "layernorm": layer_norm.launches,
    }


def _tower_layernorms(encoder) -> int:
    """LayerNorm modules of an item encoder's two towers; each runs once a
    batch (two a layer, the towers' final ones, CLIP's pre-LN or SigLIP's
    pooling head's)."""
    from outfitx_tpu_torch.models.towers.common import LayerNorm

    return sum(isinstance(m, LayerNorm) for m in encoder.modules())


def _read_shards(out_dir, model_name, prefix, n_shards):
    import pickle

    ids, embs = [], []
    for i in range(n_shards):
        with open(out_dir / f"{model_name}_{prefix}{i}.pkl", "rb") as f:
            payload = pickle.load(f)
        ids += payload["ids"]
        embs.append(payload["embeddings"])
    return ids, np.concatenate(embs)


def _sweep(cfg, model_cfg, out_dir, n_items, want_launches, **runner_kw):
    """One ``PrecomputeRunner`` sweep on the card: its result, its runner,
    the shards read back, the launch counts of the run checked exactly, and
    the embeddings checked (ids, shape, finite, unit-norm halves)."""
    from outfitx_tpu_torch.train.precompute import PrecomputeRunner

    runner = PrecomputeRunner(
        cfg, model_cfg, output_dir=str(out_dir), synthetic_items=n_items,
        device="cuda", **runner_kw,
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_tower_counts()
    result = runner.run()
    torch.cuda.synchronize()
    counts = _tower_counts()
    peak = torch.cuda.max_memory_allocated()
    want_launches = {
        **want_launches,
        "layernorm": _tower_layernorms(runner.encoder) * -(-n_items // runner.cfg.batch_size),
    }
    check(counts == want_launches,
          f"precompute launches {counts}, expected {want_launches}")
    check(result["items"] == n_items, f"precompute encoded {result['items']} items")
    ids, emb = _read_shards(out_dir, model_cfg.model_name, cfg.shard_prefix, result["shards"])
    check(ids == [10_000 + i for i in range(n_items)], "precompute shard ids")
    d = model_cfg.d_embed
    check(emb.shape == (n_items, d) and emb.dtype == np.float32,
          f"precompute embeddings {emb.shape} {emb.dtype}")
    check(bool(np.isfinite(emb).all()), "non-finite precompute embedding")
    norms = np.stack([
        np.linalg.norm(emb[:, : d // 2], axis=1), np.linalg.norm(emb[:, d // 2:], axis=1)
    ])
    check(bool(np.abs(norms - 1.0).max() <= 1e-3),
          f"precompute halves off unit norm by {np.abs(norms - 1.0).max()}")
    return result, runner, emb, counts, peak


def _half_cosines(a, b):
    """Smallest cosine over the items, for the image half and the text half."""
    d = a.shape[1]
    out = []
    for half in (slice(0, d // 2), slice(d // 2, d)):
        x, y = a[:, half].astype(np.float64), b[:, half].astype(np.float64)
        cos = (x * y).sum(1) / (np.linalg.norm(x, axis=1) * np.linalg.norm(y, axis=1))
        out.append(float(cos.min()))
    return {"image": out[0], "text": out[1]}


def _cpu_embeddings(runner, n_items):
    """The first ``n_items`` items of the runner's sweep, encoded on the CPU
    in float32 by the plain versions from the runner's weights."""
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.train.precompute import PrecomputeRunner

    enc = runner.encoder
    cpu_enc = ItemEncoderModel(
        enc.cfg,
        vision_cfg=dataclasses.replace(enc.vision.cfg, compute_dtype="float32"),
        text_cfg=dataclasses.replace(enc.text.cfg, compute_dtype="float32"),
        device="cpu",
    )
    cpu_enc.load_state_dict(enc.state_dict())
    cpu_runner = PrecomputeRunner(
        dataclasses.replace(runner.cfg, batch_size=n_items), runner.model_cfg,
        synthetic_items=n_items, encoder=cpu_enc, device="cpu",
    )
    return cpu_runner.encode_batch(next(cpu_runner._batches()))


def _resnet_sbert_outfits(emb, seed: int):
    """RESNET_SBERT_OUTFITS outfits of 2..16 items drawn from the sweep's
    embeddings: (B, 16, 128) float32 and the (B, 16) pad mask."""
    rng = np.random.default_rng(seed)
    b, l = RESNET_SBERT_OUTFITS, 16
    rows = rng.integers(0, emb.shape[0], (b, l))
    lengths = rng.integers(2, l + 1, b)
    mask = np.arange(l)[None, :] >= lengths[:, None]
    x = emb[rows].astype(np.float32)
    x[mask] = 0.0
    return x, mask


def _resnet_sbert(cfg, root):
    """The resnet_sbert item encoder at full width (ResNet-18 at 224 x 224,
    MiniLM 6 x 384 at T=64): a sweep of PRECOMPUTE_ITEMS items with exact
    launch counts (6 masked_mha_fwd and 13 layernorm a MiniLM pass), 32
    items against the CPU in float32, one batch timed; then the set
    transformer at d_embed 128 (16 heads of Dh=8, the bfloat16 narrow
    attention route) scoring outfits drawn from those embeddings, card
    bfloat16 against CPU float32."""
    from outfitx_tpu_torch.core.config import ItemEncoderConfig, OutfitXConfig
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel

    model_cfg = OutfitXConfig(item_encoder=dataclasses.replace(
        ItemEncoderConfig.for_type("resnet_sbert"), text_model_name=""
    ))
    from outfitx_tpu_torch.ops import resnet_nhwc as rn

    n_batches = -(-PRECOMPUTE_ITEMS // cfg.batch_size)
    stems = rn.stem_conv_pool.launches
    result, runner, emb, counts, peak = _sweep(
        cfg, model_cfg, root / "resnet_sbert", PRECOMPUTE_ITEMS,
        {"masked_mha_fwd": 6 * n_batches, "attn_block": 0, "mlp_fused": 0},
    )
    stems = rn.stem_conv_pool.launches - stems
    check(stems == n_batches, f"the sweep's stem ran {stems} times in {n_batches} batches")
    vc, tc = runner.encoder.vision.cfg, runner.encoder.text.cfg
    check((vc.image_size, vc.stage_channels, tc.d_model, tc.n_heads, tc.n_layers,
           tc.d_mlp, tc.vocab_size, tc.ln_eps)
          == (224, (64, 128, 256, 512), 384, 12, 6, 1536, 30522, 1e-12),
          f"resnet_sbert towers are not ResNet-18 and MiniLM-L6: {vc} {tc}")
    check(counts["layernorm"] == 13 * n_batches, f"MiniLM LayerNorms {counts}")
    t0 = time.perf_counter()
    cos = _half_cosines(emb[:CPU_CHECK_ITEMS], _cpu_embeddings(runner, CPU_CHECK_ITEMS))
    cpu_s = time.perf_counter() - t0
    check(min(cos.values()) >= PRECOMPUTE_COS_MIN,
          f"resnet_sbert card embeddings against the CPU's: cosines {cos}")
    batch = next(runner._batches())
    runner.encode_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.encode_batch(batch)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    profile = profile_call(lambda: runner.encode_batch(batch), top=8)
    del runner

    # The set transformer over these embeddings: Dh = 128 / 16 = 8.
    gpu = OutfitXModel(model_cfg, device="cuda", seed=0)
    cpu = OutfitXModel(dataclasses.replace(model_cfg, compute_dtype="float32"), device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    x, mask = _resnet_sbert_outfits(emb, seed=5)
    with torch.inference_mode():
        _reset_tower_counts()
        got = torch.sigmoid(gpu.cp_forward(
            torch.from_numpy(x).cuda(), torch.from_numpy(mask).cuda()
        )).cpu().numpy()
        torch.cuda.synchronize()
        scorer_counts = _tower_counts()
        want = torch.sigmoid(cpu.cp_forward(torch.from_numpy(x), torch.from_numpy(mask))).numpy()
    check(model_cfg.d_embed == 128 and model_cfg.d_embed // model_cfg.transformer.n_heads == 8,
          "the set transformer over resnet_sbert is not at Dh=8")
    check(scorer_counts["masked_mha_fwd"] == 6 and scorer_counts["layernorm"] == 12,
          f"resnet_sbert CP forward launches {scorer_counts}")
    check(bool(np.isfinite(got).all()), "non-finite resnet_sbert CP score")
    cp_err = float(np.abs(got - want).max())
    check(cp_err <= CP_PROB_TOL, f"resnet_sbert CP probability off by {cp_err}")
    launches = {k: counts[k] + scorer_counts[k] for k in ("masked_mha_fwd", "layernorm")}
    return {
        "vision": "ResNet-18 at 224x224", "text": "MiniLM, T=64, d=384, 6 layers, vocab 30522",
        "items": result["items"], "batch": cfg.batch_size, "shards": result["shards"],
        "sweep_s": result["seconds"], "sweep_items_per_s": result["items_per_sec"],
        "launches": counts, "peak_memory_bytes": peak,
        "batch_s": batch_s, "batch_items_per_s": cfg.batch_size / batch_s,
        "cpu_check_items": CPU_CHECK_ITEMS, "cpu_check_s": cpu_s,
        "min_cosine_vs_cpu_f32": cos, "batch_profile": profile,
        "set_transformer": {
            "d_embed": model_cfg.d_embed, "head_dim": 8, "outfits": len(x),
            "launches": scorer_counts, "cp_prob_max_abs_err_vs_cpu_f32": cp_err,
        },
    }, launches


def phase_precompute():
    from outfitx_tpu_torch.core.config import (
        ItemEncoderConfig,
        OutfitXConfig,
        PrecomputeConfig,
    )

    root = ROOT / "build" / "chip_smoke" / "precompute"
    shutil.rmtree(root, ignore_errors=True)
    cfg = PrecomputeConfig(seed=0, dataset_dir=str(root))
    # The SigLIP default at full width. No tokenizer files are in the
    # repository, so the name is emptied and the hash tokenizer is used.
    siglip = OutfitXConfig(item_encoder=dataclasses.replace(
        ItemEncoderConfig(), text_model_name=""
    ))
    n_layers = 12
    n_batches = -(-PRECOMPUTE_ITEMS // cfg.batch_size)
    # (a) attention route "block", MLP plain: the text tower (L=64) goes
    # through attn_block, the vision tower (L=196) through masked_mha.
    result, runner, emb, counts, peak = _sweep(
        cfg, siglip, root / "block", PRECOMPUTE_ITEMS,
        {"masked_mha_fwd": n_layers * n_batches, "attn_block": n_layers * n_batches,
         "mlp_fused": 0},
    )
    vc, tc = runner.encoder.vision.cfg, runner.encoder.text.cfg
    check((vc.seq_len, vc.d_model, vc.n_heads, vc.d_mlp, vc.n_layers) == (196, 768, 12, 3072, 12),
          f"vision tower is not SigLIP ViT-B/16: {vc}")
    check((tc.max_len, tc.d_model, tc.n_heads, tc.d_mlp, tc.n_layers, tc.vocab_size)
          == (64, 768, 12, 3072, 12, 32000), f"text tower is not SigLIP-B: {tc}")
    check(_tower_layernorms(runner.encoder) == 2 * 2 * n_layers + 3,
          "SigLIP pair: two LayerNorms a layer, the towers' final ones and the "
          "pooling head's")
    t0 = time.perf_counter()
    cpu_emb = _cpu_embeddings(runner, CPU_CHECK_ITEMS)
    cpu_s = time.perf_counter() - t0
    cos_cpu = _half_cosines(emb[:CPU_CHECK_ITEMS], cpu_emb)
    check(min(cos_cpu.values()) >= PRECOMPUTE_COS_MIN,
          f"card embeddings against the CPU's: cosines {cos_cpu}")

    # One batch on the card, already on the host: seconds per batch without
    # the host's image generation, and where its time goes.
    batch = next(runner._batches())
    runner.encode_batch(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        runner.encode_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    profile = profile_call(lambda: runner.encode_batch(batch), top=12)

    # (b) the same weights with the fused MLP in both towers.
    fused_result, fused_runner, fused_emb, fused_counts, _ = _sweep(
        dataclasses.replace(cfg, batch_size=FUSED_ITEMS), siglip, root / "fused",
        FUSED_ITEMS,
        {"masked_mha_fwd": n_layers, "attn_block": n_layers, "mlp_fused": 2 * n_layers},
        mlp="fused", state_dict=runner.encoder.state_dict(),
    )
    cos_fused = _half_cosines(fused_emb, emb[:FUSED_ITEMS])
    check(min(cos_fused.values()) >= FUSED_COS_MIN,
          f"fused-MLP embeddings against the plain pass: cosines {cos_fused}")
    fused_batch = next(fused_runner._batches())
    fused_runner.encode_batch(fused_batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_runner.encode_batch(fused_batch)
    torch.cuda.synchronize()
    fused_batch_s = time.perf_counter() - t0
    fused_profile = profile_call(lambda: fused_runner.encode_batch(fused_batch), top=12)
    del fused_runner

    # (c) the CLIP pair: ViT-B/32 at L=50 and the causal text tower at L=77,
    # both through masked_mha (the block's shape guard lets neither through).
    clip = OutfitXConfig(item_encoder=dataclasses.replace(
        ItemEncoderConfig.for_type("clip"), text_model_name="", text_max_length=77
    ))
    clip_result, clip_runner, clip_emb, clip_counts, _ = _sweep(
        dataclasses.replace(cfg, batch_size=CLIP_ITEMS), clip, root / "clip", CLIP_ITEMS,
        {"masked_mha_fwd": 2 * n_layers, "attn_block": 0, "mlp_fused": 0},
    )
    cvc, ctc = clip_runner.encoder.vision.cfg, clip_runner.encoder.text.cfg
    check((cvc.seq_len, ctc.max_len, ctc.variant) == (50, 77, "clip"), "CLIP tower shapes")
    cos_clip = _half_cosines(
        clip_emb[:CPU_CHECK_ITEMS], _cpu_embeddings(clip_runner, CPU_CHECK_ITEMS)
    )
    check(min(cos_clip.values()) >= PRECOMPUTE_COS_MIN,
          f"CLIP card embeddings against the CPU's: cosines {cos_clip}")

    resnet_sbert, resnet_launches = _resnet_sbert(cfg, root)

    batch_s = float(np.mean(times))
    emit({
        "phase": "precompute",
        "encoder": "siglip", "vision": "ViT-B/16, 196 tokens, d=768, 12 layers",
        "text": "L=64, d=768, 12 layers, vocab 32000",
        "items": result["items"], "batch": cfg.batch_size, "shards": result["shards"],
        "sweep_s": result["seconds"], "sweep_items_per_s": result["items_per_sec"],
        "launches": counts, "peak_memory_bytes": peak,
        "batch_s_each": times, "batch_s": batch_s,
        "batch_items_per_s": cfg.batch_size / batch_s,
        "cpu_check_items": CPU_CHECK_ITEMS, "cpu_check_s": cpu_s,
        "min_cosine_vs_cpu_f32": cos_cpu,
        "fused_mlp": {
            "items": fused_result["items"], "launches": fused_counts,
            "batch_s": fused_batch_s, "batch_items_per_s": FUSED_ITEMS / fused_batch_s,
            "min_cosine_vs_plain_mlp": cos_fused,
            "max_abs_diff_vs_plain_mlp": float(np.abs(fused_emb - emb[:FUSED_ITEMS]).max()),
            "batch_profile": fused_profile,
        },
        "clip": {
            "items": clip_result["items"], "launches": clip_counts,
            "min_cosine_vs_cpu_f32": cos_clip,
        },
        "batch_profile": profile,
        "resnet_sbert": resnet_sbert,
    })
    return {
        "precompute": {
            "masked_mha_fwd": counts["masked_mha_fwd"] + fused_counts["masked_mha_fwd"]
            + clip_counts["masked_mha_fwd"],
            "attn_block": counts["attn_block"] + fused_counts["attn_block"],
            "mlp_fused": fused_counts["mlp_fused"],
            "layernorm": counts["layernorm"] + fused_counts["layernorm"]
            + clip_counts["layernorm"],
        },
        "precompute_resnet_sbert": resnet_launches,
    }


def _http(url, payload=None, timeout=60):
    """GET ``url``, or POST ``payload`` as JSON: (status, decoded body)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _ok(url, payload=None):
    status, body = _http(url, payload)
    check(status == 200, f"{url} answered {status}: {body}")
    return body


def _ids(items):
    return [x["item_id"] for x in items]


def phase_http():
    """``serve()`` at full width on the card, its own server in a thread:
    concurrent clients on the coalesced and the plain routes against the
    engine's direct answers, live update and append over HTTP, requests
    racing updates, the stats and OpenAPI routes, exact launch counts, and an
    age drain that lets an in-flight request finish."""
    import concurrent.futures
    import socket
    import threading

    from outfitx_tpu_torch.core.config import OutfitXConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.serve import programs
    from outfitx_tpu_torch.serve.app import DRAIN_EXIT_CODE, build_engine, serve

    cfg = OutfitXConfig()
    t0 = time.perf_counter()
    engine = build_engine(
        synthetic=True, model_cfg=cfg, device="cuda", spare_capacity=HTTP_SPARE_ROWS
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine.pools.pools.pop(0)  # category 0 takes the whole-catalog route
    cat = engine.catalog
    n0 = cat.n_items
    check(cat.capacity == n0 + HTTP_SPARE_ROWS and engine._route.n_rows == cat.capacity,
          "spare capacity not reserved")
    cp, cp_batch, cir, _, fitb, sim = _requests(cat, np.random.default_rng(2))
    cp, sim = cp + cp_batch, sim + [int(i) for i in cat.item_ids[:13]]

    # Forwards and batched calls of the run, counted where the engine makes them.
    model_tasks = {programs.cp_task, programs.cir_task, programs.cir_pool_task,
                   programs.fitb_task}
    counted = {"forwards": 0, "cp_score_batch": 0, "cir_top10_batch": 0,
               "similar_items_batch": 0}
    count_lock = threading.Lock()
    real_run = engine._run

    def counting_run(task, *args):
        if task in model_tasks:
            with count_lock:
                counted["forwards"] += 1
        return real_run(task, *args)

    def counting(name):
        real = getattr(engine, name)

        def call(*a, **k):
            with count_lock:
                counted[name] += 1
            return real(*a, **k)

        return call

    # The engine's direct answers, through the batched forms that the
    # coalescers call (one bucket of 8 whatever the batch).
    want_cp = engine.cp_score_batch(cp)
    want_cir = engine.cir_top10_batch(cir)
    want_sim = engine.similar_items_batch(sim)
    want_fitb = [engine.fitb_pick(o, c) for o, c in fitb]
    engine._run = counting_run
    for name in ("cp_score_batch", "cir_top10_batch", "similar_items_batch"):
        setattr(engine, name, counting(name))

    # The in-flight request of the drain: a FITB pick that, once armed, holds
    # its handler thread until the watchdog has fired.
    hold = {"until": None}
    real_fitb = engine.fitb_pick

    def fitb_pick(outfit, candidates):
        if hold["until"] is not None:
            time.sleep(max(0.0, hold["until"] - time.monotonic()))
        return real_fitb(outfit, candidates)

    engine.fitb_pick = fitb_pick

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    outcome = {}

    def run_server():
        try:
            serve(port, engine=engine, coalesce_ms=HTTP_COALESCE_MS,
                  max_age_s=HTTP_AGE_S, poll=0.05)
            outcome["code"] = 0
        except SystemExit as e:
            outcome["code"] = e.code

    masked_mha.launches = layer_norm.launches = 0
    server = threading.Thread(target=run_server)
    started = time.monotonic()
    server.start()
    for _ in range(200):
        try:
            if _http(url + "/api/health", timeout=2)[0] == 200:
                break
        except OSError:
            time.sleep(0.05)
    check(_ok(url + "/api/health") == {"ok": True, "mock": False}, "health route")

    # Concurrent clients on every request route.
    jobs = (
        [("cp", i, lambda o=o: _ok(url + "/api/cp", {"outfit": o})["score"])
         for i, o in enumerate(cp)]
        + [("cir", i, lambda o=o, t=t: _ok(url + "/api/cir", {"outfit": o, "target": t})["items"])
           for i, (o, t) in enumerate(cir)]
        + [("sim", i, lambda it=it: _ok(f"{url}/api/similar?item_id={it}")["items"])
           for i, it in enumerate(sim)]
        + [("fitb", i, lambda o=o, c=c: _ok(url + "/api/fitb", {"outfit": o, "candidates": c})["pick"])
           for i, (o, c) in enumerate(fitb)]
        + [("cp_batch", 0, lambda: _ok(url + "/api/cp_batch", {"outfits": cp})["scores"])]
    )
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=HTTP_CLIENTS) as ex:
        futs = [(kind, i, ex.submit(fn)) for kind, i, fn in jobs]
        got = {(kind, i): f.result() for kind, i, f in futs}
    requests_s = time.perf_counter() - t0

    # Every coalesced call runs at the one bucket, as the direct answers did:
    # the same rows through the same kernels. A different neighbour in the
    # bucket may still change a product's last bits in bfloat16.
    cp_err = max(abs(got["cp", i] - want_cp[i]) for i in range(len(cp)))
    check(cp_err <= HTTP_CP_TOL, f"/api/cp off the direct score by {cp_err}")
    batch_err = max(abs(a - b) for a, b in zip(got["cp_batch", 0], want_cp))
    check(batch_err <= HTTP_CP_TOL, f"/api/cp_batch off the direct scores by {batch_err}")
    cir_same = float(np.mean([_ids(got["cir", i]) == _ids(want_cir[i]) for i in range(len(cir))]))
    # A synthetic category holds fewer items than its pool of 1,000, so a
    # pool repeats items and a top-10 holds tied copies: compare the sets.
    cir_overlap = float(np.mean([
        len(set(_ids(got["cir", i])) & set(_ids(want_cir[i])))
        / len(set(_ids(want_cir[i]))) for i in range(len(cir))
    ]))
    check(all(len(got["cir", i]) == 10 for i in range(len(cir))), "CIR answer without 10 items")
    check(cir_overlap >= HTTP_OVERLAP_MIN, f"/api/cir overlaps the direct answers on {cir_overlap}")
    sim_same = float(np.mean([_ids(got["sim", i]) == _ids(want_sim[i]) for i in range(len(sim))]))
    check(sim_same == 1.0, f"/api/similar equals the direct answers on {sim_same}")
    check([got["fitb", i] for i in range(len(fitb))] == want_fitb, "/api/fitb picks differ")
    n_coalesced = {"cp_score_batch": len(cp), "cir_top10_batch": len(cir),
                   "similar_items_batch": len(sim)}
    batch_calls = {k: counted[k] - (1 if k == "cp_score_batch" else 0) for k in n_coalesced}
    for name, n in n_coalesced.items():
        check(1 <= batch_calls[name] < n,
              f"{name}: {batch_calls[name]} batched calls for {n} requests")

    # Live update over HTTP: dst takes src's embedding and becomes its nearest.
    src, dst = sim[0], sim[1]
    emb = cat.embeddings[engine.lookup_row(src)].tolist()
    check(_ok(url + "/api/update_items", {"item_ids": [dst], "embeddings": [emb]})
          == {"updated": 1}, "update_items answer")
    near = _ok(f"{url}/api/similar?item_id={src}")["items"]
    check(near[0]["item_id"] == dst and near[0]["score"] <= 1e-3,
          f"the updated row is not its source's nearest: {near[0]}")

    # Live append: a clone of another item is found at once, and no sentinel
    # row is ever returned.
    src2, new_id = sim[2], 9_000_001
    emb2 = cat.embeddings[engine.lookup_row(src2)].tolist()
    added = _ok(url + "/api/add_items", {
        "item_ids": [new_id], "embeddings": [emb2],
        "category_ids": [int(cat.category_id[engine.lookup_row(src2)])],
        "descriptions": ["appended over HTTP"],
    })
    check(added == {"added": 1, "n_items": n0 + 1, "capacity": n0 + HTTP_SPARE_ROWS},
          f"add_items answer {added}")
    near = _ok(f"{url}/api/similar?item_id={src2}")["items"]
    check(near[0]["item_id"] == new_id and near[0]["description"] == "appended over HTTP",
          f"the appended item is not found: {near[0]}")
    known = set(int(i) for i in cat.item_ids)
    cir_new = _ok(url + "/api/cir", {"outfit": cp[0], "target": new_id})["items"]
    check(len(cir_new) == 10 and set(_ids(cir_new) + _ids(near)) <= known,
          "a sentinel row or an unknown id was returned")

    # Requests racing updates: whole-catalog CIR (two catalog reads a
    # request) while other clients rewrite rows.
    rng = np.random.default_rng(3)
    storm_rows = [rng.normal(size=(1, cfg.d_embed)).astype(np.float32).tolist() for _ in range(8)]
    unpooled = np.flatnonzero(cat.category_id[:n0] == 0)
    whole = [(cp[i], int(cat.item_ids[r])) for i, r in enumerate(rng.choice(unpooled, 8))]
    storm = (
        [lambda o=o, t=t: len(_ok(url + "/api/cir", {"outfit": o, "target": t})["items"])
         for o, t in whole]
        + [lambda r=r, i=i: _ok(url + "/api/update_items",
                                {"item_ids": [sim[3 + i % 4]], "embeddings": r})["updated"]
           for i, r in enumerate(storm_rows)]
    )
    with concurrent.futures.ThreadPoolExecutor(max_workers=HTTP_CLIENTS) as ex:
        storm_out = [f.result() for f in [ex.submit(fn) for fn in storm]]
    check(storm_out == [10] * len(whole) + [1] * len(storm_rows), f"storm answers {storm_out}")
    torch.cuda.synchronize()
    check(torch.equal(engine.catalog_dev.cpu(), torch.from_numpy(cat.embeddings)),
          "host and device catalogs differ after the updates")

    spec = _ok(url + "/api/openapi.json")
    check(spec["openapi"].startswith("3.") and "/api/cir" in spec["paths"], "OpenAPI document")
    served = {"/api/cp": len(cp), "/api/cir": len(cir) + 1 + len(whole),
              "/api/similar": len(sim) + 2, "/api/fitb": len(fitb), "/api/cp_batch": 1,
              "/api/update_items": 1 + len(storm_rows), "/api/add_items": 1}
    for _ in range(100):  # a request is recorded after its response is written
        stats = _ok(url + "/api/stats")
        if all(stats["routes"].get(r, {}).get("n") == n for r, n in served.items()):
            break
        time.sleep(0.05)
    for route, n in served.items():
        row = stats["routes"].get(route)
        check(row is not None and row["n"] == n and row["errors"] == 0,
              f"stats of {route}: {row}, expected n={n}")
        check(all(row[p] is not None and row[p] > 0 for p in ("p50_ms", "p90_ms", "p99_ms")),
              f"stats of {route} lack a percentile: {row}")
    check(stats["total_errors"] == 0, f"server errors: {stats['total_errors']}")
    check(stats["catalog"] == {"n_items": n0 + 1, "capacity": n0 + HTTP_SPARE_ROWS,
                               "updated_rows": 1 + len(storm_rows), "appended_items": 1},
          f"catalog stats {stats['catalog']}")

    # Exact launch counts of everything served so far.
    torch.cuda.synchronize()
    launches, ln_launches = masked_mha.launches, layer_norm.launches
    forwards = counted["forwards"]
    n_layers = cfg.transformer.n_layers
    check(launches == n_layers * forwards,
          f"http: masked_mha_fwd launched {launches} times for {forwards} forwards")
    check(ln_launches == _ln_per_forward(cfg) * forwards,
          f"http: layernorm launched {ln_launches} times for {forwards} forwards")

    # The age drain: a request in flight when the watchdog fires finishes.
    checks_s = time.monotonic() - started
    check(checks_s < HTTP_AGE_S - 1.0,
          f"the http checks took {checks_s:.1f} s, past the drain at {HTTP_AGE_S} s")
    hold["until"] = started + HTTP_AGE_S + 2.0
    in_flight = {}

    def slow_client():
        in_flight["answer"] = _http(
            url + "/api/fitb", {"outfit": fitb[0][0], "candidates": fitb[0][1]}
        )

    client = threading.Thread(target=slow_client)
    client.start()
    server.join(timeout=HTTP_AGE_S + 60)
    client.join(timeout=60)
    check(not server.is_alive() and not client.is_alive(), "the drained server did not stop")
    check(outcome.get("code") == DRAIN_EXIT_CODE, f"serve() ended with {outcome}")
    status, body = in_flight.get("answer", (None, None))
    check(status == 200 and 0 <= body["pick"] < len(fitb[0][1]),
          f"the in-flight request got {in_flight.get('answer')}")
    try:
        _http(url + "/api/health", timeout=2)
        check(False, "the drained server still accepts connections")
    except OSError:
        pass

    emit({
        "phase": "http",
        "d_embed": cfg.d_embed, "n_layers": n_layers, "catalog_items": n0,
        "spare_rows": HTTP_SPARE_ROWS, "coalesce_ms": HTTP_COALESCE_MS,
        "clients": HTTP_CLIENTS, "engine_build_s": build_s,
        "requests": len(jobs), "requests_s": requests_s,
        "batched_calls": batch_calls, "coalesced_requests": n_coalesced,
        "cp_max_abs_err": cp_err, "cp_batch_max_abs_err": batch_err,
        "cir_equal": cir_same, "cir_overlap": cir_overlap, "similar_equal": sim_same,
        "storm": {"cir_requests": len(whole), "updates": len(storm_rows)},
        "forwards": forwards, "masked_mha_launches": launches,
        "layernorm_launches": ln_launches,
        "route_stats_ms": {
            r: {p: stats["routes"][r][p] for p in ("n", "p50_ms", "p90_ms", "p99_ms")}
            for r in ("/api/cp", "/api/cir", "/api/similar", "/api/fitb", "/api/cp_batch")
        },
        "drain": {"age_s": HTTP_AGE_S, "exit_code": outcome["code"],
                  "in_flight_status": in_flight["answer"][0]},
    })
    return {"masked_mha_fwd": launches, "layernorm": ln_launches}


# A child process that runs the CLI as ``python -m outfitx_tpu_torch.cli
# <argv>`` does, then prints, on a last line of its own, the kernel launches
# it made, and exits with the CLI's code.
CLI_WRAPPER = """
import json, runpy, sys
sys.argv = ["outfitx_tpu_torch.cli"] + sys.argv[1:]
code = 0
try:
    runpy.run_module("outfitx_tpu_torch.cli", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
from outfitx_tpu_torch.ops.attention import masked_mha
from outfitx_tpu_torch.ops.attn_block import attn_block
from outfitx_tpu_torch.ops.layernorm import layer_norm
from outfitx_tpu_torch.ops.mlp import mlp_fused
print(json.dumps({"launches": {
    "masked_mha_fwd": masked_mha.launches, "masked_mha_bwd": masked_mha.bwd_launches,
    "attn_block": attn_block.launches, "mlp_fused": mlp_fused.launches,
    "layernorm": layer_norm.launches,
}}), flush=True)
sys.exit(code)
"""


def _cli_lines(argv, out: str, err: str, code: int, expect: int):
    check(code == expect, f"cli {' '.join(argv)} exited {code}, expected {expect}:\n{err[-3000:]}")
    lines = out.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])["launches"]


def _cli(argv):
    """One CLI command in a child process on the card: its JSON line, the
    kernel launches of that process and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_WRAPPER, *argv], cwd=ROOT, capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S,
    )
    result, launches = _cli_lines(argv, proc.stdout, proc.stderr, proc.returncode, 0)
    return result, launches, time.perf_counter() - t0


def _cli_demo(root):
    """``demo --synthetic --max-age`` in a child process: it answers one CP
    request, then drains and exits 81."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["demo", "--synthetic", "--port", str(port), "--max-age", str(CLI_DEMO_AGE_S),
            "--checkpoint-dir", str(root / "no_checkpoints")]
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", CLI_WRAPPER, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + CLI_TIMEOUT_S
        while True:
            check(proc.poll() is None and time.monotonic() < deadline,
                  "demo: the server did not come up")
            try:
                if _http(url + "/api/health", timeout=2)[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        score = _ok(url + "/api/cp", {"outfit": [10_000, 10_001, 10_002]})["score"]
        check(0.0 <= score <= 1.0, f"demo CP score {score}")
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    drain, launches = _cli_lines(argv, out, err, proc.returncode, 81)
    check(drain.get("exit") == 81, f"demo drain line {drain}")
    return {"cp_score": score, "drain": drain["drain"]}, launches, time.perf_counter() - t0


def phase_cli():
    """The port's command line on the card, each command a child process:
    ``cp --synthetic``, ``cir`` warm-started from its checkpoint, ``fitb``
    from the CIR checkpoint, ``export-torch`` (the .pth loads strictly into
    ``OutfitXModel`` and scores as the checkpoint does), ``pes --shards 2``
    (both shards read back), ``original-cp --synthetic`` at a small batch
    and ``demo --synthetic --max-age`` (one request, then exit 81)."""
    from outfitx_tpu_torch.core.config import OutfitXConfig
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
    from outfitx_tpu_torch.train.checkpoint import CheckpointManager

    root = ROOT / "build" / "chip_smoke" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--synthetic", "--epochs", "1", "--checkpoint-dir", str(root / "ckpt"),
              "--log-dir", str(root / "logs")]
    cfg = OutfitXConfig()
    runs, launches = {}, {}

    def run(name, argv):
        result, counts, seconds = _cli(argv)
        runs[name] = {"argv": argv, "seconds": seconds, "result": result, "launches": counts}
        launches[name] = counts
        return result

    cp = run("cp", ["cp", *common, "--batch-size", "256"])
    check(math.isfinite(cp["loss"]) and 0.0 <= cp["auc"] <= 1.0, f"cli cp {cp}")
    cp_final = root / "ckpt" / f"{cfg.model_name}-cp" / "final"
    cir = run("cir", ["cir", *common, "--batch-size", "256",
                      "--warm-start-from", str(cp_final)])
    check(math.isfinite(cir["loss"]) and "recall@1" in cir, f"cli cir {cir}")
    cir_final = root / "ckpt" / f"{cfg.model_name}-cir" / "final"
    fitb = run("fitb", ["fitb", *common, "--checkpoint-from", str(cir_final)])
    check(0.0 <= fitb["accuracy"] <= 1.0, f"cli fitb {fitb}")

    pth = root / "export" / "cp.pth"
    exported = run("export-torch", ["export-torch", "--params", str(cp_final), "--out", str(pth)])
    check(exported == {"exported": str(pth)}, f"cli export-torch {exported}")
    from_pth = OutfitXModel(cfg, device="cuda")
    from_pth.load_state_dict(torch.load(pth, weights_only=True)["model"], strict=True)
    from_ckpt = OutfitXModel(cfg, device="cuda")
    from_ckpt.load_state_dict(CheckpointManager(root, "x").restore(cp_final)["params"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    emb = torch.randn((64, 16, cfg.d_embed), generator=gen, device="cuda")
    mask = torch.arange(16, device="cuda")[None, :] >= torch.randint(
        2, 17, (64, 1), generator=gen, device="cuda")
    with torch.inference_mode():
        a, b = from_pth.cp_forward(emb, mask), from_ckpt.cp_forward(emb, mask)
    check(bool(torch.isfinite(a).all()) and torch.equal(a, b),
          "the exported .pth scores otherwise than its checkpoint")
    del from_pth, from_ckpt, emb

    pes_dir = root / "pes"
    pes = run("pes", ["pes", *common, "--shards", "2", "--synthetic-items", "256",
                      "--batch-size", "128", "--output-dir", str(pes_dir)])
    check((pes["items"], pes["shards"], len(pes["child_max_rss_mb"])) == (256, 2, 2),
          f"cli pes {pes}")
    ids, emb = _read_shards(pes_dir, cfg.model_name, "embedding_subset_", 2)
    check(sorted(ids) == [10_000 + i for i in range(256)], "cli pes shard ids")
    check(emb.shape == (256, cfg.d_embed) and bool(np.isfinite(emb).all()),
          f"cli pes embeddings {emb.shape}")

    ocp = run("original-cp", ["original-cp", *common, "--batch-size", "16", "--accum", "2"])
    check(math.isfinite(ocp["loss"]) and 0.0 <= ocp["auc"] <= 1.0, f"cli original-cp {ocp}")

    demo, counts, seconds = _cli_demo(root)
    runs["demo"] = {"seconds": seconds, "result": demo, "launches": counts}
    launches["demo"] = counts
    for name in ("cp", "cir", "original-cp"):
        check(launches[name]["masked_mha_bwd"] > 0, f"cli {name}: no backward launch")
    for name in ("cp", "cir", "fitb", "original-cp", "demo"):
        check(launches[name]["masked_mha_fwd"] > 0 and launches[name]["layernorm"] > 0,
              f"cli {name}: launches {launches[name]}")
    emit({"phase": "cli", "commands": runs})
    total = Counter()
    for counts in launches.values():
        total.update(counts)
    return dict(total)


def _big_catalog(n, d, seed):
    """A synthetic catalog of ``n`` items at width ``d`` with the structure
    of real embeddings: points of a 64-dimensional subspace plus small
    noise. Made on the card and copied to the host once."""
    from outfitx_tpu_torch.data.catalog import Catalog

    gen = torch.Generator(device="cuda").manual_seed(seed)
    basis = torch.randn((64, d), generator=gen, device="cuda") / 8.0
    emb = torch.zeros((n + 1, d), device="cuda")  # the last row is the PAD row
    step = 50_000
    for s in range(0, n, step):
        e = min(s + step, n)
        z = torch.randn((e - s, 64), generator=gen, device="cuda")
        emb[s:e] = z @ basis + 0.05 * torch.randn((e - s, d), generator=gen, device="cuda")
    item_ids = np.arange(1, n + 1, dtype=np.int64)
    return Catalog(
        item_ids=item_ids, embeddings=emb.cpu().numpy(),
        category_id=np.zeros(n, np.int32), semantic_category=np.zeros(n, np.int32),
        semantic_vocab=[""], id_to_row={int(i): r for r, i in enumerate(item_ids)},
    )


def phase_retrieval():
    """Whole-catalog retrieval at a real size: 300,000 items x 1536, above
    the default chunk threshold, top-10 neighbours of 8 items by the dense,
    chunked, int8 and int8-chunked routes of the engine; then a live update
    of 1,500 rows against a full requantisation."""
    from outfitx_tpu_torch.core.config import OutfitXConfig
    from outfitx_tpu_torch.ops.quantization import quantize_catalog
    from outfitx_tpu_torch.serve.engine import ServingEngine
    from outfitx_tpu_torch.serve.programs import sim_task

    cfg = OutfitXConfig()
    n, d, k = RETRIEVAL_ITEMS, cfg.d_embed, 10
    t0 = time.perf_counter()
    catalog = _big_catalog(n, d, seed=4)
    data_s = time.perf_counter() - t0
    queries = [int(i) for i in catalog.item_ids[:: n // RETRIEVAL_QUERIES][:RETRIEVAL_QUERIES]]
    qrows = torch.as_tensor([catalog.id_to_row[i] for i in queries], device="cuda")
    routes = {
        "dense": {"chunk_threshold": 1 << 30},
        "chunked": {},
        "int8": {"quantized": True, "chunk_threshold": 1 << 30},
        "int8_chunked": {"quantized": True},
    }
    out, answers, engines = {}, {}, {}
    for name, kw in routes.items():
        torch.cuda.empty_cache()
        eng = ServingEngine(model_cfg=cfg, catalog=catalog, device="cuda", **kw)
        check(eng._route.chunked == ("chunk_threshold" not in kw)
              and eng._route.quantized == ("quantized" in kw), f"route of {name}: {eng._route}")
        answers[name] = eng.similar_items_batch(queries, k=k)

        def call():
            return eng._run(sim_task, eng.catalog_dev, eng._qcat, eng._route, qrows, k + 1)

        call()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(call, iters=10, warmup=2)
        out[name] = {
            "ms": ms,
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - resident,
            "catalog_bytes": eng.catalog_dev.nbytes
            + (eng._qcat.nbytes if eng._qcat is not None else 0),
        }
        if name == "int8":
            engines[name] = eng
        else:
            del eng
    for name, ans in answers.items():
        check(all(len(a) == k for a in ans), f"{name}: an answer without {k} items")
        check(all(q not in _ids(a) for q, a in zip(queries, ans)),
              f"{name}: a query item among its own neighbours")
    dist_rel = 0.0
    for a, b in zip(answers["dense"], answers["chunked"]):
        check(_ids(a) == _ids(b), "the chunked route's rows differ from the dense route's")
        dist_rel = max(dist_rel, max(
            abs(x["score"] - y["score"]) / max(x["score"], 1e-6) for x, y in zip(a, b)
        ))
    check(dist_rel <= 1e-3, f"chunked distances off the dense ones by {dist_rel} relative")
    for a, b in zip(answers["int8"], answers["int8_chunked"]):
        check(_ids(a) == _ids(b), "the int8-chunked route's rows differ from the int8 route's")
    overlap = float(np.mean([
        len(set(_ids(a)) & set(_ids(b))) / k for a, b in zip(answers["dense"], answers["int8"])
    ]))
    check(overlap >= INT8_OVERLAP_MIN, f"int8 picks overlap the dense ones on {overlap}")

    # torch.topk alone at the distance matrix's shape: what an approximate
    # top-k kernel could save at most.
    d2 = torch.rand((RETRIEVAL_QUERIES, n), device="cuda")
    topk_ms = cuda_ms(lambda: torch.topk(d2, k + 1, largest=False), iters=20)

    # A live update of 1,500 rows (two buckets of 1,024, the second padded):
    # all three int8 fields equal a full requantisation bit for bit.
    eng = engines["int8"]
    rng = np.random.default_rng(5)
    rows = rng.choice(n, RETRIEVAL_UPDATE_ROWS, replace=False)
    vals = rng.normal(size=(RETRIEVAL_UPDATE_ROWS, d)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.update_items([int(catalog.item_ids[r]) for r in rows], vals)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    check(torch.equal(eng.catalog_dev[torch.as_tensor(rows, device="cuda")].cpu(),
                      torch.from_numpy(vals)), "updated rows differ on the device")
    full = quantize_catalog(eng.catalog_dev, n_rows=catalog.pad_row)
    for field in ("values", "scales", "sq_norms"):
        check(torch.equal(getattr(eng._qcat, field), getattr(full, field)),
              f"int8 {field} differ from a full requantisation after the update")
    del eng, engines, full
    torch.cuda.empty_cache()
    emit({
        "phase": "retrieval",
        "items": n, "d_embed": d, "queries": RETRIEVAL_QUERIES, "k": k,
        "chunk_threshold": 262_144, "data_s": data_s, "routes": out,
        "chunked_vs_dense_max_rel_dist": dist_rel, "int8_vs_dense_overlap": overlap,
        "topk_ms": topk_ms, "update_rows": RETRIEVAL_UPDATE_ROWS, "update_s": update_s,
        "int8_equals_full_requantisation": True,
    })



def _launch_bound(shape, backward: bool = False) -> bool:
    """A shape whose bound is a few microseconds: its kernel time is mostly
    launch latency, and one reading of it spreads."""
    return attention_bound(shape, torch.bfloat16, backward)[0] < LAUNCH_BOUND_MS


def _median_ms(fn, iters: int, turns: int):
    """(median, turns) of ``turns`` readings of cuda_ms."""
    got = [cuda_ms(fn, iters) for _ in range(turns)]
    return float(np.median(got)), got


def _bwd_timing(shape):
    """masked_mha_bwd at one bf16 shape: kernel, plain version, and the
    backward of ``scaled_dot_product_attention`` with the bool mask, timed
    as (forward + backward) - forward on the same inputs; at a launch-bound
    shape the kernel's medians of LAUNCH_BOUND_TURNS turns."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_bwd_cuda, mha_bwd_reference

    q, k, v, pad = attention_inputs(shape, torch.bfloat16, seed=7)
    g = torch.randn(shape, device="cuda").to(torch.bfloat16)
    keep = ~pad[:, None, None, :]
    iters = 200 if shape[0] <= 64 or _launch_bound(shape, True) else 20
    turns = LAUNCH_BOUND_TURNS if _launch_bound(shape, True) else 1
    bound, bound_by = attention_bound(shape, torch.bfloat16, backward=True)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=keep)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qr, kr, vr), g)

    ms, ms_turns = _median_ms(
        lambda: _masked_mha_bwd_cuda(q, k, v, pad, g, False), iters, turns
    )
    return {
        "shape": list(shape),
        "ms": ms,
        **({"ms_turns": ms_turns} if turns > 1 else {}),
        "plain_ms": cuda_ms(lambda: mha_bwd_reference(q, k, v, pad, g), iters),
        "library_ms": cuda_ms(sdpa_fwd_bwd, iters) - cuda_ms(sdpa, iters),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def _fwd_timing(shape, causal: bool = False, padded: bool = False):
    """masked_mha_fwd in bfloat16 at one shape, with the set transformer's
    padded keys (``padded``) or unpadded as the vision towers call it:
    kernel, plain version, SDPA on the same function as a bool mask
    (causal: the lower triangle) and the bound; at a launch-bound shape the
    kernel's medians of LAUNCH_BOUND_TURNS turns of 200 calls, else one
    reading of 20."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

    dt = torch.bfloat16
    if padded:
        q, k, v, pad = attention_inputs(shape, dt, seed=7)
    else:
        gen = torch.Generator(device="cuda").manual_seed(11)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3))
        pad = torch.zeros((shape[0], shape[2]), dtype=torch.bool, device="cuda")
    keep = ~pad[:, None, None, :]
    if causal:
        keep = keep & torch.ones(
            (shape[2], shape[2]), dtype=torch.bool, device="cuda"
        ).tril()
    bound, bound_by = attention_bound(shape, dt)
    iters, turns = (200, LAUNCH_BOUND_TURNS) if _launch_bound(shape) else (20, 1)
    ms, ms_turns = _median_ms(lambda: _masked_mha_cuda(q, k, v, pad, causal), iters, turns)
    return {
        "shape": list(shape), "causal": causal, "ms": ms,
        **({"ms_turns": ms_turns} if turns > 1 else {}),
        "plain_ms": cuda_ms(lambda: mha_reference(q, k, v, pad, causal), 3, warmup=1),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 5
        ),
        "bound_ms": bound, "bound_by": bound_by,
    }


def _tower_timing():
    """The three tower kernels in bfloat16 at the SigLIP towers' shapes at
    batch 2048: kernel, plain version, the PyTorch library calls for the same
    function, and the bound."""
    from outfitx_tpu_torch.ops.attn_block import _attn_block_cuda, attn_block_reference
    from outfitx_tpu_torch.ops.mlp import _mlp_fused_cuda, mlp_fused_reference

    dt = torch.bfloat16
    out = {
        f"masked_mha_fwd_{name}": _fwd_timing(shape, causal)
        for name, shape, causal in TOWER_MHA_TIMING
    }

    shape = ATTN_BLOCK_SHAPES[0]  # the text tower's block
    y, wqkv, bqkv, wo, pad, h, causal = attn_block_inputs(shape, dt, seed=12)
    b, l, d = y.shape
    scale = 1.0 / math.sqrt(d // h)
    w_in = wqkv.reshape(d, 3 * d).T.contiguous()
    b_in = bqkv.reshape(3 * d)
    wo_t = wo.T.contiguous()
    keep = ~pad[:, None, None, :]

    def block_library():
        qkv = F.linear(y, w_in, b_in).view(b, l, 3, h, d // h).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=keep)
        return F.linear(o.transpose(1, 2).reshape(b, l, d), wo_t)

    bound, bound_by = attn_block_bound(shape, dt)
    l2, l2_pr3 = attn_block_l2_bytes(shape)
    out["attn_block"] = {
        "shape": list(shape[:4]),
        "l2_bytes_per_launch": l2, "l2_bytes_per_launch_earlier_design": l2_pr3,
        "ms": cuda_ms(lambda: _attn_block_cuda(y, wqkv, bqkv, wo, pad, h, scale, causal), 5),
        "plain_ms": cuda_ms(
            lambda: attn_block_reference(y, wqkv, bqkv, wo, pad, h), 3, warmup=1
        ),
        "library_ms": cuda_ms(block_library, 5),
        "bound_ms": bound, "bound_by": bound_by,
    }
    del y

    for name, rows in (("text", 2048 * 64), ("vision", 2048 * 196)):
        shape = (rows, 768, 3072, "gelu_tanh")
        x, w1, b1, w2, b2, act = mlp_inputs(shape, dt, seed=13)
        w1t, w2t = w1.T.contiguous(), w2.T.contiguous()

        def mlp_library():
            return F.linear(F.gelu(F.linear(x, w1t, b1), approximate="tanh"), w2t, b2)

        bound, bound_by = mlp_bound(shape, dt)
        l2, l2_pr3 = mlp_l2_bytes(shape)
        out[f"mlp_fused_{name}"] = {
            "shape": list(shape[:3]), "act": act,
            "l2_bytes_per_launch": l2, "l2_bytes_per_launch_earlier_design": l2_pr3,
            "ms": cuda_ms(lambda: _mlp_fused_cuda(x, w1, b1, w2, b2, act), 3, warmup=1),
            "plain_ms": cuda_ms(
                lambda: mlp_fused_reference(x, w1, b1, w2, b2, act=act), 3, warmup=1
            ),
            "library_ms": cuda_ms(mlp_library, 5),
            "bound_ms": bound, "bound_by": bound_by,
        }
        del x
    torch.cuda.empty_cache()
    return out


def _alternating(a, b, turns: int):
    """``turns`` readings each of the measurements ``a`` and ``b``, taken in
    alternating order (a b, b a, a b, ...) so that a drift of the machine
    falls on both."""
    got_a, got_b = [], []
    for t in range(turns):
        pair = [(a, got_a), (b, got_b)]
        for measure, out in pair if t % 2 == 0 else pair[::-1]:
            out.append(measure())
    return got_a, got_b


def _layernorm_timing():
    """layernorm in bfloat16 at the set transformer's and the towers' row
    counts: kernel and ``F.layer_norm`` (its parameters cast to bfloat16
    once, outside the timed call) in LAYERNORM_TURNS alternating turns each,
    their medians, the plain version and the bound."""
    from outfitx_tpu_torch.ops.layernorm import _layer_norm_cuda, layer_norm_reference

    dt = torch.bfloat16
    out = {}
    for shape in LAYERNORM_TIMING_SHAPES:
        eps = LAYERNORM_EPS[shape[1]]
        x, weight, bias = layernorm_inputs(shape, dt, seed=14)
        w16, b16 = weight.to(dt), bias.to(dt)
        iters = 200 if shape[0] <= 1024 else 20
        bound, bound_by = layernorm_bound(shape, dt)
        kernel, library = _alternating(
            lambda: cuda_ms(lambda: _layer_norm_cuda(x, weight, bias, eps), iters),
            lambda: cuda_ms(lambda: F.layer_norm(x, (shape[1],), w16, b16, eps), iters),
            LAYERNORM_TURNS,
        )
        out["x".join(str(n) for n in shape)] = {
            "shape": list(shape), "eps": eps,
            "ms": float(np.median(kernel)),
            "plain_ms": cuda_ms(lambda: layer_norm_reference(x, weight, bias, eps), iters),
            "library_ms": float(np.median(library)),
            "ms_turns": kernel, "library_ms_turns": library,
            "bound_ms": bound, "bound_by": bound_by,
        }
        del x
    torch.cuda.empty_cache()
    return out


def _host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls back to back
    by the host clock, one synchronisation at the end."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _layernorm_host_time():
    """The layernorm wrapper against ``F.layer_norm`` at the serving bucket
    (136, 1536) bf16, host microseconds per call, in HOST_TURNS alternating
    turns each. The kernel's launch is shown cheaper only where its slowest
    turn beats the library's fastest."""
    from outfitx_tpu_torch.ops.layernorm import _layer_norm_cuda

    x, weight, bias = layernorm_inputs((136, 1536), torch.bfloat16, seed=15)
    w16, b16 = weight.to(torch.bfloat16), bias.to(torch.bfloat16)

    def kernel():
        _layer_norm_cuda(x, weight, bias, 1e-5)

    def library():
        F.layer_norm(x, (1536,), w16, b16, 1e-5)

    lib, ker = _alternating(lambda: _host_us(library), lambda: _host_us(kernel), HOST_TURNS)
    return {
        "shape": [136, 1536], "calls": HOST_CALLS,
        "layernorm_us": float(np.median(ker)), "f_layer_norm_us": float(np.median(lib)),
        "layernorm_us_turns": ker, "f_layer_norm_us_turns": lib,
        "layernorm_cheaper_shown": max(ker) < min(lib),
    }


def _int_mm_timing():
    """``torch._int_mm`` at INT_MM_SHAPE with the weight as the int8 forward
    keeps it ((N, K), passed transposed) and as a contiguous (K, N), beside
    ``torch.matmul`` in bfloat16 on the same shape, and the int8 bound."""
    m, k, n = INT_MM_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    w_kn = w.t().contiguous()
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    nbytes = m * k + k * n + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / INT8_OPS_PER_S * 1e3
    out = {
        "shape": list(INT_MM_SHAPE),
        "int_mm_ms": cuda_ms(lambda: torch._int_mm(x, w.t()), 20),
        "int_mm_kn_contiguous_ms": cuda_ms(lambda: torch._int_mm(x, w_kn), 10),
        "bf16_matmul_ms": cuda_ms(lambda: torch.matmul(xb, wb.t()), 20),
        "int8_bound_ms": max(t_bytes, t_ops),
        "int8_bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    del x, w, w_kn, xb, wb
    torch.cuda.empty_cache()
    return out


def _cp_score_latency(engine):
    """cp_score p50/p99 (ms, host clock) over 50 calls after 10 warm ones."""
    outfit = [int(i) for i in engine.catalog.item_ids[:4]]
    lat = []
    for _ in range(60):
        t0 = time.perf_counter()
        engine.cp_score(outfit)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[10:])
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99)), int(lat.size)


def _profile_split(profile):
    """A forward's device time by part: the int8 and the bfloat16 products,
    attention, LayerNorm, and the rest (the quantize and dequantize passes,
    bias and residual adds, activations, casts and copies)."""
    kinds = {k: v["device_ms"] for k, v in profile["by_kind"].items()}
    named = ("int8_matmul", "matmul", "masked_mha_fwd", "layernorm")
    return {
        "int8_products_ms": kinds.get("int8_matmul", 0.0),
        "bf16_products_ms": kinds.get("matmul", 0.0),
        "attention_ms": kinds.get("masked_mha_fwd", 0.0),
        "layernorm_ms": kinds.get("layernorm", 0.0),
        "quantize_dequantize_and_other_passes_ms": sum(
            v for k, v in kinds.items() if k not in named
        ),
    }


def _narrow_routes(profile, kinds):
    """The attention kernels of ``kinds`` that a profile shows, and whether
    each is the narrow route's."""
    names = [n for n in profile["attention_kernels"] if any(k in n for k in kinds)]
    return names, bool(names) and all("narrow" in n for n in names)


def _resnet_sbert_e2e():
    """The set transformer over resnet_sbert embeddings (d_embed 128, 16
    heads of Dh=8) end to end, random weights from seed 0: the CP forward at
    B=4096 and one CP train step at B=TRAIN_B x A=TRAIN_A (dropout 0.3) over
    a synthetic (CATALOG_ITEMS + 1, 128) table (unit rows, the zero PAD row
    last), each timed by the host clock around synchronised calls and
    profiled by kernel kind, with the attention kernels each launches by
    name and whether all of them are the narrow route's."""
    from outfitx_tpu_torch.core.config import (
        ItemEncoderConfig,
        OptimizerConfig,
        OutfitXConfig,
    )
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
    from outfitx_tpu_torch.train.optim import AdamW
    from outfitx_tpu_torch.train.state import TrainState
    from outfitx_tpu_torch.train.steps import cp_train_step

    cfg = OutfitXConfig(item_encoder=ItemEncoderConfig.for_type("resnet_sbert"))
    check(cfg.d_embed // cfg.transformer.n_heads == 8, "resnet_sbert heads are not Dh=8")
    b, l, d = 4096, cfg.max_outfit_len, cfg.d_embed
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randn((b, l, d), generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.randint(2, l + 1, (b,), generator=gen, device="cuda")
    mask = torch.arange(l, device="cuda")[None, :] >= lengths[:, None]
    model = OutfitXModel(cfg, device="cuda", seed=0)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.cp_forward(emb, mask), iters=10, warmup=3)
        fwd_profile = profile_call(lambda: model.cp_forward(emb, mask), names=True)
    del model, emb

    rng = np.random.default_rng(0)
    n = CATALOG_ITEMS
    table = rng.standard_normal((n + 1, d)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    table[n] = 0.0
    lengths = rng.integers(3, l + 1, (TRAIN_A, TRAIN_B))
    pads = np.arange(l)[None, None, :] >= lengths[..., None]
    rows = np.where(pads, n, rng.integers(0, n, (TRAIN_A, TRAIN_B, l)))
    batch = {
        "item_idx": torch.as_tensor(rows.astype(np.int32), device="cuda"),
        "mask": torch.as_tensor(pads, device="cuda"),
        "label": torch.as_tensor(
            rng.integers(0, 2, (TRAIN_A, TRAIN_B)).astype(np.float32), device="cuda"
        ),
    }
    catalog = torch.as_tensor(table, device="cuda")
    model = OutfitXModel(cfg, device="cuda", seed=0, trainable=True)
    state = TrainState.create(model, AdamW(model.parameters(), OptimizerConfig(), 1), seed=0)

    def step():
        return cp_train_step(state, catalog, batch)

    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = float(step()["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    check(math.isfinite(loss), f"non-finite resnet_sbert CP train loss {loss}")
    step_profile = profile_call(step, top=8, names=True)
    del model, state, catalog
    torch.cuda.empty_cache()
    fwd_names, fwd_narrow = _narrow_routes(fwd_profile, ("masked_mha_fwd",))
    step_names, step_narrow = _narrow_routes(
        step_profile, ("masked_mha_fwd", "masked_mha_bwd")
    )
    return {
        "d_embed": d, "head_dim": d // cfg.transformer.n_heads,
        "cp_forward_b4096_ms": fwd_ms, "cp_forward_outfits_per_s": b / (fwd_ms / 1e3),
        "cp_forward_b4096_profile": fwd_profile,
        "train_step": {"batch": TRAIN_B, "accumulation": TRAIN_A, "catalog_rows": n + 1},
        "train_step_ms": float(np.mean(times)), "train_step_ms_each": times,
        "train_step_loss": loss, "train_step_profile": step_profile,
        "attention_kernels": {"cp_forward": fwd_names, "train_step": step_names},
        "attention_kernels_narrow": {"cp_forward": fwd_narrow, "train_step": step_narrow},
    }


def phase_timing(engine, q8_engine):
    per_shape = {
        batch: _fwd_timing(shape, padded=True)
        for batch, shape in [(b, (b, 16, 17, 96)) for b in (8, TRAIN_B, 4096)]
        + list(PARALLEL_MHA_SHAPES.items())
    }
    bwd = {batch: _bwd_timing((batch, 16, 17, 96)) for batch in (8, TRAIN_B)}
    bwd["original_cp"] = _bwd_timing(OCP_BWD_SHAPES[0])
    bwd["resnet_sbert"] = _bwd_timing(NARROW_BWD_FULL)
    for key, shape in PARALLEL_MHA_SHAPES.items():
        bwd[key] = _bwd_timing(shape)

    cfg = engine.model_cfg
    b, l, d = 4096, cfg.max_outfit_len, cfg.d_embed
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randn((b, l, d), generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.randint(2, l + 1, (b,), generator=gen, device="cuda")
    mask = torch.arange(l, device="cuda")[None, :] >= lengths[:, None]
    model, q8_model = engine.cp_model, q8_engine.cp_model
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.cp_forward(emb, mask), iters=5, warmup=2)
        profile = profile_call(lambda: model.cp_forward(emb, mask))
        q8_ms = cuda_ms(lambda: q8_model.cp_forward(emb, mask), iters=5, warmup=2)
        q8_profile = profile_call(lambda: q8_model.cp_forward(emb, mask), top=12)
    del emb
    torch.cuda.empty_cache()
    p50, p99, n_lat = _cp_score_latency(engine)
    q8_p50, q8_p99, _ = _cp_score_latency(q8_engine)
    int_mm = _int_mm_timing()
    resnet_sbert = _resnet_sbert_e2e()
    for path, narrow in resnet_sbert["attention_kernels_narrow"].items():
        check(narrow, f"the resnet_sbert {path}'s attention kernels are not all the "
              f"narrow route's: {resnet_sbert['attention_kernels'][path]}")
    towers = _tower_timing()
    layernorm = _layernorm_timing()
    host = _layernorm_host_time()
    emit({
        "phase": "timing",
        "masked_mha_fwd": per_shape,
        "masked_mha_bwd": bwd,
        "towers": towers,
        "layernorm": layernorm,
        "cp_forward_b4096_ms": fwd_ms,
        "cp_forward_outfits_per_s": b / (fwd_ms / 1e3),
        "attention_share_of_cp_forward": (
            cfg.transformer.n_layers * per_shape[4096]["ms"] / fwd_ms
        ),
        "cp_forward_b4096_profile": profile,
        "cp_forward_b4096_split": _profile_split(profile),
        "cp_score_p50_ms": p50,
        "cp_score_p99_ms": p99,
        "cp_score_samples": n_lat,
        "int8": {
            "cp_forward_b4096_ms": q8_ms,
            "cp_forward_outfits_per_s": b / (q8_ms / 1e3),
            "cp_forward_b4096_split": _profile_split(q8_profile),
            "cp_forward_b4096_profile": q8_profile,
            "cp_score_p50_ms": q8_p50,
            "cp_score_p99_ms": q8_p99,
            "int_mm_vs_bf16_matmul": int_mm,
        },
        "layernorm_host_us_per_call": host,
        "resnet_sbert_set_transformer": resnet_sbert,
    })
    return per_shape, bwd, towers, layernorm, host


# ----------------------------------------------------------------- parallel --
# Sharded retrieval: the retrieval phase's catalog (300,000 items and the PAD
# row) over N shards on the one card; N = 2 and 4 pad its 300,001 rows.
SHARD_COUNTS = (1, 2, 4)
# Shard-sized products round the cross term elsewhere: distances agree to
# this share of |q|^2 + |p|^2 (the scale of their rounding), and of the
# distance (at least 1) in the engine's answers.
SHARD_DIST_RTOL = 1e-5
MESH_ENGINE_SHARDS = 4
MESH_SPARE_ROWS = 64
# Meshed training: one microbatch of the envelope (the collectives go
# through host memory under gloo on one card), 2 ranks a mesh.
PAR_B = 768
PAR_MESHES = [(1, 2, False), (2, 1, False), (2, 1, True)]
PAR_TOL = 1e-4  # float32 meshed step against the one-rank step
PAR_TIMED_STEPS = 3
PAR_CHILD_TIMEOUT_S = 300


def _shard_retrieval(cat, queries, n, k):
    """Top-k by retrieve_sharded / retrieve_quantized_sharded at each shard
    count against retrieve / retrieve_quantized on the same rows."""
    from outfitx_tpu_torch.core.mesh import MeshSpec, make_mesh
    from outfitx_tpu_torch.ops.quantization import quantize_catalog, retrieve_quantized
    from outfitx_tpu_torch.ops.retrieval import retrieve
    from outfitx_tpu_torch.ops.retrieval_sharded import (
        pad_rows_to_shards,
        retrieve_quantized_sharded,
        retrieve_sharded,
        shard_quantized,
        shard_rows,
    )

    qc_single = quantize_catalog(cat, n_rows=n)
    scale = 2.0 * (queries.float() ** 2).sum(dim=-1, keepdim=True)
    want = retrieve(queries, cat[:n], k)
    want_q = retrieve_quantized(queries, qc_single, k)
    out = {
        "single_ms": cuda_ms(lambda: retrieve(queries, cat[:n], k), 10),
        "single_int8_ms": cuda_ms(lambda: retrieve_quantized(queries, qc_single, k), 10),
    }
    del qc_single
    for n_shards in SHARD_COUNTS:
        mesh = make_mesh(MeshSpec(data=n_shards), devices=[torch.device("cuda", 0)] * n_shards)
        rows = pad_rows_to_shards(cat.shape[0], n_shards)
        padded = torch.cat([cat, cat.new_zeros((rows - cat.shape[0], cat.shape[1]))])
        sharded = shard_rows(padded, mesh)
        qc = shard_quantized(quantize_catalog(padded), mesh)
        del padded
        case = {"shards": n_shards, "rows": rows}
        for tag, fn, ref in (
            ("dense", lambda: retrieve_sharded(queries, sharded, k, mesh=mesh, n_rows=n), want),
            ("int8", lambda: retrieve_quantized_sharded(queries, qc, k, mesh=mesh, n_rows=n), want_q),
        ):
            d2, idx = fn()
            same = bool(torch.equal(idx, ref[1]))
            # d2 = |q|^2 + |p|^2 - 2 q.p: its rounding scales with the norms
            rel = float(((d2 - ref[0]).abs() / (ref[0].abs() + scale)).max())
            check(same, f"sharded {tag} top-{k} indices differ at {n_shards} shards")
            check(rel <= SHARD_DIST_RTOL, f"sharded {tag} distances off by {rel} at {n_shards}")
            check(int(idx.max()) < n, f"a padded row won at {n_shards} shards")
            case[f"{tag}_ms"] = cuda_ms(fn, 10)
            case[f"{tag}_dist_max_rel_err"] = rel
        out[f"shards_{n_shards}"] = case
        del sharded, qc
        torch.cuda.empty_cache()
    return out


def _synthetic_engine(cfg, **kw):
    """The serving demo's synthetic engine (2,000 items, pools of 1,000,
    random weights from seed 0), category 0's pool dropped so that its
    targets take the whole-catalog route."""
    from outfitx_tpu_torch.data.sampler import CandidatePools
    from outfitx_tpu_torch.data.synthetic import make_synthetic
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
    from outfitx_tpu_torch.serve.engine import ServingEngine

    data = make_synthetic(
        n_items=2000, d_embed=cfg.d_embed, n_outfits=256, max_len=cfg.max_outfit_len
    )
    sd = OutfitXModel(cfg, device="cuda", seed=0).state_dict()
    pools = None
    if not kw.get("quantized"):
        pools = CandidatePools.build(data.catalog, data.cir_valid, pool_size=1000, threshold=1)
        pools.pools.pop(0)
    return ServingEngine(
        model_cfg=cfg, catalog=data.catalog, cp_params=sd, cir_params=sd, pools=pools,
        device="cuda", spare_capacity=MESH_SPARE_ROWS, **kw,
    )


def _same_answers(got, want, what):
    """Equal CP scores and FITB picks; equal CIR and similar-item lists, but
    for a swap of two items whose distances tie within SHARD_DIST_RTOL."""
    check(got["cp"] == want["cp"] and list(got["cp_batch"]) == list(want["cp_batch"]),
          f"{what}: CP scores differ")
    check(got["fitb"] == want["fitb"], f"{what}: FITB picks differ")
    worst = 0.0
    for key in ("cir", "cir_batch", "sim"):
        for g, w in zip(got[key], want[key]):
            gs, ws = [x["score"] for x in g], [x["score"] for x in w]
            rel = float(np.max(np.abs(np.subtract(gs, ws)) / np.maximum(np.abs(ws), 1.0)))
            worst = max(worst, rel)
            check(rel <= SHARD_DIST_RTOL, f"{what}: {key} distances off by {rel}")
            for a, b, sa, sb in zip(g, w, gs, ws):
                check(a["item_id"] == b["item_id"] or abs(sa - sb) <= SHARD_DIST_RTOL * max(abs(sb), 1.0),
                      f"{what}: {key} answers differ beyond a tie")
    return worst


def _mesh_engine_check(cfg, catalog_kw):
    """The engine on a 4-shard mesh of the one card against the one-device
    engine: answers, then the same updates and appends, then answers."""
    from outfitx_tpu_torch.core.mesh import MeshSpec, make_mesh
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm

    mesh = make_mesh(
        MeshSpec(data=MESH_ENGINE_SHARDS), devices=[torch.device("cuda", 0)] * MESH_ENGINE_SHARDS
    )
    single = _synthetic_engine(cfg, **catalog_kw)
    meshed = _synthetic_engine(cfg, mesh=mesh, **catalog_kw)
    check(len(meshed.catalog_dev.shards) == MESH_ENGINE_SHARDS, "catalog not sharded")
    reqs = _requests(single.catalog, np.random.default_rng(5))
    want = _serve(single, reqs)
    torch.cuda.synchronize()
    masked_mha.launches = layer_norm.launches = 0
    t0 = time.perf_counter()
    got = _serve(meshed, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"masked_mha_fwd": masked_mha.launches, "layernorm": layer_norm.launches}
    forwards = _expected_forwards(meshed, reqs)
    want_launches = {
        "masked_mha_fwd": cfg.transformer.n_layers * forwards,
        "layernorm": _ln_per_forward(cfg) * forwards,
    }
    check(launches == want_launches, f"mesh engine launches {launches}, expected {want_launches}")
    before = _same_answers(got, want, "mesh engine")
    rng = np.random.default_rng(6)
    ids = [int(i) for i in rng.choice(single.catalog.item_ids[: single.catalog.n_items], 40, replace=False)]
    vals = rng.normal(size=(len(ids), cfg.d_embed)).astype(np.float32)
    new_ids = [9_900_001 + i for i in range(8)]
    new = rng.normal(size=(len(new_ids), cfg.d_embed)).astype(np.float32)
    for eng in (single, meshed):
        eng.update_items(ids, vals)
        eng.add_items(new_ids, new, category_ids=[i % 3 for i in range(len(new_ids))])
    reqs = _requests(single.catalog, np.random.default_rng(7))
    reqs = reqs[:5] + ([new_ids[0], ids[0]] + reqs[5],)
    after = _same_answers(_serve(meshed, reqs), _serve(single, reqs), "mesh engine after updates")
    rows = [meshed.lookup_row(i) for i in ids + new_ids]
    stored = meshed.catalog_dev[torch.as_tensor(rows, device="cuda")].float().cpu()
    check(torch.equal(stored, single.catalog_dev[torch.as_tensor(rows, device="cuda")].float().cpu()),
          "updated rows differ between the mesh and one-device engines")
    out = {
        "shards": MESH_ENGINE_SHARDS, "catalog_rows": int(meshed.catalog_dev.shape[0]),
        "requests_s": serve_s, "forwards": forwards, **{f"{k}_launches": v for k, v in launches.items()},
        "dist_max_rel_err_before_updates": before, "dist_max_rel_err_after_updates": after,
        "updated_rows": len(ids), "appended_items": len(new_ids),
    }
    del single, meshed
    torch.cuda.empty_cache()
    return out, launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(task, world, mesh=None):
    """``chip_smoke.py --parallel-worker`` in ``world`` child processes with
    the launcher's environment; each rank's last stdout line (JSON). Their
    output goes to files (a full pipe would stall a rank, and its group with
    it). When a rank fails the others, blocked in a collective, are killed;
    the failed ranks' stderr goes into the error."""
    import os

    port = _free_port()
    arg = json.dumps({"task": task, "mesh": mesh})
    logs = ROOT / "build" / "chip_smoke" / "ranks"
    logs.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    try:
        for r in range(world):
            env = dict(
                os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
            )
            out, err = (open(logs / f"{task}_{r}.{ext}", "w+") for ext in ("out", "err"))
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-worker", arg],
                cwd=ROOT, env=env, stdout=out, stderr=err, text=True,
            ))
        deadline = time.monotonic() + PAR_CHILD_TIMEOUT_S
        codes = [p.poll() for p in procs]
        while None in codes and not any(codes) and time.monotonic() < deadline:
            time.sleep(0.2)
            codes = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    failed = [
        f"rank {r} exited {p.returncode}: {err[-3000:]}"
        for r, (p, (_, err)) in enumerate(zip(procs, texts)) if p.returncode
    ]
    check(not failed, f"{task} {mesh}: " + " | ".join(failed))
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in texts]


def _par_batch(cfg, b, seed=0):
    """One global CP microbatch (A=1) and a CIR one with ragged negative
    masks (the first half of the rows keeps one valid negative of 10),
    made on the card from a seed: the same on every rank."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    l = cfg.max_outfit_len
    cat = torch.randn((CATALOG_ITEMS, cfg.d_embed), generator=gen, device="cuda")
    idx = torch.randint(0, CATALOG_ITEMS, (1, b, l), generator=gen, device="cuda")
    lengths = torch.randint(3, l + 1, (1, b, 1), generator=gen, device="cuda")
    mask = torch.arange(l, device="cuda")[None, None, :] >= lengths
    label = (torch.rand((1, b), generator=gen, device="cuda") < 0.5).float()
    neg_mask = torch.zeros((1, b, 10), dtype=torch.bool, device="cuda")
    neg_mask[:, : b // 2, 1:] = True
    cir = {
        "item_idx": idx, "mask": mask,
        "pos_idx": torch.randint(0, CATALOG_ITEMS, (1, b), generator=gen, device="cuda"),
        "neg_idx": torch.randint(0, CATALOG_ITEMS, (1, b, 10), generator=gen, device="cuda"),
        "neg_mask": neg_mask,
    }
    return cat, {"item_idx": idx, "mask": mask, "label": label}, cir


def _par_state(cfg, par, lr=1e-3):
    from outfitx_tpu_torch.core.config import OptimizerConfig
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
    from outfitx_tpu_torch.train.optim import AdamW
    from outfitx_tpu_torch.train.state import TrainState

    model = OutfitXModel(cfg, device="cuda", seed=0, trainable=True)
    if par is not None:
        model.shard_(par)
    opt = AdamW(model.parameters(), OptimizerConfig(learning_rate=lr, schedule="constant"), 10, par=par)
    return model, TrainState.create(model, opt, seed=0, par=par)


def _par_compare(par, model, single, out, out_single, what):
    """Loss, whole gradients and updated parameters of the meshed step
    against the one-rank step (rank 0 holds the one-rank model). An element
    whose one-rank gradient lies within the gradient check's tolerance of
    zero is left out of the parameters: an error the gradient check accepts
    can flip its sign, and Adam's first step moves it by lr either way."""
    grads, params = {}, {}
    for n, p in model.named_parameters():
        params[n] = par.full(p, p.data)
        if p.grad is not None:
            grads[n] = par.full(p, p.grad)
    if par.rank != 0:
        return None
    ref = dict(single.named_parameters())
    loss_err = abs(float(out["loss"]) - float(out_single["loss"]))
    grad_err = max(float((grads[n] - ref[n].grad).abs().max()) for n in grads)
    grad_scale = max(float(ref[n].grad.abs().max()) for n in grads)
    param_err, left_out = 0.0, 0
    for n in params:
        g = ref[n].grad
        sure = torch.ones_like(params[n], dtype=torch.bool) if g is None else g.abs() > PAR_TOL * grad_scale
        left_out += int((~sure).sum())
        if bool(sure.any()):
            param_err = max(param_err, float((params[n] - ref[n].data)[sure].abs().max()))
    check(loss_err <= PAR_TOL * max(1.0, abs(float(out_single["loss"]))),
          f"{what}: loss off by {loss_err}")
    check(grad_err <= PAR_TOL * grad_scale, f"{what}: gradients off by {grad_err} (max {grad_scale})")
    check(param_err <= PAR_TOL, f"{what}: parameters off by {param_err}")
    return {"loss": float(out["loss"]), "loss_abs_err": loss_err,
            "grad_max_abs_err": grad_err, "grad_max_abs": grad_scale,
            "param_max_abs_err": param_err, "param_elements_left_out": left_out,
            "param_elements": sum(t.numel() for t in params.values())}


def _mask_draw_ms(cfg, par):
    """Device ms of one step's dropout draws (A=1): each rank draws the
    global batch's masks and keeps its part; beside it, what draws at the
    rank's own shapes would take."""
    from outfitx_tpu_torch.core.rng import keep_mask

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = cfg.transformer
    s, d = cfg.max_outfit_len + 1, cfg.d_embed

    def draws(rows, ffn):
        for _ in range(t.n_layers):
            for width in (d, ffn, d):
                keep_mask(gen, t.dropout, (rows, s, width), "cuda")
        keep_mask(gen, t.dropout, (rows, d), "cuda")

    return {
        "global": cuda_ms(lambda: draws(PAR_B, t.d_ffn), 10),
        "rank_shapes": cuda_ms(lambda: draws(PAR_B // par.data, t.d_ffn // par.model), 10),
    }


def _recomputed_bytes(model, par, rows: int, micro: int) -> int:
    """The collective bytes that remat adds to a step on this rank: one
    more forward of the encoder layers a microbatch, so FSDP's all-gather
    of this rank's block of each layer matrix split over 'data' and, on a
    model axis, the g all-reduces of the rank's (rows, S, d) states in the
    compute dtype: two a layer, or one without dropout, where the
    recompute stops (checkpoint's early stop) before the FFN's g, whose
    output no backward needs."""
    from outfitx_tpu_torch.core.mesh import DATA_AXIS

    cfg = model.cfg
    gathered = 0
    if par.fsdp and par.data > 1:
        gathered = sum(
            p.numel() * p.element_size() for n, p in model.named_parameters()
            if n.startswith("transformer_encoder.layers.") and DATA_AXIS in p.mesh_axes
        )
    g = 0
    if par.model > 1:
        states = rows * (cfg.max_outfit_len + 1) * cfg.d_embed * model.compute_dtype.itemsize
        g = (2 if cfg.transformer.dropout else 1) * cfg.transformer.n_layers * states
    return micro * (gathered + g)


def _par_remat(cfg, par, cat, batch, plain_bytes):
    """The bfloat16 CP step at this mesh with remat ('full') against the
    plain step from the same weights and dropout seed: the loss and this
    rank's gradient blocks (bit-equal, or within REMAT_GRAD_REL), the
    launches, and the collective bytes, exactly the plain step's plus the
    recomputed forward collectives."""
    from outfitx_tpu_torch.train.steps import cp_train_step

    out, grads = {}, {}
    for tag, c in (("plain", cfg), ("remat", dataclasses.replace(cfg, remat=True))):
        model, state = _par_state(c, par)
        _reset_ocp_counts()
        moved = par.bytes_moved
        loss = float(cp_train_step(state, cat, batch)["loss"])
        torch.cuda.synchronize()
        out[tag] = {"loss": loss, "launches": _ocp_counts(),
                    "collective_bytes": par.bytes_moved - moved}
        grads[tag] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None}
        if tag == "remat":
            out["recomputed_bytes"] = _recomputed_bytes(model, par, batch["label"].shape[1] // par.data, 1)
        del model, state
    torch.cuda.empty_cache()
    check(out["plain"]["collective_bytes"] == plain_bytes,
          f"plain step bytes {out['plain']['collective_bytes']}, the counted step's {plain_bytes}")
    want = plain_bytes + out["recomputed_bytes"]
    check(out["remat"]["collective_bytes"] == want,
          f"remat step bytes {out['remat']['collective_bytes']}, expected {want}")
    for tag in ("plain", "remat"):
        want = _remat_launches(cfg, 1, remat=tag == "remat")
        check(out[tag]["launches"] == want, f"meshed {tag} launches {out[tag]['launches']}, expected {want}")
    out.update(_grad_errors(grads["remat"], grads["plain"]))
    out["loss_abs_err"] = abs(out["remat"]["loss"] - out["plain"]["loss"])
    check(out["loss_abs_err"] <= REMAT_GRAD_REL * abs(out["plain"]["loss"]),
          f"meshed remat loss {out['remat']['loss']} vs plain {out['plain']['loss']}")
    check(out["worst_grad_rel_err"] <= REMAT_GRAD_REL,
          f"meshed remat gradient of {out['worst_grad']} off by {out['worst_grad_rel_err']}")
    return out


def _parallel_mesh_worker(mesh):
    """One rank of a 2-rank mesh on the one card (gloo, CUDA tensors)."""
    import dataclasses as dc

    import torch.distributed as dist

    import outfitx_tpu_torch.models.outfit_transformer as ot
    from outfitx_tpu_torch.core.config import MeshConfig, OutfitXConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.parallel import setup_parallel
    from outfitx_tpu_torch.train.steps import cir_train_step, cp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    par = setup_parallel(MeshConfig(*mesh), "cuda")
    res = {"mesh": mesh, "backend": par.backend, "position": list(par.position)}
    cfg32 = OutfitXConfig(compute_dtype="float32")
    cat, cp, cir = _par_batch(cfg32, PAR_B)
    # float32: the meshed CP and CIR steps against the one-rank steps
    for task, step, batch in (("cp", cp_train_step, cp), ("cir", cir_train_step, cir)):
        model, state = _par_state(cfg32, par)
        out = step(state, cat, batch)
        single = out_single = None
        if par.rank == 0:
            single, state1 = _par_state(cfg32, None)
            out_single = step(state1, cat, batch)
        res[f"{task}_f32"] = _par_compare(par, model, single, out, out_single, f"{mesh} {task}")
        del model, state, single
        torch.cuda.empty_cache()
    valid = (~cir["neg_mask"][0]).sum(dim=1)
    res["cir_valid_negatives_by_data_rank"] = [
        int(valid[i * PAR_B // par.data:(i + 1) * PAR_B // par.data].sum()) for i in range(par.data)
    ]
    # bfloat16: launches (and their shapes) a rank, then the step's time
    cfg = OutfitXConfig()
    model, state = _par_state(cfg, par)
    shapes = Counter()
    real = ot.masked_mha

    def recorded(q, *a, **kw):
        shapes[tuple(q.shape)] += 1
        return real(q, *a, **kw)

    ot.masked_mha = recorded
    cp_train_step(state, cat, cp)  # warm
    torch.cuda.synchronize()
    masked_mha.launches = masked_mha.bwd_launches = layer_norm.launches = 0
    shapes.clear()
    moved = par.bytes_moved
    cp_train_step(state, cat, cp)
    torch.cuda.synchronize()
    ot.masked_mha = real
    res["launches"] = {"masked_mha_fwd": masked_mha.launches,
                       "masked_mha_bwd": masked_mha.bwd_launches,
                       "layernorm": layer_norm.launches}
    res["attention_shapes"] = [list(k) for k in shapes]
    res["collective_bytes_per_step"] = par.bytes_moved - moved
    n_layers = cfg.transformer.n_layers
    want = {"masked_mha_fwd": n_layers, "masked_mha_bwd": n_layers,
            "layernorm": _ln_per_forward(cfg)}
    check(res["launches"] == want, f"{mesh}: launches {res['launches']}, expected {want}")
    heads = cfg.transformer.n_heads // par.model
    b = PAR_B // par.data
    want_shape = [b, heads, cfg.max_outfit_len + 1, cfg.d_embed // cfg.transformer.n_heads]
    check(res["attention_shapes"] == [want_shape],
          f"{mesh}: attention at {res['attention_shapes']}, expected {want_shape}")
    if par.fsdp:
        res["remat"] = _par_remat(cfg, par, cat, cp, res["collective_bytes_per_step"])
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(PAR_TIMED_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp_train_step(state, cat, cp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["step_ms_each"] = times
    res["step_ms"] = float(np.mean(times))
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    res["dropout_masks_ms"] = _mask_draw_ms(cfg, par)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {k: res[k] for k in ("step_ms", "peak_memory_bytes", "launches")})
    res["ranks"] = ranks
    dist.destroy_process_group()
    return res


def _parallel_nccl_worker():
    """A one-rank NCCL group: the CP trainer at the reference envelope
    under the launcher's environment, as torchrun starts it."""
    import torch.distributed as dist

    from outfitx_tpu_torch.core.config import CPTrainConfig, OutfitXConfig
    from outfitx_tpu_torch.data.synthetic import make_synthetic
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.layernorm import layer_norm
    from outfitx_tpu_torch.train.cp_trainer import CPTrainer

    cfg = OutfitXConfig()
    data = make_synthetic(
        n_items=CATALOG_ITEMS, d_embed=cfg.d_embed, n_outfits=TRAIN_B * TRAIN_A * TRAIN_STEPS,
        outfit_len=(3, cfg.max_outfit_len), max_len=cfg.max_outfit_len, seed=0,
    )
    root = ROOT / "build" / "chip_smoke" / "nccl"
    shutil.rmtree(root, ignore_errors=True)
    tcfg = CPTrainConfig(
        n_epochs=1, batch_size=TRAIN_B, accumulation_steps=TRAIN_A,
        checkpoint_dir=str(root / "ckpt"), log_dir=str(root / "logs"),
    )
    with CPTrainer(tcfg, cfg, catalog=data.catalog, train_split=data.cp_train,
                   valid_split=data.cp_valid, device="cuda") as t:
        check(t.par is not None and t.par.backend == "nccl",
              f"backend {t.par and t.par.backend}, expected nccl")
        masked_mha.launches = masked_mha.bwd_launches = layer_norm.launches = 0
        t0 = time.perf_counter()
        valid = t.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = (masked_mha.launches, masked_mha.bwd_launches, layer_norm.launches)
        want = _expected_launches(cfg, t, TRAIN_STEPS)
        check(t.state.step == TRAIN_STEPS, f"NCCL CPTrainer took {t.state.step} steps")
        check(launches == want, f"NCCL CPTrainer launches {launches}, expected {want}")
        check(math.isfinite(valid["loss"]), f"NCCL CPTrainer loss {valid['loss']}")
        steps = t.state.step
        timing = _step_timing(t, profile=False)
        res = {
            "backend": t.par.backend, "world": dist.get_world_size(), "steps": steps,
            "batch": TRAIN_B, "accumulation": TRAIN_A, "run_s": run_s, "valid_loss": valid["loss"],
            "launches": dict(zip(("masked_mha_fwd", "masked_mha_bwd", "layernorm"), launches)),
            **timing,
        }
    dist.destroy_process_group()
    return res


def phase_parallel():
    """The device mesh on the one card: sharded retrieval at 1, 2 and 4
    shards, the 4-shard serving engine against the one-device engine, the
    meshed CP and CIR steps in 2-rank gloo groups against the one-rank
    step, and a one-rank NCCL group training at the envelope. Several
    ranks or shards share one card here: the times measure no scaling."""
    from outfitx_tpu_torch.core.config import OutfitXConfig

    cfg = OutfitXConfig()
    n, k = RETRIEVAL_ITEMS, 10
    catalog = _big_catalog(n, cfg.d_embed, seed=3)
    cat = torch.from_numpy(catalog.embeddings).to("cuda")
    del catalog
    queries = cat[torch.arange(0, n, n // RETRIEVAL_QUERIES, device="cuda")[:RETRIEVAL_QUERIES]]
    retrieval = _shard_retrieval(cat, queries, n, k)
    del cat, queries
    torch.cuda.empty_cache()
    engine_bf16, l1 = _mesh_engine_check(cfg, {"catalog_dtype": "bfloat16"})
    engine_int8, l2 = _mesh_engine_check(cfg, {"quantized": True})
    torch.cuda.empty_cache()
    train = {}
    counts = Counter(l1) + Counter(l2)
    for mesh in PAR_MESHES + _card_meshes(torch.cuda.device_count()):
        ranks = _run_ranks("mesh", mesh[0] * mesh[1], mesh)
        name = "data{}_model{}{}".format(mesh[0], mesh[1], "_fsdp" if mesh[2] else "")
        train[name] = ranks[0]
        for r in ranks:
            counts.update(r["launches"])
            if "remat" in r:
                counts.update(r["remat"]["remat"]["launches"])
    nccl = _run_ranks("nccl", 1)[0]
    counts.update(nccl["launches"])
    emit({
        "phase": "parallel",
        "note": "ranks and shards share one card: times measure no scaling",
        "cards": torch.cuda.device_count(),
        "sharded_retrieval": {"items": n, "queries": RETRIEVAL_QUERIES, "k": k, **retrieval},
        "mesh_engine_bf16": engine_bf16, "mesh_engine_int8": engine_int8,
        "train": train, "nccl_one_rank": nccl,
    })
    return dict(counts)


def _card_meshes(cards: int):
    """Meshes with one rank a card (NCCL) on a machine with several cards;
    none on one card. On several, the 2-rank meshes above take a card a
    rank too."""
    if cards < 2:
        return []
    meshes = [(cards, 1, False), (cards, 1, True), (1, cards, False)]
    if cards % 2 == 0 and cards > 2:
        meshes += [(2, cards // 2, False), (2, cards // 2, True)]
    return meshes


def _parallel_worker(arg: str) -> int:
    spec = json.loads(arg)
    res = _parallel_mesh_worker(spec["mesh"]) if spec["task"] == "mesh" else _parallel_nccl_worker()
    print(json.dumps(res), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    import outfitx_tpu_torch  # noqa: F401  (fails outside the repository)

    if sys.argv[1:2] == ["--parallel-worker"]:  # a rank of phase_parallel
        return _parallel_worker(sys.argv[2])

    # A reference states its float32 matmul and convolution precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("env", phase_env)
    timed("build", phase_build)
    if sys.argv[1:3] == ["--only", "dsv2"]:
        timed("dsv2", phase_dsv2)
        emit({"phase_seconds": seconds, "total": time.perf_counter() - started})
        return 0
    if sys.argv[1:3] == ["--only", "resnet"]:
        timed("resnet", phase_resnet)
        emit({"phase_seconds": seconds, "total": time.perf_counter() - started})
        return 0
    if sys.argv[1:3] == ["--only", "kimivl"]:
        timed("dsv2", phase_dsv2)
        timed("kimivl", phase_kimivl)
        emit({"phase_seconds": seconds, "total": time.perf_counter() - started})
        return 0
    max_err = timed("kernels", phase_kernels)
    engine, q8_engine, serve_launches = timed("serve", phase_serve)
    train_launches = timed("train", phase_train)
    precompute_launches = timed("precompute", phase_precompute)
    http_launches = timed("http", phase_http)
    timed("retrieval", phase_retrieval)
    ocp_launches = timed("original_cp", phase_original_cp)
    torch.cuda.empty_cache()  # the CLI's child processes share the card
    cli_launches = timed("cli", phase_cli)
    parallel_launches = timed("parallel", phase_parallel)
    timed("dsv2", phase_dsv2)
    timed("kimivl", phase_kimivl)
    resnet, max_err["resnet_nhwc"] = timed("resnet", phase_resnet)
    fwd, bwd, towers, layernorm, host = timed("timing", phase_timing, engine, q8_engine)
    rows = [
        ("masked_mha_fwd", "outfitx_tpu/ops/attention.py:76", fwd[8], {
            "at_b3072": fwd[TRAIN_B], "at_b4096": fwd[4096],
            "at_vision_tower": towers["masked_mha_fwd_vision_tower"],
            "at_clip_vision_tower": towers["masked_mha_fwd_clip_vision_tower"],
            "at_clip_text_tower": towers["masked_mha_fwd_clip_text_tower"],
            "at_minilm_text_tower": towers["masked_mha_fwd_minilm_text_tower"],
            "at_resnet_sbert_set_transformer":
                towers["masked_mha_fwd_resnet_sbert_set_transformer"],
            "at_original_cp_minilm": towers["masked_mha_fwd_original_cp_minilm"],
            "at_original_cp_set_transformer":
                towers["masked_mha_fwd_original_cp_set_transformer"],
            "at_parallel_tp_rank": fwd["tp"], "at_parallel_dp_rank": fwd["dp"],
        }),
        ("masked_mha_bwd", "outfitx_tpu/ops/attention.py:188", bwd[TRAIN_B], {
            "at_b8": bwd[8], "at_original_cp_set_transformer": bwd["original_cp"],
            "at_resnet_sbert_set_transformer_b3072": bwd["resnet_sbert"],
            "at_parallel_tp_rank": bwd["tp"], "at_parallel_dp_rank": bwd["dp"],
        }),
        ("attn_block", "outfitx_tpu/ops/attn_block.py:41", towers["attn_block"], {}),
        ("mlp_fused", "outfitx_tpu/ops/mlp.py:38", towers["mlp_fused_vision"], {
            "at_text_tower": towers["mlp_fused_text"],
        }),
        ("layernorm", "outfitx_tpu/ops/layernorm.py:33", layernorm["136x1536"], {
            "at_b4096": layernorm["69632x1536"], "at_b3072": layernorm["52224x1536"],
            "at_vision_tower": layernorm["401408x768"],
            "at_text_tower": layernorm["131072x768"],
            "at_minilm_text_tower": layernorm["131072x384"],
            "at_original_cp_minilm": layernorm["89600x384"],
            "at_original_cp_set_transformer": layernorm["5950x128"],
            "at_parallel_tp_rank": layernorm["13056x1536"],
            "at_parallel_dp_rank": layernorm["6528x1536"],
            "host_us_per_call_at_serving_bucket": host,
        }),
        ("resnet_nhwc", "none (XLA fuses the JAX tower's stem, BatchNorm, ReLU, adds and pool)",
         resnet["stem_conv_pool"], {
             "at_stem_pool": resnet["stem_pool"],
             "at_stem_bias_relu": resnet["bias_add_relu_stem"],
             "at_stage1_bias_add_relu": resnet["bias_add_relu_stage1"],
             "at_stage1_bias_relu": resnet["bias_relu_stage1"],
             "normalize": resnet["normalize"],
         }),
    ]
    by_path = {
        **serve_launches, **train_launches, **precompute_launches,
        "http": http_launches, "original_cp": ocp_launches,
        "parallel": parallel_launches,
    }
    for name, *_ in rows:
        check(all(counts.get(name, 0) > 0 for path, counts in by_path.items()
                  if name in counts) and any(name in c for c in by_path.values()),
              f"{name} was not launched on a main path that runs it")
    emit({"phase": "total", "seconds": time.perf_counter() - started,
          "phase_seconds": seconds})
    emit({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"outfitx_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(counts.get(name, 0) for counts in by_path.values()),
            "launches_by_path": {
                path: counts.get(name, 0) for path, counts in by_path.items()
            },
            # the CLI phase's child processes (pes's slices run in
            # grandchildren and are not counted)
            "launches_cli_children": cli_launches.get(name, 0),
            "max_abs_err": max_err[name],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            **more,
        }
        for name, replaces, main, more in rows
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
