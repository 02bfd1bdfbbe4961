#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``outfitx_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

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
            scalar route, causal and not; layernorm at MiniLM's 131,072 x
            384 rows with eps 1e-12); the stream a wrapper hands its
            kernel is PyTorch's current one;
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
            attention and 12 LayerNorm launches a forward;
5. train    (a) one CP train step at full width (B=64, A=2, bf16) against
            the same step on the CPU in float32 from the same weights;
            (b) ``CPTrainer`` at the reference envelope (B=3072, A=4,
            dropout 0.3, d=1536, 6 layers) for 3 optimizer steps, a
            validation pass and the final checkpoint; (c) ``CIRTrainer``
            warm-started from that checkpoint for 2 steps at B=512 and one
            recall evaluation; the launch counts of (b) and (c) are checked;
            then the CP train step's time, outfits/s, peak memory, a
            profile by kernel and the attention backward's device ms a step;
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
9. timing   kernel, plain version and the PyTorch library call at the
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
            MiniLM's (2048,12,64,32) and at Dh=8, layernorm at 384.
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

KERNEL_SHAPES = [(8, 16, 17, 96), (4096, 16, 17, 96), (3, 4, 9, 16)]
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
# (d_embed 128, 16 heads: Dh=8, bfloat16 on the scalar route), causal and
# not. (shape, causal, tail-padded keys).
SLICE8_MHA_SHAPES = [
    ((64, 12, 64, 32), False, True),
    ((4096, 16, 17, 8), False, False), ((4096, 16, 17, 8), True, False),
]
# The forward's timing rows at the towers' lengths, batch 2048: SigLIP
# ViT-B/16, CLIP ViT-B/32, CLIP text (causal), MiniLM; and the set
# transformer over resnet_sbert embeddings at B=4096.
TOWER_MHA_TIMING = [
    ("vision_tower", (2048, 12, 196, 64), False),
    ("clip_vision_tower", (2048, 12, 50, 64), False),
    ("clip_text_tower", (2048, 8, 77, 64), True),
    ("minilm_text_tower", (2048, 12, 64, 32), False),
    ("resnet_sbert_set_transformer", (4096, 16, 17, 8), False),
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
]
# The bound shapes of the timing phase: B=4096 and B=3072 set-transformer
# rows, the vision and the text tower's rows at batch 2048, MiniLM's rows.
LAYERNORM_TIMING_SHAPES = [
    (69632, 1536), (52224, 1536), (401408, 768), (131072, 768), (136, 1536),
    (131072, 384),
]
LAYERNORM_EPS = {1536: 1e-5, 768: 1e-6, 384: 1e-12}
KERNELS = ["masked_mha_fwd", "masked_mha_bwd", "attn_block", "mlp_fused", "layernorm"]
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


def profile_call(fn, top: int = 10):
    """Device time by kernel over one call of ``fn``, from torch.profiler:
    the call's wall time, the device's busy time, the time by kernel kind
    and the ``top`` kernels."""
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
    return {
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


def _tower_kernel_checks():
    """The forward attention at tower lengths, attn_block and mlp_fused, each
    against its plain version on the card, float32 and bfloat16."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference
    from outfitx_tpu_torch.ops.attn_block import _attn_block_cuda, attn_block_reference
    from outfitx_tpu_torch.ops.mlp import _mlp_fused_cuda, mlp_fused_reference

    mha_cases, block_cases, mlp_cases = [], [], []
    shapes = [(shape, causal, False) for shape, causal in TOWER_MHA_SHAPES + FWD_TILE_SHAPES]
    for si, (shape, causal, tail) in enumerate(shapes + SLICE8_MHA_SHAPES):
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
    for si, (shape, eps) in enumerate(LAYERNORM_SHAPES):
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
    for dtype, eps in ((torch.float32, 1e-5), (torch.bfloat16, 1e-6)):
        x, weight, bias = layernorm_inputs((64, 17, 1536), dtype, seed=70)
        g = torch.randn(x.shape, device="cuda").to(dtype)
        xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
        want = torch.autograd.grad(layer_norm_reference(xr, wr, br, eps), (xr, wr, br), g)
        closed = layer_norm_bwd_reference(x, weight, bias, g, eps)
        xf, wf, bf = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
        through = torch.autograd.grad(LayerNormFn.apply(xf, wf, bf, eps), (xf, wf, bf), g)
        torch.cuda.synchronize()
        case = {"shape": list(x.shape), "eps": eps, "dtype": _dtype_name(dtype)}
        for name, a, f, r in zip(("dx", "dweight", "dbias"), closed, through, want):
            # dweight and dbias are float32 sums over 1,088 rows in another
            # order than autograd's: relative 1e-4 of the largest entry.
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
    """masked_mha_bwd against its plain version on the card at BWD_SHAPES
    and BWD_TILE_SHAPES, float32 and bfloat16, causal and not: dq, dk and
    dv finite and within the dtype's limit, masked keys' dk and dv exactly
    0."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_bwd_cuda, mha_bwd_reference

    cases = []
    for si, shape, dtype, causal in _cases(BWD_SHAPES + BWD_TILE_SHAPES):
        q, k, v, pad = attention_inputs(shape, dtype, seed=si)
        tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": causal}
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


def phase_kernels():
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

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
        "launch_stream": _stream_check(),
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

    pooled = sum(
        int(engine.catalog.category_id[engine.lookup_row(t)]) in engine.pools.pools
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
    return gpu, q8_engine, {
        "serve": {"masked_mha_fwd": launches, "layernorm": ln_launches,
                  "attn_block": block["attn_block_launches"]},
        "serve_int8": {"masked_mha_fwd": int8["masked_mha_launches"],
                       "layernorm": int8["layernorm_launches"]},
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
    check(int(final["opt_state"]["count"]) == TRAIN_STEPS, "checkpoint optimizer count")
    return t, {
        "batch": TRAIN_B, "accumulation": TRAIN_A, "steps": t.state.step,
        "dropout": cfg.transformer.dropout, "train_outfits": len(data.cp_train),
        "valid_outfits": len(data.cp_valid), "run_s": run_s,
        "train_loss": train[-1]["loss"], "valid": valid,
        "masked_mha_fwd_launches": launches[0],
        "masked_mha_bwd_launches": launches[1],
        "layernorm_launches": launches[2],
        "peak_memory_bytes": peak, "params_on_path": len(on_path),
        "checkpoint": "final round-trips",
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
    return {
        "batch": tcfg.batch_size, "steps": t.state.step, "run_s": run_s,
        "train_loss": train[-1]["loss"], "valid": valid,
        "pools": len(t._pools.pools), "pool_size": t._pools.pool_size,
        "masked_mha_fwd_launches": launches[0],
        "masked_mha_bwd_launches": launches[1],
        "layernorm_launches": launches[2],
    }


def _step_timing(cp_trainer):
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
    return {
        "train_step_ms": ms,
        "train_step_peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "train_step_ms_each": times,
        "trained_outfits_per_s": TRAIN_B * TRAIN_A / (ms / 1e3),
        "train_step_profile": profile_call(step, top=14),
    }


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
    cir = _cir_trainer_run(cfg, cir_data, cp_trainer, root)
    timing = _step_timing(cp_trainer)
    bwd_kind = timing["train_step_profile"]["by_kind"].get("masked_mha_bwd", {})
    timing["masked_mha_bwd_ms_per_step"] = bwd_kind.get("device_ms", 0.0)
    timing["masked_mha_bwd_launches_per_step"] = bwd_kind.get("calls", 0)
    emit({
        "phase": "train",
        "d_embed": cfg.d_embed, "n_layers": cfg.transformer.n_layers,
        "catalog_items": cp_data.catalog.n_items, "data_s": data_s,
        "step_check": step_check, "cp_trainer": cp, "cir_trainer": cir,
        **timing,
    })
    return {
        "masked_mha_fwd": cp["masked_mha_fwd_launches"] + cir["masked_mha_fwd_launches"],
        "masked_mha_bwd": cp["masked_mha_bwd_launches"] + cir["masked_mha_bwd_launches"],
        "layernorm": cp["layernorm_launches"] + cir["layernorm_launches"],
    }


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
    transformer at d_embed 128 (16 heads of Dh=8, the bfloat16 scalar
    attention route) scoring outfits drawn from those embeddings, card
    bfloat16 against CPU float32."""
    from outfitx_tpu_torch.core.config import ItemEncoderConfig, OutfitXConfig
    from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel

    model_cfg = OutfitXConfig(item_encoder=dataclasses.replace(
        ItemEncoderConfig.for_type("resnet_sbert"), text_model_name=""
    ))
    n_batches = -(-PRECOMPUTE_ITEMS // cfg.batch_size)
    result, runner, emb, counts, peak = _sweep(
        cfg, model_cfg, root / "resnet_sbert", PRECOMPUTE_ITEMS,
        {"masked_mha_fwd": 6 * n_batches, "attn_block": 0, "mlp_fused": 0},
    )
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



def _bwd_timing(shape):
    """masked_mha_bwd at one bf16 shape: kernel, plain version, and the
    backward of ``scaled_dot_product_attention`` with the bool mask, timed
    as (forward + backward) - forward on the same inputs."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_bwd_cuda, mha_bwd_reference

    q, k, v, pad = attention_inputs(shape, torch.bfloat16, seed=7)
    g = torch.randn(shape, device="cuda").to(torch.bfloat16)
    keep = ~pad[:, None, None, :]
    iters = 200 if shape[0] <= 64 else 20
    bound, bound_by = attention_bound(shape, torch.bfloat16, backward=True)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=keep)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qr, kr, vr), g)

    return {
        "shape": list(shape),
        "ms": cuda_ms(lambda: _masked_mha_bwd_cuda(q, k, v, pad, g, False), iters),
        "plain_ms": cuda_ms(lambda: mha_bwd_reference(q, k, v, pad, g), iters),
        "library_ms": cuda_ms(sdpa_fwd_bwd, iters) - cuda_ms(sdpa, iters),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def _tower_timing():
    """The three tower kernels in bfloat16 at the SigLIP towers' shapes at
    batch 2048: kernel, plain version, the PyTorch library calls for the same
    function, and the bound."""
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference
    from outfitx_tpu_torch.ops.attn_block import _attn_block_cuda, attn_block_reference
    from outfitx_tpu_torch.ops.mlp import _mlp_fused_cuda, mlp_fused_reference

    dt = torch.bfloat16
    out = {}

    # The towers' attention, unpadded as the vision towers call it; SDPA
    # gets the same function as a bool mask (causal: the lower triangle).
    for name, shape, causal in TOWER_MHA_TIMING:
        gen = torch.Generator(device="cuda").manual_seed(11)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3))
        pad = torch.zeros((shape[0], shape[2]), dtype=torch.bool, device="cuda")
        keep = ~pad[:, None, None, :]
        if causal:
            keep = keep & torch.ones(
                (shape[2], shape[2]), dtype=torch.bool, device="cuda"
            ).tril()
        bound, bound_by = attention_bound(shape, dt)
        out[f"masked_mha_fwd_{name}"] = {
            "shape": list(shape), "causal": causal,
            "ms": cuda_ms(lambda: _masked_mha_cuda(q, k, v, pad, causal), 5),
            "plain_ms": cuda_ms(lambda: mha_reference(q, k, v, pad, causal), 3, warmup=1),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 5
            ),
            "bound_ms": bound, "bound_by": bound_by,
        }
        del q, k, v

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


def phase_timing(engine, q8_engine):
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

    per_shape = {}
    for batch in (8, TRAIN_B, 4096):
        shape = (batch, 16, 17, 96)
        q, k, v, pad = attention_inputs(shape, torch.bfloat16, seed=7)
        keep = ~pad[:, None, None, :]
        iters = 200 if shape[0] <= 64 else 20
        bound, bound_by = attention_bound(shape, torch.bfloat16)
        per_shape[batch] = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: _masked_mha_cuda(q, k, v, pad, False), iters),
            "plain_ms": cuda_ms(lambda: mha_reference(q, k, v, pad), iters),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
                iters,
            ),
            "bound_ms": bound,
            "bound_by": bound_by,
        }
    bwd = {batch: _bwd_timing((batch, 16, 17, 96)) for batch in (8, TRAIN_B)}

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
    })
    return per_shape, bwd, towers, layernorm, host


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    import outfitx_tpu_torch  # noqa: F401  (fails outside the repository)

    # A reference states its float32 matmul and convolution precision.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_env()
    phase_build()
    max_err = phase_kernels()
    engine, q8_engine, serve_launches = phase_serve()
    train_launches = phase_train()
    precompute_launches = phase_precompute()
    http_launches = phase_http()
    phase_retrieval()
    fwd, bwd, towers, layernorm, host = phase_timing(engine, q8_engine)
    rows = [
        ("masked_mha_fwd", "outfitx_tpu/ops/attention.py:76", fwd[8], {
            "at_b3072": fwd[TRAIN_B], "at_b4096": fwd[4096],
            "at_vision_tower": towers["masked_mha_fwd_vision_tower"],
            "at_clip_vision_tower": towers["masked_mha_fwd_clip_vision_tower"],
            "at_clip_text_tower": towers["masked_mha_fwd_clip_text_tower"],
            "at_minilm_text_tower": towers["masked_mha_fwd_minilm_text_tower"],
            "at_resnet_sbert_set_transformer":
                towers["masked_mha_fwd_resnet_sbert_set_transformer"],
        }),
        ("masked_mha_bwd", "outfitx_tpu/ops/attention.py:188", bwd[TRAIN_B], {
            "at_b8": bwd[8],
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
            "host_us_per_call_at_serving_bucket": host,
        }),
    ]
    by_path = {
        **serve_launches, "train": train_launches, **precompute_launches,
        "http": http_launches,
    }
    for name, *_ in rows:
        check(all(counts.get(name, 0) > 0 for path, counts in by_path.items()
                  if name in counts) and any(name in c for c in by_path.values()),
              f"{name} was not launched on a main path that runs it")
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
