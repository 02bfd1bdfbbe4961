#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``outfitx_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
1. env      torch and CUDA versions, the card's name and power limit;
2. build    compile every CUDA kernel (forward and backward attention, the
            fused attention block, the fused tower MLP) with nvcc for
            sm_90a, one process per source, all started together;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the set transformer's shapes and at the towers' (attention at
            L=196, 50, 77 causal and 256; attn_block at the SigLIP text
            tower's 2048x64x768; mlp_fused at 131072x768x3072);
4. serve    the serving engine at full width (d=1536, 6 layers, 16 heads,
            random weights from seed 0) answers CP, CIR (both routes), FITB
            and similar-item requests; the kernel launch counts of that run
            are checked, and the answers are held against the same engine on
            the CPU in float32;
5. train    (a) one CP train step at full width (B=64, A=2, bf16) against
            the same step on the CPU in float32 from the same weights;
            (b) ``CPTrainer`` at the reference envelope (B=3072, A=4,
            dropout 0.3, d=1536, 6 layers) for 3 optimizer steps, a
            validation pass and the final checkpoint; (c) ``CIRTrainer``
            warm-started from that checkpoint for 2 steps at B=512 and one
            recall evaluation; the launch counts of (b) and (c) are checked;
            then the CP train step's time, outfits/s, peak memory and a
            profile by kernel;
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
7. timing   kernel, plain version and the PyTorch library call at the
            serving bucket (B=8), the training and throughput shapes and
            the towers' shapes at batch 2048; the CP forward's outfits/s at
            B=4096 and the cp_score latency.
Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without the last line. It needs a CUDA card
and the repository around it; it imports nothing of JAX. Checkpoints and
logs go under the checkout's ``build/chip_smoke/``.
"""

from __future__ import annotations

import dataclasses
import json
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
# attn_block (B, L, d, H, causal): the SigLIP text tower, the set transformer
# in eval, and a small causal case.
ATTN_BLOCK_SHAPES = [
    (2048, 64, 768, 12, False), (8, 17, 1536, 16, False), (3, 16, 64, 4, True),
]
# mlp_fused (rows, d, d_mlp, act): the SigLIP text tower's rows, the CLIP
# text tower's widths, and a ragged row count.
MLP_SHAPES = [
    (131072, 768, 3072, "gelu_tanh"), (4096, 512, 2048, "quick_gelu"),
    (1000, 64, 96, "gelu"),
]
KERNELS = ["masked_mha_fwd", "masked_mha_bwd", "attn_block", "mlp_fused"]
# Precompute: the JAX CLI's default synthetic catalog and PrecomputeConfig's
# batch; the fused-MLP pass and the CLIP pair run one smaller sweep each.
PRECOMPUTE_ITEMS = 4096
FUSED_ITEMS = 2048
CLIP_ITEMS = 64
CPU_CHECK_ITEMS = 32
# The backward is also held at the training envelope's microbatch.
BWD_SHAPES = KERNEL_SHAPES + [(3072, 16, 17, 96)]

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
# name; the first match wins, and what matches none is "other".
KERNEL_KINDS = (
    ("masked_mha_fwd", ("masked_mha_fwd",)),
    ("masked_mha_bwd", ("masked_mha_bwd",)),
    ("attn_block", ("attn_block",)),
    ("mlp_fused", ("mlp_fused",)),
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
    row, as the hash tokenizer pads a 64-token row, with row 0 fully masked."""
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


def phase_build():
    from outfitx_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build(KERNELS)
    ptxas = {
        name: [ln.strip() for ln in r["ptxas"].splitlines()
               if "registers" in ln or "spill" in ln]
        for name, r in report.items()
    }
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "per_kernel_seconds": {n: r["seconds"] for n, r in report.items()},
        "ptxas": ptxas,
    })


def _compare(got, ref, dtype, f32_tol=F32_TOL):
    """(max |got - ref|, within the dtype's limit) for one output."""
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= f32_tol).all())
    else:
        ok = bool((err <= BF16_REL * torch.clamp_min(ref.float().abs(), 1.0)).all())
    return float(err.max()), ok


def _cases():
    for si, shape in enumerate(BWD_SHAPES):
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
    for si, (shape, causal) in enumerate(TOWER_MHA_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pad = attention_inputs(shape, dtype, seed=20 + si)
            got = _masked_mha_cuda(q, k, v, pad, causal)
            ref = mha_reference(q, k, v, pad, causal)
            torch.cuda.synchronize()
            tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": causal}
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


def phase_kernels():
    from outfitx_tpu_torch.ops.attention import (
        _masked_mha_bwd_cuda,
        _masked_mha_cuda,
        mha_bwd_reference,
        mha_reference,
    )

    fwd_cases, bwd_cases = [], []
    for si, shape, dtype, causal in _cases():
        q, k, v, pad = attention_inputs(shape, dtype, seed=si)
        tag = {"shape": list(shape), "dtype": _dtype_name(dtype), "causal": causal}
        if shape in KERNEL_SHAPES:
            got = _masked_mha_cuda(q, k, v, pad, causal)
            ref = mha_reference(q, k, v, pad, causal)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"non-finite masked_mha_fwd output at {tag}")
            err, ok = _compare(got, ref, dtype)
            case = {**tag, "max_abs_err": err, "ok": ok}
            fwd_cases.append(case)
            check(ok, f"masked_mha_fwd disagrees with its plain version: {case}")

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
        bwd_cases.append(case)
        check(all(case[f"{n}_ok"] for n in ("dq", "dk", "dv")),
              f"masked_mha_bwd disagrees with its plain version: {case}")
        check(case["masked_keys_zero"], f"masked_mha_bwd: masked keys not zero: {case}")
    tower_mha, block_cases, mlp_cases = _tower_kernel_checks()
    fwd_cases += tower_mha
    emit({
        "phase": "kernels", "masked_mha_fwd": fwd_cases,
        "masked_mha_bwd": bwd_cases, "attn_block": block_cases,
        "mlp_fused": mlp_cases,
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


def phase_serve():
    from outfitx_tpu_torch.core.config import OutfitXConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
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

    masked_mha.launches = 0
    t0 = time.perf_counter()
    got = _serve(gpu, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = masked_mha.launches

    forwards = _expected_forwards(gpu, reqs)
    n_layers = cfg.transformer.n_layers
    check(launches == n_layers * forwards,
          f"masked_mha_fwd launched {launches} times for {forwards} forwards "
          f"of {n_layers} layers")
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

    emit({
        "phase": "serve",
        "d_embed": cfg.d_embed, "n_layers": n_layers,
        "n_heads": cfg.transformer.n_heads,
        "catalog_items": gpu.catalog.n_items,
        "pool_size": gpu.pools.pool_size,
        "engine_build_s": build_s, "requests_s": serve_s,
        "forwards": forwards, "masked_mha_launches": launches,
        "cp_prob_max_abs_err": cp_err, "cir_requests": len(cir_got),
        "cir_top1_agree": top1, "cir_top1_worst_rel_gap": worst_gap,
        "fitb_agree": fitb, "similar_overlap": overlap,
    })
    return gpu, {"masked_mha_fwd": launches}


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


def _expected_launches(n_layers, trainer, steps):
    """(forward, backward) launches of ``steps`` train steps and one
    validation sweep over the trainer's staged eval batches."""
    micro = trainer.cfg.accumulation_steps * steps
    return (
        n_layers * (micro + len(trainer._eval_batches)),
        n_layers * micro,
    )


def _cp_trainer_run(cfg, data, root):
    """(b): CPTrainer at the reference envelope."""
    from outfitx_tpu_torch.core.config import CPTrainConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
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
        masked_mha.launches = masked_mha.bwd_launches = 0
        t0 = time.perf_counter()
        valid = t.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = (masked_mha.launches, masked_mha.bwd_launches)
        peak = torch.cuda.max_memory_allocated()
        n_layers = cfg.transformer.n_layers
        want = _expected_launches(n_layers, t, TRAIN_STEPS)
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
        "peak_memory_bytes": peak, "params_on_path": len(on_path),
        "checkpoint": "final round-trips",
    }


def _cir_trainer_run(cfg, data, cp_trainer, root):
    """(c): CIRTrainer warm-started from the CP trainer's final checkpoint."""
    from outfitx_tpu_torch.core.config import CIRTrainConfig
    from outfitx_tpu_torch.ops.attention import masked_mha
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
        masked_mha.launches = masked_mha.bwd_launches = 0
        t0 = time.perf_counter()
        valid = t.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = (masked_mha.launches, masked_mha.bwd_launches)
        want = _expected_launches(cfg.transformer.n_layers, t, CIR_STEPS)
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
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.mean(times))
    return {
        "train_step_ms": ms,
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
    }


def _reset_tower_counts():
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.attn_block import attn_block
    from outfitx_tpu_torch.ops.mlp import mlp_fused

    masked_mha.launches = attn_block.launches = mlp_fused.launches = 0


def _tower_counts():
    from outfitx_tpu_torch.ops.attention import masked_mha
    from outfitx_tpu_torch.ops.attn_block import attn_block
    from outfitx_tpu_torch.ops.mlp import mlp_fused

    return {
        "masked_mha_fwd": masked_mha.launches,
        "attn_block": attn_block.launches,
        "mlp_fused": mlp_fused.launches,
    }


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
        },
        "clip": {
            "items": clip_result["items"], "launches": clip_counts,
            "min_cosine_vs_cpu_f32": cos_clip,
        },
        "batch_profile": profile,
    })
    return {
        "masked_mha_fwd": counts["masked_mha_fwd"] + fused_counts["masked_mha_fwd"]
        + clip_counts["masked_mha_fwd"],
        "attn_block": counts["attn_block"] + fused_counts["attn_block"],
        "mlp_fused": fused_counts["mlp_fused"],
    }


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

    shape = (2048, 12, 196, 64)  # the vision tower's attention
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3))
    pad = torch.zeros((shape[0], shape[2]), dtype=torch.bool, device="cuda")
    keep = ~pad[:, None, None, :]
    bound, bound_by = attention_bound(shape, dt)
    out["masked_mha_fwd"] = {
        "shape": list(shape),
        "ms": cuda_ms(lambda: _masked_mha_cuda(q, k, v, pad, False), 5),
        "plain_ms": cuda_ms(lambda: mha_reference(q, k, v, pad), 3, warmup=1),
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
    out["attn_block"] = {
        "shape": list(shape[:4]),
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
        out[f"mlp_fused_{name}"] = {
            "shape": list(shape[:3]), "act": act,
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


def phase_timing(engine):
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
    model = engine.cp_model
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.cp_forward(emb, mask), iters=5, warmup=2)
        profile = profile_call(lambda: model.cp_forward(emb, mask))

    outfit = [int(i) for i in engine.catalog.item_ids[:4]]
    lat = []
    for _ in range(60):
        t0 = time.perf_counter()
        engine.cp_score(outfit)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[10:])
    towers = _tower_timing()
    emit({
        "phase": "timing",
        "masked_mha_fwd": per_shape,
        "masked_mha_bwd": bwd,
        "towers": towers,
        "cp_forward_b4096_ms": fwd_ms,
        "cp_forward_outfits_per_s": b / (fwd_ms / 1e3),
        "attention_share_of_cp_forward": (
            cfg.transformer.n_layers * per_shape[4096]["ms"] / fwd_ms
        ),
        "cp_forward_b4096_profile": profile,
        "cp_score_p50_ms": float(np.percentile(lat, 50)),
        "cp_score_p99_ms": float(np.percentile(lat, 99)),
        "cp_score_samples": int(lat.size),
    })
    return per_shape, bwd, towers


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
    engine, serve_launches = phase_serve()
    train_launches = phase_train()
    precompute_launches = phase_precompute()
    fwd, bwd, towers = phase_timing(engine)
    rows = [
        ("masked_mha_fwd", "outfitx_tpu/ops/attention.py:76", fwd[8], {
            "at_b3072": fwd[TRAIN_B], "at_b4096": fwd[4096],
            "at_vision_tower": towers["masked_mha_fwd"],
        }),
        ("masked_mha_bwd", "outfitx_tpu/ops/attention.py:188", bwd[TRAIN_B], {
            "at_b8": bwd[8],
        }),
        ("attn_block", "outfitx_tpu/ops/attn_block.py:41", towers["attn_block"], {}),
        ("mlp_fused", "outfitx_tpu/ops/mlp.py:38", towers["mlp_fused_vision"], {
            "at_text_tower": towers["mlp_fused_text"],
        }),
    ]
    by_path = {
        "serve": serve_launches, "train": train_launches,
        "precompute": precompute_launches,
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
