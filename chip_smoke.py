#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``outfitx_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
1. env      torch and CUDA versions, the card's name and power limit;
2. build    compile every CUDA kernel (forward and backward attention) with
            nvcc for sm_90a, one process per source, all started together;
3. kernels  each kernel against its plain PyTorch version on the card;
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
6. timing   kernel, plain version and the PyTorch library call at the
            serving bucket (B=8) and the training and throughput shapes; the
            CP forward's outfits/s at B=4096 and the cp_score latency.
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

KERNEL_SHAPES = [(8, 16, 17, 96), (4096, 16, 17, 96), (3, 4, 9, 16)]
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
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("random", ("distribution", "philox", "random")),
    ("reduce", ("reduce_kernel",)),
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
    report = _build.build(["masked_mha_fwd", "masked_mha_bwd"])
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


def _compare(got, ref, dtype):
    """(max |got - ref|, within the dtype's limit) for one output."""
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= F32_TOL).all())
    else:
        ok = bool((err <= BF16_REL * torch.clamp_min(ref.float().abs(), 1.0)).all())
    return float(err.max()), ok


def _cases():
    for si, shape in enumerate(BWD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                yield si, shape, dtype, causal


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
        tag = {"shape": list(shape), "dtype": str(dtype).split(".")[1], "causal": causal}
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
    emit({"phase": "kernels", "masked_mha_fwd": fwd_cases, "masked_mha_bwd": bwd_cases})

    def main_err(cases, shape):
        return next(
            c["max_abs_err"] for c in cases
            if c["shape"] == list(shape) and c["dtype"] == "bfloat16" and not c["causal"]
        )

    return {
        "masked_mha_fwd": main_err(fwd_cases, KERNEL_SHAPES[0]),
        "masked_mha_bwd": main_err(bwd_cases, (TRAIN_B, 16, 17, 96)),
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
    emit({
        "phase": "timing",
        "masked_mha_fwd": per_shape,
        "masked_mha_bwd": bwd,
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
    return per_shape, bwd


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
    fwd, bwd = phase_timing(engine)
    rows = [
        ("masked_mha_fwd", "outfitx_tpu/ops/attention.py:76", fwd[8], {
            "at_b3072": fwd[TRAIN_B], "at_b4096": fwd[4096],
        }),
        ("masked_mha_bwd", "outfitx_tpu/ops/attention.py:188", bwd[TRAIN_B], {
            "at_b8": bwd[8],
        }),
    ]
    emit({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"outfitx_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": serve_launches.get(name, 0) + train_launches[name],
            "launches_by_path": {
                "serve": serve_launches.get(name, 0), "train": train_launches[name],
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
