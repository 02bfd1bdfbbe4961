#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``outfitx_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
1. env      torch and CUDA versions, the card's name and power limit;
2. build    compile every CUDA kernel of the serving path with nvcc (sm_90a);
3. kernels  each kernel against its plain PyTorch version on the card;
4. serve    the serving engine at full width (d=1536, 6 layers, 16 heads,
            random weights from seed 0) answers CP, CIR (both routes), FITB
            and similar-item requests; the kernel launch counts of that run
            are checked, and the answers are held against the same engine on
            the CPU in float32;
5. timing   kernel, plain version and the PyTorch library call at the
            serving bucket (B=8) and the throughput shape (B=4096); the CP
            forward's outfits/s at B=4096 and the cp_score latency.
Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without the last line. It needs a CUDA card
and the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

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


def cp_forward_profile(fn, top: int = 10):
    """Device time by kernel over one call of ``fn``, from torch.profiler:
    the call's wall time, the device's busy time, and the ``top`` kernels."""
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
    busy = sum(ms for ms, _ in rows.values())
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
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


def attention_bound(shape, dtype):
    """Least time (ms) for the function on these inputs: q, k, v read and
    out written once, plus the mask; 4*B*H*L*L*Dh operations (two products)
    at the dtype's peak."""
    b, h, l, dh = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * l * dh * elem + b * l
    ops = 4 * b * h * l * l * dh
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
    report = _build.build(["masked_mha_fwd"])
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


def phase_kernels():
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

    cases = []
    for si, shape in enumerate(KERNEL_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v, pad = attention_inputs(shape, dtype, seed=si)
                got = _masked_mha_cuda(q, k, v, pad, causal)
                ref = mha_reference(q, k, v, pad, causal)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got.float()).all()),
                      f"non-finite kernel output at {shape} {dtype}")
                err = (got.float() - ref.float()).abs()
                if dtype == torch.float32:
                    ok = bool((err <= F32_TOL).all())
                else:
                    lim = BF16_REL * torch.clamp_min(ref.float().abs(), 1.0)
                    ok = bool((err <= lim).all())
                case = {
                    "shape": list(shape), "dtype": str(dtype).split(".")[1],
                    "causal": causal, "max_abs_err": float(err.max()), "ok": ok,
                }
                cases.append(case)
                check(ok, f"masked_mha_fwd disagrees with its plain version: {case}")
    emit({"phase": "kernels", "cases": cases})
    main = next(
        c for c in cases
        if c["shape"] == list(KERNEL_SHAPES[0]) and c["dtype"] == "bfloat16"
        and not c["causal"]
    )
    return main["max_abs_err"]


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
    return gpu, launches


def phase_timing(engine):
    from outfitx_tpu_torch.ops.attention import _masked_mha_cuda, mha_reference

    per_shape = {}
    for shape in KERNEL_SHAPES[:2]:
        q, k, v, pad = attention_inputs(shape, torch.bfloat16, seed=7)
        keep = ~pad[:, None, None, :]
        iters = 200 if shape[0] <= 64 else 20
        bound, bound_by = attention_bound(shape, torch.bfloat16)
        per_shape[shape[0]] = {
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

    cfg = engine.model_cfg
    b, l, d = 4096, cfg.max_outfit_len, cfg.d_embed
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randn((b, l, d), generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.randint(2, l + 1, (b,), generator=gen, device="cuda")
    mask = torch.arange(l, device="cuda")[None, :] >= lengths[:, None]
    model = engine.cp_model
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.cp_forward(emb, mask), iters=5, warmup=2)
        profile = cp_forward_profile(lambda: model.cp_forward(emb, mask))

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
    return per_shape


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
    engine, launches = phase_serve()
    timing = phase_timing(engine)
    main_shape = timing[8]
    emit({"kernels": [{
        "name": "masked_mha_fwd",
        "route": "cuda",
        "source": "outfitx_tpu_torch/csrc/masked_mha_fwd.cu",
        "replaces": "outfitx_tpu/ops/attention.py:76",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_shape["ms"],
        "kernel_ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": main_shape["shape"],
        "at_b4096": timing[4096],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
