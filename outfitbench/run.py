"""Run one cell of the benchmark once and print its result line::

    python3 -m outfitbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with a code other than 0, and prints no result, where the cards the
cell asks for are missing, or where ``jax``, ``jaxlib``, ``flax`` or
``outfitx_tpu`` is loaded once the window has closed. The last lines on
standard error, and the result line's last key ``check``, give each number
the comparison with the reference read beside its limit."""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from outfitbench import registry  # noqa: E402
from outfitbench.trace import breakdown  # noqa: E402

BANNED = frozenset({"jax", "jaxlib", "flax", "outfitx_tpu"})


def banned_modules(banned=BANNED, modules=None):
    """Top-level names of ``modules`` (``sys.modules``) that are banned,
    compared whole: ``outfitx_tpu_torch`` is not ``outfitx_tpu``."""
    names = list(sys.modules) if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(banned))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _caches():
    """Build and kernel caches at fixed paths inside the checkout. The
    program's own nvcc builds go to build/outfitx_tpu_torch/."""
    build = registry.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def result_line(bench, cell, outcome, trace: bool, device: dict) -> dict:
    """The JSON object the run prints last."""
    metrics = {}
    if trace:
        for m in registry.per_layer(bench, cell["name"]):
            value = registry.reader(m["name"])(outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.record is not None and outcome.record.trace is not None:
        line["breakdown"] = breakdown(outcome.record.trace)
    line["check"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv=None) -> int:
    args = _parse(argv)
    bench = registry.load()
    cell = registry.cell(bench, args.workload)
    _caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from outfitbench.drivers.common import Context

    params = registry.workload(cell["name"])
    ctx = Context(cell=cell, config=registry.config(bench, cell["config"]), params=params,
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace), started=STARTED)
    outcome = registry.driver(params["driver"]).run(ctx)
    found = banned_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    if args.trace:
        tr = outcome.record.trace
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    line = result_line(bench, cell, outcome, bool(args.trace), device)
    for key, value in sorted(outcome.notes.items()):
        print(f"note {key} {value}", file=sys.stderr)
    for c in outcome.checks:
        print(f"{c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
