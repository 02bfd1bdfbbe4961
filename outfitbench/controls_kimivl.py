"""Readings that set the limits of ``correct`` at kimivl.train_ocp::

    python3 -m outfitbench.controls_kimivl --seeds 11,12,13

For each seed, as ``controls_dsv2.py`` does for its cell: the program's
first steps as a run's set-up drives them, the float8 control (the
reference computed in float8 e4m3, the encoder included) and the
half-batch fault, each read against the float32 reference and judged by
the cell's limits, ``route_mismatch`` and ``token_gap`` included. ``--program-only`` reads
the program alone. The runs of the benchmark never run this."""

from __future__ import annotations

import argparse
import json
import time

import torch

from outfitbench import registry
from outfitbench.controls import judged
from outfitbench import controls_dsv2
from outfitbench.drivers import train, train_ocp_kimivl as kimivl
from outfitbench.drivers.common import Context, release

CELL = "kimivl.train_ocp"


def _gaps(got, want, got_routes, got_tokens, readout: kimivl.Readout):
    found = controls_dsv2._gaps(got, want, got_routes, readout)
    found[kimivl.TOKENS] = kimivl.token_gap(got_tokens, readout.reference_tokens,
                                            readout.real_items)
    return found


def readings(ctx: Context, program_only: bool = False):
    limits = ctx.params["limits"]
    mine = kimivl.Readout()
    job = kimivl.ocp_job(ctx, mine)
    got = train.first_steps(job.step, job.batches, job.optimizer, job.names,
                            ctx.params["ref_steps"], ctx.config["optimizer"]["b1"])
    names = job.names
    job.close()
    job = None
    release(ctx.device)
    want_routes = kimivl.Readout()
    want = kimivl.reference_readings(ctx, names, routes=want_routes)
    out = {"program": judged(_gaps(got, want, mine.program, mine.tokens, want_routes), limits),
           "norms": train.norm_notes(got, want), "worst_leaves": train.worst_leaves(got, want)}
    if not program_only:
        for label, kw in (("control", {"low": True}), ("half_batch", {"half_loss": True})):
            theirs = kimivl.Readout()
            r = kimivl.reference_readings(ctx, names, routes=theirs, **kw)
            out[label] = judged(_gaps(r, want, theirs.reference, [theirs.reference_tokens],
                                      want_routes), limits)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    bench = registry.load()
    cell = registry.cell(bench, CELL)
    params = registry.workload(CELL)
    config = registry.config(bench, cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(cell=cell, config=config, params=params, seed=seed,
                      seconds=bench["run_seconds"], trace=False, started=t0, device="cuda")
        out = readings(ctx, args.program_only)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **out}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
