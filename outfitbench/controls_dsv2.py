"""Readings that set the limits of ``correct`` at dsv2lite.train_ocp, the
cell whose driver ``controls.py`` does not build::

    python3 -m outfitbench.controls_dsv2 --seeds 11,12,13

For each seed, as ``controls.py`` does: the program's first steps as a
run's set-up drives them, the float8 control (the reference computed in
float8 e4m3, towers included) and the half-batch fault, each read against
the float32 reference and judged by the cell's limits, ``route_mismatch``
included (the control's top-6 sets against the float32 reference's).
``--program-only`` reads the program alone. The runs of the benchmark never
run this."""

from __future__ import annotations

import argparse
import json
import time

import torch

from outfitbench import registry
from outfitbench.controls import judged
from outfitbench.drivers import train, train_ocp_dsv2 as dsv2
from outfitbench.drivers.common import Context, release

CELL = "dsv2lite.train_ocp"


def _gaps(got, want, got_routes, want_routes):
    found = train.gaps(got, want)
    found[dsv2.ROUTE] = _routes(got_routes, want_routes).mismatch()
    return found


def _routes(program: list, want: dsv2.Routes) -> dsv2.Routes:
    r = dsv2.Routes()
    r.program, r.reference, r.real = program, want.reference, want.real
    return r


def readings(ctx: Context, program_only: bool = False):
    limits = ctx.params["limits"]
    mine = dsv2.Routes()
    job = dsv2.ocp_job(ctx, mine)
    got = train.first_steps(job.step, job.batches, job.optimizer, job.names,
                            ctx.params["ref_steps"], ctx.config["optimizer"]["b1"])
    names = job.names
    job.close()
    job = None
    release(ctx.device)
    want_routes = dsv2.Routes()
    want = dsv2.reference_readings(ctx, names, routes=want_routes)
    out = {"program": judged(_gaps(got, want, mine.program, want_routes), limits),
           "norms": train.norm_notes(got, want), "worst_leaves": train.worst_leaves(got, want)}
    if not program_only:
        for label, kw in (("control", {"low": True}), ("half_batch", {"half_loss": True})):
            theirs = dsv2.Routes()
            r = dsv2.reference_readings(ctx, names, routes=theirs, **kw)
            out[label] = judged(_gaps(r, want, theirs.reference, want_routes), limits)
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
