"""Readings that set the limits of ``correct``, at a cell's own size::

    python3 -m outfitbench.controls --workload siglip.train_cp --seeds 11,12,13

For each seed it builds the cell's training job as a run does, drives it
through its first steps, and prints one JSON line with the numbers the
cell compares, each read against the float32 reference and held against
the cell's limits (``correct``), three ways:

- ``program``: the program, as a run's set-up reads it;
- ``control``: the reference put in the program's place and computed in
  float8 (e4m3, a scale a tensor, forward and backward), the precision
  below the configuration's bfloat16;
- ``half_batch``: the reference put in the program's place with a fault
  planted: every outfit scored, the loss and gradient over the first half
  of each microbatch, the mean taken over it. (A step that returns its
  state unchanged reads 1 on ``change_gap`` and ``grad_gap`` by their
  definition, and needs no run.)

``--program-only`` reads the program alone (a dozen seeds in one process);
``--float32`` runs the program in float32 with TF32 off, a witness that
sides with the reference where the bfloat16 program does not.
The runs of the benchmark never run this."""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time

import torch

from outfitbench import registry
from outfitbench.drivers import train, train_ocp
from outfitbench.drivers.common import Check, Context, release
from outfitbench.reference.numerics import exact_float32

JOBS = {"train": train.cp_job, "train_ocp": train_ocp.ocp_job}


def judged(found, limits):
    """The gaps with each compared number's check and ``correct``."""
    checks = [Check(k, found[k], limits[k]) for k in limits]
    return dict(found, failed=[c.name for c in checks if not c.ok],
                correct=all(c.ok for c in checks))


@contextlib.contextmanager
def float32_program(d_out: int):
    """The program in float32 with TF32 off, towers included (the original-CP
    trainer builds its towers in bfloat16 whatever the configuration says)."""
    from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
    from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
    from outfitx_tpu_torch.train import original_cp_trainer

    encoder = original_cp_trainer.ItemEncoderModel
    original_cp_trainer.ItemEncoderModel = functools.partial(
        encoder, vision_cfg=ResNet18Config(d_out=d_out, compute_dtype="float32"),
        text_cfg=MiniLMConfig(d_out=d_out, compute_dtype="float32"))
    try:
        with exact_float32():
            yield
    finally:
        original_cp_trainer.ItemEncoderModel = encoder


def program(ctx: Context):
    """The program's first steps as a run's set-up drives them: (readings,
    the trainable parameters' names, the reference)."""
    job = JOBS[ctx.params["driver"]](ctx)
    got = train.first_steps(job.step, job.batches, job.optimizer, job.names,
                            ctx.params["ref_steps"], ctx.config["optimizer"]["b1"])
    names, reference = job.names, job.reference
    job.close()
    job = None
    release(ctx.device)
    return got, names, reference


def readings(ctx: Context, program_only: bool = False, exact: bool = False):
    """{'program', 'control', 'half_batch'}: each the gaps to the reference,
    judged by the cell's limits."""
    limits = ctx.params["limits"]
    exact = float32_program(ctx.config["dim_per_modality"]) if exact else contextlib.nullcontext()
    with exact:
        got, names, reference = program(ctx)
    want = reference(ctx, names)
    out = {"program": judged(train.gaps(got, want), limits),
           "norms": train.norm_notes(got, want), "worst_leaves": train.worst_leaves(got, want)}
    if not program_only:
        out["control"] = judged(train.gaps(reference(ctx, names, low=True), want), limits)
        out["half_batch"] = judged(train.gaps(reference(ctx, names, half_loss=True), want), limits)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args(argv)
    bench = registry.load()
    cell = registry.cell(bench, args.workload)
    params = registry.workload(cell["name"])
    config = registry.config(bench, cell["config"])
    if args.float32:
        config = dict(config, compute_dtype="float32")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(cell=cell, config=config, params=params, seed=seed,
                      seconds=bench["run_seconds"], trace=False, started=t0, device="cuda")
        out = readings(ctx, args.program_only, exact=args.float32)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **out}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
