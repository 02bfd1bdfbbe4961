"""Command line (the port of ``outfitx_tpu/cli/main.py``), on argparse.

    python -m outfitx_tpu_torch.cli {cp,cir,fitb,original-cp,pes,demo,export-torch} ...

The commands, options, defaults and JSON output are the JAX CLI's; each
command builds the same configs as it (``_build_cfg``, ``_model_cfg``).
``--synthetic`` runs a task on generated data. ``--device {cuda,cpu}``
chooses the device and defaults to the card. ``--mesh-data`` and
``--mesh-model`` lay out the training mesh (``MeshConfig``), one process per
position: launch the command under ``torchrun --nproc_per_node N``.
``--remat`` recomputes the encoder layers' activations in the backward
(``OutfitXConfig.remat``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from outfitx_tpu_torch.core.config import (
    ENCODER_PAIRS,
    CIRTrainConfig,
    CPTrainConfig,
    FITBTrainConfig,
    ItemEncoderConfig,
    MeshConfig,
    OutfitXConfig,
    PrecomputeConfig,
)


def _synth(model_cfg: OutfitXConfig, n_outfits: int = 2048, seed: int = 0):
    from outfitx_tpu_torch.data.synthetic import make_synthetic

    return make_synthetic(
        n_items=max(2000, n_outfits),
        d_embed=model_cfg.d_embed,
        n_outfits=n_outfits,
        max_len=model_cfg.max_outfit_len,
        seed=seed,
    )


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or the CPU")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", choices=["train-valid", "test"], default=None,
                   help="default: train-valid (fitb: test)")
    p.add_argument("--synthetic", action="store_true", help="use generated data")
    p.add_argument("--dataset-dir", default="datasets/polyvore")
    p.add_argument("--polyvore-type", choices=["nondisjoint", "disjoint"],
                   default="nondisjoint")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--accum", type=int, default=None, help="gradient-accumulation steps")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--log-dir", default=None, help="metrics/log output dir")
    p.add_argument("--mesh-data", type=int, default=-1)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--encoder", choices=list(ENCODER_PAIRS),
                   default="siglip",
                   help="the item encoder's tower pair; original-cp takes resnet_sbert "
                   "(its default) or resnet_dsv2lite")
    p.add_argument("--resume", default=None, help="checkpoint tag/path to resume from")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of epoch 1, with the spans "
                   "outfitx.step, .forward, .ahead, .backward, .optimizer (and "
                   "for original-CP .stage, .gather, .encode) over its kernels, and "
                   "log each span's calls, host ms and device ms")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each encoder layer: keep its input and recompute "
                   "its activations in the backward, for less memory a step")
    p.add_argument("--save-every", type=int, default=None,
                   help="save a rolling 'latest' resume checkpoint every N epochs")
    _add_device(p)


def _resolve_mode(args, default: str = "train-valid") -> str:
    return args.mode or default


def _build_cfg(cls, args, **extra):
    overrides = dict(
        dataset_dir=args.dataset_dir,
        polyvore_type=args.polyvore_type,
        checkpoint_dir=args.checkpoint_dir,
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
        **extra,
    )
    if args.epochs is not None:
        overrides["n_epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.accum is not None:
        overrides["accumulation_steps"] = args.accum
    if args.log_dir is not None:
        overrides["log_dir"] = args.log_dir
    if args.save_every is not None:
        overrides["save_every_epochs"] = args.save_every
    cfg = cls(**overrides)
    if args.lr is not None:
        cfg = dataclasses.replace(
            cfg, optimizer=dataclasses.replace(cfg.optimizer, learning_rate=args.lr)
        )
    return cfg


def _model_cfg(args) -> OutfitXConfig:
    return OutfitXConfig(
        item_encoder=ItemEncoderConfig.for_type(args.encoder), remat=bool(args.remat)
    )


def _emit(result) -> None:
    print(json.dumps(result), flush=True)


# ---------------------------------------------------------------- commands --
def cmd_cp(args, parser) -> int:
    """Compatibility-prediction training/eval."""
    from outfitx_tpu_torch.train.cp_trainer import CPTrainer

    model_cfg = _model_cfg(args)
    cfg = _build_cfg(CPTrainConfig, args)
    kwargs = {}
    if args.synthetic:
        data = _synth(model_cfg)
        kwargs = dict(catalog=data.catalog, train_split=data.cp_train,
                      valid_split=data.cp_valid)
    with CPTrainer(cfg, model_cfg, _resolve_mode(args), device=args.device, **kwargs) as t:
        t.profile_dir = args.profile_dir
        if args.resume:
            t.resume(args.resume)
        result = t.run()
    _emit(result)
    return 0


def cmd_cir(args, parser) -> int:
    """Complementary-item-retrieval training/eval."""
    from outfitx_tpu_torch.train.cir_trainer import CIRTrainer

    model_cfg = _model_cfg(args)
    extra = {"warm_start_from": args.warm_start_from}
    if args.switch_to_hard_epoch is not None:
        extra["switch_to_hard_epoch"] = args.switch_to_hard_epoch
    cfg = _build_cfg(CIRTrainConfig, args, **extra)
    kwargs = {}
    if args.synthetic:
        data = _synth(model_cfg)
        kwargs = dict(catalog=data.catalog, train_split=data.cir_train,
                      valid_split=data.cir_valid,
                      pool_threshold=1)  # the small generated catalog
    # an explicit --pool-threshold wins in both modes
    if args.pool_threshold is not None:
        kwargs["pool_threshold"] = args.pool_threshold
    with CIRTrainer(cfg, model_cfg, _resolve_mode(args), device=args.device, **kwargs) as t:
        t.profile_dir = args.profile_dir
        if args.resume:
            t.resume(args.resume)
        result = t.run()
    _emit(result)
    return 0


def cmd_fitb(args, parser) -> int:
    """Fill-in-the-blank evaluation (test only)."""
    from outfitx_tpu_torch.train.fitb_trainer import FITBTrainer

    if _resolve_mode(args, default="test") != "test":
        parser.error("fitb supports --mode=test only")
    model_cfg = _model_cfg(args)
    cfg = _build_cfg(FITBTrainConfig, args, checkpoint_from=args.checkpoint_from)
    kwargs = {}
    if args.synthetic:
        data = _synth(model_cfg)
        kwargs = dict(catalog=data.catalog, test_split=data.fitb_test)
    with FITBTrainer(cfg, model_cfg, "test", device=args.device, **kwargs) as t:
        result = t.run()
    _emit(result)
    return 0


def cmd_original_cp(args, parser) -> int:
    """End-to-end CP, ResNet-18 and MiniLM (or DeepSeek-V2-Lite with
    ``--encoder resnet_dsv2lite``) inside the train step."""
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource

    headed = ENCODER_PAIRS[args.encoder].trainable_heads
    enc_cfg = ItemEncoderConfig.for_type(args.encoder if headed else "resnet_sbert")
    model_cfg = OutfitXConfig(item_encoder=enc_cfg)
    cfg = _build_cfg(CPTrainConfig, args)
    if args.batch_size is None:  # the reference's original-CP envelope
        cfg = dataclasses.replace(cfg, batch_size=350, accumulation_steps=10)
    kwargs = {}
    if args.synthetic:
        enc = ItemEncoderModel(enc_cfg, device=args.device)
        data = _synth(model_cfg, n_outfits=512)
        source = RawItemSource.synthetic(
            n_items=data.catalog.n_items, image_size=enc.image_size,
            text_len=16, vocab=enc.text_vocab_size,
        )
        kwargs = dict(encoder=enc, source=source, train_split=data.cp_train,
                      valid_split=data.cp_valid)
    with OriginalCPTrainer(cfg, model_cfg, _resolve_mode(args), device=args.device,
                           **kwargs) as t:
        result = t.run()
    _emit(result)
    return 0


def cmd_pes(args, parser) -> int:
    """Precompute-embedding sweep over the item catalog."""
    from outfitx_tpu_torch.train.precompute import PrecomputeRunner

    if args.shards > 1 and args.slice_index is None:
        _emit(_pes_sharded_parent(args.shards, args.argv))
        return 0
    model_cfg = _model_cfg(args)
    cfg = _build_cfg(PrecomputeConfig, args)
    runner = PrecomputeRunner(
        cfg, model_cfg, output_dir=args.output_dir,
        synthetic_items=args.synthetic_items if args.synthetic else 0,
        n_slices=args.shards, slice_index=args.slice_index or 0, device=args.device,
    )
    if args.weights:
        from outfitx_tpu_torch.models.pretrained import load_item_encoder_state_dict

        enc = runner.encoder
        enc.load_state_dict(
            load_item_encoder_state_dict(enc, args.weights, init_state=enc.state_dict())
        )
    _emit({**runner.run(), "max_rss_mb": _max_rss_mb()})
    return 0


def _max_rss_mb() -> float:
    import resource

    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)


def _pes_sharded_parent(shards: int, argv: List[str]) -> dict:
    """The sweep as ``shards`` child processes run one after another, each
    this command line with its slice index; each child's memory is
    returned to the system when it exits."""
    import subprocess
    import time

    t0 = time.perf_counter()
    totals = {"items": 0, "shards": 0}
    peaks = []
    for k in range(shards):
        cmd = [sys.executable, "-m", "outfitx_tpu_torch.cli", *argv, "--slice-index", str(k)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"pes slice {k}/{shards} failed:\n{proc.stderr[-2000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        totals["items"] += child.get("items", 0)
        totals["shards"] += child.get("shards", 0)
        peaks.append(child.get("max_rss_mb"))
    dt = time.perf_counter() - t0
    return {
        **totals,
        "seconds": round(dt, 2),
        "items_per_sec": round(totals["items"] / max(dt, 1e-9), 1),
        "child_max_rss_mb": peaks,
        "parent_max_rss_mb": _max_rss_mb(),
    }


def cmd_demo(args, parser) -> int:
    """The serving demo (HTTP, port 6006)."""
    from outfitx_tpu_torch.serve.app import build_engine, serve

    engine = build_engine(
        synthetic=args.synthetic, mock=args.mock, quantized=args.quantized,
        dataset_dir=args.dataset_dir, polyvore_type=args.polyvore_type,
        checkpoint_dir=args.checkpoint_dir, quantize_model=args.quantize_model,
        exact_topk=args.exact_topk, catalog_dtype=args.catalog_dtype,
        spare_capacity=args.spare_capacity, shard_catalog=args.shard_catalog,
        device=args.device,
    )
    serve(
        port=args.port, engine=engine, mock=args.mock, coalesce_ms=args.coalesce_ms,
        max_rss_mb=None if args.max_rss_gb is None else args.max_rss_gb * 1024.0,
        max_age_s=args.max_age_s, device=args.device,
    )
    return 0


def cmd_export_torch(args, parser) -> int:
    """Export trained parameters to the reference system's .pth format."""
    from outfitx_tpu_torch.models.export_torch import export_reference_checkpoint

    out = export_reference_checkpoint(args.params_path, args.out_path,
                                      towers_from=args.towers_from)
    _emit({"exported": str(out)})
    return 0


# ------------------------------------------------------------------ parser --
def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m outfitx_tpu_torch.cli", description="OutfitX (PyTorch) command line."
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, fn, common=True):
        p = sub.add_parser(name, help=fn.__doc__.splitlines()[0])
        if common:
            _add_common(p)
        p.set_defaults(fn=fn)
        return p

    command("cp", cmd_cp)
    p = command("cir", cmd_cir)
    p.add_argument("--warm-start-from", default=None, help="CP checkpoint path")
    p.add_argument("--switch-to-hard-epoch", type=int, default=None)
    p.add_argument("--pool-threshold", type=int, default=None,
                   help="large-category eligibility threshold for retrieval eval "
                   "(default: candidate_pool_size=3000, the reference rule)")
    p = command("fitb", cmd_fitb)
    p.add_argument("--checkpoint-from", default=None, help="CIR checkpoint path")
    command("original-cp", cmd_original_cp)
    p = command("pes", cmd_pes)
    p.add_argument("--output-dir", default=None, help="embedding shard output dir")
    p.add_argument("--weights", default=None,
                   help="HF checkpoint dir with pretrained tower weights")
    p.add_argument("--shards", type=int, default=1,
                   help="split the sweep over N child processes run one after "
                   "another, each writing shard {model}_embedding_subset_{k}.pkl")
    p.add_argument("--slice-index", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--synthetic-items", type=int, default=4096,
                   help="catalog size for --synthetic sweeps")

    p = command("demo", cmd_demo, common=False)
    p.add_argument("--port", type=int, default=6006)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dataset-dir", default="datasets/polyvore")
    p.add_argument("--polyvore-type", choices=["nondisjoint", "disjoint"],
                   default="nondisjoint")
    p.add_argument("--checkpoint-dir", default="checkpoints",
                   help="dir holding the trained best_auc / best_recall@1 checkpoints")
    p.add_argument("--mock", action="store_true", help="UI smoke test with fake predictions")
    p.add_argument("--quantized", action="store_true",
                   help="int8 catalog for whole-catalog retrieval")
    p.add_argument("--quantize-model", action="store_true",
                   help="int8 W8A8 transformer forward (scores shift by the "
                   "quantization error)")
    p.add_argument("--exact-topk", action="store_true", help="exact top-k retrieval")
    p.add_argument("--coalesce-ms", type=float, default=None,
                   help="coalesce concurrent requests into one batched call "
                   "within this window")
    p.add_argument("--catalog-dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--spare-capacity", type=int, default=0,
                   help="reserve spare catalog rows for POST /api/add_items")
    p.add_argument("--shard-catalog", action="store_true",
                   help="row-shard the catalog over ALL local devices and retrieve via "
                   "per-shard top-k + merge (ops/retrieval_sharded.py); aggregate memory "
                   "scales with the device count")
    p.add_argument("--max-rss-gb", type=float, default=None,
                   help="drain and exit 81 when host RSS exceeds this")
    p.add_argument("--max-age", dest="max_age_s", type=float, default=None,
                   help="drain and exit 81 after this many seconds")
    _add_device(p)

    p = command("export-torch", cmd_export_torch, common=False)
    p.add_argument("--params", dest="params_path", required=True,
                   help="checkpoint dir (e.g. checkpoints/<run>/best_auc)")
    p.add_argument("--out", dest="out_path", required=True,
                   help=".pth output in the reference's checkpoint format")
    p.add_argument("--towers-from", default=None,
                   help="reference-side .pth holding the frozen item_encoder.* "
                   "tensors to merge for a strict load")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    args.argv = argv  # pes --shards re-runs this command line per slice
    return args.fn(args, parser)


if __name__ == "__main__":
    sys.exit(main())
