"""Original-CP training at the reference envelope: raw items through the
frozen ResNet-18 and MiniLM towers and their trainable heads into the set
transformer every step. ``original_cp_train_step`` is fed as
``OriginalCPTrainer.train_epoch`` feeds it: ``step_selections`` and the
trainer's ``RawBatchStager``, which gathers each microbatch of raw items on
the host into pinned buffers. Weights, the raw item bank and the split are
drawn from the seed. The rest (first steps in set-up, the window, the
comparison) is the CP driver's (``train.run_job``)."""

from __future__ import annotations

import numpy as np
import torch

from outfitbench import flops, inputs
from outfitbench.drivers import train
from outfitbench.drivers.common import Context, Outcome, generator, program_config, release
from outfitbench.reference import optim as ref_optim, set_transformer as ref, towers
from outfitbench.reference.numerics import exact_float32


def make_inputs(cfg, params, seed: int, device):
    gen = generator(seed, device)
    (weights,) = inputs.make_params(cfg, gen, device)
    enc = inputs.encoder_params(cfg, gen, device)
    raw = inputs.raw_items(cfg["raw_items"], cfg, gen, device)
    inputs.calibrate(enc, raw[0])
    split = inputs.cp_split_arrays(params["outfits"], cfg["raw_items"], cfg["max_outfit_len"],
                                   params["outfit_len"], seed)
    return weights, enc, raw, split


def step_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The original-CP job's stated shuffle: numpy's generator on (seed,
    epoch, 7)."""
    return np.random.default_rng([seed, epoch, 7]).permutation(n)


def ocp_job(ctx: Context) -> train.Job:
    from outfitx_tpu_torch.core.config import CPTrainConfig, OptimizerConfig
    from outfitx_tpu_torch.data.splits import CPSplit
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    cfg, params = ctx.config, ctx.params
    weights, enc, (images, ids, attn), (rows, mask, labels) = make_inputs(
        cfg, params, ctx.seed, ctx.device)
    b, a = params["batch"], params["accumulation"]
    run_dir = train.RUN_DIR / ctx.cell["name"]
    tcfg = CPTrainConfig(
        seed=ctx.seed, n_epochs=cfg["epochs"], batch_size=b, accumulation_steps=a,
        optimizer=OptimizerConfig(**cfg["optimizer"]),
        checkpoint_dir=str(run_dir / "checkpoints"), log_dir=str(run_dir / "logs"),
        async_saves=False, focal_alpha=cfg["focal_alpha"], focal_gamma=cfg["focal_gamma"],
    )
    split = CPSplit(rows, mask, labels)
    trainer = OriginalCPTrainer(
        tcfg, program_config(cfg), "custom",
        source=RawItemSource(image_bank=images, input_ids=ids, attn=attn),
        train_split=split, valid_split=CPSplit(rows[:b], mask[:b], labels[:b]),
        device=ctx.device,
    )
    trainer.setup()
    trainer.model.load_state_dict(weights)
    trainer.encoder.load_state_dict(enc)
    del weights, enc
    release(ctx.device)
    state = trainer.state
    train_step = ctx.faults.get("step", original_cp_train_step)

    def selections():
        epoch = 0
        while True:
            yield from trainer.step_selections(split, epoch)
            epoch += 1

    def step(sels):
        return train_step(state, (trainer.microbatch(split, s) for s in sels),
                          alpha=cfg["focal_alpha"], gamma=cfg["focal_gamma"])

    return train.Job(
        step=step, batches=selections(), optimizer=state.optimizer,
        names=[n for n, p in trainer.net.named_parameters() if p.requires_grad],
        outfits_per_step=b * a, microbatches_per_step=a,
        derived={"step_flops": flops.original_cp_step_flops(cfg, b, a),
                 "attention_launches": flops.attention_launches(cfg, b, a, towers=True)},
        reference=reference_readings,
        counters=lambda: {"gather_s": trainer.stage.gather_s},
        close=lambda: trainer.__exit__(None, None, None),
    )


def run(ctx: Context) -> Outcome:
    return train.run_job(ctx, ocp_job(ctx))


def reference_readings(ctx: Context, names, low: bool = False, half_loss: bool = False):
    """The plain reference's first steps: each microbatch's raw items
    through the towers and heads, then the set transformer, focal loss and
    the update, with the job's dropout draws (``train.reference_readings``
    for the rest of the terms)."""
    cfg, params, dev = ctx.config, ctx.params, ctx.device
    weights, enc, (images, ids, attn), (rows, mask, labels) = make_inputs(
        cfg, params, ctx.seed, dev)
    p = {"model." + k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    p.update({"encoder." + k: v.detach().clone().requires_grad_(k in ("vision.fc.weight",
              "vision.fc.bias", "text.proj.weight", "text.proj.bias")) for k, v in enc.items()})
    del weights, enc
    st = {k[6:]: v for k, v in p.items() if k.startswith("model.")}
    en = {k[8:]: v for k, v in p.items() if k.startswith("encoder.")}
    leaves = [p[n] for n in names]
    a, b = params["accumulation"], params["batch"]
    opt = ref_optim.AdamW(leaves, cfg["optimizer"], train.total_steps(cfg, params))
    start = [t.detach().clone() for t in leaves]
    order = step_order(len(labels), ctx.seed, 0)
    r = train.Readings(names, train.leaf_names(names, leaves))
    r.focal = (cfg["focal_alpha"], cfg["focal_gamma"])
    with exact_float32():
        for k in range(params["ref_steps"]):
            total, scores = 0.0, []
            r.labels.append(labels[order[k * a * b : (k + 1) * a * b]].reshape(a, b))
            for i in range(a):
                at = (k * a + i) * b
                sel = order[at : at + b]
                flat = rows[sel].reshape(-1)
                emb = towers.item_embeddings(
                    en, cfg, torch.as_tensor(images[flat], device=dev),
                    torch.as_tensor(ids[flat], device=dev), torch.as_tensor(attn[flat], device=dev),
                    low=low,
                ).view(len(sel), rows.shape[1], -1)
                gen = generator(ref.stream_seed(ctx.seed, k, i), dev)
                logits = ref.cp_logits(st, emb, torch.as_tensor(mask[sel], device=dev), cfg,
                                       ref.Dropout(cfg["dropout"], gen), low=low)
                loss = train.half_focal(logits, torch.as_tensor(labels[sel], device=dev), cfg,
                                        half_loss) / a
                loss.backward()
                total += float(loss.detach())
                scores.append(logits.detach().cpu().numpy())
            train.first_gradient(r, opt, leaves, names, k)
            r.losses.append(total)
            r.scores.append(np.concatenate(scores))
    r.change = train.leaf_norms(names, [t.detach() - s for t, s in zip(leaves, start)])
    return r
