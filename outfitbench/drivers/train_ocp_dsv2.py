"""Original-CP with DeepSeek-V2-Lite as the frozen text tower (the
resnet_dsv2lite pair): ResNet-18 on the images, DeepSeek-V2-Lite at its
published widths on the texts, each with a trainable head to 64, into the
set transformer every step. ``original_cp_train_step`` is fed as
``OriginalCPTrainer.train_epoch`` feeds it (``step_selections`` and the
trainer's ``RawBatchStager``); the window and the comparison are the CP
driver's (``train.run_job``).

Inputs from the seed: the set transformer, ResNet-18 (BatchNorm calibrated
on the seed's first images) and both heads in float32, the raw item bank,
the split; then, from a stream of their own, the tower's frozen weights in
bfloat16, drawn on the card one tensor at a time and copied into the
program's tensor of that name (``reference.dsv2.draw_tower``), so that no
second copy of 31 GB is ever held.

Beside the resnet cell's four numbers the comparison reads
``route_mismatch``: the share of (real token, mixture) top-6 sets of the
first steps that differ from the reference's. The program's sets are read
by forward hooks on the routers during the first steps alone."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from outfitbench import flops_dsv2, inputs
from outfitbench.drivers import train
from outfitbench.drivers.common import (
    Check, Context, Outcome, generator, program_config, release,
)
from outfitbench.drivers.train_ocp import step_order
from outfitbench.reference import dsv2, optim as ref_optim, set_transformer as ref, towers
from outfitbench.reference.numerics import exact_float32

ROUTE = "route_mismatch"
HEADS = ("vision.fc.weight", "vision.fc.bias", "text.proj.weight", "text.proj.bias")


def tower_config(cfg: Dict):
    """The program's ``DeepseekV2Config`` from the configuration file's
    published keys."""
    from outfitx_tpu_torch.models.towers.deepseek_v2 import DeepseekV2Config

    rs = cfg["rope_scaling"]
    return DeepseekV2Config(
        vocab_size=cfg["vocab_size"], max_len=cfg["max_position_embeddings"],
        d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_dim=cfg["v_head_dim"],
        kv_lora_rank=cfg["kv_lora_rank"], d_ffn=cfg["intermediate_size"],
        d_expert=cfg["moe_intermediate_size"], n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"], n_shared=cfg["n_shared_experts"],
        first_dense=cfg["first_k_dense_replace"], routed_scaling=cfg["routed_scaling_factor"],
        rms_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"], rope_factor=rs["factor"],
        rope_original_max=rs["original_max_position_embeddings"], beta_fast=rs["beta_fast"],
        beta_slow=rs["beta_slow"], mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"],
        d_out=cfg["dim_per_modality"], compute_dtype=cfg["tower_dtype"],
    )


def head_specs(cfg: Dict):
    """ResNet-18 with its ``fc`` head, and the text tower's ``proj`` head."""
    d, out = cfg["hidden_size"], cfg["dim_per_modality"]
    return ([("vision." + n, s, c, h) for n, s, c, h in inputs.resnet18_specs(out)]
            + [("text.proj.weight", (out, d), 0.0, d ** -0.5),
               ("text.proj.bias", (out,), 0.0, d ** -0.5)])


def make_inputs(cfg: Dict, params: Dict, seed: int, device):
    gen = generator(seed, device)
    (weights,) = inputs.make_params(cfg, gen, device)
    enc = inputs.draw(head_specs(cfg), gen, device)
    raw = inputs.raw_items(cfg["raw_items"], dict(cfg, text_vocab=cfg["vocab_size"]), gen, device)
    inputs.calibrate(enc, raw[0])
    split = inputs.cp_split_arrays(params["outfits"], cfg["raw_items"], cfg["max_outfit_len"],
                                   params["outfit_len"], seed)
    return weights, enc, raw, split


def tower_generator(seed: int, device) -> torch.Generator:
    return generator(ref.stream_seed(seed, 19), device)


class Routes:
    """The first steps' top-k sets: the program's (router hooks), the
    reference's and the real tokens of each microbatch, in forward order."""

    def __init__(self):
        self.program: List[torch.Tensor] = []
        self.reference: List[torch.Tensor] = []
        self.real: List[torch.Tensor] = []

    def hooks(self, tower):
        def keep(module, args, out):
            self.program.append(out[1].sort(dim=-1).values.to(torch.uint8))

        return [layer.ffn.router.register_forward_hook(keep)
                for layer in tower.layers if hasattr(layer.ffn, "router")]

    def mismatch(self) -> float:
        """The share of (real token, mixture) sets unlike the reference's;
        1e9 where the counts differ."""
        if len(self.program) != len(self.reference) or not self.real:
            return 1e9
        per = len(self.reference) // len(self.real)
        differ = total = 0
        for j, (got, want) in enumerate(zip(self.program, self.reference)):
            if got.shape != want.shape:
                return 1e9
            real = self.real[j // per]
            differ += int(((got.to(want.device) != want).any(dim=-1) & real).sum())
            total += int(real.sum())
        return differ / max(total, 1)


def ocp_job(ctx: Context, routes: Routes) -> train.Job:
    from outfitx_tpu_torch.core.config import CPTrainConfig, OptimizerConfig
    from outfitx_tpu_torch.data.splits import CPSplit
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    cfg, params = ctx.config, ctx.params
    weights, enc, (images, ids, attn), (rows, mask, labels) = make_inputs(
        cfg, params, ctx.seed, ctx.device)
    model_cfg = program_config(cfg)
    encoder = ItemEncoderModel(
        model_cfg.item_encoder,
        vision_cfg=ResNet18Config(d_out=cfg["dim_per_modality"], image_size=cfg["image_size"],
                                  compute_dtype=cfg["compute_dtype"]),
        text_cfg=tower_config(cfg), device=ctx.device, seed=ctx.seed,
    )
    loaded = encoder.load_state_dict(enc, strict=False)
    if loaded.unexpected_keys or any(not k.startswith("text.") for k in loaded.missing_keys):
        raise KeyError(f"encoder weights do not match the program's: {loaded}")
    tensors = dict(encoder.text.named_parameters())
    with torch.no_grad():
        dsv2.draw_tower(cfg, tower_generator(ctx.seed, ctx.device), ctx.device,
                        lambda name, t: tensors[name].copy_(t))
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
        tcfg, model_cfg, "custom", encoder=encoder,
        source=RawItemSource(image_bank=images, input_ids=ids, attn=attn),
        train_split=split, valid_split=CPSplit(rows[:b], mask[:b], labels[:b]),
        device=ctx.device,
    )
    trainer.setup()
    trainer.model.load_state_dict(weights)
    del weights, enc, tensors, encoder
    release(ctx.device)
    state = trainer.state
    train_step = ctx.faults.get("step", original_cp_train_step)
    hooks = routes.hooks(trainer.encoder.text)
    calls = [0]

    def selections():
        epoch = 0
        while True:
            yield from trainer.step_selections(split, epoch)
            epoch += 1

    def step(sels):
        calls[0] += 1
        try:
            return train_step(state, (trainer.microbatch(split, s) for s in sels),
                              alpha=cfg["focal_alpha"], gamma=cfg["focal_gamma"])
        finally:
            if calls[0] == params["ref_steps"]:  # the first steps read; the window is not
                for h in hooks:
                    h.remove()

    def reference(ctx_, names, low=False, half_loss=False):
        return reference_readings(ctx_, names, low=low, half_loss=half_loss, routes=routes)

    return train.Job(
        step=step, batches=selections(), optimizer=state.optimizer,
        names=[n for n, p in trainer.net.named_parameters() if p.requires_grad],
        outfits_per_step=b * a, microbatches_per_step=a,
        derived={"step_flops": flops_dsv2.ocp_step_flops(cfg, b, a),
                 "attention_launches": flops_dsv2.attention_launches(cfg, b, a),
                 "expert_s": flops_dsv2.expert_bound(
                     cfg, b * cfg["max_outfit_len"] * cfg["text_len"], cfg["tower_dtype"])},
        reference=reference,
        counters=lambda: {"gather_s": trainer.stage.gather_s},
        close=lambda: trainer.__exit__(None, None, None),
    )


def without_routes(ctx: Context) -> Context:
    """The context ``train.run_job`` compares by: the limits but
    ``route_mismatch``, which this driver reads itself."""
    limits = {k: v for k, v in ctx.params["limits"].items() if k != ROUTE}
    return dataclasses.replace(ctx, params=dict(ctx.params, limits=limits))


def run(ctx: Context) -> Outcome:
    routes = Routes()
    outcome = train.run_job(without_routes(ctx), ocp_job(ctx, routes))
    value = routes.mismatch()
    outcome.checks.append(Check(ROUTE, value, ctx.params["limits"][ROUTE]))
    outcome.notes["gaps"][ROUTE] = value
    return outcome


def reference_readings(ctx: Context, names, low: bool = False, half_loss: bool = False,
                       routes: Routes = None):
    """The plain reference's first steps: the towers' features of every
    item the first steps take (DeepSeek-V2-Lite by ``reference.dsv2``, each
    layer's weights widened to float32 in turn; ResNet-18 by
    ``reference.towers``), then the heads, the set transformer, focal loss
    and the update, with the job's dropout draws. ``routes`` takes the
    reference's top-k sets and the real tokens."""
    cfg, params, dev = ctx.config, ctx.params, ctx.device
    weights, enc, (images, ids, attn), (rows, mask, labels) = make_inputs(
        cfg, params, ctx.seed, dev)
    p = {"model." + k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    p.update({"encoder." + k: v.detach().clone().requires_grad_(k in HEADS)
              for k, v in enc.items()})
    del weights, enc
    st = {k[6:]: v for k, v in p.items() if k.startswith("model.")}
    en = {k[8:]: v for k, v in p.items() if k.startswith("encoder.")}
    leaves = [p[n] for n in names]
    a, b = params["accumulation"], params["batch"]
    steps = params["ref_steps"]
    order = step_order(len(labels), ctx.seed, 0)
    flat = rows[order[: steps * a * b]].reshape(-1)  # every item slot, in step order
    tower = {}
    dsv2.draw_tower(cfg, tower_generator(ctx.seed, dev), dev, tower.__setitem__)
    item_ids = torch.as_tensor(ids[flat], device=dev)
    item_attn = torch.as_tensor(attn[flat], device=dev)
    with exact_float32():
        txt, found = dsv2.features(tower, cfg, item_ids, item_attn, low=low)
        del tower
        vision = {k[7:]: v for k, v in en.items() if k.startswith("vision.")}
        vis = torch.cat([towers.resnet18_features(vision, torch.as_tensor(images[flat[s : s + 512]],
                                                                          device=dev), low)
                         for s in range(0, len(flat), 512)])
    if routes is not None:
        per = b * cfg["max_outfit_len"] * cfg["text_len"]  # a microbatch's tokens
        real = item_attn.reshape(-1) == 1
        routes.real = [real[s : s + per] for s in range(0, real.numel(), per)]
        routes.reference = [layer[s : s + per] for s in range(0, real.numel(), per)
                            for layer in found]
    opt = ref_optim.AdamW(leaves, cfg["optimizer"], train.total_steps(cfg, params))
    start = [t.detach().clone() for t in leaves]
    r = train.Readings(names, train.leaf_names(names, leaves))
    r.focal = (cfg["focal_alpha"], cfg["focal_gamma"])
    slots = b * rows.shape[1]
    with exact_float32():
        for k in range(steps):
            total, scores = 0.0, []
            r.labels.append(labels[order[k * a * b : (k + 1) * a * b]].reshape(a, b))
            for i in range(a):
                at = (k * a + i) * b
                sel = order[at : at + b]
                cut = slice((k * a + i) * slots, (k * a + i + 1) * slots)
                img = ref.linear(vis[cut], en["vision.fc.weight"], en["vision.fc.bias"], low)
                tx = ref.linear(txt[cut], en["text.proj.weight"], en["text.proj.bias"], low)
                emb = torch.cat([img / torch.linalg.norm(img, dim=-1, keepdim=True),
                                 tx / torch.linalg.norm(tx, dim=-1, keepdim=True)], dim=-1)
                gen = generator(ref.stream_seed(ctx.seed, k, i), dev)
                logits = ref.cp_logits(st, emb.view(len(sel), rows.shape[1], -1),
                                       torch.as_tensor(mask[sel], device=dev), cfg,
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
