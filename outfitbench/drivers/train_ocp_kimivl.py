"""Original-CP with Kimi-VL-A3B as the joint item encoder (the kimivl_a3b
pair): MoonViT on the images, its 64 merged tokens and the item's title in
one pass of the Moonlight MoE decoder, the mean over the image positions
and the mean over the title's real tokens each through a trainable head to
64, into the set transformer every step. The rest is
``train_ocp_dsv2``'s: ``original_cp_train_step`` fed by
``step_selections`` and the trainer's ``RawBatchStager``, the window and
the comparison (``train.run_job``), ``route_mismatch`` read by that
driver's router hooks, its tower config and its weights' stream. Its own
is ``token_gap``: the decoder's input image tokens of the first steps'
items against the reference's, which reads MoonViT and the projector
before any top-6 choice can amplify their rounding.

Inputs from the seed: the set transformer and both heads in float32, the
raw item bank, the split; then, from the stream of its own, the towers'
frozen weights in bfloat16 (the routers' correction biases in float32),
drawn on the card one tensor at a time and copied into the program's
tensor of that name (``reference.kimivl.draw_towers``), so that no second
copy of 32 GB is ever held."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from outfitbench import flops_dsv2, flops_kimivl, inputs
from outfitbench.drivers import train, train_ocp_dsv2 as dsv2
from outfitbench.drivers.common import Check, Context, Outcome, generator, program_config, release
from outfitbench.drivers.train_ocp import step_order
from outfitbench.reference import kimivl, optim as ref_optim, set_transformer as ref
from outfitbench.reference.numerics import exact_float32


TOKENS = "token_gap"


class Readout(dsv2.Routes):
    """``train_ocp_dsv2.Routes``' top-k sets, and the decoder's input image
    tokens (MoonViT and the projector) of every item slot the first steps
    encode: the program's, kept on the host in its own dtype as each
    microbatch's forward makes them, and the reference's in float32, with
    which item slots hold a real item."""

    def __init__(self):
        super().__init__()
        self.tokens: List[torch.Tensor] = []
        self.reference_tokens = None
        self.real_items = None

    def hooks(self, encoder):
        """The router hooks on the decoder, and a wrap of the encoder's
        ``_image_tokens`` that keeps a host copy; each handle's
        ``remove()`` takes its own off."""
        take = encoder._image_tokens

        def kept(images):
            out = take(images)
            self.tokens.append(out.detach().cpu())
            return out

        class Unwrap:
            def remove(self):
                del encoder._image_tokens

        encoder._image_tokens = kept
        return super().hooks(encoder.text) + [Unwrap()]

    def token_gap(self) -> float:
        return token_gap(self.tokens, self.reference_tokens, self.real_items)


def token_gap(got, want, real) -> float:
    """|got - want| / |want| over the real items' image tokens (Frobenius
    norms, float64 sums): ``got`` the program's tokens (or a control's),
    one tensor a microbatch in forward order, ``want`` the reference's for
    the same item slots; 1e9 where the counts differ."""
    if want is None or not got:
        return 1e9
    got = torch.cat([t.float() for t in got])
    if got.shape != want.shape:
        return 1e9
    diff = norm = 0.0
    for at in range(0, len(got), 256):
        keep = real[at : at + 256]
        w = want[at : at + 256][keep].double()
        diff += float(((got[at : at + 256][keep].double() - w) ** 2).sum())
        norm += float((w ** 2).sum())
    return (diff / norm) ** 0.5 if norm > 0 else 1e9


def tower_configs(cfg: Dict):
    """The program's ``MoonViTConfig`` and the decoder's
    ``DeepseekV2Config`` from the configuration file's published keys; the
    decoder through ``train_ocp_dsv2.tower_config`` with ``rope_scaling``
    null read as YaRN's factor 1 (plain RoPE, the scale 192^-0.5), and its
    router DeepSeek-V3's ``noaux_tc`` in one group, which the program names
    "sigmoid"."""
    from outfitx_tpu_torch.models.towers.moonvit import MoonViTConfig

    if (cfg["scoring_func"], cfg["topk_method"], cfg["n_group"], cfg["topk_group"],
            cfg["norm_topk_prob"], cfg["rope_scaling"]) != ("sigmoid", "noaux_tc", 1, 1, True, None):
        raise ValueError("the kimivl driver takes noaux_tc sigmoid routing in one group, "
                         "normalised, and no rope_scaling")
    rs = dict(kimivl.NO_YARN, original_max_position_embeddings=cfg["max_position_embeddings"],
              beta_fast=32, beta_slow=1)
    decoder = dataclasses.replace(dsv2.tower_config(dict(cfg, rope_scaling=rs)), scoring="sigmoid")
    vc = cfg["vision_config"]
    m = vc["merge_kernel_size"]
    if m[0] != m[1] or vc["init_pos_emb_height"] != vc["init_pos_emb_width"]:
        raise ValueError("the kimivl driver takes a square merge and position table")
    vision = MoonViTConfig(
        image_size=cfg["image_size"], patch_size=vc["patch_size"], d_model=vc["hidden_size"],
        n_heads=vc["num_attention_heads"], d_mlp=vc["intermediate_size"],
        n_layers=vc["num_hidden_layers"], pos_grid=vc["init_pos_emb_height"], merge=m[0],
        ln_eps=kimivl.LN_EPS, rope_theta=kimivl.ROPE_2D_THETA, d_text=cfg["hidden_size"],
        d_out=cfg["dim_per_modality"], compute_dtype=cfg["tower_dtype"])
    return vision, decoder


def head_specs(cfg: Dict):
    """MoonViT's ``fc`` and the decoder's ``proj``, each from the decoder's
    width, uniform(+-1/sqrt(d))."""
    d, out = cfg["hidden_size"], cfg["dim_per_modality"]
    return [(name + suffix, shape, 0.0, d ** -0.5)
            for name in ("vision.fc", "text.proj")
            for suffix, shape in ((".weight", (out, d)), (".bias", (out,)))]


def make_inputs(cfg: Dict, params: Dict, seed: int, device):
    gen = generator(seed, device)
    (weights,) = inputs.make_params(cfg, gen, device)
    enc = inputs.draw(head_specs(cfg), gen, device)
    raw = inputs.raw_items(cfg["raw_items"], dict(cfg, text_vocab=cfg["vocab_size"]), gen, device)
    split = inputs.cp_split_arrays(params["outfits"], cfg["raw_items"], cfg["max_outfit_len"],
                                   params["outfit_len"], seed)
    return weights, enc, raw, split


def ocp_job(ctx: Context, routes: Readout) -> train.Job:
    from outfitx_tpu_torch.core.config import CPTrainConfig, OptimizerConfig
    from outfitx_tpu_torch.data.splits import CPSplit
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource
    from outfitx_tpu_torch.train.steps import original_cp_train_step

    cfg, params = ctx.config, ctx.params
    weights, enc, (images, ids, attn), (rows, mask, labels) = make_inputs(
        cfg, params, ctx.seed, ctx.device)
    model_cfg = program_config(cfg)
    vision, decoder = tower_configs(cfg)
    encoder = ItemEncoderModel(model_cfg.item_encoder, vision_cfg=vision, text_cfg=decoder,
                               device=ctx.device, seed=ctx.seed)
    loaded = encoder.load_state_dict(enc, strict=False)
    tensors, drawn = dict(encoder.named_parameters()), []

    def sink(name, t):
        tensors[name].copy_(t)
        drawn.append(name)

    with torch.no_grad():
        kimivl.draw_towers(cfg, dsv2.tower_generator(ctx.seed, ctx.device), ctx.device, sink)
    if loaded.unexpected_keys or sorted(drawn) != sorted(loaded.missing_keys):
        raise KeyError(f"encoder weights do not match the program's: {loaded}")
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
    hooks = routes.hooks(trainer.encoder)
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

    items = b * cfg["max_outfit_len"]
    return train.Job(
        step=step, batches=selections(), optimizer=state.optimizer,
        names=[n for n, p in trainer.net.named_parameters() if p.requires_grad],
        outfits_per_step=b * a, microbatches_per_step=a,
        derived={"step_flops": flops_kimivl.ocp_step_flops(cfg, b, a),
                 "attention_launches": flops_kimivl.attention_launches(cfg, b, a),
                 "expert_s": flops_dsv2.expert_bound(cfg, items * flops_kimivl.sequence(cfg),
                                                     cfg["tower_dtype"])},
        reference=reference,
        counters=lambda: {"gather_s": trainer.stage.gather_s},
        close=lambda: trainer.__exit__(None, None, None),
    )


def run(ctx: Context) -> Outcome:
    readout = Readout()
    limits = ctx.params["limits"]
    own = {dsv2.ROUTE: readout.mismatch, TOKENS: readout.token_gap}
    rest = dataclasses.replace(ctx, params=dict(ctx.params, limits={
        k: v for k, v in limits.items() if k not in own}))
    outcome = train.run_job(rest, ocp_job(ctx, readout))
    for name, read in own.items():
        value = read()
        outcome.checks.append(Check(name, value, limits[name]))
        outcome.notes["gaps"][name] = value
    return outcome


def reference_readings(ctx: Context, names, low: bool = False, half_loss: bool = False,
                       routes: Readout = None):
    """The plain reference's first steps: the joint encoder's two means of
    every item the first steps take (``reference.kimivl``: MoonViT in
    blocks of images, the decoder each layer's weights widened to float32
    in turn), then the heads, the set transformer, focal loss and the
    update, with the job's dropout draws, as ``train_ocp_dsv2`` takes its
    towers' features. ``routes`` takes the reference's expert sets and the
    real tokens (a real item's image tokens and its title's real ones), and
    the image tokens with the item slots that hold a real item."""
    cfg, params, dev = ctx.config, ctx.params, ctx.device
    weights, enc, (images, ids, attn), (rows, mask, labels) = make_inputs(
        cfg, params, ctx.seed, dev)
    p = {"model." + k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    p.update({"encoder." + k: v.detach().clone().requires_grad_(True) for k, v in enc.items()})
    del weights, enc
    st = {k[6:]: v for k, v in p.items() if k.startswith("model.")}
    en = {k[8:]: v for k, v in p.items() if k.startswith("encoder.")}
    leaves = [p[n] for n in names]
    a, b = params["accumulation"], params["batch"]
    steps = params["ref_steps"]
    order = step_order(len(labels), ctx.seed, 0)
    flat = rows[order[: steps * a * b]].reshape(-1)  # every item slot, in step order
    towers = {}
    kimivl.draw_towers(cfg, dsv2.tower_generator(ctx.seed, dev), dev, towers.__setitem__)
    item_ids = torch.as_tensor(ids[flat], device=dev)
    item_attn = torch.as_tensor(attn[flat], device=dev)
    with exact_float32():
        tokens = kimivl.vit_tokens(towers, cfg, images[flat], low=low)
        if routes is not None:
            routes.reference_tokens = tokens.cpu()
            routes.real_items = torch.as_tensor(flat != cfg["raw_items"])
        vis, txt, found = kimivl.features(towers, cfg, tokens, item_ids, item_attn, low=low)
    del towers, tokens
    if routes is not None:
        # A real item's image tokens and real title tokens; a pad slot (the
        # pad row, an all-zero image and no title) holds none, as in dsv2.
        n_img = flops_kimivl.image_tokens(cfg)
        item = torch.as_tensor(flat != cfg["raw_items"], device=dev)[:, None]
        real = (torch.cat([item.expand(len(flat), n_img), item_attn == 1], dim=1)
                & item).reshape(-1)
        per = b * cfg["max_outfit_len"] * flops_kimivl.sequence(cfg)  # a microbatch's tokens
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
