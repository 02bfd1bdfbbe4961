"""CP training at the reference envelope: ``cp_train_step`` fed by
``CPTrainer``'s own batch iterator, epochs back to back, over a catalog,
weights and split drawn from the seed.

Set-up builds the trainer, loads the weights, and drives the one train
state through the first ``ref_steps`` steps, reading what the comparison
needs (each step's loss, the first gradient from the optimizer's moment,
the parameters' change); the window then goes on with the same state and
iterator. End to end (under the cell's ``rate_metric``): the outfits of
every step that started inside the window over the seconds until all of
them finished."""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from outfitbench import flops, inputs
from outfitbench.drivers.common import (
    Check, Context, Outcome, generator, memory_peak, program_config, release, synchronize,
)
from outfitbench.reference import optim as ref_optim, set_transformer as ref
from outfitbench.reference.numerics import exact_float32
from outfitbench.trace import DeviceTrace, Record, Spans

RUN_DIR = pathlib.Path("build") / "outfitbench"


def make_inputs(cfg: Dict, params: Dict, seed: int, device):
    """Weights and catalog on the device, the split on the host."""
    gen = generator(seed, device)
    (weights,) = inputs.make_params(cfg, gen, device)
    emb = inputs.make_catalog(cfg["catalog_items"], cfg["d_embed"], gen, device)
    split = inputs.cp_split_arrays(params["outfits"], cfg["catalog_items"], cfg["max_outfit_len"],
                                   params["outfit_len"], seed)
    return weights, emb, split


def total_steps(cfg: Dict, params: Dict) -> int:
    """The OneCycle horizon the trainer sets: steps an epoch times epochs."""
    return max(params["outfits"] // (params["batch"] * params["accumulation"]), 1) * cfg["epochs"]


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The training job's stated shuffle: numpy's generator on (seed, epoch)."""
    return np.random.default_rng([seed, epoch]).permutation(n)


def build(ctx: Context):
    """The trainer over the seed's inputs, with the seed's weights loaded."""
    from outfitx_tpu_torch.core.config import CPTrainConfig, OptimizerConfig
    from outfitx_tpu_torch.data.catalog import Catalog
    from outfitx_tpu_torch.data.splits import CPSplit
    from outfitx_tpu_torch.train.cp_trainer import CPTrainer

    cfg, params = ctx.config, ctx.params
    weights, emb, (rows, mask, labels) = make_inputs(cfg, params, ctx.seed, ctx.device)
    n = cfg["catalog_items"]
    ids = inputs.item_ids(n)
    catalog = Catalog(item_ids=ids, embeddings=emb.cpu().numpy(),
                      category_id=np.zeros(n, np.int32), semantic_category=np.zeros(n, np.int32),
                      semantic_vocab=[""], id_to_row={})
    del emb
    b = params["batch"]
    run_dir = RUN_DIR / ctx.cell["name"]
    tcfg = CPTrainConfig(
        seed=ctx.seed, n_epochs=cfg["epochs"], batch_size=b,
        accumulation_steps=params["accumulation"], optimizer=OptimizerConfig(**cfg["optimizer"]),
        checkpoint_dir=str(run_dir / "checkpoints"), log_dir=str(run_dir / "logs"),
        async_saves=False, focal_alpha=cfg["focal_alpha"], focal_gamma=cfg["focal_gamma"],
    )
    trainer = CPTrainer(
        tcfg, program_config(cfg), "custom", catalog=catalog,
        train_split=CPSplit(rows, mask, labels),
        valid_split=CPSplit(rows[:b], mask[:b], labels[:b]), device=ctx.device,
    )
    trainer.setup()
    trainer.model.load_state_dict(weights)
    del weights
    release(ctx.device)
    return trainer


def _batches(trainer):
    epoch = 0
    while True:
        yield from trainer._iter_train_batches(epoch)
        epoch += 1


def blocks(name: str, t: torch.Tensor):
    """The leaves the comparison reads in a parameter: the fused [Q; K; V]
    projections as their three blocks (a key's bias has no gradient under
    softmax, so its block moves by round-off alone and the leaf rule below
    leaves it out), every other parameter whole."""
    if name.endswith(("self_attn.in_proj_weight", "self_attn.in_proj_bias")):
        return [(f"{name}[{q}]", c) for q, c in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def leaf_norms(names: List[str], tensors, scale: float = 1.0) -> List[float]:
    return [float(b.float().norm()) * scale for n, t in zip(names, tensors) for _, b in blocks(n, t)]


def leaf_names(names: List[str], tensors) -> List[str]:
    return [b for n, t in zip(names, tensors) for b, _ in blocks(n, t)]


def leaf_vectors(names: List[str], tensors) -> List[torch.Tensor]:
    """Each leaf flattened, in float32 on the host."""
    return [b.detach().to("cpu", torch.float32, copy=True).reshape(-1)
            for n, t in zip(names, tensors) for _, b in blocks(n, t)]


class Readings:
    """What the first steps give the comparison, per leaf (``blocks``)."""

    def __init__(self, params: List[str], leaves: List[str]):
        self.params = params  # the trainable parameters' names
        self.leaves = leaves
        self.losses: List[float] = []
        self.grad: List[float] = []
        self.grad_vecs: List[torch.Tensor] = []  # the first gradient, each leaf whole
        self.global_norm: float = None  # the first gradient's norm before the clip (reference)
        self.change: List[float] = []
        self.scores: List[np.ndarray] = []  # each step's outfits' logits
        self.labels: List[np.ndarray] = []  # each step's labels (A, B) (reference)
        self.focal = None  # (alpha, gamma) of the loss (reference)


def first_steps(step, batches, opt, names, n_steps: int, b1: float) -> Readings:
    """Drive the state through its first steps, reading each loss, the
    first gradient as the optimizer got it (its first moment over 1 - b1,
    each leaf's norm and the leaf itself) and each parameter's change."""
    r = Readings(names, leaf_names(names, opt.params))
    start = [p.detach().clone() for p in opt.params]
    for k in range(n_steps):
        out = step(next(batches))
        r.losses.append(float(out["loss"]))
        r.scores.append(out["scores"].float().reshape(-1).cpu().numpy())
        if k == 0:
            r.grad = leaf_norms(names, opt.mu, 1.0 / (1.0 - b1))
            r.grad_vecs = leaf_vectors(names, opt.mu)
    r.change = leaf_norms(names, [p.detach() - s for p, s in zip(opt.params, start)])
    return r


@dataclasses.dataclass
class Job:
    """One training job as the window drives it."""

    step: Callable  # batch -> {'loss', ...}
    batches: Iterator
    optimizer: object  # the program's AdamW (params, mu)
    names: List[str]  # its parameters' names, in its order
    outfits_per_step: int
    microbatches_per_step: int
    derived: Dict  # step_flops, attention_launches, compute_dtype, chips
    reference: Callable  # (ctx, names, low=False, half_loss=False) -> Readings
    counters: Callable[[], Dict] = dict  # cumulative program counters
    close: Callable[[], None] = lambda: None


def cp_job(ctx: Context) -> Job:
    from outfitx_tpu_torch.train.steps import cp_train_step

    cfg, params = ctx.config, ctx.params
    trainer = build(ctx)
    state = trainer.state
    train_step = ctx.faults.get("step", cp_train_step)

    def step(batch):
        return train_step(state, trainer.catalog_dev, batch,
                          alpha=cfg["focal_alpha"], gamma=cfg["focal_gamma"])

    b, a = params["batch"], params["accumulation"]
    return Job(
        step=step, batches=_batches(trainer), optimizer=state.optimizer,
        names=[n for n, p in trainer.model.named_parameters() if p.requires_grad],
        outfits_per_step=b * a, microbatches_per_step=a,
        derived={"step_flops": flops.cp_step_flops(cfg, b, a),
                 "attention_launches": flops.attention_launches(cfg, b, a)},
        reference=reference_readings,
        close=lambda: trainer.__exit__(None, None, None),
    )


def run(ctx: Context) -> Outcome:
    return run_job(ctx, cp_job(ctx))


def run_job(ctx: Context, job: Job) -> Outcome:
    """Set-up's first steps, the window, then the comparison."""
    readings = first_steps(job.step, job.batches, job.optimizer, job.names,
                           ctx.params["ref_steps"], ctx.config["optimizer"]["b1"])
    spans = Spans() if ctx.trace else None
    step = job.step
    if spans is not None:
        step = spans.wrap("outfitbench.step", step)
        next_batch = spans.wrap("outfitbench.batch", lambda: next(job.batches))
    else:
        next_batch = lambda: next(job.batches)  # noqa: E731
    synchronize(ctx.device)
    counters0 = job.counters()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.started
    metrics, record = {}, None
    if not ctx.trace:
        steps = 0
        while time.perf_counter() - t0 < ctx.seconds:
            step(next_batch())
            steps += 1
        synchronize(ctx.device)
        elapsed = time.perf_counter() - t0
        metrics = {ctx.params["rate_metric"]: steps * job.outfits_per_step / elapsed,
                   "setup_s": setup_s}
    else:
        record = traced_window(ctx, job, step, next_batch, spans, t0)
        steps = record.derived["steps"]
        counters = {k: v - counters0.get(k, 0.0) for k, v in job.counters().items()}
        record.counters = dict(counters, microbatches=steps * job.microbatches_per_step)
    peak = memory_peak(ctx.device)
    job.close()
    names, reference = job.names, job.reference
    job = step = next_batch = None
    release(ctx.device)
    t_ref = time.perf_counter()
    want = reference(ctx, names)
    found = gaps(readings, want)
    checks = [Check(k, found[k], ctx.params["limits"][k]) for k in ctx.params["limits"]]
    return Outcome(metrics=metrics, attempted=steps, failed=0, memory_peak_bytes=peak,
                   checks=checks, record=record,
                   notes={"losses": readings.losses, "setup_s": setup_s,
                          "reference_s": time.perf_counter() - t_ref,
                          "worst_leaves": worst_leaves(readings, want), "gaps": found,
                          "norms": norm_notes(readings, want)})


def traced_window(ctx: Context, job: Job, step, next_batch, spans: Spans, t0: float) -> Record:
    """Unprofiled steps for half the window, ``profile_steps`` under the
    profiler, unprofiled steps to the window's end."""
    params, cfg = ctx.params, ctx.config

    def until(end: float):
        n = 0
        while time.perf_counter() - t0 < end or n == 0:
            step(next_batch())
            n += 1
        synchronize(ctx.device)
        return n

    n1 = until(ctx.seconds / 2)
    profile = DeviceTrace(spans)
    with profile:
        for _ in range(params["profile_steps"]):
            step(next_batch())
    n2 = until(ctx.seconds)
    derived = dict(job.derived, chips=ctx.cell.get("chips", 1),
                   steps=n1 + n2 + params["profile_steps"],
                   profiled_steps=params["profile_steps"],
                   compute_dtype=cfg["compute_dtype"])
    return Record(cell=ctx.cell, config=cfg, params=params, spans=spans, counters={},
                  trace=profile.summary, derived=derived)


# ----------------------------------------------------------- reference --
def reference_readings(ctx: Context, names: List[str], low: bool = False,
                       half_loss: bool = False) -> Readings:
    """The plain reference's first steps on the seed's inputs (``low``: in
    float8, the control). With ``half_loss`` every outfit is scored and the
    loss and gradient take the first half of each microbatch alone (a
    fault: the rest left out, the mean taken over what is left)."""
    cfg, params, dev = ctx.config, ctx.params, ctx.device
    weights, emb, (rows, mask, labels) = make_inputs(cfg, params, ctx.seed, dev)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    del weights
    leaves = [p[n] for n in names]
    a, b = params["accumulation"], params["batch"]
    opt = ref_optim.AdamW(leaves, cfg["optimizer"], total_steps(cfg, params))
    start = [t.detach().clone() for t in leaves]
    order = epoch_order(len(labels), ctx.seed, 0)
    r = Readings(names, leaf_names(names, leaves))
    r.focal = (cfg["focal_alpha"], cfg["focal_gamma"])
    with exact_float32():
        for k in range(params["ref_steps"]):
            sel = order[k * a * b : (k + 1) * a * b].reshape(a, b)
            r.labels.append(labels[sel])
            total, scores = 0.0, []
            for i in range(a):
                gen = generator(ref.stream_seed(ctx.seed, k, i), dev)
                drop = ref.Dropout(cfg["dropout"], gen)
                r_i = torch.as_tensor(rows[sel[i]], device=dev).long()
                m_i = torch.as_tensor(mask[sel[i]], device=dev)
                y_i = torch.as_tensor(labels[sel[i]], device=dev)
                logits = ref.cp_logits(p, emb[r_i], m_i, cfg, drop, low=low)
                loss = half_focal(logits, y_i, cfg, half_loss) / a
                loss.backward()
                total += float(loss.detach())
                scores.append(logits.detach().cpu().numpy())
            first_gradient(r, opt, leaves, names, k)
            r.losses.append(total)
            r.scores.append(np.concatenate(scores))
    r.change = leaf_norms(names, [t.detach() - s for t, s in zip(leaves, start)])
    return r


def half_focal(logits, labels, cfg: Dict, half: bool = False):
    """The focal loss; with ``half`` over the first half of the outfits
    alone (the half-batch fault)."""
    n = logits.shape[0] // 2 if half else logits.shape[0]
    return ref.focal_loss(logits[:n], labels[:n], cfg["focal_alpha"], cfg["focal_gamma"])


def first_gradient(r: Readings, opt, leaves, names: List[str], k: int) -> None:
    """Take the accumulated gradients into an optimizer step; on the first
    step read the gradient as the optimizer got it (after the clip), each
    leaf's norm and the leaf itself, and the norm before the clip."""
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    if k == 0:
        r.global_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    used = opt.step(grads)
    for t in leaves:
        t.grad = None
    if k == 0:
        r.grad = leaf_norms(names, used)
        r.grad_vecs = leaf_vectors(names, used)


def score_gap(got: Readings, want: Readings) -> float:
    """The root mean square over the followed steps' outfits of logit -
    reference logit, over the reference logits' standard deviation. Each
    outfit's logit is read apart, so rounding does not average away as it
    does in the loss; a step that scored other outfits than the
    reference's reads 1e9."""
    if [s.shape for s in got.scores] != [s.shape for s in want.scores]:
        return 1e9
    g, w = np.concatenate(got.scores), np.concatenate(want.scores)
    return float(np.sqrt(np.mean((g - w) ** 2)) / np.std(w))


def loss_logit_gap(got: Readings, want: Readings) -> float:
    """The widest, over the followed steps, |loss - the focal loss of the
    program's own logits| over the latter: the loss the program reports
    (and so the loss it took its gradient of) is to be the mean over every
    microbatch of the focal loss over all its outfits, which the
    reference works out in float64 from the logits the step returned and
    the step's labels. Scores of other outfits than the labels' read
    1e9."""
    worst = 0.0
    for loss, s, y in zip(got.losses, got.scores, want.labels):
        if s.size != y.size:
            return 1e9
        s = torch.as_tensor(s, dtype=torch.float64).reshape(y.shape)
        y = torch.as_tensor(y, dtype=torch.float64)
        want_loss = float(sum(ref.focal_loss(s[i], y[i], *want.focal) for i in range(len(y)))) / len(y)
        worst = max(worst, abs(loss - want_loss) / abs(want_loss))
    return worst


def worst_leaves(got: Readings, want: Readings) -> Dict[str, str]:
    """The leaf behind each of ``gaps``' leaf numbers (for the run's notes)."""
    med_g, med_c = float(np.median(want.grad)), float(np.median(want.change))
    live = live_leaves(want)
    pick = lambda xs, ys, med: max(live, key=lambda i: abs(xs[i] - ys[i]) / max(ys[i], med))  # noqa: E731
    return {"grad_gap": want.leaves[pick(got.grad, want.grad, med_g)],
            "change_gap": want.leaves[pick(got.change, want.change, med_c)]}


def cosine_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - the cosine between two leaves (1 where either is all zero)."""
    a, b = a.double(), b.double()
    den = float(a.norm() * b.norm())
    return 1.0 - float(torch.dot(a, b)) / den if den > 0 else 1.0


def live_leaves(want: Readings) -> List[int]:
    """The leaves the comparison reads: those whose reference gradient is
    at least a thousandth of the median leaf's (the rest move under Adam
    by round-off alone)."""
    med_g = float(np.median(want.grad))
    return [i for i, g in enumerate(want.grad) if g >= 1e-3 * med_g]


def gaps(got: Readings, want: Readings) -> Dict[str, float]:
    """loss_gap: the widest |loss - reference| over the reference's loss;
    score_gap: ``score_gap``; loss_logit_gap: ``loss_logit_gap``.
    By leaf, |norm - reference norm| over the larger of that leaf's
    reference norm and the median leaf's, for the first gradient and the
    parameters' change: grad_gap and change_gap take the worst leaf,
    grad_gap_median and change_gap_median the median leaf.
    grad_cos_gap_median: the median leaf's 1 - cosine between the first
    gradient and the reference's, which a gradient of the right size and
    the wrong direction (a loss over part of the batch) fails.
    All leaf numbers read ``live_leaves`` alone."""
    med_g = float(np.median(want.grad))
    med_c = float(np.median(want.change))
    live = live_leaves(want)
    grad = [abs(got.grad[i] - want.grad[i]) / max(want.grad[i], med_g) for i in live]
    change = [abs(got.change[i] - want.change[i]) / max(want.change[i], med_c) for i in live]
    cos = [cosine_gap(got.grad_vecs[i], want.grad_vecs[i]) for i in live]
    loss = max(abs(x - y) / abs(y) for x, y in zip(got.losses, want.losses))
    return {"loss_gap": loss, "grad_gap": max(grad), "change_gap": max(change),
            "grad_gap_median": float(np.median(grad)), "change_gap_median": float(np.median(change)),
            "grad_cos_gap_median": float(np.median(cos)), "score_gap": score_gap(got, want),
            "loss_logit_gap": loss_logit_gap(got, want)}


def norm_notes(got: Readings, want: Readings) -> Dict:
    """Where a leaf number swings: the reference's first gradient norm
    before the clip, the leaf with the largest share of its square, and
    the median over leaves of program norm / reference norm - 1 (signed:
    where the batch's gradient nearly cancels, its rounding moves every
    leaf by one scale)."""
    live = live_leaves(want)
    sq = [g * g for g in want.grad]
    top = int(np.argmax(sq))
    return {"ref_global_norm": want.global_norm, "top_leaf": want.leaves[top],
            "top_share": sq[top] / sum(sq),
            "grad_ratio_median": float(np.median([got.grad[i] / want.grad[i] - 1 for i in live]))}
