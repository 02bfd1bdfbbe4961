"""The port's span tracer (``outfitx_tpu_torch/core/trace.py``), on the CPU.

With no profiler recording, a CP, CIR and original-CP train step record
nothing. Under ``torch.profiler`` (CPU activity), A = 2: each step records
one ``outfitx.step`` tagged with its step number, a forward and a backward
for each microbatch tagged 0 and 1, an ``ahead`` between each forward and
its backward tagged 1 and 2 (the microbatch it takes; the second finds the
end), and one optimizer, all under the step; original-CP adds a ``stage``
for each microbatch, the first under the step and the second under the
``ahead`` tagged 1, each around one ``gather``, and an ``encode`` inside
each forward with the image tower's ``vision`` inside it. The profiler's own events carry the same names, nested
alike. The buffer keeps the newest records and counts the dropped. The
benchmark's six readers of the spans do their arithmetic on synthetic
records. One test needs the card: a span's device seconds read the card's
idle inside it, and about 0 behind a queued kernel longer than the span.
"""

import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core import trace
from outfitx_tpu_torch.data import sampler as tsampler
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import OutfitXModel
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import cir_train_step, cp_train_step, original_cp_train_step

torch.set_num_threads(1)

TASKS = ["cp", "cir", "original_cp"]


def _cfg():
    return tcfg.OutfitXConfig(
        item_encoder=tcfg.ItemEncoderConfig(encoder_type="siglip", dim_per_modality=32),
        transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=96, n_layers=2, dropout=0.3),
        max_outfit_len=8, compute_dtype="float32",
    )


def _catalog_step(task):
    """One step function over a device-resident catalog, A = 2."""
    cfg = _cfg()
    data = make_synthetic(n_items=300, d_embed=cfg.d_embed, n_outfits=64,
                          max_len=cfg.max_outfit_len, seed=3)
    model = OutfitXModel(cfg, device="cpu", seed=0, trainable=True)
    state = TrainState.create(
        model, AdamW(model.parameters(), tcfg.OptimizerConfig(learning_rate=1e-3), 10), seed=7
    )
    kw = dict(batch_size=8, accum_steps=2, seed=1, epoch=0)
    if task == "cp":
        batch, step = next(tsampler.cp_train_batches(data.cp_train, **kw)), cp_train_step
    else:
        batch = next(tsampler.cir_train_batches(
            data.cir_train, data.catalog, max_len=cfg.max_outfit_len, n_negatives=5,
            impl="python", **kw))
        step = cir_train_step
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    catalog = torch.from_numpy(data.catalog.embeddings)
    return state, lambda: step(state, catalog, batch)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """task -> (train state, a callable taking one train step, A = 2)."""
    from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel
    from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
    from outfitx_tpu_torch.models.towers.resnet import ResNet18Config
    from outfitx_tpu_torch.train.original_cp_trainer import OriginalCPTrainer, RawItemSource

    out = {task: _catalog_step(task) for task in ("cp", "cir")}
    tmp = tmp_path_factory.mktemp("ocp")
    enc_cfg = tcfg.ItemEncoderConfig(encoder_type="resnet_sbert", dim_per_modality=8)
    model_cfg = tcfg.OutfitXConfig(
        item_encoder=enc_cfg, max_outfit_len=8, compute_dtype="float32",
        transformer=tcfg.TransformerConfig(n_heads=4, d_ffn=32, n_layers=2, dropout=0.3),
    )
    enc = ItemEncoderModel(
        enc_cfg, device="cpu", seed=1,
        vision_cfg=ResNet18Config(d_out=8, image_size=32, compute_dtype="float32"),
        text_cfg=MiniLMConfig(vocab_size=120, max_len=12, d_model=24, n_heads=4, d_mlp=48,
                              n_layers=1, d_out=8, compute_dtype="float32"),
    )
    split = make_synthetic(n_items=100, d_embed=16, n_outfits=64, seed=9)
    t = OriginalCPTrainer(
        tcfg.CPTrainConfig(n_epochs=1, batch_size=8, accumulation_steps=2,
                           checkpoint_dir=str(tmp / "ckpt"), log_dir=str(tmp / "logs")),
        model_cfg, encoder=enc,
        source=RawItemSource.synthetic(n_items=100, image_size=32, text_len=12, vocab=120, seed=3),
        train_split=split.cp_train, valid_split=split.cp_valid, device="cpu",
    ).__enter__()
    sels = next(t.step_selections(t._train_split, 0))
    out["original_cp"] = (t.state, lambda: original_cp_train_step(
        t.state, (t.microbatch(t._train_split, s) for s in sels)))
    yield out
    t.__exit__(ValueError, None, None)  # no final checkpoints


@pytest.mark.parametrize("task", TASKS)
def test_off_without_a_profiler(steps, task):
    _, step = steps[task]
    trace.clear()
    step()
    assert not torch._C._autograd._profiler_enabled()
    assert trace.records() == []


def _outer(event):
    """The nearest enclosing profiler event named ``outfitx.*``."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("outfitx."):
        p = p.cpu_parent
    return p.name if p is not None else None


@pytest.mark.parametrize("task", TASKS)
def test_on_under_a_profiler(steps, task):
    state, step = steps[task]
    trace.clear()
    number = state.step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    named = collections.defaultdict(list)
    for r in recs:
        named[r.name].append(r)
    want = {"outfitx.step": 1, "outfitx.forward": 2, "outfitx.ahead": 2, "outfitx.backward": 2,
            "outfitx.optimizer": 1}
    if task == "original_cp":
        want.update({"outfitx.stage": 2, "outfitx.gather": 2, "outfitx.encode": 2,
                     "outfitx.vision": 2})
    assert {k: len(v) for k, v in named.items()} == want

    (st,) = named["outfitx.step"]
    assert st.tag == number and st.parent is None
    for name in ("outfitx.forward", "outfitx.backward"):
        assert [r.tag for r in named[name]] == [0, 1]
    assert [r.tag for r in named["outfitx.ahead"]] == [1, 2]
    for fwd, ahead, bwd in zip(*(named[n] for n in
                                 ("outfitx.forward", "outfitx.ahead", "outfitx.backward"))):
        assert fwd.host_end <= ahead.host_start <= ahead.host_end <= bwd.host_start
    parent = {r.name: set() for r in recs}
    for r in recs:
        parent[r.name].add(by_id[r.parent].name if r.parent is not None else None)
        assert r.host_start <= r.host_end and r.device_s is None
        if r.parent is not None:
            outer = by_id[r.parent]
            assert outer.host_start <= r.host_start and r.host_end <= outer.host_end
    assert parent["outfitx.forward"] == parent["outfitx.backward"] == {"outfitx.step"}
    assert parent["outfitx.ahead"] == parent["outfitx.optimizer"] == {"outfitx.step"}
    if task == "original_cp":
        first, second = named["outfitx.stage"]
        assert first.parent == st.id and second.parent == named["outfitx.ahead"][0].id
        assert not any(r.parent == named["outfitx.ahead"][1].id for r in recs)
        assert parent["outfitx.gather"] == {"outfitx.stage"}
        assert sorted(r.parent for r in named["outfitx.gather"]) == sorted(
            r.id for r in named["outfitx.stage"])
        assert parent["outfitx.encode"] == {"outfitx.forward"}
        assert parent["outfitx.vision"] == {"outfitx.encode"}

    events = collections.Counter(
        (e.name, _outer(e)) for e in prof.events() if e.name.startswith("outfitx."))
    spans = collections.Counter(
        (r.name, by_id[r.parent].name if r.parent is not None else None) for r in recs)
    assert events == spans


def test_buffer_keeps_the_newest_and_counts_the_dropped():
    tracer = trace.Tracer(capacity=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with tracer.span("outfitx.test", i):
                pass
    recs = tracer.records()
    assert [r.tag for r in recs] == [2, 3, 4] and tracer.dropped == 2
    assert [r.id for r in recs] == sorted(r.id for r in recs)
    tracer.clear()
    assert tracer.records() == [] and tracer.dropped == 0


def test_profiled_epoch_logs_each_span(tmp_path, monkeypatch):
    """A ``profile_dir`` run writes its Chrome trace and logs a line a span
    name for the profiled epoch alone: calls, host ms, device ms."""
    from outfitx_tpu_torch.train.cp_trainer import CPTrainer
    from outfitx_tpu_torch.train.harness import Trainer

    lines = []
    monkeypatch.setattr(Trainer, "log", lambda self, msg, level=None: lines.append(msg))
    cfg = _cfg()
    data = make_synthetic(n_items=300, d_embed=cfg.d_embed, n_outfits=64,
                          max_len=cfg.max_outfit_len, seed=3)
    tc = tcfg.CPTrainConfig(n_epochs=2, batch_size=8, accumulation_steps=2,
                            checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
    with CPTrainer(tc, cfg, catalog=data.catalog, train_split=data.cp_train,
                   valid_split=data.cp_valid, device="cpu") as t:
        t.profile_dir = str(tmp_path / "trace")
        t.run()
    assert list((tmp_path / "trace").glob("*_epoch1.trace.json"))
    calls = {}
    for line in lines:
        if line.startswith("span "):
            name, rest = line[len("span "):].split(": ")
            calls[name] = int(rest.split(" calls")[0])
            assert rest.endswith("device - ms")
    steps = len(data.cp_train) // 16
    assert calls == {"outfitx.step": steps, "outfitx.forward": 2 * steps,
                     "outfitx.ahead": 2 * steps, "outfitx.backward": 2 * steps,
                     "outfitx.optimizer": steps}


def test_totals_by_name():
    recs = [trace.Record(1, None, "a", None, 0.0, 1.0, 0.5),
            trace.Record(2, 1, "b", None, 0.2, 0.4, None),
            trace.Record(3, None, "a", None, 2.0, 2.5, 0.25)]
    assert trace.totals(recs) == {"a": (2, 1.5, 0.75), "b": (1, 0.2, None)}


# ------------------------------------------------------------ readers --
def _synthetic():
    """Two steps of A = 2: forward device s 0.1..0.4, backward 0.2 each,
    optimizer 0.05 and 0.07, encode 0.01 and 0.03 (two of them), gather
    0.0 and 0.002; forward and backward each 0.25 s on the host."""
    recs, ids = [], iter(range(1, 1000))
    for k in range(2):
        st = next(ids)
        recs.append(trace.Record(st, None, "outfitx.step", k, 10.0 * k, 10.0 * k + 9, 1.0))
        for i in range(2):
            t = 10.0 * k + 2 * i
            recs.append(trace.Record(next(ids), st, "outfitx.forward", i, t, t + 0.25,
                                     0.1 * (2 * k + i + 1)))
            recs.append(trace.Record(next(ids), st, "outfitx.backward", i, t + 1, t + 1.25, 0.2))
        recs.append(trace.Record(next(ids), st, "outfitx.optimizer", None, 10.0 * k + 5,
                                 10.0 * k + 6, (0.05, 0.07)[k]))
        recs.append(trace.Record(next(ids), st, "outfitx.encode", None, 0, 0, (0.01, 0.03)[k]))
        recs.append(trace.Record(next(ids), st, "outfitx.gather", None, 0, 0, (0.0, 0.002)[k]))
    return recs


READINGS = {"forward_ms.train": 500.0, "backward_ms.train": 400.0, "optimizer_ms.train": 60.0,
            "towers_ms.ocp": 20.0, "gather_idle_ms.ocp": 1.0, "enqueue_ms.ocp": 500.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader(metric):
    from outfitbench import registry
    from outfitbench.trace import Record, Spans

    read = registry.reader(metric)
    rec = Record(cell={}, config={}, params={}, spans=Spans(), counters={}, trace=None,
                 derived={})
    assert read(rec, _synthetic()) == pytest.approx(READINGS[metric], rel=1e-12)
    assert read(rec, []) is None
    assert read(None, _synthetic()) is None
    no_device = [trace.Record(r.id, r.parent, r.name, r.tag, r.host_start, r.host_end)
                 for r in _synthetic()]
    if metric == "enqueue_ms.ocp":
        assert read(rec, no_device) == pytest.approx(500.0, rel=1e-12)
    else:
        assert read(rec, no_device) is None


def test_metrics_are_in_the_benchmark():
    from outfitbench import registry

    bench = registry.load()
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"] if m["name"] in READINGS}
    assert cells == {name: ["siglip.train_cp"] if name.endswith(".train")
                     else ["resnet-sbert.train_ocp", "kimivl.train_ocp"] for name in READINGS}


# --------------------------------------------------------------- card --
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.init()
    return torch.device("cuda")


@pytest.mark.card
def test_device_seconds_on_the_card(card):
    """After a synchronize, a span around a 50 ms sleep reads 50 ms of
    device seconds (the card idles through it); behind a queued kernel
    longer than the sleep it reads about 0 (the card is busy throughout
    and the span queues nothing)."""
    tracer = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        with tracer.span("outfitx.idle"):
            time.sleep(0.05)
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 30)  # about half a second on an H100's clock
        t0 = time.perf_counter()
        with tracer.span("outfitx.behind"):
            time.sleep(0.05)
        torch.cuda.synchronize()
        backlog_s = time.perf_counter() - t0
    idle, behind = tracer.records()
    assert backlog_s > 0.1
    assert idle.device_s == pytest.approx(0.05, abs=0.002)
    assert behind.device_s == pytest.approx(0.0, abs=0.002)
