"""The PyTorch port's command line (``outfitx_tpu_torch/cli``, on argparse)
against the JAX package's (on click).

Each command, given the same argv, hands its trainer (or runner, engine,
exporter; replaced here by recorders) the configs the JAX CLI's
``_build_cfg`` / ``_model_cfg`` build, field for field, the mesh layout
and ``--remat`` among them. ``fitb --mode train-valid`` fails with a
message; ``export-torch`` runs for real at a tiny size; ``--help`` runs in
a subprocess that imports neither JAX nor click.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from click.testing import CliRunner

from outfitx_tpu.cli import main as jax_cli
from outfitx_tpu.core import runtime as jax_runtime
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu_torch.cli import main as cli
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.models import state_dict_from_jax
from outfitx_tpu_torch.models.export_torch import reference_state_dict
from outfitx_tpu_torch.train.checkpoint import CheckpointManager

JAX_ONLY_FIELDS = set()


class Recorder:
    """Stands in for a trainer, runner or engine: keeps what it was given."""

    calls: list = []

    def __init__(self, *args, **kwargs):
        Recorder.calls.append((args, kwargs))
        self.profile_dir = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def resume(self, tag):
        Recorder.calls.append((("resume", tag), {}))

    def run(self):
        return {"recorded": True}


def _record(fn):
    def recorder(*args, **kwargs):
        Recorder.calls.append(((fn,) + args, kwargs))
        return {"recorded": True}

    return recorder


# command -> (module paths whose attribute is replaced, attribute)
TARGETS = {
    "cp": [("train.cp_trainer", "CPTrainer")],
    "cir": [("train.cir_trainer", "CIRTrainer")],
    "fitb": [("train.fitb_trainer", "FITBTrainer")],
    "original-cp": [("train.original_cp_trainer", "OriginalCPTrainer")],
    "pes": [("train.precompute", "PrecomputeRunner")],
    "demo": [("serve.app", "build_engine"), ("serve.app", "serve")],
    "export-torch": [("models.export_torch", "export_reference_checkpoint")],
}


def _install(monkeypatch, command, package):
    import importlib

    for module, attr in TARGETS[command]:
        mod = importlib.import_module(f"{package}.{module}")
        fake = Recorder if attr[0].isupper() else _record(attr)
        monkeypatch.setattr(mod, attr, fake)


def _plain(obj):
    """A config (or any value) as plain data, without the JAX-only fields."""
    if dataclasses.is_dataclass(obj):
        return {k: _plain(v) for k, v in dataclasses.asdict(obj).items()
                if k not in JAX_ONLY_FIELDS}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items() if k not in JAX_ONLY_FIELDS}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _calls_jax(monkeypatch, argv):
    Recorder.calls = []
    monkeypatch.setattr(jax_runtime, "force_platform_from_env", lambda: None)
    monkeypatch.setattr(jax_runtime, "enable_compilation_cache", lambda: None)
    _install(monkeypatch, argv[0], "outfitx_tpu")
    res = CliRunner().invoke(jax_cli.cli, argv, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return Recorder.calls


def _calls_port(monkeypatch, argv, capsys):
    Recorder.calls = []
    _install(monkeypatch, argv[0], "outfitx_tpu_torch")
    assert cli.main(list(argv)) == 0
    out = capsys.readouterr().out.strip().splitlines()
    if argv[0] != "demo":  # every other command prints one JSON line
        assert isinstance(json.loads(out[-1]), dict)
    return Recorder.calls


ARGVS = [
    ["cp"],
    ["cp", "--epochs", "3", "--batch-size", "64", "--accum", "2", "--lr", "1e-3",
     "--log-dir", "L", "--save-every", "2", "--encoder", "clip", "--polyvore-type",
     "disjoint", "--dataset-dir", "D", "--checkpoint-dir", "C", "--mode", "test",
     "--mesh-data", "1", "--resume", "final"],
    ["cir"],
    ["cir", "--warm-start-from", "W", "--switch-to-hard-epoch", "5",
     "--pool-threshold", "7", "--encoder", "resnet_sbert", "--accum", "4"],
    ["fitb", "--checkpoint-from", "X", "--encoder", "resnet_sbert", "--batch-size", "9"],
    ["original-cp"],
    ["original-cp", "--batch-size", "12", "--accum", "3", "--epochs", "2", "--lr", "5e-4"],
    ["pes", "--batch-size", "256", "--output-dir", "O", "--encoder", "clip"],
    ["pes", "--shards", "3", "--slice-index", "1", "--synthetic", "--synthetic-items", "7"],
    ["demo", "--synthetic", "--quantized", "--coalesce-ms", "3", "--max-age", "5",
     "--port", "1234", "--catalog-dtype", "bfloat16", "--spare-capacity", "8",
     "--quantize-model", "--exact-topk", "--max-rss-gb", "2"],
    ["export-torch", "--params", "P", "--out", "O", "--towers-from", "T"],
    # the mesh options build MeshConfig field for field; --shard-catalog
    # serves the row-sharded catalog
    ["cp", "--mesh-data", "4"],
    ["cir", "--mesh-model", "2", "--mesh-data", "2"],
    ["demo", "--shard-catalog", "--synthetic"],
    # both CLIs set remat=True
    ["cp", "--remat"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_command_builds_the_jax_configs(monkeypatch, capsys, argv):
    want = _calls_jax(monkeypatch, argv)
    got = _calls_port(monkeypatch, argv, capsys)
    assert len(got) == len(want) > 0
    for (g_args, g_kw), (w_args, w_kw) in zip(got, want):
        g_kw = {k: v for k, v in g_kw.items() if k != "device"}
        if argv[0] == "pes":  # the JAX runner takes params, the port weights
            assert w_kw.pop("params") is None
        assert _plain(g_args) == _plain(w_args)
        assert _plain(g_kw) == _plain(w_kw)
    if argv[0] in ("cp", "cir", "fitb", "original-cp"):
        cfg = got[0][0][0]
        assert isinstance(cfg, tcfg.TrainConfig) and cfg.async_saves
    if argv[0] in ("cp", "cir", "fitb"):
        assert got[0][0][1].remat == ("--remat" in argv)


def test_original_cp_envelope_and_devices(monkeypatch, capsys):
    calls = _calls_port(monkeypatch, ["original-cp", "--device", "cpu"], capsys)
    (cfg, model_cfg, mode), kw = calls[0]
    assert (cfg.batch_size, cfg.accumulation_steps) == (350, 10)
    assert model_cfg.item_encoder.encoder_type == "resnet_sbert" and mode == "train-valid"
    assert kw["device"] == "cpu"
    calls = _calls_port(monkeypatch, ["cp"], capsys)
    assert calls[0][1]["device"] == "cuda"


def test_original_cp_takes_the_dsv2lite_pair(monkeypatch, capsys):
    """--encoder resnet_dsv2lite puts DeepSeek-V2-Lite in MiniLM's place;
    another pair's name leaves original-CP on resnet_sbert."""
    argv = ["original-cp", "--encoder", "resnet_dsv2lite", "--device", "cpu"]
    (cfg, model_cfg, mode), kw = _calls_port(monkeypatch, argv, capsys)[0]
    assert model_cfg.item_encoder.encoder_type == "resnet_dsv2lite"
    assert model_cfg.item_encoder.text_model_name == "deepseek-ai/DeepSeek-V2-Lite"
    assert model_cfg.d_embed == 128 and (cfg.batch_size, cfg.accumulation_steps) == (350, 10)
    argv = ["original-cp", "--encoder", "clip", "--device", "cpu"]
    (_, model_cfg, _), _ = _calls_port(monkeypatch, argv, capsys)[0]
    assert model_cfg.item_encoder.encoder_type == "resnet_sbert"


@pytest.mark.parametrize("argv, words", [
    (["fitb", "--mode", "train-valid"], "test only"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else a)
def test_unsupported_options_fail_with_a_message(monkeypatch, capsys, argv, words):
    _install(monkeypatch, argv[0], "outfitx_tpu_torch")
    Recorder.calls = []
    with pytest.raises(SystemExit) as err:
        cli.main(argv)
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert words in msg, msg
    assert not Recorder.calls


def test_export_torch_runs(tmp_path, capsys):
    from outfitx_tpu.core.config import ItemEncoderConfig, OutfitXConfig, TransformerConfig

    cfg = OutfitXConfig(
        item_encoder=ItemEncoderConfig(dim_per_modality=16),
        transformer=TransformerConfig(n_heads=2, d_ffn=32, n_layers=2),
        max_outfit_len=4, compute_dtype="float32",
    )
    params = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    path = CheckpointManager(tmp_path, "run").save(
        "final", params=state_dict_from_jax(params), epoch=4
    )
    out = tmp_path / "export" / "ref.pth"
    assert cli.main(["export-torch", "--params", str(path), "--out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out.strip()) == {"exported": str(out)}
    payload = torch.load(out, weights_only=True)
    assert payload["epoch"] == 4
    want = reference_state_dict(params)
    assert sorted(payload["model"]) == sorted(want)
    for k, v in want.items():
        assert torch.equal(payload["model"][k], v), k


def test_help_imports_neither_jax_nor_click():
    code = (
        "import runpy, sys\n"
        "before = set(sys.modules)\n"
        "for argv in (['--help'], ['original-cp', '--help']):\n"
        "    sys.argv = ['cli'] + argv\n"
        "    try:\n"
        "        runpy.run_module('outfitx_tpu_torch.cli', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "added = set(sys.modules) - before\n"
        "bad = sorted(m for m in added if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'click', 'outfitx_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "original-cp" in out.stdout and "--batch-size" in out.stdout
    assert out.stdout.rstrip().endswith("ok")
