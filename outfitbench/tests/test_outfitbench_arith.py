"""The benchmark's arithmetic, the trace's reduction and lookups, on the CPU."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys

import numpy as np
import pytest

from outfitbench import flops, readers, registry
from outfitbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS, kind
from outfitbench.trace import Record, reduce_events
from outfitbench.tests.conftest import ROOT


def _siglip():
    return json.loads((ROOT / "outfitbench/configs/outfitx-siglip.json").read_text())


def test_cp_step_flops_closed_form():
    # 6 layers x (4 d^2 + 2 d d_ffn) weights x 52,224 tokens x 2 x 3 x 4
    # microbatches, plus the two attention products and the CP head.
    cfg = _siglip()
    d, ffn, s, b, a = 1536, 2024, 17, 3072, 4
    weights = 6 * (4 * d * d + 2 * d * ffn) * 2 * (b * s)
    attention = 6 * 4 * b * s * s * d
    want = 3 * a * (weights + attention + 2 * b * d)
    got = flops.cp_step_flops(cfg, b, a)
    assert got == want
    assert abs(3 * a * weights - 117.8e12) / 117.8e12 < 1e-3


def test_resnet18_flops_published():
    # ResNet-18 at 224 x 224: 1.82 G multiply-adds (He et al., 2016).
    assert abs(flops.resnet18_forward_flops(224) - 3.64e9) / 3.64e9 < 0.01


@pytest.mark.parametrize("shape,backward", [
    ((3072, 16, 17, 96), False), ((3072, 16, 17, 96), True),
    ((350, 16, 17, 8), False), ((350, 16, 17, 8), True),
])
def test_attention_bound(shape, backward):
    b, h, l, dh = shape
    tensors, products = (7, 5) if backward else (4, 2)
    t_bytes = (tensors * b * h * l * dh * 2 + b * l) / HBM_BYTES_PER_S
    t_ops = 2 * products * b * h * l * l * dh / PEAK_FLOPS["bfloat16"]
    assert flops.attention_bound(shape, "bfloat16", backward) == max(t_bytes, t_ops)
    # At L = 17 the set transformer's attention is bound by its bytes.
    assert t_bytes > t_ops


def test_attention_launches_of_train_cp():
    got = flops.attention_launches(_siglip(), 3072, 4)
    assert got == [((3072, 16, 17, 96), False, 24), ((3072, 16, 17, 96), True, 24)]


def test_kernel_kinds():
    assert kind("masked_mha_fwd_narrow_kernel") == "masked_mha_fwd"
    assert kind("void at::native::vectorized_elementwise_kernel<4, ...>") == "elementwise"
    assert kind("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "collective"
    assert kind("nvjet_hsh_128x256") == "matmul"
    assert kind("something") == "other"


def test_reduce_events_busy_and_named_gaps():
    # marker at 10.0 s on the trace's clock = host 100.0; kernels at +1..+2
    # and +3..+3.5; a host span covers the gap between them.
    events = [("marker", 10.0, 10.001), ("k1", 11.0, 12.0), ("k2", 13.0, 13.5),
              ("k3", 13.2, 13.4)]
    out = reduce_events(events, 100.0, 104.0, [(101.5, 103.5, "outfitbench.step")])
    assert math.isclose(out["busy_s"], 0.001 + 1.0 + 0.5)
    assert out["window_s"] == 4.0
    assert math.isclose(out["span_s"], 3.5)
    assert out["kernels"]["k1"] == [1.0, 1]
    assert math.isclose(out["idle"]["idle:outfitbench.step"], 1.0)
    assert math.isclose(sum(out["idle"].values()) + out["busy_s"], 4.0)


def test_step_mfu_reads_the_traces_seconds():
    """The profiled steps' operations over the trace's seconds from the
    marker to the last operation's end, over the peak; silent without a
    trace."""
    events = [("marker", 10.0, 10.001), ("k1", 10.1, 11.0), ("k2", 11.1, 12.0)]
    summary = reduce_events(events, 100.0, 102.5)
    derived = {"step_flops": 989e12 * 0.25, "profiled_steps": 2, "chips": 1}
    rec = Record({}, {}, {}, None, {}, summary, derived)
    assert math.isclose(readers.step_mfu(rec), 100.0 * 2 * 0.25 / 2.0)
    assert readers.step_mfu(Record({}, {}, {}, None, {}, None, derived)) is None


def test_lookup_by_name():
    bench = registry.load()
    cell = registry.cell(bench, "siglip.train_cp")
    assert registry.config(bench, cell["config"])["d_embed"] == 1536
    assert registry.workload(cell["name"])["driver"] == "train"
    assert registry.driver("train").run
    names = {m["name"] for m in registry.per_layer(bench, "siglip.train_cp")}
    assert "step_mfu.train" in names and "step_mfu.ocp" not in names
    assert {m["name"] for m in registry.end_to_end(bench, "resnet-sbert.train_ocp")} == {
        "ocp_outfits_per_s", "setup_s"}
    for m in bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    with pytest.raises(KeyError):
        registry.cell(bench, "no.such.cell")


def test_adding_a_cell_config_and_metric_edits_no_file(tmp_path):
    """A new configuration, cell and per-layer metric are new files and new
    entries in BENCHMARK.json: in a copy, with no file changed, the
    registry finds them and the new reader reads a record."""
    shutil.copytree(ROOT / "outfitbench", tmp_path / "outfitbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "outfitbench").rglob("*")
              if p.is_file()}
    pkg = tmp_path / "outfitbench"
    cfg = json.loads((pkg / "configs/outfitx-siglip.json").read_text())
    cfg.update(name="outfitx-siglip-wide-catalog", catalog_items=1_000_000)
    (pkg / "configs/outfitx-siglip-wide-catalog.json").write_text(json.dumps(cfg))
    params = json.loads((pkg / "workloads/siglip.train_cp.json").read_text())
    (pkg / "workloads/wide.train_cp_b1024.json").write_text(json.dumps(dict(params, batch=1024)))
    (pkg / "metrics/steps.train.py").write_text(
        "def read(rec):\n    return rec.derived.get('steps')\n")
    bench["configs"].append(dict(bench["configs"][0], name="outfitx-siglip-wide-catalog",
                                 file="outfitbench/configs/outfitx-siglip-wide-catalog.json"))
    bench["workloads"].append({"name": "wide.train_cp_b1024", "config": "outfitx-siglip-wide-catalog",
                               "traffic": "train_cp_b1024", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "model step",
                               "moves": "train_outfits_per_s", "workloads": ["wide.train_cp_b1024"]})
    for m in bench["end_to_end"]:
        if "siglip.train_cp" in m.get("workloads", ()):
            m["workloads"].append("wide.train_cp_b1024")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "outfitbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
    code = (
        "import json, sys\n"
        "from outfitbench import registry\n"
        "from outfitbench.trace import Record\n"
        "b = registry.load()\n"
        "c = registry.cell(b, 'wide.train_cp_b1024')\n"
        "cfg = registry.config(b, c['config'])\n"
        "p = registry.workload(c['name'])\n"
        "names = [m['name'] for m in registry.per_layer(b, c['name'])]\n"
        "rec = Record(c, cfg, p, None, {}, None, {'steps': 7})\n"
        "e2e = [m['name'] for m in registry.end_to_end(b, c['name'])]\n"
        "print(json.dumps([cfg['catalog_items'], p['batch'], p['driver'], names, e2e,\n"
        "                  registry.reader('steps.train')(rec)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True)
    got = json.loads(out.stdout)
    assert got == [1_000_000, 1024, "train", ["steps.train"], ["train_outfits_per_s", "setup_s"], 7]
