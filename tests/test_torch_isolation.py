"""The PyTorch port stands alone: nothing in ``outfitx_tpu_torch`` or in
``chip_smoke.py`` imports JAX, the JAX package or ``safetensors``."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "outfitx_tpu", "safetensors"}
PORT_FILES = sorted((ROOT / "outfitx_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    assert len(PORT_FILES) > 10
    for name in ("masked_mha_fwd", "masked_mha_bwd", "attn_block", "mlp_fused", "layernorm"):
        assert (ROOT / "outfitx_tpu_torch" / "csrc" / f"{name}.cu").is_file()
    scanned = {str(p.relative_to(ROOT / "outfitx_tpu_torch")) for p in PORT_FILES[:-1]}
    for module in (
        "ops/layernorm.py", "ops/quantization.py", "ops/retrieval.py",
        "serve/app.py", "serve/browse.py", "serve/coalesce.py", "serve/engine.py",
        "serve/live_update.py", "serve/openapi.py", "serve/stats.py", "serve/ui.py",
        "models/quantized.py", "models/convert.py", "models/pretrained.py",
        "models/towers/resnet.py", "models/towers/minilm.py", "utils/__init__.py",
    ):
        assert module in scanned, module


def test_chip_smoke_builds_every_kernel_source():
    """``chip_smoke.KERNELS`` names exactly the ``csrc/*.cu`` sources."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text(encoding="utf-8"))
    kernels = next(
        ast.literal_eval(node.value) for node in tree.body
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "KERNELS"
    )
    sources = sorted(p.stem for p in (ROOT / "outfitx_tpu_torch" / "csrc").glob("*.cu"))
    assert sorted(kernels) == sources


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "def jaxy():\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "before = jaxy()\n"
        "import outfitx_tpu_torch\n"
        "for m in pkgutil.walk_packages(outfitx_tpu_torch.__path__, 'outfitx_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "added = sorted(set(jaxy()) - set(before))\n"
        "assert not added, added\n"
        "print('ok', len([m for m in sys.modules if m.startswith('outfitx_tpu_torch')]))\n"
    ) % (FORBIDDEN,)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_importing_the_whole_port_loads_no_pil_and_no_transformers():
    """The card's machine has no PIL, and tokenizer files are optional: both
    are imported inside the functions that need them. ``safetensors`` is
    never imported: the port reads the format itself
    (``models/pretrained.py read_safetensors``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import outfitx_tpu_torch\n"
        "for m in pkgutil.walk_packages(outfitx_tpu_torch.__path__, 'outfitx_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('PIL', 'transformers', 'safetensors'))\n"
        "assert not bad, bad\n"
        "assert 'outfitx_tpu_torch.train.precompute' in sys.modules\n"
        "assert 'outfitx_tpu_torch.models.pretrained' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
