"""Export trained set-transformer parameters to the reference system's
torch checkpoint format (the port of ``outfitx_tpu/models/export_torch.py``).

The reference loads ``{"model": state_dict, ...}`` with
``load_checkpoint(only_load_model=True)``; its ``OutfitX.state_dict()``
names are ``transformer_encoder.layers.{i}.*``, ``outfit_token``,
``cp_ffn``, ``cir_ffn`` and ``target_item_image_emb``, which are this
package's own ``OutfitXModel`` names. So a checkpoint of either package
becomes a reference ``.pth`` through ``models/from_jax.py``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

import torch

from outfitx_tpu_torch.models.from_jax import read_checkpoint_tree, state_dict_from_jax


def reference_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``OutfitXModel`` parameter tree -> the reference ``OutfitX``
    state dict, float32: ``wqkv (d, 3, d)`` becomes ``in_proj_weight
    (3d, d)`` and every matrix is transposed to torch's (out, in)."""
    return state_dict_from_jax(params)


def export_reference_checkpoint(
    ckpt_path: str | pathlib.Path,
    out: str | pathlib.Path,
    *,
    towers_from: str | pathlib.Path | None = None,
) -> pathlib.Path:
    """A checkpoint directory of either package -> a reference-format
    ``.pth``: the reference's ``save_checkpoint`` dict with ``model`` and
    ``epoch`` set and the other entries None (its loaders read only those
    two).

    The reference registers its frozen towers as modules, so its strict
    ``load_state_dict`` wants ``item_encoder.*`` keys too. ``towers_from``
    names a reference-side checkpoint holding them, whose ``item_encoder.*``
    tensors are merged in; it raises ValueError when there are none. The
    file is unpickled in full (``weights_only=False``), as the reference
    stores its config object in it: pass only a file you trust. Without
    it, load the export with ``strict=False``."""
    path = pathlib.Path(ckpt_path)
    model_sd = reference_state_dict(read_checkpoint_tree(path)["params"])
    meta = {}
    if (path / "meta.json").exists():
        with open(path / "meta.json", encoding="utf-8") as f:
            meta = json.load(f)
    if towers_from is not None:
        donor = torch.load(towers_from, map_location="cpu", weights_only=False)
        donor_sd = donor.get("model", donor) if isinstance(donor, dict) else donor
        towers = {k: v for k, v in donor_sd.items() if k.startswith("item_encoder.")}
        if not towers:
            raise ValueError(f"{towers_from} holds no item_encoder.* keys to merge")
        model_sd.update(towers)
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(
        {
            "epoch": int(meta.get("epoch", 0)),
            "config": None,
            "model": model_sd,
            "optimizer": None,
            "scheduler": None,
            "scaler": None,
        },
        out,
    )
    return out
