"""Engine wiring (the ``build_engine`` of ``outfitx_tpu/serve/app.py``).

The HTTP handler, request coalescer, OpenAPI document and UI come with a
later slice.
"""

from __future__ import annotations

import pathlib

from outfitx_tpu_torch.core.config import OutfitXConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.sampler import CandidatePools
from outfitx_tpu_torch.data.splits import OutfitSplit
from outfitx_tpu_torch.models.from_jax import load_jax_checkpoint
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.serve.engine import ServingEngine


def build_engine(
    *,
    synthetic: bool = False,
    model_cfg: OutfitXConfig | None = None,
    dataset_dir: str = "datasets/polyvore",
    polyvore_type: str = "nondisjoint",
    checkpoint_dir: str = "checkpoints",
    device: str = "cuda",
) -> ServingEngine:
    """Build a serving engine.

    ``synthetic`` serves a generated 2,000-item catalog with pools of 1,000;
    otherwise the Polyvore catalog under ``dataset_dir`` is loaded, with
    pools from its CIR test split when that split exists. The CP and CIR
    weights come from the JAX package's ``best_auc`` and ``best_recall@1``
    checkpoints under ``checkpoint_dir`` where they exist, and are random
    (seed 0) otherwise.
    """
    resolve_device(device)  # fail before any loading when there is no card
    model_cfg = model_cfg or OutfitXConfig()
    if synthetic:
        from outfitx_tpu_torch.data.synthetic import make_synthetic

        data = make_synthetic(
            n_items=2000,
            d_embed=model_cfg.d_embed,
            n_outfits=256,
            max_len=model_cfg.max_outfit_len,
        )
        catalog = data.catalog
        pools = CandidatePools.build(
            catalog, data.cir_valid, pool_size=1000, threshold=1
        )
    else:
        catalog = Catalog.from_polyvore(
            dataset_dir, model_name=model_cfg.model_name
        )
        try:
            cir_split = OutfitSplit.load(
                catalog, dataset_dir, polyvore_type, "test",
                model_cfg.max_outfit_len,
            )
            pools = CandidatePools.build(catalog, cir_split)
        except FileNotFoundError:
            pools = None  # whole-catalog retrieval
    params = OutfitXModel(model_cfg, device="cpu").state_dict()
    cp_params = cir_params = params
    root = pathlib.Path(checkpoint_dir)
    cp_dir = root / f"{model_cfg.model_name}-cp" / "best_auc"
    cir_dir = root / f"{model_cfg.model_name}-cir" / "best_recall@1"
    if cp_dir.exists():
        cp_params = load_jax_checkpoint(cp_dir)
    if cir_dir.exists():
        cir_params = load_jax_checkpoint(cir_dir)
    return ServingEngine(
        model_cfg=model_cfg,
        catalog=catalog,
        cp_params=cp_params,
        cir_params=cir_params,
        pools=pools,
        device=device,
    )
