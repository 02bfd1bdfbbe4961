"""OutfitX in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of the ``outfitx_tpu`` JAX package, module for module: each file
here has its counterpart at the same path under ``outfitx_tpu/``. This
package imports ``torch``, numpy and the standard library only; it never
imports JAX or the JAX package, and keeps its own copy of what it needs.

Ported: serving (``serve.app.build_engine`` and ``serve`` ->
``serve.engine.ServingEngine`` -> ``models.outfit_transformer.OutfitXModel``,
with the HTTP layer, coalescers, live updates, the retrieval routes and the
int8 forward); the frozen CLIP, SigLIP and resnet_sbert towers with the
item encoder and the precompute sweep (``train.precompute``); CP, CIR and
original-CP training and FITB evaluation (``train.cp_trainer``,
``train.cir_trainer``, ``train.original_cp_trainer``,
``train.fitb_trainer``), with asynchronous checkpoint saves; the collate
layer (``data.processors``); the export to the reference's ``.pth``
(``models.export_torch``); the command line, ``python -m
outfitx_tpu_torch.cli``; and the device mesh (``core.mesh``, ``parallel``):
the row-sharded serving catalog and data, tensor and FSDP parallel training
on ``torch.distributed``, one process per mesh position; activation
recomputation (``OutfitXConfig.remat``); and the C++ host assembler of CIR
batches (``native``), built with g++ at first use. Every Pallas kernel of
the JAX package has a hand-written CUDA counterpart under ``csrc/``.

Entry points run on the card (``device="cuda"``) and raise when there is
none, unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from outfitx_tpu_torch.core.config import (  # noqa: F401
    CIRTrainConfig,
    CPTrainConfig,
    FITBTrainConfig,
    ItemEncoderConfig,
    MeshConfig,
    OptimizerConfig,
    OutfitXConfig,
    PrecomputeConfig,
    TrainConfig,
    TransformerConfig,
)

_LAZY = {
    "OutfitXModel": "outfitx_tpu_torch.models.outfit_transformer",
    "ItemEncoderModel": "outfitx_tpu_torch.models.item_encoder",
    "Catalog": "outfitx_tpu_torch.data.catalog",
    "CPTrainer": "outfitx_tpu_torch.train.cp_trainer",
    "CIRTrainer": "outfitx_tpu_torch.train.cir_trainer",
    "FITBTrainer": "outfitx_tpu_torch.train.fitb_trainer",
    "OriginalCPTrainer": "outfitx_tpu_torch.train.original_cp_trainer",
    "PrecomputeRunner": "outfitx_tpu_torch.train.precompute",
    "ServingEngine": "outfitx_tpu_torch.serve.engine",
}


def __getattr__(name: str):
    """Lazy top-level exports (``from outfitx_tpu_torch import CPTrainer``)
    without importing the models for config-only users."""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'outfitx_tpu_torch' has no attribute {name!r}")
