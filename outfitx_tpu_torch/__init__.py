"""OutfitX in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of the ``outfitx_tpu`` JAX package, module for module: each file
here has its counterpart at the same path under ``outfitx_tpu/``. This
package imports ``torch``, numpy and the standard library only; it never
imports JAX or the JAX package, and keeps its own copy of what it needs.

Ported so far: the serving path (``serve.app.build_engine`` ->
``serve.engine.ServingEngine`` -> the task functions in ``serve.programs``
-> ``models.outfit_transformer.OutfitXModel``) and CP and CIR training on
precomputed embeddings (``train.cp_trainer.CPTrainer``,
``train.cir_trainer.CIRTrainer`` -> ``train.steps`` -> the model with
dropout, the losses and ``train.optim.AdamW``). The set-attention core
runs in the hand-written CUDA kernels ``csrc/masked_mha_fwd.cu`` and, for
its gradient, ``csrc/masked_mha_bwd.cu`` on the card.

Entry points run on the card (``device="cuda"``) and raise when there is
none, unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from outfitx_tpu_torch.core.config import (  # noqa: F401
    ItemEncoderConfig,
    OutfitXConfig,
    TransformerConfig,
)
