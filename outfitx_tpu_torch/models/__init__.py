from outfitx_tpu_torch.models.from_jax import (  # noqa: F401
    load_jax_checkpoint,
    state_dict_from_jax,
)
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel  # noqa: F401
