from outfitx_tpu_torch.ops.activations import mish, resolve_activation  # noqa: F401
from outfitx_tpu_torch.ops.attention import masked_mha, mha_reference  # noqa: F401
from outfitx_tpu_torch.ops.layernorm import layer_norm  # noqa: F401
from outfitx_tpu_torch.ops.retrieval import (  # noqa: F401
    fitb_pick,
    pairwise_l2,
    retrieve,
    retrieve_per_query_pools,
    topk_smallest,
)
