from outfitx_tpu_torch.losses.focal import focal_loss  # noqa: F401
from outfitx_tpu_torch.losses.ranking import set_wise_ranking_loss  # noqa: F401
