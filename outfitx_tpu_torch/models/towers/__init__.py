from outfitx_tpu_torch.models.towers.common import TowerEncoder  # noqa: F401
from outfitx_tpu_torch.models.towers.text import TextTower, TextTowerConfig  # noqa: F401
from outfitx_tpu_torch.models.towers.vision import (  # noqa: F401
    VisionTower,
    VisionTowerConfig,
)
