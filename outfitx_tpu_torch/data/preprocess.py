"""Image preprocessing: decode and resize to uint8 on the host, normalise on
the device.

Copy of ``outfitx_tpu/data/preprocess.py``. The host does the part that
cannot move (JPEG decode, resize, centre crop to uint8) and ships uint8, a
quarter of float32's bytes; ``(x / 255 - mean) / std`` runs on the device in
front of the encoder.
"""

from __future__ import annotations

import numpy as np
import torch

from outfitx_tpu_torch.core.config import ENCODER_PAIRS


def load_image_uint8(path_or_img, size: int) -> np.ndarray:
    """Decode, bicubic-resize the short side to ``size``, centre-crop with a
    floored margin (as the HF image processors do) -> (3, size, size) uint8,
    channel-first. PIL is imported here, so the synthetic path needs none."""
    from PIL import Image

    img = (
        Image.open(path_or_img)
        if isinstance(path_or_img, (str, bytes)) or hasattr(path_or_img, "read")
        else path_or_img
    )
    img = img.convert("RGB")
    w, h = img.size
    if w <= h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, dtype=np.uint8).transpose(2, 0, 1)


def image_stats(encoder_type: str, shape):
    """The pair's image mean and std (``ENCODER_PAIRS``) on a device: a
    function of the device -> two float32 tensors of ``shape``, made once a
    device (a tensor made from host values on the card is a copy that waits
    for the card's queue to drain)."""
    row, made = ENCODER_PAIRS[encoder_type], {}

    def on(dev: torch.device):
        if dev not in made:
            made[dev] = tuple(torch.tensor(v, dtype=torch.float32, device=dev).view(shape)
                              for v in (row.mean, row.std))
        return made[dev]

    return on


def make_normalizer(encoder_type: str):
    """(B, 3, H, W) uint8 -> float32 normalised with the pair's image
    statistics, on the images' device."""
    stats = image_stats(encoder_type, (1, 3, 1, 1))

    def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
        mean_t, std_t = stats(x_uint8.device)
        return (x_uint8.to(torch.float32) / 255.0 - mean_t) / std_t

    return normalize
