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

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

STATS = {
    "clip": (CLIP_MEAN, CLIP_STD),
    "siglip": (SIGLIP_MEAN, SIGLIP_STD),
    "resnet_sbert": (IMAGENET_MEAN, IMAGENET_STD),
}


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


def make_normalizer(encoder_type: str):
    """(B, 3, H, W) uint8 -> float32 normalised, on the images' device."""
    mean, std = STATS[encoder_type]

    def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
        dev = x_uint8.device
        mean_t = torch.tensor(mean, dtype=torch.float32, device=dev).view(1, 3, 1, 1)
        std_t = torch.tensor(std, dtype=torch.float32, device=dev).view(1, 3, 1, 1)
        return (x_uint8.to(torch.float32) / 255.0 - mean_t) / std_t

    return normalize
