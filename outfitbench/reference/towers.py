"""The resnet_sbert item encoder in plain float32 PyTorch: torchvision's
ResNet-18 (He et al., 2016) on ImageNet-normalised 224 x 224 images, with
BatchNorm on its stored statistics, and sentence-transformers'
all-MiniLM-L6-v2 (a post-LN BERT: 6 layers of 384, 12 heads, gelu MLP of
1536, LayerNorm eps 1e-12) mean-pooled over the real tokens; each followed
by its fresh linear head (ResNet's ``fc``, MiniLM's ``proj``), L2
normalised, image and text concatenated (OutfitTransformer,
arXiv:2204.04812). The towers are frozen: only the heads take a
gradient, so the towers' features are computed without one, in blocks of
items."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from outfitbench.reference.numerics import matmul, to_fp8
from outfitbench.reference.set_transformer import NEG, layer_norm, linear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv(x, w, stride, padding, low):
    if low:
        return to_fp8(F.conv2d(to_fp8(x), to_fp8(w), stride=stride, padding=padding))
    return F.conv2d(x, w, stride=stride, padding=padding)


def _bn(p, name, x, eps=1e-5, calibrate: bool = False):
    if calibrate:  # set the stored statistics to this batch's, in place
        p[name + ".running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        p[name + ".running_var"].copy_(x.var(dim=(0, 2, 3), unbiased=False))
    scale = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"] + eps)
    bias = p[name + ".bias"] - p[name + ".running_mean"] * scale
    return x * scale[None, :, None, None] + bias[None, :, None, None]


@torch.no_grad()
def resnet18_features(p: Dict[str, torch.Tensor], images_uint8, low: bool = False,
                      calibrate: bool = False):
    """(B, 3, S, S) uint8 -> (B, 512) pooled features (before ``fc``).
    ``calibrate`` first sets each BatchNorm's stored statistics to those of
    its input over these images, as training would have left them."""
    dev = images_uint8.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    x = (images_uint8.float() / 255.0 - mean) / std
    x = F.relu(_bn(p, "bn1", _conv(x, p["conv1.weight"], 2, 3, low), calibrate=calibrate))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for si in range(4):
        for bi in range(2):
            q = f"layer{si + 1}.{bi}"
            stride = 2 if bi == 0 and si > 0 else 1
            y = F.relu(_bn(p, q + ".bn1", _conv(x, p[q + ".conv1.weight"], stride, 1, low),
                           calibrate=calibrate))
            y = _bn(p, q + ".bn2", _conv(y, p[q + ".conv2.weight"], 1, 1, low), calibrate=calibrate)
            if stride != 1:
                x = _bn(p, q + ".downsample.1", _conv(x, p[q + ".downsample.0.weight"], stride, 0, low),
                        calibrate=calibrate)
            x = F.relu(x + y)
    return x.mean(dim=(2, 3))


@torch.no_grad()
def minilm_features(p: Dict[str, torch.Tensor], cfg: Dict, ids, attn, low: bool = False):
    """(B, T) token ids and attention mask (1 = token) -> (B, 384) mean of
    the real tokens' final states (before ``proj``)."""
    b, t = ids.shape
    d, h = cfg["text_width"], cfg["text_heads"]
    eps = 1e-12
    x = p["word_emb"][ids.long()] + p["pos_emb"][None, :t] + p["type_emb"][0][None, None]
    x = layer_norm(x, p["emb_ln.weight"], p["emb_ln.bias"], eps)
    pad = attn == 0
    for i in range(cfg["text_layers"]):
        q_ = f"layers.{i}."

        def heads(name):
            y = linear(x, p[q_ + name + ".weight"], p[q_ + name + ".bias"], low)
            return y.view(b, t, h, d // h).transpose(1, 2)

        s = matmul(heads("q"), heads("k").transpose(-1, -2), low) / math.sqrt(d // h)
        s = s.masked_fill(pad[:, None, None, :], NEG)
        o = matmul(torch.softmax(s, dim=-1), heads("v"), low).transpose(1, 2).reshape(b, t, d)
        x = layer_norm(x + linear(o, p[q_ + "o.weight"], p[q_ + "o.bias"], low),
                       p[q_ + "attn_ln.weight"], p[q_ + "attn_ln.bias"], eps)
        mid = F.gelu(linear(x, p[q_ + "fc1.weight"], p[q_ + "fc1.bias"], low), approximate="none")
        x = layer_norm(x + linear(mid, p[q_ + "fc2.weight"], p[q_ + "fc2.bias"], low),
                       p[q_ + "mlp_ln.weight"], p[q_ + "mlp_ln.bias"], eps)
    w = attn.float()[..., None]
    return (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1e-9)


def item_embeddings(p: Dict[str, torch.Tensor], cfg: Dict, images, ids, attn, block: int = 700,
                    low: bool = False):
    """(N, ...) raw items -> (N, 2 dim_per_modality) embeddings: the frozen
    towers' features in blocks, then the heads (which take gradients),
    each half L2 normalised."""
    vis = torch.cat([resnet18_features({k[7:]: v for k, v in p.items() if k.startswith("vision.")},
                                       images[s : s + block], low)
                     for s in range(0, images.shape[0], block)])
    txt_p = {k[5:]: v for k, v in p.items() if k.startswith("text.")}
    txt = torch.cat([minilm_features(txt_p, cfg, ids[s : s + block], attn[s : s + block], low)
                     for s in range(0, ids.shape[0], block)])
    img = linear(vis, p["vision.fc.weight"], p["vision.fc.bias"], low)
    txt = linear(txt, p["text.proj.weight"], p["text.proj.bias"], low)
    img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
    return torch.cat([img, txt], dim=-1)
