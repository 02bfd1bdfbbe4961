"""Operations and bytes computed from a configuration's shapes: what the
model asks for, not what a kernel does. Used for the step's share of the
card's peak and for the attention kernels' share of their roofline."""

from __future__ import annotations

from typing import Dict, List, Tuple

from outfitbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

_ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_bound(shape: Tuple[int, int, int, int], dtype: str, backward: bool = False) -> float:
    """Least seconds for masked attention on (B, H, L, Dh) at the dtype's
    peak. Forward: q, k, v read and out written once, plus the (B, L) mask;
    4*B*H*L*L*Dh operations (two products). Backward: q, k, v, g read and
    dq, dk, dv written once, plus the mask; 10*B*H*L*L*Dh operations (S,
    dP, dV, dQ and dK)."""
    b, h, l, dh = shape
    tensors, products = (7, 5) if backward else (4, 2)
    nbytes = tensors * b * h * l * dh * _ELEM[dtype] + b * l
    ops = 2 * products * b * h * l * l * dh
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def set_transformer_forward_flops(cfg: Dict, batch: int) -> float:
    """Operations of one forward of the set transformer over ``batch``
    outfits of ``max_outfit_len`` items and the prefix token: the four
    layer matrices and the two attention products a layer, and the CP head.
    Biases, norms and activations are not counted."""
    d, ffn, n = cfg["d_embed"], cfg["d_ffn"], cfg["n_layers"]
    s = cfg["max_outfit_len"] + 1
    tokens = batch * s
    weights = 4 * d * d + 2 * d * ffn
    attention = 4 * batch * s * s * d  # Q K^T and P V over all heads
    return n * (2 * tokens * weights + attention) + 2 * batch * d


def resnet18_forward_flops(image_size: int) -> float:
    """Operations of one ResNet-18 forward of a square image (convolutions
    and the final pooling-free layers, 2 per multiply-add): 3.64e9 at 224."""
    s = image_size
    total = 0.0

    def conv(h_out, c_in, c_out, k):
        return 2.0 * h_out * h_out * c_in * c_out * k * k

    h = s // 2
    total += conv(h, 3, 64, 7)
    h //= 2  # max pool
    c = 64
    for stage, c_out in enumerate((64, 128, 256, 512)):
        for block in range(2):
            stride = 2 if (stage > 0 and block == 0) else 1
            h_out = h // stride
            total += conv(h_out, c if block == 0 else c_out, c_out, 3)
            total += conv(h_out, c_out, c_out, 3)
            if stride == 2:
                total += conv(h_out, c, c_out, 1)  # downsample
            h = h_out
        c = c_out
    return total


def minilm_forward_flops(cfg: Dict, items: int) -> float:
    """Operations of one MiniLM forward over ``items`` texts of ``text_len``
    tokens: four attention matrices and the two MLP matrices a layer, and
    the two attention products."""
    d, ffn, n, t = cfg["text_width"], cfg["text_ffn"], cfg["text_layers"], cfg["text_len"]
    tokens = items * t
    return n * (2 * tokens * (4 * d * d + 2 * d * ffn) + 4 * items * t * t * d)


def cp_step_flops(cfg: Dict, batch: int, accumulation: int) -> float:
    """Model operations of one CP optimizer step: forward and backward (3x
    the forward) of the set transformer over every microbatch; no
    recomputation counted."""
    return 3.0 * accumulation * set_transformer_forward_flops(cfg, batch)


def original_cp_step_flops(cfg: Dict, batch: int, accumulation: int) -> float:
    """Model operations of one original-CP optimizer step: the frozen
    towers' forward over every item slot (pads included, as they run), the
    set transformer's forward and backward, the heads' projections."""
    items = batch * cfg["max_outfit_len"]
    towers = items * resnet18_forward_flops(cfg["image_size"]) + minilm_forward_flops(cfg, items)
    heads = 3.0 * 2 * items * (512 + cfg["text_width"]) * cfg["dim_per_modality"]
    return accumulation * (towers + heads + 3.0 * set_transformer_forward_flops(cfg, batch))


def attention_launches(cfg: Dict, batch: int, accumulation: int, towers: bool = False) -> List[Tuple[Tuple[int, int, int, int], bool, int]]:
    """(shape, backward, launches a step) of every masked attention the
    step asks for."""
    d, h, n = cfg["d_embed"], cfg["n_heads"], cfg["n_layers"]
    st = (batch, h, cfg["max_outfit_len"] + 1, d // h)
    out = [(st, False, n * accumulation), (st, True, n * accumulation)]
    if towers:
        items = batch * cfg["max_outfit_len"]
        th = cfg["text_heads"]
        text = (items, th, cfg["text_len"], cfg["text_width"] // th)
        out.append((text, False, cfg["text_layers"] * accumulation))
    return out
