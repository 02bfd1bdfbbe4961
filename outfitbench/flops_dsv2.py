"""Operations and bytes of the resnet_dsv2lite configuration, computed from
its shapes (what the model asks for, not what a kernel does): the step's
model operations with DeepSeek-V2-Lite as the text tower, the attention
launches the step asks for with the least time of each (queries and keys of
another width than the values apart), and the least time of a mixture's
routed products. Built on ``flops.py``, which it leaves as it is."""

from __future__ import annotations

from typing import Dict, List, Tuple

from outfitbench import flops
from outfitbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

_ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def tower_token_flops(cfg: Dict, t: int) -> float:
    """Operations of the text tower a token, at texts of ``t`` tokens: the
    four MLA projections and its two products over all ``t`` keys, the dense
    layers' SwiGLU, each mixture's router, its ``num_experts_per_tok``
    routed experts (not all of them) and its shared experts. Norms, RoPE,
    the softmax and the combine are not counted."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r = cfg["kv_lora_rank"]
    proj = d * h * (nope + rd) + d * (r + rd) + r * h * (nope + vd) + h * vd * d
    products = h * t * (nope + rd + vd)
    attn = 2 * proj + 2 * products
    dense = 2 * 3 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    mixture = 2 * (d * cfg["n_routed_experts"]
                   + 3 * d * f * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]))
    n_dense = cfg["first_k_dense_replace"]
    n = cfg["num_hidden_layers"]
    return n * attn + n_dense * dense + (n - n_dense) * mixture


def ocp_step_flops(cfg: Dict, batch: int, accumulation: int) -> float:
    """Model operations of one original-CP step of the resnet_dsv2lite
    pair: ResNet-18 and the text tower forward over every item slot (pads
    included, as they run), the heads' forward and backward, the set
    transformer's forward and backward."""
    items = batch * cfg["max_outfit_len"]
    t = cfg["text_len"]
    towers = items * (flops.resnet18_forward_flops(cfg["image_size"])
                      + t * tower_token_flops(cfg, t))
    heads = 3.0 * 2 * items * (512 + cfg["hidden_size"]) * cfg["dim_per_modality"]
    return accumulation * (towers + heads + 3.0 * flops.set_transformer_forward_flops(cfg, batch))


def attention_launches(cfg: Dict, batch: int, accumulation: int) -> List[Tuple[tuple, bool, int]]:
    """(shape, backward, launches a step) of every masked attention the step
    asks for: the set transformer's forward and backward at (B, H, L, Dh),
    MLA's forward at (items, heads, T, Dqk, Dv) in every layer."""
    items = batch * cfg["max_outfit_len"]
    mla = (items, cfg["num_attention_heads"], cfg["text_len"],
           cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    return (flops.attention_launches(cfg, batch, accumulation)
            + [(mla, False, cfg["num_hidden_layers"] * accumulation)])


def split_attention_bound(shape: Tuple[int, int, int, int, int], dtype: str) -> float:
    """Least seconds for the forward at (B, H, L, Dqk, Dv): q and k read at
    Dqk, v read and out written at Dv, once each, plus the (B, L) mask;
    2 B H L L (Dqk + Dv) operations (two products)."""
    b, h, l, dqk, dv = shape
    nbytes = b * h * l * (2 * dqk + 2 * dv) * _ELEM[dtype] + b * l
    ops = 2 * b * h * l * l * (dqk + dv)
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def attention_bound(shape: tuple, dtype: str, backward: bool = False) -> float:
    """``flops.attention_bound`` for (B, H, L, Dh), ``split_attention_bound``
    for (B, H, L, Dqk, Dv)."""
    if len(shape) == 5:
        return split_attention_bound(shape, dtype)
    return flops.attention_bound(shape, dtype, backward)


def expert_bound(cfg: Dict, tokens: int, dtype: str) -> float:
    """Least seconds of one mixture's routed products over ``tokens``: each
    token's ``num_experts_per_tok`` experts' three products of d x F
    (2 tokens k 3 d F operations), against the experts' weights read once
    and each pair's rows read and written once."""
    d, f, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    ops = 2.0 * tokens * k * 3 * d * f
    nbytes = (cfg["n_routed_experts"] * 3 * d * f + tokens * k * (2 * d + 3 * f)) * _ELEM[dtype]
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def attn_roofline(rec):
    """% : the least time of the attention launches the model asks for in
    the profiled steps over the device time of the masked_mha kernels
    there; None where the kernels launched are not the ones asked for."""
    if rec is None or not rec.trace:
        return None
    d = rec.derived
    steps = d["profiled_steps"]
    least = sum(attention_bound(shape, d["compute_dtype"], bwd) * n * steps
                for shape, bwd, n in d["attention_launches"])
    want = sum(n * steps for _, _, n in d["attention_launches"])
    seconds = calls = 0
    for name, (sec, n) in rec.trace["kernels"].items():
        if "masked_mha" in name:
            seconds += sec
            calls += n
    if calls != want or seconds <= 0:
        return None
    return 100.0 * least / seconds
