"""Operations and bytes of the kimivl_a3b configuration, computed from its
shapes (what the model asks for, not what a kernel does): the step's model
operations with Kimi-VL-A3B as the joint item encoder (MoonViT, the
projector, the decoder over 64 image tokens and the title), the attention
launches the step asks for, and the rooflines of MoonViT's attention (Dh
72 at L = 256) and of the decoder's split attention (Dqk 192, Dv 128 at L =
80), each over its own kernel's device time. The decoder's count and the
mixture's least time are ``flops_dsv2.py``'s; this file adds what
differs."""

from __future__ import annotations

from typing import Dict, List, Tuple

from outfitbench import flops, flops_dsv2

VIT_KERNEL = "masked_mha_fwd_long_tile"  # the bfloat16 tile kernel above L = 64
SPLIT_KERNEL = "masked_mha_fwd_split"


def grid(cfg: Dict) -> int:
    return cfg["image_size"] // cfg["vision_config"]["patch_size"]


def image_tokens(cfg: Dict) -> int:
    """The decoder's image tokens an item: the grid merged 2 x 2."""
    m = cfg["vision_config"]["merge_kernel_size"]
    return (grid(cfg) // m[0]) * (grid(cfg) // m[1])


def sequence(cfg: Dict) -> int:
    """The decoder's length: image tokens, then the title."""
    return image_tokens(cfg) + cfg["text_len"]


def vit_image_flops(cfg: Dict) -> float:
    """Operations of MoonViT an image: the patch embedding, and in each
    layer the four attention matrices, the two MLP matrices and the two
    attention products over all patches. Norms, the rotary, the position
    table and the activations are not counted."""
    vc = cfg["vision_config"]
    d, f, p = vc["hidden_size"], vc["intermediate_size"], vc["patch_size"]
    n = grid(cfg) ** 2
    layer = 2 * (4 * d * d + 2 * d * f) + 4 * n * d
    return n * (2 * 3 * p * p * d + vc["num_hidden_layers"] * layer)


def project_image_flops(cfg: Dict) -> float:
    """Operations of the projector an image: 4 d -> 4 d -> hidden_size at
    every merged token."""
    vc = cfg["vision_config"]
    m = vc["merge_kernel_size"]
    wide = m[0] * m[1] * vc["hidden_size"]
    return image_tokens(cfg) * 2 * (wide * wide + wide * cfg["hidden_size"])


def ocp_step_flops(cfg: Dict, batch: int, accumulation: int) -> float:
    """Model operations of one original-CP step of the kimivl_a3b pair:
    MoonViT, the projector and the decoder forward over every item slot
    (pads included, as they run; the decoder's six routed and two shared
    experts a token, ``flops_dsv2.tower_token_flops`` at the joint length),
    the two heads' forward and backward, the set transformer's forward and
    backward."""
    items = batch * cfg["max_outfit_len"]
    t = sequence(cfg)
    towers = items * (vit_image_flops(cfg) + project_image_flops(cfg)
                      + t * flops_dsv2.tower_token_flops(cfg, t))
    heads = 3.0 * 2 * items * 2 * cfg["hidden_size"] * cfg["dim_per_modality"]
    return accumulation * (towers + heads + 3.0 * flops.set_transformer_forward_flops(cfg, batch))


def vit_shape(cfg: Dict, items: int) -> Tuple[int, int, int, int]:
    vc = cfg["vision_config"]
    h = vc["num_attention_heads"]
    return (items, h, grid(cfg) ** 2, vc["hidden_size"] // h)


def split_shape(cfg: Dict, items: int) -> Tuple[int, int, int, int, int]:
    return (items, cfg["num_attention_heads"], sequence(cfg),
            cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def attention_launches(cfg: Dict, batch: int, accumulation: int) -> List[Tuple[tuple, bool, int]]:
    """(shape, backward, launches a step) of every masked attention the step
    asks for: the set transformer's forward and backward, MoonViT's forward
    in every layer at (items, heads, g g, Dh), the decoder's MLA in every
    layer at (items, heads, P + T, Dqk, Dv)."""
    items = batch * cfg["max_outfit_len"]
    return (flops.attention_launches(cfg, batch, accumulation)
            + [(vit_shape(cfg, items), False,
                cfg["vision_config"]["num_hidden_layers"] * accumulation),
               (split_shape(cfg, items), False, cfg["num_hidden_layers"] * accumulation)])


def roofline(rec, kernel: str, rank: int):
    """% : the least time of the launches of ``rank``-dimensional shapes
    (4: MoonViT's, 5: the split route's) in the profiled steps over the
    device time of the kernels whose name holds ``kernel``; None where
    their count is not the count asked for."""
    if rec is None or not rec.trace:
        return None
    d = rec.derived
    steps = d["profiled_steps"]
    asked = [(s, n) for s, bwd, n in d["attention_launches"]
             if len(s) == rank and not bwd and (rank == 5 or s[2] > 64)]
    least = sum(flops_dsv2.attention_bound(s, d["compute_dtype"]) * n * steps for s, n in asked)
    want = sum(n * steps for _, n in asked)
    seconds = calls = 0
    for name, (sec, n) in rec.trace["kernels"].items():
        if kernel in name:
            seconds += sec
            calls += n
    if not want or calls != want or seconds <= 0:
        return None
    return 100.0 * least / seconds
