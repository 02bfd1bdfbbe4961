"""The inputs a run makes from its seed, handed the same to the program and
to the reference: set-transformer weights, the embedding catalog and the
CP training split. Weights and the catalog are drawn on the device in one
call each."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

ITEM_ID_BASE = 1_000_000


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(state-dict name, shape, centre, half-width) of every parameter of
    the set transformer with its CP and CIR heads: each is drawn uniform in
    centre +- half-width. Biases and LayerNorm parameters are drawn away
    from their usual 0 and 1, so that a path that drops one shows."""
    d, ffn = cfg["d_embed"], cfg["d_ffn"]
    bd, bf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ffn)
    out = []
    for i in range(cfg["n_layers"]):
        p = f"transformer_encoder.layers.{i}."
        out += [
            (p + "self_attn.in_proj_weight", (3 * d, d), 0.0, math.sqrt(6.0 / (2 * d))),
            (p + "self_attn.in_proj_bias", (3 * d,), 0.0, 0.02),
            (p + "self_attn.out_proj.weight", (d, d), 0.0, bd),
            (p + "self_attn.out_proj.bias", (d,), 0.0, 0.02),
            (p + "linear1.weight", (ffn, d), 0.0, bd),
            (p + "linear1.bias", (ffn,), 0.0, bd),
            (p + "linear2.weight", (d, ffn), 0.0, bf),
            (p + "linear2.bias", (d,), 0.0, bf),
            (p + "norm1.weight", (d,), 1.0, 0.1),
            (p + "norm1.bias", (d,), 0.0, 0.1),
            (p + "norm2.weight", (d,), 1.0, 0.1),
            (p + "norm2.bias", (d,), 0.0, 0.1),
        ]
    out += [
        ("outfit_token", (d,), 0.0, 0.035),
        ("target_item_image_emb", (d // 2,), 0.0, 0.035),
        ("cp_ffn.1.weight", (1, d), 0.0, bd),
        ("cp_ffn.1.bias", (1,), 0.0, bd),
        ("cir_ffn.0.weight", (d, d), 0.0, bd),
    ]
    return out


def make_params(cfg: Dict, gen: torch.Generator, device, copies: int = 1) -> List[Dict[str, torch.Tensor]]:
    """``copies`` float32 state dicts drawn from ``gen`` in one call."""
    specs = param_specs(cfg)
    size = sum(math.prod(shape) for _, shape, _, _ in specs)
    flat = torch.rand(copies * size, generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out = []
    at = 0
    for _ in range(copies):
        sd = {}
        for name, shape, centre, half in specs:
            n = math.prod(shape)
            t = flat[at : at + n].view(shape)
            t.mul_(half).add_(centre)
            sd[name] = t
            at += n
        out.append(sd)
    return out


def make_catalog(n_items: int, d: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n_items + 1, d) float32 embeddings, each half of a row of unit norm
    (an image and a text embedding side by side), the last row the all-zero
    pad."""
    emb = torch.empty((n_items + 1, d), device=device)
    emb[:n_items].normal_(generator=gen)
    emb[n_items].zero_()
    halves = emb[:n_items].view(n_items, 2, d // 2)
    halves.div_(halves.norm(dim=-1, keepdim=True))
    return emb


def item_ids(n_items: int) -> np.ndarray:
    return np.arange(ITEM_ID_BASE, ITEM_ID_BASE + n_items, dtype=np.int64)


def outfit_lengths(n: int, lo: int, hi: int, rng: np.random.Generator) -> np.ndarray:
    """The same multiset of lengths in [lo, hi] for every seed, in the
    seed's order."""
    return np.resize(np.arange(lo, hi + 1), n)[rng.permutation(n)]


def cp_split_arrays(n_outfits: int, n_items: int, max_len: int, lengths: Tuple[int, int], seed: int):
    """A CP split's (item_rows (n, L) int32, mask (n, L) bool True = pad,
    labels (n,) float32): outfits of random catalog rows, padded with the
    pad row ``n_items``; half of them labelled compatible."""
    rng = np.random.default_rng([seed, 11])
    lens = outfit_lengths(n_outfits, lengths[0], lengths[1], rng)
    rows = rng.integers(0, n_items, (n_outfits, max_len), dtype=np.int64).astype(np.int32)
    mask = np.arange(max_len)[None, :] >= lens[:, None]
    rows[mask] = n_items
    labels = np.zeros(n_outfits, dtype=np.float32)
    labels[: n_outfits // 2] = 1.0
    return rows, mask, labels[rng.permutation(n_outfits)]


def resnet18_specs(d_out: int) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """ResNet-18's parameters by torchvision's names (He-uniform
    convolutions, BatchNorm statistics away from identity) and the fresh
    ``fc`` head to ``d_out``."""
    out = []

    def conv(name, cout, cin, k):
        out.append((name + ".weight", (cout, cin, k, k), 0.0, math.sqrt(6.0 / (cin * k * k))))

    def bn(name, c):
        out.extend([(name + ".weight", (c,), 1.0, 0.1), (name + ".bias", (c,), 0.0, 0.1),
                    (name + ".running_mean", (c,), 0.0, 0.1),
                    (name + ".running_var", (c,), 1.0, 0.2)])

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for si, cout in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            p = f"layer{si + 1}.{bi}"
            c_in = cin if bi == 0 else cout
            conv(p + ".conv1", cout, c_in, 3)
            bn(p + ".bn1", cout)
            conv(p + ".conv2", cout, cout, 3)
            bn(p + ".bn2", cout)
            if bi == 0 and si > 0:
                conv(p + ".downsample.0", cout, c_in, 1)
                bn(p + ".downsample.1", cout)
        cin = cout
    out += [("fc.weight", (d_out, 512), 0.0, 1.0 / math.sqrt(512)),
            ("fc.bias", (d_out,), 0.0, 1.0 / math.sqrt(512))]
    return out


def minilm_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """all-MiniLM-L6-v2's parameters by the port's names (embeddings of
    N(0, 0.02)'s spread, linears uniform(+-1/sqrt(d_in))) and the fresh
    ``proj`` head to ``dim_per_modality``."""
    d, mlp = cfg["text_width"], cfg["text_ffn"]
    out = [("word_emb", (cfg["text_vocab"], d), 0.0, 0.035),
           ("pos_emb", (cfg["text_positions"], d), 0.0, 0.035),
           ("type_emb", (2, d), 0.0, 0.035),
           ("emb_ln.weight", (d,), 1.0, 0.1), ("emb_ln.bias", (d,), 0.0, 0.1)]
    for i in range(cfg["text_layers"]):
        p = f"layers.{i}."
        for name, (o, n) in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
                             ("fc1", (mlp, d)), ("fc2", (d, mlp))):
            out += [(p + name + ".weight", (o, n), 0.0, 1.0 / math.sqrt(n)),
                    (p + name + ".bias", (o,), 0.0, 1.0 / math.sqrt(n))]
        for ln in ("attn_ln", "mlp_ln"):
            out += [(p + ln + ".weight", (d,), 1.0, 0.1), (p + ln + ".bias", (d,), 0.0, 0.1)]
    out += [("proj.weight", (cfg["dim_per_modality"], d), 0.0, 1.0 / math.sqrt(d)),
            ("proj.bias", (cfg["dim_per_modality"],), 0.0, 1.0 / math.sqrt(d))]
    return out


def draw(specs, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict of ``specs`` drawn from ``gen`` in one call."""
    size = sum(math.prod(shape) for _, shape, _, _ in specs)
    flat = torch.rand(size, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, centre, half in specs:
        n = math.prod(shape)
        out[name] = flat[at : at + n].view(shape).mul_(half).add_(centre)
        at += n
    return out


def encoder_params(cfg: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The resnet_sbert item encoder's weights: 'vision.*' and 'text.*'.
    ResNet's BatchNorm statistics are placeholders until ``calibrate``."""
    sd = {"vision." + k: v for k, v in draw(resnet18_specs(cfg["dim_per_modality"]), gen, device).items()}
    sd.update({"text." + k: v for k, v in draw(minilm_specs(cfg), gen, device).items()})
    return sd


def calibrate(sd: Dict[str, torch.Tensor], images, n: int = 64) -> None:
    """Set ResNet's BatchNorm statistics, in place, to those of each
    BatchNorm's input over the first ``n`` items' images, in float32, as
    training leaves them. Random convolutions under placeholder statistics
    pool every image to nearly one feature (cosine 0.9995 between items),
    so the items' embeddings would differ by less than a bfloat16 forward's
    rounding; calibrated, they read cosine about 0.97, as trained towers'
    features differ."""
    from outfitbench.reference.numerics import exact_float32
    from outfitbench.reference.towers import resnet18_features

    vision = {k[7:]: v for k, v in sd.items() if k.startswith("vision.")}
    dev = next(iter(sd.values())).device
    with exact_float32():
        resnet18_features(vision, torch.as_tensor(images[:n], device=dev), calibrate=True)


def raw_items(n_items: int, cfg: Dict, gen: torch.Generator, device):
    """(images (n+1, 3, S, S) uint8, input_ids (n+1, T) int32, attn (n+1,
    T) int32) on the host, the last row the pad item (all zeros). Texts
    are 4 to T tokens long, padded at the tail."""
    s, t = cfg["image_size"], cfg["text_len"]
    images = torch.randint(0, 256, (n_items + 1, 3, s, s), generator=gen, device=device,
                           dtype=torch.uint8)
    ids = torch.randint(1, cfg["text_vocab"], (n_items + 1, t), generator=gen, device=device,
                        dtype=torch.int32)
    lengths = torch.randint(4, t + 1, (n_items + 1, 1), generator=gen, device=device)
    attn = (torch.arange(t, device=device)[None, :] < lengths).to(torch.int32)
    ids = ids * attn
    images[n_items] = 0
    ids[n_items] = 0
    attn[n_items] = 0
    return images.cpu().numpy(), ids.cpu().numpy(), attn.cpu().numpy()
