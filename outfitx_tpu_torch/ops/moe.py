"""Mixture-of-experts operations: the router, the permutation of (token,
expert) pairs by expert, the grouped expert products and the combine.

DeepSeek-V2's routed layer (``models/towers/deepseek_v2.py``) replaces no
TPU kernel: the JAX package has no mixture of experts. Its parts here:

- ``route``: softmax over the router's logits in float32, greedy top-k,
  the weights left unnormalised and scaled by a factor (DeepSeek-V2);
- ``route_sigmoid``: sigmoid scores in float32, the top-k of the scores
  plus a correction bias, the weights the scores alone at those experts,
  normalised and scaled (DeepSeek-V3's ``noaux_tc`` in one group, the
  Kimi-VL decoder's router);
- ``permute``: the (token, slot) pairs sorted by expert (a stable sort, so
  a token's pairs keep token order inside an expert), each expert's count
  and the running ends of the groups, all on the device: nothing reads a
  count on the host, so a layer queues its work without waiting for the
  card (it can be captured in a CUDA graph);
- ``grouped_mm``: one launch a projection for all experts, each group of
  rows against its own expert's weight. On the card it is PyTorch's grouped
  product (``torch._grouped_mm``, bf16 on sm_90 with the group ends on the
  device); on the CPU, and as the plain version the card is held against,
  ``grouped_mm_reference`` loops over the experts;
- ``unpermute``: each pair's output put back in (token, slot) order;
  ``combine`` then sums a token's slots with their router weights, in
  float32, in slot order. Scattering each pair's row to its slot and
  summing the slots after is the scatter-add of the weighted outputs with
  a fixed order of addition: a token's result is the same in every run.

What bounds the layer on an H100 at DeepSeek-V2-Lite's widths (16,384
tokens, top-6 of 64 experts of width 1,408 over d 2,048): the routed
products, 1.70 TFLOP a layer, 1.72 ms at the bf16 peak, against 1.1 GB of
expert weights (0.33 ms at 3.35 TB/s). The router's float32 product is
4.3 GFLOP; the permutation moves 98,304 rows of 4 KB twice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def route(x: torch.Tensor, weight: torch.Tensor, top_k: int,
          scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, d) and the router's weight (E, d) -> (weights (N, k) float32,
    experts (N, k) int64): the softmax of x W^T over the E experts in
    float32, its k largest in descending order, times ``scaling``."""
    scores = torch.softmax(F.linear(x.float(), weight.float()), dim=-1)
    w, idx = torch.topk(scores, top_k, dim=-1)
    if scaling != 1.0:
        w = w * scaling
    return w, idx


def route_sigmoid(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, top_k: int,
                  scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, d), the router's weight (E, d) and correction bias (E,) ->
    (weights (N, k) float32, experts (N, k) int64): s = sigmoid(x W^T) in
    float32; the experts are the k largest of s + bias, in descending
    order; their weights are s there (without the bias), over their sum
    plus 1e-20, times ``scaling``. One group of experts: DeepSeek-V3's
    group-limited choice with ``n_group`` 1 picks among all of them."""
    scores = torch.sigmoid(F.linear(x.float(), weight.float()))
    idx = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    w = scores.gather(-1, idx)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scaling, idx


def permute(idx: torch.Tensor, n_experts: int):
    """experts (N, k) -> (order (N k,) the pairs sorted by expert, pair p
    being token p // k's slot p % k; counts (E,) int32; ends (E,) int32,
    the running sum of the counts). All on idx's device, with no sync."""
    flat = idx.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    bounds = torch.arange(n_experts, device=idx.device, dtype=sorted_e.dtype)
    ends = torch.searchsorted(sorted_e, bounds, right=True).to(torch.int32)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    return order, counts, ends


def grouped_mm_reference(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x (M, K) with its rows in groups, w (E, N, K) in torch's (out, in)
    layout, ends (E,) the groups' running ends -> (M, N): each group's rows
    times its own expert's weight, one product an expert."""
    out = x.new_empty((x.shape[0], w.shape[1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        out[start:end] = x[start:end] @ w[e].to(x.dtype).T
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``grouped_mm_reference``'s function. On the card one launch of
    ``torch._grouped_mm`` (x and w bfloat16, ``ends`` int32 on the card)
    that adds one to ``grouped_mm.launches``; on the CPU the loop."""
    if not x.is_cuda:
        return grouped_mm_reference(x, w, ends)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_mm on the card takes bfloat16, not {x.dtype} x {w.dtype}")
    if ends.dtype != torch.int32 or not ends.is_cuda:
        raise ValueError("grouped_mm takes the groups' ends as int32 on the card")
    grouped_mm.launches += 1
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)


grouped_mm.launches = 0


def unpermute(y_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The pairs' outputs (N k, d) in expert order -> in pair order."""
    out = torch.empty_like(y_sorted)
    out.index_copy_(0, order, y_sorted)
    return out


def combine(y_pairs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pair outputs (N k, d) in pair order and weights (N, k) -> (N, d)
    float32: each token's slots weighted and summed in slot order."""
    n, k = w.shape
    y = y_pairs.view(n, k, -1)
    out = y[:, 0].float() * w[:, :1]
    for s in range(1, k):
        out.addcmul_(y[:, s].float(), w[:, s : s + 1])
    return out
