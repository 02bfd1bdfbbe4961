"""The OutfitX set transformer: outfit encoder and task heads.

The port of ``outfitx_tpu/models/outfit_transformer.py``. Parameter names
follow the reference system's torch ``OutfitX.state_dict()`` (the layout
``outfitx_tpu/models/export_torch.py`` writes), so a JAX parameter tree
becomes this module's state dict through one mapping
(``models/from_jax.py``) and loads with ``load_state_dict(strict=True)``.

Numerics follow the JAX forward:
- parameters are stored in float32 and cast to the compute dtype (bfloat16
  by default) where they are used;
- the residual stream stays in the compute dtype, not float32;
- each matrix product returns the compute dtype and its bias is added in
  the compute dtype after it;
- the prefix token (CP outfit token, CIR target token) is never masked;
- scores and CIR embeddings are returned in float32.

Dropout (train mode, ``model.train()``) sits at the JAX package's sites: the
attention output before its residual add, the FFN hidden state after the
activation, the FFN output, and the CP head's token state (the CIR head has
none). There is no attention-probability dropout (the JAX package folds it
into the output dropout). Masks come from ``core.rng.keep_mask`` with a
``torch.Generator`` the caller passes in, scaled by the actual keep
probability. A serving build (the default) has no trainable parameter; a
training build (``trainable=True``) has trainable float32 parameters.

Tensor parallelism (``OutfitXModel.shard_``, one process per mesh
position) is Megatron's: a rank holds its ``n_heads/model`` heads and
``d_ffn/model`` FFN units; the QKV and FFN-in products are column-parallel
behind f (identity forward, all-reduce of the gradient backward), the
out-projection and FFN-out are row-parallel followed by g (all-reduce of the
partial sums forward), and ``bo`` and ``b2`` are added once, after g, as
the JAX layer adds them. FSDP also splits each of those four matrices over
the data axis and all-gathers it at its use. Dropout under a mesh draws the
global batch's mask at the full width and keeps this rank's rows (and, for
the FFN hidden units, its columns), so a meshed run draws the masks of the
one-rank run. A model that is not sharded runs the same path with
``parallel.SINGLE``, whose collectives and cuts are all the identity.

Activation recomputation (``cfg.remat``, training with grad enabled only)
runs each encoder layer under ``torch.utils.checkpoint`` (non-reentrant),
as the JAX package runs each layer of its scan under ``jax.checkpoint``;
the final LayerNorm stays outside. The backward runs the layer's forward
again, its kernels and its collectives (FSDP's weight gathers, the model
axis's g) included, on every rank in the same order. ``remat_policy``:
- ``'full'`` keeps the layer's input only;
- ``'masks'`` also keeps the dropout masks' random draws (the outputs of
  the ops tagged ``nondeterministic_seeded``, JAX's ``dropout_mask``
  name), which the recompute then takes instead of drawing;
- ``'dots'`` also keeps the outputs of the products autograd records
  (``mm``, ``addmm``, ``bmm``, ``baddbmm`` with grad enabled), as
  ``dots_saveable``. The attention and LayerNorm kernels launch inside
  ``torch.autograd.Function``s, where grad is off and a dispatch mode sees
  only their output's allocation: they are recomputed under every policy,
  as ``dots_saveable`` recomputes a ``pallas_call``, and no policy keeps an
  allocation whose contents a launch writes afterwards.
The selective policies go through ``create_selective_checkpoint_contexts``.
Dropout draws from an explicit generator, which checkpoint's
``preserve_rng_state`` does not restore: each layer snapshots the
generator's state when it starts and draws from a clone set to that state,
in its forward and again in its recompute, so both see the same masks; the
shared generator then takes the clone's end state, as if the layer had
drawn from it (a CUDA generator's state is its seed and offset).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from outfitx_tpu_torch.core import dtypes
from outfitx_tpu_torch.core import rng as rng_ops
from outfitx_tpu_torch.core.config import OutfitXConfig
from outfitx_tpu_torch.core.device import resolve_device
from outfitx_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, join_blocks, shard_blocks
from outfitx_tpu_torch.ops import layer_norm, masked_mha, resolve_activation
from outfitx_tpu_torch.ops.attn_block import attn_block
from outfitx_tpu_torch.parallel import SINGLE


def _dropout(x, rate: float, gen: Optional[torch.Generator], par=SINGLE, columns: bool = False):
    """Inverted dropout at ``rate`` with a mask from ``gen``; identity at
    rate 0 (eval mode passes 0). The mask is drawn for the global batch,
    whose rows are ``par.data`` times ``x``'s, and this rank keeps its rows;
    ``columns`` marks a last dimension split over the model axis, drawn at
    the full width and cut to this rank's block. On one device (``SINGLE``)
    both cuts keep everything."""
    if rate == 0.0:
        return x
    if gen is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    shape = (x.shape[0] * par.data,) + tuple(x.shape[1:])
    if columns:
        shape = shape[:-1] + (shape[-1] * par.model,)
    keep, q = rng_ops.keep_mask(gen, rate, shape, x.device)
    keep = par.rows(keep)
    if columns:
        keep = par.columns(keep)
    return torch.where(keep, x / q, torch.zeros_like(x))


def _dense(x, weight, bias=None):
    """x @ weight.T (+ bias), both in x's dtype, the bias added after the
    product's rounding (not fused into it)."""
    y = torch.matmul(x, weight.to(x.dtype).T)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class _Linear(nn.Module):
    """Holds a torch-layout (out, in) weight and an optional bias."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return _dense(x, self.weight, self.bias)


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        # Fused Q/K/V projection, rows [Wq; Wk; Wv], as torch's MHA stores it.
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = _Linear(d, d)
        self._block = {}  # dtype -> (parameter versions, block weights)

    def _block_weights(self, dtype):
        """The block kernel's layouts in ``dtype``: wqkv (d, 3, d) and wo
        (d, d) as (in, out), bqkv (3, d). Made once and cached; made again
        after the parameters change in place (a state dict load, an
        optimizer step)."""
        params = (self.in_proj_weight, self.in_proj_bias, self.out_proj.weight)
        versions = tuple((p.data_ptr(), p._version) for p in params)
        hit = self._block.get(dtype)
        if hit is None or hit[0] != versions:
            d = self.in_proj_weight.shape[1]
            with torch.no_grad():
                wqkv = self.in_proj_weight.view(3, d, d).permute(2, 0, 1)
                weights = tuple(
                    t.to(dtype).contiguous()
                    for t in (wqkv, self.in_proj_bias.view(3, d), self.out_proj.weight.T)
                )
            hit = self._block[dtype] = (versions, weights)
        return hit[1]

    def forward(self, y, pad_mask, block: bool, par):
        """This rank's heads (all of them on one device): column-parallel
        QKV behind f, row-parallel out-projection, g, then the bias."""
        b, s, d = y.shape
        if block:
            # The JAX package's OUTFITX_ATTN_BLOCK=fused route: the block's
            # float32 output cast to y's dtype, then the out-projection bias.
            wqkv, bqkv, wo = self._block_weights(y.dtype)
            o = attn_block(y, wqkv, bqkv, wo, pad_mask, self.n_heads).to(y.dtype)
            return o + self.out_proj.bias.to(y.dtype)
        h = self.n_heads // par.model
        y = par.copy_to_model(y)
        w = par.gather_weight(self.in_proj_weight, dim=1)  # (3d/M, d)
        qkv = _dense(y, w, self.in_proj_bias)  # (B, S, 3d/M)
        qkv = qkv.view(b, s, 3, h, d // self.n_heads).permute(2, 0, 3, 1, 4).contiguous()
        o = masked_mha(qkv[0], qkv[1], qkv[2], pad_mask)  # (B, H/M, S, Dh)
        o = o.transpose(1, 2).reshape(b, s, -1)
        o = par.reduce_from_model(_dense(o, par.gather_weight(self.out_proj.weight, dim=0)))
        return o + self.out_proj.bias.to(o.dtype)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: OutfitXConfig, attn: str = "mha"):
        super().__init__()
        self.attn = attn
        d = cfg.d_embed
        t = cfg.transformer
        self.norm_first = t.norm_first
        self.dropout = t.dropout
        self.act = resolve_activation(t.activation)
        self.self_attn = _SelfAttention(d, t.n_heads)
        # The JAX package zero-pads the hidden width to ffn_pad_to at apply
        # time for TPU tile alignment. That pad is numerically inert (act(0)
        # = 0 for every activation here, and the padded rows of w2 are zero),
        # so the port computes at d_ffn and ignores ffn_pad_to.
        self.linear1 = _Linear(d, t.d_ffn)
        self.linear2 = _Linear(t.d_ffn, d)
        self.norm1 = _LayerNorm(d)
        self.norm2 = _LayerNorm(d)

    def forward(self, x, pad_mask, gen, par):
        rate = self.dropout if self.training else 0.0
        y = self.norm1(x) if self.norm_first else x
        block = self.attn == "block" and not self.training
        x = x + _dropout(self.self_attn(y, pad_mask, block, par), rate, gen, par)
        if not self.norm_first:
            x = self.norm1(x)
        y = self.norm2(x) if self.norm_first else x
        # this rank's FFN units: column-parallel in, row-parallel out
        y = par.copy_to_model(y)
        w1 = par.gather_weight(self.linear1.weight, dim=1)
        hidden = _dropout(self.act(_dense(y, w1, self.linear1.bias)), rate, gen, par, columns=True)
        out = par.reduce_from_model(_dense(hidden, par.gather_weight(self.linear2.weight, dim=0)))
        x = x + _dropout(out + self.linear2.bias.to(out.dtype), rate, gen, par)
        if not self.norm_first:
            x = self.norm2(x)
        return x


_aten = torch.ops.aten
# Allocations: a kernel's wrapper fills its output after allocating it, so
# a kept allocation would be an output from the forward, kept alive.
_ALLOCATIONS = frozenset({
    _aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
})
_PRODUCTS = frozenset({
    _aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default,
})


def _keeps(policy: str, op) -> bool:
    """Whether a recomputed layer keeps ``op``'s output under ``policy``."""
    if policy == "masks":
        return torch.Tag.nondeterministic_seeded in op.tags
    return op in _PRODUCTS and torch.is_grad_enabled()  # 'dots'


def _selective(policy: str):
    """checkpoint's ``context_fn`` for a selective policy; None for 'full'."""
    if policy == "full":
        return None

    def decide(ctx, op, *args, **kwargs):
        if op in _ALLOCATIONS:
            return CheckpointPolicy.MUST_RECOMPUTE
        if _keeps(policy, op):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, decide)


def _recomputed(layer, x, pad_mask, gen, par, context_fn):
    """``layer`` under non-reentrant checkpoint, its dropout drawn from a
    clone of ``gen`` set to ``gen``'s state at the start, in the forward
    and in the recompute; ``gen`` leaves with the forward's end state."""
    start = None if gen is None else gen.get_state()
    clones = []

    def run(x):
        clone = None
        if start is not None:
            clone = torch.Generator(device=gen.device)
            clone.set_state(start)
            clones.append(clone)
        return layer(x, pad_mask, clone, par)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    y = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False, **kw)
    if start is not None:
        gen.set_state(clones[0].get_state())
    return y


class _Encoder(nn.Module):
    def __init__(self, cfg: OutfitXConfig, attn: str = "mha"):
        super().__init__()
        self.layers = nn.ModuleList(
            _EncoderLayer(cfg, attn) for _ in range(cfg.transformer.n_layers)
        )
        self.norm = _LayerNorm(cfg.d_embed) if cfg.transformer.final_norm else None
        self.remat = cfg.remat
        self.remat_context = _selective(cfg.remat_policy)

    def forward(self, x, pad_mask, gen, par):
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = _recomputed(layer, x, pad_mask, gen, par, self.remat_context)
            else:
                x = layer(x, pad_mask, gen, par)
        if self.norm is not None:
            x = self.norm(x)
        return x


class OutfitXModel(nn.Module):
    """Set transformer with the CP and CIR/FITB heads.

    Weights are random, drawn from ``seed`` with the JAX package's
    distributions (not its numbers), until a state dict is loaded. With
    ``trainable`` the parameters take gradients; otherwise (serving) none
    does. ``attn="block"`` runs each layer's attention as one fused block
    (``ops.attn_block``: QKV projection, masked attention, out-projection)
    when the model is not training, as the JAX package's
    ``OUTFITX_ATTN_BLOCK=fused`` does; the default ``"mha"`` runs the
    projections as products around ``masked_mha``.
    """

    def __init__(
        self,
        cfg: Optional[OutfitXConfig] = None,
        *,
        device: str | torch.device = "cuda",
        seed: int = 0,
        trainable: bool = False,
        attn: str = "mha",
    ):
        super().__init__()
        if attn not in ("mha", "block"):
            raise ValueError(f"attn must be 'mha' or 'block', got {attn!r}")
        self.cfg = cfg = cfg or OutfitXConfig()
        dev = resolve_device(device)
        d = cfg.d_embed
        self.transformer_encoder = _Encoder(cfg, attn)
        self.outfit_token = nn.Parameter(torch.empty(d))
        self.target_item_image_emb = nn.Parameter(torch.empty(d // 2))
        # Index 0 is the reference's dropout slot; the head's dropout is
        # applied in cp_forward.
        self.cp_ffn = nn.Sequential(nn.Identity(), _Linear(d, 1))
        self.cir_ffn = nn.Sequential(_Linear(d, d, bias=False))
        self.par = SINGLE  # this rank's ParallelContext once shard_ has cut the weights
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device=dev, dtype=dtypes.resolve(cfg.param_dtype))
        self.requires_grad_(trainable)
        self.eval()  # dropout only after an explicit .train()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator):
        cfg = self.cfg
        d, ffn = cfg.d_embed, cfg.transformer.d_ffn

        def uniform_(p, bound):
            p.uniform_(-bound, bound, generator=gen)

        bd, bf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ffn)
        for layer in self.transformer_encoder.layers:
            attn = layer.self_attn
            # Xavier-uniform for each of Q, K and V; zero projection biases.
            uniform_(attn.in_proj_weight, math.sqrt(6.0 / (2 * d)))
            attn.in_proj_bias.zero_()
            uniform_(attn.out_proj.weight, bd)
            attn.out_proj.bias.zero_()
            uniform_(layer.linear1.weight, bd)
            uniform_(layer.linear1.bias, bd)
            uniform_(layer.linear2.weight, bf)
            uniform_(layer.linear2.bias, bf)
        self.outfit_token.normal_(0.0, 0.02, generator=gen)
        self.target_item_image_emb.normal_(0.0, 0.02, generator=gen)
        uniform_(self.cp_ffn[1].weight, bd)
        uniform_(self.cp_ffn[1].bias, bd)
        uniform_(self.cir_ffn[0].weight, bd)

    @property
    def compute_dtype(self) -> torch.dtype:
        return dtypes.resolve(self.cfg.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.outfit_token.device

    def encode_set(self, tokens, pad_mask, generator=None):
        """tokens (B, S, D), pad_mask (B, S) bool with True = pad ->
        states (B, S, D) in the compute dtype. In train mode ``generator``
        draws the dropout masks."""
        return self.transformer_encoder(
            tokens.to(self.compute_dtype), pad_mask, generator, self.par
        )

    def _with_prefix(self, prefix, outfit_embedding, outfit_mask, generator):
        b = outfit_embedding.shape[0]
        x = torch.cat([prefix, outfit_embedding.to(self.compute_dtype)], dim=1)
        keep = torch.zeros((b, 1), dtype=torch.bool, device=outfit_mask.device)
        mask = torch.cat([keep, outfit_mask], dim=1)
        return self.encode_set(x, mask, generator)

    def cp_forward(self, outfit_embedding, outfit_mask, *, generator=None):
        """Compatibility logits (B,) float32. outfit_embedding (B, L, D),
        outfit_mask (B, L) bool, True = pad."""
        cdt = self.compute_dtype
        b = outfit_embedding.shape[0]
        tok = self.outfit_token.to(cdt)[None, None, :].expand(b, 1, -1)
        states = self._with_prefix(tok, outfit_embedding, outfit_mask, generator)
        rate = self.cfg.transformer.dropout if self.training else 0.0
        token_state = _dropout(states[:, 0, :], rate, generator, self.par)
        return self.cp_ffn(token_state)[:, 0].float()

    def cir_forward(
        self, outfit_embedding, outfit_mask, target_item_text_embedding,
        *, generator=None,
    ):
        """Predicted target-item embedding (B, D) float32; the target token
        is the learned image half joined to the given text half (B, D/2)."""
        cdt = self.compute_dtype
        b = outfit_embedding.shape[0]
        img = self.target_item_image_emb.to(cdt)[None, :].expand(b, -1)
        tok = torch.cat([img, target_item_text_embedding.to(cdt)], dim=-1)
        states = self._with_prefix(
            tok[:, None, :], outfit_embedding, outfit_mask, generator
        )
        return self.cir_ffn(states[:, 0, :]).float()

    # FITB shares the CIR forward.
    fitb_forward = cir_forward

    # ---------------------------------------------------------- meshes --
    @torch.no_grad()
    def shard_(self, par) -> "OutfitXModel":
        """Cut the full weights, in place, to the block this rank holds at
        ``par.position`` (``param_partition_specs``), and run the forward
        tensor-parallel from now on. Each parameter is tagged with the mesh
        axes it is split over (``mesh_axes``) for the gradient reduction
        and the clip norm."""
        t = self.cfg.transformer
        if par.model > 1 and any(l.attn == "block" for l in self.transformer_encoder.layers):
            raise ValueError(
                "attn='block' has no tensor-parallel route: the fused block "
                "runs on one device only; use attn='mha' on a model axis > 1"
            )
        if t.n_heads % par.model:
            raise ValueError(
                f"n_heads {t.n_heads} does not divide the 'model' axis ({par.model})"
            )
        specs = param_partition_specs(self.cfg, fsdp=par.fsdp)
        for name, p in self.named_parameters():
            p.mesh_spec = specs[name]
            p.mesh_blocks = _qkv_blocks(name)
            p.mesh_axes = tuple(a for a in specs[name] if a is not None and par.size(a) > 1)
            p.data = par.local(p, p.data).clone()
        self.par = par
        return self


def _qkv_blocks(name: str) -> int:
    """3 for the parameters whose leading dimension is the [Q; K; V] stack
    (their model-axis block is the same block of each of the three), else 1."""
    return 3 if name.endswith(("self_attn.in_proj_weight", "self_attn.in_proj_bias")) else 1


def param_partition_specs(cfg: OutfitXConfig, *, fsdp: bool = False) -> Dict[str, tuple]:
    """For each state-dict name, the mesh axis each dimension is split over
    (None: whole), in the port's (out, in) layouts: the counterpart of the
    JAX model's ``param_partition_specs``. QKV and FFN-in are split on
    their output rows over 'model', the out-projection and FFN-out on their
    input columns; with ``fsdp`` the other dimension of those four matrices
    splits over 'data'. Everything else is replicated."""
    dax = DATA_AXIS if fsdp else None
    specs = {}
    for i in range(cfg.transformer.n_layers):
        p = f"transformer_encoder.layers.{i}."
        specs.update({
            p + "self_attn.in_proj_weight": (MODEL_AXIS, dax),
            p + "self_attn.in_proj_bias": (MODEL_AXIS,),
            p + "self_attn.out_proj.weight": (dax, MODEL_AXIS),
            p + "self_attn.out_proj.bias": (None,),
            p + "linear1.weight": (MODEL_AXIS, dax),
            p + "linear1.bias": (MODEL_AXIS,),
            p + "linear2.weight": (dax, MODEL_AXIS),
            p + "linear2.bias": (None,),
        })
        for n in ("norm1", "norm2"):
            specs[p + n + ".weight"] = specs[p + n + ".bias"] = (None,)
    if cfg.transformer.final_norm:
        specs["transformer_encoder.norm.weight"] = (None,)
        specs["transformer_encoder.norm.bias"] = (None,)
    specs.update({
        "outfit_token": (None,), "target_item_image_emb": (None,),
        "cp_ffn.1.weight": (None, None), "cp_ffn.1.bias": (None,),
        "cir_ffn.0.weight": (None, None),
    })
    return specs


def shard_state_dict(sd, cfg: OutfitXConfig, mesh_shape, position, *, fsdp: bool = False):
    """A full state dict (tensors or numpy arrays) cut to the blocks at mesh
    ``position``."""
    specs = param_partition_specs(cfg, fsdp=fsdp)
    return {
        k: shard_blocks(v, specs[k], _qkv_blocks(k), mesh_shape, position)
        for k, v in sd.items()
    }


def join_state_dicts(shards, cfg: OutfitXConfig, mesh_shape, *, fsdp: bool = False):
    """The inverse of ``shard_state_dict``: ``shards`` maps each (data,
    model) position to its state dict; returns the full state dict."""
    specs = param_partition_specs(cfg, fsdp=fsdp)
    out = {}
    for name in shards[(0, 0)]:
        spec, blocks = specs[name], _qkv_blocks(name)

        def along(axis, get):
            if axis not in spec:
                return get(0)
            return join_blocks([get(i) for i in range(mesh_shape[axis])], axis, spec, blocks)

        out[name] = along(
            MODEL_AXIS, lambda m: along(DATA_AXIS, lambda d: shards[(d, m)][name])
        )
    return out
