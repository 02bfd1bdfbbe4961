"""The ResNet-18 tower's NHWC route (``models/towers/resnet.py``,
``ops/resnet_nhwc.py``, ``models/item_encoder.py resnet_normalizer``).

On the CPU: the state dict keeps torchvision's names and shapes; each
BatchNorm is folded from the statistics the tower holds at that forward,
so statistics set by ``load_state_dict`` or in place after a first forward
change the next output; the folded tower equals BatchNorm run after each
convolution in NCHW to float32 round-off; each convolution has one
epilogue (the stem, convolution and max-pool, one call); the ResNet
normaliser gives the float32 normaliser's values rounded once, NHWC, and
CLIP's and SigLIP's normalisers are unchanged; the epilogues' plain versions
equal the unfused passes, pooling before the epilogue too; the stem's plain
version is the convolution then the stem's pool, its packed weight holds
the folded weight in the kernel's K order, and patches read as the kernel
reads them give the convolution; the tower's output is the one it gave
before the stem was one call; the stem's checks raise; the image tower
records one ``outfitx.vision`` span an encode under a profiler, which the
benchmark's ``vision_ms.ocp`` reads. On the card: each kernel against its
plain version, bit for bit, and the stem within the bf16 rounding of its
convolution. Nothing here imports JAX, so the file also runs on the card's
machine (``--noconftest -m card``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from outfitbench.inputs import resnet18_specs
from outfitx_tpu_torch.core import dtypes, trace
from outfitx_tpu_torch.core.config import ENCODER_PAIRS, ItemEncoderConfig
from outfitx_tpu_torch.data import preprocess
from outfitx_tpu_torch.models.item_encoder import ItemEncoderModel, resnet_normalizer
from outfitx_tpu_torch.models.towers import resnet
from outfitx_tpu_torch.models.towers.minilm import MiniLMConfig
from outfitx_tpu_torch.models.towers.resnet import ResNet18, ResNet18Config
from outfitx_tpu_torch.ops import resnet_nhwc

torch.set_num_threads(1)

SMALL = dict(d_out=8, image_size=32, stage_channels=(64, 16, 16, 32), compute_dtype="float32")
CL = torch.channels_last


def _randomize_bn(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, resnet.FrozenBatchNorm):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.2, 0.2),
                                  (m.running_mean, -0.5, 0.5), (m.running_var, 0.5, 1.5)):
                    t.uniform_(lo, hi, generator=gen)
    return model


def _model(seed=0):
    model = ResNet18(ResNet18Config(**SMALL))
    model.init_weights_(torch.Generator().manual_seed(seed))
    return _randomize_bn(model, seed + 1).eval()


def _images(b=3, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, 3, 32, 32)).astype(
        np.float32))


def _nchw_features(model, x):
    """The tower with BatchNorm after each convolution, NCHW, float32."""
    def bn(m, y):
        scale = m.weight * torch.rsqrt(m.running_var + m.eps)
        bias = m.bias - m.running_mean * scale
        return y * scale[None, :, None, None] + bias[None, :, None, None]

    def conv(c, y):
        return F.conv2d(y, c.weight, stride=c.stride, padding=c.padding)

    x = F.max_pool2d(F.relu(bn(model.bn1, conv(model.conv1, x))), 3, 2, padding=1)
    for stage in model.stages():
        for blk in stage:
            y = bn(blk.bn2, conv(blk.conv2, F.relu(bn(blk.bn1, conv(blk.conv1, x)))))
            if blk.downsample is not None:
                x = bn(blk.downsample[1], conv(blk.downsample[0], x))
            x = F.relu(x + y)
    return x.mean(dim=(2, 3))


def test_state_dict_keeps_torchvision_names_and_shapes():
    got = {k: tuple(v.shape) for k, v in ResNet18(ResNet18Config(d_out=64)).state_dict().items()}
    assert got == {name: shape for name, shape, *_ in resnet18_specs(64)}
    assert all(v.dtype == torch.float32 for v in ResNet18(ResNet18Config()).state_dict().values())


def test_folded_nhwc_tower_equals_batchnorm_after_each_convolution():
    model, x = _model(), _images()
    with torch.no_grad():
        got = model.features(x)
        want = _nchw_features(model, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_statistics_changed_after_a_forward_change_the_next_output():
    """No fold outlives the statistics it was made from: a state dict
    loaded after a first forward, and statistics set in place (as the
    benchmark's calibration sets them), each give a fresh model's output."""
    model, x = _model(0), _images()
    with torch.no_grad():
        first = model(x)
        other = _model(5)
        model.load_state_dict(other.state_dict())
        loaded = model(x)
        np.testing.assert_array_equal(loaded.numpy(), other(x).numpy())
        assert not torch.equal(loaded, first)
        sd = model.state_dict()
        for k in sd:
            if k.endswith("running_mean"):
                sd[k].copy_(torch.linspace(-0.3, 0.3, sd[k].numel()))
            if k.endswith("running_var"):
                sd[k].mul_(1.5)
        calibrated = model(x)
        fresh = ResNet18(ResNet18Config(**SMALL))
        fresh.load_state_dict(sd)
        np.testing.assert_array_equal(calibrated.numpy(), fresh(x).numpy())
        assert not torch.equal(calibrated, loaded)


def test_one_epilogue_a_convolution(monkeypatch):
    """The stem (convolution, epilogue and max-pool) one call, two
    epilogues a block (a downsample's bias joins the block's second), each
    over NHWC."""
    calls = {"stem_conv_pool": 0, "bias_add_relu": 0}

    def spy(name, real):
        def f(y, *a):
            assert y.is_contiguous(memory_format=CL)
            calls[name] += 1
            return real(y, *a)
        return f

    monkeypatch.setattr(resnet, "stem_conv_pool",
                        spy("stem_conv_pool", resnet_nhwc.stem_conv_pool))
    monkeypatch.setattr(resnet, "bias_add_relu", spy("bias_add_relu", resnet_nhwc.bias_add_relu))
    with torch.no_grad():
        _model()(_images())
    assert calls == {"stem_conv_pool": 1, "bias_add_relu": 16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("encoder_type", ["resnet_sbert", "resnet_dsv2lite"])
def test_resnet_normalizer_rounds_the_float32_normaliser_once(encoder_type, dtype):
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 3, 9, 7), dtype=np.uint8))
    got = resnet_normalizer(encoder_type, dtype)(x)
    want = preprocess.make_normalizer(encoder_type)(x).to(dtype)
    assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)


@pytest.mark.parametrize("encoder_type", ["clip", "siglip", "resnet_sbert"])
def test_float32_normalizer_is_unchanged(encoder_type):
    """The normaliser CLIP and SigLIP run, bit for bit as it was written
    before the ResNet route had its own."""
    row = ENCODER_PAIRS[encoder_type]
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 3, 8, 8), dtype=np.uint8))
    mean_t, std_t = (torch.tensor(v, dtype=torch.float32).view(1, 3, 1, 1)
                     for v in (row.mean, row.std))
    got = preprocess.make_normalizer(encoder_type)(x)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, (x.to(torch.float32) / 255.0 - mean_t) / std_t)


def _activation(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).contiguous(memory_format=CL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_plain_version_equals_the_unfused_passes(dtype):
    y, res = _activation((2, 16, 5, 6), dtype, 0), _activation((2, 16, 5, 6), dtype, 1)
    bias = torch.randn(16, generator=torch.Generator().manual_seed(2))
    b4 = bias[None, :, None, None]
    got = resnet_nhwc.bias_add_relu(y, bias, res)
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    assert torch.equal(got, F.relu((y.float() + b4) + res.float()).to(dtype))
    assert torch.equal(resnet_nhwc.bias_add_relu(y, bias), F.relu(y.float() + b4).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(12, 12), (7, 9), (1, 2)])
def test_stem_pool_equals_pooling_before_the_epilogue(dtype, hw):
    """The kernel's order, the window's max and then the epilogue, gives
    the plain order's numbers bit for bit: both maps do not decrease."""
    y = _activation((2, 64, *hw), dtype, 3)
    bias = torch.randn(64, generator=torch.Generator().manual_seed(4))
    got = resnet_nhwc.stem_pool(y, bias)
    want = F.max_pool2d(F.relu(y.float() + bias[None, :, None, None]).to(dtype), 3, 2, padding=1)
    assert torch.equal(got, want)
    assert torch.equal(resnet_nhwc.bias_add_relu(F.max_pool2d(y, 3, 2, padding=1), bias), want)


def _stem_operands(shape, dtype, seed):
    """Stem input (B, 3, H, W) channels-last, a folded weight and a bias."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).to(dtype).contiguous(memory_format=CL)
    w = (0.1 * torch.randn((64, 3, 7, 7), generator=gen)).to(dtype)
    return x, w, torch.randn(64, generator=gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(16, 24), (15, 21), (14, 9), (1, 2)])
def test_stem_plain_version_is_the_convolution_then_the_stem_pool(dtype, hw):
    x, w, bias = _stem_operands((2, 3, *hw), dtype, 5)
    want = resnet_nhwc.stem_pool_reference(F.conv2d(x, w, stride=2, padding=3), bias)
    got = resnet_nhwc.stem_conv_pool_reference(x, w, bias)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(resnet_nhwc.stem_conv_pool(x, w, bias), want)


def _kernel_patches(x):
    """The stem's patches (B, OH, OW, STEM_K) as its kernel loads them: each
    input row (iy = -3 .. 2 OH + 1; rows outside the image zero) in a slot
    of 704 elements, its pixel ix, channel c at element 16 + 3 ix + c, the
    rest zero; K column k (its pair's even column k & ~1 at kernel row ky,
    column jj = divmod(k & ~1, 22); past column 153, the zero weights', an
    eighth row) at element 6 ox + jj + 6 + (k & 1) of conv row oy's kernel
    row ky. Here the eighth row past the image is random, as the ring's
    next row may be anything finite."""
    b, _, h, w = x.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    rows = x.permute(0, 2, 3, 1).reshape(b, h, 3 * w)
    slots = x.new_zeros((b, 2 * oh + 6, 704))
    slots[:, -1] = torch.randn(704, generator=torch.Generator().manual_seed(8), dtype=x.dtype)
    slots[:, 3:3 + h, 16:16 + 3 * w] = rows[:, :2 * oh + 2]
    k = torch.arange(resnet_nhwc.STEM_K)
    ky, jj = (k & ~1) // resnet_nhwc.STEM_ROW_K, (k & ~1) % resnet_nhwc.STEM_ROW_K
    assert int(ky.max()) == 7 and not (ky == 7).logical_and(k < 154).any()
    oy, ox = torch.arange(oh), torch.arange(ow)
    row = 2 * oy[:, None, None] + ky[None, None, :]
    element = 6 * ox[None, :, None] + (jj + 6 + (k & 1))[None, None, :]
    return slots[:, row, element]


@pytest.mark.parametrize("shape", [(2, 3, 37, 40), (1, 3, 6, 224)])
def test_packed_stem_weight_is_the_folded_weight_in_the_kernels_k_order(shape):
    """Column 22 ky + 1 + 3 kx + c of the packed weight is the folded
    weight's (c, ky, kx), every other column zero; the patches read as the
    kernel reads them, times the packed weight, are the convolution."""
    model = _model()
    with torch.no_grad():
        w, _ = model.conv1.fold(model.bn1, torch.float64)
    packed = resnet_nhwc.pack_stem_weight(w)
    assert packed.shape == (64, resnet_nhwc.STEM_K) and packed.dtype == torch.float64
    cols = [22 * ky + 1 + 3 * kx + c for ky in range(7) for kx in range(7) for c in range(3)]
    assert torch.equal(packed[:, cols], w.permute(0, 2, 3, 1).reshape(64, 147))
    rest = [k for k in range(resnet_nhwc.STEM_K) if k not in cols]
    assert len(rest) == 13 and not packed[:, rest].any()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    got = (_kernel_patches(x) @ packed.T).permute(0, 3, 1, 2)
    want = F.conv2d(x, w, stride=2, padding=3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def _features_before(model, images):
    """ResNet18.features as it ran with the stem's convolution apart from
    its pool: ``stem_pool(*conv1(x, bn1))``."""
    x = images.to(dtypes.resolve(model.cfg.compute_dtype), memory_format=CL)
    x = resnet_nhwc.stem_pool(*model.conv1(x, model.bn1))
    for stage in model.stages():
        x = stage(x)
    return x.mean(dim=(2, 3))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_features_on_the_cpu_are_what_they_were(compute_dtype):
    model = _model()
    model.cfg = dataclasses.replace(model.cfg, compute_dtype=compute_dtype)
    x = _images()
    with torch.no_grad():
        got = model.features(x)
        want = _features_before(model, x)
    assert got.dtype == dtypes.resolve(compute_dtype) and torch.equal(got, want)


def test_stem_checks_raise():
    """The stem's shape and geometry, checked on every route; the kernel
    route's own conditions (dtype, layout, width, gradient), checked by the
    function the card route calls."""
    x, w, bias = _stem_operands((2, 3, 16, 24), torch.bfloat16, 7)
    with pytest.raises(ValueError, match="B, 3, H, W"):
        resnet_nhwc.stem_conv_pool(torch.cat([x, x[:, :1]], dim=1), w, bias)
    with pytest.raises(ValueError, match="64, 3, 7, 7"):
        resnet_nhwc.stem_conv_pool(x, w[:32], bias)
    with pytest.raises(ValueError, match="64, 3, 7, 7"):
        resnet_nhwc.stem_conv_pool(x, w[:, :, 1:6, 1:6], bias)
    for stride, padding in ((1, 3), (2, 2)):
        with pytest.raises(ValueError, match="strides 2 with padding 3"):
            resnet_nhwc.stem_conv_pool(x, w, bias, stride, padding)
    operands = resnet_nhwc._stem_kernel_operands
    packed, b = operands(x, w, bias)
    assert torch.equal(packed, resnet_nhwc.pack_stem_weight(w)) and torch.equal(b, bias)
    with pytest.raises(ValueError, match="no gradient"):
        operands(x, w.clone().requires_grad_(), bias)
    with pytest.raises(ValueError, match="no gradient"):
        operands(x.clone().requires_grad_(), w, bias)
    with pytest.raises(TypeError):
        operands(x.float(), w.float(), bias)
    with pytest.raises(ValueError, match="channels-last"):
        operands(x.contiguous(), w, bias)
    with pytest.raises(ValueError, match="multiple of 8"):
        operands(x[..., :20].contiguous(memory_format=CL), w, bias)
    with pytest.raises(ValueError, match="bias"):
        operands(x, w, bias[:32])


def test_vision_span_once_an_encode():
    cfg = ItemEncoderConfig(encoder_type="resnet_sbert", dim_per_modality=8)
    enc = ItemEncoderModel(
        cfg, device="cpu", vision_cfg=ResNet18Config(**SMALL),
        text_cfg=MiniLMConfig(vocab_size=120, max_len=12, d_model=24, n_heads=4, d_mlp=48,
                              n_layers=1, d_out=8, compute_dtype="float32"))
    images = torch.zeros((2, 3, 32, 32), dtype=torch.uint8)
    ids = torch.ones((2, 12), dtype=torch.int32)
    trace.clear()
    with torch.no_grad():
        enc.encode(images, ids)
        assert trace.records() == []
        with profile(activities=[ProfilerActivity.CPU]):
            enc.encode(images, ids)
            enc.encode_images(images)
    assert [r.name for r in trace.records()] == ["outfitx.vision"] * 2
    trace.clear()


def test_vision_reader_and_its_cells():
    """``vision_ms.ocp``: Σ device s of ``outfitx.vision`` over the profiled
    microbatches, in ms; None without the spans (as on a program that has
    none) or without device seconds."""
    from outfitbench import registry
    from outfitbench.trace import Record, Spans

    read = registry.reader("vision_ms.ocp")
    rec = Record(cell={}, config={}, params={"accumulation": 2}, spans=Spans(), counters={},
                 trace=None, derived={"profiled_steps": 2})
    recs = [trace.Record(i, None, "outfitx.vision", None, 0.0, 1.0, 0.01 * i) for i in range(1, 5)]
    encode = [trace.Record(9, None, "outfitx.encode", None, 0.0, 1.0, 0.5)]
    assert read(rec, recs + encode) == pytest.approx(1e3 * 0.1 / 4, rel=1e-12)
    assert read(rec, encode) is None and read(None, recs) is None
    assert read(rec, [trace.Record(1, None, "outfitx.vision", None, 0.0, 1.0)]) is None
    (entry,) = [m for m in registry.load()["per_layer"] if m["name"] == "vision_ms.ocp"]
    assert entry["workloads"] == ["resnet-sbert.train_ocp", "dsv2lite.train_ocp"]
    assert (entry["layer"], entry["moves"]) == ("towers", "ocp_outfits_per_s")


# --------------------------------------------------------------- card --
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_equal_their_plain_versions_on_the_card(card, dtype):
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 3, 37, 41), dtype=np.uint8))
    row = ENCODER_PAIRS["resnet_sbert"]
    mean, std = (torch.tensor(v, dtype=torch.float32, device=card) for v in (row.mean, row.std))
    x = x.to(card)
    got = resnet_nhwc.normalize(x, mean, std, dtype)
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, resnet_nhwc.normalize_reference(x, mean, std, dtype))
    for shape in ((3, 64, 37, 41), (2, 128, 14, 14), (5, 512, 1, 1)):
        y, res = (_activation(shape, dtype, s).to(card) for s in (6, 7))
        bias = torch.randn(shape[1], generator=torch.Generator().manual_seed(8)).to(card)
        want = resnet_nhwc.bias_add_relu_reference(y, bias, res)
        assert torch.equal(resnet_nhwc.bias_add_relu(y.clone(), bias, res), want)
        want = resnet_nhwc.bias_add_relu_reference(y, bias)
        assert torch.equal(resnet_nhwc.bias_add_relu(y.clone(), bias), want)
        if shape[1] == 64:
            assert torch.equal(resnet_nhwc.stem_pool(y, bias),
                               resnet_nhwc.stem_pool_reference(y, bias))
    # The stem, against its plain version and against the route it replaced
    # (cuDNN's convolution, then stem_pool). In bfloat16 only the
    # convolution's float32 sum order differs: it can move a sum across a
    # bfloat16 rounding point, one unit in the last place of the pooled
    # value m (at most 2^-7 |m|); the epilogue's own rounding adds one of
    # the output (2^-7 max(1, |ref|)); everything after the convolution's
    # rounding is exact. Float32 is cuDNN's convolution, then stem_pool.
    for shape in ((3, 3, 37, 40), (2, 3, 224, 224), (2, 3, 45, 8), (2, 3, 23, 120)):
        x, w, bias = (t.to(card) for t in _stem_operands(shape, dtype, 9))
        before = resnet_nhwc.stem_conv_pool.launches
        got = resnet_nhwc.stem_conv_pool(x, w, bias)
        assert resnet_nhwc.stem_conv_pool.launches - before == (dtype == torch.bfloat16)
        conv = F.conv2d(x, w, stride=2, padding=3)
        for ref in (resnet_nhwc.stem_conv_pool_reference(x, w, bias),
                    resnet_nhwc.stem_pool(conv, bias)):
            assert got.shape == ref.shape and got.is_contiguous(memory_format=CL)
            if dtype == torch.float32:
                assert torch.equal(got, ref)
                continue
            m = F.max_pool2d(conv, 3, 2, padding=1).float()
            bound = 2.0 ** -7 * (ref.float().abs().clamp(min=1) + m.abs())
            assert ((got.float() - ref.float()).abs() <= bound).all()
    torch.cuda.synchronize()
