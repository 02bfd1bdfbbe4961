"""Published peaks of one NVIDIA H100 SXM card (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the kinds of kernel a device
trace is summed by."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "tf32": 495e12}
# The peak a whole step's share is taken against: the bfloat16 tensor cores.
STEP_PEAK_FLOPS = PEAK_FLOPS["bfloat16"]

# Kernel kinds by a substring of the kernel's name; the first match wins,
# and what matches none is "other". The Hopper GEMM's kernels are named by
# their epilogue (hg::gemm_kernel<BN, Epi>).
KERNEL_KINDS = (
    ("masked_mha_fwd", ("masked_mha_fwd",)),
    ("masked_mha_bwd", ("masked_mha_bwd",)),
    ("attn_block", ("attn_block", "AttnQkvEpi", "attn_core_kernel", "AttnOutEpi")),
    ("mlp_fused", ("mlp_fused", "MlpMidEpi", "MlpOutEpi")),
    ("layernorm", ("layernorm_",)),
    ("collective", ("nccl", "NCCL")),
    ("int8_matmul", ("gemm_s8", "i16832gemm", "imma", "s8s8")),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("convolution", ("conv", "implicit_", "winograd", "fft")),
    ("random", ("distribution", "philox", "random")),
    ("reduce", ("reduce_kernel",)),
    ("host_transfer", ("Memcpy", "Memset")),
    ("copy", ("copy",)),
    ("elementwise", ("elementwise",)),
)


def kind(name: str) -> str:
    """The kind of the kernel called ``name``."""
    return next(
        (k for k, keys in KERNEL_KINDS if any(s in name for s in keys)), "other"
    )
