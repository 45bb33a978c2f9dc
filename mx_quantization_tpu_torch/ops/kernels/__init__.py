"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version and a launch counter on its wrapper."""

import torch

# the MX block sizes of the port's kernels and their plain versions: those
# that divide 128 (the TPU attention kernels pad tokens to a multiple of
# 128), from 8 up; the TPU kernels also run 1, 2 and 4, which the port does
# not take yet (ROADMAP.md)
BLOCK_SIZES = (8, 16, 32, 64, 128)
# the same set for the CUDA sources, as the sum of its powers of two
BLOCK_DEFINES = (("MX_BLOCK_MASK", sum(BLOCK_SIZES)),)

# Every TPU kernel of the repository, as the line of its ``pl.pallas_call(``
# (the JAX package's and the root tools'), and the port's kernel that
# replaces it, by its wrapper's name
_JAX = "mx_quantization_tpu/ops/kernels/"
TPU_SITES = {
    _JAX + "quantize.py:157": "mx_quantize",                       # K1
    _JAX + "topk_attention.py:781": "fused_topk_attention_qkv",    # K2
    _JAX + "topk_attention.py:890": "fused_topk_attention",        # K3
    _JAX + "topk_attention.py:939": "fused_topk_attention_tiled",  # K4
    _JAX + "quantize.py:235": "ln_modulate_quantize",              # K5
    _JAX + "quantize.py:326": "gelu_quantize",                     # K6
    _JAX + "topk_attention.py:1161": "fused_topk_attention_qkv_t",  # K7
    # K8: the attention-ablation tools' cells
    "tools/attnk_bench.py:119": "ablate_attention",
    "tools/attnk_bench.py:258": "ablate_attention",
    "tools/attnk_bench.py:341": "ablate_attention",
    "tools/attnk_bench.py:464": "ablate_attention",
    "tools/attnk3_bench.py:264": "ablate_attention",
    "tools/servingk_bench.py:136": "ablate_attention",
    "tools/servingk_bench.py:250": "ablate_attention",
    "tools/passprice_bench.py:182": "ablate_attention",
    "tools/mx_matmul_ablation.py:97": "mx_matmul",                 # K9
    "tools/kth_bench.py:98": "kth_select",                         # K10
    "tools/lanequant_bench.py:133": "lane_quantize",               # K11
}


def tpu_site(kernel: str) -> str:
    """The one TPU site that the port's ``kernel`` replaces (K8, which
    replaces eight, names each in its variants)."""
    sites = [s for s, k in TPU_SITES.items() if k == kernel]
    if len(sites) != 1:
        raise ValueError(f"{kernel} replaces {len(sites)} TPU sites")
    return sites[0]


def records_grad(*tensors) -> bool:
    """Does autograd record a call on these tensors (grad enabled and one
    of them requires grad)?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def inference_only(kernel: str, *tensors) -> None:
    """Raise where autograd records a call of a kernel that has no
    backward (K5, K6, K7: the JAX package's Pallas kernels without a VJP),
    rather than hand back a gradient that skips it."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{kernel} is inference-only: it has no backward, in the JAX "
            "package as here; train without the opt-in that selects it "
            "(fuse_ln_modulate, fuse_gelu, qkv_layout='split_t')")
