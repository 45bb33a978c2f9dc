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
