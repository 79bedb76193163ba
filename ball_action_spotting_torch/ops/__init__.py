"""Compute ops. ``gem``, ``dwconv3d``, ``warp`` and ``int8_conv`` hold
hand-written Hopper kernels (``csrc/``): each wrapper launches its kernel on
a CUDA tensor (or raises) and runs its plain PyTorch version on a CPU
tensor; ``KERNELS`` lists every kernel of the port. ``int8_conv`` also
routes 1 × 1 convs to ``torch._int_mm`` (counted in ``int8_conv.INT_MM``).
``augment``, ``losses`` and ``mixup`` are plain PyTorch around them."""

from ball_action_spotting_torch.ops import dwconv3d, gem, int8_conv, warp

KERNELS = (gem.KERNEL, dwconv3d.KERNEL, warp.KERNEL, int8_conv.KERNEL)

__all__ = ["KERNELS", "dwconv3d", "gem", "int8_conv", "warp"]
