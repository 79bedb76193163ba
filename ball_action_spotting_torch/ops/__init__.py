"""Compute ops. ``gem``, ``dwconv3d``, ``warp``, ``int8_conv``,
``bias_act`` (the folded BN's bias, SiLU and residual add) and
``se_scale`` (the squeeze-excite gate multiply) hold hand-written Hopper
kernels (``csrc/``): each wrapper launches its kernel on a CUDA tensor (or
raises) and runs its plain PyTorch version on a CPU tensor; ``KERNELS``
lists every kernel of the port (``int8_conv`` has three: the k × k conv,
``csrc/int8_conv.cu``, the 1 × 1 GEMM, ``csrc/int8_gemm.cu``, and the 3 × 3
conv, ``csrc/int8_conv3x3.cu``). ``augment``, ``losses`` and ``mixup`` are
plain PyTorch around them."""

from ball_action_spotting_torch.ops import bias_act, dwconv3d, gem, int8_conv, se_scale, warp

KERNELS = (gem.KERNEL, dwconv3d.KERNEL, warp.KERNEL, int8_conv.KERNEL, int8_conv.GEMM_KERNEL,
           int8_conv.CONV3X3_KERNEL, bias_act.KERNEL, se_scale.KERNEL)

__all__ = ["KERNELS", "bias_act", "dwconv3d", "gem", "int8_conv", "se_scale", "warp"]
