"""The folded BatchNorm's epilogue (``ops/bias_act.py``) on the CPU: the
wrapper and the op against the unfused sequence the folded BN ran before,
bit for bit; the op's fake; every block kind in its folded form (SiLU, and
activations the kernel does not compute, applied apart) against a copy of
its earlier forward, unbanded and in bands; and the tracer's route
counters. The kernel itself runs in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from ball_action_spotting_torch.models.blocks3d import InvertedResidual3d
from ball_action_spotting_torch.models.effnetv2 import (
    BatchNormAct,
    ConvBnAct,
    EdgeResidual,
    InvertedResidual2d,
)
from ball_action_spotting_torch.ops.bias_act import (
    KERNEL,
    bias_act,
    bias_act_op,
    channel_planes,
)
from ball_action_spotting_torch.parallel.spatial import Bands, bands_of
from ball_action_spotting_torch.utils import profiling

DTYPES = [torch.bfloat16, torch.float16, torch.float32]
GELU = lambda x: F.gelu(x, approximate="tanh")  # noqa: E731  (multidim_stacker's "gelu")


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, so that equality is bit for bit."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])


def inputs(layout: str, dtype, c: int = 24, seed: int = 0):
    """(x, bias, residual, channels_last): an NCHW tensor in channels-last
    memory (the encoder's) or an (N, T, H, W, C) one (the 3D head's)."""
    g = torch.Generator().manual_seed(seed)
    shape = (2, c, 5, 7) if layout == "nchw" else (2, 3, 4, 5, c)
    x, r = (4 * torch.randn(shape, generator=g) for _ in range(2))
    bias = torch.randn(c, generator=g)
    if layout == "nchw":
        x, r = (t.contiguous(memory_format=torch.channels_last) for t in (x, r))
    return x.to(dtype), bias, r.to(dtype), layout != "nchw"


def unfused(x, bias, act, residual, channels_last):
    """The folded BN's sequence before the epilogue op: bias, act, skip."""
    shape = (-1,) if channels_last else (-1,) + (1,) * (x.dim() - 2)
    y = x + bias.to(x.dtype).view(shape)
    y = y if act is None else act(y)
    return y if residual is None else y + residual


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("act", [F.silu, None], ids=["silu", "none"])
@pytest.mark.parametrize("layout", ["nchw", "bthwc"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_route_and_op_match_the_unfused_sequence(dtype, layout, act, with_residual):
    x, bias, r, channels_last = inputs(layout, dtype)
    r = r if with_residual else None
    want = unfused(x, bias, act, r, channels_last)
    got = bias_act(x, bias, act, r, channels_last)
    assert got.dtype == dtype and got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(bits(got), bits(want))
    # the op on the channels-last view, as the kernel route calls it
    view = (lambda t: t) if channels_last else (lambda t: t.permute(0, 2, 3, 1))
    op = bias_act_op(view(x), bias.to(dtype), None if r is None else view(r),
                     "none" if act is None else "silu")
    assert torch.equal(bits(op), bits(view(want)))


@pytest.mark.parametrize("layout", ["nchw", "bthwc"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_fake_gives_shape_dtype_and_strides(layout, with_residual):
    x, bias, r, channels_last = inputs(layout, torch.bfloat16)
    if not channels_last:
        x, r = x.permute(0, 2, 3, 1), r.permute(0, 2, 3, 1)
    bias = bias.to(x.dtype)
    with FakeTensorMode() as mode:
        fx, fb = mode.from_tensor(x), mode.from_tensor(bias)
        fr = mode.from_tensor(r) if with_residual else None
        out = bias_act_op(fx, fb, fr, "silu")
    assert (out.shape, out.dtype, out.stride()) == (x.shape, x.dtype, x.stride())


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("act", ["silu", "none"])
def test_op_passes_opcheck_on_the_cpu(act, with_residual):
    x, bias, r, _ = inputs("bthwc", torch.float32)
    bias.requires_grad_(True)
    args = (x.requires_grad_(True), bias, r if with_residual else None, act)
    results = torch.library.opcheck(bias_act_op, args)
    assert set(results.values()) == {"SUCCESS"}, results


@pytest.mark.parametrize("case,want", [
    ("nchw", True), ("channels_last_nchw", False), ("bthwc", False), ("n11c", False),
    ("strided_nchw", False), ("nc", False)])
def test_channel_planes_is_a_contiguous_nchw_view(case, want):
    """The kernel's second layout: the channels-last view of a contiguous
    NCHW tensor, and no tensor whose channels are innermost as well."""
    x = {"nchw": lambda: torch.zeros(2, 8, 5, 7).movedim(1, -1),
         "channels_last_nchw": lambda: torch.zeros(2, 5, 7, 8),
         "bthwc": lambda: torch.zeros(2, 3, 5, 7, 8),
         "n11c": lambda: torch.zeros(2, 8, 1, 1).movedim(1, -1),
         "strided_nchw": lambda: torch.zeros(2, 8, 5, 14)[..., ::2].movedim(1, -1),
         "nc": lambda: torch.zeros(2, 8)}[case]()
    assert channel_planes(x) == want


def test_the_kernel_route_needs_a_cuda_tensor():
    x, bias, r, _ = inputs("bthwc", torch.bfloat16)
    KERNEL.reset_counts()
    assert route_counts(lambda: bias_act(x, bias, F.silu, r)) == {"bias_act.plain": 1}
    assert KERNEL.launches == 0


@pytest.mark.parametrize("act", [F.relu, F.mish, torch.sigmoid], ids=["relu", "mish", "sigmoid"])
def test_an_activation_the_kernel_does_not_compute_raises(act):
    x, bias, _, _ = inputs("bthwc", torch.float32)
    with pytest.raises(ValueError, match="SiLU or no activation"):
        bias_act(x, bias, act)


def old_bn(bn: BatchNormAct, x):
    """The folded BN's forward before the epilogue op, band by band on
    bands."""
    if isinstance(x, Bands):
        return x.map(lambda t: old_bn(bn, t))
    return unfused(x, bn.bias, bn.act, None, bn.channels_last)


def old_forward(block, x):
    """A copy of each block's forward before its last BN took the skip."""
    if isinstance(block, ConvBnAct):
        out = old_bn(block.bn1, block.conv(x))
        return out + x if block.has_skip else out
    if isinstance(block, EdgeResidual):
        out = old_bn(block.bn2, block.conv_pwl(old_bn(block.bn1, block.conv_exp(x))))
        return out + x if block.has_skip else out
    if isinstance(block, InvertedResidual2d):
        out = old_bn(block.bn2, block.conv_dw(old_bn(block.bn1, block.conv_pw(x))))
        if block.se is not None:
            out = block.se(out)
        out = old_bn(block.bn3, block.conv_pwl(out))
        return out + x if block.has_skip else out
    out = old_bn(block.bn2, block.conv_dw(old_bn(block.bn1, block.conv_pw(x))))
    return old_bn(block.bn3, block.conv_pwl(block.se(out))) + x


BLOCKS = {
    "bn_silu": lambda: BatchNormAct(16, F.silu, folded=True),
    "bn_none_channels_last": lambda: BatchNormAct(16, None, folded=True, channels_last=True),
    "conv_bn_act_skip": lambda: ConvBnAct(16, 16, 3, 1, bn_folded=True),
    "conv_bn_act_stride": lambda: ConvBnAct(16, 24, 3, 2, bn_folded=True),
    "edge_residual_skip": lambda: EdgeResidual(16, 16, 3, 1, 4, bn_folded=True),
    "edge_residual_stride": lambda: EdgeResidual(16, 24, 3, 2, 4, bn_folded=True),
    "inverted_residual_2d_skip": lambda: InvertedResidual2d(16, 16, 3, 1, 4, 0.25,
                                                            bn_folded=True),
    "inverted_residual_2d_stride": lambda: InvertedResidual2d(16, 24, 3, 2, 4, 0.25,
                                                              bn_folded=True),
    "inverted_residual_3d": lambda: InvertedResidual3d(16, 4, 8, bn_folded=True),
    # activations the kernel does not compute: the bias in the op, the rest apart
    "bn_relu": lambda: BatchNormAct(16, F.relu, folded=True),
    "conv_bn_act_skip_gelu": lambda: ConvBnAct(16, 16, 3, 1, act=GELU, bn_folded=True),
    "inverted_residual_3d_mish": lambda: InvertedResidual3d(16, 4, 8, act=F.mish,
                                                            bn_folded=True),
}


def seeded(name: str, dtype):
    """A block of ``BLOCKS`` in eval mode with seeded weights and biases,
    and an input of its layout."""
    torch.manual_seed(1)
    block = BLOCKS[name]().eval()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(0.3 * torch.randn_like(p))
    block = block.to(dtype)
    g = torch.Generator().manual_seed(2)
    if name == "bn_none_channels_last" or name.startswith("inverted_residual_3d"):
        x = torch.randn((2, 6, 5, 16) if name.startswith("bn") else (2, 3, 6, 5, 16), generator=g)
    else:
        x = torch.randn(2, 16, 6, 5, generator=g).contiguous(memory_format=torch.channels_last)
    return block, x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_folded_blocks_match_their_earlier_forward(name, dtype):
    block, x = seeded(name, dtype)
    with torch.no_grad():
        assert torch.equal(bits(block(x)), bits(old_forward(block, x) if not isinstance(
            block, BatchNormAct) else old_bn(block, x)))


@pytest.mark.parametrize("name", ["conv_bn_act_skip", "edge_residual_skip",
                                  "inverted_residual_2d_skip", "inverted_residual_3d",
                                  "conv_bn_act_skip_gelu", "inverted_residual_3d_mish"])
def test_folded_blocks_in_bands_match_their_earlier_forward(name):
    block, x = seeded(name, torch.float32)
    axis = 2  # the height: (N, C, H, W) and (N, T, H, W, C) alike
    bands = bands_of(x, ["cpu", "cpu"], (0, 3, 6), axis)
    with torch.no_grad():
        got, want = block(bands), old_forward(block, bands)
    assert got.cuts == want.cuts
    for a, b in zip(got.parts, want.parts):
        assert torch.equal(bits(a), bits(b))


def route_counts(fn) -> dict:
    profiling.reset()
    profiling.enable()
    try:
        with torch.no_grad():
            fn()
    finally:
        profiling.disable()
    counts = profiling.records().counters()
    profiling.reset()
    return {k: v for k, v in counts.items() if k.startswith("bias_act.")}


def test_folded_epilogues_count_their_route():
    block, x = seeded("inverted_residual_3d", torch.float32)
    assert route_counts(lambda: block(x)) == {"bias_act.plain": 3}


def test_an_activation_applied_apart_is_counted():
    block, x = seeded("inverted_residual_3d_mish", torch.float32)
    assert route_counts(lambda: block(x)) == {"bias_act.plain": 3, "bias_act.act_apart": 2}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_unfolded_bn_counts_no_epilogue(mode):
    bn = BatchNormAct(16, F.silu).train(mode == "train")
    x = torch.randn(2, 16, 6, 5)
    assert route_counts(lambda: bn(x)) == {}
    block = InvertedResidual3d(16, 4, 8).train(mode == "train")
    assert route_counts(lambda: block(torch.randn(2, 3, 6, 5, 16))) == {}


def test_only_a_folded_bn_takes_a_residual():
    x = torch.randn(2, 16, 6, 5)
    with pytest.raises(ValueError, match="folded"):
        BatchNormAct(16).eval()(x, residual=x)
    with pytest.raises(ValueError, match="inference-only"):
        BatchNormAct(16, folded=True).train()(x, residual=x)
