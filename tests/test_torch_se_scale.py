"""The squeeze-excite gate multiply (``ops/se_scale.py``): on the CPU the
wrapper and the op against ATen's ``x * gate`` bit for bit, in the three
layouts the kernel reads and in bands; the checks of the op, the wrapper
and the kernel's route, the view the kernel is handed, the fake and the
gradient; both SE modules against a copy of their earlier forward, in
inference and in training, and the tracer's route counters. On the card
(tests marked ``cuda``, skipped without one) the kernel against ATen's
multiply at the prediction cells' shapes and at its edges, and the SE
modules through it."""

from __future__ import annotations

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ball_action_spotting_torch.models.blocks3d import InvertedResidual3d, SqueezeExcite3d
from ball_action_spotting_torch.models.effnetv2 import SqueezeExcite2d
from ball_action_spotting_torch.ops.bias_act import channel_planes
from ball_action_spotting_torch.ops.se_scale import (
    KERNEL,
    PLANES,
    kernel_view,
    se_scale,
    se_scale_cuda,
    se_scale_op,
    se_scale_reference,
)
from ball_action_spotting_torch.parallel.spatial import Bands, band_sum, bands_of
from ball_action_spotting_torch.utils import profiling

DTYPES = [torch.bfloat16, torch.float16, torch.float32]
LAYOUTS = ["channels_last_nchw", "nchw", "bthwc"]


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, so that equality is bit for bit."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])


def inputs(layout: str, dtype, c: int = 24, seed: int = 0, device="cpu", spatial=(5, 7)):
    """(x, gate, channels_last): an NCHW map in channels-last memory (the
    encoder's), in contiguous memory (a plane per channel) or an (N, T, H,
    W, C) one (the 3D head's), and its gate in the multiply's broadcast
    shape: (N, C, 1, 1) or (N, 1, 1, 1, C)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if layout == "bthwc":
        x = 4 * torch.randn(2, 3, *spatial, c, generator=g, device=device)
        gate = torch.rand(2, 1, 1, 1, c, generator=g, device=device)
    else:
        x = 4 * torch.randn(2, c, *spatial, generator=g, device=device)
        gate = torch.rand(2, c, 1, 1, generator=g, device=device)
        if layout == "channels_last_nchw":
            x = x.contiguous(memory_format=torch.channels_last)
    return x.to(dtype), gate.to(dtype), layout == "bthwc"


def op_view(x: torch.Tensor, gate: torch.Tensor, channels_last: bool):
    """The wrapper's view of the op's arguments: channels last, gate (N, C)."""
    n = x.shape[0]
    return (x, gate.reshape(n, -1)) if channels_last else (x.movedim(1, -1), gate.reshape(n, -1))


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
    return {k: v for k, v in counts.items() if k.startswith("se_scale.")}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_route_and_op_are_x_times_gate(dtype, layout):
    x, gate, channels_last = inputs(layout, dtype)
    want = x * gate
    with torch.no_grad():
        got = se_scale(x, gate, channels_last)
    assert got.dtype == dtype and got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(bits(got), bits(want))
    xv, gv = op_view(x, gate, channels_last)
    assert kernel_view(xv) is xv  # each of the three layouts is one the kernel reads
    op = se_scale_op(xv, gv)
    assert op.stride() == xv.stride() and torch.equal(bits(op), bits(se_scale_reference(xv, gv)))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fake_gives_shape_dtype_and_strides(layout):
    x, gate, channels_last = inputs(layout, torch.bfloat16)
    xv, gv = op_view(x, gate, channels_last)
    with FakeTensorMode() as mode:
        out = se_scale_op(mode.from_tensor(xv), mode.from_tensor(gv))
    assert (out.shape, out.dtype, out.stride()) == (xv.shape, xv.dtype, xv.stride())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_op_passes_opcheck_on_the_cpu(layout):
    x, gate, channels_last = inputs(layout, torch.float32)
    xv, gv = op_view(x, gate, channels_last)
    args = (xv.detach().requires_grad_(True), gv.detach().requires_grad_(True))
    results = torch.library.opcheck(se_scale_op, args)
    assert set(results.values()) == {"SUCCESS"}, results


@pytest.mark.parametrize("case", ["channels", "batch", "flat", "dtype", "scalar_x"])
def test_op_raises_on_a_gate_it_does_not_take(case):
    x = torch.rand(2, 5, 7, 24)
    gate = {"channels": torch.rand(2, 23), "batch": torch.rand(1, 24), "flat": torch.rand(48),
            "dtype": torch.rand(2, 24, dtype=torch.float64),
            "scalar_x": torch.rand(2, 24)}[case]
    if case == "scalar_x":
        x = torch.tensor(1.0)
    with pytest.raises(ValueError, match="se_scale expects a gate"):
        se_scale_op(x, gate)


VIEWS = {  # channels on the last axis
    "nhwc": lambda: torch.rand(2, 5, 7, 8),
    "bthwc": lambda: torch.rand(2, 3, 5, 7, 8),
    "planes": lambda: torch.rand(2, 8, 5, 7).movedim(1, -1),
    "strided": lambda: torch.rand(2, 5, 14, 8)[:, :, ::2],
    "transposed_hw": lambda: torch.rand(2, 7, 5, 8).transpose(1, 2),
}


@pytest.mark.parametrize("case", list(VIEWS))
def test_the_kernel_is_handed_a_dense_view(case):
    """A dense view (channels innermost, or a plane per channel) goes to the
    kernel as it is; any other is copied dense, channels innermost."""
    x = VIEWS[case]()
    view = kernel_view(x)
    assert torch.equal(view, x)
    if case in ("nhwc", "bthwc", "planes"):
        assert view is x
    else:
        assert view.is_contiguous() and not channel_planes(view)


@pytest.mark.parametrize("case", ["float64", "int", "strided", "transposed_hw",
                                  "strided_gate", "cpu"])
def test_the_kernel_route_raises_on_what_it_cannot_launch(case):
    """``se_scale_cuda`` launches or raises: a dtype the kernel does not
    compute, a view that is not dense (the wrapper makes it so first), a
    gate that is not contiguous, or a tensor off the card."""
    x, gate = VIEWS["nhwc"](), torch.rand(2, 8)
    if case in ("float64", "int"):
        dt = torch.float64 if case == "float64" else torch.int32
        x, gate = x.to(dt), gate.to(dt)
    elif case in ("strided", "transposed_hw"):
        x = VIEWS[case]()
    elif case == "strided_gate":
        gate = torch.rand(8, 2).t()
    with pytest.raises(ValueError, match="se_scale kernel"):
        se_scale_cuda(x, gate)


@pytest.mark.parametrize("case", ["batch_gate", "spatial_gate", "float32_gate"])
def test_the_wrapper_raises_on_a_gate_it_does_not_take(case):
    """A gate of another shape than (N, C, 1, 1), or of another dtype than
    x's, raises before any route is taken."""
    x, gate, _ = inputs("channels_last_nchw", torch.bfloat16)
    gate = {"batch_gate": gate[:1], "spatial_gate": torch.rand(2, 24, 5, 1).bfloat16(),
            "float32_gate": gate.float()}[case]
    with pytest.raises(ValueError, match="se_scale expects a gate"):
        route_counts(lambda: se_scale(x, gate))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_where_a_gradient_is_needed_the_op_gives_atens_gradients(layout):
    """The op's registered gradient, bit for bit ATen's for ``x * gate``."""
    x, gate, channels_last = inputs(layout, torch.float32)
    xa, ga = x.clone().requires_grad_(True), gate.clone().requires_grad_(True)
    xb, gb = x.clone().requires_grad_(True), gate.clone().requires_grad_(True)
    profiling.reset()
    profiling.enable()
    try:
        got = se_scale(xa, ga, channels_last)
    finally:
        profiling.disable()
    assert profiling.records().counters() == {"se_scale.plain": 1}
    profiling.reset()
    assert got.grad_fn.name() != "MulBackward0"
    want = xb * gb
    w = torch.rand_like(want)
    (got * w).sum().backward()
    (want * w).sum().backward()
    assert torch.equal(got, want) and torch.equal(xa.grad, xb.grad)
    assert torch.equal(ga.grad, gb.grad)


def test_the_op_differentiates_as_the_plain_version():
    x, gate, _ = inputs("bthwc", torch.float32)
    xv, gv = op_view(x, gate, True)
    xa, ga = xv.clone().requires_grad_(True), gv.clone().requires_grad_(True)
    xb, gb = xv.clone().requires_grad_(True), gv.clone().requires_grad_(True)
    w = torch.rand_like(xv)
    (se_scale_op(xa, ga) * w).sum().backward()
    (se_scale_reference(xb, gb) * w).sum().backward()
    assert torch.equal(xa.grad, xb.grad) and torch.equal(ga.grad, gb.grad)


def test_the_op_exports_and_runs_as_traced():
    """A 3D block traced by ``torch.export`` under ``no_grad`` holds one
    ``bas_torch::se_scale`` node and gives the live block's bits."""
    block = seeded(InvertedResidual3d(16, 4, 8), torch.float32)
    x = torch.randn(2, 3, 6, 5, 16, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        program = torch.export.export(block, (x,))
        want = block(x)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("bas_torch.se_scale.default") == 1
    assert torch.equal(bits(program.module()(x)), bits(want))


def seeded(module, dtype):
    torch.manual_seed(1)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.3 * torch.randn_like(p))
    return module.to(dtype).eval()


def old_forward(se, x):
    """A copy of each SE module's forward before the op."""
    if isinstance(se, SqueezeExcite2d):
        if isinstance(x, Bands):
            n = x.height * x.shape[3]
            return x.map_with(band_sum(x, (2, 3)), lambda t, total: t * torch.sigmoid(
                se._excite((total / n).to(t.dtype)[:, :, None, None])))
        return x * torch.sigmoid(se._excite(x.mean(dim=(2, 3), keepdim=True)))
    if isinstance(x, Bands):
        _, t, h, w, _ = x.shape
        return x.map_with(band_sum(x, (1, 2, 3)), lambda part, total: part * torch.sigmoid(
            se._excite((total / (t * h * w)).to(part.dtype)[:, None, None, None])))
    return x * torch.sigmoid(se._excite(x.mean(dim=(1, 2, 3), keepdim=True)))


def se_case(kind: str, dtype):
    """A seeded SE module and an input of its layout."""
    g = torch.Generator().manual_seed(2)
    if kind == "se2d":
        x = torch.randn(2, 32, 6, 5, generator=g).contiguous(memory_format=torch.channels_last)
        return seeded(SqueezeExcite2d(32, 8), dtype), x.to(dtype)
    if kind == "se2d_planes":
        return seeded(SqueezeExcite2d(32, 8), dtype), torch.randn(2, 32, 6, 5, generator=g).to(dtype)
    return seeded(SqueezeExcite3d(48, 8), dtype), torch.randn(2, 3, 6, 5, 48, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["se2d", "se2d_planes", "se3d"])
def test_se_modules_match_their_earlier_forward_and_count_their_route(kind, dtype):
    se, x = se_case(kind, dtype)
    with torch.no_grad():
        want = old_forward(se, x)
        got = se(x)
    assert got.stride() == want.stride() and torch.equal(bits(got), bits(want))
    assert route_counts(lambda: se(x)) == {"se_scale.plain": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["se2d", "se3d"])
def test_se_modules_in_bands_match_their_earlier_forward(kind, dtype):
    """Each band takes the op, with the gate of the whole image's mean."""
    se, x = se_case(kind, dtype)
    bands = bands_of(x, ["cpu", "cpu"], (0, 2, 6), 2)  # the height: NCHW and (N, T, H, W, C)
    with torch.no_grad():
        got, want = se(bands), old_forward(se, bands)
    assert got.cuts == want.cuts
    for a, b in zip(got.parts, want.parts):
        assert a.stride() == b.stride() and torch.equal(bits(a), bits(b))
    assert route_counts(lambda: se(bands)) == {"se_scale.plain": 2}


def train_and_compare(se, x):
    """One differentiated pass of ``se`` and of its earlier forward on
    ``x``: output and gradients (x's and the excite convs') bit for bit."""
    se.train()
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = se(xa)
    want = old_forward(se, xb)
    w = torch.rand(want.shape, generator=torch.Generator().manual_seed(4)).to(want)
    grads = [torch.autograd.grad((y * w).sum(), (xi, *se.parameters()))
             for y, xi in ((got, xa), (want, xb))]
    assert got.stride() == want.stride() and torch.equal(bits(got), bits(want))
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(*grads))


@pytest.mark.parametrize("kind", ["se2d", "se3d"])
def test_training_takes_the_op_with_the_earlier_numbers(kind):
    """In training the op and its registered gradient give the earlier
    forward's output and gradients bit for bit."""
    se, x = se_case(kind, torch.float32)
    profiling.reset()
    profiling.enable()
    try:
        train_and_compare(se, x)
    finally:
        profiling.disable()
    assert profiling.records().counters() == {"se_scale.plain": 1}
    profiling.reset()


def test_se_modules_name_the_kernel_they_launch():
    assert SqueezeExcite2d(8, 2).cuda_kernels == (KERNEL,)
    assert SqueezeExcite3d(16, 8).cuda_kernels == (KERNEL,)
    assert KERNEL in {k for m in InvertedResidual3d(16, 4, 8).modules()
                      for k in getattr(m, "cuda_kernels", ())}


def test_the_kernel_route_needs_a_cuda_tensor():
    x, gate, _ = inputs("channels_last_nchw", torch.bfloat16)
    KERNEL.reset_counts()
    assert route_counts(lambda: se_scale(x, gate)) == {"se_scale.plain": 1}
    assert KERNEL.launches == 0


# ------------------------------------------------------------ on the card ---

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    return torch.device("cuda")


def card_inputs(cuda, shape, dtype, seed, offset=0):
    """x of ``shape`` (channels last; ``offset`` elements past a 16-byte
    boundary) and a gate (N, C) in ``dtype``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    numel = 1
    for s in shape:
        numel *= s
    flat = (4 * torch.randn(numel + offset, generator=g, device=cuda)).to(dtype)
    gate = torch.rand(shape[0], shape[-1], generator=g, device=cuda).to(dtype)
    return flat[offset:].view(shape), gate


def assert_kernel_is_atens(x, gate, planes=False):
    """One call of the op against ATen's multiply on the card, bit for bit
    and in the same layout, and one launch (on planes where ``planes``)."""
    KERNEL.reset_counts()
    got = se_scale_op(x, gate)
    want = se_scale_reference(x, gate)
    torch.cuda.synchronize()
    assert KERNEL.launches == 1 and KERNEL.launches_by.get(PLANES, 0) == int(planes)
    assert got.stride() == want.stride() and torch.equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (256, 46, 80, 672),      # the encoder's stride-16 SE maps (NHWC)
    (256, 23, 40, 1152),     # its stride-32 ones
    (256, 5, 23, 40, 576),   # the 3D head's, 15 frames
    (256, 11, 23, 40, 576),  # 33 frames
])
def test_se_scale_kernel_at_the_prediction_shapes(cuda, shape):
    x, gate = card_inputs(cuda, shape, torch.bfloat16, 7)
    assert_kernel_is_atens(x, gate)
    del x
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,offset", [(8, 0), (36, 0), (576, 0), (1152, 0), (576, 1)])
def test_se_scale_kernel_edges(cuda, c, offset, dtype):
    """Rows that are no multiple of the unroll or the grid; C = 36 fills no
    whole 16-byte vector in bf16 and fp16, and an x one element past a
    16-byte boundary none at all (one element a thread)."""
    x, gate = card_inputs(cuda, (3, 4099, c), dtype, c, offset)
    assert_kernel_is_atens(x, gate)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", [(23, 40), (5, 7), (46, 80)])
def test_se_scale_kernel_on_channel_planes(cuda, hw, dtype):
    """A contiguous NCHW map, read as a plane per channel: 16-byte vectors
    where H·W allows, else one element a thread (5 × 7)."""
    x, gate = card_inputs(cuda, (2, *hw, 40), dtype, hw[0])
    assert_kernel_is_atens(x.movedim(-1, 1).contiguous().movedim(1, -1), gate, planes=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided", "transposed_hw"])
def test_se_scale_makes_a_view_it_does_not_read_dense(cuda, case):
    """The wrapper copies such a view dense, channels innermost, and
    launches the kernel on it: ATen's bits."""
    x, gate = card_inputs(cuda, (2, 9, 22, 40), torch.bfloat16, 3)
    x = x[:, :, ::2] if case == "strided" else x[:, :, :9].transpose(1, 2)
    KERNEL.reset_counts()
    assert route_counts(lambda: se_scale(x, gate[:, None, None, :], True)) == {
        "se_scale.kernel": 1}
    got = se_scale(x, gate[:, None, None, :], True)
    torch.cuda.synchronize()
    assert KERNEL.launches == 2
    assert torch.equal(bits(got), bits(x * gate[:, None, None, :]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["se2d", "se2d_planes", "se3d"])
def test_se_modules_on_the_card_launch_the_kernel_once(cuda, kind):
    se, x = se_case(kind, torch.bfloat16)
    se, x = se.to(cuda), x.to(cuda)
    KERNEL.reset_counts()
    with torch.no_grad():
        got, want = se(x), old_forward(se, x)
    torch.cuda.synchronize()
    assert KERNEL.launches == 1
    assert got.stride() == want.stride() and torch.equal(bits(got), bits(want))
    assert route_counts(lambda: se(x)) == {"se_scale.kernel": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["se2d", "se2d_planes", "se3d"])
def test_se_modules_on_the_card_train_through_the_kernel(cuda, kind):
    """A differentiated pass on the card launches the kernel and gives the
    earlier forward's output and gradients bit for bit."""
    se, x = se_case(kind, torch.float32)
    KERNEL.reset_counts()
    train_and_compare(se.to(cuda), x.to(cuda))
    assert KERNEL.launches == 1
