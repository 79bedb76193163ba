"""The GEMM kernel's quantize filter (``csrc/int8_gemm.cu``'s note) in its
float32 PyTorch mirror, ``ops/int8_conv.py::quantize_filtered``, against
``quantize`` (IEEE division, JAX's arithmetic) bit for bit on the CPU: over
every bfloat16 and float16 bit pattern, a million seeded float32 values,
and values within 2δ of a half-integer, at seeded scales down to 1e-12,
scales of ``activation_scale`` on tensors with an outlier, and scales whose
reciprocal is not a finite normal number (every element by division). The
kernel itself is held to the plain version on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from ball_action_spotting_torch.models.quantize import abs_max, activation_scale
from ball_action_spotting_torch.ops.int8_conv import FILTER_LIMIT, quantize, quantize_filtered

DELTA = 0.5 - FILTER_LIMIT


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as ``tests/test_torch_quantize.py``: the tier-1
    run shares the CPU among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def outlier_scales(count: int = 3) -> list:
    """``activation_scale`` of seeded tensors, each with one outlier."""
    scales = []
    for seed in range(count):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-3, 2)).astype(np.float32))
        x[rng.integers(4096)] = float(rng.uniform(5, 50)) * x.abs().max()
        scales.append(activation_scale(abs_max(x)))
    return scales


SCALES = [torch.tensor(s, dtype=torch.float32)
          for s in (1e-12, 1.0, 0.0123, 1e30, 3e38, 1e-40)] + outlier_scales()


def every_pattern(dtype: torch.dtype) -> torch.Tensor:
    return torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_filter_equals_division_on_every_16_bit_pattern(dtype):
    """Every bit pattern (NaN, ±inf, subnormals too) at every scale."""
    x = every_pattern(dtype)
    for s_x in SCALES:
        assert torch.equal(quantize_filtered(x, s_x), quantize(x, s_x)), s_x.item()


def test_filter_equals_division_on_seeded_float32():
    """10^6 seeded float32 values over twelve decades, each at the scale of
    its own max and at the fixed scales."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=10**6) * 10.0 ** rng.uniform(-6, 6, 10**6))
                         .astype(np.float32))
    for s_x in [activation_scale(abs_max(x)), *SCALES]:
        assert torch.equal(quantize_filtered(x, s_x), quantize(x, s_x)), s_x.item()


def test_filter_equals_division_near_half_integers():
    """Values whose quotient lies within 2δ of a half-integer: the filter
    sends them to the division, and the product alone would round some of
    them the other way."""
    rng = np.random.default_rng(11)
    flipped = 0
    for s_x in [*outlier_scales(), torch.tensor(0.01), torch.tensor(1e-12)]:
        s = s_x.item()
        n = rng.integers(-128, 128, 200_000)
        x = torch.from_numpy(((n + 0.5 + rng.uniform(-2 * DELTA, 2 * DELTA, n.size)) * s)
                             .astype(np.float32))
        t = (x * (torch.ones_like(s_x) / s_x)).clamp(-127, 127)
        assert ((t - t.round()).abs() >= FILTER_LIMIT).float().mean() > 0.25
        exact = quantize(x, s_x)
        assert torch.equal(quantize_filtered(x, s_x), exact), s
        flipped += int((t.round().to(torch.int8) != exact).sum())
    assert flipped > 0
