"""Int8 inference convolutions with a dynamic activation scale (port of the
JAX package's ``models/quantize.py``).

``QuantConv`` replaces the encoder's bias-free ``Conv2dSame`` with the same
``weight`` parameter ((O, I/groups, k, k) float32, the same state-dict key),
so checkpoints, BN folding and the weight importers work unchanged. It:

- scales the weight per output channel, ``s_w[o] = max(max|w[o]| / 127,
  1e-12)``, and rounds ``w / s_w`` to int8 in [-127, 127], from the float32
  parameter: once per weight version, device and dtype
  (``QuantConv.quantized_weight``; again after ``load_state_dict``, BN
  folding or a move), not on every call;
- scales the activation per tensor on each call, ``s_x = max(max|x| / 127,
  1e-12)``, one reduction that stays on the device;
- hands x in the compute dtype, ``s_x``, the int8 weight and ``s_w`` to one
  op (``ops/int8_conv.py::int8_conv2d``, ``bas_torch::int8_conv2d``): it
  rounds ``float32(x) / s_x`` to int8 in [-127, 127], takes the s8 × s8 →
  s32 sum of the TF-SAME conv and dequantizes it, ``float32(sum) · (s_x ·
  s_w[o])`` rounded into the compute dtype; the plain version on the CPU,
  one launch of a hand-written kernel on the card.

The arithmetic is the JAX package's as XLA compiles it in its jitted
programs: ``/ 127.0`` is folded into a product with the float32 reciprocal
of 127, while the division by the traced ``s_x`` and ``s_w`` stays a
division. ``torch.round`` rounds half to even, as ``jnp.round`` does.
A grouped (depthwise) conv runs the compute-dtype conv of ``Conv2dSame``.

The activation scale is the max over the whole tensor that JAX's conv sees.
On bands (spatial partitioning) it is the max over every band
(``band_max``), and zero rows outside the image quantize to zero, so the op
takes its windows of the float bands and quantizes them itself. Where one
call's batch is split into data shares on several devices (the chunked
engine and the serving mesh), ``run_shares`` runs each share's encoder in
its own thread of one ``ScaleGroup``: every ``QuantConv`` call waits for
every share's max and takes their max, as ``jnp.max`` over a batch sharded
by GSPMD does.

The gradient is JAX's: zero through the rounding, and through the scales'
maxima where grad is enabled (the conv then takes s_w from the weight
afresh, differentiably, not from the cache; the op's backward gives ``s_x``
and ``s_w`` theirs, ``ops/int8_conv.py``).
"""

from __future__ import annotations

import contextvars
import threading
from typing import Callable, Sequence, TypeVar

import numpy as np
import torch

from ball_action_spotting_torch.models.effnetv2 import Conv2dSame, same_pad
from ball_action_spotting_torch.ops import int8_conv
from ball_action_spotting_torch.ops.int8_conv import int8_conv2d, quantize
from ball_action_spotting_torch.parallel.spatial import Bands, band_max, row_op

__all__ = ["QuantConv", "ScaleGroup", "abs_max", "activation_scale", "quantize", "run_shares",
           "shared_max", "weight_scale"]

T = TypeVar("T")

_RECIP_127 = float(np.float32(1) / np.float32(127))  # XLA's folded reciprocal, exact in f32
_MIN_SCALE = 1e-12


def weight_scale(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, I, k, k) float32 weight → (int8 OHWI weight, float32 (O,) s_w)."""
    w = weight.float()
    s_w = (w.abs().amax(dim=(1, 2, 3)) * _RECIP_127).clamp_min(_MIN_SCALE)
    w_q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127).to(torch.int8)
    return w_q.permute(0, 2, 3, 1).contiguous(), s_w


def abs_max(x: torch.Tensor) -> torch.Tensor:
    """max|x| as a 0-dim float32 tensor, exact, in one reduction with no
    temporary of x's size (the infinity norm: ``aminmax`` read the flagship's
    activations at a twentieth of the card's memory rate)."""
    return torch.linalg.vector_norm(x, float("inf")).float()


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale from max|x| (over the share group, in one)."""
    return (shared_max(amax) * _RECIP_127).clamp_min(_MIN_SCALE)


class QuantConv(Conv2dSame):
    """Bias-free conv with on-the-fly int8 quantization (module docstring);
    NCHW in and out, like ``Conv2dSame``, with channels-last memory."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._quantized_for: tuple | None = None  # the weight's address, version, dtype, device
        self._quantized_from: torch.Tensor | None = None  # that weight, so the address stays its
        self._quantized: dict = {}  # device -> (w_q, s_w)

    # the hand-written kernels this module may launch (the route takes the shape)
    cuda_kernels = (int8_conv.KERNEL, int8_conv.GEMM_KERNEL, int8_conv.CONV3X3_KERNEL)

    def quantized_weight(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """``weight_scale`` of the weight on ``device``: (int8 (O, k, k, I)
        w_q, the layout both kernels read, and float32 (O,) s_w), kept for
        the weight's storage, version and dtype, so that ``load_state_dict``,
        BN folding and a move (each a new storage or a new version) compute
        it again. The cache holds the weight it was computed from: a new
        storage cannot take that one's address while the key names it.
        Traced into the program under ``torch.export``, and computed on
        each call for an inference tensor (which counts no versions)."""
        w = self.weight
        if torch.compiler.is_compiling() or w.is_inference():
            return weight_scale(w.to(device))
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._quantized_for != key:
            self._quantized_for, self._quantized_from, self._quantized = key, w.detach(), {}
        entry = self._quantized.get(device)
        if entry is None:
            with torch.inference_mode(False), torch.no_grad():
                entry = self._quantized[device] = weight_scale(w.detach().to(device))
        return entry

    def forward(self, x: torch.Tensor | Bands) -> torch.Tensor | Bands:
        if self.groups > 1:  # depthwise: the compute-dtype conv, as in JAX
            return super().forward(x)
        if isinstance(x, Bands):
            return self._forward_bands(x)
        s_x = activation_scale(abs_max(x))
        return self._int8(x, s_x, same_pad(x.shape[-2], self.weight.shape[-1], self.stride))

    def _forward_bands(self, x: Bands) -> Bands:
        """The scale from every band's max; the op on each window of the
        float bands (zero rows outside the image quantize to zero, so the
        windows give the bits of windows of quantized bands; the height's
        SAME pad from the global height, as ``Conv2dSame`` takes it)."""
        k = self.weight.shape[-1]
        s_x = activation_scale(band_max(x).float())
        top = same_pad(x.height, k, self.stride)[0]
        return row_op(x, k, self.stride, top, -(-x.height // self.stride),
                      lambda window: self._int8(window, s_x.to(window.device), (0, 0)))

    def _int8(self, x: torch.Tensor, s_x: torch.Tensor,
              rows_pad: tuple[int, int]) -> torch.Tensor:
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:  # s_w differentiable, as in JAX
            w_q, s_w = weight_scale(w.to(x.device))
        else:
            w_q, s_w = self.quantized_weight(x.device)
        left, right = same_pad(x.shape[-1], w_q.shape[1], self.stride)
        y = int8_conv2d(x.permute(0, 2, 3, 1), s_x, w_q, s_w, self.stride,
                        (*rows_pad, left, right), x.dtype)
        return y.permute(0, 3, 1, 2)


# --- one activation scale over data shares ---------------------------------

_SHARE = threading.local()


class ScaleGroup:
    """The data shares of one encoder call, each run in its own thread
    (``run_shares``). Each ``QuantConv`` call of a share hands its max|x|
    to ``max`` and waits for every share's; the max of them all, taken in
    share order on ``device``, comes back to each share's device."""

    def __init__(self, size: int, device: torch.device):
        self.device = device
        self._maxes: list = [None] * size
        self._total: torch.Tensor | None = None
        self._barrier = threading.Barrier(size, action=self._reduce)

    def _reduce(self) -> None:
        total = self._maxes[0].to(self.device)
        for m in self._maxes[1:]:
            total = torch.maximum(total, m.to(self.device))
        self._total = total

    def max(self, index: int, amax: torch.Tensor) -> torch.Tensor:
        self._maxes[index] = amax
        self._barrier.wait()
        return self._total.to(amax.device)

    def abort(self) -> None:
        self._barrier.abort()


def shared_max(amax: torch.Tensor) -> torch.Tensor:
    """``amax`` outside a share group; in one, the max over every share."""
    member = getattr(_SHARE, "member", None)
    return amax if member is None else member[0].max(member[1], amax)


def run_shares(calls: Sequence[Callable[[], T]], device: torch.device) -> list[T]:
    """Run one call's data shares (``calls``, each a share's encoder work)
    with one activation scale: with more than one, each in its own thread
    of a ``ScaleGroup`` on ``device``, under the caller's grad and
    inference modes (both are thread-local). A share that raises breaks the
    group, so that the others raise too; the first error is raised."""
    if len(calls) <= 1:
        return [call() for call in calls]
    group = ScaleGroup(len(calls), device)
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    results: list = [None] * len(calls)
    errors: list = []

    def work(i: int) -> None:
        _SHARE.member = (group, i)
        try:
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                results[i] = calls[i]()
        except BaseException as exc:  # noqa: BLE001 (re-raised by the caller)
            errors.append((isinstance(exc, threading.BrokenBarrierError), exc))
            group.abort()
        finally:
            _SHARE.member = None

    # each thread in a copy of the caller's context, so a share's tracer spans
    # (``utils/profiling.py``) nest in the caller's
    threads = [threading.Thread(target=contextvars.copy_context().run, args=(work, i), daemon=True)
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise sorted(errors, key=lambda e: e[0])[0][1]  # a share's own error first
    return results
