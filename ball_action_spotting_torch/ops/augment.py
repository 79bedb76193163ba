"""On-device training augmentations (port of the JAX package's
``ops/augment.py``).

Op set and parameter distributions of the reference pipeline:

  CameraMove p=.2 · Rotation ±2.5° p=.3 · ResizedCrop scale(.9,1) p=.8 ·
  HFlip p=.5 · Sharpness p=.2 · MotionBlur k11 p=.2 · Brightness(.8,1.2)
  p=.3 · Contrast(.8,1.2) p=.3 · Posterize 3bit p=.2 · GaussNoise σ=.05 p=.2

All geometric ops compose into one 3×3 matrix per frame and one bilinear
warp (``ops/warp.py``, the hand-written kernel on the card); the photometric
ops follow at batch level with the frames of the whole batch as the groups
of one depthwise convolution.

A ``torch.Generator`` cannot give ``jax.random``'s draws, so sampling and
application are split: ``sample_augment_params`` draws every random value of
a batch, ``apply_augment`` applies them deterministically. Tests feed both
packages the same sampled values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ball_action_spotting_torch.ops.warp import affine_warp


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    # camera move (two interpolated affine states across the clip)
    camera_move_p: float = 0.2
    camera_degrees: float = 2.5
    camera_translate: tuple[float, float] = (0.1, 0.05)
    camera_scale: tuple[float, float] = (0.95, 1.05)
    # whole-clip geometric ops
    rotation_p: float = 0.3
    rotation_degrees: float = 2.5
    crop_p: float = 0.8
    crop_scale: tuple[float, float] = (0.9, 1.0)
    crop_ratio_jitter: float = 0.1
    hflip_p: float = 0.5
    # photometric
    sharpness_p: float = 0.2
    sharpness: float = 1.0
    motion_blur_p: float = 0.2
    motion_blur_kernel: int = 11
    motion_blur_angle: float = 7.5
    motion_blur_direction: float = 1.0
    brightness_p: float = 0.3
    brightness: tuple[float, float] = (0.8, 1.2)
    contrast_p: float = 0.3
    contrast: tuple[float, float] = (0.8, 1.2)
    posterize_p: float = 0.2
    posterize_bits: int = 3
    noise_p: float = 0.2
    noise_std: float = 0.05
    # warp precision: "bfloat16" rounds the resample's image and weights to
    # bf16 with f32 sums (error ≤ ~4e-3, under the 1/255 uint8 step);
    # "highest" resamples in f32
    warp_precision: str = "bfloat16"
    # storage/compute dtype of the pipeline ("bfloat16"/"float32"); None
    # follows warp_precision. Reductions (contrast mean) and the posterize
    # quantization run in f32 whatever it is.
    compute_dtype: Optional[str] = None

    @property
    def dtype(self) -> torch.dtype:
        name = self.compute_dtype or (
            "bfloat16" if self.warp_precision == "bfloat16" else "float32")
        return torch.bfloat16 if name == "bfloat16" else torch.float32


# --- affine matrix helpers (3x3, forward transforms on (x, y, 1)) -----------


def _stack3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def translation(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _stack3([(o, z, tx), (z, o, ty), (z, z, o)])


def rotation_scale_about(cx, cy, angle_deg, sx, sy) -> torch.Tensor:
    """T(c) · R(θ) · S · T(-c)."""
    theta = torch.deg2rad(angle_deg)
    cos, sin = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(cos), torch.ones_like(cos)
    rs = _stack3([(cos * sx, -sin * sy, z), (sin * sx, cos * sy, z), (z, z, o)])
    return translation(cx, cy) @ rs @ translation(-cx, -cy)


def hflip_matrix(width: float, flip: torch.Tensor) -> torch.Tensor:
    """Identity or x → W-1-x, selected by boolean ``flip``."""
    a = torch.where(flip, -1.0, 1.0)
    t = torch.where(flip, width - 1.0, 0.0)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _stack3([(a, z, t), (z, o, z), (z, z, o)])


def crop_matrix(x0, y0, cw, ch, width: float, height: float) -> torch.Tensor:
    """Map crop box [x0, x0+cw)×[y0, y0+ch) onto the full canvas."""
    sx = width / cw
    sy = height / ch
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _stack3([(sx, z, -x0 * sx), (z, sy, -y0 * sy), (z, z, o)])


def _lerp(a, b, t):
    return a * (1.0 - t) + b * t


# --- photometric helpers -----------------------------------------------------

SHARP_KERNEL = (1.0 / 13.0) * torch.tensor(
    [[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]])


def motion_blur_kernel(angle: torch.Tensor, direction: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) angles in degrees and weight skews → (B, k, k) line kernels: a
    bilinear splat of a length-k line whose weights run linearly from
    (1-d)/2 to (1+d)/2, normalized to sum 1."""
    b = angle.shape[0]
    theta = torch.deg2rad(angle)[:, None]
    c = (k - 1) / 2.0
    ts = torch.arange(k, dtype=torch.float32, device=angle.device) - c
    xs = c + ts * torch.cos(theta)
    ys = c + ts * torch.sin(theta)
    weights = (1.0 - direction[:, None]) / 2.0 + (
        torch.arange(k, dtype=torch.float32, device=angle.device) / max(k - 1, 1)
    ) * direction[:, None]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    kernel = torch.zeros((b, k * k), dtype=torch.float32, device=angle.device)
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        idx = (y0 + dy).clamp(0, k - 1) * k + (x0 + dx).clamp(0, k - 1)
        kernel.scatter_add_(1, idx, weights * wgt)
    kernel = kernel.reshape(b, k, k)
    return kernel / kernel.sum(dim=(1, 2), keepdim=True)


def posterize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Keep the top ``bits`` bits of the 8-bit intensity (mask off the low
    bits). The ×255 quantization runs in f32 whatever the dtype."""
    shift = 8 - bits
    quantized = ((x.float() * 255.0).to(torch.int32) >> shift) << shift
    return (quantized.float() / 255.0).to(x.dtype)


def _depthwise_frames(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W) ⊛ per-frame (B·T, 1, k, k) kernels, SAME padding, with
    all frames of the batch as the groups of one convolution."""
    b, t, h, w = x.shape
    k = weight.shape[-1]
    out = F.conv2d(x.reshape(1, b * t, h, w), weight.to(x.dtype), padding=k // 2,
                   groups=b * t)
    return out.reshape(b, t, h, w)


# --- sampling ----------------------------------------------------------------


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _bernoulli(gen, shape, p: float):
    return torch.rand(shape, generator=gen, device=gen.device) < p


def sample_crop_ratio(gen, b: int, w: float, h: float, jitter: float) -> torch.Tensor:
    """Crop aspect relative to the frame ratio r=w/h, drawn log-uniformly
    over the absolute band (r-jitter, r+jitter); returns ratio / r."""
    r_img = w / h
    log_lo = math.log(max(r_img - jitter, 1e-6))
    log_hi = math.log(r_img + jitter)
    return torch.exp(_uniform(gen, (b,), log_lo, log_hi)) / r_img


def sample_augment_params(generator: torch.Generator, noise_generator: torch.Generator,
                          b: int, t: int, h: int, w: int,
                          cfg: AugmentConfig) -> dict[str, torch.Tensor]:
    """Every random value of one batch's augmentation.

    The per-clip values are drawn with ``generator`` on its device (a CPU
    generator keeps this small host math off the card); the batch noise
    with ``noise_generator`` on its device, in the compute dtype. Returns
    ``inv`` (B, T, 3, 3) inverse warp maps, ``sharp``, ``blur_kernel``
    (B, k, k), ``bright``, ``contrast``, the ``post`` and ``noise_apply``
    gates (B,) and ``noise`` (B, T, H, W), already scaled by ``noise_std``.
    """
    g = generator
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0

    # -- camera move: two affine endpoint states interpolated over T frames
    cam_apply = _bernoulli(g, (b,), cfg.camera_move_p)[:, None]
    cam_angle = _uniform(g, (b, 2), -cfg.camera_degrees, cfg.camera_degrees)
    cam_tx = _uniform(g, (b, 2), -cfg.camera_translate[0] * w, cfg.camera_translate[0] * w)
    cam_ty = _uniform(g, (b, 2), -cfg.camera_translate[1] * h, cfg.camera_translate[1] * h)
    cam_scale = _uniform(g, (b, 2), cfg.camera_scale[0], cfg.camera_scale[1])
    ts = torch.linspace(0.0, 1.0, t, device=g.device)[None, :]

    def endpoints(v, idle):
        return torch.where(cam_apply, _lerp(v[:, :1], v[:, 1:], ts), idle)

    ang_t, tx_t = endpoints(cam_angle, 0.0), endpoints(cam_tx, 0.0)
    ty_t, sc_t = endpoints(cam_ty, 0.0), endpoints(cam_scale, 1.0)
    full = torch.full((b, t), 1.0, device=g.device)
    cam_mats = translation(tx_t, ty_t) @ rotation_scale_about(
        full * cx, full * cy, ang_t, sc_t, sc_t)  # (B, T, 3, 3)

    # -- whole-clip rotation
    rot_apply = _bernoulli(g, (b,), cfg.rotation_p)
    rot_angle = torch.where(
        rot_apply, _uniform(g, (b,), -cfg.rotation_degrees, cfg.rotation_degrees), 0.0)
    ones = torch.ones(b, device=g.device)
    rot_mat = rotation_scale_about(ones * cx, ones * cy, rot_angle, ones, ones)

    # -- resized crop (area scale + log-uniform aspect + random position);
    # out-of-bounds crops clamp to the frame
    crop_apply = _bernoulli(g, (b,), cfg.crop_p)
    area = _uniform(g, (b,), cfg.crop_scale[0], cfg.crop_scale[1])
    aspect = sample_crop_ratio(g, b, float(w), float(h), cfg.crop_ratio_jitter)
    cw = torch.clamp(w * torch.sqrt(area * aspect), max=float(w))
    ch = torch.clamp(h * torch.sqrt(area / aspect), max=float(h))
    cw = torch.where(crop_apply, cw, float(w))
    ch = torch.where(crop_apply, ch, float(h))
    pos = torch.rand((b, 2), generator=g, device=g.device)
    crop_mat = crop_matrix(pos[:, 0] * (w - cw), pos[:, 1] * (h - ch), cw, ch,
                           float(w), float(h))

    # -- hflip
    flip_mat = hflip_matrix(float(w), _bernoulli(g, (b,), cfg.hflip_p))

    # forward F = flip · crop · rot · cam(t); the warp samples at F^{-1}
    fwd = (flip_mat @ crop_mat @ rot_mat)[:, None] @ cam_mats
    inv, _ = torch.linalg.inv_ex(fwd)

    sharp_apply = _bernoulli(g, (b,), cfg.sharpness_p)
    sharp = torch.where(sharp_apply, _uniform(g, (b,), 0.0, cfg.sharpness), 0.0)

    k = cfg.motion_blur_kernel
    blur_apply = _bernoulli(g, (b,), cfg.motion_blur_p)
    blur = motion_blur_kernel(
        _uniform(g, (b,), -cfg.motion_blur_angle, cfg.motion_blur_angle),
        _uniform(g, (b,), -cfg.motion_blur_direction, cfg.motion_blur_direction), k)
    identity = torch.zeros((k, k), device=g.device)
    identity[k // 2, k // 2] = 1.0
    blur = torch.where(blur_apply[:, None, None], blur, identity)

    bright_apply = _bernoulli(g, (b,), cfg.brightness_p)
    bright = torch.where(bright_apply, _uniform(g, (b,), *cfg.brightness), 1.0)
    contrast_apply = _bernoulli(g, (b,), cfg.contrast_p)
    contrast = torch.where(contrast_apply, _uniform(g, (b,), *cfg.contrast), 1.0)
    post = _bernoulli(g, (b,), cfg.posterize_p)
    noise_apply = _bernoulli(g, (b,), cfg.noise_p)

    noise = torch.randn((b, t, h, w), generator=noise_generator,
                        device=noise_generator.device, dtype=cfg.dtype) * cfg.noise_std
    return dict(inv=inv, sharp=sharp, blur_kernel=blur, bright=bright, contrast=contrast,
                post=post, noise_apply=noise_apply, noise=noise)


# --- application -------------------------------------------------------------


def apply_photometrics(x: torch.Tensor, p: dict, cfg: AugmentConfig) -> torch.Tensor:
    """The photometric ops on a warped (B, T, H, W) batch, in the reference
    order (sharpness → blur → brightness → contrast → posterize → noise)."""
    b, t, h, w = x.shape
    dt, dev = x.dtype, x.device

    def per_clip(v):
        return v.to(device=dev, dtype=dt)[:, None, None, None]

    # sharpness: unsharp-mask blend with the 3×3 smoothing kernel
    sharp_w = SHARP_KERNEL.to(dev).expand(b * t, 1, 3, 3)
    blurred = _depthwise_frames(x, sharp_w)
    x = torch.clamp(_lerp(x, blurred, -per_clip(p["sharp"])), 0.0, 1.0)

    # motion blur: each clip's kernel on each of its frames
    blur_w = p["blur_kernel"].to(dev).repeat_interleave(t, dim=0)[:, None]
    x = _depthwise_frames(x, blur_w)

    x = torch.clamp(x * per_clip(p["bright"]), 0.0, 1.0)

    # the contrast mean accumulates in f32 even under bf16 compute
    mean = x.float().mean(dim=(1, 2, 3), keepdim=True).to(dt)
    x = torch.clamp(mean + (x - mean) * per_clip(p["contrast"]), 0.0, 1.0)

    post = p["post"].to(dev)[:, None, None, None]
    x = torch.where(post, posterize(x, cfg.posterize_bits), x)

    noise = p["noise"].to(device=dev, dtype=dt) * per_clip(p["noise_apply"])
    return torch.clamp(x + noise, 0.0, 1.0)


def apply_augment(x: torch.Tensor, params: dict, cfg: AugmentConfig) -> torch.Tensor:
    """Apply sampled ``params`` to a (B, T, H, W) batch in [0, 1]: cast to
    the compute dtype, one affine warp per frame, then the photometrics."""
    b, t, h, w = x.shape
    x = x.to(cfg.dtype)
    inv = params["inv"].to(x.device).reshape(b * t, 3, 3)
    x = affine_warp(x.reshape(b * t, h, w), inv, precision=cfg.warp_precision)
    return apply_photometrics(x.reshape(b, t, h, w), params, cfg)
