"""Port augmentation against the JAX package, given the same sampled
values: the affine matrix helpers, the motion-blur kernel, posterize, the
photometric application and the whole application (warp + photometrics);
and the port's sampler by its statistics, since a ``torch.Generator``
cannot give ``jax.random``'s draws.

Tolerances (float32): 1e-5 absolute on [0, 1] images and on the matrices
(other orders of float32 sums); the statistical checks use bounds several
standard errors wide at their sample sizes."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.ops import augment as jaug
from ball_action_spotting_tpu.ops.warp import affine_warp_clip
from ball_action_spotting_torch.ops import augment as aug

ATOL = 1e-5
F32 = aug.AugmentConfig(warp_precision="highest")


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def test_matrix_helpers_match_jax():
    rng = np.random.default_rng(0)
    tx, ty, ang, sx, sy = (rng.uniform(-5, 5, 4).astype(np.float32) for _ in range(5))
    cx, cy = np.float32(47.5), np.float32(31.5)
    pairs = [
        (aug.translation(_t(tx), _t(ty)), jaug._translation(tx, ty)),
        (aug.rotation_scale_about(_t(cx + 0 * tx), _t(cy + 0 * tx), _t(ang), _t(sx), _t(sy)),
         jaug._rotation_scale_about(cx + 0 * tx, cy + 0 * tx, ang, sx, sy)),
        (aug.hflip_matrix(96.0, torch.tensor([True, False])),
         jaug._hflip_matrix(96.0, jnp.asarray([True, False]))),
        (aug.crop_matrix(_t(tx), _t(ty), _t(80 + sx), _t(50 + sy), 96.0, 64.0),
         jaug._crop_matrix(tx, ty, 80 + sx, 50 + sy, 96.0, 64.0)),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-6)


def test_motion_blur_kernel_matches_jax_draws():
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    kernels = np.stack([np.asarray(jaug._motion_blur_kernel(k, 11, 7.5, 1.0)) for k in keys])
    # JAX's two draws inside _motion_blur_kernel, reproduced
    angles, directions = [], []
    for k in keys:
        k_angle, k_dir = jax.random.split(k)
        angles.append(float(jax.random.uniform(k_angle, (), minval=-7.5, maxval=7.5)))
        directions.append(float(jax.random.uniform(k_dir, (), minval=-1.0, maxval=1.0)))
    port = aug.motion_blur_kernel(_t(angles), _t(directions), 11)
    np.testing.assert_allclose(port.numpy(), kernels, atol=ATOL)
    np.testing.assert_allclose(port.sum(dim=(1, 2)).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_posterize_matches_jax(dtype):
    x = np.random.default_rng(1).random((2, 3, 8, 8)).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    out = aug.posterize(tx, 3)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jaug._posterize(jx, 3), np.float32))


def _fixed_params(b, t, h, w, seed=0):
    """Sampled values (port layout) with every op active on some clip."""
    rng = np.random.default_rng(seed)
    k = 11
    blur = aug.motion_blur_kernel(_t(rng.uniform(-7.5, 7.5, b)), _t(rng.uniform(-1, 1, b)), k)
    blur[0] = 0.0
    blur[0, k // 2, k // 2] = 1.0  # clip 0 unblurred
    one = torch.ones(b)
    fwd = (aug.hflip_matrix(float(w), torch.tensor([True, False]))
           @ aug.rotation_scale_about(one * (w - 1) / 2, one * (h - 1) / 2,
                                      _t([2.0, -1.5]), one, one))
    cam = aug.translation(_t(rng.uniform(-2, 2, (b, t))), _t(rng.uniform(-1, 1, (b, t))))
    return dict(
        inv=torch.linalg.inv(fwd[:, None] @ cam),
        sharp=_t([0.7, 0.0]), blur_kernel=blur, bright=_t([1.1, 0.9]),
        contrast=_t([0.85, 1.15]), post=torch.tensor([False, True]),
        noise_apply=torch.tensor([True, False]),
        noise=_t(rng.normal(size=(b, t, h, w)) * 0.05),
    )


def _jax_params(p):
    gate = p["noise_apply"].numpy().astype(np.float32)[:, None, None, None]
    return dict(sharp=jnp.asarray(p["sharp"].numpy()), blur_kernel=jnp.asarray(p["blur_kernel"].numpy()),
                bright=jnp.asarray(p["bright"].numpy()), contrast=jnp.asarray(p["contrast"].numpy()),
                post=jnp.asarray(p["post"].numpy()), noise=jnp.asarray(p["noise"].numpy() * gate))


def test_photometrics_match_jax():
    b, t, h, w = 2, 3, 24, 40
    x = np.random.default_rng(2).random((b, t, h, w)).astype(np.float32)
    p = _fixed_params(b, t, h, w)
    out = aug.apply_photometrics(torch.from_numpy(x), p, F32)
    expected = jaug._apply_photometrics(jnp.asarray(x), _jax_params(p), jaug.AugmentConfig())
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=ATOL)


def test_apply_augment_matches_jax_warp_then_photometrics():
    b, t, h, w = 2, 3, 24, 40
    x = np.random.default_rng(3).random((b, t, h, w)).astype(np.float32)
    p = _fixed_params(b, t, h, w, seed=1)
    out = aug.apply_augment(torch.from_numpy(x), p, F32)
    warped = jnp.stack([affine_warp_clip(jnp.asarray(x[i]), jnp.asarray(p["inv"][i].numpy()),
                                         precision="highest") for i in range(b)])
    expected = jaug._apply_photometrics(warped, _jax_params(p), jaug.AugmentConfig())
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=ATOL)


def test_zero_probabilities_leave_the_input():
    cfg = dataclasses.replace(
        F32, camera_move_p=0.0, rotation_p=0.0, crop_p=0.0, hflip_p=0.0, sharpness_p=0.0,
        motion_blur_p=0.0, brightness_p=0.0, contrast_p=0.0, posterize_p=0.0, noise_p=0.0)
    x = torch.rand(2, 3, 24, 40, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    p = aug.sample_augment_params(g, g, 2, 3, 24, 40, cfg)
    np.testing.assert_array_equal(p["inv"].numpy(), np.broadcast_to(np.eye(3), (2, 3, 3, 3)))
    np.testing.assert_allclose(aug.apply_augment(x, p, cfg).numpy(), x.numpy(), atol=1e-6)


def test_compute_dtype_follows_warp_precision():
    assert aug.AugmentConfig().dtype == torch.bfloat16
    assert F32.dtype == torch.float32
    assert dataclasses.replace(F32, compute_dtype="bfloat16").dtype == torch.bfloat16
    x = torch.rand(1, 3, 16, 24)
    g = torch.Generator().manual_seed(0)
    cfg = aug.AugmentConfig()
    out = aug.apply_augment(x, aug.sample_augment_params(g, g, 1, 3, 16, 24, cfg), cfg)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape


def test_sampler_distributions():
    n, t, h, w = 4000, 3, 46, 80  # the flagship's 1280/736 aspect ratio
    cfg = aug.AugmentConfig()
    g = torch.Generator().manual_seed(0)
    p = aug.sample_augment_params(g, torch.Generator().manual_seed(1), n, t, h, w, cfg)

    def rate(active, p_expected):
        se = math.sqrt(p_expected * (1 - p_expected) / active.numel())
        assert abs(float(active.float().mean()) - p_expected) < 5 * se

    rate(p["post"], cfg.posterize_p)
    rate(p["noise_apply"], cfg.noise_p)
    rate(p["sharp"] > 0, cfg.sharpness_p)
    rate(p["bright"] != 1.0, cfg.brightness_p)
    rate(p["contrast"] != 1.0, cfg.contrast_p)
    centre = p["blur_kernel"][:, 5, 5]
    rate(centre < 1.0, cfg.motion_blur_p)
    for key, (lo, hi) in (("bright", cfg.brightness), ("contrast", cfg.contrast)):
        v = p[key]
        assert float(v.min()) >= lo and float(v.max()) <= hi
    assert float(p["sharp"].max()) <= cfg.sharpness
    noise = p["noise"].float()
    assert abs(float(noise.std()) - cfg.noise_std) < 0.005

    # hflip: the inverse map's x scale is negative
    fwd = torch.linalg.inv(p["inv"][:, 0])
    rate(fwd[:, 0, 0] < 0, cfg.hflip_p)
    # crop (no camera move, no rotation): the area scale and the aspect
    # ratio, log-uniform in the absolute band (r - 0.1, r + 0.1)
    sx, sy = fwd[:, 0, 0].abs(), fwd[:, 1, 1]
    last = torch.linalg.inv(p["inv"][:, -1])
    still = (fwd[:, 0, 1].abs() < 1e-6) & (last - fwd).abs().amax(dim=(1, 2)).lt(1e-6)
    cropped = still & (((sx - 1).abs() > 1e-6) | ((sy - 1).abs() > 1e-6))
    rate(cropped[still], cfg.crop_p)
    cw, ch = w / sx[cropped], h / sy[cropped]
    area = (cw * ch / (w * h)).numpy()
    ratio = (cw / ch).numpy()
    r = w / h
    assert area.min() >= 0.9 - 1e-4 and area.max() <= 1.0 + 1e-4
    clamped = (cw >= w - 1e-3) | (ch >= h - 1e-3)
    log_ratio = np.log(ratio[~clamped.numpy()])
    lo, hi = math.log(r - 0.1), math.log(r + 0.1)
    assert log_ratio.min() >= lo - 1e-4 and log_ratio.max() <= hi + 1e-4
    # uniform in log space: the mean sits at the band's midpoint; the
    # clamped crops (at the band's top) bias it slightly low
    assert abs(log_ratio.mean() - (lo + hi) / 2) < 0.01
