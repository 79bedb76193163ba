"""Port losses and mixup against the JAX package: focal and BCE loss values
and gradients, and mixup / cutmix for the same lambda and box (the test
reproduces the JAX sampler's draws and hands them to the port's
application).

Tolerances (float32): losses and gradients rtol 1e-6 + atol 1e-7 (the same
elementwise formula); mixed images atol 1e-6, targets 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.ops.losses import build_loss as jax_build_loss
from ball_action_spotting_tpu.ops.mixup import Mixup as JaxMixup
from ball_action_spotting_tpu.ops.mixup import mixup_target as jax_mixup_target
from ball_action_spotting_torch.ops.losses import LOSS_REGISTRY, build_loss
from ball_action_spotting_torch.ops.mixup import Mixup, make_mixup_fn, mixup_target


def _logits_targets(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(6, 2)) * 3).astype(np.float32)
    logits[0, 0] = 40.0  # saturated: the stable form must not overflow
    targets = (rng.random((6, 2)) > 0.5).astype(np.float32)
    targets[1] = 0.3  # soft (mixed) targets
    return logits, targets


@pytest.mark.parametrize("name,kwargs", [
    ("focal_loss", {"alpha": -1.0, "gamma": 1.2}),
    ("focal_loss", {"alpha": 0.4, "gamma": 2.0, "reduction": "sum"}),
    ("focal_loss", {"alpha": 0.25, "gamma": 1.2, "reduction": "none"}),
    ("BCEWithLogitsLoss", {}),
])
def test_loss_and_gradient_match_jax(name, kwargs):
    logits, targets = _logits_targets()
    jax_loss = jax_build_loss(name, **kwargs)

    def total(x):
        return jnp.sum(jax_loss(x, jnp.asarray(targets)))

    expected, expected_grad = jax.value_and_grad(total)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = build_loss(name, **kwargs)(x, torch.from_numpy(targets))
    loss.sum().backward()
    np.testing.assert_allclose(loss.sum().item(), float(expected), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(expected_grad), rtol=1e-6, atol=1e-7)


def test_focal_loss_runs_in_float32():
    logits, targets = _logits_targets(1)
    loss = build_loss("focal_loss", gamma=1.2)(torch.from_numpy(logits).bfloat16(),
                                               torch.from_numpy(targets))
    assert loss.dtype == torch.float32
    assert sorted(LOSS_REGISTRY) == ["BCEWithLogitsLoss", "focal_loss"]


def _jax_draws(mix: JaxMixup, key, h, w):
    """The draws inside JAX's ``Mixup.__call__``, reproduced."""
    k_apply, k_switch, k_lam, k_box = jax.random.split(key, 4)
    use_cutmix = bool(mix.cutmix_alpha > 0.0 and (
        mix.mixup_alpha <= 0.0 or bool(jax.random.bernoulli(k_switch, mix.switch_prob))))
    alpha = mix.cutmix_alpha if use_cutmix else mix.mixup_alpha
    lam = float(jax.random.beta(k_lam, alpha, alpha))
    if not bool(jax.random.bernoulli(k_apply, mix.prob)):
        lam = 1.0
    ky, kx = jax.random.split(k_box)
    return dict(use_cutmix=use_cutmix, lam=lam,
                cy=int(jax.random.randint(ky, (), 0, h)), cx=int(jax.random.randint(kx, (), 0, w)))


@pytest.mark.parametrize("kwargs,seed", [
    ({"mixup_alpha": 0.8}, 0),
    ({"mixup_alpha": 0.8, "label_smoothing": 0.1}, 1),
    ({"mixup_alpha": 0.0, "cutmix_alpha": 1.0}, 2),
    ({"mixup_alpha": 0.8, "cutmix_alpha": 1.0, "switch_prob": 1.0}, 3),
    ({"mixup_alpha": 0.8, "prob": 0.0}, 4),
])
def test_mixup_application_matches_jax(kwargs, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((4, 3, 8, 10)).astype(np.float32)
    t = (rng.random((4, 2)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jax_mix = JaxMixup(**kwargs)
    xm, tm = jax_mix(key, jnp.asarray(x), jnp.asarray(t))
    params = _jax_draws(jax_mix, key, 8, 10)
    out_x, out_t = Mixup(**kwargs).apply(torch.from_numpy(x), torch.from_numpy(t), params)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(xm), atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(tm), atol=1e-6)


def test_mixup_target_and_sampler():
    t = np.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], np.float32)
    np.testing.assert_allclose(mixup_target(torch.from_numpy(t), 0.7, 0.1).numpy(),
                               np.asarray(jax_mixup_target(jnp.asarray(t), 0.7, 0.1)), atol=1e-7)
    mix = Mixup(mixup_alpha=0.8, cutmix_alpha=1.0)
    g = torch.Generator().manual_seed(0)
    draws = [mix.sample(g, 8, 10) for _ in range(400)]
    lams = np.array([d["lam"] for d in draws])
    assert 0.0 <= lams.min() and lams.max() <= 1.0
    share = np.mean([d["use_cutmix"] for d in draws])
    assert abs(share - 0.5) < 0.1  # switch_prob 0.5
    assert all(0 <= d["cy"] < 8 and 0 <= d["cx"] < 10 for d in draws)
    assert make_mixup_fn(None) is None and make_mixup_fn({"mixup_alpha": 0.4}).mixup_alpha == 0.4
