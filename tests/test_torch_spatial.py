"""Spatial partitioning in the port (``parallel/spatial.py`` and the band
paths of the models, the ops, the chunked engine and the train step) on the
CPU, against the unbanded port and the JAX package's spatially partitioned
engine and train step.

Tolerances: ``window`` is exact (it copies rows). Banded convs, the banded
encoder (standard and s2d stems) and the banded 3D head against the
unbanded ones: float32, 1e-5 (other orders of the float32 sums of the
cross-band means). The band-partial GeM against autograd of its plain
formula and, after the band combination, against ``gem_pool_reference``:
1e-5 relative. The chunked engine against JAX's on its 8-device CPU mesh:
atol 1e-5, JAX's own tolerance for its spatial engine. The banded train
step against JAX's on frames sharded by ``spatial_frames_sharding``:
float32, drop path on (both sides given the same masks), loss rel 1e-5,
gradients 1e-4·max|ref| per tensor + 1e-7 (a BN bias followed by another
batch-statistic BN has a gradient that is 0 up to rounding, as
``tests/test_torch_train.py``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

import ball_action_spotting_tpu.models.effnetv2 as jax_effnetv2
from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.ops.focal_loss import FocalLoss as JaxFocalLoss
from ball_action_spotting_tpu.parallel.mesh import (
    batch_sharding,
    make_mesh as jax_make_mesh,
    replicated,
    spatial_frames_sharding,
)
from ball_action_spotting_tpu.predict.streaming import (
    ChunkedVideoPredictor as JaxChunkedVideoPredictor,
    iter_source_frames as jax_iter_source_frames,
)
from ball_action_spotting_tpu.train.state import TrainState as JaxTrainState
from ball_action_spotting_tpu.train.steps import make_train_step as jax_make_train_step
import ball_action_spotting_torch.models.effnetv2 as effnetv2
from ball_action_spotting_torch.convert import state_dict_to_flax_tree
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.models import build_model, init_weights
from ball_action_spotting_torch.models.effnetv2 import Conv2dSame, same_pad
from ball_action_spotting_torch.ops.gem import (
    gem_pool_bands,
    gem_pool_partial,
    gem_pool_partial_reference,
    gem_pool_reference,
)
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.parallel.mesh import make_mesh, spatial_bands
from ball_action_spotting_torch.parallel.spatial import (
    COUNTS,
    Bands,
    balanced_cuts,
    band_sum,
    bands_of,
    row_op,
    window,
)
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    iter_source_frames,
)
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step
from tests.test_predictor import FRAME_COUNT
from tests.test_torch_fused import make_ckpt
from tests.test_torch_models import NN_KWARGS as TINY_KWARGS
from tests.test_torch_models import register_port_tiny_arch

register_port_tiny_arch()

SRC_KWARGS = dict(num_frames=FRAME_COUNT, height=64, width=96, seed=1, events={20: 0, 30: 1})
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny arch gains nothing from intra-op threads beside the
    suite's other workers (as ``tests/test_torch_chain.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_bands(x: torch.Tensor, n: int, axis: int) -> Bands:
    return bands_of(x, *spatial_bands(make_mesh(1, n, ["cpu"] * n), x.shape[axis]), axis)


# ------------------------------------------------------------- primitives ---

@settings(max_examples=60, deadline=None, database=None)
@given(h=st.integers(1, 40), n=st.integers(1, 6), k=st.sampled_from([2, 3]),
       s=st.sampled_from([1, 2]))
def test_window_is_a_slice_of_the_zero_padded_tensor(h, n, k, s):
    """Each band's window of the per-layer cut rule, for k ∈ {2, 3}, s ∈
    {1, 2}, odd and even heights and as many bands as rows or more (empty
    bands included), is the zero-padded global tensor's slice."""
    x = torch.arange(2 * h * 3, dtype=torch.float32).reshape(2, h, 3) + 1
    bands = cpu_bands(x, n, axis=1)
    top = same_pad(h, k, s)[0]
    rows_out = -(-h // s)
    cuts = balanced_cuts(rows_out, n)
    assert cuts == spatial_bands(make_mesh(1, n, ["cpu"] * n), rows_out)[1]
    pad = k + s
    padded = F.pad(x, (0, 0, pad, pad))
    for i in range(n):
        a, b = cuts[i], cuts[i + 1]
        if b == a:
            continue
        lo, hi = a * s - top, (b - 1) * s - top + k
        torch.testing.assert_close(window(bands, i, lo, hi), padded[:, lo + pad:hi + pad],
                                   rtol=0, atol=0)


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(2, 24), n=st.integers(1, 5), k=st.sampled_from([1, 2, 3]),
       s=st.sampled_from([1, 2]))
def test_banded_conv_matches_the_conv(h, n, k, s):
    """``Conv2dSame`` on bands (its window from ``row_op``, its padding from
    the global height), gathered, equals the unbanded conv; so does the
    s2d stem's kernel-2 stride-2 row op on an even height."""
    g = torch.Generator().manual_seed(h * 31 + n)
    conv = Conv2dSame(3, 4, k, s)
    conv.weight.data = torch.randn(conv.weight.shape, generator=g)
    x = torch.randn(2, 3, h, 7, generator=g)
    ref = conv(x)
    out = conv(cpu_bands(x, n, axis=2))
    assert out.cuts == balanced_cuts(ref.shape[2], n)
    torch.testing.assert_close(out.gather(), ref, rtol=0, atol=ATOL)
    if h % 2 == 0:
        s2d = row_op(cpu_bands(x[..., :6], n, axis=2), 2, 2, 0, h // 2, effnetv2.space_to_depth)
        torch.testing.assert_close(s2d.gather(), effnetv2.space_to_depth(x[..., :6]),
                                   rtol=0, atol=0)


def test_band_sum_is_differentiable_and_counted():
    x = torch.randn(2, 7, 3, requires_grad=True)
    bands = cpu_bands(x, 3, axis=1)
    COUNTS.reset()
    totals = band_sum(bands, (1,))
    assert COUNTS.band_sums == 1 and len(totals) == 3
    torch.testing.assert_close(totals[0], x.sum(1), rtol=0, atol=1e-6)
    (totals[1] * torch.arange(3.0)).sum().backward()
    torch.testing.assert_close(x.grad, torch.arange(3.0).expand(2, 7, 3))


# ----------------------------------------------------------------- models ---

def tiny_model(**kwargs):
    """The tiny arch, seeded, every BN's scale, bias and statistics
    randomized (an identity BN would hide a wrong statistic), in eval
    mode."""
    model = build_model("multidim_stacker", **{**TINY_KWARGS, **kwargs})
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, effnetv2.BatchNormAct)):
            c = bn.bias.shape[0]
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.2, c)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    return model.eval()


@pytest.mark.parametrize("s2d,n", [(False, 2), (False, 5), (True, 2), (True, 3)])
def test_banded_encoder_matches_unbanded(s2d, n):
    """``forward_2d_nhwc`` on 64-row bands (5 bands: 2 rows at 1/32, so
    three bands end up empty) equals the unbanded forward."""
    model = tiny_model(stem_space_to_depth=s2d)
    x = torch.rand(3, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model.forward_2d_nhwc(x)
        out = model.forward_2d_nhwc(cpu_bands(x, n, axis=1))
    assert out.axis == 1 and out.cuts == balanced_cuts(2, n)
    torch.testing.assert_close(out.gather(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("use_kernel,n", [(True, 2), (False, 3)])
def test_banded_3d_head_matches_unbanded(use_kernel, n):
    """``forward_3d_head`` (the depthwise op's plain version, or the
    grouped conv, on halo windows; the SE means and GeM over the bands) and
    ``forward_3d`` on 7-row feature bands equal the unbanded ones."""
    model = tiny_model(dw3d_use_kernel=use_kernel)
    x = torch.rand(4, 2, 7, 3, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = model.forward_3d_head(x)
        out = model.forward_3d_head(cpu_bands(x, n, axis=2))
        fused = model.forward_3d(cpu_bands(x, n, axis=2))
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(fused.gather(), model.forward_3d(x), rtol=0, atol=ATOL)


def test_gem_pool_partial_and_its_backward():
    """The band-partial sums and their registered backward against autograd
    of the plain formula; the bands' sums combined (``gem_pool_bands``,
    an empty band included) against ``gem_pool_reference``, forward and
    backward."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 5, 4, 8, generator=g) - 0.1  # some below eps
    p = torch.full((1,), 2.5)
    w = torch.randn(2, 8, generator=g)

    xk, pk = x.clone().requires_grad_(True), p.clone().requires_grad_(True)
    (gem_pool_partial(xk, pk) * w).sum().backward()
    xr, pr = x.clone().requires_grad_(True), p.clone().requires_grad_(True)
    plain = torch.exp(pr * torch.log(xr.clamp_min(1e-6))).sum(dim=(1, 2))
    (plain * w).sum().backward()
    torch.testing.assert_close(gem_pool_partial_reference(x, p), plain.detach(), rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(xk.grad, xr.grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(pk.grad, pr.grad, rtol=1e-5, atol=0)

    xb, pb = x.clone().requires_grad_(True), p.clone().requires_grad_(True)
    (gem_pool_bands(cpu_bands(xb, 6, axis=1), pb) * w).sum().backward()
    xg, pg = x.clone().requires_grad_(True), p.clone().requires_grad_(True)
    (gem_pool_reference(xg, pg) * w).sum().backward()
    torch.testing.assert_close(gem_pool_bands(cpu_bands(x, 6, axis=1), p),
                               gem_pool_reference(x, p), rtol=1e-5, atol=0)
    torch.testing.assert_close(xb.grad, xg.grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(pb.grad, pg.grad, rtol=1e-5, atol=0)


# --------------------------------------------------------- chunked engine ---

@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return make_ckpt(tmp_path_factory.mktemp("sp") / "model-001-0.500000.ckpt")


@pytest.fixture(scope="module")
def jax_spatial_predictions(ckpt_path):
    """JAX's spatial engine on a (data=2, model=4) mesh of its 8 CPU
    devices, compiled once for every comparison."""
    engine = JaxChunkedVideoPredictor(ckpt_path, dtype=jnp.float32, chunk_size=16,
                                      mesh=jax_make_mesh(2, 4), spatial=True)
    return engine.predict_video(jax_iter_source_frames(JaxSyntheticSource(**SRC_KWARGS)),
                                FRAME_COUNT)


@pytest.mark.parametrize("grid", [(2, 4), (1, 2), (1, 5)])
def test_chunked_spatial_matches_jax(ckpt_path, jax_spatial_predictions, grid):
    """The port's spatial engine over the CPU repeated on a (2, 4) grid (as
    JAX's test), a (1, 2) and a (1, 5) grid (2 rows at 1/32: three empty
    bands) against JAX's spatial engine on (2, 4)."""
    j_idx, j_raw = jax_spatial_predictions
    n_data, n_model = grid
    engine = ChunkedVideoPredictor(ckpt_path, dtype=torch.float32, chunk_size=16,
                                   mesh=make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model)),
                                   spatial=True)
    assert not engine.carry_features
    idx, raw = engine.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)),
                                    FRAME_COUNT)
    assert list(idx) == list(j_idx) and raw.shape == (28, 2)
    np.testing.assert_allclose(raw, np.asarray(j_raw), atol=ATOL)


@pytest.mark.parametrize("tta,chunk", [(True, 7), (False, 10)])
def test_chunked_spatial_matches_one_device(ckpt_path, tta, chunk):
    """TTA and a chunk of 7 (a ragged last chunk, shares of 4 and 3 on the
    data axis) on a (2, 2) grid against the unsplit frame-carry engine."""
    kw = dict(tta=tta, chunk_size=chunk, dtype=torch.float32)
    one = ChunkedVideoPredictor(ckpt_path, device="cpu", carry_features=False, **kw)
    sp = ChunkedVideoPredictor(ckpt_path, mesh=make_mesh(2, 2, ["cpu"] * 4), spatial=True, **kw)
    i1, r1 = one.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    i2, r2 = sp.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)), FRAME_COUNT)
    assert i1 == i2
    np.testing.assert_allclose(r2, r1, atol=ATOL)


def test_spatial_without_mesh_raises(ckpt_path):
    with pytest.raises(ValueError, match="spatial=True requires mesh"):
        ChunkedVideoPredictor(ckpt_path, dtype=torch.float32, device="cpu", spatial=True)


def test_carry_features_rejects_spatial(ckpt_path):
    with pytest.raises(ValueError, match="carry_features"):
        ChunkedVideoPredictor(ckpt_path, dtype=torch.float32, chunk_size=10,
                              mesh=make_mesh(1, 2, ["cpu"] * 2), spatial=True,
                              carry_features=True)


def test_carry_features_defaults_to_not_spatial(ckpt_path):
    kw = dict(dtype=torch.float32, chunk_size=10)
    assert ChunkedVideoPredictor(ckpt_path, device="cpu", **kw).carry_features
    grid = make_mesh(1, 2, ["cpu"] * 2)
    assert not ChunkedVideoPredictor(ckpt_path, mesh=grid, spatial=True, **kw).carry_features
    assert not ChunkedVideoPredictor(ckpt_path, device="cpu", carry_features=False,
                                     **kw).carry_features


# ------------------------------------------------------------- train step ---

DROP_KWARGS = dict(TINY_KWARGS, drop_path_rate=0.2)


def masks(count: int, batch: int) -> list:
    rng = np.random.default_rng(7)
    return [rng.random(batch) < 0.8 for _ in range(count)]


@pytest.fixture
def given_masks(monkeypatch):
    """Both packages' drop-path masks, in call order, from one numpy list:
    their generators draw different bits from the same seed."""
    draws = masks(16, 4)
    port_calls, jax_calls = iter(draws), iter(draws)

    def port_mask(generator, shape, keep, device, shard=None):
        return torch.from_numpy(next(port_calls)).reshape(shape).to(device)

    def jax_drop_path(x, rate, deterministic, rng):
        if deterministic or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = jnp.asarray(next(jax_calls)).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return jnp.where(mask, x / keep, jnp.zeros_like(x))

    monkeypatch.setattr(effnetv2, "random_keep_mask", port_mask)
    monkeypatch.setattr(jax_effnetv2, "drop_path", jax_drop_path)


def capture_gradients() -> optax.GradientTransformation:
    """An optimizer that keeps the step's gradients in its state and leaves
    the parameters where they are."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (jax.tree.map(jnp.zeros_like, updates),
                                             {"grads": updates}))


def close_per_tensor(port: dict, ref: dict) -> None:
    for name, value in ref.items():
        err = np.abs(port[name] - value).max()
        assert err <= 1e-4 * np.abs(value).max() + 1e-7, (name, err)


def flat(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def test_banded_train_step_matches_jax_spatial_step(given_masks):
    """One step on a (1, 2) CPU grid against JAX's ``make_train_step`` on
    frames sharded by ``spatial_frames_sharding(make_mesh(1, 2), 4, 2)``:
    float32, drop path on, the loss, predictions and every gradient."""
    model = tiny_model(**DROP_KWARGS)  # weights written by the port: no JAX init to run
    tree = state_dict_to_flax_tree(model.state_dict(), model)
    jmodel = jax_build_model("multidim_stacker", **DROP_KWARGS)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 6, 64, 96), dtype=np.uint8)
    targets = (rng.random((4, 2)) > 0.5).astype(np.float32)

    mesh = jax_make_mesh(1, 2)
    loss_fn = JaxFocalLoss(alpha=-1.0, gamma=1.2)
    # copies: the numpy leaves share the port's parameters, which its step
    # updates in place while JAX's asynchronous step may still read them
    variables = jax.tree.map(lambda a: jnp.array(np.array(a)), tree)
    jstate = jax.device_put(JaxTrainState.create(variables, capture_gradients()),
                            replicated(mesh))
    jstate, jaux = jax.block_until_ready(
        jax.jit(jax_make_train_step(jmodel, loss_fn, capture_gradients(), 0.9))(
            jstate, jax.device_put(frames, spatial_frames_sharding(mesh, 4, 2)),
            jax.device_put(targets, batch_sharding(mesh)), jax.random.PRNGKey(0)))

    model.train()
    state = TrainState(model, build_optimizer("AdamW", {}, model))
    aux = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda c: 1e-3, 0.9)(
        state, cpu_bands(torch.from_numpy(frames), 2, axis=2),
        torch.from_numpy(targets), 0)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(aux["prediction"].numpy(), np.asarray(jaux["prediction"]),
                               atol=ATOL)
    grads = state_dict_to_flax_tree({n: p.grad for n, p in model.named_parameters()}, model)
    close_per_tensor(dict(flat(grads["params"])), dict(flat(jstate.opt_state["grads"])))


@pytest.mark.parametrize("s2d,n", [(False, 3), (True, 2)])
def test_banded_train_step_matches_unbanded(s2d, n):
    """The banded step (drop path and dropout from the step's generator)
    against the unbanded step from the same weights: loss, predictions,
    gradients and the BN running statistics after it."""
    model = build_model("multidim_stacker", **{**TINY_KWARGS, "drop_rate": 0.2,
                                               "drop_path_rate": 0.2, "stem_space_to_depth": s2d})
    init_weights(model, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (4, 6, 64, 96), dtype=np.uint8))
    targets = torch.from_numpy((rng.random((4, 2)) > 0.5).astype(np.float32))
    step = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda c: 1e-3, 0.9)
    runs = []
    for x in (frames, cpu_bands(frames, n, axis=2)):
        m = copy.deepcopy(model)
        state = TrainState(m, build_optimizer("AdamW", {}, m))
        aux = step(state, x, targets, 3)
        runs.append((aux, {k: p.grad.numpy() for k, p in m.named_parameters()},
                     {k: b.numpy() for k, b in m.named_buffers()}))
    (ref_aux, ref_grads, ref_bufs), (aux, grads, bufs) = runs
    np.testing.assert_allclose(float(aux["loss"]), float(ref_aux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(aux["prediction"].numpy(), ref_aux["prediction"].numpy(),
                               atol=ATOL)
    close_per_tensor(grads, ref_grads)
    for k, v in ref_bufs.items():
        np.testing.assert_allclose(bufs[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_banded_train_step_refuses_augmentation():
    from ball_action_spotting_torch.ops.augment import AugmentConfig

    model = tiny_model().train()
    state = TrainState(model, build_optimizer("AdamW", {}, model))
    step = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda c: 1e-3, 0.9,
                           augment=AugmentConfig())
    frames = cpu_bands(torch.zeros(2, 6, 64, 96, dtype=torch.uint8), 2, axis=2)
    with pytest.raises(ValueError, match="no augmentation"):
        step(state, frames, torch.zeros(2, 2), 0)
