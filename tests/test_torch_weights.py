"""The port's weight sources against the JAX package on the CPU (tiny arch,
float32): reference PyTorch state dicts converted by
``models/torch_import.py`` (bitwise the JAX converter's trees: plain, with
``_orig_mod.`` and with the space-to-depth stem); ImageNet weight files
found and read by ``models/pretrained.py`` in every container (the
``.safetensors`` reader is the port's own); ``pretrained=True`` in the
port's ``Trainer`` (the encoder's weights and BN statistics bitwise JAX's
``init_state``, with and without the s2d stem; a missing file or a shape
mismatch raises; a stage pretrain supersedes it) and one train step from
that init; a reference argus ``.pth`` through checkpoint discovery,
``resolve_pretrain_variables`` and the chunked and streaming engines
against JAX's ``StreamingPredictor``; a CPU rehearsal of ``chip_smoke.py``
phase 8.

Tolerances: converted trees and initial states bitwise; predictions atol
1e-5 (float32, as ``tests/test_torch_predict.py``); the train step as
``tests/test_torch_train.py`` (loss rtol 1e-5, parameters atol 2e-5)."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ball_action_spotting_tpu.data.video import SyntheticSource as JaxSyntheticSource
from ball_action_spotting_tpu.models import build_model as jax_build_model
from ball_action_spotting_tpu.models.pretrained import load_state_dict as jax_load_state_dict
from ball_action_spotting_tpu.models.torch_import import (
    convert_multidim_stacker as jax_convert_multidim_stacker,
)
from ball_action_spotting_tpu.models.torch_import import (
    convert_timm_effnetv2 as jax_convert_timm_effnetv2,
)
from ball_action_spotting_tpu.ops.focal_loss import FocalLoss as JaxFocalLoss
from ball_action_spotting_tpu.predict.streaming import (
    StreamingPredictor as JaxStreamingPredictor,
    get_raw_predictions as jax_get_raw_predictions,
)
from ball_action_spotting_tpu.train.engine import Trainer as JaxTrainer
from ball_action_spotting_tpu.train.optim import build_optimizer as jax_build_optimizer
from ball_action_spotting_tpu.train.state import TrainState as JaxTrainState
from ball_action_spotting_tpu.train.steps import make_train_step as jax_make_train_step
from ball_action_spotting_torch.convert import (
    flax_tree_to_state_dict,
    jax_variables_to_state_dict,
    state_dict_to_flax_tree,
)
from ball_action_spotting_torch.data.video import SyntheticSource
from ball_action_spotting_torch.models.pretrained import (
    PretrainedWeightsError,
    apply_pretrained_encoder,
    find_pretrained_file,
    load_state_dict,
    read_safetensors,
)
from ball_action_spotting_torch.models.torch_import import (
    convert_multidim_stacker,
    convert_timm_effnetv2,
    load_reference_checkpoint,
)
from ball_action_spotting_torch.ops.losses import FocalLoss
from ball_action_spotting_torch.predict.streaming import (
    ChunkedVideoPredictor,
    StreamingPredictor,
    get_raw_predictions,
    iter_source_frames,
)
from ball_action_spotting_torch.train.checkpoint import (
    get_best_checkpoint_path,
    resolve_pretrain_variables,
    save_checkpoint,
)
from ball_action_spotting_torch.train.engine import Trainer
from ball_action_spotting_torch.train.optim import build_optimizer
from ball_action_spotting_torch.train.state import TrainState
from ball_action_spotting_torch.train.steps import make_train_step
from tests.test_predictor import NN_KWARGS, PARAMS
from tests.test_torch_import import tiny_torch_state_dict_shapes
from tests.test_torch_models import register_port_tiny_arch
from tests.test_torch_train import ADAM_EPS, EMA, LR, assert_trees_close, leaves
from tests.test_train_engine import CLASSES, tiny_config

register_port_tiny_arch()
ATOL = 1e-5
FRAME_COUNT = 40
SRC_KWARGS = dict(num_frames=FRAME_COUNT, height=64, width=96, seed=1, events={20: 0, 30: 1})
ENCODER = "conv2d_encoder."


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny arch gains nothing from intra-op threads, and beside the
    suite's other workers they oversubscribe the cores (as
    ``tests/test_torch_streaming.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_state_dict(seed: int = 0, scale: float = 1.0) -> dict:
    """A seeded reference-layout ``MultiDimStacker`` state dict of the tiny
    arch (numpy, positive variances)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in tiny_torch_state_dict_shapes().items():
        arr = rng.normal(scale=scale, size=shape).astype(np.float32)
        sd[key] = np.abs(arr) + 0.5 if key.endswith("running_var") else arr
    return sd


def timm_state_dict(seed: int = 7) -> dict:
    """A timm-layout encoder state dict of the tiny arch with what a real
    timm file holds past the feature tap (``conv_head``, ``bn2``,
    ``classifier``) and ``num_batches_tracked``, as
    ``tests/test_pretrained.py::fake_timm_state_dict``."""
    sd = {k[len(ENCODER):]: v for k, v in reference_state_dict(seed).items()
          if k.startswith(ENCODER)}
    rng = np.random.default_rng(seed + 1)
    sd["conv_head.weight"] = rng.normal(size=(64, 24, 1, 1)).astype(np.float32)
    sd["classifier.weight"] = rng.normal(size=(1000, 64)).astype(np.float32)
    sd["bn1.num_batches_tracked"] = np.asarray(17, np.int64)
    return sd


def assert_trees_equal(port, ref):
    """Same keys, shapes, dtypes and values (bitwise)."""
    port, ref = dict(leaves(port)), dict(leaves(jax.tree.map(np.asarray, ref)))
    assert sorted(port) == sorted(ref)
    for name, value in ref.items():
        assert port[name].dtype == value.dtype, name
        np.testing.assert_array_equal(port[name], value, err_msg=name)


@pytest.mark.parametrize("case", ["plain", "orig_mod", "s2d"])
def test_convert_multidim_stacker_is_bitwise_jax(case):
    sd = reference_state_dict()
    if case == "orig_mod":
        sd = {"_orig_mod." + k: v for k, v in sd.items()}
    s2d = case == "s2d"
    port = convert_multidim_stacker(sd, "efficientnetv2_test", 2, stem_space_to_depth=s2d)
    ref = jax_convert_multidim_stacker(sd, "efficientnetv2_test", num_3d_blocks=2,
                                       stem_space_to_depth=s2d)
    assert_trees_equal(port, ref)
    stem = port["params"]["conv2d_encoder"]["conv_stem"]["kernel"]
    assert stem.shape == ((2, 2, 12, 8) if s2d else (3, 3, 3, 8))


@pytest.mark.parametrize("s2d", [False, True])
def test_convert_timm_effnetv2_is_bitwise_jax_and_torch_tensors_convert_alike(s2d):
    def tree(pair):
        return dict(zip(("params", "batch_stats"), pair))

    sd = timm_state_dict()
    port = tree(convert_timm_effnetv2(sd, "tf_efficientnetv2_test.in1k",
                                      stem_space_to_depth=s2d))
    assert_trees_equal(port, tree(jax_convert_timm_effnetv2(
        sd, "tf_efficientnetv2_test.in1k", stem_space_to_depth=s2d)))
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert_trees_equal(tree(convert_timm_effnetv2(tensors, "efficientnetv2_test",
                                                  stem_space_to_depth=s2d)), port)


def test_s2d_tree_converts_both_ways():
    """A space-to-depth stem's (2, 2, 4C, O) kernel crosses ``convert.py``
    into the ``stem_space_to_depth`` model and back unchanged."""
    from ball_action_spotting_torch.models import build_model

    tree = convert_multidim_stacker(reference_state_dict(), "efficientnetv2_test", 2,
                                    stem_space_to_depth=True)
    kwargs = dict(NN_KWARGS, num_3d_blocks=2, stem_space_to_depth=True)
    state = jax_variables_to_state_dict(tree, kwargs)
    assert tuple(state["conv2d_encoder.conv_stem.weight"].shape) == (8, 12, 2, 2)
    model = build_model("multidim_stacker", **kwargs)
    assert_trees_equal(state_dict_to_flax_tree(state, model), tree)


def write_safetensors_numpy(path, sd):
    pytest.importorskip("safetensors")
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(path))


@pytest.mark.parametrize("container", ["npz", "pth", "bin", "pth_wrapped", "safetensors"])
def test_pretrained_file_found_and_read_like_jax(tmp_path, monkeypatch, container):
    sd = timm_state_dict()
    suffix = container.split("_")[0]
    # the bare arch name for the pickles, the full timm name for the rest
    name = "efficientnetv2_test" if suffix in ("pth", "bin") else "tf_efficientnetv2_test.in1k"
    path = tmp_path / f"{name}.{suffix}"
    if suffix == "npz":
        np.savez(path, **sd)
    elif suffix == "safetensors":
        write_safetensors_numpy(path, sd)
    else:
        tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
        torch.save({"state_dict": tensors} if container == "pth_wrapped" else tensors, path)
    monkeypatch.setenv("BAS_TPU_PRETRAINED_DIR", str(tmp_path))
    assert find_pretrained_file("tf_efficientnetv2_test.in1k") == path
    loaded = load_state_dict(path)
    assert sorted(loaded) == sorted(sd)
    reference = jax_load_state_dict(path)
    for key, value in sd.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)
        np.testing.assert_array_equal(loaded[key], reference[key], err_msg=key)


def test_safetensors_reader_takes_bf16_and_refuses_malformed_files(tmp_path):
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    values = {"a": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
              "b": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    values["a_bf16"] = values["a"].to(torch.bfloat16)
    path = tmp_path / "w.safetensors"
    save_file(values, str(path))
    read = read_safetensors(path)
    np.testing.assert_array_equal(read["a"], values["a"].numpy())
    np.testing.assert_array_equal(read["b"], values["b"].numpy())
    assert read["a_bf16"].dtype == np.float32
    np.testing.assert_array_equal(read["a_bf16"], values["a_bf16"].float().numpy())

    data = path.read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header["a"]["data_offsets"][1] += 4
    bad_offsets = json.dumps(header).encode()
    cases = {
        "short": data[:5],
        "length": struct.pack("<Q", len(data)) + data[8:],
        "json": struct.pack("<Q", n) + b"{" * n + data[8 + n:],
        "offsets": struct.pack("<Q", len(bad_offsets)) + bad_offsets + data[8 + n:],
    }
    for name, blob in cases.items():
        (tmp_path / f"{name}.safetensors").write_bytes(blob)
        with pytest.raises(ValueError, match="safetensors"):
            read_safetensors(tmp_path / f"{name}.safetensors")


def pretrained_config(s2d: bool = False, drop_rate: float = 0.1) -> dict:
    config = tiny_config()
    kwargs = config["argus_params"]["nn_module"][1]
    kwargs.update(pretrained=True, drop_rate=drop_rate)
    if s2d:
        kwargs["stem_space_to_depth"] = True
    return config


def port_trainer(config, save_dir) -> Trainer:
    return Trainer(config, CLASSES, save_dir, compute_dtype=torch.float32, device="cpu")


@pytest.fixture()
def weights_dir(tmp_path, monkeypatch):
    np.savez(tmp_path / "efficientnetv2_test.npz", **timm_state_dict())
    monkeypatch.setenv("BAS_TPU_PRETRAINED_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("s2d", [False, True])
def test_trainer_pretrained_init_is_bitwise_jax(weights_dir, tmp_path, s2d):
    """The encoder's weights and BN statistics equal JAX's ``init_state``
    tree converted by ``convert.py``, bitwise; the rest of the state is the
    seed's (the two packages draw from other generators) and has the same
    names and shapes."""
    config = pretrained_config(s2d)
    jstate = JaxTrainer(config, CLASSES, tmp_path / "jax").init_state()
    jstate_dict = flax_tree_to_state_dict(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    port = port_trainer(config, tmp_path / "port").init_state().model.state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in jstate_dict.items()}
    encoder = [k for k in port if k.startswith(ENCODER)]
    assert len(encoder) == sum(k.startswith(ENCODER) for k in tiny_torch_state_dict_shapes())
    for key in encoder:
        assert torch.equal(port[key], jstate_dict[key]), key
    sd = timm_state_dict()
    assert torch.equal(port["conv2d_encoder.bn1.running_var"],
                       torch.from_numpy(sd["bn1.running_var"]))
    stem = port["conv2d_encoder.conv_stem.weight"]
    if not s2d:
        assert torch.equal(stem, torch.from_numpy(sd["conv_stem.weight"]))
    else:
        assert tuple(stem.shape) == (8, 12, 2, 2)


def test_trainer_pretrained_missing_file_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("BAS_TPU_PRETRAINED_DIR", str(tmp_path / "empty"))
    with pytest.raises(PretrainedWeightsError, match="pretrained=True") as err:
        port_trainer(pretrained_config(), tmp_path / "exp").init_state()
    assert "efficientnetv2_test.npz" in str(err.value)


def test_pretrained_shape_mismatch_raises_and_extras_are_ignored(weights_dir, tmp_path):
    model = port_trainer(tiny_config(), tmp_path / "exp").init_state().model
    bad = timm_state_dict()
    bad["conv_stem.weight"] = bad["conv_stem.weight"][:, :1]  # wrong in_chans
    np.savez(weights_dir / "bad.npz", **bad)
    with pytest.raises(PretrainedWeightsError, match="shape"):
        apply_pretrained_encoder(model.state_dict(), "efficientnetv2_test",
                                 weights_path=weights_dir / "bad.npz")
    truncated = {k: v for k, v in timm_state_dict().items() if not k.startswith("blocks.4.")}
    np.savez(weights_dir / "missing.npz", **truncated)
    with pytest.raises(PretrainedWeightsError,
                       match="missing parameter 'conv2d_encoder.blocks_4_0"):
        apply_pretrained_encoder(model.state_dict(), "efficientnetv2_test",
                                 weights_path=weights_dir / "missing.npz")
    with pytest.raises(PretrainedWeightsError, match="no 'encoder' subtree"):
        apply_pretrained_encoder(model.state_dict(), "efficientnetv2_test",
                                 encoder_name="encoder", weights_path=weights_dir / "bad.npz")
    merged = apply_pretrained_encoder(model.state_dict(), "efficientnetv2_test")
    assert sorted(merged) == sorted(model.state_dict())  # conv_head, classifier ignored
    assert torch.equal(merged["classifier.weight"], model.state_dict()["classifier.weight"])


def test_stage_pretrain_supersedes_imagenet(tmp_path, monkeypatch):
    """With a stage pretrain given, the absent ImageNet file is not read."""
    monkeypatch.setenv("BAS_TPU_PRETRAINED_DIR", str(tmp_path / "empty"))
    source = port_trainer(tiny_config(), tmp_path / "a").init_state().model
    tree = state_dict_to_flax_tree(source.state_dict(), source)
    state = port_trainer(pretrained_config(), tmp_path / "b").init_state(tree)
    for key, value in source.state_dict().items():
        assert torch.equal(state.model.state_dict()[key], value), key


def test_train_step_from_pretrained_init_matches_jax(weights_dir, tmp_path):
    """One AdamW step (float32, drop rates 0) from the port's pretrained
    initial state on both packages."""
    model = port_trainer(pretrained_config(drop_rate=0.0), tmp_path / "exp").init_state().model
    tree = state_dict_to_flax_tree(model.state_dict(), model)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 6, 64, 96), dtype=np.uint8)
    targets = (rng.random((4, 2)) > 0.5).astype(np.float32)

    name, kwargs = pretrained_config(drop_rate=0.0)["argus_params"]["nn_module"]
    jmodel = jax_build_model(name, **kwargs)  # float32, as the port's trainer here
    tx = jax_build_optimizer("AdamW", {"eps": ADAM_EPS}, schedule=LR)
    # copies: the tree's arrays share memory with the port's parameters,
    # which the port's step below updates in place while JAX may still run
    jstate = JaxTrainState.create(jax.tree.map(jnp.array, tree), tx)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxFocalLoss(alpha=-1.0, gamma=1.2), tx,
                                        ema_decay=EMA))
    jstate, jaux = jstep(jstate, jnp.asarray(frames), jnp.asarray(targets),
                         jax.random.PRNGKey(0))

    pstate = TrainState(model, build_optimizer("AdamW", {"eps": ADAM_EPS}, model))
    pstep = make_train_step(FocalLoss(alpha=-1.0, gamma=1.2), lambda count: LR, EMA)
    paux = pstep(pstate, torch.from_numpy(frames), torch.from_numpy(targets), 0)
    np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]), rtol=1e-5)
    raw = state_dict_to_flax_tree(pstate.model.state_dict(), pstate.model)
    assert_trees_close({"params": raw["params"]}, {"params": jstate.params}, rtol=0.0,
                       atol=2e-5)


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference argus checkpoint of the tiny stacker beside a lower-scored
    ``.ckpt``, as ``tests/test_reference_checkpoint.py`` writes it."""
    sd = {k: torch.from_numpy(v) for k, v in reference_state_dict(scale=0.1).items()}
    params = {
        "nn_module": ("multidim_stacker", dict(NN_KWARGS, num_3d_blocks=2)),
        "loss": ("focal_loss", {"alpha": -1.0, "gamma": 1.2, "reduction": "mean"}),
        "optimizer": ("AdamW", {"lr": 3e-4}),
        "frame_stack_size": 6,
        "frame_stack_step": 2,
        "frames_processor": ("pad_normalize", {"size": (96, 64)}),
        "device": ["cuda:0"],  # reference checkpoints carry these; ignored
        "amp": True,
        "iter_size": 1,
    }
    state = {"model_name": "BallActionModel", "params": params, "nn_state_dict": sd,
             "no_ema_nn_state_dict": {k: v * 1.01 for k, v in sd.items()}}
    directory = tmp_path_factory.mktemp("ref")
    path = directory / "model-012-0.812345.pth"
    torch.save(state, path)
    save_checkpoint(directory / "model-011-0.800000.ckpt", PARAMS, {"params": {}})
    return path


def test_pth_is_found_and_resolved(reference_pth):
    best = get_best_checkpoint_path(reference_pth.parent, return_score=True)
    assert best[0] == reference_pth and best[1] == pytest.approx(0.812345)
    variables, params = resolve_pretrain_variables(reference_pth)
    assert params["nn_module"][0] == "multidim_stacker" and params["device"] == ["cuda:0"]
    raw, _ = resolve_pretrain_variables(reference_pth, use_ema=False)
    ema_leaf = variables["params"]["classifier"]["bias"]
    np.testing.assert_allclose(raw["params"]["classifier"]["bias"], ema_leaf * 1.01, rtol=1e-6)
    sd = torch.load(reference_pth, weights_only=False)["nn_state_dict"]
    assert_trees_equal(variables, jax_convert_multidim_stacker(
        {k: v.numpy() for k, v in sd.items()}, "efficientnetv2_test", num_3d_blocks=2))
    assert_trees_equal(load_reference_checkpoint(reference_pth)[0], variables)


def test_pth_refuses_other_families(tmp_path):
    path = tmp_path / "model-001-0.5.pth"
    torch.save({"params": {"nn_module": ("timm", {"model_name": "x"})}}, path)
    with pytest.raises(ValueError, match="Unsupported reference nn_module: timm"):
        resolve_pretrain_variables(path)


@pytest.mark.parametrize("use_ema", [True, False])
def test_engines_from_pth_match_jax(reference_pth, use_ema):
    j_idx, j_raw = jax_get_raw_predictions(
        JaxStreamingPredictor(reference_pth, tta=True, use_ema=use_ema, dtype=jnp.float32),
        JaxSyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    kw = dict(tta=True, use_ema=use_ema, dtype=torch.float32, device="cpu")
    idx, raw = get_raw_predictions(StreamingPredictor(reference_pth, **kw),
                                   SyntheticSource(**SRC_KWARGS), FRAME_COUNT)
    chunked = ChunkedVideoPredictor(reference_pth, chunk_size=10, **kw)
    c_idx, c_raw = chunked.predict_video(iter_source_frames(SyntheticSource(**SRC_KWARGS)),
                                         FRAME_COUNT)
    assert idx == j_idx == list(c_idx) and len(idx) == 28
    np.testing.assert_allclose(raw, j_raw, atol=ATOL)
    np.testing.assert_allclose(c_raw, j_raw, atol=ATOL)


# --- chip_smoke.py phase 8, rehearsed on the CPU ---------------------------

def count_plain_calls(monkeypatch):
    """Count a launch per call of each op's plain version, as its kernel's
    wrapper counts on the card (the warp by pass)."""
    from ball_action_spotting_torch.ops import dwconv3d as dw_ops
    from ball_action_spotting_torch.ops import gem as gem_ops
    from ball_action_spotting_torch.ops import warp as warp_ops

    def counting(module, attr, tag=None):
        original = getattr(module, attr)

        def call(*args):
            module.KERNEL.launches += 1
            if tag is not None:
                key = tag(*args)
                module.KERNEL.launches_by[key] = module.KERNEL.launches_by.get(key, 0) + 1
            return original(*args)

        monkeypatch.setattr(module, attr, call)

    counting(gem_ops, "gem_pool_op")
    counting(dw_ops, "dwconv3d_op")
    counting(warp_ops, "warp_resample_op", tag=lambda *a: "H" if a[-1] == 2 else "V")


def test_chip_smoke_phase8_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.weights_and_family`` on the CPU with the stage configs
    cut by ``tests/test_torch_chain.py::shrink`` (``pretrained`` as
    shipped), the flagship geometry at their tiny arch and 64×96: every
    check of phase 8 but the kernel timings (whose rows need the card)
    holds, each op's plain version counted as its kernel's launch."""
    import chip_smoke
    from ball_action_spotting_torch.domains import action, ball
    from ball_action_spotting_torch.predict import streaming
    from ball_action_spotting_torch.utils.experiments import load_experiment_config
    from tests.test_torch_chain import shrink

    count_plain_calls(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(chip_smoke, "family_kernels", lambda dev: {})
    init = streaming.PredictorBase.__init__

    def kernel_by_default(self, *args, dw3d_use_kernel=None, **kwargs):
        # the card's default route, which the launch checks expect
        init(self, *args, dw3d_use_kernel=True if dw3d_use_kernel is None else dw3d_use_kernel,
             **kwargs)

    monkeypatch.setattr(streaming.PredictorBase, "__init__", kernel_by_default)

    configs = tmp_path / "configs"
    stages = dict(chip_smoke.PHASE8_STAGES, tuning="ball_tuning_001")
    for key, name in stages.items():
        domain = action.DOMAIN if key == "action" else ball.DOMAIN
        config = load_experiment_config(name, domain)
        shrunk = shrink(config)
        shrunk["argus_params"]["nn_module"][1]["pretrained"] = \
            config["argus_params"]["nn_module"][1]["pretrained"]
        (configs / domain.name).mkdir(parents=True, exist_ok=True)
        (configs / domain.name / f"{name}.py").write_text(f"config = {shrunk!r}\n")
    monkeypatch.setenv("BAS_TPU_CONFIGS_DIR", str(configs))
    nn_kwargs = {k: v for k, v in shrunk["argus_params"]["nn_module"][1].items()
                 if k != "pretrained"}
    params = {"nn_module": ("multidim_stacker", nn_kwargs), "frame_stack_size": 15,
              "frame_stack_step": 2, "frames_processor": ("pad_normalize", {"size": (96, 64)})}
    for name, value in dict(WIDTH=96, HEIGHT=64, VIDEO_HEIGHT=64, CHUNK=8,
                            NN_KWARGS=nn_kwargs, PARAMS=params, CHUNKS=3,
                            DW_PER_CHUNK=nn_kwargs["num_3d_blocks"]).items():
        monkeypatch.setattr(chip_smoke, name, value)

    cpu = torch.device("cpu")
    src = SyntheticSource(num_frames=3 * 8 + 30, height=64, width=96, seed=0)
    frames = np.stack([src.fetch_frame(i) for i in range(3 * 8 + 30)])
    weights = (chip_smoke.flagship_weights(cpu, frames), params)
    _, raw_main = ChunkedVideoPredictor(weights=weights, device=cpu, chunk_size=8,
                                        tta=True).predict_video(iter(enumerate(frames)),
                                                                len(frames))
    launches, rows = chip_smoke.weights_and_family(cpu, "cpu", weights, frames, raw_main,
                                                   tmp_path / "work")
    assert rows == {}
    assert launches["pth_predict"] == launches["s2d_predict"]
    assert launches["pth_predict"]["gem"] == 3 and launches["pth_predict"]["dwconv3d"] == 3
    for path in ("stage1_pretrained", "stage2_pretrained"):
        assert launches[path]["warp_H"] == launches[path]["warp_V"] == 4
    assert launches["multichan"]["dwconv3d"] == 1
    assert launches["classifier2d_train"]["gem"] == launches["classifier2d_folded"]["gem"] == 1
