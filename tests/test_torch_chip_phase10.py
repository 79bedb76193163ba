"""A rehearsal of ``chip_smoke.py``'s phase 10 (``model_parallel``) on the
CPU: the flagship recipe's config cut by ``tests/test_torch_chain.py::
shrink`` (tiny arch, 64×96, 15 frames) in float32, the (1, 2) and 2 × 1
grids repeating the CPU device, the dryrun over one CPU device, and each
op's plain version counted as its kernel's launch on the device of its
input. Every check of the phase holds: pp against ``iter_size``, the
pipelined ``Trainer.fit`` (its validation and checkpoint included), tp
against the replicated step, the serving mesh against a
``StreamingPredictor`` per stream, and the launches on the stage and
data-axis devices."""

import numpy as np
import torch

from ball_action_spotting_torch.models import build_model, init_weights
from ball_action_spotting_torch.ops import dwconv3d as dw_ops
from ball_action_spotting_torch.ops import gem as gem_ops
from ball_action_spotting_torch.ops import warp as warp_ops
from ball_action_spotting_torch.predict import streaming
from ball_action_spotting_torch.utils.recipe import spotting_recipe
from tests.test_torch_chain import shrink


def count_plain_calls_on(monkeypatch):
    """A launch per call of each op's plain version, under its pass (the
    warp's) and under its input's device, as the kernels' wrappers count."""

    def counting(module, attr, tag=None):
        original = getattr(module, attr)
        kernel = module.KERNEL

        def call(*args):
            kernel.launches += 1
            if tag is not None:
                kernel.launches_by[tag(*args)] = kernel.launches_by.get(tag(*args), 0) + 1
            device = str(args[0].device)
            kernel.launches_on[device] = kernel.launches_on.get(device, 0) + 1
            return original(*args)

        monkeypatch.setattr(module, attr, call)

    counting(gem_ops, "gem_pool_op")
    counting(dw_ops, "dwconv3d_op")
    counting(warp_ops, "warp_resample_op", tag=lambda *a: "H" if a[-1] == 2 else "V")


def test_chip_smoke_phase10_rehearsal_on_the_cpu(monkeypatch):
    import chip_smoke

    count_plain_calls_on(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    init = streaming.PredictorBase.__init__

    def kernel_by_default(self, *args, dw3d_use_kernel=None, dtype=torch.float32, **kwargs):
        # the card's default route, which the launch checks expect
        init(self, *args, dw3d_use_kernel=True if dw3d_use_kernel is None else dw3d_use_kernel,
             dtype=dtype, **kwargs)

    monkeypatch.setattr(streaming.PredictorBase, "__init__", kernel_by_default)
    for name, value in dict(WIDTH=96, HEIGHT=64, VIDEO_HEIGHT=48, MP_DTYPE=torch.float32,
                            MP_TIMED_STEPS=1, DRYRUN_DEVICE="cpu", TICK_BUCKETS=(1, 4),
                            TP_MIN_CHANNELS=32).items():
        monkeypatch.setattr(chip_smoke, name, value)
    config = shrink(spotting_recipe(num_classes=2, image_size=(96, 64), pretrained=False,
                                    num_decode_workers=2))
    monkeypatch.setattr(chip_smoke, "flagship_config", lambda epoch_size=16: config)
    nn_name, nn_kwargs = config["argus_params"]["nn_module"]
    model = build_model(nn_name, **nn_kwargs)
    init_weights(model, torch.Generator().manual_seed(0))
    params = {"nn_module": (nn_name, nn_kwargs), "frame_stack_size": 15,
              "frame_stack_step": 2, "frames_processor": ("pad_normalize", {"size": (96, 64)})}
    video = np.random.default_rng(0).integers(
        0, 255, (chip_smoke.SERVE_STREAMS * chip_smoke.SERVE_FRAMES, 64, 96), dtype=np.uint8)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny arch gains nothing from intra-op threads
    try:
        launches = chip_smoke.model_parallel(torch.device("cpu"), "cpu",
                                             (model.state_dict(), params), video)
    finally:
        torch.set_num_threads(threads)
    assert launches["pp_step"]["warp_H"] == launches["pp_step"]["warp_V"] == 2
    # a warmup and a train epoch of PP_TRAINER_STEPS steps, 2 microbatches each
    epochs = sum(config["num_epochs"])
    assert launches["pp_train"]["warp"] == 4 * chip_smoke.PP_TRAINER_STEPS * epochs
    assert launches["serve_mesh"]["gem"] > 0 and launches["serve_mesh"]["dwconv3d"] > 0
