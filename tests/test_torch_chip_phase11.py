"""A rehearsal of ``chip_smoke.py``'s phase 11 (``spatial``) on the CPU:
the flagship recipe's config cut by ``tests/test_torch_chain.py::shrink``
(tiny arch, 64×96, 15 frames) in float32, chunks of 8, the grids repeating
the CPU device, the kernel rows at a chunk of 2 with their timers and the
chunk profile (device time only) stubbed, and each op's plain version
counted as its kernel's launch on the device of its input (GeM's
band-partial sums under ``launches_by["partial"]``, as the kernel counts
them). Every check of the phase holds: the kernels against their plain
versions, the spatial engine on the (1, 2) and (1, 4) grids against the
unsplit engine, the float32 run, the banded train step against the
unbanded one with its launches counted as the spatial training path,
and the launches on every band device; the kernels line's phase-11 rows
build from its launches."""

import numpy as np
import torch

from ball_action_spotting_torch.models import build_model, init_weights
from ball_action_spotting_torch.ops import dwconv3d as dw_ops
from ball_action_spotting_torch.ops import gem as gem_ops
from ball_action_spotting_torch.predict import streaming
from ball_action_spotting_torch.utils.recipe import spotting_recipe
from tests.test_torch_chain import shrink
from tests.test_torch_chip_phase10 import count_plain_calls_on


def count_partial_calls_on(monkeypatch):
    original, kernel = gem_ops.gem_pool_partial_op, gem_ops.KERNEL

    def call(*args):
        kernel.launches += 1
        kernel.launches_by[gem_ops.PARTIAL] = kernel.launches_by.get(gem_ops.PARTIAL, 0) + 1
        device = str(args[0].device)
        kernel.launches_on[device] = kernel.launches_on.get(device, 0) + 1
        return original(*args)

    monkeypatch.setattr(gem_ops, "gem_pool_partial_op", call)


def test_chip_smoke_phase11_rehearsal_on_the_cpu(monkeypatch):
    import chip_smoke

    count_plain_calls_on(monkeypatch)
    count_partial_calls_on(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, *a, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "profiled_ms", lambda fn, *a, **kw: (0.0, [10]))
    monkeypatch.setattr(chip_smoke, "sp_profile", lambda *a: {})  # device time only
    init = streaming.PredictorBase.__init__

    def kernel_by_default(self, *args, dw3d_use_kernel=None, dtype=torch.float32, **kwargs):
        # the card's default route, which the launch checks expect
        init(self, *args, dw3d_use_kernel=True if dw3d_use_kernel is None else dw3d_use_kernel,
             dtype=dtype, **kwargs)

    monkeypatch.setattr(streaming.PredictorBase, "__init__", kernel_by_default)
    for name, value in dict(WIDTH=96, HEIGHT=64, CHUNK=2, MP_DTYPE=torch.float32,
                            MP_TIMED_STEPS=1).items():
        monkeypatch.setattr(chip_smoke, name, value)
    config = shrink(spotting_recipe(num_classes=2, image_size=(96, 64), pretrained=False,
                                    num_decode_workers=2))
    monkeypatch.setattr(chip_smoke, "flagship_config", lambda epoch_size=16: config)
    nn_name, nn_kwargs = config["argus_params"]["nn_module"]
    model = build_model(nn_name, **nn_kwargs)
    init_weights(model, torch.Generator().manual_seed(0))
    params = {"nn_module": (nn_name, nn_kwargs), "frame_stack_size": 15,
              "frame_stack_step": 2, "frames_processor": ("pad_normalize", {"size": (96, 64)})}
    video = np.random.default_rng(0).integers(0, 255, (3 * 8 + 30, 64, 96), dtype=np.uint8)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny arch gains nothing from intra-op threads
    try:
        rows = chip_smoke.sp_kernel_checks(torch.device("cpu"))
        monkeypatch.setattr(chip_smoke, "CHUNK", 8)
        monkeypatch.setattr(chip_smoke, "sp_kernel_checks", lambda dev: rows)
        launches, got = chip_smoke.spatial(torch.device("cpu"), "cpu",
                                           (model.state_dict(), params), video)
    finally:
        torch.set_num_threads(threads)
    assert got is rows and sorted(rows) == sorted(chip_smoke.spatial_sources(launches))
    assert sorted(k for k in launches if k.startswith("sp_")) == [
        "sp_1x2_tta_off", "sp_1x2_tta_on", "sp_1x4_tta_off", "sp_1x4_tta_on", "sp_predict",
        "sp_train"]
    main = launches["sp_predict"]
    assert main == launches["sp_1x2_tta_on"]
    # one partial GeM per band and chunk program, a depthwise conv per band,
    # 3D block and chunk program, no whole-map GeM
    chunks = -(-(len(video) - 30) // 8)
    assert main["gem_partial"] == main["gem"] == 2 * chunks
    assert main["dwconv3d"] == 2 * nn_kwargs["num_3d_blocks"] * chunks
    # the banded train step: one partial GeM per band, no depthwise kernel
    # (training's depthwise conv is the grouped conv)
    assert launches["sp_train"]["gem_partial"] == 2
    assert launches["sp_train"]["dwconv3d"] == 0
    kernels = chip_smoke.kernels_line(chip_smoke.spatial_sources(launches), rows)
    assert [k["name"] for k in kernels] == list(rows)
    assert all(k["launches"] > 0 for k in kernels)
    assert all(("sp_train" in k["launches_by_path"]) == k["name"].startswith("gem")
               for k in kernels)


def test_kernel_device_ms_falls_back_to_events_when_the_profiler_loses_launches(monkeypatch):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "profiled_ms", lambda fn, *a, **kw: (None, [0, 0, 0]))
    taken = []

    def events(fn, kernel, per_call=1):
        taken.append((kernel, per_call))
        return 1.5

    monkeypatch.setattr(chip_smoke, "device_ms_events", events)
    row = chip_smoke.kernel_device_ms(lambda: None, "dwconv3d_kernel", dw_ops.KERNEL, per_call=2)
    assert row == {"device_ms": 1.5, "device_ms_method": "cuda_events_behind_sleep",
                   "profiler_launches_seen": [0, 0, 0]}
    assert taken == [(dw_ops.KERNEL, 2)]
    monkeypatch.setattr(chip_smoke, "profiled_ms", lambda fn, *a, **kw: (0.25, [20]))
    assert chip_smoke.kernel_device_ms(lambda: None, "dwconv3d_kernel", dw_ops.KERNEL) == {
        "device_ms": 0.25, "device_ms_method": "per_call_sum"}
