"""A rehearsal of ``chip_smoke.py``'s phase 12 (``int8``) on the CPU: the
flagship recipe's model cut by ``tests/test_torch_chain.py::shrink`` (tiny
arch, 64×96, 15 frames) in float32, chunks of 8, the grids repeating the
CPU device, the kernel rows at small shapes with their timers and the chunk
profile (device time only) stubbed, and each op's plain version counted as
its kernel's launch on the device of its input (``count_plain_versions_on``).
Every check of the phase holds: the s8 route against its plain version, the
int8 main path's launches, the hooked layers, the drift and correlation
bounds, the 1×1 convs of a chunk recorded at the op for the GEMM line, the
other engines against their counterparts with their launches; the kernels
line's phase-12 rows build from its launches (the 3×3, GEMM and conv
kernels' rows, the last with the edge cases' path)."""

import numpy as np
import torch

from ball_action_spotting_torch.models import build_model, init_weights
from ball_action_spotting_torch.ops import dwconv3d as dw_ops
from ball_action_spotting_torch.ops import gem as gem_ops
from ball_action_spotting_torch.ops import int8_conv as int8_ops
from ball_action_spotting_torch.predict import streaming
from ball_action_spotting_torch.utils.recipe import spotting_recipe
from tests.test_torch_chain import shrink


def count_plain_versions_on(monkeypatch):
    """A launch per call of each op's plain version, under its input's
    device: the ops' CPU implementations call them, so that the exported
    program's calls count too. GeM's band-partial sums count under
    ``launches_by["partial"]``; the int8 op's count as a launch of the conv,
    the GEMM or the 3×3 kernel, by the route its shape takes on the card."""
    routes = {"gemm": int8_ops.GEMM_KERNEL, "conv3x3": int8_ops.CONV3X3_KERNEL}

    def counting(module, attr, kernel, tag=None):
        original = getattr(module, attr)

        def call(*args):
            t = tag(*args) if tag else "kernel"
            k = routes.get(t, kernel)
            k.launches += 1
            if t not in ("kernel", "conv", "gemm", "conv3x3"):
                k.launches_by[t] = k.launches_by.get(t, 0) + 1
            device = str(args[0].device)
            k.launches_on[device] = k.launches_on.get(device, 0) + 1
            return original(*args)

        monkeypatch.setattr(module, attr, call)

    counting(gem_ops, "gem_pool_reference", gem_ops.KERNEL)
    counting(gem_ops, "gem_pool_partial_reference", gem_ops.KERNEL, lambda *a: gem_ops.PARTIAL)
    counting(dw_ops, "dwconv3d_reference", dw_ops.KERNEL)
    counting(int8_ops, "int8_conv2d_reference", int8_ops.KERNEL, lambda x, s_x, w_q, s_w, s, *a: (
        "gemm" if int8_ops.gemm_takes(x, w_q, s, a[:4])
        else "conv3x3" if int8_ops.conv3x3_takes(x, w_q, s) else "conv"))
    # the kernels' own wrappers, which the kernel rows call directly
    for wrapper in ("int8_conv_cuda", "int8_conv3x3_cuda"):
        monkeypatch.setattr(int8_ops, wrapper, lambda x, s_x, w_q, s_w, s, pads, dtype:
                            int8_ops.int8_conv2d_reference(x, s_x, w_q, s_w, s, *pads, dtype))
    monkeypatch.setattr(int8_ops, "int8_gemm_cuda", lambda x, s_x, w_q, s_w, dtype:
                        int8_ops.int8_conv2d_reference(x, s_x, w_q, s_w, 1, 0, 0, 0, 0, dtype))


def test_chip_smoke_phase12_rehearsal_on_the_cpu(monkeypatch):
    import chip_smoke

    count_plain_versions_on(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    for timer in ("median_ms", "device_ms_events"):
        monkeypatch.setattr(chip_smoke, timer, lambda fn, *a, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "int8_profile", lambda *a: {  # the card's profile only
        "pass_op_calls_per_chunk": dict.fromkeys(chip_smoke.INT8_PASS_OPS, 0),
        "int8_gemm_kernel_ms_per_chunk": 0.0, "int8_conv3x3_kernel_ms_per_chunk": 0.0})
    init = streaming.PredictorBase.__init__

    def kernel_by_default(self, *args, dw3d_use_kernel=None, dtype=torch.float32, **kwargs):
        # the card's default route, which the launch checks expect
        init(self, *args, dw3d_use_kernel=True if dw3d_use_kernel is None else dw3d_use_kernel,
             dtype=dtype, **kwargs)

    monkeypatch.setattr(streaming.PredictorBase, "__init__", kernel_by_default)
    config = shrink(spotting_recipe(num_classes=2, image_size=(96, 64), pretrained=False,
                                    num_decode_workers=2))
    nn_name, nn_kwargs = config["argus_params"]["nn_module"]
    small = {"int8_conv_small": (2, 12, 20, 16, 24, 3, 2)}
    for name, value in dict(CHUNK=8, INT8_K_CONVS=3, INT8_MM_CONVS=6, INT8_SHAPES=small,
                            INT8_MM_SHAPES={"int8_gemm_small": (2, 6, 8, 32, 16, 1, 1)},
                            INT8_CONV_SHAPES={"int8_conv_f32_small": (2, 9, 11, 32, 24, 3, 2)},
                            INT8_SLICE=1, INT8_STREAM_FRAMES=46,
                            DW_PER_CHUNK=nn_kwargs["num_3d_blocks"]).items():
        monkeypatch.setattr(chip_smoke, name, value)
    model = build_model(nn_name, **nn_kwargs)
    init_weights(model, torch.Generator().manual_seed(0))
    params = {"nn_module": (nn_name, nn_kwargs), "frame_stack_size": 15,
              "frame_stack_step": 2, "frames_processor": ("pad_normalize", {"size": (96, 64)})}
    weights = (model.state_dict(), params)
    video = np.random.default_rng(0).integers(0, 255, (3 * 8 + 30, 64, 96), dtype=np.uint8)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny arch gains nothing from intra-op threads
    try:
        bf16 = streaming.ChunkedVideoPredictor(weights=weights, device="cpu", chunk_size=8,
                                               tta=True)
        _, raw_bf16 = bf16.predict_video(iter(enumerate(video)), len(video))
        launches, rows = chip_smoke.int8_phase(torch.device("cpu"), "cpu", weights, video,
                                               raw_bf16)
    finally:
        torch.set_num_threads(threads)
    assert sorted(rows) == ["int8_conv_f32_small", "int8_conv_small", "int8_gemm_small"]
    assert sorted(launches) == ["int8_data_parallel", "int8_edges", "int8_export",
                                "int8_inference", "int8_serve_device", "int8_sp_1x2",
                                "int8_streaming"]
    main = launches["int8_inference"]  # 3 chunks + the bootstrap
    assert main["int8_conv3x3"] == 3 * 4 and main["int8_gemm"] == 6 * 4 and main["int8_conv"] == 0
    kernels = chip_smoke.kernels_line(chip_smoke.int8_sources(launches), rows)
    assert [k["name"] for k in kernels] == ["int8_conv_small", "int8_gemm_small",
                                            "int8_conv_f32_small"]
    assert kernels[0]["launches"] == 12 and kernels[0]["library_ms"] is None
    assert "cudnn_bf16_ms" in kernels[0] and len(kernels[0]["launches_by_path"]) == 6
    assert kernels[0]["source"].endswith("csrc/int8_conv3x3.cu")
    assert kernels[1]["launches"] == 24 and kernels[1]["library_ms"] == 0.0
    assert len(kernels[1]["launches_by_path"]) == 6
    assert kernels[2]["source"].endswith("csrc/int8_conv.cu") and "cudnn_float32_ms" in kernels[2]
    assert list(kernels[2]["launches_by_path"]) == ["int8_edges"] and kernels[2]["launches"] > 0
