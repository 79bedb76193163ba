"""``chip_smoke.py`` phase 9 (``host_data_path``) rehearsed on the CPU:
the stage configs cut by ``tests/test_torch_chain.py::shrink`` (tiny arch,
64×96), 48-row stores padded to 64 rows as the card's 720 are to 736, the
kernels' plain versions counted as their launches. Every check of the
phase holds: the native gather bitwise the numpy reader's into padded
slots, training and predicting from the stores, the smoothing against
scipy, a device trace naming the GeM and warp ops, and the rehearsal
CLI's every step, with the launches of each path."""

import torch

from ball_action_spotting_torch.predict import streaming
from ball_action_spotting_torch.utils.experiments import load_experiment_config
from ball_action_spotting_torch.utils.recipe import spotting_recipe
from tests.test_torch_chain import shrink
from tests.test_torch_weights import count_plain_calls


def test_chip_smoke_phase9_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    count_plain_calls(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    init = streaming.PredictorBase.__init__

    def kernel_by_default(self, *args, dw3d_use_kernel=None, **kwargs):
        # the card's default route, which the launch checks expect
        init(self, *args, dw3d_use_kernel=True if dw3d_use_kernel is None else dw3d_use_kernel,
             **kwargs)

    monkeypatch.setattr(streaming.PredictorBase, "__init__", kernel_by_default)
    frames = 100
    events = {half: {f: (chip_smoke.ball.classes[k % 2], None)
                     for k, f in enumerate(range(20, frames - 10, 20))} for half in (1, 2)}
    for name, value in dict(
            WIDTH=96, HEIGHT=64, VIDEO_HEIGHT=48, STORE_FRAMES=frames, STORE_EVENTS=events,
            GATHER_BATCHES=(4, 8), SMOOTH_FRAMES=2000,
            TRACE_NAMES=("bas_torch::gem_pool", "bas_torch::warp_resample")).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "flagship_config", lambda: shrink(spotting_recipe(
        num_classes=2, image_size=(96, 64), pretrained=False, num_decode_workers=2)))
    monkeypatch.setattr(chip_smoke, "stage_config", lambda name, domain: shrink(
        load_experiment_config(name, domain,
                               configs_dir=chip_smoke.PORT_CONFIGS / domain.name)))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny arch gains nothing from intra-op threads
    try:
        launches = chip_smoke.host_data_path(torch.device("cpu"), "cpu",
                                             {"device_fps_tta_on": 0.0,
                                              "end_to_end_fps_tta_on": 0.0}, tmp_path / "work")
    finally:
        torch.set_num_threads(threads)
    train = launches["store_train"]
    assert train["warp_H"] == train["warp_V"] == 4 and train["gem"] >= 4
    assert launches["store_predict"]["gem"] > 0 and launches["store_predict"]["dwconv3d"] > 0
    assert set(chip_smoke.REHEARSAL_PATHS.values()) <= set(launches)
    assert launches["rehearsal_stage4_train"]["warp_H"] == 4
    stores = sorted((tmp_path / "work" / "stores").rglob("*.gray"))
    assert len(stores) == 4 and all(p.stat().st_size == 24 + frames * 48 * 96 for p in stores)
