"""Fixtures of the benchmark's CPU tests beside ``tests/conftest.py``.

``test_metric_readers_on_a_trace`` hands every reader a fake trace of the
prediction program's kernels. The folded BN's epilogue kernel
(``csrc/bias_act.cu``, read by ``bias_act_ms.predict``) is one of them, so
for that test the fake trace also holds one ``bias_act`` kernel."""

from __future__ import annotations

import pytest

BIAS_ACT_KERNEL = "void (anonymous namespace)::bias_act_kernel<__nv_bfloat16, 8, true, false>"


@pytest.fixture(autouse=True)
def bias_act_kernel_in_fake_trace(request, monkeypatch):
    fake = getattr(request.module, "FakeTrace", None)
    if request.node.originalname == "test_metric_readers_on_a_trace" and fake is not None:
        kernel_seconds = fake.kernel_seconds

        def with_bias_act(self, match):
            self.by_name.setdefault(BIAS_ACT_KERNEL, [0.3, 200])
            return kernel_seconds(self, match)

        monkeypatch.setattr(fake, "kernel_seconds", with_bias_act)
    yield
