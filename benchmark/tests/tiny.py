"""Small cells for tests on the CPU: each real cell's traffic and
parameters with the configuration cut to the tiny encoder at 64×96."""

from __future__ import annotations

import copy

from benchmark import harness

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY_KWARGS = dict(model_name="efficientnetv2_tiny", num_3d_blocks=2, num_3d_features=16,
                   se_reduce_3d_ratio=8, num_3d_stack_proj=8)


def tiny_cell(name: str, dtype: str = "float32", **params) -> dict:
    """The cell of ``BENCHMARK.json`` named ``name``, its configuration
    cut to the tiny encoder at 64×96 frames (60 rows decoded), chunk 8 and
    short segments; ``params`` override the cell's."""
    cell = copy.deepcopy(harness.find_cell(name, SPEC))
    m = cell["model"]
    m["nn_module_kwargs"].update(TINY_KWARGS)
    m.update(image_size=[96, 64], video_size=[96, 60], chunk_size=8, dtype=dtype)
    p = cell["params"]
    p.update(segment_frames=70, pool_frames=40, check_samples=6)
    p.update(params)
    return cell
