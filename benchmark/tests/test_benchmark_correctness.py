"""CPU tests of what decides ``correct``: the frozen reference agrees with
the program at a tiny size in float32; each fault a cell can have, planted
under its timed path, turns ``correct`` false; the control (the int8
engine) reads further from the reference than the program does."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.reference.model import Reference, calibrate_bn, seeded_weights
from benchmark.tests.faults import FAULTS
from benchmark.tests.test_benchmark_harness import run_tiny
from benchmark.tests.tiny import CELLS, SPEC, TINY_KWARGS, tiny_cell

KWARGS = dict(num_classes=2, num_frames=15, stack_size=3, index_2d_features=4,
              expansion_3d_ratio=3, drop_rate=0.2, drop_path_rate=0.2, act_layer="silu",
              **TINY_KWARGS)


def test_frozen_reference_agrees_with_the_program_model():
    """Same seeded weights and frames, float32, eval mode: the program's
    model and the reference agree to rounding. A frozen copy that drifted
    fails here."""
    from ball_action_spotting_torch.models import build_model

    w = seeded_weights(KWARGS, 11, "cpu")
    clips = torch.rand(2, 15, 64, 96, generator=torch.Generator().manual_seed(1))
    calibrate_bn(w, KWARGS, clips)
    model = build_model("multidim_stacker", **KWARGS)
    model.load_state_dict(w)
    with torch.no_grad():
        got = model.eval()(clips)
    want = Reference(w, KWARGS).forward(clips)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_served_weights_are_the_weights_the_program_serves():
    """In float32 the served form computes what the calibrated weights do;
    in bfloat16 the program's BN fold and cast leave every value as it is,
    so the program and the reference run the same numbers."""
    from ball_action_spotting_torch.predict.streaming import inference_state

    from benchmark.inputs import served

    w = seeded_weights(KWARGS, 5, "cpu")
    clips = torch.rand(2, 15, 64, 96, generator=torch.Generator().manual_seed(2))
    calibrate_bn(w, KWARGS, clips)
    want = Reference(w, KWARGS).forward(clips)
    assert torch.allclose(Reference(served(w, torch.float32), KWARGS).forward(clips), want,
                          atol=1e-5, rtol=1e-5)
    w16 = served(w, torch.bfloat16)
    folded = inference_state(w16, fold_bn=True, s2d_stem=False)
    for key, value in folded.items():
        assert torch.equal(value.to(torch.bfloat16).float(), value), key
        if key in w16:
            assert torch.equal(value, w16[key]), key


FAULT_CASES = [(c, f) for c in CELLS for f in FAULTS[harness.find_cell(c, SPEC)["traffic"]]]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_a_planted_fault_turns_correct_false(name, fault):
    cell = tiny_cell(name)
    assert run_tiny(cell)[0]
    correct, line = run_tiny(cell, hook=FAULTS[cell["traffic"]][fault])
    assert not correct, line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_further_than_the_program(name):
    """The control runs through the rest of a run and reads far from the
    reference where the sound program, in float32 at a tiny size, reads
    rounding. (At a tiny size bf16 rounding is as large as the control's,
    so the limits come from readings on the card at the cell's size.)"""
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    program = calibrate.reading(cell, 7, 0.2, "program", device=cpu)["checks"]
    control = calibrate.reading(cell, 7, 0.2, "control", device=cpu)["checks"]
    assert max(control[k] / max(program[k], 1e-12) for k in program) >= 100.0, (program, control)
