"""`correct` on the host at a size a test run holds: sound runs pass, the
controls fail (the reference's rollout in TF32 fails the rollout
comparison; the program's own bf16 G-sweeps fail the QP residual), and a
run whose timed path is broken
underneath comes out not correct, once for each fault the cell can have (a
step that returns its state unchanged; half of the samples left out of the
kernel's iterations; the plan altered where it is produced). The cell has
one card, so there is no exchange between chips to leave out."""

import pytest

import helpers

SEED = 3000000021


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import run

    root = helpers.tiny_checkout(tmp_path_factory.mktemp("tiny"))
    return run.load_cell(helpers.TINY, root / "BENCHMARK.json", root)


def _run(c):
    import run

    return run.run_cell(c, SEED, 0.0, False, "cpu")


def test_a_sound_run_is_correct(tiny):
    r = _run(tiny)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 1


def test_the_control_fails_the_rollout_comparison(tiny):
    cfg, model = tiny["config"], tiny["model"]
    prog = model.Program(cfg, "cpu")
    inst = model.instance(cfg, SEED, 0, "cpu")
    out = prog.solve(inst)
    sound = model.judge(cfg, inst, out)["rollout_gap"]
    control = model.rollout_control(cfg, inst, out)["rollout_gap"]
    limit = tiny["limits"]["rollout_gap"]["limit"]
    assert sound <= limit < control, (sound, limit, control)


def test_the_programs_bf16_sweeps_fail_the_qp_residual(tiny):
    import calibrate

    cfg, model = tiny["config"], tiny["model"]
    inst = model.instance(cfg, SEED, 0, "cpu")
    sound = model.judge(cfg, inst, model.Program(cfg, "cpu").solve(inst))
    low = calibrate.with_control(cfg, "bf16_sweeps")
    control = model.judge(low, inst, model.Program(low, "cpu").solve(inst))
    limit = tiny["limits"]["qp_residual"]["limit"]
    assert sound["qp_residual"] <= limit < control["qp_residual"], (
        sound["qp_residual"], limit, control["qp_residual"])


@pytest.mark.parametrize("fault", ["unchanged", "half_samples", "altered"])
def test_a_broken_timed_path_is_not_correct(tiny, fault):
    import faults

    undo = faults.FAULTS[fault]()
    try:
        r = _run(tiny)
    finally:
        undo()
    assert not r["correct"], r["checks"]
