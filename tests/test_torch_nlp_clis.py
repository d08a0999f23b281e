"""The port's CLIs of the NLP family at small budgets, on the host, into
tmp_path: hopper (its two result files in the JAX CLI's layout, read back
with numpy; the Monte-Carlo lines), drone_gaussian (warm-started from a
drone_alpha=0.2_repeat=0.npy written from the committed golden plan; its
file read by the JAX package's loader), terrains_gaussian (its figure);
and --help of each."""

import os
import re
from pathlib import Path

import numpy as np
import pytest

from riskaversetrajopt_torch.experiments import (
    common,
    drone_gaussian,
    hopper,
    terrains_gaussian,
)
from riskaversetrajopt_tpu.experiments import common as jcommon

GOLD = (Path(__file__).parent / "fixtures"
        / "gold_drone_m50_a0.2_seed0_iters15.npy")


@pytest.mark.parametrize("cli", [hopper, drone_gaussian, terrains_gaussian])
def test_help(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"], device="cpu")
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out


def test_hopper_cli_files_in_the_jax_layout(tmp_path, capsys):
    """--alphas 0.3 --max-iter 3 --mc-M 100: the baseline and SAA files
    hold np.save(xs) then np.save(us), as the JAX CLI writes them; the MC
    block reports both plans over the 100 fields."""
    rdir = tmp_path / "results"
    hopper.main(["--alphas", "0.3", "--max-iter", "3", "--mc-M", "100",
                 "--results", str(rdir)], device="cpu")
    out = capsys.readouterr().out
    assert sorted(p.name for p in rdir.iterdir()) == [
        "hopper_base_results.npy", "hopper_saa_alpha=0.3_results.npy"]
    for f in rdir.iterdir():
        with open(f, "rb") as fh:
            xs, us = np.load(fh), np.load(fh)
        assert xs.shape == (31, 8) and us.shape == (30, 4)
        assert np.isfinite(xs).all() and np.isfinite(us).all()
    assert re.search(r"baseline: jumped=\S+ safe=\S+", out)
    assert re.search(r"alpha=0.3: jumped=\S+ safe=\S+ avar=\S+", out)
    assert len(re.findall(r"iters=3 solved=False", out)) == 2


def test_drone_gaussian_cli_reads_drone_risk_and_writes_for_jax(tmp_path,
                                                                capsys):
    """From drone_alpha=0.2_repeat=0.npy (the golden plan's controls),
    --max-iter 5: drone_gaussian_alpha=0.2.npy in the reference's
    sequential layout, read by the JAX package's common.load_traj; without
    the drone_risk file the CLI raises as JAX's does."""
    rdir = tmp_path / "results"
    with pytest.raises(FileNotFoundError, match="run the drone_risk"):
        drone_gaussian.main(["--alphas", "0.2", "--results", str(rdir)],
                            device="cpu")
    us = np.load(GOLD)
    common.save_traj(rdir / "drone_alpha=0.2_repeat=0.npy", us,
                     np.zeros((50, 21, 6)))
    drone_gaussian.main(["--alphas", "0.2", "--max-iter", "5", "--results",
                         str(rdir)], device="cpu")
    assert re.search(r"iters=5 solved=False", capsys.readouterr().out)
    us_g, xs_g = jcommon.load_traj(rdir / "drone_gaussian_alpha=0.2.npy")
    assert us_g.shape == (20, 3) and xs_g.shape == (21, 6)
    assert np.isfinite(xs_g).all()


def test_terrains_gaussian_cli_writes_its_figure(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        terrains_gaussian.main(["--num-fields", "3"], device="cpu")
    finally:
        os.chdir(cwd)
    assert (tmp_path / "figures" / "hopper_friction_fields.png").stat().st_size
