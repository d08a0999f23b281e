"""The harness: a cell added as files alone, the modules a run may hold,
the reference on its own, and a host without a card."""

import json
import os
import shutil
import subprocess
import sys

import helpers

PY = sys.executable


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    import run

    root = helpers.tiny_checkout(tmp_path)
    c = run.load_cell(helpers.TINY, root / "BENCHMARK.json", root)
    assert c["config"]["M"] == 16 and c["traffic"]["pool"] == 1
    assert {m["name"] for m in c["end_to_end"]} == {"solve_s", "setup_s"}
    assert set(c["readers"]) == {m["name"] for m in c["per_layer"]}
    assert set(c["limits"]) == {"rollout_gap", "unsafe_share", "goal_gap",
                                "cvar_gap", "qp_residual"}


def _modules_after(code, path):
    out = subprocess.run(
        [PY, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=path, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=""))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_reference_load_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.']\n"
            "import run, reference, roofline, sampler, timeline\n"
            "for w in run.json.loads(open('BENCHMARK.json').read())['workloads']:\n"
            "    c = run.load_cell(w['name'])\n"
            "    c['model'].Program  # the driver module, not the program\n")
    mods = _modules_after(code, helpers.ROOT)
    assert not mods & {"jax", "jaxlib", "flax", "riskaversetrajopt_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    mods = _modules_after("import sys; sys.path[:0] = ['benchmark']\n"
                          "import reference, sampler, roofline", helpers.ROOT)
    assert "riskaversetrajopt_torch" not in mods
    assert not mods & {"jax", "jaxlib", "flax", "riskaversetrajopt_tpu"}


def test_the_reference_runs_without_the_port(tmp_path):
    for f in ("reference.py", "sampler.py"):
        shutil.copy(helpers.BENCH / f, tmp_path / f)
    cfg = (helpers.BENCH / "configs" / "drone_m1000.json").read_text()
    code = f"""
import json, torch, reference, sampler
cfg = json.loads({cfg!r})
inst = tuple(x.float() for x in sampler.drone_instance(cfg, 5, 0, 8, "cpu"))
us = torch.zeros(cfg["S"], cfg["n_u"])
hist = torch.stack([reference.initial_guess(cfg, "cpu").float(), us])
xs = reference.rollout(cfg, us, inst[0], inst[2]).float()
n = reference.judge(cfg, inst, us, xs, hist, 0.0)
assert n["rollout_gap"] < 1e-6 and n["finite"], n
assert len(n["qp_residuals"]) == 2 and n["qp_residual"] > 0, n
c = reference.judge(cfg, inst, us, reference.control_xs(cfg, inst, us), hist, 0.0)
assert c["rollout_gap"] > n["rollout_gap"], (c, n)
print("ok")
"""
    out = subprocess.run([PY, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_a_host_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [PY, "benchmark/run.py", "--workload", "drone_m2000.fused", "--seed",
         "3000000017", "--seconds", "1", "--trace", "0"],
        cwd=helpers.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_a_directory_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(helpers.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(helpers.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['benchmark']\n"
            "import run\n"
            "c = run.load_cell('drone_m2000.fused')\n"
            "c['model'].Program(c['config'], 'cpu')\n")
    out = subprocess.run([PY, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "riskaversetrajopt_torch" in out.stderr
