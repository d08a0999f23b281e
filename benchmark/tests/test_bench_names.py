"""BENCHMARK.json keeps to its format's names and finds every file it
names."""

import json
import re

import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((helpers.ROOT / "BENCHMARK.json").read_text())


def test_every_name_and_unit_keeps_to_the_alphabet():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_every_cell_finds_its_files():
    b = helpers.BENCH
    for w in BENCH["workloads"]:
        cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        assert (helpers.ROOT / cfg["file"]).is_file()
        assert (b / "traffic" / f"{w['traffic']}.json").is_file()
        assert (b / "limits" / f"{w['name']}.json").is_file()
        model = json.loads((helpers.ROOT / cfg["file"]).read_text())["model"]
        assert (b / "models" / f"{model}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (b / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds_and_run_length_are_in_range():
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
