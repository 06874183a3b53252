"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import ast
import json
import re

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(_text(w) for w in SPEC["command"])


def test_names_units_and_texts():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])
        names += [w["name"], w["config"], w["traffic"]]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in SPEC[group]]
        assert len(group_names) == len(set(group_names))


def test_shares_are_percent_and_layers_agree():
    layers = {}
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        kind = m["name"].split(".")[0]
        if kind in ("kernels_roofline", "device_idle_share"):
            # one layer, measured in two kinds of cell
            assert layers.setdefault(kind, m["layer"]) == m["layer"]


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        mine = {n for n, m in e2e.items()
                if cell in m.get("workloads", [cell])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if cell in m.get("workloads", [cell])]
        assert layer
        for m in layer:
            assert m["moves"] in mine


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.traffic["loop"] in ("train", "segment")
    assert (harness.HERE / "loops" / f"{cell.traffic['loop']}.py").exists()
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]).read)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert cell.config["reduced"] == []


def test_config_files_under_paths_and_distinct():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


def test_kernel_kinds_have_their_parts():
    for name, kind in harness.kernel_kinds().items():
        assert kind.FRAGMENTS and all(isinstance(f, str)
                                      for f in kind.FRAGMENTS)
        module, fn = kind.COUNTER
        assert module.startswith("ctseg_tpu_torch.ops.")
        assert kind.work({"op": "none"}) is None


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(CELLS) // 4)


def test_file_names_are_made_of_name_characters():
    for path in harness.HERE.rglob("*"):
        if "_cache" in path.parts or "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        if "_cache" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)
