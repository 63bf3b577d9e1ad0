"""``BENCHMARK.json`` against the benchmark's contract: names, units,
metrics and the files each cell needs."""

import json
import re

import pytest

from bench_dcnn.tests.tiny import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["command"][1:] == ["bench_dcnn/run.py"]
    assert MANIFEST["paths"] == ["bench_dcnn"]
    for kind in ("config", "workload", "end_to_end", "per_layer"):
        key = {"config": "configs", "workload": "workloads"}.get(kind, kind)
        for entry in MANIFEST[key]:
            assert set(entry) - {"workloads"} == KEYS[kind], entry


def test_names_units_and_lines():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names += [e["name"] for e in MANIFEST[key]]
    for w in MANIFEST["workloads"]:
        names += [w["config"], w["traffic"]]
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        names += c["reduced"]
        assert _line(c["why"]) and _line(c["source"])
    assert all(NAME.match(n) for n in names), names
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _reports(cell):
    return {m["name"] for m in MANIFEST["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_layer_metric_moves_what_its_cells_report():
    """The harness reports a per-layer metric in the cells its
    ``workloads`` list, so every entry lists them."""
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m.get("workloads"), m["name"]
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in _reports(cell), (m["name"], cell)
    for cell in cells:
        got = _reports(cell)
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_finds_its_files(cell):
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    conf = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("bench_dcnn/")
    assert (BENCH / "reference" / f"{cfg['model']}.py").is_file()
    assert (BENCH / "models" / f"{cfg['model']}.py").is_file()
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "loops" / f"{mix['kind']}.py").is_file()
    assert (BENCH / "limits" / f"{cell}.json").is_file()
    for m in MANIFEST["per_layer"]:
        if cell in m["workloads"]:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


WIDTHS = ("channels", "in_channels", "z_dim", "num_classes", "kernel")


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_each_config_file_states_its_source_and_cuts(conf):
    """The file repeats the entry's source and cuts; each cut is a key of
    the file with its published value beside it, and none is a width."""
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert key in cfg and key in cfg["published"], key
        assert cfg[key] != cfg["published"][key], key
        assert key not in WIDTHS and not key.endswith(("_dim", "_rank"))
