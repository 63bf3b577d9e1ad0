"""A later change adds a configuration, a mix and a per-layer metric as
new files and manifest entries, editing no file that is there; the
harness then runs the new cell."""

import hashlib
import json

from bench_dcnn.tests.tiny import (TINY_CONFIGS, copy_benchmark, result,
                                   run_cli)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench_dcnn").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = copy_benchmark(tmp_path / "co")
    before = _digests(root)
    bench = root / "bench_dcnn"
    cfg = json.loads((bench / "configs" / "vnet.json").read_text())
    cfg.update(TINY_CONFIGS["vnet"], name="vnet_tiny")
    (bench / "configs" / "vnet_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "infer-b3.json").write_text(json.dumps(
        {"kind": "infer", "dtype": "float32", "batch": 3, "pool": 2,
         "in_flight": 1, "compare_batches": 1}))
    (bench / "limits" / "vnet_tiny.infer-b3.json").write_text(
        json.dumps({"out_rel_rms": 1e-4}))
    (bench / "metrics" / "voxels_per_batch.infer.py").write_text(
        '"""Voxels a batch (a new reader, for the test)."""\n\n\n'
        "def read(ctx):\n"
        "    if ctx.kind != 'infer':\n"
        "        return None\n"
        "    nd = ctx.work[0][0]\n"
        "    n = 1\n"
        "    for s in nd['in_spatial']:\n"
        "        n *= s\n"
        "    return float(n * ctx.batch)\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "vnet_tiny", "source": "https://arxiv.org/abs/1606.04797",
         "file": "bench_dcnn/configs/vnet_tiny.json", "reduced": [
             "in_spatial", "channels"], "why": "a test's cell"})
    manifest["workloads"].append(
        {"name": "vnet_tiny.infer-b3", "config": "vnet_tiny",
         "traffic": "infer-b3", "chips": 1, "why": "a test's cell"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and m["name"].startswith("infer_"):
            m["workloads"].append("vnet_tiny.infer-b3")
    manifest["per_layer"].append(
        {"name": "voxels_per_batch.infer", "unit": "voxels",
         "better": "higher", "source": "program_counter",
         "layer": "model step", "moves": "infer_samples_per_s",
         "workloads": ["vnet_tiny.infer-b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before

    plain = result(run_cli(root, "vnet_tiny.infer-b3", seconds=3, trace=0))
    assert plain["correct"] is True
    # the tail needs 20 batches in the window, which a loaded CPU may miss
    assert {"setup_s", "infer_samples_per_s"} <= set(plain["metrics"]) <= {
        "setup_s", "infer_samples_per_s", "infer_p95_ms"}
    traced = result(run_cli(root, "vnet_tiny.infer-b3", trace=1))
    assert traced["correct"] is True
    assert traced["metrics"]["voxels_per_batch.infer"]["value"] == 3 * 16 ** 3
    assert list(traced)[-1] == "checks"
