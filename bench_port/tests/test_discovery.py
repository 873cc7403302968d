"""Cells, configurations, mixes, limits and per-layer metrics are found
by name, and new ones by adding files and entries alone."""

import json
import os
import shutil

from bench_port.harness import cells


def _bench():
    return cells.load_json(os.path.join(cells.ROOT, "BENCHMARK.json"))


def test_every_cell_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = cells.find(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["kind"] in ("offline", "serve", "train")
        assert cells.kind(cell.mix).run
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names


def test_every_metric_has_a_reader_that_keeps_to_its_kind():
    for m in _bench()["per_layer"]:
        read = cells.reader(m["name"])
        assert read({"kind": "no such kind"}) is None


def test_configuration_files_hold_their_sources():
    for c in _bench()["configs"]:
        cfg = cells.load_json(os.path.join(cells.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and cfg["reduced"] == []
        assert cfg["program_config"]["model"]["size_preset"] == "full"


def test_a_new_cell_mix_and_metric_are_found_from_added_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH_DIR, root / "bench_port")
    bench = _bench()
    bench["workloads"].append({
        "name": "s-infer-b2", "config": "stablemtl-s-sd2",
        "traffic": "offline-b2-256", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("s-infer-b2")
    bench["per_layer"].append({
        "name": "steps.infer", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "model step",
        "moves": "images_per_s", "workloads": ["s-infer-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = dict(cells.load_json(os.path.join(
        cells.BENCH_DIR, "traffic", "offline-b8-512.json")),
        batch=2, height=256, width=256)
    (root / "bench_port/traffic/offline-b2-256.json").write_text(
        json.dumps(mix))
    (root / "bench_port/limits/s-infer-b2.json").write_text(json.dumps(
        {"worst_rel_l2": {"limit": 0.25, "lower": 0.05, "upper": 0.5}}))
    (root / "bench_port/metrics/steps.infer.py").write_text(
        "def read(record):\n    return record.get('window_steps')\n")
    cell = cells.find("s-infer-b2", root=str(root))
    assert cell.mix["batch"] == 2 and cell.limits["worst_rel_l2"] == 0.25
    assert [m["name"] for m in cell.per_layer][-1] == "steps.infer"
    assert cells.reader("steps.infer", root=str(root))(
        {"window_steps": 7}) == 7
    # the cells already there see nothing of it
    old = cells.find("ms-infer-b8", root=str(root))
    assert "steps.infer" not in [m["name"] for m in old.per_layer]
