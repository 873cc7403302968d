"""Cells, configurations with their plain references, mixes, limits and
per-layer metrics are found by name, and new ones by adding files and
entries alone."""

import dataclasses
import json
import os
import shutil
import sys

import pytest
import torch

import bench_port.reference
from bench_port.harness import cells, program
from bench_port.harness.refcheck import plain_reference
from bench_port.reference import pipeline
from bench_port.tests.bench_helpers import shrunk
from bench_port.workcount.count import infer_work, train_work


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
    """Each file is its entry's configuration, with the cuts the entry
    lists, a plain reference that resolves, and no test preset's widths
    in a cell."""
    for c in _bench()["configs"]:
        cfg = cells.load_json(os.path.join(cells.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cells.reference_of(cfg).Reference
        assert cfg["program_config"]["model"]["size_preset"] not in (
            "tiny", "nano")


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


def _checkout(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's files."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH_DIR, root / "bench_port")
    (root / "BENCHMARK.json").write_text(json.dumps(_bench()))
    return root


def test_a_configuration_that_names_no_reference_is_refused(tmp_path):
    root = _checkout(tmp_path)
    path = root / "bench_port/configs/stablemtl-s-sd2.json"
    cfg = json.loads(path.read_text())
    del cfg["reference"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match="reference"):
        cells.find("s-infer-b8", root=str(root))
    assert cells.find("ms-infer-b8", root=str(root))


# a reference module a later configuration could bring: SD2's, with a
# record of each call and a text table of its own (the SD2 one negated)
RECORDING = """
from bench_port.reference import pipeline
from bench_port.reference.pipeline import N_TASKS, TINY, TWO_FRAME  # noqa

CALLS = []


def build(config, device="meta"):
    CALLS.append("build")
    return pipeline.build(config, device)


def conditioning_shapes(config):
    CALLS.append("conditioning_shapes")
    return pipeline.conditioning_shapes(config)


def conditioning(config, seed, device):
    CALLS.append("conditioning")
    return {k: -v for k, v in
            pipeline.conditioning(config, seed, device).items()}


class Reference(pipeline.Reference):
    def train_inputs(self, *args, **kw):
        CALLS.append("train_inputs")
        return super().train_inputs(*args, **kw)


class Trainer(pipeline.Trainer):
    def __init__(self, ref, opt):
        CALLS.append("Trainer")
        super().__init__(ref, opt)
"""


def test_a_new_reference_is_found_from_added_files(tmp_path, monkeypatch):
    """A configuration that names another reference module is built,
    drawn, loaded, conditioned, referenced and counted through it; the
    SD2 configurations still resolve to `pipeline`."""
    root = _checkout(tmp_path)
    (root / "bench_port/reference/recording.py").write_text(RECORDING)
    cfg = cells.load_json(os.path.join(cells.BENCH_DIR, "configs",
                                       "stablemtl-ms-sd2.json"))
    cfg.update(name="stablemtl-ms-rec", reference="recording")
    (root / "bench_port/configs/stablemtl-ms-rec.json").write_text(
        json.dumps(cfg))
    bench = _bench()
    bench["configs"].append({**bench["configs"][0], "name": cfg["name"],
                             "file": "bench_port/configs/"
                                     "stablemtl-ms-rec.json"})
    bench["workloads"].append({
        "name": "rec-train", "config": cfg["name"],
        "traffic": "train-mb16-288x384", "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "bench_port/limits/ms-train-mb16.json",
                root / "bench_port/limits/rec-train.json")
    # the package of the checkout's reference modules, as a run from the
    # checkout would import it
    monkeypatch.setattr(bench_port.reference, "__path__", [
        str(root / "bench_port/reference"), *bench_port.reference.__path__])
    name = "bench_port.reference.recording"
    try:
        cell = cells.find("rec-train", root=str(root))
        rec = cells.reference_of(cell.config)
        assert rec.__name__ == name and rec.CALLS == []
        for sd2 in ("ms-infer-b8", "s-infer-b8", "ms-train-mb16"):
            assert cells.reference_of(
                cells.find(sd2, root=str(root)).config) is pipeline
        _drive(cell, rec, monkeypatch)
    finally:
        sys.modules.pop(name, None)


def _drive(cell, rec, monkeypatch):
    from bench_port.harness.kinds import train
    from bench_port.harness.main import Context

    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg, seed = shrunk(cell.config), 2**31 + 5
    weights = program.draw_weights(cfg, seed, "cpu",
                                   program.weight_dtypes(cfg))
    assert rec.CALLS == ["build"] and set(weights) == {"vae", "unet",
                                                       "child"}
    pipe = program.build_program(cfg, "cpu", (32, 32))
    program.load_program(pipe, cfg, seed, "cpu")
    table = rec.conditioning(cfg, seed, "cpu")["text_embed_table"]
    assert torch.equal(pipe.text_embed_table, table.to(
        pipe.text_embed_table.dtype))
    ref = plain_reference(cfg, seed, "cpu")
    assert type(ref) is rec.Reference and torch.equal(ref.text, table.float())
    del rec.CALLS[:]
    infer_work(cfg, 1, (32, 32))
    train_work(cfg, 1, (32, 32))
    assert rec.CALLS == ["build", "conditioning_shapes"] * 2 + \
        ["train_inputs"]
    mix = {**cell.mix, "micro_batch": 1, "pool": 1, "height": 32,
           "width": 32, "checked_updates": 1}
    ctx = Context(cell=dataclasses.replace(cell, config=cfg, mix=mix),
                  seed=seed, seconds=0.0, trace=False, t_start=0.0,
                  device="cpu")
    oc = train.optimizer_config(cfg, int(mix["accumulation"]))
    del rec.CALLS[:]
    train.reference_readings(ctx, train.make_batches(seed, mix, "cpu"),
                             program.derived_seed(seed, "steps"), oc)
    assert rec.CALLS[:4] == ["build", "conditioning", "Trainer",
                             "train_inputs"]
    # a conditioning the program's pipeline cannot take is refused
    real = rec.conditioning
    for extra, match in (
            ({"add_time_ids": torch.zeros(2, 6)}, "add_time_ids"),
            ({"text_embed_table": torch.zeros(7, 3, 32)}, "text_embed_table")):
        monkeypatch.setattr(rec, "conditioning",
                            lambda c, s, d, extra=extra: {**real(c, s, d),
                                                          **extra})
        with pytest.raises(RuntimeError, match=match):
            program.load_program(pipe, cfg, seed, "cpu")
