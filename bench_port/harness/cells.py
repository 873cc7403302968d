"""Everything of a cell found by name: its entry in BENCHMARK.json, its
configuration file and the plain reference that file names, its traffic
mix, its limits and the readers of its per-layer metrics. Adding a cell,
a configuration (with its reference), a mix or a metric adds files and
entries; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MIX_SUFFIX = ".json"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    mix: dict               # the traffic mix's parameters
    limits: dict            # {number compared: limit}
    end_to_end: list        # the metric entries this cell reports
    per_layer: list


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a cell reports `metric`: the cells it lists, or, without a
    list, every cell that reports the end-to-end metric it moves (an
    end-to-end metric without a list is every cell's)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def find(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of the checkout at `root`."""
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    reference_of(config)
    mix = load_json(os.path.join(bench_dir, "traffic",
                                 w["traffic"] + MIX_SUFFIX))
    limits_path = os.path.join(bench_dir, "limits", name + ".json")
    limits = {k: v["limit"] for k, v in load_json(limits_path).items()}
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: str = ROOT):
    """The `read(record)` function of per-layer metric `metric`, from
    bench_port/metrics/<metric>.py of the checkout at `root`."""
    path = os.path.join(root, os.path.basename(BENCH_DIR), "metrics",
                        metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference_of(config: dict):
    """The plain reference module of a configuration file: bench_port/
    reference/<reference>.py, the file's "reference" (contract in
    `reference/pipeline.py`); no default."""
    if "reference" not in config:
        raise KeyError(f"configuration {config.get('name')!r} names no "
                       f"plain reference (its key \"reference\")")
    return importlib.import_module(
        f"bench_port.reference.{config['reference']}")


def kind(mix: dict):
    """The generator of a traffic mix: bench_port/harness/kinds/<kind>.py,
    the mix's "kind"."""
    return importlib.import_module(f"bench_port.harness.kinds.{mix['kind']}")
