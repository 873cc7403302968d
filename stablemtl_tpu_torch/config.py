"""Hierarchical YAML configs with recursive `base_config` inheritance,
counterpart of `stablemtl_tpu/config.py`.

A config file may list `base_config: [a.yaml, b.yaml]`; the bases load
depth-first in order and merge, later files (and finally the child)
overriding earlier keys. Plain dicts behind a small attribute-access
wrapper. YAML needs PyYAML, imported when a YAML file is read; a training
run directory's `config_resolved.json` needs only json.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Iterator, Mapping


class Config(Mapping):
    """Immutable-ish attribute/Mapping view over a nested dict."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", dict(data or {}))

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        val = self._data[key]
        return Config(val) if isinstance(val, dict) else val

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    # -- attribute access --------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def __repr__(self) -> str:
        return f"Config({json.dumps(self._data, indent=2, default=str)})"


def merge_dicts(base: dict, override: dict) -> dict:
    """Deep-merge `override` into `base` (override wins; dicts merge recursively)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str) -> dict:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs PyYAML; without it, pass a run directory "
            f"holding config_resolved.json") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def recursive_load_config(path: str, root: str | None = None) -> Config:
    """Load a YAML config, resolving its `base_config` list recursively.

    Paths inside `base_config` resolve against `root` (default: the
    file's directory), the working directory, then the repository root:
    the shipped configs name their bases repo-root-relative
    (`config/dataset/...`).
    """
    path = os.path.abspath(path)
    if root is None:
        root = os.path.dirname(path)

    raw = load_yaml(path)
    merged: dict = {}
    for base_rel in raw.pop("base_config", []) or []:
        base_path = base_rel
        if not os.path.isabs(base_path):
            repo_root = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            for cand_root in (root, os.getcwd(), repo_root):
                cand = os.path.join(cand_root, base_rel)
                if os.path.exists(cand):
                    break
            base_path = cand
        base_cfg = recursive_load_config(base_path, root=root)
        merged = merge_dicts(merged, base_cfg.to_dict())
    merged = merge_dicts(merged, raw)
    return Config(merged)


def resolve_config_arg(config_arg: str):
    """Resolve a CLI `--config` value that may be a YAML path OR a training
    output dir: a dir reloads the run's archived `config_resolved.json` and
    implies `<dir>/checkpoint` when it exists. Returns (cfg,
    implied_checkpoint_dir_or_None)."""
    if os.path.isdir(config_arg):
        resolved = os.path.join(config_arg, "config_resolved.json")
        if not os.path.exists(resolved):
            raise SystemExit(f"{resolved} not found")
        with open(resolved) as f:
            cfg = Config(json.load(f))
        ck = os.path.join(config_arg, "checkpoint")
        return cfg, (ck if os.path.isdir(ck) else None)
    cfg = recursive_load_config(
        config_arg, root=os.path.dirname(os.path.dirname(
            os.path.abspath(config_arg))))
    return cfg, None


def find_value_in_config(cfg: Config | dict, key: str) -> list:
    """Every value stored under `key` anywhere in the config tree, in
    document order (the reference's config_util.py:30-44, used to locate
    dataset directories)."""
    found = []
    data = cfg.to_dict() if isinstance(cfg, Config) else cfg
    for k, v in data.items():
        if k == key:
            found.append(v)
        if isinstance(v, dict):
            found.extend(find_value_in_config(v, key))
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, dict):
                    found.extend(find_value_in_config(item, key))
    return found
