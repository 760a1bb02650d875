"""YAML + CLI-dotlist configuration system.

Port (a plain-Python copy) of humangaussian_tpu/config.py, on pyyaml:

- `load_config(path, dotlist)` merges YAML with `key.sub=value` overrides
  (values parsed as YAML, so `a.b=[1,2]` works);
- `${path.to.key}` interpolation and the `${rmspace:...}` resolver used
  for run tags;
- `ExperimentConfig` supplies the trial directory layout
  `exp_root/name/tag@timestamp/{ckpts,save,configs}`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any

import yaml


def _parse_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def merge_dotlist(cfg: dict, dotlist: list[str]) -> dict:
    """Apply `a.b.c=value` overrides in place."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"cannot override through non-dict at {p!r}")
        node[parts[-1]] = _parse_value(value)
    return cfg


_INTERP = re.compile(r"\$\{([^}]+)\}")


def _lookup(cfg: dict, path: str):
    node: Any = cfg
    for p in path.split("."):
        node = node[p]
    return node


_INNER = re.compile(r"\$\{([^${}]+)\}")  # innermost (no nested braces)


def resolve_interpolations(cfg: dict) -> dict:
    """Resolve ${a.b} references and ${rmspace:...,_} style resolvers,
    including NESTED forms like ${rmspace:${system.prompt},_} —
    innermost expressions resolve first."""

    def resolve(value):
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v) for v in value]
        if not isinstance(value, str):
            return value
        for _ in range(20):
            m = _INNER.search(value)
            if m is None:
                return value
            expr = m.group(1)
            if expr.startswith("rmspace:"):
                body = expr[len("rmspace:"):]
                text, sep = body.rsplit(",", 1)
                out = re.sub(r"\s+", sep, text.strip())
            else:
                out = str(resolve(_lookup(cfg, expr)))
            value = value[: m.start()] + out + value[m.end() :]
        raise ValueError(f"interpolation recursion limit in {value!r}")

    return resolve(cfg)


def load_config(path: str, dotlist: list[str] | None = None) -> dict:
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if dotlist:
        merge_dotlist(cfg, dotlist)
    return resolve_interpolations(cfg)


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "default"
    tag: str = ""
    exp_root_dir: str = "outputs"
    seed: int = 0
    timestamp: str = ""

    def __post_init__(self):
        if not self.timestamp:
            self.timestamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")

    @property
    def trial_dir(self) -> str:
        tag = self.tag or "run"
        return os.path.join(self.exp_root_dir, self.name, f"{tag}@{self.timestamp}")

    def make_dirs(self) -> dict:
        dirs = {
            sub: os.path.join(self.trial_dir, sub)
            for sub in ("ckpts", "save", "configs", "tb_logs", "csv_logs")
        }
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        dirs["trial"] = self.trial_dir
        return dirs
