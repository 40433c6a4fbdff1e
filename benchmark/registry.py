"""Finds what ``BENCHMARK.json`` names: each cell's configuration file,
its traffic file (``traffic/<traffic>.json``), each per-layer metric's
reader (``metrics/<metric name>.py``) and the scene generator that a
configuration names (``scenes/<generator>.py``), all by name.

A later cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``; nothing here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    """One entry of ``workloads`` with what it names, loaded."""

    name: str
    chips: int
    config: dict          # the configuration file's object
    traffic: dict         # the traffic file's object
    end_to_end: list      # the metric entries this cell reports
    per_layer: list


class Bench(NamedTuple):
    root: str
    spec: dict

    def cell(self, name: str) -> Cell:
        """The cell ``name`` with its files loaded; KeyError if unknown."""
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have: {', '.join(by_name)})")
        w = by_name[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        config = load_json(os.path.join(self.root,
                                        configs[w["config"]]["file"]))
        traffic = load_json(traffic_path(self.root, w["traffic"]))

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        return Cell(name, int(w["chips"]), config, traffic,
                    [m for m in self.spec["end_to_end"] if mine(m)],
                    [m for m in self.spec["per_layer"] if mine(m)])


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str) -> Bench:
    """``root``/BENCHMARK.json."""
    return Bench(root, load_json(os.path.join(root, "BENCHMARK.json")))


def traffic_path(root: str, traffic: str) -> str:
    return os.path.join(root, "benchmark", "traffic", f"{traffic}.json")


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def scene_path(generator: str) -> str:
    return os.path.join(HERE, "scenes", f"{generator}.py")


def _module(package: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{package}." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return _module("metrics", name, metric_path(name)).read


def scene_builder(generator: str):
    """The ``build(params, seed)`` function of ``scenes/<generator>.py``."""
    return _module("scenes", generator, scene_path(generator)).build
