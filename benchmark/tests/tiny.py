"""A copy of the benchmark at a size the CPU runs in seconds, for the
tests: the same cells, traffic kinds and checks, on a 64x64 image over
an 8x8 grid of a ~7,000-face cathedral, with fewer views."""

from __future__ import annotations

import json
import os

from benchmark import registry

SIZE = dict(screen_width=64, screen_height=64, grid_x=8, grid_y=8)
FACES = 2000


def tiny_root(tmp_path) -> str:
    """A benchmark root under ``tmp_path``: BENCHMARK.json and its files,
    the configurations cut to the tiny size."""
    root = str(tmp_path)
    spec = registry.load(registry.ROOT).spec
    for c in spec["configs"]:
        cfg = registry.load_json(os.path.join(registry.ROOT, c["file"]))
        cfg["render"].update(SIZE)
        cfg["scene"]["num_faces_target"] = FACES
        if "reflect" in cfg:
            cfg["reflect"].update(uniform_dims=[8, 8, 8],
                                  uniform_capacity=1 << 16)
        dst = os.path.join(root, c["file"])
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "w") as f:
            json.dump(cfg, f)
    for w in spec["workloads"]:
        t = registry.load_json(registry.traffic_path(registry.ROOT,
                                                     w["traffic"]))
        t["views"] = 2
        if "vertex_frames" in t:
            t["vertex_frames"] = 2
        if "rate_steps" in t:
            t["rate_steps"] = 4
        dst = registry.traffic_path(root, w["traffic"])
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "w") as f:
            json.dump(t, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
