"""dist.mesh's kept Programs, spans and counters on gloo worlds of 2 CPU
ranks (tests/torch_dist_worker.py, as tests/test_torch_dist.py runs
them), and the four-card benchmark configuration against the one-card
one.

- The Programs: equal statics over two Meshes of one group give one
  Program; other statics or the other entry point another; ``clear()``
  and ``render_and_grad.clear()`` drop them.  Two
  ``train(use_mesh=True)`` jobs in one process run one kept Program and
  give bit for bit the losses and parameters of each job run alone in a
  fresh world.
- The recorder over the sharded step: one ``mesh.allreduce`` span per
  all-reduce (loss, both gradients and the overflow vote; in "windowed"
  mode the light window's four bounds, in "extent" mode its two
  extents, inside the strip), one ``mesh.strip`` a step, and the
  counters ``mesh.collectives`` and ``mesh.allreduce_bytes`` equal to
  the counts and float32 / int32 bytes of those tensors, from the
  scene's vertex and material shapes.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from test_torch_dist import _cfg_fields, _frame_arrays, _run_world, _spec
from test_torch_train import LR, _triangle_case
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACED_STEPS = 2
JOBS = (dict(learning_rate=LR, steps=3),
        dict(learning_rate=LR / 2, steps=4))
# All-reduces a step beside the loss, the gradients and the overflow
# vote, inside the strip: the light window's bounds or extents.
STRIP_REDUCES = {"reference": 0, "windowed": 4, "extent": 2}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, tiny_cfg, cornell, generic_camera,
           generic_light):
    """{world name: [rank results]} of three worlds of 2 ranks: "both"
    (the Program checks, the traced steps in each light-grid mode, then
    both jobs in turn), "first" and "second" (one job each); and the
    step's inputs."""
    tiny = _frame_arrays(tiny_cfg, cornell, generic_camera, generic_light)
    tiny["target"] = np.random.default_rng(1).uniform(
        0.0, 0.3, (tiny_cfg.screen_height, tiny_cfg.screen_width,
                   3)).astype(np.float32)
    arrays = {f"tiny/{k}": v for k, v in tiny.items()}
    sc, spec, light, target = _triangle_case(tiny_cfg)
    arrays.update({f"tri/{k}": getattr(sc, k) for k in (
        "vertices", "materials", "faces", "mat_index")})
    arrays["tri/target"] = target
    cap = tiny_cfg.pair_capacity(cornell.num_faces)

    def jobs(key, which):
        return dict(name="train_jobs", key=key, inputs="tri",
                    cfg=_cfg_fields(tiny_cfg), camera=_spec(spec),
                    light=_spec(light), jobs=[JOBS[i] for i in which])

    traced = [dict(name="traced_steps", key=f"traced_{mode}", inputs="tiny",
                   cfg=_cfg_fields(dataclasses.replace(
                       tiny_cfg, light_grid_mode=mode)),
                   capacity=cap, steps=TRACED_STEPS)
              for mode in STRIP_REDUCES]
    specs = {"both": [dict(name="kept_programs", key="kept",
                           cfg=_cfg_fields(tiny_cfg), capacity=cap),
                      *traced, jobs("jobs", (0, 1))],
             "first": [jobs("jobs", (0,))],
             "second": [jobs("jobs", (1,))]}
    out = {}
    for name, tasks in specs.items():
        d = tmp_path_factory.mktemp(name)
        out[name] = _run_world(d / "run", 2, dict(tasks=tasks), arrays)
    return out, tiny


def test_kept_programs_per_group_and_statics(worlds):
    for r in worlds[0]["both"]:
        assert list(r["kept/checks"]) == [True] * 7


def test_second_job_replays_the_kept_program(worlds):
    """Both jobs in one process ran one kept Program of one key, and
    each gave the losses and parameters of the same job alone in a fresh
    world, bit for bit, on every rank."""
    out = worlds[0]
    for rank in (0, 1):
        both = out["both"][rank]
        assert bool(both["jobs/same"])
        assert [int(both[f"jobs/{i}/keys"]) for i in (0, 1)] == [1, 1]
        for i, alone in ((0, out["first"][rank]), (1, out["second"][rank])):
            assert len(both[f"jobs/{i}/log"]) == JOBS[i]["steps"]
            for res in ("log", "vertices", "materials"):
                np.testing.assert_array_equal(
                    both[f"jobs/{i}/{res}"], alone[f"jobs/0/{res}"],
                    err_msg=f"job {i}: {res}")
        assert not np.array_equal(both["jobs/0/materials"],
                                  both["jobs/1/materials"])
    for key in ("jobs/0/log", "jobs/1/log", "jobs/1/materials"):
        np.testing.assert_array_equal(out["both"][0][key],
                                      out["both"][1][key])


@pytest.mark.parametrize("mode", sorted(STRIP_REDUCES))
def test_sharded_step_spans_and_counters(worlds, mode):
    out, tiny = worlds
    n_v, n_m = tiny["vertices"].shape[0], tiny["materials"].size
    inside = STRIP_REDUCES[mode]
    per_step = 4 + inside
    # f32 loss, f32 gradients, the int32 overflow vote, f32 bounds.
    nbytes = 4 * (1 + 3 * n_v + n_m + 1 + inside)
    key, n = f"traced_{mode}", TRACED_STEPS
    for r in out["both"]:
        assert int(r[f"{key}/mesh.strip/calls"]) == n
        assert int(r[f"{key}/mesh.strip/device_calls"]) == n
        assert int(r[f"{key}/mesh.allreduce/calls"]) == per_step * n
        assert int(r[f"{key}/mesh.allreduce/device_calls"]) == per_step * n
        assert int(r[f"{key}/in_strip"]) == inside * n
        assert int(r[f"{key}/mesh.collectives"]) == per_step * n
        assert int(r[f"{key}/mesh.allreduce_bytes"]) == nbytes * n


def _load(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


def test_four_card_configuration_is_the_one_card_one_sharded():
    """sibenik75k-x4 is sibenik75k's deployment but for its name, its
    text, its source, its cluster and what it assumes (every entry of
    sibenik75k's kept), so the frozen reference applies unchanged; its
    cluster's cards are its cell's chips."""
    spec = _load("BENCHMARK.json")
    configs = {c["name"]: c for c in spec["configs"]}
    one, four = (_load(configs[n]["file"]) for n in ("sibenik75k",
                                                     "sibenik75k-x4"))
    differ = {"name", "deployment", "source", "cluster", "assumed"}
    assert {k: v for k, v in one.items() if k not in differ} == \
        {k: v for k, v in four.items() if k not in differ}
    assert four["name"] == "sibenik75k-x4" and four["reduced"] == []
    assert configs["sibenik75k-x4"]["reduced"] == []
    assert one["assumed"].items() <= four["assumed"].items()
    (cell,) = [w for w in spec["workloads"]
               if w["config"] == "sibenik75k-x4"]
    assert cell["name"] == "sibenik75k-x4.train"
    assert four["cluster"]["cards"] == cell["chips"] == 4
    assert four["cluster"]["columns_per_card"] * cell["chips"] == \
        four["render"]["grid_x"]
