"""The readers of the program's own spans (``benchmark/spans.py``) on
the CPU at the tiny size: after a tiny cell's window each new reader
returns a positive float from one traced loop, the recorder is off
again, and the check still reads ``correct``; a program without the
recorder gives every reader None.

    python -m pytest benchmark/tests/test_spans.py -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark import check, drivers, harness, registry, spans
from benchmark.tests import tiny

SPEC = registry.load(registry.ROOT).spec
ONE_CARD = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]
SPAN_METRICS = ("upload_ms", "camera_ms", "dispatch_ms.frame",
                "replay_ms.frame", "grid_ms.loop", "primary_ms.loop",
                "shadow_ms.loop", "reflect_ms.loop", "dispatch_ms.train",
                "launch_ms.train", "replay_ms.train", "backward_ms.loop",
                "adam_ms")


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return registry.load(tiny.tiny_root(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _window(bench, name, seed):
    cell = bench.cell(name)
    d = drivers.make(cell, seed, "cpu")
    d.setup(0.1)
    w = d.window(0.3)
    return cell, d, harness.Layers(d, w, harness.end_to_end(cell, w))


def test_every_span_metric_is_in_the_benchmark():
    names = {m["name"]: m for m in SPEC["per_layer"]}
    for n in SPAN_METRICS:
        assert n in names and names[n]["unit"] == "ms"
        assert names[n]["better"] == "lower"


@pytest.mark.parametrize("name", ONE_CARD)
def test_span_readers_read_one_loop_and_keep_the_check(tiny_bench, name):
    from ugrt_torch.api import profiler
    cell, d, ctx = _window(tiny_bench, name, 2**31 + 17)
    kept = getattr(d, "kept", None)
    mine = [m["name"] for m in cell.per_layer if m["name"] in SPAN_METRICS]
    assert len(mine) == {"train": 5, "frames": 7}[cell.traffic["kind"]] + (
        1 if d.cell.config.get("frame") == "reflective" else 0)
    values = {}
    for n in mine:
        values[n] = registry.metric_reader(n)(ctx)
        assert isinstance(values[n], float) and values[n] > 0, n
        assert not profiler.recording()
    lp = spans.loop(ctx)
    assert lp is ctx._spans and lp.count > 0
    if cell.traffic["kind"] == "frames":
        assert d.kept is kept
        assert values["replay_ms.frame"] >= values["primary_ms.loop"]
    else:
        assert values["launch_ms.train"] <= values["dispatch_ms.train"]
        assert values["backward_ms.loop"] < values["replay_ms.train"]
    d.free()
    limits = cell.config["limits"][cell.traffic["kind"]]
    numbers = d.check()
    assert check.verdict(numbers, limits), numbers


def test_a_program_without_the_recorder_reads_nothing(tiny_bench,
                                                      monkeypatch):
    from ugrt_torch.api import profiler
    name = "sibenik75k.dynamic-frames"
    cell, d, ctx = _window(tiny_bench, name, 5)
    monkeypatch.delattr(profiler, "tracing")
    for m in cell.per_layer:
        if m["name"] in SPAN_METRICS:
            assert registry.metric_reader(m["name"])(ctx) is None
    d.free()
