"""Runs a cell of several cards: one process a card, spawned here.

Each rank is a spawned process (``multiprocessing``'s "spawn") on card
``cuda:<rank>`` (``LOCAL_RANK`` set for the program's ``make_mesh``),
in one NCCL group whose rendezvous is a ``FileStore`` in a directory
made under ``TMPDIR`` and removed at the end.  NCCL is kept out of
``/dev/shm`` (``NCCL_SHM_DISABLE=1``); peer-to-peer transfers over
NVLink stay on.  Every rank runs the same driver with the group's
``dist.mesh.Mesh``; times are the slowest rank's, ``memory_peak_bytes``
the fullest card's, and rank 0 alone runs the reference check after
the window and the per-layer stages.  A rank that fails fails every
step of the window; ranks still running after ``JOIN_S`` are killed.

On the CPU the same launcher runs gloo ranks (``device="cpu"``), which
is how the tests exercise it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

JOIN_S = 300


def _env(rank: int, world: int) -> None:
    os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank),
                      WORLD_SIZE=str(world), NCCL_SHM_DISABLE="1")


def _worker(rank, world, root, name, seed, seconds, trace, device_type,
            store_dir, out, mode, t_start, fault):
    """One rank: set-up, window, (traced) stages, rank 0's check; its
    report goes to ``out``.  ``fault``: a ``faults`` name planted in
    this rank (tests and calibration only)."""
    _env(rank, world)
    from benchmark import host
    host.steady_allocator()
    import datetime

    import torch
    import torch.distributed as dist

    from benchmark import drivers, registry
    report = dict(rank=rank, ok=False)
    try:
        cell = registry.load(root).cell(name)
        if device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            backend, device_id = "nccl", device
        else:
            torch.set_num_threads(2)
            device, backend, device_id = torch.device("cpu"), "gloo", None
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, device_id=device_id,
                                timeout=datetime.timedelta(seconds=120))
        try:
            from ugrt_torch.dist import mesh as dmesh
            mesh = dmesh.make_mesh(device=device_type)
            driver = drivers.make(cell, seed, mesh.device, mesh=mesh)
            if fault is not None:
                import contextlib

                from benchmark import faults
                stack = contextlib.ExitStack()
                stack.enter_context(faults.plant("train_sharded", fault))
            if mode == "profile":
                from benchmark import profiler_child
                report.update(profiler_child.profile_rank(driver))
            else:
                report.update(_run_rank(driver, cell, seconds, trace,
                                        t_start, device_type,
                                        control=mode == "calibrate"))
            dist.barrier()
        finally:
            from ugrt_torch.diff.render_grad import render_and_grad
            render_and_grad.clear()
            dist.destroy_process_group()
        report["ok"] = True
    except Exception:           # the rank's failure is the parent's to report
        report["error"] = traceback.format_exc()[-2000:]
    out.put(report)


def _run_rank(driver, cell, seconds, trace, t_start, device_type,
              control=False) -> dict:
    import torch

    from benchmark import drivers, harness, registry
    driver.setup(seconds)
    drivers.sync(driver.device)
    rep = dict(window_start=time.perf_counter())
    window = driver.window(seconds)
    rep.update(window=window._asdict(),
               peak=(torch.cuda.max_memory_allocated(driver.device)
                     if device_type == "cuda" else 0))
    if trace:
        e2e = harness.end_to_end(cell, window)
        ctx = harness.Layers(driver, window, e2e)
        for m in cell.per_layer:
            registry.metric_reader(m["name"])(ctx)
        rep["stages"] = dict(ctx.stages.cache)
    driver.free()
    if driver.mesh.rank == 0:
        rep["numbers"] = driver.check()
        if control:
            rep["control"] = driver.check(lowp=torch.bfloat16)
    return rep


def spawn(world, root, name, seed, seconds, trace, device_type, mode,
          t_start, fault=None) -> list:
    """Every rank's report (a rank that sent none gets an error
    report)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    store_dir = tempfile.mkdtemp(prefix="bench_store_", dir=base)
    procs = [ctx.Process(target=_worker, args=(
        r, world, root, name, seed, seconds, trace, device_type, store_dir,
        out, mode, t_start, fault)) for r in range(world)]
    reports = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_S
        while len(reports) < world and time.monotonic() < deadline:
            try:
                rep = out.get(timeout=1.0)
            except queue_mod.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            reports[rep["rank"]] = rep
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(store_dir, ignore_errors=True)
    return [reports.get(r, dict(rank=r, ok=False, error="no report"))
            for r in range(world)]


def run(cell, name, seed, seconds, trace, t_start, *, root=None,
        device_type="cuda", fault=None):
    """(result object, stderr lines) of one run of a several-card
    ``cell`` (``run.py``'s line)."""
    from benchmark import check, harness, registry
    root = root or registry.ROOT
    reports = spawn(cell.chips, root, name, seed, seconds, trace,
                    device_type, "run", t_start, fault)
    bad = [r for r in reports if not r["ok"]]
    notes = [f"rank {r['rank']} failed: {r.get('error', '')}" for r in bad]
    limits = cell.config["limits"][cell.traffic["kind"]]
    result = dict(correct=False, attempted=0, failed=0, metrics={},
                  device=dict(platform="gpu" if device_type == "cuda"
                              else "cpu", count=cell.chips))
    windows = [r["window"] for r in reports if r["ok"]]
    attempted = max((w["attempted"] for w in windows), default=0)
    result["attempted"] = attempted
    if bad or not windows:
        result["failed"] = max(attempted, 1)
        numbers = {n: float("inf") for n in limits}
    else:
        slow = max(windows, key=lambda w: w["window_s"])
        result["failed"] = max(w["failed"] for w in windows)
        from benchmark.drivers import WindowResult
        window = WindowResult(**slow)
        e2e = harness.end_to_end(cell, window)
        if trace:
            stages = {}
            for r in reports:
                for k, v in r.get("stages", {}).items():
                    stages[k] = max(stages.get(k, v), v)
            ctx = _Reduced(window, e2e, stages)
            result["metrics"] = harness.per_layer(cell, ctx, notes)
            fallback = harness.busy_from_events(cell, ctx)
        else:
            e2e["setup_s"] = max(r["window_start"] for r in reports) - t_start
            units = {m["name"]: m["unit"] for m in cell.end_to_end}
            result["metrics"] = {k: dict(value=v, unit=units[k])
                                 for k, v in e2e.items() if k in units}
        numbers = reports[0]["numbers"]
        notes.append(f"window: {attempted} attempted, {result['failed']} "
                     f"failed; slowest rank {slow['window_s']:.6f} s")
    peak = max((r.get("peak", 0) for r in reports), default=0)
    if device_type == "cuda":
        import torch
        result["device"].update(kind=torch.cuda.get_device_name(0),
                                memory_peak_bytes=int(peak))
    else:
        result["device"].update(kind="cpu", memory_peak_bytes=0)
    if trace and not bad:
        from benchmark import profiler_child
        prof = profiler_child.run_child(name, seed, notes)
        if prof is None:
            notes.append("busy_s and window_s from events, not a trace")
            result["device"].update(fallback)
        else:
            result["device"].update(busy_s=prof["busy_s"],
                                    window_s=prof["window_s"])
            result["breakdown"] = prof["breakdown"]
    result["correct"] = bool(check.verdict(numbers, limits)
                             and result["failed"] == 0)
    comp, lines = harness.compared_lines(numbers, limits)
    result["compared"] = comp
    for n in notes:
        print(n, flush=True)
    return result, lines


class _Reduced:
    """A per-layer reader's context over several ranks: the slowest
    rank's window and each stage's slowest time."""

    def __init__(self, window, e2e, stages):
        self.window, self.e2e, self.stages = window, e2e, stages
        self.driver = None

    def stage_ms(self, name: str) -> float:
        return self.stages[name]
