"""One rank of a gloo process group on the CPU, for tests/test_torch_dist.py
and tests/test_torch_mesh_programs.py (or, with ``"backend": "nccl"`` in
the spec, of an NCCL group on card ``cuda:<RANK>``, for
tests/test_torch_cuda.py).

    python tests/torch_dist_worker.py DIR RANK WORLD_SIZE

Joins the group through a FileStore in DIR (no TCP port), reads the
tasks from DIR/spec.json and their arrays from DIR/inputs.npz, runs them
through ``ugrt_torch.dist.mesh`` (its Programs, and for the program
tasks their eager bodies beside them) and ``ugrt_torch.api.train``, and
writes its results to DIR/rank<RANK>.npz.  It imports only torch, numpy
and ugrt_torch (``ugrt_torch`` must be on PYTHONPATH), never
tests/conftest.py, which imports JAX, and holds torch at one thread.
"""

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ugrt_torch import config
from ugrt_torch.api import checkpoint, profiler
from ugrt_torch.api import train as tmod
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.diff.render_grad import render_and_grad
from ugrt_torch.dist import mesh as dmesh
from ugrt_torch.scene.model import Scene

SCENE_KEYS = ("vertices", "materials", "faces", "mat_index")
FRAME_KEYS = (*SCENE_KEYS, "camcoords", "light_camcoords", "light_position")


def render_config(fields):
    return config.RenderConfig(**{**fields, "quirks": config.QuirkConfig(
        **fields["quirks"])})


def run_task(task, arrays, mesh, out):
    cfg = render_config(task["cfg"])
    if task["name"] == "train":
        train_runs(task, arrays, cfg, out)
        return
    if task["name"] == "psum_overlap":
        psum_overlap(task, arrays, mesh, cfg, out)
        return
    if task["name"] in PROGRAMS:
        program_runs(task, arrays, mesh, cfg, out)
        return
    if task["name"] in MESH_TASKS:
        MESH_TASKS[task["name"]](task, arrays, mesh, cfg, out)
        return
    a = {k: torch.from_numpy(arrays[f"{task['inputs']}/{k}"])
         for k in (*FRAME_KEYS, "target") if f"{task['inputs']}/{k}" in arrays}
    kw = dict(cfg=cfg, capacity=task["capacity"], num_lights=1,
              use_spot=task["use_spot"])
    key = task["key"]
    if task["name"] == "render":
        image, overflow = dmesh.sharded_render(mesh, **kw)(
            *(a[k] for k in FRAME_KEYS))
        out[f"{key}/image"] = image.numpy()
        out[f"{key}/overflow"] = overflow.numpy()
    else:
        loss, gv, gm, overflow = dmesh.sharded_train_step(mesh, **kw)(
            *(a[k] for k in FRAME_KEYS), a["target"])
        for name, x in (("loss", loss), ("grad_vertices", gv),
                        ("grad_materials", gm), ("overflow", overflow)):
            out[f"{key}/{name}"] = x.numpy()


# The sharded entry points' Programs: (maker, tensor arguments, results).
PROGRAMS = {
    "program_render": (dmesh.sharded_render, FRAME_KEYS,
                       ("image", "overflow")),
    "program_step": (dmesh.sharded_train_step, (*FRAME_KEYS, "target"),
                     ("loss", "grad_vertices", "grad_materials",
                      "overflow")),
}


def program_runs(task, arrays, mesh, cfg, out):
    """One Program of dist.mesh against its eager body (.fn), input by
    input: task["variants"] each replace some of the inputs' arrays by
    others (key -> array name).  Writes both results and the Program's
    key count after each input."""
    make, names, results = PROGRAMS[task["name"]]
    prog = make(mesh, cfg=cfg, capacity=task["capacity"], num_lights=1,
                use_spot=task["use_spot"])
    for i, variant in enumerate(task["variants"]):
        args = [torch.from_numpy(arrays[variant.get(
            k, f"{task['inputs']}/{k}")]) for k in names]
        got, want = prog(*args), prog.fn(*args)
        for name, g, w in zip(results, got, want):
            out[f"{task['key']}/{i}/program/{name}"] = g.numpy()
            out[f"{task['key']}/{i}/eager/{name}"] = w.numpy()
        out[f"{task['key']}/{i}/keys"] = np.asarray(prog.cache_size())


def train_runs(task, arrays, cfg, out):
    """Two train(use_mesh=True) runs on one checkpoint directory (the
    second resumes the first); counts this rank's checkpoint writes."""
    p = task["inputs"]
    scene = Scene(**{k: arrays[f"{p}/{k}"] for k in SCENE_KEYS})
    saves = []
    save = checkpoint.save_checkpoint

    def counted(*args, **kwargs):
        saves.append(args[2] if len(args) > 2 else kwargs["step"])
        return save(*args, **kwargs)

    checkpoint.save_checkpoint = counted
    try:
        for i, steps in enumerate(task["steps"]):
            tcfg = tmod.TrainConfig(**{**task["train"], "steps": steps})
            verts, mats, log = tmod.train(
                scene, [CameraSpec(**task["camera"])],
                CameraSpec(**task["light"]), task["light"]["eye"],
                [arrays[f"{p}/target"]], cfg, tcfg, verbose=False,
                device="cpu")
            out[f"{task['key']}/log{i}"] = np.asarray(log)
    finally:
        checkpoint.save_checkpoint = save
    out[f"{task['key']}/vertices"] = verts.numpy()
    out[f"{task['key']}/materials"] = mats.numpy()
    out[f"{task['key']}/saves"] = np.asarray(saves, dtype=np.int64)
    out[f"{task['key']}/latest"] = np.asarray(
        checkpoint.latest_step(task["train"]["checkpoint_dir"]))


def kept_programs(task, arrays, mesh, cfg, out):
    """dist.mesh's kept Programs: over two Meshes of the group, equal
    statics give the same step and frame Program; another statics value,
    or the other entry point, another Program; after ``clear()``, and
    after ``render_and_grad.clear()``, a new one.  Writes the seven
    checks in that order."""
    kw = dict(cfg=cfg, capacity=task["capacity"], num_lights=1,
              use_spot=True)
    other = dmesh.make_mesh(device=mesh.device.type)
    step = dmesh.sharded_train_step(mesh, **kw)
    checks = [
        step is dmesh.sharded_train_step(other, **kw),
        dmesh.sharded_render(mesh, **kw) is dmesh.sharded_render(other,
                                                                 **kw),
        step is not dmesh.sharded_train_step(mesh, **dict(kw,
                                                          use_spot=False)),
        step is not dmesh.sharded_train_step(
            mesh, **dict(kw, capacity=kw["capacity"] + 1)),
        step is not dmesh.sharded_render(mesh, **kw)]
    dmesh.clear()
    again = dmesh.sharded_train_step(mesh, **kw)
    checks.append(step is not again)
    render_and_grad.clear()
    checks.append(again is not dmesh.sharded_train_step(mesh, **kw))
    dmesh.clear()
    out[f"{task['key']}/checks"] = np.asarray(checks)


def traced_steps(task, arrays, mesh, cfg, out):
    """task["steps"] calls of the kept step Program with the recorder on:
    the calls and device calls of ``mesh.allreduce`` and ``mesh.strip``,
    the all-reduces inside a strip, and the counters."""
    a = {k: torch.from_numpy(arrays[f"{task['inputs']}/{k}"]).to(mesh.device)
         for k in (*FRAME_KEYS, "target")}
    step = dmesh.sharded_train_step(mesh, cfg=cfg, capacity=task["capacity"],
                                    num_lights=1, use_spot=True)
    with profiler.tracing(mesh.device) as rec:
        for _ in range(task["steps"]):
            step(*(a[k] for k in (*FRAME_KEYS, "target")))
    key = task["key"]
    totals = rec.totals()
    for name in ("mesh.allreduce", "mesh.strip"):
        t = totals[name]
        out[f"{key}/{name}/calls"] = np.asarray(t.calls)
        out[f"{key}/{name}/device_calls"] = np.asarray(t.device_calls)
    out[f"{key}/in_strip"] = np.asarray(sum(
        s.name == "mesh.allreduce" and _inside(s, "mesh.strip")
        for s in rec.spans))
    for name in ("mesh.collectives", "mesh.allreduce_bytes"):
        out[f"{key}/{name}"] = np.asarray(rec.counts[name])


def _inside(span, name):
    """Whether a span named ``name`` encloses ``span``."""
    p = span.parent
    while p is not None and p.name != name:
        p = p.parent
    return p is not None


def train_jobs(task, arrays, mesh, cfg, out):
    """The train(use_mesh=True) jobs of task["jobs"] (TrainConfig fields
    each) one after another in this process, the recorder on: each job's
    losses and parameters, and after each job the count of
    ``program.captures`` and the kept step Program's keys (none kept
    before the first); and whether every job ran the same kept
    Program."""
    dmesh.clear()
    p = task["inputs"]
    scene = Scene(**{k: arrays[f"{p}/{k}"] for k in SCENE_KEYS})
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    key, programs = task["key"], []
    with profiler.tracing(mesh.device) as rec:
        for i, job in enumerate(task["jobs"]):
            verts, mats, log = tmod.train(
                scene, [CameraSpec(**task["camera"])],
                CameraSpec(**task["light"]), task["light"]["eye"],
                [arrays[f"{p}/target"]], cfg,
                tmod.TrainConfig(**job, use_mesh=True), verbose=False,
                device=mesh.device.type)
            programs.append(dmesh.sharded_train_step(mesh, **kw))
            out[f"{key}/{i}/log"] = np.asarray(log)
            out[f"{key}/{i}/vertices"] = verts.cpu().numpy()
            out[f"{key}/{i}/materials"] = mats.cpu().numpy()
            out[f"{key}/{i}/captures"] = np.asarray(
                rec.counts.get("program.captures", 0))
            out[f"{key}/{i}/keys"] = np.asarray(programs[-1].cache_size())
    out[f"{key}/same"] = np.asarray(all(x is programs[0] for x in programs))
    dmesh.clear()


MESH_TASKS = {"kept_programs": kept_programs, "traced_steps": traced_steps,
              "train_jobs": train_jobs}


def psum_overlap(task, arrays, mesh, cfg, out):
    """micro.trace_psum_overlap.run on the scene of task["inputs"] with
    the script's Cornell camera and light; writes this rank's report."""
    from ugrt_torch.micro import trace_psum_overlap as tpo

    p = task["inputs"]
    scene = Scene(**{k: arrays[f"{p}/{k}"] for k in SCENE_KEYS})
    r = tpo.run(mesh, cfg, scene, task["out_dir"], camera=tpo.CORNELL_CAMERA,
                light=tpo.CORNELL_LIGHT)
    key = task["key"]
    out[f"{key}/all_reduces"] = np.asarray(r["all_reduces"])
    out[f"{key}/span_ms"] = np.asarray([r["span_ms"], r["rank_span_ms"]])
    out[f"{key}/shares"] = np.asarray(
        [r["overlap_share"]] + [x for e in r["top"]
                                for x in (e["start"], e["end"])])
    out[f"{key}/loss"] = np.asarray(r["loss"])


def main(argv):
    d, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    with open(os.path.join(d, "spec.json")) as fh:
        spec = json.load(fh)
    store = dist.FileStore(os.path.join(d, "store"), world)
    backend = spec.get("backend", "gloo")
    device = "cuda" if backend == "nccl" else "cpu"
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout_s"]),
        device_id=torch.device("cuda", rank) if device == "cuda" else None)
    try:
        mesh = dmesh.make_mesh(device=device)
        assert (mesh.rank, mesh.world_size) == (rank, world)
        with np.load(os.path.join(d, "inputs.npz")) as f:
            arrays = dict(f)
        out = {}
        for task in spec["tasks"]:
            run_task(task, arrays, mesh, out)
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    finally:
        dmesh.clear()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
