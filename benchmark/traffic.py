"""The one traffic generator: everything a cell sends, made from
``--seed`` and the parameters of its traffic file (``traffic/*.json``).

A traffic file states its ``kind`` ("train": inverse rendering over a
camera path; "frames": the dynamic-scene frame loop) and the ranges
drawn from.  The generator gives every seed the same sizes and counts;
the seed moves only the values: the scene's own seeded values
(``scene.generate``), camera poses, the target scene and column angles.

- Views: ``views`` cameras, each eye uniform in the ball of
  ``eye_radius`` about ``eye_center``, each look-at uniform in the ball
  of ``look_radius`` about ``look_center``; ``up``, ``near``, ``far``
  fixed.
- Targets ("train"): the scene as inverse rendering would find it, one
  image [H, W, 3] per view rendered by the reference
  (``reference.frame.render_color``: one light, spot shading, the
  configuration's lights and settings) from perturbed vertices and
  materials.  The vertices move by a smooth field: per axis
  ``target_waves`` plane waves across the scene's bounding box, each of
  1 to ``target_max_frequency`` cycles along each axis (signs drawn),
  random phase, amplitudes that sum to ``target_vertex_offset`` (scene
  units).  Each material value is scaled by a factor uniform in
  ``target_material_scale`` and clipped to [0, 1].  Made on the run's
  device.
- Training's job: ``rate_steps``, the length of the set-up's timed job
  whose step rate fixes the window's one job; ``checkpoint_every``
  (null: none), the interval at which ``train()`` saves a checkpoint,
  into a fresh folder of the run's ``TMPDIR``.
- Vertex frames ("frames"): ``vertex_frames`` copies of the scene's
  vertices, each column turned about its own vertical axis by an angle
  uniform in ``column_angle`` (radians), drawn per frame and column.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import scene as bscene

_MASK64 = (1 << 64) - 1


class View(NamedTuple):
    """A camera as the program's ``CameraSpec`` takes it."""

    eye: tuple
    look_at: tuple
    up: tuple
    near: float
    far: float


class Traffic(NamedTuple):
    """What one run of a cell sends: the scene, its views and, by kind,
    the targets or the vertex frames."""

    scene: bscene.Scene
    views: list
    targets: list           # [H, W, 3] f32 tensors ("train")
    vertex_frames: list     # [V, 3] f32 arrays ("frames")


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """Independent streams of one seed (any int, negative or past 64
    bits included)."""
    return np.random.SeedSequence([seed & _MASK64, (seed >> 64) & _MASK64,
                                   int(seed < 0), stream])


def _ball(rng, center, radius, n):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * rng.random(n) ** (1.0 / 3.0)
    return np.asarray(center, dtype=np.float64)[None] + d * r[:, None]


def views(params: dict, seed: int, n: int) -> list:
    """``n`` cameras drawn from the file's ranges (module docstring)."""
    rng = np.random.default_rng(seed_sequence(seed, 1))
    eyes = _ball(rng, params["eye_center"], params["eye_radius"], n)
    looks = _ball(rng, params["look_center"], params["look_radius"], n)
    return [View(tuple(float(x) for x in e), tuple(float(x) for x in lk),
                 tuple(float(x) for x in params["up"]),
                 float(params["near"]), float(params["far"]))
            for e, lk in zip(eyes, looks)]


def target_scene(params: dict, seed: int, sc: bscene.Scene) -> tuple:
    """(vertices, materials) of the scene that the targets show (module
    docstring), float32 arrays."""
    rng = np.random.default_rng(seed_sequence(seed, 2))
    lo = sc.vertices.min(axis=0).astype(np.float64)
    ext = np.maximum(sc.vertices.max(axis=0) - lo, 1e-6)
    pos = (sc.vertices - lo) / ext
    waves = int(params["target_waves"])
    fmax = int(params["target_max_frequency"])
    offset = np.zeros(sc.vertices.shape, dtype=np.float64)
    for axis in range(3):
        amp = rng.random(waves)
        amp = float(params["target_vertex_offset"]) * amp / amp.sum()
        freq = (rng.integers(1, fmax + 1, size=(waves, 3))
                * rng.choice([-1, 1], size=(waves, 3)))
        phase = 2 * math.pi * rng.random(waves)
        offset[:, axis] = (amp[None] * np.sin(
            2 * math.pi * pos @ freq.T + phase[None])).sum(axis=1)
    lo_s, hi_s = params["target_material_scale"]
    mats = np.clip(sc.materials * rng.uniform(lo_s, hi_s,
                                              size=sc.materials.shape),
                   0.0, 1.0)
    return ((sc.vertices + offset).astype(np.float32),
            mats.astype(np.float32))


def targets(params: dict, config: dict, seed: int, sc: bscene.Scene,
            cams: list, device) -> list:
    """One target image per view of ``cams`` (module docstring), on
    ``device``; raises if the reference's grids overflow on one."""
    from benchmark import frame_call
    from benchmark.reference import frame as rframe
    verts, mats = target_scene(params, seed, sc)
    cfg = frame_call.reference_config(config)
    fc = frame_call.of(config)
    aspect = fc.step_aspect
    v = torch.from_numpy(verts).to(device)
    m = torch.from_numpy(mats).to(device)
    f = torch.from_numpy(sc.faces).to(device)
    mi = torch.from_numpy(sc.mat_index).to(device)
    lcc = fc.light_camcoords(cfg.fovy_deg, device, aspect)[:1]
    lp = fc.light_position_tensor(device)
    kw = fc.step_kwargs(cfg, cfg.pair_capacity(sc.faces.shape[0]))
    out = []
    with torch.no_grad():
        for view in cams:
            cc = fc.camcoords(view, cfg.fovy_deg, device, aspect)
            color, overflow = rframe.render_color(v, m, f, mi, cc, lcc, lp,
                                                  **kw)
            if bool(overflow):
                raise RuntimeError("a target's grids overflow: the target "
                                   "scene is outside the capacities")
            out.append(color.contiguous())
    return out


def vertex_frames(params: dict, seed: int, scene: bscene.Scene,
                  n: int) -> list:
    """``n`` animated copies of the scene's vertices (module
    docstring)."""
    rng = np.random.default_rng(seed_sequence(seed, 3))
    lo, hi = params["column_angle"]
    angles = rng.uniform(lo, hi, size=(n, len(scene.columns)))
    return [bscene.rotate_columns(scene, a) for a in angles]


def generate(traffic: dict, config: dict, seed: int, device) -> Traffic:
    """The whole of one run's traffic for ``--seed``."""
    sc = bscene.generate(config["scene"], seed)
    cams = views(traffic, seed, traffic["views"])
    if traffic["kind"] == "train":
        return Traffic(sc, cams, targets(traffic, config, seed, sc, cams,
                                         device), [])
    if traffic["kind"] == "frames":
        return Traffic(sc, cams, [],
                       vertex_frames(traffic, seed, sc,
                                     traffic["vertex_frames"]))
    raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
