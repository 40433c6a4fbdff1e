"""The one way arrays and host objects enter and leave the port.

ugrt's only parameters are the scene arrays (``vertices`` f32 [V, 3],
``faces`` i32 [F, 3], ``mat_index`` i32 [F], ``materials`` f32 [M, 6])
and the packed camera vector ``camcoords`` f32 [64]
(``ugrt_torch.core.host_camera.camcoords_from_spec``).  Tests feed the
same numpy arrays to ugrt and to the port through these functions, and
hand ugrt's host objects (render config, camera spec, scene) to the port
through ``render_config``, ``camera_spec`` and ``scene``, which copy the
fields by name: this module imports nothing of ``ugrt``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ugrt_torch import config
from ugrt_torch.api import profiler
from ugrt_torch.core import host_camera
from ugrt_torch.scene import model


def _fields(cls, obj, **convert) -> dict:
    return {f.name: convert.get(f.name, lambda x: x)(getattr(obj, f.name))
            for f in dataclasses.fields(cls)}


def render_config(obj) -> config.RenderConfig:
    """The port's RenderConfig with the fields of ``obj`` (any object with
    RenderConfig's fields, its ``quirks`` with QuirkConfig's)."""
    return config.RenderConfig(**_fields(
        config.RenderConfig, obj,
        quirks=lambda q: config.QuirkConfig(**_fields(config.QuirkConfig,
                                                      q))))


def camera_spec(obj) -> host_camera.CameraSpec:
    """The port's CameraSpec with the fields of ``obj``."""
    return host_camera.CameraSpec(**_fields(host_camera.CameraSpec, obj))


def scene(obj) -> model.Scene:
    """The port's Scene with the arrays of ``obj``."""
    return model.Scene(**_fields(model.Scene, obj))


def from_numpy(a, device, dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> torch tensor on ``device`` (a copy)."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def to_numpy(t) -> np.ndarray:
    """torch tensor (any device) -> numpy array."""
    return t.detach().cpu().numpy()


def scene_to_torch(scene, device) -> dict:
    """A scene's arrays as tensors on ``device``."""
    return dict(
        vertices=from_numpy(scene.vertices, device, np.float32),
        faces=from_numpy(scene.faces, device, np.int32),
        mat_index=from_numpy(scene.mat_index, device, np.int32),
        materials=from_numpy(scene.materials, device, np.float32),
    )


def camcoords_to_torch(spec, fovy_deg: float, aspect: float,
                       device) -> torch.Tensor:
    """The packed camcoords[64] of a camera spec, f32 on ``device``.

    The matrices are computed on the host in numpy by the GL-faithful
    camera code (``core.host_camera``), exactly as ugrt does (the span
    ``bridge.camera``: the matrices and their upload)."""
    with profiler.span("bridge.camera"):
        return from_numpy(host_camera.camcoords_from_spec(
            spec, fovy_deg, aspect), device, np.float32)
