"""NumPy <-> torch bridge: the one way arrays enter and leave the port.

ugrt's only parameters are the scene arrays (``vertices`` f32 [V, 3],
``faces`` i32 [F, 3], ``mat_index`` i32 [F], ``materials`` f32 [M, 6])
and the packed camera vector ``camcoords`` f32 [64]
(``ugrt.core.camera.camcoords_from_spec``).  Tests feed the same numpy
arrays to ugrt and to the port through these functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt.core import camera as cam


def from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> torch tensor on ``device`` (a copy)."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def to_numpy(t) -> np.ndarray:
    """torch tensor (any device) -> numpy array."""
    return t.detach().cpu().numpy()


def scene_to_torch(scene, device="cpu") -> dict:
    """A ``ugrt.scene.model.Scene`` as tensors on ``device``."""
    return dict(
        vertices=from_numpy(scene.vertices, device, np.float32),
        faces=from_numpy(scene.faces, device, np.int32),
        mat_index=from_numpy(scene.mat_index, device, np.int32),
        materials=from_numpy(scene.materials, device, np.float32),
    )


def camcoords_to_torch(spec: cam.CameraSpec, fovy_deg: float,
                       aspect: float, device="cpu") -> torch.Tensor:
    """The packed camcoords[64] of a camera spec, f32 on ``device``.

    The matrices are computed on the host in numpy by ugrt's own
    GL-faithful camera code, exactly as ugrt does."""
    return from_numpy(cam.camcoords_from_spec(spec, fovy_deg, aspect),
                      device, np.float32)
