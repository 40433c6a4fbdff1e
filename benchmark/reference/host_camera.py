"""Frozen copy of ``ugrt_torch/core/host_camera.py`` (lines 1-187), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Pinhole camera matrices on the host, in numpy (the port's copy of
ugrt/core/camera.py:33-158 and the helpers it needs from
ugrt/core/vecmath.py:16-36).

Copied: ``CameraSpec``, ``perspective_matrix``, ``look_at_matrix``,
``mvp_matrix``, ``frustum_planes``, ``frustum_corners`` (with
``_intersect_3_planes``) and ``camcoords_from_spec``, with ``cross``,
``dot`` and ``normalize``, in numpy only (ugrt's ``xp=`` argument is
gone).  The operations and their order are ugrt's, so the packed vector
is bitwise equal to ugrt's (tests/test_torch_isolation.py); the port
keeps its own copy so that it imports nothing of ``ugrt``.

The reference delegates its matrix math to OpenGL (``gluPerspective`` +
``gluLookAt``, camera.h:135-148) and reads the matrices back with
``glGetFloatv`` (camera.h:86-89); these functions reproduce those
matrices in float32, the reference's MVP product (camera.h:150-165),
Gribb–Hartmann plane extraction (camera.h:167-216) and 3-plane corner
intersection (camera.h:218-253).  Matrices are flat [16] float32 in GL
column-major order, so the packed ``camcoords[64]``
(per_frame_funcs.h:18-43) has the layout the kernels index into:

    [0:4]    eye (homogeneous, w=1)
    [4:16]   near frustum corners 0..3 (xyz)
    [16:32]  modelview matrix
    [32:48]  projection matrix
    [48:64]  mvp matrix

The per-pixel ray directions are built on the device by
``ugrt_torch.core.camera.primary_ray_dirs``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Host-side camera definition (mirrors Camera state, camera.h:18-23)."""

    eye: tuple[float, float, float]
    look_at: tuple[float, float, float]
    up: tuple[float, float, float]
    near: float = 0.1
    far: float = 100.0


def cross(a, b):
    """CROSS macro (main.cu.h:44-47)."""
    return np.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def dot(a, b):
    """DOT macro (main.cu.h:49)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(a):
    """NORMALIZE macro (main.cu.h:56): multiply by rsqrt."""
    inv = 1.0 / np.sqrt(dot(a, a))
    return a * inv[..., None]


def perspective_matrix(fovy_deg: float, aspect: float, near: float,
                       far: float):
    """gluPerspective, column-major flat float32."""
    f = 1.0 / math.tan(math.radians(fovy_deg) / 2.0)
    m = np.zeros(16, dtype=np.float32)
    m[0] = np.float32(f / aspect)
    m[5] = np.float32(f)
    m[10] = np.float32((far + near) / (near - far))
    m[11] = np.float32(-1.0)
    m[14] = np.float32(2.0 * far * near / (near - far))
    return m


def look_at_matrix(eye, center, up):
    """gluLookAt, column-major flat float32 (Mesa convention)."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)

    f = normalize(center - eye)
    s = normalize(cross(f, normalize(up)))
    u = cross(s, f)

    m = np.zeros(16, dtype=np.float32)
    # Rotation rows s, u, -f in column-major storage.
    m[0], m[4], m[8] = s
    m[1], m[5], m[9] = u
    m[2], m[6], m[10] = -f
    # Translation: R @ (-eye).
    m[12] = np.float32(-dot(s, eye))
    m[13] = np.float32(-dot(u, eye))
    m[14] = np.float32(dot(f, eye))
    m[15] = np.float32(1.0)
    return m


def mvp_matrix(mv_flat, p_flat):
    """The reference's MVP product (camera.h:150-165).

    mvp[i*4+k] = sum_j mv[i*4+j] * p[j*4+k] over the flat arrays, which for
    column-major storage yields the column-major flat of P @ MV — i.e. the
    true clip transform.
    """
    mv = np.reshape(mv_flat, (4, 4))
    p = np.reshape(p_flat, (4, 4))
    return np.reshape(mv @ p, (16,))


def frustum_planes(mvp_flat):
    """Plane extraction (camera.h:167-216). Returns [6,4] normalized planes.

    Order: left, right, bottom, top, near, far — using the reference's own
    (sign-flipped) labels; only the corner pairing below depends on it.
    """
    m = mvp_flat
    rows = np.stack(
        [
            np.stack([m[3] - m[0], m[7] - m[4], m[11] - m[8], m[15] - m[12]]),
            np.stack([m[3] + m[0], m[7] + m[4], m[11] + m[8], m[15] + m[12]]),
            np.stack([m[3] + m[1], m[7] + m[5], m[11] + m[9], m[15] + m[13]]),
            np.stack([m[3] - m[1], m[7] - m[5], m[11] - m[9], m[15] - m[13]]),
            np.stack([m[3] + m[2], m[7] + m[6], m[11] + m[10], m[15] + m[14]]),
            np.stack([m[3] - m[2], m[7] - m[6], m[11] - m[10], m[15] - m[14]]),
        ]
    )
    norm = np.sqrt(rows[:, 0] ** 2 + rows[:, 1] ** 2 + rows[:, 2] ** 2)
    return rows / norm[:, None]


def _intersect_3_planes(n1, n2, n3):
    """Intersect3Planes (camera.h:218-239)."""
    n1n2 = cross(n1[:3], n2[:3])
    n2n3 = cross(n2[:3], n3[:3])
    n3n1 = cross(n3[:3], n1[:3])
    den = dot(n1[:3], n2n3)
    return -(n1[3] * n2n3 + n2[3] * n3n1 + n3[3] * n1n2) / den


def frustum_corners(planes):
    """Frustum corners 0..7 (camera.h:241-253). [8,3].

    0..3 are the near-plane corners used for ray generation:
    NBL, NBR, NTR, NTL (camera.h:123-133).
    """
    pairs = [
        (0, 2, 4), (1, 2, 4), (1, 3, 4), (0, 3, 4),
        (0, 2, 5), (1, 2, 5), (1, 3, 5), (0, 3, 5),
    ]
    return np.stack(
        [_intersect_3_planes(planes[a], planes[b], planes[c])
         for a, b, c in pairs]
    )


def camcoords_from_spec(spec: CameraSpec, fovy_deg: float, aspect: float):
    """Build the packed camcoords[64] vector for a camera spec."""
    mv = look_at_matrix(spec.eye, spec.look_at, spec.up)
    p = perspective_matrix(fovy_deg, aspect, spec.near, spec.far)
    mvp = mvp_matrix(mv, p)
    planes = frustum_planes(mvp)
    corners = frustum_corners(planes)

    eye = np.asarray(spec.eye, dtype=np.float32)
    cc = np.concatenate(
        [
            eye,
            np.ones(1, dtype=np.float32),
            np.reshape(corners[:4], (12,)),
            mv,
            p,
            mvp,
        ]
    )
    return cc.astype(np.float32)
