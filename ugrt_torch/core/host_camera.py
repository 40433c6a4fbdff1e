"""Pinhole camera matrices on the host, in numpy (the port's copy of
ugrt/core/camera.py:33-158 and the helpers it needs from
ugrt/core/vecmath.py:16-36).

Copied: ``CameraSpec``, ``perspective_matrix``, ``look_at_matrix``,
``mvp_matrix``, ``frustum_planes``, ``frustum_corners`` (ugrt's
``_intersect_3_planes`` inside it) and ``camcoords_from_spec``, with
``cross``, ``dot`` and ``normalize``, in numpy only (ugrt's ``xp=``
argument is gone).  Each is bitwise equal to ugrt's, the packed vector
included (tests/test_torch_isolation.py, over a thousand seeded
cameras); the port keeps its own copy so that it imports nothing of
``ugrt``.

The camera is evaluated batched: ugrt works scalar by scalar (the 8
corners one at a time, each plane and each cross product a stack of
scalar expressions), which costs a frame ~400 numpy calls on 0-d and
3-element arrays; here the 8 corners, the 6 planes, the rows of the
look-at matrix and each cross product are a few index gathers and
elementwise operations over whole arrays.  The bits are unchanged
because every value is the same chain of elementwise IEEE float32
operations (add, subtract, multiply, divide, sqrt, negate, multiply by
±1), each rounded alike whether numpy applies it to a scalar or to an
array lane: every sum keeps its terms and its order (``dot`` is
``a0*b0 + a1*b1 + a2*b2``, left to right; a plane's norm is
``x**2 + y**2 + z**2``), ``normalize`` is ``1/sqrt`` then a multiply,
and the one product whose order belongs to numpy's BLAS, ``mv @ p`` in
``mvp_matrix``, is the same call as ugrt's.  So do not bring in
``np.dot``, ``@`` (other than the MVP's), ``einsum``, ``np.sum`` or
``np.linalg.norm``: they may sum in another order or fuse operations.

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

# cross: component i is a[_YZX[i]] * b[_ZXY[i]] - a[_ZXY[i]] * b[_YZX[i]].
_YZX = np.array([1, 2, 0])
_ZXY = np.array([2, 0, 1])

# gluLookAt's rotation rows are s, u, -f and its translation is
# (-s.eye, -u.eye, f.eye): signs over the rows (s, u, f).
_ROTATION_SIGN = np.array([1.0, 1.0, -1.0], dtype=np.float32)
_TRANSLATION_SIGN = np.array([-1.0, -1.0, 1.0], dtype=np.float32)

# Plane k of frustum_planes is mvp's w column (flat 3, 7, 11, 15) plus
# _PLANE_SIGN[k] times its x, y or z column: flat indices into mvp, all
# [6, 4] (a small ufunc costs less without broadcasting).
_PLANE_W = np.tile([3, 7, 11, 15], (6, 1))
_PLANE_XYZ = np.array([0, 0, 1, 1, 2, 2])[:, None] + np.array([0, 4, 8, 12])
_PLANE_SIGN = np.repeat(np.array([-1.0, 1.0, 1.0, -1.0, 1.0, -1.0],
                                 dtype=np.float32), 4).reshape(6, 4)


def _corner_gathers():
    """Flat indices into the [6, 4] planes for frustum_corners.

    Corner i meets planes (n1, n2, n3) = triples[i] (Intersect3Planes'
    order).  The three cross products are stacked in the order the
    numerator takes them, X = (n2 x n3, n3 x n1, n1 x n2), each written
    out as left[_YZX] * right[_ZXY] - left[_ZXY] * right[_YZX]."""
    triples = np.array([(0, 2, 4), (1, 2, 4), (1, 3, 4), (0, 3, 4),
                        (0, 2, 5), (1, 2, 5), (1, 3, 5), (0, 3, 5)])
    n = 4 * triples.T[:, :, None]                # [3 (n1, n2, n3), 8, 1]
    left, right = n[[1, 2, 0]], n[[2, 0, 1]]
    return (np.stack([left + _YZX, left + _ZXY]),    # [2, 3, 8, 3]
            np.stack([right + _ZXY, right + _YZX]),
            np.repeat(n + 3, 3, axis=2),             # n1, n2, n3's w
            n[0] + np.arange(3))                     # n1's xyz, [8, 3]


_CORNER_LEFT, _CORNER_RIGHT, _CORNER_W, _CORNER_N1 = _corner_gathers()


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Host-side camera definition (mirrors Camera state, camera.h:18-23)."""

    eye: tuple[float, float, float]
    look_at: tuple[float, float, float]
    up: tuple[float, float, float]
    near: float = 0.1
    far: float = 100.0


def cross(a, b):
    """CROSS macro (main.cu.h:44-47), over the last axis."""
    a, b = a.T, b.T      # components first: a [3] vector takes a 1-D gather
    return (a[_YZX] * b[_ZXY] - a[_ZXY] * b[_YZX]).T


def dot(a, b):
    """DOT macro (main.cu.h:49), over the last axis, summed left to
    right."""
    ab = a * b
    return ab[..., 0] + ab[..., 1] + ab[..., 2]


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
    eye, center, up = np.asarray((eye, center, up), dtype=np.float32)

    f, up_n = normalize(np.array([center - eye, up]))
    s = normalize(cross(f, up_n))
    u = cross(s, f)
    rows = np.array([s, u, f])

    m = np.zeros((4, 4), dtype=np.float32)      # m[col, row]
    m[:3, :3] = rows.T * _ROTATION_SIGN          # rows s, u, -f
    m[3, :3] = dot(rows, eye) * _TRANSLATION_SIGN  # R @ (-eye)
    m[3, 3] = 1.0
    return m.reshape(16)


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
    rows = mvp_flat[_PLANE_W] + _PLANE_SIGN * mvp_flat[_PLANE_XYZ]
    sq = rows ** 2
    norm = np.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2])
    return rows / norm[:, None]


def frustum_corners(planes):
    """Frustum corners 0..7 (camera.h:241-253). [8,3].

    0..3 are the near-plane corners used for ray generation:
    NBL, NBR, NTR, NTL (camera.h:123-133).  Intersect3Planes
    (camera.h:218-239) over the 8 corners at once.
    """
    p = planes.reshape(24)
    prod = p[_CORNER_LEFT] * p[_CORNER_RIGHT]
    x = prod[0] - prod[1]                  # (n2 x n3, n3 x n1, n1 x n2)
    t = p[_CORNER_W] * x                   # n1[3] * n2n3, ...
    den = dot(p[_CORNER_N1], x[0])
    return -(t[0] + t[1] + t[2]) / den[:, None]


def camcoords_from_spec(spec: CameraSpec, fovy_deg: float, aspect: float):
    """Build the packed camcoords[64] vector for a camera spec."""
    mv = look_at_matrix(spec.eye, spec.look_at, spec.up)
    p = perspective_matrix(fovy_deg, aspect, spec.near, spec.far)
    mvp = mvp_matrix(mv, p)
    corners = frustum_corners(frustum_planes(mvp))

    cc = np.empty(64, dtype=np.float32)
    cc[0:3] = spec.eye
    cc[3] = 1.0
    cc[4:16] = corners[:4].reshape(12)
    cc[16:32] = mv
    cc[32:48] = p
    cc[48:64] = mvp
    return cc
