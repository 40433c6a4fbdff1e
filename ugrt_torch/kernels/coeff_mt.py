"""S1 — coefficient-form Möller–Trumbore as a product (CUDA:
``csrc/coeff_mt.cu``), the probe behind ``ugrt_torch.micro.micro_mxu``.

Replaces the Pallas probes ``mxu_kernel`` and ``vpu_kernel`` of
scripts/micro_mxu.py:26-64.  Per item ``it`` of ``items``, triangles
T = tri[it] (f32 [24, 256], component-major) meet rays
D = rays[it % n_rays] (f32 [8, 128]); every (triangle m, ray n) gets
det, u = up * (1/det) and v = vp * (1/det), written at row ``it`` of
three f32 [n_tri, 256, 128] outputs (rows no item names stay unwritten,
as in the script):

- ``coeff_mt_fma`` (``vpu_kernel``): det = dx*T0 + dy*T1 + dz*T2,
  up over T8..T10, vp over T16..T18, left-associated f32 on the CUDA
  cores; bitwise equal to ``coeff_mt_plain(terms=3)``.
- ``coeff_mt_mma`` (``mxu_kernel``): the three [256 x 8] . [8 x 128]
  products over T[0:8], T[8:16], T[16:24] on the tensor cores
  (mma.sync TF32), "highest" as 3xTF32 and "default" as 1xTF32.  Held
  to ``coeff_mt_plain(terms=8)`` within the bound of ``mma_check``.

Item indices are clamped into [0, n_tri).  The wrappers launch the
kernels for CUDA tensors and run the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from ugrt_torch.kernels import _build

TRI_W, RAY_N = 256, 128          # triangles and rays per item
TRI_C, RAY_C = 24, 8             # their components
# precision -> (split flag of the kernel, c), where
# |det - det_plain| <= c * sum_k |T_k D_k|.  One TF32 product rounds each
# operand to 10 mantissa bits (relative error <= 2^-11 each, 2^-10 for
# the product); 3xTF32 leaves the small*small term and the residual of
# the split, <= ~2^-21, plus f32 accumulation.  c carries a factor 2 of
# margin over each, and covers the plain version's own f32 rounding.
MMA_BOUND = {"highest": (1, 2.0 ** -19), "default": (0, 2.0 ** -9)}
_ITEMS_PER_CHUNK = 256


def _check(items, tri, rays):
    dev = tri.device
    _build.check_tensor(items, "items", torch.int32, (None,), dev)
    _build.check_tensor(tri, "tri", torch.float32, (None, TRI_C, TRI_W), dev)
    _build.check_tensor(rays, "rays", torch.float32, (None, RAY_C, RAY_N),
                        dev)
    if tri.shape[0] == 0 or rays.shape[0] == 0:
        raise ValueError("tri and rays must hold at least one block each")


def _outputs(tri):
    return tuple(torch.empty((tri.shape[0], TRI_W, RAY_N),
                             dtype=torch.float32, device=tri.device)
                 for _ in range(3))


def _dispatch(wrapper, items, tri, rays, terms, entry, *flag):
    _check(items, tri, rays)
    if tri.device.type == "cpu":
        return coeff_mt_plain(items, tri, rays, terms=terms)
    if tri.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{tri.device}")
    det, u, v = _outputs(tri)
    _build.launch(entry, items, items.shape[0], tri, tri.shape[0], rays,
                  rays.shape[0], *flag, det, u, v)
    wrapper.launches += 1
    return det, u, v


def coeff_mt_fma(items, tri, rays):
    """(det, u, v) f32 [n_tri, 256, 128] by 3-term CUDA-core dots."""
    return _dispatch(coeff_mt_fma, items, tri, rays, 3, "ugrt_coeff_mt_fma")


def coeff_mt_mma(items, tri, rays, precision="highest"):
    """(det, u, v) f32 [n_tri, 256, 128] by 8-deep TF32 tensor-core
    products; ``precision`` "highest" (3xTF32) or "default" (1xTF32)."""
    if precision not in MMA_BOUND:
        raise ValueError(f"coeff_mt_mma: precision must be one of "
                         f"{sorted(MMA_BOUND)}, got {precision!r}")
    return _dispatch(coeff_mt_mma, items, tri, rays, 8, "ugrt_coeff_mt_mma",
                     MMA_BOUND[precision][0])


coeff_mt_fma.launches = 0
coeff_mt_mma.launches = 0


def _item_blocks(items, tri, rays):
    """Yield (it [C] int64, T [C, 24, 256], D [C, 8, 128]) chunks."""
    it_all = torch.clamp(items.long(), 0, tri.shape[0] - 1)
    for s in range(0, it_all.shape[0], _ITEMS_PER_CHUNK):
        it = it_all[s:s + _ITEMS_PER_CHUNK]
        yield it, tri[it], rays[it % rays.shape[0]]


def _dot(T, D, comps):
    """Left-associated sum over comps of T[:, c, :, None] * D[:, c, None]."""
    acc = None
    for c in comps:
        term = T[:, c, :, None] * D[:, c % RAY_C, None, :]
        acc = term if acc is None else acc + term
    return acc


def coeff_mt_plain(items, tri, rays, *, terms=3):
    """``coeff_mt_fma`` (terms=3: components 0-2, 8-10, 16-18) or the
    function ``coeff_mt_mma`` approximates (terms=8: components 0-7,
    8-15, 16-23), in f32 PyTorch ops, left-associated."""
    det_o, u_o, v_o = _outputs(tri)
    for it, T, D in _item_blocks(items, tri, rays):
        det = _dot(T, D, range(terms))
        up = _dot(T, D, range(8, 8 + terms))
        vp = _dot(T, D, range(16, 16 + terms))
        inv = 1.0 / det
        det_o[it], u_o[it], v_o[it] = det, up * inv, vp * inv
    return det_o, u_o, v_o


def mma_check(got, plain, items, tri, rays, precision):
    """Hold ``coeff_mt_mma``'s (det, u, v) to the plain (terms=8) result.

    With S_det = sum_k |T_k D_k| (and S_up, S_vp alike, in f64) and c
    from MMA_BOUND: |det - det_p| <= c * S_det everywhere; u and v are
    held only where |det_p| >= 16 c S_det (elsewhere det is lost to
    cancellation and u, v mean nothing), to
    c (S_up + |u_p| S_det) / (|det_p| - c S_det) + 2^-21 |u_p|.
    Returns (violations, max |diff| / bound, max |diff| of det)."""
    c = MMA_BOUND[precision][1]
    bad, worst, det_err = 0, 0.0, 0.0
    for it, T, D in _item_blocks(items, tri, rays):
        T, D = T.double().abs(), D.double().abs()
        s_det, s_up, s_vp = (_dot(T, D, range(k, k + 8)) for k in (0, 8, 16))
        det_g, det_p = got[0][it].double(), plain[0][it].double()
        diff = (det_g - det_p).abs()
        det_err = max(det_err, float(diff.max()))
        ratios = [torch.where(diff == 0, 0.0, diff / (c * s_det))]
        held = (det_p.abs() >= 16 * c * s_det) & (s_det > 0)
        margin = det_p.abs() - c * s_det
        for k, s_num in ((1, s_up), (2, s_vp)):
            g, p = got[k][it].double(), plain[k][it].double()
            bound = (c * (s_num + p.abs() * s_det) / margin
                     + 2.0 ** -21 * p.abs())
            diff = (g - p).abs()
            ratios.append(torch.where(held & (diff != 0), diff / bound, 0.0))
        for r in ratios:                     # NaN counts as a violation
            bad += int((~(r <= 1)).sum())
            worst = max(worst, float(r.nan_to_num(nan=float("inf")).max()))
    return bad, worst, det_err
