"""The kernel seam (``ugrt_torch.kernels._build.Kernel``): every hand
kernel's wrapper is a Kernel in the one registry ``KERNELS``, carries its
plain version, runs it on CPU tensors bit for bit without counting a
launch, and refuses a device that is neither the CPU nor a card.  One
case per registered kernel, on small inputs of its own shapes; a kernel
registered without a case here fails its case."""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil

import pytest
import torch

import ugrt_torch.kernels
from ugrt_torch import bench, bridge
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.grid import build as gbuild
from ugrt_torch.kernels import _build
from ugrt_torch.micro import dda_edge, micro_heavy, micro_mxu, pallas_micro
from ugrt_torch.scene import procedural
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Every kernel module, so that every Kernel is registered.
for _m in pkgutil.iter_modules(ugrt_torch.kernels.__path__):
    importlib.import_module(f"ugrt_torch.kernels.{_m.name}")

CFG = RenderConfig()


def _keyed(g, shape, key_col, keys=2):
    """Random f32 rows of ``shape`` whose column ``key_col`` holds cell
    keys in [0, keys)."""
    x = torch.randn(shape, generator=g)
    x[..., key_col] = torch.randint(0, keys, shape[:-1], generator=g).float()
    return x


def _windows(lo, hi):
    return (torch.tensor(lo, dtype=torch.int32),
            torch.tensor(hi, dtype=torch.int32))


def _k1(g):
    tri = _keyed(g, (3, 128, 16), 9)
    tri[..., 10] = torch.arange(3 * 128).reshape(3, 128).float()
    return (tri, _keyed(g, (2, 128, 8), 3), *_windows([0, 1], [1, 2])), dict(
        cfg=CFG)


def _k3(g):
    rays = _keyed(g, (2, 128, 8), 4)
    rays[..., 3] = rays[..., 3].abs() * 10 + 1
    return (_keyed(g, (2, 256, 16), 10), rays, *_windows([0, 0], [1, 0])), (
        dict(cfg=CFG))


def _heavy(_g):
    return micro_heavy.make_workload("cpu", nb=2, h_live=100, h_cap=256)


def _rays(g):
    """(primary, eye, light camcoords) of 300 rays, some missing."""
    t = torch.rand((12, 25), generator=g) * 20 + 1
    t[0, :5] = -1.0
    d = torch.randn((12, 25, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    lcc = bridge.camcoords_to_torch(bench.LIGHT, CFG.fovy_deg, 1.0, "cpu")
    return dict(t=t, ray_dir=d), torch.randn((3,), generator=g), lcc


def _face_values(g):
    fid = torch.randint(0, 20, (64,), dtype=torch.int32, generator=g)
    faces = torch.randint(0, 30, (20, 3), dtype=torch.int32, generator=g)
    return (torch.randn((64, 9), generator=g), fid, faces, 30), {}


def _tris(g):
    """The Cornell box's light grid (heavy threshold 4: a heavy list) and
    four ray blocks' first and last real cells, one all sentinel."""
    cfg = dataclasses.replace(CFG, screen_width=64, screen_height=64,
                              grid_x=8, grid_y=8, heavy_threshold=4)
    sc = bridge.scene_to_torch(procedural.cornell_box(subdiv=2), "cpu")
    light = CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                       up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
    lcc = bridge.camcoords_to_torch(light, cfg.fovy_deg, 1.0, "cpu")
    lgrid = gbuild.build_spherical_grid(
        sc["vertices"], sc["faces"], lcc, cfg=cfg,
        capacity=cfg.pair_capacity(sc["faces"].shape[0]))
    first = torch.sort(torch.randint(0, cfg.cell_sentinel, (4,),
                                     generator=g)).values.int()
    last = torch.maximum(first, torch.roll(first, -1)).int()
    first[3], last[3] = cfg.cell_sentinel, -1
    return (sc["vertices"], sc["faces"], lgrid, lcc, first, last, cfg), {}


# Kernel name -> g -> (positional arguments, keyword arguments).
EXAMPLES = {
    "primary_sweep": _k1,
    "heavy_primary_sweep": lambda g: (_heavy(g), dict(cfg=CFG)),
    "shadow_sweep": _k3,
    "uniform_dda": lambda g: (dda_edge.dda_edge_inputs("cpu"), dict(
        cfg=CFG, max_batches=dda_edge.MAX_BATCHES, eps=1e-4,
        batch=dda_edge.BATCH, skip_k=6)),
    "segment_sum": lambda g: ((torch.randn((64, 3), generator=g),
                               torch.randint(0, 10, (64,), dtype=torch.int32,
                                             generator=g), 10), {}),
    "face_corner_sum": _face_values,
    "shadow_rays": lambda g: ((*_rays(g), CFG), {}),
    "unpermute": lambda g: ((torch.randint(0, 2, (3, 128), dtype=torch.int32,
                                           generator=g),
                             torch.randperm(300, generator=g).int()), {}),
    "window_angles": lambda g: (_rays(g), {}),
    "shadow_tris": _tris,
    "coeff_mt_fma": lambda g: (micro_mxu.make_workload("cpu", n_items=2),
                               {}),
    "coeff_mt_mma": lambda g: (micro_mxu.make_workload("cpu", n_items=2),
                               dict(precision="default")),
    "tile_sweep": lambda g: (pallas_micro.make_workload(
        "cpu", cap8=256, n_items=4, n_tiles=2), {}),
    **{f"heavy_sweep_v{v}": lambda g: (_heavy(g), dict(cfg=CFG, mb=2))
       for v in (1, 2, 3)},
}


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_to_meta, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(_to_meta, x))
    return x


def _bits(out):
    """Every tensor of ``out`` as its bytes, in order."""
    leaves = torch.utils._pytree.tree_leaves(out)
    return [x.reshape(-1).contiguous().view(torch.uint8) for x in leaves]


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_kernel_takes_its_plain_version_on_the_cpu(name):
    """A Kernel has a plain version; a CPU call is that version bit for
    bit and counts no launch; meta tensors raise at the route."""
    kernel = _build.KERNELS[name]
    assert isinstance(kernel, _build.Kernel) and kernel.__name__ == name
    assert callable(kernel.plain) and kernel.plain is not kernel
    args, kwargs = EXAMPLES[name](torch.Generator().manual_seed(0))
    before, launched = kernel.launches, _build._launched
    got = kernel(*args, **kwargs)
    want = kernel.plain(*args, **kwargs)
    assert (kernel.launches, _build._launched) == (before, launched)
    got, want = _bits(got), _bits(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device meta"):
        kernel(*_to_meta(args), **kwargs)
