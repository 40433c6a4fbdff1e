"""The probes S1-S3 (ugrt_torch.kernels.{coeff_mt, tile_pipeline,
heavy_variants}) against the Pallas kernels of scripts/micro_mxu.py,
scripts/pallas_micro.py and scripts/micro_heavy.py, on the CPU.

The scripts run their benchmarks when imported, so they are not
imported: ``_load_script`` parses each with ``ast`` and executes only
its imports (not the TPU helpers ``_tpu``/``_timing``), its constants,
its defs and, with ``data=True``, the workload it builds before its
first def, with the size constants overridden.  Its kernels then run
through ``pl.pallas_call(..., interpret=True)``, as tests/test_pallas.py
runs ugrt's, on the same numpy-seeded inputs as the port's plain
versions (CPU tensors take the plain path; the CUDA kernels are held to
the plain versions on the card by chip_smoke.py phase 7).

Interpret mode compiles a kernel as one XLA computation, and XLA's CPU
backend contracts multiply-adds into FMAs there (ROADMAP Queue 3; the
TPU and the port do not).  So the interpret-mode comparisons that claim
bitwise equality run on the scripts' data rounded to quarter-integers
(``_fma_proof``): every product and three-term sum is then exact, a
contraction cannot change a bit, and only the divisions round.

Tolerances: vpu_kernel, the three heavy layouts and ugrt's
heavy_primary_sweep are bitwise equal to the plain versions, and so is
compute_block evaluated op by op.  mxu_kernel is held to
``coeff_mt.mma_check``'s bound (c = 2^-19 for "highest", 2^-9 for
"default", times sum |T_k D_k|).  kern's chain multiplies by 1.0001 and
then subtracts, which no rounding of the inputs makes exact: its "full"
sweep through interpret mode (DMAs and all) is held to 1e-5 in t (a few
ulps of the chain's intermediates, which reach ~10), with the argmin
equal wherever the minimum leads the runner-up by 2e-5; "dma" is exact.  The TPU "compute" sweep reads uninitialised memory, so it is
not compared; the port defines it on zero tiles.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ugrt.config import RenderConfig
from ugrt.trace import pallas_tracer as pt
from ugrt_torch.kernels import coeff_mt as cm
from ugrt_torch.kernels import heavy_variants as hv
from ugrt_torch.kernels import tile_pipeline as tp
from ugrt_torch.kernels.heavy_primary_sweep import heavy_primary_sweep_plain
from ugrt_torch.micro import micro_heavy, micro_mxu, pallas_micro
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CFG = RenderConfig()


def _interpret_call(*args, **kwargs):
    """pl.pallas_call in interpret mode, evaluated op by op: jitted, XLA's
    CPU backend contracts multiply-adds into FMAs (ROADMAP Queue 3), which
    the kernels on the TPU and the port's plain versions do not."""
    call = pl.pallas_call(*args, interpret=True, **kwargs)

    def run(*operands):
        with jax.disable_jit():
            return call(*operands)
    return run


class _InterpretPallas:
    """``pl`` with pallas_call in op-by-op interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    pallas_call = staticmethod(_interpret_call)


def _assign_names(node):
    names = []
    for t in node.targets:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        if not all(isinstance(e, ast.Name) for e in elts):
            return None
        names += [e.id for e in elts]
    return names


def _load_script(name, overrides, data=False, extra=()):
    """The namespace of scripts/<name>.py without running it (see the
    module docstring).  Constants are upper-case assignments and the
    names in ``extra``; ``overrides`` replaces their values."""
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text())
    first_def = next(i for i, n in enumerate(tree.body)
                     if isinstance(n, ast.FunctionDef))
    keep = []
    for i, node in enumerate(tree.body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module])
            if not any(m.startswith("_") for m in mods):
                keep.append(node)
        elif isinstance(node, ast.FunctionDef):
            keep.append(node)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            names = (_assign_names(node) if isinstance(node, ast.Assign)
                     else None)
            if names and any(n in overrides for n in names):
                if len(names) != 1:
                    raise ValueError(f"{name}: cannot override {names}")
                node = ast.parse(f"{names[0]} = {overrides[names[0]]!r}"
                                 ).body[0]
                keep.append(node)
            elif (names and all(n.lstrip("_").isupper() or n in extra
                                for n in names)) or (data and i < first_def):
                keep.append(node)
    ns = {"__name__": f"loaded_{name}"}
    exec(compile(ast.Module(keep, []), str(path), "exec"), ns)
    ns["pl"] = _InterpretPallas()
    return ns


def _np(t):
    return t.detach().cpu().numpy()


def _fma_proof(x):
    """x rounded to quarter-integers (see the module docstring)."""
    return np.round(np.asarray(x) * 4) / 4


# --- S1: scripts/micro_mxu.py ------------------------------------------

N_MXU = 8


@pytest.fixture(scope="module")
def mxu():
    ns = _load_script("micro_mxu", {"NITEMS": N_MXU})
    _, tri, rays = micro_mxu.make_workload("cpu", n_items=N_MXU)
    items = torch.from_numpy(np.random.default_rng(3).permutation(N_MXU)
                             .astype(np.int32))
    return ns, (items, tri, rays)


def _run_mxu(ns, kernel, args):
    items, tri, rays = (jnp.asarray(_np(a)) for a in args)
    return [torch.from_numpy(np.asarray(o))
            for o in ns["run"](kernel, tri, rays, items)]


def test_vpu_kernel_matches_fma_plain(mxu):
    ns, (items, tri, rays) = mxu
    args = (items, torch.from_numpy(_fma_proof(tri)),
            torch.from_numpy(_fma_proof(rays)))
    want = cm.coeff_mt_plain(*args, terms=3)
    got = _run_mxu(ns, ns["vpu_kernel"], args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    # The CPU path of the kernel's wrapper is that plain version.
    for g, w in zip(cm.coeff_mt_fma(*args), want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_mxu_kernel_within_bound(mxu, precision):
    ns, args = mxu
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "default": jax.lax.Precision.DEFAULT}[precision]
    got = _run_mxu(ns, functools.partial(ns["mxu_kernel"], precision=prec),
                   args)
    want = cm.coeff_mt_plain(*args, terms=8)
    bad, worst, _ = cm.mma_check(got, want, *args, precision)
    assert bad == 0 and worst <= 1


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), nearest with ties away from
    zero, as cvt.rna.tf32.f32 does."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulated_mma(args, split):
    """det/up/vp of 1xTF32 (split False) or 3xTF32 products, summed in
    f64 and rounded once, then u and v as the kernel forms them."""
    items, tri, rays = (_np(a) for a in args)
    T = tri[items].astype(np.float32)
    D = rays[items % rays.shape[0]]
    Tb, Db = _tf32(T), _tf32(D)
    parts = [(Tb, Db)]
    if split:
        parts += [(_tf32(T - Tb), Db), (Tb, _tf32(D - Db))]
    outs = []
    for k in (0, 8, 16):
        acc = sum(np.einsum("icm,icn->imn", a[:, k:k + 8].astype(np.float64),
                            d.astype(np.float64)) for a, d in parts)
        outs.append(acc.astype(np.float32))
    det, up, vp = outs
    inv = np.float32(1.0) / det
    res = [np.empty((tri.shape[0], 256, 128), np.float32) for _ in range(3)]
    for r, x in zip(res, (det, up * inv, vp * inv)):
        r[items] = x
    return [torch.from_numpy(r) for r in res]


def test_mma_bound_tells_the_precisions_apart(mxu):
    """The bound is tight enough to matter: an emulated 1xTF32 product
    passes "default" and fails "highest"; an emulated 3xTF32 passes
    "highest"."""
    _, args = mxu
    want = cm.coeff_mt_plain(*args, terms=8)
    one = _emulated_mma(args, split=False)
    three = _emulated_mma(args, split=True)
    assert cm.mma_check(one, want, *args, "default")[0] == 0
    assert cm.mma_check(one, want, *args, "highest")[0] > 0
    assert cm.mma_check(three, want, *args, "highest")[0] == 0


# --- S2: scripts/pallas_micro.py ---------------------------------------

N_TILE_ITEMS, CAP8 = 16, 1024


@pytest.fixture(scope="module")
def tiles_ns():
    ns = _load_script("pallas_micro", {"NITEMS": N_TILE_ITEMS,
                                       "CAP8": CAP8}, data=True)
    args = pallas_micro.make_workload("cpu", cap8=CAP8,
                                      n_items=N_TILE_ITEMS)
    # The script's workload: its offsets and ray tiles, its zero values.
    np.testing.assert_array_equal(np.asarray(ns["offs"]), _np(args[0]))
    np.testing.assert_array_equal(np.asarray(ns["tiles"]), _np(args[1]))
    ns["tri"] = jnp.asarray(_np(args[2]))
    ns["rays"] = jnp.asarray(_np(args[3]))
    return ns, args


def test_compute_block_matches_plain(tiles_ns):
    ns, args = tiles_ns
    rng = np.random.default_rng(4)
    trib = rng.standard_normal((128, 128)).astype(np.float32)
    rayb = rng.standard_normal((8, 128)).astype(np.float32)
    trib[5] = trib[9]                 # a tie in one column: first index wins
    rayb[:, 3] = 0.0
    t_j, i_j = ns["compute_block"](jnp.asarray(trib), jnp.asarray(rayb))
    t_p, i_p = tp.compute_block(torch.from_numpy(trib)[None],
                                torch.from_numpy(rayb)[None])
    np.testing.assert_array_equal(_np(t_p[0]), np.asarray(t_j))
    np.testing.assert_array_equal(_np(i_p[0]), np.asarray(i_j))
    assert i_p[0, 3] != 9


def _chain_np(row, ray):
    """compute_block's chain for one row and ray column, in f32 numpy."""
    f = np.float32
    acc = row[0] * ray[0]
    for i in range(1, 9):
        acc = np.abs((acc + row[i] * ray[i % 8]) * f(1.0001) - f(0.5))
    return acc


@pytest.mark.parametrize("first,twin", [(5, 100), (31, 32)])
def test_compute_block_first_row_wins_across_slices(tiles_ns, first, twin):
    """Two equal rows far apart (or on either side of a 32-row slice
    boundary of the CUDA kernel) that hold the minimum of some columns:
    jnp.argmin and the plain version both take the first, the rule the
    kernel's merge of its row slices keeps (smaller value, then smaller
    row)."""
    ns, _ = tiles_ns
    rng = np.random.default_rng(8)
    trib = rng.standard_normal((128, 128)).astype(np.float32)
    rayb = rng.standard_normal((8, 128)).astype(np.float32)
    # Row `first`'s last coefficient brings its chain near 0 in column n
    # (one the kernel gives its second ray column): far below the others.
    n, f = 70, np.float32
    partial = trib[first, 0] * rayb[0, n]
    for i in range(1, 8):
        partial = np.abs((partial + trib[first, i] * rayb[i, n]) * f(1.0001)
                         - f(0.5))
    trib[first, 8] = (f(0.5) / f(1.0001) - partial) / rayb[0, n]
    trib[twin] = trib[first]
    t_j, i_j = ns["compute_block"](jnp.asarray(trib), jnp.asarray(rayb))
    t_p, i_p = tp.compute_block(torch.from_numpy(trib)[None],
                                torch.from_numpy(rayb)[None])
    np.testing.assert_array_equal(_np(t_p[0]), np.asarray(t_j))
    np.testing.assert_array_equal(_np(i_p[0]), np.asarray(i_j))
    assert _chain_np(trib[twin], rayb[:, n]) == _np(t_p[0])[n]
    assert int(i_p[0, n]) == first


@pytest.mark.parametrize("variant", ["dma", "full"])
def test_kern_matches_tile_sweep_plain(tiles_ns, variant):
    """The script's own kernel, DMAs and all (interpret mode runs them),
    against the plain version (see the module docstring for "full"'s
    bound); the wrapper's CPU path equals the plain version."""
    ns, args = tiles_ns
    t_j, i_j = (np.asarray(o) for o in ns["make"](variant, 8)())
    t_p, i_p = tp.tile_sweep_plain(*args, variant)
    if variant == "dma":
        np.testing.assert_array_equal(_np(t_p), t_j)
        np.testing.assert_array_equal(_np(i_p), i_j)
    else:
        np.testing.assert_allclose(_np(t_p), t_j, rtol=0, atol=1e-5)
        rows = _np(args[0])[:, None] + np.arange(128)
        tri, rays = _np(args[2]), _np(args[3])[_np(args[1])]
        acc = tp.compute_block(torch.from_numpy(tri[rows]),
                               torch.from_numpy(rays))[0]
        # runner-up: the minimum over rows other than the plain argmin
        gap = _runner_up_gap(tri[rows], rays, _np(i_p))
        clear = gap > 2e-5
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(_np(i_p)[clear], i_j[clear])
        assert torch.equal(acc, t_p)
        assert (_np(i_p) > 0).any() and (_np(t_p) > 0).all()
    for a, b in zip(tp.tile_sweep(*args, variant, 8), (t_p, i_p)):
        assert torch.equal(a, b)


def _runner_up_gap(tri_rows, rays, arg):
    """Per (item, ray): second-smallest minus smallest chain value."""
    acc = torch.from_numpy(tri_rows[:, :, 0, None] * rays[:, None, 0, :])
    for i in range(1, 9):
        acc = acc + torch.from_numpy(tri_rows[:, :, i, None]
                                     * rays[:, None, i % 8, :])
        acc = torch.abs(acc * 1.0001 - 0.5)
    two = acc.topk(2, dim=1, largest=False).values
    return _np(two[:, 1] - two[:, 0])


def test_compute_variant_runs_on_zero_tiles(tiles_ns):
    """"compute" is the chain on zero tiles: what compute_block gives
    for a zero tile and zero rays, for every item."""
    ns, args = tiles_ns
    t0, i0 = ns["compute_block"](jnp.zeros((128, 128), jnp.float32),
                                 jnp.zeros((8, 128), jnp.float32))
    t, i = tp.tile_sweep_plain(*args, "compute")
    np.testing.assert_array_equal(_np(t), np.broadcast_to(np.asarray(t0),
                                                          t.shape))
    np.testing.assert_array_equal(_np(i), np.broadcast_to(np.asarray(i0),
                                                          i.shape))


# --- S3: scripts/micro_heavy.py ----------------------------------------

HEAVY_SIZES = {"NB": 7, "H_LIVE": 200, "H_CAP": 384}   # 2 live of 3 windows


@pytest.fixture(scope="module")
def heavy():
    ns = _load_script("micro_heavy", HEAVY_SIZES, data=True)
    count, table, rays = micro_heavy.make_workload("cpu", nb=7, h_live=200,
                                                   h_cap=384)
    # The script's workload, made by the script's own lines ...
    np.testing.assert_array_equal(np.asarray(ns["tri_windows"]),
                                  _np(table))
    np.testing.assert_array_equal(np.asarray(ns["rays_rm"]), _np(rays))
    assert int(ns["heavy_count"]) == int(count)
    # ... made FMA-proof for interpret mode, in the script's globals too.
    table = torch.from_numpy(_fma_proof(table))
    rays = torch.from_numpy(_fma_proof(rays))
    ns["tri_windows"] = jnp.asarray(_np(table))
    ns["rays_blocks"] = jnp.asarray(_np(rays).swapaxes(1, 2))
    args = (count, table, rays)
    want = heavy_primary_sweep_plain(*args, cfg=CFG)
    assert (_np(want[0]) < 3e38).sum() > 100
    return ns, args, want


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_heavy_layouts_match_plain(heavy, name):
    ns, args, want = heavy
    t, f = ns[f"make_{name}"](8)()
    np.testing.assert_array_equal(np.asarray(t)[:7], _np(want[0]))
    np.testing.assert_array_equal(np.asarray(f)[:7], _np(want[1]))


@pytest.fixture(scope="module")
def heavy_varied():
    """The script's heavy workload at the test sizes, FMA-proof, with
    footprints that vary per face and faces that tie in t: columns c + 1
    (same window) and c + 128 (next window) repeat column c, ids
    ascending as pack_heavy_windows packs them.  (On a tie across windows
    Pallas keeps the earlier window's face and the port the smaller id:
    the same face where ids ascend.)"""
    ns = _load_script("micro_heavy", HEAVY_SIZES, data=True)
    count, table, rays = micro_heavy.make_workload("cpu", nb=7, h_live=200,
                                                   h_cap=384)
    tbl = _fma_proof(_np(table)).astype(np.float32)
    rng = np.random.default_rng(6)
    lo = rng.integers(0, 96, (2, 384))
    tbl[10], tbl[11] = lo[0], lo[0] + rng.integers(0, 64, 384)
    tbl[12], tbl[13] = lo[1], lo[1] + rng.integers(0, 64, 384)
    tbl[10, 200:], tbl[11, 200:] = 1.0, 0.0          # dead: empty footprint
    dup = np.arange(0, 60, 4)
    for c in dup:
        tbl[:14, c + 1] = tbl[:14, c]
        tbl[:14, c + 128] = tbl[:14, c]
    table = torch.from_numpy(tbl)
    rays = torch.from_numpy(_fma_proof(rays))
    ns["tri_windows"] = jnp.asarray(tbl)
    ns["rays_blocks"] = jnp.asarray(_np(rays).swapaxes(1, 2))
    args = (count, table, rays)
    want = heavy_primary_sweep_plain(*args, cfg=CFG)
    assert (_np(want[0]) < 3e38).sum() > 100
    assert np.isin(_np(want[1]), dup).sum() > 10      # ties decided by id
    return ns, args, want


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_heavy_layouts_match_plain_on_varied_footprints(heavy_varied, name):
    """The script's layouts on footprints that hold some rays of a block
    and not others, and on faces tied in t within and across windows."""
    ns, args, want = heavy_varied
    t, f = ns[f"make_{name}"](8)()
    np.testing.assert_array_equal(np.asarray(t)[:7], _np(want[0]))
    np.testing.assert_array_equal(np.asarray(f)[:7], _np(want[1]))


def _could_not_win(k, det, best_t):
    """The could-win vote's drop test of csrc/sweep.cuh (win_bound and
    heavy_face), in f32 numpy."""
    f = np.float32
    lim = np.where(best_t >= f(2.0**-100), best_t * (f(1) + f(2.0**-20)),
                   f(np.inf)).astype(f)
    ad = np.abs(det)
    lq = (ad * lim).astype(f)
    return (np.abs(k) > lq) & (lq >= f(2.0**-100)) & (ad <= f(2.0**100))


def test_could_win_bound_keeps_every_winner():
    """Wherever the could-win vote drops a candidate, its rounded t =
    |k * (1/det)| exceeds the ray's running t, so no candidate that wins
    or ties is dropped: checked on k within 64 ulps of best_t * det, over
    magnitudes from subnormal to near overflow; and the vote does drop
    candidates a few ulps above a tie."""
    f = np.float32
    rng = np.random.default_rng(7)
    n = 20000
    best = (10.0 ** rng.uniform(-40, 38, n)).astype(f)
    best[:100] = f(3e38)                                 # no hit yet
    det = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-40, 38, n)
           ).astype(f)
    near = (best.astype(np.float64) * np.abs(det)).astype(f)
    steps = np.arange(-64, 65, dtype=np.int32)
    bits = near.view(np.int32)[:, None] + steps[None, :]
    k = np.where(bits > 0, bits, 0).astype(np.int32).view(f)
    k = k * np.sign(det)[:, None] * rng.choice([-1, 1], (n, 1)).astype(f)
    with np.errstate(all="ignore"):
        t = np.abs(k * (f(1) / det[:, None]))
    drop = _could_not_win(k, det[:, None], best[:, None])
    assert not (drop & ~(t > best[:, None])).any()
    assert (drop & (t < f(3e38))).sum() > n


def test_heavy_primary_sweep_interpret_matches_plain(heavy):
    _, args, want = heavy
    t, f = pt.heavy_primary_sweep(*(jnp.asarray(_np(a)) for a in args),
                                  cfg=CFG, interpret=True)
    np.testing.assert_array_equal(np.asarray(t), _np(want[0]))
    np.testing.assert_array_equal(np.asarray(f), _np(want[1]))


# --- the wrappers and the entry points ---------------------------------

def test_wrappers_take_the_plain_path_on_cpu(heavy):
    """On CPU tensors each probe wrapper returns its plain version's
    result and launches nothing (the counters stay put)."""
    _, args, want = heavy
    wrappers = (hv.heavy_sweep_v1, hv.heavy_sweep_v2, hv.heavy_sweep_v3,
                cm.coeff_mt_fma, cm.coeff_mt_mma, tp.tile_sweep)
    before = [w.launches for w in wrappers]
    for fn in wrappers[:2]:
        for mb in hv.MBS:
            for a, b in zip(fn(*args, cfg=CFG, mb=mb), want):
                assert torch.equal(a, b)
    table4 = torch.cat([args[1], torch.zeros((16, 128))], dim=1)  # NWH 4
    for a, b in zip(hv.heavy_sweep_v3(args[0], table4, args[2], cfg=CFG),
                    heavy_primary_sweep_plain(args[0], table4, args[2],
                                              cfg=CFG)):
        assert torch.equal(a, b)
    m_args = micro_mxu.make_workload("cpu", n_items=2)
    for a, b in zip(cm.coeff_mt_mma(*m_args, precision="default"),
                    cm.coeff_mt_plain(*m_args, terms=8)):
        assert torch.equal(a, b)
    assert [w.launches for w in wrappers] == before


def test_wrappers_raise_on_other_devices_and_bad_inputs(heavy):
    _, (count, table, rays), _ = heavy
    m_items, m_tri, m_rays = micro_mxu.make_workload("cpu", n_items=2)
    offs, tiles, tri, trays = pallas_micro.make_workload(
        "cpu", cap8=256, n_items=4, n_tiles=2)
    meta = [x.to("meta") for x in (count, table, rays)]
    with pytest.raises(ValueError, match="unsupported device"):
        hv.heavy_sweep_v1(*meta, cfg=CFG)
    with pytest.raises(ValueError, match="unsupported device"):
        cm.coeff_mt_fma(*(x.to("meta") for x in (m_items, m_tri, m_rays)))
    with pytest.raises(ValueError, match="unsupported device"):
        tp.tile_sweep(*(x.to("meta") for x in (offs, tiles, tri, trays)))
    with pytest.raises(ValueError, match="mb must be"):
        hv.heavy_sweep_v2(count, table, rays, cfg=CFG, mb=3)
    with pytest.raises(ValueError, match="built for"):
        hv.heavy_sweep_v3(count, table, rays, cfg=CFG)       # NWH 3
    with pytest.raises(ValueError, match="multiple"):
        hv.heavy_sweep_v1(count, table[:, :200].contiguous(), rays, cfg=CFG)
    with pytest.raises(TypeError):
        cm.coeff_mt_fma(m_items.long(), m_tri, m_rays)
    with pytest.raises(ValueError):
        cm.coeff_mt_fma(m_items, m_tri[:, :8], m_rays)
    with pytest.raises(ValueError, match="precision"):
        cm.coeff_mt_mma(m_items, m_tri, m_rays, precision="high")
    with pytest.raises(ValueError, match="variant"):
        tp.tile_sweep(offs, tiles, tri, trays, "copy")
    with pytest.raises(ValueError, match="wchunk"):
        tp.tile_sweep(offs, tiles, tri, trays, "full", 0)
    with pytest.raises(ValueError, match="rows"):
        tp.tile_sweep(offs, tiles, tri[:100], trays)


def test_tile_sweep_clamps_indices():
    """Out-of-range offsets and ray tiles are clamped (kernel and plain
    alike), not read out of bounds."""
    offs, tiles, tri, rays = pallas_micro.make_workload(
        "cpu", cap8=256, n_items=4, n_tiles=2)
    bad_o = torch.tensor([-8, 10_000, 0, 128], dtype=torch.int32)
    bad_t = torch.tensor([-1, 5, 0, 1], dtype=torch.int32)
    fixed_o = torch.tensor([0, 128, 0, 128], dtype=torch.int32)
    fixed_t = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    for a, b in zip(tp.tile_sweep_plain(bad_o, bad_t, tri, rays),
                    tp.tile_sweep_plain(fixed_o, fixed_t, tri, rays)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("probe", [micro_mxu, pallas_micro, micro_heavy])
def test_probes_refuse_to_run_without_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need an NVIDIA GPU"):
        probe.run()
