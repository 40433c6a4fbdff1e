"""ugrt_torch's gather_rows and its segment sum (kernels/segment_sum.py,
G1) against ugrt's gather transposes (ugrt/diff/fastgrad.py), and the
fixed-point arithmetic of G1's kernel, on the CPU.

- The gradients of ugrt's ``gather_rows`` (the material gather's one-hot
  product) and ``gather_face_corners`` (the corner gather's sorted
  prefix sums), through ``jax.vjp``, against the port's ``gather_rows``
  on the same numpy-seeded inputs: 5 x 6 and 300 x 3 tables, 64 x 48
  pixels.  The port is held to the f64 sum within its own bound (rtol
  2^-24, atol n 2^-62 sum|g|, n = pixels x corners: n q / 2 before the
  f32 rounding), and to ugrt within rtol 2^-20 and atol 2^-24 sum|g| of
  the column: ugrt sums in f32 in another order, a difference of two
  prefix sums or a HIGHEST-precision product accumulated over every
  pixel, so its error is a few roundings of running sums as large as
  the column's sum|g| (measured: at most 0.32 of that atol on these
  inputs), not of the row's result; n 2^-62 sum|g| alone fails there
  (up to 2^-17 relative on rows whose sum cancels).
- ``kernel_model``: G1's arithmetic in numpy (a warp's 32 elements
  grouped by row, each group's 64-bit patterns summed as 22-, 22- and
  20-bit pieces, sums of zero skipped, the rest added in a shuffled
  order as two 32-bit words with the low word's carry), bitwise
  ``segment_sum_plain`` on micro.gather_bwd's skewed cases.  No
  tolerance.
- The NaN rule, N = 0, and that skipping zero contributions changes no
  bit; the wrapper on CPU tensors, and what it refuses.
"""

import inspect
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.diff import fastgrad
from ugrt_torch.core.gather import gather_rows
from ugrt_torch.kernels import _build
from ugrt_torch.kernels import segment_sum as g1
from ugrt_torch.micro import gather_bwd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PIXELS = (64, 48)


def _cotangents(rng, shape, miss):
    """f32 cotangents across 20 binades, zero at the miss pixels."""
    g = rng.normal(size=shape).astype(np.float32)
    g *= np.float32(2.0) ** rng.integers(-20, 0, size=shape[:2] + (1,) *
                                         (len(shape) - 2))
    g[miss] = 0
    return g


def _vjp(fn, table, cot):
    _, pull = jax.vjp(fn, jnp.asarray(table))
    return np.asarray(pull(jnp.asarray(cot))[0])


def _port_grad(table, idx, cot):
    t = torch.tensor(table, requires_grad=True)
    out = gather_rows(t, torch.from_numpy(idx))
    assert torch.equal(out, t[torch.from_numpy(idx)])
    (g,) = torch.autograd.grad(out, t, torch.from_numpy(
        cot.reshape(out.shape)))
    return g.numpy()


def _material_case(seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(5, 6)).astype(np.float32)
    miss = rng.random(PIXELS) < 0.1
    idx = np.where(miss, 0, rng.integers(0, 5, size=PIXELS))
    return table, idx, _cotangents(rng, PIXELS + (6,), miss)


def _corner_case(seed):
    """300 vertices, 150 faces; 4x4 pixel patches share a face; misses
    clamp to face 0 with zero cotangents (trace/refine.py)."""
    rng = np.random.default_rng(seed)
    vertices = rng.normal(size=(300, 3)).astype(np.float32)
    faces = np.stack([rng.choice(300, 3, replace=False) for _ in range(150)])
    patch = rng.integers(0, 150, size=(PIXELS[0] // 4, PIXELS[1] // 4))
    fid = np.repeat(np.repeat(patch, 4, 0), 4, 1)
    miss = rng.random(PIXELS) < 0.1
    fid = np.where(miss, 0, fid)
    return vertices, faces, fid, _cotangents(rng, PIXELS + (3, 3), miss)


def _exact(idx, cot, rows):
    """The f64 sum of the cotangents per row, and the port's bound of
    its difference from it (n q / 2)."""
    width = cot.shape[-1]
    want = np.zeros((rows, width))
    np.add.at(want, idx.reshape(-1), cot.reshape(-1, width).astype(
        np.float64))
    n = idx.size
    return want, n * 2.0 ** -62 * np.abs(cot).astype(np.float64).sum()


@pytest.mark.parametrize("gather", ["material", "corner"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gradients_match_ugrt_fastgrad(gather, seed):
    """The port's gather backward against ugrt's custom VJPs."""
    if gather == "material":
        table, idx, cot = _material_case(seed)
        want = _vjp(lambda t: fastgrad.gather_rows(
            t, jnp.asarray(idx, jnp.int32)), table, cot)
        port_idx, rows = idx, 5
    else:
        table, faces, fid, cot = _corner_case(seed)
        want = _vjp(lambda v: fastgrad.gather_face_corners(
            v, jnp.asarray(faces, jnp.int32), jnp.asarray(fid, jnp.int32)),
            table, cot)
        port_idx, rows = faces[fid.reshape(-1)], 300
        cot = cot.reshape(-1, 3, 3)
    got = _port_grad(table, port_idx, cot)
    exact, bound = _exact(port_idx, cot, rows)
    np.testing.assert_allclose(got, exact, rtol=2 ** -24, atol=bound)
    column = np.abs(cot.reshape(-1, cot.shape[-1])).astype(np.float64).sum(0)
    assert np.all(np.abs(got.reshape(rows, -1) - want.reshape(rows, -1))
                  <= 2 ** -20 * np.abs(want.reshape(rows, -1))
                  + 2 ** -24 * column + bound)
    assert np.abs(got).sum() > 0


def kernel_model(values, idx, rows, seed=0):
    """G1's arithmetic (csrc/segment_sum.cu) in numpy, on CPU tensors:
    total = sum |v| (here math.fsum, another order than the plain
    version's), each value round(v 2^(62 - exp)) half to even, the
    elements in groups of 32 consecutive ones, in each group the 64-bit
    patterns of one row summed as unsigned pieces of 22, 22 and 20 bits,
    recombined modulo 2^64, sums of zero skipped, the rest added to the
    accumulator in a shuffled order as the shared tables add them (two
    32-bit words, the low word's carry into the high one); then int64 ->
    f64, the scaling, f64 -> f32, and NaN everywhere for a total not
    finite."""
    n = idx.shape[0]
    shape = (rows,) + tuple(values.shape[1:])
    cols = math.prod(values.shape[1:])
    v = values.reshape(n, cols).numpy().astype(np.float64)
    total = math.fsum(np.abs(v).ravel())
    if not math.isfinite(total):
        return torch.full(shape, float("nan"), dtype=torch.float32)
    exp = np.frexp(total)[1]
    q = np.rint(v * np.ldexp(1.0, 62 - exp)).astype(np.int64)
    u = q.view(np.uint64)
    r = idx.numpy()
    key = np.arange(n) // 32 * rows + r
    uniq, inv = np.unique(key, return_inverse=True)
    pieces = []
    for lo, bits in ((0, 22), (22, 22), (44, 20)):
        part = np.zeros((uniq.size, cols), np.uint64)
        np.add.at(part, inv, (u >> np.uint64(lo)) & np.uint64((1 << bits) - 1))
        assert (part < 2 ** 32).all()
        pieces.append(part)
    sums = (pieces[0] + (pieces[1] << np.uint64(22))
            + (pieces[2] << np.uint64(44)))
    dest = (uniq % rows)[:, None] * cols + np.arange(cols)
    nonzero = sums != 0
    order = np.random.default_rng(seed).permutation(int(nonzero.sum()))
    # Each addition as the shared tables take it: the low 32-bit word's
    # atomic, its carry into the high word with the high half.
    lo, hi = [0] * (rows * cols), [0] * (rows * cols)
    for d, x in zip(dest[nonzero][order].tolist(),
                    sums[nonzero][order].tolist()):
        old = lo[d]
        lo[d] = (old + (x & 0xffffffff)) & 0xffffffff
        hi[d] = (hi[d] + (x >> 32) + (lo[d] < old)) & 0xffffffff
    acc = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64)
    out = acc.view(np.int64).astype(np.float64) * np.ldexp(1.0, exp - 62)
    return torch.from_numpy(out.astype(np.float32).reshape(shape))


@pytest.mark.parametrize("case", sorted(gather_bwd.skewed_cases(
    "cpu", n=4096)))
def test_kernel_arithmetic_equals_plain(case):
    """kernel_model bitwise segment_sum_plain on each skewed case (two
    orders of the atomics), and the wrapper on CPU tensors is the plain
    version."""
    values, idx, rows = gather_bwd.skewed_cases("cpu", n=4096)[case]
    want = g1.segment_sum_plain(values, idx, rows)
    for seed in (0, 1):
        got = kernel_model(values, idx, rows, seed)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(g1.segment_sum(values, idx, rows).view(torch.int32),
                       want.view(torch.int32))


def test_skewed_cases_cover_every_table():
    """The card tests' skewed cases reach each of the kernel's tables by
    their shapes: every row in shared memory up to SHARED_ENTRIES
    entries, the shared hash table above it, and the global table for
    rows of more than 95 columns, where 32 hash slots no longer fit."""
    assert [g1.table(5000, c) for c in (95, 96)] == ["hashed", "global"]
    assert [g1.table(r, 3) for r in (1365, 1366)] == ["direct", "hashed"]
    tables = {}
    for name, (values, _, rows) in gather_bwd.skewed_cases("cpu").items():
        tables.setdefault(g1.table(rows, math.prod(values.shape[1:])),
                          []).append(name)
    assert sorted(tables) == ["direct", "global", "hashed"], tables
    assert tables["global"] == ["96 columns"]


def test_nan_rule_empty_input_and_zero_skips():
    """A total that is not finite gives NaN (0x7fc00000) everywhere; N = 0
    gives +0 rows; dropping the elements whose contributions are all zero
    (what the kernel skips) changes no bit."""
    rng = np.random.default_rng(7)
    values = torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, 1000))
    for bad in (float("inf"), float("-inf"), float("nan")):
        v = values.clone()
        v[17, 2] = bad
        out = g1.segment_sum(v, idx, 40)
        assert (out.view(torch.int32) == 0x7fc00000).all()
    out = g1.segment_sum(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.long),
                         40)
    assert out.shape == (40, 3) and (out.view(torch.int32) == 0).all()
    values[::3] = 0
    values[1::7, 1] = 0
    keep = values.abs().sum(1) > 0
    full = g1.segment_sum(values, idx, 40)
    assert torch.equal(full.view(torch.int32), g1.segment_sum(
        values[keep].contiguous(), idx[keep].contiguous(),
        40).view(torch.int32))
    assert torch.equal(full.view(torch.int32),
                       kernel_model(values, idx, 40).view(torch.int32))


def test_wrapper_checks_and_cpu_route():
    """CPU tensors take the plain version, in their own floating dtype,
    and count no launch; the kernel route refuses CPU tensors and values
    that are not f32; a non-contiguous, wrongly typed or wrongly shaped
    input raises, and so does a device that is neither."""
    values = torch.randn(64, 3)
    idx = torch.randint(0, 10, (64,))
    before = g1.segment_sum.launches
    assert torch.equal(g1.segment_sum(values, idx, 10),
                       g1.segment_sum_plain(values, idx, 10))
    assert g1.segment_sum.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        g1._launch(values, idx, 10)
    with pytest.raises(TypeError, match="float32"):
        g1._launch(values.double(), idx, 10)
    wide = g1.segment_sum(values.double(), idx, 10)
    assert wide.dtype == torch.float64 and torch.equal(
        wide, g1.segment_sum_plain(values.double(), idx, 10))
    with pytest.raises(ValueError, match="contiguous"):
        g1.segment_sum(torch.randn(3, 64).t(), idx, 10)
    with pytest.raises(ValueError, match="contiguous"):
        g1.segment_sum(values, torch.randint(0, 10, (128,))[::2], 10)
    with pytest.raises(TypeError):
        g1.segment_sum(values.int(), idx, 10)
    with pytest.raises(TypeError):
        g1.segment_sum(values, idx.int(), 10)
    with pytest.raises(ValueError):
        g1.segment_sum(values, idx[:32], 10)
    with pytest.raises(ValueError):
        g1.segment_sum(values, idx, -1)
    with pytest.raises(ValueError, match="unsupported device"):
        g1.segment_sum(values.to("meta"), idx.to("meta"), 10)


def test_kernel_constants_and_entry_point():
    """The wrapper's sizes are the kernel's (kPartials, kSharedEntries,
    kHashBytes, kThreads), the kernel picks its table from the shapes
    alone, and the entry point's parameters are the ctypes
    signature's."""
    src = (_build.CSRC_DIR / "segment_sum.cu").read_text()
    assert int(re.search(r"kPartials = (\d+);", src).group(1)) == g1.PARTIALS
    assert int(re.search(r"kSharedEntries = (\d+);", src).group(1)) == (
        g1.SHARED_ENTRIES)
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == g1.THREADS
    assert re.search(r"kHashBytes = (.*?);", src).group(1) == "24 * 1024"
    assert g1.HASH_BYTES == 24 * 1024
    assert "mode" not in inspect.signature(g1._launch).parameters
    params = re.search(r'extern "C" int ugrt_segment_sum\((.*?)\)', src,
                       re.S).group(1)
    assert len(params.split(",")) == len(
        _build.SIGNATURES["kernels"]["ugrt_segment_sum"])
    assert "segment_sum.cu" in _build.LIBRARIES["kernels"]
