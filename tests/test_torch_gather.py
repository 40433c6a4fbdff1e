"""ugrt_torch's gathers (core/gather.py) and their segment sums
(kernels/segment_sum.py, G1) against ugrt's gathers and their transposes
(ugrt/diff/fastgrad.py), and the fixed-point arithmetic of G1's kernel,
on the CPU.

- ``gather_face_corners`` and ``gather_face_data`` forward: bitwise
  ``vertices[faces[fid]]`` and ugrt's rows (the aux columns too).
- The gradients of ugrt's ``gather_rows`` (the material gather's one-hot
  product), ``gather_face_corners`` and ``gather_face_data`` (the corner
  gather's sorted prefix sums), through ``jax.vjp``, against the port's
  gathers on the same numpy-seeded inputs: 5 x 6 and 300 x 3 tables
  (150 faces), 64 x 48 pixels in 4x4 patches of a face.  The port's
  face gathers' gradients are bitwise its ``gather_rows(vertices,
  faces[fid])``'s.  The port is held to the f64 sum within its own bound (rtol
  2^-24, atol n 2^-62 sum|g|, n = pixels x corners: n q / 2 before the
  f32 rounding), and to ugrt within rtol 2^-20 and atol 2^-24 sum|g| of
  the column: ugrt sums in f32 in another order, a difference of two
  prefix sums or a HIGHEST-precision product accumulated over every
  pixel, so its error is a few roundings of running sums as large as
  the column's sum|g| (measured: at most 0.32 of that atol on these
  inputs), not of the row's result; n 2^-62 sum|g| alone fails there
  (up to 2^-17 relative on rows whose sum cancels).
- ``kernel_model``: G1's arithmetic in numpy (each warp's span of
  elements 32 a step; a key carried in each lane's 64-bit registers
  while every lane holds it; at a change the lanes' patterns
  reduce-scattered over the warp by 64-bit shuffles, and a step of
  several keys grouped by key, its groups' patterns summed as 22-, 22-
  and 20-bit pieces; sums of zero skipped, the rest added to the key's
  table in a shuffled order as two 32-bit words with the low word's
  carry; the tables added into the rows, or a face's into its three
  vertices, modulo 2^64), bitwise the plain versions on
  micro.gather_bwd's skewed and face cases, with the kernel's warps and
  with three long spans.  No tolerance.
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
from ugrt_torch.core.gather import (gather_face_corners, gather_face_data,
                                    gather_rows)
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


def _face_aux(rng):
    """[150, 2] f32 per-face data (a material id and a flag, as
    shaders.face_shade_meta makes)."""
    return np.stack([rng.integers(0, 5, 150), rng.integers(0, 2, 150)],
                    1).astype(np.float32)


def _face_gather(kind, table, faces, fid, aux):
    """The port's face gather of ``kind`` on torch tensors: corners (and
    the aux rows)."""
    f, i = (torch.from_numpy(faces.astype(np.int32)),
            torch.from_numpy(fid.astype(np.int32)))
    if kind == "face data":
        return gather_face_data(table, f, torch.from_numpy(aux), i)
    return gather_face_corners(table, f, i), None


@pytest.mark.parametrize("kind", ["corner", "face data"])
def test_face_gathers_forward_bitwise(kind):
    """gather_face_corners and gather_face_data are bitwise
    vertices[faces[fid]] and ugrt's rows, aux columns included."""
    vertices, faces, fid, _ = _corner_case(0)
    aux = _face_aux(np.random.default_rng(1))
    got, got_aux = _face_gather(kind, torch.from_numpy(vertices), faces, fid,
                                aux)
    args = (jnp.asarray(vertices), jnp.asarray(faces, jnp.int32))
    if kind == "face data":
        want, want_aux = fastgrad.gather_face_data(
            *args, jnp.asarray(aux), jnp.asarray(fid, jnp.int32))
        np.testing.assert_array_equal(got_aux.numpy(), np.asarray(want_aux))
        np.testing.assert_array_equal(got_aux.numpy(), aux[fid])
    else:
        want = fastgrad.gather_face_corners(*args,
                                            jnp.asarray(fid, jnp.int32))
    assert got.shape == fid.shape + (3, 3)
    np.testing.assert_array_equal(got.numpy(), vertices[faces[fid]])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gather", ["material", "corner", "face data"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gradients_match_ugrt_fastgrad(gather, seed):
    """The port's gather backward against ugrt's custom VJPs; the face
    gathers' bitwise the per-corner gather_rows's."""
    if gather == "material":
        table, idx, cot = _material_case(seed)
        want = _vjp(lambda t: fastgrad.gather_rows(
            t, jnp.asarray(idx, jnp.int32)), table, cot)
        port_idx, rows = idx, 5
        got = _port_grad(table, port_idx, cot)
    else:
        table, faces, fid, cot = _corner_case(seed)
        aux = _face_aux(np.random.default_rng(seed))
        f, i = jnp.asarray(faces, jnp.int32), jnp.asarray(fid, jnp.int32)
        if gather == "face data":
            want = _vjp(lambda v: fastgrad.gather_face_data(
                v, f, jnp.asarray(aux), i)[0], table, cot)
        else:
            want = _vjp(lambda v: fastgrad.gather_face_corners(v, f, i),
                        table, cot)
        t = torch.tensor(table, requires_grad=True)
        out, _ = _face_gather(gather, t, faces, fid, aux)
        (got,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
        got = got.numpy()
        port_idx, rows = faces[fid.reshape(-1)], 300
        cot = cot.reshape(-1, 3, 3)
        per_corner = _port_grad(table, port_idx, cot)
        assert np.array_equal(got.view(np.int32), per_corner.view(np.int32))
    exact, bound = _exact(port_idx, cot, rows)
    np.testing.assert_allclose(got, exact, rtol=2 ** -24, atol=bound)
    column = np.abs(cot.reshape(-1, cot.shape[-1])).astype(np.float64).sum(0)
    assert np.all(np.abs(got.reshape(rows, -1) - want.reshape(rows, -1))
                  <= 2 ** -20 * np.abs(want.reshape(rows, -1))
                  + 2 ** -24 * column + bound)
    assert np.abs(got).sum() > 0


def _piece_sum(u):
    """The sum over lanes (axis 0) of uint64 patterns u as G1's warp
    reductions take it: pieces of 22, 22 and 20 bits, each summed in 32
    bits, recombined modulo 2^64."""
    out = np.zeros(u.shape[1:], np.uint64)
    for lo, bits in ((0, 22), (22, 22), (44, 20)):
        part = ((u >> np.uint64(lo)) & np.uint64((1 << bits) - 1)).sum(
            0, dtype=np.uint64)
        assert (part < 2 ** 32).all()
        out += part << np.uint64(lo)
    return out


def _halve(w, n, m):
    """One step of G1's reduce-scatter (csrc/segment_sum.cu, halve) on
    [32, n] uint64 lanes: lane bit m clear keeps the first ceil(n / 2)
    slots, set the rest moved down, each plus its partner's copy."""
    n1, n2 = (n + 1) // 2, n - (n + 1) // 2
    lanes = np.arange(32)
    up = (lanes & m) != 0
    out = np.zeros((32, n1), np.uint64)
    for i in range(n1):
        high = w[:, n1 + i] if i < n2 else np.zeros(32, np.uint64)
        send = np.where(up, w[:, i], high)
        out[:, i] = np.where(up, high, w[:, i]) + send[lanes ^ m]
    return out


def _reduce_scatter(w):
    """G1's carry flush (reduce_scatter) on [32, kW] uint64 lanes: five
    halvings, then each column's total in the one lane the kernel's
    replay of the splits names.  Returns the kW totals."""
    kw = n = w.shape[1]
    for m in (16, 8, 4, 2, 1):
        w = _halve(w, n, m)
        n = (n + 1) // 2
    totals = {}
    for lane in range(32):
        col, real, n = 0, kw, kw
        for m in (16, 8, 4, 2, 1):
            n1 = (n + 1) // 2
            if lane & m:
                col, real = col + n1, max(real - n1, 0)
            else:
                real = min(real, n1)
            n = n1
        if real:
            assert col not in totals
            totals[col] = w[lane, 0]
    assert sorted(totals) == list(range(kw))
    return np.asarray([totals[c] for c in range(kw)], np.uint64)


def _carry_sum(a):
    """The carry flush's column totals of [32, cols] lanes as the kernel
    takes them: 6 or 9 columns in one reduce-scatter, other widths in
    blocks of 9 padded with zeros."""
    cols = a.shape[1]
    width = cols if cols in (6, 9) else 9
    out = []
    for c0 in range(0, cols, width):
        block = np.zeros((32, width), np.uint64)
        block[:, :min(width, cols - c0)] = a[:, c0:c0 + width]
        out.extend(_reduce_scatter(block)[:min(width, cols - c0)])
    return np.asarray(out, np.uint64)


def kernel_model(case, warps=None, seed=0):
    """G1's arithmetic (csrc/segment_sum.cu) in numpy on a case of CPU
    tensors, (values, idx, rows) or (values, fid, faces, rows): total =
    sum |v| (here math.fsum, another order than the plain version's),
    each value round(v 2^(62 - exp)) half to even; each of ``warps``
    warps (default: the kernel's for the case's size on a 132-SM card)
    walks its span 32 elements a step, carries a key in each lane's
    64-bit patterns while every lane of a step holds it (or none), and
    at a change flushes the lanes' piece sums; a step of several keys
    flushes each key's group; flushed sums of zero are skipped, the rest
    added to the key's table entries in a shuffled order as the shared
    tables add them (two 32-bit words, the low word's carry into the high
    one); the entries go to the rows, a face's column 3 j + c to vertex
    faces[f, j], column c, modulo 2^64; then int64 -> f64, the scaling,
    f64 -> f32, and NaN everywhere for a total not finite.  Keys outside
    their table add nothing."""
    values, keys, *faces, rows = case
    n = keys.shape[0]
    cols = math.prod(values.shape[1:])
    shape = (rows, 3) if faces else (rows,) + tuple(values.shape[1:])
    v = values.reshape(n, cols).numpy().astype(np.float64)
    total = math.fsum(np.abs(v).ravel())
    if not math.isfinite(total):
        return torch.full(shape, float("nan"), dtype=torch.float32)
    exp = np.frexp(total)[1]
    u = np.rint(v * np.ldexp(1.0, 62 - exp)).astype(np.int64).view(
        np.uint64)
    count = faces[0].shape[0] if faces else rows
    k = keys.numpy().astype(np.int64)
    valid = (k >= 0) & (k < count)
    k = np.where(valid, k, -1)
    u[~valid] = 0
    if warps is None:
        warps = gather_bwd.warp_layout(max(n, 1))[0]
    span = -(-n // (warps * 32)) * 32
    flushes = []                       # (key, column, pattern)

    def flush(key, sums):
        flushes.extend((int(key), c, int(x)) for c, x in enumerate(sums)
                       if x)

    for w in range(warps):
        cur, a = -1, np.zeros((32, cols), np.uint64)
        for b in range(w * span, min((w + 1) * span, n), 32):
            kk = np.full(32, -1)
            q = np.zeros((32, cols), np.uint64)
            m = min(32, n - b, (w + 1) * span - b)
            kk[:m], q[:m] = k[b:b + m], u[b:b + m]
            on = (kk == cur) & (cur >= 0)
            a += np.where(on[:, None], q, np.uint64(0))
            if np.all(on | (kk < 0)):
                continue
            last = kk[kk >= 0][-1]
            if last != cur:
                if cur >= 0:
                    flush(cur, _carry_sum(a))
                a = np.where((kk == last)[:, None], q, np.uint64(0))
            rest = (kk >= 0) & ~on & (kk != last)
            cur = last
            for g in np.unique(kk[rest]):
                flush(g, _piece_sum(q[kk == g]))
        if cur >= 0:
            flush(cur, _carry_sum(a))
    # The shared tables' additions, in a shuffled order.
    lo, hi = {}, {}
    for i in np.random.default_rng(seed).permutation(len(flushes)):
        key, c, x = flushes[i]
        old = lo.get((key, c), 0)
        lo[(key, c)] = (old + (x & 0xffffffff)) & 0xffffffff
        hi[(key, c)] = (hi.get((key, c), 0) + (x >> 32)
                        + (lo[(key, c)] < old)) & 0xffffffff
    acc = np.zeros(math.prod(shape), np.uint64)
    for (key, c), low in lo.items():
        d = (int(faces[0][key, c // 3]) * 3 + c % 3 if faces
             else key * cols + c)
        acc[d] += np.uint64((hi[(key, c)] << 32) | low)
    out = acc.view(np.int64).astype(np.float64) * np.ldexp(1.0, exp - 62)
    return torch.from_numpy(out.astype(np.float32).reshape(shape))


def _cases(n=4096):
    cases = gather_bwd.skewed_cases("cpu", n=n)
    cases.update({f"face: {k}": c for k, c in gather_bwd.face_cases(
        "cpu", n=n).items()})
    return cases


@pytest.mark.parametrize("case", sorted(_cases()))
def test_kernel_arithmetic_equals_plain(case):
    """kernel_model bitwise the plain version on each skewed and face case
    (the kernel's warps and three long spans; two orders of the table
    additions), and the wrapper on CPU tensors is the plain version."""
    args = _cases()[case]
    fn, plain = gather_bwd.sums(args)
    want = plain(*args)
    for warps, seed in ((None, 0), (None, 1), (3, 0)):
        got = kernel_model(args, warps, seed)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(fn(*args).view(torch.int32), want.view(torch.int32))


def test_skewed_cases_cover_every_table():
    """The card tests' skewed cases reach each of the kernel's tables by
    their shapes: every key in shared memory up to SHARED_ENTRIES
    entries, the shared hash table above it, and the global table for
    rows of more than 63 columns, where 32 hash slots no longer fit; the
    face cases (9 columns a face) the direct and the hashed table."""
    assert [g1.table(5000, c) for c in (63, 64)] == ["hashed", "global"]
    assert [g1.table(r, 3) for r in (682, 683)] == ["direct", "hashed"]
    assert [g1.table(f, 9) for f in (227, 228)] == ["direct", "hashed"]
    tables = {}
    for name, (values, _, rows) in gather_bwd.skewed_cases("cpu").items():
        tables.setdefault(g1.table(rows, math.prod(values.shape[1:])),
                          []).append(name)
    assert sorted(tables) == ["direct", "global", "hashed"], tables
    assert tables["global"] == ["96 columns"]
    face_tables = {g1.table(faces.shape[0], 9) for _, _, faces, _ in
                   gather_bwd.face_cases("cpu", n=4096).values()}
    assert face_tables == {"direct", "hashed"}


def test_nan_rule_empty_input_and_zero_skips():
    """A total that is not finite gives NaN (0x7fc00000) everywhere; N = 0
    gives +0 rows; dropping the elements whose contributions are all zero
    (what the kernel skips) changes no bit."""
    rng = np.random.default_rng(7)
    values = torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, 1000).astype(np.int32))
    for bad in (float("inf"), float("-inf"), float("nan")):
        v = values.clone()
        v[17, 2] = bad
        out = g1.segment_sum(v, idx, 40)
        assert (out.view(torch.int32) == 0x7fc00000).all()
    out = g1.segment_sum(torch.zeros((0, 3)),
                         torch.zeros(0, dtype=torch.int32), 40)
    assert out.shape == (40, 3) and (out.view(torch.int32) == 0).all()
    values[::3] = 0
    values[1::7, 1] = 0
    keep = values.abs().sum(1) > 0
    full = g1.segment_sum(values, idx, 40)
    assert torch.equal(full.view(torch.int32), g1.segment_sum(
        values[keep].contiguous(), idx[keep].contiguous(),
        40).view(torch.int32))
    assert torch.equal(full.view(torch.int32),
                       kernel_model((values, idx, 40)).view(torch.int32))


def test_wrapper_checks_and_cpu_route():
    """CPU tensors take the plain version, in their own floating dtype,
    and count no launch; the kernel route refuses CPU tensors and values
    that are not f32; a non-contiguous, wrongly typed or wrongly shaped
    input raises (indices are int32; the plain version also takes
    int64), and so does a device that is neither."""
    values = torch.randn(64, 3)
    idx = torch.randint(0, 10, (64,), dtype=torch.int32)
    before = g1.segment_sum.launches
    assert torch.equal(g1.segment_sum(values, idx, 10),
                       g1.segment_sum_plain(values, idx, 10))
    assert torch.equal(g1.segment_sum_plain(values, idx, 10),
                       g1.segment_sum_plain(values, idx.long(), 10))
    assert g1.segment_sum.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _build.choose_sweep(g1.segment_sum, "kernel", values.device)
    with pytest.raises(TypeError, match="float32"):
        g1.segment_sum.body(values.double(), idx, 10)
    wide = g1.segment_sum(values.double(), idx, 10)
    assert wide.dtype == torch.float64 and torch.equal(
        wide, g1.segment_sum_plain(values.double(), idx, 10))
    with pytest.raises(ValueError, match="contiguous"):
        g1.segment_sum(torch.randn(3, 64).t(), idx, 10)
    with pytest.raises(ValueError, match="contiguous"):
        g1.segment_sum(values, torch.randint(0, 10, (128,),
                                             dtype=torch.int32)[::2], 10)
    with pytest.raises(TypeError):
        g1.segment_sum(values.int(), idx, 10)
    with pytest.raises(TypeError):
        g1.segment_sum(values, idx.long(), 10)
    with pytest.raises(ValueError):
        g1.segment_sum(values, idx[:32], 10)
    with pytest.raises(ValueError):
        g1.segment_sum(values, idx, -1)
    with pytest.raises(ValueError, match="unsupported device"):
        g1.segment_sum(values.to("meta"), idx.to("meta"), 10)


def test_face_wrapper_checks_and_cpu_route():
    """face_corner_sum on CPU tensors is its plain version,
    segment_sum_plain of the corners keyed by faces[fid], and counts no
    launch; its kernel route refuses CPU tensors and values that are not
    f32; values not [N, 9], fid or faces not int32, faces not [F, 3] or
    a shorter fid raise."""
    rng = np.random.default_rng(2)
    values = torch.randn(64, 9)
    fid = torch.from_numpy(rng.integers(0, 20, 64).astype(np.int32))
    faces = torch.from_numpy(rng.integers(0, 30, (20, 3)).astype(np.int32))
    before = g1.face_corner_sum.launches
    got = g1.face_corner_sum(values, fid, faces, 30)
    assert g1.face_corner_sum.launches == before
    assert torch.equal(got, g1.segment_sum_plain(
        values.reshape(-1, 3), faces[fid].reshape(-1).long(), 30))
    assert torch.equal(got, g1.face_corner_sum_plain(values, fid, faces, 30))
    with pytest.raises(ValueError, match="CUDA"):
        _build.choose_sweep(g1.face_corner_sum, "kernel", values.device)
    with pytest.raises(TypeError, match="float32"):
        g1.face_corner_sum.body(values.double(), fid, faces, 30)
    with pytest.raises(ValueError):
        g1.face_corner_sum(values[:, :6].contiguous(), fid, faces, 30)
    with pytest.raises(TypeError):
        g1.face_corner_sum(values, fid.long(), faces, 30)
    with pytest.raises(TypeError):
        g1.face_corner_sum(values, fid, faces.long(), 30)
    with pytest.raises(ValueError):
        g1.face_corner_sum(values, fid, faces[:, :2].contiguous(), 30)
    with pytest.raises(ValueError):
        g1.face_corner_sum(values, fid[:32], faces, 30)


def test_kernel_constants_and_entry_point():
    """The wrapper's sizes are the kernel's (kPartials, kSharedEntries,
    kHashBytes, kThreads, kBlocksPerSM, the face's 9 columns), the
    kernel picks its table from the shapes alone, and the entry points'
    parameters are the ctypes signatures'."""
    src = (_build.CSRC_DIR / "segment_sum.cu").read_text()
    assert int(re.search(r"kPartials = (\d+);", src).group(1)) == g1.PARTIALS
    assert int(re.search(r"kSharedEntries = (\d+);", src).group(1)) == (
        g1.SHARED_ENTRIES)
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == g1.THREADS
    assert int(re.search(r"kBlocksPerSM = (\d+);", src).group(1)) == (
        g1.BLOCKS_PER_SM)
    assert int(re.search(r"kMaxCols = (\d+);", src).group(1)) == (
        g1.CORNER_COLUMNS)
    assert re.search(r"kHashBytes = (.*?);", src).group(1) == "16 * 1024"
    assert g1.HASH_BYTES == 16 * 1024
    # Only the generic kernel is built for the global table: the widest
    # row with hash slots is kWideCols, wider than the face's and the
    # material's rows.
    wide = int(re.search(r"kWideCols = (\d+);", src).group(1))
    assert [g1.table(5000, c) for c in (wide, wide + 1)] == [
        "hashed", "global"]
    assert g1.CORNER_COLUMNS <= wide and 6 <= wide
    assert "mode" not in inspect.signature(g1.segment_sum).parameters
    for name in ("ugrt_segment_sum", "ugrt_face_corner_sum"):
        params = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                           re.S).group(1)
        assert len(params.split(",")) == len(
            _build.SIGNATURES["kernels"][name])
    assert "segment_sum.cu" in _build.LIBRARIES["kernels"]
