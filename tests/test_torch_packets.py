"""ugrt_torch's build_packets (the reference's DecisionData packet reorder)
against ugrt's, on tests/test_packets.py's cells, and against the packet
invariants those tests pin.

Tolerance: none — every output (sorted ray ids, packet starts, counts,
cells, overflow) is exactly equal, int32 and of ugrt's shapes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.config import RenderConfig
from ugrt.trace import shadow as shadow_j
from ugrt_torch import bridge
from ugrt_torch.trace import shadow as shadow_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG64 = dataclasses.replace(RenderConfig(), screen_width=64,
                            screen_height=64, grid_x=8, grid_y=8)
CFG32 = dataclasses.replace(RenderConfig(), screen_width=32,
                            screen_height=32, grid_x=4, grid_y=4)


def _random_cells(cfg, n, seed=7):
    """tests/test_packets.py:55-67: a few hot cells, many single-ray
    cells, ~5% sentinels."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, cfg.cell_sentinel, n).astype(np.int32)
    hot = rng.integers(0, cfg.cell_sentinel, 4)
    idx = rng.random(n) < 0.6
    cells[idx] = rng.choice(hot, idx.sum())
    cells[rng.random(n) < 0.05] = cfg.cell_sentinel
    return cells


def _cases():
    """name -> (cells, cfg).  ``pcap_eq_n``: n equal to packet_capacity,
    the one size at which ugrt pads the next-start array (shadow.py:
    127-130)."""
    n_eq = next(n for n in range(1, 1000)
                if shadow_j.packet_capacity(CFG64, n) == n)
    return {
        "random": (_random_cells(CFG64, 64 * 64), CFG64),
        "all_one_cell": (np.full(32 * 32, 5, np.int32), CFG32),
        "all_sentinel": (np.full(32 * 32, CFG32.cell_sentinel, np.int32),
                         CFG32),
        "pcap_eq_n": (_random_cells(CFG64, n_eq, seed=3), CFG64),
    }


def _port(cells, cfg):
    ray, work = shadow_t.build_packets(torch.from_numpy(cells),
                                       bridge.render_config(cfg))
    return [bridge.to_numpy(x) for x in (ray, *work)]


def _check_invariants(cells, cfg, ray, pos, cnt, cell, overflow):
    """tests/test_packets.py:19-52 on the port's arrays."""
    assert not bool(overflow)
    sent, mrp, n = cfg.cell_sentinel, cfg.max_rays_per_packet, len(cells)
    live = cell < sent
    _, counts = np.unique(cells[cells < sent], return_counts=True)
    assert int(live.sum()) == int(np.sum(-(-counts // mrp)))
    sorted_cells = cells[ray]
    covered = np.zeros(n, dtype=bool)
    for p in np.nonzero(live)[0]:
        s, c = int(pos[p]), int(cnt[p])
        assert 1 <= c <= mrp and s + c <= n
        assert (sorted_cells[s:s + c] == cell[p]).all()
        assert not covered[s:s + c].any()
        covered[s:s + c] = True
    assert covered.sum() == (cells < sent).sum()
    assert (cnt[~live] == 0).all()


@pytest.mark.parametrize("case", ["random", "all_one_cell", "all_sentinel",
                                  "pcap_eq_n"])
def test_build_packets_equals_ugrt(case):
    cells, cfg = _cases()[case]
    ray_j, work_j = shadow_j.build_packets(jnp.asarray(cells), cfg)
    want = [np.asarray(x) for x in (ray_j, *work_j)]
    got = _port(cells, cfg)
    for name, g, w in zip(("sorted_ray", *shadow_t.ShadowWork._fields),
                          got, want):
        assert g.shape == w.shape, name
        assert g.dtype == (np.bool_ if name == "overflow" else np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[1].shape == (shadow_t.packet_capacity(cfg, len(cells)),)
    _check_invariants(cells, cfg, *got)
    if case == "all_one_cell":       # 1024 rays in one cell: 16 full packets
        live = got[3] < cfg.cell_sentinel
        assert live.sum() == 16 and (got[2][live] == 64).all()


def test_build_packets_capacity_above_ray_count():
    """Fewer rays than packet slots (pcap + 1 > n, where ugrt's own
    slicing leaves packet_pos shorter than pcap): the port pads every
    output to pcap and still meets the invariants."""
    cells = _random_cells(CFG64, 40, seed=5)
    got = _port(cells, CFG64)
    pcap = shadow_t.packet_capacity(bridge.render_config(CFG64), 40)
    assert pcap + 1 > 40
    assert all(x.shape == (pcap,) for x in got[1:4])
    assert (got[1][40:] == 40).all()
    _check_invariants(cells, CFG64, *got)
