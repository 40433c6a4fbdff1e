"""ugrt_torch's Perlin debug shader vs ugrt's numpy and jnp versions.

Tolerance: none — the u8 images are bitwise equal, at widths up to 1024
(the hash wraps in int32 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.config import RenderConfig
from ugrt.shade import shaders as shaders_j
from ugrt_torch.shade import shaders as shaders_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("height,width", [(8, 8), (16, 16), (64, 1024)])
def test_perlin_matches_ugrt(height, width):
    cfg = RenderConfig()
    fid = np.random.default_rng(height).integers(
        -2, 5, (height, width)).astype(np.int32)
    want = shaders_j.perlin_shade(fid, width, height, cfg, xp=np)
    want_j = np.asarray(shaders_j.perlin_shade(jnp.asarray(fid), width,
                                               height, cfg, xp=jnp))
    got = shaders_t.perlin_shade(torch.from_numpy(fid), width, height, cfg)
    assert got.dtype == torch.uint8 and got.shape == (height, width, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_j)
    assert want[fid >= 0].sum() > 0


def test_perlin_deterministic_and_masked():
    """tests/test_shade.py's case: misses black, red channel only."""
    fid = torch.zeros((16, 16), dtype=torch.int32)
    fid[0, :] = -2
    img = shaders_t.perlin_shade(fid, 16, 16, RenderConfig())
    assert torch.equal(img, shaders_t.perlin_shade(fid, 16, 16,
                                                   RenderConfig()))
    assert (img[0] == 0).all() and img[1:].sum() > 0
    assert (img[..., 1:] == 0).all()
