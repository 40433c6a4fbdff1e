"""ugrt_torch frames vs the numpy oracle and ugrt: the forward frame path.

Renderer.render and the CLI run on the CPU here (device="cpu": the
sweeps take their plain PyTorch versions).

Tolerance: none — u8 images, shadow masks and PPM files are
byte-identical.  (ugrt's own bound for knife-edge rays, 0.1% of pixels,
README.md:108-113, is not needed on these generic cameras.)
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from ugrt.ref import oracle
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("use_spot,light_position",
                         [(True, None), (False, (0.2, 0.8, 0.9))])
def test_renderer_matches_oracle(small_cfg, cornell, generic_camera,
                                 generic_light, use_spot, light_position):
    """The test_trace.py:98-121 pair: spot shading lit from the light
    camera's eye, and Lambert from another point."""
    from ugrt_torch.api.renderer import Renderer

    lp = light_position or generic_light.eye
    ores = oracle.render_frame(cornell, generic_camera, [generic_light], lp,
                               small_cfg, use_spot=use_spot)
    out = Renderer(cornell, small_cfg, device="cpu").render(
        generic_camera, [generic_light], lp, use_spot=use_spot)
    assert not bool(out["overflow"])
    assert out["shadowed"].sum() > 100
    np.testing.assert_array_equal(out["shadowed"].numpy(), ores["shadowed"])
    np.testing.assert_array_equal(out["image"].numpy(), ores["image"])


def test_renderer_windowed_matches_ugrt(small_cfg, cornell, generic_camera,
                                        generic_light):
    """light_grid_mode="windowed" (the bench's), frame 1 Lambert then
    frame 2 spot, against ugrt's jitted Renderer."""
    from ugrt.api.renderer import Renderer as RendererJax
    from ugrt_torch.api.renderer import Renderer

    cfg = dataclasses.replace(small_cfg, light_grid_mode="windowed")
    lp = generic_light.eye
    rj = RendererJax(cornell, cfg)
    rt = Renderer(cornell, cfg, device="cpu")
    for _ in range(2):
        oj = rj.render(generic_camera, [generic_light], lp)
        ot = rt.render(generic_camera, [generic_light], lp)
        np.testing.assert_array_equal(ot["shadowed"].numpy(),
                                      np.asarray(oj["shadowed"]))
        np.testing.assert_array_equal(ot["image"].numpy(),
                                      np.asarray(oj["image"]))
        assert bool(ot["overflow"]) == bool(oj["overflow"]) is False


def test_cli_matches_ugrt_cli(tmp_path):
    """python -m ugrt_torch.api.cli --device cpu writes the same PPMs as
    ugrt.api.cli (frame 0 Lambert, frame 1 spot)."""
    from ugrt.api import cli as cli_jax
    from ugrt_torch.api import cli as cli_torch

    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 -1 -3\nv 1 -1 -3\nv 0 1 -3\n"
                   "v -2 -2 -4\nv 2 -2 -4\nv 2 2 -4\nv -2 2 -4\n"
                   "f 1 2 3\nf 4 5 6\nf 4 6 7\n")
    args = [str(obj), "--size", "64", "--grid", "8", "--frames", "2",
            "--camera", "0.01", "0.02", "2", "0", "0", "-1", "0", "1", "0",
            "--light-camera", "0.5", "1.5", "1", "0", "0", "-3", "0", "1",
            "0", "--light-position", "0.5", "1.5", "1"]
    cli_jax.main(args + ["--out", str(tmp_path / "jax"), "--tag", "f"])
    cli_torch.main(args + ["--out", str(tmp_path / "torch"), "--tag", "f",
                           "--device", "cpu"])
    for frame in range(2):
        a = (tmp_path / "jax" / f"f-{frame}.ppm").read_bytes()
        b = (tmp_path / "torch" / f"f-{frame}.ppm").read_bytes()
        assert a == b, f"frame {frame} differs"
    from ugrt.api import io
    assert io.read_ppm(str(tmp_path / "torch" / "f-1.ppm")).sum() > 0


def test_cli_refuses_reflect(tmp_path):
    from ugrt_torch.api import cli as cli_torch

    obj = tmp_path / "tri.obj"
    obj.write_text("v -1 -1 -3\nv 1 -1 -3\nv 0 1 -3\nf 1 2 3\n")
    with pytest.raises(SystemExit, match="reflect"):
        cli_torch.main([str(obj), "--size", "64", "--grid", "8",
                        "--reflect", "--device", "cpu"])


def test_port_imports_no_jax():
    """Every ugrt_torch module imports without pulling in jax (the card's
    machine has none)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ugrt_torch\n"
        "for m in pkgutil.walk_packages(ugrt_torch.__path__, 'ugrt_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('ugrt_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15
