"""How a configuration's frame is called, read in one place for the
drivers, the check, the stage timings and the rooflines.

A configuration states:

- ``lights``: the light cameras, each a view (eye, look_at, up, near,
  far); a frame traces a shadow pass per light and shades with the last;
- ``light_position``: the point the shaders light from;
- ``frame``: "plain" (``Renderer.render``) or "reflective"
  (``render_frame_reflective``, as ``cli --reflect`` calls it), and for
  a reflective frame ``reflect``: uniform_dims, uniform_capacity,
  reflectivity, max_batches.

A plain frame's cameras have the image's aspect; a reflective frame's
have aspect 1, as ``cli --reflect`` builds its camera matrices.  A
training step renders with one light (the first), spot shading and the
image's aspect, as ``train()`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.traffic import View


def view_of(obj) -> View:
    """A ``View`` of a configuration's camera object, or of any camera
    with the attributes of one (a ``View``, the program's
    ``CameraSpec``)."""
    if isinstance(obj, View):
        return obj
    if not isinstance(obj, dict):
        return View(tuple(obj.eye), tuple(obj.look_at), tuple(obj.up),
                    float(obj.near), float(obj.far))
    return View(tuple(float(x) for x in obj["eye"]),
                tuple(float(x) for x in obj["look_at"]),
                tuple(float(x) for x in obj["up"]),
                float(obj["near"]), float(obj["far"]))


class FrameCall(NamedTuple):
    reflective: bool
    lights: tuple            # View each
    light_position: tuple
    aspect: float            # a frame's
    step_aspect: float       # a training step's: the image's
    reflect: dict            # the bounce's keyword arguments ({} if plain)

    @property
    def num_lights(self) -> int:
        return len(self.lights)

    def kwargs(self, cfg, capacity: int, use_spot: bool = True,
               plain: bool = False) -> dict:
        """Keyword arguments of a frame, the program's entry and the
        reference's alike (``render_frame`` or
        ``render_frame_reflective``); with ``plain``, of the same frame
        without its bounce (``render_frame``)."""
        kw = dict(cfg=cfg, capacity=capacity, num_lights=self.num_lights,
                  use_spot=use_spot)
        if not plain:
            kw.update(self.reflect)
        return kw

    def step_kwargs(self, cfg, capacity: int) -> dict:
        """Keyword arguments of a training step (one light, spot)."""
        return dict(cfg=cfg, capacity=capacity, num_lights=1, use_spot=True)

    def camcoords(self, view, fovy_deg: float, device, aspect=None):
        """[64] f32 camera coordinates of ``view``, worked out by the
        reference's host camera (equal to the program's, bit for bit:
        ``benchmark/tests``)."""
        from benchmark.reference import host_camera as rcam
        view = view_of(view)
        spec = rcam.CameraSpec(eye=view.eye, look_at=view.look_at,
                               up=view.up, near=view.near, far=view.far)
        return torch.from_numpy(np.asarray(rcam.camcoords_from_spec(
            spec, fovy_deg, self.aspect if aspect is None else aspect),
            dtype=np.float32)).to(device)

    def light_camcoords(self, fovy_deg: float, device, aspect=None):
        """[num_lights, 64] of the lights."""
        return torch.stack([self.camcoords(v, fovy_deg, device, aspect)
                            for v in self.lights])

    def light_position_tensor(self, device):
        return torch.tensor(self.light_position, dtype=torch.float32,
                            device=device)


def reference_config(config: dict):
    """The reference's ``RenderConfig`` of a configuration file."""
    from benchmark.reference.config import QuirkConfig, RenderConfig
    r = dict(config["render"])
    r["quirks"] = QuirkConfig(**r.get("quirks", {}))
    return RenderConfig(**r)


def of(config: dict) -> FrameCall:
    """The ``FrameCall`` of a configuration file's object."""
    r = config["render"]
    reflective = config.get("frame", "plain") == "reflective"
    reflect = {}
    if reflective:
        rc = config["reflect"]
        reflect = dict(uniform_dims=tuple(rc["uniform_dims"]),
                       uniform_capacity=int(rc["uniform_capacity"]),
                       reflectivity=float(rc["reflectivity"]),
                       max_batches=int(rc["max_batches"]))
    aspect = 1.0 if reflective else r["screen_width"] / r["screen_height"]
    return FrameCall(reflective, tuple(view_of(v) for v in config["lights"]),
                     tuple(float(x) for x in config["light_position"]),
                     aspect, r["screen_width"] / r["screen_height"], reflect)
