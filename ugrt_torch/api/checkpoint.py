"""Checkpoint / resume for inverse-rendering state (torch mirror of the
flat ``.npz`` form of ugrt/api/checkpoint.py:27-92).

A checkpoint is ``<path>/step_<N>.npz`` holding the state's leaves with
their keys joined by ``/`` (``params/vertices``, ``params/materials``),
exactly as ugrt writes it with ``use_orbax=False``: either package reads
the other's files.  ugrt's Orbax form (a ``step_<N>`` directory) belongs
to JAX and is not read here; ``load_checkpoint`` refuses it by name.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(node, prefix: str, out: dict) -> None:
    """Leaves of nested dicts, lists and tuples under '/'-joined keys (dict
    keys sorted, as jax.tree_util orders them)."""
    if isinstance(node, dict):
        items = sorted(node.items())
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        leaf = node.detach().cpu() if isinstance(node, torch.Tensor) else node
        out[prefix] = np.asarray(leaf)
        return
    for key, child in items:
        _flatten(child, f"{prefix}/{key}" if prefix else str(key), out)


def save_checkpoint(path: str, state: dict, step: int) -> str:
    """Save a nested dict of arrays or tensors as ``step_<step>.npz``
    under ``path``.  Returns the written file."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"step_{step}.npz")
    flat = {}
    _flatten(state, "", flat)
    np.savez(fn, **flat)
    return fn


def _orbax_error(path: str, what: str) -> ValueError:
    return ValueError(
        f"{path}: {what} in Orbax form (step_N directories), which only "
        "ugrt (JAX) reads; save with ugrt's save_checkpoint(..., "
        "use_orbax=False) for the port")


def load_checkpoint(path: str, step: int | None = None) -> dict:
    """Load the given (or the latest ``.npz``) step of a directory, or one
    ``.npz`` file.  Returns a flat {'/'-joined key: numpy array} dict.
    Raises where the step asked for, or every step, is an Orbax
    checkpoint."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        if step is None:
            steps = [int(f[5:-4]) for f in os.listdir(path)
                     if f.startswith("step_") and f.endswith(".npz")]
            if not steps:
                if latest_step(path) is not None:
                    raise _orbax_error(path, "every checkpoint is")
                raise FileNotFoundError(f"no checkpoints under {path}")
            step = max(steps)
        fn = os.path.join(path, f"step_{step}.npz")
        if not os.path.exists(fn):
            if os.path.isdir(os.path.join(path, f"step_{step}")):
                raise _orbax_error(path, f"step {step} is")
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{path}")
    else:
        fn = path
    with np.load(fn) as data:
        return {k: data[k] for k in data.files}


def latest_step(path: str) -> int | None:
    """Highest checkpointed step under path (either form), or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_"):
            tail = d[5:-4] if d.endswith(".npz") else d[5:]
            try:
                steps.append(int(tail))
            except ValueError:
                pass
    return max(steps) if steps else None
