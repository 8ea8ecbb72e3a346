"""Checkpoints of a training run (the counterpart of the JAX package's orbax
``StandardCheckpointer`` saves in ``tools/train.py`` and restores in
``tools/test.py`` and ``apis.init_model``).

A checkpoint is a directory, ``work_dir/ckpt_{step}`` as JAX names it,
holding one ``state.pt``: the model's ``state_dict`` (parameters and
running statistics, float32 whatever the compute dtype), the optimizer's
state (AdamW's moments and per-parameter steps, and ``ClippedAdamW.count``,
which drives the one-cycle rate) and ``step``. It is written under a
temporary name and moved into place, replacing an older one of the same
name, as orbax's ``force=True`` save does. It loads with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
import shutil

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    step: int = 0) -> str:
    """Write ``model`` (and ``optimizer``, a ``train/state.py
    ClippedAdamW``, where given) at ``step`` into the directory ``path``;
    returns its absolute path."""
    path = os.path.abspath(path)
    state = {"model": model.state_dict(), "step": int(step)}
    if optimizer is not None:
        state["optimizer"] = {"adamw": optimizer.adamw.state_dict(),
                              "count": int(optimizer.count)}
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):  # a directory cannot replace a non-empty one
        old = f"{path}.old{os.getpid()}"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    return path


def read_checkpoint(path: str, map_location="cpu") -> dict:
    """The checkpoint's raw contents: ``model``, ``step`` and, where one was
    saved, ``optimizer`` (``adamw``, ``count``)."""
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    map_location=None) -> int:
    """Load the checkpoint at ``path`` into ``model`` (strictly: every
    parameter and buffer) and, where given, ``optimizer``; returns its
    step. ``map_location`` defaults to the model's device."""
    if map_location is None:
        map_location = next(model.parameters()).device
    state = read_checkpoint(path, map_location)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        if "optimizer" not in state:
            raise KeyError(f"{path} holds no optimizer state")
        optimizer.adamw.load_state_dict(state["optimizer"]["adamw"])
        optimizer.count = state["optimizer"]["count"]
    return state["step"]
