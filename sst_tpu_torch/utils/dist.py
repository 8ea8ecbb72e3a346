"""Data parallelism over processes, one card each (the counterpart of
``sst_tpu/utils/dist.py`` and of the JAX package's shard_map train step).

torchrun starts one process per card and sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` (and ``MASTER_ADDR`` / ``MASTER_PORT``);
:func:`init_from_env` joins them into one process group, NCCL on the card
and gloo on the CPU. Where JAX's step binds a mesh axis and its modules
``psum`` over it, the port's modules ask :func:`is_dist` and all-reduce
over the default group: ``models/layers.py MaskedBatchNorm`` sums its
statistics over ranks (the reference's NaiveSyncBN), and ``train/step.py
train_step`` averages the gradients and metrics. Plain ``BatchNorm`` stays
per rank, as flax's ``nn.BatchNorm`` without an ``axis_name`` does.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_from_env(device="cuda"):
    """Join the process group that torchrun's environment describes.
    Returns (rank, world size, this process's device): the card
    ``cuda:LOCAL_RANK`` where ``device`` is a CUDA device, else ``device``.
    Without ``WORLD_SIZE`` or with a world of one, no group is made."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} asked for, but torch.cuda.is_available() "
                f"is False; pass --device cpu to run on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", rank=rank,
            world_size=world,
            **({"device_id": device} if device.type == "cuda" else {}))
    return rank, world, device


def is_dist() -> bool:
    """True inside a process group of more than one rank."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, differentiable: its transpose is the sum of the
    cotangents over ranks, as JAX's ``psum``'s is."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ranks (``psum_if_dist``); ``x`` itself outside a
    process group. Gradients flow through it."""
    return _AllReduceSum.apply(x) if is_dist() else x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over ranks (``pmean_if_dist``)."""
    return all_reduce_sum(x) / dist.get_world_size() if is_dist() else x


@torch.no_grad()
def average_in_place(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks, one all-reduce per dtype
    over a flat buffer (``pmean`` of every gradient leaf)."""
    if not is_dist():
        return
    world = dist.get_world_size()
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s."""
    if is_dist():
        for t in module.state_dict().values():
            dist.broadcast(t, src)
