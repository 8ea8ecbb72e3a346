"""One optimizer step (counterpart of ``train_step`` and of the DDP-exact
``make_shard_map_train_step`` in ``sst_tpu/train/step.py``).

On one process it is the plain step. In a process group of several ranks
(``utils/dist.py``, one card each, torchrun) it is JAX's shard_map step:
each rank takes the loss of its own slice of the batch (its
``MaskedBatchNorm`` statistics summed over ranks in the forward), fills a
zero gradient for every parameter no loss reached, averages every gradient
over the ranks (one all-reduce over a flat buffer), then clips and steps
identically on each rank. The reported losses and metrics are their means
over ranks, ``grad_norm`` the norm of the averaged gradients.

It all-reduces explicitly rather than through ``DistributedDataParallel``:
DDP raises on parameters that no loss reached (the FSD schedule's
``pretrain`` mode leaves the detection head unused) and its hooks would
meet the remat recompute of ``utils/remat.checkpoint`` twice.
"""

from __future__ import annotations

import torch

from portbench.ref.train.state import ClippedAdamW


def train_step(model, optimizer: ClippedAdamW, batch,
               loss_kwargs: dict | None = None) -> dict:
    """``model.loss(batch, train=True, **loss_kwargs)``, summed over its
    ``loss*`` keys, backward, clip and AdamW step. The model's running
    statistics move in the forward. ``loss_kwargs`` carries what JAX's step
    feeds the loss: the FSD schedule's ``pretrain`` / ``thr_extra``, or a
    voxel-shuffle or sampler ``generator`` (JAX's rngs). Returns the loss
    dict with ``loss_total`` and ``grad_norm`` (the global norm before
    clipping) added, as 0-d tensors that are not synchronised."""
    optimizer.zero_grad()
    out = model.loss(batch, train=True, **(loss_kwargs or {}))
    total = sum(v for k, v in out.items() if k.startswith("loss"))
    total.backward()
    grad_norm = optimizer.step()
    metrics = {k: v.detach() for k, v in out.items()}
    metrics["loss_total"] = total.detach()
    metrics["grad_norm"] = grad_norm
    return metrics
