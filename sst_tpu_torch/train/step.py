"""One optimizer step on one device (counterpart of ``train_step`` in
``sst_tpu/train/step.py``). Data parallelism over several cards (the JAX
package's pjit and shard_map steps) is not ported yet."""

from __future__ import annotations

from sst_tpu_torch.train.state import ClippedAdamW


def train_step(model, optimizer: ClippedAdamW, batch,
               loss_kwargs: dict | None = None) -> dict:
    """``model.loss(batch, train=True, **loss_kwargs)``, summed over its
    ``loss*`` keys, backward, clip and AdamW step. The model's running
    statistics move in the forward. ``loss_kwargs`` carries what JAX's step
    feeds the loss: the FSD schedule's ``pretrain`` / ``thr_extra``, or an
    SST model's voxel-shuffle ``generator`` (JAX's ``shuffle`` rng).
    Returns the loss dict with ``loss_total`` and ``grad_norm`` (the global
    norm before clipping) added, as 0-d tensors that are not
    synchronised."""
    optimizer.zero_grad()
    out = model.loss(batch, train=True, **(loss_kwargs or {}))
    total = sum(v for k, v in out.items() if k.startswith("loss"))
    total.backward()
    grad_norm = optimizer.step()
    metrics = {k: v.detach() for k, v in out.items()}
    metrics["loss_total"] = total.detach()
    metrics["grad_norm"] = grad_norm
    return metrics
