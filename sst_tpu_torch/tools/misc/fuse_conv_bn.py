"""Fold eval-time batch norms into the convs before them in a checkpoint
(counterpart of the JAX package's ``tools/misc/fuse_conv_bn.py``, after the
reference's).

    python -m sst_tpu_torch.tools.misc.fuse_conv_bn CONFIG CKPT_DIR OUT_DIR

At inference a batch norm is a fixed per-channel scale and shift: the scale
is baked into the conv's weight and the norm is rewritten to statistics that
leave it a bias alone, an equivalent checkpoint (``train/checkpoint.py``
layout). The optimizer state and ``step`` are carried over unchanged. The
config is read for the reference's interface and not otherwise used.
"""

from __future__ import annotations

import argparse

import torch


def _pairs(names) -> list:
    """(conv, norm) child pairs of one scope, matched by index:
    ``Conv_i`` with ``BatchNorm_i`` (``models/layers.py ConvNormAct``) only
    in a scope holding as many of each, and ``deblock_conv_i`` with
    ``deblock_bn_i`` (``models/second.py SECONDFPN``)."""
    n_conv = sum(1 for k in names if k.startswith("Conv_"))
    n_bn = sum(1 for k in names if k.startswith("BatchNorm_"))
    out = []
    for ck in sorted(names):
        if ck.startswith("Conv_") and n_conv == n_bn:
            bk = "BatchNorm_" + ck[len("Conv_"):]
        elif ck.startswith("deblock_conv_"):
            bk = "deblock_bn_" + ck[len("deblock_conv_"):]
        else:
            continue
        if bk in names:
            out.append((ck, bk))
    return out


def fused_pairs(state: dict) -> list:
    """The (scope prefix, conv, norm) triples of ``state`` that
    :func:`fuse_state_dict` fuses: the pairs of :func:`_pairs` in each
    scope whose norm holds running statistics."""
    scopes: dict = {}
    for key in state:
        parts = key.split(".")
        if len(parts) >= 2:
            scopes.setdefault(".".join(parts[:-2]), set()).add(parts[-2])
    out = []
    for scope, names in scopes.items():
        pre = f"{scope}." if scope else ""
        out += [(pre, ck, bk) for ck, bk in _pairs(names)
                if f"{pre}{bk}.running_var" in state]
    return out


def fuse_state_dict(state: dict, eps: float = 1e-3) -> dict:
    """A new ``state_dict`` with every (conv, batch norm) pair of
    :func:`_pairs` fused, as JAX's ``fuse_variables`` fuses the flax tree:
    weight *= scale / sqrt(running_var + eps) on the output-channel axis;
    the norm's scale 1, running_mean 0 and running_var ``1 - eps``; the
    shift ``bias - running_mean * factor`` kept in the norm's bias (or, for
    a conv with a bias, folded into it and the norm's bias zeroed).

    A ``Conv2d`` weight is [Cout, Cin, kh, kw], scaled on dim 0. A
    ``SECONDFPN`` ``deblock_conv_i`` above stride 1 is a ``ConvTranspose2d``
    whose weight is [Cin, Cout, k, k] with k = stride > 1, scaled on dim 1;
    at stride 1 it is a 1x1 ``Conv2d``. (flax scales the last axis of
    both.)

    ``eps`` is JAX's one value for every norm: the fused norm is an
    identity-plus-bias only where the module's own eps is ``eps``. The
    norms of ``ConvNormAct`` and ``SECONDFPN`` use 1e-3, the default;
    PointNet++'s and PAConv's use 1e-5 and take ``eps=1e-5`` here (the
    CLI, as JAX's, fuses at 1e-3)."""
    out = dict(state)
    for pre, ck, bk in fused_pairs(state):
        w = state[f"{pre}{ck}.weight"]
        scale = state[f"{pre}{bk}.weight"]
        bn_bias = state[f"{pre}{bk}.bias"]
        mean = state[f"{pre}{bk}.running_mean"]
        var = state[f"{pre}{bk}.running_var"]
        factor = scale / torch.sqrt(var + eps)
        dim = 1 if (ck.startswith("deblock_conv_")
                    and tuple(w.shape[2:]) != (1, 1)) else 0
        shape = [1] * w.dim()
        shape[dim] = -1
        out[f"{pre}{ck}.weight"] = w * factor.reshape(shape)
        if f"{pre}{ck}.bias" in state:
            out[f"{pre}{ck}.bias"] = (
                state[f"{pre}{ck}.bias"] - mean) * factor + bn_bias
            new_bias = torch.zeros_like(bn_bias)
        else:
            new_bias = bn_bias - mean * factor
        out[f"{pre}{bk}.weight"] = torch.ones_like(scale)
        out[f"{pre}{bk}.bias"] = new_bias
        out[f"{pre}{bk}.running_mean"] = torch.zeros_like(mean)
        out[f"{pre}{bk}.running_var"] = torch.full_like(var, 1.0 - eps)
    return out


def main(argv=None) -> str:
    from sst_tpu_torch.train.checkpoint import read_checkpoint, \
        write_checkpoint

    p = argparse.ArgumentParser(description="fuse Conv+BN in a checkpoint")
    p.add_argument("config", help="config file path")
    p.add_argument("checkpoint", help="checkpoint dir")
    p.add_argument("out", help="output checkpoint dir")
    args = p.parse_args(argv)

    state = read_checkpoint(args.checkpoint)
    n = len(fused_pairs(state["model"]))
    state["model"] = fuse_state_dict(state["model"])
    out = write_checkpoint(args.out, state)
    print(f"fused checkpoint ({n} conv + batch norm pairs) written to "
          f"{args.out}")
    return out


if __name__ == "__main__":
    main()
