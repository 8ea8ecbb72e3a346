"""SST-Waymo (6 blocks at d128, 8 heads), the training buckets, bfloat16
products, trained by the port's ``train/step.py train_step`` and clipped
AdamW: the port's build, the plain reference beside it, the count of
operations, the spans, and the check of the first train steps against the
reference.

The reference is ``portbench/ref`` (a frozen copy of the port's model,
loss, step and optimizer code in plain PyTorch, every product float32
including the window attention, TF32 off, autograd for every gradient, no
rematerialisation) built from the sizes in ``sst_bf16.json``. It reads the
same raw frames, the same initial weights and the same voxel-shuffle seed,
and follows the first three steps itself."""

from __future__ import annotations

import math

import numpy as np

from portbench import harness

# an element whose reference gradient is under this share of the median
# leaf's root-mean-square gradient moves under Adam by round-off alone (a
# key's bias under the softmax): its change is not compared
NOUGHT_GRAD = 1e-3


def build(cfg: dict, traffic: dict, device):
    """The port's build: ``flagship.sst_waymo(train_buckets=True)`` at
    bfloat16."""
    import torch

    from sst_tpu_torch.flagship import sst_waymo

    return sst_waymo(max_points=cfg["max_points"],
                     max_voxels=cfg["model"]["max_voxels"],
                     train_buckets=True, dtype=getattr(torch, cfg["dtype"]),
                     num_point_features=cfg["num_point_features"],
                     device=device)


def build_reference(cfg: dict, traffic: dict, device):
    """The plain reference from the file's sizes, float32, blocks not
    rematerialised."""
    import torch

    from portbench.ref.models.detectors.dynamic_voxelnet import (
        DynamicVoxelNet,
    )
    from portbench.ref.ops.window import BucketSpec

    m = harness.tuples(cfg["model"])
    m["buckets"] = tuple(BucketSpec(*b) for b in m["buckets"])
    m["backbone"] = dict(m["backbone"], remat_blocks=False,
                         conv_kwargs=tuple(dict(c) for c in
                                           m["backbone"]["conv_kwargs"]))
    model = DynamicVoxelNet(num_point_features=cfg["num_point_features"],
                            dtype=torch.float32, **m)
    return model.to(device)


def init_rule(name: str, shape: tuple):
    """The initializer of a parameter, by name and shape."""
    if len(shape) >= 2:
        return ("normal", 1.0 / math.sqrt(math.prod(shape[1:])))
    if name.endswith(".bias"):
        return ("const", 0.0)
    if name.endswith(".weight"):
        return ("const", 1.0)
    raise ValueError(f"no initializer for {name} {shape}")


def optimizer(model, cfg: dict, make=None):
    """The config's clipped AdamW over the model's parameters (the port's
    ``make_optimizer``, or ``make`` for the reference's copy)."""
    if make is None:
        from sst_tpu_torch.train.state import make_optimizer as make
    o = cfg["optimizer"]
    return make(model.parameters(), base_lr=o["base_lr"],
                weight_decay=o["weight_decay"],
                total_steps=o["total_steps"], clip_norm=o["clip_norm"],
                betas=tuple(o["betas"]))


def shuffle_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 11]).generate_state(1)[0])


def loss_kwargs(cfg: dict, seed: int, device) -> dict:
    """The voxel shuffle's generator on the card, seeded from the run's
    seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(shuffle_seed(seed))
    return {"generator": gen}


def install_spans(spans, model, opt, traffic) -> None:
    """The train step's stages: the forward and loss (the model's
    ``loss``), the backward (from the loss's end to the optimizer's
    start), and the clip + AdamW step (the optimizer's ``step``)."""
    spans.method("loss", model, "loss")
    spans.method("optimizer", opt, "step")


# ------------------------------------------------------------- operations

def frame_counts(cfg: dict, frame: dict, device) -> dict:
    """What one frame's operations depend on, from the reference's own
    voxelization and window plan: valid points, seated voxels, and per
    shift the valid slots of every window of every bucket."""
    import torch

    from portbench.ref.models.sst_input import sst_input_layer
    from portbench.ref.ops.voxelize import dynamic_voxelize, grid_shape_zyx
    from portbench.ref.ops.window import BucketSpec

    m = cfg["model"]
    pts = torch.from_numpy(frame["points"]).to(device)
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=device)
    vm = dynamic_voxelize(pts, torch.zeros(n, dtype=torch.int32,
                                           device=device), valid,
                          m["point_cloud_range"], m["voxel_size"],
                          m["max_voxels"], 1)
    _, ny, nx = grid_shape_zyx(m["point_cloud_range"], m["voxel_size"])
    plan = sst_input_layer(vm.voxel_coords, vm.voxel_valid,
                           sparse_shape=(nx, ny, 1),
                           window_shape=tuple(m["window_shape"]),
                           buckets=tuple(BucketSpec(*b)
                                         for b in m["buckets"]),
                           d_model=m["backbone"]["d_model"][0],
                           max_total_windows=m["max_total_windows"])
    fills = [[(~p).sum(1).double().cpu().numpy() for p in f2w.pads]
             for f2w in plan.f2w]
    return {"points": int(vm.valid.sum()), "voxels": int(plan.valid.sum()),
            "fills": fills}


def attention_work(cfg: dict, counts: dict) -> tuple:
    """(operations, bytes) of one pass of every window attention of the
    backbone over the valid slots: QK^T and PV (4 n^2 C per window of n
    valid slots) and q, k, v and the output once each in bf16, summed over
    the blocks' two shifts and the buckets."""
    c = cfg["model"]["backbone"]["d_model"][0]
    blocks = cfg["model"]["backbone"]["num_blocks"]
    flops = byts = 0.0
    for shift in counts["fills"]:
        for fill in shift:
            flops += float((4 * fill * fill * c).sum())
            byts += float((4 * fill * c * 2).sum())
    return blocks * flops, blocks * byts


def forward_flops(cfg: dict, counts: dict) -> float:
    """One frame's forward: the VFE over the valid points, every SST
    layer's projections and FFN over the seated voxels, the window
    attention, the three attached 3x3 convs, the FPN's 1x1 conv and the
    head's 1x1 convs at the BEV size."""
    m = cfg["model"]
    pcr, vs = m["point_cloud_range"], m["voxel_size"]
    h = round((pcr[4] - pcr[1]) / vs[1])
    w = round((pcr[3] - pcr[0]) / vs[0])
    bb = m["backbone"]
    c_in = cfg["num_point_features"] + 6  # cluster and voxel-centre offsets
    f = 0.0
    for ch in m["vfe"]["feat_channels"]:
        f += 2 * counts["points"] * c_in * ch
        c_in = 2 * ch
    for d, ff in zip(bb["d_model"], bb["dim_feedforward"]):
        per_layer = 2 * (d * 2 * d + d * d + d * d + d * ff + ff * d)
        f += 2 * per_layer * counts["voxels"]  # two shifted layers a block
    f += attention_work(cfg, counts)[0]
    c = bb["in_channel"]
    for kw in bb["conv_kwargs"]:
        f += 2 * kw["kernel_size"] ** 2 * c * bb["conv_out_channel"] * h * w
        c = bb["conv_out_channel"]
    neck = sum(m["neck"]["out_channels"])
    f += 2 * c * neck * h * w
    anchors = 3 * 2  # classes x rotations
    outs = anchors * (m["head"]["num_classes"] + 7 + 2)
    f += 2 * neck * outs * h * w
    return f


def _counts(cfg, record):
    import torch

    if "_counts" not in record:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        record["_counts"] = [frame_counts(cfg, f, device)
                             for f in record["pool"]]
    return record["_counts"]


def window_flops(cfg: dict, record: dict) -> float:
    """Model operations of the traced window: three times each step's
    forward (the rematerialised recompute is not model work)."""
    counts = _counts(cfg, record)
    return sum(3 * forward_flops(cfg, counts[i])
               for frames in record["window_frames"] for i in frames)


def mha_bound_s(cfg: dict, record: dict, peaks: dict) -> float:
    """The least time of the window-attention kernel's launches in the
    profiled steps: per pass the larger of its operations at the bf16 peak
    and its bytes at the memory bandwidth; a step runs each attention
    twice (the forward and the recompute in the backward)."""
    counts = _counts(cfg, record)
    total = 0.0
    for frames in record["profiled_requests"]:
        for i in frames:
            flops, byts = attention_work(cfg, counts[i])
            total += 2 * max(flops / peaks["bf16_flops"],
                             byts / peaks["hbm_bytes"])
    return total


# ------------------------------------------------------------ the check

def _batch(frame: dict, device):
    from portbench.ref.models import PointBatch

    n = len(frame["points"])
    return PointBatch(points=frame["points"][None],
                      valid=np.ones((1, n), bool),
                      gt_boxes=frame["gt_boxes"][None],
                      gt_labels=frame["gt_labels"][None],
                      gt_valid=frame["gt_valid"][None]).to(device)


def reference_steps(cfg, traffic, pool, seed, device, adjust,
                    products=None):
    """The reference's first ``checked_steps`` steps from the seed's
    weights: each step's loss, the first gradient's norm by leaf as the
    optimizer took it, and each leaf's change after the steps."""
    import contextlib

    import torch

    from portbench.ref.train.state import make_optimizer
    from portbench.ref.train.step import train_step

    ref = build_reference(cfg, traffic, device)
    weights = harness.draw_weights(ref, seed, init_rule, device)
    harness.apply_adjust(weights, adjust)
    harness.load_weights(ref, weights)
    ref.train()
    opt = optimizer(ref, cfg, make=make_optimizer)
    kwargs = loss_kwargs(cfg, seed, device)
    losses, first = [], None
    with (products or contextlib.nullcontext)():
        for i in range(traffic["checked_steps"]):
            out = train_step(ref, opt, _batch(pool[i % len(pool)], device),
                             kwargs)
            losses.append(out["loss_total"].item())
            if i == 0:
                first = optimizer_first_grads(opt, ref)
    with torch.no_grad():
        change = {n: (p - weights[n]).cpu()
                  for n, p in ref.named_parameters()}
    del ref, opt, weights
    torch.cuda.empty_cache()
    return losses, first, change


def optimizer_first_grads(opt, model) -> dict:
    """The first gradient as the optimizer took it (after the clip), by
    leaf: AdamW's first moment after one step over (1 - beta1), on the
    host."""
    beta1 = opt.adamw.param_groups[0]["betas"][0]
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: (st["exp_avg"] / (1 - beta1)).cpu()
            for p, st in opt.adamw.state.items()}


def numbers(losses, first, change, ref_losses, ref_first, ref_change) -> dict:
    """The compared numbers:

    * ``loss_gap``: the largest relative gap of a checked step's loss;
    * ``grad_gap``: by the worst leaf, the gap between the program's and
      the reference's norms of the first gradient;
    * ``change_gap``: by the worst leaf, the gap between the norms of the
      change over the checked steps, over the elements whose reference
      gradient is at least ``NOUGHT_GRAD`` of the median leaf's
      root-mean-square gradient;
    * ``grad_err``: by the worst leaf, the norm of the difference, program
      less reference, of the first gradient. A gap of two norms is second
      order in rounding noise that is uncorrelated with the gradient, and
      blind to a gradient turned or permuted; the norm of the difference is
      first order.

    Each leaf's number is over the larger of the reference's norm of that
    leaf and of the median leaf."""
    import torch

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    names = sorted(ref_first)
    ref_g = {n: ref_first[n].double().norm().item() for n in names}
    med_g = float(np.median([ref_g[n] for n in names]))
    grad_gap = grad_err = 0.0
    for n in names:
        mine = first[n].double() if n in first else \
            torch.zeros_like(ref_first[n], dtype=torch.float64)
        scale = max(ref_g[n], med_g)
        grad_gap = max(grad_gap, abs(mine.norm().item() - ref_g[n]) / scale)
        grad_err = max(grad_err,
                       (mine - ref_first[n].double()).norm().item() / scale)
    med_rms = float(np.median([ref_g[n] / math.sqrt(ref_first[n].numel())
                               for n in names]))
    got_c, ref_c = {}, {}
    for n in names:
        keep = ref_first[n].abs() >= NOUGHT_GRAD * med_rms
        if bool(keep.any()):
            got_c[n] = torch.where(keep, change[n], 0.0).double().norm().item()
            ref_c[n] = torch.where(keep, ref_change[n],
                                   0.0).double().norm().item()
    med_c = float(np.median(list(ref_c.values())))
    change_gap = max(abs(got_c[n] - ref_c[n]) / max(ref_c[n], med_c)
                     for n in ref_c)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_err": grad_err}


# set from the readings in PERF.md, each above the port's largest over its
# seeds (the lower reading) and below the upper one (the fp8 control's
# smallest for ``loss_gap``, the planted faults' for the others), nearer
# the upper in ratio
LIMITS = {"loss_gap": 2e-3, "grad_gap": 0.35, "change_gap": 0.3,
          "grad_err": 0.55}


def check(cfg: dict, traffic: dict, record: dict, seed: int, device):
    """The first steps of the run (the warm-up, driven through the
    window's own step on distinct frames) against the reference's.
    Returns {name: (value, limit)}."""
    ref = reference_steps(cfg, traffic, record["pool"], seed, device,
                          record["weight_adjust"])
    got = numbers(record["losses"], record["first_grads"], record["change"],
                  *ref)
    return {k: (v, LIMITS[k]) for k, v in got.items()}


def readings(cell, seed: int, device):
    """(side, numbers) for ``seed``: the port's first steps through the
    cell's loop against the reference ("program"), the reference with fp8
    products and maps in the port's place ("control"), and the port's
    answers with two faults planted ("unchanged", "loss_altered")."""
    from portbench import loops
    from portbench.ref.precision import lower_precision

    cfg, traffic = cell.config, cell.traffic
    record = loops.train(cell, seed, 0.0, False, device)
    adjust = record["weight_adjust"]
    ref = reference_steps(cfg, traffic, record["pool"], seed, device, adjust)
    ctrl = reference_steps(cfg, traffic, record["pool"], seed, device,
                           adjust, products=lower_precision)
    # faults planted in the port's answers: a step that leaves the state
    # unchanged (no optimizer state, no change), a loss altered where it
    # is produced (times 1.5)
    unchanged = {n: c * 0.0 for n, c in record["change"].items()}
    return [
        ("program", numbers(record["losses"], record["first_grads"],
                            record["change"], *ref)),
        ("control", numbers(*ctrl, *ref)),
        ("unchanged", numbers(record["losses"], {}, unchanged, *ref)),
        ("loss_altered", numbers([x * 1.5 for x in record["losses"]],
                                 record["first_grads"], record["change"],
                                 *ref)),
    ]
