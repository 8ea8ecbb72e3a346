"""forward_ms.train: CUDA-event ms of the model's ``loss`` (voxelize, VFE,
window plan, the SST blocks, convs, FPN, head, targets and losses) per
train step, total over the traced window over the calls."""


def read(ctx):
    s = ctx["record"].get("spans", {}).get("loss")
    return s["total_ms"] / s["count"] if s and s["count"] else None
