"""optimizer_ms.train: CUDA-event ms of the optimizer's ``step`` (zero
fill of missing gradients, the global norm, the clip, AdamW) per train
step, total over the traced window over the calls."""


def read(ctx):
    s = ctx["record"].get("spans", {}).get("optimizer")
    return s["total_ms"] / s["count"] if s and s["count"] else None
