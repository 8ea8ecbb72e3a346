"""segmentor_ms.predict: CUDA-event ms from the segmentor module's forward
pre-hook to its forward hook, total over the traced window over the calls
(one per batch)."""


def read(ctx):
    s = ctx["record"].get("spans", {}).get("segmentor")
    return s["total_ms"] / s["count"] if s and s["count"] else None
