"""decode_nms_ms.predict: CUDA-event ms of the head's ``get_bboxes`` (box
decode, per-class pre-selection and NMS, the top ``max_num``) per batch,
total over the traced window over the calls."""


def read(ctx):
    s = ctx["record"].get("spans", {}).get("get_bboxes")
    return s["total_ms"] / s["count"] if s and s["count"] else None
