"""backward_ms.train: CUDA-event ms from the end of the model's ``loss``
to the start of the optimizer's ``step`` (the loss sum and the backward,
the rematerialised blocks' recompute with it), per train step, total over
the traced window over the steps."""


def read(ctx):
    ms = ctx["record"].get("backward_ms")
    return sum(ms) / len(ms) if ms else None
