"""train_frames_per_s: every frame trained in the window, over its wall
time; the window ends with a ``torch.cuda.synchronize()``."""

from portbench import harness


def read(ctx):
    r = ctx["record"]
    return harness.rate(r["frames"], r["window_s"])
