"""predict_frames_per_s: every frame whose boxes reached the host in the
window, over the window's wall time."""

from portbench import harness


def read(ctx):
    r = ctx["record"]
    return harness.rate(r["frames"], r["window_s"])
