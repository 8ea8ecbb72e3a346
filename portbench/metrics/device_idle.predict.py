"""device_idle.predict: 1 - (union of device intervals) / wall, in percent,
over the traced sub-window of the predict loop."""

from portbench.metrics import common


def read(ctx):
    return common.idle_percent(ctx)
