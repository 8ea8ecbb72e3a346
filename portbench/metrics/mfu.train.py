"""mfu.train: the model operations of every train step of the traced
window (the configuration's count: three times the forward) over the
window's wall time, against the bf16 dense peak (``peaks.json``), in
percent."""

from portbench.metrics import common


def read(ctx):
    cfgm = ctx["cell"].config_module
    return common.mfu_percent(ctx, cfgm.window_flops(ctx["config"],
                                                     ctx["record"]))
