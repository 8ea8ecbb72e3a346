"""Arithmetic that several metric readers share."""


def idle_percent(ctx):
    prof = ctx["record"].get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu_percent(ctx, window_flops: float):
    """Model operations of the traced window over its wall time, against
    the bf16 dense peak, in percent."""
    r = ctx["record"]
    if r["window_s"] <= 0 or window_flops <= 0:
        return None
    return 100.0 * window_flops / r["window_s"] / ctx["peaks"]["bf16_flops"]
