"""mha_roofline.train: the least time of the window-attention kernel's
launches in the profiled train steps (the configuration's count: forward
and recompute, QK^T and PV over the valid slots at the bf16 peak, or q, k,
v and the output once each at the memory bandwidth, whichever is longer)
against the device time of the kernels named ``window_mha`` in the trace,
in percent."""


def read(ctx):
    r = ctx["record"]
    prof = r.get("profile")
    if not prof or not r.get("profiled_requests"):
        return None
    device_ms = sum(ms for name, ms in prof["kernels_ms"].items()
                    if "window_mha" in name)
    if device_ms <= 0:
        return None
    cfgm = ctx["cell"].config_module
    bound_s = cfgm.mha_bound_s(ctx["config"], r, ctx["peaks"])
    return 100.0 * bound_s * 1e3 / device_ms
