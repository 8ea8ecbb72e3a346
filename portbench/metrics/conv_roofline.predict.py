"""conv_roofline.predict: the least time of the two dense UNets'
convolutions (the configuration's count: per convolution the larger of its
operations at the bf16 peak and its bytes at the memory bandwidth) over
the profiled batches, against the device time of the kernels launched
inside the convolution modules' forward (the ``conv`` ranges of the
trace), in percent."""


def read(ctx):
    r = ctx["record"]
    prof = r.get("profile")
    if not prof:
        return None
    device_ms = prof["ranges_ms"].get("conv", 0.0)
    if device_ms <= 0:
        return None
    cfgm = ctx["cell"].config_module
    per_frame = cfgm.conv_bound_s(cfgm.conv_list(ctx["config"]), ctx["peaks"])
    frames = sum(len(f) for f in r["profiled_requests"])
    return 100.0 * per_frame * frames * 1e3 / device_ms
