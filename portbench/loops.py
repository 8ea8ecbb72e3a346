"""The loops a traffic file names (``"loop"``): a closed loop of batched
predicts and a closed loop of train steps. Each warms up the cell's own
shapes, measures for ``seconds``, and keeps what the correctness check
needs. With ``trace`` it also installs the configuration's spans for the
window and, once the window has closed, runs ``torch.profiler`` over
``PROFILED`` more requests."""

from __future__ import annotations

import time

import numpy as np

from portbench import harness

PROFILED = 6  # requests or steps of the traced sub-window
WARMUP = 3  # requests before the predict window (every shape is static)


def profile(run, first: int, torch) -> tuple:
    """Two traces of ``PROFILED`` calls of ``run(i)`` each, from ``i =
    first``, after the measured window has closed, so starting and reading
    the profiler costs the window nothing: one of the device alone, whose
    busy and wall seconds give the idle share at the least cost to the
    host, then one of the host and the device, whose ranges attribute
    device time to the spans and whose host operations label the idle
    gaps. One call under the profiler before them is discarded (its first
    start sets up the tracer). Returns (the device-only trace's busy and
    wall seconds with the full trace's kernels, ranges and breakdown, as
    ``harness.read_profile`` reads them; the indices of the full trace's
    calls)."""
    cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=[cpu, cuda]):
        run(first)
        torch.cuda.synchronize()
    reads = []
    for acts in ([cuda], [cpu, cuda]):
        first += 1
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(first, first + PROFILED):
                run(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        reads.append(harness.read_profile(prof, wall))
        first += PROFILED - 1
    out = dict(reads[1], busy_s=reads[0]["busy_s"],
               window_s=reads[0]["window_s"])
    return out, range(first - PROFILED + 1, first + 1)


def predict(cell, seed: int, seconds: float, trace: bool, device):
    """One client, closed loop: batch ``i`` takes pool frames ``i * B`` to
    ``i * B + B - 1`` (cyclic), each through the port's
    ``apis.prepare_batch``, joined into one ``PointBatch``, predicted, and
    every frame's result copied to the host as numpy before the next batch
    is sent. A request is one batch; its time runs from its dispatch to
    its boxes on the host."""
    phases = harness.Phases()
    import torch

    from portbench.traffic import generator
    from sst_tpu_torch.apis import prepare_batch
    from sst_tpu_torch.models import PointBatch

    cfgm, cfg, traffic = cell.config_module, cell.config, cell.traffic
    phases.mark("imports")
    pool = generator.make_pool(traffic, seed)
    phases.mark("frames")
    model = cfgm.build(cfg, traffic, device)
    phases.mark("build")
    weights = harness.draw_weights(model, seed, cfgm.init_rule, device)
    adjust, reference_s = harness.adjust_weights(cfgm, cfg, traffic, pool,
                                                 weights, device)
    phases.mark("weights")
    harness.load_weights(model, weights)
    del weights
    model.eval()
    b, n_pool = traffic["batch"], traffic["pool"]

    def frames_of(i):
        return [(i * b + j) % n_pool for j in range(b)]

    def request(i):
        parts = [prepare_batch(model, pool[f]["points"], model.max_points)
                 for f in frames_of(i)]
        batch = PointBatch(points=torch.cat([p.points for p in parts]),
                           valid=torch.cat([p.valid for p in parts]))
        res = model.predict(batch)
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .cpu().numpy() for k, v in res.items()}

    for i in range(WARMUP):
        request(i)
    torch.cuda.synchronize()
    phases.mark("warm-up")

    spans = None
    if trace:
        spans = harness.Spans()
        cfgm.install_spans(spans, model, traffic)
    results, lat = [], []
    t_window = time.time()
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        results.append(request(i))
        lat.append(time.perf_counter() - t)
        i += 1
    window_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    failed = sum(not (np.isfinite(r["boxes"]).all()
                      and np.isfinite(r["scores"]).all()) for r in results)
    record = {
        "t_window": t_window, "window_s": window_s, "requests": i,
        "frames": i * b, "latencies_s": lat, "failed": failed,
        "results": results, "frames_of": frames_of, "pool": pool,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(),
        "weight_adjust": adjust, "reference_s": reference_s,
        "setup_phases": phases.seconds,
    }
    if trace:
        record["spans"] = spans.totals()
        record["window_frames"] = [frames_of(k) for k in range(i)]
        record["profile"], done = profile(request, i, torch)
        record["profiled_requests"] = [frames_of(k) for k in done]
        spans.remove()
    del model
    torch.cuda.empty_cache()
    return record


def train(cell, seed: int, seconds: float, trace: bool, device):
    """Back-to-back ``train/step.py train_step`` calls at batch 1: step
    ``i`` moves pool frame ``i`` (cyclic) to the card and trains on it.
    The first ``checked_steps`` steps are the warm-up; the optimizer state
    after the first and the parameters after the last are kept for the
    check. The host runs as far ahead as the program lets it; the window
    ends with a ``torch.cuda.synchronize()``."""
    phases = harness.Phases()
    import torch

    from portbench.traffic import generator
    from sst_tpu_torch.models import PointBatch
    from sst_tpu_torch.train.step import train_step

    cfgm, cfg, traffic = cell.config_module, cell.config, cell.traffic
    phases.mark("imports")
    pool = generator.make_pool(traffic, seed)
    phases.mark("frames")
    model = cfgm.build(cfg, traffic, device)
    phases.mark("build")
    weights = harness.draw_weights(model, seed, cfgm.init_rule, device)
    adjust, reference_s = harness.adjust_weights(cfgm, cfg, traffic, pool,
                                                 weights, device)
    phases.mark("weights")
    harness.load_weights(model, weights)
    initial = {n: w.clone() for n, w in weights.items()}
    del weights
    model.train()
    opt = cfgm.optimizer(model, cfg)
    kwargs = cfgm.loss_kwargs(cfg, seed, device)
    n_pool = traffic["pool"]

    def step(i):
        f = pool[i % n_pool]
        batch = PointBatch(points=f["points"][None],
                           valid=np.ones((1, len(f["points"])), bool),
                           gt_boxes=f["gt_boxes"][None],
                           gt_labels=f["gt_labels"][None],
                           gt_valid=f["gt_valid"][None]).to(device)
        return train_step(model, opt, batch, kwargs)

    checked = traffic["checked_steps"]
    losses, first_grads = [], None
    for i in range(checked):
        out = step(i)
        losses.append(out["loss_total"])
        if i == 0:
            first_grads = cfgm.optimizer_first_grads(opt, model)
    with torch.no_grad():
        change = {n: (p.detach() - initial[n]).cpu()
                  for n, p in model.named_parameters()}
    del initial
    losses = [x.item() for x in losses]
    torch.cuda.synchronize()
    phases.mark("warm-up")

    spans = None
    if trace:
        spans = harness.Spans()
        cfgm.install_spans(spans, model, opt, traffic)
    t_window = time.time()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        step(checked + i)
        i += 1
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    record = {
        "t_window": t_window, "window_s": window_s, "requests": i,
        "frames": i * traffic["batch"], "failed": 0, "pool": pool,
        "losses": losses, "first_grads": first_grads, "change": change,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(),
        "weight_adjust": adjust, "reference_s": reference_s,
        "setup_phases": phases.seconds,
    }
    if trace:
        record["spans"] = spans.totals()
        record["backward_ms"] = spans.between("backward", "loss",
                                              "optimizer")
        record["window_frames"] = [[(checked + k) % n_pool]
                                   for k in range(i)]
        record["profile"], done = profile(step, checked + i, torch)
        record["profiled_requests"] = [[k % n_pool] for k in done]
        spans.remove()
    del model, opt
    torch.cuda.empty_cache()
    return record


LOOPS = {"predict": predict, "train": train}
