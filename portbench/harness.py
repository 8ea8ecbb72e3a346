"""What every cell shares: finding a cell's configuration, traffic and
metrics by name, the environment of a run, the weights drawn from the seed,
the statistics of the window, the spans and the device trace, and the
result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its configuration
is ``portbench/configs/<config>.json`` (the sizes) with
``portbench/configs/<config>.py`` beside it (the port's build, the plain
reference and the count of operations), its traffic
``portbench/traffic/<traffic>.json`` (parameters that ``traffic/generator.py``
and a loop of ``loops.py`` read), and each per-layer metric a reader
``portbench/metrics/<metric>.py``. Nothing here names a cell."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "sst_tpu")


def process_start_epoch() -> float:
    """The wall-clock time at which this process started (from
    ``/proc/self/stat``), so set-up counts the interpreter's start and the
    imports."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed directory
    inside the checkout (the port's nvcc builds already go to
    ``sst_tpu_torch/csrc/build/``)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, spec_path: Path = ROOT / "BENCHMARK.json"):
        spec = json.loads(spec_path.read_text())
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             f"{spec_path.name}; there are {sorted(by_name)}")
        self.workload = by_name[name]
        self.name = name
        conf = next(c for c in spec["configs"]
                    if c["name"] == self.workload["config"])
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.config_module = load_module(
            (ROOT / conf["file"]).with_suffix(".py"),
            f"portbench_config_{conf['name'].replace('.', '_')}")
        # a test's benchmark file may keep its traffic beside it
        tname = f"{self.workload['traffic']}.json"
        local = spec_path.parent / "traffic" / tname
        self.traffic = json.loads(
            (local if local.exists() else HERE / "traffic" / tname)
            .read_text())
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    def metric_reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric.replace('.', '_')}")


# ------------------------------------------------------------- statistics

def rate(units: float, seconds: float) -> float:
    """Work per second over the whole window."""
    return units / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile of all ``values``: the smallest
    value with at least ``q`` percent of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, edge = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > edge:
            total += end - max(start, edge)
            edge = end
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps between the union of (start, end) intervals within
    [lo, hi], as (start, end) pairs."""
    gaps, edge = [], lo
    for start, end in sorted(intervals):
        if start > edge:
            gaps.append((edge, min(start, hi)))
        edge = max(edge, end)
    if hi > edge:
        gaps.append((edge, hi))
    return [(a, b) for a, b in gaps if b > a]


def tuples(x):
    """``x`` (a configuration file's value) with its lists as tuples, as
    the model constructors take them."""
    if isinstance(x, list):
        return tuple(tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: tuples(v) for k, v in x.items()}
    return x


# ---------------------------------------------------------------- weights

def draw_weights(model, seed: int, init_rule, device) -> dict:
    """Random weights from ``seed``, by parameter name and shape, in a few
    large draws on the card: one normal draw for every parameter that
    ``init_rule(name, shape)`` gives ``("normal", std)``, in the order of
    the sorted names; ``("const", value)`` fills. Returns the float32
    tensors by name, for the port and the reference alike."""
    import torch

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rules = {n: init_rule(n, s) for n, s in shapes.items()}
    normal = sorted(n for n, r in rules.items() if r[0] == "normal")
    total = sum(math.prod(shapes[n]) for n in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n in normal:
        k = math.prod(shapes[n])
        out[n] = flat[at:at + k].view(shapes[n]) * rules[n][1]
        at += k
    for n, r in rules.items():
        if r[0] == "const":
            out[n] = torch.full(shapes[n], float(r[1]), device=device)
    return out


def adjust_weights(cfgm, cfg, traffic, pool, weights, device) -> tuple:
    """The configuration's adjustment of the drawn weights, where it has
    one (``adjust_weights`` in its module, worked out by the benchmark's
    reference, never by the port): the deltas it added, by name, so that
    the check can add them to the reference's draw too, and the seconds it
    took, which the set-up time leaves out (the reference's time is not
    the program's)."""
    hook = getattr(cfgm, "adjust_weights", None)
    t0 = time.perf_counter()
    deltas = hook(cfg, traffic, pool, weights, device) if hook else {}
    return deltas, time.perf_counter() - t0


def apply_adjust(weights: dict, adjust: dict) -> None:
    for n, delta in adjust.items():
        weights[n] += delta.to(weights[n].device)


def load_weights(model, weights: dict) -> None:
    """Copy ``weights`` into ``model``'s parameters; the names and shapes
    have to match one to one."""
    import torch

    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(
            f"parameter names differ: only in the model "
            f"{sorted(set(params) - set(weights))[:5]}, only in the weights "
            f"{sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for n, p in params.items():
            if tuple(p.shape) != tuple(weights[n].shape):
                raise RuntimeError(f"{n}: shape {tuple(p.shape)} against "
                                   f"{tuple(weights[n].shape)}")
            p.copy_(weights[n])


# ------------------------------------------------------------------ spans

class Spans:
    """CUDA-event spans around calls into the port, installed from the
    benchmark's side: hooks on module boundaries and wrappers on instance
    attributes. Each span also opens a ``torch.profiler.record_function``
    range of its name, so the device trace attributes kernels to it.
    ``totals()`` synchronises and gives, per span name, the total time in
    ms and the number of calls."""

    def __init__(self):
        import torch

        self.torch = torch
        self.events = defaultdict(list)  # name -> [(start, end)]
        self._open = {}
        self._undo = []

    def _start(self, name):
        torch = self.torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rf = torch.profiler.record_function(f"portbench::{name}")
        rf.__enter__()
        self._open.setdefault(name, []).append((ev, rf))

    def _end(self, name):
        torch = self.torch
        start, rf = self._open[name].pop()
        rf.__exit__(None, None, None)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.events[name].append((start, end))

    def module(self, name: str, module) -> None:
        """A span from ``module``'s forward pre-hook to its forward hook."""
        h1 = module.register_forward_pre_hook(
            lambda *_: self._start(name))
        h2 = module.register_forward_hook(lambda *_: self._end(name))
        self._undo += [h1.remove, h2.remove]

    def method(self, name: str, obj, attr: str) -> None:
        """A span around every call of ``obj.attr`` (an instance attribute
        set over the bound method, removed by ``remove``)."""
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            self._start(name)
            try:
                return inner(*args, **kwargs)
            finally:
                self._end(name)

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr))

    def between(self, name: str, first: str, second: str) -> list:
        """Per call, ms from the end of span ``first`` to the start of the
        following span ``second`` (the backward between the loss and the
        optimizer step)."""
        return [a[1].elapsed_time(b[0]) for a, b in
                zip(self.events[first], self.events[second])]

    def totals(self) -> dict:
        self.torch.cuda.synchronize()
        return {name: {"total_ms": sum(s.elapsed_time(e) for s, e in evs),
                       "count": len(evs)}
                for name, evs in self.events.items()}

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


# ----------------------------------------------------------- device trace

def read_profile(prof, window_s: float, range_prefix: str = "portbench::"
                 ) -> dict:
    """From a ``torch.profiler`` trace of a sub-window: the device's busy
    seconds (the union of its kernel, copy and set intervals), the device
    ms of each kernel name, the device ms inside each benchmark range
    (kernels launched under it), and the breakdown: the 10 device
    operations that took most time and the 10 longest idle gaps, each
    labelled by the innermost host operation running when it began (or,
    where the host ran Python outside every traced operation then, by the
    operation it started next)."""
    import torch

    dev, cpu, ranges = [], [], defaultdict(float)
    kernels = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(range_prefix):
                continue  # the ranges' own device-side marks, no work
            dev.append((e.time_range.start, e.time_range.end))
            kernels[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        else:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
            if e.name.startswith(range_prefix):
                ranges[e.name[len(range_prefix):]] += e.device_time_total / 1e3
    busy_s = union_seconds(dev) / 1e6
    out = {"busy_s": busy_s, "window_s": window_s, "kernels_ms": dict(kernels),
           "ranges_ms": dict(ranges)}
    if dev:
        lo = min(a for a, _ in dev)
        hi = max(b for _, b in dev)
        gaps = sorted(idle_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
        cpu.sort()
        labelled = []
        for a, b in gaps:
            inner, after = None, None
            for s, e, name in cpu:
                if s > a:
                    after = name
                    break
                if e >= a and (inner is None or s >= inner[0]):
                    inner = (s, name)
            label = (inner[1] if inner else
                     f"host outside any op, then {after}" if after else
                     "host outside any op")
            labelled.append([label[:200], (b - a) / 1e6])
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {
            "device_ops": [[n[:200], ms / 1e3] for n, ms in top],
            "idle_gaps": labelled}
    return out


# ------------------------------------------------------------ the run end

class Phases:
    """The wall-clock seconds of a run's set-up phases, in order, for
    stderr: where the set-up time goes."""

    def __init__(self):
        self.t = time.time()
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.time()
        self.seconds[name] = now - self.t
        self.t = now


def power_limit_w(index: int = 0):
    """The card's enforced power limit in watts, from NVML where
    ``pynvml`` imports, else from ``nvidia-smi``; None where neither
    answers. A card set below its maximum runs slower under load, so the
    limit stands beside every rate and share of a peak."""
    try:
        import pynvml

        pynvml.nvmlInit()
        try:
            handle = pynvml.nvmlDeviceGetHandleByIndex(index)
            return pynvml.nvmlDeviceGetEnforcedPowerLimit(handle) / 1000.0
        finally:
            pynvml.nvmlShutdown()
    except Exception:
        pass
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except Exception:
        return None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of the JAX package's or JAX's own, compared whole."""
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN_TOP_LEVEL)


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
