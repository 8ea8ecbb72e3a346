"""The SST configuration's module at the tiny sizes of ``sst_tiny.json``:
the port's model is built from the file's sizes (the full-size builder
has fixed widths), all else is the real module's."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from portbench import harness  # noqa: E402

_real = harness.load_module(
    harness.HERE / "configs" / "sst_bf16.py", "portbench_sst_real")
globals().update({k: v for k, v in vars(_real).items()
                  if not k.startswith("__")})


def build(cfg, traffic, device):
    import torch

    from sst_tpu_torch.models import DynamicVoxelNet
    from sst_tpu_torch.ops.window import BucketSpec

    m = harness.tuples(cfg["model"])
    m["buckets"] = tuple(BucketSpec(*b) for b in m["buckets"])
    m["backbone"] = dict(m["backbone"], conv_kwargs=tuple(
        dict(c) for c in m["backbone"]["conv_kwargs"]))
    model = DynamicVoxelNet(num_point_features=cfg["num_point_features"],
                            dtype=getattr(torch, cfg["dtype"]), **m)
    model.max_points = cfg["max_points"]
    return model.to(device)
