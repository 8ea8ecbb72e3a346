"""The dense FSDv2 configuration's module at the tiny sizes of
``fsdv2_tiny.json``: the port's model is built from the file's sizes (the
full-size builder has fixed widths), all else is the real module's."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from portbench import harness  # noqa: E402

_real = harness.load_module(
    harness.HERE / "configs" / "fsdv2_dense_bf16.py", "portbench_fsdv2_real")
globals().update({k: v for k, v in vars(_real).items()
                  if not k.startswith("__")})


def build(cfg, traffic, device):
    import torch

    from sst_tpu_torch.models.fsd.fsdv2 import FSDV2Caps, SingleStageFSDV2

    k = traffic["batch"]
    m = harness.tuples(cfg["model"])
    caps = m.pop("caps")
    m["segmentor"] = dict(m["segmentor"],
                          max_voxels=m["segmentor"]["max_voxels"] * k)
    model = SingleStageFSDV2(
        num_point_features=cfg["num_point_features"],
        caps=FSDV2Caps(fg_per_class=tuple(c * k for c in caps["fg_per_class"]),
                       voxels=caps["voxels"] * k,
                       union_voxels=caps["union_voxels"] * k,
                       virtual_out=caps["virtual_out"] * k),
        dtype=getattr(torch, cfg["dtype"]), **m).to(device)
    model.max_points = cfg["max_points"]
    return model
