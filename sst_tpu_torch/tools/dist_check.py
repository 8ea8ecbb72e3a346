"""Check the data-parallel train step across processes: run the train CLI
under torchrun, one card (or CPU process) per rank, then require every
rank's parameters to equal rank 0's bit for bit (the step averages the
gradients over ranks, then each rank steps alike) and print, per rank, its
step times, loader waits, losses, peak memory and the sparse conv kernels'
launches per step.

    torchrun --nproc-per-node 4 -m sst_tpu_torch.tools.dist_check \
        configs/fsdv2/fsdv2_waymo_1x.py --synthetic --max-steps 6 \
        --work-dir work_dirs/dist_check --expect-devices 4

Each rank prints one line ``DIST_CHECK {json}``; the run exits non-zero
where the ranks' parameters differ.
"""
import hashlib
import json
import sys

import torch.distributed as dist

import sst_tpu_torch.train.step as step_mod
from sst_tpu_torch.ops import sparse_conv_dw as sdw
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.tools import train


def main(argv=None) -> None:
    seen = {"launches": []}
    real = step_mod.train_step

    def recording(model, opt, batch, kw=None):
        """The train step, the model kept and its launches counted."""
        seen["model"] = model
        before = (dict(scg.kind_counts), sdw.launches)
        out = real(model, opt, batch, kw)
        seen["launches"].append(
            {**{k: v - before[0].get(k, 0)
                for k, v in scg.kind_counts.items()},
             "dw": sdw.launches - before[1]})
        return out

    step_mod.train_step = recording  # the CLI imports it at its start
    try:
        summary = train.main(argv)
    finally:
        step_mod.train_step = real
    h = hashlib.sha256()
    for name, p in seen["model"].named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    grouped = dist.is_initialized()  # a run of one process makes no group
    rank, world = ((dist.get_rank(), dist.get_world_size()) if grouped
                   else (0, 1))
    digests = [h.hexdigest()] * world
    if grouped:
        dist.all_gather_object(digests, h.hexdigest())
    rec = {"rank": rank, "world": world, "step_ms": summary["step_ms"],
           "loader_wait_ms": summary["loader_wait_ms"],
           "loss_total": summary["loss_total"],
           "peak_memory_bytes": summary.get("peak_memory_bytes"),
           "launches_per_step": seen["launches"],
           "params_equal_on_all_ranks": len(set(digests)) == 1}
    print("DIST_CHECK " + json.dumps(rec), flush=True)
    if grouped:
        dist.barrier()
        dist.destroy_process_group()
    if len(set(digests)) != 1:
        sys.exit(f"rank parameters differ: {digests}")


if __name__ == "__main__":
    main()
