"""Training CLI of the port (counterpart of the JAX package's
``tools/train.py``).

    python -m sst_tpu_torch.tools.train configs/sst/sst_waymoD5_3class.py \\
        --work-dir work_dirs/sst --max-steps 1000 [--cfg-options k.a=v]
    torchrun --nproc-per-node 4 -m sst_tpu_torch.tools.train <config> ...

One process per card. Under torchrun the processes form one process group
(``utils/dist.py``): each rank loads its own shard of every epoch, and the
step averages gradients over the ranks (``train/step.py``). The model is
built from the config with random weights from ``--seed`` (rank 0's,
broadcast), trained with the config's AdamW and one-cycle rate, the FSD
detection schedule's ``pretrain`` / ``thr_extra`` and the
``disable_aug_schedule`` rebuild; each step's voxel shuffle and samplers
draw from a generator seeded from (``--seed``, step). Rank 0 writes
``train_log.jsonl`` (JAX's keys), checkpoints ``ckpt_{step}``
(``train/checkpoint.py``) and the in-train evaluation (``eval_ap`` over a
separate ``train=False`` module that loads the trained weights).
TensorBoard scalars are not written: the JSONL file is the record.
"""

from __future__ import annotations

import argparse
import ast
import inspect
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train a detector of the port from a config.",
        epilog="Several processes: launch with torchrun, whose RANK, "
               "WORLD_SIZE and LOCAL_RANK take the place of JAX's "
               "--coordinator, --num-processes and --process-id; the step "
               "is always the data-parallel one (JAX's --train-step "
               "shard_map).")
    p.add_argument("config")
    p.add_argument("--work-dir", default="work_dirs/default")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--resume-from", default=None,
                   help="a ckpt_{step} directory: weights, optimizer state "
                        "and step (the loader restarts at epoch 0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no real data needed)")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--ckpt-interval", type=int, default=1000)
    p.add_argument("--eval-interval", type=int, default=0,
                   help="run validation every N steps; 0 = the config's "
                        "evaluation.interval_steps or off")
    p.add_argument("--eval-samples", type=int, default=32,
                   help="cap on validation samples per in-train eval")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--expect-devices", type=int, default=0,
                   help="require this many processes (cards) in the run; "
                        "0 = any")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (each process takes cuda:LOCAL_RANK; "
                        "raises without a card) or 'cpu'")
    return p.parse_args(argv)


def apply_cfg_options(cfg: dict, options) -> dict:
    """``--cfg-options a.b=value ...``: each value parsed as a Python
    literal where it is one, else kept as a string."""
    from sst_tpu_torch.utils.config import set_by_dotted

    for opt in options:
        k, v = opt.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        set_by_dotted(cfg, k, v)
    return cfg


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A result tensor as numpy (bfloat16 as float32: numpy has none)."""
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def frames_of(out: dict, batch) -> tuple[list, list]:
    """One batch's predictions (valid boxes [N, 7], scores, labels) and gt
    (valid boxes [M, 7], labels), frame by frame, as numpy."""
    preds, gts = [], []
    for i in range(batch.points.shape[0]):
        ok = to_numpy(out["valid"][i])
        preds.append({"boxes": to_numpy(out["boxes"][i])[ok][:, :7],
                      "scores": to_numpy(out["scores"][i])[ok],
                      "labels": to_numpy(out["labels"][i])[ok]})
        gv = to_numpy(batch.gt_valid[i])
        gts.append({"boxes": to_numpy(batch.gt_boxes[i])[gv][:, :7],
                    "labels": to_numpy(batch.gt_labels[i])[gv]})
    return preds, gts


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step (JAX's ``PRNGKey(step)``), the same on
    every rank: seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def main(argv=None) -> dict:
    """Run the CLI; returns a summary: the steps run, per step its wall ms
    (the device synchronised at its end), the host ms spent waiting on the
    loader and ``loss_total``, the checkpoints written, the evaluations and
    the peak device memory."""
    args = parse_args(argv)

    from sst_tpu_torch.data.loader import DataLoader
    from sst_tpu_torch.data.pipelines import build_pipeline
    from sst_tpu_torch.flagship import init_weights
    from sst_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from sst_tpu_torch.train.data_setup import build_train_dataset
    from sst_tpu_torch.train.step import train_step
    from sst_tpu_torch.utils import dist
    from sst_tpu_torch.utils.builders import (
        build_model_from_cfg,
        optimizer_from_cfg,
        schedule_from_cfg,
    )
    from sst_tpu_torch.utils.config import load_config

    rank, world, device = dist.init_from_env(args.device)
    if args.expect_devices and world != args.expect_devices:
        raise SystemExit(f"--expect-devices {args.expect_devices} but the "
                         f"run has {world} process(es)")
    lead = rank == 0
    cfg = apply_cfg_options(load_config(args.config), args.cfg_options)
    if lead:
        os.makedirs(args.work_dir, exist_ok=True)
    model = build_model_from_cfg(cfg, train=True, device=device)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    dist.broadcast_module(model)
    model.train()

    batch_size = cfg.get("data", {}).get("samples_per_device", 1)
    dataset, collate, ds_kind, train_pipeline_cfg = build_train_dataset(
        cfg, model, synthetic=args.synthetic, seed=args.seed,
        batch_size=batch_size)
    loader = DataLoader(dataset, batch_size=batch_size, seed=args.seed,
                        num_shards=world, shard_id=rank,
                        **({} if collate is None else {"collate": collate}))
    total_steps = args.max_steps or cfg.get("schedule", {}).get("max_steps",
                                                                10000)
    opt = optimizer_from_cfg(model, cfg, total_steps)
    step = 0
    if args.resume_from:
        step = load_checkpoint(args.resume_from, model, opt)
    start_step = step

    sched = schedule_from_cfg(cfg)
    loss_params = set(inspect.signature(model.loss).parameters)
    aug_sched = None
    if "disable_aug_schedule" in cfg and ds_kind == "waymo":
        from sst_tpu_torch.train.schedules import DisableAugmentationSchedule

        aug_sched = DisableAugmentationSchedule(**cfg["disable_aug_schedule"])

    eval_interval = args.eval_interval or cfg.get(
        "evaluation", {}).get("interval_steps", 0)
    eval_model = val_ds = val_classes = None
    if eval_interval and lead:
        from sst_tpu_torch.train.data_setup import build_val_dataset

        val_ds, val_classes = build_val_dataset(
            cfg, model, synthetic=args.synthetic,
            num_samples=args.eval_samples)
        if val_ds is None:
            print("in-train eval disabled: no val dataset for "
                  f"data.dataset={cfg.get('data', {}).get('dataset')!r} "
                  "(set data.val_info_path)", flush=True)
            eval_interval = 0
        else:
            eval_model = build_model_from_cfg(cfg, train=False,
                                              device=device).eval()

    def run_eval():
        from sst_tpu_torch.core.evaluation import eval_ap

        # a copy of the trained weights: nothing made under inference
        # mode reaches the train module
        eval_model.load_state_dict(model.state_dict())
        preds, gts = [], []
        vloader = DataLoader(val_ds, batch_size=1, shuffle=False,
                             drop_last=False)
        for bi, vb in enumerate(vloader):
            if bi >= args.eval_samples:
                break
            vb = vb.to(device)
            p, g = frames_of(eval_model.predict(vb), vb)
            preds += p
            gts += g
        return eval_ap(preds, gts, val_classes)

    def loss_kwargs(s: int) -> dict:
        kw = sched(s) if sched is not None else {}
        kw = {k: v for k, v in kw.items() if k in loss_params}
        if "generator" in loss_params:
            kw["generator"] = step_generator(args.seed, s, device)
        return kw

    cuda = device.type == "cuda"
    summary = {"start_step": start_step, "step_ms": [], "loader_wait_ms": [],
               "loss_total": [], "checkpoints": [], "eval": []}
    log_path = os.path.join(args.work_dir, "train_log.jsonl")
    t0 = time.time()
    logf = open(log_path, "a") if lead else None
    try:
        while step < total_steps:
            if aug_sched is not None and step >= aug_sched.disable_after_step:
                dataset.pipeline = build_pipeline(
                    aug_sched.filter_pipeline(train_pipeline_cfg, step))
                aug_sched = None  # applied once
            batches = iter(loader)
            while step < total_steps:
                tw = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                ts = time.perf_counter()
                metrics = train_step(model, opt, batch.to(device),
                                     loss_kwargs(step))
                loss_total = float(metrics["loss_total"])
                if cuda:
                    torch.cuda.synchronize(device)
                summary["step_ms"].append((time.perf_counter() - ts) * 1e3)
                summary["loader_wait_ms"].append((ts - tw) * 1e3)
                summary["loss_total"].append(loss_total)
                step += 1
                if not lead:
                    continue
                if step % args.log_interval == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["wall"] = round(time.time() - t0, 1)
                    logf.write(json.dumps(m) + "\n")
                    logf.flush()
                    print(f"step {step}/{total_steps} "
                          f"loss={m['loss_total']:.4f} ({m['wall']}s)",
                          flush=True)
                if eval_interval and (step % eval_interval == 0
                                      or step == total_steps):
                    em = {f"val/{k}": float(v) for k, v in run_eval().items()
                          if isinstance(v, (int, float))}
                    em["step"] = step
                    logf.write(json.dumps(em) + "\n")
                    logf.flush()
                    summary["eval"].append(em)
                    head = {k: round(v, 4) for k, v in list(em.items())[:6]}
                    print(f"eval @ {step}: {head}", flush=True)
                if step % args.ckpt_interval == 0 or step == total_steps:
                    path = save_checkpoint(
                        os.path.join(args.work_dir, f"ckpt_{step}"), model,
                        opt, step)
                    summary["checkpoints"].append(path)
                    print(f"saved {path}", flush=True)
    finally:
        if logf is not None:
            logf.close()
    if lead:
        print("done", flush=True)
    summary["steps"] = step - start_step
    if cuda:
        summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return summary


if __name__ == "__main__":
    main()
