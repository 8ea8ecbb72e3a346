"""GPU smoke run of the PyTorch port's ``predict`` paths and train steps at
full width on one CUDA card, through their hand-written kernels:
FSDv2-Waymo's dense-BEV build at its default bf16 compute policy and in
float32 beside it (sorted segment reduce kernel, its bf16 and float32
routes, in predict and training), its sparse-UNet build (sorted segment
reduce and sparse conv kernels; in training also the sparse conv's
weight-gradient kernel, and the conv kernel over the transposed tables for
the input gradient), SST-Waymo in float32 and at its bf16 default (window
MHA kernel; in training under autograd, with the JAX package's
einsum-recompute backward in torch ops, the blocks rematerialised), FSD
two-stage predict and training (sparse conv kernel; in training also the
weight-gradient kernel and the input gradient), built from its config,
FSD++ (the FSD two stage behind the incremental point selection, sparse
and dense-BEV) predict and training, built from its config, CTRL's
``TrackletDetector`` (its data path, predict and train step; sparse conv,
input gradient and dW kernels) and the ``FSDV2`` two stage (sorted reduce
and sparse conv kernels; its loss's backward through dW), both built
through the config builder; the CLIs and the offline workflows (the
Waymo bin, FSD++'s seeds and sequential train and test, CTRL's chain);
the CenterHead and weighted-NMS SST configs and FSD with the SST encoder
(window MHA kernel), and the preflight, benchmark and soak tools;
PointPillars from its config (predict and the CLIs, no kernel of ours on
its path), SECOND's ``SparseEncoder`` (sparse conv, input gradient and dW
kernels at 27 and 3 taps) and the dynamic pillar VFE (sorted reduce).

    python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit code):
  1. device   the card's name and power limit; there is no CPU path.
  2. build    compile every kernel from ``sst_tpu_torch/csrc``, one nvcc per
              source, all started together.
  3. kernels  the sorted reduce and its offsets kernel against their plain
              PyTorch twins on the card, at the dense path's shapes: the
              reductions of the bf16 ``fsdv2_waymo_dense`` (its default
              dtype) recorded from its main path on frame 0 (a float32
              cluster-centre sum at C = 3, two bf16 maxima at C = 64) and
              the float32 build's maxima at the same ids; then edge cases
              in float32 and bf16 (NaN and +-inf, ids out of range, a
              3000-row segment, a mostly empty segment range at the
              segmentor's 196,608 rows and 131,072 segments); a max equal
              bit for bit, a bf16 sum within one bf16 ulp; offsets computed
              by the wrapper and passed in give the same bits; kernel,
              twin and ``torch.segment_reduce`` timed on the same rows, the
              bound at each dtype's bytes, and the wrapper's host time.
  4. predict  the bf16 ``fsdv2_waymo_dense`` (random weights from a seed)
              answers four synthetic Waymo frames through
              ``apis.inference_detector``; the kernels' launch counts by
              (mode, C, dtype) must equal the modules' (1 float32 sum at
              C = 3, 2 bf16 maxima at C = 64, 1 offsets launch per frame).
  5. A/B      segmentor outputs with the sorted reduce on and off agree, in
              the bf16 build and in the float32 build with the same
              weights; the float32 build answers the four frames (its
              launches counted from zero), how many of its detections the
              bf16 build shares is printed; predict latency of bf16 with
              the kernel, bf16 with the scatters and float32 with the
              kernel, in rotation.
     batch 4  ``fsdv2_waymo_dense(cap_scale=4)`` with the same weights on
              ``synthetic_waymo_batch(batch_size=4)``, the counterpart of
              ``bench.py bench_fsdv2_b4``: 2 timed batches, launches
              counted, ms per frame amortised.
 12. dense train  the bf16 model, then the float32 one, trains on four
              labelled frames (``synthetic_labeled_batch``): 2 warm-up and
              6 timed ``train_step`` calls in the detection schedule's
              step-0 mode, 3 more steps timed by stage (loss, backward,
              optimizer), one ``pretrain=False`` step; step ms, peak
              memory, losses, grad norms, and the sorted reduce's and
              offsets kernel's launches per step by (mode, C, dtype),
              counted at the launch sites and held against the modules.
  6. sparse kernels  the sparse conv kernel against its twin at every conv
              of one frame of ``fsdv2_waymo(backbone="sparse")`` (the
              rulebooks of frame 0 and their row schedules, recorded by
              hooks on each SparseConvLayer) and on edge cases, both timed;
              a second run without the plan's schedule (the wrapper builds
              one) gives the same bits; per conv the share of (row, tap)
              pairs with a neighbour, the executed share of the earlier
              SIMT kernel's 8-row-group skip and of the tile schedule, and
              the schedule's build time.
  7. sparse predict  ``fsdv2_waymo(backbone="sparse")`` (float32) answers
              the four frames; 58 sparse conv launches and 3 sorted reduce
              launches per frame, counted at the launch sites; latency
              timed.
 10. backward kernels  on labelled frame 0 (``synthetic_labeled_batch``),
              hooks record every conv's input and rulebook; the weight-
              gradient kernel and the input gradient (the conv kernel over
              the transposed table) against their twins at all 58 convs,
              with a seeded output gradient, and on edge cases; dW over the
              plan's row schedule and over one the wrapper builds, and two
              runs, equal bit for bit; both timed per step beside the
              bound, per conv the executed share of (row, tap) pairs, and
              the dW wrapper's host time.
 11. train    the same model trains on four labelled frames: 2 warm-up and
              6 timed ``train_step`` calls in the detection schedule's
              step-0 mode (``pretrain=True``), 3 more steps timed by stage
              (loss, backward, optimizer), then one ``pretrain=False``
              step; step ms, peak memory, losses, grad norms and launches
              per step by kind (forward, recompute, input gradient, weight
              gradient, sorted reduce), held against the modules.
  8. SST kernels  the window MHA kernel against its twin on the attention
              inputs of every bucket of every layer of one frame of
              ``sst_waymo(train_buckets=False)`` (recorded by hooks on each
              WindowAttention), on valid query rows, and on edge cases;
              kernel, twin and ``F.scaled_dot_product_attention`` timed on
              each of those inputs (the kernel's work follows the pad), and
              the wrapper's host time per call; the bound counts the bytes
              and operations that input's pad leaves to the kernel; a
              second run gives the same bits, and rows of all-padded
              windows and 16-row query tiles are zeros.
  9. SST predict  ``sst_waymo`` answers four synthetic Waymo frames (x, y,
              z); 48 window MHA launches per frame at the shapes phase 8
              checked; capacity counters per frame; latency timed.
 13. SST train  ``sst_waymo(train_buckets=True)`` on four labelled frames
              within 74.8 m: on the 36 attention inputs of step 0 (hooks on
              each WindowAttention) the kernel forward + ported backward
              through autograd against the twin forward + ported backward
              (outputs at phase 8's tolerance, gradients the same bits) and
              against the float64 gradient, each input timed (kernel, twin
              and SDPA forward, ported backward); then 2 warm-up, 6 timed
              and 3 staged ``train_step`` calls with a seeded voxel-shuffle
              generator; step ms, stages, peak memory, losses, capacity
              counters, and 36 window MHA launches per step (6 blocks x 2
              shifts x 3 buckets) and 36 more in the rematerialised
              blocks' recompute, counted at the launch site by kind.
 16. SST bf16  ``sst_waymo(train_buckets=False, dtype=torch.bfloat16)``
              (``bench.py bench_sst``'s build) with phase 9's weights: phase
              8's kernel checks and timings on its frame 0's 48 attention
              inputs, phase 9's predict on the four frames (48 launches per
              frame), detections shared with the float32 build (printed),
              bf16 and float32 latency alternated, peak memory; after phase
              13, ``sst_waymo(train_buckets=True, dtype=torch.bfloat16)``
              trains as phase 13 does.

 14. FSD      configs/fsd/fsd_waymoD1_1x.py at full width through the
              port's config loader and ``build_model_from_cfg`` (seed-0
              weights; the segmentor head's vote weights set to pull points
              toward their voxel's centre and its class biases set so that
              0.6 of each fg cap passes its threshold on frame 0, so that
              no stage runs on an empty set); the sparse conv kernel
              against its twin on the recorded inputs of all 39 convs of
              frame 0, timed beside the twin and the bound; two-stage
              ``predict`` through ``apis.inference_detector`` on the four
              frames: 39 conv launches per frame, each frame's cap fills
              (fg points between a quarter and all of each cap, cluster
              voxels, clusters, CCL rounds, valid rois, paired points, the
              pool's overflow counters), finite outputs, at most max_num
              detections; latency of ``inference_detector`` and of
              ``predict(skip_rcnn=True)`` (median and range of 12 runs),
              stage times and peak memory; then
              configs/fsd/fsd_waymoD1_1x_dense.py the same way (no kernel
              on its path), its latency.

 15. FSD train  configs/fsd/fsd_waymoD1_1x.py at full width through
              ``build_model_from_cfg(cfg, train=True)`` (seed-0 weights;
              phase 14's vote and fg settings, the vote channels' batch
              norms set to pass them in train mode and the fg biases to a
              0.6 fill at thr_extra 0.3); dW and the input gradient against
              their twins on the recorded inputs of all 39 convs of a
              ``pretrain=False`` step, timed beside the bound; the config's
              AdamW and FSDDetectionSchedule: 2 warm-up, 6 timed and 3
              staged ``train_step`` calls at step 0 (``pretrain=True``,
              the segmentor alone), the same at ``enable_after``
              (``thr_extra=0.3``), one step at ``thr_extra=0.0``, the RoI
              sampler drawing from a seeded generator; 39 forward, 39
              recompute, 39 input-gradient and 39 dW launches per step;
              losses, counters, the sampler's kept positives and negatives
              per IoU piece; the RoI loss and its backward on 256 proposals
              made from frame 0's gt boxes with seeded jitter (positives,
              cars among them, finite gradients); a trace of 2 steps with
              the gathers as they are and 2 with the plain clamped gathers
              (``indexing_backward_kernel`` ms per step, idle share).
 17. FSD++    configs/fsdpp/fsdpp_waymo_2x.py at full width through the
              port's loader and ``build_model_from_cfg`` (seed-0 weights,
              phase 14's vote and fg settings on ``model.fsd_mod``, taken
              on the points FSD++ selects); the sparse conv kernel against
              its twin on all 39 convs of frame 0 at the half caps;
              ``predict`` on four ``bench.py bench_fsdpp`` frames
              (``flagship.synthetic_temporal_batch``): 39 launches per
              frame, the point selection's counts (residual current points,
              seed-cropped previous points, kept points, overflow), phase
              14's fills and outputs, latency with and without the RoI
              stage, stage times (the point selection first), a profiler
              trace, peak memory; configs/fsdpp/fsdpp_waymo_2x_dense.py
              predict (no kernel on its path), timed; then training with
              ``build_model_from_cfg(cfg, train=True)`` and the config's
              AdamW at thr_extra 0.3, the seed noise and the RoI sampler
              from one seeded generator: dW and the input gradient against
              their twins on all 39 convs of a train step, 2 + 6 + 3
              steps, 39 forward, 39 recompute, 39 input-gradient and 39 dW
              launches per step.

 18. CTRL     configs/ctrl/ctrl_veh_24e.py at full width through the
              port's loader and ``build_model_from_cfg`` (float32, seed-0
              weights, nothing cut) on ``bench.py bench_ctrl``'s tracks
              (32,768 points over 200 frames): the sparse conv kernel
              against its twin at all 18 convs of track 0, timed, and the
              wrapper's host time with its ctypes entry point bound once
              and set on every call; ``predict`` on four tracks (18 launches
              per track, the voxel fill, the pool's pairs and overflow
              counters, latency over 12 runs, peak memory); one track
              through the ported ``WaymoTrackletDataset`` and
              ``collate_tracklets`` from a world written to a temporary
              directory, and ``predict``; training on batches of 2 tracks
              (gt = tracker boxes + N(0, 0.05)) with the config's AdamW: dW
              and the input gradient against their twins at all 18 convs,
              2 + 6 + 3 ``train_step`` calls, 18 forward + 18 input-gradient
              + 18 dW launches per step, finite losses, ``mean_roi_iou``
              above 0.3.
 19. FSDV2    ``dict(type="FSDV2", single_stage=<fsdv2_waymo_1x.py's model
              without its type>)`` through ``build_model_from_cfg`` (the RoI
              head and ``rois_per_sample`` at the class defaults; the
              segmentor VFE on the sorted reduce, as the port's FSDv2
              builders set it; float32, seed-0 weights, the seg head's class
              biases shifted to a 0.6 fill of each fg cap): the sparse conv
              kernel against its twin at all 58 convs of frame 0, timed;
              refined and ``skip_rcnn`` predict on two of phase 7's frames
              (58 conv + 3 sorted reduce + 1 offsets launches per frame, the
              RoI pool's counters, latency, peak memory); one loss and
              backward on a labelled frame (dW and the input gradient
              against their twins at its 58 convs, finite losses and
              gradients, 58 forward and 58 dW launches).

 20. CLIs     the train and test CLIs in process (``phase_cli``): the
              FSDv2-Waymo train CLI, a resume and the test CLI's Waymo, SST
              and seg evaluations; then configs/fsdv2/fsdv2_nusc_1x.py's
              train CLI with ``data.dataset="nuscenes"``, CBGS and a
              10-sweep pipeline with ``ObjectSample`` over a
              nuScenes-format set written from a seed (3 steps, a resume),
              the test CLI's NDS on it, and configs/fsdv2/fsdv2_argo_2x.py's
              test CLI with CDS over an Argo2-format set; each run's
              launches held against the modules.
 21. groups   the group-sampling and multi-sweep recipes at full width,
              nothing cut, through ``build_model_from_cfg`` (seed-0
              weights, the seg head's class biases shifted so 0.6 of each
              group's fg cap passes on frame 0, the FSD models' votes
              contracted as in phase 14): configs/fsdv2/fsdv2_nusc_1x.py
              on frames of a keyframe and 9 sweeps of 34,000 points
              through ``NuScenesDataset`` and ``LoadPointsFromMultiSweeps``
              (the points the 196,608 cap kept printed),
              configs/fsdv2/fsdv2_argo_2x.py and
              configs/argo2/argo_onestage_12e.py on 131,072-point
              Argo2-format frames: each conv of frame 0 against its twin,
              predict (launches per frame held to the module's convs; the
              sorted reduce counted, 0), latency and peak memory, then one
              loss + backward (dW and the input gradient against their
              twins at every conv, launches by kind, finite losses and
              gradients, times); configs/fsd/fsd_waymoD1_1x_3f.py predict
              on 3-sweep frames, the down-sampling's kept points printed.
 22. offline  the offline workflows on a Waymo kitti-format set written
              from a seed (``data/format_writers.py write_waymo_set``: 2
              training sequences of 7 frames, 2 validation ones of 4,
              196,608 points and 40 moving objects per frame, poses, the
              converter's maps, a gt tfrecord), with ``jax``, ``flax`` and
              ``sst_tpu`` blocked from import and absent from
              ``sys.modules`` at the end: configs/fsd/fsd_waymoD1_1x.py's
              test CLI with ``--eval dataset`` (phase 14's vote and fg
              settings, through a checkpoint), ``WaymoDataset.
              format_results`` and the bin read back; the FSD++ seed tools
              and segment breaks; configs/fsdpp/fsdpp_waymo_2x.py's train
              CLI on the incremental set (3 steps and a resume; the conv,
              input gradient and dW against their twins at a step's shapes
              first) and ``tools.test --sequential`` (fed-back seeds, conv
              against its twin at frame 1's shapes); CTRL's chain on
              configs/ctrl/ctrl_veh_24e.py (pose tables, the gt bin from
              the tfrecord, a tracker's bin from the FSD detections,
              extension, tracklets, candidates, 2 train CLI steps, predict
              over every track, the refined bin and its score, a merge,
              empty boxes removed, a submission parsed back); the gt
              objects' own tracks, moved to the world by the poses,
              match their gt boxes on every frame once ``generate_
              candidates --poses`` moves those too. Every run's launches
              are held against the modules.
 23. heads    with ``jax``, ``flax`` and ``sst_tpu`` blocked, at full width
              through ``build_model_from_cfg`` (seed-0 weights):
              configs/sst/sst_waymoD5_3class_centerhead.py (the window MHA
              against its twin on frame 0's 48 attention inputs, timed;
              predict on 3 x, y, z frames: 48 launches per frame and no
              other kernel, stage times, peak memory, idle share), the
              D1 2x CenterHead file and sst_waymoD5_car_wnms.py the same
              way on the same shapes; both CenterHead files' train steps
              (2 + 6 + 3, 36 forward + 36 recompute launches, the kernel
              against its twin on step 0's inputs);
              configs/fsd/fsd_waymoD1_1x_sst_encoder.py (phase 14's vote
              and fg settings; the kernel on frame 0's 24 inputs; predict
              with 24 launches per frame and no conv, dW or sorted reduce;
              fills, latency, stages, peak memory, idle share) and one
              loss + backward per step for 2 steps;
              configs/fsd/fsd_sst_encoder_pretrain.py's segmentor-pretrain
              steps; then the benchmark tool on the CenterHead config (its
              preflight of all four kernels first) and a 30-step soak of
              ``sst``, which must hold every invariant.
 24. pointpillars  with ``jax``, ``flax`` and ``sst_tpu`` blocked:
              configs/pointpillars/pointpillars_waymoD5_3class.py at full
              width through ``build_model_from_cfg`` (seed-0 weights): the
              pillar fill of 3 seeded 196,608-point frames (points in
              range, distinct and kept pillars of the 32,000, points kept
              of 20 per pillar), predict through ``inference_detector``
              (finite boxes, every kernel's launch count held at 0: hard
              pillars, cuDNN convs), latency, the stage table (voxelize,
              PFN, scatter, SECOND, FPN, head, decode + NMS), peak memory
              and idle share; the train CLI (``--synthetic``, 3 steps at 2
              samples per card) and the test CLI on its checkpoint, no
              kernel launched. SECOND's ``SparseEncoder`` at its defaults
              on mmdet3d's SECOND KITTI middle-encoder shape (sparse shape
              [41, 1600, 1408], 4 features, the voxels of a seeded frame
              through ``hard_voxelize`` and ``HardSimpleVFE``): each of
              its 12 convs (27 taps, and the 3-tap z-only ``conv_out``),
              input gradients and dW against their twins on the recorded
              inputs of a train-mode forward, timed; then a forward (12
              launches by (mode, Cin, Cout), held to the module) and one
              loss + backward (12 forward, 11 input-gradient, 12 dW
              launches; dW of ``conv_out`` [3, 64, 128]). Then
              ``DynamicPillarFeatureNet(use_sorted_reduce=True)`` at the
              PointPillars grid on frame 0: its sum and max against their
              twin, timed beside ``torch.segment_reduce``, 2 launches and 1
              offsets launch.

Phase 5, the batch-4 phase and phase 12 run after phase 4 on the dense
models; phases 10 and 11 after phase 7, on the sparse model; phase 16's
predict after phase 9, then phase 13 and phase 16's training on models
with the training buckets; phases 14, 15, 17, 18, 19, 20, 21, 22, 23
and 24 last. Phase 8 also measures the window MHA wrapper's host time with
its entry point bound once and set on every call. TF32 is turned off for
convolutions and matmuls, so every float32 comparison is in full
float32. Kernel, twin and library times are device times: each
timed call is queued behind a short ``torch.cuda._sleep``
(``utils/timing.py cuda_ms``). The line before the last is the kernels
JSON (every kernel's time, its plain twin's, its bound on the card and a
library call's where there is one); the last line of standard output is
the result JSON.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import pickle
import shutil
import statistics
from collections import Counter
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from sst_tpu_torch.apis import (
    frame_to_numpy,
    inference_detector,
    prepare_batch,
)
from sst_tpu_torch.flagship import (
    fsdv2_waymo,
    fsdv2_waymo_dense,
    init_weights,
    sst_waymo,
    synthetic_labeled_batch,
    synthetic_temporal_batch,
    synthetic_waymo_batch,
)
from sst_tpu_torch.models.ctrl import TrackletBatch
from sst_tpu_torch.models.middle_encoders import SparseEncoder
from sst_tpu_torch.models.sparse_unet import SimpleSparseUNet, SparseConvLayer
from sst_tpu_torch.models.sst import WindowAttention
from sst_tpu_torch.ops import sorted_reduce as sr
from sst_tpu_torch.ops import sparse_conv_dw as sdw
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.ops import window_mha as wm
from sst_tpu_torch.models.vfe import DynamicPillarFeatureNet, HardSimpleVFE
from sst_tpu_torch.ops.sparse_conv import make_sparse_grid
from sst_tpu_torch.ops.voxelize import (
    compute_voxel_coords,
    dynamic_voxelize,
    hard_voxelize,
)
from sst_tpu_torch.train.schedules import FSDDetectionSchedule
from sst_tpu_torch.train.state import make_optimizer
from sst_tpu_torch.tools.profile_predict import device_busy
from sst_tpu_torch.train.step import train_step
from sst_tpu_torch.utils import remat
from sst_tpu_torch.utils.builders import (
    build_model_from_cfg,
    optimizer_from_cfg,
    schedule_from_cfg,
)
from sst_tpu_torch.utils.config import load_config
from sst_tpu_torch.utils.nvcc import load_kernel_libraries
from sst_tpu_torch.utils.timing import (
    card_name_and_power_limit,
    cuda_ms,
    disable_tf32,
    event_ms,
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card and has no CPU path")
    card = card_name_and_power_limit()
    print(card, flush=True)
    disable_tf32()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for cuDNN convs and matmuls",
          flush=True)
    return card


KERNELS = ("sorted_reduce", "sparse_conv_gemm", "sparse_conv_dw",
           "window_mha")

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data
# sheet): HBM bytes/s, f32 FLOP/s outside the tensor
# cores, bf16 tensor-core FLOP/s, and f32-accurate products on the TF32
# tensor cores (3xTF32: three TF32 products per f32 product, 495 / 3). A
# kernel's bound is the larger of its bytes (each input read once, each
# output written once) over the first and its operations over the fastest
# route the card has for their type: the sparse convs' f32 products take
# 3xTF32 (their SIMT bound at 67 TFLOP/s is kept beside it, named).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
F32_TC_FLOP_PER_S = 495e12 / 3


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0, before a path is driven."""
    for mod in (sr, scg, sdw, wm):
        mod.reset_launch_counts()


def bound(nbytes: float, flops: float, peak: float):
    """(bound ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    t0 = time.perf_counter()
    libs = load_kernel_libraries(KERNELS)
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        print(f"build: {lib.path.name} (nvcc {lib.build_seconds:.2f} s)",
              flush=True)
        for line in lib.compiler_log.splitlines():
            if "ptxas info" in line and "Compile time" not in line:
                print(f"  {line.strip()}", flush=True)
    print(f"build: {len(libs)} kernels in {seconds:.2f} s (one nvcc per "
          f"source, run together)", flush=True)
    return seconds, {n: lib.build_seconds for n, lib in libs.items()}


def _record_sorted_reduce(model, frame):
    """Predict one frame with the segmentor VFE's ``sorted_segment_reduce``
    wrapped; returns each call's (mode, data, seg, num_segments) as the main
    path hands them to the kernel: the frame's sorted rows."""
    from sst_tpu_torch.models import vfe as vfe_module

    calls = []
    wrapped = vfe_module.sorted_segment_reduce

    def record(data, seg, num_segments, mode="sum", offsets=None):
        calls.append((mode, data.detach().clone(), seg, num_segments))
        return wrapped(data, seg, num_segments, mode, offsets)

    vfe_module.sorted_segment_reduce = record
    try:
        inference_detector(model, frame.points[0], max_points=196608)
    finally:
        vfe_module.sorted_segment_reduce = wrapped
    if not calls:
        fail("the segmentor voxelization did not sort; the kernel would not "
             "run on the main path")
    return calls


def _same_bits(a, b) -> bool:
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.view(bits), b.view(bits))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at each value (the spacing of its binade)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0**-126)))
    return 2.0 ** (e - 7)


def _dtype_name(t: torch.Tensor) -> str:
    return sr.DTYPES[t.dtype][0]


def _check_case(name, data, seg, num_segments, mode, results,
                twin_on_cpu=False):
    """The kernel over offsets it computes and over offsets passed in (the
    same bits), the offsets against ``torch.searchsorted`` (exactly), the
    result against the twin: a max equal bit for bit; a float32 sum within
    rtol 1e-5 + 1e-5 sqrt(rows), a bfloat16 sum within one bf16 ulp (both
    reduce in float32, in other orders, and round once)."""
    offsets = sr.segment_offsets(seg, num_segments)
    got = sr.sorted_segment_reduce(data, seg, num_segments, mode, offsets)
    again = sr.sorted_segment_reduce(data, seg, num_segments, mode)
    if twin_on_cpu:
        ref = sr.sorted_segment_reduce_ref(data.cpu(), seg.cpu(),
                                           num_segments, mode).to(data.device)
    else:
        ref = sr.sorted_segment_reduce_ref(data, seg, num_segments, mode)
    torch.cuda.synchronize()
    if not torch.equal(offsets, sr.segment_offsets_ref(seg, num_segments)):
        fail(f"the offsets kernel disagrees with torch.searchsorted in {name}")
    if got.dtype != data.dtype:
        fail(f"the sorted reduce returned {got.dtype} for {data.dtype} rows "
             f"in {name}")
    if not _same_bits(got, again):
        fail(f"the sorted reduce gave other bits over the offsets passed in "
             f"than over its own in {name} ({mode})")
    if mode == "max" and not bool(torch.isfinite(got).all()):
        fail(f"the kernel wrote a non-finite max in {name}: a max that is "
             f"not finite must read 0, as JAX segment_reduce does")
    finite = torch.isfinite(ref)
    inf = torch.isinf(ref)
    if not (torch.equal(torch.isfinite(got), finite)
            and torch.equal(got.isnan(), ref.isnan())
            and torch.equal(got[inf], ref[inf])):
        fail(f"kernel and plain twin disagree on which outputs are NaN or "
             f"+-inf in {name} ({mode})")
    got, ref = got.masked_fill(~finite, 0.0), ref.masked_fill(~finite, 0.0)
    err = (got - ref).float().abs().max().item() if got.numel() else 0.0
    if mode == "max":
        ok = _same_bits(got, ref)
        rule = "same bits"
    elif data.dtype == torch.bfloat16:
        ok = bool(((got - ref).float().abs() <= _bf16_ulp(ref)).all())
        rule = "one bf16 ulp"
    else:
        # the kernel sums each segment in row order, the twin's index_add in
        # another order: rtol 1e-5 plus atol 1e-5 * sqrt(rows in segment)
        idx = seg.long()
        keep = (idx >= 0) & (idx < num_segments)
        rows = torch.bincount(idx[keep], minlength=num_segments).float()
        tol = 1e-5 * ref.abs() + 1e-5 * rows.sqrt()[:, None]
        ok = bool(((got - ref).abs() <= tol).all())
        rule = "rtol 1e-5, atol 1e-5*sqrt(rows)"
    print(f"  {name:<40} {mode:<3} C={data.shape[1]:<3} "
          f"{_dtype_name(data):<8} max_abs_err={err:.3e} ({rule}), offsets "
          f"exact, same bits over given offsets "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    results.append(err)
    if not ok:
        fail(f"kernel disagrees with its plain twin on {name} ({mode})")


def _segment_reduce_library(data, offsets, num_segments, mode):
    """The library yardstick: one ``torch.segment_reduce`` call over the
    in-range rows (one contiguous range of the sorted rows), with lengths
    from the same offsets. It writes -inf (not 0) for an empty max and does
    not zero a non-finite one, so it is timed, not used."""
    lengths = offsets[1:] - offsets[:-1]
    rows = data[int(offsets[0]):int(offsets[-1])]
    return lambda: torch.segment_reduce(rows, mode, lengths=lengths,
                                        unsafe=True)


def _sorted_reduce_cases(model, f32_model, frame, gen, device):
    """The reductions each dense build's segmentor VFE hands the kernel on
    frame 0: (name, data, mode), recorded from the main path where the
    bf16 build is concerned (its float32 cluster-centre sum and its two
    bf16 maxima at C = 64); the float32 build's maxima take random rows at
    the recorded ids and widths."""
    calls = _record_sorted_reduce(model, frame)
    seg, nseg = calls[0][2], calls[0][3]
    cases = [(f"recorded {mode} {i}", data, mode)
             for i, (mode, data, _, _) in enumerate(calls)]
    for c in sorted(set(f32_model.segmentor_mod.vfe_mod.feat_channels)):
        cases.append(("float32 build's layer max", torch.randn(
            seg.shape[0], c, generator=gen, device=device), "max"))
    return cases, seg, nseg


def phase_kernels(model, f32_model, frame, device):
    """The kernels against their twins at the shapes the dense builds'
    segmentor VFE gives them: one offsets array of the frame's sorted ids;
    the float32 sum over the xyz rows (cluster centres) and the bf16 build's
    two maxima, recorded from its main path on frame 0; the float32 build's
    maxima at the same ids. Then edge cases in float32 and bf16. Returns the
    timed reduce shapes (one per (mode, C, dtype): the mean of its inputs),
    the offsets kernel's record and the largest error."""
    gen = torch.Generator(device=device).manual_seed(0)
    main_cases, seg, nseg = _sorted_reduce_cases(model, f32_model, frame,
                                                 gen, device)
    n = seg.shape[0]
    n_valid = int((seg < nseg).sum())
    offsets = sr.segment_offsets(seg, nseg)
    occupied = int(((offsets[1:] - offsets[:-1]) > 0).sum())
    print(f"kernels: sorted_segment_reduce at the segmentor's shapes: N={n} "
          f"rows ({n_valid} in range), {nseg} segments ({occupied} "
          f"occupied)", flush=True)
    runs = {k: [] for k in ("plain", "kernel")}
    for kind in ("plain", "kernel", "kernel", "plain"):
        runs[kind].append(cuda_ms(
            (lambda: sr.segment_offsets_ref(seg, nseg)) if kind == "plain"
            else (lambda: sr.segment_offsets(seg, nseg)), 20))
    if not torch.equal(offsets, sr.segment_offsets_ref(seg, nseg)):
        fail("the offsets kernel disagrees with torch.searchsorted at the "
             "segmentor's shapes")
    off_bound, off_by = bound(4 * (n + nseg + 1), 0, F32_FLOP_PER_S)
    offsets_rec = {"n": n, "num_segments": nseg, "ms": min(runs["kernel"]),
                   "plain_ms": min(runs["plain"]), "bound_ms": off_bound,
                   "bound_by": off_by, "max_abs_err": 0.0,
                   "host_ms": _host_ms(lambda: sr.segment_offsets(seg, nseg))}
    print(f"  time offsets: kernel {offsets_rec['ms']:.4f} ms (runs "
          f"{runs['kernel'][0]:.4f}, {runs['kernel'][1]:.4f}), "
          f"torch.searchsorted {offsets_rec['plain_ms']:.4f} ms, bound "
          f"{off_bound:.4f} ms ({off_by}), wrapper host time "
          f"{offsets_rec['host_ms'] * 1e3:.1f} us per call", flush=True)
    errs = []
    timed = {}
    for name, data, mode in main_cases:
        _check_case(name, data, seg, nseg, mode, errs)
        fns = {"plain": lambda: sr.sorted_segment_reduce_ref(
                   data, seg, nseg, mode),
               "kernel": lambda: sr.sorted_segment_reduce(
                   data, seg, nseg, mode, offsets),
               "library": _segment_reduce_library(data, offsets, nseg, mode)}
        runs = {k: [] for k in fns}
        for kind in ("plain", "kernel", "library", "library", "kernel",
                     "plain"):
            runs[kind].append(cuda_ms(fns[kind], 20))
        c, esize = data.shape[1], data.element_size()
        # each row read once, the offsets and each output row written once
        bound_ms, bound_by = bound(esize * (n * c + nseg * c)
                                   + 4 * (nseg + 1), n * c, F32_FLOP_PER_S)
        rec = {"mode": mode, "c": c, "dtype": _dtype_name(data), "n": n,
               "num_segments": nseg,
               **{("ms" if k == "kernel" else f"{k}_ms"): min(v)
                  for k, v in runs.items()},
               "host_ms": _host_ms(fns["kernel"]),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": errs[-1]}
        timed.setdefault((mode, c, rec["dtype"]), []).append(rec)
        print(f"  time {mode} C={c} {rec['dtype']} ({name}): kernel "
              f"{rec['ms']:.4f} ms (runs {runs['kernel'][0]:.4f}, "
              f"{runs['kernel'][1]:.4f}), plain twin {rec['plain_ms']:.4f} "
              f"ms, torch.segment_reduce {rec['library_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), wrapper host time "
              f"{rec['host_ms'] * 1e3:.1f} us per call", flush=True)
    shapes = []
    for recs in timed.values():
        mean = {k: sum(r[k] for r in recs) / len(recs) for k in (
            "ms", "plain_ms", "library_ms", "host_ms", "bound_ms",
            "max_abs_err")}
        shapes.append({**recs[0], **mean, "inputs": len(recs)})

    # edge cases, in float32 and in bf16
    m = 4096
    i32 = dict(dtype=torch.int32, device=device)
    gaps = torch.sort((torch.arange(m, device=device) // 7 * 5).to(
        torch.int32)).values
    span = torch.zeros(m, **i32)
    span[3000:] = 1
    wild = torch.sort(torch.randint(-50, 700, (m,), generator=gen,
                                    device=device).to(torch.int32)).values
    # the segmentor's row and segment counts with most segments empty: ids
    # dense in [0, 40000), the invalid rows' ids at num_segments
    sparse_ids = torch.sort(torch.randint(0, 40000, (196608,), generator=gen,
                                          device=device).to(
        torch.int32)).values
    sparse_ids[-20000:] = 131072
    for dtype in (torch.float32, torch.bfloat16):
        r = (torch.randn(m, 16, generator=gen, device=device) * 4).to(dtype)
        _check_case("all rows dropped", r, torch.full((m,), 300, **i32),
                    300, "max", errs)
        _check_case("all rows dropped", r, torch.full((m,), 300, **i32),
                    300, "sum", errs)
        for mode in ("sum", "max"):
            _check_case("empty segments between ids", r, gaps,
                        int(gaps[-1]) + 9, mode, errs)
        _check_case("negative maxima", -r.abs() - 1.0, gaps,
                    int(gaps[-1]) + 1, "max", errs)
        for mode in ("sum", "max"):
            # held against the twin on the CPU, which adds a segment's rows
            # in row order as the kernel does: on the card the twin's
            # index_add_ adds the 3000 rows by atomics, in an order that
            # changes from run to run, and its sum drifted past the
            # tolerance in one run of seven
            _check_case("one segment over 3000 rows", r, span, 4, mode, errs,
                        twin_on_cpu=True)
            _check_case("ids < 0 and >= num_segments", r, wild, 600, mode,
                        errs)
            _check_case("narrow rows, C=3", r[:, :3].contiguous(), wild, 600,
                        mode, errs)
        # NaN and inf rows: a sum over a segment holding a NaN is NaN, and a
        # max that is not finite reads 0 (JAX segment_reduce). Held against
        # the twin on the CPU: the twin on the card goes through ATen's CUDA
        # atomics, whose NaN rule is not documented
        with_nan = r.clone()
        with_nan[::97, ::5] = float("nan")
        with_nan[5::89, 1::7] = float("inf")
        with_nan[7::83, 2::6] = -float("inf")
        for mode in ("sum", "max"):
            _check_case("NaN and +-inf in some rows", with_nan, gaps,
                        int(gaps[-1]) + 1, mode, errs, twin_on_cpu=True)
        for c, mode in ((3, "sum"), (64, "max"), (64, "sum")):
            _check_case("mostly empty, N=196608, S=131072",
                        torch.randn(196608, c, generator=gen,
                                    device=device).to(dtype),
                        sparse_ids, 131072, mode, errs)
    return shapes, offsets_rec, max(errs)


def _frames(n_frames: int):
    return [synthetic_waymo_batch(1, 196608, seed=s, num_extra_feats=2,
                                  pcr_half=79.8) for s in range(n_frames)]


def _expected_reduce_launches(model) -> dict:
    """The segmentor VFE's reductions per frame by (mode, C, dtype), from
    the module: the float32 cluster-centre sum over xyz (the decoration
    stays float32), then one reduction per layer in the compute dtype."""
    vfe = model.segmentor_mod.vfe_mod
    out = Counter({("sum", 3, "float32"): 1})
    for c in vfe.feat_channels:
        out[(vfe.mode, c, sr.DTYPES[vfe.dtype][0])] += 1
    return dict(out)


def _predict_frames(model, frames, title):
    """Drive one dense predict path from zero counts; returns the results,
    the kernels' launches (reduce, offsets) and the reduce's launches per
    frame by (mode, C, dtype), counted at the launch sites and held
    against the modules."""
    results, per_frame = [], []
    reset_launch_counts()
    for frame in frames:
        before = (dict(sr.launch_counts), sr.offsets_launches)
        results.append(inference_detector(model, frame.points[0],
                                          max_points=196608))
        per_frame.append(({k: v - before[0].get(k, 0)
                           for k, v in sr.launch_counts.items()},
                          sr.offsets_launches - before[1]))
    launches = (sr.launches, sr.offsets_launches)
    split, n_offsets = per_frame[0]
    expected = _expected_reduce_launches(model)
    print(f"predict: {title} on {len(frames)} frames; sorted_segment_reduce "
          f"launches {launches[0]}, per frame by (mode, C, dtype) {split} "
          f"(the modules give {expected}); segment_offsets launches "
          f"{launches[1]}, {n_offsets} per frame", flush=True)
    if any(f != (split, n_offsets) for f in per_frame):
        fail(f"the kernels' launches differ between frames: {per_frame}")
    if split != expected:
        fail(f"expected kernel launches per frame {expected} from the "
             f"modules, counted {split}")
    if n_offsets != 1:
        fail(f"expected one offsets launch per frame (the VFE's three "
             f"reductions share it), counted {n_offsets}")
    max_num = model.test_cfg["max_num"]
    for s, res in enumerate(results):
        if res["boxes"].shape != (max_num, 7) or res["scores"].shape != (
                max_num,):
            fail(f"frame {s}: unexpected output shapes "
                 f"{ {k: v.shape for k, v in res.items()} }")
        for k in ("boxes", "scores"):
            if not np.isfinite(res[k]).all():
                fail(f"frame {s}: non-finite {k}")
        print(f"  frame {s}: [1, {max_num}] predictions, "
              f"{int(res['valid'].sum())} valid boxes", flush=True)
    return results, launches, split


def _seg_outputs(model, frame, device):
    pts = torch.from_numpy(frame.points[0]).to(device)
    valid = torch.from_numpy(frame.valid[0]).to(device)
    bidx = torch.zeros(pts.shape[0], dtype=torch.int32, device=device)
    with torch.inference_mode():
        out = model.segmentor_mod(pts, bidx, valid, 1)
    return out["seg_logits"], out["seg_feats"]


def _same_detections(a, b) -> float:
    same = (a["valid"] == b["valid"]) & (a["labels"] == b["labels"])
    same &= np.abs(a["boxes"] - b["boxes"]).max(-1) <= 1e-4
    same &= np.abs(a["scores"] - b["scores"]) <= 1e-5
    return float(same[a["valid"] | b["valid"]].mean()) if (
        a["valid"] | b["valid"]).any() else 1.0


def _matched_detections(ref, got) -> int:
    """How many of ``ref``'s valid detections ``got`` has too: the same
    label, each box value within 2^-3 relative + 0.25, the score within
    2^-5 (greedy, highest score first)."""
    rv, gv = ref["valid"], got["valid"]
    free = set(np.flatnonzero(gv))
    n = 0
    for i in np.flatnonzero(rv)[np.argsort(-ref["scores"][rv],
                                           kind="stable")]:
        for k in sorted(free, key=lambda k: np.abs(
                ref["boxes"][i] - got["boxes"][k]).max()):
            if (got["labels"][k] == ref["labels"][i]
                    and abs(got["scores"][k] - ref["scores"][i]) <= 2.0**-5
                    and (np.abs(ref["boxes"][i] - got["boxes"][k])
                         <= 2.0**-3 * np.abs(ref["boxes"][i]) + 0.25).all()):
                free.discard(k)
                n += 1
                break
    return n


def _kernel_vs_scatter(model, frames, device, close, rule):
    """The segmentor outputs with the sorted reduce on and off agree within
    ``close``."""
    vfe = model.segmentor_mod.vfe_mod
    for s, frame in enumerate(frames):
        vfe.use_sorted_reduce = True
        out_k = _seg_outputs(model, frame, device)
        vfe.use_sorted_reduce = False
        out_s = _seg_outputs(model, frame, device)
        vfe.use_sorted_reduce = True
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(out_k, out_s)]
        print(f"A/B frame {s} ({sr.DTYPES[vfe.dtype][0]}): kernel vs scatter "
              f"segmentor max-abs diff: seg_logits {diffs[0]:.3e}, seg_feats "
              f"{diffs[1]:.3e} ({rule})", flush=True)
        if not all(close(a, b) for a, b in zip(out_k, out_s)):
            fail(f"frame {s}: kernel and scatter segmentor outputs differ")


def _bf16_close(a, b) -> bool:
    """Within one bf16 ulp of the value plus 4 of the largest magnitude:
    the cluster-centre sums differ in float32 order, and a value cast to
    bf16 on the other side of a rounding moves a few ulps downstream (the
    CPU tests' tolerance between the packages)."""
    a, b = a.float(), b.float()
    tol = 2.0**-7 * b.abs() + 4 * 2.0**-7 * b.abs().max()
    return bool(((a - b).abs() <= tol).all())


def phase_ab(model, f32_model, frames, sorted_results, device):
    """The sorted reduce against the scatter path (segmentor outputs agree)
    in the bf16 build and in the float32 build with the same weights; the
    float32 build's predictions on the frames, its launches from zero
    counts, and how many detections of the bf16 build it shares (printed,
    not gated); predict latency of bf16 with the kernel, bf16 with the
    scatters and float32 with the kernel, alternated. Returns (latencies,
    the float32 path's launches and split)."""
    _kernel_vs_scatter(model, frames, device, _bf16_close,
                       "rtol 2^-7 + 4 x 2^-7 max|ref|")
    _kernel_vs_scatter(
        f32_model, frames, device,
        lambda a, b: (a - b).abs().max().item() <= 1e-4, "atol 1e-4")
    for s, frame in enumerate(frames):
        model.segmentor_mod.vfe_mod.use_sorted_reduce = False
        scatter_res = inference_detector(model, frame.points[0],
                                         max_points=196608)
        model.segmentor_mod.vfe_mod.use_sorted_reduce = True
        print(f"  frame {s}: bf16 kernel vs scatter: identical detections "
              f"{_same_detections(sorted_results[s], scatter_res):.4f} of "
              f"the slots valid in either build", flush=True)
    f32_results, f32_launches, f32_split = _predict_frames(
        f32_model, frames, "fsdv2_waymo_dense(dtype=torch.float32), the "
        "same weights")
    for s, (a, b) in enumerate(zip(f32_results, sorted_results)):
        print(f"  frame {s}: bf16 build has {_matched_detections(a, b)} of "
              f"the float32 build's {int(a['valid'].sum())} detections "
              f"(same label, box within 2^-3 + 0.25, score within 2^-5)",
              flush=True)

    builds = {"bf16 kernel": (model, True), "bf16 scatter": (model, False),
              "f32 kernel": (f32_model, True)}
    timed = {k: [] for k in builds}

    def run(name, frame):
        m, flag = builds[name]
        m.segmentor_mod.vfe_mod.use_sorted_reduce = flag
        return event_ms(lambda: inference_detector(m, frame.points[0],
                                                   max_points=196608))

    for name in builds:  # warm-up
        for frame in frames[:2]:
            run(name, frame)
    names = list(builds)
    for r in range(12):
        frame = frames[r % len(frames)]
        for name in names[r % 3:] + names[:r % 3]:
            timed[name].append(run(name, frame))
    for m, _ in builds.values():
        m.segmentor_mod.vfe_mod.use_sorted_reduce = True
    lat = {k: statistics.median(v) for k, v in timed.items()}
    print(f"A/B predict latency (median of 12 CUDA-event runs each, "
          f"inference_detector incl. host I/O, the three builds in "
          f"rotation): " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                     lat.items()), flush=True)
    for k, v in timed.items():
        print(f"  {k} runs: {[round(t, 2) for t in v]}", flush=True)
    return lat, f32_launches, f32_split


def phase_batch4(model, device):
    """The batch-4 counterpart of ``bench.py bench_fsdv2_b4``:
    ``fsdv2_waymo_dense(cap_scale=4)`` with the bf16 model's weights on
    ``synthetic_waymo_batch(batch_size=4)`` (seeds 0, 1; one more batch to
    warm up): 2 timed batches, launches per batch from zero counts, held
    against the modules (the batch is flattened: one set per batch), ms per
    frame amortised. Returns the phase's record."""
    b4 = fsdv2_waymo_dense(cap_scale=4)
    b4.load_state_dict(model.state_dict())
    b4.eval()
    batches = [synthetic_waymo_batch(4, 196608, seed=s, num_extra_feats=2,
                                     pcr_half=79.8).to(device)
               for s in range(3)]
    b4.predict(batches[2])  # warm-up
    reset_launch_counts()
    ms, outs = [], []
    for batch in batches[:2]:
        ms.append(event_ms(lambda: outs.append(b4.predict(batch))))
    split = {k: v // 2 for k, v in sr.launch_counts.items()}
    expected = _expected_reduce_launches(b4)
    launches = (sr.launches, sr.offsets_launches)
    print(f"batch 4: fsdv2_waymo_dense(cap_scale=4) bf16, 2 timed batches "
          f"of 4 frames: {[round(t, 2) for t in ms]} ms per batch, "
          f"{statistics.mean(ms) / 4:.2f} ms per frame amortised; "
          f"sorted_segment_reduce launches {launches[0]} by (mode, C, dtype) "
          f"per batch {split} (the modules give {expected}), "
          f"segment_offsets {launches[1]}", flush=True)
    if split != expected or launches != (2 * sum(expected.values()), 2):
        fail(f"batch 4: launches {launches}, {split}; expected "
             f"{expected} and one offsets launch per batch")
    for i, out in enumerate(outs):
        if out["boxes"].shape != (4, b4.test_cfg["max_num"], 7):
            fail(f"batch 4: unexpected boxes shape {out['boxes'].shape}")
        if not bool(torch.isfinite(out["boxes"]).all()
                    and torch.isfinite(out["scores"]).all()):
            fail(f"batch 4: non-finite boxes or scores in batch {i}")
        print(f"  batch {i}: valid boxes per frame "
              f"{out['valid'].sum(1).tolist()}", flush=True)
    del b4
    return {"batch_ms": ms, "ms_per_frame": statistics.mean(ms) / 4,
            "launches": launches, "split": split}


SPARSE_TOL = 1e-4  # max-abs and relative: f32 sums of up to 27*512 terms


def _record_sparse_convs(model, frame, drive=None):
    """Predict one frame (or call ``drive()``) with a hook on every
    SparseConvLayer; returns each conv's (module name, input rows,
    rulebook, weight shape, input features, output-row validity) in call
    order. The rulebooks are those the main path builds for this frame."""
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, SparseConvLayer):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: calls.append(
                    (name, args[0].shape[0], args[1], tuple(m.weight.shape),
                     args[0].detach(), args[2]))))
    try:
        if drive is None:
            inference_detector(model, frame.points[0], max_points=196608)
        else:
            drive()
    finally:
        for h in hooks:
            h.remove()
    return calls


def _check_conv(name, feats, nbr, w, mode, errs, schedule=None):
    """The kernel (over ``schedule`` when given) against its twin, and a
    second run over a schedule the wrapper builds itself: the same bits."""
    got = scg.sparse_conv_gemm(feats, nbr, w, mode, schedule=schedule)
    again = scg.sparse_conv_gemm(feats, nbr, w, mode)
    ref = scg.sparse_conv_gemm_ref(feats, nbr, w)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    err = diff.max().item() if diff.numel() else 0.0
    ok = bool((diff <= SPARSE_TOL + SPARSE_TOL * ref.abs()).all())
    errs.append(err)
    print(f"  {name:<44} {mode:<8} {w.shape[1]:>3}->{w.shape[2]:<3} "
          f"K={w.shape[0]:<2} Vin={feats.shape[0]:<6} Vout={nbr.shape[1]:<6} "
          f"max_abs_err={err:.3e} (atol+rtol {SPARSE_TOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"sparse conv kernel disagrees with its plain twin on {name}")
    if not torch.equal(got, again):
        fail(f"sparse conv kernel gave other bits on a second run of {name}")
    return got


def _executed_shares(nbr, vin, schedule):
    """Shares of the K x Vout (row, tap) pairs: those with a neighbour, and
    those computed by the earlier SIMT kernel (a tap skipped only where all
    8 rows of a warp's group lack it, groups in row order) and by the tile
    schedule (every row of a tile computes every tap set in its mask)."""
    taps, vout = nbr.shape
    has = (nbr >= 0) & (nbr < vin)
    groups = -(-vout // 8)
    grouped = torch.zeros((taps, groups * 8), dtype=torch.bool,
                          device=nbr.device)
    grouped[:, :vout] = has
    old = int(grouped.view(taps, groups, 8).any(-1).sum()) * 8
    bits = (schedule.tile_mask.long() & 0xFFFFFFFF)[:, None] >> torch.arange(
        32, device=nbr.device)
    new = int((bits & 1).sum()) * scg.TILE_ROWS
    total = taps * vout
    return int(has.sum()) / total, old / total, new / total


def _sparse_inputs(vin, cin, cout, taps, gen, device):
    feats = torch.randn(vin, cin, generator=gen, device=device)
    w = torch.randn(taps, cin, cout, generator=gen, device=device) / (
        taps * cin) ** 0.5
    return feats, w


def _sparse_edge_cases(gen, device):
    """(name, feats, nbr, weights): missing entries are Vin, -1 or past
    Vin; rows 64-127 of the first case have no neighbour at all (the
    schedule gathers them into a tile of zeros); tiles are 64 rows x 64
    channels."""
    def table(vin, vout, taps, missing=0.6):
        nbr = torch.randint(0, vin, (taps, vout), generator=gen,
                            device=device, dtype=torch.int32)
        drop = torch.rand(taps, vout, generator=gen, device=device) < missing
        bad = torch.tensor([vin, -1, vin + 7], dtype=torch.int32,
                           device=device)[torch.randint(
                               0, 3, (taps, vout), generator=gen,
                               device=device)]
        return torch.where(drop, bad, nbr)

    cases = []
    nbr = table(500, 300, 27)
    nbr[:, 64:128] = 500
    cases.append(("edge: all-missing tile", 500, nbr, 64, 64))
    nbr = table(500, 300, 27)
    nbr[13] = 500
    cases.append(("edge: tap with no neighbour anywhere", 500, nbr, 64, 64))
    cases.append(("edge: K=3", 700, table(700, 400, 3), 32, 64))
    cases.append(("edge: Cin, Cout off the tile (3->48)", 900,
                  table(900, 640, 27), 3, 48))
    cases.append(("edge: Vout=1000 off the row tile", 1200,
                  table(1200, 1000, 27), 40, 72))
    out = []
    for name, vin, nbr, cin, cout in cases:
        feats, w = _sparse_inputs(vin, cin, cout, nbr.shape[0], gen, device)
        out.append((name, feats, nbr, w))
    return out


def phase_sparse_kernels(model, frame, device):
    """The sparse conv kernel against its twin on the rulebooks of every
    conv of one frame (one case per distinct rulebook and widths), then on
    edge cases. Returns (timed cases, per-conv ms of kernel and twin summed
    over the frame's convs, largest error, the frame's convs)."""
    gen = torch.Generator(device=device).manual_seed(1)
    calls = _record_sparse_convs(model, frame)
    print(f"sparse kernels: sparse_conv_gemm on the rulebooks of frame 0 of "
          f"fsdv2_waymo(backbone='sparse'): {len(calls)} convs", flush=True)
    cases = {}
    for name, vin, cp, wshape, _, _ in calls:
        key = (id(cp.nbr), wshape[1], wshape[2])
        if key not in cases:
            cases[key] = dict(name=name, mode=cp.mode, plan=cp, vin=vin,
                              taps=wshape[0], cin=wshape[1], cout=wshape[2],
                              convs=0)
        cases[key]["convs"] += 1
    errs, shapes, tables = [], [], {}
    simt_ms = 0.0  # the bound on the f32 SIMT cores, printed beside
    for case in cases.values():
        nbr, vin, mode = case["plan"].nbr, case["vin"], case["mode"]
        sched = case["plan"].schedule(vin)  # built by the recorded predict
        feats, w = _sparse_inputs(vin, case["cin"], case["cout"],
                                  case["taps"], gen, device)
        short = case["name"].replace("segmentor_mod.unet_mod.", "seg.") \
            .replace("mixer_mod.", "mix.")
        _check_conv(f"{short} (x{case['convs']})", feats, nbr, w, mode, errs,
                    schedule=sched)
        # alternate plain and kernel timings: plain, kernel, kernel, plain
        runs = [cuda_ms(fn, 10, warmup=2) for fn in (
            lambda: scg.sparse_conv_gemm_ref(feats, nbr, w),
            lambda: scg.sparse_conv_gemm(feats, nbr, w, mode, schedule=sched),
            lambda: scg.sparse_conv_gemm(feats, nbr, w, mode, schedule=sched),
            lambda: scg.sparse_conv_gemm_ref(feats, nbr, w))]
        kern, plain = min(runs[1], runs[2]), min(runs[0], runs[3])
        if id(nbr) not in tables:  # one schedule per table, shared
            tables[id(nbr)] = cuda_ms(lambda: scg.conv_schedule(nbr, vin), 5,
                                      warmup=1)
        taps, vout = nbr.shape
        hit, old, new = _executed_shares(nbr, vin, sched)
        flops = 2 * hit * taps * vout * case["cin"] * case["cout"]
        nbytes = 4 * (vin * case["cin"] + taps * vout
                      + taps * case["cin"] * case["cout"] + vout * case["cout"])
        bound_ms, bound_by = bound(nbytes, flops, F32_TC_FLOP_PER_S)
        simt_ms += bound(nbytes, flops, F32_FLOP_PER_S)[0] * case["convs"]
        print(f"    time: kernel {kern:.4f} ms (runs {runs[1]:.4f}, "
              f"{runs[2]:.4f}), plain twin {plain:.4f} ms (runs "
              f"{runs[0]:.4f}, {runs[3]:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}); (row, tap) pairs: {hit:.3f} have a neighbour, "
              f"{old:.3f} executed by the 8-row-group skip, {new:.3f} by the "
              f"tile schedule; schedule built in {tables[id(nbr)]:.4f} ms",
              flush=True)
        shapes.append({"conv": case["name"], "convs_per_frame": case["convs"],
                       "mode": mode, "cin": case["cin"],
                       "cout": case["cout"], "vin": vin, "vout": vout,
                       "neighbour_share": hit, "executed_share_8row": old,
                       "executed_share_tiles": new,
                       "schedule_ms": tables[id(nbr)],
                       "ms": kern, "plain_ms": plain, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": errs[-1]})
    for name, feats, nbr, w in _sparse_edge_cases(gen, device):
        got = _check_conv(name, feats, nbr, w, "subm", errs)
        if name == "edge: all-missing tile" and not torch.equal(
                got[64:128], torch.zeros_like(got[64:128])):
            fail("the all-missing rows are not written as zeros")
    per_frame = {k: sum(s[k] * s["convs_per_frame"] for s in shapes)
                 for k in ("ms", "plain_ms", "bound_ms")}
    per_frame["schedule_ms"] = sum(tables.values())
    work = {k: sum(s[k] * s["convs_per_frame"] * s["vout"] * s["cin"]
                   * s["cout"] for s in shapes) for k in (
        "neighbour_share", "executed_share_8row", "executed_share_tiles")}
    dense = sum(s["convs_per_frame"] * s["vout"] * s["cin"] * s["cout"]
                for s in shapes)
    per_frame["shares"] = {k: v / dense for k, v in work.items()}
    print(f"sparse kernels: per frame over its {len(calls)} convs: kernel "
          f"{per_frame['ms']:.3f} ms, plain twin {per_frame['plain_ms']:.3f} "
          f"ms, bound {per_frame['bound_ms']:.3f} ms (3xTF32; "
          f"{simt_ms:.3f} ms on the f32 SIMT cores); "
          f"{len(tables)} schedules built in {per_frame['schedule_ms']:.3f} "
          f"ms; shares of the (row, tap) x Cin x Cout work "
          f"{ {k: round(v, 4) for k, v in per_frame['shares'].items()} }",
          flush=True)
    return shapes, per_frame, max(errs), calls


def phase_sparse_predict(model, frames, n_convs):
    """Drive the sparse path; returns (conv launches, sorted-reduce
    launches, conv launches per frame by (mode, Cin, Cout), latency)."""
    results, per_frame = [], []
    reset_launch_counts()
    for frame in frames:
        before = (dict(scg.launch_counts), dict(sr.launch_counts),
                  sr.offsets_launches)
        results.append(inference_detector(model, frame.points[0],
                                          max_points=196608))
        per_frame.append(tuple(
            {k: v - b.get(k, 0) for k, v in counts.items()}
            for counts, b in zip((scg.launch_counts, sr.launch_counts),
                                 before)) + (sr.offsets_launches - before[2],))
    conv_launches = scg.launches
    sr_launches = (sr.launches, sr.offsets_launches)
    split, sr_split, n_offsets = per_frame[0]
    print(f"sparse predict: fsdv2_waymo(backbone='sparse') on {len(frames)} "
          f"frames; sparse_conv_gemm launches {conv_launches}, per frame by "
          f"(mode, Cin, Cout) {split}; sorted_segment_reduce launches "
          f"{sr_launches[0]}, per frame {sr_split}; segment_offsets launches "
          f"{sr_launches[1]}, {n_offsets} per frame", flush=True)
    if any(f != (split, sr_split, n_offsets) for f in per_frame):
        fail(f"launches differ between frames: {per_frame}")
    if n_offsets != 1:
        fail(f"expected one offsets launch per frame, counted {n_offsets}")
    if sum(split.values()) != n_convs:
        fail(f"expected {n_convs} sparse conv launches per frame (one per "
             f"SparseConvLayer), counted {sum(split.values())}")
    if sum(sr_split.values()) != 3:
        fail(f"expected 3 sorted reduce launches per frame, got {sr_split}")
    max_num = model.test_cfg["max_num"]
    for s, res in enumerate(results):
        if res["boxes"].shape != (max_num, 7) or res["scores"].shape != (
                max_num,):
            fail(f"sparse frame {s}: unexpected output shapes "
                 f"{ {k: v.shape for k, v in res.items()} }")
        for k in ("boxes", "scores"):
            if not np.isfinite(res[k]).all():
                fail(f"sparse frame {s}: non-finite {k}")
        print(f"  frame {s}: [1, {max_num}] predictions, "
              f"{int(res['valid'].sum())} valid boxes", flush=True)

    timed = [event_ms(lambda f=frames[r % len(frames)]: inference_detector(
        model, f.points[0], max_points=196608)) for r in range(12)]
    lat = statistics.median(timed)
    print(f"sparse predict latency (median of 12 CUDA-event runs after "
          f"warm-up, inference_detector incl. host I/O): {lat:.2f} ms; runs "
          f"{[round(t, 2) for t in timed]}", flush=True)
    return conv_launches, sr_launches, split, lat


def _labeled_frames(n_frames: int):
    """Labelled Waymo-like frames (x, y, z + 2 extra channels within 79.8 m;
    the gt boxes own their points), seeds 0 .. n_frames - 1."""
    return [synthetic_labeled_batch(1, 196608, seed=s, num_extra_feats=2,
                                    pcr_half=79.8)[0]
            for s in range(n_frames)]


DW_TOL = 1e-4  # times the twin on |feats|, |dout|, plus 1e-6 absolute


def _dw_error(got, feats, nbr, dout):
    """(largest |got - twin|, whether every element is within DW_TOL)."""
    ref = sdw.sparse_conv_dw_ref(feats, nbr, dout)
    tol = DW_TOL * sdw.sparse_conv_dw_ref(feats.abs(), nbr, dout.abs()) + 1e-6
    diff = (got - ref).abs()
    return diff.max().item(), bool((diff <= tol).all())


def _check_dw(name, feats, nbr, dout, mode, errs, schedule=None):
    """The weight-gradient kernel (over ``schedule`` when given) against its
    twin: |kernel - twin| <= 1e-4 * (|feats|^T |dout| per element) + 1e-6
    (f32 sums of the same products in another order); a second run over a
    schedule the wrapper builds itself gives the same bits."""
    got = sdw.sparse_conv_dw(feats, nbr, dout, mode, schedule=schedule)
    again = sdw.sparse_conv_dw(feats, nbr, dout, mode)
    err, ok = _dw_error(got, feats, nbr, dout)
    errs.append(err)
    print(f"  dW    {name:<44} {mode:<8} {feats.shape[1]:>3}->"
          f"{dout.shape[1]:<3} Vin={feats.shape[0]:<6} Vout={nbr.shape[1]:<6} "
          f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"sparse_conv_dw disagrees with its plain twin on {name}")
    if not torch.equal(got, again):
        fail(f"sparse_conv_dw gave other bits over a schedule it built than "
             f"over the plan's on {name}")
    return got


def _check_dgrad(name, dout, nbr_t, sched_t, w, mode, errs):
    """The input gradient, the conv kernel over the transposed table (and
    the plan's schedule of it) with W[k].T, against the conv twin on the
    same inputs."""
    wt = w.transpose(1, 2).contiguous()
    got = scg.sparse_conv_gemm(dout, nbr_t, wt, mode, kind="dgrad",
                               schedule=sched_t)
    ref = scg.sparse_conv_gemm_ref(dout, nbr_t, wt)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    err = diff.max().item() if diff.numel() else 0.0
    ok = bool((diff <= SPARSE_TOL + SPARSE_TOL * ref.abs()).all())
    errs.append(err)
    if not ok:
        fail(f"the input gradient (conv kernel over the transposed table) "
             f"disagrees with the twin on {name}: max_abs_err {err:.3e}")


def _dw_edge_cases(device):
    """(name, feats, nbr, dout): missing entries are Vin, -1 or past Vin;
    a tile is 64 x 64 channels, a stage 32 rows."""
    gen = torch.Generator().manual_seed(5)

    def case(vin, vout, cin, cout, missing=0.6):
        nbr = torch.randint(0, vin, (27, vout), generator=gen,
                            dtype=torch.int32)
        drop = torch.rand(27, vout, generator=gen) < missing
        bad = torch.tensor([vin, -1, vin + 7], dtype=torch.int32)[
            torch.randint(0, 3, (27, vout), generator=gen)]
        feats = torch.randn(vin, cin, generator=gen)
        dout = torch.randn(vout, cout, generator=gen)
        return (feats.to(device), torch.where(drop, bad, nbr).to(device),
                dout.to(device))

    out = []
    feats, nbr, dout = case(500, 300, 64, 64)
    nbr[13] = 500
    out.append(("edge: tap with no neighbour anywhere", feats, nbr, dout))
    feats, nbr, dout = case(500, 300, 64, 64)
    out.append(("edge: all rows missing", feats, torch.full_like(nbr, -1),
                dout))
    out.append(("edge: Vout=1000 off the 64-row tile, 40->72",
                *case(1200, 1000, 40, 72)))
    out.append(("edge: 16->32", *case(3000, 2500, 16, 32)))
    out.append(("edge: 512->256", *case(2048, 2048, 512, 256, 0.7)))
    return out


def phase_backward_kernels(model, frame, device, calls=None,
                           title="labelled frame 0 of fsdv2_waymo(backbone="
                                 "'sparse')"):
    """The weight-gradient kernel and the input gradient (the conv kernel
    over the transposed table) against their twins at every conv of one
    labelled frame, with each conv's recorded input and a seeded output
    gradient masked at invalid output rows; edge cases; bit-for-bit
    repeats; both timed per distinct (rulebook, widths) case. ``calls``:
    the convs' recorded inputs (``_record_sparse_convs``' tuples), recorded
    from a predict of ``frame`` where none are given. Returns (timed cases,
    per-step ms of kernel, twin and bound summed over the convs, largest
    dW error, largest dgrad error)."""
    gen = torch.Generator().manual_seed(4)
    with torch.inference_mode():
        if calls is None:
            calls = _record_sparse_convs(model, frame)
        print(f"backward kernels: sparse_conv_dw and the input gradient on "
              f"the rulebooks and inputs of {title}: {len(calls)} convs",
              flush=True)
        dw_errs, dg_errs, cases = [], [], {}
        for name, vin, cp, wshape, feats, out_valid in calls:
            vout, cout = cp.nbr.shape[1], wshape[2]
            dout = (torch.randn(vout, cout, generator=gen)
                    * out_valid.cpu()[:, None]).to(device)
            short = name.replace("segmentor_mod.unet_mod.", "seg.") \
                .replace("mixer_mod.", "mix.")
            _check_dw(short, feats, cp.nbr, dout, cp.mode, dw_errs,
                      schedule=cp.schedule(vin))
            nbr_t = cp.transposed(vin)
            sched_t = cp.transposed_schedule(vin)
            w = model.get_submodule(name).weight.detach()
            _check_dgrad(short, dout, nbr_t, sched_t, w, cp.mode, dg_errs)
            key = (id(cp.nbr), wshape[1], cout)
            if key not in cases:
                cases[key] = dict(name=short, mode=cp.mode, feats=feats,
                                  nbr=cp.nbr, sched=cp.schedule(vin),
                                  nbr_t=nbr_t, sched_t=sched_t,
                                  dout=dout, w=w, convs=0)
            cases[key]["convs"] += 1
        print(f"  every conv: dW max_abs_err {max(dw_errs):.3e} (1e-4 x the "
              f"twin on absolute values + 1e-6), input gradient "
              f"max_abs_err {max(dg_errs):.3e} (atol+rtol {SPARSE_TOL:g}) ok",
              flush=True)
        widest = max(cases.values(), key=lambda c: c["w"].numel())
        deepest = max(cases.values(), key=lambda c: c["nbr"].shape[1])
        for case in (widest, deepest):
            a, b = (sdw.sparse_conv_dw(case["feats"], case["nbr"],
                                       case["dout"], case["mode"],
                                       schedule=case["sched"])
                    for _ in range(2))
            if not torch.equal(a, b):
                fail(f"sparse_conv_dw gave other bits on a second run of "
                     f"{case['name']}")
            wt = case["w"].transpose(1, 2).contiguous()
            a, b = (scg.sparse_conv_gemm(case["dout"], case["nbr_t"], wt,
                                         case["mode"], kind="dgrad",
                                         schedule=sched)
                    for sched in (case["sched_t"], None))
            if not torch.equal(a, b):
                fail(f"the input gradient gave other bits on a second run "
                     f"of {case['name']}")
        print(f"  determinism: dW over the plan's schedule and over one the "
              f"wrapper builds equal bit for bit on every conv; dW and input "
              f"gradient, two runs equal bit for bit on {widest['name']} and "
              f"{deepest['name']}", flush=True)
        for name, feats, nbr, dout in _dw_edge_cases(device):
            got = _check_dw(name, feats, nbr, dout, "subm", dw_errs)
            if not torch.equal(got, sdw.sparse_conv_dw(feats, nbr, dout,
                                                       "subm")):
                fail(f"sparse_conv_dw gave other bits on a second run of "
                     f"{name}")
            zero = (got[13] if "no neighbour" in name
                    else got if "all rows" in name else None)
            if zero is not None and not torch.equal(zero,
                                                    torch.zeros_like(zero)):
                fail(f"{name}: the taps without a neighbour are not zeros")

        shapes = []
        simt_ms = 0.0  # the bound on the f32 SIMT cores, printed beside
        for case in cases.values():
            feats, nbr, dout, mode, sched = (case["feats"], case["nbr"],
                                             case["dout"], case["mode"],
                                             case["sched"])
            wt = case["w"].transpose(1, 2).contiguous()
            fns = {
                "plain": lambda: sdw.sparse_conv_dw_ref(feats, nbr, dout),
                "kernel": lambda: sdw.sparse_conv_dw(feats, nbr, dout, mode,
                                                     schedule=sched),
                "dgrad": lambda: scg.sparse_conv_gemm(
                    dout, case["nbr_t"], wt, mode, kind="dgrad",
                    schedule=case["sched_t"]),
                "dgrad_plain": lambda: scg.sparse_conv_gemm_ref(
                    dout, case["nbr_t"], wt)}
            runs = {k: [] for k in fns}
            for kind in ("plain", "kernel", "dgrad", "dgrad_plain",
                         "dgrad_plain", "dgrad", "kernel", "plain"):
                runs[kind].append(cuda_ms(fns[kind], 5, warmup=1))
            vin, cin = feats.shape
            taps, vout = nbr.shape
            cout = dout.shape[1]
            hit, _, executed = _executed_shares(nbr, vin, sched)
            pairs = int(((nbr >= 0) & (nbr < vin)).sum())
            nbytes = 4 * (vin * cin + taps * vout + vout * cout
                          + taps * cin * cout)
            bound_ms, bound_by = bound(nbytes, 2 * pairs * cin * cout,
                                       F32_TC_FLOP_PER_S)
            simt_ms += bound(nbytes, 2 * pairs * cin * cout,
                             F32_FLOP_PER_S)[0] * case["convs"]
            row = {"conv": case["name"], "convs_per_step": case["convs"],
                   "mode": mode, "cin": cin, "cout": cout, "vin": vin,
                   "vout": vout, "neighbour_share": pairs / (taps * vout),
                   "executed_share_tiles": executed,
                   "splits": sdw.split_rows(taps, cin, cout, vout),
                   "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
                   "host_ms": _host_ms(fns["kernel"]),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "dgrad_ms": min(runs["dgrad"]),
                   "dgrad_plain_ms": min(runs["dgrad_plain"])}
            shapes.append(row)
            print(f"    time {case['name']:<28} x{case['convs']} {cin:>3}->"
                  f"{cout:<3} Vout={vout:<6}: dW kernel {row['ms']:.4f} ms "
                  f"(runs {runs['kernel'][0]:.4f}, {runs['kernel'][1]:.4f}, "
                  f"{row['splits']} tile splits), twin {row['plain_ms']:.4f} "
                  f"ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), wrapper host time "
                  f"{row['host_ms'] * 1e3:.1f} us per call; (row, tap) pairs: "
                  f"{hit:.3f} have a neighbour, {executed:.3f} executed by the "
                  f"tile schedule; input gradient kernel "
                  f"{row['dgrad_ms']:.4f} ms, twin "
                  f"{row['dgrad_plain_ms']:.4f} ms", flush=True)
    per_step = {k: sum(r[k] * r["convs_per_step"] for r in shapes)
                for k in ("ms", "plain_ms", "bound_ms", "host_ms", "dgrad_ms",
                          "dgrad_plain_ms")}
    work = sum(r["convs_per_step"] * r["vout"] * r["cin"] * r["cout"]
               for r in shapes)
    per_step["shares"] = {k: sum(r[k] * r["convs_per_step"] * r["vout"]
                                 * r["cin"] * r["cout"] for r in shapes) / work
                          for k in ("neighbour_share",
                                    "executed_share_tiles")}
    print(f"backward kernels: per step over its {len(calls)} convs: dW "
          f"kernel {per_step['ms']:.3f} ms, twin {per_step['plain_ms']:.3f} "
          f"ms, bound {per_step['bound_ms']:.3f} ms (3xTF32; "
          f"{simt_ms:.3f} ms on the f32 SIMT cores), the "
          f"same for the input gradient; wrapper host time "
          f"{per_step['host_ms']:.3f} ms; shares of the (row, tap) x Cin x "
          f"Cout work "
          f"{({k: round(v, 4) for k, v in per_step['shares'].items()})}"
          f"; input gradient kernel "
          f"{per_step['dgrad_ms']:.3f} ms, twin "
          f"{per_step['dgrad_plain_ms']:.3f} ms", flush=True)
    return shapes, per_step, max(dw_errs), max(dg_errs)


def _losses(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _stage_ms(model, opt, batch, kw):
    """One step of ``train_step``'s body with CUDA events between its
    stages: the loss (forward), backward (with the remat recompute) and the
    clip + AdamW step. Returns (ms by stage, the step's metrics)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    opt.zero_grad()
    out = model.loss(batch, train=True, **kw)
    total = sum(v for k, v in out.items() if k.startswith("loss"))
    ev[1].record()
    total.backward()
    ev[2].record()
    norm = opt.step()
    ev[3].record()
    ev[3].synchronize()
    metrics = {k: v.detach() for k, v in out.items()}
    metrics.update(loss_total=total.detach(), grad_norm=norm)
    return {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
            enumerate(("loss", "backward", "optimizer"))}, metrics


N_WARMUP, N_TIMED, N_STAGED = 2, 6, 3  # train steps of each train phase


def _train_loop(model, opt, frames, kws, counts, after_step=None,
                no_grad_params: int = 0):
    """``train_step`` on ``frames`` (step i on frame i mod their number,
    with loss kwargs ``kws[i]``): steps ``N_WARMUP`` to ``N_WARMUP +
    N_TIMED - 1`` timed whole by CUDA events, the next ``N_STAGED`` by stage
    (loss, backward, optimizer), then the rest whole. ``counts()`` reads the
    kernels' launch counters; a step's launches are the differences.
    Fails on a non-finite loss or grad norm, or on a parameter without a
    gradient (beyond the ``no_grad_params`` that no loss of the mode
    reaches). Returns (steps, median ms by stage, peak memory over the
    timed and staged steps)."""
    steps, stages = [], []
    for i, kw in enumerate(kws):
        if i == N_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        before = counts()
        out = {}
        batch = frames[i % len(frames)]
        if N_WARMUP + N_TIMED <= i < N_WARMUP + N_TIMED + N_STAGED:
            stage, out = _stage_ms(model, opt, batch, kw)
            stages.append(stage)
            ms = sum(stage.values())
        else:
            ms = event_ms(lambda: out.update(train_step(model, opt, batch,
                                                        kw)))
        if i == N_WARMUP + N_TIMED + N_STAGED - 1:
            peak = torch.cuda.max_memory_allocated()
        if after_step is not None:
            after_step(i)
        after = counts()
        metrics = _losses(out)
        steps.append(dict(ms=ms, kw=kw, metrics=metrics, launches={
            k: v - before.get(k, 0) for k, v in after.items()}))
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            fail(f"train step {i}: non-finite {bad} (a non-finite grad_norm "
                 f"means a non-finite gradient)")
        if opt.params_without_grad != no_grad_params:
            fail(f"train step {i}: {opt.params_without_grad} parameters got "
                 f"no gradient, {no_grad_params} expected; every other leaf "
                 f"gets one in JAX")
    stage_ms = {k: statistics.median(st[k] for st in stages)
                for k in stages[0]}
    return steps, stage_ms, peak


def _print_train(steps, stage_ms, peak):
    """The timed steps' ms, the stage medians, peak memory, losses and
    grad norms; returns the phase's record."""
    timed = [st["ms"] for st in steps[N_WARMUP:N_WARMUP + N_TIMED]]
    first, last = steps[N_WARMUP], steps[N_WARMUP + N_TIMED - 1]
    print(f"  step ms (CUDA events around train_step, {N_TIMED} steps "
          f"after {N_WARMUP} warm-up): median {statistics.median(timed):.2f},"
          f" min {min(timed):.2f}, max {max(timed):.2f}; runs "
          f"{[round(t, 2) for t in timed]}; warm-up "
          f"{[round(st['ms'], 2) for st in steps[:N_WARMUP]]}", flush=True)
    print(f"  stages (CUDA events inside {N_STAGED} more steps, median ms): "
          f"{ {k: round(v, 2) for k, v in stage_ms.items()} }", flush=True)
    print(f"  peak memory (torch.cuda.max_memory_allocated over the timed "
          f"and staged steps): {peak / 2**30:.3f} GiB", flush=True)
    print(f"  first timed step: {first['metrics']}", flush=True)
    print(f"  last timed step: {last['metrics']}", flush=True)
    print(f"  grad_norm per step: "
          f"{[round(st['metrics']['grad_norm'], 4) for st in steps]}",
          flush=True)
    return {"step_ms_median": statistics.median(timed),
            "step_ms_min": min(timed), "step_ms_max": max(timed),
            "step_ms_runs": timed, "stage_ms": stage_ms,
            "peak_memory_bytes": peak,
            "launches_per_step": steps[0]["launches"],
            "loss_first": first["metrics"], "loss_last": last["metrics"]}


def _check_launches(steps, expected):
    for i, st in enumerate(steps):
        got = {k: st["launches"].get(k, 0) for k in expected}
        if got != expected:
            fail(f"train step {i}: launches by kind {got}, expected "
                 f"{expected} from the modules")


def _adamw(model):
    """The configs' optimizer (configs/fsdv2/fsdv2_waymo_1x.py,
    configs/sst/sst_waymoD5_3class.py): AdamW, base_lr 1e-5, weight decay
    0.05, clip 10, a 10,000-step one-cycle."""
    return make_optimizer(model.parameters(), base_lr=1e-5,
                          weight_decay=0.05, clip_norm=10.0,
                          total_steps=10000)


def _fsd_kws():
    """FSDDetectionSchedule's step-0 mode for every warm-up, timed and
    staged step, then one ``pretrain=False`` step."""
    schedule = FSDDetectionSchedule(enable_after=4000, buffer_start=0.3)
    n = N_WARMUP + N_TIMED + N_STAGED
    return [schedule(i) for i in range(n)] + [
        dict(pretrain=False, thr_extra=0.0)]


def _sorted_reduce_counts():
    return {"sorted_reduce": sr.launches,
            "segment_offsets": sr.offsets_launches,
            **{f"sorted_reduce {m}/C={c}/{d}": v
               for (m, c, d), v in sr.launch_counts.items()}}


def phase_train(model, device, n_convs):
    """Drive the sparse build's train path: ``train_step`` on labelled
    frames (seeds 0-3), the config's optimizer and FSDDetectionSchedule's
    step-0 mode (``pretrain=True``): 2 warm-up and 6 timed steps, 3 steps
    timed by stage, then one ``pretrain=False`` step. Launches per step are
    counted at the launch sites by kind and held against the modules.
    Returns the phase's record."""
    frames = [f.to(device) for f in _labeled_frames(4)]
    opt = _adamw(model)
    convs = [m for m in model.modules() if isinstance(m, SparseConvLayer)]
    n_remat = sum(isinstance(m, SparseConvLayer) for u in model.modules()
                  if isinstance(u, SimpleSparseUNet) and u.remat
                  for m in u.modules())
    needs_dgrad = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: None if remat.recomputing()
        else needs_dgrad.append(bool(args[0].requires_grad))) for m in convs]

    def remove_hooks(i):
        if i == 0:
            for h in hooks:
                h.remove()

    def counts():
        return {**scg.kind_counts, "dw": sdw.launches,
                **_sorted_reduce_counts()}

    reset_launch_counts()  # the train path's run starts here
    steps, stage_ms, peak = _train_loop(model, opt, frames, _fsd_kws(),
                                        counts, remove_hooks)
    expected = {"forward": n_convs, "recompute": n_remat,
                "dgrad": sum(needs_dgrad), "dw": n_convs, "sorted_reduce": 3,
                "segment_offsets": 1}
    if len(needs_dgrad) != n_convs:
        fail(f"the hooks saw {len(needs_dgrad)} conv calls in a step, the "
             f"model has {n_convs} convs")
    _check_launches(steps, expected)
    detection = steps[-1]
    print(f"train: fsdv2_waymo(backbone='sparse') f32, batch 1, AdamW "
          f"(base_lr 1e-5, wd 0.05, clip 10, 10,000-step one-cycle); "
          f"{N_WARMUP} warm-up + {N_TIMED} timed + {N_STAGED} staged steps "
          f"in the schedule's step-0 mode {steps[0]['kw']}, then one step "
          f"with {detection['kw']}", flush=True)
    print(f"  launches per step by kind (counted at the launch sites; the "
          f"modules give {expected}: every conv's input needs a gradient "
          f"{'in all' if sum(needs_dgrad) == n_convs else 'in some'} "
          f"{n_convs} convs, {n_remat} convs sit in rematerialised UNets): "
          f"{steps[0]['launches']}", flush=True)
    record = _print_train(steps, stage_ms, peak)
    print(f"  num_virtual: pretrain steps "
          f"{[st['metrics']['num_virtual'] for st in steps[:-1]]}, "
          f"pretrain=False step {detection['metrics']['num_virtual']}",
          flush=True)
    print(f"  pretrain=False step: {detection['ms']:.2f} ms, "
          f"{detection['metrics']}", flush=True)
    return {**record,
            "launches": {"sparse_conv_gemm": scg.launches,
                         "sparse_conv_dw": sdw.launches,
                         "sorted_reduce": sr.launches,
                         "segment_offsets": sr.offsets_launches},
            "detection_step": detection["metrics"],
            "detection_step_ms": detection["ms"]}


def phase_dense_train(model, device):
    """Drive the dense-BEV build's train path (the main path's training):
    ``train_step`` of ``fsdv2_waymo_dense`` (the bf16 default, or the
    float32 build) on labelled frames (seeds 0-3), the config's optimizer,
    FSDDetectionSchedule's step-0 mode for 2 warm-up, 6 timed and 3 staged
    steps, then one ``pretrain=False`` step. The segmentor VFE's three
    reductions run the sorted-reduce kernel over one offsets launch per
    step; launches per step, by (mode, C, dtype) too, are counted at the
    launch sites and held against the modules. Returns the phase's
    record."""
    frames = [f.to(device) for f in _labeled_frames(4)]
    opt = _adamw(model)
    dtype = sr.DTYPES[model.segmentor_mod.vfe_mod.dtype][0]
    reset_launch_counts()  # the dense train path's run starts here
    steps, stage_ms, peak = _train_loop(model, opt, frames, _fsd_kws(),
                                        _sorted_reduce_counts)
    expected = {"sorted_reduce": 3, "segment_offsets": 1,
                **{f"sorted_reduce {m}/C={c}/{d}": v for (m, c, d), v in
                   _expected_reduce_launches(model).items()}}
    _check_launches(steps, expected)
    detection = steps[-1]
    print(f"dense train: fsdv2_waymo_dense {dtype}, batch 1, AdamW (base_lr "
          f"1e-5, wd 0.05, clip 10, 10,000-step one-cycle); {N_WARMUP} "
          f"warm-up + {N_TIMED} timed + {N_STAGED} staged steps in the "
          f"schedule's step-0 mode {steps[0]['kw']}, then one step with "
          f"{detection['kw']}", flush=True)
    print(f"  launches per step (counted at the launch sites; the "
          f"segmentor VFE gives {expected}): {steps[0]['launches']}",
          flush=True)
    record = _print_train(steps, stage_ms, peak)
    print(f"  pretrain=False step: {detection['ms']:.2f} ms, "
          f"{detection['metrics']}", flush=True)
    return {**record,
            "launches": {"sorted_reduce": sr.launches,
                         "segment_offsets": sr.offsets_launches},
            "detection_step": detection["metrics"],
            "detection_step_ms": detection["ms"]}


def _sst_frames(n_frames: int):
    """The frames the JAX package's SST bench feeds: x, y, z only, within
    74.8 m."""
    return [synthetic_waymo_batch(1, 196608, seed=s) for s in range(n_frames)]


def _record_attention(model, frame):
    """Predict one frame with a hook on every WindowAttention; returns, in
    call order, (module name, nhead, [(q, k, v, pad) per bucket]): the
    attention inputs the main path builds for this frame."""
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, WindowAttention):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: calls.append(
                    (name, m.nhead, m.windows(*args)))))
    try:
        inference_detector(model, frame.points[0], model.max_points)
    finally:
        for h in hooks:
            h.remove()
    return calls


def _mha_close(got, ref, v, pad):
    """Largest error on valid query rows, and whether it is within 1 bf16
    ulp of the output (rtol 2^-7) plus 2^-8 * max|v| (a bf16(p) that rounds
    the other way after another f32 sum order); padded rows only need to be
    finite."""
    got, ref = got.float(), ref.float()
    rows = ~pad
    diff = (got - ref).abs()[rows]
    tol = (2.0**-7 * ref.abs() + 2.0**-8 * v.float().abs().max())[rows]
    err = diff.max().item() if diff.numel() else 0.0
    return err, bool((diff <= tol).all()) and bool(torch.isfinite(got).all())


def _check_mha(name, q, k, v, pad, nhead, errs):
    """The kernel against its twin on valid query rows; a second run gives
    the same bits; skipped rows are zeros. Returns the kernel's output and
    the twin's."""
    got = wm.window_mha(q, k, v, pad, nhead)
    again = wm.window_mha(q, k, v, pad, nhead)
    ref = wm.window_mha_ref(q, k, v, pad, nhead)
    torch.cuda.synchronize()
    err, ok = _mha_close(got, ref, v, pad)
    errs.append(err)
    if not ok:
        fail(f"window_mha disagrees with its twin on {name}: max_abs_err "
             f"{err:.3e}")
    if not torch.equal(got, again):
        fail(f"window_mha gave other bits on a second run of {name}")
    skipped = got[wm.skipped_rows(pad)]
    if not torch.equal(skipped, torch.zeros_like(skipped)):
        fail(f"window_mha did not write zeros on the all-padded windows and "
             f"query tiles of {name}")
    return got, ref


def _sdpa(q, k, v, pad, nhead):
    """The library yardstick: one ``F.scaled_dot_product_attention`` call on
    [W, H, T, dh] bf16 views with an additive [W, 1, 1, T] mask. It
    normalises before AV, so it rounds otherwise than the kernel."""
    w, t, c = q.shape
    q4, k4, v4 = (x.reshape(w, t, nhead, c // nhead).transpose(1, 2)
                  for x in (q, k, v))
    mask = (pad.to(torch.bfloat16) * -1e4)[:, None, None, :]
    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def _mha_edge_cases(device):
    """(name, q, k, v, pad, nhead): an all-padded window, a one-token
    window and a window with all-padded 16-row query tiles, random pads
    elsewhere, T off the multiples of 16 and at the kernel's 320, W = 1,
    and q/k/v as contiguous copies of the strided column blocks."""
    gen = torch.Generator(device=device).manual_seed(3)
    out = []
    for name, w, t, h in (("edge: T=30, all-padded + one-token windows",
                           64, 30, 8),
                          ("edge: T=100, all-padded + one-token windows",
                           16, 100, 8),
                          ("edge: W=1, T=144", 1, 144, 8),
                          ("edge: T=8, 2 heads", 16, 8, 2),
                          ("edge: T=320, all-padded + one-token windows",
                           6, 320, 8)):
        qkv = torch.randn(w, t, 48 * h, generator=gen, device=device)
        qkv = qkv.to(torch.bfloat16)
        pad = torch.rand(w, t, generator=gen, device=device) > 0.6
        if w > 1:
            pad[0] = True
            pad[1] = True
            pad[1, t // 2] = False
            pad[2, 16:48] = True  # two all-padded query tiles (one if T < 48)
        out.append((name, *qkv.split(16 * h, dim=-1), pad, h))
    name, q, k, v, pad, h = out[0]
    out.append(("edge: contiguous copies of the column blocks",
                q.contiguous(), k.contiguous(), v.contiguous(), pad, h))
    return out


def _mha_bound(pad, c):
    """(bound ms, bound_by) of the kernel's function on one input: the pad
    (read) and the output (written) at every slot, k and v at the slots of
    windows with a valid slot, q at the rows of live 16-row query tiles, all
    bf16; and QK^T and PV of those rows against every key of their window
    (padded keys of an occupied window are computed, as in the Pallas
    kernel), on the bf16 tensor cores."""
    w, t = pad.shape
    computed = int((~wm.skipped_rows(pad)).sum())
    occupied = int((~pad).any(1).sum())
    nbytes = w * t * (1 + 2 * c) + 2 * 2 * occupied * t * c + 2 * computed * c
    return bound(nbytes, 4 * computed * t * c, BF16_FLOP_PER_S)


def _host_ms(fn, n=20):
    """The host's time per call of ``fn`` (Python, checks, ctypes, launch)
    with the card idle at the start; the calls are not waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / n


def phase_sst_kernels(model, frame, device,
                      title="sst_waymo(train_buckets=False)"):
    """The window MHA kernel against its twin on the attention inputs of
    every bucket of every layer of one frame, then on edge cases; kernel,
    twin and SDPA timed on each of those inputs, since the kernel's work
    follows the pad. Returns (per (T, C, H): the inputs' means per launch,
    largest error, SDPA's largest error)."""
    with torch.inference_mode():
        calls = _record_attention(model, frame)
        n_inputs = sum(len(b) for _, _, b in calls)
        print(f"SST kernels: window_mha on the attention inputs of frame 0 "
              f"of {title}: {len(calls)} attention "
              f"layers, {n_inputs} (layer, bucket) inputs, each timed",
              flush=True)
        errs, sdpa_errs, inputs = [], [], {}
        for name, nhead, buckets in calls:
            for q, k, v, pad in buckets:
                w, t, c = q.shape
                key = (t, c, nhead)
                _, ref = _check_mha(f"{name}, T={t}, W={w}", q, k, v, pad,
                                    nhead, errs)
                sdpa_err, _ = _mha_close(_sdpa(q, k, v, pad, nhead).transpose(
                    1, 2).reshape(w, t, c), ref, v, pad)
                sdpa_errs.append(sdpa_err)
                # a gross disagreement means the yardstick computes another
                # function; its rounding differs by design
                if sdpa_err > 0.1 * v.float().abs().max().item():
                    fail(f"SDPA disagrees with the twin at {key} in {name}: "
                         f"{sdpa_err:.3e}")
                runs = {"plain": [], "kernel": [], "library": []}
                fns = {"plain": lambda: wm.window_mha_ref(q, k, v, pad, nhead),
                       "kernel": lambda: wm.window_mha(q, k, v, pad, nhead),
                       "library": lambda: _sdpa(q, k, v, pad, nhead)}
                for kind in ("plain", "kernel", "library", "library",
                             "kernel", "plain"):
                    runs[kind].append(cuda_ms(fns[kind], 10, warmup=2))
                bound_ms, bound_by = _mha_bound(pad, c)
                inputs.setdefault(key, []).append({
                    "w": w, "valid_slots": int((~pad).sum()),
                    "computed_slots": int((~wm.skipped_rows(pad)).sum()),
                    "occupied_windows": int((~pad).any(1).sum()),
                    "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
                    "library_ms": min(runs["library"]),
                    "host_ms": _host_ms(fns["kernel"]),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": errs[-1], "sdpa_max_abs_err": sdpa_err})
        shapes = {}
        for (t, c, nhead), rows in inputs.items():
            n = len(rows)
            by = Counter()
            for r in rows:
                by[r["bound_by"]] += r["bound_ms"]
            shapes[(t, c, nhead)] = s = {
                "t": t, "c": c, "h": nhead, "w": rows[0]["w"], "inputs": n,
                **{k: sum(r[k] for r in rows) / n for k in (
                    "valid_slots", "computed_slots", "occupied_windows", "ms",
                    "plain_ms", "library_ms", "host_ms", "bound_ms")},
                "bound_by": by.most_common(1)[0][0],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "sdpa_max_abs_err": max(r["sdpa_max_abs_err"] for r in rows)}
            ms = [r["ms"] for r in rows]
            print(f"  T={t:<3} W={s['w']:<4} C={c} H={nhead}, means over "
                  f"{n} inputs: {s['occupied_windows']:.1f} windows and "
                  f"{s['valid_slots']:.1f} of {s['w'] * t} slots occupied "
                  f"({s['computed_slots']:.1f} computed); kernel "
                  f"{s['ms']:.4f} ms ({min(ms):.4f}-{max(ms):.4f}), twin "
                  f"{s['plain_ms']:.4f} ms, SDPA {s['library_ms']:.4f} ms, "
                  f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}), wrapper "
                  f"host time {s['host_ms'] * 1e3:.1f} us per call; "
                  f"max_abs_err {s['max_abs_err']:.3e}, SDPA vs twin "
                  f"{s['sdpa_max_abs_err']:.3e}", flush=True)
        print(f"  every (layer, bucket) input: max_abs_err {max(errs):.3e} "
              f"(rtol 2^-7 + 2^-8 max|v| on valid query rows); two runs "
              f"equal bit for bit; skipped rows zero", flush=True)
        if "window_mha" not in WRAPPER_HOST_US:
            _, nhead, buckets = calls[0]
            q, k, v, pad = buckets[0]
            _binding_host_us("window_mha", lambda: wm.window_mha(
                q, k, v, pad, nhead), wm, "window_mha")
        edges = _mha_edge_cases(device)
        for name, q, k, v, pad, h in edges:
            got, _ = _check_mha(name, q, k, v, pad, h, errs)
            print(f"  {name:<48} max_abs_err={errs[-1]:.3e} ok (bit-equal "
                  f"repeat, {int(wm.skipped_rows(pad).sum())} skipped rows "
                  f"zero)", flush=True)
            if name.startswith("edge: contiguous"):
                strided = wm.window_mha(*edges[0][1:])
                if not torch.equal(got, strided):
                    fail("window_mha gives other results on contiguous "
                         "copies than on the strided column blocks")
    return shapes, max(errs), max(sdpa_errs)


def phase_sst_predict(model, frames, title="sst_waymo(train_buckets=False)"):
    """Drive the SST path; returns (window MHA launches, launches per frame
    by (T, C, H), latency, capacity counters per frame, the frames'
    results)."""
    results, per_frame = [], []
    reset_launch_counts()
    for frame in frames:
        before = dict(wm.launch_counts)
        results.append(inference_detector(model, frame.points[0],
                                          model.max_points))
        per_frame.append({k: v - before.get(k, 0)
                          for k, v in wm.launch_counts.items()})
    launches, others = wm.launches, sr.launches + scg.launches
    split = per_frame[0]
    print(f"SST predict: {title} on {len(frames)} "
          f"frames; window_mha launches {launches}, per frame by (T, C, H) "
          f"{split}; other kernels' launches {others}", flush=True)
    if any(f != split for f in per_frame):
        fail(f"window_mha launches differ between frames: {per_frame}")
    n_attn = sum(isinstance(m, WindowAttention) for m in model.modules())
    expected = n_attn * len(model.buckets)
    if sum(split.values()) != expected:
        fail(f"expected {expected} window_mha launches per frame "
             f"({n_attn} attention layers x {len(model.buckets)} buckets), "
             f"counted {sum(split.values())}")
    max_num = model.test_cfg["max_num"]
    for s, res in enumerate(results):
        if res["boxes"].shape != (max_num, 7) or res["scores"].shape != (
                max_num,):
            fail(f"SST frame {s}: unexpected output shapes "
                 f"{ {k: v.shape for k, v in res.items()} }")
        for k in ("boxes", "scores"):
            if not np.isfinite(res[k]).all():
                fail(f"SST frame {s}: non-finite {k}")
    diags = []
    with torch.inference_mode():
        for s, frame in enumerate(frames):
            diag = {}
            model.extract_feat(prepare_batch(model, frame.points[0],
                                             model.max_points),
                               diag=diag)
            diags.append({k: float(v) for k, v in diag.items()})
            note = "" if diags[-1]["num_window_dropped_voxels"] == 0 else (
                " -- window caps DROPPED voxels on this frame")
            print(f"  frame {s}: [1, {max_num}] predictions, "
                  f"{int(results[s]['valid'].sum())} valid boxes; "
                  f"{diags[-1]}{note}", flush=True)

    timed = [event_ms(lambda f=frames[r % len(frames)]: inference_detector(
        model, f.points[0], model.max_points)) for r in range(12)]
    lat = statistics.median(timed)
    print(f"SST predict latency (median of 12 CUDA-event runs after "
          f"warm-up, inference_detector incl. host I/O): {lat:.2f} ms; runs "
          f"{[round(t, 2) for t in timed]}", flush=True)
    return launches, split, lat, diags, results


def _labeled_sst_frames(n_frames: int):
    """Labelled frames within the SST range (x, y, z within 74.8 m; the gt
    boxes own their points), seeds 0 .. n_frames - 1."""
    return [synthetic_labeled_batch(1, 196608, seed=s, num_extra_feats=0,
                                    pcr_half=74.8)[0]
            for s in range(n_frames)]


def _record_train_attention(model, batch, generator):
    """One train-mode forward of ``batch`` with a hook on every
    WindowAttention; returns, in call order, (module name, nhead, [(q, k,
    v, pad) per bucket]): the attention inputs of that step. The
    generator's state and the running statistics are put back, so the
    step that follows sees the same voxel shuffle and statistics."""
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, WindowAttention):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: calls.append(
                    (name, m.nhead, m.windows(*args)))))
    state = generator.get_state()
    stats = {k: v.clone() for k, v in model.named_buffers()}
    try:
        with torch.no_grad():
            model.extract_feat(batch, train=True, generator=generator)
    finally:
        for h in hooks:
            h.remove()
        generator.set_state(state)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(stats[k])
    return calls


def _attention_grads_f64(q, k, v, pad, nhead, g):
    """The exact gradient of softmax attention (every step in float64, by
    autograd) at the bf16 inputs: the function of the ported ``_mha_bwd``,
    up to its f32 sums and bf16 results."""
    w, t, c = q.shape
    q4, k4, v4 = (x.double().reshape(w, t, nhead, c // nhead)
                  .requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        logits = torch.einsum("wthd,wshd->whts", q4, k4) / (
            c // nhead) ** 0.5
        logits = logits + pad[:, None, None, :].double() * -1e4
        out = torch.einsum("whts,wshd->wthd", torch.softmax(logits, -1), v4)
        grads = torch.autograd.grad(
            out, (q4, k4, v4), g.double().reshape(w, t, nhead, c // nhead))
    return torch.cat([x.reshape(w, t, c) for x in grads], dim=-1)


def _check_mha_grad(name, q, k, v, pad, nhead, gen):
    """Kernel forward + ported backward against twin forward + ported
    backward on one input, through autograd on the column views of one
    qkv buffer, at a seeded bf16 cotangent that is zero on padded query
    rows (as the window-to-flat gather leaves it): outputs within phase 8's
    tolerance; the buffer's gradient equal bit for bit to the ported
    backward at the twin's inputs (the Function's wiring), and within 1
    bf16 ulp (rtol 2^-7) plus 2^-8 of each gradient's largest magnitude of
    the exact gradient in float64. Returns (output error, gradient error
    over the largest magnitude)."""
    w, t, c = q.shape
    g = torch.randn(w, t, c, generator=gen, device=q.device)
    g = torch.where(pad[..., None], 0.0, g).to(torch.bfloat16)
    qkv = torch.cat([q, k, v], dim=-1).requires_grad_()
    with torch.enable_grad():
        out = wm.window_mha(*qkv.split(c, dim=-1), pad, nhead)
        out.backward(g)
    ref = wm.window_mha_ref(q, k, v, pad, nhead)
    ported = torch.cat(wm.window_mha_backward(q, k, v, pad, nhead, g), -1)
    exact = _attention_grads_f64(q, k, v, pad, nhead, g)
    torch.cuda.synchronize()
    err, ok = _mha_close(out.detach(), ref, v, pad)
    if not ok:
        fail(f"window_mha (under autograd) disagrees with its twin on "
             f"{name}: max_abs_err {err:.3e}")
    if not torch.equal(qkv.grad, ported):
        fail(f"the window_mha autograd gradient is not the ported backward "
             f"at the twin's inputs on {name}")
    gerr = 0.0
    for i in range(3):
        got_i = qkv.grad[..., i * c:(i + 1) * c].double()
        ref_i = exact[..., i * c:(i + 1) * c]
        scale = ref_i.abs().max()
        tol = 2.0**-7 * ref_i.abs() + 2.0**-8 * scale
        if not bool(((got_i - ref_i).abs() <= tol).all()):
            fail(f"the window_mha gradient d{'qkv'[i]} is off the exact "
                 f"float64 gradient on {name}")
        if scale > 0:
            gerr = max(gerr, ((got_i - ref_i).abs().max() / scale).item())
    return err, gerr


def phase_sst_train(model, device,
                    title="sst_waymo(train_buckets=True) f32 (bf16 "
                          "attention)"):
    """Drive the SST train path: first, on the attention inputs of step 0
    (hooks on every WindowAttention), the kernel forward + ported backward
    against the twin forward + ported backward, each input timed (kernel
    forward, backward, twin forward); then ``train_step`` of
    ``sst_waymo(train_buckets=True)`` on labelled frames (seeds 0-3) with
    the config's optimizer and a seeded voxel-shuffle generator: 2
    warm-up, 6 timed and 3 staged steps. Window MHA launches per step are
    counted at the launch site and held against the modules (attention
    layers x buckets); the capacity counters are printed per step. Returns
    (the phase's record, per (T, C, H) the inputs' means)."""
    frames = [f.to(device) for f in _labeled_sst_frames(4)]
    gen = torch.Generator(device=device).manual_seed(0)
    calls = _record_train_attention(model, frames[0], gen)
    gen_g = torch.Generator(device=device).manual_seed(1)
    inputs = {}
    errs, gerrs = [], []
    for name, nhead, buckets in calls:
        for q, k, v, pad in buckets:
            w, t, c = q.shape
            err, gerr = _check_mha_grad(f"{name}, T={t}, W={w}", q, k, v,
                                        pad, nhead, gen_g)
            errs.append(err)
            gerrs.append(gerr)
            g = torch.where(pad[..., None], 0.0, torch.randn(
                w, t, c, generator=gen_g, device=device)).to(torch.bfloat16)
            inputs.setdefault((t, c, nhead), []).append({
                "w": w, "valid_slots": int((~pad).sum()),
                "ms": cuda_ms(lambda: wm.window_mha(q, k, v, pad, nhead), 10),
                "plain_ms": cuda_ms(
                    lambda: wm.window_mha_ref(q, k, v, pad, nhead), 5),
                "library_ms": cuda_ms(lambda: _sdpa(q, k, v, pad, nhead), 5),
                "backward_ms": cuda_ms(lambda: wm.window_mha_backward(
                    q, k, v, pad, nhead, g), 5),
                "bound": _mha_bound(pad, c)})
    shapes = {}
    for key, rows in inputs.items():
        n = len(rows)
        shapes[key] = {"t": key[0], "c": key[1], "h": key[2],
                       "w": rows[0]["w"], "inputs": n,
                       **{k: sum(r[k] for r in rows) / n for k in (
                           "valid_slots", "ms", "plain_ms", "library_ms",
                           "backward_ms")},
                       "bound_ms": sum(r["bound"][0] for r in rows) / n,
                       "bound_by": Counter(
                           r["bound"][1] for r in rows).most_common(1)[0][0]}
    n_inputs = sum(len(r) for r in inputs.values())
    print(f"SST train kernels: window_mha under autograd on the {n_inputs} "
          f"(layer, bucket) attention inputs of train step 0 of "
          f"sst_waymo(train_buckets=True): kernel forward vs twin "
          f"max_abs_err {max(errs):.3e} (phase 8's tolerance on valid query "
          f"rows), the gradient equal bit for bit to the ported backward "
          f"at the twin's inputs, and within 1 bf16 ulp + 2^-8 of its "
          f"largest magnitude of the float64 gradient (largest error "
          f"{max(gerrs):.3e} of that magnitude)", flush=True)
    for (t, c, nhead), sh in sorted(shapes.items()):
        print(f"  T={t:<3} W={sh['w']:<4} C={c} H={nhead}, means over "
              f"{sh['inputs']} inputs: {sh['valid_slots']:.1f} of "
              f"{sh['w'] * t} slots occupied; kernel forward "
              f"{sh['ms']:.4f} ms, twin forward {sh['plain_ms']:.4f} ms, "
              f"SDPA forward {sh['library_ms']:.4f} ms, bound "
              f"{sh['bound_ms']:.4f} ms ({sh['bound_by']}); ported "
              f"backward (torch ops) {sh['backward_ms']:.4f} ms",
              flush=True)

    opt = _adamw(model)
    n_attn = sum(isinstance(m, WindowAttention) for m in model.modules())
    per_pass = n_attn * len(model.buckets)
    # the rematerialised blocks launch each attention again in the backward
    recompute = per_pass if model.backbone_mod.remat_blocks else 0
    expected = {"window_mha": per_pass + recompute,
                "window_mha forward": per_pass,
                "window_mha recompute": recompute}
    n_steps = N_WARMUP + N_TIMED + N_STAGED
    reset_launch_counts()  # the SST train path's run starts here
    steps, stage_ms, peak = _train_loop(
        model, opt, frames, [dict(generator=gen)] * n_steps,
        lambda: {"window_mha": wm.launches,
                 "window_mha forward": wm.kind_counts.get("forward", 0),
                 "window_mha recompute": wm.kind_counts.get("recompute", 0),
                 **{f"window_mha T={t}": v
                    for (t, _, _), v in wm.launch_counts.items()}})
    _check_launches(steps, expected)
    print(f"SST train: {title}, "
          f"batch 1, AdamW (base_lr 1e-5, wd 0.05, clip 10, 10,000-step "
          f"one-cycle), voxel shuffle from a seeded generator, blocks "
          f"rematerialised {model.backbone_mod.remat_blocks}; buckets (T, "
          f"windows) {[(b.max_tokens, b.max_windows) for b in model.buckets]}"
          f"; {N_WARMUP} warm-up + {N_TIMED} timed + {N_STAGED} staged "
          f"steps", flush=True)
    print(f"  launches per step (counted at the launch site; {n_attn} "
          f"attention layers x {len(model.buckets)} buckets, forward and "
          f"recompute, give {expected}): {steps[0]['launches']}",
          flush=True)
    record = _print_train(steps, stage_ms, peak)
    counters = [{k: st["metrics"][k] for k in (
        "num_voxels", "num_voxel_overflow_points",
        "num_window_seat_trimmed_voxels", "num_window_dropped_voxels",
        "num_pos")} for st in steps]
    print(f"  capacity counters per step (the training buckets may drop "
          f"voxels by design): {counters}", flush=True)
    per_step = {k: sum(sh[k] * sh["inputs"] for sh in shapes.values())
                for k in ("ms", "plain_ms", "library_ms", "backward_ms",
                          "bound_ms")}
    print(f"  window_mha per step over its {n_inputs} inputs: kernel "
          f"forward {per_step['ms']:.3f} ms, twin forward "
          f"{per_step['plain_ms']:.3f} ms, SDPA forward "
          f"{per_step['library_ms']:.3f} ms, bound "
          f"{per_step['bound_ms']:.3f} ms; ported backward "
          f"{per_step['backward_ms']:.3f} ms", flush=True)
    return {**record, "launches": {"window_mha": wm.launches},
            "launches_per_step_expected": expected,
            "capacity_counters": counters, "mha_max_abs_err": max(errs),
            "mha_grad_err": max(gerrs), "mha_per_step": per_step,
            "mha_shapes": list(shapes.values())}


# ---------------------------------------------------------------- phase 14

FSD_CONFIG = "configs/fsd/fsd_waymoD1_1x.py"
FSD_DENSE_CONFIG = "configs/fsd/fsd_waymoD1_1x_dense.py"
FSD_FG_FILL = 0.6  # the share of each fg cap the calibrated biases select
FSD_N_TIMED = 12  # inference_detector runs timed after warm-up


def _event():
    return torch.cuda.Event(enable_timing=True)


FSD_VOTE_GAIN = 8.0  # offset = -gain * l * |l| per axis, l the local x, y


def _contract_votes(model):
    """Set the segmentor head's vote weights (weights, not the config) so
    that each point's vote pulls it toward the centre of its 0.25 m
    segmentor voxel: offset = -8 l |l| in x and y, l the point's offset
    from the voxel centre (|l| <= 0.125 m), which maps a voxel's points
    into a 6.25 cm square. Random votes scatter the centres, so with the
    config's ``min_points = 2`` nearly every cluster voxel would hold one
    point and be dropped: the pedestrians' 5 cm cluster voxels can never
    hold two pre-voxelized points (0.1 m cells) unless votes move them.
    Two channels per axis of both pre_seg layers carry +l and -l through
    the ReLUs (their batch norms the identity); the vote is -sqrt(8) l,
    decoded as v |v|. Every other weight stays as drawn."""
    head = getattr(model, "rpn", model).segmentor_mod.head_mod
    mlp = head.pre_seg
    d0, d1 = mlp.Dense_0, mlp.Dense_1
    nin = d0.weight.shape[1]  # voxel features, then the local x, y, z
    gain = math.sqrt(FSD_VOTE_GAIN)
    with torch.no_grad():
        for axis in range(2):
            for half, sign in enumerate((1.0, -1.0)):
                ch = 2 * axis + half
                d0.weight[ch] = 0.0
                d0.weight[ch, nin - 3 + axis] = sign
                d1.weight[ch] = 0.0
                d1.weight[ch, ch] = 1.0
                for bn in (mlp.MaskedBatchNorm_0, mlp.MaskedBatchNorm_1):
                    bn.running_mean[ch] = 0.0
                    bn.running_var[ch] = 1.0 - bn.eps
                    bn.weight[ch] = 1.0
                    bn.bias[ch] = 0.0
        head.voting.weight.zero_()
        head.voting.bias.zero_()
        for c in range(head.num_classes):
            for axis in range(2):
                head.voting.weight[3 * c + axis, 2 * axis] = -gain
                head.voting.weight[3 * c + axis, 2 * axis + 1] = gain


def _calibrate_fg(model, frame):
    """Shift the segmentor head's class biases (weights, not the config) so
    that on ``frame`` the top ``FSD_FG_FILL`` of each class's fg cap passes
    its score threshold. With random weights and ``init_bias = -2`` the
    scores sit near 0.12, under the thresholds (0.3, 0.25, 0.25): sampling
    would select nothing, and CCL, SIR and the RoI head would run on empty
    sets. A bias shift passes through the pre-voxelization's mean exactly,
    so it moves each pre-voxelized logit by the same amount. Returns the
    shifts."""
    rpn = model.rpn
    with torch.inference_mode():
        data = rpn.run_pipeline(prepare_batch(model, frame.points[0],
                                              model.max_points))["data"]
    return _shift_fg_biases(rpn, data)


def _shift_fg_biases(rpn, data, thr_extra: float = 0.0):
    """Shift the seg head's class biases so that the top ``FSD_FG_FILL`` of
    each fg cap of ``data`` (a pipeline's pre-voxelized points) scores
    above its threshold plus ``thr_extra``. Returns the shifts."""
    shifts = []
    for c, thr in enumerate(rpn.score_thresh):
        logits = torch.sort(data["seg_logits"][data["valid"], c],
                            descending=True).values
        n = int(FSD_FG_FILL * rpn.caps.fg_per_class[c])
        if logits.numel() <= n:
            fail(f"fsd: frame 0 has {logits.numel()} pre-voxelized points, "
                 f"too few to fill {n} of class {c}'s fg cap")
        thr = thr + thr_extra
        target = math.log(thr / (1 - thr))
        shifts.append(target - float(logits[n - 1] + logits[n]) / 2)
    with torch.no_grad():
        rpn.segmentor_mod.head_mod.conv_seg.bias += torch.tensor(
            shifts, device=rpn.segmentor_mod.head_mod.conv_seg.bias.device)
    return shifts


class _FSDProbe:
    """Records, for each predict while active, the single stage's counters
    (``extract``'s ``counts``), the proposals' validity and the pool's
    fills and overflow counters. Wraps ``extract``, ``_proposals`` and
    ``roi_head.dynamic_point_pool``; launches nothing."""

    def __init__(self, model):
        self.model = model
        self.frames = []

    def __enter__(self):
        from sst_tpu_torch.models.fsd import roi_head

        rpn, model, rec = self.model.rpn, self.model, {}
        self._roi_head, self._pool = roi_head, roi_head.dynamic_point_pool
        extract, proposals, pool = rpn.extract, model._proposals, self._pool

        def extract_rec(*a, **k):
            out = extract(*a, **k)
            rec["counts"] = {k: v.tolist() for k, v in out["counts"].items()}
            return out

        def proposals_rec(*a, **k):
            out = proposals(*a, **k)
            rec["rois"] = int(out[3].sum())
            return out

        def pool_rec(*a, **k):
            out = pool(*a, **k)
            rec.update(pairs=int(out["valid"].sum()),
                       pair_slots=out["valid"].numel(),
                       membership_overflow=int(out["membership_overflow"]),
                       inbox_overflow=int(out["inbox_overflow"]))
            self.frames.append(dict(rec))
            return out

        rpn.extract, model._proposals = extract_rec, proposals_rec
        roi_head.dynamic_point_pool = pool_rec
        return self

    def __exit__(self, *exc):
        del self.model.rpn.extract, self.model._proposals
        self._roi_head.dynamic_point_pool = self._pool


FSD_STAGES = ("segmentor", "pre-voxelize", "sampling + CCL", "SIR + head",
              "RoI pool", "RoI head", "decode + NMS")


def _fsd_stage_ms(model, frame):
    """One two-stage predict with CUDA events around its stages (module
    and method boundaries), the card synchronised at each boundary: a
    stage's time is its own device work and the host's time to launch it,
    and no stage absorbs the queued work of the one before (the model
    copies small constants to the card, and each copy waits for the
    queue). The pool and the SIR² head run inside ``roi.predict``; decode +
    NMS is the rest of it. An FSD++ model (``frame`` a ``TemporalBatch``)
    adds its point selection before them. Returns ms by stage, "other"
    (the predict outside the stages) and "total" (with the
    synchronisations)."""
    from sst_tpu_torch.models.fsd import roi_head

    fsd = getattr(model, "fsd_mod", model)
    rpn, spans = fsd.rpn, []

    def timed(stage, fn):
        def run(*a, **k):
            start, end = _event(), _event()
            torch.cuda.synchronize()
            start.record()
            out = fn(*a, **k)
            end.record()
            torch.cuda.synchronize()
            spans.append((stage, start, end))
            return out
        return run

    patched = [(rpn.segmentor_mod, "forward", "segmentor"),
               (rpn, "pre_voxelize", "pre-voxelize"),
               (rpn, "sample_class", "sampling + CCL"),
               (rpn, "cluster_class", "sampling + CCL"),
               (rpn.backbone_mod, "forward", "SIR + head"),
               (rpn.head_mod, "forward", "SIR + head"),
               (fsd.roi.bbox_head_mod, "forward", "RoI head"),
               (fsd.roi, "predict", "roi.predict")]
    stages = FSD_STAGES
    if fsd is not model:
        patched.append((model, "to_point_batch", "point selection"))
        stages = ("point selection",) + FSD_STAGES
    for obj, name, stage in patched:
        setattr(obj, name, timed(stage, getattr(obj, name)))
    pool = roi_head.dynamic_point_pool
    roi_head.dynamic_point_pool = timed("RoI pool", pool)
    try:
        batch = frame if fsd is not model else prepare_batch(
            model, frame.points[0], model.max_points)
        start, end = _event(), _event()
        start.record()
        model.predict(batch)
        end.record()
        end.synchronize()
    finally:
        roi_head.dynamic_point_pool = pool
        for obj, name, _ in patched:
            delattr(obj, name)
    ms = Counter()
    for stage, s, e in spans:
        ms[stage] += s.elapsed_time(e)
    ms["decode + NMS"] = ms.pop("roi.predict") - ms["RoI pool"] \
        - ms["RoI head"]
    out = {k: ms[k] for k in stages}
    out["total"] = start.elapsed_time(end)
    out["other"] = out["total"] - sum(ms[k] for k in stages)
    return out


def phase_fsd_kernels(model, frame, device, drive=None, title=FSD_CONFIG,
                      modes=("subm", "strided", "inverse")):
    """The sparse conv kernel against its twin on every conv of one FSD
    frame, on the conv's recorded input features, rulebook and weights
    (hooks on each SparseConvLayer, frame 0 of the main path), one case
    per distinct (rulebook, Cin, Cout): phase 6's tolerance and bit-equal
    repeat; kernel and twin timed (plain, kernel, kernel, plain), the bound
    at 3xTF32 over the (row, tap) pairs with a neighbour, and the executed
    shares. ``drive``: the call that runs frame 0 (an FSD predict through
    ``inference_detector`` where none is given); ``modes``: the conv modes
    the path must show. Returns (shapes, per-frame sums, largest error, the
    frame's convs by (mode, Cin, Cout))."""
    calls = _record_sparse_convs(model, frame, drive)
    cases = {}
    for name, vin, cp, wshape, feats, _ in calls:
        key = (id(cp.nbr), wshape[1], wshape[2])
        if key not in cases:
            cases[key] = dict(name=name, plan=cp, vin=vin, feats=feats,
                              w=model.get_submodule(name).weight.detach(),
                              convs=0)
        cases[key]["convs"] += 1
    convs = Counter((cp.mode, w[1], w[2]) for _, _, cp, w, _, _ in calls)
    print(f"fsd kernels ({title}): sparse_conv_gemm on the recorded inputs "
          f"of the {len(calls)} convs of frame 0 ({len(cases)} distinct "
          f"rulebook "
          f"and widths); convs by (mode, Cin, Cout) {dict(convs)}",
          flush=True)
    errs, shapes = [], []
    for case in cases.values():
        cp, vin, feats, w = case["plan"], case["vin"], case["feats"], case["w"]
        nbr, mode = cp.nbr, cp.mode
        sched = cp.schedule(vin)
        short = case["name"].split("segmentor_mod.unet_mod.")[-1]
        _check_conv(f"{short} (x{case['convs']})", feats, nbr, w, mode, errs,
                    schedule=sched)
        runs = [cuda_ms(fn, 10, warmup=2) for fn in (
            lambda: scg.sparse_conv_gemm_ref(feats, nbr, w),
            lambda: scg.sparse_conv_gemm(feats, nbr, w, mode, schedule=sched),
            lambda: scg.sparse_conv_gemm(feats, nbr, w, mode, schedule=sched),
            lambda: scg.sparse_conv_gemm_ref(feats, nbr, w))]
        kern, plain = min(runs[1], runs[2]), min(runs[0], runs[3])
        taps, vout = nbr.shape
        cin, cout = w.shape[1], w.shape[2]
        hit, _, executed = _executed_shares(nbr, vin, sched)
        flops = 2 * hit * taps * vout * cin * cout
        nbytes = 4 * (vin * cin + taps * vout + taps * cin * cout
                      + vout * cout)
        bound_ms, bound_by = bound(nbytes, flops, F32_TC_FLOP_PER_S)
        print(f"    time: kernel {kern:.4f} ms per call (runs {runs[1]:.4f}, "
              f"{runs[2]:.4f}), plain twin {plain:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, 3xTF32); (row, tap) pairs: "
              f"{hit:.3f} have a neighbour, {executed:.3f} executed by the "
              f"tile schedule", flush=True)
        shapes.append({"conv": case["name"], "convs_per_frame": case["convs"],
                       "mode": mode, "cin": cin, "cout": cout, "vin": vin,
                       "vout": vout, "neighbour_share": hit,
                       "executed_share_tiles": executed, "ms": kern,
                       "plain_ms": plain, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": errs[-1]})
    covered = {(s["mode"], s["cin"], s["cout"]) for s in shapes}
    for width in sorted({c for _, c, _ in covered}):
        modes = {m for m, c, _ in covered if c == width}
        print(f"  Cin {width}: checked {sorted(modes)}", flush=True)
    if not set(modes) <= {m for m, _, _ in covered}:
        fail(f"fsd kernels: not every conv mode was checked: {covered}")
    per_frame = {k: sum(s[k] * s["convs_per_frame"] for s in shapes)
                 for k in ("ms", "plain_ms", "bound_ms")}
    print(f"fsd kernels: per frame over its {len(calls)} convs: kernel "
          f"{per_frame['ms']:.3f} ms, plain twin {per_frame['plain_ms']:.3f} "
          f"ms, bound {per_frame['bound_ms']:.3f} ms (3xTF32); largest "
          f"error {max(errs):.3e}", flush=True)
    del calls, cases
    return shapes, per_frame, max(errs), convs


def _check_fsd_frame(model, s, res, rec):
    """The frame's fills and outputs: each fg cap filled between a quarter
    and all, no stage fed an empty set, finite outputs, at most max_num
    detections."""
    rpn = model.rpn
    caps = rpn.caps
    c = rec["counts"]
    rounds = c["ccl_rounds"]
    print(f"  frame {s}: fg points {c['fg']} of {list(caps.fg_per_class)}; "
          f"cluster voxels {c['cluster_voxels']} of "
          f"{list(caps.cluster_voxels_per_class)}; clusters {c['clusters']} "
          f"of {list(caps.clusters_per_class)} (before the cap); CCL rounds "
          f"{rounds} (64-round cap reached: {[r >= 64 for r in rounds]}); "
          f"valid rois {rec['rois']} of {model.rois_per_sample}; paired "
          f"points {rec['pairs']} of {rec['pair_slots']}; "
          f"membership_overflow {rec['membership_overflow']}, "
          f"inbox_overflow {rec['inbox_overflow']}; "
          f"{int(res['valid'].sum())} detections", flush=True)
    for k, cap in zip(c["fg"], caps.fg_per_class):
        if not cap // 4 <= k <= cap:
            fail(f"fsd frame {s}: fg fill {c['fg']} outside a quarter to "
                 f"all of the caps {caps.fg_per_class}")
    for name, n in (("cluster voxels", min(c["cluster_voxels"])),
                    ("clusters", min(c["clusters"])),
                    ("valid rois", rec["rois"]),
                    ("paired points", rec["pairs"]),
                    ("detections", int(res["valid"].sum()))):
        if n == 0:
            fail(f"fsd frame {s}: no {name}: a stage ran on an empty set")
    rows = min(rpn.test_cfg["max_num"],
               model.rois_per_sample)
    if res["boxes"].shape != (rows, 7) or int(res["valid"].sum()) > rows:
        fail(f"fsd frame {s}: boxes {res['boxes'].shape}, "
             f"{int(res['valid'].sum())} valid; expected [{rows}, 7]")
    for k in ("boxes", "scores"):
        if not np.isfinite(res[k]).all():
            fail(f"fsd frame {s}: non-finite {k}")


def _latency(fn, frames, n):
    """Median and range of ``n`` CUDA-event runs of ``fn(frame)`` over the
    frames in turn, after one warm-up run per frame."""
    for frame in frames:
        fn(frame)
    runs = [event_ms(lambda f=frames[r % len(frames)]: fn(f))
            for r in range(n)]
    return {"median": statistics.median(runs), "min": min(runs),
            "max": max(runs), "runs": runs}


def phase_fsd_predict(model, frames, n_convs):
    """Drive FSD two-stage predict through ``inference_detector`` from zero
    counts on every frame; conv launches per frame held to the module's
    convs; fills, counters and outputs per frame; latency of
    ``inference_detector`` and of ``predict(skip_rcnn=True)``; stage times
    and peak memory. Returns the phase's record."""
    results, per_frame = [], []
    with _FSDProbe(model) as probe:
        reset_launch_counts()
        for frame in frames:
            before = dict(scg.launch_counts)
            results.append(inference_detector(model, frame.points[0],
                                              model.max_points))
            per_frame.append({k: v - before.get(k, 0)
                              for k, v in scg.launch_counts.items()})
        launches = scg.launches
        reduce_launches = sr.launches
    split = per_frame[0]
    print(f"fsd predict: {FSD_CONFIG} on {len(frames)} frames; "
          f"sparse_conv_gemm launches {launches}, per frame by (mode, Cin, "
          f"Cout) {split}; sorted_segment_reduce launches {reduce_launches} "
          f"(the config leaves use_sorted_reduce off)", flush=True)
    if any(f != split for f in per_frame):
        fail(f"fsd: conv launches differ between frames: {per_frame}")
    if sum(split.values()) != n_convs:
        fail(f"fsd: expected {n_convs} sparse conv launches per frame (one "
             f"per SparseConvLayer), counted {sum(split.values())}")
    if reduce_launches:
        fail(f"fsd: the sorted reduce launched {reduce_launches} times")
    for s, (res, rec) in enumerate(zip(results, probe.frames)):
        _check_fsd_frame(model, s, res, rec)

    lat = _latency(lambda f: inference_detector(
        model, f.points[0], model.max_points), frames, FSD_N_TIMED)
    lat_rpn = _latency(lambda f: frame_to_numpy(model.predict(
        prepare_batch(model, f.points[0], model.max_points),
        skip_rcnn=True)), frames, FSD_N_TIMED)
    for name, l in (("inference_detector (two stage)", lat),
                    ("predict(skip_rcnn=True) incl. host I/O", lat_rpn)):
        print(f"fsd latency, {name}: median {l['median']:.2f} ms, range "
              f"{l['min']:.2f}-{l['max']:.2f} over {FSD_N_TIMED} CUDA-event "
              f"runs after warm-up; runs {[round(t, 2) for t in l['runs']]}",
              flush=True)
    stages = [_fsd_stage_ms(model, f) for f in frames[:3]]
    stage_ms = {k: statistics.median(s[k] for s in stages)
                for k in stages[0]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inference_detector(model, frames[0].points[0], model.max_points)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"fsd stages, ms (median of 3 frames, CUDA events at module and "
          f"method boundaries, the card synchronised at each): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; peak memory of one predict {peak:.3f} GiB", flush=True)
    return {"launches": launches, "split": split, "latency": lat,
            "latency_skip_rcnn": lat_rpn, "stage_ms": stage_ms,
            "peak_gib": peak, "frames": probe.frames,
            "detections": [int(r["valid"].sum()) for r in results],
            "trace": _fsd_trace(model, frames)}


def _trace(calls, what: str) -> dict:
    """``torch.profiler`` over the ``calls`` (functions of no argument): the
    device's busy time (the union of its kernel and copy intervals), the
    wall time, the idle share (profiler on) and the kernels taking the
    most device time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_busy(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = 1.0 - busy / wall if busy > 0 else None
    print(f"trace over {what} (profiler on): device busy "
          f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; top kernels:",
          flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name[:100]}", flush=True)
    return {"device_busy_ms": busy, "wall_ms": wall, "idle_share": idle,
            "top_kernels_ms": {k[:100]: v for k, v in top}}


def _fsd_trace(model, frames, n=2):
    """:func:`_trace` over ``n`` predicts (two-stage ones of FSD++'s
    batches, or of the frames' points)."""
    batches = [f if hasattr(model, "fsd_mod") else prepare_batch(
        model, f.points[0], model.max_points) for f in frames[:n]]
    return {"predicts": n, **_trace(
        [lambda b=b: model.predict(b) for b in batches], f"{n} predicts")}


def phase_fsd_dense(frames):
    """configs/fsd/fsd_waymoD1_1x_dense.py through the same builder (seed-0
    weights, the fg biases calibrated on frame 0): its outputs checked as
    the sparse build's, its predict timed. The dense-BEV segmentor runs no
    hand-written kernel (its VFE leaves the sorted reduce off)."""
    t0 = time.perf_counter()
    model = init_weights(build_model_from_cfg(load_config(FSD_DENSE_CONFIG),
                                              train=False),
                         torch.Generator().manual_seed(0)).eval()
    _contract_votes(model)
    shifts = _calibrate_fg(model, frames[0])
    print(f"model: {FSD_DENSE_CONFIG}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, built "
          f"in {time.perf_counter() - t0:.1f} s; fg bias shifts "
          f"{[round(x, 3) for x in shifts]}", flush=True)
    with _FSDProbe(model) as probe:
        reset_launch_counts()
        results = [inference_detector(model, f.points[0], model.max_points)
                   for f in frames]
        launches = scg.launches + sr.launches
    if launches:
        fail(f"fsd dense: {launches} kernel launches; its path runs none")
    for s, (res, rec) in enumerate(zip(results, probe.frames)):
        _check_fsd_frame(model, s, res, rec)
    lat = _latency(lambda f: inference_detector(
        model, f.points[0], model.max_points), frames, FSD_N_TIMED // 2)
    print(f"fsd dense latency, inference_detector (two stage): median "
          f"{lat['median']:.2f} ms, range {lat['min']:.2f}-{lat['max']:.2f} "
          f"over {FSD_N_TIMED // 2} runs; runs "
          f"{[round(t, 2) for t in lat['runs']]}", flush=True)
    return {"latency": lat, "frames": probe.frames}


def phase_fsd(device):
    """Phase 14: FSD two-stage at the full width of configs/fsd/
    fsd_waymoD1_1x.py, built by the port's config loader and builder (seed-0
    weights, TF32 off). Returns the phase's record."""
    t0 = time.perf_counter()
    model = init_weights(build_model_from_cfg(load_config(FSD_CONFIG),
                                              train=False),
                         torch.Generator().manual_seed(0)).eval()
    n_convs = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    frames = _frames(4)  # bench.py bench_fsd's frames
    _contract_votes(model)
    shifts = _calibrate_fg(model, frames[0])
    print(f"model: {FSD_CONFIG} through build_model_from_cfg, f32, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{n_convs} sparse convs, built in {time.perf_counter() - t0:.1f} "
          f"s; votes contracted toward the segmentor voxel centres, fg bias "
          f"shifts {[round(x, 3) for x in shifts]} (a {FSD_FG_FILL} fill "
          f"of each fg cap on frame 0)", flush=True)
    shapes, per_frame, err, convs = phase_fsd_kernels(model, frames[0],
                                                      device)
    if sum(convs.values()) != n_convs:
        fail(f"fsd: frame 0 ran {sum(convs.values())} sparse convs, the "
             f"model has {n_convs}")
    rec = phase_fsd_predict(model, frames, n_convs)
    if Counter(rec["split"]) != convs:
        fail(f"fsd: the convs checked {dict(convs)} are not those launched "
             f"per frame {rec['split']}")
    rec["split"] = {f"{m} {a}->{b}": n for (m, a, b), n in
                    rec["split"].items()}
    del model
    torch.cuda.empty_cache()
    rec["dense"] = phase_fsd_dense(frames)
    rec.update(shapes=shapes, per_frame=per_frame, max_abs_err=err)
    return rec

# ---------------------------------------------------------------- phase 15

FSD_TRAIN_TOTAL_STEPS = 10000  # the one-cycle of the config's AdamW


class _KeptRunningStats:
    """Puts every running statistic of ``model`` back on exit: a train-mode
    forward that only measures must not move them."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        self.kept = {k: v.clone() for k, v in self.model.state_dict().items()
                     if "running_" in k}
        return self

    def __exit__(self, *exc):
        state = self.model.state_dict()
        with torch.no_grad():
            for k, v in self.kept.items():
                state[k].copy_(v)


def _train_vote_norms(model, batch):
    """In train mode the seg head's batch norms normalise the four vote
    channels that ``_contract_votes`` routes through them (+-local x, y)
    by the batch's statistics, which would scale the votes by ~14. Set
    those channels' scale and bias to the batch's standard deviation and
    mean on ``batch`` (weights, not the config), so that both norms pass
    them through as at inference. Returns the scales set."""
    rpn = getattr(model, "rpn", model)
    mlp = rpn.segmentor_mod.head_mod.pre_seg
    scales = []
    for bn in (mlp.MaskedBatchNorm_0, mlp.MaskedBatchNorm_1):
        seen = []
        hook = bn.register_forward_pre_hook(
            lambda m, args: seen.append((args[0][:, :4].detach(),
                                         args[1])))
        try:
            with torch.no_grad(), _KeptRunningStats(model):
                rpn.segmentor_mod(
                    batch.points.reshape(-1, batch.points.shape[-1]),
                    torch.zeros(batch.points.shape[1], dtype=torch.int32,
                                device=batch.points.device),
                    batch.valid.reshape(-1), 1, True)
        finally:
            hook.remove()
        x, mask = seen[0]
        x = x[mask] if mask is not None else x
        mean = x.mean(0)
        var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.weight[:4] = torch.sqrt(var + bn.eps)
            bn.bias[:4] = mean
        scales.append([round(v, 4) for v in bn.weight[:4].tolist()])
    return scales


class _SamplerProbe:
    """Records what the RoI sampler kept on each call while active: the
    positives and the negatives of each IoU piece (wraps
    ``roi_head.iou_neg_piecewise_sample``; launches nothing, reads the
    host once per call)."""

    def __enter__(self):
        from sst_tpu_torch.models.fsd import roi_head

        self._mod, self._fn, self.calls = roi_head, \
            roi_head.iou_neg_piecewise_sample, []
        fn = self._fn

        def probe(max_iou, is_pos, valid, num, pos_fraction, fractions,
                  thrs, **kw):
            keep = fn(max_iou, is_pos, valid, num, pos_fraction, fractions,
                      thrs, **kw)
            neg = keep & ~is_pos
            bounds = list(thrs) + [0.0]
            self.calls.append({
                "valid": int(valid.sum()), "positives": int(
                    (is_pos & valid).sum()), "kept_positives": int(
                    (keep & is_pos).sum()),
                "kept_negatives_by_piece": [
                    int((neg & (max_iou >= bounds[i + 1])
                         & (max_iou < bounds[i])).sum())
                    for i in range(len(fractions))]})
            return keep

        roi_head.iou_neg_piecewise_sample = probe
        return self

    def __exit__(self, *exc):
        self._mod.iou_neg_piecewise_sample = self._fn


def _plain_gather(src, index, fill=0.0):
    """The padded gathers before the repair: every outside slot reads one
    clamped row (``src[index]``, whose backward is the sort-based index
    backward) and is masked."""
    inside = (index >= 0) & (index < src.shape[0])
    out = src[torch.clamp(index.long(), 0, src.shape[0] - 1)]
    return torch.where(inside[:, None], out, fill)


def _index_backward_trace(model, opt, frames, kw, n=2):
    """``torch.profiler`` over ``n`` train steps: the device time of the
    sort-based index backward (``indexing_backward_kernel``) per step, the
    device's busy share and idle share, and the top kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            train_step(model, opt, frames[i % len(frames)], kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_busy(prof)
    index_ms = sum(v for k, v in by_name.items()
                   if "indexing_backward_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": n, "index_backward_ms_per_step": index_ms / n,
            "device_busy_ms": busy, "wall_ms": wall,
            "idle_share": 1.0 - busy / wall if busy > 0 else None,
            "top_kernels_ms": {k[:100]: v for k, v in top}}


FSD_JITTER = (0.03, 0.1, 0.3, 0.8)  # proposal jitter scales, in turn
FSD_JITTER_AXES = (1.0, 1.0, 0.3, 0.2, 0.2, 0.1, 0.5)  # x y z w l h yaw


def _fsd_roi_positives(model, batch, gen):
    """``GroupCorrectionHead.loss`` and its backward at full width on frame
    0's RoI point set (a train-mode pipeline, no gradient into it) with 256
    proposals made from the frame's valid gt boxes and seeded jitter of
    four sizes, the config's sampler on. Random weights rarely propose a
    box at IoU 0.55, so the main path's steps may see no positive; here
    positives (cars among them) must exist, and every gradient of the RoI
    head and of the point features must be finite. Returns the losses and
    the car positives."""
    roi = model.roi
    with torch.no_grad(), _KeptRunningStats(model):
        pipe = model.rpn.run_pipeline(batch, train=True)
        pts, feats, pvalid, pbatch = model._roi_points(pipe)
    gv = batch.gt_valid[0]
    gt, gl = batch.gt_boxes[0][gv], batch.gt_labels[0][gv]
    k = model.rois_per_sample
    pick = torch.arange(k, device=gt.device) % gt.shape[0]
    scale = torch.tensor(FSD_JITTER, device=gt.device)[
        (torch.arange(k, device=gt.device) // gt.shape[0]) % len(FSD_JITTER)]
    noise = torch.randn(k, 7, generator=gen, device=gt.device) * scale[
        :, None] * torch.tensor(FSD_JITTER_AXES, device=gt.device)
    props = gt[pick] + noise
    props[:, 3:6] = torch.abs(props[:, 3:6]) + 0.1
    feats = feats.detach().requires_grad_()
    valid = torch.ones(k, dtype=torch.bool, device=gt.device)
    sample = torch.zeros(k, dtype=torch.int32, device=gt.device)
    for p in roi.parameters():
        p.grad = None
    with _SamplerProbe() as probe:
        out = roi.loss(pts, feats, pvalid, pbatch, props, gl[pick], valid,
                       sample, batch.gt_boxes, batch.gt_labels,
                       batch.gt_valid, True, generator=gen)
    sum(v for n, v in out.items() if n.startswith("loss")).backward()
    _, argmax, is_pos = roi.assign_and_sample(
        props, gl[pick], valid, sample, batch.gt_boxes, batch.gt_labels,
        batch.gt_valid)
    car_pos = int((is_pos & (batch.gt_labels.reshape(-1)[argmax] == 0)).sum())
    losses = {n: float(v.detach()) for n, v in out.items()}
    grads = [p.grad for p in roi.parameters()] + [feats.grad]
    bad = [i for i, g in enumerate(grads)
           if g is None or not torch.isfinite(g).all()]
    print(f"  RoI loss at full width on frame 0's RoI point set, {k} "
          f"proposals from its {gt.shape[0]} valid gt boxes with jitter "
          f"{FSD_JITTER} (x, y, z, w, l, h, yaw weighted {FSD_JITTER_AXES}), "
          f"the config's sampler on: {losses}; car positives {car_pos}; "
          f"sampler kept {probe.calls[-1]}", flush=True)
    if losses["num_pos_rois"] <= 0 or car_pos <= 0 \
            or losses["loss_rcnn_corner"] <= 0:
        fail(f"fsd train: the jittered-gt RoI loss has no (car) positive: "
             f"{losses}, car positives {car_pos}")
    if bad or not all(np.isfinite(v) for v in losses.values()):
        fail(f"fsd train: the jittered-gt RoI loss or its gradients are not "
             f"finite ({len(bad)} gradients)")
    return {"losses": losses, "car_positives": car_pos,
            "sampler": probe.calls[-1]}


def phase_fsd_train(device):
    """Phase 15: train configs/fsd/fsd_waymoD1_1x.py at full width, built by
    ``build_model_from_cfg(cfg, train=True)`` (seed-0 weights, TF32 off),
    with the config's AdamW and FSDDetectionSchedule: 2 warm-up, 6 timed
    and 3 staged steps in the schedule's step-0 mode (``pretrain=True``),
    the same at ``enable_after`` (``pretrain=False, thr_extra=0.3``), one
    step at ``thr_extra=0.0``; the sampler draws from a seeded generator.
    Conv, recompute, input-gradient and dW launches per step held against
    the modules; dW and the input gradient against their twins on the
    inputs of every conv of a ``pretrain=False`` step; the RoI loss with
    positives on jittered gt; the index backward's device time from a
    trace, with the repaired gathers and with the plain ones. Returns the
    phase's record."""
    t0 = time.perf_counter()
    cfg = load_config(FSD_CONFIG)
    model = init_weights(build_model_from_cfg(cfg, train=True),
                         torch.Generator().manual_seed(0)).train()
    n_convs = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    frames = [f.to(device) for f in _labeled_frames(4)]
    schedule = schedule_from_cfg(cfg)
    pretrain_kw = schedule(0)
    detect_kw = schedule(schedule.enable_after)
    final_kw = schedule(schedule.delay_buffer_until)
    _contract_votes(model)
    vote_scales = _train_vote_norms(model, frames[0])
    with torch.no_grad(), _KeptRunningStats(model):
        data = model.rpn.run_pipeline(frames[0], train=True)["data"]
        shifts = _shift_fg_biases(model.rpn, data, detect_kw["thr_extra"])
    del data
    print(f"model: {FSD_CONFIG} through build_model_from_cfg(train=True), "
          f"f32, {sum(p.numel() for p in model.parameters())} parameters, "
          f"{n_convs} sparse convs, remat "
          f"{model.rpn.segmentor_mod.unet_mod.remat}, RoI sampler "
          f"{model.roi.sampler}, built in {time.perf_counter() - t0:.1f} s; "
          f"votes contracted (vote channels' train-mode norm scales "
          f"{vote_scales}), fg bias shifts {[round(x, 3) for x in shifts]} "
          f"(a {FSD_FG_FILL} fill of each fg cap on labelled frame 0 in "
          f"train mode at thr_extra {detect_kw['thr_extra']})", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)

    def train_forward():
        # one pretrain=False forward of the loss in train mode: no
        # gradient, running statistics put back
        with torch.no_grad(), _KeptRunningStats(model):
            model.loss(frames[0], train=True, **detect_kw, generator=gen)

    calls = _record_sparse_convs(model, frames[0], train_forward)
    modes = Counter((cp.mode, w[1], w[2]) for _, _, cp, w, _, _ in calls)
    if len(calls) != n_convs or not {"subm", "strided", "inverse"} <= {
            m for m, _, _ in modes}:
        fail(f"fsd train: recorded {len(calls)} convs by (mode, Cin, Cout) "
             f"{dict(modes)}; the model has {n_convs}")
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        model, frames[0], device, calls=calls,
        title=f"a pretrain=False train step of {FSD_CONFIG} (labelled frame "
              f"0, train mode)")
    del calls

    opt = optimizer_from_cfg(model, cfg, FSD_TRAIN_TOTAL_STEPS)
    convs = [m for m in model.modules() if isinstance(m, SparseConvLayer)]
    n_remat = sum(isinstance(m, SparseConvLayer) for u in model.modules()
                  if isinstance(u, SimpleSparseUNet) and u.remat
                  for m in u.modules())
    needs_dgrad = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: None if remat.recomputing()
        else needs_dgrad.append(bool(args[0].requires_grad))) for m in convs]

    def remove_hooks(i):
        if i == 0:
            for h in hooks:
                h.remove()

    def counts():
        return {**scg.kind_counts, "dw": sdw.launches,
                **_sorted_reduce_counts()}

    outside_segmentor = sum(1 for n, p in model.named_parameters()
                            if p.requires_grad and "segmentor_mod" not in n)
    n_steps = N_WARMUP + N_TIMED + N_STAGED
    reset_launch_counts()  # the FSD train path's run starts here
    pre_steps, pre_stage, pre_peak = _train_loop(
        model, opt, frames, [dict(pretrain_kw, generator=gen)] * n_steps,
        counts, remove_hooks, no_grad_params=outside_segmentor)
    expected = {"forward": n_convs, "recompute": n_remat,
                "dgrad": sum(needs_dgrad), "dw": n_convs,
                "sorted_reduce": 0}
    if len(needs_dgrad) != n_convs:
        fail(f"fsd train: the hooks saw {len(needs_dgrad)} conv calls in a "
             f"step, the model has {n_convs} convs")
    _check_launches(pre_steps, expected)
    with _SamplerProbe() as probe:
        det_steps, det_stage, det_peak = _train_loop(
            model, opt, frames,
            [dict(detect_kw, generator=gen)] * n_steps
            + [dict(final_kw, generator=gen)], counts)
    _check_launches(det_steps, expected)
    launches = {"sparse_conv_gemm": scg.launches,
                "sparse_conv_dw": sdw.launches,
                "sorted_reduce": sr.launches}
    print(f"fsd train: {FSD_CONFIG}, batch 1, AdamW from the config "
          f"({cfg['optimizer']}, a {FSD_TRAIN_TOTAL_STEPS}-step one-cycle), "
          f"FSDDetectionSchedule from the config; launches per step by kind "
          f"(counted at the launch sites; the modules give {expected}: "
          f"{n_convs} convs, {n_remat} in the rematerialised UNet, the "
          f"input of {sum(needs_dgrad)} needing a gradient): "
          f"{pre_steps[0]['launches']}; in the whole run {launches}",
          flush=True)
    print(f" pretrain: {N_WARMUP} warm-up + {N_TIMED} timed + {N_STAGED} "
          f"staged steps in the schedule's step-0 mode {pretrain_kw} "
          f"({outside_segmentor} parameters outside the segmentor get no "
          f"gradient, zeros as in JAX)", flush=True)
    pre = _print_train(pre_steps, pre_stage, pre_peak)
    print(f" detection: the same at enable_after {detect_kw}, then one "
          f"step at {final_kw}", flush=True)
    det = _print_train(det_steps[:-1], det_stage, det_peak)
    keys = ("num_fg_points", "num_clusters", "num_pos_rois",
            "roi_membership_overflow")
    for name in keys:
        print(f"  {name} per step: "
              f"{[st['metrics'][name] for st in det_steps]}", flush=True)
    print(f"  sampler per step (valid proposals, positives, kept positives, "
          f"kept negatives in [0.1, 0.55) and [0, 0.1)): {probe.calls}",
          flush=True)
    final = det_steps[-1]
    print(f"  thr_extra 0.0 step: {final['ms']:.2f} ms, {final['metrics']}",
          flush=True)

    positives = _fsd_roi_positives(
        model, frames[0], torch.Generator(device=device).manual_seed(1))
    trace = _index_backward_trace(model, opt, frames,
                                  dict(detect_kw, generator=gen))
    from sst_tpu_torch.models.fsd import roi_head, two_stage
    from sst_tpu_torch.ops import segment

    patched = [(mod, getattr(mod, "gather_rows"))
               for mod in (segment, roi_head, two_stage)]
    for mod, _ in patched:
        mod.gather_rows = _plain_gather
    try:
        plain = _index_backward_trace(model, opt, frames,
                                      dict(detect_kw, generator=gen))
    finally:
        for mod, fn in patched:
            mod.gather_rows = fn
    for name, tr in (("repaired gathers", trace),
                     ("plain clamped gathers (before the repair)", plain)):
        top = {k[:60]: round(v, 2) for k, v in tr["top_kernels_ms"].items()}
        print(f"  trace of {tr['steps']} pretrain=False steps, {name} "
              f"(profiler on): indexing_backward_kernel "
              f"{tr['index_backward_ms_per_step']:.3f} ms per step; device "
              f"busy {tr['device_busy_ms']:.1f} of {tr['wall_ms']:.1f} ms "
              f"wall, idle share {tr['idle_share']:.3f}; top kernels {top}",
              flush=True)
    return {"pretrain": pre, "detection": det, "launches": launches,
            "launches_per_step": expected, "final_step": final["metrics"],
            "final_step_ms": final["ms"],
            "counters": {k: [st["metrics"][k] for st in det_steps]
                         for k in keys},
            "sampler": probe.calls, "positives": positives,
            "trace": trace, "trace_plain_gathers": plain,
            "dw_shapes": dw_shapes, "dw_step": dw_step, "dw_err": dw_err,
            "dgrad_err": dgrad_err}



# ---------------------------------------------------------------- phase 16

SST_BF16 = "sst_waymo(train_buckets=False, dtype=torch.bfloat16)"


def phase_sst_bf16_predict(f32_model, frames, f32_results, device):
    """Phase 16, predict: ``sst_waymo`` at bf16 compute (``bench.py
    bench_sst``'s build) with phase 9's seed-0 weights: the window MHA
    kernel against its twin on the 48 (layer, bucket) attention inputs of
    frame 0 of the bf16 model (phase 8's checks and timings); predict on
    the four frames through ``inference_detector`` (48 launches per frame,
    capacity counters, detections shared with the float32 build, printed);
    bf16 and float32 latency in rotation; peak memory of one predict.
    Returns the phase's record."""
    t0 = time.perf_counter()
    model = sst_waymo(train_buckets=False, dtype=torch.bfloat16,
                      num_point_features=3)
    model.load_state_dict(f32_model.state_dict())
    model.eval()
    print(f"model: {SST_BF16} with phase 9's weights (float32 parameters, "
          f"bf16 compute), built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    shapes, err, sdpa_err = phase_sst_kernels(model, frames[0], device,
                                              title=SST_BF16)
    launches, split, lat, diags, results = phase_sst_predict(
        model, frames, title=SST_BF16)
    if set(split) - set(shapes):
        fail(f"the bf16 SST path launched window_mha at (T, C, H) "
             f"{set(split) - set(shapes)}, which phase 16 did not check")
    for key, shape in shapes.items():
        shape["calls_per_frame"] = split.get(key, 0)
        if shape["inputs"] != shape["calls_per_frame"]:
            fail(f"phase 16 timed {shape['inputs']} inputs at (T, C, H) "
                 f"{key}, the bf16 SST path launched "
                 f"{shape['calls_per_frame']} per frame")
    if any(r["scores"].dtype != np.float32 for r in results):
        fail("the bf16 SST path's scores did not come back as float32 "
             "numpy arrays of bf16 values")
    shared = []
    for s, (a, b) in enumerate(zip(f32_results, results)):
        shared.append(_matched_detections(a, b))
        print(f"  frame {s}: the bf16 build has {shared[-1]} of the float32 "
              f"build's {int(a['valid'].sum())} detections (same label, box "
              f"within 2^-3 + 0.25, score within 2^-5; not gated)",
              flush=True)
    builds = {"bf16": model, "f32": f32_model}
    timed = {k: [] for k in builds}
    for r in range(12):
        frame = frames[r % len(frames)]
        for name in (("bf16", "f32") if r % 2 else ("f32", "bf16")):
            m = builds[name]
            timed[name].append(event_ms(lambda: inference_detector(
                m, frame.points[0], m.max_points)))
    rotation = {k: statistics.median(v) for k, v in timed.items()}
    print(f"SST bf16 vs f32 predict latency (median of 12 CUDA-event runs "
          f"each, inference_detector incl. host I/O, alternated): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in rotation.items()),
          flush=True)
    for k, v in timed.items():
        print(f"  {k} runs: {[round(t, 2) for t in v]}", flush=True)
    peaks = {}
    for name, m in builds.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        inference_detector(m, frames[0].points[0], m.max_points)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak memory of one predict (both models resident): "
          f"{ {k: round(v, 3) for k, v in peaks.items()} } GiB", flush=True)
    return {"shapes": list(shapes.values()), "max_abs_err": err,
            "sdpa_max_abs_err": sdpa_err, "launches": launches,
            "split": {f"T={t} C={c} H={h}": n
                      for (t, c, h), n in split.items()}, "latency": lat,
            "latency_rotation": rotation, "runs_rotation": timed,
            "capacity_counters": diags, "shared_with_f32": shared,
            "f32_detections": [int(r["valid"].sum()) for r in f32_results],
            "peak_gib": peaks}


# ---------------------------------------------------------------- phase 17

FSDPP_CONFIG = "configs/fsdpp/fsdpp_waymo_2x.py"
FSDPP_DENSE_CONFIG = "configs/fsdpp/fsdpp_waymo_2x_dense.py"
FSDPP_THR_EXTRA = 0.3  # the detection-mode threshold raise of its steps


def _fsdpp_frames(n_frames: int, device):
    """``bench.py bench_fsdpp``'s frames (seeds 0 .. n_frames - 1) on the
    card: 262,144 points of seven frames and 256 seed boxes each."""
    return [synthetic_temporal_batch(s).to(device) for s in range(n_frames)]


def _fsdpp_set_weights(model, batch, train: bool):
    """Phase 14's vote and fg settings on ``model.fsd_mod`` (weights, not
    the config), taken on the point batch that FSD++ selects from
    ``batch``: votes contracted toward the segmentor voxel centres, in
    train mode the vote channels' norms set to pass them, the fg biases
    shifted to a 0.6 fill of each fg cap (at ``FSDPP_THR_EXTRA`` in train
    mode). Returns (vote norm scales or None, bias shifts)."""
    fsd = model.fsd_mod
    _contract_votes(fsd)
    with torch.no_grad(), _KeptRunningStats(model):
        pb, _ = model.to_point_batch(batch, False)
        scales = _train_vote_norms(fsd, pb) if train else None
        data = fsd.rpn.run_pipeline(pb, train=train)["data"]
        shifts = _shift_fg_biases(fsd.rpn, data,
                                  FSDPP_THR_EXTRA if train else 0.0)
    return scales, shifts


def _fsdpp_counts(model, batch) -> dict:
    """The point selection's counters on one frame (residual current
    points, seed-cropped previous points, kept points, the overflow past
    the residual cap)."""
    diag = {}
    with torch.inference_mode():
        model.to_point_batch(batch, False, diag=diag)
    return {k: int(v) for k, v in diag.items()}


def phase_fsdpp_predict(model, frames, n_convs):
    """Drive FSD++ predict on the frames from zero counts: conv launches
    per frame held to the module's convs, the point selection's counters,
    FSD's fills and outputs per frame (phase 14's checks), latency of
    ``predict`` and of ``predict(skip_rcnn=True)`` (host I/O included:
    the results to numpy), stage times, a trace of 2 predicts, peak
    memory. Returns the phase's record."""
    fsd = model.fsd_mod
    results, per_frame = [], []
    with _FSDProbe(fsd) as probe:
        reset_launch_counts()
        for frame in frames:
            before = dict(scg.launch_counts)
            results.append(frame_to_numpy(model.predict(frame)))
            per_frame.append({k: v - before.get(k, 0)
                              for k, v in scg.launch_counts.items()})
        launches, others = scg.launches, sr.launches + wm.launches
    split = per_frame[0]
    print(f"fsdpp predict: {FSDPP_CONFIG} on {len(frames)} frames; "
          f"sparse_conv_gemm launches {launches}, per frame by (mode, Cin, "
          f"Cout) {split}; other kernels' launches {others}", flush=True)
    if any(f != split for f in per_frame):
        fail(f"fsdpp: conv launches differ between frames: {per_frame}")
    if sum(split.values()) != n_convs:
        fail(f"fsdpp: expected {n_convs} sparse conv launches per frame (one "
             f"per SparseConvLayer), counted {sum(split.values())}")
    if others:
        fail(f"fsdpp: {others} launches of kernels its path does not run")
    selection = []
    for s, (frame, res, rec) in enumerate(zip(frames, results,
                                              probe.frames)):
        selection.append(_fsdpp_counts(model, frame))
        print(f"  frame {s}: point selection {selection[-1]} (of "
              f"{int(frame.valid.sum())} valid points, "
              f"{int((frame.valid & (frame.frame_inds == 0)).sum())} in the "
              f"current frame)", flush=True)
        if not 0 < selection[-1]["num_input_points"] \
                <= model.residual_points_cap:
            fail(f"fsdpp frame {s}: {selection[-1]} points selected")
        _check_fsd_frame(fsd, s, res, rec)

    def numpy_predict(f, **kw):
        return frame_to_numpy(model.predict(f, **kw))

    lat = _latency(numpy_predict, frames, FSD_N_TIMED)
    lat_rpn = _latency(lambda f: numpy_predict(f, skip_rcnn=True), frames,
                       FSD_N_TIMED)
    for name, l in (("predict (two stage)", lat),
                    ("predict(skip_rcnn=True)", lat_rpn)):
        print(f"fsdpp latency, {name} incl. results to numpy: median "
              f"{l['median']:.2f} ms, range {l['min']:.2f}-{l['max']:.2f} "
              f"over {FSD_N_TIMED} CUDA-event runs after warm-up; runs "
              f"{[round(t, 2) for t in l['runs']]}", flush=True)
    stages = [_fsd_stage_ms(model, f) for f in frames[:3]]
    stage_ms = {k: statistics.median(s[k] for s in stages)
                for k in stages[0]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    numpy_predict(frames[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"fsdpp stages, ms (median of 3 frames, CUDA events at module and "
          f"method boundaries, the card synchronised at each): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; peak memory of one predict {peak:.3f} GiB", flush=True)
    return {"launches": launches, "split": split, "latency": lat,
            "latency_skip_rcnn": lat_rpn, "stage_ms": stage_ms,
            "peak_gib": peak, "selection": selection,
            "frames": probe.frames,
            "detections": [int(r["valid"].sum()) for r in results],
            "trace": _fsd_trace(model, frames)}


def phase_fsdpp_dense(frames):
    """configs/fsdpp/fsdpp_waymo_2x_dense.py through the same loader and
    builder (seed-0 weights, phase 14's settings on frame 0): its outputs
    checked as the sparse build's, its predict timed; its path runs no
    hand-written kernel."""
    t0 = time.perf_counter()
    model = init_weights(build_model_from_cfg(load_config(
        FSDPP_DENSE_CONFIG), train=False), torch.Generator().manual_seed(
            0)).eval()
    _, shifts = _fsdpp_set_weights(model, frames[0], train=False)
    print(f"model: {FSDPP_DENSE_CONFIG}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, built "
          f"in {time.perf_counter() - t0:.1f} s; fg bias shifts "
          f"{[round(x, 3) for x in shifts]}", flush=True)
    with _FSDProbe(model.fsd_mod) as probe:
        reset_launch_counts()
        results = [frame_to_numpy(model.predict(f)) for f in frames]
        launches = scg.launches + sr.launches + wm.launches
    if launches:
        fail(f"fsdpp dense: {launches} kernel launches; its path runs none")
    for s, (res, rec) in enumerate(zip(results, probe.frames)):
        _check_fsd_frame(model.fsd_mod, s, res, rec)
    lat = _latency(lambda f: frame_to_numpy(model.predict(f)), frames,
                   FSD_N_TIMED // 2)
    print(f"fsdpp dense latency, predict (two stage) incl. results to "
          f"numpy: median {lat['median']:.2f} ms, range {lat['min']:.2f}-"
          f"{lat['max']:.2f} over {FSD_N_TIMED // 2} runs; runs "
          f"{[round(t, 2) for t in lat['runs']]}", flush=True)
    return {"latency": lat, "frames": probe.frames}


def phase_fsdpp(device):
    """Phase 17, predict: FSD++ at the full width of
    configs/fsdpp/fsdpp_waymo_2x.py (the FSD two stage at half caps behind
    the incremental point selection), built by the port's config loader and
    builder (seed-0 weights, TF32 off); the sparse conv kernel against its
    twin on all 39 convs of frame 0; predict on four ``bench_fsdpp``
    frames; then the dense-BEV config. Returns the phase's record."""
    t0 = time.perf_counter()
    model = init_weights(build_model_from_cfg(load_config(FSDPP_CONFIG),
                                              train=False),
                         torch.Generator().manual_seed(0)).eval()
    n_convs = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    frames = _fsdpp_frames(4, device)
    _, shifts = _fsdpp_set_weights(model, frames[0], train=False)
    print(f"model: {FSDPP_CONFIG} through build_model_from_cfg, f32, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{n_convs} sparse convs, residual cap "
          f"{model.residual_points_cap}, built in "
          f"{time.perf_counter() - t0:.1f} s; votes contracted, fg bias "
          f"shifts {[round(x, 3) for x in shifts]} (a {FSD_FG_FILL} fill of "
          f"each fg cap on frame 0's selected points)", flush=True)

    def drive():
        with torch.inference_mode():
            model.predict(frames[0])

    shapes, per_frame, err, convs = phase_fsd_kernels(
        model, frames[0], device, drive, title=FSDPP_CONFIG)
    if sum(convs.values()) != n_convs:
        fail(f"fsdpp: frame 0 ran {sum(convs.values())} sparse convs, the "
             f"model has {n_convs}")
    rec = phase_fsdpp_predict(model, frames, n_convs)
    if Counter(rec["split"]) != convs:
        fail(f"fsdpp: the convs checked {dict(convs)} are not those "
             f"launched per frame {rec['split']}")
    rec["split"] = {f"{m} {a}->{b}": n for (m, a, b), n in
                    rec["split"].items()}
    del model
    torch.cuda.empty_cache()
    rec["dense"] = phase_fsdpp_dense(frames)
    rec.update(shapes=shapes, per_frame=per_frame, max_abs_err=err)
    return rec


def phase_fsdpp_train(device):
    """Phase 17, training: configs/fsdpp/fsdpp_waymo_2x.py through
    ``build_model_from_cfg(cfg, train=True)`` (seed-0 weights, phase 14's
    vote and fg settings in train mode at ``thr_extra`` 0.3) with the
    config's AdamW: dW and the input gradient against their twins on the
    recorded inputs of all 39 convs of a train step; 2 warm-up, 6 timed and
    3 staged ``train_step`` calls at ``thr_extra`` 0.3, the seed noise and
    the RoI sampler drawing from one seeded generator; forward, recompute,
    input-gradient and dW launches per step held against the modules.
    Returns the phase's record."""
    t0 = time.perf_counter()
    cfg = load_config(FSDPP_CONFIG)
    model = init_weights(build_model_from_cfg(cfg, train=True),
                         torch.Generator().manual_seed(0)).train()
    n_convs = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    frames = _fsdpp_frames(4, device)
    scales, shifts = _fsdpp_set_weights(model, frames[0], train=True)
    kw = dict(thr_extra=FSDPP_THR_EXTRA)
    print(f"model: {FSDPP_CONFIG} through build_model_from_cfg(train=True), "
          f"f32, {n_convs} sparse convs, remat "
          f"{model.fsd_mod.rpn.segmentor_mod.unet_mod.remat}, RoI sampler "
          f"{model.fsd_mod.roi.sampler}, seed noise (centre, size, yaw) "
          f"{(model.center_noise, model.dim_noise, model.yaw_noise)}, built "
          f"in {time.perf_counter() - t0:.1f} s; vote norm scales {scales}, "
          f"fg bias shifts {[round(x, 3) for x in shifts]} (train mode, "
          f"thr_extra {FSDPP_THR_EXTRA})", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)

    def train_forward():
        with torch.no_grad(), _KeptRunningStats(model):
            model.loss(frames[0], train=True, **kw,
                       generator=torch.Generator(device=device).manual_seed(
                           0))

    calls = _record_sparse_convs(model, frames[0], train_forward)
    if len(calls) != n_convs:
        fail(f"fsdpp train: recorded {len(calls)} convs; the model has "
             f"{n_convs}")
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        model, frames[0], device, calls=calls,
        title=f"a train step of {FSDPP_CONFIG} (frame 0, train mode)")
    del calls

    opt = optimizer_from_cfg(model, cfg, FSD_TRAIN_TOTAL_STEPS)
    convs = [m for m in model.modules() if isinstance(m, SparseConvLayer)]
    n_remat = sum(isinstance(m, SparseConvLayer) for u in model.modules()
                  if isinstance(u, SimpleSparseUNet) and u.remat
                  for m in u.modules())
    needs_dgrad = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: None if remat.recomputing()
        else needs_dgrad.append(bool(args[0].requires_grad))) for m in convs]

    def remove_hooks(i):
        if i == 0:
            for h in hooks:
                h.remove()

    def counts():
        return {**scg.kind_counts, "dw": sdw.launches,
                "sorted_reduce": sr.launches, "window_mha": wm.launches}

    n_steps = N_WARMUP + N_TIMED + N_STAGED
    reset_launch_counts()  # the FSD++ train path's run starts here
    with _SamplerProbe() as probe:
        steps, stage_ms, peak = _train_loop(
            model, opt, frames, [dict(kw, generator=gen)] * n_steps, counts,
            remove_hooks)
    expected = {"forward": n_convs, "recompute": n_remat,
                "dgrad": sum(needs_dgrad), "dw": n_convs,
                "sorted_reduce": 0, "window_mha": 0}
    if len(needs_dgrad) != n_convs:
        fail(f"fsdpp train: the hooks saw {len(needs_dgrad)} conv calls in a "
             f"step, the model has {n_convs} convs")
    _check_launches(steps, expected)
    launches = {"sparse_conv_gemm": scg.launches,
                "sparse_conv_dw": sdw.launches}
    print(f"fsdpp train: {FSDPP_CONFIG}, batch 1, AdamW from the config "
          f"({cfg['optimizer']}, a {FSD_TRAIN_TOTAL_STEPS}-step one-cycle), "
          f"thr_extra {FSDPP_THR_EXTRA}; launches per step by kind (counted "
          f"at the launch sites; the modules give {expected}: {n_convs} "
          f"convs, {n_remat} in the rematerialised UNet, the input of "
          f"{sum(needs_dgrad)} needing a gradient): {steps[0]['launches']}; "
          f"in the whole run {launches}", flush=True)
    record = _print_train(steps, stage_ms, peak)
    keys = ("num_input_points", "num_residual_overflow", "num_fg_points",
            "num_clusters", "num_pos_rois", "roi_membership_overflow")
    for name in keys:
        print(f"  {name} per step: "
              f"{[st['metrics'][name] for st in steps]}", flush=True)
    print(f"  sampler, last step (valid proposals, positives, kept "
          f"positives, kept negatives by IoU piece): "
          f"{probe.calls[-1] if probe.calls else 'no sampler'}", flush=True)
    return {**record, "launches": launches, "launches_per_step": expected,
            "counters": {k: [st["metrics"][k] for st in steps]
                         for k in keys},
            "dw_shapes": dw_shapes, "dw_step": dw_step, "dw_err": dw_err,
            "dgrad_err": dgrad_err}


# ---------------------------------------------------------------- phase 18

CTRL_CONFIG = "configs/ctrl/ctrl_veh_24e.py"
CTRL_N_TIMED = 12  # predicts timed after warm-up
CTRL_TRAIN_TOTAL_STEPS = 10000  # the one-cycle of the config's AdamW
WRAPPER_HOST_US = {}  # the wrappers' host time per call, by _binding_host_us


def _binding_host_us(name, call, mod, lib_name):
    """The wrapper's host time per call (Python, checks, ctypes, launch;
    ``_host_ms`` over 50 calls) as it is, its ctypes entry point bound
    once, and with the entry point looked up and its ``argtypes`` and
    ``restype`` set before every call, as the wrapper did before;
    alternated (once, per call, per call, once), the smaller of each pair,
    in microseconds."""
    from sst_tpu_torch.utils.nvcc import load_kernel_library

    fn = mod._kernel()
    symbol, argtypes = fn.__name__, list(fn.argtypes)

    def bound_per_call():
        f = getattr(load_kernel_library(lib_name).lib, symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        call()

    fns = {"bound_once": call, "bound_per_call": bound_per_call}
    runs = {k: [] for k in fns}
    for kind in ("bound_once", "bound_per_call", "bound_per_call",
                 "bound_once"):
        runs[kind].append(_host_ms(fns[kind], n=50) * 1e3)
    rec = {k: min(v) for k, v in runs.items()}
    WRAPPER_HOST_US[name] = rec
    print(f"  {name} wrapper host time per call: {rec['bound_once']:.1f} us "
          f"with its entry point bound once, {rec['bound_per_call']:.1f} us "
          f"with argtypes set on every call (runs "
          f"{ {k: [round(x, 1) for x in v] for k, v in runs.items()} })",
          flush=True)
    return rec


def _ctrl_tracks(seeds, device, noisy_gt=False):
    """``bench.py bench_ctrl``'s tracks, one per seed, stacked into one
    batch on the card: 32,768 points each (x, y, z ``clip(randn * 1.5,
    +-6)``, two channels, the time lag ``frame * 0.1``) over 200 frames,
    tracker boxes of a car near the origin. ``noisy_gt``: the gt candidates
    are the tracker boxes plus N(0, 0.05) noise (seeded ``1000 + seed``),
    as ``flagship.tracklet_batch`` gives them; identical boxes meet XLA's
    coincident-edge IoUs. Otherwise the tracker boxes, as bench_ctrl."""
    rows = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        b, p, f = 1, 32768, 200
        pts = np.clip(rng.randn(b, p, 3).astype(np.float32) * 1.5, -6, 6)
        ts = rng.randint(0, f, (b, p)).astype(np.int32)
        points = np.concatenate(
            [pts, rng.rand(b, p, 2).astype(np.float32),
             ts[..., None].astype(np.float32) * 0.1], -1)
        trk = np.concatenate(
            [rng.uniform(-0.5, 0.5, (b, f, 2)), np.full((b, f, 1), -1.0),
             np.tile([[1.9, 4.5, 1.7]], (b, f, 1))
             * rng.uniform(0.9, 1.1, (b, f, 3)),
             rng.uniform(-0.3, 0.3, (b, f, 1))], -1).astype(np.float32)
        gt = trk
        if noisy_gt:
            gt = trk + np.random.RandomState(1000 + seed).randn(
                b, f, 7).astype(np.float32) * 0.05
        rows.append(dict(
            points=points, valid=np.ones((b, p), bool), frame_inds=ts,
            trk_boxes=trk, trk_scores=rng.rand(b, f).astype(np.float32),
            trk_valid=np.ones((b, f), bool), labels=np.zeros((b,), np.int32),
            gt_boxes=gt, gt_valid=np.ones((b, f), bool)))
    return TrackletBatch(**{k: np.concatenate([r[k] for r in rows])
                            for k in rows[0]}).to(device)


class _PoolProbe:
    """Records each ``roi_head.dynamic_point_pool`` call while active: the
    paired points, the pair slots and the two overflow counters (reads the
    host once per call; launches nothing)."""

    def __enter__(self):
        from sst_tpu_torch.models.fsd import roi_head

        self._mod, self._fn, self.calls = roi_head, \
            roi_head.dynamic_point_pool, []
        fn = self._fn

        def probe(*a, **k):
            out = fn(*a, **k)
            self.calls.append(dict(
                pairs=int(out["valid"].sum()), pair_slots=out["valid"].numel(),
                membership_overflow=int(out["membership_overflow"]),
                inbox_overflow=int(out["inbox_overflow"])))
            return out

        roi_head.dynamic_point_pool = probe
        return self

    def __exit__(self, *exc):
        self._mod.dynamic_point_pool = self._fn


def _ctrl_voxel_fill(model, batch):
    """The segmentor's voxel fill on ``batch``: valid voxels of its cap and
    the valid points that fell past the cap or out of range (a forward
    hook on the VFE reads its voxel mapping)."""
    seen = []
    hook = model.segmentor_mod.vfe_mod.register_forward_pre_hook(
        lambda m, args: seen.append(args[1]))
    try:
        with torch.inference_mode():
            model.predict(batch)
    finally:
        hook.remove()
    vm = seen[0]
    return {"voxels": int(vm.voxel_valid.sum()),
            "voxel_cap": vm.voxel_valid.numel(),
            "points_dropped": int((batch.valid.reshape(-1)
                                   & ~vm.valid).sum())}


def _ctrl_world(root):
    """The world of ``tests/test_tracklet_dataset.py`` under ``root``: one
    moving car track over 6 frames at identity poses, each frame 300 points
    on the car and 700 in a 80 m cube (x, y, z + 3 channels), the gt
    candidates the boxes + 0.05."""
    import pickle

    from sst_tpu_torch.core.tracklet import LiDARTracklet

    rng = np.random.RandomState(0)
    ctx, n_frames = "ctx0", 6
    timestamps = [1000 + 100 * i for i in range(n_frames)]
    centers = np.stack([np.linspace(5, 8, n_frames),
                        np.linspace(2, 2.5, n_frames),
                        np.full(n_frames, -1.0)], 1)
    boxes = np.concatenate(
        [centers, np.tile([[2.0, 4.5, 1.6]], (n_frames, 1)),
         np.zeros((n_frames, 1))], 1).astype(np.float32)
    trk = LiDARTracklet(ctx, "car-1", 1, timestamps, boxes,
                        np.full(n_frames, 0.9, np.float32))
    frame_index = {}
    for i, ts in enumerate(timestamps):
        obj = centers[i] + rng.randn(300, 3) * np.asarray([1.0, 0.5, 0.4])
        obj[:, 2] = np.clip(obj[:, 2], -1.0, 0.6)
        bg = rng.uniform(-40, 40, (700, 3))
        pts = np.concatenate([obj, bg]).astype(np.float32)
        arr = np.concatenate([pts, rng.rand(1000, 3).astype(np.float32)], 1)
        arr.tofile(os.path.join(root, f"frame_{i}.bin"))
        frame_index[(ctx, ts)] = f"frame_{i}.bin"
    for name, obj in (
            ("poses.pkl", {ctx: {ts: np.eye(4) for ts in timestamps}}),
            ("frame_index.pkl", frame_index), ("tracklets.pkl", [trk]),
            ("cands.pkl", [dict(boxes=boxes + 0.05,
                                valid=np.ones(n_frames, bool))])):
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(obj, f)


def _ctrl_data_path(model, device):
    """One track through the ported ``WaymoTrackletDataset`` and
    ``collate_tracklets`` from the world of ``_ctrl_world`` in a temporary
    directory, at the config's caps, onto the card and through
    ``predict``; its launches counted."""
    from sst_tpu_torch.data.tracklet_dataset import (
        WaymoTrackletDataset,
        collate_tracklets,
    )

    cap = load_config(CTRL_CONFIG)["capacity"]
    with tempfile.TemporaryDirectory() as root:
        _ctrl_world(root)
        ds = WaymoTrackletDataset(
            data_root=root, tracklet_path=os.path.join(root, "tracklets.pkl"),
            poses_path=os.path.join(root, "poses.pkl"),
            frame_index_path=os.path.join(root, "frame_index.pkl"),
            candidates_path=os.path.join(root, "cands.pkl"),
            max_points=cap["max_points"], max_frames=cap["max_frames"])
        sample = ds[0]
    batch = collate_tracklets([sample], device)
    reset_launch_counts()
    out = model.predict(batch)
    torch.cuda.synchronize()
    launches = scg.launches
    n_frames = int(batch.trk_valid.sum())
    rec = {"points": int(batch.valid.sum()), "frames": n_frames,
           "refined": int(out["valid"].sum()), "launches": launches}
    print(f"ctrl data path: WaymoTrackletDataset[0] of a 6-frame world "
          f"(one car, 6,000 points) -> collate_tracklets on {device}: "
          f"{rec['points']} cropped points of the {cap['max_points']} cap, "
          f"{n_frames} tracker frames of {cap['max_frames']}; predict "
          f"refined {rec['refined']} frames; sparse_conv_gemm launches "
          f"{launches}", flush=True)
    if n_frames != 6 or rec["points"] < 100:
        fail(f"ctrl data path: {rec}")
    if not all(bool(torch.isfinite(out[k]).all()) for k in ("boxes",
                                                              "scores")):
        fail("ctrl data path: non-finite refined boxes or scores")
    return rec


def phase_ctrl(device):
    """Phase 18: CTRL at the full width of configs/ctrl/ctrl_veh_24e.py,
    through the port's loader and ``build_model_from_cfg`` (f32, seed-0
    weights, nothing cut): the sparse conv kernel against its twin at every
    conv of one ``bench_ctrl`` track; predict on four tracks (launches per
    track held to the module's convs, the pool's counters, latency, peak
    memory); the train step on batches of 2 tracks (dW and the input
    gradient against their twins, 2 + 6 + 3 steps, launches per step held
    against the modules, finite losses, ``mean_roi_iou`` > 0.3); the data
    path. Returns the phase's record."""
    t0 = time.perf_counter()
    cfg = load_config(CTRL_CONFIG)
    model = init_weights(build_model_from_cfg(cfg, train=False),
                         torch.Generator().manual_seed(0)).eval()
    n_convs = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    tracks = [_ctrl_tracks([s], device) for s in range(4)]
    print(f"model: {CTRL_CONFIG} through build_model_from_cfg, f32, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{n_convs} sparse convs, point cap {model.max_points}, built in "
          f"{time.perf_counter() - t0:.1f} s; tracks of bench.py bench_ctrl "
          f"(32,768 points, 200 frames)", flush=True)

    def drive():
        with torch.inference_mode():
            model.predict(tracks[0])

    shapes, per_track, err, convs = phase_fsd_kernels(
        model, tracks[0], device, drive, title=CTRL_CONFIG)
    if sum(convs.values()) != n_convs:
        fail(f"ctrl: track 0 ran {sum(convs.values())} sparse convs, the "
             f"model has {n_convs}")
    calls = _record_sparse_convs(model, tracks[0], drive)
    widest = max(calls, key=lambda c: c[1] * c[3][1] * c[3][2])
    _, vin, cp, _, feats, _ = widest
    w = model.get_submodule(widest[0]).weight.detach()
    sched = cp.schedule(vin)
    binding = _binding_host_us(
        "sparse_conv_gemm", lambda: scg.sparse_conv_gemm(
            feats, cp.nbr, w, cp.mode, schedule=sched), scg,
        "sparse_conv_gemm")
    del calls, widest, feats

    fill = _ctrl_voxel_fill(model, tracks[0])
    results, per = [], []
    with _PoolProbe() as pool:
        reset_launch_counts()
        for trk in tracks:
            before = dict(scg.launch_counts)
            res = model.predict(trk)
            results.append({k: v.cpu().numpy() for k, v in res.items()})
            per.append({k: v - before.get(k, 0)
                        for k, v in scg.launch_counts.items()})
        launches, others = scg.launches, sr.launches + sdw.launches \
            + wm.launches
    split = per[0]
    print(f"ctrl predict: {len(tracks)} tracks; sparse_conv_gemm launches "
          f"{launches}, per track by (mode, Cin, Cout) {split}; other "
          f"kernels' launches {others}; voxels {fill['voxels']} of "
          f"{fill['voxel_cap']}, {fill['points_dropped']} valid points past "
          f"the voxel cap", flush=True)
    if any(p != split for p in per) or sum(split.values()) != n_convs:
        fail(f"ctrl: expected {n_convs} conv launches per track, counted "
             f"{per}")
    if Counter(split) != convs:
        fail(f"ctrl: the convs checked {dict(convs)} are not those launched "
             f"per track {split}")
    if others:
        fail(f"ctrl: {others} launches of kernels its path does not run")
    for s, (res, pc) in enumerate(zip(results, pool.calls)):
        print(f"  track {s}: {int(res['valid'].sum())} of 200 frames refined "
              f"(non-empty rois); paired points {pc['pairs']} of "
              f"{pc['pair_slots']}; membership_overflow "
              f"{pc['membership_overflow']}, inbox_overflow "
              f"{pc['inbox_overflow']}; mean score "
              f"{float(res['scores'].mean()):.4f}", flush=True)
        if res["boxes"].shape != (1, 200, 7) or not all(
                np.isfinite(res[k]).all() for k in ("boxes", "scores")):
            fail(f"ctrl track {s}: boxes {res['boxes'].shape} or non-finite "
                 f"outputs")
        if pc["pairs"] == 0:
            fail(f"ctrl track {s}: no point paired with a roi")

    lat = _latency(lambda t: {k: v.cpu() for k, v in
                              model.predict(t).items()},
                   tracks, CTRL_N_TIMED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.predict(tracks[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"ctrl latency, predict of one track incl. results to the host: "
          f"median {lat['median']:.2f} ms ({1e3 / lat['median']:.2f} tracks "
          f"per s), range {lat['min']:.2f}-{lat['max']:.2f} over "
          f"{CTRL_N_TIMED} CUDA-event runs after warm-up; runs "
          f"{[round(t, 2) for t in lat['runs']]}; peak memory of one "
          f"predict {peak:.3f} GiB", flush=True)
    data_path = _ctrl_data_path(model, device)
    del tracks
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- training
    batches = [_ctrl_tracks([2 * k, 2 * k + 1], device, noisy_gt=True)
               for k in range(2)]  # samples_per_device = 2
    model.train()

    def train_forward():
        with torch.no_grad(), _KeptRunningStats(model):
            model.loss(batches[0], train=True)

    calls = _record_sparse_convs(model, batches[0], train_forward)
    if len(calls) != n_convs:
        fail(f"ctrl train: recorded {len(calls)} convs; the model has "
             f"{n_convs}")
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        model, batches[0], device, calls=calls,
        title=f"a train step of {CTRL_CONFIG} (2 tracks, train mode)")
    del calls
    opt = optimizer_from_cfg(model, cfg, CTRL_TRAIN_TOTAL_STEPS)
    convs_m = [m for m in model.modules() if isinstance(m, SparseConvLayer)]
    needs_dgrad = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: needs_dgrad.append(bool(args[0].requires_grad)))
        for m in convs_m]

    def remove_hooks(i):
        if i == 0:
            for h in hooks:
                h.remove()

    def counts():
        return {**scg.kind_counts, "dw": sdw.launches,
                "sorted_reduce": sr.launches, "window_mha": wm.launches}

    n_steps = N_WARMUP + N_TIMED + N_STAGED
    with _PoolProbe() as pool:
        reset_launch_counts()  # the CTRL train path's run starts here
        steps, stage_ms, peak_train = _train_loop(
            model, opt, batches, [{}] * n_steps, counts, remove_hooks)
    expected = {"forward": n_convs, "recompute": 0,
                "dgrad": sum(needs_dgrad), "dw": n_convs,
                "sorted_reduce": 0, "window_mha": 0}
    if len(needs_dgrad) != n_convs:
        fail(f"ctrl train: the hooks saw {len(needs_dgrad)} conv calls in a "
             f"step, the model has {n_convs} convs")
    _check_launches(steps, expected)
    train_launches = {"sparse_conv_gemm": scg.launches,
                      "sparse_conv_dw": sdw.launches}
    print(f"ctrl train: {CTRL_CONFIG}, 2 tracks per step (65,536 points, 400 "
          f"rois), AdamW from the config ({cfg['optimizer']}, a "
          f"{CTRL_TRAIN_TOTAL_STEPS}-step one-cycle); launches per step by "
          f"kind (counted at the launch sites; the modules give {expected}): "
          f"{steps[0]['launches']}; in the whole run {train_launches}",
          flush=True)
    record = _print_train(steps, stage_ms, peak_train)
    ious = [st["metrics"]["mean_roi_iou"] for st in steps]
    overflow = [st["metrics"]["roi_membership_overflow"] for st in steps]
    print(f"  mean_roi_iou per step {[round(x, 4) for x in ious]}; "
          f"roi_membership_overflow per step {overflow}; pool per step "
          f"(pairs of slots) {[(c['pairs'], c['pair_slots']) for c in pool.calls[:2]]}",
          flush=True)
    if min(ious) <= 0.3:
        fail(f"ctrl train: mean_roi_iou {min(ious):.4f} <= 0.3 on rois "
             f"within N(0, 0.05) of their gt")
    del model, batches, opt
    torch.cuda.empty_cache()
    return {"launches": launches, "split": {
        f"{m} {a}->{b}": n for (m, a, b), n in split.items()},
        "latency": lat, "peak_gib": peak, "voxel_fill": fill,
        "pool": pool.calls[:2], "shapes": shapes, "per_track": per_track,
        "max_abs_err": err, "binding_host_us": binding,
        "data_path": data_path,
        "train": {**record, "launches": train_launches,
                  "launches_per_step": expected, "mean_roi_iou": ious,
                  "roi_membership_overflow": overflow,
                  "dw_shapes": dw_shapes, "dw_step": dw_step,
                  "dw_err": dw_err, "dgrad_err": dgrad_err}}


# ---------------------------------------------------------------- phase 19

FSDV2_CONFIG = "configs/fsdv2/fsdv2_waymo_1x.py"


def _fsdv2_two_stage_cfg() -> dict:
    """``dict(type="FSDV2", single_stage=<the config's model without its
    type>)`` (the RoI head and ``rois_per_sample`` at the class defaults),
    the config's capacity; the segmentor's VFE on the sorted reduce, as the
    port's FSDv2 builders set it (a declared difference: JAX leaves it
    off)."""
    cfg = load_config(FSDV2_CONFIG)
    ss = dict(cfg["model"])
    ss.pop("type")
    ss["segmentor"] = dict(ss["segmentor"], vfe=dict(
        ss["segmentor"]["vfe"], use_sorted_reduce=True))
    return {"model": dict(type="FSDV2", single_stage=ss),
            "capacity": cfg["capacity"], "optimizer": cfg["optimizer"]}


def phase_fsdv2_two_stage(device):
    """Phase 19: the FSDV2 two stage over the full-width single stage of
    configs/fsdv2/fsdv2_waymo_1x.py through ``build_model_from_cfg`` (f32,
    seed-0 weights, the seg head's class biases shifted to a 0.6 fill of
    each fg cap on frame 0): the sparse conv kernel against its twin at
    every conv of frame 0; refined and ``skip_rcnn`` predict on two of
    phase 7's frames, conv and sorted-reduce launches per frame held to the
    modules, timed; one loss and backward on a labelled frame (dW and the
    input gradient against their twins at its convs, finite losses,
    launches counted). Returns the phase's record."""
    t0 = time.perf_counter()
    model = init_weights(build_model_from_cfg(_fsdv2_two_stage_cfg(),
                                              train=False),
                         torch.Generator().manual_seed(0)).eval()
    rpn = model.rpn
    n_convs = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    frames = [prepare_batch(model, f.points[0], model.max_points)
              for f in _frames(2)]
    with torch.inference_mode():
        data = rpn.run_pipeline(frames[0])["data"]
    shifts = _shift_fg_biases(rpn, data)
    del data
    print(f"model: FSDV2 over the single stage of {FSDV2_CONFIG} through "
          f"build_model_from_cfg, f32, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{n_convs} sparse convs, rois_per_sample {model.rois_per_sample}, "
          f"built in {time.perf_counter() - t0:.1f} s; fg bias shifts "
          f"{[round(x, 3) for x in shifts]}", flush=True)

    def drive():
        with torch.inference_mode():
            model.predict(frames[0])

    shapes, per_frame, err, convs = phase_fsd_kernels(
        model, frames[0], device, drive, title=f"FSDV2 over {FSDV2_CONFIG}")
    if sum(convs.values()) != n_convs:
        fail(f"fsdv2 two stage: frame 0 ran {sum(convs.values())} sparse "
             f"convs, the model has {n_convs}")
    results, per = {}, []
    with _PoolProbe() as pool:
        reset_launch_counts()
        for skip in (False, True):
            for frame in frames:
                before = (scg.launches, sr.launches, sr.offsets_launches)
                res = frame_to_numpy(model.predict(frame, skip_rcnn=skip))
                results.setdefault(skip, []).append(res)
                per.append((scg.launches - before[0],
                            sr.launches - before[1],
                            sr.offsets_launches - before[2]))
        launches = {"sparse_conv_gemm": scg.launches,
                    "sorted_reduce": (sr.launches, sr.offsets_launches),
                    "others": sdw.launches + wm.launches}
    print(f"fsdv2 two stage predict: {len(frames)} frames, refined then "
          f"skip_rcnn; launches per frame (conv, sorted reduce, offsets) "
          f"{per}; in the run {launches}", flush=True)
    if any(p != (n_convs, 3, 1) for p in per) or launches["others"]:
        fail(f"fsdv2 two stage: expected {n_convs} conv, 3 sorted reduce "
             f"and 1 offsets launches per frame and no other kernel, "
             f"counted {per}, {launches}")
    max_num = rpn.test_cfg["max_num"]
    rows = {False: min(max_num, model.rois_per_sample), True: max_num}
    for skip, outs in results.items():
        for s, res in enumerate(outs):
            if res["boxes"].shape != (rows[skip], 7) or not all(
                    np.isfinite(res[k]).all() for k in ("boxes", "scores")):
                fail(f"fsdv2 two stage frame {s} (skip_rcnn {skip}): boxes "
                     f"{res['boxes'].shape} or non-finite outputs")
            print(f"  frame {s}, skip_rcnn {skip}: "
                  f"{int(res['valid'].sum())} detections of {rows[skip]}",
                  flush=True)
    for s, pc in enumerate(pool.calls):
        print(f"  frame {s} RoI pool: paired points {pc['pairs']} of "
              f"{pc['pair_slots']}, membership_overflow "
              f"{pc['membership_overflow']}, inbox_overflow "
              f"{pc['inbox_overflow']}", flush=True)
    if any(c["pairs"] == 0 for c in pool.calls):
        fail("fsdv2 two stage: a RoI pool paired no point")

    def numpy_predict(f, **kw):
        return frame_to_numpy(model.predict(f, **kw))

    lat = _latency(numpy_predict, frames, 6)
    lat_rpn = _latency(lambda f: numpy_predict(f, skip_rcnn=True), frames, 6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    numpy_predict(frames[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, l in (("predict (two stage)", lat),
                    ("predict(skip_rcnn=True)", lat_rpn)):
        print(f"fsdv2 two stage latency, {name} incl. results to numpy: "
              f"median {l['median']:.2f} ms, range {l['min']:.2f}-"
              f"{l['max']:.2f} over 6 runs; runs "
              f"{[round(t, 2) for t in l['runs']]}", flush=True)
    print(f"  peak memory of one predict {peak:.3f} GiB", flush=True)
    del frames
    torch.cuda.empty_cache()

    # ------------------------------------------------- one loss + backward
    model.train()
    batch = _labeled_frames(1)[0].to(device)

    def train_forward():
        with torch.no_grad(), _KeptRunningStats(model):
            model.loss(batch, train=True)

    calls = _record_sparse_convs(model, batch, train_forward)
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        model, batch, device, calls=calls,
        title=f"a loss of FSDV2 over {FSDV2_CONFIG} (labelled frame 0)")
    del calls
    reset_launch_counts()
    ev = [_event() for _ in range(3)]
    ev[0].record()
    out = model.loss(batch, train=True)
    total = sum(v for k, v in out.items() if k.startswith("loss"))
    ev[1].record()
    total.backward()
    ev[2].record()
    ev[2].synchronize()
    loss_launches = {**scg.kind_counts, "dw": sdw.launches,
                     "sorted_reduce": sr.launches,
                     "segment_offsets": sr.offsets_launches}
    losses = _losses({k: v.detach() for k, v in out.items()})
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in model.parameters() if p.grad is not None)
    print(f"fsdv2 two stage loss: {ev[0].elapsed_time(ev[1]):.2f} ms, "
          f"backward {ev[1].elapsed_time(ev[2]):.2f} ms; launches "
          f"{loss_launches}; losses {losses}; gradients finite "
          f"{grads_finite}", flush=True)
    bad = [k for k, v in losses.items() if not np.isfinite(v)]
    if bad or not grads_finite:
        fail(f"fsdv2 two stage loss: non-finite {bad} or gradients")
    if loss_launches.get("forward") != n_convs or \
            loss_launches["dw"] != n_convs or \
            loss_launches["sorted_reduce"] != 3:
        fail(f"fsdv2 two stage loss: launches {loss_launches}, expected "
             f"{n_convs} forward and dW, 3 sorted reduce")
    del model, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "per_frame_launches": per[0],
            "latency": lat, "latency_skip_rcnn": lat_rpn, "peak_gib": peak,
            "pool": pool.calls, "shapes": shapes, "per_frame": per_frame,
            "max_abs_err": err, "loss": losses,
            "loss_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "loss_launches": loss_launches, "dw_shapes": dw_shapes,
            "dw_step": dw_step, "dw_err": dw_err, "dgrad_err": dgrad_err}


# ---------------------------------------------------------------- phase 20

CLI_TRAIN_CONFIG = "configs/fsdv2/fsdv2_waymo_1x.py"
# the flagship build's remat (sst_tpu/flagship.py fsdv2_waymo, phase 11);
# the config leaves it off, as JAX's does
CLI_TRAIN_OPTIONS = ("model.segmentor.unet.remat=True", "model.mixer.remat=True")
CLI_SST_CONFIG = "configs/sst/sst_waymoD5_3class_bf16.py"
CLI_TRAIN_STEPS, CLI_EVAL_FRAMES = 4, 2


def _cli_counts() -> dict:
    return {**scg.kind_counts, "dw": sdw.launches, "window_mha": wm.launches,
            "sorted_reduce": sr.launches}


def _cli_run(main, argv, title):
    """``main(argv)`` with every launch count set to 0 just before it;
    returns (its summary, the launches it made, seconds)."""
    print(f"cli: {title}: {' '.join(argv)}", flush=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = main(list(argv))
    torch.cuda.synchronize()
    return out, _cli_counts(), time.perf_counter() - t0


def _same_state_bits(a, b, path="") -> list:
    """Paths where two (nested) states differ: tensors by dtype, shape and
    bits, everything else by value."""
    if isinstance(a, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            return [path + "/keys"]
        return [d for k in a for d in _same_state_bits(a[k], b[k],
                                                       f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _same_state_bits(x, y, f"{path}/{i}")] + (
            [path + "/len"] if len(a) != len(b) else [])
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            return [path]
        if a.is_floating_point():
            bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[
                a.element_size()]
            a, b = a.reshape(-1).view(bits), b.reshape(-1).view(bits)
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def _expect(what: str, got: dict, want: dict) -> None:
    have = {k: got.get(k, 0) for k in want}
    if have != want:
        fail(f"cli: {what}: launches {have}, expected {want} from the "
             f"modules")


CLI_NUSC_FRAMES, CLI_NUSC_STEPS = 4, 3


def _cli_nusc_argo(device, work, train_cli, test_cli):
    """Phase 20's nuScenes and Argo2 runs: ``tools.train.main`` on
    configs/fsdv2/fsdv2_nusc_1x.py with ``data.dataset="nuscenes"``,
    ``cbgs=True`` and a multi-sweep pipeline with ``ObjectSample`` (a
    config file in ``work`` that inherits it) over a nuScenes-format set
    written there (4 keyframes, 9 sweeps each, a gt database): 3 steps, a
    checkpoint at 2, a resume from it to step 3; ``tools.test.main`` on
    the checkpoint with the dataset's evaluation (NDS), and on
    configs/fsdv2/fsdv2_argo_2x.py (seed-0 weights) over an Argo2-format
    set with its CDS. Each run's launches, counted from 0, are held
    against the modules. Returns the runs' record."""
    from sst_tpu_torch.data import format_writers as fw

    nusc_root = os.path.join(work, "nuscenes")
    argo_root = os.path.join(work, "argo2")
    os.makedirs(nusc_root)
    os.makedirs(argo_root)
    info = fw.write_nuscenes_set(nusc_root, seed=20, frames=CLI_NUSC_FRAMES,
                                 points=NUSC_SWEEP_POINTS, sweeps=NUSC_SWEEPS,
                                 boxes=30, half=54.0)
    db = fw.write_gt_database(nusc_root, fw.NUSC_CLASSES, seed=20,
                              per_class=6, points=200)
    argo_info = fw.write_argo2_set(argo_root, seed=23, frames=2,
                                   points=ARGO_POINTS, boxes=60, half=100.0)
    nusc_cfg = load_config(NUSC_CONFIG)
    pcr = nusc_cfg["model"]["point_cloud_range"]
    cap = nusc_cfg["capacity"]["max_points"]
    pipeline = [
        dict(type="LoadPointsFromMultiSweeps", sweeps_num=NUSC_SWEEPS,
             load_dim=5, use_dim=(0, 1, 2, 3)),
        dict(type="ObjectSample", db_sampler=dict(
            info_path=db, data_root=nusc_root, rate=1.0,
            sample_groups={n: 2 for n in fw.NUSC_CLASSES},
            classes=fw.NUSC_CLASSES,
            points_loader=dict(load_dim=5, use_dim=(0, 1, 2, 3, 4)))),
        dict(type="RandomFlip3D"),
        dict(type="GlobalRotScaleTrans"),
        dict(type="PointsRangeFilter", point_cloud_range=pcr),
        dict(type="ObjectRangeFilter", point_cloud_range=pcr),
        dict(type="PointShuffle"),
        dict(type="PadToCap", max_points=cap)]
    cfg_path = os.path.join(work, "nusc_cli.py")
    with open(cfg_path, "w") as f:
        f.write(f"_base_ = [{os.path.abspath(NUSC_CONFIG)!r}]\n"
                f"data = dict(dataset='nuscenes', data_root={nusc_root!r}, "
                f"info_path={info!r}, val_info_path={info!r}, cbgs=True, "
                f"use_dim=(0, 1, 2, 3), train_pipeline={pipeline!r})\n")
    argo_path = os.path.join(work, "argo_cli.py")
    with open(argo_path, "w") as f:
        f.write(f"_base_ = [{os.path.abspath(ARGO_FSDV2_CONFIG)!r}]\n"
                f"data = dict(dataset='argo2', data_root={argo_root!r}, "
                f"info_path={argo_info!r}, val_info_path={argo_info!r})\n")
    model = build_model_from_cfg(load_config(cfg_path), train=True,
                                 device="cpu")
    n = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    batch = load_config(cfg_path)["data"]["samples_per_device"]
    del model
    per_step = {"forward": n, "recompute": 0, "dgrad": n, "dw": n,
                "sorted_reduce": 0}
    nwork = os.path.join(work, "nusc_wd")
    common = [cfg_path, "--device", str(device), "--work-dir", nwork,
              "--log-interval", "1", "--ckpt-interval", "2"]
    torch.cuda.reset_peak_memory_stats()
    train, train_launches, train_s = _cli_run(
        train_cli.main, common + ["--max-steps", str(CLI_NUSC_STEPS)],
        "train, nuScenes (CBGS, 10 sweeps, ObjectSample)")
    peak = torch.cuda.max_memory_allocated()
    _expect("train nuscenes", train_launches,
            {k: v * CLI_NUSC_STEPS for k, v in per_step.items()})
    resume, resume_launches, resume_s = _cli_run(
        train_cli.main, common + ["--max-steps", str(CLI_NUSC_STEPS),
                                  "--resume-from",
                                  os.path.join(nwork, "ckpt_2")],
        "resume, nuScenes")
    _expect("resume nuscenes", resume_launches,
            {k: v * (CLI_NUSC_STEPS - 2) for k, v in per_step.items()})
    losses = train["loss_total"] + resume["loss_total"]
    if not all(np.isfinite(losses)) or resume["start_step"] != 2:
        fail(f"cli nuscenes: losses {losses}, resumed at "
             f"{resume['start_step']}")
    ckpt = os.path.join(nwork, f"ckpt_{CLI_NUSC_STEPS}")
    nds, nds_launches, nds_s = _cli_run(
        test_cli.main, [cfg_path, ckpt, "--device", str(device), "--eval",
                        "dataset"], "test, nuScenes NDS")
    _expect("test nuscenes", nds_launches,
            {"forward": CLI_NUSC_FRAMES * n, "dw": 0, "sorted_reduce": 0})
    argo = build_model_from_cfg(load_config(argo_path), train=False,
                                device="cpu")
    n_argo = sum(isinstance(m, SparseConvLayer) for m in argo.modules())
    del argo
    cds, cds_launches, cds_s = _cli_run(
        test_cli.main, [argo_path, "--device", str(device), "--eval",
                        "dataset"], "test, Argo2 CDS")
    _expect("test argo2", cds_launches,
            {"forward": 2 * n_argo, "dw": 0, "sorted_reduce": 0})
    if not (np.isfinite(nds["NDS"]) and np.isfinite(cds["CDS"])):
        fail(f"cli: NDS {nds.get('NDS')} or CDS {cds.get('CDS')}")
    rec = {"nusc_train_step_ms": train["step_ms"],
           "nusc_resume_step_ms": resume["step_ms"],
           "nusc_loader_wait_ms": train["loader_wait_ms"]
           + resume["loader_wait_ms"],
           "nusc_batch": batch, "nusc_peak_memory_bytes": peak,
           "nusc_losses": losses, "nusc_launches_per_step": per_step,
           "nds": {k: v for k, v in nds.items() if k in (
               "NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "frames",
               "detections")},
           "cds": {k: v for k, v in cds.items() if k in (
               "CDS", "mAP", "frames", "detections")},
           "seconds": {"nusc_train": train_s, "nusc_resume": resume_s,
                       "nusc_test": nds_s, "argo_test": cds_s},
           "launches": {"nusc_train": train_launches,
                        "nusc_resume": resume_launches,
                        "nusc_test": nds_launches,
                        "argo_test": cds_launches}}
    print(f"cli: nuScenes train CLI (CBGS over {CLI_NUSC_FRAMES} keyframes, "
          f"{NUSC_SWEEPS} sweeps, ObjectSample), batch {batch}, "
          f"{CLI_NUSC_STEPS} + 1 steps: step ms (device synchronised at "
          f"each step's end) {[round(t, 2) for t in rec['nusc_train_step_ms']]}"
          f" + resume {[round(t, 2) for t in resume['step_ms']]}; loader "
          f"wait per step {[round(w, 1) for w in rec['nusc_loader_wait_ms']]}"
          f" ms; peak memory {peak / 2**30:.3f} GiB; losses "
          f"{[round(x, 4) for x in losses]}; launches per step {per_step}; "
          f"test CLI: {rec['nds']}, Argo2 {rec['cds']}; seconds "
          f"{({k: round(v, 1) for k, v in rec['seconds'].items()})}",
          flush=True)
    return rec


def phase_cli(device):
    """Phase 20: the port's train and test CLIs in process, at full width:
    ``tools.train.main`` on configs/fsdv2/fsdv2_waymo_1x.py --synthetic
    (remat on through --cfg-options, as the flagship build): 4 steps, a
    checkpoint at 2, in-train eval at 4 over 2 synthetic frames; a resume
    from ckpt_2 to step 4; ckpt_4 restored on the card equal to the saved
    one bit for bit; ``tools.test.main`` on ckpt_4 with --eval waymo, on
    configs/sst/sst_waymoD5_3class_bf16.py --eval ap3d (seed-0 weights)
    and on configs/fsd/fsd_waymoD1_1x.py --eval seg. Each run's launches,
    counted from 0, are held against the modules. Returns the phase's
    record."""
    from sst_tpu_torch.tools import test as test_cli
    from sst_tpu_torch.tools import train as train_cli
    from sst_tpu_torch.train.checkpoint import (
        load_checkpoint,
        read_checkpoint,
        save_checkpoint,
    )
    from sst_tpu_torch.tools.train import apply_cfg_options

    t_phase = time.perf_counter()
    cfg = apply_cfg_options(load_config(CLI_TRAIN_CONFIG), CLI_TRAIN_OPTIONS)
    model = build_model_from_cfg(cfg, train=True, device=device)
    convs = [m for m in model.modules() if isinstance(m, SparseConvLayer)]
    n_remat = sum(isinstance(m, SparseConvLayer) for u in model.modules()
                  if isinstance(u, SimpleSparseUNet) and u.remat
                  for m in u.modules())
    n = len(convs)
    # the config's VFEs leave the sorted reduce off, as JAX's do
    per_step = {"forward": n, "recompute": n_remat, "dgrad": n, "dw": n,
                "sorted_reduce": 0}
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    common = [CLI_TRAIN_CONFIG, "--synthetic", "--device", str(device),
              "--work-dir", work,
              "--log-interval", "1", "--ckpt-interval", "2",
              "--eval-interval", str(CLI_TRAIN_STEPS), "--eval-samples",
              str(CLI_EVAL_FRAMES), "--cfg-options", *CLI_TRAIN_OPTIONS]
    torch.cuda.reset_peak_memory_stats()
    train, train_launches, train_s = _cli_run(
        train_cli.main, common + ["--max-steps", str(CLI_TRAIN_STEPS)],
        "train")
    peak = torch.cuda.max_memory_allocated()
    eval_forward = CLI_EVAL_FRAMES * n
    _expect("train", train_launches, {
        k: v * CLI_TRAIN_STEPS + (eval_forward if k == "forward" else 0)
        for k, v in per_step.items()})
    ckpt2 = os.path.join(work, "ckpt_2")
    resume, resume_launches, resume_s = _cli_run(
        train_cli.main, common + ["--max-steps", str(CLI_TRAIN_STEPS),
                                  "--resume-from", ckpt2], "resume")
    n_resumed = CLI_TRAIN_STEPS - 2
    _expect("resume", resume_launches, {
        k: v * n_resumed + (eval_forward if k == "forward" else 0)
        for k, v in per_step.items()})
    losses = train["loss_total"] + resume["loss_total"]
    if not all(np.isfinite(losses)) or resume["start_step"] != 2 \
            or len(losses) != CLI_TRAIN_STEPS + n_resumed:
        fail(f"cli: losses {losses}, resumed at {resume['start_step']}")
    evals = train["eval"] + resume["eval"]
    if len(evals) != 2 or not all(np.isfinite(v) for e in evals
                                  for v in e.values()):
        fail(f"cli: in-train evals {evals}")

    # ckpt_4 restored on the card against the file, bit for bit, and a
    # second save of the restored state read back the same
    ckpt4 = os.path.join(work, f"ckpt_{CLI_TRAIN_STEPS}")
    raw = read_checkpoint(ckpt4)
    opt = optimizer_from_cfg(model, cfg, CLI_TRAIN_STEPS)
    step = load_checkpoint(ckpt4, model, opt)
    restored = {"model": model.state_dict(), "step": step,
                "optimizer": {"adamw": opt.adamw.state_dict(),
                              "count": opt.count}}
    diff = _same_state_bits(restored, raw)
    again = read_checkpoint(save_checkpoint(os.path.join(work, "again"),
                                            model, opt, step))
    diff += _same_state_bits(again, raw)
    n_tensors = len(raw["model"]) + sum(
        len(v) for v in raw["optimizer"]["adamw"]["state"].values())
    if diff or step != CLI_TRAIN_STEPS or opt.count != CLI_TRAIN_STEPS:
        fail(f"cli: ckpt_4 restored on the card differs from the saved one "
             f"at {diff[:8]} (step {step}, count {opt.count})")
    del model, opt, restored, again, raw
    torch.cuda.empty_cache()

    test_waymo, waymo_launches, waymo_s = _cli_run(
        test_cli.main, [CLI_TRAIN_CONFIG, ckpt4, "--synthetic", "--device",
                        str(device), "--num-samples", str(CLI_EVAL_FRAMES),
                        "--eval", "waymo"], "test, FSDv2 ckpt_4")
    _expect("test waymo", waymo_launches, {"forward": eval_forward,
                                           "dw": 0, "sorted_reduce": 0})
    sst_cfg = load_config(CLI_SST_CONFIG)
    sst = build_model_from_cfg(sst_cfg, train=False, device="cpu")
    # each window attention runs once per bucket
    mha_per_frame = len(sst.buckets) * sum(
        isinstance(m, WindowAttention) for m in sst.modules())
    del sst
    test_sst, sst_launches, sst_s = _cli_run(
        test_cli.main, [CLI_SST_CONFIG, "--synthetic", "--device",
                        str(device), "--num-samples", str(CLI_EVAL_FRAMES),
                        "--eval", "ap3d"],
        "test, SST bf16")
    _expect("test ap3d", sst_launches,
            {"window_mha": CLI_EVAL_FRAMES * mha_per_frame,
             "sorted_reduce": 0})
    fsd = build_model_from_cfg(load_config(FSD_CONFIG), train=False,
                               device="cpu")
    n_seg = sum(isinstance(m, SparseConvLayer)
                for m in fsd.rpn.segmentor_mod.modules())
    del fsd
    test_seg, seg_launches, seg_s = _cli_run(
        test_cli.main, [FSD_CONFIG, "--synthetic", "--device", str(device),
                        "--num-samples", str(CLI_EVAL_FRAMES), "--eval",
                        "seg"],
        "test, FSD seg")
    _expect("test seg", seg_launches, {"forward": CLI_EVAL_FRAMES * n_seg,
                                       "sorted_reduce": 0})
    if not np.isfinite(test_seg["acc"]) or \
            not np.isfinite(test_sst["AP_3d"]["mAP"]) or \
            not np.isfinite(test_waymo["Overall/L2 mAP"]):
        fail(f"cli: test metrics {test_seg} {test_sst} {test_waymo}")
    groups = _cli_nusc_argo(device, work, train_cli, test_cli)
    shutil.rmtree(work, ignore_errors=True)

    steps_ms = train["step_ms"] + resume["step_ms"]
    waits = train["loader_wait_ms"] + resume["loader_wait_ms"]
    timed = train["step_ms"][1:]
    record = {
        "train_step_ms_median": statistics.median(timed),
        "train_step_ms_runs": timed, "train_warmup_step_ms": steps_ms[0],
        "resume_step_ms": resume["step_ms"],
        "loader_wait_ms_per_step": waits,
        "loader_wait_ms_median": statistics.median(waits),
        "peak_memory_bytes": peak, "losses": losses, "evals": evals,
        "launches_per_step": per_step,
        "launches": {"train": train_launches, "resume": resume_launches,
                     "test_waymo": waymo_launches,
                     "test_sst_bf16": sst_launches,
                     "test_seg": seg_launches},
        "checkpoint_tensors_compared": n_tensors,
        "seconds": {"train": train_s, "resume": resume_s,
                    "test_waymo": waymo_s, "test_sst_bf16": sst_s,
                    "test_seg": seg_s,
                    "phase": time.perf_counter() - t_phase},
        "test_waymo_overall": {k: v for k, v in test_waymo.items()
                               if k.startswith("Overall")},
        "test_sst_ap3d": test_sst["AP_3d"], "test_seg": test_seg,
        "nusc_argo": groups}
    record["launches"].update(groups.pop("launches"))
    print(f"cli: {CLI_TRAIN_CONFIG} train CLI, batch 1 (samples_per_device), "
          f"{CLI_TRAIN_STEPS} + {n_resumed} steps: step ms (device "
          f"synchronised at each step's end, after 1 warm-up) median "
          f"{record['train_step_ms_median']:.2f}, runs "
          f"{[round(t, 2) for t in timed]}, warm-up {steps_ms[0]:.2f}; "
          f"loader wait per step (host ms blocked on the queue) "
          f"{[round(w, 3) for w in waits]}; peak memory "
          f"{peak / 2**30:.3f} GiB; launches per step {per_step} (train run "
          f"{train_launches}, resume {resume_launches}); losses "
          f"{[round(x, 4) for x in losses]}; ckpt_4 restored bit for bit "
          f"({n_tensors} tensors); test CLI launches: waymo "
          f"{waymo_launches}, SST bf16 {sst_launches}, seg {seg_launches}; "
          f"seconds {({k: round(v, 1) for k, v in record['seconds'].items()})}",
          flush=True)
    return record


# ---------------------------------------------------------------- phase 21

NUSC_CONFIG = "configs/fsdv2/fsdv2_nusc_1x.py"
ARGO_FSDV2_CONFIG = "configs/fsdv2/fsdv2_argo_2x.py"
ARGO_FSD_CONFIG = "configs/argo2/argo_onestage_12e.py"
FSD_3F_CONFIG = "configs/fsd/fsd_waymoD1_1x_3f.py"
NUSC_SWEEPS, NUSC_SWEEP_POINTS = 9, 34000  # a keyframe and 9 past sweeps
ARGO_POINTS = 131072  # the Argo2 configs' point cap
GROUP_N_FRAMES = 2
GROUP_N_TIMED = 4


def _shift_group_biases(ss, data):
    """Group sampling's counterpart of ``_shift_fg_biases``: shift the seg
    head's class biases (weights, not the config) so that on ``data`` (a
    pipeline's points) the top ``FSD_FG_FILL`` of each group's fg cap
    scores above the group's threshold. A shift d on every member logit
    multiplies the group's odds (its softmax sum against the rest) by
    exp(d), so each round sets the cut of each group in turn, and five
    rounds settle the groups' shared denominator. Returns the shifts."""
    logits = data["seg_logits"][data["valid"]].double()
    shift = torch.zeros(logits.shape[1], dtype=torch.float64,
                        device=logits.device)
    groups = [[ss.class_names.index(n) for n in g] for g in ss.group_names]
    for _ in range(5):
        for g, ids in enumerate(groups):
            p = torch.softmax(logits + shift, -1)[:, ids].sum(-1)
            p = torch.sort(p, descending=True).values.clamp(1e-12, 1 - 1e-12)
            n = int(FSD_FG_FILL * ss.caps.fg_per_class[g])
            if p.numel() <= n:
                fail(f"group sampling: {p.numel()} points, too few to fill "
                     f"{n} of group {g}'s fg cap")
            thr = ss.score_thresh[g]
            odds = torch.log(p[n - 1:n + 1] / (1 - p[n - 1:n + 1])).mean()
            shift[ids] += math.log(thr / (1 - thr)) - float(odds)
    with torch.no_grad():
        ss.segmentor_mod.head_mod.conv_seg.bias += shift.float()
    return [round(float(shift[ids[0]]), 3) for ids in groups]


def _group_frames(kind: str, root: str, device):
    """Frames of a nuScenes-format set (a keyframe and 9 sweeps of ~34,000
    five-channel points each, through ``NuScenesDataset`` and
    ``LoadPointsFromMultiSweeps(sweeps_num=9)``) or an Argo2-format set
    (131,072-point frames through ``Argo2Dataset``), written under
    ``root`` from a seed; each frame range-filtered and padded to its
    config's cap. Returns (labelled batches on the device, points before
    the cap, points kept)."""
    from sst_tpu_torch.data import format_writers as fw
    from sst_tpu_torch.data.datasets import (
        Argo2Dataset,
        NuScenesDataset,
        collate_to_batch,
    )
    from sst_tpu_torch.data.pipelines import build_pipeline

    if kind == "nusc":
        cfg = load_config(NUSC_CONFIG)
        info = fw.write_nuscenes_set(root, seed=21, frames=GROUP_N_FRAMES,
                                     points=NUSC_SWEEP_POINTS,
                                     sweeps=NUSC_SWEEPS, boxes=40, half=54.0)
        load = [dict(type="LoadPointsFromMultiSweeps",
                     sweeps_num=NUSC_SWEEPS, load_dim=5,
                     use_dim=(0, 1, 2, 3), test_mode=True)]
        ds_cls, kw = NuScenesDataset, dict(use_dim=(0, 1, 2, 3))
    else:
        cfg = load_config(ARGO_FSDV2_CONFIG)
        info = fw.write_argo2_set(root, seed=22, frames=GROUP_N_FRAMES,
                                  points=ARGO_POINTS, boxes=60, half=100.0)
        load, ds_cls, kw = [], Argo2Dataset, {}
    pcr = cfg["model"]["point_cloud_range"]
    cap = cfg["capacity"]["max_points"]
    before = build_pipeline(load + [dict(type="PointsRangeFilter",
                                         point_cloud_range=pcr)])
    pad = build_pipeline([dict(type="PadToCap", max_points=cap)])
    ds = ds_cls(data_root=root, info_path=info, test_mode=True, **kw)
    frames, n_in, n_kept = [], [], []
    for i in range(len(ds)):
        sample = before(ds[i])
        n_in.append(len(sample["points"]))
        sample = pad(sample)
        n_kept.append(int(sample["points_valid"].sum()))
        frames.append(collate_to_batch([sample]).to(device))
    return frames, n_in, n_kept


def _three_sweep_frames(root: str, device, n_frames: int):
    """3-sweep Waymo frames (``fsd_waymoD1_1x_3f.py``): each keyframe of
    ``synthetic_waymo_batch`` (x, y, z + 2 channels) with its two past
    sweeps (the same scene moved by a small pose each, 0.1 s apart) read
    from ``.bin`` files through ``LoadPointsFromMultiSweeps`` on the 4x4
    pose route, range-filtered and padded to the config's 393,216 cap;
    points of 6 channels, the last the time lag."""
    from sst_tpu_torch.data.pipelines import build_pipeline

    cfg = load_config(FSD_3F_CONFIG)
    pcr = cfg["model"]["single_stage"]["point_cloud_range"]
    pipe = build_pipeline([
        dict(type="LoadPointsFromMultiSweeps", sweeps_num=2, load_dim=5,
             use_dim=(0, 1, 2, 3, 4)),
        dict(type="PointsRangeFilter", point_cloud_range=pcr),
        dict(type="PadToCap", max_points=cfg["capacity"]["max_points"])])

    def pose(yaw, t):
        m = np.eye(4)
        m[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                     [math.sin(yaw), math.cos(yaw)]]
        m[:3, 3] = t
        return m

    from sst_tpu_torch.models import PointBatch

    frames = []
    for f in range(n_frames):
        key = synthetic_waymo_batch(1, 131072, seed=30 + f,
                                    num_extra_feats=2).points[0]
        key = np.asarray(key.cpu() if torch.is_tensor(key) else key,
                         np.float32)
        sweeps = []
        for k in range(2):
            path = os.path.join(root, f"sweep_{f}_{k}.bin")
            key.tofile(path)
            sweeps.append(dict(data_path=path, timestamp=1.0 - 0.1 * (k + 1),
                               pose=pose(0.01 * (k + 1), (0.5 * (k + 1),
                                                          0.0, 0.0))))
        sample = pipe({"points": key.copy(), "timestamp": 1.0,
                       "pose": pose(0.0, (0.0, 0.0, 0.0)), "sweeps": sweeps,
                       "rng": np.random.RandomState(f)})
        frames.append(PointBatch(points=sample["points"][None],
                                 valid=sample["points_valid"][None])
                      .to(device))
    return frames


def _predict_stages(model, ss, frame) -> dict:
    """Host-clock medians of 3, the card synchronised at each boundary:
    the single stage's pipeline (segmentor to head outputs), the whole
    predict, and the rest (the head's decode + NMS; for a two stage also
    its RoI stage); then the device's busy time over one predict
    (``torch.profiler``, the union of its kernel and copy intervals,
    ``device_busy``) against its wall time, and the idle share, with the
    profiler on."""
    from torch.profiler import ProfilerActivity, profile

    def median_ms(fn):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)

    with torch.inference_mode():
        pipe_ms = median_ms(lambda: ss.run_pipeline(frame, detach_seg=False))
        pred_ms = median_ms(lambda: model.predict(frame))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.predict(frame)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    busy, _ = device_busy(prof)
    return {"pipeline_ms": pipe_ms, "predict_ms": pred_ms,
            "rest_ms": pred_ms - pipe_ms, "profiled_wall_ms": wall,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall}


def _group_path(title, model, frames, batch, device, n_remat=0,
                vote_norms=False):
    """One model of phase 21: the sparse conv kernel against its twin at
    every conv of frame 0; predict on the frames (launches per frame by
    kind, held to the module's convs; the sorted reduce, off in these
    configs as in JAX's, counted), latency and peak memory; then, where
    ``batch`` is given, one loss + backward in train mode (dW and the
    input gradient against their twins at every conv of the step,
    launches, finite losses and gradients, times); ``vote_norms``: the
    contracted votes' batch norms set for train mode first
    (``_train_vote_norms``). Returns the record."""
    n = sum(isinstance(m, SparseConvLayer) for m in model.modules())

    def drive():
        with torch.inference_mode():
            model.predict(frames[0])

    shapes, per_frame, err, convs = phase_fsd_kernels(
        model, frames[0], device, drive, title=title)
    if sum(convs.values()) != n:
        fail(f"{title}: frame 0 ran {sum(convs.values())} sparse convs, the "
             f"model has {n}")
    per, outs = [], []
    reset_launch_counts()
    for frame in frames:
        before = (scg.launches, sr.launches, sdw.launches)
        with torch.inference_mode():
            outs.append(frame_to_numpy(model.predict(frame)))
        per.append((scg.launches - before[0], sr.launches - before[1],
                    sdw.launches - before[2]))
    launches = {"sparse_conv_gemm": scg.launches, "sorted_reduce":
                sr.launches, "others": sdw.launches + wm.launches}
    if any(p != (n, 0, 0) for p in per) or launches["others"]:
        fail(f"{title}: expected {n} conv launches per frame and no other "
             f"kernel, counted {per}, {launches}")
    rows = model.test_cfg["max_num"]
    for i, res in enumerate(outs):
        if res["boxes"].shape[0] > rows or not all(
                np.isfinite(res[k]).all() for k in ("boxes", "scores")):
            fail(f"{title} frame {i}: boxes {res['boxes'].shape} or "
                 f"non-finite outputs")
    lat = _latency(lambda f: frame_to_numpy(model.predict(f)), frames,
                   GROUP_N_TIMED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        frame_to_numpy(model.predict(frames[0]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{title} predict: {len(frames)} frames, launches per frame (conv, "
          f"sorted reduce, dW) {per}; detections "
          f"{[int(r['valid'].sum()) for r in outs]} of "
          f"{outs[0]['boxes'].shape[0]} (box width "
          f"{outs[0]['boxes'].shape[1]}); latency incl. results to numpy: "
          f"median {lat['median']:.2f} ms, range {lat['min']:.2f}-"
          f"{lat['max']:.2f} over {GROUP_N_TIMED} runs; peak memory "
          f"{peak:.3f} GiB", flush=True)
    ss = getattr(model, "rpn", model)
    stages = _predict_stages(model, ss, frames[0])
    print(f"{title} predict stages (median of 3, the card synchronised at "
          f"each boundary): {({k: round(v, 3) for k, v in stages.items()})}",
          flush=True)
    rec = {"convs": n, "launches": launches, "per_frame_launches": per[0],
           "latency": lat, "peak_gib": peak, "shapes": shapes,
           "per_frame": per_frame, "max_abs_err": err, "stages": stages,
           "detections": [int(r["valid"].sum()) for r in outs]}
    with torch.inference_mode():
        ex = ss.run_pipeline(frames[0])["ex"]
    if "counts" in ex:  # FSD: fg, cluster voxels, clusters, CCL rounds
        rec["counts"] = {k: v.tolist() for k, v in ex["counts"].items()}
        empty = [k for k in ("fg", "cluster_voxels", "clusters")
                 if min(rec["counts"][k]) == 0]
    else:  # FSDv2: the virtual voxels the head sees
        rec["counts"] = {"virtual": int(ex["num_virtual"]),
                         "union_overflow": int(
                             ex["num_union_overflow_points"])}
        empty = [] if rec["counts"]["virtual"] else ["virtual"]
    print(f"{title} frame 0 counts {rec['counts']}", flush=True)
    if empty:
        fail(f"{title}: a sampling unit's stage is empty: {empty}")
    if batch is None:
        return rec

    if vote_norms:
        _train_vote_norms(model, batch)
    model.train()
    # one warm-up loss + backward, timed apart: the first grad-mode pass
    # pays one-time costs (seconds on the Argo2 FSD config), not the step's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _KeptRunningStats(model):
        out = model.loss(batch, train=True)
        sum(v for k, v in out.items() if k.startswith("loss")).backward()
    torch.cuda.synchronize()
    rec["first_loss_backward_ms"] = (time.perf_counter() - t0) * 1e3
    model.zero_grad(set_to_none=True)
    del out

    def train_forward():
        with torch.no_grad(), _KeptRunningStats(model):
            model.loss(batch, train=True)

    calls = _record_sparse_convs(model, batch, train_forward)
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        model, batch, device, calls=calls, title=f"a loss of {title}")
    del calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ev = [_event() for _ in range(3)]
    ev[0].record()
    out = model.loss(batch, train=True)
    total = sum(v for k, v in out.items() if k.startswith("loss"))
    ev[1].record()
    total.backward()
    ev[2].record()
    ev[2].synchronize()
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    loss_launches = {**scg.kind_counts, "dw": sdw.launches,
                     "sorted_reduce": sr.launches}
    losses = _losses({k: v.detach() for k, v in out.items()})
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in model.parameters() if p.grad is not None)
    model.zero_grad(set_to_none=True)
    model.eval()
    want = {"forward": n, "recompute": n_remat, "dgrad": n, "dw": n,
            "sorted_reduce": 0}
    have = {k: loss_launches.get(k, 0) for k in want}
    print(f"{title} loss + backward: the first (warm-up) "
          f"{rec['first_loss_backward_ms']:.2f} ms; then loss "
          f"{ev[0].elapsed_time(ev[1]):.2f} "
          f"ms, backward {ev[1].elapsed_time(ev[2]):.2f} ms, peak memory "
          f"{step_peak:.3f} GiB; launches {have}; losses {losses}; "
          f"gradients finite {finite}", flush=True)
    bad = [k for k, v in losses.items() if not np.isfinite(v)]
    if bad or not finite:
        fail(f"{title} loss: non-finite {bad} or gradients")
    if have != want:
        fail(f"{title} loss: launches {have}, expected {want} from the "
             f"modules")
    rec.update(loss=losses, loss_ms=ev[0].elapsed_time(ev[1]),
               backward_ms=ev[1].elapsed_time(ev[2]), step_peak_gib=step_peak,
               loss_launches=have, dw_shapes=dw_shapes, dw_step=dw_step,
               dw_err=dw_err, dgrad_err=dgrad_err)
    return rec


def phase_groups(device):
    """Phase 21: the group-sampling and multi-sweep recipes at full width,
    nothing cut, through ``build_model_from_cfg`` (float32, seed-0
    weights; the seg head's class biases shifted so 0.6 of each group's
    fg cap passes its threshold on frame 0, and for the FSD models the
    votes contracted, as phase 14 does): configs/fsdv2/fsdv2_nusc_1x.py on
    10-sweep nuScenes-format frames and configs/fsdv2/fsdv2_argo_2x.py and
    configs/argo2/argo_onestage_12e.py on Argo2-format frames (each:
    convs against their twins, predict, one loss + backward), then
    configs/fsd/fsd_waymoD1_1x_3f.py predict on 3-sweep frames. Returns
    the phase's record."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_groups_")
    out = {}
    for key, path, kind in (("nusc", NUSC_CONFIG, "nusc"),
                            ("argo_fsdv2", ARGO_FSDV2_CONFIG, "argo"),
                            ("argo_fsd", ARGO_FSD_CONFIG, "argo")):
        t0 = time.perf_counter()
        cfg = load_config(path)
        model = init_weights(build_model_from_cfg(cfg, train=False),
                             torch.Generator().manual_seed(0)).eval()
        data_dir = os.path.join(root, kind)
        if not os.path.isdir(data_dir):
            os.makedirs(data_dir)
            cache = _group_frames(kind, data_dir, device)
            out[f"{kind}_frames"] = cache
        frames, n_in, n_kept = out[f"{kind}_frames"]
        is_fsd = not hasattr(model, "vgrid")
        if is_fsd:
            _contract_votes(model)
        with torch.inference_mode():
            data = model.run_pipeline(frames[0])["data"]
        shifts = _shift_group_biases(model, data)
        del data
        n_remat = sum(isinstance(m, SparseConvLayer)
                      for u in model.modules()
                      if isinstance(u, SimpleSparseUNet) and u.remat
                      for m in u.modules())
        print(f"model: {path} through build_model_from_cfg, f32, "
              f"{sum(p.numel() for p in model.parameters())} parameters, "
              f"{len(model.group_names)} groups, built in "
              f"{time.perf_counter() - t0:.1f} s; frames: points in range "
              f"{n_in}, kept by the {cfg['capacity']['max_points']} cap "
              f"{n_kept}; group bias shifts {shifts}", flush=True)
        rec = _group_path(path, model, frames, frames[0], device, n_remat,
                          vote_norms=is_fsd)
        rec.update(points_in_range=n_in, points_kept=n_kept,
                   bias_shifts=shifts)
        out[key] = rec
        del model
        torch.cuda.empty_cache()
    for kind in ("nusc", "argo"):
        out.pop(f"{kind}_frames")

    t0 = time.perf_counter()
    cfg = load_config(FSD_3F_CONFIG)
    model = init_weights(build_model_from_cfg(cfg, train=False,
                                              num_point_features=6),
                         torch.Generator().manual_seed(0)).eval()
    frames = _three_sweep_frames(root, device, GROUP_N_FRAMES)
    seg = model.rpn.segmentor_mod
    kept = []
    with torch.inference_mode():
        for f in frames:
            _, ok = seg.voxel_downsample(f.points.reshape(-1, 6),
                                         f.valid.reshape(-1), 1)
            kept.append((int(f.valid.sum()), int(ok.sum())))
    _contract_votes(model)
    with torch.inference_mode():
        data = model.rpn.run_pipeline(frames[0])["data"]
    shifts = _shift_fg_biases(model.rpn, data)
    del data
    print(f"model: {FSD_3F_CONFIG} through build_model_from_cfg (6-channel "
          f"points, the last the time lag), f32, built in "
          f"{time.perf_counter() - t0:.1f} s; 3-sweep frames: (points, kept "
          f"by the 0.05 m down-sampling) {kept}; fg bias shifts "
          f"{[round(x, 3) for x in shifts]}", flush=True)
    rec = _group_path(FSD_3F_CONFIG, model, frames, None, device)
    rec.update(downsample_kept=kept, bias_shifts=shifts)
    out["fsd_3f"] = rec
    del model, frames
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"groups: phase 21 took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 22

OFFLINE_FRAMES = 4  # frames per validation sequence (2 of them)
OFFLINE_TRAIN_FRAMES = 7  # per training sequence (2): samples of 7 sweeps
OFFLINE_POINTS = 196608  # points per frame, the FSD configs' cap
OFFLINE_BOXES = 40  # objects per sequence
OFFLINE_HALF = 70.0  # m: points within 70 m, objects within 56 m
OFFLINE_TRAIN_STEPS = 3  # FSD++ train CLI steps, then one resumed
OFFLINE_CTRL_STEPS = 2
OFFLINE_TRACK_DIST = 3.0  # m: the tracker's link distance, world frame
OFFLINE_TRACK_PER_FRAME = 24  # the highest-scoring detections it links
BLOCKED_PACKAGES = ("jax", "jaxlib", "flax", "sst_tpu")


class _BlockedImports:
    """A meta-path finder that refuses JAX, flax and the JAX package:
    phase 22 runs under it."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED_PACKAGES:
            raise ImportError(f"{name}: phase 22 runs with "
                              f"{', '.join(BLOCKED_PACKAGES)} blocked")
        return None


def _blocked_loaded() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in BLOCKED_PACKAGES)


def _config_over(work: str, name: str, base: str, data: dict) -> str:
    """A config file in ``work`` inheriting ``base`` with ``data`` merged
    over its data section."""
    path = os.path.join(work, name)
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.abspath(base)!r}]\ndata = {data!r}\n")
    return path


def _pickle_load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _per_step(model) -> dict:
    """The conv kernels' launches one train step of ``model`` makes, from
    its modules (the configs' VFEs leave the sorted reduce off)."""
    n = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    n_remat = sum(isinstance(m, SparseConvLayer) for u in model.modules()
                  if isinstance(u, SimpleSparseUNet) and u.remat
                  for m in u.modules())
    return {"forward": n, "recompute": n_remat, "dgrad": n, "dw": n,
            "sorted_reduce": 0}


def _offline_fsd(device, work, sets) -> dict:
    """Phase 22, steps 1-2: FSD's test CLI with the Waymo evaluation over
    the validation set, then ``WaymoDataset.format_results`` and the bin
    read back."""
    from types import SimpleNamespace

    from sst_tpu_torch.core.waymo_bin import read_bin_as_frames
    from sst_tpu_torch.data.datasets import WaymoDataset
    from sst_tpu_torch.tools import test as test_cli
    from sst_tpu_torch.train.checkpoint import save_checkpoint

    root = sets["root"]
    cfg_path = _config_over(work, "fsd_offline.py", FSD_CONFIG, dict(
        dataset="waymo", data_root=root, info_path=sets["training"],
        val_info_path=sets["validation"]))
    ds = WaymoDataset(data_root=root, info_path=sets["validation"])
    model = init_weights(build_model_from_cfg(load_config(cfg_path),
                                              train=False, device=device),
                         torch.Generator().manual_seed(0)).eval()
    n = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    _contract_votes(model)
    shifts = _calibrate_fg(model, SimpleNamespace(
        points=ds.get_sample(0)["points"][None]))
    ckpt = save_checkpoint(os.path.join(work, "fsd_ckpt"), model)
    del model
    torch.cuda.empty_cache()
    preds = os.path.join(work, "fsd_preds.pkl")
    res, launches, secs = _cli_run(
        test_cli.main, [cfg_path, ckpt, "--device", str(device), "--eval",
                        "dataset", "--out", preds],
        f"test, {FSD_CONFIG} over the validation set, Waymo evaluate")
    frames = len(ds)
    _expect("offline fsd test", launches, {"forward": frames * n, "dw": 0,
                                           "sorted_reduce": 0})
    if res["frames"] != frames or not res["detections"] \
            or not np.isfinite(res["Overall/L2 mAPH"]):
        fail(f"offline: FSD test CLI gave {res}")
    results = [dict(boxes_3d=p["boxes"], scores_3d=p["scores"],
                    labels_3d=p["labels"]) for p in _pickle_load(preds)]
    t0 = time.perf_counter()
    bin_path = ds.format_results(results, os.path.join(work, "dets"))
    write_ms = (time.perf_counter() - t0) * 1e3
    idx2ts = _pickle_load(os.path.join(root, "idx2timestamp.pkl"))
    idx2cx = _pickle_load(os.path.join(root, "idx2contextname.pkl"))
    back = read_bin_as_frames(bin_path)
    worst = 0.0
    for info, r in zip(ds.infos, results):
        key = f"{info['image']['image_idx']:07d}"
        got = back.get((idx2cx[key], idx2ts[key]))
        if got is None:
            if len(r["scores_3d"]):
                fail(f"offline: frame {key}'s detections are not in the bin")
            continue
        rows = np.asarray(r["boxes_3d"], np.float32)[:, :7]
        yaw = (got["boxes"][:, 6] - rows[:, 6] + np.pi) % (2 * np.pi) - np.pi
        worst = max(worst, float(np.abs(got["boxes"][:, :6]
                                        - rows[:, :6]).max()),
                    float(np.abs(yaw).max()))
        if not (np.array_equal(got["scores"], r["scores_3d"])
                and np.array_equal(got["labels"], r["labels_3d"])
                and worst <= 1e-4):
            fail(f"offline: frame {key} read back from the bin differs "
                 f"(largest box gap {worst:.3e})")
    rec = {"metrics": {k: v for k, v in res.items()
                       if k.startswith("Overall")},
           "frames": frames, "detections": res["detections"],
           "launches": launches, "seconds": secs, "bin_write_ms": write_ms,
           "bin_objects": int(sum(len(f["scores"]) for f in back.values())),
           "bin_max_gap": worst, "fg_bias_shifts": shifts}
    print(f"offline fsd: test CLI {frames} frames, {res['detections']} "
          f"detections, launches {launches} ({n} convs per frame); "
          f"{rec['metrics']}; format_results wrote {rec['bin_objects']} "
          f"objects in {write_ms:.2f} ms, read back within {worst:.2e} "
          f"(float32 rows through double fields), scores and labels equal; "
          f"{secs:.1f} s", flush=True)
    return rec, bin_path


def _offline_seeds(work, sets, dets_bin) -> dict:
    """Phase 22, step 3: the FSD++ seed tools on the detections' bin and
    the training infos, and the segment breaks of the validation set."""
    from sst_tpu_torch.tools.fsdpp import (
        create_seed_boxes_from_info,
        create_segment_break,
        generate_seeds,
    )

    val_seeds = os.path.join(work, "seeds_val.pkl")
    generate_seeds.main(["--bin", dets_bin, "--out", val_seeds])
    # the info tool keys seeds by image index; the dataset finds them
    # beside the converter's maps in its data root
    train_seeds = os.path.join(work, "seeds_train.pkl")
    create_seed_boxes_from_info.main(["--info", sets["training"], "--out",
                                      train_seeds])
    breaks = create_segment_break.main(["--info", sets["validation"],
                                        "--num-shards", "2"])
    n_val = len(_pickle_load(val_seeds))
    n_train = len(_pickle_load(train_seeds))
    if breaks["breaks"] != [0, OFFLINE_FRAMES, 2 * OFFLINE_FRAMES] \
            or not n_val or n_train != 2 * OFFLINE_TRAIN_FRAMES:
        fail(f"offline seeds: {n_val} validation and {n_train} training "
             f"frames seeded, breaks {breaks}")
    return {"val_seed_frames": n_val, "train_seed_frames": n_train,
            "breaks": breaks["breaks"], "val": val_seeds,
            "train": train_seeds}


def _offline_fsdpp_train(device, work, sets, seeds) -> dict:
    """Phase 22, step 4: FSD++'s train CLI over the incremental set (3
    steps, a resume from the last checkpoint for one more), with the conv,
    input-gradient and dW kernels against their twins at a step's shapes
    first."""
    from sst_tpu_torch.data.incremental_dataset import (
        IncrementalWaymoDataset,
        collate_temporal,
    )
    from sst_tpu_torch.tools import train as train_cli
    from sst_tpu_torch.tools.train import step_generator

    cfg_path = _config_over(work, "fsdpp_train.py", FSDPP_CONFIG, dict(
        dataset="waymo", sequential=True, data_root=sets["root"],
        info_path=sets["training"], seeds_path=seeds["train"]))
    cfg = load_config(cfg_path)
    cap = cfg["capacity"]
    model = init_weights(build_model_from_cfg(cfg, train=True,
                                              device=device),
                         torch.Generator().manual_seed(0)).train()
    per_step = _per_step(model)
    ds = IncrementalWaymoDataset(
        data_root=sets["root"], info_path=sets["training"],
        seeds_path=seeds["train"], max_points=cap["max_points"],
        max_seeds=cap["max_seeds"], max_gt=cap["max_gt"])
    t0 = time.perf_counter()
    # a sequence's last frame: 6 earlier ones, 7 sweeps
    sample = ds[OFFLINE_TRAIN_FRAMES - 1]
    assemble_ms = (time.perf_counter() - t0) * 1e3
    batch = collate_temporal([sample]).to(device)

    def train_forward():
        with torch.no_grad(), _KeptRunningStats(model):
            model.loss(batch, train=True,
                       generator=step_generator(0, 0, device))

    title = (f"{FSDPP_CONFIG} train CLI step (incremental frame "
             f"{OFFLINE_TRAIN_FRAMES - 1})")
    shapes, per_frame, err, _ = phase_fsd_kernels(model, None, device,
                                                  train_forward, title)
    calls = _record_sparse_convs(model, None, train_forward)
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        model, None, device, calls=calls, title=title)
    del calls, model, batch
    torch.cuda.empty_cache()

    wd = os.path.join(work, "fsdpp_wd")
    common = [cfg_path, "--device", str(device), "--work-dir", wd,
              "--log-interval", "1", "--ckpt-interval", "2"]
    torch.cuda.reset_peak_memory_stats()
    train, launches, secs = _cli_run(
        train_cli.main, common + ["--max-steps", str(OFFLINE_TRAIN_STEPS)],
        f"train, {FSDPP_CONFIG} (sequential=True)")
    peak = torch.cuda.max_memory_allocated()
    _expect("offline fsdpp train", launches,
            {k: v * OFFLINE_TRAIN_STEPS for k, v in per_step.items()})
    last = os.path.join(wd, f"ckpt_{OFFLINE_TRAIN_STEPS}")
    resume, resume_launches, resume_s = _cli_run(
        train_cli.main, common + ["--max-steps", str(OFFLINE_TRAIN_STEPS + 1),
                                  "--resume-from", last], "resume, FSD++")
    _expect("offline fsdpp resume", resume_launches, per_step)
    losses = train["loss_total"] + resume["loss_total"]
    if not all(np.isfinite(losses)) \
            or resume["start_step"] != OFFLINE_TRAIN_STEPS:
        fail(f"offline fsdpp train: losses {losses}, resumed at "
             f"{resume['start_step']}")
    rec = {"step_ms": train["step_ms"], "resume_step_ms": resume["step_ms"],
           "loader_wait_ms": train["loader_wait_ms"]
           + resume["loader_wait_ms"], "peak_memory_bytes": peak,
           "losses": losses, "launches_per_step": per_step,
           "launches": launches, "resume_launches": resume_launches,
           "sample_assembly_ms": assemble_ms,
           "sample_points": int(sample["valid"].sum()),
           "sample_seeds": int(sample["seed_valid"].sum()),
           "seconds": {"train": secs,
                       "resume": resume_s},
           "shapes": shapes, "per_step": per_frame, "max_abs_err": err,
           "dw_shapes": dw_shapes, "dw_step": dw_step, "dw_err": dw_err,
           "dgrad_err": dgrad_err}
    print(f"offline fsdpp train CLI: {OFFLINE_TRAIN_STEPS} + 1 steps, step "
          f"ms (card synchronised at each step's end) "
          f"{[round(t, 2) for t in rec['step_ms']]} + resume "
          f"{[round(t, 2) for t in rec['resume_step_ms']]}; loader wait per "
          f"step {[round(w, 1) for w in rec['loader_wait_ms']]} ms (a "
          f"sequence's last sample: {OFFLINE_TRAIN_FRAMES} sweeps read, "
          f"aligned and drawn to "
          f"{cap['max_points']} points, {assemble_ms:.1f} ms alone: "
          f"{rec['sample_points']} points, {rec['sample_seeds']} seeds); "
          f"peak memory {peak / 2**30:.3f} GiB; losses "
          f"{[round(x, 4) for x in losses]}; launches per step {per_step} "
          f"(run {launches}, resume {resume_launches}); conv "
          f"{per_frame['ms']:.3f} ms per step (twin "
          f"{per_frame['plain_ms']:.3f}, bound {per_frame['bound_ms']:.3f}), "
          f"dW {dw_step['ms']:.3f} (bound {dw_step['bound_ms']:.3f}), input "
          f"gradient {dw_step['dgrad_ms']:.3f}", flush=True)
    return rec


def _offline_fsdpp_sequential(device, work, sets, seeds) -> dict:
    """Phase 22, step 5: FSD++'s test CLI ``--sequential`` over the
    validation sequences (seed-0 weights with phase 17's settings, through
    a checkpoint), the conv kernel against its twin at frame 1's shapes
    first."""
    from sst_tpu_torch.data.incremental_dataset import (
        IncrementalWaymoDataset,
        collate_temporal,
    )
    from sst_tpu_torch.tools import test as test_cli
    from sst_tpu_torch.train.checkpoint import save_checkpoint

    cfg_path = _config_over(work, "fsdpp_test.py", FSDPP_CONFIG, dict(
        dataset="waymo", sequential=True, data_root=sets["root"],
        info_path=sets["training"], val_info_path=sets["validation"],
        seeds_path=seeds["val"]))
    model = init_weights(build_model_from_cfg(load_config(cfg_path),
                                              train=False, device=device),
                         torch.Generator().manual_seed(0)).eval()
    n = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    ds = IncrementalWaymoDataset(data_root=sets["root"],
                                 info_path=sets["validation"],
                                 seeds_path=seeds["val"])
    batch = collate_temporal([ds[1]]).to(device)
    _, shifts = _fsdpp_set_weights(model, batch, train=False)

    def drive():
        with torch.inference_mode():
            model.predict(batch)

    shapes, per_frame, err, _ = phase_fsd_kernels(
        model, None, device, drive,
        title=f"{FSDPP_CONFIG} sequential predict (validation frame 1)")
    ckpt = save_checkpoint(os.path.join(work, "fsdpp_ckpt"), model)
    del model, batch
    torch.cuda.empty_cache()
    out = os.path.join(work, "fsdpp_seq.pkl")
    torch.cuda.reset_peak_memory_stats()
    res, launches, secs = _cli_run(
        test_cli.main, [cfg_path, ckpt, "--device", str(device),
                        "--sequential", "--eval", "waymo", "--out", out],
        f"test --sequential, {FSDPP_CONFIG}")
    peak = torch.cuda.max_memory_allocated()
    frames = len(ds)
    _expect("offline fsdpp sequential", launches,
            {"forward": frames * n, "dw": 0, "sorted_reduce": 0})
    fed = frames - 2  # every frame but each sequence's first
    if res["frames"] != frames or res["seeded_frames"] != fed \
            or not np.isfinite(res["Overall/L2 mAPH"]):
        fail(f"offline fsdpp sequential: {res['frames']} frames, "
             f"{res['seeded_frames']} with fed-back seeds ({fed} expected), "
             f"L2 mAPH {res.get('Overall/L2 mAPH')}")
    rec = {"predict_ms": res["predict_ms"],
           "seeded_frames": res["seeded_frames"], "frames": frames,
           "detections": res["detections"], "launches": launches,
           "launches_per_frame": n, "peak_memory_bytes": peak,
           "metrics": {k: v for k, v in res.items()
                       if k.startswith("Overall")}, "seconds": secs,
           "fg_bias_shifts": shifts, "shapes": shapes,
           "per_frame": per_frame, "max_abs_err": err}
    print(f"offline fsdpp sequential: {frames} frames, predict ms (card "
          f"synchronised) {[round(t, 2) for t in res['predict_ms']]}, "
          f"{res['seeded_frames']} frames with fed-back seeds, "
          f"{res['detections']} detections, launches {launches} ({n} per "
          f"frame), peak {peak / 2**30:.3f} GiB; {rec['metrics']}; conv "
          f"{per_frame['ms']:.3f} ms per frame (twin "
          f"{per_frame['plain_ms']:.3f}, bound {per_frame['bound_ms']:.3f}); "
          f"{secs:.1f} s", flush=True)
    return rec


def _offline_ctrl(device, work, sets, dets_bin) -> dict:
    """Phase 22, step 6: CTRL's offline chain on the validation sequences:
    pose tables, the gt bin from the tfrecord, a tracker's bin from the
    FSD detections (``format_writers.assign_track_ids``), extension,
    tracklets, candidates, 2 train CLI steps, predict over every track,
    the refined bin and its score, a per-type split merged back, empty
    boxes removed, and the submission packed and parsed back. The
    tracker's bin is extended before the tracklets are made from it."""
    from sst_tpu_torch.apis import init_model
    from sst_tpu_torch.core.tracklet import tracklets_to_bin
    from sst_tpu_torch.core.waymo_bin import (
        _parse_fields,
        read_bin_as_frames,
        write_waymo_bin,
    )
    from sst_tpu_torch.data import format_writers as fw
    from sst_tpu_torch.data.tracklet_dataset import (
        WaymoTrackletDataset,
        collate_tracklets,
    )
    from sst_tpu_torch.tools import create_submission
    from sst_tpu_torch.tools import train as train_cli
    from sst_tpu_torch.tools.ctrl import (
        extend_tracks,
        extract_poses,
        generate_candidates,
        generate_track_input,
        generate_train_gt_bin,
        merge_bins,
        remove_empty,
    )

    root = sets["root"]
    t_chain = time.perf_counter()
    extract_poses.main(["--kitti-root", root])
    gt_bin = os.path.join(work, "gt.bin")
    generate_train_gt_bin.main(["--data-folder",
                                os.path.dirname(sets["tfrecord"]),
                                "--output", gt_bin])
    poses = _pickle_load(os.path.join(root, "poses_by_context.pkl"))
    tracks_bin = write_waymo_bin(
        os.path.join(work, "tracks.bin"),
        fw.assign_track_ids(read_bin_as_frames(dets_bin), poses,
                            OFFLINE_TRACK_DIST, OFFLINE_TRACK_PER_FRAME))
    ext_bin = os.path.join(work, "tracks_ext.bin")
    extend_tracks.main(["--bin", tracks_bin, "--kitti-root", root,
                        "--extend-length", "3", "--min-length", "2",
                        "--out", ext_bin])
    trk_pkl = os.path.join(work, "tracklets.pkl")
    generate_track_input.main(["--bin", ext_bin, "--poses",
                               os.path.join(root, "poses_by_context.pkl"),
                               "--out", trk_pkl])
    cand_pkl = os.path.join(work, "candidates.pkl")
    generate_candidates.main(["--tracklets", trk_pkl, "--gt-bin", gt_bin,
                              "--poses",
                              os.path.join(root, "poses_by_context.pkl"),
                              "--out", cand_pkl])
    n_matched = int(sum(c["valid"].sum() for c in _pickle_load(cand_pkl)))
    # F6 on this set: the gt objects as a tracker's tracks, moved to the
    # world by the poses, match their own gt box on every frame once the
    # gt boxes take the same poses; compared in the ego frame, few do
    gt_trk = os.path.join(work, "gt_tracklets.pkl")
    generate_track_input.main(["--bin", gt_bin, "--poses",
                               os.path.join(root, "poses_by_context.pkl"),
                               "--out", gt_trk])
    gt_frames = sum(len(t) for t in _pickle_load(gt_trk))
    gt_matched = {}
    for frame, extra in (("world", ["--poses", os.path.join(
            root, "poses_by_context.pkl")]), ("ego", [])):
        out = os.path.join(work, f"gt_candidates_{frame}.pkl")
        generate_candidates.main(["--tracklets", gt_trk, "--gt-bin", gt_bin,
                                  *extra, "--out", out])
        gt_matched[frame] = int(sum(c["valid"].sum()
                                    for c in _pickle_load(out)))
    if gt_matched["world"] != gt_frames or gt_matched["ego"] >= gt_frames:
        fail(f"offline ctrl: the gt objects' own tracks matched "
             f"{gt_matched} of {gt_frames} frames (world: all expected)")
    chain_s = time.perf_counter() - t_chain
    data = dict(dataset="waymo_tracklet", data_root=root,
                tracklet_path=trk_pkl,
                poses_path=os.path.join(root, "poses_by_context.pkl"),
                frame_index_path=os.path.join(root, "frame_index.pkl"),
                candidates_path=cand_pkl)
    cfg_path = _config_over(work, "ctrl_offline.py", CTRL_CONFIG, data)
    cfg = load_config(cfg_path)
    cap, batch_size = cfg["capacity"], cfg["data"]["samples_per_device"]
    ds = WaymoTrackletDataset(
        data_root=root, tracklet_path=trk_pkl, poses_path=data["poses_path"],
        frame_index_path=data["frame_index_path"],
        max_points=cap["max_points"], max_frames=cap["max_frames"])
    n_tracks = len(ds)
    lengths = [len(t) for t in ds.tracklets]
    if n_tracks < 2 * batch_size:
        fail(f"offline ctrl: {n_tracks} tracklets from the tracker's bin, "
             f"fewer than two batches of {batch_size}")
    per_step = _per_step(build_model_from_cfg(cfg, train=True, device="cpu"))
    wd = os.path.join(work, "ctrl_wd")
    train, train_launches, train_s = _cli_run(
        train_cli.main, [cfg_path, "--device", str(device), "--work-dir", wd,
                         "--log-interval", "1", "--max-steps",
                         str(OFFLINE_CTRL_STEPS)],
        f"train, {CTRL_CONFIG} over the chain's tracklets")
    _expect("offline ctrl train", train_launches,
            {k: v * OFFLINE_CTRL_STEPS for k, v in per_step.items()})
    if not all(np.isfinite(train["loss_total"])):
        fail(f"offline ctrl train: losses {train['loss_total']}")

    model = init_model(cfg_path, os.path.join(
        wd, f"ckpt_{OFFLINE_CTRL_STEPS}"), device=device)
    n = sum(isinstance(m, SparseConvLayer) for m in model.modules())
    first = collate_tracklets([ds[0]], device)

    def drive():
        with torch.inference_mode():
            model.predict(first)

    shapes, per_track, err, _ = phase_fsd_kernels(
        model, None, device, drive,
        title=f"{CTRL_CONFIG} predict (the chain's track 0)")
    results, ms = [], []
    reset_launch_counts()
    for i in range(n_tracks):
        sample = ds[i]
        batch = collate_tracklets([sample], device)
        t0 = time.perf_counter()
        out = model.predict(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        results.append(dict(boxes=out["boxes"][0].cpu().numpy(),
                            scores=out["scores"][0].cpu().numpy(),
                            valid=out["valid"][0].cpu().numpy(),
                            track_center=sample["track_center"]))
    launches = _cli_counts()
    _expect("offline ctrl predict", launches,
            {"forward": n_tracks * n, "dw": 0, "sorted_reduce": 0})
    if not all(np.isfinite(r["boxes"]).all() and np.isfinite(
            r["scores"]).all() for r in results):
        fail("offline ctrl: non-finite refined boxes or scores")
    del model, first
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    refined = ds.format_results(results, os.path.join(work, "refined.bin"))
    write_ms = (time.perf_counter() - t0) * 1e3
    score = ds.evaluate(results, os.path.join(work, "refined_eval.bin"),
                        gt_bin=gt_bin)
    if not refined or not np.isfinite(score.get("Overall/L2 mAPH", 0.0)):
        fail(f"offline ctrl: {len(refined)} refined tracks, score {score}")
    # the refined tracks in two bins, as per-class runs write them
    half = len(refined) // 2
    parts = [tracklets_to_bin(sub, os.path.join(work, f"refined_{i}.bin"))
             for i, sub in enumerate((refined[:half], refined[half:]))]
    merged = os.path.join(work, "merged.bin")
    merge_bins.main(["--bins", *parts, "--out", merged])

    def objects(path):
        return sorted((k, oid, tuple(b), float(s))
                      for k, fr in read_bin_as_frames(path).items()
                      for oid, b, s in zip(fr["obj_ids"],
                                           fr["boxes"].tolist(),
                                           fr["scores"].tolist()))

    if objects(merged) != objects(os.path.join(work, "refined.bin")):
        fail("offline ctrl: the per-type bins merged back differ from the "
             "refined bin")
    cleaned = os.path.join(work, "cleaned.bin")
    remove_empty.main(["--bin", merged, "--kitti-root", root, "--split",
                       "validation", "--out", cleaned])
    meta = os.path.join(work, "submission.txt")
    with open(meta, "w") as f:
        f.write("unique_method_name: ctrl-port\nauthors: chip smoke\n"
                "affiliation: sst_tpu_torch\naccount_name: smoke@example.com"
                "\ntask: TRACKING_3D\nnum_past_frames: 6\n")
    shards = create_submission.main([
        "--input-filenames", cleaned, "--submission-filename", meta,
        "--output-filename", os.path.join(work, "submission", "part"),
        "--num-shards", "2"])
    packed = []
    for path in shards:
        with open(path, "rb") as f:
            fields = _parse_fields(f.read())
        if [v for fn, _, v in fields if fn == 1] != [4]:
            fail(f"offline ctrl: {path} does not parse as a TRACKING_3D "
                 f"submission")
        for fn, _, v in fields:
            if fn == 11:
                packed += [p for f2, w2, p in _parse_fields(v)
                           if f2 == 1 and w2 == 2]
    kept = create_submission.read_objects_payload(cleaned)
    if sorted(packed) != sorted(kept) or not kept:
        fail(f"offline ctrl: the submission holds {len(packed)} objects, "
             f"the cleaned bin {len(kept)}")
    rec = {"tracks": n_tracks, "track_lengths": lengths,
           "candidates_matched": n_matched,
           "gt_track_frames": gt_frames, "gt_track_matched": gt_matched,
           "train_step_ms": train["step_ms"],
           "train_loader_wait_ms": train["loader_wait_ms"],
           "train_losses": train["loss_total"],
           "train_launches": train_launches, "launches_per_step": per_step,
           "predict_ms": ms, "launches": launches, "launches_per_track": n,
           "refined_tracks": len(refined), "bin_write_ms": write_ms,
           "metrics": {k: v for k, v in score.items()
                       if k.startswith("Overall")},
           "submission_objects": len(packed), "chain_tools_s": chain_s,
           "seconds": {"train": train_s}, "shapes": shapes,
           "per_track": per_track, "max_abs_err": err}
    print(f"offline ctrl: {n_tracks} tracklets (lengths {lengths}), "
          f"{rec['candidates_matched']} candidate frames matched (the gt "
          f"objects' own tracks: {gt_matched['world']} of {gt_frames} frames "
          f"with the poses, {gt_matched['ego']} without); train CLI "
          f"step ms {[round(t, 2) for t in train['step_ms']]}, loader wait "
          f"{[round(w, 1) for w in train['loader_wait_ms']]} ms, launches "
          f"{train_launches}; predict ms per track "
          f"{[round(t, 2) for t in ms]}, launches {launches} ({n} per "
          f"track); refined bin written in {write_ms:.2f} ms, "
          f"{rec['metrics']}; {len(packed)} objects in the submission; "
          f"conv {per_track['ms']:.3f} ms per track (twin "
          f"{per_track['plain_ms']:.3f}, bound {per_track['bound_ms']:.3f})",
          flush=True)
    return rec


def phase_offline(device) -> dict:
    """Phase 22: the offline workflows on a seeded Waymo kitti-format set,
    with ``jax``, ``flax`` and ``sst_tpu`` blocked: FSD's test CLI and the
    detections' bin, FSD++'s seed tools, train CLI and ``--sequential``
    test CLI, CTRL's chain from a tracker's bin to a submission. Returns
    the phase's record."""
    from sst_tpu_torch.data import format_writers as fw

    t_phase = time.perf_counter()
    finder = _BlockedImports()
    sys.meta_path.insert(0, finder)
    work = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    try:
        t0 = time.perf_counter()
        sets = fw.write_waymo_set(
            os.path.join(work, "kitti"), seed=22, train_sequences=2,
            val_sequences=2, frames=OFFLINE_FRAMES,
            train_frames=OFFLINE_TRAIN_FRAMES, points=OFFLINE_POINTS,
            boxes=OFFLINE_BOXES, half=OFFLINE_HALF)
        write_s = time.perf_counter() - t0
        print(f"offline: a Waymo kitti-format set of 2 training sequences "
              f"x {OFFLINE_TRAIN_FRAMES} frames and 2 validation ones x "
              f"{OFFLINE_FRAMES}, {OFFLINE_POINTS} points and "
              f"{OFFLINE_BOXES} objects each, and its tfrecord, written in "
              f"{write_s:.1f} s", flush=True)
        fsd, dets_bin = _offline_fsd(device, work, sets)
        torch.cuda.empty_cache()
        seeds = _offline_seeds(work, sets, dets_bin)
        fsdpp_train = _offline_fsdpp_train(device, work, sets, seeds)
        torch.cuda.empty_cache()
        fsdpp_seq = _offline_fsdpp_sequential(device, work, sets, seeds)
        torch.cuda.empty_cache()
        ctrl = _offline_ctrl(device, work, sets, dets_bin)
        torch.cuda.empty_cache()
    finally:
        sys.meta_path.remove(finder)
        shutil.rmtree(work, ignore_errors=True)
    loaded = _blocked_loaded()
    if loaded:
        fail(f"offline: {loaded} entered sys.modules")
    seconds = time.perf_counter() - t_phase
    print(f"offline: phase 22 took {seconds:.1f} s (set written in "
          f"{write_s:.1f} s); none of {BLOCKED_PACKAGES} in sys.modules",
          flush=True)
    return {"fsd": fsd, "seeds": {k: v for k, v in seeds.items()
                                  if k not in ("val", "train")},
            "fsdpp_train": fsdpp_train, "fsdpp_sequential": fsdpp_seq,
            "ctrl": ctrl, "set_write_s": write_s, "seconds": seconds}


# ---------------------------------------------------------------- phase 23

CENTER_CONFIG = "configs/sst/sst_waymoD5_3class_centerhead.py"
CENTER_D1_CONFIG = "configs/sst/sst_waymoD1_2x_3class_centerhead.py"
WNMS_CONFIG = "configs/sst/sst_waymoD5_car_wnms.py"
FSD_SST_CONFIG = "configs/fsd/fsd_waymoD1_1x_sst_encoder.py"
FSD_SST_PRETRAIN_CONFIG = "configs/fsd/fsd_sst_encoder_pretrain.py"
SST_HEAD_FRAMES = 3  # predicted frames per path
SOAK_STEPS = 30
SOAK_SCENES = 8
BENCH_SAMPLES = 20


def _off_path_launches() -> dict:
    """The launches of the kernels that no phase-23 model path runs."""
    return {"sorted_reduce": sr.launches,
            "segment_offsets": sr.offsets_launches,
            "sparse_conv_gemm": scg.launches, "sparse_conv_dw": sdw.launches}


def _expect_mha_only(what: str) -> None:
    others = _off_path_launches()
    if any(others.values()):
        fail(f"{what}: kernels off the path launched: {others}")


def _build_from(path: str, train: bool, n_features: int = 5):
    t0 = time.perf_counter()
    model = init_weights(build_model_from_cfg(
        load_config(path), train=train, num_point_features=n_features),
        torch.Generator().manual_seed(0)).train(train)
    n_attn = sum(isinstance(m, WindowAttention) for m in model.modules())
    print(f"model: {path} through build_model_from_cfg (train={train}), "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{n_attn} window attention layers, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model


def _predict_profile(title: str, model, frames) -> dict:
    """Peak memory of one predict, and phase 14's trace over 2 predicts
    (busy, wall, idle share, top kernels)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.predict(prepare_batch(model, frames[0].points[0], model.max_points))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  {title}: peak memory of one predict {peak / 2**30:.3f} GiB",
          flush=True)
    return {"peak_bytes": peak, **_fsd_trace(model, frames)}


def _sst_head_predict(path: str, frames, device, timed_shapes=None):
    """One SST config's predict at full width (x, y, z frames): the window
    MHA against its twin on frame 0's attention inputs (where
    ``timed_shapes`` is None), 48 launches per frame and no other kernel,
    the stage table (CUDA events at module hooks), peak memory and idle
    share. Returns the path's record."""
    from sst_tpu_torch.tools.profile_predict import (
        stage_boundaries,
        staged_predict,
    )

    model = _build_from(path, False, 3).eval()
    rec = {}
    if timed_shapes is None:
        timed_shapes, err, sdpa_err = phase_sst_kernels(model, frames[0],
                                                        device, title=path)
        rec.update(shapes=list(timed_shapes.values()), max_abs_err=err,
                   sdpa_max_abs_err=sdpa_err)
    launches, split, lat, diags, results = phase_sst_predict(model, frames,
                                                             path)
    _expect_mha_only(path)
    if set(split) - set(timed_shapes):
        fail(f"{path}: window_mha launched at (T, C, H) "
             f"{set(split) - set(timed_shapes)}, which no check timed")
    if not any(r["valid"].any() for r in results):
        fail(f"{path}: no frame gave a valid box")
    boundaries = stage_boundaries(model, "sst")
    names = [n for n, _, _ in boundaries] + ["decode + NMS", "copy to host"]
    batches = [prepare_batch(model, f.points[0], model.max_points)
               for f in frames]
    staged = [staged_predict(model, b, boundaries)[1] for b in batches]
    stage_ms = {n: statistics.median(s[i] for s in staged)
                for i, n in enumerate(names)}
    print(f"  {path} stages, ms (median of {len(batches)} frames, CUDA "
          f"events at module hooks): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()),
          flush=True)
    rec.update(launches=launches,
               split={f"T={t} C={c} H={h}": n for (t, c, h), n in
                      split.items()},
               latency_ms=lat, capacity_counters=diags, stage_ms=stage_ms,
               detections=[int(r["valid"].sum()) for r in results],
               **_predict_profile(path, model, frames))
    del model
    torch.cuda.empty_cache()
    return rec, timed_shapes, split


def _sst_head_train(path: str, device, check_kernel: bool) -> dict:
    """One SST config's train step at full width: the window MHA against
    its twin on the attention inputs of step 0 (``check_kernel``), then
    2 + 6 + 3 ``train_step`` calls with a seeded voxel-shuffle generator,
    the configs' AdamW: 36 forward and 36 recompute launches per step, no
    other kernel, finite losses."""
    model = _build_from(path, True, 3)
    frames = [f.to(device) for f in _labeled_sst_frames(4)]
    gen = torch.Generator(device=device).manual_seed(0)
    errs = []
    if check_kernel:
        for name, nhead, buckets in _record_train_attention(model, frames[0],
                                                            gen):
            for q, k, v, pad in buckets:
                _check_mha(f"{name}, T={q.shape[1]}, W={q.shape[0]}", q, k,
                           v, pad, nhead, errs)
        print(f"  {path}: window_mha against its twin on the {len(errs)} "
              f"attention inputs of train step 0, max_abs_err "
              f"{max(errs):.3e}", flush=True)
    n_attn = sum(isinstance(m, WindowAttention) for m in model.modules())
    per_pass = n_attn * len(model.buckets)
    expected = {"window_mha forward": per_pass,
                "window_mha recompute": per_pass}
    reset_launch_counts()
    steps, stage_ms, peak = _train_loop(
        model, _adamw(model), frames,
        [dict(generator=gen)] * (N_WARMUP + N_TIMED + N_STAGED),
        lambda: {"window_mha forward": wm.kind_counts.get("forward", 0),
                 "window_mha recompute": wm.kind_counts.get("recompute",
                                                            0)})
    _check_launches(steps, expected)
    _expect_mha_only(f"{path} train")
    print(f"SST head train: {path}, batch 1, launches per step {expected}",
          flush=True)
    record = _print_train(steps, stage_ms, peak)
    record.update(launches={"window_mha": wm.launches},
                  launches_per_step_expected=expected,
                  mha_max_abs_err=max(errs) if errs else None,
                  losses={k: v for k, v in steps[-1]["metrics"].items()
                          if k.startswith("loss")})
    del model
    torch.cuda.empty_cache()
    return record


def _fsd_sst_predict(device) -> dict:
    """FSD with the SST encoder at full width (x, y, z + 2 channels): the
    votes contracted and the fg biases calibrated as in phase 14; the
    window MHA against its twin on frame 0's attention inputs; predict on
    the frames through ``inference_detector``: 24 window MHA launches per
    frame (4 blocks x 2 layers x 3 buckets), no sparse conv, dW or sorted
    reduce; fills and outputs per frame; latency, stages, peak memory,
    idle share."""
    model = _build_from(FSD_SST_CONFIG, False).eval()
    frames = _frames(SST_HEAD_FRAMES)
    _contract_votes(model)
    shifts = _calibrate_fg(model, frames[0])
    print(f"  votes contracted, fg bias shifts "
          f"{[round(x, 3) for x in shifts]}", flush=True)
    shapes, err, sdpa_err = phase_sst_kernels(model, frames[0], device,
                                              title=FSD_SST_CONFIG)
    seg = model.rpn.segmentor_mod
    n_attn = sum(isinstance(m, WindowAttention) for m in model.modules())
    expected = n_attn * len(seg.sst_buckets)
    results, per_frame = [], []
    with _FSDProbe(model) as probe:
        reset_launch_counts()
        for frame in frames:
            before = dict(wm.launch_counts)
            results.append(inference_detector(model, frame.points[0],
                                              model.max_points))
            per_frame.append({k: v - before.get(k, 0)
                              for k, v in wm.launch_counts.items()})
        launches = wm.launches
        _expect_mha_only(FSD_SST_CONFIG)
    split = per_frame[0]
    print(f"fsd sst predict: {FSD_SST_CONFIG} on {len(frames)} frames; "
          f"window_mha launches {launches}, per frame by (T, C, H) {split}; "
          f"sparse conv, dW and sorted reduce launches 0", flush=True)
    if any(f != split for f in per_frame) or sum(split.values()) != expected:
        fail(f"fsd sst: window_mha launches per frame {per_frame}, "
             f"expected {expected} ({n_attn} layers x "
             f"{len(seg.sst_buckets)} buckets)")
    if set(split) - set(shapes):
        fail(f"fsd sst: window_mha launched at {set(split) - set(shapes)}, "
             f"which the kernel check did not time")
    for s, (res, rec) in enumerate(zip(results, probe.frames)):
        _check_fsd_frame(model, s, res, rec)
    lat = _latency(lambda f: inference_detector(
        model, f.points[0], model.max_points), frames, 8)
    print(f"fsd sst latency, inference_detector (two stage): median "
          f"{lat['median']:.2f} ms, range {lat['min']:.2f}-"
          f"{lat['max']:.2f} over 8 runs", flush=True)
    stages = [_fsd_stage_ms(model, f) for f in frames[:2]]
    stage_ms = {k: statistics.median(s[k] for s in stages)
                for k in stages[0]}
    print(f"  stages, ms (median of 2 frames, the card synchronised at each "
          f"boundary): " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in stage_ms.items()),
          flush=True)
    prof = _predict_profile(FSD_SST_CONFIG, model, frames)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches,
            "split": {f"T={t} C={c} H={h}": n for (t, c, h), n in
                      split.items()},
            "latency": lat, "stage_ms": stage_ms, "frames": probe.frames,
            "fg_bias_shifts": shifts, "shapes": list(shapes.values()),
            "max_abs_err": err,
            "sdpa_max_abs_err": sdpa_err,
            "detections": [int(r["valid"].sum()) for r in results], **prof}


def _fsd_sst_steps(path: str, device, n_steps: int, kws) -> dict:
    """``n_steps`` train steps of ``path``'s model (train=True, votes
    contracted, the config's AdamW and schedule mode ``kws``) on labelled
    frames, timed by CUDA events: 24 forward and 24 recompute window MHA
    launches per step and no other kernel, finite losses and grad norms."""
    model = _build_from(path, True)
    _contract_votes(model)
    cfg = load_config(path)
    opt = optimizer_from_cfg(model, cfg, 10000)
    frames = [f.to(device) for f in _labeled_frames(2)]
    seg = model.rpn.segmentor_mod
    per_pass = sum(isinstance(m, WindowAttention) for m in seg.modules()) \
        * len(seg.sst_buckets)
    expected = {"forward": per_pass, "recompute": per_pass}
    gen = torch.Generator(device=device).manual_seed(0)
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps):
        reset_launch_counts()
        out = {}
        ms = event_ms(lambda: out.update(train_step(
            model, opt, frames[i % len(frames)], dict(kws, generator=gen))))
        got = {k: wm.kind_counts.get(k, 0) for k in expected}
        if got != expected:
            fail(f"{path} step {i}: window_mha launches by kind {got}, "
                 f"expected {expected}")
        _expect_mha_only(f"{path} step {i}")
        m = _losses(out)
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            fail(f"{path} step {i}: non-finite {bad}")
        steps.append({"ms": ms, "metrics": m})
    peak = torch.cuda.max_memory_allocated()
    print(f"fsd sst train: {path}, {kws}, {n_steps} steps; ms "
          f"{[round(s['ms'], 2) for s in steps]}; launches per step "
          f"{expected}; peak memory {peak / 2**30:.3f} GiB; last step "
          f"{ {k: round(v, 4) for k, v in steps[-1]['metrics'].items()} }",
          flush=True)
    del model, opt
    torch.cuda.empty_cache()
    return {"step_ms": [s["ms"] for s in steps], "peak_bytes": peak,
            "launches_per_step": expected, "metrics": steps[-1]["metrics"],
            "launches": {"window_mha": n_steps * 2 * per_pass}}


def _tools(device) -> dict:
    """The preflight, the benchmark tool on the CenterHead config and the
    soak on ``sst``, which must pass."""
    from sst_tpu_torch.tools import soak as soak_tool
    from sst_tpu_torch.tools.analysis_tools import benchmark

    # the benchmark tool runs preflight_kernels on the card first
    t0 = time.perf_counter()
    bench = benchmark.main([CENTER_CONFIG, "--samples", str(BENCH_SAMPLES),
                            "--warmup", "3", "--device", str(device)])
    bench_s = time.perf_counter() - t0
    pf = bench["preflight"]
    print(f"preflight_kernels('cuda') in the benchmark tool: every kernel "
          f"against its twin at the models' shapes; largest errors {pf}",
          flush=True)
    print(f"benchmark tool: {CENTER_CONFIG}, {BENCH_SAMPLES} samples: fps "
          f"{bench['fps']:.3f}, p50 {bench['p50_latency_ms']:.3f} ms "
          f"({bench_s:.1f} s with its preflight)", flush=True)
    t0 = time.perf_counter()
    log = soak_tool.soak("sst", SOAK_STEPS, 196608, SOAK_SCENES, device)
    soak_s = time.perf_counter() - t0
    if not log["ok"]:
        fail(f"soak (sst, {SOAK_STEPS} steps): {log['failures']}")
    print(f"soak: sst, {SOAK_STEPS} steps over {SOAK_SCENES} scenes in "
          f"{soak_s:.1f} s: every loss finite, overflow and dropped "
          f"counters {log['overflow_keys']}, launches per step "
          f"{log['launches'][2]} and peak memory "
          f"{log['peak_bytes'][2] / 2**30:.3f} GiB constant from step 2; "
          f"steady step mean {log['steady_step_ms_mean']:.2f} ms, p90 "
          f"{log['steady_step_ms_p90']:.2f} ms", flush=True)
    return {"preflight": pf, "benchmark_s": bench_s,
            "benchmark": {k: v for k, v in bench.items() if k != "preflight"},
            "soak": {k: log[k] for k in (
                "steps", "scene_pool", "overflow_keys", "steady_step_ms_mean",
                "steady_step_ms_p90", "step_ms", "losses")},
            "soak_launches_per_step": log["launches"][2],
            "soak_peak_bytes": log["peak_bytes"][2], "soak_s": soak_s}


def phase_sst_heads(device) -> dict:
    """Phase 23: the CenterHead and weighted-NMS SST configs, FSD with the
    SST encoder and its segmentor pretrain, at full width through the
    config builder, with ``jax``, ``flax`` and ``sst_tpu`` blocked; then the
    preflight, the benchmark tool and the soak. Returns the phase's
    record."""
    t_phase = time.perf_counter()
    finder = _BlockedImports()
    sys.meta_path.insert(0, finder)
    try:
        frames = _sst_frames(SST_HEAD_FRAMES)
        center, shapes, split = _sst_head_predict(CENTER_CONFIG, frames,
                                                  device)
        # the D1 file's model is the D5 file's, its weights the same seed's:
        # the same attention inputs, checked above
        center_d1, _, _ = _sst_head_predict(CENTER_D1_CONFIG, frames[:2],
                                            device, shapes)
        wnms, _, _ = _sst_head_predict(WNMS_CONFIG, frames, device, shapes)
        center_train = _sst_head_train(CENTER_CONFIG, device, True)
        center_d1_train = _sst_head_train(CENTER_D1_CONFIG, device, False)
        fsd = _fsd_sst_predict(device)
        fsd_loss = _fsd_sst_steps(FSD_SST_CONFIG, device, 2,
                                  dict(pretrain=False, thr_extra=0.0))
        sched = schedule_from_cfg(load_config(FSD_SST_PRETRAIN_CONFIG))
        pretrain = _fsd_sst_steps(FSD_SST_PRETRAIN_CONFIG, device, 3,
                                  sched(0))
        tools = _tools(device)
    finally:
        sys.meta_path.remove(finder)
    loaded = _blocked_loaded()
    if loaded:
        fail(f"sst heads: {loaded} entered sys.modules")
    seconds = time.perf_counter() - t_phase
    print(f"sst heads: phase 23 took {seconds:.1f} s; none of "
          f"{BLOCKED_PACKAGES} in sys.modules", flush=True)
    return {"centerhead": center, "centerhead_d1": center_d1, "wnms": wnms,
            "centerhead_train": center_train,
            "centerhead_d1_train": center_d1_train, "fsd_sst": fsd,
            "fsd_sst_loss": fsd_loss, "fsd_sst_pretrain": pretrain,
            "tools": tools, "seconds": seconds}

POINTPILLARS_CONFIG = "configs/pointpillars/pointpillars_waymoD5_3class.py"
PP_FRAMES = 3  # predicted frames
PP_N_TIMED = 8  # inference_detector runs timed after warm-up
PP_TRAIN_STEPS = 3  # train CLI steps at the config's 2 samples per card
# SECOND's middle encoder as mmdet3d's public SECOND KITTI model sets it up
# (mmdet3d configs/_base_/models/hv_second_secfpn_kitti.py): 0.05 x 0.05 x
# 0.1 m voxels over [0, 70.4] x [-40, 40] x [-3, 1] m, 5 points per voxel,
# 40,000 voxels at test, sparse_shape [41, 1600, 1408], 4 point features
SECOND_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
SECOND_VOXEL = (0.05, 0.05, 0.1)
SECOND_SPARSE_SHAPE = (41, 1600, 1408)
SECOND_MAX_VOXELS = 40000
SECOND_POINTS = 65536  # points drawn, before the range crop


def _pillar_fill(model, frame, device) -> dict:
    """The pillars one frame fills: points in range, distinct pillars, the
    pillars kept (at most ``max_voxels``, the lowest keys) and the points
    kept (at most ``max_points_per_voxel`` per pillar)."""
    pts = torch.from_numpy(frame.points[0]).to(device)
    valid = torch.from_numpy(frame.valid[0]).to(device)
    bidx = torch.zeros(pts.shape[0], dtype=torch.int32, device=device)
    vm = dynamic_voxelize(pts, bidx, valid, model.point_cloud_range,
                          model.voxel_size, 1 << 20, 1)
    counts = vm.unique.counts[vm.voxel_valid]
    kept = torch.clamp(counts, max=model.max_points_per_voxel)
    return {"points_in_range": int(vm.valid.sum()),
            "distinct_pillars": int(vm.unique.num_unique),
            "kept_pillars": min(int(vm.unique.num_unique), model.max_voxels),
            "kept_points": int(kept[:model.max_voxels].sum()),
            "pillars_past_points_cap": int((counts > kept).sum())}


def _pointpillars_predict(device) -> dict:
    """The PointPillars config at full width: predict on seeded 196,608-point
    frames through ``inference_detector`` (no hand-written kernel on its
    path: every launch count held at 0), the pillar fill, the stage table,
    latency, peak memory and idle share."""
    from sst_tpu_torch.tools.profile_predict import (
        stage_boundaries,
        staged_predict,
    )

    model = _build_from(POINTPILLARS_CONFIG, False).eval()
    frames = _frames(PP_FRAMES)
    fills = [_pillar_fill(model, f, device) for f in frames]
    for s, fill in enumerate(fills):
        print(f"  frame {s}: {fill['points_in_range']} points in range, "
              f"{fill['distinct_pillars']} distinct pillars, "
              f"{fill['kept_pillars']} kept (cap {model.max_voxels}), "
              f"{fill['kept_points']} points kept (cap "
              f"{model.max_points_per_voxel} per pillar; "
              f"{fill['pillars_past_points_cap']} pillars past it)",
              flush=True)
    reset_launch_counts()
    results = [inference_detector(model, f.points[0], model.max_points)
               for f in frames]
    launches = _off_path_launches() | {"window_mha": wm.launches}
    if any(launches.values()):
        fail(f"pointpillars: a hand-written kernel launched on a path that "
             f"has none: {launches}")
    max_num = model.test_cfg["max_num"]
    for s, res in enumerate(results):
        if res["boxes"].shape != (max_num, 7) or not all(
                np.isfinite(res[k]).all() for k in ("boxes", "scores")):
            fail(f"pointpillars frame {s}: boxes {res['boxes'].shape}, "
                 f"finite {np.isfinite(res['boxes']).all()}")
    if not any(r["valid"].any() for r in results):
        fail("pointpillars: no frame gave a valid box")
    lat = _latency(lambda f: inference_detector(model, f.points[0],
                                                model.max_points),
                   frames, PP_N_TIMED)
    print(f"  predict: {len(frames)} frames through inference_detector, "
          f"valid boxes {[int(r['valid'].sum()) for r in results]}, no "
          f"kernel launched; latency median {lat['median']:.3f} ms (range "
          f"{lat['min']:.3f}-{lat['max']:.3f}, {PP_N_TIMED} runs)",
          flush=True)
    boundaries = stage_boundaries(model, "pointpillars")
    names = [n for n, _, _ in boundaries] + ["decode + NMS", "copy to host"]
    batches = [prepare_batch(model, f.points[0], model.max_points)
               for f in frames]
    staged = [staged_predict(model, b, boundaries)[1] for b in batches]
    stage_ms = {n: statistics.median(st[i] for st in staged)
                for i, n in enumerate(names)}
    print(f"  {POINTPILLARS_CONFIG} stages, ms (median of {len(batches)} "
          f"frames, CUDA events at module hooks): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()),
          flush=True)
    rec = {"fills": fills, "launches": launches, "latency": lat,
           "stage_ms": stage_ms,
           "detections": [int(r["valid"].sum()) for r in results],
           **_predict_profile(POINTPILLARS_CONFIG, model, frames)}
    del model
    torch.cuda.empty_cache()
    return rec


def _pointpillars_clis(device) -> dict:
    """The train CLI on the PointPillars config (``--synthetic``, a few steps
    at its 2 samples per card) and the test CLI on its checkpoint, each run
    from zero launch counts: no hand-written kernel on the path."""
    from sst_tpu_torch.tools import test as test_cli
    from sst_tpu_torch.tools import train as train_cli

    work = tempfile.mkdtemp(prefix="pointpillars_cli_")
    try:
        wd = os.path.join(work, "wd")
        train, train_launches, train_s = _cli_run(train_cli.main, [
            POINTPILLARS_CONFIG, "--synthetic", "--device", str(device),
            "--max-steps", str(PP_TRAIN_STEPS), "--work-dir", wd,
            "--log-interval", "1", "--ckpt-interval", str(PP_TRAIN_STEPS)],
            "pointpillars train")
        if train["steps"] != PP_TRAIN_STEPS or not np.isfinite(
                train["loss_total"]).all():
            fail(f"pointpillars train CLI: {train['steps']} steps, losses "
                 f"{train['loss_total']}")
        ckpt = os.path.join(wd, f"ckpt_{PP_TRAIN_STEPS}")
        test, test_launches, test_s = _cli_run(test_cli.main, [
            POINTPILLARS_CONFIG, ckpt, "--synthetic", "--device",
            str(device), "--num-samples", "4", "--eval", "ap3d"],
            "pointpillars test")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for what, counts in (("train", train_launches), ("test", test_launches)):
        if any(counts.values()):
            fail(f"pointpillars {what} CLI: a hand-written kernel launched "
                 f"on a path that has none: {counts}")
    print(f"  train CLI: {PP_TRAIN_STEPS} steps at 2 samples per card, step "
          f"ms {[round(x, 2) for x in train['step_ms']]}, loader wait ms "
          f"{[round(x, 2) for x in train['loader_wait_ms']]}, losses "
          f"{[round(x, 4) for x in train['loss_total']]}, peak memory "
          f"{train.get('peak_memory_bytes', 0) / 2**30:.3f} GiB "
          f"({train_s:.1f} s); "
          f"test CLI on its checkpoint: {test['frames']} frames "
          f"({test_s:.1f} s)", flush=True)
    return {"train_step_ms": train["step_ms"],
            "train_loader_wait_ms": train["loader_wait_ms"],
            "train_losses": train["loss_total"], "train_s": train_s,
            "test_frames": test["frames"], "test_s": test_s,
            "launches": {"train": train_launches, "test": test_launches}}


def _second_input(device):
    """Seeded KITTI-like voxels for SECOND's encoder: a 4-channel synthetic
    frame cropped to the KITTI range, hard-voxelized (5 points, 40,000
    voxels), averaged by ``HardSimpleVFE``, on a SparseGrid at the sparse
    shape. Returns (features in grid order, grid, voxel counts)."""
    frame = synthetic_waymo_batch(1, SECOND_POINTS, seed=7,
                                  num_extra_feats=1, pcr_half=79.8)
    pts = torch.from_numpy(frame.points[0]).to(device)
    valid = torch.from_numpy(frame.valid[0]).to(device)
    bidx = torch.zeros(pts.shape[0], dtype=torch.int32, device=device)
    voxels, num, coords, vvalid = hard_voxelize(
        pts, bidx, valid, SECOND_RANGE, SECOND_VOXEL, SECOND_MAX_VOXELS, 5, 1)
    feats = HardSimpleVFE()(voxels, num)
    sg, order = make_sparse_grid(coords, vvalid, SECOND_SPARSE_SHAPE, 1)
    active = int(vvalid.sum())
    in_range = int(compute_voxel_coords(pts, bidx, valid, SECOND_RANGE,
                                        SECOND_VOXEL)[1].sum())
    print(f"second encoder input: {SECOND_POINTS} points, {in_range} in "
          f"range, {active} active voxels of {SECOND_MAX_VOXELS} at "
          f"{SECOND_VOXEL} m over {SECOND_RANGE}, sparse shape "
          f"{SECOND_SPARSE_SHAPE}", flush=True)
    if not 16000 <= active <= SECOND_MAX_VOXELS:
        fail(f"second encoder: {active} active voxels, outside 16,000 to "
             f"{SECOND_MAX_VOXELS}")
    return feats[order].contiguous(), sg, active


def _expected_encoder_launches(enc) -> Counter:
    """The encoder's convs by (mode, Cin, Cout), from the module."""
    out = Counter()
    for name, mod in enc.named_modules():
        if isinstance(mod, SparseConvLayer):
            mode = ("zdown" if name == "conv_out" else "strided"
                    if name.endswith("_down") else "subm")
            out[(mode, *mod.weight.shape[1:])] += 1
    return out


def _second_encoder(device) -> dict:
    """SECOND's ``SparseEncoder`` at its defaults on the KITTI middle-encoder
    shape: each conv, input gradient and dW against its twin on the
    recorded inputs of a train-mode forward; then a forward and one loss +
    backward from zero counts, launches held to the module's convs."""
    torch.manual_seed(0)
    enc = SparseEncoder(4).to(device)
    feats, sg, active = _second_input(device)
    gen = torch.Generator(device=device).manual_seed(8)
    with torch.no_grad():
        out = enc(feats, sg)
    g = torch.randn(out.shape, generator=gen, device=device)

    def loss_step():
        enc.zero_grad(set_to_none=True)
        (enc(feats, sg, train=True) * g).sum().backward()

    state = {k: v.clone() for k, v in enc.state_dict().items()}
    calls = _record_sparse_convs(enc, None, loss_step)
    shapes, per_fwd, conv_err, convs = phase_fsd_kernels(
        enc, None, device, drive=lambda: loss_step(),
        title="SECOND SparseEncoder", modes=("subm", "strided", "zdown"))
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        enc, None, device, calls=calls, title="SECOND SparseEncoder")
    enc.load_state_dict(state)  # the running statistics as before
    del calls
    expected = _expected_encoder_launches(enc)
    if len(expected) == 0 or sum(expected.values()) != 12:
        fail(f"second encoder: {sum(expected.values())} convs, expected 12")
    reset_launch_counts()
    box = {}

    def forward():
        with torch.no_grad():
            box["out"] = enc(feats, sg)

    fwd_ms = event_ms(forward)
    out = box.pop("out")
    fwd = dict(scg.launch_counts)
    if fwd != dict(expected) or scg.kind_counts != {"forward": 12}:
        fail(f"second encoder forward: conv launches {fwd} by kind "
             f"{scg.kind_counts}, the module gives {dict(expected)}")
    if out.shape != (1, 256, 200, 176) or not bool(
            torch.isfinite(out).all()):
        fail(f"second encoder: map {tuple(out.shape)}, finite "
             f"{bool(torch.isfinite(out).all())}")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms = event_ms(loss_step)
    peak = torch.cuda.max_memory_allocated()
    kinds = dict(scg.kind_counts)
    dgrad = sum(scg.launch_counts.values()) - kinds.get("forward", 0)
    if (kinds.get("forward") != 12 or dgrad not in (11, 12)
            or kinds.get("dgrad") != dgrad or sdw.launches != 12
            or dict(sdw.launch_counts) != dict(expected)):
        fail(f"second encoder loss + backward: conv launches by kind "
             f"{kinds}, dW {dict(sdw.launch_counts)}; the module gives "
             f"{dict(expected)}")
    if sr.launches or sr.offsets_launches or wm.launches:
        fail(f"second encoder: kernels off its path launched: sorted "
             f"reduce {sr.launches} + {sr.offsets_launches} offsets, "
             f"window MHA {wm.launches}")
    grads = [p.grad for p in enc.parameters()]
    if any(gr is None or not bool(torch.isfinite(gr).all()) for gr in grads):
        fail("second encoder: a missing or non-finite gradient")
    if tuple(enc.conv_out.weight.grad.shape) != (3, 64, 128):
        fail(f"second encoder: conv_out's dW is "
             f"{tuple(enc.conv_out.weight.grad.shape)}, not [3, 64, 128]")
    trace = _trace([forward, forward], "2 SparseEncoder forwards")
    print(f"second encoder: forward {fwd_ms:.3f} ms, loss + backward "
          f"{step_ms:.3f} ms (CUDA events), peak {peak / 2**30:.3f} GiB; "
          f"launches: forward {sum(fwd.values())} by (mode, Cin, Cout) "
          f"{fwd}, loss + backward {kinds} and dW {sdw.launches}; the "
          f"3-tap conv_out's dW [3, 64, 128]", flush=True)
    rec = {"active_voxels": active, "forward_ms": fwd_ms,
           "loss_backward_ms": step_ms, "peak_bytes": peak,
           "forward_trace": trace,
           "launches": {"forward": {str(k): v for k, v in fwd.items()},
                        "train": kinds, "dw": sdw.launches},
           "conv_shapes": shapes, "conv_per_forward": per_fwd,
           "conv_max_abs_err": conv_err, "dw_shapes": dw_shapes,
           "dw_step": dw_step, "dw_max_abs_err": dw_err,
           "dgrad_max_abs_err": dgrad_err}
    del enc, feats, sg, out, g
    torch.cuda.empty_cache()
    return rec


def _dynamic_pillars(device) -> dict:
    """``DynamicPillarFeatureNet`` with ``use_sorted_reduce=True`` at the
    PointPillars grid (0.32 m pillars over +-74.88 m, PFN 64) on phase 24's
    frame 0, voxelized by the sort: its sorted reduces (the cluster-centre
    sum and the PFN max) against their twin, timed beside the twin and
    ``torch.segment_reduce``; launches by (mode, C, dtype) from zero."""
    from sst_tpu_torch.models import vfe as vfe_module

    cfg = load_config(POINTPILLARS_CONFIG)["model"]
    pcr, vs = cfg["point_cloud_range"], cfg["voxel_size"]
    torch.manual_seed(0)
    dvfe = DynamicPillarFeatureNet(5, feat_channels=(64,), voxel_size=vs,
                                   point_cloud_range=pcr,
                                   use_sorted_reduce=True).to(device).eval()
    frame = _frames(1)[0]
    pts = torch.from_numpy(frame.points[0]).to(device)
    valid = torch.from_numpy(frame.valid[0]).to(device)
    bidx = torch.zeros(pts.shape[0], dtype=torch.int32, device=device)
    vm = dynamic_voxelize(pts, bidx, valid, pcr, vs, 65536, 1,
                          need_ranks=True)
    calls = []
    wrapped = vfe_module.sorted_segment_reduce

    def record(data, seg, num_segments, mode="sum", offsets=None):
        calls.append((mode, data.detach().clone(), seg, num_segments))
        return wrapped(data, seg, num_segments, mode, offsets)

    vfe_module.sorted_segment_reduce = record
    try:
        with torch.no_grad():
            dvfe(pts, vm)
    finally:
        vfe_module.sorted_segment_reduce = wrapped
    reset_launch_counts()
    with torch.no_grad():
        out = dvfe(pts, vm)
    torch.cuda.synchronize()
    split = {k: v for k, v in sr.launch_counts.items()}
    want = {("sum", 3, "float32"): 1, ("max", 64, "float32"): 1}
    if split != want or sr.offsets_launches != 1 or dvfe.sorted_calls != 2:
        fail(f"dynamic pillars: sorted reduce launches {split} and "
             f"{sr.offsets_launches} offsets, the module gives {want} and 1")
    if not bool(torch.isfinite(out).all()):
        fail("dynamic pillars: non-finite pillar features")
    print(f"dynamic pillars: DynamicPillarFeatureNet(use_sorted_reduce=True)"
          f" at {tuple(vs)} m, {int(vm.unique.num_unique)} pillars of "
          f"{int(vm.valid.sum())} points; launches {split} + 1 offsets",
          flush=True)
    errs, shapes = [], []
    for mode, data, seg, nseg in calls:
        _check_case(f"dynamic pillars {mode}", data, seg, nseg, mode, errs)
        offsets = sr.segment_offsets(seg, nseg)
        fns = {"plain": lambda: sr.sorted_segment_reduce_ref(
                   data, seg, nseg, mode),
               "kernel": lambda: sr.sorted_segment_reduce(
                   data, seg, nseg, mode, offsets),
               "library": _segment_reduce_library(data, offsets, nseg, mode)}
        runs = {k: [] for k in fns}
        for kind in ("plain", "kernel", "library", "library", "kernel",
                     "plain"):
            runs[kind].append(cuda_ms(fns[kind], 20))
        n, c = data.shape
        bound_ms, bound_by = bound(data.element_size() * (n * c + nseg * c)
                                   + 4 * (nseg + 1), n * c, F32_FLOP_PER_S)
        rec = {"mode": mode, "c": c, "dtype": _dtype_name(data), "n": n,
               "num_segments": nseg, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": errs[-1],
               **{("ms" if k == "kernel" else f"{k}_ms"): min(v)
                  for k, v in runs.items()}}
        shapes.append(rec)
        print(f"  time {mode} C={c}: kernel {rec['ms']:.4f} ms, twin "
              f"{rec['plain_ms']:.4f} ms, torch.segment_reduce "
              f"{rec['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
    del dvfe, vm, calls
    torch.cuda.empty_cache()
    return {"launches": {str(k): v for k, v in split.items()},
            "offsets_launches": 1, "shapes": shapes,
            "max_abs_err": max(errs)}


def phase_pointpillars(device) -> dict:
    """Phase 24: PointPillars at full width (predict, the train and test
    CLIs), SECOND's ``SparseEncoder`` on the conv, input-gradient and dW
    kernels (27 and 3 taps), and ``DynamicPillarFeatureNet`` on the sorted
    reduce, with ``jax``, ``flax`` and ``sst_tpu`` blocked."""
    t_phase = time.perf_counter()
    finder = _BlockedImports()
    sys.meta_path.insert(0, finder)
    try:
        predict = _pointpillars_predict(device)
        clis = _pointpillars_clis(device)
        encoder = _second_encoder(device)
        pillars = _dynamic_pillars(device)
    finally:
        sys.meta_path.remove(finder)
    loaded = _blocked_loaded()
    if loaded:
        fail(f"pointpillars: {loaded} entered sys.modules")
    seconds = time.perf_counter() - t_phase
    print(f"pointpillars: phase 24 took {seconds:.1f} s; none of "
          f"{BLOCKED_PACKAGES} in sys.modules", flush=True)
    return {"predict": predict, "clis": clis, "second_encoder": encoder,
            "dynamic_pillars": pillars, "seconds": seconds}


def main() -> None:
    card = phase_device()
    device = torch.device("cuda", 0)
    build_s, nvcc_s = phase_build()

    t0 = time.perf_counter()
    model = init_weights(fsdv2_waymo_dense(),
                         torch.Generator().manual_seed(0)).eval()
    f32_model = fsdv2_waymo_dense(dtype=torch.float32)
    f32_model.load_state_dict(model.state_dict())
    f32_model.eval()
    frames = _frames(4)
    print(f"model: fsdv2_waymo_dense at its default dtype (bf16 compute, "
          f"float32 parameters), and the same weights at "
          f"dtype=torch.float32; {sum(p.numel() for p in model.parameters())}"
          f" parameters, built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    shapes, offsets_rec, max_err = phase_kernels(model, f32_model, frames[0],
                                                 device)
    results, launches, split = _predict_frames(model, frames,
                                               "fsdv2_waymo_dense (bf16)")
    lat, f32_launches, f32_split = phase_ab(model, f32_model, frames,
                                            results, device)
    timed = {(s["mode"], s["c"], s["dtype"]) for s in shapes}
    untimed = (set(split) | set(f32_split)) - timed
    if untimed:
        fail(f"the dense paths launched the kernel at (mode, C, dtype) "
             f"{untimed}, which phase 3 did not check or time")
    for s in shapes:
        key = (s["mode"], s["c"], s["dtype"])
        s["calls_per_frame"] = split.get(key, 0)
        s["calls_per_frame_f32_build"] = f32_split.get(key, 0)
    batch4 = phase_batch4(model, device)
    if set(batch4["split"]) - timed:
        fail(f"the batch-4 path launched the kernel at (mode, C, dtype) "
             f"{set(batch4['split']) - timed}, which phase 3 did not time")
    dense_train = phase_dense_train(model.train(), device)
    dense_train["card"] = card
    del model
    torch.cuda.empty_cache()
    dense_train_f32 = phase_dense_train(f32_model.train(), device)
    dense_train_f32["card"] = card
    del f32_model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sparse = init_weights(fsdv2_waymo(dtype=torch.float32, backbone="sparse"),
                          torch.Generator().manual_seed(0)).eval()
    n_convs = sum(isinstance(m, SparseConvLayer) for m in sparse.modules())
    print(f"model: fsdv2_waymo(backbone='sparse') f32, "
          f"{sum(p.numel() for p in sparse.parameters())} parameters, "
          f"{n_convs} sparse convs, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    conv_shapes, conv_per_frame, conv_err, calls = phase_sparse_kernels(
        sparse, frames[0], device)
    if len(calls) != n_convs:
        fail(f"frame 0 ran {len(calls)} sparse convs, the model has "
             f"{n_convs}")
    conv_launches, sr_sparse_launches, conv_split, sparse_lat = \
        phase_sparse_predict(sparse, frames, n_convs)
    untimed = set(conv_split) - {(s["mode"], s["cin"], s["cout"])
                                 for s in conv_shapes}
    if untimed:
        fail(f"the sparse path launched the kernel at (mode, Cin, Cout) "
             f"{untimed}, which phase 6 did not check or time")
    recorded = Counter((cp.mode, w[1], w[2]) for _, _, cp, w, _, _ in calls)
    if recorded != Counter(conv_split):
        fail(f"the convs timed in phase 6 {dict(recorded)} are not those "
             f"launched per frame in phase 7 {conv_split}")
    del calls
    dw_shapes, dw_step, dw_err, dgrad_err = phase_backward_kernels(
        sparse, _labeled_frames(1)[0], device)
    train = phase_train(sparse.train(), device, n_convs)
    train["card"] = card
    del sparse
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sst = init_weights(sst_waymo(train_buckets=False, num_point_features=3),
                       torch.Generator().manual_seed(0)).eval()
    sst_frames = _sst_frames(4)
    buckets = [(b.max_tokens, b.max_windows) for b in sst.buckets]
    print(f"model: sst_waymo(train_buckets=False) f32 (bf16 attention), "
          f"{sum(p.numel() for p in sst.parameters())} parameters, buckets "
          f"(T, windows) {buckets}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    mha_shapes, mha_err, sdpa_err = phase_sst_kernels(sst, sst_frames[0],
                                                      device)
    mha_launches, mha_split, sst_lat, sst_diags, sst_results = \
        phase_sst_predict(sst, sst_frames)
    untimed = set(mha_split) - set(mha_shapes)
    if untimed:
        fail(f"the SST path launched window_mha at (T, C, H) {untimed}, "
             f"which phase 8 did not check or time")
    for key, shape in mha_shapes.items():
        shape["calls_per_frame"] = mha_split.get(key, 0)
        if shape["inputs"] != shape["calls_per_frame"]:
            fail(f"phase 8 timed {shape['inputs']} inputs at (T, C, H) "
                 f"{key}, the SST path launched {shape['calls_per_frame']} "
                 f"per frame")
    sst_bf16 = phase_sst_bf16_predict(sst, sst_frames, sst_results, device)
    sst_bf16["card"] = card
    del sst
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sst = init_weights(sst_waymo(train_buckets=True, num_point_features=3),
                       torch.Generator().manual_seed(0)).train()
    buckets = [(b.max_tokens, b.max_windows) for b in sst.buckets]
    print(f"model: sst_waymo(train_buckets=True) f32 (bf16 attention), "
          f"buckets (T, windows) {buckets}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sst_train = phase_sst_train(sst, device)
    sst_train["card"] = card
    del sst
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sst = init_weights(sst_waymo(train_buckets=True, dtype=torch.bfloat16,
                                 num_point_features=3),
                       torch.Generator().manual_seed(0)).train()
    print(f"model: sst_waymo(train_buckets=True, dtype=torch.bfloat16), "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    sst_bf16_train = phase_sst_train(
        sst, device, title="sst_waymo(train_buckets=True, "
                           "dtype=torch.bfloat16)")
    sst_bf16_train["card"] = card
    del sst
    torch.cuda.empty_cache()

    fsd = phase_fsd(device)
    fsd["card"] = card
    torch.cuda.empty_cache()
    fsd_train = phase_fsd_train(device)
    fsd_train["card"] = card
    torch.cuda.empty_cache()
    fsdpp = phase_fsdpp(device)
    fsdpp["card"] = card
    torch.cuda.empty_cache()
    fsdpp_train = phase_fsdpp_train(device)
    fsdpp_train["card"] = card
    torch.cuda.empty_cache()
    ctrl = phase_ctrl(device)
    ctrl["card"] = card
    torch.cuda.empty_cache()
    fsdv2_ts = phase_fsdv2_two_stage(device)
    fsdv2_ts["card"] = card
    torch.cuda.empty_cache()
    cli = phase_cli(device)
    cli["card"] = card
    torch.cuda.empty_cache()
    groups = phase_groups(device)
    groups["card"] = card
    torch.cuda.empty_cache()
    offline = phase_offline(device)
    offline["card"] = card
    off_fsdpp, off_seq, off_ctrl = (offline["fsdpp_train"],
                                    offline["fsdpp_sequential"],
                                    offline["ctrl"])
    torch.cuda.empty_cache()
    heads = phase_sst_heads(device)
    heads["card"] = card
    # phase 23's paths, each counted from 0: window MHA launches; every
    # other kernel was held to 0 on each
    head_runs = {"centerhead": heads["centerhead"]["launches"],
                 "centerhead_d1": heads["centerhead_d1"]["launches"],
                 "wnms": heads["wnms"]["launches"],
                 "centerhead_train": heads["centerhead_train"]["launches"][
                     "window_mha"],
                 "centerhead_d1_train": heads["centerhead_d1_train"][
                     "launches"]["window_mha"],
                 "fsd_sst": heads["fsd_sst"]["launches"],
                 "fsd_sst_loss": heads["fsd_sst_loss"]["launches"][
                     "window_mha"],
                 "fsd_sst_pretrain": heads["fsd_sst_pretrain"]["launches"][
                     "window_mha"]}
    center_rows = heads["centerhead"]["shapes"]
    fsd_sst_rows = heads["fsd_sst"]["shapes"]
    torch.cuda.empty_cache()
    pp = phase_pointpillars(device)
    pp["card"] = card
    enc, dyn = pp["second_encoder"], pp["dynamic_pillars"]
    # phase 24's PointPillars runs, each counted from 0: no hand-written
    # kernel on their path (every count held at 0)
    pp_runs = ("pointpillars", "pointpillars_train_cli",
               "pointpillars_test_cli")
    # phase 22's runs, each counted from 0: (name, launches by kind)
    off_runs = {"offline_fsd_test": offline["fsd"]["launches"],
                "offline_fsdpp_train": off_fsdpp["launches"],
                "offline_fsdpp_resume": off_fsdpp["resume_launches"],
                "offline_fsdpp_sequential": off_seq["launches"],
                "offline_ctrl_train": off_ctrl["train_launches"],
                "offline_ctrl_predict": off_ctrl["launches"]}
    group_keys = ("nusc", "argo_fsdv2", "argo_fsd", "fsd_3f")
    trained = ("nusc", "argo_fsdv2", "argo_fsd")

    def per_frame(rows, calls_key):
        """Each timed shape times its launches per frame, summed."""
        return {k: sum(r[k] * r[calls_key] for r in rows)
                for k in ("ms", "plain_ms", "bound_ms")}

    def bound_by(rows, calls_key):
        by = Counter()
        for r in rows:
            by[r["bound_by"]] += r["bound_ms"] * r[calls_key]
        return by.most_common(1)[0][0]

    sr_frame, sr_frame_f32 = ({k: sum(r[k] * r[calls] for r in shapes)
                               for k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms", "host_ms")}
                              for calls in ("calls_per_frame",
                                            "calls_per_frame_f32_build"))
    mha_rows = list(mha_shapes.values())
    mha_frame = per_frame(mha_rows, "calls_per_frame")
    # counted in the dense bf16 path's run (phase 4), the float32 build's
    # predicts (phase 5), the batch-4 run, the bf16 and float32 train runs
    # (phase 12), the sparse path's run (phase 7) and its train run (phase
    # 11), each from 0
    runs = {"dense_bev": launches, "dense_bev_f32": f32_launches,
            "dense_bev_b4": batch4["launches"],
            "dense_bev_train": (dense_train["launches"]["sorted_reduce"],
                                dense_train["launches"]["segment_offsets"]),
            "dense_bev_f32_train": (
                dense_train_f32["launches"]["sorted_reduce"],
                dense_train_f32["launches"]["segment_offsets"]),
            "sparse": sr_sparse_launches,
            "sparse_train": (train["launches"]["sorted_reduce"],
                             train["launches"]["segment_offsets"]),
            "fsdv2_two_stage": fsdv2_ts["launches"]["sorted_reduce"],
            "fsdv2_two_stage_loss": (
                fsdv2_ts["loss_launches"]["sorted_reduce"],
                fsdv2_ts["loss_launches"]["segment_offsets"]),
            # phase 21: the grouped and multi-sweep configs leave the VFE's
            # sorted reduce off, as JAX's do
            **{f"group_{k}": (groups[k]["launches"]["sorted_reduce"], 0)
               for k in group_keys},
            **{f"group_{k}_loss": (groups[k]["loss_launches"][
                "sorted_reduce"], 0) for k in trained},
            # phase 22: FSD, FSD++ and CTRL leave it off, as JAX's do
            **{k: (v.get("sorted_reduce", 0), 0)
               for k, v in off_runs.items()},
            # phase 23: the SST VFEs leave it off (held to 0 per path)
            **{f"heads_{k}": (0, 0) for k in head_runs},
            # phase 24: PointPillars' hard voxels need none; the dynamic
            # pillar VFE's sum and max share one offsets launch
            **{k: (0, 0) for k in pp_runs},
            "dynamic_pillars": (sum(dyn["launches"].values()),
                                dyn["offsets_launches"])}
    sr_launches = {k: v[0] for k, v in runs.items()}
    # the conv kernel's launches in each path's run, each counted from 0
    conv_by_path = {
        "sparse": conv_launches,
        "sparse_train": train["launches"]["sparse_conv_gemm"],
        "fsd": fsd["launches"],
        "fsd_train": fsd_train["launches"]["sparse_conv_gemm"],
        "fsdpp": fsdpp["launches"],
        "fsdpp_train": fsdpp_train["launches"]["sparse_conv_gemm"],
        "ctrl": ctrl["launches"],
        "ctrl_data_path": ctrl["data_path"]["launches"],
        "ctrl_train": ctrl["train"]["launches"]["sparse_conv_gemm"],
        "fsdv2_two_stage": fsdv2_ts["launches"]["sparse_conv_gemm"],
        "fsdv2_two_stage_loss": (fsdv2_ts["loss_launches"]["forward"]
                                 + fsdv2_ts["loss_launches"].get("dgrad",
                                                                 0)),
        # the CLIs (phase 20): each run's forward, recompute and
        # input-gradient launches
        **{f"cli_{k}": sum(v.get(kind, 0) for kind in
                           ("forward", "recompute", "dgrad"))
           for k, v in cli["launches"].items() if k != "test_sst_bf16"},
        # the group-sampling and multi-sweep paths (phase 21): predict, and
        # each loss's forward, recompute and input-gradient launches
        **{f"group_{k}": groups[k]["launches"]["sparse_conv_gemm"]
           for k in group_keys},
        **{f"group_{k}_loss": sum(groups[k]["loss_launches"][kind] for kind
                                  in ("forward", "recompute", "dgrad"))
           for k in trained},
        # the offline workflows (phase 22): each run's forward, recompute
        # and input-gradient launches
        **{k: sum(v.get(kind, 0) for kind in ("forward", "recompute",
                                              "dgrad"))
           for k, v in off_runs.items()},
        # phase 23: no sparse conv on the SST-head and SST-encoder paths
        **{f"heads_{k}": 0 for k in head_runs},
        # phase 24: SECOND's encoder forward (12 convs: 8 subm, 3 strided,
        # the 3-tap zdown), its loss + backward (12 forward, 11 input
        # gradient); none on PointPillars
        **{k: 0 for k in pp_runs},
        "second_encoder": sum(int(v) for v in enc["launches"][
            "forward"].values()),
        "second_encoder_train": sum(enc["launches"]["train"].values())}
    dw_by_path = {
        "sparse_train": train["launches"]["sparse_conv_dw"],
        "fsd_train": fsd_train["launches"]["sparse_conv_dw"],
        "fsdpp_train": fsdpp_train["launches"]["sparse_conv_dw"],
        "ctrl_train": ctrl["train"]["launches"]["sparse_conv_dw"],
        "fsdv2_two_stage_loss": fsdv2_ts["loss_launches"]["dw"],
        "cli_train": cli["launches"]["train"]["dw"],
        "cli_resume": cli["launches"]["resume"]["dw"],
        "cli_nusc_train": cli["launches"]["nusc_train"]["dw"],
        "cli_nusc_resume": cli["launches"]["nusc_resume"]["dw"],
        **{f"group_{k}_loss": groups[k]["loss_launches"]["dw"]
           for k in trained},
        **{k: off_runs[k]["dw"] for k in ("offline_fsdpp_train",
                                          "offline_fsdpp_resume",
                                          "offline_ctrl_train")},
        **{f"heads_{k}": 0 for k in head_runs},
        **{k: 0 for k in pp_runs},
        "second_encoder_train": enc["launches"]["dw"]}
    off_launches = {k: v[1] for k, v in runs.items()}
    summary = {"kernels": [{
        "name": "sorted_segment_reduce",
        "route": "cuda",
        "source": "sst_tpu_torch/csrc/sorted_reduce.cu",
        "replaces": "sst_tpu/ops/sorted_reduce.py:72",
        "launches": sum(sr_launches.values()),
        "launches_by_path": sr_launches,
        "max_abs_err": max_err,
        # per frame of the main path (the bf16 dense build; the sparse
        # build's segmentor VFE is the float32 one): each timed shape times
        # its launches per frame, as counted in phase 4, over the frame's
        # one offsets array (the segment_offsets entry)
        "ms": sr_frame["ms"],
        "plain_ms": sr_frame["plain_ms"],
        "bound_ms": sr_frame["bound_ms"],
        "bound_by": bound_by(shapes, "calls_per_frame"),
        # the same per frame of the float32 builds (phase 5's split)
        "per_frame_f32_build": sr_frame_f32,
        # one torch.segment_reduce call per reduction, over the same rows
        # with lengths from the same offsets; a yardstick only (-inf for an
        # empty max, non-finite maxima kept)
        "library_ms": sr_frame["library_ms"],
        "library": "torch.segment_reduce",
        # the wrapper's host time (Python, checks, ctypes, launch) per frame
        "host_ms": sr_frame["host_ms"],
        "shapes": shapes,
        # phase 24: the dynamic pillar VFE's sum (C = 3) and max (C = 64)
        # per frame at the PointPillars grid
        **{f"dynamic_pillars_{k}_per_frame": sum(r[k] for r in dyn["shapes"])
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "dynamic_pillars_bound_by": bound_by(
            [dict(r, calls=1) for r in dyn["shapes"]], "calls"),
        "dynamic_pillars_max_abs_err": dyn["max_abs_err"],
        "dynamic_pillars_shapes": dyn["shapes"],
    }, {
        "name": "segment_offsets",
        "route": "cuda",
        "source": "sst_tpu_torch/csrc/sorted_reduce.cu",
        # the segment bounds that the TPU kernel found per block
        "replaces": "sst_tpu/ops/sorted_reduce.py:72",
        "launches": sum(off_launches.values()),
        "launches_by_path": off_launches,
        "max_abs_err": offsets_rec["max_abs_err"],
        # per frame: one launch, shared by the frame's three reductions
        "ms": offsets_rec["ms"],
        "plain_ms": offsets_rec["plain_ms"],
        "bound_ms": offsets_rec["bound_ms"],
        "bound_by": offsets_rec["bound_by"],
        # the twin is one torch.searchsorted call
        "library_ms": offsets_rec["plain_ms"],
        "library": "torch.searchsorted",
        "host_ms": offsets_rec["host_ms"],
        "shapes": [offsets_rec],
    }, {
        "name": "sparse_conv_gemm",
        "route": "cuda",
        "source": "sst_tpu_torch/csrc/sparse_conv_gemm.cu",
        "replaces": "sst_tpu/ops/sparse_conv_pallas.py:375",
        # predict (phase 7), train (phase 11: forward, recompute and
        # input-gradient launches), FSD predict (phase 14) and FSD train
        # (phase 15, the same three kinds), each counted from 0
        "launches": sum(conv_by_path.values()),
        "launches_by_path": conv_by_path,
        "launches_per_fsdpp_train_step": {
            k: v for k, v in fsdpp_train["launches_per_step"].items()
            if k in ("forward", "recompute", "dgrad")},
        "launches_per_fsd_train_step": {
            k: v for k, v in fsd_train["launches_per_step"].items()
            if k in ("forward", "recompute", "dgrad")},
        "max_abs_err": max(conv_err, dgrad_err, fsd["max_abs_err"],
                           fsd_train["dgrad_err"], fsdpp["max_abs_err"],
                           fsdpp_train["dgrad_err"], ctrl["max_abs_err"],
                           ctrl["train"]["dgrad_err"],
                           fsdv2_ts["max_abs_err"], fsdv2_ts["dgrad_err"],
                           *(groups[k]["max_abs_err"] for k in group_keys),
                           *(groups[k]["dgrad_err"] for k in trained),
                           off_fsdpp["max_abs_err"], off_fsdpp["dgrad_err"],
                           off_seq["max_abs_err"], off_ctrl["max_abs_err"],
                           enc["conv_max_abs_err"],
                           enc["dgrad_max_abs_err"]),
        "dgrad_max_abs_err": max(dgrad_err, fsd_train["dgrad_err"],
                                 fsdpp_train["dgrad_err"],
                                 ctrl["train"]["dgrad_err"],
                                 fsdv2_ts["dgrad_err"],
                                 *(groups[k]["dgrad_err"] for k in trained),
                                 off_fsdpp["dgrad_err"]),
        # per frame of the sparse path: each of its convs at the time of
        # its rulebook and widths (phase 6)
        "ms": conv_per_frame["ms"],
        "plain_ms": conv_per_frame["plain_ms"],
        "bound_ms": conv_per_frame["bound_ms"],
        "bound_by": bound_by(conv_shapes, "convs_per_frame"),
        # the rulebook layer: the row schedules of the frame's tables
        "schedule_ms_per_frame": conv_per_frame["schedule_ms"],
        "work_shares": conv_per_frame["shares"],
        # no single PyTorch call gathers through a neighbour table and
        # multiplies per tap
        "library_ms": None,
        "shapes": conv_shapes,
        # the input gradient per train step: this kernel over the
        # transposed tables (phase 10)
        "dgrad_ms_per_step": dw_step["dgrad_ms"],
        "dgrad_plain_ms_per_step": dw_step["dgrad_plain_ms"],
        # per frame of FSD (phase 14): each of its 39 convs at the time of
        # its recorded input, rulebook and widths
        "fsd_ms_per_frame": fsd["per_frame"]["ms"],
        "fsd_plain_ms_per_frame": fsd["per_frame"]["plain_ms"],
        "fsd_bound_ms_per_frame": fsd["per_frame"]["bound_ms"],
        "fsd_bound_by": bound_by(fsd["shapes"], "convs_per_frame"),
        "fsd_max_abs_err": fsd["max_abs_err"],
        "fsd_shapes": fsd.pop("shapes"),
        # the input gradient per FSD train step (phase 15): this kernel over
        # the transposed tables of each of its 39 convs
        "fsd_train_dgrad_ms_per_step": fsd_train["dw_step"]["dgrad_ms"],
        "fsd_train_dgrad_plain_ms_per_step": fsd_train["dw_step"][
            "dgrad_plain_ms"],
        # per frame of FSD++ (phase 17): its 39 convs at the half caps
        "fsdpp_ms_per_frame": fsdpp["per_frame"]["ms"],
        "fsdpp_plain_ms_per_frame": fsdpp["per_frame"]["plain_ms"],
        "fsdpp_bound_ms_per_frame": fsdpp["per_frame"]["bound_ms"],
        "fsdpp_bound_by": bound_by(fsdpp["shapes"], "convs_per_frame"),
        "fsdpp_shapes": fsdpp.pop("shapes"),
        "fsdpp_train_dgrad_ms_per_step": fsdpp_train["dw_step"]["dgrad_ms"],
        "fsdpp_train_dgrad_plain_ms_per_step": fsdpp_train["dw_step"][
            "dgrad_plain_ms"],
        # per CTRL track (phase 18): its 18 convs, and the input gradient
        # per CTRL train step (2 tracks)
        **{f"ctrl_{k}_per_track": v for k, v in ctrl["per_track"].items()},
        "ctrl_bound_by": bound_by(ctrl["shapes"], "convs_per_frame"),
        "ctrl_shapes": ctrl.pop("shapes"),
        "ctrl_train_dgrad_ms_per_step": ctrl["train"]["dw_step"]["dgrad_ms"],
        "ctrl_train_dgrad_plain_ms_per_step": ctrl["train"]["dw_step"][
            "dgrad_plain_ms"],
        # per frame of the FSDV2 two stage (phase 19): its 58 convs, and the
        # input gradient of its one loss
        **{f"fsdv2_two_stage_{k}_per_frame": v
           for k, v in fsdv2_ts["per_frame"].items()},
        "fsdv2_two_stage_bound_by": bound_by(fsdv2_ts["shapes"],
                                             "convs_per_frame"),
        "fsdv2_two_stage_shapes": fsdv2_ts.pop("shapes"),
        "fsdv2_two_stage_loss_dgrad_ms": fsdv2_ts["dw_step"]["dgrad_ms"],
        "fsdv2_two_stage_loss_dgrad_plain_ms": fsdv2_ts["dw_step"][
            "dgrad_plain_ms"],
        # per frame of each phase-21 path: its convs at the times of frame
        # 0's recorded inputs, and the input gradient of its one loss
        **{f"group_{k}_{m}_per_frame": groups[k]["per_frame"][m]
           for k in group_keys for m in ("ms", "plain_ms", "bound_ms")},
        **{f"group_{k}_bound_by": bound_by(groups[k].pop("shapes"),
                                           "convs_per_frame")
           for k in group_keys},
        **{f"group_{k}_loss_{m}": groups[k]["dw_step"][m]
           for k in trained for m in ("dgrad_ms", "dgrad_plain_ms")},
        # the offline paths (phase 22): the FSD++ train CLI's step (its
        # forward convs and input gradient at a step's recorded inputs),
        # FSD++'s sequential predict per frame and CTRL's per track
        **{f"offline_fsdpp_train_{m}_per_step": off_fsdpp["per_step"][m]
           for m in ("ms", "plain_ms", "bound_ms")},
        "offline_fsdpp_train_bound_by": bound_by(off_fsdpp.pop("shapes"),
                                                 "convs_per_frame"),
        "offline_fsdpp_train_dgrad_ms_per_step": off_fsdpp["dw_step"][
            "dgrad_ms"],
        "offline_fsdpp_train_dgrad_plain_ms_per_step": off_fsdpp["dw_step"][
            "dgrad_plain_ms"],
        **{f"offline_fsdpp_sequential_{m}_per_frame": off_seq["per_frame"][m]
           for m in ("ms", "plain_ms", "bound_ms")},
        "offline_fsdpp_sequential_bound_by": bound_by(
            off_seq.pop("shapes"), "convs_per_frame"),
        **{f"offline_ctrl_{m}_per_track": off_ctrl["per_track"][m]
           for m in ("ms", "plain_ms", "bound_ms")},
        "offline_ctrl_bound_by": bound_by(off_ctrl.pop("shapes"),
                                          "convs_per_frame"),
        # the wrapper's host time per call, its entry point bound once and
        # set on every call (phase 18, the widest CTRL conv)
        "host_us": WRAPPER_HOST_US.get("sparse_conv_gemm"),
        # per forward of SECOND's encoder (phase 24): its 12 convs (27 taps,
        # and 3 for conv_out) at the times of their recorded inputs, and
        # the input gradient of its one loss
        **{f"second_encoder_{k}_per_forward": enc["conv_per_forward"][k]
           for k in ("ms", "plain_ms", "bound_ms")},
        "second_encoder_bound_by": bound_by(enc["conv_shapes"],
                                            "convs_per_frame"),
        "second_encoder_shapes": enc.pop("conv_shapes"),
        "second_encoder_loss_dgrad_ms": enc["dw_step"]["dgrad_ms"],
        "second_encoder_loss_dgrad_plain_ms": enc["dw_step"][
            "dgrad_plain_ms"],
    }, {
        "name": "sparse_conv_dw",
        "route": "cuda",
        "source": "sst_tpu_torch/csrc/sparse_conv_dw.cu",
        "replaces": "sst_tpu/ops/sparse_conv_pallas.py:397",
        # the sparse step (phase 11) and the FSD step (phase 15), each
        # counted from 0
        "launches": sum(dw_by_path.values()),
        "launches_by_path": dw_by_path,
        "max_abs_err": max(dw_err, fsd_train["dw_err"],
                           fsdpp_train["dw_err"], ctrl["train"]["dw_err"],
                           fsdv2_ts["dw_err"],
                           *(groups[k]["dw_err"] for k in trained),
                           off_fsdpp["dw_err"], enc["dw_max_abs_err"]),
        # per train step: each of the 58 convs at the time of its rulebook
        # and widths (phase 10)
        "ms": dw_step["ms"],
        "plain_ms": dw_step["plain_ms"],
        "bound_ms": dw_step["bound_ms"],
        "bound_by": bound_by(dw_shapes, "convs_per_step"),
        # no single PyTorch call gathers through a neighbour table and
        # multiplies per tap
        "library_ms": None,
        # the wrapper's host time per step, and the executed share of the
        # (row, tap) x Cin x Cout work over the forward's schedule
        "host_ms": dw_step["host_ms"],
        "work_shares": dw_step["shares"],
        "shapes": dw_shapes,
        # per FSD train step (phase 15): each of its 39 convs at the time of
        # its rulebook and widths, inputs recorded from a pretrain=False
        # step
        "fsd_train_ms_per_step": fsd_train["dw_step"]["ms"],
        "fsd_train_plain_ms_per_step": fsd_train["dw_step"]["plain_ms"],
        "fsd_train_bound_ms_per_step": fsd_train["dw_step"]["bound_ms"],
        "fsd_train_bound_by": bound_by(fsd_train["dw_shapes"],
                                       "convs_per_step"),
        "fsd_train_work_shares": fsd_train["dw_step"]["shares"],
        "fsd_train_shapes": fsd_train.pop("dw_shapes"),
        # per FSD++ train step (phase 17): its 39 convs at the half caps
        "fsdpp_train_ms_per_step": fsdpp_train["dw_step"]["ms"],
        "fsdpp_train_plain_ms_per_step": fsdpp_train["dw_step"]["plain_ms"],
        "fsdpp_train_bound_ms_per_step": fsdpp_train["dw_step"]["bound_ms"],
        "fsdpp_train_bound_by": bound_by(fsdpp_train["dw_shapes"],
                                         "convs_per_step"),
        "fsdpp_train_shapes": fsdpp_train.pop("dw_shapes"),
        # per CTRL train step (phase 18, 2 tracks) and the FSDV2 two stage's
        # one loss (phase 19)
        **{f"ctrl_train_{k}_per_step": ctrl["train"]["dw_step"][k]
           for k in ("ms", "plain_ms", "bound_ms")},
        "ctrl_train_bound_by": bound_by(ctrl["train"]["dw_shapes"],
                                        "convs_per_step"),
        "ctrl_train_shapes": ctrl["train"].pop("dw_shapes"),
        **{f"fsdv2_two_stage_loss_{k}": fsdv2_ts["dw_step"][k]
           for k in ("ms", "plain_ms", "bound_ms")},
        "fsdv2_two_stage_loss_bound_by": bound_by(fsdv2_ts["dw_shapes"],
                                                  "convs_per_step"),
        "fsdv2_two_stage_loss_shapes": fsdv2_ts.pop("dw_shapes"),
        # each phase-21 path's one loss: its convs' dW at the times of the
        # step's recorded inputs
        **{f"group_{k}_loss_{m}": groups[k]["dw_step"][m]
           for k in trained for m in ("ms", "plain_ms", "bound_ms")},
        **{f"group_{k}_loss_bound_by": bound_by(groups[k].pop("dw_shapes"),
                                                "convs_per_step")
           for k in trained},
        # the FSD++ train CLI's step (phase 22): its convs' dW at the
        # recorded inputs of a step on the incremental set
        **{f"offline_fsdpp_train_{m}_per_step": off_fsdpp["dw_step"][m]
           for m in ("ms", "plain_ms", "bound_ms")},
        "offline_fsdpp_train_bound_by": bound_by(off_fsdpp.pop("dw_shapes"),
                                                 "convs_per_step"),
        # SECOND's encoder's one loss (phase 24): the dW of its 12 convs
        # (the 3-tap conv_out's [3, 64, 128] among them)
        **{f"second_encoder_loss_{k}": enc["dw_step"][k]
           for k in ("ms", "plain_ms", "bound_ms")},
        "second_encoder_loss_bound_by": bound_by(enc.pop("dw_shapes"),
                                                 "convs_per_step"),
    }, {
        "name": "window_mha",
        "route": "cuda",
        "source": "sst_tpu_torch/csrc/window_mha.cu",
        "replaces": "sst_tpu/ops/pallas_attention.py:25",
        # predict (phase 9), train (phase 13), and both at bf16 compute
        # (phase 16), each counted from 0
        "launches": (mha_launches + sst_train["launches"]["window_mha"]
                     + sst_bf16["launches"]
                     + sst_bf16_train["launches"]["window_mha"]
                     + cli["launches"]["test_sst_bf16"]["window_mha"]
                     + sum(head_runs.values())),
        "launches_by_path": {"sst": mha_launches,
                             "sst_train": sst_train["launches"][
                                 "window_mha"],
                             "sst_bf16": sst_bf16["launches"],
                             "sst_bf16_train": sst_bf16_train["launches"][
                                 "window_mha"],
                             # the test CLI on the bf16 SST config (phase
                             # 20)
                             "cli_test_sst_bf16": cli["launches"][
                                 "test_sst_bf16"]["window_mha"],
                             # the CenterHead, weighted-NMS and SST-encoder
                             # paths (phase 23)
                             **{f"heads_{k}": v
                                for k, v in head_runs.items()},
                             # phase 24: none on the PointPillars runs
                             **{k: 0 for k in pp_runs}},
        "launches_per_train_step": sst_train[
            "launches_per_step_expected"],
        "max_abs_err": max(mha_err, sst_train["mha_max_abs_err"],
                           sst_bf16["max_abs_err"],
                           sst_bf16_train["mha_max_abs_err"],
                           heads["centerhead"]["max_abs_err"],
                           heads["centerhead_train"]["mha_max_abs_err"],
                           heads["fsd_sst"]["max_abs_err"]),
        # per frame of the SST path: the sum over frame 0's (layer, bucket)
        # inputs, each timed and bounded on its own pad (phase 8)
        "ms": mha_frame["ms"],
        "plain_ms": mha_frame["plain_ms"],
        "bound_ms": mha_frame["bound_ms"],
        "bound_by": bound_by(mha_rows, "calls_per_frame"),
        "library_ms": sum(r["library_ms"] * r["calls_per_frame"]
                          for r in mha_rows),
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "library_max_abs_err_vs_twin": sdpa_err,
        # per SST train step (phase 13): the kernel forward over step 0's
        # inputs, and the ported backward (torch ops, no hand kernel in
        # JAX either)
        "train_ms_per_step": sst_train["mha_per_step"]["ms"],
        "train_plain_ms_per_step": sst_train["mha_per_step"]["plain_ms"],
        "train_bound_ms_per_step": sst_train["mha_per_step"]["bound_ms"],
        "train_library_ms_per_step": sst_train["mha_per_step"][
            "library_ms"],
        "backward_ms_per_step": sst_train["mha_per_step"]["backward_ms"],
        "grad_err_vs_f64": sst_train["mha_grad_err"],
        # the wrapper's host time (Python, checks, ctypes, launch) per frame
        "host_ms": sum(r["host_ms"] * r["calls_per_frame"] for r in mha_rows),
        # the wrapper's host time per call, its entry point bound once and
        # set on every call (phase 8, one input)
        "host_us": WRAPPER_HOST_US.get("window_mha"),
        "shapes": mha_rows,
        # per frame of the bf16 SST build (phase 16): its own frame 0's
        # inputs, timed and bounded as phase 8's
        **{f"sst_bf16_{k}_per_frame": v for k, v in per_frame(
            sst_bf16["shapes"], "calls_per_frame").items()},
        "sst_bf16_library_ms_per_frame": sum(
            r["library_ms"] * r["calls_per_frame"]
            for r in sst_bf16["shapes"]),
        "sst_bf16_train_ms_per_step": sst_bf16_train["mha_per_step"]["ms"],
        "sst_bf16_train_backward_ms_per_step": sst_bf16_train[
            "mha_per_step"]["backward_ms"],
        # per frame of the CenterHead SST config and of FSD's SST encoder
        # (phase 23): the sum over frame 0's inputs, each timed and bounded
        # as phase 8's
        **{f"centerhead_{k}_per_frame": sum(r[k] * r["inputs"]
                                            for r in center_rows)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "centerhead_bound_by": bound_by(
            center_rows, "inputs"),
        **{f"fsd_sst_{k}_per_frame": sum(r[k] * r["inputs"]
                                         for r in fsd_sst_rows)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "fsd_sst_bound_by": bound_by(fsd_sst_rows, "inputs"),
    }], "build_s": build_s, "nvcc_s": nvcc_s, "predict_ms": {
        "dense_bev_bf16_sorted_reduce_kernel": lat["bf16 kernel"],
        "dense_bev_bf16_scatter": lat["bf16 scatter"],
        "dense_bev_f32_sorted_reduce_kernel": lat["f32 kernel"],
        "dense_bev_bf16_batch4_per_frame": batch4["ms_per_frame"],
        "sparse": sparse_lat, "sst": sst_lat,
        "fsd": fsd["latency"]["median"],
        "fsd_skip_rcnn": fsd["latency_skip_rcnn"]["median"],
        "fsd_dense": fsd["dense"]["latency"]["median"],
        "sst_bf16": sst_bf16["latency"],
        "sst_bf16_rotation": sst_bf16["latency_rotation"],
        "fsdpp": fsdpp["latency"]["median"],
        "fsdpp_skip_rcnn": fsdpp["latency_skip_rcnn"]["median"],
        "fsdpp_dense": fsdpp["dense"]["latency"]["median"],
        "ctrl": ctrl["latency"]["median"],
        "fsdv2_two_stage": fsdv2_ts["latency"]["median"],
        "fsdv2_two_stage_skip_rcnn": fsdv2_ts["latency_skip_rcnn"][
            "median"],
        **{f"group_{k}": groups[k]["latency"]["median"]
           for k in group_keys},
        "offline_fsdpp_sequential": statistics.median(off_seq["predict_ms"]),
        "offline_ctrl_per_track": statistics.median(off_ctrl["predict_ms"]),
        "centerhead": heads["centerhead"]["latency_ms"],
        "centerhead_d1": heads["centerhead_d1"]["latency_ms"],
        "wnms": heads["wnms"]["latency_ms"],
        "fsd_sst": heads["fsd_sst"]["latency"]["median"],
        "benchmark_centerhead_p50": heads["tools"]["benchmark"][
            "p50_latency_ms"],
        "pointpillars": pp["predict"]["latency"]["median"]},
        "sst_capacity_counters": sst_diags,
        "train": train,
        "train_dense_bev": dense_train,
        "train_dense_bev_f32": dense_train_f32,
        "train_sst": sst_train,
        "fsd": fsd,
        "train_fsd": fsd_train,
        "sst_bf16": sst_bf16,
        "train_sst_bf16": sst_bf16_train,
        "fsdpp": fsdpp,
        "train_fsdpp": fsdpp_train,
        "ctrl": ctrl,
        "fsdv2_two_stage": fsdv2_ts,
        "cli": cli,
        "groups": groups,
        "offline": offline,
        "sst_heads": heads,
        "pointpillars": pp,
        "wrapper_host_us": WRAPPER_HOST_US,
        "card": card}
    print(json.dumps(summary), flush=True)
    # one card drove every phase
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
