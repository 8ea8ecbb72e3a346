"""Flagship model builders and the synthetic frame generators (counterpart
of ``sst_tpu/flagship.py``: the SST, FSDv2 and tiny FSD, FSD++ and CTRL
builds; the full-width FSD, FSD++, FSDV2 two stage and CTRL are built from
their configs, ``utils/builders.py``).

Every builder returns its module on ``device``, the card by default, and
raises if there is no card and the caller named no other device
(:func:`on_device`)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from sst_tpu_torch.models import DynamicVoxelNet, PointBatch
from sst_tpu_torch.models.ctrl import TrackletBatch, TrackletDetector
from sst_tpu_torch.models.fsd.fsdpp import TemporalBatch, TwoStageFSDPP
from sst_tpu_torch.models.fsd.fsdv2 import FSDV2Caps, SingleStageFSDV2
from sst_tpu_torch.models.fsd.single_stage import FSDCaps, SingleStageFSD
from sst_tpu_torch.models.fsd.two_stage import FSD
from sst_tpu_torch.models.fsd.vote_segmentor import VoteSegHead
from sst_tpu_torch.models.sparse_unet import SparseConvLayer
from sst_tpu_torch.ops.window import BucketSpec


def sst_waymo(max_points: int = 196608, max_voxels: int = 65536,
              train_buckets: bool = True, dtype=torch.float32,
              num_point_features: int = 5, device="cuda"):
    """Full-scale SST-Waymo (configs/sst/sst_waymoD5_1x_3class_8heads.py):
    the widths and caps of ``sst_tpu/flagship.py sst_waymo``. 468x468
    pillars of 0.32 m, 12x12 windows, at most 2,048 windows per shift;
    drop buckets (max tokens, window cap) (30, 1536), (60, 1280),
    (100, 768) for training and (30, 896), (60, 768), (100, 320),
    (144, 160) at test time (``train_buckets=False``); a 6-block d128,
    8-head, FFN-256 SSTv2 with three attached 3x3 convs (the last at
    dilation 2), SECONDFPN(384) and a 3-class Anchor3DHead with 2
    rotations. Every window attention runs the hand-written window MHA
    kernel on the card.

    ``dtype`` is the compute dtype (flax's policy: float32 parameters,
    products in ``dtype``); float32 by default, as JAX's builder, and
    ``torch.bfloat16`` as ``bench.py bench_sst`` and
    configs/sst/sst_waymoD5_3class_bf16.py run it. The attention is bf16
    inside at either dtype, as on the JAX Pallas path. Each SST block is
    rematerialised in training (``remat_blocks``, JAX's default).
    ``max_points`` is the model's point cap (pass it to
    ``apis.prepare_batch`` for frames beyond its 65,536 default);
    ``num_point_features`` the width of a point row.

    It trains with the training buckets (``loss`` with a voxel-shuffle
    generator; ``train/step.py train_step``); the config's optimizer is
    ``train/state.py make_optimizer`` at base_lr 1e-5, weight decay 0.05,
    clip 10 (configs/sst/sst_waymoD5_3class.py)."""
    if train_buckets:
        buckets = (
            BucketSpec(30, 0, 30, 1536),
            BucketSpec(60, 30, 60, 1280),
            BucketSpec(100, 60, 100000, 768),
        )
    else:
        buckets = (
            BucketSpec(30, 0, 30, 896),
            BucketSpec(60, 30, 60, 768),
            BucketSpec(100, 60, 100, 320),
            BucketSpec(144, 100, 100000, 160),
        )
    return on_device(DynamicVoxelNet(
        num_point_features=num_point_features,
        voxel_size=(0.32, 0.32, 6.0),
        point_cloud_range=(-74.88, -74.88, -2.0, 74.88, 74.88, 4.0),
        max_voxels=max_voxels,
        max_total_windows=2048,
        window_shape=(12, 12),
        buckets=buckets,
        vfe=dict(feat_channels=(64, 128)),
        backbone=dict(
            d_model=(128,) * 6, nhead=(8,) * 6, num_blocks=6,
            dim_feedforward=(256,) * 6, num_attached_conv=3,
            conv_kwargs=(
                {"kernel_size": 3, "dilation": 1},
                {"kernel_size": 3, "dilation": 1},
                {"kernel_size": 3, "dilation": 2},
            ),
            conv_out_channel=128, in_channel=128,
        ),
        neck=dict(out_channels=(384,)),
        head=dict(num_classes=3, feat_channels=384),
        dtype=dtype,
    ), device, max_points)


def tiny_sst(grid: int = 32, num_point_features: int = 3,
             dtype=torch.float32, device="cuda"):
    """Small SST for CPU tests (same config as the JAX ``tiny_sst``, no
    remat), at compute ``dtype``, on ``device``."""
    half = grid * 0.4 / 2
    return on_device(DynamicVoxelNet(
        num_point_features=num_point_features,
        voxel_size=(0.4, 0.4, 6.0),
        point_cloud_range=(-half, -half, -2.0, half, half, 4.0),
        max_voxels=512,
        max_total_windows=128,
        window_shape=(4, 4),
        buckets=(BucketSpec(8, 0, 8, 64), BucketSpec(16, 8, 100000, 32)),
        vfe=dict(feat_channels=(16, 32)),
        backbone=dict(
            d_model=(32, 32), nhead=(2, 2), num_blocks=2,
            dim_feedforward=(64, 64), num_attached_conv=1,
            conv_kwargs=({"kernel_size": 3, "dilation": 1},),
            conv_out_channel=32, in_channel=32, remat_blocks=False,
        ),
        neck=dict(out_channels=(64,)),
        head=dict(
            num_classes=3, feat_channels=64,
            anchor_ranges=(
                (-half, -half, -0.0345, half, half, -0.0345),
                (-half, -half, -0.1188, half, half, -0.1188),
                (-half, -half, 0.0, half, half, 0.0),
            ),
        ),
        test_cfg=dict(score_thr=0.1, nms_thr=0.25, nms_pre=64, max_num=32,
                      use_rotate_nms=True),
        dtype=dtype,
    ), device)


def tiny_batch(batch_size: int = 2, num_points: int = 512,
               seed: int = 0) -> PointBatch:
    """Uniform points in the ``tiny_sst`` range as numpy arrays,
    bit-identical to the JAX package's ``tiny_batch``."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (batch_size, num_points, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1, 2, (batch_size, num_points))
    g = 8
    boxes = np.concatenate(
        [
            rng.uniform(-5, 5, (batch_size, g, 2)),
            np.full((batch_size, g, 1), -0.1),
            rng.uniform(0.8, 4.0, (batch_size, g, 3)),
            rng.uniform(-np.pi, np.pi, (batch_size, g, 1)),
        ],
        -1,
    ).astype(np.float32)
    return PointBatch(
        points=pts,
        valid=np.ones((batch_size, num_points), bool),
        gt_boxes=boxes,
        gt_labels=rng.randint(0, 3, (batch_size, g)).astype(np.int32),
        gt_valid=np.ones((batch_size, g), bool),
    )


def fsdv2_waymo(max_points: int = 196608, dtype=None,
                as_rpn: bool = False, backbone: str = "dense_bev",
                num_point_features: int = 5, device="cuda"):
    """Full-scale FSDv2-Waymo (configs/fsdv2/fsdv2_waymo_1x.py): segmentor
    voxels 0.25x0.25x0.2 m over (-80, 80) m, 0.5 m virtual voxels.

    backbone="dense_bev" (default) is :func:`fsdv2_waymo_dense`.
    backbone="sparse" is the reference topology with the widths and caps of
    ``sst_tpu/flagship.py fsdv2_waymo``: a 6-level SimpleSparseUNet
    segmentor (level caps 131072, 204800, 98304, 32768, 8192, 2048; the
    k=3 / s=2 / p=1 downsample dilates, so level 1 needs more slots than
    level 0) and the sparse VirtualVoxelMixer over the 0.5 m union grid
    (caps 98304 / 49152 / 24576). Every sparse conv runs the hand-written
    sparse conv kernel on the GPU. As in the dense build, the segmentor's
    VFE sets ``use_sorted_reduce=True``: its 30x640x640 grid takes the
    sort-based voxel unique, so its three per-voxel reductions run the
    sorted segment reduce kernel too, in predict and in training. That is
    a declared difference from JAX's builder, which leaves the switch at
    its default (off): the same function up to f32 summation order, with
    the gradient of JAX's own sorted path (its custom vjp hands a tied
    maximum's gradient to the first row that holds it, where the scatter
    path splits it between them).

    ``dtype`` None gives each build JAX's default: bfloat16 compute for the
    dense-BEV build, float32 for the sparse one (``sst_tpu/flagship.py``
    builds its sparse flagship in float32; a bfloat16 sparse build raises
    NotImplementedError). ``max_points`` is the point cap
    ``apis.prepare_batch`` pads to; ``num_point_features`` is the width of a
    point row. The module is returned on ``device`` (see :func:`on_device`).
    """
    if backbone == "dense_bev":
        return fsdv2_waymo_dense(max_points=max_points, dtype=dtype,
                                 as_rpn=as_rpn,
                                 num_point_features=num_point_features,
                                 device=device)
    if backbone != "sparse":
        raise NotImplementedError(f"backbone={backbone!r}")
    dtype = dtype or torch.float32
    return on_device(SingleStageFSDV2(
        num_point_features=num_point_features,
        point_cloud_range=(-80.0, -80.0, -2.0, 80.0, 80.0, 4.0),
        virtual_voxel_size=(0.5, 0.5, 0.5),
        score_thresh=(0.3, 0.25, 0.25),
        caps=FSDV2Caps(
            fg_per_class=(8192, 4096, 4096),
            voxels=81920,
            union_voxels=98304,
            virtual_out=16384,
        ),
        multiscale_levels=(0, 1),
        ms_projector_hiddens=((128,), (128,)),
        ms_output_dim=128,
        mixer_type="sparse",
        segmentor=dict(
            voxel_size=(0.25, 0.25, 0.2),
            max_voxels=131072,
            unet_level_caps=(131072, 204800, 98304, 32768, 8192, 2048),
            unet_strides=((2, 2, 2),) * 5,
            unet_paddings=((1, 1, 1),) * 5,
            vfe=dict(feat_channels=(64, 64), mode="max",
                     use_sorted_reduce=True),
            unet=dict(
                in_channels=64, base_channels=64,
                encoder_channels=((128,), (128, 128), (128, 128),
                                  (128, 128, 128), (256, 256, 256),
                                  (256, 256, 256)),
                decoder_channels=((256, 256, 256), (256, 256, 128),
                                  (128, 128, 128), (128, 128, 128),
                                  (128, 128, 128), (128, 128, 128)),
                remat=True,
            ),
            head=dict(num_classes=3, hidden_dims=(128, 128)),
        ),
        vfe=dict(feat_channels=(64, 128), mode="max"),
        mixer=dict(
            base_channels=64, output_channels=128,
            encoder_channels=((64,), (64, 64), (64, 64)),
            decoder_channels=((64, 64, 64), (64, 64, 64), (64, 64, 64)),
            remat=True,
        ),
        head=dict(
            in_channel=128,
            shared_mlp_dims=(256, 256),
            common_attrs=(("center", 3, 2, 128), ("dim", 3, 2, 128),
                          ("rot", 2, 2, 128)),
            num_cls_layer=2,
            cls_hidden_dim=128,
        ),
        as_rpn=as_rpn,
        test_cfg=dict(score_thr=0.1, nms_thr=0.25, nms_pre=1024, max_num=500,
                      use_rotate_nms=True),
        dtype=dtype,
    ), device, max_points)


def fsdv2_waymo_dense(max_points: int = 196608, dtype=None,
                      as_rpn: bool = False, z_groups: int = 4,
                      cap_scale: int = 1, num_point_features: int = 5,
                      device="cuda"):
    """Full-scale FSDv2-Waymo, dense-BEV build: the same widths and caps as
    ``sst_tpu/flagship.py fsdv2_waymo_dense`` (segmentor at 0.25x0.25x0.2 m
    over (-80, 80) m, 2D UNet at 640² → 80², dense z-sliced mixer over the
    0.5 m virtual grid).

    The segmentor's VFE sets ``use_sorted_reduce=True``: its grid
    (30x640x640 cells) takes the sort-based voxel unique, so each of its
    three per-voxel reductions (the cluster-centre sum and two maxes over 64
    channels) runs as the hand-written sorted segment reduce kernel on the
    GPU. The JAX package leaves that switch off because of an A/B on another
    accelerator; whether it stays on here is decided by the GPU A/B that
    ``chip_smoke.py`` records. It is a declared difference from JAX's
    builder defaults: the same function up to f32 summation order, and in
    training the gradient of JAX's own sorted path (a tied maximum's
    gradient goes to the first row that holds it). The virtual-grid VFE
    takes the canvas unique, which yields no sort order, so it stays on
    scatters either way.

    ``dtype`` defaults to bfloat16, JAX's flagship policy: every Dense and
    conv computes in bfloat16 and the canvases and BEV maps are bfloat16,
    while the parameters, running statistics, gradients and optimizer state
    stay float32, the norms compute in float32, and the cluster-centre sums,
    box decode and losses are float32 where JAX's are. The segmentor VFE's
    two maxima then reduce bfloat16 rows through the kernel's bfloat16
    route; its cluster-centre sum stays float32. Pass
    ``dtype=torch.float32`` for the full-precision build. ``max_points`` is
    the point cap ``apis.prepare_batch`` pads to. The module is returned on
    ``device`` (see :func:`on_device`). It trains (``loss``,
    ``train/step.py train_step``) with the optimizer of
    configs/fsdv2/fsdv2_waymo_1x.py: ``train/state.py make_optimizer`` at
    base_lr 1e-5, weight decay 0.05, clip 10; like JAX's dense build,
    without rematerialisation.

    num_point_features: width of a point row (x, y, z + intensity,
    elongation for Waymo).

    cap_scale: every batch-global capacity (voxel, fg and virtual caps are
    flattened across the batch) times this; set it to the batch size for
    batched inference (``bench.py bench_fsdv2_b4`` runs 4)."""
    k = cap_scale
    dtype = dtype or torch.bfloat16
    return on_device(SingleStageFSDV2(
        num_point_features=num_point_features,
        point_cloud_range=(-80.0, -80.0, -2.0, 80.0, 80.0, 4.0),
        virtual_voxel_size=(0.5, 0.5, 0.5),
        score_thresh=(0.3, 0.25, 0.25),
        caps=FSDV2Caps(
            fg_per_class=(8192 * k, 4096 * k, 4096 * k),
            voxels=81920 * k,
            union_voxels=81920 * k,  # dense path: union slots == virtual slots
            virtual_out=16384 * k,
        ),
        multiscale_levels=(0, 1),  # decoder maps at 1/4 and 1/2 resolution
        ms_projector_hiddens=((128,), (128,)),
        ms_output_dim=128,
        mixer_type="dense_bev",
        segmentor=dict(
            voxel_size=(0.25, 0.25, 0.2),
            max_voxels=131072 * k,
            backbone="dense_bev",
            z_groups=z_groups,
            dense_pre_channels=24,
            dense_group_channels=24,
            vfe=dict(feat_channels=(64, 64), mode="max",
                     use_sorted_reduce=True),
            unet=dict(
                encoder_channels=((64, 64), (128, 128), (256, 256),
                                  (256, 256)),
                decoder_channels=(256, 128, 128),
                out_channels=128,
            ),
            head=dict(num_classes=3, hidden_dims=(128, 128)),
        ),
        vfe=dict(feat_channels=(64, 128), mode="max"),
        mixer=dict(
            z_channels=32, output_channels=128,
            encoder_channels=((128, 128), (128, 128)),
            decoder_channels=(128,),
        ),
        head=dict(
            in_channel=128,
            shared_mlp_dims=(256, 256),
            common_attrs=(("center", 3, 2, 128), ("dim", 3, 2, 128),
                          ("rot", 2, 2, 128)),
            num_cls_layer=2,
            cls_hidden_dim=128,
        ),
        as_rpn=as_rpn,
        test_cfg=dict(score_thr=0.1, nms_thr=0.25, nms_pre=1024, max_num=500,
                      use_rotate_nms=True),
        dtype=dtype,
    ), device, max_points)


def tiny_fsdv2_dense(grid: int = 16, z_groups: int = 2,
                     num_point_features: int = 3, segmentor_overrides=None,
                     dtype=torch.float32, device="cuda"):
    """Small dense-BEV FSDv2 for CPU tests (same config as the JAX
    ``tiny_fsdv2_dense``, float32 like it; ``dtype=torch.bfloat16`` is the
    counterpart of its ``.clone(dtype=jnp.bfloat16)``), on ``device``.
    ``segmentor_overrides`` updates the segmentor dict, e.g. a finer voxel
    so that its voxel unique sorts."""
    half = grid * 0.5 / 2
    segmentor = dict(
        voxel_size=(0.5, 0.5, 0.5),
        max_voxels=256,
        backbone="dense_bev",
        z_groups=z_groups,
        dense_group_channels=16,
        dense_pre_channels=16,
        vfe=dict(feat_channels=(16, 16), mode="max"),
        unet=dict(
            encoder_channels=((16, 16), (16, 16)),
            decoder_channels=(16,),
            out_channels=16,
        ),
        head=dict(num_classes=3, hidden_dims=(16, 16)),
    )
    segmentor.update(segmentor_overrides or {})
    return on_device(SingleStageFSDV2(
        num_point_features=num_point_features,
        point_cloud_range=(-half, -half, -2.0, half, half, 4.0),
        virtual_voxel_size=(0.5, 0.5, 0.5),
        score_thresh=(0.05, 0.05, 0.05),
        caps=FSDV2Caps(fg_per_class=(64, 32, 32), voxels=256,
                       union_voxels=256, virtual_out=64),
        multiscale_levels=(0,),
        ms_projector_hiddens=((16,),),
        ms_output_dim=16,
        mixer_type="dense_bev",
        segmentor=segmentor,
        vfe=dict(feat_channels=(16, 16), mode="max"),
        mixer=dict(z_channels=8, output_channels=16,
                   encoder_channels=((16, 16), (16, 16)),
                   decoder_channels=(16,)),
        head=dict(
            in_channel=16, shared_mlp_dims=(32,),
            common_attrs=(("center", 3, 1, 16), ("dim", 3, 1, 16),
                          ("rot", 2, 1, 16)),
            num_cls_layer=1, cls_hidden_dim=16,
        ),
        test_cfg=dict(score_thr=0.05, nms_thr=0.25, nms_pre=32, max_num=16,
                      use_rotate_nms=True),
        dtype=dtype,
    ), device)


def tiny_fsdv2_flagship(grid: int = 16, num_point_features: int = 3,
                        device="cuda"):
    """Small sparse-UNet FSDv2 for CPU tests (same config as the JAX
    ``tiny_fsdv2_flagship``), on ``device``."""
    half = grid * 0.5 / 2
    return on_device(SingleStageFSDV2(
        num_point_features=num_point_features,
        point_cloud_range=(-half, -half, -2.0, half, half, 4.0),
        virtual_voxel_size=(0.5, 0.5, 0.5),
        score_thresh=(0.05, 0.05, 0.05),
        caps=FSDV2Caps(fg_per_class=(64, 32, 32), voxels=256,
                       union_voxels=512, virtual_out=64),
        multiscale_levels=(0,),
        ms_projector_hiddens=((16,),),
        ms_output_dim=16,
        segmentor=dict(
            voxel_size=(0.5, 0.5, 0.5),
            max_voxels=256,
            unet_level_caps=(256, 128, 64),
            unet_strides=((2, 2, 2),) * 2,
            unet_paddings=((1, 1, 1),) * 2,
            vfe=dict(feat_channels=(16, 16), mode="max"),
            unet=dict(
                in_channels=16, base_channels=16,
                encoder_channels=((16,), (16, 16), (16, 16)),
                decoder_channels=((16, 16, 16), (16, 16, 16), (16, 16, 16)),
            ),
            head=dict(num_classes=3, hidden_dims=(16, 16)),
        ),
        vfe=dict(feat_channels=(16, 16), mode="max"),
        mixer=dict(
            base_channels=16, output_channels=16,
            encoder_channels=((16,), (16, 16)),
            decoder_channels=((16, 16, 16), (16, 16, 16)),
        ),
        mixer_strides=((2, 2, 2),),
        mixer_paddings=((1, 1, 1),),
        head=dict(
            in_channel=16, shared_mlp_dims=(32,),
            common_attrs=(("center", 3, 1, 16), ("dim", 3, 1, 16),
                          ("rot", 2, 1, 16)),
            num_cls_layer=1, cls_hidden_dim=16,
        ),
        test_cfg=dict(score_thr=0.05, nms_thr=0.25, nms_pre=32, max_num=16,
                      use_rotate_nms=True),
    ), device)


_TINY_FSD_PCR = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)


def _tiny_fsd_cfg() -> dict:
    return dict(
        point_cloud_range=_TINY_FSD_PCR,
        score_thresh=(0.05, 0.05, 0.05),
        cluster_voxel_size=((0.3, 0.3, 6.0), (0.05, 0.05, 6.0),
                            (0.2, 0.2, 6.0)),
        connected_dist=(0.6, 0.1, 0.4),
        min_points=1,
        pre_voxelization_size=(0.1, 0.1, 0.1),
        caps=FSDCaps(
            fg_per_class=(256, 128, 128),
            cluster_voxels_per_class=(256, 256, 256),
            clusters_per_class=(32, 32, 32),
            pre_voxels=1024,
        ),
        segmentor=dict(
            voxel_size=(0.25, 0.25, 0.2),
            max_voxels=1024,
            unet_level_caps=(1024, 512, 256, 128),
            unet_strides=((2, 2, 2),) * 3,
            unet_paddings=((1, 1, 1),) * 3,
            vfe=dict(feat_channels=(16, 16), mode="max"),
            unet=dict(
                in_channels=16, base_channels=16,
                encoder_channels=((16,), (16, 16), (32, 32)),
                decoder_channels=((32, 32, 16), (16, 16, 16), (16, 16, 16)),
            ),
            head=dict(num_classes=3, hidden_dims=(32, 32)),
        ),
        backbone=dict(
            num_blocks=2,
            in_channels=(0, 0),
            feat_channels=((32, 32), (32, 32)),
            rel_mlp_hidden=((8, 8), (8, 8)),
        ),
        head=dict(
            in_channel=128,
            shared_mlp_dims=(64, 64),
            common_attrs=(("center", 3, 1, 32), ("dim", 3, 1, 32),
                          ("rot", 2, 1, 32)),
            num_cls_layer=1,
            cls_hidden_dim=32,
        ),
        test_cfg=dict(score_thr=0.05, nms_thr=0.25, nms_pre=64, max_num=32,
                      use_rotate_nms=True),
    )


def tiny_fsd(num_point_features: int = 5, device="cuda"):
    """Small SingleStageFSD for CPU tests (same config as the JAX
    ``tiny_fsd``: segmentor → CCL clustering → SIR → cluster head), on
    ``device``. ``num_point_features``: 5 for ``fsd_batch``'s rows."""
    return on_device(SingleStageFSD(num_point_features=num_point_features,
                                    **_tiny_fsd_cfg()), device)


def tiny_fsd_grouped(num_point_features: int = 5, device="cuda"):
    """Small SingleStageFSD in group-sampling mode (the Argo2 recipe cut
    to 5 classes in 2 groups; the config of the JAX ``tiny_fsd_grouped``):
    the segmentor head carries a background column (6 logits), sampling
    and clustering run per group, the head's tasks are the groups."""
    names = ("A", "B", "C", "D", "E")
    cfg = _tiny_fsd_cfg()
    cfg.update(
        num_classes=5, class_names=names,
        group_names=(names[:2], names[2:]),
        score_thresh=(0.05, 0.05),
        cluster_voxel_size=((0.3, 0.3, 6.0), (0.2, 0.2, 6.0)),
        connected_dist=(0.6, 0.4),
        caps=FSDCaps(fg_per_class=(256, 128),
                     cluster_voxels_per_class=(256, 256),
                     clusters_per_class=(32, 32), pre_voxels=1024))
    cfg["segmentor"] = dict(cfg["segmentor"],
                            head=dict(num_classes=6, hidden_dims=(32, 32)))
    return on_device(SingleStageFSD(num_point_features=num_point_features,
                                    **cfg), device)


def tiny_fsdv2_grouped(num_point_features: int = 5, with_vel: bool = False,
                       device="cuda"):
    """Small sparse-UNet SingleStageFSDV2 in batched group-sampling mode
    (the nuScenes recipe cut to 3 classes in 2 groups, the segmentor head
    with a background column), the clone of ``tiny_fsdv2`` in the JAX
    package's ``tests/test_fsdv2.py``; ``with_vel`` adds the head's
    velocity branch (boxes of 9 columns), as ``fsdv2_nusc_1x.py`` does."""
    return on_device(SingleStageFSDV2(
        num_point_features=num_point_features,
        point_cloud_range=_TINY_FSD_PCR,
        virtual_voxel_size=(0.5, 0.5, 0.5),
        group_names=(("Car",), ("Pedestrian", "Cyclist")),
        score_thresh=(0.05, 0.05),
        caps=FSDV2Caps(fg_per_class=(256, 128, 128), voxels=1024,
                       union_voxels=2048, virtual_out=256),
        multiscale_levels=(0, 1),
        ms_projector_hiddens=((16,), (16,)),
        ms_output_dim=16,
        segmentor=dict(
            voxel_size=(0.5, 0.5, 0.5),
            max_voxels=1024,
            unet_level_caps=(1024, 512, 256),
            unet_strides=((2, 2, 2),) * 2,
            unet_paddings=((1, 1, 1),) * 2,
            vfe=dict(feat_channels=(16, 16), mode="max"),
            unet=dict(
                in_channels=16, base_channels=16,
                encoder_channels=((16,), (16, 16), (16, 16)),
                decoder_channels=((16, 16, 16), (16, 16, 16), (16, 16, 16)),
            ),
            head=dict(num_classes=4, hidden_dims=(32, 32)),
        ),
        vfe=dict(feat_channels=(16, 16), mode="max"),
        mixer=dict(
            base_channels=16, output_channels=32,
            encoder_channels=((16,), (16, 16), (16, 16)),
            decoder_channels=((16, 16, 16), (16, 16, 16), (16, 16, 16)),
        ),
        head=dict(
            in_channel=32,
            shared_mlp_dims=(64, 64),
            common_attrs=(("center", 3, 1, 32), ("dim", 3, 1, 32),
                          ("rot", 2, 1, 32)),
            num_cls_layer=1,
            cls_hidden_dim=32,
            with_vel=with_vel,
        ),
        test_cfg=dict(score_thr=0.05, nms_thr=0.25, nms_pre=64, max_num=32,
                      use_rotate_nms=True),
    ), device)


def _tiny_roi_head_cfg() -> dict:
    return dict(
        max_inbox_point=32,
        bbox_head=dict(
            num_blocks=2,
            feat_channels=((32, 32),) * 2,
            rel_mlp_hidden=((8, 8),) * 2,
            reg_mlp=(64, 64),
            cls_mlp=(64, 64),
        ),
    )


def _tiny_two_stage_cfg() -> dict:
    return dict(single_stage=_tiny_fsd_cfg(), roi_head=_tiny_roi_head_cfg(),
                rois_per_sample=16)


def tiny_fsd_two_stage(num_point_features: int = 5, device="cuda"):
    """Small two-stage FSD (+ GroupCorrectionHead, SIR² refinement) for CPU
    tests, the config of the JAX ``tiny_fsd_two_stage``, on ``device``."""
    return on_device(FSD(num_point_features=num_point_features,
                         **_tiny_two_stage_cfg()), device)


def tiny_fsdpp(num_point_features: int = 5, device="cuda"):
    """Small FSD++ (the tiny two stage behind the incremental point
    selection, seed noise on) for CPU tests, the config of the JAX
    ``tiny_fsdpp``, on ``device``. ``num_point_features``: 5 for
    :func:`temporal_batch`'s rows (the inner FSD sees 6)."""
    return on_device(TwoStageFSDPP(
        num_point_features=num_point_features, fsd=_tiny_two_stage_cfg(),
        point_cloud_range=_TINY_FSD_PCR, inc_voxel_size=(0.4, 0.4, 0.4),
        pre_score_thr=0.1, center_noise=0.1, dim_noise=0.05, yaw_noise=0.1,
    ), device)


def tiny_ctrl(device="cuda"):
    """Small CTRL ``TrackletDetector`` (tracklet segmentor + track RoI head)
    for CPU tests, the config of the JAX ``tiny_ctrl``, on ``device``; its
    points are :func:`tracklet_batch`'s six channels."""
    return on_device(TrackletDetector(
        num_point_features=6,
        segmentor=dict(
            point_cloud_range=(-3.2, -3.2, -4.0, 3.2, 3.2, 4.0),
            voxel_size=(0.2, 0.2, 0.4),
            max_voxels=512,
            unet_level_caps=(512, 256, 128),
            vfe=dict(feat_channels=(16, 16), mode="max"),
            unet=dict(
                in_channels=16, base_channels=16,
                encoder_channels=((16,), (16, 16), (16, 16)),
                decoder_channels=((16, 16, 16), (16, 16, 16), (16, 16, 16)),
            ),
        ),
        roi_head=dict(num_classes=1, **_tiny_roi_head_cfg()),
    ), device)


def on_device(model: nn.Module, device="cuda",
              max_points: int | None = None) -> nn.Module:
    """``model`` moved to ``device``, with ``max_points`` (where the builder
    gives one) kept as ``model.max_points``, the cap its callers pass to
    ``apis.prepare_batch``.

    The builders default to the card and never fall back to the CPU: asking
    for a CUDA device where there is none raises. Pass ``device="cpu"`` for
    the CPU (the tests do)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, but torch.cuda.is_available() is "
            f"False; pass device='cpu' to build the model on the CPU")
    if max_points is not None:
        model.max_points = max_points
    return model.to(device)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator`` with the JAX package's
    initializer families: Linear and Conv weights normal with variance
    1/fan_in, sparse conv weights [K, Cin, Cout] normal with variance
    1/(K*Cin), biases 0 (the seg head's class bias ``init_bias``), norm
    scales 1 and offsets 0, z embeddings normal(0, 0.02). Each tensor is
    drawn on the CPU from ``generator`` (a CPU generator) and copied into
    the parameter wherever it lies, so the weights do not depend on the
    device."""

    def normal_(param, std):
        param.copy_(torch.empty(param.shape).normal_(0.0, std,
                                                     generator=generator))

    for mod in model.modules():
        if isinstance(mod, SparseConvLayer):
            fan_in = mod.weight.shape[0] * mod.weight.shape[1]
            normal_(mod.weight, 1.0 / math.sqrt(fan_in))
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        if isinstance(mod, VoteSegHead):
            mod.conv_seg.bias.fill_(mod.init_bias)
        if hasattr(mod, "z_embed"):
            normal_(mod.z_embed, 0.02)
    return model


def synthetic_waymo_batch(batch_size: int = 1, num_points: int = 196608,
                          seed: int = 0, num_extra_feats: int = 0,
                          pcr_half: float = 74.8) -> PointBatch:
    """A Waymo-like synthetic frame as numpy arrays: radial density falloff
    + surface structure (ground rings + clustered verticals). Bit-identical
    to the JAX package's generator for the same arguments."""
    rng = np.random.RandomState(seed)
    p = num_points
    n_beams = 64
    beam = rng.randint(0, n_beams, (batch_size, p))
    elev = -np.radians(1.0 + 17.0 * (beam + 0.5) / n_beams)  # -1 .. -18 deg
    ring_r = np.clip(2.1 / np.tan(-elev), 0.0, 78.0)
    az = rng.uniform(-np.pi, np.pi, (batch_size, p))
    rr = ring_r * (1 + rng.randn(batch_size, p) * 0.01)
    x = (rr * np.cos(az)).astype(np.float32)
    y = (rr * np.sin(az)).astype(np.float32)
    z_ground = (rng.randn(batch_size, p) * 0.05 - 0.8).astype(np.float32)
    # 30% of returns hit vertical structures clustered in xy
    is_ground = rng.rand(batch_size, p) < 0.7
    n_struct = 1024
    cx = rng.uniform(-pcr_half, pcr_half, (batch_size, n_struct))
    cy = rng.uniform(-pcr_half, pcr_half, (batch_size, n_struct))
    which = rng.randint(0, n_struct, (batch_size, p))
    xs = np.take_along_axis(cx, which, 1) + rng.randn(batch_size, p) * 0.6
    ys = np.take_along_axis(cy, which, 1) + rng.randn(batch_size, p) * 0.6
    z_struct = rng.uniform(-1.0, 3.0, (batch_size, p)).astype(np.float32)
    x = np.where(is_ground, x, xs.astype(np.float32))
    y = np.where(is_ground, y, ys.astype(np.float32))
    z = np.where(is_ground, z_ground, z_struct).astype(np.float32)
    pts = np.stack([x, y, z], -1)
    if num_extra_feats:
        pts = np.concatenate(
            [pts, rng.rand(batch_size, p, num_extra_feats).astype(np.float32)],
            -1)
    valid = (np.abs(x) < pcr_half) & (np.abs(y) < pcr_half)
    g = 64
    boxes = np.concatenate(
        [
            rng.uniform(-70, 70, (batch_size, g, 2)),
            np.full((batch_size, g, 1), -0.1),
            rng.uniform(0.8, 5.0, (batch_size, g, 3)),
            rng.uniform(-np.pi, np.pi, (batch_size, g, 1)),
        ],
        -1,
    ).astype(np.float32)
    return PointBatch(
        points=pts,
        valid=valid,
        gt_boxes=boxes,
        gt_labels=rng.randint(0, 3, (batch_size, g)).astype(np.int32),
        gt_valid=np.ones((batch_size, g), bool),
    )


def fsd_batch(rng: np.random.RandomState, b: int = 2, p: int = 1024,
              g: int = 6) -> PointBatch:
    """Clustered points in the tiny-FSD range (half around six gt boxes,
    half uniform), x, y, z + 2 channels, as numpy arrays: bit-identical to
    the JAX package's ``fsd_batch`` for the same ``rng`` state."""
    boxes = np.concatenate([
        rng.uniform(-6, 6, (b, g, 2)),
        np.full((b, g, 1), -0.5),
        rng.uniform(1.0, 3.0, (b, g, 3)),
        rng.uniform(-np.pi, np.pi, (b, g, 1)),
    ], -1).astype(np.float32)
    pts = []
    for i in range(b):
        obj = boxes[i, rng.randint(0, g, p // 2), :3] \
            + rng.randn(p // 2, 3) * 0.5
        bgp = rng.uniform(-7, 7, (p - p // 2, 3))
        pp = np.concatenate([obj, bgp]).astype(np.float32)
        pp[:, 2] = np.clip(pp[:, 2], -1.5, 3.5)
        inten = rng.rand(p, 2).astype(np.float32)
        pts.append(np.concatenate([pp, inten], -1))
    return PointBatch(points=np.stack(pts), valid=np.ones((b, p), bool),
                      gt_boxes=boxes,
                      gt_labels=rng.randint(0, 3, (b, g)).astype(np.int32),
                      gt_valid=np.ones((b, g), bool))


def temporal_batch(rng: np.random.RandomState, b: int = 2, p: int = 1024,
                   g: int = 6, s: int = 8) -> TemporalBatch:
    """FSD++ input for the tiny model as numpy arrays: :func:`fsd_batch`,
    frame indices 0-2 and ``s`` seed boxes; bit-identical to the JAX
    package's ``temporal_batch`` for the same ``rng`` state."""
    base = fsd_batch(rng, b, p, g)
    frame_inds = rng.randint(0, 3, (b, p)).astype(np.int32)
    seed_boxes = np.concatenate(
        [rng.uniform(-6, 6, (b, s, 2)), np.full((b, s, 1), -0.5),
         rng.uniform(1, 3, (b, s, 3)), rng.uniform(-3, 3, (b, s, 1))], -1,
    ).astype(np.float32)
    return TemporalBatch(
        points=base.points, valid=base.valid, frame_inds=frame_inds,
        gt_boxes=base.gt_boxes, gt_labels=base.gt_labels,
        gt_valid=base.gt_valid, seed_boxes=seed_boxes,
        seed_labels=rng.randint(0, 3, (b, s)).astype(np.int32),
        seed_scores=rng.rand(b, s).astype(np.float32),
        seed_valid=np.ones((b, s), bool))


def synthetic_temporal_batch(seed: int = 0, num_points: int = 262144,
                             num_seeds: int = 256) -> TemporalBatch:
    """A Waymo-like multi-frame FSD++ input of one sample as numpy arrays,
    bit-identical to ``bench.py bench_fsdpp``'s frames: the
    :func:`synthetic_waymo_batch` sweep of ``num_points`` points (x, y, z +
    2 channels within 79.8 m) with frame indices 0-6, and ``num_seeds``
    seed boxes anywhere within 70 m."""
    base = synthetic_waymo_batch(batch_size=1, num_points=num_points,
                                 num_extra_feats=2, pcr_half=79.8, seed=seed)
    rng = np.random.RandomState(seed)
    s = num_seeds
    seeds = np.concatenate(
        [rng.uniform(-70, 70, (1, s, 2)), np.full((1, s, 1), -0.5),
         rng.uniform(1, 5, (1, s, 3)),
         rng.uniform(-np.pi, np.pi, (1, s, 1))], -1).astype(np.float32)
    return TemporalBatch(
        points=base.points, valid=base.valid,
        frame_inds=rng.randint(0, 7, base.points.shape[:2]).astype(np.int32),
        gt_boxes=base.gt_boxes, gt_labels=base.gt_labels,
        gt_valid=base.gt_valid, seed_boxes=seeds,
        seed_labels=rng.randint(0, 3, (1, s)).astype(np.int32),
        seed_scores=rng.rand(1, s).astype(np.float32),
        seed_valid=np.ones((1, s), bool))


# Labelled synthetic scenes: the gt boxes generate their points, so the
# losses see real positives. Class size priors follow the Waymo anchors.
_CLASS_SIZE_PRIORS = (
    # (l_lo, l_hi, w_lo, w_hi, h_lo, h_hi)
    (3.8, 5.5, 1.7, 2.2, 1.5, 2.0),   # Car / Vehicle
    (0.6, 1.0, 0.6, 1.0, 1.6, 1.9),   # Pedestrian
    (1.6, 2.0, 0.6, 0.9, 1.5, 1.9),   # Cyclist
)


def synthetic_labeled_batch(batch_size: int = 1, num_points: int = 196608,
                            seed: int = 0, num_extra_feats: int = 2,
                            pcr_half: float = 79.8, num_objects: int = 48,
                            size_scale: float = 1.0):
    """A Waymo-like scene whose gt boxes own their points, as numpy arrays,
    bit-identical to the JAX package's ``synthetic_labeled_batch``.

    The background is :func:`synthetic_waymo_batch`; on top, ``num_objects``
    boxes with class-dependent size priors each replace a range-scaled
    number of background points with points sampled inside the (rotated)
    box, 80% of them on its faces. A box that finds no point budget left is
    dropped (zeroed, ``gt_valid`` False). Returns (PointBatch, gt_meta),
    gt_meta[i] holding the valid boxes, labels and per-box point counts."""
    base = synthetic_waymo_batch(batch_size, num_points, seed,
                                 num_extra_feats, pcr_half)
    rng = np.random.RandomState(seed + 70000)
    pts = base.points.copy()
    g = num_objects
    boxes = np.zeros((batch_size, g, 7), np.float32)
    labels = rng.randint(0, 3, (batch_size, g)).astype(np.int32)
    npts_meta = np.zeros((batch_size, g), np.int64)
    gvalid = np.ones((batch_size, g), bool)
    for i in range(batch_size):
        # centres on a coarse grid: no overlapping objects at full range
        cells = rng.choice((2 * 24) ** 2, size=g, replace=False)
        cx = (cells % 48 - 24 + rng.uniform(0.25, 0.75, g)) * (pcr_half / 24.4)
        cy = (cells // 48 - 24 + rng.uniform(0.25, 0.75, g)) * (pcr_half
                                                               / 24.4)
        cursor = 0
        for j in range(g):
            lo_hi = _CLASS_SIZE_PRIORS[labels[i, j]]
            length = rng.uniform(lo_hi[0], lo_hi[1]) * size_scale
            width = rng.uniform(lo_hi[2], lo_hi[3]) * size_scale
            height = rng.uniform(lo_hi[4], lo_hi[5]) * size_scale
            yaw = rng.uniform(-np.pi, np.pi)
            zb = -0.9
            boxes[i, j] = (cx[j], cy[j], zb, width, length, height, yaw)
            r = float(np.hypot(cx[j], cy[j]))
            # beam-density falloff: ~1/r points, scaled by footprint and by
            # the frame's point budget; never past the point buffer
            budget = 9000.0 * num_points / 196608
            n = int(np.clip(budget * np.sqrt(length * width) / max(r, 5.0), 8,
                            1500))
            n = min(n, num_points - cursor)
            if n <= 0:
                boxes[i, j, :] = 0
                gvalid[i, j] = False
                continue
            local = np.stack([
                rng.uniform(-length / 2, length / 2, n),
                rng.uniform(-width / 2, width / 2, n),
                rng.uniform(0, height, n)], -1).astype(np.float32)
            # most points on the hull (lidar sees surfaces)
            surf = rng.rand(n) < 0.8
            ax = rng.randint(0, 2, n)
            local[surf & (ax == 0), 0] = np.sign(
                local[surf & (ax == 0), 0]) * length / 2
            local[surf & (ax == 1), 1] = np.sign(
                local[surf & (ax == 1), 1]) * width / 2
            c, s = np.cos(yaw), np.sin(yaw)
            sl = slice(cursor, cursor + n)
            pts[i, sl, 0] = local[:, 0] * c - local[:, 1] * s + cx[j]
            pts[i, sl, 1] = local[:, 0] * s + local[:, 1] * c + cy[j]
            pts[i, sl, 2] = local[:, 2] + zb
            npts_meta[i, j] = n
            cursor += n
        # shuffle so that object points are not index-contiguous
        pts[i] = pts[i][rng.permutation(num_points)]
    batch = PointBatch(
        points=pts,
        valid=(np.abs(pts[..., 0]) < pcr_half) & (np.abs(pts[..., 1])
                                                  < pcr_half),
        gt_boxes=boxes, gt_labels=labels, gt_valid=gvalid)
    gt_meta = [dict(boxes=boxes[i][gvalid[i]], labels=labels[i][gvalid[i]],
                    num_points=npts_meta[i][gvalid[i]])
               for i in range(batch_size)]
    return batch, gt_meta


def tracklet_batch(rng: np.random.RandomState, b: int = 2, p: int = 512,
                   f: int = 8, device="cuda") -> TrackletBatch:
    """CTRL input for the tiny model on ``device``: track-frame points
    (x, y, z, two channels, the time lag ``frame * 0.1``), tracker boxes and
    gt candidates at the tracker boxes plus N(0, 0.05) noise. The same numpy
    draws from ``rng`` as the JAX package's ``tracklet_batch``."""
    pts = np.clip(rng.randn(b, p, 3).astype(np.float32), -3.0, 3.0)
    inten = rng.rand(b, p, 2).astype(np.float32)
    ts = rng.randint(0, f, (b, p)).astype(np.int32)
    points = np.concatenate(
        [pts, inten, ts[..., None].astype(np.float32) * 0.1], -1)
    trk = np.concatenate(
        [rng.uniform(-0.5, 0.5, (b, f, 2)), np.full((b, f, 1), -1.0),
         np.tile([[.9, 2.0, 1.5]], (b, f, 1))
         * rng.uniform(0.9, 1.1, (b, f, 3)),
         rng.uniform(-0.3, 0.3, (b, f, 1))], -1,
    ).astype(np.float32)
    gt = trk + rng.randn(b, f, 7).astype(np.float32) * 0.05
    return TrackletBatch(
        points=points, valid=np.ones((b, p), bool), frame_inds=ts,
        trk_boxes=trk, trk_scores=rng.rand(b, f).astype(np.float32),
        trk_valid=np.ones((b, f), bool), labels=np.zeros((b,), np.int32),
        gt_boxes=gt, gt_valid=np.ones((b, f), bool)).to(device)
