"""Every config file under ``configs/`` through the port's builder, and the
full-width parameter shapes of the grouped configs against the JAX
package's.

The sweep builds each file with ``utils/builders.py build_model_from_cfg(
..., device="cpu")`` at ``train=False`` and ``train=True``: every file
builds (PointPillars, the last detector type to port, since ROADMAP queue
1 item 10), and the PointPillars file predicts at a cut range.

Every config with sparse convs also builds at ``model.dtype="bfloat16"``
(and the ``FSDV2`` two stage over the FSDv2 config): every sparse conv
layer's norm at bf16, the parameters float32 and of the float32 build's
shapes; the FSDv2 and CTRL files' shapes at bf16 are JAX's builder's.

The shape tests trace JAX's init of each grouped config, and of the
CenterHead, weighted-NMS and SST-encoder configs, at full width with
``jax.eval_shape`` (no compile, no allocation) and hold every leaf against
its torch target through ``convert.py check_flax_shapes``.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sst_tpu.models  # noqa: F401  (fills the JAX registry)
from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB
from sst_tpu.utils.builders import build_model_from_cfg as jbuild
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch.convert import check_flax_shapes
from sst_tpu_torch.models.sparse_unet import SparseConvLayer
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "*", "*.py")) if "_base_" not in p)
NEWLY_BUILT = (
    "configs/argo2/argo_onestage_12e.py",
    "configs/argo2/argo_segmentation_pretrain.py",
    "configs/fsdv2/fsdv2_argo_2x.py",
    "configs/fsdv2/fsdv2_nusc_1x.py",
    "configs/fsdv2/fsdv2_nusc_2x.py",
    "configs/fsd/fsd_waymoD1_1x_3f.py",
    "configs/fsd/fsd_sst_encoder_pretrain.py",
    "configs/fsd/fsd_waymoD1_1x_sst_encoder.py",
    "configs/sst/sst_waymoD1_2x_3class_centerhead.py",
    "configs/sst/sst_waymoD5_3class_centerhead.py",
    "configs/pointpillars/pointpillars_waymoD5_3class.py",
)
GROUPED_CFGS = ("configs/fsdv2/fsdv2_nusc_1x.py",
                "configs/fsdv2/fsdv2_argo_2x.py",
                "configs/argo2/argo_onestage_12e.py")
# the CenterHead, weighted-NMS and SST-encoder configs
# every file whose model runs sparse convs (the sparse UNets, FSD's
# segmentor, CTRL's tracklet segmentor)
SPARSE_CFGS = tuple(p for p in CONFIGS if p.split("/")[1] in (
    "argo2", "ctrl", "fsd", "fsdpp", "fsdv2") and "dense" not in p
    and "sst_encoder" not in p)
SST_HEAD_CFGS = ("configs/sst/sst_waymoD5_3class_centerhead.py",
                 "configs/sst/sst_waymoD1_2x_3class_centerhead.py",
                 "configs/sst/sst_waymoD5_car_wnms.py",
                 "configs/fsd/fsd_waymoD1_1x_sst_encoder.py",
                 "configs/fsd/fsd_sst_encoder_pretrain.py")


@pytest.mark.parametrize("train", [False, True])
def test_every_config_builds_or_names_its_item(train):
    """Every file builds; none raises any more."""
    assert set(NEWLY_BUILT) <= set(CONFIGS)
    for path in CONFIGS:
        cfg = load_config(os.path.join(ROOT, path))
        m = build_model_from_cfg(cfg, train=train, device="cpu")
        assert sum(p.numel() for p in m.parameters()) > 0, path


def _bf16(cfg: dict) -> dict:
    return dict(cfg, model=dict(cfg["model"], dtype="bfloat16"))


def _fsdv2_two_stage(path="configs/fsdv2/fsdv2_waymo_1x.py") -> dict:
    """The ``FSDV2`` two stage over the FSDv2 config's model, as
    ``chip_smoke.py``'s phase 19 builds it."""
    cfg = load_config(os.path.join(ROOT, path))
    ss = {k: v for k, v in cfg["model"].items() if k != "type"}
    return dict(cfg, model=dict(type="FSDV2", single_stage=ss))


@pytest.fixture(scope="module")
def sparse_cfgs_f32():
    """Each sparse file's config (and the ``FSDV2`` two stage's) with its
    float32 build's floating-point state: {name: (shape, dtype)}."""
    cfgs = {p: load_config(os.path.join(ROOT, p)) for p in SPARSE_CFGS}
    cfgs["FSDV2"] = _fsdv2_two_stage()
    return {path: (cfg, {k: (tuple(v.shape), v.dtype) for k, v in
                         build_model_from_cfg(cfg, train=False, device="cpu")
                         .state_dict().items() if v.is_floating_point()})
            for path, cfg in cfgs.items()}


@pytest.mark.parametrize("train", [False, True])
def test_every_sparse_config_builds_at_bf16(sparse_cfgs_f32, train):
    """Each of the 13 sparse files, and the ``FSDV2`` two stage, at
    ``model.dtype="bfloat16"``: the norms of its sparse conv layers bf16,
    every parameter and statistic float32, of the float32 build's names
    and shapes."""
    assert len(SPARSE_CFGS) == 13
    for path, (cfg, want) in sparse_cfgs_f32.items():
        m = build_model_from_cfg(_bf16(cfg), train=train, device="cpu")
        convs = [c for c in m.modules() if isinstance(c, SparseConvLayer)]
        assert convs, path
        assert {c.MaskedBatchNorm_0.dtype for c in convs
                if c.MaskedBatchNorm_0 is not None} == {torch.bfloat16}, path
        got = {k: (tuple(v.shape), v.dtype) for k, v in
               m.state_dict().items() if v.is_floating_point()}
        assert got == want, path
        assert {d for _, d in want.values()} == {torch.float32}, path


@pytest.mark.parametrize("path", ["configs/fsdv2/fsdv2_waymo_1x.py",
                                  "configs/ctrl/ctrl_veh_24e.py"])
def test_bf16_sparse_parameter_shapes_match_jax(path):
    """The FSDv2 and CTRL files at ``model.dtype="bfloat16"`` through both
    builders: every leaf of JAX's bf16 init (``jax.eval_shape``) has its
    torch target at the same shape, float32 in both."""
    from sst_tpu.models.ctrl import TrackletBatch as JTB

    cfg = _bf16(load_config(os.path.join(ROOT, path)))
    jcfg = jload(os.path.join(ROOT, path))
    jcfg["model"] = dict(jcfg["model"], dtype="bfloat16")
    jm = jbuild(jcfg, train=False)
    sd = jax.ShapeDtypeStruct
    if "ctrl" in path:
        b, p, f = 1, 4096, 8
        batch = JTB(points=sd((b, p, 6), jnp.float32),
                    valid=sd((b, p), jnp.bool_),
                    frame_inds=sd((b, p), jnp.int32),
                    trk_boxes=sd((b, f, 7), jnp.float32),
                    trk_scores=sd((b, f), jnp.float32),
                    trk_valid=sd((b, f), jnp.bool_),
                    labels=sd((b,), jnp.int32),
                    gt_boxes=sd((b, f, 7), jnp.float32),
                    gt_valid=sd((b, f), jnp.bool_))
    else:
        batch = _shape_batch(16384, 5)
    shapes = jax.eval_shape(lambda bt: jm.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        bt, train=False), batch)
    assert {x.dtype for x in jax.tree_util.tree_leaves(shapes)} == {
        jnp.dtype(jnp.float32)}
    tm = build_model_from_cfg(cfg, train=False, device="cpu")
    assert check_flax_shapes(tm, shapes) == len(tm.state_dict())


def test_pointpillars_config_predicts_at_a_cut_range():
    """``configs/pointpillars/pointpillars_waymoD5_3class.py`` at its full
    widths (PFN 64, SECOND (64, 128, 256), FPN 128 x 3, 32,000 pillars of
    20 points), its range and anchor ranges cut to +-16 m (100² pillars),
    through ``apis.inference_detector``: finite boxes of the config's
    ``max_num`` rows. ``chip_smoke.py`` phase 24 predicts it at 468²."""
    from sst_tpu_torch.apis import inference_detector
    from sst_tpu_torch.flagship import init_weights, synthetic_waymo_batch

    cfg = load_config(os.path.join(
        ROOT, "configs/pointpillars/pointpillars_waymoD5_3class.py"))
    half = 16.0
    model = cfg["model"]
    model["point_cloud_range"] = (-half, -half, -2.0, half, half, 4.0)
    model["head"]["anchor_ranges"] = tuple(
        (-half, -half, z, half, half, z) for z in (-0.0345, -0.1188, 0.0))
    m = init_weights(build_model_from_cfg(cfg, train=False, device="cpu"),
                     torch.Generator().manual_seed(0)).eval()
    assert type(m).__name__ == "PointPillars" and m.bev_shape == (100, 100)
    frame = synthetic_waymo_batch(1, 8192, num_extra_feats=2, pcr_half=15.5)
    out = inference_detector(m, frame.points[0])
    assert out["boxes"].shape == (500, 7)
    assert np.isfinite(out["boxes"]).all() and out["valid"].sum() > 0


def test_grouped_and_multisweep_configs_build_their_options():
    """What the six newly built files ask of the modules: group sampling
    with a background column, the velocity branch (nuScenes), the 3-sweep
    segmentor's 0.05 m down-sampling and its two tanh channels."""
    def build(path):
        return build_model_from_cfg(load_config(os.path.join(ROOT, path)),
                                    train=False, device="cpu")

    nusc = build("configs/fsdv2/fsdv2_nusc_1x.py")
    assert len(nusc.group_names) == 6 and nusc.head_mod.with_vel
    assert nusc.segmentor_mod.head_mod.num_classes == 11
    argo = build("configs/argo2/argo_onestage_12e.py")
    assert argo.num_units == 6 and len(argo.head_mod.tasks) == 6
    assert argo.segmentor_mod.head_mod.num_classes == 27
    three = build("configs/fsd/fsd_waymoD1_1x_3f.py")
    seg = three.rpn.segmentor_mod
    assert seg.voxel_downsampling_size == (0.05, 0.05, 0.05)
    assert seg.tanh_dims == (3, 4)


def _shape_batch(num_points, width, box_dim=7):
    sd = jax.ShapeDtypeStruct
    return JPB(points=sd((1, num_points, width), jnp.float32),
               valid=sd((1, num_points), jnp.bool_),
               gt_boxes=sd((1, 1, box_dim), jnp.float32),
               gt_labels=sd((1, 1), jnp.int32),
               gt_valid=sd((1, 1), jnp.bool_))


@pytest.mark.parametrize("path", GROUPED_CFGS)
def test_full_width_grouped_parameter_shapes_match_jax(path):
    """Each grouped config at full width: every leaf of JAX's init has its
    torch target at the same shape (the velocity branch and the
    segmentor's background column included), and every torch tensor is
    set."""
    cfg = load_config(os.path.join(ROOT, path))
    jm = jbuild(jload(os.path.join(ROOT, path)), train=False)
    shapes = jax.eval_shape(lambda bt: jm.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        bt, train=False), _shape_batch(16384, 5,
                                       9 if "nusc" in path else 7))
    tm = build_model_from_cfg(cfg, train=False, device="cpu")
    assert check_flax_shapes(tm, shapes) == len(tm.state_dict())
    assert tm.segmentor_mod.head_mod.num_classes == \
        cfg["model"]["num_classes"] + 1
    if "nusc" in path:
        assert tm.head_mod.task_0.vel.Dense_2.out_features == 2


@pytest.mark.parametrize("path", SST_HEAD_CFGS)
def test_full_width_sst_head_parameter_shapes_match_jax(path):
    """Each CenterHead, weighted-NMS and SST-encoder config at full width:
    every leaf of JAX's init (the CenterHead's shared conv and task
    branches, the segmentor's 4-block SSTv2 without attached convs) has
    its torch target at the same shape, and every torch tensor is set."""
    cfg = load_config(os.path.join(ROOT, path))
    jm = jbuild(jload(os.path.join(ROOT, path)), train=False)
    shapes = jax.eval_shape(lambda bt: jm.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        bt, train=False), _shape_batch(16384, 5))
    tm = build_model_from_cfg(cfg, train=False, device="cpu")
    assert check_flax_shapes(tm, shapes) == len(tm.state_dict())
