"""Every config file under ``configs/`` through the port's builder, and the
full-width parameter shapes of the grouped configs against the JAX
package's.

The sweep builds each file with ``utils/builders.py build_model_from_cfg(
..., device="cpu")`` at ``train=False`` and ``train=True``: every file
builds but the one whose detector is still to port, which raises
``NotImplementedError`` naming its ROADMAP queue 1 item (PointPillars,
item 10).

The shape tests trace JAX's init of each grouped config, and of the
CenterHead, weighted-NMS and SST-encoder configs, at full width with
``jax.eval_shape`` (no compile, no allocation) and hold every leaf against
its torch target through ``convert.py check_flax_shapes``.
"""

import glob
import os

import jax
import jax.numpy as jnp
import pytest

import sst_tpu.models  # noqa: F401  (fills the JAX registry)
from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB
from sst_tpu.utils.builders import build_model_from_cfg as jbuild
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch.convert import check_flax_shapes
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "*", "*.py")) if "_base_" not in p)
# the files that raise, by the ROADMAP queue 1 item their message names
RAISES = {
    "configs/pointpillars/pointpillars_waymoD5_3class.py": "item 10",
}
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
)
GROUPED_CFGS = ("configs/fsdv2/fsdv2_nusc_1x.py",
                "configs/fsdv2/fsdv2_argo_2x.py",
                "configs/argo2/argo_onestage_12e.py")
# the CenterHead, weighted-NMS and SST-encoder configs
SST_HEAD_CFGS = ("configs/sst/sst_waymoD5_3class_centerhead.py",
                 "configs/sst/sst_waymoD1_2x_3class_centerhead.py",
                 "configs/sst/sst_waymoD5_car_wnms.py",
                 "configs/fsd/fsd_waymoD1_1x_sst_encoder.py",
                 "configs/fsd/fsd_sst_encoder_pretrain.py")


@pytest.mark.parametrize("train", [False, True])
def test_every_config_builds_or_names_its_item(train):
    assert set(RAISES) | set(NEWLY_BUILT) <= set(CONFIGS)
    for path in CONFIGS:
        cfg = load_config(os.path.join(ROOT, path))
        if path in RAISES:
            with pytest.raises(NotImplementedError, match=RAISES[path]):
                build_model_from_cfg(cfg, train=train, device="cpu")
            continue
        m = build_model_from_cfg(cfg, train=train, device="cpu")
        assert sum(p.numel() for p in m.parameters()) > 0, path


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
