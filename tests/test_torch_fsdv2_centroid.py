"""FSDv2's ``centroid_alpha`` and ``DynamicVFE(return_point_feats=True)``
against the JAX package, on the CPU.

``centroid_alpha``: in training a virtual voxel's centroid is the weighted
mean of its points, gt-foreground points (``gt_fg_points_mask``, held
exactly against JAX here) weighing 1 and the others alpha, in one fused
4-channel segment sum; outside training the VFE's ``cluster_mean`` stays.
The train-mode losses, gradients and centroids of ``tiny_fsdv2_flagship``
with ``centroid_alpha=0.1`` are held against JAX's in
test_torch_fsdv2_train.py's slice (one jitted JAX function for both);
here, port-only, the option's training-only effect and both mixer pairings
with JAX's ``tests/test_train_fidelity.py`` setting (0.1 with
``add_gt_fg_points=True``). ``return_point_feats``: the last layer's point
features within 1e-5 of flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.core.target_assign import gt_fg_points_mask as jgt_fg
from sst_tpu.models.vfe import DynamicVFE as FlaxVFE
from sst_tpu.ops.voxelize import dynamic_voxelize as jax_voxelize
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core.target_assign import gt_fg_points_mask
from sst_tpu_torch.models.vfe import DynamicVFE
from sst_tpu_torch.ops.voxelize import dynamic_voxelize
from test_torch_fsdv2_train import FRAME
from test_torch_layers_vfe import _numpy_vars, _points
from torch_threads import torch_threads_per_worker  # noqa: F401

ALPHA = dict(centroid_alpha=0.1, add_gt_fg_points=True)


def _with_alpha(m):
    m.centroid_alpha = ALPHA["centroid_alpha"]
    m.add_gt_fg_points = ALPHA["add_gt_fg_points"]
    return m


def test_centroid_alpha_weighs_only_in_training():
    """Outside training the centroid is the VFE's plain cluster mean (the
    same model without the option gives the same bits); in training the
    weights move it off the plain mean."""
    tm = _with_alpha(tflag.init_weights(
        tflag.tiny_fsdv2_flagship(device="cpu"),
        torch.Generator().manual_seed(0)))
    tb = tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu")
    with torch.no_grad():
        # the test-mode runs first: a train-mode run moves the statistics
        test_c = tm.run_pipeline(tb, False)["ex"]["virtual_centroid"]
        tm.centroid_alpha = None
        plain = tm.run_pipeline(tb, False)["ex"]["virtual_centroid"]
        tm.centroid_alpha = ALPHA["centroid_alpha"]
        ex = tm.run_pipeline(tb, True)["ex"]
        tm.centroid_alpha = None
        plain_train = tm.run_pipeline(tb, True)["ex"]["virtual_centroid"]
    assert torch.equal(test_c, plain)
    vv = ex["virtual_valid"]
    assert vv.sum() > 0
    assert not torch.allclose(ex["virtual_centroid"][vv], plain_train[vv])


def test_gt_fg_points_mask_matches_jax():
    """Any class and one class, exactly, over two samples."""
    b, _ = jflag.synthetic_labeled_batch(batch_size=2, num_points=1024,
                                         seed=4, num_extra_feats=0,
                                         pcr_half=3.8, num_objects=6,
                                         size_scale=0.5)
    pts = np.asarray(b.points).reshape(-1, 3)
    bidx = np.repeat(np.arange(2, dtype=np.int32), 1024)
    valid = np.asarray(b.valid).reshape(-1)
    args = (pts, bidx, valid, np.asarray(b.gt_boxes),
            np.asarray(b.gt_labels), np.asarray(b.gt_valid))
    for cls in (None, 1):
        ref = np.asarray(jgt_fg(*args, cls=cls))
        got = gt_fg_points_mask(*(torch.from_numpy(np.array(a))
                                  for a in args), cls=cls).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 0 < ref.sum() < valid.sum()


def test_return_point_feats_matches_jax():
    """The last layer's point features (the scatter route, also where the
    sorted reduce is asked for), with and without ``extra_sum`` (and its
    aux), within 1e-5."""
    pts, valid, extra = _points()
    pcr = (-4.0, -4.0, -2.0, 4.0, 4.0, 4.0)
    vsz = (0.5, 0.5, 0.5)
    bidx = np.zeros(len(pts), np.int32)
    kw = dict(feat_channels=(16, 16), voxel_size=vsz, point_cloud_range=pcr,
              return_point_feats=True)
    jvm = jax_voxelize(jnp.asarray(pts), jnp.asarray(bidx),
                       jnp.asarray(valid), pcr, vsz, 300, 1, need_ranks=True)
    tvm = dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(bidx),
                           torch.from_numpy(valid), pcr, vsz, 300, 1,
                           need_ranks=True)
    fm = FlaxVFE(**kw)
    v = _numpy_vars(jax.jit(lambda p: fm.init(jax.random.PRNGKey(0), p,
                                              jvm))(pts))
    tm = load_flax_variables(DynamicVFE(4, use_sorted_reduce=True, **kw), v)
    for with_extra in (False, True):
        es = extra if with_extra else None
        ref = jax.jit(lambda p, e: fm.apply(v, p, jvm, extra_sum=e))(
            pts, es)
        with torch.no_grad():
            got = tm(torch.from_numpy(pts), tvm, extra_sum=(
                torch.from_numpy(extra) if with_extra else None))
        if with_extra:
            (ref, ref_aux), (got, got_aux) = ref, got
            for k in ("cluster_mean", "extra_sum"):
                np.testing.assert_allclose(got_aux[k].numpy(),
                                           np.asarray(ref_aux[k]),
                                           rtol=1e-5, atol=1e-5)
        assert got.shape == (len(pts), 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert tm.sorted_calls == 0


@pytest.mark.parametrize("build", ["dense", "sparse"])
def test_centroid_alpha_builds_with_both_mixers(build):
    """Both mixer pairings build with the option and train a step."""
    from sst_tpu_torch.models.fsd.fsdv2 import SingleStageFSDV2

    make = (tflag.tiny_fsdv2_dense if build == "dense"
            else tflag.tiny_fsdv2_flagship)
    m = _with_alpha(tflag.init_weights(make(device="cpu"),
                                       torch.Generator().manual_seed(1)))
    assert isinstance(m, SingleStageFSDV2)
    out = m.loss(tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu"))
    total = sum(x for k, x in out.items() if k.startswith("loss"))
    assert torch.isfinite(total)
    total.backward()
