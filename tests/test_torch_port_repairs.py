"""Repairs of faults in the port, each against the JAX package, on the CPU:

- ``ops/segment.py gather_rows`` / ``gather_segments`` take sources of any
  rank, as JAX's ``gather_segments`` does (they assumed 2-D rows);
- ``apis.prepare_batch`` caps a cloud at JAX's 65,536 points whatever the
  model (it took the model's 196,608-point cap), so the same call keeps
  the same points in both packages;
- SST's ``remat_blocks`` (JAX's default, on) rematerialises each block in
  training without changing a value;
- a point exactly on a voxel boundary lands in JAX's cell: jitted XLA
  divides by the constant voxel size as a product with its float32
  reciprocal, and the port's cell floors now multiply by it too
  (``ops/voxelize.py compute_voxel_coords``, ``ops/incremental.py`` and
  FSD's ``_cell_coords``); they divided.

The SST configs that set JAX's switches build and predict in
tests/test_torch_sst_bf16.py; the config loader that keeps the JAX package
out of the port's process is held in tests/test_torch_fsdpp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import apis as japis
from sst_tpu import flagship as jflag
from sst_tpu.ops.incremental import _voxel_keys as jvoxel_keys
from sst_tpu.ops.segment import gather_segments as jgather
from sst_tpu.ops.voxelize import dynamic_voxelize as jvoxelize
from sst_tpu_torch import apis
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.models.detectors import dynamic_voxelnet as tdvn
from sst_tpu_torch.models.sst import WindowAttention
from sst_tpu_torch.ops.incremental import _voxel_keys
from sst_tpu_torch.ops.segment import gather_rows, gather_segments
from sst_tpu_torch.ops.voxelize import dynamic_voxelize
from sst_tpu_torch.utils import remat
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("shape", [(7,), (7, 3, 2), (7, 1, 4, 2)])
def test_gather_segments_any_rank_equals_jax(shape):
    """Rows of a 1-D, 3-D and 4-D source by ids in and out of range (the
    out-of-range ones filled): JAX's ``gather_segments`` exactly; the
    gradient lands on the gathered rows only."""
    rng = np.random.RandomState(len(shape))
    src = rng.randn(*shape).astype(np.float32)
    ids = np.array([0, 6, 7, 3, 9, 3, 2], np.int32)
    for fill in (0.0, -1.5):
        ref = np.asarray(jgather(jnp.asarray(src), jnp.asarray(ids), fill))
        got = gather_segments(torch.from_numpy(src), torch.from_numpy(ids),
                              fill)
        assert got.shape == ref.shape == (7,) + shape[1:]
        np.testing.assert_array_equal(got.numpy(), ref)
    x = torch.from_numpy(src).requires_grad_()
    gather_rows(x, torch.from_numpy(ids)).sum().backward()
    counts = np.bincount(ids[ids < 7], minlength=7).astype(np.float32)
    np.testing.assert_array_equal(
        x.grad.numpy(), np.broadcast_to(
            counts.reshape((7,) + (1,) * (len(shape) - 1)), shape))


def test_prepare_batch_keeps_the_points_jax_keeps():
    """A cloud of 70,000 in-range points (and some out of range): the
    port's ``inference_detector`` input equals the batch JAX's
    ``inference_detector`` builds, the first 65,536 in-range points, even
    for a model whose own cap is larger."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-6, 6, (72000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1, 2, len(pts))
    pts[::36, 0] = 9.0  # out of tiny_sst's x range
    model = tflag.tiny_sst(device="cpu")
    model.max_points = 196608
    seen = {}

    def predict(variables, batch):
        seen.update(points=np.asarray(batch.points),
                    valid=np.asarray(batch.valid))
        return {"valid": batch.valid}

    japis.inference_detector(jflag.tiny_sst(), None, predict, pts)
    got = apis.prepare_batch(model, pts)
    in_range = int((pts[:, 0] < 6.4).sum())
    assert in_range > 65536 == seen["valid"].sum()
    np.testing.assert_array_equal(got.points.numpy(), seen["points"])
    np.testing.assert_array_equal(got.valid.numpy(), seen["valid"])
    more = apis.prepare_batch(model, pts, model.max_points)
    assert int(more.valid.sum()) == in_range


def test_sst_remat_blocks_change_no_value():
    """``tiny_sst`` with each block rematerialised (``remat_blocks=True``,
    as ``sst_waymo`` trains) against without (``tiny_sst``'s setting, as
    JAX's): the same losses and every gradient bit for bit on the CPU, and
    the attention layers really run again in the backward's recompute."""
    perm = None
    results = []
    for use_remat in (False, True):
        m = tflag.init_weights(tflag.tiny_sst(device="cpu"),
                               torch.Generator().manual_seed(0))
        m.backbone_mod.remat_blocks = use_remat
        recomputed = []
        for mod in m.modules():
            if isinstance(mod, WindowAttention):
                mod.register_forward_pre_hook(
                    lambda *_: recomputed.append(remat.recomputing()))
        if perm is None:
            perm = tdvn.voxel_permutation(m.max_voxels,
                                          torch.Generator().manual_seed(1))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tdvn, "voxel_permutation", lambda n, gen: perm)
            out = m.loss(tflag.tiny_batch().to("cpu"),
                         generator=torch.Generator())
        sum(v for k, v in out.items() if k.startswith("loss")).backward()
        results.append((out, {n: p.grad for n, p in m.named_parameters()},
                        recomputed))
    (out0, g0, rec0), (out1, g1, rec1) = results
    assert rec0 == [False] * 4 and rec1 == [False] * 4 + [True] * 4
    for k in out0:
        assert torch.equal(out0[k], out1[k]), k
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


# (range, voxel size): tiny CTRL, configs/ctrl/ctrl_veh_24e.py, the FSDv2
# segmentor, SST's pillars
_GRIDS = [((-3.2, -3.2, -4.0, 3.2, 3.2, 4.0), (0.2, 0.2, 0.4)),
          ((-6.4, -6.4, -4.0, 6.4, 6.4, 4.0), (0.1, 0.1, 0.2)),
          ((-80.0, -80.0, -2.0, 80.0, 80.0, 4.0), (0.25, 0.25, 0.2)),
          ((-74.88, -74.88, -2.0, 74.88, 74.88, 4.0), (0.32, 0.32, 6.0))]


def _boundary_points(pcr, vs, n=6000, seed=0):
    """Points on cell boundaries: ``lo + k * size`` in float32, and
    rounded decimals such as the clipped 3.0 of CTRL's tracks."""
    rng = np.random.RandomState(seed)
    k = np.stack([rng.randint(0, int(round((pcr[i + 3] - pcr[i]) / vs[i])),
                              n) for i in range(3)], 1)
    pts = np.float32(pcr[:3]) + k.astype(np.float32) * np.float32(vs)
    hi = np.float32(pcr[3]) - 0.2
    pts[:1000] = np.clip(rng.randn(1000, 3) * 5, -hi, hi).round(1)
    return pts.astype(np.float32)


@pytest.mark.parametrize("grid", range(len(_GRIDS)))
def test_boundary_points_take_jax_voxels(grid):
    """``dynamic_voxelize`` (jitted in the JAX package, its range and size
    static) and the FSD++ cell keys (JAX's under ``jax.jit`` with the range
    and size as constants, as in the model) put every boundary point in
    JAX's cell; the division the port made before puts hundreds elsewhere
    on these grids."""
    pcr, vs = _GRIDS[grid]
    pts = _boundary_points(pcr, vs)
    n = len(pts)
    bi, valid = np.zeros(n, np.int32), np.ones(n, bool)
    ref = jvoxelize(jnp.asarray(pts), jnp.asarray(bi), jnp.asarray(valid),
                    pcr, vs, n, 1)
    got = dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(bi),
                           torch.from_numpy(valid), pcr, vs, n, 1)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    np.testing.assert_array_equal(got.point_seg_ids.numpy(),
                                  np.asarray(ref.point_seg_ids))
    divided = np.floor((pts - np.float32(pcr[:3])) / np.float32(vs))
    assert (divided != np.asarray(ref.coords)[:, [3, 2, 1]]).any(1).sum() > 20
    jkeys = jax.jit(lambda p, v: jvoxel_keys(p, v, pcr, vs))(
        jnp.asarray(pts), jnp.asarray(valid))
    tkeys = _voxel_keys(torch.from_numpy(pts), torch.from_numpy(valid), pcr,
                        vs)
    for a, b in zip(tkeys[:2], jkeys[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
