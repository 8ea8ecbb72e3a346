"""The port's ``VoteSegmentor(backbone="sst")`` (FSD's SST-encoder recipe)
against the JAX package on the CPU.

A tiny segmentor (0.4 m full-height pillars over +-6.4 m, 4 x 4 windows,
two buckets, a two-block SSTv2 of width 32 without attached convs, the vote
head) with the port's seeded weights carried into flax (random running
statistics), on ``tiny_batch`` points with a seeded intensity channel. One
jitted JAX function gives the eval outputs and the train-mode
``value_and_grad`` of the head's losses against ``seg_targets``; JAX runs
its fused attention (``use_pallas=True``, the Pallas kernel in interpret
mode) and draws its voxel shuffle from its ``shuffle`` rng, which is
recorded and fed to the port. Tolerances as ``tests/test_torch_sst_train.py``
states them for the attention's bf16 roundings: per-point logits, votes
and features rtol/atol 1e-2 (voxels the plan dropped read zeros on both
sides); the losses rtol 1e-4; each gradient leaf within 3e-2 of its
largest magnitude plus rtol 1e-2; running statistics 1e-4.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.models import sst_input as jsi
from sst_tpu.models.fsd import vote_segmentor as jvs
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models.detectors import dynamic_voxelnet as tdvn
from sst_tpu_torch.models.fsd import vote_segmentor as tvs
from sst_tpu_torch.ops import window_mha as wm
from test_torch_fsdv2_dense_train import _flax_variables, _torch_leaf
from test_torch_fsdv2_train import _leaves
from torch_threads import torch_threads_per_worker  # noqa: F401

MAP_TOL = dict(rtol=1e-2, atol=1e-2)
SEG = dict(voxel_size=(0.4, 0.4, 6.0),
           point_cloud_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 4.0),
           max_voxels=512, backbone="sst",
           sst=dict(window_shape=(4, 4),
                    buckets=((8, 0, 8, 64), (16, 8, 100000, 32)),
                    max_total_windows=128),
           vfe=dict(feat_channels=(16, 32), mode="max"),
           unet=dict(d_model=(32, 32), nhead=(2, 2), num_blocks=2,
                     dim_feedforward=(64, 64), remat_blocks=False),
           head=dict(num_classes=3, hidden_dims=(32, 32)))
OUTS = ("seg_logits", "seg_vote_preds", "seg_feats")


def _batch():
    b = jax.tree_util.tree_map(np.asarray, jflag.tiny_batch())
    inten = np.random.RandomState(5).rand(*b.points.shape[:2], 1)
    pts = np.concatenate([b.points, inten.astype(np.float32)], -1)
    return pts, b


@pytest.fixture(scope="module")
def seg_run():
    pts, b = _batch()
    bsz, p, c = pts.shape
    flat = pts.reshape(bsz * p, c)
    bidx = np.repeat(np.arange(bsz, dtype=np.int32), p)
    valid = b.valid.reshape(-1)
    tm = tflag.init_weights(tvs.VoteSegmentor(c, **SEG),
                            torch.Generator().manual_seed(0))
    v = _flax_variables(tm)
    mp = pytest.MonkeyPatch()
    mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    perms = []
    real_input_layer = jsi.sst_input_layer

    def recording_input_layer(*args, shuffle_rng=None, **kw):
        if shuffle_rng is not None:
            perms.append(jax.random.permutation(shuffle_rng,
                                                args[0].shape[0]))
        return real_input_layer(*args, shuffle_rng=shuffle_rng, **kw)

    mp.setattr(jsi, "sst_input_layer", recording_input_layer)
    try:
        jm = jvs.VoteSegmentor(**{**SEG, "unet": {**SEG["unet"],
                                                  "use_pallas": True}})

        def targets(boxes, labels, gvalid):
            jnp = jax.numpy
            per = [jvs.seg_targets(jnp.asarray(flat[i * p:(i + 1) * p, :3]),
                                   jnp.asarray(valid[i * p:(i + 1) * p]),
                                   jnp.asarray(boxes[i]),
                                   jnp.asarray(labels[i]),
                                   jnp.asarray(gvalid[i]), 3)
                   for i in range(bsz)]
            return [jax.numpy.concatenate(x) for x in zip(*per)]

        def run(params, stats):
            ev = {"params": params, "batch_stats": stats}
            out = jm.apply(ev, flat, bidx, valid, bsz, False)

            def loss_fn(pp, ss):
                o, mut = jm.apply(
                    {"params": pp, "batch_stats": ss}, flat, bidx, valid,
                    bsz, True, rngs={"shuffle": jax.random.PRNGKey(7)},
                    mutable=["batch_stats"])
                lbl, vt, vm = targets(b.gt_boxes, b.gt_labels, b.gt_valid)
                parts = jm.apply(
                    {"params": pp, "batch_stats": ss}, o["seg_logits"],
                    o["seg_vote_preds"], lbl, vt, vm, o["valid"],
                    method=lambda m, *a: m.head_mod.losses(*a))
                return sum(parts.values()), (parts, mut["batch_stats"],
                                             perms[-1])

            (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, stats)
            return {k: out[k] for k in OUTS + ("valid",)}, aux, grads

        jout, (jparts, jstats, jperm), jgrads = jax.jit(run)(
            v["params"], v["batch_stats"])
    finally:
        mp.undo()
    jperm = np.asarray(jperm)
    tm = load_flax_variables(tvs.VoteSegmentor(c, **SEG), v).eval()
    args = (torch.from_numpy(flat), torch.from_numpy(bidx),
            torch.from_numpy(valid), bsz)
    wm.reset_launch_counts()
    with torch.inference_mode():
        tout = tm(*args)
    mp = pytest.MonkeyPatch()
    mp.setattr(tdvn, "voxel_permutation",
               lambda n, gen: torch.from_numpy(jperm.copy()).long())
    try:
        tm.train()
        o = tm(*args, True, generator=torch.Generator())
        per = [tvs.seg_targets(args[0][i * p:(i + 1) * p, :3],
                               args[2][i * p:(i + 1) * p],
                               torch.from_numpy(b.gt_boxes[i]),
                               torch.from_numpy(b.gt_labels[i]),
                               torch.from_numpy(b.gt_valid[i]), 3)
               for i in range(bsz)]
        lbl, vt, vm = (torch.cat(x) for x in zip(*per))
        tparts = tm.head_mod.losses(o["seg_logits"], o["seg_vote_preds"],
                                    lbl, vt, vm, o["valid"])
        sum(tparts.values()).backward()
    finally:
        mp.undo()
    assert wm.launches == 0  # CPU tensors take the twin
    return dict(tm=tm, jout=jout, jparts=jparts, jstats=jstats,
                jgrads=jgrads, jperm=jperm, tout=tout, tparts=tparts)


def test_sst_segmentor_outputs_match_jax(seg_run):
    r = seg_run
    np.testing.assert_array_equal(r["tout"]["valid"].numpy(),
                                  np.asarray(r["jout"]["valid"]))
    for k in OUTS:
        np.testing.assert_allclose(r["tout"][k].numpy(),
                                   np.asarray(r["jout"][k]), **MAP_TOL,
                                   err_msg=k)
    # the plan's drops zero a voxel's SST features on both sides
    feats = np.asarray(r["jout"]["seg_feats"])[:, :32]
    assert (np.abs(feats).sum(1) == 0).any()


def test_sst_segmentor_train_parity(seg_run):
    r = seg_run
    assert sorted(r["tparts"]) == sorted(r["jparts"])
    for k, ref in r["jparts"].items():
        np.testing.assert_allclose(float(r["tparts"][k].detach()),
                                   float(ref), rtol=1e-4, err_msg=k)
    assert (r["jperm"] != np.arange(len(r["jperm"]))).any()
    n = 0
    for path, ref in _leaves(r["jgrads"]):
        got = _torch_leaf(r["tm"], path, grad=True)
        np.testing.assert_allclose(got, ref, rtol=1e-2,
                                   atol=3e-2 * np.abs(ref).max(),
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in r["tm"].parameters())
    for path, ref in _leaves(r["jstats"]):
        got = _torch_leaf(r["tm"], path, grad=False)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg="/".join(path))


def test_sst_segmentor_requires_pillars():
    with pytest.raises(ValueError, match="pillar"):
        tvs.VoteSegmentor(4, **{**SEG, "voxel_size": (0.4, 0.4, 0.2)})
