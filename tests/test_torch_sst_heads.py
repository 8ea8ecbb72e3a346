"""The port's SST detector with the CenterHead, and cosine window
attention, against the JAX package on the CPU; the weighted-NMS config at
full width.

- A tiny ``DynamicVoxelNet(head_type="center")`` (``tiny_sst``'s voxels,
  windows, two SST blocks and neck, a CenterHead of 16 channels) with the
  port's seeded weights carried into flax (random running statistics).
  One jitted JAX function gives the eval head maps, the predict, and the
  train-mode ``value_and_grad`` of the loss; JAX runs its fused attention
  (``use_pallas=True``, the Pallas kernel in interpret mode), so both
  sides compute the same attention function, and its voxel shuffle is
  recorded and fed to the port. The batch's seed keeps every L1 term of
  the box loss farther from its kink than the maps' tolerance, so no
  term's gradient sign can flip. Tolerances are those of
  ``tests/test_torch_sst_train.py``, for the reason its docstring gives
  (an element near a bf16 rounding boundary of the attention rounds the
  other way after an f32 sum in another order): head maps rtol/atol 1e-2;
  the decode of JAX's head maps exactly (boxes 2e-5, scores 1e-6); losses
  rtol 5e-4 (the box losses read the maps at the gt centres: 1.1e-4
  measured), counters exactly; running statistics 1e-4. The gradients
  reach every leaf through the dense focal loss of all 32 x 32 x 3 pixels,
  so the attention's roundings weigh more than under the anchor head:
  each leaf is held within 0.12 of its largest magnitude plus rtol 1e-2
  (largest gap measured 0.096, an SST ``qk_proj`` bias), and the median
  leaf within 1e-2 (measured 5.7e-3); the head's own gradients are held
  at 1e-4 in ``tests/test_torch_center_head.py``.
- Cosine (Swin-v2) ``WindowAttention`` with one shared ``tau`` and with a
  ``tau`` per head (one below ``tau_min`` = 0.25), on a window plan of 110
  pillars, against JAX's einsum path (its only path for cosine): the
  output and the gradients of the input and of every projection within
  2^-6 of each one's largest magnitude plus rtol 2^-6 (bf16 logits,
  softmax and AV on both sides, rounded at other points), the gradient of
  ``tau`` within 5e-2 (a bf16 sum on both sides; 3.5e-2 measured). JAX's
  side is compiled with excess precision off, so its bf16 values are
  rounded where their dtype says.
- ``configs/sst/sst_waymoD5_car_wnms.py`` at full width predicts a small
  cloud on the CPU through the weighted NMS.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.models import sst as jsst
from sst_tpu.models import sst_input as jin
from sst_tpu.models.detectors import dynamic_voxelnet as jdvn
from sst_tpu.models.heads import center_head as jch
from sst_tpu.ops import window as jwin
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import sst_input as tin
from sst_tpu_torch.models.detectors import dynamic_voxelnet as tdvn
from sst_tpu_torch.models.sst import WindowAttention
from sst_tpu_torch.ops import window as twin
from sst_tpu_torch.ops import window_mha as wm
from test_torch_bf16_modules import _exact_bf16
from test_torch_fsdv2_dense_train import _flax_variables, _torch_leaf
from test_torch_fsdv2_train import _leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_TOL = dict(rtol=1e-2, atol=1e-2)
HALF = 6.4
TINY = dict(
    voxel_size=(0.4, 0.4, 6.0),
    point_cloud_range=(-HALF, -HALF, -2.0, HALF, HALF, 4.0),
    max_voxels=512, max_total_windows=128, window_shape=(4, 4),
    vfe=dict(feat_channels=(16, 32)),
    backbone=dict(d_model=(32, 32), nhead=(2, 2), num_blocks=2,
                  dim_feedforward=(64, 64), num_attached_conv=1,
                  conv_kwargs=({"kernel_size": 3, "dilation": 1},),
                  conv_out_channel=32, in_channel=32, remat_blocks=False),
    neck=dict(out_channels=(64,)), head_type="center",
    head=dict(share_conv_channel=16, head_conv=16),
    test_cfg=dict(score_thr=0.1, nms_thr=0.25, nms_pre=64, max_num=32,
                  use_rotate_nms=True))
BUCKETS = ((8, 0, 8, 64), (16, 8, 100000, 32))
# the first seed whose box-loss L1 terms all keep more than the maps'
# tolerance from their kink (seeds 0 and 1 refused: 1.1e-3, 2.0e-3)
BATCH_SEED = 2
# cosine logits reach +-1/tau; bf16 logits at tau = 0.1 are rounded by up
# to 0.04 before the exponential, which moves the gradients by 4% of their
# scale with the roundings placed differently: the clamp is tested at 0.25
TAU_MIN = 0.25


def _port_model():
    return tdvn.DynamicVoxelNet(
        num_point_features=3,
        buckets=tuple(twin.BucketSpec(*b) for b in BUCKETS), **TINY)


@pytest.fixture(scope="module")
def center_run():
    tm = tflag.init_weights(_port_model(), torch.Generator().manual_seed(0))
    v = _flax_variables(tm)
    mp = pytest.MonkeyPatch()
    mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    perms = []

    def recording_input_layer(*args, shuffle_rng=None, **kw):
        if shuffle_rng is not None:
            perms.append(jax.random.permutation(shuffle_rng,
                                                args[0].shape[0]))
        return real_input_layer(*args, shuffle_rng=shuffle_rng, **kw)

    real_input_layer = jdvn.sst_input_layer
    mp.setattr(jdvn, "sst_input_layer", recording_input_layer)
    try:
        jm = jdvn.DynamicVoxelNet(
            buckets=tuple(jwin.BucketSpec(*b) for b in BUCKETS),
            **{**TINY, "backbone": {**TINY["backbone"], "use_pallas": True}})
        jb = jflag.tiny_batch(seed=BATCH_SEED)
        # the head's decode reads no variable
        jhead = jch.CenterHead(point_cloud_range=TINY["point_cloud_range"],
                               voxel_size=TINY["voxel_size"], **TINY["head"])

        def run(params, stats, b):
            ev = {"params": params, "batch_stats": stats}
            maps = jm.apply(ev, b)
            dets = jm.apply(ev, b, method=jm.predict)
            pinned = jhead.get_bboxes(maps, **TINY["test_cfg"])

            def loss_fn(p, s):
                out, mut = jm.apply(
                    {"params": p, "batch_stats": s}, b, True,
                    method=jm.loss, rngs={"shuffle": jax.random.PRNGKey(3)},
                    mutable=["batch_stats"])
                total = sum(x for k, x in out.items() if k.startswith("loss"))
                return total, (out, mut["batch_stats"], perms[-1])

            (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, stats)
            train_maps, _ = jm.apply(
                ev, b, True, rngs={"shuffle": jax.random.PRNGKey(3)},
                mutable=["batch_stats"])
            return maps, dets, pinned, aux, grads, train_maps

        maps, dets, pinned, (jout, jstats, jperm), jgrads, train_maps = \
            jax.jit(run)(v["params"], v["batch_stats"], jb)
    finally:
        mp.undo()
    jperm = np.asarray(jperm)
    tm = load_flax_variables(_port_model(), v).eval()
    tb = tflag.tiny_batch(seed=BATCH_SEED).to("cpu")
    wm.reset_launch_counts()
    with torch.inference_mode():
        tmaps = tm(tb)
        tdets = tm.predict(tb)
        tpinned = tm.head_mod.get_bboxes(
            [{k: torch.from_numpy(np.array(x)) for k, x in m.items()}
             for m in maps], **TINY["test_cfg"])
    mp = pytest.MonkeyPatch()
    mp.setattr(tdvn, "voxel_permutation",
               lambda n, gen: torch.from_numpy(jperm.copy()).long())
    try:
        tm.train()
        tout = tm.loss(tb, generator=torch.Generator())
        sum(x for k, x in tout.items() if k.startswith("loss")).backward()
    finally:
        mp.undo()
    assert wm.launches == 0  # CPU tensors take the twin
    return dict(tm=tm, maps=maps, dets=dets, pinned=pinned, jout=jout,
                jstats=jstats, jgrads=jgrads, jperm=jperm, tmaps=tmaps,
                tdets=tdets, tpinned=tpinned, tout=tout,
                l1_margin=_l1_margin(train_maps, jb))


def _l1_margin(maps, batch) -> float:
    """The smallest |prediction - target| of the box loss's L1 terms in
    JAX's train-mode maps (its gradient is the sign of that difference: a
    difference inside the maps' tolerance may flip it)."""
    stride, lo = TINY["voxel_size"][0], TINY["point_cloud_range"][0]
    recip = np.float32(1.0) / np.float32(stride)
    gb, gl, gv = batch.gt_boxes, batch.gt_labels, batch.gt_valid
    rel = (gb[..., :2] - np.float32(lo)) * recip
    pix = np.floor(rel)
    h, w = np.asarray(maps[0]["heatmap"]).shape[1:3]
    inb = gv & (pix >= 0).all(-1) & (pix[..., 0] < w) & (pix[..., 1] < h)
    pc = np.clip(pix, 0, w - 1).astype(int)
    bi = np.arange(gb.shape[0])[:, None]
    tgt = np.concatenate([rel - (pc + 0.5), gb[..., 2:3] + gb[..., 5:6] / 2,
                          np.log(np.maximum(gb[..., 3:6], 1e-3)),
                          np.sin(gb[..., 6:7]), np.cos(gb[..., 6:7])], -1)
    margin = np.inf
    for t, m in enumerate(maps):
        pred = np.concatenate([np.asarray(m[k])[bi, pc[..., 1], pc[..., 0]]
                               for k in ("reg", "height", "dim", "rot")], -1)
        used = inb & (gl == t)
        margin = min(margin, np.abs(pred - tgt)[used].min())
    return float(margin)


def test_center_head_maps_match_jax(center_run):
    r = center_run
    assert len(r["tmaps"]) == len(r["maps"]) == 3
    for tmap, jmap in zip(r["tmaps"], r["maps"]):
        assert sorted(tmap) == sorted(jmap)
        for k in jmap:
            np.testing.assert_allclose(tmap[k].numpy(), np.asarray(jmap[k]),
                                       **MAP_TOL, err_msg=k)


def test_center_head_decode_of_jax_maps_is_jax_predict(center_run):
    """The port's decode of JAX's head maps gives JAX's detections, and
    JAX's predict is that decode of its maps."""
    r = center_run
    for k in ("boxes", "scores", "labels", "valid"):
        ref = np.asarray(r["pinned"][k])
        np.testing.assert_array_equal(np.asarray(r["dets"][k]), ref)
        got = r["tpinned"][k].numpy()
        if k in ("labels", "valid"):
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, err_msg=k,
                                       atol=2e-5 if k == "boxes" else 1e-6)
    assert int(r["tpinned"]["valid"].sum()) > 10
    for k in ("boxes", "scores", "labels", "valid"):
        assert r["tdets"][k].shape == r["pinned"][k].shape


def test_center_head_train_parity(center_run):
    r = center_run
    jout = {k: float(x) for k, x in r["jout"].items()}
    tout = {k: float(x.detach()) for k, x in r["tout"].items()}
    assert sorted(tout) == sorted(jout)
    for k in jout:
        if k.startswith("loss"):
            np.testing.assert_allclose(tout[k], jout[k], rtol=5e-4,
                                       err_msg=k)
        else:
            assert tout[k] == jout[k], k
    assert (r["jperm"] != np.arange(len(r["jperm"]))).any()
    assert r["l1_margin"] > MAP_TOL["atol"]
    gaps = []
    for path, ref in _leaves(r["jgrads"]):
        got = _torch_leaf(r["tm"], path, grad=True)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=0.12 * scale,
                                   err_msg="/".join(path))
        gaps.append((np.abs(got - ref) - 1e-2 * np.abs(ref)).max() / scale)
    assert len(gaps) == sum(1 for _ in r["tm"].parameters())
    assert np.median(gaps) <= 1e-2
    for path, ref in _leaves(r["jstats"]):
        got = _torch_leaf(r["tm"], path, grad=False)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg="/".join(path))


def _cosine_plan():
    rng = np.random.RandomState(1)
    n = 120
    cells = rng.choice(16 * 16, n, replace=False)
    coords = np.stack([np.zeros(n), np.zeros(n), cells // 16, cells % 16],
                      -1).astype(np.int32)
    valid = np.arange(n) < 110
    coords[~valid] = -1
    buckets = ((8, 0, 8, 16), (16, 8, 100000, 8))
    args = ((16, 16, 1), (4, 4))
    jplan = jin.sst_input_layer(
        jnp.asarray(coords), jnp.asarray(valid), *args,
        tuple(jwin.BucketSpec(*b) for b in buckets), 32, 64)
    tplan = tin.sst_input_layer(
        torch.from_numpy(coords), torch.from_numpy(valid), *args,
        tuple(twin.BucketSpec(*b) for b in buckets), 32, 64)
    return rng, n, jplan, tplan


@pytest.mark.parametrize("tau", [(0.3,), (0.7, 0.1, 1.3, 0.4)])
def test_cosine_window_attention_matches_jax(tau):
    """Forward and gradients (input, projections, ``tau``) of cosine
    attention; the second case has a ``tau`` per head, one clamped at
    ``tau_min`` (its gradient 0 in both)."""
    rng, n, jplan, tplan = _cosine_plan()
    non_shared = len(tau) > 1
    feat = rng.randn(n, 32).astype(np.float32)
    pos = np.asarray(jplan.pos[0])
    g = rng.randn(n, 32).astype(np.float32)
    jl = jsst.WindowAttention(32, 4, cosine=True, non_shared_tau=non_shared,
                              tau_min=TAU_MIN)
    v = jl.init(jax.random.PRNGKey(0), feat, jplan.pos[0], jplan.f2w[0])
    params = jax.tree_util.tree_map(np.array, v["params"])
    params["tau"] = np.asarray(tau, np.float32)

    def f(p, x):
        return jnp.sum(jl.apply({"params": p}, x, jplan.pos[0],
                                jplan.f2w[0]) * g)

    ref_out = np.asarray(_exact_bf16(lambda p, x: jl.apply(
        {"params": p}, x, jplan.pos[0], jplan.f2w[0]), params, feat))
    ref_gp, ref_gx = _exact_bf16(jax.grad(f, argnums=(0, 1)), params, feat)
    tl = load_flax_variables(
        WindowAttention(32, 4, cosine=True, non_shared_tau=non_shared,
                        tau_min=TAU_MIN),
        {"params": params})
    x = torch.from_numpy(feat).requires_grad_()
    out = tl(x, tplan.pos[0], tplan.f2w[0])
    (out * torch.from_numpy(g)).sum().backward()

    def close(got, ref, what, rel=2.0**-6):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=rel,
                                   atol=rel * np.abs(ref).max(), err_msg=what)

    close(out.detach().numpy(), ref_out, "output")
    close(x.grad.numpy(), ref_gx, "input gradient")
    # a sum of W * H * T^2 terms in bf16 on both sides (the logits' dtype
    # where they are divided), in other orders: 3.5e-2 measured
    close(tl.tau.grad.numpy(), ref_gp["tau"], "tau gradient", rel=5e-2)
    assert np.abs(np.asarray(ref_gp["tau"])).max() > 0
    if non_shared:
        assert float(tl.tau.grad[1]) == float(ref_gp["tau"][1]) == 0.0
    for name in ("qk_proj", "v_proj", "out_proj"):
        mod = getattr(tl, name)
        close(mod.weight.grad.numpy().T, ref_gp[name]["kernel"],
              f"{name} kernel gradient")
        close(mod.bias.grad.numpy(), ref_gp[name]["bias"],
              f"{name} bias gradient")


def test_wnms_config_predicts_at_full_width():
    """``configs/sst/sst_waymoD5_car_wnms.py`` at full width on the CPU:
    468² pillars, the whole 1.31 M-anchor grid decoded, the weighted NMS
    per class; finite boxes of the config's ``max_num`` rows."""
    from sst_tpu_torch.utils.builders import build_model_from_cfg
    from sst_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/sst/sst_waymoD5_car_wnms.py"))
    assert cfg["model"]["test_cfg"]["use_wnms"]
    m = tflag.init_weights(build_model_from_cfg(cfg, train=False,
                                                num_point_features=3,
                                                device="cpu"),
                           torch.Generator().manual_seed(0)).eval()
    b = tflag.synthetic_waymo_batch(1, 3000, seed=0, pcr_half=20.0)
    out = m.predict(b.to("cpu"))
    assert out["boxes"].shape == (1, 500, 7)
    assert torch.isfinite(out["boxes"]).all() and int(out["valid"].sum()) > 0
