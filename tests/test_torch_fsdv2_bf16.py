"""Slice-level parity of the dense-BEV FSDv2 at the bfloat16 compute policy
(``fsdv2_waymo_dense``'s default) with the JAX package, on the CPU:
``tiny_fsdv2_dense(dtype=torch.bfloat16)`` against JAX's
``tiny_fsdv2_dense().clone(dtype=jnp.bfloat16)`` with the same float32
weights (the port's seeded ``init_weights`` and random running statistics,
converted into a flax variable tree), ``predict`` on the frame of
test_torch_fsdv2.py and ``loss`` in train mode (``pretrain=False``) on the
labelled frame of test_torch_fsdv2_train.py against one jitted JAX
``value_and_grad``. Both JAX functions are compiled with XLA's excess
precision off (``_exact_bf16`` of tests/test_torch_bf16_modules.py), so
JAX rounds every bf16 value as its dtype says, as the port does.

Pinned decisions. The two packages' bf16 networks differ by about an ulp
(tests/test_torch_bf16_modules.py), and XLA's bf16 logistic is one ulp off
the correctly rounded sigmoid (torch's) on about a third of its inputs, so
the discrete steps downstream of the segmentor flip where a margin is
under the gap between the packages: a fg threshold or a per-class top-k
cut (bf16 scores tie often; ties go to the lower index in both), and the
virtual voxel of a vote-shifted centre near a voxel face. The test records
JAX's ``topk_compact`` results in its jitted run and feeds them to the
port's (the fg selections and the virtual-voxel compaction), with JAX's
``offsets`` (a wrapper around ``extract_feat``); it counts the decisions
the port's own values would have changed, prints the count, asserts that
each changed fg decision lies within the score gap of its threshold or
cut and that fewer than half of the selected points were pinned (measured
12 of 128 in predict, 2 in train, no virtual voxel moved). The NMS's
decisions are pinned by decoding JAX's head outputs through the port's
``get_bboxes`` with XLA's logistic in place of torch's sigmoid.

Tolerances in bf16 terms (``|got - ref| <= 2^-7 |ref| + k 2^-7 max|ref|``,
see tests/test_torch_bf16_modules.py), with the largest gaps measured:
  - predict: segmentor outputs, decoder maps and head outputs k = 2
    (measured 1.07); the detection branch's discrete outputs and float32
    centres exactly; detections as stated in their test;
  - train: seg logits and offsets k = 2 (measured 0); losses rtol 2^-7
    (measured 1.2e-3); each gradient leaf k = 8 of its own largest
    magnitude (measured 5.29); running statistics as in the module tests
    (rtol 2^-7 plus 2^-7 of the largest).
Every output's dtype equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import layers as tl
from sst_tpu_torch.ops.ccl import topk_compact
from test_torch_bf16_modules import _close, _dtype_name, _exact_bf16, _np
from test_torch_fsdv2_dense_train import _flax_variables, _torch_leaf
from test_torch_fsdv2_train import FRAME, _leaves
from torch_threads import torch_threads_per_worker  # noqa: F401

BF16 = jnp.bfloat16
ULP = 2.0**-7


def _bf16(x) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor (exact)."""
    return torch.from_numpy(np.asarray(x).astype(np.float32)).bfloat16()


def _xla_logistic(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``sigmoid`` of a bf16 tensor: XLA's bf16 logistic, one ulp off
    the correctly rounded sigmoid (torch's) on about a third of inputs."""
    return _bf16(jax.nn.sigmoid(jnp.asarray(_np(x)).astype(BF16)))


def _models():
    tm = tflag.init_weights(
        tflag.tiny_fsdv2_dense(dtype=torch.bfloat16, device="cpu"),
        torch.Generator().manual_seed(0))
    v = _flax_variables(tm)
    tm = load_flax_variables(
        tflag.tiny_fsdv2_dense(dtype=torch.bfloat16, device="cpu"), v)
    return tm, jflag.tiny_fsdv2_dense().clone(dtype=BF16), v


class _Pins:
    """JAX's selections and vote offsets, recorded in its jitted run and fed
    to the port.

    ``record()`` wraps JAX's ``topk_compact`` while JAX's function is
    traced: every call's (indices, valid, scores) become extra outputs. The
    port's ``topk_compact`` then returns JAX's result for the same call (the
    per-class fg selections, then the virtual-voxel compaction), and a
    wrapper around the port's ``extract_feat`` swaps in JAX's ``offsets``,
    which place the vote-shifted centres in their virtual voxels. The
    port's own results are kept to count what was pinned."""

    def __init__(self):
        self.traced = []
        self.jax = None
        self.own = []
        self.own_data = {}

    def record(self, mp):
        from sst_tpu.models.fsd import fsdv2 as jfsd

        orig = jfsd.topk_compact

        def topk(scores, mask, k):
            idx, ok = orig(scores, mask, k)
            self.traced.append((idx, ok, scores))
            return idx, ok

        mp.setattr(jfsd, "topk_compact", topk)

    def outputs(self):
        out, self.traced = list(self.traced), []
        return out

    def feed(self, mp, tm, jax_sel, jseg):
        from sst_tpu_torch.models.fsd import fsdv2 as tfsd

        self.jax = [tuple(torch.from_numpy(np.asarray(x)) for x in c[:2])
                    for c in jax_sel]

        def topk(scores, mask, k):
            idx, ok = topk_compact(scores, mask, k)
            j_idx, j_ok = self.jax[len(self.own) % len(self.jax)]
            self.own.append((idx, ok, scores))
            return j_idx.long(), j_ok

        mp.setattr(tfsd, "topk_compact", topk)
        extract_feat = tm.extract_feat

        def pinned(data, *args, **kw):
            self.own_data.update(data)
            return extract_feat(dict(data, offsets=_bf16(jseg["offsets"])),
                                *args, **kw)

        tm.extract_feat = pinned


def _pinned_decisions(tm, pins: _Pins, jax_sel, jseg) -> dict:
    """The decisions the port's own values change against JAX's: per class
    the points that enter or leave the fg selection, each asserted to lie
    within the score gap of the class's threshold or top-k cut (the gap
    holds the bf16 networks' difference and XLA's bf16 logistic, which is
    one ulp off the correctly rounded sigmoid on about a third of its
    inputs, where torch's is exact); the selected virtual points whose
    voxel moves with the port's own offsets; the virtual voxels that enter
    or leave the compaction."""
    own = pins.own_data
    n_cls = tm.num_classes
    pcr = np.asarray(tm.point_cloud_range)
    vsz = np.asarray(tm.virtual_voxel_size)
    valid = own["valid"].numpy()
    fg_flips, voxel_moves, n_sel = 0, 0, 0
    for c, thr in enumerate(tm.score_thresh):
        t_idx, t_ok, s_t = pins.own[c]
        j_idx, j_ok, s_j = (np.asarray(x) for x in jax_sel[c])
        s_t, s_j = _np(s_t).astype(np.float64), _np(s_j).astype(np.float64)
        gap = np.abs(s_t - s_j)[valid].max()
        flips = set(t_idx[t_ok].numpy()) ^ set(j_idx[j_ok])
        cap = tm.caps.fg_per_class[c]
        fg = np.sort(s_j[valid & (s_j > thr)])[::-1]
        cut = fg[cap - 1] if len(fg) >= cap else thr
        for p in flips:
            margin = min(abs(s_j[p] - thr), abs(s_j[p] - cut))
            assert margin <= gap, (c, int(p), margin, gap)
        fg_flips += len(flips)
        idx = torch.from_numpy(j_idx[j_ok]).long()
        n_sel += len(idx)
        xyz = own["seg_points"][idx, :3]
        cells = []
        for offsets in (own["offsets"], _bf16(jseg["offsets"])):
            off = offsets[idx].reshape(-1, n_cls, 3)[:, c].float()
            cells.append(np.floor((tm._clip(xyz + off).numpy() - pcr[:3])
                                  / vsz))
        voxel_moves += int((cells[0] != cells[1]).any(-1).sum())
    t_idx, t_ok, _ = pins.own[n_cls]
    j_idx, j_ok, _ = jax_sel[n_cls]
    compaction = len(set(t_idx[t_ok].numpy())
                     ^ set(np.asarray(j_idx)[np.asarray(j_ok)]))
    return dict(fg=fg_flips, voxel=voxel_moves, compaction=compaction,
                selected=n_sel)


def _match(ref: dict, got: dict, box_tol: float, score_tol: float,
           box_atol: float = 1e-5):
    """Pairs JAX's valid detections (frame 0) with the port's of the same
    label, nearest box first, each box value within ``box_tol`` relative
    plus ``box_atol``. Returns the scores of the unmatched of each
    side and the largest box and score gaps of the pairs."""
    jv, tv = _np(ref["valid"])[0] > 0, _np(got["valid"])[0] > 0
    jb, tb = _np(ref["boxes"])[0][jv], _np(got["boxes"])[0][tv]
    jl, tl_ = _np(ref["labels"])[0][jv], _np(got["labels"])[0][tv]
    js, ts = _np(ref["scores"])[0][jv], _np(got["scores"])[0][tv]
    free = set(range(len(tb)))
    lost, box_gap, score_gap = [], 0.0, 0.0
    for i in np.argsort(-js, kind="stable"):
        cand = [(np.abs(jb[i] - tb[k]).max(), k) for k in free
                if tl_[k] == jl[i] and abs(js[i] - ts[k]) <= score_tol
                and (np.abs(jb[i] - tb[k])
                     <= box_tol * np.abs(jb[i]) + box_atol).all()]
        d, k = min(cand) if cand else (np.inf, None)
        if k is None:
            lost.append(float(js[i]))
            continue
        free.discard(k)
        box_gap = max(box_gap, d)
        score_gap = max(score_gap, abs(js[i] - ts[k]))
    return lost, [float(ts[k]) for k in free], box_gap, score_gap


# ---------------------------------------------------------------- predict


@pytest.fixture(scope="module")
def predict_run():
    tm, jm, v = _models()
    batch = tflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8)
    jb = jflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8)
    pins = _Pins()

    def pipe_and_pred(m, b):
        pipe = m.run_pipeline(b, False, detach_seg=False)
        ex = pipe["ex"]
        pred = m.head_mod.get_bboxes(pipe["outs"], ex["virtual_centers"],
                                     ex["virtual_batch"],
                                     ex["virtual_valid"], 1, **m.test_cfg)
        return pipe, pred, pins.outputs()

    with pytest.MonkeyPatch.context() as mp:
        pins.record(mp)
        jpipe, jpred, jsel = _exact_bf16(lambda vv, b: jm.apply(
            vv, b, method=pipe_and_pred), v, jb)
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        pins.feed(mp, tm, jsel, jpipe["seg_out"])
        tm.eval()
        tpipe = tm.run_pipeline(batch.to("cpu"), detach_seg=False)
        tpred = tm.predict(batch.to("cpu"))
        ex = jpipe["ex"]
        # NMS pinned: the port's decode + NMS on JAX's head outputs, with
        # XLA's bf16 logistic in place of torch's sigmoid
        outs = {k: [_bf16(x) for x in jpipe["outs"][k]] for k in
                ("cls_logits", "reg_preds")}
        logistic_pins = sum(int((_xla_logistic(x) != torch.sigmoid(x)).sum())
                            for x in outs["cls_logits"])
        mp.setattr(torch, "sigmoid", _xla_logistic)
        tpred_j = tm.head_mod.get_bboxes(
            outs,
            torch.from_numpy(np.asarray(ex["virtual_centers"])),
            torch.from_numpy(np.asarray(ex["virtual_batch"])),
            torch.from_numpy(np.asarray(ex["virtual_valid"])), 1,
            **tm.test_cfg)
    return dict(tm=tm, jpipe=jpipe, jpred=jpred, jsel=jsel, tpipe=tpipe,
                tpred=tpred, tpred_j=tpred_j, pins=pins,
                logistic_pins=logistic_pins,
                n_scores=sum(x.numel() for x in outs["cls_logits"]))


def test_bf16_is_the_flagship_default_and_f32_an_option():
    """``fsdv2_waymo_dense()`` and ``fsdv2_waymo()`` build JAX's default:
    bf16 compute with float32 parameters and running statistics;
    ``dtype=torch.float32`` builds the float32 model; ``tiny_fsdv2_dense``
    stays float32 unless asked."""
    m = tflag.fsdv2_waymo_dense(device="cpu")
    for built in (m, tflag.fsdv2_waymo(device="cpu")):
        assert built.segmentor_mod.unet_mod.enc_0_0.Conv_0.dtype == \
            torch.bfloat16
        assert built.head_mod.task_0.score.Dense_0.dtype == torch.bfloat16
        assert {t.dtype for t in built.state_dict().values()
                if t.is_floating_point()} == {torch.float32}
    f32 = tflag.fsdv2_waymo_dense(dtype=torch.float32, device="cpu")
    assert {getattr(mod, "dtype") for mod in f32.modules()
            if isinstance(mod, (tl.Dense, tl.Conv, tl.LayerNorm,
                                tl.BatchNorm))} == {torch.float32}
    assert tflag.tiny_fsdv2_dense(device="cpu").head_mod.task_0.score \
        .Dense_0.dtype == torch.float32


def test_bf16_sparse_build_raises():
    """JAX's sparse flagship is float32; a bf16 sparse build waits for the
    conv kernels' bf16 routes."""
    with pytest.raises(NotImplementedError, match="sparse"):
        tflag.fsdv2_waymo(backbone="sparse", dtype=torch.bfloat16,
                          device="cpu")
    assert tflag.fsdv2_waymo(backbone="sparse", device="cpu") \
        .head_mod.task_0.score.Dense_0.dtype == torch.float32


def test_predict_parity_tiny_fsdv2_dense_bf16(predict_run):
    r = predict_run
    seg_j, seg_t = r["jpipe"]["seg_out"], r["tpipe"]["seg_out"]
    for k in ("seg_logits", "seg_vote_preds", "offsets", "seg_feats"):
        _close(seg_t[k], seg_j[k], 2.0, k)
    np.testing.assert_array_equal(_np(seg_t["valid"]), _np(seg_j["valid"]))
    for got, ref in zip(seg_t["decoder_maps"], seg_j["decoder_maps"]):
        _close(got, ref, 2.0, "decoder map")
    pins = _pinned_decisions(r["tm"], r["pins"], r["jsel"], seg_j)
    print(f"\npinned decisions (bf16 predict): {pins}")
    assert pins["fg"] + pins["voxel"] <= pins["selected"] // 2
    ex_j, ex_t = r["jpipe"]["ex"], r["tpipe"]["ex"]
    for k in ("virtual_valid", "virtual_batch", "num_virtual",
              "num_union_overflow_points", "virtual_centers",
              "virtual_centroid"):
        assert _dtype_name(ex_t[k]) == _dtype_name(ex_j[k]), k
        np.testing.assert_array_equal(_np(ex_t[k]), _np(ex_j[k]), err_msg=k)
    assert int(ex_j["num_virtual"]) > 0
    _close(ex_t["virtual_feats"], ex_j["virtual_feats"], 2.0, "feats")
    for k in ("cls_logits", "reg_preds"):
        for got, ref in zip(r["tpipe"]["outs"][k], r["jpipe"]["outs"][k]):
            _close(got, ref, 2.0, k)


def test_predict_detections_tiny_fsdv2_dense_bf16(predict_run):
    """Decode + NMS pinned to JAX's head outputs (XLA's logistic in place
    of torch's sigmoid, which differs by one ulp on 37 of the 192 scores):
    JAX's detections, equal as a set, in JAX's dtypes. The port's own
    detections, from its own head outputs (k = 2 of JAX's), are counted
    against JAX's at that noise (boxes 2^-3 relative plus 0.25, scores
    2^-5): the NMS's IoU threshold and the top-k cut flip inside it, so at
    least three quarters must match (measured 14 of 16)."""
    r = predict_run
    jpred, tpred_j = r["jpred"], r["tpred_j"]
    for k in ("boxes", "scores", "labels", "valid"):
        assert _dtype_name(r["tpred"][k]) == _dtype_name(jpred[k]), k
        assert _dtype_name(tpred_j[k]) == _dtype_name(jpred[k]), k
    assert _dtype_name(jpred["scores"]) == "bfloat16"
    n = int(_np(jpred["valid"]).sum())
    assert n > 0 and int(_np(tpred_j["valid"]).sum()) == n
    lost, extra, _, _ = _match(jpred, tpred_j, 0.0, 0.0, box_atol=0.0)
    assert lost == [] and extra == [], (lost, extra)
    assert 0 < r["logistic_pins"] <= r["n_scores"] // 2
    own = _match(jpred, r["tpred"], 2.0**-3, 2.0**-5, box_atol=0.25)
    print(f"\nbf16 detections: {n} valid; NMS pinned: all equal, "
          f"{r['logistic_pins']} of {r['n_scores']} scores pinned to XLA's "
          f"logistic; the port's own: {n - len(own[0])} of {n} matched, box "
          f"gap {own[2]:.3f}, score gap {own[3]:.4f}")
    assert len(own[0]) <= n // 4


# ------------------------------------------------------------------ train


def _pipeline_losses(m, b):
    """``pretrain=False`` losses, and the seg outputs the pins read."""
    pipe = m.run_pipeline(b, True, 0.0, False)
    seg = pipe["seg_out"]
    return m.losses_from_pipeline(b, pipe), {
        k: seg[k] for k in ("seg_logits", "offsets", "valid", "seg_points")}


@pytest.fixture(scope="module")
def train_run():
    tm, jm, v = _models()
    jb, _ = jflag.synthetic_labeled_batch(**FRAME)
    pins = _Pins()

    def loss_fn(params, stats, b):
        (out, seg), mut = jm.apply(
            {"params": params, "batch_stats": stats}, b,
            method=_pipeline_losses, mutable=["batch_stats"])
        total = sum(x for k, x in out.items() if k.startswith("loss"))
        return total, (out, seg, mut["batch_stats"], pins.outputs())

    with pytest.MonkeyPatch.context() as mp:
        pins.record(mp)
        (_, (jout, jseg, jstats, jsel)), jgrads = _exact_bf16(
            jax.value_and_grad(loss_fn, has_aux=True),
            v["params"], v["batch_stats"], jb)
    tb = tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu")
    # the float32 gradient along the same pinned path: the port's float32
    # build (held to JAX's float32 one in test_torch_fsdv2_dense_train.py)
    t32 = load_flax_variables(
        tflag.tiny_fsdv2_dense(dtype=torch.float32, device="cpu"), v)
    for m in (tm, t32):
        with pytest.MonkeyPatch.context() as mp:
            if m is tm:
                pins.feed(mp, m, jsel, jseg)
            else:
                _Pins().feed(mp, m, jsel, jseg)
            out, _ = _pipeline_losses(m, tb)
            sum(x for k, x in out.items() if k.startswith("loss")).backward()
        if m is tm:
            tout = out
    return dict(tm=tm, t32=t32, jout=jout, jseg=jseg, jstats=jstats,
                jgrads=jgrads, jsel=jsel, tout=tout, pins=pins)


def test_train_parity_tiny_fsdv2_dense_bf16(train_run):
    """Losses at rtol 2^-7 (largest gap measured 1.2e-3 relative);
    running statistics at rtol 2^-7 plus 2^-7 of each leaf's largest (as
    the module tests).

    Gradients. Every leaf is held to JAX's within 2^-7 of each value plus
    8 ulps (8 x 2^-7) of the leaf's own largest magnitude (largest gap
    measured 5.29 ulps, on a UNet BatchNorm bias). That is far inside the
    bf16 policy's own effect: JAX's bf16 gradient lies up to 1.17 of a
    leaf's largest magnitude from the float32 gradient on the same pinned
    path (the port's float32 build, held to JAX's float32 one in
    test_torch_fsdv2_dense_train.py), 0.085 root mean square, because bf16
    maxima tie where float32 ones do not and norm gradients cancel to small
    sums of bf16 terms. Over all leaves (each over its float32 scale) the
    port's gradient points with JAX's (cosine >= 0.999, measured 0.99993)
    and lies as far from the float32 gradient as JAX's (root mean square,
    0.95 to 1.05 times, measured 0.998), so a float32 backward would
    fail."""
    r = train_run
    pins = _pinned_decisions(r["tm"], r["pins"], r["jsel"], r["jseg"])
    print(f"\npinned decisions (bf16 train): {pins}")
    assert pins["fg"] + pins["voxel"] <= pins["selected"] // 2
    for k in ("seg_logits", "offsets"):
        _close(r["pins"].own_data[k], r["jseg"][k], 2.0, k)
    jout, tout = r["jout"], r["tout"]
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert _dtype_name(tout[k]) == _dtype_name(jout[k]), k
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]),
                                   rtol=ULP, atol=1e-6, err_msg=k)
    assert float(jout["loss_vote"]) > 0 and float(jout["num_virtual"]) > 0
    port, ref, f32, gaps = [], [], [], {}
    for path, j in _leaves(r["jgrads"]):
        got = _torch_leaf(r["tm"], path, grad=True)
        truth = _torch_leaf(r["t32"], path, grad=True)
        assert got.dtype == j.dtype == np.float32, path
        gaps["/".join(path)] = _close(
            torch.from_numpy(np.ascontiguousarray(got)), j, 8.0,
            "/".join(path))
        scale = np.abs(truth).max()
        if scale > 0:
            port.append(got.ravel() / scale)
            ref.append(j.ravel() / scale)
            f32.append(truth.ravel() / scale)
    worst = max(gaps, key=gaps.get)
    port, ref, f32 = (np.concatenate(x) for x in (port, ref, f32))
    cos = float(port @ ref / np.linalg.norm(port) / np.linalg.norm(ref))
    err = np.linalg.norm(port - f32) / np.linalg.norm(ref - f32)
    print(f"gradients: port vs JAX cosine {cos:.6f}, distance from float32 "
          f"{err:.4f} x JAX's, largest leaf gap {gaps[worst]:.2f} ({worst})")
    assert cos >= 0.999 and 0.95 <= err <= 1.05
    kinds = set()
    for path, j in _leaves(r["jstats"]):
        got = _torch_leaf(r["tm"], path, grad=False)
        np.testing.assert_allclose(got, j, rtol=ULP,
                                   atol=ULP * np.abs(j).max(),
                                   err_msg="/".join(path))
        kinds.add(type(r["tm"].get_submodule(".".join(path[:-1]))))
    assert kinds == {tl.BatchNorm, tl.MaskedBatchNorm}


def test_every_parameter_of_the_bf16_build_gets_a_float32_gradient(
        train_run):
    """The parameters stay float32 and every one gets a float32 gradient
    through the casts' backward, as flax's ``param_dtype`` gives."""
    for name, p in train_run["tm"].named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
