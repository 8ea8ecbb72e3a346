"""FSD two stage at the bfloat16 compute policy against the JAX package, on
the CPU: ``tiny_fsd_two_stage(dtype=torch.bfloat16)`` against JAX's
``tiny_fsd_two_stage().clone(dtype=jnp.bfloat16)`` with the same seeded
float32 variables (``test_torch_ctrl.seeded_port_variables``) on
test_torch_fsd.py's ``fsd_batch`` frame: the segmentor, the pipeline from
its pre-voxelized points on, the proposals and the refined predict. One
jitted JAX function, compiled with XLA's excess precision off
(``_exact_bf16``); JAX runs its neighbour-table path (``gather_gemm``), the
port's CPU tensors the conv twin at bf16.

Pinned decisions. The pre-voxelization averages the bf16 segmentor
outputs into float32 rows (a concatenation with the float32 points), and
fg selection and CCL act on them; a bf16 ulp there moves a threshold, a
top-k cut or a connected-distance test. So the port's segmentor outputs
are held to JAX's (k = 2), and the port then runs on JAX's pre-voxelized
rows (a wrapper around ``pre_voxelize``): its fg selections, clusters and
point indices equal JAX's exactly, and SIR, the head, the RoI pooling and
the RoI head run at bf16 on the same points. The proposals' per-sample
top-k over bf16 scores (which tie) is fed JAX's selection, and the
bf16 sigmoids of the proposals and of the final decode are XLA's logistic
(one ulp off the correctly rounded sigmoid on about a third of inputs,
tests/test_torch_fsdv2_bf16.py); the pinned proposals are counted.

Tolerances in bf16 terms (``|got - ref| <= 2^-7 |ref| + k 2^-7 max|ref|``,
tests/test_torch_bf16_modules.py ``_close``), largest gaps measured
beside: segmentor outputs k = 2 (measured 0); SIR cluster and point
features, proposal boxes and scores and RoI features k = 2 (measured
0.85); the head outputs k = 6 (measured 3.76, a task's logits: the head's
three bf16 layers carry the SIR features' gap of up to 0.85 and scale it
by their weights); the refined and single-stage detections of JAX matched
by the port's (the same label, boxes within 2^-3 relative plus 0.25,
scores within 2^-5) at least three quarters of them (measured 32 of 32 and
11 of 12). Every output's dtype equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.models.fsd import two_stage as jts
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.fsd import two_stage as tts
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from test_torch_bf16_modules import _close, _dtype_name, _exact_bf16, _np
from test_torch_ctrl import seeded_port_variables
from test_torch_fsd import _everything
from test_torch_fsdv2_bf16 import _match, _xla_logistic
from torch_threads import torch_threads_per_worker  # noqa: F401

BF16 = jnp.bfloat16
_DATA = ("seg_points", "seg_logits", "seg_vote_preds", "offsets",
         "seg_feats", "batch_idx", "valid")


def _with_pipeline(m, b):
    """``_everything`` and the segmentor outputs and pre-voxelized rows it
    reads, from one pipeline."""
    out = _everything(m, b)
    pipe = m.rpn.run_pipeline(b, train=False, detach_seg=False)
    out["seg_out"] = {k: pipe["seg_out"][k] for k in (
        "seg_logits", "seg_vote_preds", "offsets", "seg_feats")}
    out["all_data"] = {k: pipe["data"][k] for k in _DATA}
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def run(monkeypatch_module):
    monkeypatch_module.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)
    jm = jflag.tiny_fsd_two_stage().clone(dtype=BF16)
    jb = jflag.fsd_batch(np.random.RandomState(1), p=512)
    v = seeded_port_variables(tflag.tiny_fsd_two_stage(device="cpu"))
    traced = []
    orig = jts.topk_compact

    def topk(scores, mask, k):
        idx, ok = orig(scores, mask, k)
        traced.append((idx, ok))
        return idx, ok

    def ref(vv, b):
        out = jm.apply(vv, b, method=_with_pipeline)
        return out, list(traced)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "topk_compact", topk)
        jout, jsel = _exact_bf16(ref, v, jb)
    jout = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "dtype") else x, jout)
    jsel = [tuple(torch.from_numpy(np.asarray(x)) for x in c) for c in jsel]

    batch = PointBatch(points=np.asarray(jb.points),
                       valid=np.asarray(jb.valid)).to("cpu")
    tm = load_flax_variables(tflag.tiny_fsd_two_stage(dtype=torch.bfloat16,
                                                      device="cpu"), v).eval()
    jdata = {k: torch.from_numpy(np.asarray(x))
             for k, x in jout["all_data"].items()}
    own, calls, seg_own = [], [0], {}
    real_topk, real_sigmoid = tts.topk_compact, torch.sigmoid
    pre_voxelize, run_pipeline = tm.rpn.pre_voxelize, tm.rpn.run_pipeline

    def pinned_pre_voxelize(data, b):
        pre_voxelize(data, b)
        return dict(jdata)

    def pinned_run_pipeline(*a, **kw):
        pipe = run_pipeline(*a, **kw)
        seg_own.update(pipe["seg_out"])
        return pipe

    def pinned_topk(scores, mask, k):
        idx, ok = real_topk(scores, mask, k)
        j_idx, j_ok = jsel[calls[0] % len(jsel)]
        calls[0] += 1
        own.append((idx, ok))
        return j_idx.long(), j_ok

    def sigmoid(x, *a, **kw):
        if x.dtype == torch.bfloat16:
            return _xla_logistic(x)
        return real_sigmoid(x, *a, **kw)

    scg.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mp.setattr(tts, "topk_compact", pinned_topk)
        mp.setattr(torch, "sigmoid", sigmoid)
        tm.rpn.pre_voxelize = pinned_pre_voxelize
        tm.rpn.run_pipeline = pinned_run_pipeline
        tout = _everything(tm, batch)
        del tm.rpn.pre_voxelize, tm.rpn.run_pipeline
    assert scg.launches == 0  # CPU tensors take the twin
    pinned = sum(int((set(np.flatnonzero(o[1].numpy()))
                      != set(np.flatnonzero(j[1].numpy())))
                     or not torch.equal(o[0][o[1]], j[0][j[1]].long()))
                 for o, j in zip(own, jsel))
    return dict(jout=jout, tout=tout, seg_own=seg_own, pinned=pinned,
                n_topk=len(own))


def test_fsd_bf16_segmentor_matches_jax(run):
    gaps = [_close(run["seg_own"][k], run["jout"]["seg_out"][k], 2.0, k)
            for k in ("seg_logits", "seg_vote_preds", "offsets",
                      "seg_feats")]
    assert _dtype_name(run["seg_own"]["seg_logits"]) == "bfloat16"
    print(f"\nFSD bf16 segmentor: largest gap {max(gaps):.3f}")


def test_fsd_bf16_pipeline_matches_jax(run):
    """On JAX's pre-voxelized rows: fg selections, clusters and point
    indices exactly; SIR features, head outputs, pinned proposals and RoI
    features at bf16."""
    jout, tout = run["jout"], run["tout"]
    for k in ("cluster_valid", "cluster_batch", "pt_seg_ids", "pt_valid",
              "pt_idx"):
        np.testing.assert_array_equal(_np(tout["ex"][k]), jout["ex"][k],
                                      err_msg=k)
    assert int(jout["ex"]["cluster_valid"].sum()) > 0
    gaps = [_close(tout["ex"][k], jout["ex"][k], 2.0, k)
            for k in ("cluster_xyz", "cluster_feats", "pt_feats")]
    head = [_close(got, ref, 6.0, k) for k in ("cls_logits", "reg_preds")
            for got, ref in zip(tout["outs"][k], jout["outs"][k])]
    boxes, scores, labels, valid, batch = tout["props"]
    jboxes, jscores, jlabels, jvalid, jbatch = jout["props"]
    np.testing.assert_array_equal(_np(valid), jvalid)
    np.testing.assert_array_equal(_np(batch), jbatch)
    gaps.append(_close(boxes, jboxes, 2.0, "proposal boxes"))
    gaps.append(_close(scores, jscores, 2.0, "proposal scores"))
    gaps.append(_close(tout["roi_feats"], jout["roi_feats"], 2.0,
                       "roi feats"))
    print(f"\nFSD bf16 pipeline: largest gap {max(gaps):.3f}, head outputs "
          f"{max(head):.3f}; proposal "
          f"selections pinned {run['pinned']} of {run['n_topk']}")
    assert run["n_topk"] == 2  # one per sample


@pytest.mark.parametrize("which", ["rpn", "pred"])
def test_fsd_bf16_detections_match_jax(run, which):
    """The single stage's and the refined detections: JAX's dtypes, and at
    least three quarters of JAX's valid detections matched."""
    ref = {k: np.asarray(x)[None] if np.asarray(x).ndim < 2 else
           np.asarray(x) for k, x in run["jout"][which].items()}
    got = run["tout"][which]
    for k in ("boxes", "scores", "labels", "valid"):
        assert _dtype_name(got[k]) == _dtype_name(run["jout"][which][k]), k
    n = int(ref["valid"][0].sum())
    lost, _, box_gap, score_gap = _match(ref, got, 2.0**-3, 2.0**-5,
                                         box_atol=0.25)
    print(f"\nFSD bf16 {which}: {n - len(lost)} of {n} of JAX's sample-0 "
          f"detections matched, box gap {box_gap:.4f}, score gap "
          f"{score_gap:.4f}")
    assert n > 0 and len(lost) <= n // 4
