"""Slice-level parity of the sparse-UNet FSDv2 at the bfloat16 compute
policy with the JAX package, on the CPU: ``tiny_fsdv2_flagship(dtype=
torch.bfloat16)`` against JAX's ``tiny_fsdv2_flagship().clone(dtype=
jnp.bfloat16)`` with the same seeded float32 variables
(``test_torch_ctrl.seeded_port_variables``), ``predict`` on the frame of
test_torch_fsdv2_sparse.py and ``loss`` in train mode (``pretrain=False``)
on the labelled frame of test_torch_fsdv2_train.py, against one jitted
JAX predict and one jitted ``value_and_grad``, traced in turn and
compiled together in threads with XLA's excess precision off
(``_exact_bf16``'s option). The port's CPU tensors take the sparse conv,
input-gradient and dW twins at bf16 (the kernels' bf16 function); JAX runs
its neighbour-table path (``gather_gemm``, the same forward function).

Pinned decisions, as tests/test_torch_fsdv2_bf16.py pins the dense build's
(its ``_Pins``): JAX's ``topk_compact`` results (the per-class fg
selections, the virtual-voxel compaction) and JAX's vote offsets are fed
to the port; the decisions the port's own values would have changed are
counted, each changed fg decision asserted to lie within the score gap of
its threshold or cut, and fewer than half of the selected points pinned.
The NMS is pinned by decoding JAX's head outputs with XLA's logistic.

Tolerances in bf16 terms (``|got - ref| <= 2^-7 |ref| + k 2^-7 max|ref|``,
tests/test_torch_bf16_modules.py ``_close``), largest gaps measured:
  - predict: segmentor outputs, decoder features, virtual features and
    head outputs k = 2 (measured 0); the virtual voxels' discrete outputs
    and float32 centres exactly; JAX's detections equal through the
    pinned NMS;
  - train: seg logits and offsets k = 2; losses rtol 2^-7; running
    statistics rtol 2^-7 plus 2^-7 of each leaf's largest.
Gradients. A bf16 gradient of this model is a rough estimate of the
float32 one: JAX's lies at a cosine of 0.94 from the float32 gradient on
the same pinned path (the port's float32 build, held to JAX's float32 one
in test_torch_fsdv2_train.py), up to half of a leaf's norm away. And JAX's
table path scatters each conv's input-gradient tap terms into a bf16
buffer one add at a time, where its Pallas vjp and the port sum them in
f32 and round once (held to one ulp of the Pallas vjp in
tests/test_torch_sparse_bf16.py). So the port is held to JAX as an
estimate of the same float32 gradient: every leaf float32, its distance
from JAX's at most JAX's own distance from the float32 gradient plus 2^-5
of the leaf's norm (largest excess measured 0.0138, a VFE norm bias); over
all leaves (each over its largest magnitude) a cosine with JAX's of at
least 0.99 (measured 0.9928) and a distance from the float32 gradient
0.9 to 1.1 times JAX's (measured 1.0585), so a backward that dropped or
doubled a term, or ran in float32, would fail.
Every output's dtype equals JAX's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models.sparse_unet import SparseConvLayer
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from test_torch_bf16_modules import _close, _dtype_name, _np
from test_torch_ctrl import seeded_port_variables
from test_torch_fsdv2_bf16 import (
    _bf16,
    _match,
    _pinned_decisions,
    _Pins,
    _pipeline_losses,
    _xla_logistic,
)
from test_torch_fsdv2_train import FRAME, _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

BF16 = jnp.bfloat16
ULP = 2.0**-7


def compile_exact(calls):
    """Each ``(f, args)`` jitted: traced in turn, compiled together in
    threads with XLA's excess precision off, and run; numpy trees."""
    lowered = [(jax.jit(f).lower(*args), args) for f, args in calls]
    opts = {"xla_allow_excess_precision": False}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(
            lambda la: la[0].compile(compiler_options=opts), lowered))
    return [jax.tree_util.tree_map(np.asarray, c(*args))
            for c, (_, args) in zip(compiled, lowered)]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def run(monkeypatch_module):
    monkeypatch_module.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)
    bf = torch.bfloat16
    v = seeded_port_variables(tflag.tiny_fsdv2_flagship(dtype=bf,
                                                        device="cpu"))
    tm = load_flax_variables(tflag.tiny_fsdv2_flagship(dtype=bf,
                                                       device="cpu"), v)
    jm = jflag.tiny_fsdv2_flagship().clone(dtype=BF16)
    jb = jflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8)
    jlb, _ = jflag.synthetic_labeled_batch(**FRAME)
    pins = _Pins()

    def pipe_and_pred(m, b):
        pipe = m.run_pipeline(b, False, detach_seg=False)
        ex = pipe["ex"]
        pred = m.head_mod.get_bboxes(pipe["outs"], ex["virtual_centers"],
                                     ex["virtual_batch"],
                                     ex["virtual_valid"], 1, **m.test_cfg)
        return pipe, pred, pins.outputs()

    def loss_fn(params, stats, b):
        (out, seg), mut = jm.apply(
            {"params": params, "batch_stats": stats}, b,
            method=_pipeline_losses, mutable=["batch_stats"])
        total = sum(x for k, x in out.items() if k.startswith("loss"))
        return total, (out, seg, mut["batch_stats"], pins.outputs())

    with pytest.MonkeyPatch.context() as mp:
        pins.record(mp)
        (jpipe, jpred, jsel), ((_, (jout, jseg, jstats, jtsel)), jgrads) = \
            compile_exact([
                (lambda vv, b: jm.apply(vv, b, method=pipe_and_pred),
                 (v, jb)),
                (jax.value_and_grad(loss_fn, has_aux=True),
                 (v["params"], v["batch_stats"], jlb))])

    # predict, pinned
    batch = tflag.synthetic_waymo_batch(1, 2048, pcr_half=3.8).to("cpu")
    scg.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        pins.feed(mp, tm, jsel, jpipe["seg_out"])
        tm.eval()
        tpipe = tm.run_pipeline(batch, detach_seg=False)
        tpred = tm.predict(batch)
        outs = {k: [_bf16(x) for x in jpipe["outs"][k]] for k in
                ("cls_logits", "reg_preds")}
        mp.setattr(torch, "sigmoid", _xla_logistic)
        ex = jpipe["ex"]
        tpred_j = tm.head_mod.get_bboxes(
            outs, torch.from_numpy(np.asarray(ex["virtual_centers"])),
            torch.from_numpy(np.asarray(ex["virtual_batch"])),
            torch.from_numpy(np.asarray(ex["virtual_valid"])), 1,
            **tm.test_cfg)
    predict_pins = _pinned_decisions(tm, pins, jsel, jpipe["seg_out"])
    del tm.extract_feat  # the pin's wrapper, an instance attribute

    # train, pinned; and the float32 gradient along the same pinned path
    # (the port's float32 build, held to JAX's in test_torch_fsdv2_train.py)
    tpins = _Pins()
    tb = tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu")
    t32 = load_flax_variables(tflag.tiny_fsdv2_flagship(device="cpu"), v)
    for m, p in ((tm, tpins), (t32, _Pins())):
        m.train()
        with pytest.MonkeyPatch.context() as mp:
            p.feed(mp, m, jtsel, jseg)
            out, _ = _pipeline_losses(m, tb)
            sum(x for k, x in out.items() if k.startswith("loss")).backward()
        if m is tm:
            tout = out
    assert scg.launches == 0  # CPU tensors take the twins
    return dict(tm=tm, t32=t32, jpipe=jpipe, jpred=jpred, tpipe=tpipe,
                tpred=tpred, tpred_j=tpred_j, predict_pins=predict_pins,
                jout=jout, jseg=jseg, jstats=jstats, jgrads=jgrads,
                jtsel=jtsel, tout=tout, tpins=tpins)


def test_bf16_sparse_build_runs_the_convs_at_bf16():
    """Every sparse conv of the bf16 build casts its float32 weight to
    bf16 and runs the bf16 route: the launch keys of a CUDA run carry
    "bfloat16"; here, on the CPU, every conv's input and output is bf16."""
    tm = tflag.init_weights(
        tflag.tiny_fsdv2_flagship(dtype=torch.bfloat16, device="cpu"),
        torch.Generator().manual_seed(0)).eval()
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, a, out: seen.append((a[0].dtype, out.dtype)))
        for m in tm.modules() if isinstance(m, SparseConvLayer)]
    with torch.inference_mode():
        tm.predict(tflag.synthetic_waymo_batch(1, 2048,
                                               pcr_half=3.8).to("cpu"))
    for h in hooks:
        h.remove()
    n = sum(isinstance(m, SparseConvLayer) for m in tm.modules())
    assert len(seen) == n > 0
    assert set(seen) == {(torch.bfloat16, torch.bfloat16)}
    assert {p.dtype for p in tm.parameters()} == {torch.float32}


def test_predict_parity_tiny_fsdv2_flagship_bf16(run):
    r = run
    seg_j, seg_t = r["jpipe"]["seg_out"], r["tpipe"]["seg_out"]
    gaps = []
    for k in ("seg_logits", "seg_vote_preds", "offsets", "seg_feats"):
        gaps.append(_close(seg_t[k], seg_j[k], 2.0, k))
    np.testing.assert_array_equal(_np(seg_t["valid"]), _np(seg_j["valid"]))
    for got, ref in zip(seg_t["decoder_features"],
                        seg_j["decoder_features"]):
        gaps.append(_close(got, ref, 2.0, "decoder feature"))
    pins = r["predict_pins"]
    print(f"\npinned decisions (sparse bf16 predict): {pins}")
    assert pins["fg"] + pins["voxel"] <= pins["selected"] // 2
    ex_j, ex_t = r["jpipe"]["ex"], r["tpipe"]["ex"]
    for k in ("virtual_valid", "virtual_batch", "num_virtual",
              "virtual_centers"):
        assert _dtype_name(ex_t[k]) == _dtype_name(ex_j[k]), k
        np.testing.assert_array_equal(_np(ex_t[k]), _np(ex_j[k]), err_msg=k)
    assert int(ex_j["num_virtual"]) > 0
    gaps.append(_close(ex_t["virtual_feats"], ex_j["virtual_feats"], 2.0,
                       "virtual_feats"))
    for k in ("cls_logits", "reg_preds"):
        for got, ref in zip(r["tpipe"]["outs"][k], r["jpipe"]["outs"][k]):
            gaps.append(_close(got, ref, 2.0, k))
    print(f"largest gap {max(gaps):.3f}")


def test_predict_detections_tiny_fsdv2_flagship_bf16(run):
    """Decode + NMS pinned to JAX's head outputs and XLA's logistic: JAX's
    detections, equal as a set, in JAX's dtypes."""
    r = run
    jpred, tpred_j = r["jpred"], r["tpred_j"]
    for k in ("boxes", "scores", "labels", "valid"):
        assert _dtype_name(r["tpred"][k]) == _dtype_name(jpred[k]), k
        assert _dtype_name(tpred_j[k]) == _dtype_name(jpred[k]), k
    n = int(_np(jpred["valid"]).sum())
    assert n > 0 and int(_np(tpred_j["valid"]).sum()) == n
    lost, extra, _, _ = _match(jpred, tpred_j, 0.0, 0.0, box_atol=0.0)
    assert lost == [] and extra == [], (lost, extra)


def test_train_parity_tiny_fsdv2_flagship_bf16(run):
    r = run
    pins = _pinned_decisions(r["tm"], r["tpins"], r["jtsel"], r["jseg"])
    print(f"\npinned decisions (sparse bf16 train): {pins}")
    assert pins["fg"] + pins["voxel"] <= pins["selected"] // 2
    for k in ("seg_logits", "offsets"):
        _close(r["tpins"].own_data[k], r["jseg"][k], 2.0, k)
    jout, tout = r["jout"], r["tout"]
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert _dtype_name(tout[k]) == _dtype_name(jout[k]), k
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]),
                                   rtol=ULP, atol=1e-6, err_msg=k)
    assert float(jout["loss_vote"]) > 0 and float(jout["num_virtual"]) > 0
    gaps, port, ref, f32 = {}, [], [], []
    for path, j in _leaves(r["jgrads"]):
        got = _torch_leaf(r["tm"], path, grad=True)
        truth = _torch_leaf(r["t32"], path, grad=True)
        assert got.dtype == j.dtype == np.float32, path
        norm = max(float(np.linalg.norm(j)), 1e-30)
        # the port's distance from JAX beyond JAX's own distance from the
        # float32 gradient, over the leaf's norm
        gaps["/".join(path)] = (np.linalg.norm(got - j)
                                - np.linalg.norm(j - truth)) / norm
        scale = max(float(np.abs(j).max()), 1e-30)
        port.append(got.ravel() / scale)
        ref.append(j.ravel() / scale)
        f32.append(truth.ravel() / scale)
    port, ref, f32 = (np.concatenate(x) for x in (port, ref, f32))
    cos = float(port @ ref / np.linalg.norm(port) / np.linalg.norm(ref))
    err = np.linalg.norm(port - f32) / np.linalg.norm(ref - f32)
    worst = max(gaps, key=gaps.get)
    print(f"gradients: {len(gaps)} leaves, cosine {cos:.6f}, distance from "
          f"float32 {err:.4f} x JAX's, largest leaf excess {gaps[worst]:.4f} "
          f"of its norm ({worst})")
    assert cos >= 0.99 and 0.9 <= err <= 1.1
    assert gaps[worst] <= 2.0**-5, worst
    for path, j in _leaves(r["jstats"]):
        got = _torch_leaf(r["tm"], path, grad=False)
        np.testing.assert_allclose(got, j, rtol=ULP,
                                   atol=ULP * np.abs(j).max(),
                                   err_msg="/".join(path))
    for name, p in r["tm"].named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
