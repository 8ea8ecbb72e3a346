"""SST at the bfloat16 compute policy (``bench.py bench_sst``'s and
configs/sst/sst_waymoD5_3class_bf16.py's) against the JAX package, on the
CPU: the modules one by one, then ``tiny_sst(dtype=torch.bfloat16)``
against ``jflag.tiny_sst().clone(dtype=jnp.bfloat16)`` in predict and in a
train-mode ``value_and_grad`` of the loss.

The JAX side runs its fused attention (``use_pallas=True``, the Pallas
kernel in interpret mode through ``SST_TPU_PALLAS_INTERPRET``, and its
custom vjp ``_mha_bwd``), and every JAX function is compiled with XLA's
excess precision off (``_exact_bf16`` of tests/test_torch_bf16_modules.py),
so JAX rounds every bf16 value as its dtype says. The loss test records
JAX's voxel shuffle and feeds it to the port (as tests/test_torch_sst_train.py
does). The weights are the port's seeded ``init_weights`` converted to a
flax tree with random running statistics; the modules get seeded variables
of their flax init's shapes.

Tolerances, in bf16 terms: ``|got - ref| <= 2^-7 |ref| + k 2^-7 max|ref|``
(``_close``), k per test with the largest gap measured in its docstring.
Every output's dtype equals JAX's.

Pinned decisions: the packages' bf16 head outputs differ by about an ulp,
and XLA's bf16 logistic is an ulp off the correctly rounded sigmoid on a
share of its inputs, so a score threshold, a top-k cut or an NMS overlap
near a tie may flip. As tests/test_torch_fsdv2_bf16.py does, the port's
decode + NMS runs on JAX's head outputs with XLA's logistic in place of
torch's sigmoid and must then give JAX's detections; the pinned logistic
values are counted and asserted to be a minority. The port's own
detections are matched to JAX's at the head outputs' noise.

A bias's gradient sums the bf16 cotangent of every output row: XLA sums it
in bf16 (an ulp per add: -4.25 for an exact -4.97 over 512 rows of N(0, 1)
values), torch in float32 rounded once. Those leaves are held against the
exact float64 sum of JAX's own bf16 cotangent instead of JAX's sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu.models import second as jsecond
from sst_tpu.models import sst as jsst
from sst_tpu.models.detectors import dynamic_voxelnet as jdvn
from sst_tpu.models.heads.anchor3d import Anchor3DHead as JHead
from sst_tpu.utils.builders import build_model_from_cfg as jbuild
from sst_tpu.utils.config import load_config as jload
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import check_flax_shapes, load_flax_variables
from sst_tpu_torch.models import layers as tl
from sst_tpu_torch.models import sst as tsst
from sst_tpu_torch.models.detectors import dynamic_voxelnet as tdvn
from sst_tpu_torch.models.heads.anchor3d import Anchor3DHead
from sst_tpu_torch.models.second import SECONDFPN
from sst_tpu_torch.ops import window_mha as wm
from sst_tpu_torch.utils.builders import build_model_from_cfg
from sst_tpu_torch.utils.config import load_config
from test_torch_bf16_modules import (
    _close,
    _dtype_name,
    _exact_bf16,
    _leaves,
    _np,
    _variables,
)
from test_torch_fsdv2_bf16 import _bf16, _match, _xla_logistic
from test_torch_fsdv2_dense_train import _flax_variables, _torch_leaf
from test_torch_window import _plans
from torch_threads import torch_threads_per_worker  # noqa: F401

BF16 = jnp.bfloat16
TBF16 = torch.bfloat16
SST_BF16_CFG = "configs/sst/sst_waymoD5_3class_bf16.py"


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")


def _feats(n, c, seed):
    """Seeded features, exactly representable in bf16, as float32."""
    x = np.random.RandomState(seed).randn(n, c).astype(np.float32)
    return _np(torch.from_numpy(x).bfloat16())


def _module_run(fm, tm, jargs, targs, post=lambda y: y, train_kw=None,
                x_index=0, seed=0, compile_fn=_exact_bf16, grads_only=False):
    """Forward (inference) of flax ``fm`` and torch ``tm`` on the same
    seeded variables, and in train mode (``train_kw``: the flax call's
    extra keywords) the gradients of ``sum(f32(out) * g)`` with seeded
    float32 cotangents over every output, with respect to the parameters
    and argument ``x_index``. ``post`` maps the port's outputs to flax's
    layout; ``compile_fn`` compiles and runs JAX's functions. Returns (ref,
    got, flax param grads, flax input grad, port input grad, tm); with
    ``grads_only`` only JAX's gradients (the rest None)."""
    v = _variables(fm, *jargs)
    x = jargs[x_index]

    def apply(params, x, train):
        args = list(jargs)
        args[x_index] = x
        kw = dict(train_kw or {}) if train else {}
        if train and train_kw is not None:
            y, _ = fm.apply({**v, "params": params}, *args, **kw,
                            mutable=["batch_stats"])
            return y
        return fm.apply({**v, "params": params}, *args)

    ref = None if grads_only else compile_fn(
        lambda p, x: apply(p, x, False), v["params"], x)
    outs = jax.eval_shape(lambda p, x: jax.tree_util.tree_leaves(
        apply(p, x, True)), v["params"], x)
    rng = np.random.RandomState(seed)
    gs = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def loss(p, x):
        return sum(jnp.sum(y.astype(jnp.float32) * g) for y, g in zip(
            jax.tree_util.tree_leaves(apply(p, x, True)), gs))

    gp, gx = compile_fn(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    if grads_only:
        return None, None, gp, gx, None, None
    tm = load_flax_variables(tm, v)
    with torch.no_grad():
        got = post(tm(*targs))
    targs = list(targs)
    targs[x_index] = targs[x_index].clone().requires_grad_()
    train = {} if train_kw is None else {"train": True}
    ys = post(tm(*targs, **train))
    ys = ys if isinstance(ys, (tuple, list)) else (ys,)
    sum((y.float() * torch.from_numpy(g)).sum()
        for y, g in zip(ys, gs)).backward()
    return ref, got, gp, gx, targs[x_index].grad, tm


def _grads_close(gp, gx, tx, tm, k, bias_k=None, x_post=lambda g: g):
    """Every parameter leaf and the input gradient within k (``_close``);
    the Dense and Conv biases within ``bias_k`` where given (their bf16
    sums, see the module docstring). Returns the largest gap."""
    gaps = [_close(x_post(tx), gx, k, "input")]
    for path, ref in _leaves(gp):
        got = torch.from_numpy(np.array(_torch_leaf(tm, path, grad=True)))
        kk = bias_k if (bias_k is not None and path[-1] == "bias") else k
        gaps.append(_close(got, ref, kk, "/".join(path)))
        assert float(got.abs().max()) > 0, "/".join(path)
    return max(gaps)


# ------------------------------------------------------------- modules


@pytest.mark.parametrize("module", ["attention", "post_norm", "pre_norm"])
def test_window_attention_and_encoder_layer_bf16(interpret, module):
    """``WindowAttention`` and ``EncoderLayer`` (post- and pre-norm) at
    bf16 on tiny_sst's window plan, shift 0: the bf16 output (k = 1) and
    the train-mode gradients of every leaf and of the bf16 input (k = 2;
    the largest gap of the three tests, output or gradient, 1.42)."""
    _, _, _, jp, tp = _plans("tiny_sst")
    n = int(jp.pos[0].shape[0])
    x = _feats(n, 32, seed=5)
    jx, tx = jnp.asarray(x).astype(BF16), torch.from_numpy(x).bfloat16()
    if module == "attention":
        fm = jsst.WindowAttention(32, 2, use_pallas=True, dtype=BF16)
        tm = tsst.WindowAttention(32, 2, dtype=TBF16)
    else:
        post = module == "post_norm"
        fm = jsst.EncoderLayer(32, 2, 64, post_norm=post, use_pallas=True,
                               dtype=BF16)
        tm = tsst.EncoderLayer(32, 2, 64, post_norm=post, dtype=TBF16)
    ref, got, gp, gx, gt, tm = _module_run(
        fm, tm, (jx, jp.pos[0], jp.f2w[0]), (tx, tp.pos[0], tp.f2w[0]),
        train_kw=None)
    assert _dtype_name(ref) == "bfloat16"
    _close(got, ref, 1.0, module)
    _grads_close(gp, gx, gt, tm, 2.0)


def _default_jit(f, *args):
    """``f(*args)`` jitted with XLA's defaults (excess precision on)."""
    return jax.jit(f)(*args)


@pytest.mark.parametrize("case", ["to_bev=False", "conv_shortcut, remat"])
def test_sstv2_bf16(interpret, case):
    """``SSTv2`` at bf16 (``linear0``, two blocks, in train mode
    rematerialised in the second case, as JAX's ``nn.remat``) on tiny_sst's
    voxels and plan: with ``to_bev=False`` the voxel features [N, C]; with
    ``conv_shortcut`` the BEV map after two attached convs (BN in train
    mode), the second added to its input. Outputs k = 2 (largest gap
    measured 1.4).

    Gradients: with ``to_bev=False`` every leaf and the input within k = 6
    (largest 3.7). Behind the attached convs the
    bf16 gradients carry much more rounding noise: JAX's own two
    compilations (excess precision off and on) differ by up to 41.7 on a
    leaf, and both lie 9-13 from the float32 gradient. So there each leaf
    of the port must lie within ``max(4, 2 x`` JAX's gap between its two
    compilations on that leaf) of the excess-precision-off one (the
    port's largest gap 34.8, its largest ratio 1.8)."""
    coords, _, _, jp, tp = _plans("tiny_sst")
    n = coords.shape[0]
    x = _feats(n, 16, seed=6)
    kw = dict(d_model=(32, 32), nhead=(2, 2), num_blocks=2,
              dim_feedforward=(64, 64), in_channel=16,
              output_shape=(32, 32), num_attached_conv=2,
              conv_kwargs=({"kernel_size": 3, "dilation": 1},
                           {"kernel_size": 3, "dilation": 2}),
              conv_out_channel=32)
    bev = case != "to_bev=False"
    kw.update(to_bev=bev, remat_blocks=bev, conv_shortcut=bev)
    post = (lambda y: y[0].permute(0, 2, 3, 1)) if bev else (
        lambda y: y[0])
    args = ((jnp.asarray(x), jnp.asarray(coords), jp, 2),
            (torch.from_numpy(x), torch.from_numpy(coords), tp, 2))
    fm = jsst.SSTv2(use_pallas=True, dtype=BF16, **kw)
    ref, got, gp, gx, gt, tm = _module_run(
        fm, tsst.SSTv2(dtype=TBF16, **kw), *args, post=post,
        train_kw={"train": True})
    assert _dtype_name(ref[0]) == "bfloat16"
    _close(got, ref[0], 2.0, case)
    if not bev:
        _grads_close(gp, gx, gt, tm, 6.0)
        assert not hasattr(tm, "attached_conv_0")
        return
    _, _, gp2, gx2, _, _ = _module_run(
        fm, None, *args, post=post, train_kw={"train": True},
        compile_fn=_default_jit, grads_only=True)
    pairs = [(("input",), gx, gx2, gt)] + [
        (path, ref, ref2, torch.from_numpy(np.array(
            _torch_leaf(tm, path, grad=True))))
        for (path, ref), (_, ref2) in zip(_leaves(gp), _leaves(gp2))]
    for path, ref, ref2, got in pairs:
        scale = 2.0**-7 * np.abs(_np(ref)).max()
        noise = float(np.max(np.maximum(np.abs(_np(ref2) - _np(ref))
                                        - 2.0**-7 * np.abs(_np(ref)), 0))
                      / scale)
        _close(got, ref, max(4.0, 2.0 * noise), "/".join(path))


def test_secondfpn_and_anchor_head_convs_bf16():
    """``SECONDFPN`` (1x1 conv, BN, ReLU) and the ``Anchor3DHead`` convs at
    bf16 on an NHWC map, inference and train mode: outputs k = 1,
    gradients of every leaf and of the bf16 input k = 2 (largest gap
    measured 0.35), the head convs' biases (bf16 sums over 2 x 12 x 10 rows
    in XLA) k = 8 (largest 2.1)."""
    rng = np.random.RandomState(7)
    x = _np(torch.from_numpy(rng.randn(2, 12, 10, 24).astype(np.float32))
            .bfloat16())
    jx = jnp.asarray(x).astype(BF16)
    tx = torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)
    nhwc = lambda y: y.permute(0, 2, 3, 1)  # noqa: E731
    fm = jsecond.SECONDFPN(out_channels=(16,), dtype=BF16)
    tm = SECONDFPN(24, out_channels=(16,), dtype=TBF16)
    ref, got, gp, gx, gt, tm = _module_run(
        fm, tm, (jx,), (tx,), post=nhwc, train_kw={"train": True})
    _close(got, ref, 1.0, "neck")
    _grads_close(gp, gx, gt, tm, 2.0, x_post=nhwc)

    fm = JHead(num_classes=3, feat_channels=24, dtype=BF16)
    tm = Anchor3DHead(num_classes=3, feat_channels=24, dtype=TBF16)
    ref, got, gp, gx, gt, tm = _module_run(
        fm, tm, (jx,), (tx,), post=lambda y: (y["cls"], y["dir"], y["reg"]))
    for name, g in zip(("cls", "dir", "reg"), got):
        assert _dtype_name(ref[name]) == "bfloat16"
        _close(g, ref[name], 1.0, name)
    _grads_close(gp, gx, gt, tm, 2.0, bias_k=8.0, x_post=nhwc)


def test_gelu_bf16_is_jax_op_by_op():
    """The port's bf16 GELU follows ``jax.nn.gelu``'s ops, each rounded to
    bf16: equal to XLA's on all but 0.5% of 200,000 normal inputs (one
    ulp: XLA's float32 tanh), where a fused ``F.gelu`` (float32 inside,
    rounded once) differs on ~40%. Where they differ, XLA's float32 tanh
    (an approximation) rounded to the other side: one bf16 ulp of tanh
    near +-1 (2^-8), scaled by x / 2 after ``1 + tanh`` cancels, so the
    values lie within 2^-7 |x|. Float32 stays ``F.gelu``."""
    x = np.random.RandomState(0).randn(200000).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(BF16)
    ref = _np(_exact_bf16(jax.nn.gelu, jx))
    got = tl.gelu(_bf16(jx))
    assert got.dtype == TBF16
    diff = _np(got) != ref
    assert diff.mean() < 0.005
    xb = _np(_bf16(jx))
    assert (np.abs(_np(got) - ref) <= 2.0**-7 * np.abs(xb))[diff].all()
    tx = torch.from_numpy(x)
    assert torch.equal(tl.gelu(tx), torch.nn.functional.gelu(
        tx, approximate="tanh"))


# --------------------------------------------------------------- slice


def _models():
    tm = tflag.init_weights(tflag.tiny_sst(dtype=TBF16, device="cpu"),
                            torch.Generator().manual_seed(0))
    v = _flax_variables(tm)
    tm = load_flax_variables(tflag.tiny_sst(dtype=TBF16, device="cpu"), v)
    jm = jflag.tiny_sst().clone(dtype=BF16)
    jm = jm.clone(backbone={**jm.backbone, "use_pallas": True})
    return tm, jm, v


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's predict, its loss's ``value_and_grad`` and the head's
    cotangents (``loss_run``) of one set of variables: traced in turn, then
    compiled together in threads as ``_exact_bf16`` compiles them (excess
    precision off) and run."""
    from concurrent.futures import ThreadPoolExecutor

    _, jm, v = _models()
    jb = jflag.tiny_batch()
    perms = []
    real_input_layer = jdvn.sst_input_layer

    def recording_input_layer(*args, shuffle_rng=None, **kw):
        if shuffle_rng is not None:
            perms.append(jax.random.permutation(shuffle_rng,
                                                args[0].shape[0]))
        return real_input_layer(*args, shuffle_rng=shuffle_rng, **kw)

    def predict(vv, b):
        return jm.apply(vv, b), jm.apply(vv, b, method=jm.predict)

    def loss_fn(params, stats, b):
        out, mut = jm.apply(
            {"params": params, "batch_stats": stats}, b, True,
            method=jm.loss, rngs={"shuffle": jax.random.PRNGKey(3)},
            mutable=["batch_stats"])
        total = sum(x for k, x in out.items() if k.startswith("loss"))
        return total, (out, mut["batch_stats"], perms[-1])

    def head_cotangents(params, stats, b):
        """JAX's bf16 cotangents at the head's outputs (the same loss as
        a function of the predictions)."""
        vv = {"params": params, "batch_stats": stats}
        preds, _ = jm.apply(vv, b, True, mutable=["batch_stats"],
                            rngs={"shuffle": jax.random.PRNGKey(3)})

        def head_loss(p):
            h, w = p["cls"].shape[1:3]
            out = jm.apply(vv, p, method=lambda m, p: m.head_mod.loss(
                p, m.head_mod.grid_anchors((h, w)), b.gt_boxes,
                b.gt_labels, b.gt_valid))
            return sum(x for k, x in out.items() if k.startswith("loss"))

        return jax.grad(head_loss)(preds)

    train_args = (v["params"], v["batch_stats"], jb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
        mp.setattr(jdvn, "sst_input_layer", recording_input_layer)
        lowered = [jax.jit(predict).lower(v, jb),
                   jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
                       *train_args),
                   jax.jit(head_cotangents).lower(*train_args)]
    with ThreadPoolExecutor(3) as pool:
        predict, loss, cot = pool.map(lambda low: low.compile(
            compiler_options={"xla_allow_excess_precision": False}), lowered)
    return dict(predict=predict(v, jb), loss=loss(*train_args),
                cot=cot(*train_args))


@pytest.fixture(scope="module")
def predict_run(jax_refs):
    tm, _, _ = _models()
    jpreds, jdet = jax_refs["predict"]
    batch = tflag.tiny_batch().to("cpu")
    tm.eval()
    wm.reset_launch_counts()
    with torch.inference_mode():
        tpreds = tm(batch)
        tdet = tm.predict(batch)
    assert wm.launches == 0  # CPU tensors take the twin
    outs = {k: _bf16(x) for k, x in jpreds.items()}
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        pins = int((_xla_logistic(outs["cls"]) != torch.sigmoid(
            outs["cls"])).sum())
        mp.setattr(torch, "sigmoid", _xla_logistic)
        anchors = tm.head_mod.grid_anchors(outs["cls"].shape[1:3])
        tdet_j = tm.head_mod.get_bboxes(outs, anchors, **tm.test_cfg)
    return dict(jpreds=jpreds, jdet=jdet, tpreds=tpreds, tdet=tdet,
                tdet_j=tdet_j, pins=pins, n_scores=outs["cls"].numel())


def test_tiny_sst_bf16_head_outputs(predict_run):
    """The head's bf16 maps after voxelize, VFE, two SST blocks, the
    attached conv and the neck: k = 2 (largest gap measured 1.41)."""
    r = predict_run
    for k in ("cls", "reg", "dir"):
        assert _dtype_name(r["tpreds"][k]) == "bfloat16"
        _close(r["tpreds"][k], r["jpreds"][k], 2.0, k)


def test_tiny_sst_bf16_detections(predict_run):
    """Decode + NMS pinned to JAX's head outputs (XLA's logistic in place of
    torch's sigmoid, counted and a minority: 10,782 of 36,864 logistic
    values differ by an ulp): JAX's detections in order,
    labels, validity and bf16 scores equal, boxes within 1e-6 relative
    (XLA fuses the decode's products and sums; measured 4.8e-7 absolute).
    The port's own detections, from its own head outputs, match JAX's as
    sets at that noise (boxes 2^-3 relative plus 0.25, scores 2^-5): at
    least three quarters (measured all 32 of frame 0)."""
    r = predict_run
    jdet, pinned = r["jdet"], r["tdet_j"]
    for k in ("boxes", "scores", "labels", "valid"):
        assert _dtype_name(r["tdet"][k]) == _dtype_name(jdet[k]), k
        assert _dtype_name(pinned[k]) == _dtype_name(jdet[k]), k
    assert _dtype_name(jdet["scores"]) == "bfloat16"
    assert int(_np(jdet["valid"]).sum()) > 0
    for k in ("scores", "labels", "valid"):
        np.testing.assert_array_equal(_np(pinned[k]), _np(jdet[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_np(pinned["boxes"]), _np(jdet["boxes"]),
                               rtol=1e-6, atol=1e-6)
    print(f"\npinned logistic values: {r['pins']} of {r['n_scores']}")
    assert 0 < r["pins"] < r["n_scores"] // 2
    n = int(_np(jdet["valid"]).sum())
    lost, extra, _, _ = _match(jdet, r["tdet"], 2.0**-3, 2.0**-5,
                               box_atol=0.25)
    assert len(lost) <= n // 4 and len(extra) <= n // 4, (lost, extra)


@pytest.fixture(scope="module")
def loss_run(jax_refs):
    tm, _, _ = _models()
    (_, (jout, jstats, jperm)), jgrads = jax_refs["loss"]
    jcot = jax_refs["cot"]
    jperm = np.asarray(jperm)
    batch = tflag.tiny_batch().to("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdvn, "voxel_permutation",
                   lambda n, gen: torch.from_numpy(jperm).long())
        tout = tm.loss(batch, generator=torch.Generator())
        sum(x for k, x in tout.items() if k.startswith("loss")).backward()
    return dict(tm=tm, jout=jout, jstats=jstats, jgrads=jgrads, jcot=jcot,
                tout=tout)


_HEAD_CONVS = {"conv_cls": "cls", "conv_reg": "reg", "conv_dir_cls": "dir"}


def test_tiny_sst_bf16_loss_and_gradients(loss_run):
    """``loss`` in train mode against JAX's ``value_and_grad``: the counters
    exactly, the losses float32 within rtol 2^-6 (measured 6.7e-3, the
    direction loss's cross-entropy over bf16 logits), the running statistics
    within rtol 2^-7 plus 2^-7 of their largest, and every gradient leaf
    within k = 16 (``_close``; measured 11.95, the VFE's second Dense
    kernel, below two bf16 blocks; median 2.6; JAX's own two compilations,
    excess precision off and on, differ by up to 18.9 on these leaves). The
    head convs' biases
    against the float64 sum of JAX's own bf16 cotangent of the head's
    outputs, k = 2 (JAX's bf16 sum of the same values misses it by up to
    303)."""
    r = loss_run
    tm = r["tm"]
    for k, ref in r["jout"].items():
        got = r["tout"][k]
        assert _dtype_name(got) == _dtype_name(ref), k
        if k.startswith("loss"):
            np.testing.assert_allclose(float(got), float(ref), rtol=2.0**-6,
                                       err_msg=k)
        else:
            assert float(got) == float(ref), k
    assert float(r["jout"]["num_pos"]) > 1
    gaps = []
    for path, ref in _leaves(r["jgrads"]):
        got = torch.from_numpy(np.array(_torch_leaf(tm, path, grad=True)))
        if path[-2] in _HEAD_CONVS and path[-1] == "bias":
            cot = np.asarray(r["jcot"][_HEAD_CONVS[path[-2]]]).astype(
                np.float64)
            ref = cot.reshape(-1, cot.shape[-2] * cot.shape[-1]).sum(0)
            ref = ref.astype(np.float32)
            _close(got, ref, 2.0, "/".join(path))
            continue
        gaps.append(_close(got, ref, 16.0, "/".join(path)))
    assert len(gaps) == sum(1 for _ in tm.parameters()) - 3
    print(f"\ngradient gaps (units of 2^-7 max|ref|): max {max(gaps):.2f}, "
          f"median {float(np.median(gaps)):.2f}")
    for path, ref in _leaves(r["jstats"]):
        mod = tm.get_submodule(".".join(path[:-1]))
        got = getattr(mod, f"running_{path[-1]}").numpy()
        np.testing.assert_allclose(got, ref, rtol=2.0**-7,
                                   atol=2.0**-7 * np.abs(ref).max(),
                                   err_msg="/".join(path))


# ------------------------------------------------- configs and weights


def test_sst_configs_build_through_the_port():
    """configs/sst/sst_tiny_synthetic.py (``remat_blocks=False``, JAX's CLI
    smoke config) and sst_waymoD5_3class_bf16.py (``dtype='bfloat16'``)
    build with ``train=False`` and ``train=True``; the tiny config's predict
    equals JAX's on ``tiny_batch`` (float32, the Pallas attention on both
    sides): every JAX detection has a port detection of its label within
    1e-3 in score and 1e-2 in box, as in tests/test_torch_sst.py, but for
    those within 2e-3 of the lowest kept score (a near tie at the
    ``max_num`` cut)."""
    for path in ("configs/sst/sst_tiny_synthetic.py", SST_BF16_CFG):
        for train in (False, True):
            m = build_model_from_cfg(load_config(path), train=train,
                                     num_point_features=3, device="cpu")
            dtype = TBF16 if "bf16" in path else torch.float32
            assert m.backbone_mod.block_0.encoder_0.Dense_0.dtype == dtype
            assert m.backbone_mod.remat_blocks == ("tiny" not in path)
    cfg = load_config("configs/sst/sst_tiny_synthetic.py")
    tm = tflag.init_weights(build_model_from_cfg(
        cfg, train=False, num_point_features=3, device="cpu"),
        torch.Generator().manual_seed(1)).eval()
    v = _flax_variables(tm)
    jcfg = jload("configs/sst/sst_tiny_synthetic.py")
    jcfg["model"]["backbone"]["use_pallas"] = True
    jm = jbuild(jcfg, train=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
        jdet = jax.jit(lambda vv, b: jm.apply(vv, b, method=jm.predict))(
            v, jflag.tiny_batch())
    tm = load_flax_variables(tm, v)
    tdet = {k: x.numpy() for k, x in tm.predict(
        tflag.tiny_batch().to("cpu")).items()}
    jdet = {k: np.asarray(x) for k, x in jdet.items()}
    np.testing.assert_array_equal(tdet["valid"].sum(1), jdet["valid"].sum(1))
    checked = 0
    for i in range(jdet["valid"].shape[0]):
        lowest = jdet["scores"][i][jdet["valid"][i]].min()
        for j in np.flatnonzero(jdet["valid"][i]):
            if jdet["scores"][i, j] - lowest <= 2e-3:
                continue  # a near tie at the max_num cut may go either way
            t = tdet["valid"][i] & (tdet["labels"][i] == jdet["labels"][i, j])
            t &= np.abs(tdet["scores"][i] - jdet["scores"][i, j]) <= 1e-3
            t &= np.abs(tdet["boxes"][i] - jdet["boxes"][i, j]).max(-1) \
                <= 1e-2
            assert t.any(), (i, j)
            checked += 1
    assert checked >= 40


def test_full_width_sst_bf16_parameter_shapes_match_jax():
    """configs/sst/sst_waymoD5_3class_bf16.py at full width: every leaf of
    JAX's init (``jax.eval_shape``: no compile) has its target at the same
    shape in the port's bf16 build, whose parameters and statistics are
    float32."""
    from sst_tpu.models.detectors.dynamic_voxelnet import PointBatch as JPB

    jm = jbuild(jload(SST_BF16_CFG), train=False)
    sd = jax.ShapeDtypeStruct
    b = JPB(points=sd((1, 4096, 3), jnp.float32),
            valid=sd((1, 4096), jnp.bool_))
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b), b)
    tm = build_model_from_cfg(load_config(SST_BF16_CFG), train=False,
                              num_point_features=3, device="cpu")
    assert check_flax_shapes(tm, shapes) == len(tm.state_dict())
    assert {t.dtype for t in tm.state_dict().values()} == {torch.float32}
    assert tm.head_mod.conv_cls.dtype == TBF16
