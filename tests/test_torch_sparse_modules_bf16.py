"""The sparse modules at ``dtype=bfloat16`` against flax at bf16, on the
CPU: ``SimpleSparseUNet`` (multiscale), ``VirtualVoxelMixer`` and SECOND's
``SparseEncoder`` with the same seeded variables, eval and train mode, on
JAX's neighbour-table path (``gather_gemm``: the same bf16 function as the
kernel's), compiled with XLA's excess precision off (``_exact_bf16``);
the port's CPU tensors take the conv, input-gradient and dW twins at bf16
(held to JAX's Pallas kernel and custom vjp in
tests/test_torch_sparse_bf16.py).

Tolerances: maps at ``|got - ref| <= 2^-7 |ref| + k 2^-7 max|ref|`` with
k = 2 (largest measured gap stated at each test), running statistics as in
tests/test_torch_bf16_modules.py. ``SparseEncoder``'s train-mode gradients
are held leaf by leaf at k = 8 plus a cosine over all leaves: JAX's table
path scatters the input gradient's 27 bf16 tap terms into a bf16 buffer
one add at a time, where its Pallas vjp (and the port) sums them in f32
and rounds once, so the two differ by more than an ulp. A bf16 layer's
float32 weight gets a float32 gradient holding dW's bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.models import middle_encoders as jme
from sst_tpu.models import sparse_unet as jsu
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import middle_encoders as tme
from sst_tpu_torch.models import sparse_unet as tsu
from test_torch_bf16_modules import _close, _exact_bf16, _stats_close
from test_torch_ctrl import seeded_port_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf
from test_torch_middle_encoders import ENC, ENC_GRID, _random_grid
from test_torch_sparse_bf16 import _bf16_np, _t
from test_torch_sparse_unet import (
    CAPS,
    PADDINGS,
    STRIDES,
    UNET,
    _feats,
    _grids,
)
from torch_threads import torch_threads_per_worker  # noqa: F401

BF16 = jnp.bfloat16


@pytest.fixture(autouse=True)
def _table_path(monkeypatch):
    monkeypatch.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)


# ------------------------------------------------------------ the modules


@pytest.fixture(scope="module")
def unet_plans():
    """test_torch_sparse_unet.py's three-level plans (JAX's and the port's)
    and their first two levels; JAX's built under one jit (op by op it
    takes seconds)."""
    jsg, tsg = _grids()
    jp = jax.jit(lambda sg: jsu.build_unet_plan(sg, CAPS, STRIDES,
                                                PADDINGS))(jsg)
    tp = tsu.build_unet_plan(tsg, CAPS, STRIDES, PADDINGS)
    assert jp.subm[0].nbr is not None  # the neighbour-table path
    jp2 = jp.replace(levels=jp.levels[:2], subm=jp.subm[:2], down=jp.down[:1],
                     inv=jp.inv[:1])
    tp2 = tsu.UNetPlan(levels=tp.levels[:2], subm=tp.subm[:2],
                       down=tp.down[:1], inv=tp.inv[:1])
    return {3: (jp, tp), 2: (jp2, tp2)}


def test_bf16_weight_gradient_reaches_the_float32_parameter(unet_plans):
    """A bf16 ``SparseConvLayer`` casts its float32 weight to bf16: the
    weight's gradient is float32 holding dW's bf16 values, as flax's
    ``astype`` vjp gives."""
    _, tp = unet_plans[3]
    valid = tp.levels[0].valid
    x = _t(_feats(16, valid.numpy()))
    layer = tsu.SparseConvLayer(16, 24, dtype=torch.bfloat16)
    y = layer(x, tp.subm[0], valid, train=True)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    gw = layer.weight.grad
    assert gw.dtype == torch.float32
    assert torch.equal(gw.bfloat16().float(), gw)
    assert float(gw.abs().sum()) > 0


def _bf16_module_run(jmod, tmod, feats, jargs, targs):
    """flax ``jmod`` at bf16 (jitted, excess precision off) and the port's
    ``tmod`` with the same seeded variables: eval and train-mode outputs
    and the updated running statistics."""
    v = seeded_port_variables(tmod, seed=3)
    load_flax_variables(tmod, v)

    def ref(vv, x, a):
        ev = jmod.apply(vv, x, *a, False)
        tr, upd = jmod.apply(vv, x, *a, True, mutable=["batch_stats"])
        return ev, tr, upd["batch_stats"]

    ev, tr, stats = _exact_bf16(ref, v, jnp.asarray(feats).astype(BF16),
                                jargs)
    x = _t(feats)
    with torch.no_grad():
        tev = tmod.eval()(x, *targs, False)
        ttr = tmod.train()(x, *targs, True)
    return (tev, ttr, tmod), (ev, tr, jax.tree_util.tree_map(np.asarray,
                                                             stats))


def test_simple_sparse_unet_bf16_matches_flax(unet_plans):
    """Eval and train mode: the output and every decoder feature at k = 2
    (largest gap measured 0.33), bf16 like flax's; the running statistics
    as the module tests hold them."""
    jp, tp = unet_plans[3]
    feats = _feats(16, np.asarray(jp.levels[0].valid))
    (tev, ttr, tm), (ev, tr, stats) = _bf16_module_run(
        jsu.SimpleSparseUNet(return_multiscale=True, dtype=BF16, **UNET),
        tsu.SimpleSparseUNet(16, return_multiscale=True,
                             dtype=torch.bfloat16, **UNET), feats,
        (jp,), (tp,))
    gaps = []
    for got, ref in ((tev, ev), (ttr, tr)):
        gaps.append(_close(got["voxel_feats"], ref["voxel_feats"], 2.0,
                           "voxel_feats"))
        for d, (g, r) in enumerate(zip(got["decoder_features"],
                                       ref["decoder_features"])):
            gaps.append(_close(g, r, 2.0, f"decoder feature {d}"))
    print(f"\nSimpleSparseUNet bf16: largest gap {max(gaps):.3f}")
    _stats_close(tm, stats, "SimpleSparseUNet")


def test_virtual_voxel_mixer_bf16_matches_flax(unet_plans):
    """Eval and train mode at k = 2 (largest gap measured 0)."""
    jp, tp = unet_plans[2]
    cfg = dict(base_channels=16, output_channels=24,
               encoder_channels=((16,), (16, 16)),
               decoder_channels=((16, 16, 16), (16, 16, 16)))
    feats = _feats(20, np.asarray(jp.levels[0].valid))
    (tev, ttr, tm), (ev, tr, stats) = _bf16_module_run(
        jsu.VirtualVoxelMixer(dtype=BF16, **cfg),
        tsu.VirtualVoxelMixer(20, dtype=torch.bfloat16, **cfg), feats,
        (jp,), (tp,))
    gaps = [_close(tev, ev, 2.0, "eval"), _close(ttr, tr, 2.0, "train")]
    print(f"\nVirtualVoxelMixer bf16: largest gap {max(gaps):.3f}")
    _stats_close(tm, stats, "VirtualVoxelMixer")


@pytest.fixture(scope="module")
def encoder_bf16():
    """``SparseEncoder`` at narrow widths (test_torch_middle_encoders.py's)
    and bf16 input rows, as a bf16 VFE gives: every conv on the bf16
    route. One jitted JAX function: the eval map, the train map, the
    gradient of a seeded linear loss and the updated statistics."""
    jsg, tsg = _random_grid(ENC_GRID, v=500, cap=640, seed=5)
    rng = np.random.RandomState(6)
    feats = _bf16_np(np.where(np.asarray(jsg.valid)[:, None],
                              rng.randn(640, 4), 0.0).astype(np.float32))
    tm = tme.SparseEncoder(4, dtype=torch.bfloat16, **ENC)
    v = seeded_port_variables(tm, seed=7)
    load_flax_variables(tm, v)
    jm = jme.SparseEncoder(in_channels=4, dtype=BF16, **ENC)
    x = jnp.asarray(feats).astype(BF16)
    out_shape = jax.eval_shape(lambda: jm.apply(v, x, jsg))
    g = _bf16_np(rng.randn(*out_shape.shape).astype(np.float32))

    def ref(params, stats, x, g, sg):
        ev = jm.apply({"params": params, "batch_stats": stats}, x, sg)

        def loss(p):
            out, upd = jm.apply({"params": p, "batch_stats": stats}, x, sg,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float32) * g), (
                out, upd["batch_stats"])

        (val, (tr, new_stats)), grads = jax.value_and_grad(
            loss, has_aux=True)(params)
        return ev, tr, val, grads, new_stats

    want = _exact_bf16(ref, v["params"], v["batch_stats"], x,
                       jnp.asarray(g), jsg)
    want = jax.tree_util.tree_map(np.asarray, want)
    xt = _t(feats)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    with torch.no_grad():
        ev = tm.eval()(xt, tsg).permute(0, 2, 3, 1)
    tr = tm.train()(xt, tsg, train=True)
    val = (tr.float() * gt).sum()
    val.backward()
    return dict(tm=tm, want=want, ev=ev, tr=tr.detach().permute(0, 2, 3, 1),
                val=float(val.detach()))


def test_sparse_encoder_bf16_maps_match_flax(encoder_bf16):
    """bf16 maps at k = 2 (largest gap measured 0), the loss at rtol
    2^-7."""
    ev, tr, val, _, _ = encoder_bf16["want"]
    assert str(ev.dtype) == "bfloat16" and np.abs(ev.astype(np.float32)).max()
    gaps = [_close(encoder_bf16["ev"], ev, 2.0, "eval map"),
            _close(encoder_bf16["tr"], tr, 2.0, "train map")]
    print(f"\nSparseEncoder bf16 maps: largest gap {max(gaps):.3f}")
    np.testing.assert_allclose(encoder_bf16["val"], float(val),
                               rtol=2.0**-7)


def test_sparse_encoder_bf16_gradients_and_stats_match_flax(encoder_bf16):
    """Every gradient leaf float32 (flax's param dtype) within 2^-7 of
    each value plus 8 ulps of the leaf's largest magnitude (largest
    measured gap 5.8, a norm scale), and over all leaves (each over its
    largest magnitude) a cosine of at least 0.999 with JAX's (measured
    0.99986); the running statistics as the module tests hold them."""
    tm, (_, _, _, grads, stats) = encoder_bf16["tm"], encoder_bf16["want"]
    gaps, port, ref = {}, [], []
    for path, want in _leaves(grads):
        got = _torch_leaf(tm, path, grad=True)
        assert got.dtype == want.dtype == np.float32, path
        gaps["/".join(path)] = _close(torch.from_numpy(got), want, 8.0,
                                      "/".join(path))
        scale = max(float(np.abs(want).max()), 1e-30)
        port.append(got.ravel() / scale)
        ref.append(want.ravel() / scale)
    port, ref = np.concatenate(port), np.concatenate(ref)
    cos = float(port @ ref / np.linalg.norm(port) / np.linalg.norm(ref))
    worst = max(gaps, key=gaps.get)
    print(f"\nSparseEncoder bf16 gradients: {len(gaps)} leaves, largest gap "
          f"{gaps[worst]:.3f} ({worst}), cosine {cos:.6f}")
    assert len(gaps) == 3 * 12 and cos >= 0.999
    _stats_close(tm, stats, "SparseEncoder")
