"""Parity of the port's training path on the dense-BEV FSDv2 build with the
JAX package, on the CPU.

The slice: ``tiny_fsdv2_dense`` with the same weights in both packages (the
port's seeded ``init_weights``, random running statistics, converted into a
flax variable tree), on the labelled 2048-point frame of
test_torch_fsdv2_train.py. ``loss`` in train mode with ``pretrain=False``
is held against JAX ``value_and_grad`` (jitted once): every loss, the
gradient of every parameter leaf and the updated running statistics of both
batch norms (``MaskedBatchNorm`` over valid rows, and the ``nn.BatchNorm``
of every ``ConvNormAct`` over N·H·W). Both packages run the segmentor VFE
on its scatter path (the tiny build's default).

Tolerances, with the largest gaps measured:
  - losses rtol 1e-4 / atol 1e-6 (5.4e-6 relative);
  - gradients: each leaf within 1e-4 of its largest magnitude, plus rtol
    1e-4 (3.1e-5 of the largest magnitude): the backward sums many f32
    products in other orders through two UNets;
  - running statistics rtol/atol 1e-5 (1.2e-7).
The discrete steps (fg thresholds, per-class top-k cuts) could flip on a
near-tie, so the test first asserts every such margin is at least 10x the
seg-score gap between the packages.

The pieces: ``ConvNormAct`` (conv + ``BatchNorm``) in train mode against
flax at rtol/atol 1e-5, and the dense canvases' max scatters with
deliberately tied rows (duplicate voxels of one cell and band, and values
equal to the zero init) against JAX at 1e-5: both frameworks
split a tied maximum's gradient equally among the rows that hold it and
the init, so a different split would show as a gap of a third or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sst_tpu import flagship as jflag
from sst_tpu.models import dense_bev as fd
from sst_tpu.models import layers as fl
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import dense_bev as td
from sst_tpu_torch.models import layers as tl
from sst_tpu_torch.train import schedules as tsched
from sst_tpu_torch.train.state import make_optimizer
from sst_tpu_torch.train.step import train_step
from test_torch_fsdv2 import _assert_margins
from test_torch_fsdv2_train import FRAME, _leaves, _pipeline_losses

TOL = dict(rtol=1e-5, atol=1e-5)


def _flax_variables(model: nn.Module, seed: int = 0) -> dict:
    """The torch model's parameters as a flax variable tree (the inverse of
    ``load_flax_variables``: Linear and Conv2d kernels to flax layouts),
    with random running statistics."""
    rng = np.random.RandomState(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        mod = model.get_submodule(".".join(path))
        arr = value.detach().numpy().copy()
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", leaf[len("running_"):]
            arr = ((rng.randn(*arr.shape) * 0.1) if name == "mean" else
                   rng.uniform(0.5, 1.5, arr.shape)).astype(np.float32)
        elif leaf in ("bias", "z_embed"):
            coll, name = "params", leaf
        elif isinstance(mod, nn.Linear):
            coll, name, arr = "params", "kernel", arr.T
        elif isinstance(mod, nn.Conv2d):
            coll, name, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)
        else:  # LayerNorm and batch-norm scales
            coll, name = "params", "scale"
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def _torch_leaf(model: nn.Module, path: tuple, grad: bool) -> np.ndarray:
    """The torch counterpart of flax leaf ``path`` in flax layout: a
    gradient, or a running statistic."""
    *mods, leaf = path
    mod = model.get_submodule(".".join(mods))
    if leaf in ("mean", "var"):
        return getattr(mod, f"running_{leaf}").numpy()
    t = getattr(mod, leaf if leaf in ("bias", "z_embed") else "weight")
    arr = (t.grad if grad else t.detach()).numpy()
    if leaf == "kernel" and isinstance(mod, nn.Linear):
        return arr.T
    if leaf == "kernel" and isinstance(mod, nn.Conv2d):
        return arr.transpose(2, 3, 1, 0)
    return arr


@pytest.fixture(scope="module")
def slice_run():
    tm = tflag.init_weights(tflag.tiny_fsdv2_dense(device="cpu"),
                            torch.Generator().manual_seed(0))
    v = _flax_variables(tm)
    jm = jflag.tiny_fsdv2_dense()
    jb, _ = jflag.synthetic_labeled_batch(**FRAME)

    def loss_fn(params, stats, b):
        (out, seg), mut = jm.apply(
            {"params": params, "batch_stats": stats}, b, False,
            method=_pipeline_losses, mutable=["batch_stats"])
        total = sum(x for k, x in out.items() if k.startswith("loss"))
        return total, (out, seg, mut["batch_stats"])

    (_, (jout, jseg, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"], jb)

    tb = tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu")
    tm = load_flax_variables(tflag.tiny_fsdv2_dense(device="cpu"), v)
    tout, tseg = _pipeline_losses(tm, tb, False)
    sum(x for k, x in tout.items() if k.startswith("loss")).backward()
    return dict(jm=jm, tm=tm, v=v, jout=jout, jseg=jseg, jstats=jstats,
                jgrads=jgrads, tout=tout, tseg=tseg)


def test_train_parity_tiny_fsdv2_dense(slice_run):
    """Losses at rtol 1e-4 / atol 1e-6, each gradient leaf within 1e-4 of
    its largest magnitude plus rtol 1e-4, running statistics of both batch
    norms at rtol/atol 1e-5 (largest gaps measured: 5.4e-6, 3.1e-5 and
    1.2e-7 relative)."""
    r = slice_run
    _assert_margins(r["jm"], {"seg_out": r["jseg"]},
                    {"seg_out": {k: x.detach() for k, x in
                                 r["tseg"].items()}})
    jout = {k: float(x) for k, x in r["jout"].items()}
    tout = {k: float(x.detach()) for k, x in r["tout"].items()}
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert jout["loss_vote"] > 0 and jout["num_virtual"] > 0
    assert all(jout[f"loss_center.task{t}"] > 0 for t in range(3))
    n = 0
    for path, ref in _leaves(r["jgrads"]):
        got = _torch_leaf(r["tm"], path, grad=True)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in r["tm"].parameters())
    kinds = set()
    for path, ref in _leaves(r["jstats"]):
        got = _torch_leaf(r["tm"], path, grad=False)
        np.testing.assert_allclose(got, ref, **TOL, err_msg="/".join(path))
        kinds.add(type(r["tm"].get_submodule(".".join(path[:-1]))))
    assert kinds == {tl.BatchNorm, tl.MaskedBatchNorm}


def test_every_parameter_of_the_dense_build_gets_a_gradient(slice_run):
    """As in JAX, every parameter leaf has a gradient (no tolerance)."""
    missing = [n for n, p in slice_run["tm"].named_parameters()
               if p.grad is None]
    assert missing == []


@pytest.mark.parametrize("k,stride,dilation", [(3, 1, 1), (3, 2, 1),
                                               (1, 1, 1), (3, 1, 2)])
def test_conv_norm_act_train_matches_flax(k, stride, dilation):
    """Output, the input, kernel, scale and bias gradients, and the updated
    running statistics at rtol/atol 1e-5 (largest gap measured 2.3e-5
    absolute, 7.0e-7 of the largest magnitude)."""
    rng = np.random.RandomState(k + stride + dilation)
    x = (rng.randn(2, 10, 12, 6) * 2 + 0.5).astype(np.float32)  # NHWC
    fm = fl.ConvNormAct(8, k, stride=stride, dilation=dilation)
    v = jax.tree_util.tree_map(np.asarray, fm.init(jax.random.PRNGKey(2),
                                                   jnp.asarray(x)))
    v = {"params": v["params"], "batch_stats": {"BatchNorm_0": {
        "mean": rng.randn(8).astype(np.float32),
        "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}}
    out_shape = jax.eval_shape(lambda vv: fm.apply(vv, jnp.asarray(x)),
                               v).shape
    g = rng.randn(*out_shape).astype(np.float32)

    def f(params, xx):
        y, mut = fm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx, True,
                          mutable=["batch_stats"])
        return (y * g).sum(), (y, mut["batch_stats"])

    (_, (y_ref, st_ref)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    tm = load_flax_variables(tl.ConvNormAct(6, 8, k, stride=stride,
                                            dilation=dilation), v)
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt.permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, **TOL)
    np.testing.assert_allclose(
        tm.Conv_0.weight.grad.permute(2, 3, 1, 0).numpy(),
        gp["Conv_0"]["kernel"], **TOL)
    bn = tm.BatchNorm_0
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               gp["BatchNorm_0"]["scale"], **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               gp["BatchNorm_0"]["bias"], **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               st_ref["BatchNorm_0"]["mean"], **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               st_ref["BatchNorm_0"]["var"], **TOL)


def _tied_voxels(rng, n, b, nz, hw):
    """Voxels where every third valid row repeats the one before it (same
    cell, same z, same features), some features exactly 0 (the canvas's
    zero init) and some negative."""
    h, w = hw
    coords = np.stack([rng.randint(0, b, n), rng.randint(0, nz, n),
                       rng.randint(0, h, n), rng.randint(0, w, n)], -1)
    feats = rng.randn(n, 6).astype(np.float32)
    feats[rng.rand(n, 6) < 0.3] = 0.0
    dup = np.arange(2, n, 3)
    coords[dup] = coords[dup - 1]
    feats[dup] = feats[dup - 1]
    valid = rng.rand(n) > 0.1
    valid[dup] = valid[dup - 1] = True
    coords = np.where(valid[:, None], coords, -1).astype(np.int32)
    return feats, coords, valid


@pytest.mark.parametrize("name", ["scatter z1", "scatter z2 pre", "mixer"])
def test_canvas_tied_max_gradient_matches_jax(name):
    """The train-mode gradients of BEVScatter (full-column collapse, and z
    bands with the ``pre`` MLP, whose ReLU zeros tie with the init) and
    DenseBEVMixer through their tied canvas maxima: the features' gradient
    and every parameter's at rtol 1e-5 plus 1e-5 of each leaf's largest
    magnitude (largest gap measured 2.0e-6 of that magnitude)."""
    rng = np.random.RandomState(7)
    n, nz, b, hw = 120, 4, 2, (4, 6)
    feats, coords, valid = _tied_voxels(rng, n, b, nz, hw)
    if name == "mixer":
        fm = fd.DenseBEVMixer(nz=nz, z_channels=4, output_channels=8,
                              encoder_channels=((8, 8), (8, 8)),
                              decoder_channels=(8,))
        tm = td.DenseBEVMixer(6, nz, z_channels=4, output_channels=8,
                              encoder_channels=((8, 8), (8, 8)),
                              decoder_channels=(8,))
    else:
        g_n, pre = (1, 0) if name == "scatter z1" else (2, 5)
        fm = fd.BEVScatter(nz=nz, z_groups=g_n, pre_channels=pre)
        tm = td.BEVScatter(6, nz, g_n, pre)
    args = (jnp.asarray(coords), jnp.asarray(valid), b, hw)
    v = jax.tree_util.tree_map(np.asarray, fm.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), *args))
    v = {k: dict(x) for k, x in v.items()}
    if name == "scatter z1":  # x + z_embed keeps the zeros and the ties
        v["params"]["z_embed"] = np.zeros_like(v["params"]["z_embed"])
    out_shape = jax.eval_shape(lambda vv: fm.apply(
        vv, jnp.asarray(feats), *args), v).shape
    g = rng.randn(*out_shape).astype(np.float32)

    def f(params, x):
        y, _ = fm.apply({**v, "params": params}, x, *args, train=True,
                        mutable=["batch_stats"])
        return (y * g).sum()

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(v["params"],
                                                  jnp.asarray(feats))
    tm = load_flax_variables(tm, v)
    xt = torch.from_numpy(feats).requires_grad_()
    y = tm(xt, torch.from_numpy(coords), torch.from_numpy(valid), b, hw,
           train=True)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for path, ref in _leaves(gp):
        got = _torch_leaf(tm, path, grad=True)
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg="/".join(path))
    if name != "mixer":
        # the scatter's output is the canvas alone, so two tied duplicates
        # take equal shares of their cell's gradient
        dup = np.arange(2, n, 3)
        np.testing.assert_array_equal(xt.grad.numpy()[dup],
                                      xt.grad.numpy()[dup - 1])
        assert np.abs(xt.grad.numpy()[dup]).max() > 0


def test_dense_train_step_moves_the_model():
    """One step of the train loop on the dense build: every parameter
    with a gradient, every running statistic of both batch-norm kinds
    moved, and every parameter moved but zero biases whose gradient is 0.
    ``loss_total`` is the sum of the losses at rtol 1e-6."""
    m = tflag.init_weights(tflag.tiny_fsdv2_dense(device="cpu"),
                           torch.Generator().manual_seed(1))
    batch = tflag.synthetic_labeled_batch(**FRAME)[0].to("cpu")
    opt = make_optimizer(m.parameters(), base_lr=1e-3, total_steps=100)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    met = train_step(m, opt, batch, tsched.FSDDetectionSchedule()(0))
    total = sum(float(v) for k, v in met.items()
                if k.startswith("loss") and k != "loss_total")
    assert np.isclose(float(met["loss_total"]), total, rtol=1e-6)
    assert float(met["grad_norm"]) > 0 and opt.params_without_grad == 0
    params = dict(m.named_parameters())
    for k, v in m.state_dict().items():
        if torch.equal(before[k], v):
            assert k in params, k
            assert not params[k].grad.any() and not v.any(), k
    assert any(isinstance(mod, tl.BatchNorm)
               and not isinstance(mod, tl.MaskedBatchNorm)
               for mod in m.modules())
