"""Parity of the port's layers and voxel feature encoder (models/layers.py,
models/vfe.py) with the flax modules, through converted parameters.

Tolerance 1e-5: both sides run the same f32 matmuls and norms, in different
summation orders. Batch-norm running statistics are randomised so that the
converted ``running_mean`` / ``running_var`` matter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.models import layers as fl
from sst_tpu.models.vfe import DynamicVFE as FlaxVFE
from sst_tpu.ops.voxelize import dynamic_voxelize as jax_voxelize
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import layers as tl
from sst_tpu_torch.models.vfe import DynamicVFE
from sst_tpu_torch.ops import sorted_reduce as sr
from sst_tpu_torch.ops.voxelize import dynamic_voxelize

TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy_vars(variables, seed=0):
    """Flax variables as numpy, with random running statistics."""
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    out = {k: dict(v) for k, v in out.items()}

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                tree[k] = (rng.randn(*v.shape) * 0.2).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    if "batch_stats" in out:
        perturb(out["batch_stats"])
    return out


@pytest.mark.parametrize("norm,is_head,act", [
    ("bn", False, "relu"), ("bn", True, "relu"), ("ln", False, "relu"),
    ("ln", True, "gelu"), ("none", False, "leakyrelu")])
def test_mlp(norm, is_head, act):
    rng = np.random.RandomState(0)
    x = rng.randn(50, 7).astype(np.float32) * 2 + 0.5
    mask = rng.rand(50) > 0.2
    fm = fl.MLP((16, 12, 5), act=act, norm=norm, is_head=is_head)
    v = _numpy_vars(fm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                            jnp.asarray(mask)))
    ref = fm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    tm = load_flax_variables(
        tl.MLP(7, (16, 12, 5), act=act, norm=norm, is_head=is_head), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k,stride,dilation,use_norm", [
    (3, 1, 1, True), (3, 2, 1, True), (1, 1, 1, True), (3, 1, 2, True),
    (3, 1, 1, False)])
def test_conv_norm_act(k, stride, dilation, use_norm):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(2, 10, 12, 6).astype(np.float32)  # NHWC
    fm = fl.ConvNormAct(8, k, stride=stride, dilation=dilation,
                        use_norm=use_norm)
    v = _numpy_vars(fm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    ref = np.asarray(fm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(
        tl.ConvNormAct(6, 8, k, stride=stride, dilation=dilation,
                       use_norm=use_norm), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _points(seed=3, n=600):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-3.9, 3.9, (n, 2)),
                          rng.uniform(-1.9, 3.9, (n, 1)),
                          rng.rand(n, 1)], -1).astype(np.float32)
    valid = rng.rand(n) > 0.1
    extra = (rng.rand(n, 1) > 0.5).astype(np.float32)
    return pts, valid, extra


@pytest.mark.parametrize("sorted_path,mode,with_extra", [
    (False, "max", True), (False, "mean", False),
    (True, "max", True), (True, "mean", False)])
def test_dynamic_vfe(monkeypatch, sorted_path, mode, with_extra):
    """Scatter path and sorted path. For the sorted path the mapping is
    built with need_ranks=True (so both sides sort), and the JAX side runs
    its Pallas sorted-reduce kernel in interpret mode."""
    if sorted_path:
        monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    pts, valid, extra = _points()
    pcr = (-4.0, -4.0, -2.0, 4.0, 4.0, 4.0)
    vsz = (0.5, 0.5, 0.5)
    bidx = np.zeros(len(pts), np.int32)
    kw = dict(feat_channels=(16, 16), voxel_size=vsz, point_cloud_range=pcr,
              mode=mode, use_sorted_reduce=sorted_path)
    jvm = jax_voxelize(jnp.asarray(pts), jnp.asarray(bidx),
                       jnp.asarray(valid), pcr, vsz, 300, 1,
                       need_ranks=sorted_path)
    es = jnp.asarray(extra) if with_extra else None
    fm = FlaxVFE(**kw)
    v = _numpy_vars(fm.init(jax.random.PRNGKey(0), jnp.asarray(pts), jvm,
                            extra_sum=es))
    ref = fm.apply(v, jnp.asarray(pts), jvm, extra_sum=es)

    tvm = dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(bidx),
                           torch.from_numpy(valid), pcr, vsz, 300, 1,
                           need_ranks=sorted_path)
    tm = load_flax_variables(DynamicVFE(4, **kw), v)
    sr.launches = 0
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), tvm,
                 extra_sum=torch.from_numpy(extra) if with_extra else None)
    assert tm.sorted_calls == int(sorted_path)
    assert sr.launches == 0  # CPU tensors take the plain twin
    if with_extra:
        (ref, ref_aux), (got, got_aux) = ref, got
        for k in ("cluster_mean", "extra_sum"):
            np.testing.assert_allclose(got_aux[k].numpy(),
                                       np.asarray(ref_aux[k]), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.abs(got.numpy()).sum() > 0


def _clustered_points(seed=11, clusters=150, per=4, dups=80):
    """Points in tight clusters (several to a 5 cm voxel), plus ``dups``
    exact copies of some of them: a copy ties its original at every
    channel, so voxels hold ties at their maxima."""
    rng = np.random.RandomState(seed)
    centers = np.concatenate([rng.uniform(-3.9, 3.9, (clusters, 2)),
                              rng.uniform(-1.9, 3.9, (clusters, 1))], -1)
    xyz = (centers[:, None] + rng.uniform(-0.015, 0.015, (clusters, per, 3))
           ).reshape(-1, 3)
    pts = np.concatenate([xyz, rng.rand(len(xyz), 1)], -1)
    pts = np.concatenate([pts, pts[rng.choice(len(pts), dups, False)]])
    pts = pts[rng.permutation(len(pts))].astype(np.float32)
    return pts, rng.rand(len(pts)) > 0.05


def _grad_of(module, path):
    """The torch gradient of flax param ``path``, in flax layout."""
    *mods, leaf = path
    mod = module.get_submodule(".".join(mods))
    if leaf == "bias":
        return mod.bias.grad.numpy()
    grad = mod.weight.grad.numpy()
    return grad.T if leaf == "kernel" else grad


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_dynamic_vfe_sorted_path_train_gradients(monkeypatch):
    """Train mode on the sorted path (the full-width FSDv2 builders' segmentor
    VFE) against JAX's ``DynamicVFE(use_sorted_reduce=True)``, its Pallas
    sorted reduce in interpret mode under one jitted ``value_and_grad``. The
    key space 160x160x120 is above 2**21, so both packages sort. Duplicated
    points tie at voxel maxima: both sorted-path vjps hand a tie's gradient
    to the first argmax (the scatter path would split it, which the last
    assertion shows moves the points' gradient). Outputs and the updated
    running statistics at rtol/atol 1e-5; the gradient of every parameter
    and of the points at rtol 1e-5 plus 1e-6 of the leaf's largest
    magnitude (f32 sums over the voxels in other orders; largest gap
    measured 1.1e-5 on a Dense kernel whose gradient reaches 53)."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    pts, valid = _clustered_points()
    pcr = (-4.0, -4.0, -2.0, 4.0, 4.0, 4.0)
    vsz = (0.05, 0.05, 0.05)
    bidx = np.zeros(len(pts), np.int32)
    kw = dict(feat_channels=(16, 16), voxel_size=vsz, point_cloud_range=pcr,
              mode="max", use_sorted_reduce=True)
    jvm = jax_voxelize(jnp.asarray(pts), jnp.asarray(bidx),
                       jnp.asarray(valid), pcr, vsz, 600, 1)
    assert jvm.unique.order is not None
    fm = FlaxVFE(**kw)
    v = _numpy_vars(fm.init(jax.random.PRNGKey(0), jnp.asarray(pts), jvm))
    g = np.random.RandomState(12).randn(600, 16).astype(np.float32)

    def loss(params, p):
        out, mut = fm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, p, jvm, True,
                            mutable=["batch_stats"])
        return (out * g).sum(), (out, mut["batch_stats"])

    (_, (ref, ref_stats)), (ref_gp, ref_gpts) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(pts))

    tvm = dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(bidx),
                           torch.from_numpy(valid), pcr, vsz, 600, 1)
    seg = tvm.point_seg_ids.numpy()
    copies = [(i, j) for i in range(len(pts)) for j in range(i)
              if valid[i] and valid[j] and (pts[i] == pts[j]).all()]
    assert copies and all(seg[i] == seg[j] < 600 for i, j in copies)
    grads = []
    for use_sorted in (True, False):
        tm = load_flax_variables(DynamicVFE(4, **kw), v)
        tm.use_sorted_reduce = use_sorted
        p = torch.from_numpy(pts).requires_grad_()
        out = tm(p, tvm, train=True)
        (out * torch.from_numpy(g)).sum().backward()
        grads.append(p.grad.numpy())
        if use_sorted:
            assert tm.sorted_calls == 1
            np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                       **TOL)
            for path, got, want in [(("points",), grads[0], ref_gpts)] + [
                    (path, _grad_of(tm, path), want)
                    for path, want in _leaves(ref_gp)]:
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                    err_msg="/".join(path))
            for path, want in _leaves(ref_stats):
                *mods, leaf = path
                got = getattr(tm.get_submodule(".".join(mods)),
                              f"running_{leaf}").numpy()
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg="/".join(path))
    assert np.abs(grads[0]).sum() > 0
    assert not np.allclose(grads[0], grads[1], rtol=1e-5, atol=1e-5)
