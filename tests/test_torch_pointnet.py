"""Parity of the port's PointNet++ ops (``ops/pointnet.py``) and modules
(``models/pointnet_modules.py``: ``PointSAModuleMSG``, ``PointSAModule``,
``PointFPModule``, ``ScoreNet``, ``PAConv``) with the JAX package, on the
CPU.

The modules get their flax init's variables (random running statistics)
through ``convert.py load_flax_variables``; forward in test mode, and in
train mode the gradient of ``sum(out * R)`` (R seeded) for every parameter
leaf and input, and the updated running statistics (flax's BatchNorm at
momentum 0.9), against one jitted JAX function per module.

Exact: every index (ball query, kNN, three-NN, FPS). Within 1e-5 (rtol and
atol): distances, features, running statistics. Gradients: rtol 1e-5 plus
1e-4 of each leaf's largest magnitude, as the port's other train tests
hold them: JAX's float32 gradient of a BN scale behind the SA module's
pooling lay 2.3e-4 (1.9e-5 of the leaf's largest) from a float64 run, the
port's 4e-6 (measured on this file's single-scale case). Every index decision is
first checked 1e-5 (relative, on squared distances in float64) away from a
tie or a radius: the FPS picks' leads, the kNN orders, the ball edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.models import pointnet_modules as jpm
from sst_tpu.ops import pointnet as jpn
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import pointnet_modules as tpm
from sst_tpu_torch.ops import pointnet as tpn
from test_torch_layers_vfe import _numpy_vars
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, b=2, n=160, c=0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    feats = rng.randn(b, c, n).astype(np.float32) if c else None
    return xyz, valid, feats


def _d2(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)


def _assert_fps_margin(xyz, valid, k):
    """Each FPS pick of each sample leads its runner-up by MARGIN."""
    for p, v in zip(xyz.astype(np.float64), valid):
        mind = np.where(v, 1e10, -1e10)
        last = int(np.argmax(v))
        for _ in range(k - 1):
            mind = np.minimum(mind, np.where(v, ((p - p[last]) ** 2).sum(-1),
                                             -1e10))
            top2 = np.sort(mind)[-2:]
            assert top2[1] - top2[0] >= MARGIN * top2[1]
            last = int(np.argmax(mind))


def _assert_radius_margin(d2, radii):
    for r in radii:
        assert np.abs(d2 - r * r).min() >= MARGIN * r * r


def _assert_order_margin(d2, k):
    """The k nearest, and the k-th against the next, apart by MARGIN."""
    s = np.sort(d2, -1)[..., :k + 1]
    assert (np.diff(s, axis=-1) >= MARGIN * (s[..., 1:] + 1e-3)).all()


def test_pointnet_ops_match_jax():
    """``square_distance``, ``ball_query`` (a shell and a ball, padding
    masked), ``knn``, ``three_nn``, ``three_interpolate``,
    ``gather_points``, ``grouping_operation`` and ``query_and_group``."""
    xyz, valid, feats = _cloud(0, c=4)
    ctr = xyz[:, :24]
    d2 = _d2(ctr, xyz)
    for b in range(2):
        _assert_radius_margin(d2[b][:, valid[b]], (0.2, 0.5))
    got = tpn.square_distance(_t(ctr), _t(xyz), _t(valid))
    ref = jpn.square_distance(jnp.asarray(ctr), jnp.asarray(xyz),
                              jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for lo, hi in ((0.0, 0.5), (0.2, 0.5)):
        idx = tpn.ball_query(lo, hi, 12, _t(xyz), _t(ctr), _t(valid))
        ref = jpn.ball_query(lo, hi, 12, jnp.asarray(xyz), jnp.asarray(ctr),
                             jnp.asarray(valid))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    dv = np.where(valid[:, None], d2, np.inf)
    _assert_order_margin(dv, 8)
    idx = tpn.knn(8, _t(xyz), _t(ctr), _t(valid))
    ref = jpn.knn(8, jnp.asarray(xyz), jnp.asarray(ctr), jnp.asarray(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    assert idx.shape == (2, 8, 24)
    tgt = _cloud(1, n=40)[0]
    _assert_order_margin(np.where(valid[:, None], _d2(tgt, xyz), np.inf), 3)
    dist, nn = tpn.three_nn(_t(tgt), _t(xyz), _t(valid))
    rdist, rnn = jpn.three_nn(jnp.asarray(tgt), jnp.asarray(xyz),
                              jnp.asarray(valid))
    np.testing.assert_array_equal(nn.numpy(), np.asarray(rnn))
    np.testing.assert_allclose(dist.numpy(), np.asarray(rdist), **TOL)
    w = np.random.RandomState(2).rand(2, 40, 3).astype(np.float32)
    np.testing.assert_allclose(
        tpn.three_interpolate(_t(feats), nn, _t(w)).numpy(),
        np.asarray(jpn.three_interpolate(jnp.asarray(feats), rnn,
                                         jnp.asarray(w))), **TOL)
    pick = np.random.RandomState(3).randint(0, 160, (2, 24)).astype(np.int32)
    np.testing.assert_array_equal(
        tpn.gather_points(_t(feats), _t(pick)).numpy(),
        np.asarray(jpn.gather_points(jnp.asarray(feats), jnp.asarray(pick))))
    gidx = tpn.ball_query(0.0, 0.5, 12, _t(xyz), _t(ctr), _t(valid))
    np.testing.assert_array_equal(
        tpn.grouping_operation(_t(feats), gidx).numpy(),
        np.asarray(jpn.grouping_operation(jnp.asarray(feats),
                                          jnp.asarray(gidx.numpy()))))
    for norm in (False, True):
        got = tpn.query_and_group(_t(xyz), _t(ctr), gidx, _t(feats),
                                  normalize_xyz=norm, radius=0.5)
        ref = jpn.query_and_group(jnp.asarray(xyz), jnp.asarray(ctr),
                                  jnp.asarray(gidx.numpy()),
                                  jnp.asarray(feats), normalize_xyz=norm,
                                  radius=0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _is_float(a):
    if isinstance(a, tuple):
        return all(_is_float(x) for x in a)
    return a is not None and a.dtype == np.float32


def _jax_run(fm, v, args, kw, r, main):
    """Test-mode output; train-mode output, gradients of sum(out * r) for
    the parameters and the float inputs (``args``' float leading ones),
    and the new statistics."""
    nf = sum(1 for a in args if _is_float(a))

    def loss(params, *xs):
        out, mut = fm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, *xs,
                            train=True, mutable=["batch_stats"], **kw)
        out = out[main] if isinstance(out, tuple) else out
        return (out * r).sum(), (out, mut["batch_stats"])

    def run(params, *xs):
        test = fm.apply(v, *xs, **kw)
        test = test[main] if isinstance(test, tuple) else test
        (_, (train, stats)), grads = jax.value_and_grad(
            loss, argnums=tuple(range(nf + 1)), has_aux=True)(params, *xs)
        return test, train, stats, grads

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(
        v["params"], *jax.tree_util.tree_map(jnp.asarray, args)))


def _leaves(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _leaves(x, prefix + (k,))
        else:
            yield prefix + (k,), x


def _assert_module(tm, fm, v, args, kw=None, main=1):
    """The module against flax: test mode, train-mode output, parameter and
    input gradients, running statistics."""
    kw = kw or {}

    def conv(a):
        return (tuple(conv(x) for x in a) if isinstance(a, tuple) else
                None if a is None else _t(a))

    targs = [conv(a) for a in args]
    with torch.no_grad():
        test = tm(*targs, **kw)
    leading = []
    for a, raw in zip(targs, args):
        if _is_float(raw):
            leading.extend(a if isinstance(a, tuple) else (a,))
    for a in leading:
        a.requires_grad_(True)
    train = tm(*targs, train=True, **kw)
    pick = (lambda o: o[main]) if isinstance(train, tuple) else (lambda o: o)
    r = np.random.RandomState(9).randn(*pick(train).shape).astype(np.float32)
    (pick(train) * _t(r)).sum().backward()
    jtest, jtrain, jstats, jgrads = _jax_run(fm, v, args, kw, jnp.asarray(r),
                                             main)
    np.testing.assert_allclose(pick(test).numpy(), jtest, **TOL)
    np.testing.assert_allclose(pick(train).detach().numpy(), jtrain, **TOL)
    n = 0
    for path, ref in _leaves(jgrads[0]):
        *mods, leaf = path
        mod = tm.get_submodule(".".join(mods))
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        g = getattr(mod, name).grad.numpy()
        g = g.T if leaf == "kernel" else g
        np.testing.assert_allclose(g, ref, rtol=1e-5,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in tm.parameters())
    refs = jax.tree_util.tree_leaves(jgrads[1:])
    assert len(refs) == len(leading)
    for a, ref in zip(leading, refs):
        # NaN where both differentiate a norm at 0 (PAConv's centre pair)
        np.testing.assert_allclose(a.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-4 * np.nanmax(np.abs(ref)))
    for path, ref in _leaves(jstats):
        mod = tm.get_submodule(".".join(path[:-1]))
        np.testing.assert_allclose(
            getattr(mod, f"running_{path[-1]}").numpy(), ref, **TOL,
            err_msg="/".join(path))


def _init(fm, *args, **kw):
    return _numpy_vars(jax.jit(lambda *a: fm.init(
        jax.random.PRNGKey(0), *a, **kw))(
            *jax.tree_util.tree_map(jnp.asarray, args)))


def test_sa_msg_module_matches_jax():
    """Two scales at 32 FPS centres with features, max-pooled: a ball and
    a kNN scale (radius None); the FPS indices exactly."""
    xyz, valid, feats = _cloud(4, c=3)
    _assert_fps_margin(xyz, valid, 32)
    ctr = np.stack([x[np.asarray(jpn_fps(x, v, 32))] for x, v in
                    zip(xyz, valid)])
    for b in range(2):
        _assert_radius_margin(_d2(ctr[b], xyz[b][valid[b]]), (0.4,))
    _assert_order_margin(np.where(valid[:, None], _d2(ctr, xyz), np.inf), 8)
    kw = dict(num_point=32, radii=(0.4, None), sample_nums=(12, 8),
              mlp_channels=((8, 16), (8, 8)))
    fm = jpm.PointSAModuleMSG(**kw)
    v = _init(fm, xyz, feats, valid)
    tm = load_flax_variables(tpm.PointSAModuleMSG(in_channels=3, **kw), v)
    _assert_module(tm, fm, v, (xyz, feats, valid))
    idx = tm(_t(xyz), _t(feats), _t(valid))[2]
    ref = fm.apply(v, jnp.asarray(xyz), jnp.asarray(feats),
                   jnp.asarray(valid))[2]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))


def jpn_fps(xyz, valid, k):
    from sst_tpu.ops.fps import furthest_point_sample

    return furthest_point_sample(jnp.asarray(xyz), jnp.asarray(valid), k)[0]


def test_sa_module_and_fp_module_match_jax():
    """``PointSAModule`` (one scale, xyz only, normalised, average-pooled)
    and ``PointFPModule`` from its 32 centres to 160 other points. (Cloud
    seed 6 was refused: a point within 1e-5 of the 0.5 m ball.)"""
    xyz, valid, feats = _cloud(10, c=4)
    _assert_fps_margin(xyz, valid, 32)
    ctr = np.stack([x[np.asarray(jpn_fps(x, v, 32))] for x, v in
                    zip(xyz, valid)])
    for b in range(2):
        _assert_radius_margin(_d2(ctr[b], xyz[b][valid[b]]), (0.5,))
    kw = dict(num_point=32, radii=(0.5,), sample_nums=(16,),
              mlp_channels=((8, 8, 16),), pool_mod="avg",
              normalize_xyz=True)
    fm = jpm.PointSAModule(**kw)
    v = _init(fm, xyz, None, valid)
    tm = load_flax_variables(tpm.PointSAModule(**kw), v)
    _assert_module(tm, fm, v, (xyz, None, valid))
    src_feats = np.random.RandomState(7).randn(2, 16, 32).astype(np.float32)
    # targets off the centres: at a distance ~0 the inverse-distance
    # weights turn on the expansion's rounding
    tgt = _cloud(11, c=4)
    d2 = _d2(tgt[0], ctr)
    assert d2.min() >= 1e-4
    _assert_order_margin(d2, 3)
    fm = jpm.PointFPModule(mlp_channels=(16, 8))
    args = (tgt[0], ctr, tgt[2], src_feats)
    v = _init(fm, *args)
    tm = load_flax_variables(tpm.PointFPModule((16, 8), in_channels=20), v)
    _assert_module(tm, fm, v, args)


def test_paconv_and_scorenet_match_jax():
    """PAConv (``w_neighbor`` kernels, ``w_neighbor_dist`` scores, softmax)
    and a sigmoid ScoreNet with its last BN."""
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 6, 20, 8).astype(np.float32)
    pxyz = rng.randn(2, 3, 20, 8).astype(np.float32)
    fm = jpm.PAConv(in_channels=6, out_channels=10, num_kernels=4)
    v = _init(fm, (feats, pxyz))
    assert v["params"]["weight_bank"].shape == (12, 40)
    tm = load_flax_variables(tpm.PAConv(6, 10, 4), v)
    assert tm.bn.momentum == 0.9 and tm.bn.eps == 1e-5
    _assert_module(tm, fm, v, ((feats, pxyz),), main=0)
    geo = rng.randn(2, 7, 20, 8).astype(np.float32)
    fm = jpm.ScoreNet((16, 4), score_norm="sigmoid", last_bn=True)
    v = _init(fm, geo)
    tm = load_flax_variables(tpm.ScoreNet(7, (16, 4), score_norm="sigmoid",
                                          last_bn=True), v)
    _assert_module(tm, fm, v, (geo,))


@pytest.mark.parametrize("strict", ["extra_leaf", "bad_shape"])
def test_converter_stays_strict_on_pointnet(strict):
    """A flax leaf without a torch target, or at another shape, raises."""
    fm = jpm.PAConv(in_channels=6, out_channels=10, num_kernels=4)
    rng = np.random.RandomState(0)
    v = _init(fm, (rng.randn(1, 6, 4, 3).astype(np.float32),
                   rng.randn(1, 3, 4, 3).astype(np.float32)))
    params = dict(v["params"])
    if strict == "extra_leaf":
        params["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        err = KeyError
    else:
        params["weight_bank"] = params["weight_bank"][:, :-1]
        err = ValueError
    with pytest.raises(err):
        load_flax_variables(tpm.PAConv(6, 10, 4), dict(v, params=params))
