"""Parity of the port's middle encoders, canvas tables and legacy window
plan with the JAX package: ``PointPillarsScatter``, ``build_canvas``, the
subm / strided / inverse canvas neighbour tables, ``zdown_grid_and_table``,
SECOND's ``SparseEncoder`` (``sst_tpu_torch/models/middle_encoders.py``,
``ops/sparse_conv.py``) and ``drop_and_bucket`` / ``build_flat2win``
(``ops/window.py``).

Grids are ``tests/test_middle_encoders.py _random_grid``'s kind: distinct
seeded sites over two samples, padded to a cap, sorted by key. The tables
are held equal to JAX's entry for entry; ``SparseEncoder`` at narrow widths
(4 → 8, the default four stages and paddings, 16 out) gets seeded
variables of the port model's shapes in flax's layout, and one jitted JAX
function gives its eval-mode map and, in train mode, its map, the
gradient of a seeded linear loss and the updated running statistics. The
JAX side runs its neighbour-table path (``gather_gemm``); the port's CPU
tensors take the conv, input-gradient and dW kernels' plain twins.

The file holds fewer than 8 test ids, so the tier-1 command's ``--dist
loadfile`` runs it beside ``tests/test_train_step.py``, not before it
(ROADMAP.md, "Tier-1 headroom").

Tolerances: tables, grids, counts and plans exactly; the scatter's maps
exactly; ``SparseEncoder``'s maps at rtol 1e-5 and atol 1e-5 of the map's
largest magnitude, each gradient leaf and each running statistic within
1e-5 relative plus 1e-5 of the leaf's largest magnitude (12 convs of up to
27 * 16 f32 products, summed in another order by the twin than by XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.models import middle_encoders as jme
from sst_tpu.ops import sparse_conv as jsc
from sst_tpu.ops import window as jwin
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import middle_encoders as tme
from sst_tpu_torch.ops import sparse_conv as tsc
from sst_tpu_torch.ops import sparse_conv_dw as sdw
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from sst_tpu_torch.ops import window as twin
from test_torch_ctrl import seeded_port_variables
from test_torch_fsdv2_train import _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

ENC = dict(base_channels=8, output_channels=16,
           encoder_channels=((8,), (16, 16, 16), (16, 16, 16), (16, 16, 16)))
ENC_GRID = (41, 24, 24)  # z 41 -> 21 -> 11 -> 5 -> zdown 2, as KITTI's


@pytest.fixture(autouse=True)
def _table_path(monkeypatch):
    monkeypatch.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)


def _random_grid(grid=(10, 16, 16), v=300, b=2, cap=384, seed=0):
    """The same sites as a JAX and a port SparseGrid."""
    nz, ny, nx = grid
    rng = np.random.RandomState(seed)
    picks = rng.choice(b * nz * ny * nx, size=v, replace=False)
    bb, r = picks // (nz * ny * nx), picks % (nz * ny * nx)
    z, r = r // (ny * nx), r % (ny * nx)
    coords = -np.ones((cap, 4), np.int32)
    coords[:v] = np.stack([bb, z, r // nx, r % nx], -1)
    valid = np.arange(cap) < v
    jsg, _ = jsc.make_sparse_grid(jnp.asarray(coords), jnp.asarray(valid),
                                  grid, b)
    tsg, _ = tsc.make_sparse_grid(torch.from_numpy(coords),
                                  torch.from_numpy(valid), grid, b)
    np.testing.assert_array_equal(tsg.keys.numpy(), np.asarray(jsg.keys))
    return jsg, tsg


def _same_grid(jsg, tsg):
    assert tsg.grid == jsg.grid and tsg.batch_size == jsg.batch_size
    for f in ("keys", "coords", "valid"):
        np.testing.assert_array_equal(getattr(tsg, f).numpy(),
                                      np.asarray(getattr(jsg, f)))


def test_pillar_scatter_golden_and_seeded():
    """JAX's golden case (``tests/test_middle_encoders.py``), then seeded
    pillars against JAX's module; the port's map is NCHW."""
    mod = tme.PointPillarsScatter(2, (4, 4), batch_size=2)
    feats = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    coors = torch.tensor([[0, 0, 1, 2], [0, 0, 0, 0], [1, 0, 3, 1]],
                         dtype=torch.int32)
    out = mod(feats, coors, torch.tensor([True, True, True]))
    assert out.shape == (2, 2, 4, 4)
    np.testing.assert_array_equal(out[0, :, 1, 2].numpy(), [1, 2])
    np.testing.assert_array_equal(out[0, :, 0, 0].numpy(), [3, 4])
    np.testing.assert_array_equal(out[1, :, 3, 1].numpy(), [5, 6])
    assert float(out.abs().sum()) == 21.0
    out2 = mod(feats, coors, torch.tensor([True, False, True]))
    assert float(out2[0, :, 0, 0].abs().sum()) == 0.0

    rng = np.random.RandomState(0)
    ny, nx, b, p, c = 12, 10, 2, 96, 5
    cells = rng.choice(b * ny * nx, size=p, replace=False)
    coors = np.stack([cells // (ny * nx), np.zeros(p, np.int64),
                      cells % (ny * nx) // nx, cells % nx], 1).astype(
                          np.int32)
    feats = rng.randn(p, c).astype(np.float32)
    valid = rng.rand(p) < 0.8
    want = jme.PointPillarsScatter(c, (ny, nx), b).apply(
        {}, jnp.asarray(feats), jnp.asarray(coors), jnp.asarray(valid))
    got = tme.PointPillarsScatter(c, (ny, nx), b)(
        torch.from_numpy(feats), torch.from_numpy(coors),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("padding", [(1, 1, 1), (0, 1, 1)])
def test_canvas_tables_equal_jax(padding):
    """``build_canvas`` and the subm, strided and inverse tables over a
    grid and its downsample; JAX's canvas writes its padding sites into the
    trailing row's first slot, which no table reads unmasked: the trailing
    row is compared apart."""
    jsg, tsg = _random_grid()
    jc, tc = jax.jit(jsc.build_canvas)(jsg), tsc.build_canvas(tsg)
    assert tuple(tc.shape) == jc.shape and tc.dtype == torch.int32
    np.testing.assert_array_equal(tc[:-1].numpy(), np.asarray(jc[:-1]))
    np.testing.assert_array_equal(tc[-1].numpy(), tsg.cap)
    assert (np.asarray(jc[-1, 1:]) == jsg.cap).all()
    subm = tsc.subm_neighbor_table(tsg)
    np.testing.assert_array_equal(subm.numpy(), np.asarray(
        jax.jit(jsc.subm_neighbor_table)(jsg, jc)))

    stride = (2, 2, 2)
    jdn = jsc.downsample_grid(jsg, 256, stride, padding)
    tdn = tsc.downsample_grid(tsg, 256, stride, padding)
    _same_grid(jdn, tdn)
    jdc = jax.jit(jsc.build_canvas)(jdn)
    static = dict(static_argnums=(3, 4))
    strided = tsc.strided_neighbor_table(tdn, tsg, stride, padding)
    np.testing.assert_array_equal(strided.numpy(), np.asarray(jax.jit(
        jsc.strided_neighbor_table, **static)(jdn, jsg, jc, stride,
                                               padding)))
    inverse = tsc.inverse_neighbor_table(tsg, tdn, stride, padding)
    np.testing.assert_array_equal(inverse.numpy(), np.asarray(jax.jit(
        jsc.inverse_neighbor_table, **static)(jsg, jdn, jdc, stride,
                                               padding)))
    assert (strided < tsg.cap).sum() > tdn.valid.sum()  # real neighbours


def test_zdown_grid_and_table_equal_jax():
    jsg, tsg = _random_grid(grid=(9, 12, 12), v=400, cap=512, seed=3)
    jc = jax.jit(jsc.build_canvas)(jsg)
    for cap_out in (512, 200):  # 200 < the outputs: the highest drop
        jout, jnbr = jax.jit(jme.zdown_grid_and_table, static_argnums=2)(
            jsg, jc, cap_out)
        tout, tnbr = tme.zdown_grid_and_table(tsg, cap_out)
        _same_grid(jout, tout)
        assert tnbr.shape == (3, cap_out) and tnbr.dtype == torch.int32
        np.testing.assert_array_equal(tnbr.numpy(), np.asarray(jnbr))
    assert bool(tout.valid.all())


@pytest.fixture(scope="module")
def encoder_run():
    jsg, tsg = _random_grid(grid=ENC_GRID, v=480, cap=512, seed=5)
    rng = np.random.RandomState(6)
    feats = np.where(np.asarray(jsg.valid)[:, None],
                     rng.randn(512, 4), 0.0).astype(np.float32)
    tm = tme.SparseEncoder(4, **ENC)
    v = seeded_port_variables(tm, seed=7)
    load_flax_variables(tm, v)
    jm = jme.SparseEncoder(in_channels=4, **ENC)
    # JAX's map is NHWC [B, ny, nx, oz * C]; the port's NCHW
    out_shape = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(feats), jsg))
    g = rng.randn(*out_shape.shape).astype(np.float32)

    def ref(params, stats, x, g):
        ev = jm.apply({"params": params, "batch_stats": stats}, x, jsg)

        def loss(p):
            out, upd = jm.apply({"params": p, "batch_stats": stats}, x, jsg,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out * g), (out, upd["batch_stats"])

        (val, (tr, new_stats)), grads = jax.value_and_grad(
            loss, has_aux=True)(params)
        return ev, tr, val, grads, new_stats

    want = jax.tree_util.tree_map(np.asarray, jax.jit(ref)(
        v["params"], v["batch_stats"], jnp.asarray(feats), jnp.asarray(g)))
    x = torch.from_numpy(feats)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    scg.reset_launch_counts()
    sdw.reset_launch_counts()
    with torch.no_grad():
        ev = tm(x, tsg).permute(0, 2, 3, 1).numpy()
    tr = tm(x, tsg, train=True)
    val = (tr * gt).sum()
    val.backward()
    val = float(val.detach())
    assert scg.launches == sdw.launches == 0  # CPU tensors take the twins
    return dict(jm=jm, tm=tm, want=want, ev=ev,
                tr=tr.detach().permute(0, 2, 3, 1).numpy(), val=val)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


def test_sparse_encoder_maps_equal_jax(encoder_run):
    ev, tr, val, _, _ = encoder_run["want"]
    assert ev.shape == (2, 3, 3, 16 * 2)  # 24 -> 3 BEV, z 41 -> 2
    assert np.abs(ev).max() > 0
    _close(encoder_run["ev"], ev)
    _close(encoder_run["tr"], tr)
    np.testing.assert_allclose(encoder_run["val"], val, rtol=1e-5)


def test_sparse_encoder_gradients_and_stats_equal_jax(encoder_run):
    tm, (_, _, _, grads, stats) = encoder_run["tm"], encoder_run["want"]
    assert tm.conv_out.weight.grad.shape == (3, 16, 16)
    assert tuple(grads["conv_out"]["kernel"].shape) == (3, 16, 16)
    n = 0
    for path, want in _leaves(grads):
        _close(_torch_leaf(tm, path, grad=True), want)
        n += 1
    for path, want in _leaves(stats):
        _close(_torch_leaf(tm, path, grad=False), want)
    assert n == 3 * 12  # each conv's kernel, scale and bias


def _window_setup(seed=0, n=700):
    rng = np.random.RandomState(seed)
    coords = np.stack([rng.randint(0, 2, n), np.zeros(n, np.int64),
                       rng.randint(0, 48, n), rng.randint(0, 48, n)],
                      1).astype(np.int32)
    valid = rng.rand(n) < 0.9
    buckets = (jwin.BucketSpec(8, 0, 8, 24), jwin.BucketSpec(16, 8, 100000,
                                                             6))
    tb = tuple(twin.BucketSpec(b.max_tokens, b.drop_lower, b.drop_upper,
                               b.max_windows) for b in buckets)
    return coords, valid, buckets, tb


def test_legacy_window_plan_equals_jax():
    """``drop_and_bucket`` and ``build_flat2win`` on seeded pillars (a
    bucket's window cap overflows), both shifts; ``flat2window`` over the
    legacy plan gives JAX's windows, and the windows of
    ``finalize_flat2win``'s plan."""
    coords, valid, jb, tb = _window_setup()
    feat = np.random.RandomState(1).randn(len(valid), 3).astype(np.float32)
    for shift in (False, True):
        jwi, jciw = jwin.get_window_coors(jnp.asarray(coords), (48, 48, 1),
                                          (6, 6), shift, jnp.asarray(valid))
        twi, tciw = twin.get_window_coors(torch.from_numpy(coords),
                                          (48, 48, 1), (6, 6), shift,
                                          torch.from_numpy(valid))
        np.testing.assert_array_equal(twi.numpy(), np.asarray(jwi))
        jkeep, jlvl = jwin.drop_and_bucket(jwi, jnp.asarray(valid), jb, 512)
        tkeep, tlvl = twin.drop_and_bucket(twi, torch.from_numpy(valid), tb,
                                           512)
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(tlvl.numpy(), np.asarray(jlvl))
        jf = jwin.build_flat2win(jwi, jciw, jlvl, jkeep, jb)
        tf = twin.build_flat2win(twi, tciw, tlvl, tkeep, tb)
        for f in ("drop_lvl", "flat_inds", "valid"):
            np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                          np.asarray(getattr(jf, f)))
        assert int(tf.valid.sum()) < int(tkeep.sum())  # the window cap drops
        want = jwin.flat2window(jnp.asarray(feat), jf)
        got = twin.flat2window(torch.from_numpy(feat), tf)
        uniq, keep, lvl = twin.drop_pass(twi, torch.from_numpy(valid), tb,
                                         512)
        fin = twin.flat2window(torch.from_numpy(feat), twin.finalize_flat2win(
            uniq, tciw, lvl, keep, tb, 512))
        for g, w, f in zip(got, want, fin):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(f.numpy(), g.numpy())
        for pad, w in zip(tf.pads, jwin.window_key_padding(jf)):
            np.testing.assert_array_equal(pad.numpy(), np.asarray(w))
