"""Parity of the port's sparse UNet modules (``sst_tpu_torch/models/
sparse_unet.py``) with flax: the same flax variables (random BN statistics
and affine terms) are converted into the torch module, both get the same
numpy features on the same grid, and the JAX side runs its neighbour-table
path (``gather_gemm``), as it does on the CPU.

Tolerance: rtol/atol 1e-5. Each conv sums up to 27 * Cin f32 products, in
another order in the twin than in XLA's einsum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.models import sparse_unet as jsu
from sst_tpu.ops import sparse_conv as jsc
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import sparse_unet as tsu
from sst_tpu_torch.ops import sparse_conv as tsc

TOL = dict(rtol=1e-5, atol=1e-5)
GRID = (8, 24, 24)
CAPS = (320, 192, 96)
STRIDES = ((2, 2, 2),) * 2
PADDINGS = ((1, 1, 1),) * 2


@pytest.fixture(autouse=True)
def _table_path(monkeypatch):
    monkeypatch.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)


def _grids(seed=0, cap=320, batch=2, fill=260):
    rng = np.random.RandomState(seed)
    nz, ny, nx = GRID
    coords = np.stack([rng.randint(0, batch, fill), rng.randint(0, nz, fill),
                       rng.randint(0, ny, fill), rng.randint(0, nx, fill)],
                      1).astype(np.int32)
    coords = np.unique(coords, axis=0)
    n = coords.shape[0]
    coords = np.concatenate([coords, -np.ones((cap - n, 4), np.int32)])
    valid = np.arange(cap) < n
    jsg, _ = jsc.make_sparse_grid(jnp.asarray(coords), jnp.asarray(valid),
                                  GRID, batch)
    tsg, _ = tsc.make_sparse_grid(torch.from_numpy(coords),
                                  torch.from_numpy(valid), GRID, batch)
    return jsg, tsg


def _plans(levels=3):
    jsg, tsg = _grids()
    n = levels - 1
    jp = jsu.build_unet_plan(jsg, CAPS[:levels], STRIDES[:n], PADDINGS[:n])
    tp = tsu.build_unet_plan(tsg, CAPS[:levels], STRIDES[:n], PADDINGS[:n])
    assert jp.subm[0].nbr is not None  # the neighbour-table path
    return jp, tp


def _feats(c, valid, seed=1):
    x = np.random.RandomState(seed).randn(valid.shape[0], c).astype(
        np.float32)
    return np.where(np.asarray(valid)[:, None], x, 0.0).astype(np.float32)


def _randomized(variables, seed=2):
    """Flax variables as numpy, with random BN statistics, scales and
    biases (flax initialises them to 0 and 1)."""
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))

    def visit(tree):
        tree = dict(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = visit(v)
            elif k in ("mean", "bias"):
                tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return tree

    return {k: visit(v) for k, v in out.items()}


def _run_both(jmod, tmod, feats, jargs, targs):
    variables = _randomized(jax.jit(
        lambda f, a: jmod.init(jax.random.PRNGKey(0), f, *a, False))(
            jnp.asarray(feats), jargs))
    ref = jax.jit(lambda v, f, a: jmod.apply(v, f, *a, False))(
        variables, jnp.asarray(feats), jargs)
    load_flax_variables(tmod, variables).eval()
    with torch.inference_mode():
        got = tmod(torch.from_numpy(feats), *targs)
    return got, ref


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 24)])
def test_sparse_conv_layer(level, cin, cout):
    jp, tp = _plans()
    valid = jp.levels[level].valid
    feats = _feats(cin, valid)
    got, ref = _run_both(
        jsu.SparseConvLayer(cout), tsu.SparseConvLayer(cin, cout), feats,
        (jp.subm[level], valid), (tp.subm[level], tp.levels[level].valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.abs(np.asarray(ref)).sum() > 0


@pytest.mark.parametrize("mode", ["strided", "inverse"])
def test_sparse_conv_layer_strided_and_inverse(mode):
    jp, tp = _plans()
    if mode == "strided":
        jcp, tcp, vin, vout = jp.down[0], tp.down[0], 0, 1
    else:
        jcp, tcp, vin, vout = jp.inv[0], tp.inv[0], 1, 0
    feats = _feats(16, jp.levels[vin].valid)
    got, ref = _run_both(
        jsu.SparseConvLayer(16), tsu.SparseConvLayer(16, 16), feats,
        (jcp, jp.levels[vout].valid),
        (tcp, tp.levels[vout].valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cin,c", [(16, 16), (16, 24)])
def test_sparse_basic_block(cin, c):
    jp, tp = _plans()
    feats = _feats(cin, jp.levels[0].valid)
    tmod = tsu.SparseBasicBlock(cin, c)
    assert (tmod.downsample is not None) == (cin != c)
    got, ref = _run_both(jsu.SparseBasicBlock(c), tmod, feats,
                         (jp.subm[0], jp.levels[0].valid),
                         (tp.subm[0], tp.levels[0].valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


UNET = dict(base_channels=16, encoder_channels=((16,), (16, 16), (24, 24)),
            decoder_channels=((40, 32, 16), (16, 16, 16), (16, 16, 16)))


def test_simple_sparse_unet_multiscale():
    """A lateral block with a downsample (24 → 40), the channel-reduce
    residual, and the decoder features of every level."""
    jp, tp = _plans()
    feats = _feats(16, jp.levels[0].valid)
    got, ref = _run_both(
        jsu.SimpleSparseUNet(return_multiscale=True, **UNET),
        tsu.SimpleSparseUNet(16, return_multiscale=True, **UNET), feats,
        (jp,), (tp,))
    np.testing.assert_allclose(got["voxel_feats"].numpy(),
                               np.asarray(ref["voxel_feats"]), **TOL)
    assert len(got["decoder_features"]) == 3
    for d, (g, r) in enumerate(zip(got["decoder_features"],
                                   ref["decoder_features"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL,
                                   err_msg=f"decoder feature {d}")
    for k in ("voxel_coords", "voxel_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_virtual_voxel_mixer():
    jp, tp = _plans(levels=2)
    cfg = dict(base_channels=16, output_channels=24,
               encoder_channels=((16,), (16, 16)),
               decoder_channels=((16, 16, 16), (16, 16, 16)))
    feats = _feats(20, jp.levels[0].valid)
    got, ref = _run_both(jsu.VirtualVoxelMixer(**cfg),
                         tsu.VirtualVoxelMixer(20, **cfg), feats,
                         (jp,), (tp,))
    assert got.shape == (CAPS[0], 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_unet_plan_levels_match_jax():
    jp, tp = _plans()
    for lvl, (j, t) in enumerate(zip(jp.levels, tp.levels)):
        np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys),
                                      err_msg=f"level {lvl}")
    for fam in ("subm", "down", "inv"):
        for j, t in zip(getattr(jp, fam), getattr(tp, fam)):
            np.testing.assert_array_equal(t.nbr.numpy(), np.asarray(j.nbr),
                                          err_msg=fam)
