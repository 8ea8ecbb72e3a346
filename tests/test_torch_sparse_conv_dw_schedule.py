"""The sparse conv weight-gradient kernel's loop over the forward's
mask-sorted row schedule (``csrc/sparse_conv_dw.cu``), on the CPU.

The kernel runs only on the card. Here a plain emulation of its loop walks
what it walks: per tap k, the list of the schedule's 64-row tiles whose mask
has bit k, cut into the wrapper's ``split_rows`` equal shares; each share's
tiles in schedule order, each in two 32-row stages; a stage's products are
summed from zero and then added to the share's accumulator, and the shares'
partials are summed in split order. It is held against the wrapper's twin
``sparse_conv_dw_ref`` and against JAX's dW (``jax.grad`` of
``gather_gemm`` with respect to the weights, with the missing entries
written as Vin, which is all ``gather_gemm`` reads as missing) at rtol 1e-5
plus 1e-5 of the sum of absolute products (both sum the same f32 products
in other orders), on the edge cases that ``chip_smoke.py`` phase 10 gives
the kernel: a tap with no neighbour, every row missing, Vout off the 64-row
tile, 40 -> 72 and 16 -> 32 channels, several splits, 32 taps (bit 31 of a
mask is the int32 sign), and missing entries written as -1, Vin and past
Vin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.ops.sparse_conv import gather_gemm
from sst_tpu_torch.ops import sparse_conv_dw as scd
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from torch_threads import torch_threads_per_worker  # noqa: F401

TILE = scg.TILE_ROWS
STAGE = 32


def _case(seed, vin, vout, cin, cout, taps=27, missing=0.6):
    """feats, a [K, Vout] table whose missing entries are Vin, -1 or past
    Vin, and dout."""
    rng = np.random.RandomState(seed)
    nbr = rng.randint(0, vin, (taps, vout))
    drop = rng.rand(taps, vout) < missing
    nbr = np.where(drop, rng.choice([vin, -1, vin + 7], (taps, vout)), nbr)
    return (torch.from_numpy(rng.randn(vin, cin).astype(np.float32)),
            torch.from_numpy(nbr.astype(np.int32)),
            torch.from_numpy(rng.randn(vout, cout).astype(np.float32)))


def _dw_emulation(feats, nbr, dout, sched):
    """The kernel's loop in plain torch. Rows past Vout and missing
    neighbours read zero rows (index Vout of the extended dout, Vin of the
    extended feats)."""
    vin, cin = feats.shape
    taps, vout = nbr.shape
    cout = dout.shape[1]
    splits = scd.split_rows(taps, cin, cout, vout)
    tiles = sched.tile_mask.shape[0]
    ext_f = torch.cat([feats, feats.new_zeros((1, cin))])
    ext_d = torch.cat([dout, dout.new_zeros((1, cout))])
    perm = torch.nn.functional.pad(sched.perm.long(),
                                   (0, tiles * TILE - vout), value=vout)
    masks = [m & 0xFFFFFFFF for m in sched.tile_mask.tolist()]
    partial = feats.new_zeros((splits, taps, cin, cout))
    for k in range(taps):
        idx = nbr[k].long()
        idx = torch.where((idx >= 0) & (idx < vin), idx, vin)
        idx = torch.cat([idx, idx.new_full((1,), vin)])  # row Vout: missing
        listed = [i for i in range(tiles) if masks[i] >> k & 1]
        for s in range(splits):
            acc = feats.new_zeros((cin, cout))
            share = listed[len(listed) * s // splits:
                           len(listed) * (s + 1) // splits]
            assert len(share) <= -(-tiles // splits)
            for i in share:
                for h in range(TILE // STAGE):
                    r = perm[i * TILE + h * STAGE:i * TILE + (h + 1) * STAGE]
                    acc = acc + ext_f[idx[r]].T @ ext_d[r]
            partial[s, k] = acc
    out = partial[0]
    for s in range(1, splits):
        out = out + partial[s]
    return out, splits


def _jax_dw(feats, nbr, dout):
    vin = feats.shape[0]
    table = np.where((nbr >= 0) & (nbr < vin), nbr, vin)

    def loss(w):
        return (gather_gemm(jnp.asarray(feats), jnp.asarray(table), w)
                * jnp.asarray(dout)).sum()

    w = jnp.zeros((nbr.shape[0], feats.shape[1], dout.shape[1]), jnp.float32)
    return np.asarray(jax.jit(jax.grad(loss))(w))


def _assert_dw_close(got, want, feats, nbr, dout, name):
    scale = scd.sparse_conv_dw_ref(feats.abs(), nbr, dout.abs()).numpy()
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert (diff <= 1e-5 * np.abs(np.asarray(want)) + 1e-5 * scale
            + 1e-7).all(), (name, float(diff.max()))


# (name, seed, vin, vout, cin, cout, taps, missing)
CASES = [
    ("tap with no neighbour anywhere", 0, 500, 300, 64, 64, 27, 0.6),
    ("all rows missing", 1, 500, 300, 64, 64, 27, 1.0),
    ("Vout=1000 off the 64-row tile, 40->72", 2, 1200, 1000, 40, 72, 27,
     0.6),
    ("16->32, several splits", 3, 3000, 2500, 16, 32, 27, 0.6),
    ("32 taps, mostly missing", 4, 900, 700, 24, 40, 32, 0.9),
    ("nothing missing, one tile", 5, 80, 50, 8, 12, 27, 0.0),
]


@pytest.mark.parametrize("name,seed,vin,vout,cin,cout,taps,missing", CASES,
                         ids=[c[0] for c in CASES])
def test_dw_emulation_matches_twin_and_jax(name, seed, vin, vout, cin, cout,
                                           taps, missing):
    feats, nbr, dout = _case(seed, vin, vout, cin, cout, taps, missing)
    if name.startswith("tap with no"):
        nbr[13] = vin
    if name.startswith("all rows"):
        nbr.fill_(-1)
    sched = scg.conv_schedule(nbr, vin)
    got, splits = _dw_emulation(feats, nbr, dout, sched)
    if name.endswith("several splits"):
        assert splits > 1
    ref = scd.sparse_conv_dw_ref(feats, nbr, dout)
    _assert_dw_close(got, ref, feats, nbr, dout, name)
    _assert_dw_close(got, _jax_dw(feats.numpy(), nbr.numpy(), dout.numpy()),
                     feats, nbr, dout, name)
    has = ((nbr >= 0) & (nbr < vin)).any(1)
    # a tap that no row has is written as zeros
    assert (got[~has] == 0).all()
    if has.any():
        assert got[has].abs().sum() > 0
    # the CPU wrapper takes the twin, with or without a schedule
    torch.testing.assert_close(
        scd.sparse_conv_dw(feats, nbr, dout, "subm", schedule=sched), ref)


def test_dw_emulation_skips_what_has_no_neighbour():
    """The tiles the emulation executes for tap k are those whose mask has
    bit k, and together they hold every (row, tap k) pair with a
    neighbour: the skipped work is exactly work without one."""
    feats, nbr, _ = _case(6, 700, 1500, 8, 8, 27, 0.7)
    vin = feats.shape[0]
    sched = scg.conv_schedule(nbr, vin)
    has = ((nbr >= 0) & (nbr < vin)).numpy()
    perm = sched.perm.numpy()
    masks = sched.tile_mask.numpy().astype(np.int64) & 0xFFFFFFFF
    executed = 0
    for k in range(nbr.shape[0]):
        run = np.zeros(nbr.shape[1], bool)
        for i, m in enumerate(masks):
            if m >> k & 1:
                run[perm[i * TILE:(i + 1) * TILE]] = True
        assert not (has[k] & ~run).any()
        executed += run.sum()
    assert has.sum() <= executed < has.size
