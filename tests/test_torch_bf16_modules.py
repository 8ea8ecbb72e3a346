"""The port's modules at the bfloat16 compute policy against their flax
counterparts at ``dtype=jnp.bfloat16``, on the CPU: the same inputs (numpy,
seeded), the same float32 weights and running statistics, in inference and
in train mode where the module trains.

Each output's dtype must equal JAX's. Values are held at a tolerance in
bfloat16 terms: ``|got - ref| <= 2^-7 |ref| + k 2^-7 max|ref|``, one bf16
ulp of the value plus k ulps of the output's largest magnitude; ``k`` is
stated per test with the largest gap measured (in units of 2^-7 max|ref|,
after the 2^-7 |ref| part). The JAX side is jitted over seeded variables
of ``fm.init``'s shapes, with XLA's excess precision off (``_exact_bf16``):
by default XLA on the CPU keeps some bf16 intermediates of a fused graph at
float32 precision, which moves a forward value a few ulps and a gradient
leaf up to 30 ulps of its largest from flax's dtypes as written, the
rounding the port follows. Train-mode gradients (``jax.grad``) are held
leaf by leaf at the same tolerance. Running statistics are float32 in both
and are held at rtol 2^-7 of each channel plus 2^-7 of the largest.

The sorted segment reduce's bfloat16 route (its twin against JAX's Pallas
kernel in interpret mode) and the sums of ``ops/segment.py`` in bfloat16
are held exactly or within one bf16 ulp, as stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.core import box_coders as jcoders
from sst_tpu.core import losses as jlosses
from sst_tpu.models import dense_bev as fd
from sst_tpu.models import layers as fl
from sst_tpu.models.fsd import sparse_cluster_head as fsch
from sst_tpu.models.fsd import vote_segmentor as fvs
from sst_tpu.models.vfe import DynamicVFE as FlaxVFE
from sst_tpu.ops.segment import gather_segments as jax_gather
from sst_tpu.ops.segment import segment_reduce as jax_segment_reduce
from sst_tpu.ops.segment import unique_segments
from sst_tpu.ops.sorted_reduce import sorted_segment_reduce as jax_sorted
from sst_tpu.ops.voxelize import dynamic_voxelize as jax_voxelize
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.core import box_coders as tcoders
from sst_tpu_torch.core import losses as tlosses
from sst_tpu_torch.models import dense_bev as td
from sst_tpu_torch.models import layers as tl
from sst_tpu_torch.models.fsd import sparse_cluster_head as tsch
from sst_tpu_torch.models.fsd import vote_segmentor as tvs
from sst_tpu_torch.models.vfe import DynamicVFE
from sst_tpu_torch.ops import sorted_reduce as sr
from sst_tpu_torch.ops.segment import gather_segments, segment_reduce
from sst_tpu_torch.ops.voxelize import dynamic_voxelize
from test_torch_fsdv2_dense_train import _torch_leaf

BF16 = jnp.bfloat16
ULP = 2.0**-7  # one bfloat16 ulp, relative, at the top of a binade


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _close(got, ref, k: float, what: str = "") -> float:
    """Asserts JAX's dtype and ``|got - ref| <= 2^-7 |ref| + k 2^-7
    max|ref|``; returns the largest gap beyond the 2^-7 |ref| part in units
    of 2^-7 max|ref| (0 when the values are equal)."""
    assert _dtype_name(got) == _dtype_name(ref), (what, got.dtype, ref.dtype)
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    scale = ULP * max(float(np.abs(r).max()), 1e-30)
    excess = np.maximum(np.abs(g - r) - ULP * np.abs(r), 0.0) / scale
    gap = float(excess.max()) if excess.size else 0.0
    assert gap <= k, f"{what}: gap {gap:.3f} x 2^-7 max|ref| > {k}"
    return gap


def _stats_close(tm, v_ref, what=""):
    """Every running statistic of ``tm`` against flax's updated tree."""
    n = 0
    for path, ref in _leaves(v_ref):
        mod = tm.get_submodule(".".join(path[:-1]))
        got = getattr(mod, f"running_{path[-1]}").numpy()
        np.testing.assert_allclose(got, ref, rtol=ULP,
                                   atol=ULP * np.abs(ref).max(),
                                   err_msg=f"{what} {'/'.join(path)}")
        n += 1
    assert n > 0


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _variables(fm, *args, seed=0) -> dict:
    """Seeded numpy variables of the shapes ``fm.init`` would make (traced
    with ``jax.eval_shape``, never compiled): kernels normal with variance
    1/fan_in, biases normal(0, 0.1), scales uniform(0.5, 1.5), z embeddings
    normal(0, 0.5), running means normal(0, 0.1) and variances uniform(0.5,
    1.5), all float32."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), *args))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            x = rng.randn(*shape) * 0.1
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = rng.randn(*shape) * 0.5
        return x.astype(np.float32)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: dict(v) for k, v in out.items()}


def _exact_bf16(f, *args):
    """``f(*args)`` jitted with XLA's ``xla_allow_excess_precision`` off, so
    every bf16 value of the graph is rounded to bf16 as its dtype says, as
    the port rounds it: on the CPU, XLA otherwise keeps some bf16
    intermediates of a fused graph at float32 precision."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jit_apply(fm, v, args, **kw):
    """``fm.apply(v, *args, **kw)`` jitted, with the arguments that are not
    arrays (batch sizes, grid shapes, flags) held static."""
    arrays = [i for i, a in enumerate(args) if hasattr(a, "shape")]

    def f(vv, *xs):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return fm.apply(vv, *full, **kw)

    return _exact_bf16(f, v, *[args[i] for i in arrays])


def _both(fm, tm, args, targs, train: bool):
    """flax ``fm`` (jitted) and torch ``tm`` with the same seeded variables
    on the same inputs; in train mode also the updated running statistics.
    Returns (ref, got, flax's new batch_stats, tm)."""
    v = _variables(fm, *args)
    if train:
        ref, mut = _jit_apply(fm, v, args, train=True,
                              mutable=["batch_stats"])
        stats = jax.tree_util.tree_map(np.asarray,
                                       dict(mut).get("batch_stats", {}))
    else:
        ref, stats = _jit_apply(fm, v, args), None
    tm = load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(*targs, train=train) if train else tm(*targs)
    return ref, got, stats, tm


def _torchify(*xs):
    return tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                 for x in xs)


# ------------------------------------------------------------------ layers


def test_dense_rounds_the_bias_add_as_flax_does():
    """flax's bf16 Dense adds the bias to the rounded product: the port's
    ``Dense`` (product, then a separate bf16 add) equals it on all but a
    handful of 262,144 outputs (2 measured: XLA's own product rounding);
    a fused ``F.linear`` with the bias, rounding once, differs on about a
    quarter of them."""
    rng = np.random.RandomState(0)
    x = rng.randn(2048, 64).astype(np.float32)
    w = (rng.randn(64, 128) * 0.2).astype(np.float32)
    b = (rng.randn(128) * 3).astype(np.float32)
    ref = fl.nn.Dense(128, dtype=BF16).apply(
        {"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
    tm = tl.Dense(64, 128, dtype=torch.bfloat16)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(w.T))
        tm.bias.copy_(torch.from_numpy(b))
        got = tm(torch.from_numpy(x))
        fused = torch.nn.functional.linear(
            torch.from_numpy(x).bfloat16(), tm.weight.bfloat16(),
            tm.bias.bfloat16())
    assert got.dtype == torch.bfloat16 and _dtype_name(ref) == "bfloat16"
    r = _np(ref)
    assert (_np(got) != r).sum() <= 8
    assert (_np(fused) != r).mean() > 0.1


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("norm,is_head", [("bn", False), ("bn", True),
                                          ("ln", False), ("ln", True)])
def test_mlp_bf16(norm, is_head, train):
    """Output within 1 ulp of the value + 2 ulps of the largest (largest
    gap measured 0); running statistics as the module note says."""
    rng = np.random.RandomState(1)
    x = (rng.randn(300, 7) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(300) > 0.2
    fm = fl.MLP((32, 24, 5), norm=norm, is_head=is_head, dtype=BF16)
    tm = tl.MLP(7, (32, 24, 5), norm=norm, is_head=is_head,
                dtype=torch.bfloat16)
    ref, got, stats, tm = _both(fm, tm, (jnp.asarray(x), jnp.asarray(mask)),
                                _torchify(x, mask), train)
    _close(got, ref, 2.0, "mlp")
    if train and norm == "bn":
        _stats_close(tm, stats, "mlp")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv_norm_act_bf16(k, stride, train):
    """NHWC bf16 maps: output within 1 ulp + 2 ulps of the largest
    (largest gap measured 0); running statistics as the module note
    says."""
    rng = np.random.RandomState(k + stride)
    x = (rng.randn(2, 10, 12, 6) * 2).astype(np.float32)
    fm = fl.ConvNormAct(8, k, stride=stride, dtype=BF16)
    tm = tl.ConvNormAct(6, 8, k, stride=stride, dtype=torch.bfloat16)
    v = _variables(fm, jnp.asarray(x))
    if train:
        ref, mut = _jit_apply(fm, v, (jnp.asarray(x), True),
                              mutable=["batch_stats"])
    else:
        ref = _jit_apply(fm, v, (jnp.asarray(x),))
    tm = load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 train=train).permute(0, 2, 3, 1)
    _close(got, ref, 2.0, "conv")
    if train:
        _stats_close(tm, jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"]), "conv")


# --------------------------------------------------------- segment ops


def _sorted_rows(n, v, c, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, v * 3, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    uniq = unique_segments(jnp.asarray(keys), jnp.asarray(valid), v)
    order = np.asarray(uniq.order)
    data = (rng.randn(n, c) * 4).astype(np.float32)[order]
    return data, np.asarray(uniq.seg_ids)[order]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 ulp at each value (the spacing of its binade)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("n,v,c", [(700, 300, 64), (1024, 64, 3),
                                   (256, 700, 24)])
def test_sorted_reduce_bf16_twin_matches_pallas_kernel(monkeypatch, mode, n,
                                                       v, c):
    """The twin on bf16 rows against JAX's Pallas kernel in interpret mode
    (cast to f32, reduce, cast back): bf16 out; max equal bit for bit, sum
    within one bf16 ulp of JAX's (the f32 sums differ in order only)."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    data, seg = _sorted_rows(n, v, c, seed=n + c)
    xb = jnp.asarray(data).astype(BF16)
    ref = jax_sorted(xb, jnp.asarray(seg), v, mode, 128, True)
    sr.reset_launch_counts()
    got = sr.sorted_segment_reduce(
        torch.from_numpy(data).bfloat16(), torch.from_numpy(seg), v, mode)
    assert sr.launches == 0 and sr.launch_counts == {}
    assert got.dtype == torch.bfloat16 and _dtype_name(ref) == "bfloat16"
    r = _np(ref)
    if mode == "max":
        np.testing.assert_array_equal(_np(got), r)
    else:
        assert (np.abs(_np(got) - r) <= _bf16_ulp(r)).all()
        assert (_np(got) != 0).any()


def test_sorted_reduce_bf16_backward_matches_jax_vjp(monkeypatch):
    """The gradient through the bf16 route against JAX's custom vjp on tied
    maxima (duplicated rows): bf16 gradients, equal bit for bit (the first
    argmax takes a tie's whole gradient; a sum hands each row its
    segment's)."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    data, seg = _sorted_rows(200, 80, 16, seed=5)
    data[1::3] = data[0::3][:len(data[1::3])]  # ties within segments
    data = data.astype(np.float32)
    rng = np.random.RandomState(6)
    g = rng.randn(80, 16).astype(np.float32)
    xb = jnp.asarray(data).astype(BF16)
    gb = jnp.asarray(g).astype(BF16)
    for mode in ("max", "sum"):
        _, vjp = jax.vjp(lambda x: jax_sorted(x, jnp.asarray(seg), 80, mode,
                                              128, True), xb)
        (ref,) = vjp(gb)
        xt = torch.from_numpy(data).bfloat16().requires_grad_()
        out = sr.sorted_segment_reduce(xt, torch.from_numpy(seg), 80, mode)
        out.backward(torch.from_numpy(g).bfloat16())
        assert xt.grad.dtype == torch.bfloat16
        assert _dtype_name(ref) == "bfloat16"
        np.testing.assert_array_equal(_np(xt.grad), _np(ref), err_msg=mode)
        assert (_np(xt.grad) != 0).sum() > 0


@pytest.mark.parametrize("mode", ["max", "sum", "mean"])
def test_segment_reduce_bf16(mode):
    """Scatter path on bf16 rows: bf16 out as in JAX. A max equals JAX's bit
    for bit. A sum or mean is taken in f32 and rounded once, so it lies
    within one bf16 ulp of the exact (float64) result; JAX's bf16
    segment_sum rounds at each add, so the port lies within one ulp plus
    JAX's own rounding bound (rows x 2^-8 x the segment's sum of |x|) of
    JAX's result."""
    rng = np.random.RandomState(7)
    n, v, c = 900, 120, 8
    data = (rng.randn(n, c) * 3).astype(np.float32)
    seg = rng.randint(0, v + 10, n).astype(np.int32)  # some dropped
    xb = jnp.asarray(data).astype(BF16)
    ref = jax_segment_reduce(xb, jnp.asarray(seg), v, mode)
    got = segment_reduce(torch.from_numpy(data).bfloat16(),
                         torch.from_numpy(seg), v, mode)
    assert got.dtype == torch.bfloat16 and _dtype_name(ref) == "bfloat16"
    g, r = _np(got), _np(ref)
    if mode == "max":
        np.testing.assert_array_equal(g, r)
        return
    x64 = _np(torch.from_numpy(data).bfloat16()).astype(np.float64)
    exact = np.zeros((v + 1, c))
    np.add.at(exact, np.minimum(seg, v), x64)
    rows = np.bincount(np.minimum(seg, v), minlength=v + 1)[:v, None]
    exact = exact[:v]
    if mode == "mean":
        exact = exact / np.maximum(rows, 1)
    assert (np.abs(g - exact) <= _bf16_ulp(exact)).all()
    # each of JAX's adds rounds by at most 2^-8 of its partial sum, which
    # is at most the segment's sum of |x|
    abs_sum = np.zeros((v + 1, c))
    np.add.at(abs_sum, np.minimum(seg, v), np.abs(x64))
    bound = rows * 2.0**-8 * abs_sum[:v]
    if mode == "mean":
        bound = bound / np.maximum(rows, 1)
    assert (np.abs(g - r) <= _bf16_ulp(exact) + bound).all()


def test_gather_segments_bf16():
    rng = np.random.RandomState(8)
    vox = jnp.asarray(rng.randn(50, 6).astype(np.float32)).astype(BF16)
    seg = rng.randint(0, 60, 300).astype(np.int32)
    ref = jax_gather(vox, jnp.asarray(seg))
    got = gather_segments(torch.from_numpy(_np(vox)).bfloat16(),
                          torch.from_numpy(seg))
    assert got.dtype == torch.bfloat16 and _dtype_name(ref) == "bfloat16"
    np.testing.assert_array_equal(_np(got), _np(ref))


# ------------------------------------------------------------------ VFE


def _points(seed=3, n=600):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-3.9, 3.9, (n, 2)),
                          rng.uniform(-1.9, 3.9, (n, 1)),
                          rng.rand(n, 1)], -1).astype(np.float32)
    valid = rng.rand(n) > 0.1
    extra = (rng.rand(n, 1) > 0.5).astype(np.float32)
    return pts, valid, extra


@pytest.mark.parametrize("sorted_path,train", [(False, False), (True, False),
                                               (True, True)])
def test_dynamic_vfe_bf16(monkeypatch, sorted_path, train):
    """``DynamicVFE`` at bf16 on the scatter and the sorted path (JAX: its
    Pallas kernel in interpret mode on bf16 rows): voxel features bf16
    within 1 ulp + 2 ulps of the largest (largest gap measured 0); the
    float32 cluster-centre mean and extra sum within 1e-6 (the decoration
    stays float32); running statistics as the module note says."""
    if sorted_path:
        monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    pts, valid, extra = _points()
    pcr = (-4.0, -4.0, -2.0, 4.0, 4.0, 4.0)
    vsz = (0.5, 0.5, 0.5)
    bidx = np.zeros(len(pts), np.int32)
    kw = dict(feat_channels=(16, 16), voxel_size=vsz, point_cloud_range=pcr,
              mode="max", use_sorted_reduce=sorted_path)
    jvm = jax_voxelize(jnp.asarray(pts), jnp.asarray(bidx),
                       jnp.asarray(valid), pcr, vsz, 300, 1,
                       need_ranks=sorted_path)
    fm = FlaxVFE(dtype=BF16, **kw)
    v = _variables(fm, jnp.asarray(pts), jvm, False, jnp.asarray(extra))
    (ref, ref_aux), mut = _exact_bf16(lambda vv: fm.apply(
        vv, jnp.asarray(pts), jvm, train, jnp.asarray(extra),
        mutable=["batch_stats"]), v)
    tvm = dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(bidx),
                           torch.from_numpy(valid), pcr, vsz, 300, 1,
                           need_ranks=sorted_path)
    tm = load_flax_variables(DynamicVFE(4, dtype=torch.bfloat16, **kw), v)
    with torch.no_grad():
        got, got_aux = tm(torch.from_numpy(pts), tvm, train,
                          extra_sum=torch.from_numpy(extra))
    assert tm.sorted_calls == int(sorted_path)
    _close(got, ref, 2.0, "vfe")
    for k in ("cluster_mean", "extra_sum"):
        assert _dtype_name(got_aux[k]) == _dtype_name(ref_aux[k]) == "float32"
        np.testing.assert_allclose(_np(got_aux[k]), _np(ref_aux[k]),
                                   atol=1e-6, err_msg=k)
    if train:
        _stats_close(tm, jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"]), "vfe")


# ------------------------------------------------------------ dense BEV


def _voxels(n, b, nz, h, w, seed, unique_zyx=False, unique_bxy=False):
    rng = np.random.RandomState(seed)
    if unique_bxy:
        flat = rng.choice(b * h * w, n, replace=False)
        bb, yy, xx = np.unravel_index(flat, (b, h, w))
        coords = np.stack([bb, rng.randint(0, nz, n), yy, xx], -1)
    elif unique_zyx:
        flat = rng.choice(b * nz * h * w, n, replace=False)
        coords = np.stack(np.unravel_index(flat, (b, nz, h, w)), -1)
    else:
        coords = np.stack([rng.randint(0, b, n), rng.randint(0, nz, n),
                           rng.randint(0, h, n), rng.randint(0, w, n)], -1)
    valid = rng.rand(n) > 0.15
    coords = np.where(valid[:, None], coords, -1).astype(np.int32)
    return coords, valid


def _bf16_input(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and back, so both packages read the same bf16
    input whichever of them does the cast."""
    return _np(torch.from_numpy(x).bfloat16())


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("z_groups,pre", [(1, 0), (2, 6)])
def test_bev_scatter_bf16(z_groups, pre, train):
    """bf16 canvas (the f32 z embedding cast to bf16) within 1 ulp + 2 ulps
    of the largest (largest gap measured 0)."""
    rng = np.random.RandomState(z_groups)
    n, c, nz, b, hw = 90, 8, 4, 2, (6, 5)
    feats = _bf16_input(rng.randn(n, c).astype(np.float32))
    coords, valid = _voxels(n, b, nz, *hw, seed=1)
    fm = fd.BEVScatter(nz=nz, z_groups=z_groups, pre_channels=pre,
                       dtype=BF16)
    tm = td.BEVScatter(c, nz, z_groups, pre, dtype=torch.bfloat16)
    args = (jnp.asarray(feats).astype(BF16), jnp.asarray(coords),
            jnp.asarray(valid), b, hw)
    targs = (torch.from_numpy(feats).bfloat16(), *_torchify(coords, valid),
             b, hw)
    ref, got, _, _ = _both(fm, tm, args, targs, train)
    _close(got, ref, 2.0, "scatter")


@pytest.mark.parametrize("train", [False, True])
def test_dense_bev_unet_bf16(train):
    """Output and decoder maps bf16 within 1 ulp + 2 ulps of the largest
    (largest gap measured 1.28, in train mode); running statistics as the
    module note says."""
    rng = np.random.RandomState(4)
    x = _bf16_input(rng.randn(2, 16, 16, 4).astype(np.float32))
    kw = dict(encoder_channels=((8, 8), (16, 16), (16, 16)),
              decoder_channels=(16, 8), out_channels=8)
    fm = fd.DenseBEVUNet(dtype=BF16, **kw)
    tm = td.DenseBEVUNet(4, dtype=torch.bfloat16, **kw)
    (ref_out, ref_maps), (out, maps), stats, tm = _both(
        fm, tm, (jnp.asarray(x).astype(BF16),),
        (torch.from_numpy(x).bfloat16(),), train)
    _close(out, ref_out, 2.0, "unet out")
    for got, ref in zip(maps, ref_maps):
        _close(got, ref, 2.0, "unet map")
    if train:
        _stats_close(tm, stats, "unet")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("z_groups", [1, 2])
def test_dense_voxel_decode_bf16(z_groups, train):
    """Per-voxel features bf16 within 1 ulp + 2 ulps of the largest
    (largest gap measured 0)."""
    rng = np.random.RandomState(5)
    nz, gc = 4, 5
    c = z_groups * gc if z_groups > 1 else 6
    bev = _bf16_input(rng.randn(2, 6, 5, c).astype(np.float32))
    coords, valid = _voxels(70, 2, nz, 6, 5, seed=2)
    fm = fd.DenseVoxelDecode(nz=nz, out_channels=8, z_groups=z_groups,
                             group_channels=gc, dtype=BF16)
    tm = td.DenseVoxelDecode(c, nz, 8, z_groups, gc, dtype=torch.bfloat16)
    ref, got, _, _ = _both(
        fm, tm, (jnp.asarray(bev).astype(BF16), jnp.asarray(coords),
                 jnp.asarray(valid)),
        (torch.from_numpy(bev).bfloat16(), *_torchify(coords, valid)), train)
    _close(got, ref, 2.0, "decode")


@pytest.mark.parametrize("train", [False, True])
def test_dense_bev_mixer_bf16(train):
    """Mixed voxel features bf16 within 1 ulp + 2 ulps of the largest
    (largest gap measured 0); running statistics as the module note
    says."""
    rng = np.random.RandomState(6)
    n, c, nz, b, hw = 120, 8, 4, 2, (8, 8)
    feats = _bf16_input(rng.randn(n, c).astype(np.float32))
    coords, valid = _voxels(n, b, nz, *hw, seed=3, unique_zyx=True)
    kw = dict(z_channels=4, output_channels=8,
              encoder_channels=((8, 8), (8, 8)), decoder_channels=(8,))
    fm = fd.DenseBEVMixer(nz=nz, dtype=BF16, **kw)
    tm = td.DenseBEVMixer(c, nz, dtype=torch.bfloat16, **kw)
    ref, got, stats, tm = _both(
        fm, tm, (jnp.asarray(feats).astype(BF16), jnp.asarray(coords),
                 jnp.asarray(valid), b, hw),
        (torch.from_numpy(feats).bfloat16(), *_torchify(coords, valid), b,
         hw), train)
    _close(got, ref, 2.0, "mixer")
    if train:
        _stats_close(tm, stats, "mixer")


# ----------------------------------------------------- segmentor and head


@pytest.mark.parametrize("train", [False, True])
def test_vote_seg_head_bf16(train):
    """Seg logits and votes bf16 within 1 ulp + 2 ulps of the largest
    (largest gap measured 0) from float32 features (the segmentor's
    concat with the float32 local xyz); the losses float32, as in JAX, at
    rtol 2^-7."""
    rng = np.random.RandomState(9)
    n = 400
    feats = (rng.randn(n, 19) * 1.5).astype(np.float32)
    valid = rng.rand(n) > 0.1
    fm = fvs.VoteSegHead(num_classes=3, hidden_dims=(16, 16), dtype=BF16)
    tm = tvs.VoteSegHead(19, 3, (16, 16), dtype=torch.bfloat16)
    (ref_l, ref_v), (got_l, got_v), _, tm = _both(
        fm, tm, (jnp.asarray(feats), jnp.asarray(valid)),
        _torchify(feats, valid), train)
    _close(got_l, ref_l, 2.0, "logits")
    _close(got_v, ref_v, 2.0, "votes")
    labels = rng.randint(0, 4, n).astype(np.int32)
    vt = (rng.randn(n, 3) * 0.5).astype(np.float32)
    vmask = rng.rand(n) > 0.5
    jl = _exact_bf16(fm.losses, ref_l, ref_v, jnp.asarray(labels),
                     jnp.asarray(vt), jnp.asarray(vmask), jnp.asarray(valid))
    tl_ = tm.losses(got_l, got_v, *_torchify(labels, vt, vmask, valid))
    for k in jl:
        assert _dtype_name(tl_[k]) == _dtype_name(jl[k]) == "float32", k
        np.testing.assert_allclose(float(tl_[k]), float(jl[k]), rtol=ULP,
                                   err_msg=k)


def _head_kw():
    return dict(num_classes=3, in_channel=16, shared_mlp_dims=(32,),
                common_attrs=(("center", 3, 1, 16), ("dim", 3, 1, 16),
                              ("rot", 2, 1, 16)),
                num_cls_layer=1, cls_hidden_dim=16)


def test_sparse_cluster_head_bf16():
    """``SparseClusterHeadV2`` at bf16: logits and regressions bf16 within
    1 ulp + 2 ulps of the largest (largest gap measured 0); the losses
    float32 (bf16 predictions against float32 targets and weights promote,
    as in JAX) at rtol 2^-6. Its ``get_bboxes`` is held in
    tests/test_torch_fsdv2_bf16.py on the tiny model's head outputs."""
    rng = np.random.RandomState(10)
    n = 64
    feats = _bf16_input((rng.randn(n, 16) * 1.5).astype(np.float32))
    valid = rng.rand(n) > 0.2
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    batch = rng.randint(0, 2, n).astype(np.int32)
    fm = fsch.SparseClusterHeadV2(dtype=BF16, **_head_kw())
    tm = tsch.SparseClusterHeadV2(dtype=torch.bfloat16, **_head_kw())
    ref, got, _, tm = _both(
        fm, tm, (jnp.asarray(feats).astype(BF16), jnp.asarray(valid)),
        (torch.from_numpy(feats).bfloat16(), torch.from_numpy(valid)), False)
    for k in ("cls_logits", "reg_preds"):
        for g, r in zip(got[k], ref[k]):
            _close(g, r, 2.0, k)
    gt = np.concatenate([rng.uniform(-3, 3, (2, 5, 3)),
                         rng.uniform(1, 3, (2, 5, 3)),
                         rng.uniform(-3, 3, (2, 5, 1))], -1).astype(
                             np.float32)
    gl = rng.randint(0, 3, (2, 5)).astype(np.int32)
    gv = rng.rand(2, 5) > 0.2
    jl = _exact_bf16(fm.loss, ref, jnp.asarray(xyz), jnp.asarray(batch),
                     jnp.asarray(valid), jnp.asarray(gt), jnp.asarray(gl),
                     jnp.asarray(gv))
    tl_ = tm.loss(got, *_torchify(xyz, batch, valid, gt, gl, gv))
    for k in jl:
        assert _dtype_name(tl_[k]) == _dtype_name(jl[k]) == "float32", k
        np.testing.assert_allclose(float(tl_[k]), float(jl[k]),
                                   rtol=2 * ULP, atol=1e-6, err_msg=k)


def test_promotion_where_bf16_meets_f32():
    """Where a bf16 array meets a float32 one, JAX promotes whatever the
    float32 one's rank; torch keeps bf16 against a 0-dim float32 tensor.
    The port's losses and decode give JAX's dtypes and values: the focal
    loss of bf16 logits over a 0-dim float32 ``avg_factor`` without
    weights, the L1 loss of bf16 predictions against float32 targets, and
    the base-point decode of bf16 predictions at float32 centres, all
    float32, at rtol 2^-7."""
    rng = np.random.RandomState(12)
    logits = _bf16_input(rng.randn(50, 3).astype(np.float32))
    labels = rng.randint(0, 4, 50).astype(np.int32)
    preds = _bf16_input(rng.randn(50, 8).astype(np.float32))
    target = rng.randn(50, 8).astype(np.float32)
    base = rng.randn(50, 3).astype(np.float32)
    avg = np.float32(17.0)
    cases = [
        (jlosses.sigmoid_focal_loss(jnp.asarray(logits).astype(BF16),
                                    jnp.asarray(labels),
                                    avg_factor=jnp.asarray(avg)),
         tlosses.sigmoid_focal_loss(torch.from_numpy(logits).bfloat16(),
                                    torch.from_numpy(labels),
                                    avg_factor=torch.tensor(avg))),
        (jlosses.l1_loss(jnp.asarray(preds).astype(BF16),
                         jnp.asarray(target), avg_factor=jnp.asarray(avg)),
         tlosses.l1_loss(torch.from_numpy(preds).bfloat16(),
                         torch.from_numpy(target),
                         avg_factor=torch.tensor(avg))),
        (jcoders.base_point_decode(jnp.asarray(base),
                                   jnp.asarray(preds).astype(BF16), 1.0),
         tcoders.base_point_decode(torch.from_numpy(base),
                                   torch.from_numpy(preds).bfloat16(), 1.0)),
    ]
    for ref, got in cases:
        assert _dtype_name(got) == _dtype_name(ref) == "float32"
        np.testing.assert_allclose(_np(got), _np(ref), rtol=ULP, atol=1e-6)
    # a Python number keeps bf16 in both
    ref = jlosses.l1_loss(jnp.asarray(preds).astype(BF16),
                          jnp.asarray(preds).astype(BF16), avg_factor=3.0)
    got = tlosses.l1_loss(torch.from_numpy(preds).bfloat16(),
                          torch.from_numpy(preds).bfloat16(), avg_factor=3.0)
    assert _dtype_name(got) == _dtype_name(ref) == "bfloat16"


# ------------------------------------------------- train-mode gradients


def _grads_both(fm, tm, args, targs, post=lambda y: y, seed=0):
    """Train-mode gradients of flax ``fm`` (``jax.grad`` under
    ``_exact_bf16``) and torch
    ``tm`` with the same seeded variables on the same inputs, of the loss
    ``sum(f32(out) * g)`` over every output with seeded float32 cotangents
    ``g``: the parameters' and the first array argument's. ``post`` maps
    the port's outputs to flax's layout. Returns (flax param grads, flax
    input grad, port input grad, tm)."""
    v = _variables(fm, *args)
    arrays = [i for i, a in enumerate(args) if hasattr(a, "shape")]

    def fwd(params, *xs):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        y, _ = fm.apply({**v, "params": params}, *full, train=True,
                        mutable=["batch_stats"])
        return jax.tree_util.tree_leaves(y)

    xs = [args[i] for i in arrays]
    rng = np.random.RandomState(seed)
    gs = [rng.randn(*o.shape).astype(np.float32)
          for o in jax.eval_shape(fwd, v["params"], *xs)]

    def loss(params, *xs):
        return sum(jnp.sum(y.astype(jnp.float32) * g)
                   for y, g in zip(fwd(params, *xs), gs))

    gp, gx = _exact_bf16(jax.grad(loss, argnums=(0, 1)), v["params"], *xs)
    tm = load_flax_variables(tm, v)
    targs = list(targs)
    targs[arrays[0]] = targs[arrays[0]].clone().requires_grad_()
    ys = post(tm(*targs, train=True))
    ys = ys if isinstance(ys, tuple) else (ys,)
    sum((y.float() * torch.from_numpy(g)).sum()
        for y, g in zip(ys, gs)).backward()
    return gp, gx, targs[arrays[0]].grad, tm


def _grads_close(gp, gx, tx, tm, k: float, x_post=lambda g: g) -> None:
    """Every parameter gradient leaf and the input gradient within
    ``2^-7 |ref| + k 2^-7 max|ref|`` of flax's, each in JAX's dtype (float32
    for the parameters, the input's for the input). The gradients of a
    Dense or Conv kernel or bias come through the bf16 product's backward
    and a cast, so in both packages they are bf16 values held in float32:
    a float32 backward would not give them."""
    _close(x_post(tx), gx, k, "input")
    n_cast = 0
    for path, ref in _leaves(gp):
        got = np.array(_torch_leaf(tm, path, grad=True))
        _close(torch.from_numpy(got), ref, k, "/".join(path))
        if isinstance(tm.get_submodule(".".join(path[:-1])),
                      (tl.Dense, tl.Conv)):
            for arr in (got, np.array(ref)):
                np.testing.assert_array_equal(
                    _np(torch.from_numpy(arr).bfloat16()), arr,
                    err_msg="/".join(path))
            n_cast += 1
        assert np.abs(got).max() > 0, "/".join(path)
    assert n_cast > 0


@pytest.mark.parametrize("norm,is_head", [("bn", False), ("bn", True),
                                          ("ln", False), ("ln", True)])
def test_mlp_bf16_gradients(norm, is_head):
    """Train-mode gradients of a bf16 ``MLP`` (masked BN or LayerNorm in
    float32 between bf16 products) against ``jax.grad`` of flax's: every
    leaf within 1 ulp + 2 ulps of its largest (largest gap measured
    1.16)."""
    rng = np.random.RandomState(21)
    x = (rng.randn(300, 7) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(300) > 0.2
    fm = fl.MLP((32, 24, 5), norm=norm, is_head=is_head, dtype=BF16)
    tm = tl.MLP(7, (32, 24, 5), norm=norm, is_head=is_head,
                dtype=torch.bfloat16)
    _grads_close(*_grads_both(fm, tm, (jnp.asarray(x), jnp.asarray(mask)),
                              _torchify(x, mask)), 2.0)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv_norm_act_bf16_gradients(k, stride):
    """Train-mode gradients of a bf16 ``ConvNormAct`` (BN over N, H, W in
    float32) against ``jax.grad`` of flax's: every leaf and the NHWC input
    within 1 ulp + 2 ulps of its largest (largest gap measured 0.40)."""
    rng = np.random.RandomState(20 + k + stride)
    x = (rng.randn(2, 10, 12, 6) * 2).astype(np.float32)
    fm = fl.ConvNormAct(8, k, stride=stride, dtype=BF16)
    tm = tl.ConvNormAct(6, 8, k, stride=stride, dtype=torch.bfloat16)
    _grads_close(*_grads_both(
        fm, tm, (jnp.asarray(x),),
        (torch.from_numpy(x).permute(0, 3, 1, 2),),
        post=lambda y: y.permute(0, 2, 3, 1)), 2.0,
        x_post=lambda g: g.permute(0, 2, 3, 1))


def test_bev_scatter_pre_mlp_bf16_gradients():
    """Train-mode gradients of a bf16 ``BEVScatter`` with its ``pre`` MLP
    (Dense, LayerNorm, ReLU) and z bands, on voxels in distinct xy cells so
    no two rows meet in a canvas maximum: the pre MLP's leaves, the z
    embedding and the bf16 features within 1 ulp + 2 ulps of each
    one's largest (largest gap measured 0.49)."""
    rng = np.random.RandomState(22)
    n, c, nz, b, hw = 50, 8, 4, 2, (6, 5)
    feats = _bf16_input(rng.randn(n, c).astype(np.float32))
    coords, valid = _voxels(n, b, nz, *hw, seed=4, unique_bxy=True)
    fm = fd.BEVScatter(nz=nz, z_groups=2, pre_channels=6, dtype=BF16)
    tm = td.BEVScatter(c, nz, 2, 6, dtype=torch.bfloat16)
    _grads_close(*_grads_both(
        fm, tm, (jnp.asarray(feats).astype(BF16), jnp.asarray(coords),
                 jnp.asarray(valid), b, hw),
        (torch.from_numpy(feats).bfloat16(), *_torchify(coords, valid), b,
         hw)), 2.0)


@pytest.mark.parametrize("z_groups", [1, 2])
def test_dense_voxel_decode_bf16_gradients(z_groups):
    """Train-mode gradients of a bf16 ``DenseVoxelDecode`` (cell gather, z
    embedding, Dense + LayerNorm): its leaves and the bf16 BEV map's
    gradient (repeated cells summed) within 1 ulp + 2 ulps of each one's
    largest (largest gap measured 0.43)."""
    rng = np.random.RandomState(23)
    nz, gc = 4, 5
    c = z_groups * gc if z_groups > 1 else 6
    bev = _bf16_input(rng.randn(2, 6, 5, c).astype(np.float32))
    coords, valid = _voxels(70, 2, nz, 6, 5, seed=5)
    fm = fd.DenseVoxelDecode(nz=nz, out_channels=8, z_groups=z_groups,
                             group_channels=gc, dtype=BF16)
    tm = td.DenseVoxelDecode(c, nz, 8, z_groups, gc, dtype=torch.bfloat16)
    _grads_close(*_grads_both(
        fm, tm, (jnp.asarray(bev).astype(BF16), jnp.asarray(coords),
                 jnp.asarray(valid)),
        (torch.from_numpy(bev).bfloat16(), *_torchify(coords, valid))), 2.0)


def test_vote_seg_head_bf16_gradients():
    """Train-mode gradients of a bf16 ``VoteSegHead`` (masked-BN MLP, then
    the biased ``conv_seg`` and ``voting`` products) through both outputs:
    every leaf and the float32 features within 1 ulp + 2 ulps of each
    one's largest (largest gap measured 0.94)."""
    rng = np.random.RandomState(24)
    n = 400
    feats = (rng.randn(n, 19) * 1.5).astype(np.float32)
    valid = rng.rand(n) > 0.1
    fm = fvs.VoteSegHead(num_classes=3, hidden_dims=(16, 16), dtype=BF16)
    tm = tvs.VoteSegHead(19, 3, (16, 16), dtype=torch.bfloat16)
    _grads_close(*_grads_both(fm, tm, (jnp.asarray(feats),
                                       jnp.asarray(valid)),
                              _torchify(feats, valid)), 2.0)
