"""Slice-level parity of the port's SST ``predict`` (DynamicVoxelNet +
SSTv2) with the JAX package on ``tiny_sst`` / ``tiny_batch``: the flax
variables (with random BN statistics) are converted into the torch model
and both packages see the same points. The JAX model runs its fused Pallas
attention (``use_pallas=True``, interpret mode on the CPU), so both sides
compute the same attention function.

Tolerances: the attention rounds q, k, v, its probabilities and its output
to bf16, and a value that lies near a bf16 rounding boundary can round the
other way after an f32 sum taken in another order, moving that element by
one bf16 ulp (2^-8 relative). Neck features and head maps are compared at
rtol/atol 1e-2; capacity counters exactly. Detections are matched as sets
(order among near ties is free): every JAX detection must have a port
detection of its label within 1e-3 in score and 1e-2 in box, except those
within twice the score tolerance of the lowest kept score, where a near tie
at the ``max_num`` cut may go either way.
"""

import jax
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch import apis
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models.sst import WindowAttention
from sst_tpu_torch.models.vfe import DynamicVFE
from sst_tpu_torch.ops import window_mha as wm
from torch_threads import torch_threads_per_worker  # noqa: F401

MAP_TOL = dict(rtol=1e-2, atol=1e-2)
SCORE_TOL, BOX_TOL = 1e-3, 1e-2


def _numpy_vars(variables, seed=0):
    """Flax variables as numpy dicts, with random running statistics."""
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    out = {k: dict(v) for k, v in out.items()}

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    perturb(out["batch_stats"])
    return out


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    mp.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    try:
        jm = jflag.tiny_sst()
        jm = jm.clone(backbone={**jm.backbone, "use_pallas": True})
        jb = jflag.tiny_batch()
        v = _numpy_vars(jax.jit(lambda b: jm.init(jax.random.PRNGKey(0),
                                                  b))(jb))

        def jfeat(v, b):
            diag = {}
            feats = jm.apply(v, b, False, diag, method=jm.extract_feat)
            return feats, diag

        jfeats, jdiag = jax.jit(jfeat)(v, jb)
        jpreds = jax.jit(lambda v, b: jm.apply(v, b))(v, jb)
        jdet = jax.jit(lambda v, b: jm.apply(v, b, method=jm.predict))(v,
                                                                       jb)
    finally:
        mp.undo()
    tm = load_flax_variables(tflag.tiny_sst(device="cpu"), v).eval()
    batch = tflag.tiny_batch().to("cpu")
    wm.reset_launch_counts()
    with torch.inference_mode():
        tdiag = {}
        tfeats = tm.extract_feat(batch, diag=tdiag)
        tpreds = tm(batch)
        tdet = tm.predict(batch)
    assert wm.launches == 0  # CPU tensors take the twin
    return dict(v=v, jfeats=jfeats, jdiag=jdiag, jpreds=jpreds, jdet=jdet,
                tfeats=tfeats, tdiag=tdiag, tpreds=tpreds, tdet=tdet)


def test_sstv2_and_neck_features_match_jax(both):
    # JAX keeps NHWC, the port NCHW
    got = both["tfeats"].permute(0, 2, 3, 1).numpy()
    ref = np.asarray(both["jfeats"])
    assert got.shape == ref.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(got, ref, **MAP_TOL)
    for k in ("num_voxels", "num_voxel_overflow_points",
              "num_window_seat_trimmed_voxels", "num_window_dropped_voxels"):
        assert float(both["tdiag"][k]) == float(both["jdiag"][k]), k
    assert float(both["tdiag"]["num_voxels"]) > 0


@pytest.mark.parametrize("key", ["cls", "reg", "dir"])
def test_head_maps_match_jax(both, key):
    got, ref = both["tpreds"][key].numpy(), np.asarray(both["jpreds"][key])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **MAP_TOL, err_msg=key)


def test_predict_parity_tiny_sst(both):
    jdet = {k: np.asarray(v) for k, v in both["jdet"].items()}
    tdet = {k: v.numpy() for k, v in both["tdet"].items()}
    for k in jdet:
        assert tdet[k].shape == jdet[k].shape, k
    np.testing.assert_array_equal(tdet["valid"].sum(1), jdet["valid"].sum(1))
    checked = 0
    for i in range(jdet["valid"].shape[0]):
        lowest = jdet["scores"][i][jdet["valid"][i]].min()
        for j in np.flatnonzero(jdet["valid"][i]):
            if jdet["scores"][i, j] - lowest <= 2 * SCORE_TOL:
                continue  # a near tie at the max_num cut may go either way
            t = tdet["valid"][i] & (tdet["labels"][i] == jdet["labels"][i, j])
            t &= np.abs(tdet["scores"][i] - jdet["scores"][i, j]) <= SCORE_TOL
            t &= np.abs(tdet["boxes"][i] - jdet["boxes"][i, j]).max(-1) \
                <= BOX_TOL
            assert t.any(), (i, j)
            checked += 1
    assert checked >= 40


@pytest.mark.parametrize("case", ["missing_leaf", "bad_shape"])
def test_converter_is_strict_on_the_sst_tree(both, case):
    v = both["v"]
    path = ("params", "backbone_mod", "block_1", "encoder_0",
            "WindowAttention_0", "qk_proj")
    bad = {k: dict(x) for k, x in v.items()}
    node = bad
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    node[path[-1]] = dict(node[path[-1]])
    if case == "missing_leaf":
        del node[path[-1]]["bias"]
        err = KeyError
    else:
        node[path[-1]]["kernel"] = node[path[-1]]["kernel"][:, :-1]
        err = ValueError
    with pytest.raises(err):
        load_flax_variables(tflag.tiny_sst(device="cpu"), bad)


@pytest.mark.parametrize("builder", [
    "sst_waymo", "tiny_sst", "fsdv2_waymo", "fsdv2_waymo_dense",
    "tiny_fsdv2_dense", "tiny_fsdv2_flagship",
])
def test_builders_default_to_the_card_and_raise_without_one(builder):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the builder would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tflag, builder)()


def test_sst_waymo_builder():
    m = tflag.sst_waymo(train_buckets=False, num_point_features=3,
                        device="cpu")
    assert m.bev_shape == (468, 468) and m.max_points == 196608
    assert [(b.max_tokens, b.max_windows) for b in m.buckets] == [
        (30, 896), (60, 768), (100, 320), (144, 160)]
    attn = [mod for mod in m.modules() if isinstance(mod, WindowAttention)]
    assert len(attn) == 12 and {(a.d_model, a.nhead) for a in attn} == {
        (128, 8)}
    conv = m.backbone_mod.attached_conv_2.Conv_0
    assert conv.dilation == (2, 2) and conv.padding == (2, 2)
    assert m.head_mod.conv_cls.out_channels == 18  # 6 anchors x 3 classes
    assert len(tflag.sst_waymo(device="cpu").buckets) == 3
    # random weights: LayerNorm scales 1, head conv biases 0
    tflag.init_weights(m, torch.Generator().manual_seed(0))
    ln = m.backbone_mod.block_0.encoder_0.LayerNorm_0
    assert torch.equal(ln.weight, torch.ones(128))
    assert torch.equal(m.head_mod.conv_cls.bias, torch.zeros(18))
    assert float(m.head_mod.conv_cls.weight.detach().std()) > 0


def test_prepare_batch_pads_to_the_model_cap():
    """The default cap is JAX's 65,536 whatever the model's ``max_points``
    (which callers pass to keep more); an explicit cap wins."""
    m = tflag.tiny_sst(device="cpu")
    pts = tflag.tiny_batch(1, 300).points[0]
    assert apis.prepare_batch(m, pts).points.shape == (
        1, apis.DEFAULT_MAX_POINTS, 3) == (1, 65536, 3)
    m.max_points = 1000
    b = apis.prepare_batch(m, pts)
    assert b.points.shape == (1, 65536, 3) and int(b.valid.sum()) == 300
    b = apis.prepare_batch(m, pts, m.max_points)
    assert b.points.shape == (1, 1000, 3) and int(b.valid.sum()) == 300
    assert apis.prepare_batch(m, pts, 400).points.shape == (1, 400, 3)


# cosine attention, the CenterHead (tests/test_torch_sst_heads.py),
# SECONDFPN's upsampling (tests/test_torch_pointpillars.py) and the VFE's
# point features (tests/test_torch_fsdv2_centroid.py) are ported since; a
# reduction mode that no segment_reduce has still raises
@pytest.mark.parametrize("make", [
    lambda: DynamicVFE(3, mode="median"),
])
def test_options_outside_the_slice_raise(make):
    with pytest.raises(NotImplementedError):
        make()


def test_return_point_feats_builds():
    vfe = DynamicVFE(3, return_point_feats=True, use_sorted_reduce=True)
    assert vfe.return_point_feats and vfe.out_channels == 128


@pytest.mark.parametrize("post_norm", [True, False])
def test_encoder_layer_matches_jax(post_norm, monkeypatch):
    """One encoder layer, post-norm and pre-norm, on a window plan of 110
    random pillars (JAX: the Pallas attention in interpret mode)."""
    import jax.numpy as jnp

    from sst_tpu.models import sst as jsst
    from sst_tpu.models import sst_input as jin
    from sst_tpu.ops import window as jwin
    from sst_tpu_torch.models import sst_input as tin
    from sst_tpu_torch.models.sst import EncoderLayer
    from sst_tpu_torch.ops import window as twin

    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(1)
    n = 120
    cells = rng.choice(16 * 16, n, replace=False)
    coords = np.stack([np.zeros(n), np.zeros(n), cells // 16, cells % 16],
                      -1).astype(np.int32)
    valid = np.arange(n) < 110
    coords[~valid] = -1
    buckets = ((8, 0, 8, 16), (16, 8, 100000, 8))
    args = ((16, 16, 1), (4, 4))
    jplan = jin.sst_input_layer(
        jnp.asarray(coords), jnp.asarray(valid), *args,
        tuple(jwin.BucketSpec(*b) for b in buckets), 32, 64)
    tplan = tin.sst_input_layer(
        torch.from_numpy(coords), torch.from_numpy(valid), *args,
        tuple(twin.BucketSpec(*b) for b in buckets), 32, 64)
    feat = rng.randn(n, 32).astype(np.float32)
    jl = jsst.EncoderLayer(32, 2, 64, post_norm=post_norm, use_pallas=True)
    # jitted: op by op, the init and the apply took ~10 s
    v = jax.jit(lambda x: jl.init(jax.random.PRNGKey(0), x, jplan.pos[0],
                                  jplan.f2w[0]))(jnp.asarray(feat))
    ref = np.asarray(jax.jit(lambda v, x: jl.apply(
        v, x, jplan.pos[0], jplan.f2w[0]))(v, jnp.asarray(feat)))
    tl = load_flax_variables(EncoderLayer(32, 2, 64, post_norm=post_norm),
                             _numpy_vars(dict(v, batch_stats={})))
    with torch.inference_mode():
        got = tl(torch.from_numpy(feat), tplan.pos[0], tplan.f2w[0])
    np.testing.assert_allclose(got.numpy(), ref, **MAP_TOL)


def test_sstv1_defaults_two_dilated_convs():
    from sst_tpu_torch.models.sst import SSTv1

    m = SSTv1(d_model=(32,), nhead=(2,), num_blocks=1, dim_feedforward=(64,),
              conv_out_channel=32)
    convs = [m.attached_conv_0.Conv_0, m.attached_conv_1.Conv_0]
    assert m.num_attached_conv == 2
    assert all(c.dilation == (2, 2) and c.padding == (2, 2) for c in convs)
