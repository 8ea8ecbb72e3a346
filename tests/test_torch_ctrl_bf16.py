"""CTRL's ``TrackletDetector`` at the bfloat16 compute policy against the
JAX package, on the CPU: ``tiny_ctrl(dtype=torch.bfloat16)`` against JAX's
``tiny_ctrl().clone(dtype=jnp.bfloat16)`` with the same seeded float32
variables (``test_torch_ctrl.seeded_port_variables``) on
``tracklet_batch(RandomState(0))``: predict, and the train-mode losses,
running statistics and gradients of their sum. One jitted JAX predict and
one jitted ``value_and_grad``, traced in turn and compiled together with
XLA's excess precision off (``compile_exact`` of
tests/test_torch_fsdv2_sparse_bf16.py). JAX runs its neighbour-table path
(``gather_gemm``); the port's CPU tensors take the conv, input-gradient
and dW twins at bf16. The pool pairs points with the tracker boxes on the
float32 points, so no decision depends on a bf16 value.

Tolerances in bf16 terms (``|got - ref| <= 2^-7 |ref| + k 2^-7 max|ref|``,
tests/test_torch_bf16_modules.py ``_close``; largest gaps measured beside):
  - predict: valid and labels exactly, boxes and scores k = 2 (0.67);
  - losses rtol 2^-7 (measured 2.0e-3), the pool's overflow exactly;
  - running statistics rtol 2^-7 plus 2^-7 of each leaf's largest;
  - gradients as tests/test_torch_fsdv2_sparse_bf16.py holds them (the
    port as an estimate of the float32 gradient on the same batch, beside
    JAX's): every leaf float32, its distance from JAX's at most JAX's own
    distance from the float32 gradient plus 2^-5 of the leaf's norm
    (largest excess measured 0.0158, a LayerNorm scale of the RoI head);
    over all leaves a cosine with JAX's of at least 0.99 (measured 0.9962)
    and a distance from the float32 gradient 0.9 to 1.1 times JAX's
    (measured 1.032).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu import flagship as jflag
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from test_torch_bf16_modules import _close, _dtype_name
from test_torch_ctrl import seeded_port_variables
from test_torch_fsdv2_sparse_bf16 import compile_exact
from test_torch_fsdv2_train import _leaves, _torch_leaf
from torch_threads import torch_threads_per_worker  # noqa: F401

ULP = 2.0**-7


def _is_loss(k):
    return k.startswith("loss")


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def run(monkeypatch_module):
    monkeypatch_module.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)
    jm = jflag.tiny_ctrl().clone(dtype=jnp.bfloat16)
    jb = jflag.tracklet_batch(np.random.RandomState(0))
    v = seeded_port_variables(tflag.tiny_ctrl(device="cpu"))

    def predict(params, stats, b):
        return jm.apply({"params": params, "batch_stats": stats}, b,
                        method=jm.predict)

    def train(params, stats, b):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, b,
                                train=True, method=jm.loss,
                                mutable=["batch_stats"])
            return (sum(x for k, x in out.items() if _is_loss(k)),
                    (out, mut["batch_stats"]))

        (_, (out, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return dict(losses=out, stats=new_stats, grads=grads)

    args = (v["params"], v["batch_stats"], jb)
    pred, ref = compile_exact([(predict, args), (train, args)])
    ref["pred"] = pred

    tb = tflag.tracklet_batch(np.random.RandomState(0), device="cpu")
    scg.reset_launch_counts()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tm = load_flax_variables(tflag.tiny_ctrl(dtype=dtype, device="cpu"),
                                 v).eval()
        pred = tm.predict(tb)
        tm.train()
        losses = tm.loss(tb, train=True)
        sum(x for k, x in losses.items() if _is_loss(k)).backward()
        out[dtype] = (tm, pred, losses)
    assert scg.launches == 0  # CPU tensors take the twins
    tm, pred, losses = out[torch.bfloat16]
    return dict(ref=ref, tm=tm, t32=out[torch.float32][0], pred=pred,
                losses=losses)


def test_ctrl_bf16_predict_matches_jax(run):
    ref, got = run["ref"]["pred"], run["pred"]
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    assert ref["valid"].all()
    gaps = [_close(got[k], ref[k], 2.0, k) for k in ("boxes", "scores")]
    assert _dtype_name(got["scores"]) == "bfloat16"
    print(f"\nCTRL bf16 predict: largest gap {max(gaps):.3f}")


def test_ctrl_bf16_losses_and_statistics_match_jax(run):
    ref = run["ref"]["losses"]
    got = {k: float(x.detach()) for k, x in run["losses"].items()}
    assert sorted(got) == sorted(ref)
    assert got["roi_membership_overflow"] == float(
        ref["roi_membership_overflow"])
    gap = max(abs(got[k] - float(ref[k])) / max(abs(float(ref[k])), 1e-30)
              for k in ref)
    print(f"\nCTRL bf16 losses: largest relative gap {gap:.2e}")
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=ULP, atol=0,
                                   err_msg=k)
    assert all(float(ref[k]) > 0 for k in ref if _is_loss(k))
    n = 0
    for path, want in _leaves(run["ref"]["stats"]):
        np.testing.assert_allclose(_torch_leaf(run["tm"], path, grad=False),
                                   want, rtol=ULP,
                                   atol=ULP * np.abs(want).max(),
                                   err_msg="/".join(path))
        n += 1
    assert n > 0


def test_ctrl_bf16_gradients_match_jax(run):
    gaps, port, ref, f32 = {}, [], [], []
    for path, j in _leaves(run["ref"]["grads"]):
        got = _torch_leaf(run["tm"], path, grad=True)
        truth = _torch_leaf(run["t32"], path, grad=True)
        assert got.dtype == j.dtype == np.float32, path
        norm = max(float(np.linalg.norm(j)), 1e-30)
        gaps["/".join(path)] = (np.linalg.norm(got - j)
                                - np.linalg.norm(j - truth)) / norm
        scale = max(float(np.abs(j).max()), 1e-30)
        port.append(got.ravel() / scale)
        ref.append(j.ravel() / scale)
        f32.append(truth.ravel() / scale)
    port, ref, f32 = (np.concatenate(x) for x in (port, ref, f32))
    cos = float(port @ ref / np.linalg.norm(port) / np.linalg.norm(ref))
    err = np.linalg.norm(port - f32) / np.linalg.norm(ref - f32)
    worst = max(gaps, key=gaps.get)
    print(f"\nCTRL bf16 gradients: {len(gaps)} leaves, cosine {cos:.6f}, "
          f"distance from float32 {err:.4f} x JAX's, largest leaf excess "
          f"{gaps[worst]:.4f} of its norm ({worst})")
    assert len(gaps) == sum(1 for _ in run["tm"].parameters())
    assert cos >= 0.99 and 0.9 <= err <= 1.1
    assert gaps[worst] <= 2.0**-5, worst
