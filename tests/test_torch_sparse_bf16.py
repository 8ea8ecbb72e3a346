"""The sparse conv's bfloat16 routes against the JAX package, on the CPU
(where the conv, input-gradient and dW wrappers take their plain twins).

- The conv twin at bf16 (subm, strided, inverse; 16 -> 24 channels and a
  6 -> 24 first conv) against JAX's Pallas ``_conv_kernel`` in interpret
  mode on window plans (``SST_TPU_PALLAS_INTERPRET=1``): both sum exact
  products of bf16 operands in f32, in other orders, and round once to
  bf16, so each value is equal or one bf16 ulp of JAX's away.
- The input gradient and dW at bf16 against ``jax.vjp`` of
  ``windowed_sparse_conv`` (JAX's ``_windowed_conv`` custom vjp) in
  interpret mode: dW rounded to bf16 once (``.astype(weights.dtype)``),
  the input gradient the bf16 conv route over the transposed plan; each
  value within one bf16 ulp of JAX's.

The file holds 7 test ids, so the tier-1 command's ``--dist loadfile``
runs it beside ``tests/test_train_step.py`` (ROADMAP.md, "Tier-1
headroom"); the modules at bf16 are tests/test_torch_sparse_modules_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sst_tpu.ops import sparse_conv_pallas as jscp
from sst_tpu_torch.ops import sparse_conv as tsc
from sst_tpu_torch.ops import sparse_conv_dw as scd
from sst_tpu_torch.ops import sparse_conv_gemm as scg
from test_torch_sparse_conv_grad import conv_cases  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

BF16 = jnp.bfloat16


def _bf16_np(x) -> np.ndarray:
    """f32 numpy values rounded to bf16 (as float32 numpy)."""
    return np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).bfloat16()


def _ulps(got: torch.Tensor, ref) -> float:
    """The largest distance of ``got`` (bf16) from JAX's bf16 ``ref`` in
    ulps of the reference's value (an ulp of x is 2^(floor(log2|x|) - 7);
    a zero reference counts the distance in ulps of the smallest normal)."""
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    g = got.float().numpy().astype(np.float64)
    r = np.asarray(ref).astype(np.float32).astype(np.float64)
    assert g.shape == r.shape
    mag = np.maximum(np.abs(r), 2.0**-126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(g - r) / ulp).max())


@pytest.fixture(autouse=True)
def _table_path(monkeypatch):
    monkeypatch.delenv("SST_TPU_PALLAS_INTERPRET", raising=False)


# ------------------------------------------------------------ the kernels


def _case(conv_cases, mode, cin):  # noqa: F811
    """The mode's case of test_torch_sparse_conv_grad.py at bf16; ``cin``
    6 keeps the first 6 channels (a first conv off the mma's k of 16)."""
    c = conv_cases[mode]
    return (_bf16_np(c["feats"][:, :cin]), _bf16_np(c["w"][:, :cin]),
            _bf16_np(c["g"]), c)


@pytest.mark.parametrize("mode,cin", [("subm", 16), ("subm", 6),
                                      ("strided", 16), ("inverse", 16)])
def test_bf16_twin_matches_jax_pallas_kernel(conv_cases, monkeypatch,  # noqa
                                             mode, cin):
    """Each value equal to JAX's bf16 kernel output or one ulp away."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    feats, w, _, c = _case(conv_cases, mode, cin)
    assert c["fast"].fwd is not None  # the Pallas path, not a table
    ref = jscp.windowed_sparse_conv(jnp.asarray(feats).astype(BF16),
                                    jnp.asarray(w).astype(BF16), c["fast"])
    scg.reset_launch_counts()
    got = tsc.windowed_sparse_conv(_t(feats), _t(w), c["tp"])
    assert scg.launches == 0  # CPU tensors take the twin
    assert got.dtype == torch.bfloat16
    assert _ulps(got, ref) <= 1.0
    assert np.abs(np.asarray(ref).astype(np.float32)).sum() > 0


@pytest.mark.parametrize("mode", ["subm", "strided", "inverse"])
def test_bf16_conv_grads_match_jax_custom_vjp(conv_cases, monkeypatch,  # noqa
                                              mode):
    """dW (bf16, rounded once) and the input gradient (the bf16 conv route
    over the transposed plan) against ``jax.vjp`` through JAX's custom vjp
    in interpret mode: each value within one bf16 ulp of JAX's."""
    monkeypatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    feats, w, g, c = _case(conv_cases, mode, 16)
    plan = c["fast"]
    assert plan.fwd is not None and plan.bwd is not None

    def vjp(f, ww, gg):
        return jax.vjp(lambda a, b: jscp.windowed_sparse_conv(a, b, plan),
                       f, ww)[1](gg)

    ref_f, ref_w = jax.jit(vjp)(*(jnp.asarray(x).astype(BF16)
                                  for x in (feats, w, g)))
    f = _t(feats).requires_grad_()
    ww = _t(w).requires_grad_()
    scg.reset_launch_counts()
    scd.reset_launch_counts()
    tsc.windowed_sparse_conv(f, ww, c["tp"]).backward(_t(g))
    assert scg.launches == 0 and scd.launches == 0
    assert f.grad.dtype == ww.grad.dtype == torch.bfloat16
    assert _ulps(ww.grad, ref_w) <= 1.0
    assert _ulps(f.grad, ref_f) <= 1.0
    assert float(ww.grad.float().abs().sum()) > 0
