"""The port's data-parallel train step (``utils/dist.py``, ``train/step.py``,
``models/layers.py MaskedBatchNorm``) over two gloo ranks on the CPU,
against JAX's DDP-exact ``make_shard_map_train_step`` over a two-device
CPU mesh (the conftest gives JAX eight host devices).

``tiny_sst`` with the same seeded variables in both packages takes one
step on ``tiny_batch(2)``: rank r (and JAX's device r) the frame r. JAX
runs its fused attention (interpret mode), so its gradient is the custom
vjp the port ports; its voxel shuffle is recorded by a ``jax.debug``
callback inside the step (each device draws the same permutation) and fed
to both ranks. Held: the metrics (means over ranks), ``grad_norm`` of the
averaged gradients, the averaged gradient itself (AdamW's first moment),
rank 0's running statistics (the masked batch norms' statistics summed
over ranks, the convs' batch norms per rank, as flax's) and every
parameter after the step, equal on both ranks.

Tolerances: losses rtol 1e-4, counters exactly; ``grad_norm`` rtol 1e-2;
the averaged gradient within 5e-2 of each leaf's largest magnitude plus
rtol 1e-2. The gradients carry the bf16 attention's rounding noise
(``test_torch_sst_train.py``): on these variables the largest gap measured
is 4.1e-2, on the first VFE layer's kernel, where JAX's own step with the
float32 einsum attention in place of its bf16 kernel lies 6.2e-2 from its
bf16 step (9.4e-2 on the worst leaf). The masked batch norms' statistics
must pass their gradient back through the sum over ranks: a step whose
all-reduce passes the cotangent through unsummed misses the VFE leaves by
0.5 to 2.1 of their scale. Running statistics rtol/atol 1e-4; parameters
within 1e-5 of each leaf's largest magnitude (the step moves a parameter
by about the learning rate, 1e-6 here), except where a gradient element
lies within its tolerance of zero (see the test).
"""

import os
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.convert import load_flax_variables
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.train.state import cosine_onecycle, make_optimizer
from sst_tpu_torch.train.step import train_step
from torch_threads import torch_threads_per_worker  # noqa: F401

BASE_LR, TOTAL_STEPS, WEIGHT_DECAY = 1e-5, 100, 0.05


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_batch(batch: dict, rank: int) -> PointBatch:
    return PointBatch(**{k: torch.from_numpy(v[rank:rank + 1])
                         for k, v in batch.items()})


def _wait_for(path: str, abort: str, seconds: float = 600.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if os.path.exists(abort) or time.monotonic() - t0 > seconds:
            raise RuntimeError(f"{path} never came")
        time.sleep(0.05)


def _rank(rank, world, port, variables, sst_batch, fsd_batch, out_dir):
    """One rank: a ``pretrain=True`` step of ``tiny_fsd`` (seeded weights,
    its frame of the batch), then, once the parent has written JAX's voxel
    permutation, the port's step on ``tiny_sst`` (its frame); writes what
    each left."""
    import torch.distributed as dist

    from sst_tpu_torch.models.detectors import dynamic_voxelnet as tdvn

    torch.set_num_threads(1)  # two ranks share the cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        model = tflag.init_weights(tflag.tiny_fsd(device="cpu"),
                                   torch.Generator().manual_seed(0)).train()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model.parameters(), base_lr=1e-3,
                             weight_decay=WEIGHT_DECAY, total_steps=10)
        metrics = train_step(model, opt, _rank_batch(fsd_batch, rank),
                             {"pretrain": True})
        fsd = {"before": before, "state": model.state_dict(),
               "lr": opt.schedule(0), "without_grad": opt.params_without_grad,
               "metrics": {k: float(v) for k, v in metrics.items()}}

        _wait_for(os.path.join(out_dir, "perm.npy"),
                  os.path.join(out_dir, "abort"))
        perm = torch.from_numpy(np.load(os.path.join(out_dir, "perm.npy")))
        tdvn.voxel_permutation = lambda n, gen: perm.long()
        model = load_flax_variables(tflag.tiny_sst(device="cpu"),
                                    variables).train()
        opt = make_optimizer(model.parameters(), base_lr=BASE_LR,
                             weight_decay=WEIGHT_DECAY,
                             total_steps=TOTAL_STEPS)
        metrics = train_step(model, opt, _rank_batch(sst_batch, rank),
                             {"generator": torch.Generator()})
        sst = {"state": model.state_dict(),
               "exp_avg": {n: opt.adamw.state[p]["exp_avg"]
                           for n, p in model.named_parameters()},
               "metrics": {k: float(v) for k, v in metrics.items()}}
        torch.save({"sst": sst, "fsd": fsd},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_shard_map_step(variables, jbatch):
    """JAX's shard_map step over devices 0-1; returns (new state, metrics,
    the voxel permutation the step drew)."""
    import jax
    from jax.sharding import Mesh

    from sst_tpu import flagship as jflag
    from sst_tpu.models.detectors import dynamic_voxelnet as jdvn
    from sst_tpu.train import create_train_state, make_optimizer as jopt
    from sst_tpu.train import shard_batch
    from sst_tpu.train.step import make_shard_map_train_step

    perms = []
    real = jdvn.sst_input_layer

    def recording(*args, shuffle_rng=None, **kw):
        if shuffle_rng is not None:
            jax.debug.callback(lambda p: perms.append(np.asarray(p)),
                               jax.random.permutation(shuffle_rng,
                                                      args[0].shape[0]))
        return real(*args, shuffle_rng=shuffle_rng, **kw)

    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("SST_TPU_PALLAS_INTERPRET", "1")
    mpatch.setattr(jdvn, "sst_input_layer", recording)
    try:
        jm = jflag.tiny_sst()
        jm = jm.clone(backbone={**jm.backbone, "use_pallas": True})
        state = create_train_state(jm, variables, jopt(
            base_lr=BASE_LR, weight_decay=WEIGHT_DECAY,
            total_steps=TOTAL_STEPS))
        mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
        with mesh:
            step = make_shard_map_train_step(jm, mesh)
            new_state, metrics = step(state, shard_batch(jbatch, mesh),
                                      jax.random.PRNGKey(3))
            new_state, metrics = jax.tree_util.tree_map(
                np.asarray, (new_state, metrics))
    finally:
        mpatch.undo()
    assert len(perms) == 2 and np.array_equal(perms[0], perms[1])
    return new_state, metrics, perms[0]


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _port_leaf(model, state: dict, path) -> np.ndarray:
    """The tensor of ``state`` (a state dict of ``model``) at flax leaf
    ``path``, in flax's layout."""
    *mods, leaf = path
    mod = model.get_submodule(".".join(mods))
    name = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(leaf, leaf)
    arr = state[".".join(mods + [name])].numpy()
    if leaf == "kernel" and isinstance(mod, torch.nn.Linear):
        return arr.T
    if leaf == "kernel" and isinstance(mod, torch.nn.Conv2d):
        return arr.transpose(2, 3, 1, 0)
    return arr


def _batch_arrays(batch) -> dict:
    return {k: np.array(getattr(batch, k)) for k in
            ("points", "valid", "gt_boxes", "gt_labels", "gt_valid")}


@pytest.fixture(scope="module")
def steps():
    """JAX's shard_map step and both ranks of the port (one spawn)."""
    from sst_tpu import flagship as jflag
    from test_torch_fsdv2_dense_train import _flax_variables

    # seeded weights with biases drawn too (a zero-initialised bias would
    # have a leaf scale of one learning rate after the step)
    gen = torch.Generator().manual_seed(5)
    model = tflag.init_weights(tflag.tiny_sst(device="cpu"), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
    variables = _flax_variables(model, seed=5)
    jbatch = jflag.tiny_batch(batch_size=2)
    fsd_batch = tflag.fsd_batch(np.random.RandomState(0), b=2, p=512)
    with tempfile.TemporaryDirectory() as d:
        # the ranks start (and take the FSD step) while JAX compiles
        ctx = mp.spawn(_rank, args=(2, _free_port(), variables,
                                    _batch_arrays(jbatch),
                                    _batch_arrays(fsd_batch), d),
                       nprocs=2, join=False)
        try:
            jstate, jmetrics, perm = _jax_shard_map_step(variables, jbatch)
            np.save(os.path.join(d, "perm.tmp.npy"), perm)
            os.replace(os.path.join(d, "perm.tmp.npy"),
                       os.path.join(d, "perm.npy"))
        except BaseException:
            open(os.path.join(d, "abort"), "w").close()
            raise
        finally:
            deadline = time.monotonic() + 600
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    for proc in ctx.processes:
                        proc.kill()
                    raise TimeoutError("the ranks did not finish")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=True) for r in range(2)]
    return dict(model=model, jstate=jstate, jmetrics=jmetrics, ranks=ranks)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_two_rank_sst_step_matches_jax_shard_map(steps):
    """The module docstring's holds. Adam moves a parameter by about the
    learning rate whatever its gradient's size, so where JAX's averaged
    gradient lies within the gradient tolerance of zero its sign is the
    attention's rounding noise, and that element is held within twice the
    first step's learning rate instead."""
    model, jstate = steps["model"], steps["jstate"]
    ranks = [r["sst"] for r in steps["ranks"]]
    got = ranks[0]["metrics"]
    assert sorted(got) == sorted(steps["jmetrics"])
    for k, ref in steps["jmetrics"].items():
        if k == "grad_norm":
            np.testing.assert_allclose(got[k], ref, rtol=1e-2)
        elif k.startswith("loss"):
            np.testing.assert_allclose(got[k], ref, rtol=1e-4, err_msg=k)
        else:
            assert got[k] == float(ref), k
    assert got == ranks[1]["metrics"]
    for k, v in ranks[0]["state"].items():  # every rank steps alike
        if "running" not in k:
            assert torch.equal(v, ranks[1]["state"][k]), k
    lr0 = cosine_onecycle(BASE_LR, TOTAL_STEPS)(0)
    n = flips = 0
    mu = jstate.opt_state[1][0].mu  # clip, then adamw's ScaleByAdamState
    for path, ref in _flax_leaves(jstate.params):
        name = "/".join(path)
        g_ref = np.asarray(_get(mu, path)) / 0.1  # mu = (1 - b1) g
        g_got = _port_leaf(model, ranks[0]["exp_avg"], path) / 0.1
        g_tol = 1e-2 * np.abs(g_ref) + 5e-2 * np.abs(g_ref).max()
        assert (np.abs(g_got - g_ref) <= g_tol).all(), "grad " + name
        got = _port_leaf(model, ranks[0]["state"], path)
        tol = 1e-5 * np.abs(ref).max() + np.where(
            np.abs(g_ref) <= g_tol, 2 * lr0, 0.0)
        assert (np.abs(got - ref) <= tol).all(), name
        flips += int((np.abs(got - ref) > 1e-5 * np.abs(ref).max()).sum())
        n += 1
    assert n == sum(1 for _ in model.parameters())
    assert flips <= 4  # sign flips of near-zero gradients are rare
    stats = list(_flax_leaves(jstate.batch_stats))
    assert any("MaskedBatchNorm" in "/".join(p) for p, _ in stats)
    for path, ref in stats:
        np.testing.assert_allclose(
            _port_leaf(model, ranks[0]["state"], path), ref, rtol=1e-4,
            atol=1e-4, err_msg="/".join(path))


def test_two_rank_fsd_pretrain_step_leaves_the_head_to_weight_decay(steps):
    """A ``pretrain=True`` step of ``tiny_fsd`` over two ranks (the FSD
    schedule's warm-up: the segmentor alone) runs without
    ``DistributedDataParallel``'s unused-parameter error; every parameter
    outside the segmentor moves by the weight decay alone, exactly as
    AdamW with a zero gradient moves it, and the segmentor's move."""
    r0, r1 = (r["fsd"] for r in steps["ranks"])
    assert r0["metrics"] == r1["metrics"]
    assert np.isfinite(list(r0["metrics"].values())).all()
    assert r0["without_grad"] > 0  # the head: no loss reached it
    decay = 1 - r0["lr"] * WEIGHT_DECAY
    moved = 0
    for k, after in r0["state"].items():
        if "running" in k:
            continue
        assert torch.equal(after, r1["state"][k]), k
        before = r0["before"][k]
        if k.startswith("segmentor_mod."):
            moved += not torch.equal(after, before)
        else:
            torch.testing.assert_close(after, before * decay, rtol=1e-7,
                                       atol=0, msg=k)
    assert moved > 0
