"""The worker fold as a kernel of its own (``kernels.fused_step.fold_workers``).

``fold_workers`` is the port's kernel for the worker sum of a bank the
staged routes have already advanced; the JAX package sums the bank with
XLA (``repro.core.util.tree_sum_leading``, a ``jnp.sum``). Its plain
version is ``core.util.sum_leading``, the left fold in worker order, which
the card's kernel equals bit for bit (``tests/test_torch_cuda.py``). Here,
on the CPU:
  * ``ref.fold_workers`` is ``sum_leading`` bit for bit, -0.0 leaves, NaN
    and +-inf rows included, at M in {1, 2, 65, 70,000};
  * the wrapper on CPU tensors runs the plain version and counts no
    launch; its checks, launcher names and C bindings;
  * against the JAX package's ``tree_sum_leading`` at f64 within rtol
    1e-12 (XLA groups the sum otherwise);
  * the ``cuda`` backend routes exactly its worker sums through it (the
    staged routes, ``shard_step``, ``per_tensor``, the fed sweep), the
    ``reference`` backend and the fused routes never; both backends give
    the same bits.
"""
import contextlib
import re

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import util as j_util
from repro_torch import opt, sweep
from repro_torch.core import simulator
from repro_torch.core.util import sum_leading
from repro_torch.data import edge_tasks
from repro_torch.kernels import build, common, fused_step, ops, ref
from repro_torch.tree import tree_leaves

DTYPES = [torch.float32, torch.float64]


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _bank(m, n, dtype, seed):
    """An (M, n) bank: column 0 all -0.0, column 1 -0.0 but one +0.0 row,
    a NaN in column n-1 and +-inf in column n-2 (n >= 4)."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(m, n))).to(dtype)
    x[:, 0] = -0.0
    x[:, 1] = -0.0
    x[m // 2, 1] = 0.0
    if n >= 4:
        x[m - 1, n - 1] = float("nan")
        x[0, n - 2] = float("inf")
        x[m // 2, n - 3] = float("-inf")
    return x


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 2, 65, 70_000])
def test_plain_fold_is_sum_leading(m, dtype):
    x = _bank(m, 9, dtype, m)
    got = ref.fold_workers(x)
    want = sum_leading(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
    assert _bits(got[0]).item() == _bits(torch.tensor(-0.0, dtype=dtype))\
        .item()
    assert _bits(got[1]).item() == 0       # -0.0 + +0.0 is +0.0
    if m > 1:
        assert torch.isnan(got[8]) and got[7] == float("inf")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(1, 3), (4, 5, 6), (65, 2049)])
def test_wrapper_on_cpu_runs_the_plain_fold(shape, dtype):
    x = _bank(shape[0], int(np.prod(shape[1:])), dtype, 3).reshape(shape)
    common.reset_launches()
    got = fused_step.fold_workers(x)
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}
    assert got.shape == shape[1:] and got.dtype == dtype
    want = sum_leading(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


def test_wrapper_checks():
    with pytest.raises(ValueError, match="M >= 1"):
        fused_step.fold_workers(torch.zeros((0, 3)))
    with pytest.raises(ValueError, match="M >= 1"):
        fused_step.fold_workers(torch.tensor(1.0))
    with pytest.raises(TypeError, match="float32 and float64"):
        fused_step.fold_workers(torch.zeros((2, 3), dtype=torch.int32))
    assert fused_step.fold_workers(torch.zeros((3, 0))).shape == (0,)


def test_launchers_are_bound_and_exported():
    """Each design and dtype has a ctypes signature and a C launcher in
    ``fused_step.cu`` (the CPU cannot build it; the names must agree)."""
    src = (build.CSRC / "fused_step.cu").read_text()
    for path in fused_step.FOLD_PATHS:
        for dtype in common.KERNEL_DTYPES:
            name = fused_step._launcher("fold_workers", path, dtype)
            assert name in build.SIGNATURES["fused_step"], name
            assert re.search(rf"\bint {name}\(int device, const void\* x, "
                             r"void\* out, int64_t m, int64_t n,", src), name
            assert len(build.SIGNATURES["fused_step"][name]) == 6
    assert "fold_workers" in common.KERNELS


def test_tree_fold_workers_against_jax():
    gen = np.random.default_rng(0)
    tree = {"a": gen.normal(size=(70, 4, 3)), "b": gen.normal(size=(70,))}
    got = ops.tree_fold_workers({k: torch.from_numpy(v)
                                 for k, v in tree.items()})
    want = j_util.tree_sum_leading({k: jnp.asarray(v)
                                    for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-14)
        assert torch.equal(got[k], sum_leading(torch.from_numpy(tree[k])))


# ------------------------------------------------------------ call sites
M = 6
PATHS = {  # path: (opt.make keywords, staged route)
    "dense_staged": ({}, True),
    "int8_staged": ({"quantize": "int8"}, True),
    "topk": ({"transport": "topk", "k": 5}, False),
    "lowrank": ({"transport": "lowrank", "rank": 1}, False),
    "per_tensor": ({"granularity": "per_tensor"}, False),
    "dense": ({}, False),
    "int8": ({"quantize": "int8"}, False),
}


@pytest.fixture
def folds(monkeypatch):
    """Counts the calls of ``ops.tree_fold_workers``."""
    calls = []
    real = ops.tree_fold_workers

    def counted(tree):
        calls.append(len(tree_leaves(tree)))
        return real(tree)

    monkeypatch.setattr(ops, "tree_fold_workers", counted)
    return calls


def _tree_task():
    """The edge quadratics over two leaves (elementwise gradients)."""
    flat = edge_tasks.make_edge_quadratics(m=M, d=12 + 8, seed=1,
                                           device="cpu")
    a, c = flat.worker_data
    return simulator.FedTask(
        init_params={"u": torch.zeros((3, 4), dtype=torch.float64),
                     "v": torch.zeros((8,), dtype=torch.float64)},
        grad_fn=lambda th, d: {
            k: d[0].view((-1,) + (1,) * x.dim()) * (x - d[1][k])
            for k, x in th.items()},
        loss_fn=lambda th, d: sum(
            0.5 * d[0] * ((x - d[1][k]) ** 2).reshape(M, -1).sum(1)
            for k, x in th.items()),
        worker_data=(a, {"u": c[:, :12].reshape(M, 3, 4),
                         "v": c[:, 12:]}))


@pytest.mark.parametrize("path", PATHS)
def test_cuda_backend_folds_through_the_kernel(folds, path):
    kw, staged = PATHS[path]
    task = _tree_task()
    runs = {}
    for backend in ("cuda", "reference"):
        folds.clear()
        o = opt.make("chb", 0.05, M, eps1=1.0, backend=backend, **kw)
        with (fused_step.force_staged() if staged
              else contextlib.nullcontext()):
            runs[backend] = simulator.run(o, task, 4, device="cpu")
        # one fold of the two-leaf bank a step on cuda's unfused routes
        fused = path in ("dense", "int8")
        want = [] if backend == "reference" or fused else [2] * 4
        assert folds == want, (backend, folds)
    a, b = runs["cuda"], runs["reference"]
    assert torch.equal(a.mask, b.mask)
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params)):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_shard_step_and_fed_sweep_fold_on_cuda_only(folds, backend):
    task = _tree_task()
    o = opt.make("chb", 0.05, M, eps1=1.0, backend=backend)
    state = o.init(task.init_params)
    o.shard_step(state, task.init_params,
                 task.grad_fn(task.init_params, task.worker_data))
    sweep.run_fed_sweep(o, task, sweep.FedScenarioGrid(loss_prob=(0.0, 0.2)),
                        3, device="cpu")
    assert folds == ([2] * (1 + 2 * 3) if backend == "cuda" else [])
