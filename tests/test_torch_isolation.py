"""The PyTorch port stands alone and runs on CUDA unless told otherwise.

* No module of ``src/repro_torch/`` or ``benchmarks_torch/``, and not
  ``chip_smoke.py``, imports ``jax``, ``jaxlib`` or anything of the JAX
  package ``repro``.
* Entry points given ``device=None`` resolve to CUDA and raise without it;
  they never fall back to the CPU.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import fed, opt
from repro_torch import random as jrandom
from repro_torch.core import simulator
from repro_torch.data import edge_tasks, paper_tasks
from repro_torch.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 10
    return files + sorted((REPO / "benchmarks_torch").glob("*.py")) \
        + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_nothing_of_jax(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_tasks.make_linear_regression(m=2, n_per=3, d=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        edge_tasks.make_edge_quadratics(m=2, d=2)
    task = edge_tasks.make_edge_quadratics(m=2, d=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.run(opt.make("chb", 0.1, 2, backend="cuda"), task, 1)
    hist = simulator.run(opt.make("chb", 0.1, 2, backend="cuda"), task, 1,
                         device="cpu")
    assert hist.final_params.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def test_edge_runtime_entry_points_default_to_cuda(no_cuda):
    for build in (paper_tasks.make_logistic_regression,
                  paper_tasks.make_lasso, paper_tasks.make_neural_network):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(m=2, n_per=3, d=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_tasks.make_standin("housing", "lasso")
    with pytest.raises(RuntimeError, match="CUDA"):
        edge_tasks.make_edge_linreg(2, d=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        jrandom.PRNGKey(0)
    task = edge_tasks.make_edge_linreg(2, d=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.estimate_fstar(task, 0.1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_edge(opt.make("chb", 0.1, 2), task, fed.sync_config(2), 1)
    hist = fed.run_edge(opt.make("chb", 0.1, 2, backend="cuda"), task,
                        fed.sync_config(2), 1, device="cpu")
    assert hist.final_params.device.type == "cpu"
