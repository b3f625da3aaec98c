"""repro_torch.sweep: grids of Algorithm-1 runs (port of ``repro.sweep``).

``run_sweep`` runs a whole :class:`ConfigGrid`, partitioned by its static
axes, each point bit for bit as ``core.simulator.run`` runs its optimizer;
``run_fed_sweep`` runs ``repro_torch.fed`` deployment scenarios (loss
rate, participation, quorum) in synchronous rounds, with the JAX
package's draws.

    from repro_torch import sweep
    grid = sweep.ConfigGrid(alpha=(a,), beta=(0.4,),
                            eps1_scale=(0.01, 0.1, 1.0), seed=(0, 1))
    res = sweep.run_sweep(grid, task_factory=make_task, num_iters=3000)
    res.frontier(fstar, tol=1e-7)      # communication/accuracy frontier
    res.to_json("sweep.json")
"""
from .engine import SweepResult, run_sweep
from .fed_sweep import (FedScenarioGrid, FedScenarioPoint, FedSweepResult,
                        run_fed_sweep)
from .grid import ConfigGrid, GridPoint

__all__ = [
    "SweepResult", "run_sweep", "FedScenarioGrid", "FedScenarioPoint",
    "FedSweepResult", "run_fed_sweep", "ConfigGrid", "GridPoint",
]
