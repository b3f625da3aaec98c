"""repro_torch.fed: the event-driven federated edge runtime (port of
``repro.fed``).

    population = fed.straggler_population(9, straggler_frac=0.2)
    edge = fed.EdgeConfig(population=population,
                          channel=fed.ChannelConfig.lossy(0.1),
                          quorum=0.8)
    hist = fed.run_edge(opt.make("chb", alpha, 9), task, edge,
                        num_rounds=500)

``fed.sync_config(M)`` is the correctness anchor: it reproduces
``core.simulator.run`` bit for bit (``tests/test_torch_fed.py``). The
mesh runtime (``run_mesh``, ``MeshScenario``) is not ported yet
(ROADMAP.md A10).
"""
from .channel import ChannelConfig, Transmission
from .clients import (ClientProfile, Population, VectorPopulation,
                      duty_cycle_population, intermittent_population,
                      straggler_population, uniform_population,
                      uniform_vector_population)
from .energy import EdgeStats, EnergyModel
from .runner import (EdgeConfig, EdgeHistory, edge_metrics_to_accuracy,
                     quorum_need, run_edge, sync_config)

__all__ = [
    "ChannelConfig", "Transmission", "ClientProfile", "Population",
    "VectorPopulation", "duty_cycle_population", "intermittent_population",
    "straggler_population", "uniform_population",
    "uniform_vector_population", "EdgeStats", "EnergyModel", "EdgeConfig",
    "EdgeHistory", "edge_metrics_to_accuracy", "quorum_need", "run_edge",
    "sync_config",
]
