"""repro_torch.fed: the event-driven federated edge runtime (port of
``repro.fed``).

    population = fed.straggler_population(9, straggler_frac=0.2)
    edge = fed.EdgeConfig(population=population,
                          channel=fed.ChannelConfig.lossy(0.1),
                          quorum=0.8)
    hist = fed.run_edge(opt.make("chb", alpha, 9), task, edge,
                        num_rounds=500)

``fed.sync_config(M)`` is the correctness anchor: it reproduces
``core.simulator.run`` bit for bit (``tests/test_torch_fed.py``).

The mesh runtime runs the same knobs as synchronous rounds over 10^5-10^6
clients, the client axis in shards (``launch.mesh.make_client_mesh``):

    hist = fed.run_mesh(opt.make("chb", 0.5 / M, M, eps1=4.0), task, 80,
                        mesh=make_client_mesh(1),
                        scenario=fed.MeshScenario(0.5, 0.3, 0.5, seed=3))

Its ideal scenario over one shard equals ``core.simulator.run`` bit for
bit, and its masks do not depend on the shard count
(``tests/test_torch_mesh.py``).
"""
from .channel import ChannelConfig, Transmission
from .clients import (ClientProfile, Population, VectorPopulation,
                      duty_cycle_population, intermittent_population,
                      straggler_population, uniform_population,
                      uniform_vector_population)
from .energy import EdgeStats, EnergyModel
from .mesh import MeshHistory, MeshScenario, run_mesh
from .runner import (EdgeConfig, EdgeHistory, edge_metrics_to_accuracy,
                     quorum_need, run_edge, sync_config)

__all__ = [
    "ChannelConfig", "Transmission", "ClientProfile", "Population",
    "VectorPopulation", "duty_cycle_population", "intermittent_population",
    "straggler_population", "uniform_population",
    "uniform_vector_population", "EdgeStats", "EnergyModel", "EdgeConfig",
    "EdgeHistory", "edge_metrics_to_accuracy", "quorum_need", "run_edge",
    "sync_config", "MeshHistory", "MeshScenario", "run_mesh",
]
