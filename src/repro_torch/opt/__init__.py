"""repro_torch.opt: the composable federated optimizer (port of repro.opt).

    from repro_torch import opt
    o = opt.make("chb", alpha=0.05, num_workers=9, backend="cuda")
    hist = simulator.run(o, task, 1000)
"""
from .api import OptState, ShardStepStats, StepStats, static_pos
from .censor import (AdaptiveCensor, Eq8Censor, NeverCensor,
                     StochasticCensor)
from .optimizer import BACKENDS, ComposedOptimizer
from .registry import (BACKEND_ALIASES, CENSOR_KINDS, SERVER_KINDS,
                       TRANSPORT_KINDS, from_spec, make, make_for_point,
                       make_transport, names, register, to_spec,
                       transport_names)
from .server import GradientDescent, HeavyBall
from .transport import (DenseTransport, Int8Transport, LowRankTransport,
                        TopKTransport, tree_topk_keep)

__all__ = [
    "OptState", "StepStats", "ShardStepStats", "static_pos",
    "NeverCensor", "Eq8Censor", "AdaptiveCensor", "StochasticCensor",
    "DenseTransport", "Int8Transport", "TopKTransport", "LowRankTransport",
    "tree_topk_keep",
    "GradientDescent", "HeavyBall",
    "ComposedOptimizer", "BACKENDS", "BACKEND_ALIASES",
    "register", "make", "make_for_point", "names", "to_spec", "from_spec",
    "make_transport", "transport_names",
    "CENSOR_KINDS", "TRANSPORT_KINDS", "SERVER_KINDS",
]
