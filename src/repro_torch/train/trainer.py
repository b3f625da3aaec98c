"""CHB training loop at LLM scale (port of ``repro/train/trainer.py``).

Composes the model (``models.model.train_loss``), the CHB optimizer family
(``opt``, realized by the scan strategy of ``core.distributed``), the
token pipeline (``data.lm_data``) and checkpointing. Algorithm selectable
per paper Sec. IV: gd | hb | lag | chb (+ optional int8 deltas).

``train(..., backend="cuda")`` runs each step's attention through B14
(with its log-sum-exp) and the flash backward kernel, and the optimizer
through B1 and B2 (dense) or B5 and B6 (int8); ``backend="reference"``
runs their plain versions. The pod strategy and a mesh raise
``NotImplementedError`` (ROADMAP.md A13). The JAX module's deprecated
``make_fed_config`` returns the legacy ``core.chb.FedOptConfig``, a facade
this package does not port (ROADMAP.md A14): it is left out.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from .. import opt
from ..checkpoint import checkpoint as ckpt
from ..configs.base import ModelConfig
from ..core import distributed
from ..data import lm_data
from ..device import resolve_device
from ..launch.serve import full_f32
from ..models import model
from ..random import PRNGKey

MESH_TODO = ("training on a mesh (sharded parameters, the pod strategy) is "
             "not ported yet (ROADMAP.md A13)")


@dataclasses.dataclass
class TrainConfig:
    algorithm: str = "chb"           # gd | hb | lag | chb
    strategy: str = "scan"           # scan | pod
    num_workers: int = 4
    alpha: float = 3e-2
    beta: float = 0.4
    eps1_scale: float = 0.1
    quantize: Optional[str] = None
    global_batch: int = 16
    seq_len: int = 256
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_path: str = "checkpoints/run"
    seed: int = 0
    remat: str = "none"
    moe_mode: str = "scan"
    # the JAX package donates (params, state) into its jitted step. Accepted
    # and a no-op here, as in fed.run_mesh: a step builds new tensors and
    # the loop drops the old ones itself
    donate: bool = True


def make_optimizer(tc: TrainConfig, mesh=None) -> opt.ComposedOptimizer:
    """Resolve ``tc.algorithm`` through the ``repro_torch.opt`` registry.

    Any registered name is accepted, but the scan strategy only realizes
    eq.-(8)/uncensored policies with dense or int8 transport: anything else
    raises here rather than silently running uncensored. A mesh (the JAX
    package's pod count) raises."""
    if mesh is not None:
        raise NotImplementedError(f"make_optimizer: {MESH_TODO}")
    kw = {"quantize": tc.quantize}
    if tc.algorithm == "hb":
        kw["beta"] = tc.beta
    if tc.algorithm in ("lag", "chb"):
        kw["eps1_scale"] = tc.eps1_scale
    o = opt.make(tc.algorithm, tc.alpha, tc.num_workers, **kw)
    if not isinstance(o.censor, (opt.NeverCensor, opt.Eq8Censor)):
        raise NotImplementedError(
            f"algorithm {tc.algorithm!r} uses censor policy "
            f"{type(o.censor).__name__}, which the scan/pod training "
            "strategies do not realize (eq.-8 / uncensored only)")
    return o


def train(cfg: ModelConfig, tc: TrainConfig, mesh=None, verbose=True, *,
          device=None, backend: str = "cuda"):
    """Returns (params, state, history list of metric dicts).

    The weights are ``init_params(PRNGKey(tc.seed), cfg)``, the JAX
    package's; each history record has the JAX package's keys (the
    step's metrics, ``step``, ``comms``, ``comm_savings``, ``wall_s``).
    ``device=None`` means CUDA (and raises without it); ``backend`` picks
    the kernels or their plain versions."""
    if mesh is not None or tc.strategy == "pod":
        raise NotImplementedError(f"train: {MESH_TODO}")
    dev = resolve_device(device)
    full_f32()
    fcfg = make_optimizer(tc)
    m = fcfg.num_workers

    def loss_fn(params, batch):
        return model.train_loss(params, cfg, batch, moe_mode=tc.moe_mode,
                                remat=tc.remat, backend=backend)[0]

    params = model.init_params(PRNGKey(tc.seed, device=dev), cfg)
    state = distributed.init_scan_state(fcfg, params)
    step_fn = distributed.make_scan_step(fcfg, loss_fn, backend=backend)
    data = lm_data.batch_iterator(cfg, global_batch=tc.global_batch,
                                  seq_len=tc.seq_len, num_workers=m,
                                  seed=tc.seed, device=dev)
    history = []
    t0 = time.time()
    for step in range(tc.steps):
        batch = next(data)
        params, state, metrics = step_fn(params, state, batch)
        if step % tc.log_every == 0 or step == tc.steps - 1:
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step,
                       comms=int(state.comm.total_uplinks),
                       comm_savings=float(state.comm.savings_vs_dense()),
                       wall_s=round(time.time() - t0, 1))
            history.append(rec)
            if verbose:
                print(f"step {step:5d} loss={rec['loss']:.4f} "
                      f"tx={rec['transmitted']:.0f}/{m} "
                      f"comms={rec['comms']} "
                      f"saved={rec['comm_savings']*100:.1f}%")
        if tc.ckpt_every and step and step % tc.ckpt_every == 0:
            ckpt.save(f"{tc.ckpt_path}_step{step}",
                      {"params": params},
                      metadata={"step": step, "arch": cfg.name})
    return params, state, history
