"""``ComposedOptimizer``: Algorithm 1 from one censor, one transport and
one server update (port of ``repro.opt.optimizer``).

Two backends:

  * ``"reference"`` -- plain PyTorch stage calls (``_step``, a port of the
    JAX reference step);
  * ``"cuda"`` -- the kernel step (``_step_kernels``, a port of the JAX
    package's ``_step_pallas``). Dense and int8 take the fused route: per
    parameter leaf one reduction (B1 for dense, B5 for int8) feeds the
    censor decision, then one fused pass (B2 / B6) advances the bank, sums
    the workers and applies eq. (4). Top-k, low-rank and any other
    stateful transport with ``encode_feedback_cuda`` take the staged
    route: the pending tree in plain torch, its norms (B8), the
    transport's encode + EF tail (B10 / B11), the bank advance (B9), the
    worker sum and ``apply_server`` (B3). On CPU tensors the kernel
    wrappers run their plain versions, so this backend also runs, and is
    tested, on the CPU.

Not ported yet: ``per_tensor`` granularity (ROADMAP A6), ``shard_step``
(A10) and the staged dense/int8 route (``fused_step.force_staged``, which
needs B4 and B7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..core.accounting import CommStats
from ..core.censoring import delta_sqnorms, step_sqnorm
from ..core.util import tree_sqnorm, tree_stack_zeros, tree_sum_leading
from ..kernels import ops as kernel_ops
from ..tree import tree_leaves, tree_map
from .api import OptState, StepStats, static_pos
from .server import GradientDescent, HeavyBall
from .transport import DenseTransport, Int8Transport, _bcast

BACKENDS = ("reference", "cuda")


@dataclasses.dataclass(frozen=True)
class ComposedOptimizer:
    """One censor policy + one transport + one server update.

    Attributes:
      censor: who uploads (``opt.censor``).
      transport: what the upload carries (``opt.transport``).
      server: how theta advances (``opt.server``).
      num_workers: M.
      granularity: ``"global"`` (the paper's single-vector view).
      bank_dtype: optional dtype of the stale-gradient bank (the reference
        backend only; the kernels take the bank in the gradients' dtype).
      backend: ``"reference"`` or ``"cuda"`` (see the module docstring).
    """

    censor: Any
    transport: Any
    server: Any
    num_workers: int
    granularity: str = "global"
    bank_dtype: Any = None
    backend: str = "reference"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; valid: {BACKENDS}")
        if self.granularity == "per_tensor":
            raise NotImplementedError(
                "per_tensor granularity is not ported yet (ROADMAP A6)")
        if self.granularity != "global":
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.backend == "cuda":
            # the fused route implements dense and int8 itself; any other
            # transport opts in by being stateful with encode_feedback_cuda
            # (a custom stage falling back silently would misreport what ran)
            t = self.transport
            if not (type(t) in (DenseTransport, Int8Transport)
                    or (t.stateful and hasattr(t, "encode_feedback_cuda"))):
                raise TypeError(
                    "backend='cuda' runs the built-in transports (dense | "
                    "int8 | topk | lowrank) and stateful transports "
                    "providing encode_feedback_cuda; custom transport "
                    f"{type(t).__name__} must run on the reference backend")
            if not isinstance(self.server, (GradientDescent, HeavyBall)):
                raise TypeError(
                    "backend='cuda' fuses the gd and hb servers; "
                    f"{type(self.server).__name__} must run on the "
                    "reference backend")

    # ------------------------------------------------ hyperparameter views
    @property
    def alpha(self):
        return self.server.alpha

    @property
    def beta(self):
        return getattr(self.server, "beta", 0.0)

    @property
    def eps1(self):
        return getattr(self.censor, "eps1", 0.0)

    @property
    def quantize(self) -> Optional[str]:
        return self.transport.mode

    @property
    def name(self) -> str:
        """gd/hb/lag/chb classification (paper Sec. II), or "swept"."""
        ep, bp = static_pos(self.eps1), static_pos(self.beta)
        if ep is None or bp is None:
            return "swept"
        if ep and bp:
            return "chb"
        if ep:
            return "lag"
        return "hb" if bp else "gd"

    # ----------------------------------------------------------- protocol
    def init(self, params) -> OptState:
        """The iteration-0 state: zero bank, theta^{-1} = a copy of theta^0."""
        bank = tree_stack_zeros(params, self.num_workers)
        if self.bank_dtype is not None:
            bank = tree_map(lambda x: x.to(self.bank_dtype), bank)
        return OptState(
            prev_params=tree_map(lambda x: x.clone(), params),
            ghat=bank,
            err=self.transport.init(params, self.num_workers),
            comm=CommStats.init(self.num_workers,
                                tree_leaves(params)[0].device),
            censor=self.censor.init(self.num_workers),
        )

    def step(self, state: OptState, params, worker_grads
             ) -> tuple[OptState, Any, StepStats]:
        """One iteration of Algorithm 1: ``(new_state, new_params, stats)``.

        ``worker_grads`` is the gradient tree stacked with leading axis M.
        """
        if self.backend == "cuda":
            return self._step_kernels(state, params, worker_grads)
        return self._step(state, params, worker_grads)

    def _step(self, state: OptState, params, worker_grads):
        # delta_m = g_m - ghat_m, in the bank's dtype
        delta = tree_map(lambda g, h: g.to(h.dtype) - h,
                         worker_grads, state.ghat)
        pending = self.transport.prepare(delta, state.err)
        dsq = delta_sqnorms(pending)
        ssq = step_sqnorm(params, state.prev_params)
        mask, new_censor = self.censor.decide(state.censor, dsq, ssq)

        payload, aux = self.transport.encode(pending, state.err)
        new_err = self.transport.feedback(mask, pending, payload, aux,
                                          state.err)
        # server/worker synchronized advance of the stale bank
        new_ghat = tree_map(
            lambda h, q: h + _bcast(mask, h) * q.to(h.dtype),
            state.ghat, payload)
        # grad_k = sum_m ghat_m^k (eq. (5) unrolled)
        agg = tree_sum_leading(new_ghat)
        new_params = self.server.apply(params, state.prev_params, agg)
        return self._finish(state, params, mask, dsq, ssq, new_ghat,
                            new_err, new_censor, agg, new_params)

    def _step_kernels(self, state: OptState, params, worker_grads):
        kind = type(self.transport)
        fused = kind in (DenseTransport, Int8Transport)
        pending = scales = None
        if kind is Int8Transport:
            # sweep 1: sqnorms + abs-max from pending recomputed in
            # registers; the pending tree is never materialized
            dsq, scales = kernel_ops.tree_int8_stats(
                worker_grads, state.ghat, state.err)
        elif fused:
            dsq = kernel_ops.tree_delta_sqnorms(worker_grads, state.ghat)
        else:
            delta = tree_map(lambda g, h: g.to(h.dtype) - h,
                             worker_grads, state.ghat)
            pending = self.transport.prepare(delta, state.err)
            del delta
            dsq = kernel_ops.tree_sqnorms(pending)
        ssq = step_sqnorm(params, state.prev_params)
        mask, new_censor = self.censor.decide(state.censor, dsq, ssq)

        if kind is Int8Transport:
            # sweep 2: int8 round trip + EF + bank advance + worker sum +
            # eq. (4) in one pass per leaf
            new_ghat, new_err, agg, new_params = \
                kernel_ops.tree_fused_int8_step(
                    worker_grads, state.ghat, state.err, params,
                    state.prev_params, mask, scales, self.alpha, self.beta)
        elif fused:
            new_err = state.err
            new_ghat, agg, new_params = kernel_ops.tree_fused_dense_step(
                worker_grads, state.ghat, params, state.prev_params, mask,
                self.alpha, self.beta)
        else:
            payload, new_err = self.transport.encode_feedback_cuda(
                pending, state.err, mask)
            del pending
            new_ghat = kernel_ops.tree_bank_advance(state.ghat, payload,
                                                    mask)
            del payload
            agg = tree_sum_leading(new_ghat)
            new_params = self.apply_server(params, state.prev_params, agg)
        if fused:
            # the diagnostic is recomputed from the bank, as the JAX fused
            # route does (the kernel's agg is the same left fold, bit for
            # bit); the staged route's agg already is that fold
            agg = tree_sum_leading(new_ghat)
        return self._finish(state, params, mask, dsq, ssq, new_ghat,
                            new_err, new_censor, agg, new_params)

    def _finish(self, state, params, mask, dsq, ssq, new_ghat, new_err,
                new_censor, agg, new_params):
        stats = StepStats(mask=mask, delta_sq=dsq, step_sq=ssq,
                          agg_grad_sqnorm=tree_sqnorm(agg))
        new_state = OptState(
            prev_params=params,
            ghat=new_ghat,
            err=new_err,
            comm=state.comm.update(mask,
                                   self.transport.payload_bytes(params)),
            censor=new_censor,
        )
        return new_state, new_params, stats

    def shard_step(self, state, params, worker_grads, **gates):
        """The client half of a sharded round: not ported (ROADMAP A10)."""
        raise NotImplementedError(
            "shard_step is not ported yet (ROADMAP A10)")

    def apply_server(self, params, prev_params, agg):
        """The backend-dispatched server update (the fed runtime's hook).

        On ``cuda`` it runs B3 per leaf; gd runs it at beta = 0, which is
        bit-identical to ``GradientDescent.apply``.
        """
        if self.backend == "cuda":
            return kernel_ops.tree_hb_update(params, prev_params, agg,
                                             self.alpha, self.beta)
        return self.server.apply(params, prev_params, agg)


