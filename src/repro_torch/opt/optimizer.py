"""``ComposedOptimizer``: Algorithm 1 from one censor, one transport and
one server update (port of ``repro.opt.optimizer``).

Two backends:

  * ``"reference"`` -- plain PyTorch stage calls (``_step``, a port of the
    JAX reference step);
  * ``"cuda"`` -- the kernel step (``_step_kernels``, a port of the JAX
    package's ``_step_pallas``). Dense and int8 take the fused route: per
    parameter leaf one reduction (B1 for dense, B5 for int8) feeds the
    censor decision, then one fused pass (B2 / B6) advances the bank, sums
    the workers and applies eq. (4). Inside ``fused_step.force_staged()``
    they take the staged route instead, as top-k, low-rank and any other
    stateful transport with ``encode_feedback_cuda`` always do: dense runs
    B1, the bank advance B4, the worker fold (``fold_workers``) and
    ``apply_server`` (B3); a stateful transport runs the pending tree in
    plain torch, its norms (B8), the transport's encode + EF tail (B7a +
    B7b for int8, B10 for top-k, B11 for low-rank), the bank advance (B9),
    the worker fold and B3. Both routes give the same bits. A bf16 bank
    (``bank_dtype=torch.bfloat16`` or bf16 params) runs every route
    (fused, staged, ``shard_step``, ``per_tensor``) of every transport; an
    f16 bank is refused before any launch (the kernels' f16 builds are
    ROADMAP queue B). On CPU tensors the kernel wrappers run their plain
    versions, so this backend also runs, and is tested, on the CPU.

``shard_step`` is the client half of a sharded round (the staged kernels
on ``cuda``, since the server half runs after the cross-shard fold), and
``granularity="per_tensor"`` runs the eq.-(8) test per parameter tensor
(B8, B9 and the worker fold per leaf on ``cuda``). The ``reference``
backend sums the workers with ``core.util.tree_sum_leading``, one eager add
a worker; ``fold_workers`` folds in the same order, so both give the same
bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core import accounting
from ..core.accounting import CommStats
from ..core.censoring import delta_sqnorms, step_sqnorm
from ..core.util import tree_sqnorm, tree_stack_zeros, tree_sum_leading
from ..kernels import censor as kernel_censor
from ..kernels import fused_step as kernel_fused
from ..kernels import ops as kernel_ops
from ..kernels.common import FUSED_DTYPES
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .api import OptState, ShardStepStats, StepStats, static_pos
from .censor import Eq8Censor, NeverCensor
from .server import GradientDescent, HeavyBall
from .transport import DenseTransport, Int8Transport, _bcast

BACKENDS = ("reference", "cuda")
GRANULARITIES = ("global", "per_tensor")


def _gate(mask, participate, channel_mask):
    """Compose the censor mask with the optional round gates.

    All operands are exact {0.0, 1.0} indicators, so the products are
    logical ANDs that stay exact; with both gates absent the result is
    ``mask`` itself, which keeps the ungated ``shard_step`` bit for bit
    equal to ``step``.
    """
    attempted_mask = mask if participate is None else mask * participate
    delivered_mask = attempted_mask if channel_mask is None \
        else attempted_mask * channel_mask
    return attempted_mask, delivered_mask


@dataclasses.dataclass(frozen=True)
class ComposedOptimizer:
    """One censor policy + one transport + one server update.

    Attributes:
      censor: who uploads (``opt.censor``).
      transport: what the upload carries (``opt.transport``).
      server: how theta advances (``opt.server``).
      num_workers: M.
      granularity: ``"global"`` (the paper's single-vector view) or
        ``"per_tensor"`` (beyond the paper: the eq.-(8) test per parameter
        tensor; it needs an ``Eq8Censor`` with a host-scalar eps1 and a
        stateless transport, and degenerates to the global path for
        eps1 = 0 and for any other censor).
      bank_dtype: optional dtype of the stale-gradient bank (bf16 halves
        it). On ``cuda`` every route runs f32, f64 and bf16 params with a
        bank in their dtype, and f32 params with a bf16 bank
        (``kernels.common.FUSED_DTYPES``); an f16 bank is refused before
        any launch (ROADMAP queue B).
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
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}; "
                             f"valid: {GRANULARITIES}")
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

    def with_hparams(self, *, alpha=None, beta=None,
                     eps1=None) -> "ComposedOptimizer":
        """Rebind the scalar hyperparameters (the sweep engine's hook).

        * ``beta`` rebinds a momentum server; ``GradientDescent`` is
          promoted to ``HeavyBall(alpha, beta)``, which is bit-identical
          at beta = 0.
        * ``eps1`` retargets an eq.-(8) censor, or upgrades a
          ``NeverCensor`` to one (``Eq8Censor(0.0)`` transmits always, as
          ``NeverCensor`` does). Any other policy keeps its own
          thresholds.

        Pass host floats: a tensor scalar takes the stages' branch-free
        forms (``static_pos``), which are not ``opt.make``'s code.
        """
        server = self.server
        if alpha is not None:
            server = dataclasses.replace(server, alpha=alpha)
        if beta is not None:
            if hasattr(server, "beta"):
                server = dataclasses.replace(server, beta=beta)
            else:
                server = HeavyBall(server.alpha, beta)
        censor = self.censor
        if eps1 is not None:
            if isinstance(censor, Eq8Censor):
                censor = dataclasses.replace(censor, eps1=eps1)
            elif isinstance(censor, NeverCensor):
                censor = Eq8Censor(eps1)
        return dataclasses.replace(self, censor=censor, server=server)

    def metrics(self, state: OptState, stats: StepStats) -> dict:
        """The per-round ``repro_torch.obs`` MetricBag of a finished step
        (read-only: see ``obs.metrics.step_metrics``)."""
        from ..obs import metrics as obs_metrics
        return obs_metrics.step_metrics(self, state, stats)

    # ----------------------------------------------------------- protocol
    def init(self, params) -> OptState:
        """The iteration-0 state: zero bank, theta^{-1} = a copy of theta^0."""
        bank = tree_stack_zeros(params, self.num_workers)
        if self.bank_dtype is not None:
            bank = tree_map(lambda x: x.to(self.bank_dtype), bank)
        device = tree_leaves(params)[0].device
        return OptState(
            prev_params=tree_map(lambda x: x.clone(), params),
            ghat=bank,
            err=self.transport.init(params, self.num_workers),
            comm=CommStats.init(self.num_workers, device),
            censor=self.censor.init(self.num_workers, device),
        )

    def step(self, state: OptState, params, worker_grads
             ) -> tuple[OptState, Any, StepStats]:
        """One iteration of Algorithm 1: ``(new_state, new_params, stats)``.

        ``worker_grads`` is the gradient tree stacked with leading axis M.
        """
        # per_tensor binds to the eq.-(8) censor only; any other policy,
        # and eps1 = 0, degenerate to the global path, as in the JAX package
        if self.granularity == "per_tensor" \
                and isinstance(self.censor, Eq8Censor):
            eps_pos = static_pos(self.censor.eps1)
            if eps_pos is None:
                raise NotImplementedError(
                    "per_tensor censoring needs a host-scalar eps1 (its "
                    "byte accounting splits each leaf's payload on the "
                    "host)")
            if eps_pos:
                return self._step_per_tensor(state, params, worker_grads)
        if self.backend == "cuda":
            return self._step_kernels(state, params, worker_grads)
        return self._step(state, params, worker_grads)

    def _refuse_bank(self, params, bank, route: str) -> None:
        """On ``cuda`` a route off the fused one takes the (params, bank)
        pairs its kernels do (B4, B8, B9, the fold, B3; B7a, B7b, B10, B11):
        ``FUSED_DTYPES``' f32, f64, bf16 and f32 params on a bf16 bank.
        ``route`` names one that a leaf falls outside, which raises here,
        before any launch."""
        bad = sorted({f"{p.dtype} params on a {h.dtype}" for p, h in zip(
            tree_leaves(params), tree_leaves(bank))
            if (p.dtype, h.dtype) not in FUSED_DTYPES})
        if bad:
            raise TypeError(
                f"backend='cuda' runs {route} on float32, float64 and "
                "bfloat16 banks of params in their dtype, and on bfloat16 "
                f"banks of float32 params, not {', '.join(bad)} bank (other "
                "banks there are ROADMAP queue B)")

    def _step(self, state: OptState, params, worker_grads):
        pending = self._pending(state, worker_grads)
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
        fusion = kernel_fused.fusion_enabled()
        quantized = self.transport.stateful
        int8_fused = fusion and type(self.transport) is Int8Transport
        fused = int8_fused or (fusion and not quantized)
        if not fused:
            self._refuse_bank(
                params, state.ghat, f"{type(self.transport).__name__} off "
                "the fused route")
        pending = scales = None
        if int8_fused:
            # sweep 1: sqnorms + abs-max from pending recomputed in
            # registers; the pending tree is never materialized
            dsq, scales = kernel_ops.tree_int8_stats(
                worker_grads, state.ghat, state.err)
        elif quantized:
            pending = self._pending(state, worker_grads)
            dsq = kernel_ops.tree_sqnorms(pending)
        else:
            dsq = kernel_ops.tree_delta_sqnorms(worker_grads, state.ghat)
        ssq = step_sqnorm(params, state.prev_params)
        mask, new_censor = self.censor.decide(state.censor, dsq, ssq)

        if int8_fused:
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
            new_ghat, new_err = self._advance_kernels(
                state, worker_grads, pending, mask)
            del pending
            agg = kernel_ops.tree_fold_workers(new_ghat)
            new_params = self.apply_server(params, state.prev_params, agg)
        # the fused routes keep the kernels' agg. The JAX fused route
        # recomputes agg from the bank for its agg_grad_sqnorm diagnostic:
        # XLA would fuse the sqnorm into the sliced kernel output and group
        # its sum otherwise than over the host fold. Eager PyTorch runs one
        # torch.sum on whichever buffer holds the values, and B2/B6 fold
        # the workers left to right from ghat'_0, tree_sum_leading's fold
        # bit for bit, so a recompute would only add M - 1 launches a leaf
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

    def _pending(self, state: OptState, worker_grads):
        """The transport's pending tree: ``delta = g - ghat`` in the bank's
        dtype, with the EF residual folded in by ``prepare``."""
        delta = tree_map(lambda g, h: g.to(h.dtype) - h,
                         worker_grads, state.ghat)
        return self.transport.prepare(delta, state.err)

    def _advance_kernels(self, state: OptState, worker_grads, pending,
                         mask):
        """The staged bank advance under ``mask``: B4 on the raw gradients
        for a stateless transport, else the transport's encode + EF tail
        and B9 on its payload. Returns ``(new_ghat, new_err)``."""
        if pending is None:
            return kernel_ops.tree_censor_bank_advance(
                worker_grads, state.ghat, mask), state.err
        payload, new_err = self.transport.encode_feedback_cuda(
            pending, state.err, mask)
        return kernel_ops.tree_bank_advance(state.ghat, payload, mask), \
            new_err

    def shard_step(self, state: OptState, params, worker_grads, *,
                   worker_ids=None, participate=None, channel_mask=None
                   ) -> tuple[OptState, Any, ShardStepStats]:
        """The client half of a step, for one shard of workers.

        ``step`` with the server update factored out: it runs the censor
        and transport stages and the bank advance for a shard-local block
        of workers and returns the shard's eq.-(5) partial aggregate
        ``sum_m ghat_m`` instead of new params. A sharded round folds the
        partials and advances theta once with ``apply_server``; over one
        shard with no gates, ``shard_step`` + ``apply_server(params,
        state.prev_params, partial)`` equals ``step`` bit for bit (the
        sync anchor).

        Args:
          state: the shard-local state (``(M_local, ...)`` bank rows, the
            shard's own ``CommStats`` and censor state).
          params / worker_grads: theta^k and the shard's ``(M_local, ...)``
            stacked gradients.
          worker_ids: the shard's absolute client ids, handed to the
            censor's ``decide_ids`` (omit for one full-population shard).
          participate: optional (M_local,) {0, 1} gate: who woke up this
            round. A censor-passing non-participant does not transmit.
          channel_mask: optional (M_local,) {0, 1} gate: whose uplink
            survived the channel. A dropped transmission still spends its
            bytes (``attempted``) but never reaches the bank or the EF
            state (``delivered``).
        Returns:
          ``(new_state, partial_agg, ShardStepStats)``.
        """
        if self.granularity != "global":
            raise NotImplementedError(
                "shard_step supports global granularity only (per_tensor "
                "byte accounting is host-side and unsharded)")
        kernels = self.backend == "cuda"
        quantized = self.transport.stateful
        if kernels:
            self._refuse_bank(params, state.ghat, "shard_step")
        pending = None
        if kernels and not quantized:
            dsq = kernel_ops.tree_delta_sqnorms(worker_grads, state.ghat)
        else:
            pending = self._pending(state, worker_grads)
            dsq = kernel_ops.tree_sqnorms(pending) if kernels \
                else delta_sqnorms(pending)
        ssq = step_sqnorm(params, state.prev_params)
        mask, new_censor = self._decide(state.censor, dsq, ssq, worker_ids)
        attempted, delivered = _gate(mask, participate, channel_mask)

        if kernels:
            # the staged kernels: the megakernels fuse eq. (4) into the
            # sweep, and a sharded round applies it after the fold
            new_ghat, new_err = self._advance_kernels(
                state, worker_grads, pending, delivered)
        else:
            payload, aux = self.transport.encode(pending, state.err)
            new_err = self.transport.feedback(delivered, pending, payload,
                                              aux, state.err)
            new_ghat = tree_map(
                lambda h, q: h + _bcast(delivered, h) * q.to(h.dtype),
                state.ghat, payload)
        del pending
        partial = self._worker_sum(new_ghat)

        stats = ShardStepStats(mask=mask, attempted=attempted,
                               delivered=delivered, delta_sq=dsq,
                               step_sq=ssq)
        new_state = OptState(
            prev_params=params,
            ghat=new_ghat,
            err=new_err,
            comm=state.comm.update(attempted,
                                   self.transport.payload_bytes(params)),
            censor=new_censor,
        )
        return new_state, partial, stats

    def _decide(self, censor_state, dsq, ssq, worker_ids):
        if worker_ids is None:
            return self.censor.decide(censor_state, dsq, ssq)
        return self.censor.decide_ids(censor_state, dsq, ssq, worker_ids)

    def _worker_sum(self, bank):
        """``sum_m ghat_m`` per leaf: the fold kernel on ``cuda``, the
        Python left fold on ``reference``; the same bits."""
        if self.backend == "cuda":
            return kernel_ops.tree_fold_workers(bank)
        return tree_sum_leading(bank)

    def apply_server(self, params, prev_params, agg):
        """The backend-dispatched server update (the fed runtime's hook).

        On ``cuda`` it runs B3 per leaf; gd runs it at beta = 0, which is
        bit-identical to ``GradientDescent.apply``.
        """
        if self.backend == "cuda":
            return kernel_ops.tree_hb_update(params, prev_params, agg,
                                             self.alpha, self.beta)
        return self.server.apply(params, prev_params, agg)

    def _step_per_tensor(self, state: OptState, params, worker_grads):
        """Per-tensor censoring (beyond the paper).

        The eq.-(8) test runs on each parameter tensor on its own,
        ``dsq_t > eps1 * ssq_t`` in f32 with ``ssq_t`` the squared f32
        difference of the leaf's theta^k and theta^{k-1} (eps1 is not cast
        first, as in the JAX package). Bytes count per transmitted tensor;
        the uplink count counts a worker-iteration once if any of its
        tensors ships, so it stays comparable with global censoring. On
        ``cuda`` each leaf runs B8 and B9, then the server runs B3.
        """
        if self.transport.stateful:
            raise NotImplementedError(
                "per_tensor granularity with a stateful transport "
                f"({type(self.transport).__name__}) is not supported")
        eps1 = self.censor.eps1
        kernels = self.backend == "cuda"
        if kernels:
            self._refuse_bank(params, state.ghat,
                              "per_tensor granularity")
        pending = self._pending(state, worker_grads)
        leaves_d, treedef = tree_flatten(pending)
        leaves_t = tree_leaves(params)
        leaves_p = tree_leaves(state.prev_params)
        leaves_h = tree_leaves(state.ghat)

        m = self.num_workers
        device = leaves_h[0].device
        mib_up = torch.zeros((), dtype=torch.int32, device=device)
        rem_up = torch.zeros((), dtype=torch.int32, device=device)
        any_mask = torch.zeros((m,), dtype=torch.float32, device=device)
        new_ghat = []
        for d, t, tp, h in zip(leaves_d, leaves_t, leaves_p, leaves_h):
            if kernels:
                dsq_t = kernel_censor.sqnorm_batched(d)
            else:
                dsq_t = torch.sum(
                    torch.square(d.to(torch.float32)).reshape(m, -1), dim=1)
            ssq_t = torch.sum(torch.square(t.to(torch.float32)
                                           - tp.to(torch.float32)))
            mask_t = (dsq_t > eps1 * ssq_t).to(torch.float32)
            any_mask = torch.maximum(any_mask, mask_t)
            n_tx_t = torch.sum(mask_t).to(torch.int32)
            # exact split-counter bytes: the leaf's payload is split on the
            # host, and the carry per leaf keeps the remainder in int32
            pb_mib, pb_rem = accounting.split_bytes(
                d[0].numel() * d.element_size())
            mib_up, rem_up = accounting.carry_bytes(
                mib_up + n_tx_t * pb_mib, rem_up + n_tx_t * pb_rem)
            if kernels:
                new_ghat.append(kernel_censor.bank_advance(h, d, mask_t))
            else:
                new_ghat.append(h + _bcast(mask_t, h) * d.to(h.dtype))
        new_ghat = tree_unflatten(treedef, new_ghat)

        agg = self._worker_sum(new_ghat)
        new_params = self.apply_server(params, state.prev_params, agg)
        comm = CommStats(
            uplink_count=state.comm.uplink_count + any_mask.to(torch.int32),
            uplink_mib=state.comm.uplink_mib,
            uplink_rem=state.comm.uplink_rem,
            downlink_count=state.comm.downlink_count + 1,
            iterations=state.comm.iterations + 1,
        ).add_bytes_split(mib_up, rem_up)
        stats = StepStats(mask=any_mask, delta_sq=delta_sqnorms(pending),
                          step_sq=step_sqnorm(params, state.prev_params),
                          agg_grad_sqnorm=tree_sqnorm(agg))
        new_state = OptState(prev_params=params, ghat=new_ghat,
                             err=state.err, comm=comm, censor=state.censor)
        return new_state, new_params, stats
