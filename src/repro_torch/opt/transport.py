"""Transports: what bits a transmitted delta carries (port of
``repro.opt.transport``).

  * :class:`DenseTransport` -- the paper's uplink: the raw delta tree.
  * :class:`Int8Transport` -- symmetric int8 with a per-worker scale and
    error feedback, so worker and server views never diverge.
  * :class:`TopKTransport` -- per-leaf magnitude top-k (index + value on
    the wire) with the same error-feedback bank.
  * :class:`LowRankTransport` -- PowerSGD-style rank-r power iteration
    with warm-started factors beside the error-feedback bank.

Stage anatomy of one batched step:

    pending = prepare(delta, err)
    payload, aux = encode(pending, err)
    new_err = feedback(mask, pending, payload, aux, err)

Each stage also has a row form for one worker's slice, which the event
runtime (``fed.runner``) calls as a client finishes:
``prepare_row(delta, err_row)``, ``encode_row(pending, err_row)`` and
``feedback_row(pending, payload, aux, err_row)``, the last applied only
when the upload arrives. A row entry runs the per-slice math of the
batched one, so it equals the batched entry's worker slice at mask 1 bit
for bit. The row entries are plain PyTorch on either backend, as in the
JAX package. ``stateful`` says whether transport state (the EF bank, and
any warm-started factors) exists.

Each stage has a ``metrics(err) -> dict`` hook for ``repro_torch.obs``:
read-only stage-local scalars (the EF bank's squared norm for the
stateful ones), namespaced ``transport/<kind>/<key>`` in the MetricBag.

A stateful transport runs the staged steps of the ``cuda`` backend through
``encode_feedback_cuda(pending, err, mask) -> (payload, new_err)``, which
hands its elementwise tail to kernels (B7a + B7b for int8, B10 for top-k,
B11 for low-rank).
The selections and factor products around it are plain PyTorch, as the
JAX package leaves them to XLA; they assume
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default),
since TF32 would change the factors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

import torch

from ..core.quantize import (payload_bytes_dense, payload_bytes_int8,
                             tree_quantize_roundtrip,
                             tree_quantize_roundtrip_per_worker)
from ..core.util import tree_sqnorm, tree_stack_zeros
from ..kernels import ops as kernel_ops
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-worker mask (M,) against a leading-M leaf."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def _ef_blend(mask, pending, payload, err):
    """Masked error-feedback update ``mk*(p - q) + (1 - mk)*e``: the
    arithmetic-blend form the fused int8 kernel evaluates too."""
    return tree_map(
        lambda p, q, e: _bcast(mask, p) * (p - q)
        + (1.0 - _bcast(mask, p)) * e.to(p.dtype),
        pending, payload, err)


@dataclasses.dataclass(frozen=True)
class DenseTransport:
    """Raw-delta uplinks (the paper's transport)."""

    mode: ClassVar[Optional[str]] = None
    stateful: ClassVar[bool] = False
    exact_residual: ClassVar[bool] = True

    def init(self, params, num_workers: int):
        # empty leaves keep the state's tree structure the same across
        # transports, as in the JAX package
        return tree_map(lambda x: torch.zeros((0,), dtype=x.dtype,
                                              device=x.device), params)

    def prepare(self, delta, err):
        return delta

    def encode(self, pending, err):
        return pending, ()

    def feedback(self, mask, pending, payload, aux, err):
        return err

    def prepare_row(self, delta, err_row):
        return delta

    def encode_row(self, pending, err_row):
        return pending, ()

    def feedback_row(self, pending, payload, aux, err_row):
        return err_row

    def payload_bytes(self, params) -> int:
        return payload_bytes_dense(params)

    def ef_bank(self, err):
        return None

    def metrics(self, err) -> dict:
        return {}


@dataclasses.dataclass(frozen=True)
class Int8Transport:
    """Int8 uplinks with per-worker scales and error feedback."""

    mode: ClassVar[Optional[str]] = "int8"
    stateful: ClassVar[bool] = True
    exact_residual: ClassVar[bool] = True

    def init(self, params, num_workers: int):
        return tree_stack_zeros(params, num_workers)

    def prepare(self, delta, err):
        return _add_err(delta, err)

    def encode(self, pending, err):
        # per-worker scales: worker m quantizes its own delta slice
        return tree_quantize_roundtrip_per_worker(pending), ()

    def feedback(self, mask, pending, payload, aux, err):
        return _ef_blend(mask, pending, payload, err)

    def encode_feedback_cuda(self, pending, err, mask):
        """The staged kernel route: one abs-max reduction (B7a), then one
        pass emitting the payload and the new EF bank together (B7b)."""
        return kernel_ops.tree_int8_roundtrip_ef(pending, err, mask)

    def prepare_row(self, delta, err_row):
        return _add_err(delta, err_row)

    def encode_row(self, pending, err_row):
        return tree_quantize_roundtrip(pending), ()

    def feedback_row(self, pending, payload, aux, err_row):
        return tree_map(torch.sub, pending, payload)

    def payload_bytes(self, params) -> int:
        return payload_bytes_int8(params)

    def ef_bank(self, err):
        return err

    def metrics(self, err) -> dict:
        # ||EF bank||^2: the quantization residual the cohort carries
        return {"ef_residual_sqnorm": tree_sqnorm(err)}


def _add_err(delta, err):
    return tree_map(lambda d, e: d + e.to(d.dtype), delta, err)


def _blend_q(mask, q_new, q_old):
    """Transmitted workers take their refreshed factors, censored ones keep
    the old: ``mk*qn + (1 - mk)*qo``."""
    return tree_map(
        lambda qn, qo: _bcast(mask, qn) * qn
        + (1.0 - _bcast(mask, qn)) * qo.to(qn.dtype),
        q_new, q_old)


# ------------------------------------------------------------------ top-k
def _keep_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 keep masks, in ``x.dtype``, of each worker's slice of one
    (M, ...) leaf: the ``min(k, size)`` largest ``|x|``, the lowest flat
    index winning a tie, exactly as ``lax.top_k`` chooses.

    ``torch.topk`` promises no order among ties on CUDA, so it gives only
    the kk-th largest value t. Every entry above t is kept, and of the
    entries equal to t the first ``kk - count(> t)`` in index order.
    ``|-0.0| == +0.0``, so signed zeros tie with each other.

    The ties are ranked in their compacted list (``nonzero`` lists them in
    row-major order), not by a cumulative count along each row: PyTorch's
    scan over the last dimension runs a few very long rows almost
    serially, about 250 ms for 4 x 163,597,056 entries on an H100.
    """
    m = x.shape[0]
    vals = torch.abs(x.reshape(m, -1))
    kk = min(int(k), vals.shape[1])
    if kk == 0:
        return torch.zeros_like(x)
    t = torch.topk(vals, kk, dim=1, sorted=False).values.amin(
        dim=1, keepdim=True)
    above = vals > t
    ties = vals == t
    room = kk - above.sum(dim=1, dtype=torch.int64)
    n_ties = ties.sum(dim=1, dtype=torch.int64)
    rows, cols = torch.nonzero(ties, as_tuple=True)
    # a tie's rank among its row's ties: its place in the list minus the
    # place of the row's first tie
    rank = torch.arange(rows.numel(), device=x.device) \
        - (torch.cumsum(n_ties, 0) - n_ties)[rows]
    surplus = rank >= room[rows]
    ties[rows[surplus], cols[surplus]] = False
    return (above | ties).to(x.dtype).reshape(x.shape)


def tree_topk_keep(pending, k: int):
    """Per-worker keep masks of a leading-M stacked tree."""
    return tree_map(lambda x: _keep_mask(x, k), pending)


def tree_topk_keep_row(pending_row, k: int):
    """One worker's keep masks (the ``fed.runner`` entry point): the
    batched selection at M = 1."""
    return tree_map(lambda x: _keep_mask(x[None], k)[0], pending_row)


def _select_kept(pending, keep):
    # a select, not a multiply: x * 0 would turn -0.0 into +0.0
    return tree_map(
        lambda p, kp: torch.where(kp != 0, p, torch.zeros_like(p)),
        pending, keep)


@dataclasses.dataclass(frozen=True)
class TopKTransport:
    """Top-k sparsified uplinks with error feedback (index+value packing).

    Each worker ships, per leaf, the ``min(k, leaf.size)`` largest-magnitude
    entries of its pending delta: ``k * (4 + itemsize)`` bytes per leaf.
    The un-shipped mass goes into the same error-feedback bank int8 uses.
    """

    mode: ClassVar[Optional[str]] = "topk"
    stateful: ClassVar[bool] = True
    exact_residual: ClassVar[bool] = True   # the residual is x or 0

    k: int = 64

    def init(self, params, num_workers: int):
        return tree_stack_zeros(params, num_workers)

    def prepare(self, delta, err):
        return _add_err(delta, err)

    def encode(self, pending, err):
        return _select_kept(pending, tree_topk_keep(pending, self.k)), ()

    def feedback(self, mask, pending, payload, aux, err):
        return _ef_blend(mask, pending, payload, err)

    def encode_feedback_cuda(self, pending, err, mask):
        """The kernel route: exact keep masks in plain torch, then one
        select/pack + EF pass per leaf (B10)."""
        keep = tree_topk_keep(pending, self.k)
        return kernel_ops.tree_topk_pack_ef(pending, err, keep, mask)

    def prepare_row(self, delta, err_row):
        return _add_err(delta, err_row)

    def encode_row(self, pending, err_row):
        return _select_kept(pending,
                            tree_topk_keep_row(pending, self.k)), ()

    def feedback_row(self, pending, payload, aux, err_row):
        return tree_map(torch.sub, pending, payload)

    def payload_bytes(self, params) -> int:
        # min(k, size) kept entries per leaf, each a 4-byte index plus one
        # native-dtype value
        return sum(min(int(self.k), x.numel()) * (4 + x.element_size())
                   for x in tree_leaves(params))

    def ef_bank(self, err):
        return err

    def metrics(self, err) -> dict:
        return {"ef_residual_sqnorm": tree_sqnorm(err)}


# ---------------------------------------------------------------- low-rank
def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt on the columns of ``p`` (r, rank).

    An explicit column loop, as in the JAX package. Zero columns pass
    through unnormalized (guarded divide), never NaN.
    """
    cols = []
    for j in range(p.shape[1]):
        v = p[:, j]
        for u in cols:
            v = v - torch.dot(u, v) * u
        nrm = torch.sqrt(torch.sum(v * v))
        cols.append(v / torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
    return torch.stack(cols, dim=1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in ``promote_types`` of the two, as ``jnp.matmul`` promotes
    (``torch.matmul`` refuses mixed dtypes); one dtype passes unchanged."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _power_iter_slice(mat: torch.Tensor, q: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One PowerSGD step on one worker's matrixized leaf: ``mat`` (r, c),
    ``q`` (c, rank). Returns (reconstruction ``P @ Q'^T``, ``Q'``). Each
    product runs in the promoted dtype of its operands, as in the JAX
    package: a bf16 pending leaf of f32 params (a bf16 bank) meets an f32
    factor, and P, Q' and the reconstruction come out in f32."""
    p = _orthonormalize(_matmul(mat, q))
    q_new = _matmul(mat.T, p)
    return p @ q_new.T, q_new


def _matrixize(x: torch.Tensor) -> torch.Tensor:
    """One worker's leaf as (shape[0], prod(rest)), PowerSGD's view."""
    return x.reshape(x.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class LowRankTransport:
    """PowerSGD-style rank-r uplinks with warm-started factors + EF.

    Matrix leaves (ndim >= 2, viewed as ``(shape[0], prod(rest))``) ship
    one power-iteration step of rank ``min(rank, rows, cols)``: two factors
    of ``rank*(rows + cols)`` values. Vector leaves ship dense. The right
    factor Q warm-starts the next round and advances only on transmitted
    rounds, like the bank; the approximation error goes into the EF bank.
    """

    mode: ClassVar[Optional[str]] = "lowrank"
    stateful: ClassVar[bool] = True
    exact_residual: ClassVar[bool] = False  # P@Q^T is an arbitrary float

    rank: int = 2

    def _rank_eff(self, leaf_shape) -> int:
        return min(int(self.rank), leaf_shape[0], math.prod(leaf_shape[1:]))

    def _q_init_slice(self, leaf: torch.Tensor) -> torch.Tensor:
        """Deterministic warm start: the first rank_eff canonical basis
        vectors of the column space."""
        if leaf.dim() < 2:
            return torch.zeros((0,), dtype=leaf.dtype, device=leaf.device)
        c = math.prod(leaf.shape[1:])
        return torch.eye(c, self._rank_eff(leaf.shape), dtype=leaf.dtype,
                         device=leaf.device)

    def init(self, params, num_workers: int):
        def q0(x):
            q = self._q_init_slice(x)
            return q.expand((num_workers,) + tuple(q.shape)).contiguous()
        return {"err": tree_stack_zeros(params, num_workers),
                "q": tree_map(q0, params)}

    def prepare(self, delta, err):
        return _add_err(delta, err["err"])

    def _encode_slice(self, x: torch.Tensor, q: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One worker's (payload, new_q) for one leaf."""
        if q.shape[-1] == 0:            # vector leaf: dense passthrough
            return x, q
        recon, q_new = _power_iter_slice(_matrixize(x), q)
        return recon.reshape(x.shape), q_new

    def encode(self, pending, err):
        # an explicit loop over the workers, as in the JAX package, where
        # each worker slice runs the subgraph the per-client entry runs
        def leaf(p, q):
            outs = [self._encode_slice(p[i], q[i])
                    for i in range(p.shape[0])]
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]))
        leaves_p, treedef = tree_flatten(pending)
        outs = [leaf(p, q) for p, q in zip(leaves_p, tree_leaves(err["q"]))]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                tree_unflatten(treedef, [o[1] for o in outs]))

    def feedback(self, mask, pending, payload, aux, err):
        return {"err": _ef_blend(mask, pending, payload, err["err"]),
                "q": _blend_q(mask, aux, err["q"])}

    def encode_feedback_cuda(self, pending, err, mask):
        """The kernel route: the factor products in plain torch, then one
        EF residual pass per leaf (B11), then the q blend."""
        payload, q_new = self.encode(pending, err)
        new_err = kernel_ops.tree_residual_ef(pending, payload, err["err"],
                                              mask)
        return payload, {"err": new_err,
                         "q": _blend_q(mask, q_new, err["q"])}

    def prepare_row(self, delta, err_row):
        return _add_err(delta, err_row["err"])

    def encode_row(self, pending, err_row):
        leaves_p, treedef = tree_flatten(pending)
        outs = [self._encode_slice(p, q)
                for p, q in zip(leaves_p, tree_leaves(err_row["q"]))]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                tree_unflatten(treedef, [o[1] for o in outs]))

    def feedback_row(self, pending, payload, aux, err_row):
        return {"err": tree_map(torch.sub, pending, payload), "q": aux}

    def payload_bytes(self, params) -> int:
        # matrix leaves ship the two factors; vector leaves ship dense
        total = 0
        for x in tree_leaves(params):
            if x.dim() >= 2:
                total += self._rank_eff(x.shape) * (
                    x.shape[0] + math.prod(x.shape[1:])) * x.element_size()
            else:
                total += x.numel() * x.element_size()
        return total

    def ef_bank(self, err):
        return err["err"]

    def metrics(self, err) -> dict:
        return {"ef_residual_sqnorm": tree_sqnorm(err["err"]),
                "factor_sqnorm": tree_sqnorm(err["q"])}
