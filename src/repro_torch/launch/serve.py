"""Batched decode server driver: prefill a batch of prompts, then decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chb-paper-lm-124m \
        [--reduced] [--batch 4] [--prompt-len 64] [--gen 32] [--seed 0] \
        [--device cuda|cpu]

A port of ``repro/launch/serve.py``: the same flags, plus ``--device``
(default: the card; without one it raises rather than fall back to the
CPU) and ``--seed``. Decoding is greedy argmax, as in the JAX package,
which reads ``--temperature`` and ignores it; so does this one. The
prompts are the JAX package's (``MarkovLM(vocab, seed=0)`` sampled with
``numpy.random.default_rng(0)``) and the weights are its
``init_params(PRNGKey(0), cfg)`` weights (``--seed`` picks another key),
drawn through the port of the JAX PRNG (``repro_torch.random``).

On the card, prefill runs each layer's attention through B14 and every
decode step through B13; f32 matmuls run in full f32, never TF32.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import random as jrandom
from ..configs import get
from ..data.lm_data import MarkovLM
from ..device import resolve_device
from ..kernels import build
from ..models import model


class Generation(NamedTuple):
    tokens: torch.Tensor          # (B, gen) greedy tokens
    logits: list                  # gen tensors (B, V) f32: prefill's, then each step's
    prefill_ms: float
    step_ms: list                 # gen - 1 decode steps


def full_f32() -> None:
    """f32 matmuls in full f32: TF32 would not hold the port's f32
    tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(params: dict, cfg, prompts, gen: int, *,
             cache_len: Optional[int] = None, backend: str = "cuda",
             feed: Optional[torch.Tensor] = None, device=None) -> Generation:
    """Prefill ``prompts`` (B, L), then ``gen - 1`` decode steps.

    Each step feeds the previous greedy token, or with ``feed`` (B, gen)
    the previous column of ``feed`` (teacher forcing: two backends then see
    the same tokens). ``cache_len`` defaults to L + gen + 1, as in the JAX
    package. Runs on ``device`` (default the card, raising without one),
    where ``params`` must lie. Returns the greedy tokens, every logit row
    and the prefill and per-step times (milliseconds, the host clock around
    work that ends in a synchronize).
    """
    full_f32()
    device = resolve_device(device)
    if params["embed"].device.type != device.type:
        raise ValueError(f"generate: the weights lie on "
                         f"{params['embed'].device}, not on {device}")
    prompts = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    l = prompts.shape[1]
    cache_len = cache_len or l + gen + 1
    t0 = _clock(device)
    logits, cache = model.prefill(params, cfg, prompts, cache_len=cache_len,
                                  backend=backend)
    t1 = _clock(device)
    all_logits = [logits]
    toks = [torch.argmax(logits, dim=-1)]
    step_ms = []
    for i in range(gen - 1):
        prev = toks[-1] if feed is None else feed[:, i]
        t = _clock(device)
        logits, cache = model.serve_step(params, cfg, cache, prev[:, None],
                                         l + i, backend=backend)
        toks.append(torch.argmax(logits, dim=-1))
        step_ms.append((_clock(device) - t) * 1e3)
        all_logits.append(logits)
    return Generation(torch.stack(toks, dim=1), all_logits, (t1 - t0) * 1e3,
                      step_ms)


def prompts_of(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The JAX package's prompts: (B, prompt_len) int64."""
    lm = MarkovLM(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    toks = lm.sample(rng, batch, prompt_len)[:, :-1]
    return torch.tensor(toks, dtype=torch.int64, device=device)


def main(argv=None) -> Generation:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chb-paper-lm-124m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="read and ignored, as in the JAX package: decoding "
                    "is greedy argmax")
    ap.add_argument("--seed", type=int, default=0,
                    help="the weights' PRNGKey seed (the JAX package's 0)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    full_f32()
    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if device.type == "cuda":       # compile the kernels before the clock
        for name in ("flash_attention", "decode_attention"):
            build.library(name)
    params = model.init_params(jrandom.PRNGKey(args.seed, device=device),
                               cfg)
    prompts = prompts_of(cfg, args.batch, args.prompt_len, device)
    out = generate(params, cfg, prompts, args.gen, device=device)
    wall = (out.prefill_ms + sum(out.step_ms)) / 1e3
    step = sum(out.step_ms) / max(len(out.step_ms), 1)
    print("generated:", out.tokens[:2].cpu().numpy())
    print(f"batch={args.batch} gen={args.gen} device={device} "
          f"prefill={out.prefill_ms:.2f}ms decode={step:.3f}ms/step "
          f"wall={wall:.2f}s ({args.batch * args.gen / wall:.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
