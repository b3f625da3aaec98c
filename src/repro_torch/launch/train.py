"""CLI training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch chb-paper-lm-124m \
      --algorithm chb --steps 200 --global-batch 16 --seq-len 256 \
      [--device cuda|cpu] [--seed 0] [--backend cuda|reference]

The JAX launcher's flags, plus ``--device`` (default: the card; without
one it raises rather than fall back to the CPU), ``--seed`` (the weights'
PRNG key and the data's seed, ``TrainConfig.seed``) and ``--backend`` (the
kernels, or their plain versions). The params and the bank are in the
config's dtype, bf16 through B14 bf16, the bf16 flash backward and the
bf16 CHB step. ``--strategy pod``, ``--use-mesh`` and
``--pods`` above 1 (a mesh of devices) raise ``NotImplementedError``
(ROADMAP.md A13); ``--model-parallel`` acts only on a mesh, as in the JAX
launcher.
"""
from __future__ import annotations

import argparse

from ..configs import get
from ..train.trainer import MESH_TODO, TrainConfig, train


def main(argv=None):
    """Parse the flags, train, return ``train``'s (params, state, history)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chb-paper-lm-124m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny smoke variant of the arch")
    ap.add_argument("--algorithm", default="chb",
                    choices=["gd", "hb", "lag", "chb"])
    ap.add_argument("--strategy", default="scan", choices=["scan", "pod"])
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=3e-2)
    ap.add_argument("--beta", type=float, default=0.4)
    ap.add_argument("--eps1-scale", type=float, default=0.1)
    ap.add_argument("--quantize", default=None, choices=["int8"])
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--use-mesh", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "reference"],
                    help="the kernels, or their plain versions")
    args = ap.parse_args(argv)

    if args.strategy == "pod" or args.use_mesh or args.pods > 1:
        raise NotImplementedError(f"launch.train: {MESH_TODO}")
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(algorithm=args.algorithm, strategy=args.strategy,
                     num_workers=args.num_workers, alpha=args.alpha,
                     beta=args.beta, eps1_scale=args.eps1_scale,
                     quantize=args.quantize, global_batch=args.global_batch,
                     seq_len=args.seq_len, steps=args.steps,
                     ckpt_every=args.ckpt_every, seed=args.seed)
    return train(cfg, tc, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
