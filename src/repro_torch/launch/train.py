"""Training launcher (the reference ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch trail-llama \
        --steps 200 --batch 8 --seq 256 [--smoke] [--ckpt out.npz] \
        [--device cuda]

Trains the chosen architecture's LM on the synthetic instruction data
from float32 master weights drawn from ``--seed``, printing one JSON line
per logged step, and with ``--ckpt`` writes ``{"params": ...}`` in the
reference's ``.npz`` format, which the reference's ``restore`` reads back
into the tree of its ``Model.init``. Runs on the card unless ``--device
cpu`` is given. ``main(argv)`` runs in-process and returns the model with
the trained weights loaded, the masters and the history.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.config import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.model import Model, params_to_jax
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.checkpoint import save
from repro_torch.training.data import DataConfig, batches
from repro_torch.training.train import train_lm


def main(argv=None):
    """CLI entry: train the chosen arch and optionally save a checkpoint.
    Returns (model, params, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="trail-llama",
                    choices=ARCH_IDS + ("trail-llama",))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init_params(args.seed)
    dc = DataConfig(vocab=cfg.vocab_size, seq_len=args.seq, batch=args.batch,
                    max_out=min(448, args.seq - 64), seed=args.seed)
    ocfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10,
                               total_steps=args.steps)
    params, _, hist = train_lm(
        model, params, batches(dc, args.steps), ocfg, args.steps,
        callback=lambda r: print(json.dumps(r), flush=True))
    model.load_state_dict(params)
    if args.ckpt:
        save(args.ckpt, {"params": params_to_jax(cfg, params), "config": {}})
        print(f"saved {args.ckpt}", flush=True)
    return model, params, hist


if __name__ == "__main__":
    main()
