"""Small-scale runnable trainer for any architecture of the registry
(``configs.list_models()``).

The port of the reference's ``launch/train.py``: the ``reduced()`` variant
of ``--arch`` (the full config with ``--full-config``) trained on
synthetic Zipf tokens (``data.tokens.token_batches``, a numpy generator
seeded ``--seed``), with weights and a VLM's patch or whisper's frame
embeddings drawn from a ``torch.Generator`` seeded ``--seed`` on the
chosen device.  Every ``--ckpt-every`` steps the weights go to
``--ckpt-dir`` through ``checkpoint.store.save_checkpoint``, in the
reference's pytree layout (``convert.params_to_tree``), which the
reference's ``load_checkpoint`` reads.  A full config trains with its
``remat`` (on: each unit recomputed in the backward); a reduced one
without.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import get_config, list_models
from repro_torch.data.tokens import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_models())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (assigned) config, not reduced")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    step_fn, model, opt = make_train_step(cfg, lr=args.lr, device=dev,
                                          generator=gen)
    opt_state = opt.init(dict(model.named_parameters()))
    step = 0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M device={dev}")

    rng = np.random.default_rng(args.seed)
    batches = token_batches(rng, vocab=cfg.vocab_size, batch=args.batch,
                            seq_len=args.seq, n_batches=args.steps)
    n_embed = cfg.prefix_tokens or cfg.stub_frames
    for i, batch in enumerate(batches):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if n_embed:
            b["embeddings"] = torch.randn(
                (args.batch, n_embed, cfg.d_model), generator=gen,
                device=dev).to(cfg.compute_dtype)
        t0 = time.perf_counter()
        opt_state, step, metrics = step_fn(opt_state, step, b)
        loss = float(metrics["loss"])
        print(f"step {i:4d} loss {loss:.4f} "
              f"({time.perf_counter() - t0:.2f}s)")
        if not np.isfinite(loss):
            raise RuntimeError(f"step {i}: the loss diverged ({loss})")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            path = store.save_checkpoint(args.ckpt_dir, i + 1,
                                         convert.params_to_tree(model))
            print(f"  checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
