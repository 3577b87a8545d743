"""Batched decode server simulation for a ported architecture.

Prefill a batch of prompts token by token into the decode caches
(reduced config), then decode greedily with ``serve_step`` -- the port of
the reference's ``launch/serve.py``.  Weights, prompts and a VLM's stub
patch embeddings come from a seeded ``torch.Generator`` on the chosen
device.  A VLM (``prefix_tokens`` > 0) first runs its patch embeddings
through ``Transformer.prefill_prefix`` and feeds the prompt from index P
(the reference's server feeds the prompt from 0 with no prefix).  An
encoder-decoder (whisper) does what the reference's server does: a cache
for ``stub_frames`` frames, seeded stub frames through
``EncDecTransformer.prefill_cross``, then the prompt from index 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --device cpu

Across ranks, one process a card (or gloo ranks on the CPU), on the
``("data", "model")`` mesh of ``launch.mesh.make_host_mesh(model=M)``:

  PYTHONPATH=src torchrun --nproc_per_node=4 -m repro_torch.launch.serve \
      --arch yi-34b --mesh 1x4 [--full-config --layers 8] [--device cpu]

``--mesh DxM`` must multiply to the processes; every rank draws the same
weights and keeps its blocks, and rank 0 prints.  ``--full-config``
serves the published widths (``--layers`` cuts the depth) instead of the
reduced config.

``--arch`` takes any architecture of ``configs.list_models()`` (the
registry but ``hfl-mnist``, the HFL simulation's config):
recurrentgemma-9b, grok-1-314b, paligemma-3b, xlstm-125m, stablelm-1.6b,
qwen1.5-110b, qwen3-8b, qwen3-8b-sw4k, llama4-maverick-400b-a17b,
yi-34b, whisper-large-v3.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_models
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import Model, make_serve_step


@torch.no_grad()
def prefill_into_cache(model: Model, tokens: torch.Tensor, cache: dict,
                       start: int = 0):
    """Feed prompt tokens one decode step at a time from index ``start``
    (the functional reference prefill; a VLM's text starts after its
    prefix), with ``prefix_len`` the config's ``prefix_tokens``.  Returns
    the last step's logits and the cache."""
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(
            tokens[:, i:i + 1], cache, start + i,
            prefix_len=model.cfg.prefix_tokens)
    return logits, cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_models())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu' (the kernels' plain versions)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve across a data x model mesh of D·M "
                         "processes (under torchrun)")
    ap.add_argument("--full-config", action="store_true",
                    help="the published widths instead of the reduced "
                         "config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    cfg = cfg if args.full_config else cfg.reduced()
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    mesh = None
    if args.mesh:
        n_data, n_model = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_host_mesh(model=n_model, device=args.device)
        if mesh.size != n_data * n_model:
            raise SystemExit(f"--mesh {args.mesh} needs {n_data * n_model} "
                             f"processes, there are {mesh.size}")
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    serve_step, model = make_serve_step(cfg, device=dev, generator=gen,
                                        mesh=mesh)
    start = cfg.prefix_tokens
    if cfg.encoder_layers:
        cache = model.init_cache(args.batch, args.cache_len, cfg.stub_frames)
        frames = torch.randn((args.batch, cfg.stub_frames, cfg.d_model),
                             generator=gen, device=dev).to(cfg.compute_dtype)
        with torch.no_grad():
            cache = model.prefill_cross(cache, frames)
    else:
        cache = model.init_cache(args.batch, args.cache_len)
    if start:
        patches = torch.randn((args.batch, start, cfg.d_model),
                              generator=gen, device=dev)
        with torch.no_grad():
            cache = model.prefill_prefix(cache, patches)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    _, cache = prefill_into_cache(model, prompt, cache, start)

    tok = prompt[:, -1:]
    out = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.tokens):
        tok, cache = serve_step(tok, cache, start + args.prompt_len + i)
        out.append(tok[:, 0])
    gen_tokens = torch.stack(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    if mesh is None or mesh.coords == {"data": 0, "model": 0}:
        where = "" if mesh is None else f" mesh={args.mesh}"
        print(f"arch={cfg.name} device={dev}{where} batch={args.batch} "
              f"generated {gen_tokens.shape[1]} tokens/seq in {dt:.2f}s "
              f"({args.tokens * args.batch / dt:.1f} tok/s)")
        print("sample:", gen_tokens[0][:16].tolist())
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()):
        raise RuntimeError("generated tokens outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
