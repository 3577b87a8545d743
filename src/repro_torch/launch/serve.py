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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    serve_step, model = make_serve_step(cfg, device=dev, generator=gen)
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
    print(f"arch={cfg.name} device={dev} batch={args.batch} generated "
          f"{gen_tokens.shape[1]} tokens/seq in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s)")
    print("sample:", gen_tokens[0][:16].tolist())
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()):
        raise RuntimeError("generated tokens outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
