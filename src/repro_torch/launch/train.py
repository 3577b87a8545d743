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
reference's ``load_checkpoint`` reads, and both Adam moments, in the
same layout (``convert.opt_state_to_numpy``'s), under ``--ckpt-dir``'s
``adam/`` (written first, so a step whose weights are complete has its
moments); ``--resume DIR`` starts from the latest of them: the weights,
the moments and the step, the run an uninterrupted one would have been
(a checkpoint without moments, such as the reference's trainer writes,
starts them and Adam's step count at zero).  A full config trains with
its ``remat`` (on: each unit recomputed in the backward); a reduced one
without.

``--mesh DxM`` under ``torchrun`` (D·M processes) trains across a ``data
x model`` mesh (``launch.mesh.make_host_mesh``) with the training
placement: each rank holds ``spec_for_param(..., fsdp=True)``'s block of
every weight and both moments, draws the same batches and runs its rows
of each (``steps.make_train_step(mesh=)``); every rank prints the same
loss, and rank 0 writes the checkpoint of the weights gathered whole --
the files an unsharded run writes.  ``--resume`` on a mesh places the
checkpoint's weights and moments.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --device cpu
  PYTHONPATH=src torchrun --nproc_per_node=4 -m repro_torch.launch.train \
      --arch qwen3-8b --mesh 2x2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import get_config, list_models
from repro_torch.data.tokens import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model


def parse_mesh(text: str):
    """``"DxM"`` -> (D, M)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM (e.g. 2x2), not {text!r}")
    return d, m


# the subdirectory of a checkpoint directory that holds the Adam moments
ADAM_DIR = "adam"


def _resumed(cfg, directory: str, device, mesh):
    """The model holding the weights of ``directory``'s latest checkpoint
    (this rank's blocks on a mesh, placed for training), its step, and
    that step's Adam moments in the reference's layout with numpy leaves
    (None where the checkpoint has none)."""
    def template(node):
        if isinstance(node, dict):
            return {k: template(v) for k, v in node.items()}
        return torch.empty(0)
    whole = template(convert.params_to_tree(build_model(cfg, device="meta")))
    tree, step, _ = store.load_checkpoint(directory, whole)
    model = convert.params_from_numpy(convert.host_tree(tree), cfg,
                                      device=device, mesh=mesh, fsdp=True)
    adam = os.path.join(directory, ADAM_DIR)
    moments = None
    if os.path.exists(os.path.join(adam, f"step_{step}.npz")):
        moments, _, _ = store.load_checkpoint(
            adam, {"m": whole, "v": whole}, step=step)
        moments = convert.host_tree(moments)
    return model, step, moments


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
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="start from the latest checkpoint in DIR")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train across a data x model mesh of D·M ranks "
                         "(under torchrun), FSDP over data")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu' (the kernels' plain versions; gloo ranks "
                         "with --mesh)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    mesh, who = None, ""
    if args.mesh:
        n_data, n_model = parse_mesh(args.mesh)
        mesh = make_host_mesh(model=n_model, device=args.device)
        if mesh.shape["data"] != n_data:
            raise ValueError(f"--mesh {args.mesh} needs {n_data * n_model} "
                             f"processes; there are {mesh.size}")
        dev = mesh.device
        if mesh.size > 1:
            who = f"[rank {mesh.coords['data']},{mesh.coords['model']}] "
    else:
        dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    start, model, moments = 0, None, None
    if args.resume:
        model, start, moments = _resumed(cfg, args.resume, dev, mesh)
    step_fn, model, opt = make_train_step(cfg, lr=args.lr, device=dev,
                                          generator=gen, model=model,
                                          mesh=mesh)
    opt_state = opt.init(dict(model.named_parameters()))
    # Adam's step count: the batches' index, unless the moments restart
    step = start
    resumed = ""
    if args.resume:
        resumed = f" resumed at step {start}"
        if moments is None:
            step = 0
            resumed += " (no Adam moments: they and Adam's count restart)"
        else:
            convert.opt_state_from_numpy(model, moments, opt_state)
        del moments
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{who}arch={cfg.name} params={n_params / 1e6:.2f}M "
          f"device={dev}{f' mesh={args.mesh}' if mesh else ''}{resumed}")

    rng = np.random.default_rng(args.seed)
    batches = token_batches(rng, vocab=cfg.vocab_size, batch=args.batch,
                            seq_len=args.seq, n_batches=start + args.steps)
    n_embed = cfg.prefix_tokens or cfg.stub_frames
    writer = mesh is None or (mesh.coords["data"], mesh.coords["model"]) \
        == (0, 0)
    for i, batch in enumerate(batches):
        if i < start:
            continue
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if n_embed:
            b["embeddings"] = torch.randn(
                (args.batch, n_embed, cfg.d_model), generator=gen,
                device=dev).to(cfg.compute_dtype)
        t0 = time.perf_counter()
        opt_state, step, metrics = step_fn(opt_state, step, b)
        loss = float(metrics["loss"])
        print(f"{who}step {i:4d} loss {loss:.4f} "
              f"({time.perf_counter() - t0:.2f}s)")
        if not np.isfinite(loss):
            raise RuntimeError(f"step {i}: the loss diverged ({loss})")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            # every rank gathers; the moments go first
            moments = {k: convert.params_to_tree(model, opt_state[k])
                       for k in ("m", "v")}
            if writer:
                store.save_checkpoint(os.path.join(args.ckpt_dir, ADAM_DIR),
                                      i + 1, moments)
            del moments
            tree = convert.params_to_tree(model)
            if writer:
                path = store.save_checkpoint(args.ckpt_dir, i + 1, tree)
                print(f"  checkpoint -> {path}")
            del tree
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
