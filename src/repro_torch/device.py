"""Device selection for the port's entry points.

The default is the GPU: ``resolve_device()`` raises when no CUDA device is
present instead of quietly running on the CPU.  The CPU is used only when
the caller asks for it (``device="cpu"``), as the tests do; there every
kernel wrapper runs its plain PyTorch version.  ``"meta"`` builds a model
of shapes alone, allocating nothing (the partition rules read it).

On the GPU, TF32 is switched off for matmul and cuDNN: TF32 keeps about
three decimal digits, and the port is held to the float32 reference.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device='cuda' was requested but no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' (or builds "
                         f"shapes on 'meta'), got {dev}")
    return dev
