"""npz + JSON-manifest checkpoints of the port's state trees."""
from repro_torch.checkpoint.store import (latest_step, load_checkpoint,  # noqa: F401
                                          save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]
