"""The declarative sweep runner (the reference's ``repro.sweeps``)."""
from repro_torch.sweeps.grid import (SweepCell, SweepGrid, expand_grid,
                                     run_sweep, summarize)

__all__ = ["SweepCell", "SweepGrid", "expand_grid", "run_sweep", "summarize"]
