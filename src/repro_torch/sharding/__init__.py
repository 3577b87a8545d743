"""Logical-axis partition rules of the substrate (``rules``)."""
from repro_torch.sharding.rules import (MeshAxes, batch_axes, cache_spec,
                                        input_shardings, mesh_axes,
                                        model_dim, spec_for_param,
                                        tree_specs)

__all__ = ["MeshAxes", "batch_axes", "cache_spec", "input_shardings",
           "mesh_axes", "model_dim", "spec_for_param", "tree_specs"]
