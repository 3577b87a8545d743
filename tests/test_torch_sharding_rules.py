"""The port's partition rules (``repro_torch.sharding``) held to the
reference's (``repro.sharding.rules``) leaf for leaf.

For every architecture of the registry, at full size and reduced, the
port's model is built on the ``meta`` device (shapes alone) and each
parameter's placement by ``spec_for_param`` -- FSDP on and off -- is
compared with the reference's ``PartitionSpec`` for the same name and
shape, on stand-in meshes of 16 x 16, 2 x 16 x 16 (with a pod axis), 1 x
4, 2 x 2, 4 x 1 and 1 x 3: only ``axis_names`` and ``shape`` are read,
so no process is needed.  A placement depends on a leaf's last name and
its shape alone, so each distinct (name, shape) pair of a model is
compared once.  The comparison is made on the canonical (unstacked)
leaf, the one the reference's rule table is written for: the port's
parameters are unstacked, one a layer.  ``cache_spec`` is compared for
every leaf of the port's ``init_cache(..., device="meta")``,
``batch_axes`` for batches 1, 2, 4 and 256, and ``input_shardings`` for
every (architecture, input shape) pair of ``configs.input_specs``
against the reference's on an ``AbstractMesh``.  The reference's own
cases (``tests/test_sharding_roofline.py``) run through the port too.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.sharding import rules as jrules
from repro_torch import convert
from repro_torch.configs import INPUT_SHAPES, get_config, input_specs, \
    list_models
from repro_torch.models import build_model
from repro_torch.models import encdec, transformer
from repro_torch.sharding import (batch_axes, cache_spec, input_shardings,
                                  model_dim, spec_for_param, tree_specs)


class FakeMesh:
    """Only ``axis_names`` and ``shape`` are read."""

    def __init__(self, shape_map):
        self.axis_names = tuple(shape_map)
        self.shape = dict(shape_map)


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "1x4": {"data": 1, "model": 4},
    "2x2": {"data": 2, "model": 2},
    "4x1": {"data": 4, "model": 1},
    "1x3": {"data": 1, "model": 3},
}
MESH = FakeMesh(MESHES["16x16"])
POD = FakeMesh(MESHES["2x16x16"])
SIZES = ("full", "reduced")


def _cfgs(arch, size):
    port, ref = get_config(arch), jget_config(arch)
    return (port, ref) if size == "full" else (port.reduced(), ref.reduced())


def _abstract(shape_map):
    return AbstractMesh(tuple(shape_map.values()), tuple(shape_map))


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", list_models())
def test_param_specs_match_reference(arch, size):
    cfg, _ = _cfgs(arch, size)
    model = build_model(cfg, device="meta")
    leaves = {}
    for name, p in model.named_parameters():
        leaves.setdefault((name.rsplit(".", 1)[-1], tuple(p.shape)), name)
    split = 0
    for key, shape_map in MESHES.items():
        mesh = FakeMesh(shape_map)
        for fsdp in (True, False):
            specs = tree_specs(model, mesh, fsdp=fsdp)
            assert len(specs) == len(list(model.parameters()))
            for (leaf, shape), name in leaves.items():
                want = _spec(jrules.spec_for_param(leaf, shape, mesh,
                                                   fsdp=fsdp))
                got = spec_for_param(leaf, shape, mesh, fsdp=fsdp)
                assert got == want, (key, fsdp, name, shape)
                assert specs[name] == want, (key, fsdp, name)
                split += model_dim(got) is not None
    assert split > 0


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", list_models())
def test_cache_and_input_specs_match_reference(arch, size):
    """Every cache leaf's ``cache_spec`` and every input's placement by
    ``input_shardings``, for each input shape the architecture takes."""
    cfg, jcfg = _cfgs(arch, size)
    b, s = (4, 64) if size == "reduced" else (8, 32_768)
    if cfg.encoder_layers:
        cache = encdec.init_cache(cfg, b, s, cfg.stub_frames, "meta")
    else:
        cache = transformer.init_cache(cfg, b, s, "meta")
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(tuple(v.shape))
    walk(cache)
    for shape_map in MESHES.values():
        mesh = FakeMesh(shape_map)
        for batch in (None, ("data",), ("pod", "data")):
            if batch == ("pod", "data") and "pod" not in shape_map:
                continue
            for shape in leaves:
                assert cache_spec(shape, mesh, batch) == _spec(
                    jrules.cache_spec(shape, mesh, batch)), (shape_map,
                                                             shape)
    for name, shape in INPUT_SHAPES.items():
        specs = input_specs(cfg, shape)
        jspecs = jinput_specs(jcfg, JINPUT_SHAPES[name])
        for shape_map in MESHES.values():
            got = input_shardings(specs, FakeMesh(shape_map),
                                  shape.global_batch)
            want = jax.tree.map(
                lambda sh: _spec(sh.spec),
                jrules.input_shardings(jspecs, _abstract(shape_map),
                                       shape.global_batch),
                is_leaf=lambda x: isinstance(x, NamedSharding))
            if "cache" in want:
                want["cache"] = _port_cache_layout(cfg, want["cache"])
            assert got == want, (name, shape_map)


def _port_cache_layout(cfg, tree):
    """The reference's cache tree in the port's layout: an xLSTM block's
    tuple of leaves as the port's named leaves."""
    if cfg.encoder_layers:
        return tree
    pat = tuple(zip(cfg.block_pattern, cfg.ffn_pattern))
    out = {}
    for si, (unit, _) in enumerate(transformer.compute_stages(cfg.n_layers,
                                                              pat)):
        stage = {}
        for i, (kind, _) in enumerate(unit):
            leaves = tree[f"stage_{si}"][str(i)]
            if kind in convert._TUPLE_CACHE:
                leaves = dict(zip(convert._TUPLE_CACHE[kind], leaves))
            stage[str(i)] = leaves
        out[f"stage_{si}"] = stage
    return out


@pytest.mark.parametrize("batch", (1, 2, 4, 256))
def test_batch_axes_match_reference(batch):
    for shape_map in MESHES.values():
        mesh = FakeMesh(shape_map)
        assert batch_axes(mesh, batch) == jrules.batch_axes(mesh, batch)


# -- the reference's own cases (tests/test_sharding_roofline.py) ------------

def test_attention_rules():
    assert spec_for_param("wq", (4096, 32, 128), MESH) \
        == ("data", "model", None)
    assert spec_for_param("wk", (4096, 8, 128), MESH) == (None, None, "data")
    assert spec_for_param("wk", (2048, 1, 256), MESH) == (None, None, "data")
    assert spec_for_param("wo", (32, 128, 4096), MESH) \
        == ("model", None, "data")
    assert spec_for_param("wq", (7168, 56, 128), MESH) \
        == (None, None, "data")


def test_stacked_leading_axis_untouched():
    assert spec_for_param("wq", (12, 4096, 32, 128), MESH) \
        == (None, "data", "model", None)


def test_mlp_and_moe_rules():
    assert spec_for_param("w_in", (4096, 12288), MESH) == ("data", "model")
    assert spec_for_param("w_out", (12288, 4096), MESH) == ("model", "data")
    assert spec_for_param("w_in", (128, 5120, 8192), MESH) \
        == ("model", "data", None)
    assert spec_for_param("w_in", (8, 6144, 32768), MESH) \
        == (None, "data", "model")


def test_embedding_fallback():
    assert spec_for_param("embedding", (51866, 1280), MESH) \
        == (None, "model")
    assert spec_for_param("embedding", (151936, 4096), MESH) \
        == ("model", None)


def test_vectors_replicated():
    assert spec_for_param("scale", (4096,), MESH) == (None,)
    assert spec_for_param("b_gates", (3072,), MESH) == (None,)


def test_batch_axes():
    assert batch_axes(MESH, 256) == ("data",)
    assert batch_axes(MESH, 1) is None
    assert batch_axes(POD, 256) == ("pod", "data")
    assert batch_axes(POD, 2) == ("pod",)


def test_cache_spec():
    assert cache_spec((36, 128, 32768, 8, 128), MESH, ("data",)) \
        == (None, "data", "model", None, None)
    assert cache_spec((36, 1, 524288, 8, 128), MESH, None) \
        == (None, None, "model", None, None)
    assert cache_spec((12, 32, 4096), MESH, ("data",)) \
        == (None, "data", "model")


def test_tree_specs_cover_every_leaf():
    model = build_model(get_config("qwen3-8b").reduced(), device="meta")
    specs = tree_specs(model, MESH)
    assert list(specs) == [n for n, _ in model.named_parameters()]
    assert all(len(s) == p.dim() for s, (_, p) in
               zip(specs.values(), model.named_parameters()))
    assert model_dim(("data", "model", None)) == 1
    assert model_dim((("pod", "data"), None)) is None
    assert model_dim(P(None, "model")) == 1
