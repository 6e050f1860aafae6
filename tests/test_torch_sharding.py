"""The port's sharding rules and spec builders against the reference's.

Every case of ``tests/test_sharding.py`` against ``repro_torch.sharding.
rules``; then, for the ten architectures and Qwen3 with the int8 KV cache,
over stand-in meshes of (16, 16), (2, 16, 16), (2, 2) and (4, 2), the
port's ``param_shardings`` / ``opt_shardings`` / ``batch_specs`` (train,
prefill, decode) / ``cache_specs`` leaf by leaf against the reference's
builders on the same shapes: shape, dtype name, spec.  The reference's
builders wrap their specs in ``NamedSharding``, which needs devices; the
tests hand them a struct that keeps the spec instead (``_RefStruct``)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest

import repro.launch.steps as ref_steps
from repro import models as ref_models
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models.config import LM_SHAPES as REF_SHAPES
from repro.sharding.rules import spec_tree as ref_spec_tree
from repro_torch.configs import get_config
from repro_torch.core.util import tree_leaves
from repro_torch.launch import steps
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,
                                     mesh_context)
from repro_torch.models import LM_SHAPES, Transformer
from repro_torch.sharding.layout import (device_coords, shard_of,
                                         shard_params_from_reference, unshard)
from repro_torch.sharding.rules import (PartitionSpec, constrain,
                                        logical_to_spec, spec_tree)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESH1 = FakeMesh({"data": 16, "model": 16})
MESHES = {"16x16": MESH1, "2x16x16": MESH,
          "2x2": FakeMesh({"data": 2, "model": 2}),
          "4x2": FakeMesh({"data": 4, "model": 2})}
#: the ten architectures, and Qwen3 with the int8 KV cache (k_scale /
#: v_scale cache leaves)
CONFIGS = [(a, {}) for a in REF_ARCHS] + [("qwen3_1_7b",
                                           {"kv_cache_dtype": "int8"})]
CONFIG_IDS = [a + ("-int8" if kw else "") for a, kw in CONFIGS]


# ---------------------------------------------------------------------------
# the rules: every case of tests/test_sharding.py
# ---------------------------------------------------------------------------

def test_basic_rules():
    assert logical_to_spec((4096, 24576), ("fsdp", "ff"), MESH1) == \
        PartitionSpec("data", "model")
    assert logical_to_spec((49152, 6144), ("vocab", "fsdp"), MESH1) == \
        PartitionSpec("model", "data")


def test_divisibility_fallback():
    spec = logical_to_spec((8, 4096, 14336), ("experts", "fsdp", "ff"), MESH1)
    assert spec == PartitionSpec(None, "data", "model")
    spec = logical_to_spec((64, 2048, 1408), ("experts", "fsdp", "ff"), MESH1)
    assert spec == PartitionSpec("model", "data", None)


def test_multi_axis_fsdp_prefix():
    assert logical_to_spec((2048,), ("fsdp",), MESH) == \
        PartitionSpec(("pod", "data"))
    assert logical_to_spec((48,), ("fsdp",), MESH) == PartitionSpec("pod")
    assert logical_to_spec((47,), ("fsdp",), MESH) == PartitionSpec(None)


def test_axis_never_reused():
    spec = logical_to_spec((16, 16), ("heads", "kv_heads"), MESH1)
    assert spec == PartitionSpec("model", None)


def test_spec_tree_parallel_structure():
    params = {"a": np.zeros((32, 64)), "b": [np.zeros((16,))]}
    logical = {"a": ("fsdp", "ff"), "b": [("heads",)]}
    tree = spec_tree(logical, params, MESH1)
    assert tree["a"] == PartitionSpec("data", "model")
    assert tree["b"][0] == PartitionSpec("model")


def test_constrain_checks_the_block():
    """No mesh: x itself; on a mesh, the block of the spec or a raise."""
    x = np.zeros((4, 8, 64))
    assert constrain(x, None, "batch", None, None) is x
    assert constrain(x, MESH1, "batch", None, None) is x
    assert constrain(x, MESH1, "batch", None, None, shape=(64, 8, 64)) is x
    # 4 rows do not split 16 ways: the block is the whole array
    assert constrain(x, MESH1, "batch", None, None, shape=(4, 8, 64)) is x
    with pytest.raises(ValueError, match="not the block"):
        constrain(x, MESH1, "batch", None, None, shape=(32, 8, 64))
    with pytest.raises(ValueError, match="not the block"):
        constrain(x, MESH1, "batch", None, None, shape=(48, 8, 64))


# ---------------------------------------------------------------------------
# layouts: blocks out and back, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model")),
                                        ((4, 1), ("data", "model"))])
def test_shard_of_and_unshard_are_exact(shape, axes):
    mesh = make_mesh(shape, axes, device="cpu")
    full = np.arange(8 * 12 * 4, dtype=np.float32).reshape(8, 12, 4)
    for spec in (PartitionSpec(None, "model", None),
                 PartitionSpec(tuple(a for a in axes if a != "model"),
                               "model"),
                 PartitionSpec("model", None, axes[0]), PartitionSpec()):
        spec = PartitionSpec(*(e for e in spec))
        blocks = [shard_of(full, spec, mesh, c) for c in device_coords(mesh)]
        assert all(b.shape == blocks[0].shape for b in blocks)
        np.testing.assert_array_equal(unshard(blocks, spec, mesh), full)
    coords = device_coords(mesh)
    assert [mesh.coords(r) for r in range(mesh.size)] == coords


def test_meshes_describe_and_launch_by_rule():
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    two = make_production_mesh(multi_pod=True)
    assert two.axis_names == ("pod", "data", "model") and two.size == 512
    for m in (mesh, two):
        with pytest.raises(RuntimeError, match="does not launch"):
            m.grid()
    with mesh_context(mesh) as m:
        assert m is mesh
    with pytest.raises(ValueError, match="in that order"):
        Mesh((2, 2), ("model", "data"))
    assert make_mesh((2, 2), ("data", "model"), device="cpu").batch_size == 2


def test_shard_params_from_reference_blocks():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tree = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
            "b": [np.ones(4, np.float32)]}
    specs = {"w": PartitionSpec("data", "model"), "b": [PartitionSpec()]}
    got = shard_params_from_reference(tree, mesh, specs,
                                      mesh.coords(3), device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"][2:, 2:])
    np.testing.assert_array_equal(got["b"][0].numpy(), tree["b"][0])


# ---------------------------------------------------------------------------
# the spec builders against the reference's, every config and mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _RefStruct:
    shape: tuple
    dtype: object
    sharding: object = None


@pytest.fixture
def ref_structs(monkeypatch):
    """The reference's builders with their shardings kept as specs."""
    monkeypatch.setattr(ref_steps, "_named", lambda mesh, spec: spec)
    monkeypatch.setattr(ref_steps.jax, "ShapeDtypeStruct", _RefStruct)


def _norm(spec, ndim):
    """A spec as a tuple of ndim tuples of axis names."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if not isinstance(dt, np.dtype) \
        else dt.name


def _same(port, ref, what):
    """Port struct tree against reference struct leaves, leaf by leaf."""
    pl = tree_leaves(port)
    rflat = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, _RefStruct))[0]
    assert len(pl) == len(rflat), what
    for g, (path, w) in zip(pl, rflat):
        where = f"{what} {jax.tree_util.keystr(path)}"
        assert tuple(g.shape) == tuple(w.shape), where
        assert _dtype_name(g.dtype) == np.dtype(w.dtype).name, where
        assert _norm(g.sharding.spec, len(g.shape)) == \
            _norm(w.sharding, len(w.shape)), where


@functools.lru_cache(maxsize=None)
def _ref_model(arch, kw):
    return ref_models.Transformer(dataclasses.replace(
        ref_get_config(arch), **dict(kw)))


@functools.lru_cache(maxsize=None)
def _ref_init(arch, kw):
    """The reference's (param shapes, logical tree) -- abstract."""
    model = _ref_model(arch, kw)
    got = {}

    def only(k):
        p, lg = model.init(k)
        got["logical"] = lg
        return p
    shapes = jax.eval_shape(only, jax.random.PRNGKey(0))
    return shapes, got["logical"]


def _port_model(arch, kw, mesh):
    return Transformer(dataclasses.replace(get_config(arch), **dict(kw)),
                       device="meta", mesh=mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,kw", CONFIGS, ids=CONFIG_IDS)
def test_param_and_opt_shardings_match_reference(arch, kw, mesh_name):
    mesh = MESHES[mesh_name]
    kw = tuple(kw.items())
    shapes, logical = _ref_init(arch, kw)
    ref_specs = ref_spec_tree(logical, shapes, mesh)
    ref_params = jax.tree.map(
        lambda s, sp: _RefStruct(s.shape, s.dtype, sp), shapes, ref_specs)
    structs, plogical, pspecs = steps.param_shardings(
        _port_model(arch, kw, mesh), mesh)
    _same(structs, ref_params, "param")
    assert jax.tree.structure(plogical, is_leaf=lambda x: isinstance(
        x, tuple)) == jax.tree.structure(logical, is_leaf=lambda x:
                                         isinstance(x, tuple))
    opt = steps.opt_shardings(structs, mesh, pspecs)
    _same(opt["mu"], ref_params, "mu")
    _same(opt["nu"], ref_params, "nu")
    assert opt["count"].shape == () and opt["count"].spec == PartitionSpec()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,kw", CONFIGS, ids=CONFIG_IDS)
def test_batch_specs_match_reference(arch, kw, mesh_name, ref_structs):
    mesh = MESHES[mesh_name]
    rcfg = dataclasses.replace(ref_get_config(arch), **kw)
    cfg = dataclasses.replace(get_config(arch), **kw)
    for rshape, shape in zip(REF_SHAPES, LM_SHAPES):
        want = ref_steps.batch_specs(rcfg, rshape, mesh)
        got = steps.batch_specs(cfg, shape, mesh)
        assert list(got) == list(want)
        _same([got[k] for k in want], [want[k] for k in want],
              f"batch {shape.name}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,kw", CONFIGS, ids=CONFIG_IDS)
def test_cache_specs_match_reference(arch, kw, mesh_name, ref_structs):
    mesh = MESHES[mesh_name]
    kw_t = tuple(kw.items())
    model = _port_model(arch, kw_t, mesh)
    assert steps._cache_logical(model, mesh) == ref_steps._cache_logical(
        _ref_model(arch, kw_t), mesh)
    for rshape, shape in zip(REF_SHAPES, LM_SHAPES):
        if shape.kind != "decode":
            continue
        want = ref_steps.cache_specs(_ref_model(arch, kw_t), rshape, mesh)
        got = steps.cache_specs(model, shape, mesh)
        _same(got, want, f"cache {shape.name}")


def test_input_specs_assemble_every_cell():
    mesh = make_production_mesh(multi_pod=True)
    cfg = get_config("qwen3-1.7b")
    for shape in LM_SHAPES:
        cell = steps.input_specs(cfg, shape, mesh)
        assert cell.kind == shape.kind and callable(cell.fn)
        assert (cell.opt is not None) == (shape.kind == "train")
        assert (cell.cache is not None) == (shape.kind == "decode")
        emb = cell.params["embed"]
        assert emb.local_shape == (151936 // 16, 2048 // 32)
