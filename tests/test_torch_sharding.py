"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``), leaf by leaf.

Both read only a mesh's axis names and sizes, so a duck-typed mesh (the
reference's ``axis_names`` and ``devices.shape``) holds them at the
production shapes with no devices: every leaf of every config's params
in ``serve``, ``train`` and ``serve_dp``, and every decode-cache leaf
in ``tp`` and ``dp_cp``, at meshes (1,1), (4,4), (16,16) and (2,16,16).
Then the tests of ``tests/test_sharding.py`` on the port, and specs as
DTensor placements on a fake 16-rank ``DeviceMesh``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

torch = pytest.importorskip("torch")

from repro import sharding as ref  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.steps import \
    resolve_serve_strategy as ref_resolve  # noqa: E402
from repro.models import make_model as ref_model  # noqa: E402
from repro_torch import sharding as port  # noqa: E402
from repro_torch.checkpoint import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch.steps import resolve_serve_strategy  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.specs import TensorSpec  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x4": ((4, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()


def same(port_spec, ref_spec) -> bool:
    """A port spec (a tuple) equals a reference ``PartitionSpec`` as JAX
    compares specs (JAX spells a one-axis tuple ``("data",)`` as
    ``"data"``)."""
    return PartitionSpec(*port_spec) == ref_spec and \
        len(port_spec) == len(ref_spec)


def duck(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _ref_paths(arch):
    """The reference's key paths of ``arch``'s params, in its spelling."""
    shapes = jax.eval_shape(
        lambda: ref_model(ref_config(arch)).init(jax.random.PRNGKey(0)))
    return {ref.partitioning._path_str(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}


@pytest.fixture(scope="module")
def port_leaves():
    return {a: {k: tuple(s.shape) for k, s in flatten_with_paths(
        make_model(get_config(a), device="cpu").param_specs()).items()}
        for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_paths_name_the_same_leaves(arch, port_leaves):
    assert port_leaves[arch] == _ref_paths(arch)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_the_reference(arch, mesh, port_leaves):
    m = duck(mesh)
    specs = port.shard_params(make_model(get_config(arch), device="cpu")
                              .param_specs(), m, "train")
    flat = flatten_with_paths(specs)
    for path, shape in port_leaves[arch].items():
        for mode in ("serve", "train", "serve_dp"):
            want = ref.param_spec(path, shape, m, mode)
            assert same(port.param_spec(path, shape, m, mode), want), \
                (path, mode)
        assert same(flat[path].spec, ref.param_spec(path, shape, m,
                                                    "train")), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaf_spec_equals_the_reference(arch, mesh):
    m = duck(mesh)
    cfg = get_config(arch)
    model = make_model(cfg, device="cpu")
    n = 0
    for B, S in ((128, 32768), (1, 524288), (3, 1000)):
        specs = model.cache_specs(B, S)
        for strategy in ("tp", "dp_cp"):
            shardings = port.shard_cache_for_model(cfg, specs, m, B,
                                                   strategy)
            for si, (pattern, _) in enumerate(cfg.segments):
                for pi, kind in enumerate(pattern):
                    for name, leaf in specs[si][pi].items():
                        want = ref.cache_leaf_spec(
                            kind, name, leaf.shape, m, B, strategy)
                        assert same(port.cache_leaf_spec(
                            kind, name, leaf.shape, m, B, strategy), want)
                        assert same(shardings[si][pi][name].spec, want)
                        n += 1
    assert n > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_token_and_batch_specs(mesh):
    m = duck(mesh)
    for B in (1, 3, 32, 128, 256, 512):
        assert same(port.token_spec(m, B), ref.token_spec(m, B))
    assert port.batch_axes(m) == ref.batch_axes(m)


def test_reference_rule_cases():
    """``tests/test_sharding.py``'s cases, on the port."""
    m = duck("4x4")
    P = port.param_spec
    assert P("embed", (256000, 4608), m, "serve") == ("model", None)
    assert P("embed", (256000, 4608), m, "train") == ("model", "data")
    assert P("embed", (49155, 1024), m, "serve") == (None, None)
    assert P("seg0/[0]/mixer/wq", (23, 4608, 4096), m, "serve") == \
        (None, None, "model")
    assert P("seg0/[0]/ffn/wi", (4608, 36864), m, "train") == \
        ("data", "model")
    assert P("seg0/[0]/ffn/wi_e", (64, 2048, 1408), m, "serve") == \
        ("model", None, None)
    assert P("norm1/scale", (4608,), m, "serve") == (None,)
    assert P("seg0/[0]/mixer/wq", (23, 4608, 4096), m, "serve_dp") == \
        (None, None, None)
    C = port.cache_leaf_spec
    assert C("attn", "k", (23, 128, 32768, 16, 128), m, 128) == \
        (None, ("data",), None, "model", None)
    spec = C("attn", "k", (23, 1, 524288, 16, 128), m, 1)
    assert spec[1] is None and spec[2] in ("data", ("data",))
    assert C("attn", "k", (23, 128, 32768, 2, 64), m, 128,
             strategy="dp_cp") == (None, ("data",), "model", None, None)
    assert len(C("slstm", "n", (12, 2, 1024), m, 2)) == 3
    assert len(C("mlstm", "n", (12, 2, 4, 512), m, 2)) == 4
    assert port.token_spec(m, 128) == (("data",),)
    assert port.token_spec(m, 3) == (None,)


@pytest.mark.parametrize("arch,strategy,want", [
    ("qwen2-0.5b", None, "tp"), ("qwen2-0.5b", "auto", "dp_cp"),
    ("gemma2-27b", "auto", "tp"), ("granite-moe-1b-a400m", "auto", "tp"),
    ("xlstm-350m", "auto", "tp")])
def test_resolve_serve_strategy(arch, strategy, want):
    cfg, rcfg = get_config(arch), ref_config(arch)
    if strategy:
        cfg = dataclasses.replace(cfg, serve_strategy=strategy)
        rcfg = dataclasses.replace(rcfg, serve_strategy=strategy)
    assert resolve_serve_strategy(cfg) == ref_resolve(rcfg) == want


def test_specs_as_placements_on_a_fake_device_mesh():
    """A spec on a 16-rank ``DeviceMesh`` (the fake backend, one
    process): each named axis shards its tensor dim, an axis pair is two
    shards of one dim in mesh order, the rest replicate; a DTensor made
    from the spec holds this rank's shard."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 4),
                                mesh_dim_names=("pod", "data", "model"))
        sp = port.spec_placements
        assert sp(("model", ("pod", "data")), mesh) == \
            (Shard(1), Shard(1), Shard(0))
        assert sp((None, None), mesh) == (Replicate(),) * 3
        assert sp((None, ("data",), "model"), mesh) == \
            (Replicate(), Shard(1), Shard(2))
        spec = port.param_spec("embed", (1024, 64), mesh, "train")
        assert spec == ("model", ("pod", "data"))
        leaf = TensorSpec((1024, 64), torch.float32,
                          sharding=port.NamedSharding(mesh, spec))
        t = port.distribute_specs(leaf, "cpu")
        assert tuple(t.shape) == (1024, 64)
        assert tuple(t.to_local().shape) == (256, 16)
        assert t.placements == (Shard(1), Shard(1), Shard(0))
        # the pod-major order of ("pod", "data") is JAX's
        assert port.spec_placements(spec, mesh)[0] == Shard(1)
    finally:
        dist.destroy_process_group()
