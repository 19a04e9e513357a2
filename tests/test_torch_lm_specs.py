"""ParamSpecs with logical axes and the spec helpers, against the
reference's (`repro.nn.params`), with no ranks: every arch's
`lm_param_specs` and the DLRM's `dlrm_param_specs` (shapes, logical axes,
init rules), `specs_to_pspecs` under the four rule tables over meshes given
as `SimpleNamespace(axis_names, shape)` (the production (16, 16) and
(2, 16, 16), and a (2, 4)), `stack_specs`, `cast_specs`, `param_bytes`,
`abstract_params` on the meta device; and that the logical axes moved no
bit: `init_params` and the one-device LM step give the bits they gave
before the axes existed, recorded from that tree with one CPU thread.

Tolerances: none; every comparison is exact.
"""
import dataclasses
import hashlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core.dlrm import dlrm_param_specs as jdlrm_specs
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.models.lm import lm_param_specs as jlm_specs
from repro.nn import params as jparams
from repro.nn import sharding as jsharding
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core.dlrm import dlrm_param_specs, init_dlrm_params
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.models.lm import init_lm_params, lm_param_specs
from repro_torch.nn import params, sharding
from repro_torch.nn.params import ParamSpec, tree_leaves
from repro_torch.optim import adamw
from repro_torch.train.steps import build_lm_train_step

TABLES = ["TRAIN_RULES", "FSDP_RULES", "ZERO_DP_RULES", "SERVE_RULES"]
MESHES = [(("data", "model"), (2, 4)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
DLRMS = ["dlrm-m1", "dlrm-m2", "dlrm-m3"]

#: sha256 prefixes of the leaves' bytes, taken on the tree before the
#: specs had logical axes (one CPU thread): init_params at seed 3 of each
#: smoke config, and two steps of build_lm_train_step (accum_steps 2; bf16
#: compute with bf16 gradients) from seed 0: losses, parameters, moments
BEFORE = {
    "init stablelm-1.6b": "bea3e0962c88280e",
    "init granite-moe-1b-a400m": "a1a6716943c2fcf4",
    "init mamba2-780m": "d97be3b76621fe2d",
    "init jamba-v0.1-52b": "6443cf809436945f",
    "init musicgen-large": "8195d3a66e9f58e8",
    "init internvl2-26b": "1c90d14f155b0cb1",
    "init dlrm-m1": "79559fb17f8dcc9b",
    "step stablelm-1.6b float32": "bd6cf2cae3979ff1",
    "step stablelm-1.6b bfloat16": "ee32eeb28f8cd4e0",
    "step granite-moe-1b-a400m float32": "8b9ee86c9625eab7",
    "step granite-moe-1b-a400m bfloat16": "b22d854a454edfc2",
    "step mamba2-780m float32": "31095d832984a366",
    "step mamba2-780m bfloat16": "fd9cf930c711e6cc",
}


def _walk(tree, path=()):
    """(path, leaf) pairs of a dict / list tree of specs, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _walk(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not (
            tree and all(isinstance(e, (str, type(None))) for e in tree)):
        return [x for i, v in enumerate(tree) for x in _walk(v, path + (i,))]
    return [(path, tree)]


def _fields(spec) -> tuple:
    return (tuple(spec.shape), tuple(spec.logical_axes), spec.init,
            spec.scale, spec.fan_axis)


def _same_specs(got, want):
    g, w = _walk(got), _walk(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert _fields(a) == _fields(b), path


def _mesh(names, sizes):
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _hash(ts) -> str:
    m = hashlib.sha256()
    for t in ts:
        m.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return m.hexdigest()[:16]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_lm_param_specs_match_the_reference(name, smoke):
    cfg = get_smoke_config(name) if smoke else get_config(name)
    jcfg = jget_smoke(name) if smoke else jget_config(name)
    _same_specs(lm_param_specs(cfg), jlm_specs(jcfg))


@pytest.mark.parametrize("name", DLRMS)
def test_dlrm_param_specs_match_the_reference(name):
    for cfg, jcfg in ((get_config(name), jget_config(name)),
                      (get_smoke_config(name), jget_smoke(name))):
        _same_specs(dlrm_param_specs(cfg, EmbeddingBagCollection.build(cfg)),
                    jdlrm_specs(jcfg, JEBC.build(jcfg, n_shards=1)))


@pytest.mark.parametrize("table", TABLES)
def test_specs_to_pspecs_match_the_reference(table):
    """Every arch's tree (and dlrm-m1's) under one table, size-aware over
    each mesh and by axis names alone."""
    rules, jrules = getattr(sharding, table), getattr(jsharding, table)
    trees = [(lm_param_specs(get_config(n)), jlm_specs(jget_config(n)))
             for n in sorted(ARCHS)]
    cfg, jcfg = get_config("dlrm-m1"), jget_config("dlrm-m1")
    trees.append((dlrm_param_specs(cfg, EmbeddingBagCollection.build(cfg)),
                  jdlrm_specs(jcfg, JEBC.build(jcfg, n_shards=1))))
    for specs, jspecs in trees:
        for names, sizes in MESHES:
            for kw in ({"mesh": _mesh(names, sizes)},
                       {"mesh_axis_names": names}):
                got = _walk(params.specs_to_pspecs(specs, rules, **kw))
                want = jparams.specs_to_pspecs(jspecs, jrules, **kw)
                want = _walk(jax.tree.map(
                    tuple, want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec)))
                assert got == want


def test_spec_helpers_match_the_reference():
    cfg, jcfg = get_config("jamba-v0.1-52b"), jget_config("jamba-v0.1-52b")
    specs, jspecs = lm_param_specs(cfg), jlm_specs(jcfg)
    assert params.param_bytes(specs) == jparams.param_bytes(jspecs)
    assert params.param_count(specs) == jparams.param_count(jspecs)
    half = params.cast_specs(specs, torch.bfloat16)
    jhalf = jparams.cast_specs(jspecs, jnp.bfloat16)
    assert params.param_bytes(half) == jparams.param_bytes(jhalf)
    _same_specs(half, jhalf)
    ints = {"a": ParamSpec((3,), ("embed",), dtype=torch.int32)}
    assert params.cast_specs(ints, torch.bfloat16)["a"].dtype == torch.int32
    unit = {"w": ParamSpec((4, 6), ("embed", "ff")),
            "b": ParamSpec((6,), ("ff",), init="zeros", fan_axis=0)}
    junit = {"w": jparams.ParamSpec((4, 6), ("embed", "ff")),
             "b": jparams.ParamSpec((6,), ("ff",), init="zeros",
                                    fan_axis=0)}
    _same_specs(params.stack_specs(unit, 5, "stage"),
                jparams.stack_specs(junit, 5, "stage"))
    assert params.stack_specs(unit, 5)["w"].logical_axes == \
        ("layer", "embed", "ff")


def test_abstract_params_take_no_memory():
    specs = lm_param_specs(get_config("qwen1.5-32b"))
    meta = params.abstract_params(specs)
    jmeta = jparams.abstract_params(jlm_specs(jget_config("qwen1.5-32b")))
    got = [(tuple(t.shape), t.device.type) for t in tree_leaves(meta)]
    want = [(tuple(s.shape), "meta") for _, s in _walk(jmeta)]
    assert sorted(got) == sorted(want)
    assert all(t.dtype == torch.float32 for t in tree_leaves(meta))


def test_specs_to_shardings_blocks():
    """Each leaf's NamedSharding holds the resolve_sized spec; its block
    is the leaf's shape split by the axes' sizes."""
    cfg = get_config("qwen1.5-32b")
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 16, "model": 16},
                           coords={"data": 3, "model": 5})
    specs = lm_param_specs(cfg)
    sh = params.specs_to_shardings(specs, sharding.FSDP_RULES, mesh)
    wq = sh["blocks"]["b0"]["attn"]["wq"]
    # 40 heads do not split 16 ways: wq shards its d_model over data only
    assert wq.spec == (None, "data")
    assert wq.local_shape(specs["blocks"]["b0"]["attn"]["wq"].shape) == \
        (cfg.n_layers, cfg.d_model // 16, 40, 128)


def test_a_spec_needs_one_axis_name_a_dimension():
    with pytest.raises(ValueError, match="axes"):
        ParamSpec((2, 3), ("embed",))


@pytest.mark.parametrize("name", ["stablelm-1.6b", "granite-moe-1b-a400m",
                                  "mamba2-780m", "jamba-v0.1-52b",
                                  "musicgen-large", "internvl2-26b",
                                  "dlrm-m1"])
def test_init_params_bits_did_not_move(name, one_thread):
    cfg = get_smoke_config(name)
    if name.startswith("dlrm"):
        got = init_dlrm_params(cfg, EmbeddingBagCollection.build(cfg), 3,
                               "cpu")
    else:
        got = init_lm_params(cfg, 3, "cpu")
    assert _hash(tree_leaves(got)) == BEFORE[f"init {name}"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "granite-moe-1b-a400m",
                                  "mamba2-780m"])
def test_one_device_step_bits_did_not_move(name, dtype, one_thread):
    """The step without a mesh, under every table, is today's step bit
    for bit (the BEFORE hashes) and the same under each table."""
    cfg = dataclasses.replace(get_smoke_config(name), compute_dtype=dtype)
    hashes = set()
    for table in (None, "TRAIN_RULES", "FSDP_RULES", "ZERO_DP_RULES"):
        p = init_lm_params(cfg, 0, "cpu")
        opt = adamw(3e-4)
        st = opt.init(p)
        kw = {} if table is None else {"rules": getattr(sharding, table),
                                       "mesh": None}
        step = build_lm_train_step(
            cfg, opt, accum_steps=2,
            grad_dtype="bfloat16" if dtype == "bfloat16" else "float32",
            **kw)
        losses = []
        for t in range(2):
            batch = {k: torch.from_numpy(v)
                     for k, v in make_lm_batch(cfg, 4, 32, t, 0).items()}
            p, st, m = step(p, st, batch, t)
            losses.append(m["loss"])
        hashes.add(_hash(losses + tree_leaves(p) + tree_leaves(st)))
    assert hashes == {BEFORE[f"step {name} {dtype}"]}
