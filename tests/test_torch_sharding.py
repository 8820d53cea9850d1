"""The port's sharding rules and specs against the reference's: logical
rules, parameter specs, the whole train state's, batch and cache specs
for every config of the registry, on duck-typed meshes (shape-only
stand-ins, as tests/test_sharding_and_roofline.py uses; jax's
``AbstractMesh``, so that the reference can make its shardings) at the production
shapes and at a small data-parallel one; the spec helpers; the blocks a
rank holds and the shard index its seed folds."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JaxP  # noqa: E402

from repro import sharding as jax_sharding  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro_torch import distributed as dst  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.sharding import Mesh, P  # noqa: E402


def _FakeMesh(shape):
    """Shape-only mesh (nothing allocated): jax's ``AbstractMesh``, which
    the reference's NamedSharding takes and which has ``axis_names`` and
    ``shape[name]``, as the port's functions read a mesh."""
    return jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape))


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x1": {"data": 2, "model": 1}}
ARCHS = list_archs()


def _specs(tree):
    """{path: spec tuple} of a tree of the reference's NamedShardings or
    the port's."""
    out = {}

    def visit(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                visit(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            out[prefix] = tuple(t.spec)
    visit(tree, "")
    return out


def _jax_specs(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def shapes():
    """The reference's state, batch and decode-cache shapes of every
    config (``jax.eval_shape``: nothing allocated)."""
    from repro.data import synthetic as jax_synthetic
    out = {}
    for arch in ARCHS:
        cfg = jax_get_config(arch)
        if cfg.model.family == "cnn":
            # the reference caches its CIFAR prototypes at first use: made
            # here, eagerly, so that tracing the batch does not cache a
            # tracer for the later tests of this process
            jax_synthetic.cifar_prototypes(cfg.model.vocab_size)
        out[arch] = {"state": jax_specs.state_specs(cfg),
                     "batch": jax_specs.batch_specs(cfg)}
        if cfg.model.family != "cnn":
            out[arch]["caches"] = jax_specs.decode_specs(cfg)["caches"]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh_name, shapes):
    mesh = _FakeMesh(MESHES[mesh_name])
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    sh = shapes[arch]
    for kind in ("train", "prefill", "decode", "long"):
        assert mesh_lib.make_rules(cfg, mesh, kind) == \
            jax_mesh.make_rules(jcfg, mesh, kind)
    want = _jax_specs(jax_mesh.state_shardings(sh["state"], jcfg, mesh))
    got = _specs(mesh_lib.state_shardings(sh["state"], cfg, mesh))
    assert got == want
    for zero in (True, False):
        assert _specs(mesh_lib.state_shardings(sh["state"], cfg, mesh,
                                               zero=zero)) == \
            _jax_specs(jax_mesh.state_shardings(sh["state"], jcfg, mesh,
                                                zero=zero))
    params = sh["state"]["params"]
    for fsdp in (None, True, False):
        assert _specs(mesh_lib.param_shardings(params, cfg, mesh,
                                               fsdp=fsdp)) == \
            _jax_specs(jax_mesh.param_shardings(params, jcfg, mesh,
                                                fsdp=fsdp))
    if cfg.model.family != "cnn":
        assert {k: tuple(v.spec) for k, v in mesh_lib.packed_slice_specs(
            params, cfg, mesh).items()} == \
            {k: tuple(v.spec) for k, v in jax_mesh.packed_slice_specs(
                params, jcfg, mesh).items()}
    assert _specs(mesh_lib.batch_shardings(sh["batch"], mesh)) == \
        _jax_specs(jax_mesh.batch_shardings(sh["batch"], mesh))
    if "caches" in sh:
        for kind in ("decode", "long"):
            assert _specs(mesh_lib.cache_shardings(sh["caches"], cfg, mesh,
                                                   kind)) == \
                _jax_specs(jax_mesh.cache_shardings(sh["caches"], jcfg, mesh,
                                                    kind))
    assert mesh_lib.dp_size(mesh) == jax_mesh.dp_size(mesh)
    assert mesh_lib.dp_axes(mesh) == jax_mesh.dp_axes(mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_name_rules_on_their_own(mesh_name):
    """The rules the registry's configs do not all reach: wk/wv under
    kv_proj=replicate, expert parallelism against TP inside an expert,
    the FSDP fold on the last free dim that divides, seq_shard_attn and
    split-KV decode, the bf16 TP reduce flag."""
    from repro.config import apply_overrides as jax_apply
    from repro_torch.config import apply_overrides
    mesh = _FakeMesh(MESHES[mesh_name])
    cases = [("granite-8b", ["mesh.kv_proj=replicate",
                             "mesh.seq_shard_attn=pad",
                             "mesh.decode_kv_shard=seq",
                             "train.tp_reduce_dtype=bfloat16"]),
             ("smollm-360m", ["mesh.seq_shard_attn=auto"]),
             ("mixtral-8x22b", []), ("arctic-480b", [])]
    shapes = [("blocks/s0_attn/wk", (36, 4096, 1024)),
              ("blocks/s0_attn/wv", (36, 4096, 1024)),
              ("blocks/s0_moe/we_gate", (35, 128, 7168, 4864)),
              ("blocks/s0_moe/we_down", (56, 8, 16384, 6144)),
              ("blocks/s0_mamba/conv_w", (48, 4, 3072)),
              ("blocks/s0_moe/router", (35, 7168, 128)),
              ("w", (3, 3, 16, 32)), ("w", (10, 4096)),
              ("embed", (49152, 4096)), ("head", (4096, 49155)),
              ("blocks/s0_attn/wo", (36, 4096, 4096))]
    for arch, ov in cases:
        jcfg = jax_apply(jax_get_config(arch), ov)
        cfg = apply_overrides(get_config(arch), ov)
        for kind in ("train", "decode", "long"):
            assert mesh_lib.make_rules(cfg, mesh, kind) == \
                jax_mesh.make_rules(jcfg, mesh, kind)
        for path, shape in shapes:
            for fsdp in (None, True, False):
                assert tuple(mesh_lib.param_pspec(path, shape, cfg, mesh,
                                                  fsdp=fsdp)) == \
                    tuple(jax_mesh.param_pspec(path, shape, jcfg, mesh,
                                               fsdp=fsdp)), (arch, path)


def test_spec_helpers_equal_the_reference():
    mesh = _FakeMesh({"pod": 2, "data": 4, "model": 3})
    specs = [P(), P(None, "data"), P("model", "data"), P(("pod", "data")),
             P(None, ("pod", "data"), "model")]
    for s in specs:
        js = JaxP(*s)
        for shape in [(8, 12, 6), (6, 8, 3), (12, 3, 9), (4,)]:
            assert sharding.shard_grid(shape, s, mesh) == \
                jax_sharding.shard_grid(shape, js, mesh)
        for nd in (1, 2, 3, 4):
            assert sharding.spec_dim_axes(s, nd) == \
                jax_sharding.spec_dim_axes(js, nd)
    rules = {"batch": ("pod", "data"), "heads": ("model",), "#flag": True,
             "seq": ()}
    assert sharding.strip_axes(rules, ("pod",)) == \
        jax_sharding.strip_axes(rules, ("pod",))


def test_rules_context_and_duplicate_axes():
    """A mesh axis appears once in a spec; outside rules every helper is
    a no-op and ``shard`` is the identity inside them too."""
    x = torch.ones(4, 4)
    assert sharding.shard(x, "batch", None) is x
    assert sharding.spec("batch") is None and not sharding.active()
    assert sharding.axis_size("batch") == 1 and sharding.flag("#x") is None
    mesh = Mesh(("pod", "data", "model"), (2, 2, 1))
    rules = {"batch": ("pod", "data"), "seq": ("data",), "ff": ("model",),
             "#tp": True}
    with sharding.use_rules(mesh, rules):
        assert sharding.active() and sharding.current_mesh() is mesh
        assert sharding.spec("batch", "seq") == P(("pod", "data"), None)
        assert sharding.spec("seq", "batch") == P("data", "pod")
        assert sharding.spec(None, "ff") == P(None, "model")
        assert sharding.axis_size("batch") == 4
        assert sharding.flag("#tp") is True
        assert sharding.shard(x, "batch", "ff") is x
        assert tuple(sharding.named_sharding("batch").spec) == \
            (("pod", "data"),)
    jmesh = _FakeMesh({"data": 2, "model": 1})
    with jax_sharding.use_rules(jmesh, {"batch": ("data",),
                                        "seq": ("data",)}):
        assert tuple(jax_sharding.spec("batch", "seq")) == ("data", None)
    with sharding.use_rules(Mesh(("data", "model"), (2, 1)),
                            {"batch": ("data",), "seq": ("data",)}):
        assert tuple(sharding.spec("batch", "seq")) == ("data", None)
    assert not sharding.active()


def test_blocks_and_shard_index():
    """Each rank's block of a leaf, in grid order, tiles the leaf once;
    the linear index folds the axes the spec names, in dim order, and
    replicas along the other axes get the same index."""
    sizes = (2, 2, 1)
    names = ("pod", "data", "model")
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    for spec in (P(None, "data", "model"), P("model", "data"),
                 P(("pod", "data")), P(None, None, ("data", "model")),
                 P("data", None, "pod")):
        seen = torch.zeros_like(x)
        idx = {}
        for r in range(4):
            c = dst.rank_coords(r, names, sizes)
            m = Mesh(names, sizes, c)
            blk = dst.local_block(x, spec, m)
            seen[dst.block_slices(x.shape, spec, m)] += 1
            assert torch.equal(blk, x[dst.block_slices(x.shape, spec, m)])
            key = tuple(blk.flatten().tolist())
            i = dst.shard_index(spec, m, x.ndim)
            assert idx.setdefault(key, i) == i
        grid = sharding.shard_grid(x.shape, spec, Mesh(names, sizes))
        assert len(idx) == int(np.prod(grid))
        assert sorted(idx.values()) == list(range(len(idx)))
        assert int(seen.min()) == int(seen.max()) == 4 // len(idx)
    assert dst.rank_coords(5, names, (2, 3, 1)) == {"pod": 1, "data": 2,
                                                    "model": 0}
    with pytest.raises(ValueError, match="divide"):
        dst.block_slices((5, 4), P("data"), Mesh(names, sizes, {
            "pod": 0, "data": 0, "model": 0}))


def test_production_meshes():
    assert mesh_lib.make_production_mesh().shape == {"data": 16, "model": 16}
    m = mesh_lib.make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert mesh_lib.make_cpu_mesh().shape == {"data": 1, "model": 1}
    assert mesh_lib.FSDP_THRESHOLD == jax_mesh.FSDP_THRESHOLD
    assert tuple(mesh_lib.replicated(m).spec) == ()
