"""The sharded fused SR quantize (``kernels/ops._fused_sharded``) against
the reference: each rank's block quantized with the per-shard seed, bit
for bit the reference's ``ref_sr_quantize_fused_sharded_words`` (the
assembled oracle of its shard_map-wrapped Pallas kernels), for all four
entry points (int8 words flat and stacked, grid values flat and stacked,
f32 and bf16), on the grids ``param_pspec`` gives real leaves under
``train.zero_shard`` on (1, 2, 1), (2, 2, 1) and (1, 4, 1) meshes (specs
that name size-1 axes included), a stacked leaf sharded on dim 0, and the
controller's copy of a leaf held in blocks; an uneven leaf takes the noise
path. On the CPU the kernels' plain versions run."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import controller as jax_controller  # noqa: E402
from repro.core import fixed_point as jax_fxp  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch import distributed as dst  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.sharding import Mesh, NamedSharding, P, shard_grid  # noqa: E402

NAMES = ("pod", "data", "model")
MESHES = [(1, 2, 1), (2, 2, 1), (1, 4, 1)]
# (path, shape): the embedding, stacked wq and wi_up at narrow widths, and
# a stacked leaf whose only free dim that divides the data axis is the
# layer dim (zero_shard folds data into dim 0)
LEAVES = [("embed", (96, 40)), ("blocks/s0_attn/wq", (4, 40, 48)),
          ("blocks/s0_mlp/wi_up", (4, 40, 64)),
          ("blocks/s0_attn/wq", (4, 3, 5))]
SEEDS = [-5, 2 ** 31 - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def _prec(shape, stacked):
    if not stacked:
        return np.int32(8), np.int32(5)
    L = shape[0]
    return (np.array([4, 8, 12, 6][:L] * (L // 4 or 1), np.int32)[:L],
            np.array([3, 5, 9, 2][:L] * (L // 4 or 1), np.int32)[:L])


def _blocks(x, seed, wl, fl, sharding, *, int8=False,
            out_dtype=torch.float32):
    """The whole leaf quantized block by block as the ranks of the
    sharding's mesh quantize their own: each distinct block by the entry
    point with its rank's ``sharding=`` (the per-shard seed)."""
    spec, mesh = sharding.spec, sharding.mesh
    out = torch.empty(x.shape, dtype=torch.int8 if int8 else out_dtype)
    for r in range(mesh.size):
        coords = dst.rank_coords(r, NAMES, [mesh.shape[a] for a in NAMES])
        sh = NamedSharding(mesh.at(coords), spec, tuple(x.shape))
        sl = dst.block_slices(x.shape, spec, mesh, coords)
        out[sl] = (ops.sr_quantize_fused_int8(x[sl], seed, fl,
                                              use_pallas=True, sharding=sh)
                   if int8 else
                   ops.sr_quantize_fused(x[sl], seed, wl, fl, use_pallas=True,
                                         out_dtype=out_dtype, sharding=sh))
    return out


def _cases():
    cfg = load_config("tiny", overrides=["train.zero_shard=true"])
    for sizes in MESHES:
        mesh = Mesh(NAMES, sizes)
        for path, shape in LEAVES:
            spec = mesh_lib.param_pspec(path, shape, cfg, mesh, fsdp=True)
            yield sizes, path, shape, spec


CASES = list(_cases())


@pytest.mark.parametrize("sizes,path,shape,spec", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_blocks_bit_equal_the_reference(sizes, path, shape, spec):
    mesh = Mesh(NAMES, sizes)
    grid = shard_grid(shape, spec, mesh)
    assert grid is not None
    sh = NamedSharding(mesh, spec, shape)
    for seed in SEEDS:
        x = _x(shape, seed & 0xFFFF)
        for stacked in ((False, True) if len(shape) == 3 else (False,)):
            wl, fl = _prec(shape, stacked)
            xt = torch.from_numpy(x)
            wlt, flt = torch.from_numpy(np.asarray(wl)), \
                torch.from_numpy(np.asarray(fl))
            want8 = np.asarray(jax_ref.ref_sr_quantize_fused_sharded_words(
                jnp.asarray(x), seed, jnp.asarray(wl), jnp.asarray(fl), grid,
                int8=True))
            got8 = _blocks(xt, seed, wlt, flt, sh, int8=True)
            assert np.array_equal(got8.numpy(), want8), (seed, stacked)
            plain8 = ref.ref_sr_quantize_fused_sharded_words(
                xt, seed, wlt, flt, grid, int8=True)
            assert torch.equal(plain8, got8)
            want = np.asarray(jax_ref.ref_sr_quantize_fused_sharded_words(
                jnp.asarray(x), seed, jnp.asarray(wl), jnp.asarray(fl), grid))
            got = _blocks(xt, seed, wlt, flt, sh)
            assert np.array_equal(got.numpy(), want), (seed, stacked)
            bf = _blocks(xt, seed, wlt, flt, sh, out_dtype=torch.bfloat16)
            assert torch.equal(bf, torch.from_numpy(want.copy()).to(torch.bfloat16))


def test_size_one_axes_fold_against_the_live_reference():
    """On a (1, 1, 1) mesh the reference's shard_map-wrapped kernels (in
    interpret mode) fold the seed with shard 0 when the spec names an
    axis: the words differ from the unsharded kernel's and equal the
    port's, block = whole leaf."""
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding as JaxNamedSharding
    from jax.sharding import PartitionSpec as JaxP
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), NAMES)
    mesh = Mesh(NAMES, (1, 1, 1), {"pod": 0, "data": 0, "model": 0})
    for spec, shape in ((P("model", "data"), (96, 40)),
                        (P(None, "data", "model"), (4, 40, 48))):
        x = _x(shape, 7)
        stacked = len(shape) == 3
        wl, fl = _prec(shape, stacked)
        jsh = JaxNamedSharding(jmesh, JaxP(*spec))
        sh = NamedSharding(mesh, spec, shape)
        xt = torch.from_numpy(x)
        wlt, flt = torch.as_tensor(wl), torch.as_tensor(fl)
        want8 = np.asarray(jax_ops.sr_quantize_fused_int8(
            jnp.asarray(x), 11, jnp.asarray(fl), use_pallas=True,
            sharding=jsh))
        got8 = ops.sr_quantize_fused_int8(xt, 11, flt, use_pallas=True,
                                          sharding=sh)
        assert np.array_equal(got8.numpy(), want8)
        plain8 = ops.sr_quantize_fused_int8(xt, 11, flt, use_pallas=True)
        assert not torch.equal(plain8, got8)
        want = np.asarray(jax_ops.sr_quantize_fused(
            jnp.asarray(x), 11, jnp.asarray(wl), jnp.asarray(fl),
            use_pallas=True, sharding=jsh))
        got = ops.sr_quantize_fused(xt, 11, wlt, flt, use_pallas=True,
                                    sharding=sh)
        assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="use_pallas"):
        ops.sr_quantize_fused(xt, 11, wlt, flt, sharding=sh)


def _tiny_state(ov):
    from repro.config import load_config as jax_load_config
    from repro.train import train_loop as jax_train_loop
    jcfg = jax_load_config("tiny", overrides=ov)
    return jcfg, jax.tree.map(np.asarray, jax_train_loop.init_state(jcfg))


@pytest.mark.parametrize("container", ["float32", "bfloat16", "int8",
                                       "int8_packed"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "noise"])
def test_controller_blocks_assemble_the_whole_copy(container, fused):
    """Each rank of a (2, 2, 1) mesh quantizes its blocks of tiny's params
    (``quantize_params[_packed](shardings=)``); the blocks put together are
    the fused kernels' per-shard words of the reference's oracle, and on
    the noise path (jax.random noise of each element's own index) the
    unsharded copy's, bit for bit."""
    ov = ["train.zero_shard=true", f"quant.container_dtype={container}",
          f"quant.use_pallas={str(fused).lower()}", "quant.fused_prng=true"]
    jcfg, jstate = _tiny_state(ov)
    cfg = load_config("tiny", overrides=ov)
    packed = container == "int8_packed"
    params = interop.params_from_numpy(jstate["params"], "cpu")
    adapt = interop.adapt_state_from_numpy(jstate["adapt"], "cpu")
    sizes = (2, 2, 1)
    seeds = controller.leaf_seeds(0, 3, adapt["tensors"])
    key = controller.step_key(0, 3)
    shardings = mesh_lib.state_shardings({"params": params}, cfg,
                                         Mesh(NAMES, sizes))["params"]
    flat_sh = dict(controller.flatten_with_path(shardings))
    if packed and fused:
        # the reference refuses the dense kernels a leaf split over ranks
        m = Mesh(NAMES, sizes, dst.rank_coords(0, NAMES, sizes))
        with pytest.raises(ValueError, match="cannot be partitioned"):
            controller.quantize_params_packed(
                params, adapt, cfg.quant, seeds,
                shardings={p: NamedSharding(m, s.spec, s.shape)
                           for p, s in flat_sh.items()})
        return
    dtype = {"bfloat16": torch.bfloat16, "int8": torch.int8}.get(
        container, torch.float32)
    whole = {}
    for r in range(4):
        m = Mesh(NAMES, sizes, dst.rank_coords(r, NAMES, sizes))
        rank_sh = {p: NamedSharding(m, s.spec, s.shape)
                   for p, s in flat_sh.items()}
        blocks = {p: dst.local_block(t, rank_sh[p].spec, m).contiguous()
                  for p, t in controller.flatten_with_path(params)}
        tree = {}
        for p, t in blocks.items():
            controller._set_path(tree, p, t)
        if packed:
            q = controller.quantize_params_packed(
                tree, adapt, cfg.quant, seeds, key=key, shardings=rank_sh)
            q = {p: v["q8"] for p, v in _packed(q).items()}
        else:
            q = dict(controller.flatten_with_path(controller.quantize_params(
                tree, adapt, cfg.quant, seeds, dtype=dtype, key=key,
                shardings=rank_sh)))
        for p, blk in q.items():
            if p not in adapt["tensors"]:
                continue
            sl = dst.block_slices(flat_sh[p].shape, flat_sh[p].spec, m)
            out = whole.setdefault(p, torch.empty(flat_sh[p].shape,
                                                  dtype=blk.dtype))
            out[sl] = blk
    for p, got in whole.items():
        ts = jstate["adapt"]["tensors"][p]
        leaf = jnp.asarray(_get(jstate["params"], p))
        wl, fl = jnp.asarray(ts["wl"]), jnp.asarray(ts["fl"])
        if fused:
            grid = shard_grid(flat_sh[p].shape, flat_sh[p].spec,
                              Mesh(NAMES, sizes))
            int8 = container in ("int8", "int8_packed")
            want = np.asarray(jax_ref.ref_sr_quantize_fused_sharded_words(
                leaf, seeds[p], wl, fl, grid, int8=int8))
            if container == "int8":
                want = _int8_value(want, ts["fl"])
        else:
            want = np.asarray(_reference_noise_copy(leaf, ts, p, container))
        assert np.array_equal(interop.tensor_to_numpy(got).astype(np.float32),
                              np.asarray(want).astype(np.float32)), p


def _packed(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "q8" in v:
            out[p] = v
        elif isinstance(v, dict):
            out.update(_packed(v, p))
    return out


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _int8_value(words, fl):
    sc = np.asarray(jax_fxp.pow2i(-jnp.asarray(fl)).astype(jnp.bfloat16))
    if np.ndim(fl):
        sc = sc.reshape(np.shape(fl) + (1,) * (words.ndim - 1))
    return np.asarray(jnp.asarray(words).astype(jnp.bfloat16)
                      * jnp.asarray(sc))


def _reference_noise_copy(leaf, ts, p, container):
    """The reference's noise path on the whole leaf (step key of run seed
    0, step 3)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    u = jax_fxp.uniform_noise_like(jax_controller._leaf_key(key, p), leaf)
    wl, fl = jnp.asarray(ts["wl"]), jnp.asarray(ts["fl"])
    if wl.ndim:
        b = wl.shape + (1,) * (leaf.ndim - 1)
        wl, fl = wl.reshape(b), fl.reshape(b)
    if container in ("int8", "int8_packed"):
        x = leaf.astype(jnp.float32) * jax_fxp.pow2i(fl)
        q = jnp.clip(jax_fxp.stochastic_round(x, u), -128.0, 127.0).astype(
            jnp.int8)
        if container == "int8_packed":
            return q
        return q.astype(jnp.bfloat16) * jax_fxp.pow2i(-fl).astype(
            jnp.bfloat16)
    out = jax_fxp.quantize(leaf, wl, fl, u=u)
    return out.astype(jnp.bfloat16) if container == "bfloat16" else out


def test_uneven_leaf_takes_the_noise_path():
    """A spec that does not divide the leaf (5 rows over 2 data ranks): the
    leaf is held whole, ``_use_fused_prng`` declines it, and its copy is
    the noise path's, the same on every rank."""
    cfg = load_config("tiny", overrides=["quant.use_pallas=true",
                                         "quant.fused_prng=true"])
    leaf = torch.from_numpy(_x((5, 16), 3))
    fl = torch.tensor(6, dtype=torch.int32)
    sizes = (1, 2, 1)
    copies = []
    for r in range(2):
        m = Mesh(NAMES, sizes, dst.rank_coords(r, NAMES, sizes))
        sh = NamedSharding(m, P("data", None), (5, 16))
        assert not controller._use_fused_prng(cfg.quant, True, fl, leaf, sh)
        state = {"tensors": {"w": {"wl": torch.tensor(8, dtype=torch.int32),
                                   "fl": fl}}}
        copies.append(controller.quantize_params(
            {"w": leaf}, state, cfg.quant, {"w": 9},
            key=controller.step_key(0, 1), shardings={"w": sh})["w"])
    assert torch.equal(copies[0], copies[1])
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    u = jax_fxp.uniform_noise_like(jax_controller._leaf_key(key, "w"),
                                   jnp.asarray(leaf.numpy()))
    want = jax_fxp.quantize(jnp.asarray(leaf.numpy()), jnp.int32(8),
                            jnp.int32(6), u=u)
    assert np.array_equal(copies[0].numpy(), np.asarray(want))


def test_dense_prologue_and_packed_refusal_under_shardings():
    """A spec that names an axis keeps a dense leaf off the quantize
    prologue; under use_pallas the packed container refuses a dense leaf
    split over more than one rank, with the reference's message."""
    cfg = load_config("tiny", overrides=["quant.use_pallas=true",
                                         "quant.dense_prologue=true",
                                         "quant.container_dtype=int8_packed"])
    leaf = torch.zeros(8, 16)
    fl = torch.tensor(6, dtype=torch.int32)
    one = Mesh(NAMES, (1, 1, 1), {"pod": 0, "data": 0, "model": 0})
    p = "blocks/s0_attn/wq"
    assert controller._use_dense_prologue(cfg.quant, p, fl, leaf)
    assert not controller._use_dense_prologue(
        cfg.quant, p, fl, leaf, NamedSharding(one, P(None, "model"), (8, 16)))
    assert controller._use_dense_prologue(
        cfg.quant, p, fl, leaf, NamedSharding(one, P(), (8, 16)))
    two = Mesh(NAMES, (1, 2, 1), {"pod": 0, "data": 0, "model": 0})
    state = {"tensors": {p: {"wl": torch.tensor(8, dtype=torch.int32),
                             "fl": fl}}}
    params = {"blocks": {"s0_attn": {"wq": leaf[:4]}}}
    with pytest.raises(ValueError, match="cannot be partitioned"):
        controller.quantize_params_packed(
            params, state, cfg.quant, {p: 1},
            shardings={p: NamedSharding(two, P("data", None), (8, 16))})
