"""QSGD across pods (``quant/qsgd.py``) against the reference's: ``encode``
bit for bit (words and scale) with the noise of ``jax.random``; a block's
words with the whole tensor's amax and its own elements' noise; the
leaves' order (JAX's sorted-key flatten); and ``psum_compressed`` over 2
and 4 gloo ranks, each a subprocess of this file, against
``jax.vmap(qsgd.psum_compressed, axis_name="pod")`` on the stacked
per-pod gradients, bit for bit."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.quant import qsgd as jax_qsgd  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.quant import qsgd  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120
GLOO_TIMEOUT_S = 60


def _grad_tree(seed, pod):
    """A gradient tree keyed so that insertion order is not JAX's sorted
    order; scaled per pod so that the pods' amax differ."""
    rng = np.random.default_rng(seed + 100 * pod)
    g = lambda *s: (rng.standard_normal(s) * (1 + pod)).astype(np.float32)  # noqa: E731
    return {"head": g(8, 24), "blocks": {"s0_mlp": {"wo": g(2, 12, 8)},
                                         "s0_attn": {"wq": g(2, 8, 8),
                                                     "pre_norm": g(2, 8)}},
            "embed": g(24, 8), "final_norm": g(8)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(37,), (6, 50), (3, 4, 65), (1,)])
def test_encode_bit_equal(shape, bits):
    rng = np.random.default_rng(sum(shape) + bits)
    g = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    if g.size:
        g.flat[0] = 0.0
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    jq, js = jax_qsgd.encode(jnp.asarray(g), key, bits)
    tq, ts = qsgd.encode(torch.from_numpy(g), threefry.fold_in(
        threefry.key_from_seed(3), 7), bits)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts) == np.asarray(js)
    assert np.array_equal(qsgd.decode(tq, ts).numpy(),
                          np.asarray(jax_qsgd.decode(jq, js)))
    # the zero gradient: amax 1e-30, every word 0
    zq, _ = qsgd.encode(torch.zeros(shape), (0, 1), bits)
    assert not zq.any()


def test_encode_chunks_do_not_change_the_words(monkeypatch):
    """The encode goes chunk by chunk (``qsgd._CHUNK``) to bound its
    temporaries; a chunk of 1000 elements gives the same words, whole and
    for a block."""
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 7, 500)).astype(np.float32))
    whole = qsgd.encode(g, (1, 2))
    place = ((6, 7, 500), (3, 0, 0))
    amax = torch.tensor(5.0)
    blk = qsgd.encode(g, (1, 2), amax=amax, place=place)
    monkeypatch.setattr(qsgd, "_CHUNK", 1000)
    for got, want in ((qsgd.encode(g, (1, 2)), whole),
                      (qsgd.encode(g, (1, 2), amax=amax, place=place), blk)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_block_encode_is_the_whole_tensors():
    """A rank's block, given the whole tensor's amax and its place, gets
    the words of the whole tensor's encode at its elements."""
    from repro_torch import distributed as dst
    from repro_torch.sharding import Mesh, P
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6, 8)).astype(np.float32))
    key = (12, 34)
    whole, scale = qsgd.encode(g, key)
    amax = torch.max(torch.abs(g))
    names, sizes = ("pod", "data", "model"), (1, 2, 2)
    for spec in (P(None, "data", "model"), P("data", None, "model"),
                 P(None, None, ("data", "model"))):
        for r in range(4):
            m = Mesh(names, sizes, dst.rank_coords(r, names, sizes))
            sl = dst.block_slices(g.shape, spec, m)
            q, s = qsgd.encode(g[sl].contiguous(), key, amax=amax,
                               place=(tuple(g.shape),
                                      tuple(x.start for x in sl)))
            assert torch.equal(q, whole[sl]) and torch.equal(s, scale)


def test_leaf_order_is_jax_flatten_order():
    tree = _grad_tree(0, 0)
    tree["a.b"] = np.zeros(1, np.float32)     # '.' sorts before '/'
    tree["a"] = {"z": np.zeros(1, np.float32)}
    want = [jax.tree_util.keystr(p, simple=True, separator="/")
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert qsgd.sorted_paths(list(_flat(tree))) == want


def _rank_main(argv):
    """One pod rank: its gradient tree through ``psum_compressed`` on a
    (pods, 1, 1) gloo mesh; the result to ``out``."""
    rank, world, store, out = argv
    torch.set_num_threads(1)
    from repro_torch import distributed as dst
    mesh = dst.init_mesh({"pod": int(world)}, "gloo", device="cpu",
                         rank=int(rank),
                         world_size=int(world), init_method=f"file://{store}",
                         timeout_s=GLOO_TIMEOUT_S)
    grads = {k: torch.from_numpy(v) for k, v in
             _flat(_grad_tree(0, int(rank))).items()}
    tree = {}
    for p, t in grads.items():
        cur = tree
        *parents, last = p.split("/")
        for k in parents:
            cur = cur.setdefault(k, {})
        cur[last] = t
    key = threefry.fold_in(threefry.key_from_seed(5), 2)
    got = qsgd.psum_compressed(tree, key, mesh, "pod", 8)
    pickle.dump({p: v.numpy() for p, v in _flat(got).items()},
                open(out, "wb"))
    dst.destroy(mesh)


@pytest.mark.parametrize("pods", [2, 4])
def test_psum_compressed_over_gloo_ranks_equals_vmap(pods, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(pods),
                               str(tmp_path / "store"),
                               str(tmp_path / f"rank{r}.pkl")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(pods)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran past {CHILD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[_grad_tree(0, r) for r in range(pods)])
    key = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    want = jax.vmap(lambda g: jax_qsgd.psum_compressed(g, key, "pod", 8),
                    axis_name="pod")(stacked)
    want = {p: np.asarray(v) for p, v in _flat(want).items()}
    for r in range(pods):
        got = pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
        assert set(got) == set(want)
        for p in want:
            assert np.array_equal(got[p], want[p][r]), (r, p)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
