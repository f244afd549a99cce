"""``graft_entry_torch.py`` (the port's entry points) against
``__graft_entry__.py`` (the JAX package's).

* ``entry(device="cpu")`` against ``__graft_entry__.entry()``: the same
  params (drawn by each package, equal bit for bit, and the JAX ones carried
  across with ``besskge_tpu_torch.convert``), the same batch bit for bit,
  the loss and the metric sums within fp32 tolerance.
* ``dryrun_multichip(4)`` inside one spawn of 4 gloo ranks on the CPU
  (``tests/torch_mesh_ranks.py``'s ``graft_dryrun``, which puts the JAX
  package's uniforms into sub-check 7's draws): every rank returns, each
  prints the eleven ``PARITY OK`` lines in ``__graft_entry__.py``'s order
  and the closing line.
* Sub-checks 6-11 of the ranks against the JAX package's run of the same
  set-up on 4 devices of the 8-device CPU mesh (``shard_map``), run here
  while the ranks run:

  - 6 and 9, the packed and plain 16-bit trajectories (and 6's stochastic
    rounding run): equal or one 16-bit ulp apart, the bound of
    ``tests/test_torch_packed_train.py`` (a last-bit fp32 difference in the
    step can round a 16-bit value to its other neighbour: one value of the
    576 of a rank's bf16 block does, here). The packed and plain runs of
    the port are equal bit for bit, as the sub-check itself asserts;
  - 7, the type-based draws, gathered over the ranks: bit for bit;
  - 8, the interleaved table and momentum: the fp32 step tolerance of
    ``tests/test_torch_mesh.py`` (``1e-5·(|want| + max|want|)``: the
    distances and the sums over micro-batches and ranks in another order);
    B4 on each rank's block against the JAX kernel (interpret mode) under
    ``shard_map`` at ``tests/test_torch_row_optim.py``'s rtol 1e-6 plus
    atol 1e-7;
  - 10 and 11, the packed fp16 stores: ``tests/test_torch_packed_train.py``'s
    bounds (params equal or one 16-bit ulp apart, the fp32 moments within
    one bf16 ulp of each value plus 2^-12 of the largest).

* An NCCL request beyond the host's cards raises, and the entry points run
  on the card unless told otherwise (here, with no card, they raise).

The file takes one spawn of 4 ranks, beside the JAX runs.
"""

import inspect
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as jax_entry
import graft_entry_torch as G
import torch_mesh_ranks as R
from besskge_tpu import packed as jpk
from besskge_tpu.dataset import KGDataset
from besskge_tpu.device_sampler import DeviceBatchSampler
from besskge_tpu.negative_sampler import TypeBasedShardedNegativeSampler
from besskge_tpu.ops.pallas_row_sgdm import fused_pair_sgdm
from besskge_tpu.optim import RowAdamW, RowSGDM, interleave_momentum, split_interleaved
from besskge_tpu.parallel import make_shard_mesh, shard_batch, shard_params
from besskge_tpu.parallel.mesh import AXIS, replicate_tree
from besskge_tpu.sharding import PartitionedTripleSet, Sharding
from besskge_tpu.trainer import build_train_step, init_optimizer_state
from besskge_tpu_torch import convert
from besskge_tpu_torch import packed as ppk
from besskge_tpu_torch.parallel.multihost import _spawn
from test_torch_device_sampler import _jax_uniforms

N = 4
TIMEOUT = 120
NAMES = ["embedding_moving_train", "score_moving_eval", "topk_vs_all", "allscores_windows",
         "sparse_row_sgdm", "packed_bf16_table", "type_device_sampling", "interleaved_row_sgdm",
         "packed_fp16_table", "packed_triplet_interleave", "packed_quint_adamw"]


def _mesh():
    return make_shard_mesh(N, devices=jax.devices("cpu")[:N])


def _type_sampler(n):
    """Sub-check 7's set-up (``__graft_entry__.py:427``) in the JAX package."""
    n_entity = 24 * n
    type_offsets = np.asarray([0, n_entity // 3, 2 * (n_entity // 3)])
    rng = np.random.default_rng(5)
    trip = np.stack([rng.integers(n_entity, size=4000), rng.integers(4, size=4000),
                     rng.integers(n_entity, size=4000)], 1).astype(np.int32)
    ds = KGDataset(n_entity=n_entity, n_relation_type=4,
                   type_offsets={"a": 0, "b": int(type_offsets[1]), "c": int(type_offsets[2])},
                   triples={"train": trip}, original_triple_ids={"train": np.arange(4000)})
    sharding = Sharding.create(n_entity, n, seed=5, type_offsets=type_offsets)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    ns = TypeBasedShardedNegativeSampler(pts.types, 6, sharding, "t", local_sampling=False, seed=5)
    return DeviceBatchSampler(pts, ns, shard_bs=4 * n, batches_per_step=1, seed=5)


def _jax_type_draw(dev, mesh):
    """The draw of ``__graft_entry__.py:467-485``: through ``shard_map``,
    each device's slice reassembled into the global layout."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    state = replicate_tree(dev.state(), mesh)
    key = dev.next_key(0)

    def sample_local(st, k):
        return dev.slice_local(dev.sample(st, k[0]), jax.lax.axis_index(AXIS))

    keys = jax.device_put(jnp.broadcast_to(key, (N, *key.shape)), NamedSharding(mesh, P(AXIS)))
    out = jax.jit(jax.shard_map(sample_local, mesh=mesh, in_specs=(P(), P(AXIS)),
                            out_specs=P(None, AXIS)))(state, keys)
    return jax.tree.map(np.asarray, out)


def _jax_run(mesh, half, pack, row, interleave=None, steps=2):
    """``__graft_entry__.py``'s ``run`` of sub-checks 6 and 8-11: the tiny
    set-up trained ``steps`` host-fed steps with the entity table in
    ``half`` (packed or plain): (params, state, losses)."""
    bess, bs, params, _, _ = jax_entry._build(n_shard=N, n_entity=16 * N + 3, emb=16,
                                              shard_bs=4 * N, n_negative=4, bps=1)
    tab = params["entity_embedding"]
    if half is not None:
        tab = jpk.pack_table(tab.astype(half)) if pack else tab.astype(half)
        bess.score_fn.dtype = half
        bess.score_fn.packed_entity_storage = pack
    params["entity_embedding"] = tab if interleave is None else interleave(tab)
    params = shard_params(params, mesh)
    n_logical = bess.sharding.n_shard * bess.sharding.max_entity_per_shard
    opt = optax.sgd(0.05)
    st = init_optimizer_state(opt, params, mesh, row,
                              n_logical=n_logical if interleave is not None else None)
    step = build_train_step(bess, opt, mesh, row, donate=False)
    blocks = bs.epoch_index_blocks(shuffle=False)
    losses = []
    for _ in range(steps):
        params, st, out = step(params, st, shard_batch(bs.sample_batch(next(blocks)), mesh))
        losses.append(float(out["loss"]))
    return params, st, losses


def _jax_logical(table):
    """A JAX package's entity table as fp32 logical rows (``G._logical``)."""
    t = np.asarray(table)
    if t.dtype in (np.int32, np.uint32):
        return ppk.unpack_table_host(t, 2 * t.shape[0]).astype(np.float32)
    return np.asarray(jnp.asarray(table).astype(jnp.float32))


def _jax_b4(mesh):
    """``fused_pair_sgdm`` under ``shard_map`` (``__graft_entry__.py:576-601``),
    in interpret mode."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(11)
    n_rows, d = 32, 128
    tab = rng.normal(size=(N, 2 * n_rows, d)).astype(np.float32)
    idx = np.sort(rng.choice(n_rows, size=8, replace=False)).astype(np.int32)
    g = rng.normal(size=(8, d)).astype(np.float32)

    def dev_update(t, phys, grads):
        return fused_pair_sgdm(t, phys, grads, 0.1, momentum=0.9, weight_decay=0.01,
                               skip_dups=True, interpret=True)

    sharded = jax.jit(jax.shard_map(dev_update, mesh=mesh, in_specs=(P(AXIS), P(), P()),
                                    out_specs=P(AXIS), check_vma=False))
    return np.asarray(sharded(jax.device_put(jnp.asarray(tab), NamedSharding(mesh, P(AXIS))),
                              jnp.asarray(2 * idx), jnp.asarray(g)))


def _jax_sub_checks(mesh):
    """The JAX package's arrays of sub-checks 6-11 at 4 shards."""
    out = {}
    for name, half in (("packed_bf16_table", jnp.bfloat16), ("packed_fp16_table", jnp.float16)):
        runs = {}
        kinds = [("plain", False, False), ("packed", True, False)]
        if half == jnp.bfloat16:
            kinds.append(("packed_sr", True, True))
        for kind, pack, sr in kinds:
            row = RowSGDM(learning_rate=0.05, momentum=0.9, stochastic_rounding=sr)
            params, _, losses = _jax_run(mesh, half, pack, row)
            runs[kind] = _jax_logical(params["entity_embedding"])
            runs[f"{kind}_losses"] = losses
        out[name] = runs
    row = RowSGDM(learning_rate=0.05, momentum=0.9, weight_decay=0.01, interleaved=True)
    params, _, losses = _jax_run(mesh, None, False, row, interleave_momentum)
    tab, mom = split_interleaved(params["entity_embedding"])
    out["interleaved_row_sgdm"] = {"losses": losses, "table": np.asarray(tab),
                                   "momentum": np.asarray(mom), "b4_block": _jax_b4(mesh)}
    for name, row, widen in (
            ("packed_triplet_interleave", RowSGDM(learning_rate=0.05, momentum=0.9,
                                                  interleaved=True),
             jpk.interleave_packed_momentum),
            ("packed_quint_adamw", RowAdamW(learning_rate=0.05, weight_decay=0.01,
                                            interleaved=True), jpk.interleave_packed_adamw)):
        params, _, losses = _jax_run(mesh, jnp.float16, True, row, widen)
        store = np.asarray(params["entity_embedding"])
        k = 2 if name == "packed_quint_adamw" else 1
        packed, states = ppk.split_packed_state(torch.from_numpy(store.view(np.int32).copy()), k)
        out[name] = {"params": packed.numpy(), "losses": losses,
                     "states": [s.numpy() for s in states]}
    return out


@pytest.fixture(scope="module")
def dry():
    """One spawn of 4 gloo ranks running ``dryrun_multichip(4)`` with the
    JAX package's uniforms in sub-check 7, and beside it the JAX package's
    runs of sub-checks 6-11."""
    mesh = _mesh()
    jdev = _type_sampler(N)
    draws = _jax_uniforms(jdev, jdev.next_key(0))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        ranks = pool.submit(_spawn, R.graft_dryrun, N, (N, draws), timeout=TIMEOUT)
        want = _jax_sub_checks(mesh)
        want["type_device_sampling"] = _jax_type_draw(jdev, mesh)
        return {"ranks": ranks.result(), "want": want,
                "max_e": Sharding.create(16 * N + 3, N, seed=0).max_entity_per_shard}


def test_entry_matches_jax():
    jfn, (jparams, jbatch) = jax_entry.entry()
    jout = jax.tree.map(np.asarray, jax.jit(jfn)(jparams, jbatch))
    fn, (params, batch) = G.entry(device="cpu")
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), err_msg=k)
    carried = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    for k, v in carried.items():
        assert torch.equal(params[k], v), k
    with torch.no_grad():
        out = fn(carried, batch)
    assert out.keys() == jout.keys()
    np.testing.assert_allclose(float(out["loss"]), jout["loss"], rtol=1e-5)
    want = jout["metrics"]
    got = out["metrics"].numpy()
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-5 * (np.abs(want) + np.abs(want).max())).all(), (got, want)


def test_dryrun_prints_every_line_on_every_rank(dry):
    ranks = dry["ranks"]
    assert [r["rank"] for r in ranks] == list(range(N))
    for r in ranks:
        lines = r["lines"]
        assert len(lines) == 12 and list(r["checks"]) == NAMES
        for i, (line, name) in enumerate(zip(lines, NAMES), start=1):
            assert line.startswith(f"  [{i}/11] {name}: PARITY OK ("), line
        assert lines[-1].startswith(f"dryrun_multichip({N}) OK, loss=")
        assert lines[-1].endswith("11/11 golden sub-checks passed")
    # The replicated loss and the global counts are the same on every rank.
    assert len({r["lines"][-1] for r in ranks}) == 1
    assert len({r["lines"][1] for r in ranks}) == 1


def _block(x, rank, n=N):
    rows = x.shape[0] // n
    return x[rank * rows:(rank + 1) * rows]


def _ordinal(words):
    """The 16-bit halves of packed words as integers ordered like their
    values (±0 both 0)."""
    u = np.ascontiguousarray(words).view(np.uint32)
    halves = np.stack([u & 0xFFFF, u >> 16]).astype(np.int64)
    return np.where(halves & 0x8000, -(halves & 0x7FFF), halves)


def _half_ordinal(x, half):
    """fp32 values held exactly in bf16 (``half`` None) or fp16, as their
    16-bit patterns ordered like their values (``_ordinal``)."""
    bits = x.astype(np.float16).view(np.uint16) if half else x.view(np.uint32) >> 16
    b = bits.astype(np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _within_bf16(got, want, what):
    tol = 2.0**-8 * np.abs(want) + 2.0**-12 * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= tol).all(), (what, float(err.max()))


def _within_fp32(got, want, scale, what, rtol=1e-5):
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= rtol * (np.abs(want) + scale)).all(), (what, float(err.max()))


@pytest.mark.parametrize("name", NAMES[5:])
def test_sub_check_matches_jax(dry, name):
    want = dry["want"][name]
    for rank, r in enumerate(dry["ranks"]):
        got = r["checks"][name]["arrays"]
        if name in ("packed_bf16_table", "packed_fp16_table"):
            half = np.float16 if name == "packed_fp16_table" else None
            for kind in [k for k in want if not k.endswith("losses")]:
                apart = np.abs(_half_ordinal(got[kind], half)
                               - _half_ordinal(_block(want[kind], rank), half))
                assert apart.max() <= 1, (name, kind, rank, int(apart.max()))
                np.testing.assert_allclose(got[f"{kind}_losses"], want[f"{kind}_losses"],
                                           rtol=1e-5)
        elif name == "type_device_sampling":
            for k, v in want.items():
                np.testing.assert_array_equal(got["global"][k], v, err_msg=k)
                np.testing.assert_array_equal(got["local"][k], v[:, rank:rank + 1], err_msg=k)
        elif name == "interleaved_row_sgdm":
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
            for k in ("table", "momentum"):
                _within_fp32(got[k], _block(want[k], rank), np.abs(want[k]).max(), k)
            np.testing.assert_allclose(got["b4_block"], want["b4_block"][rank], rtol=1e-6,
                                       atol=1e-7)
            assert got["b4_vs_plain"] == 0.0
        else:
            inter, sep = got["interleaved"], got["separate"]
            np.testing.assert_allclose(inter["losses"], want["losses"], rtol=1e-5)
            assert np.abs(_ordinal(inter["params"])
                          - _ordinal(_block(want["params"], rank))).max() <= 1
            states = ([inter["momentum"]] if name == "packed_triplet_interleave"
                      else [inter["mu"], inter["nu"]])
            for i, (g, w) in enumerate(zip(states, want["states"])):
                _within_bf16(g, _block(w, rank), f"{name} state {i} rank {rank}")
            # The port's two layouts: the check's own bounds, here bit for bit.
            np.testing.assert_array_equal(inter["params"], sep["params"])


def test_nccl_beyond_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="one card per rank"):
        G.dryrun_multichip(4, backend="nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="one card per rank"):
        G.dryrun_multichip(1, backend="nccl", device="cuda")


@pytest.mark.parametrize("fn", [G.entry, G.dryrun_multichip, G._build])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default in ("cuda", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn() if fn is G.entry else fn(1)


def test_spawned_dryrun_prints_rank_0(monkeypatch, capsys):
    """Outside a process group ``dryrun_multichip`` starts its ranks and
    prints rank 0's lines."""
    calls = []

    def spawn(fn, n, args, backend, timeout):
        calls.append((fn, n, args, backend))
        return [{"rank": r, "lines": [f"line of rank {r}"]} for r in range(n)]

    monkeypatch.setattr(G, "_spawn", spawn)
    ranks = G.dryrun_multichip(3, device="cpu")
    assert calls == [(G._rank, 3, (3, "cpu", "gloo"), "gloo")] and len(ranks) == 3
    assert capsys.readouterr().out == "line of rank 0\n"
