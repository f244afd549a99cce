"""The port's checkpoints against the JAX package's: the same files, loaded
by either package, bit for bit.

For every row optimizer and entity-table storage (``RowSGDM``,
``RowAdagrad`` and ``RowAdamW``, interleaved and with separate buffers;
fp32, row-pair-packed bf16 and fp16, plain bf16; ``FusedDenseAdamW``; no
entity optimizer) and each dense optimizer (``optax.sgd`` with and without
momentum and ``optax.adamw`` against the port's ``SGD`` and ``AdamW``), the
two packages write the same arrays under the same keys from the same values,
in the ``.npz`` format and the sharded directory format. Each package loads
the other's file to the values it started from, the JAX package with
``like=`` its optax state, the port with ``like=`` its own state. The
values are random, the interleaved stores' state rows too, so a
de-interleave that mixed planes would show.

Also: resharding 1 → 4 → 1 gives the JAX package's arrays at 4 shards and
the original ones at 1; ``Sharding`` and ``KGDataset`` files cross over both
ways (the port loads a JAX-pickled ``KGDataset`` without importing the JAX
package); the three checks the JAX package lacks raise or hold;
``Trainer.save`` writes the JAX ``Trainer.save`` file; ``Trainer.fit`` saves
with and without ``valid_fn``; and a run saved after two calls and resumed
in a fresh ``Trainer`` equals the uninterrupted run bit for bit.
"""

import filecmp
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import bess as jax_bess
from besskge_tpu import checkpoint as jax_ckpt
from besskge_tpu import dataset as jax_ds
from besskge_tpu import device_sampler as jax_dev
from besskge_tpu import loss as jax_loss
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import packed as jpk
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import checkpoint as port_ckpt
from besskge_tpu_torch import convert
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import device_sampler as port_dev
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer

ROOT = Path(__file__).resolve().parent.parent
N, D, N_REL, LR = 40, 16, 5, 0.05

# (entity optimizer, its kwargs, storage, dense optimizer, layout to save)
CASES = {
    "sgdm_interleaved_fp32": ("RowSGDM", {"interleaved": True}, "fp32", "sgd_m", True),
    "sgdm_interleaved_bf16": ("RowSGDM", {"interleaved": True}, "bf16", "sgd_m", "momentum"),
    "sgdm_interleaved_fp16": ("RowSGDM", {"interleaved": True}, "fp16", "adamw", True),
    "sgdm_separate_fp32": ("RowSGDM", {}, "fp32", "adamw", False),
    "sgdm_separate_bf16": ("RowSGDM", {}, "bf16", "sgd", False),
    "sgdm_separate_plain_bf16": ("RowSGDM", {}, "plain_bf16", "sgd_m", False),
    "adagrad_interleaved_fp32": ("RowAdagrad", {"interleaved": True}, "fp32", "sgd_m", "adagrad"),
    "adagrad_interleaved_bf16": ("RowAdagrad", {"interleaved": True}, "bf16", "adamw", "adagrad"),
    "adagrad_interleaved_fp16": ("RowAdagrad", {"interleaved": True}, "fp16", "sgd", "adagrad"),
    "adagrad_separate_fp32": ("RowAdagrad", {}, "fp32", "sgd_m", False),
    "adagrad_separate_fp16": ("RowAdagrad", {}, "fp16", "sgd_m", False),
    "adamw_interleaved_fp32": ("RowAdamW", {"interleaved": True}, "fp32", "adamw", "adamw"),
    "adamw_interleaved_bf16": ("RowAdamW", {"interleaved": True}, "bf16", "sgd_m", "adamw"),
    "adamw_interleaved_fp16": ("RowAdamW", {"interleaved": True}, "fp16", "sgd_m", "adamw"),
    "adamw_separate_fp32": ("RowAdamW", {}, "fp32", "sgd_m", False),
    "fused_dense_adamw": ("FusedDenseAdamW", {}, "fp32", "adamw", False),
    "dense_adamw": (None, {}, "fp32", "adamw", False),
    "dense_sgd_momentum": (None, {}, "fp32", "sgd_m", False),
    "dense_sgd": (None, {}, "fp32", "sgd", False),
}
RESHARD_CASES = [name for name in CASES if "plain" not in name]


def _dense(kind, jax_side):
    if kind == "adamw":
        return optax.adamw(LR) if jax_side else port_optim.AdamW(LR)
    momentum = 0.9 if kind == "sgd_m" else 0.0
    if jax_side:
        return optax.sgd(LR, momentum=momentum or None)
    return port_optim.SGD(LR, momentum=momentum)


def _random_like(x, rng):
    x = np.asarray(x)
    if x.ndim == 0:
        return np.asarray(7, x.dtype)  # a step count
    return rng.normal(size=x.shape).astype(x.dtype)


def _case(name, seed=0):
    """(JAX params, JAX state, port params, port state, sharding pair, layout)
    holding the same random values."""
    ent_name, kw, storage, dense, layout = CASES[name]
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    jtab = jnp.asarray(table)
    half = {"bf16": jnp.bfloat16, "fp16": jnp.float16}.get(storage)
    if half is not None:
        jtab = jpk.pack_table(jtab.astype(half))
    elif storage == "plain_bf16":
        jtab = jtab.astype(jnp.bfloat16)
    jent = None if ent_name is None else getattr(jax_optim, ent_name)(LR, **kw)
    if kw.get("interleaved"):
        k = 2 if ent_name == "RowAdamW" else 1
        if half is not None:
            states = [jnp.asarray(rng.normal(size=(N, D)).astype(np.float32)) for _ in range(k)]
            jtab = jpk.interleave_packed_state(jtab, states)
        elif k == 1:
            jtab = jax_optim.interleave_momentum(jtab, jnp.asarray(rng.normal(size=(N, D)),
                                                                   jnp.float32))
        else:
            jtab = jax_optim.interleave_adamw(
                jtab, *(jnp.asarray(rng.normal(size=(N, D)), jnp.float32) for _ in range(2)))
    jparams = {"entity_embedding": np.asarray(jtab),
               "relation_embedding": rng.normal(size=(N_REL, D)).astype(np.float32)}
    jstate = jax_trainer.init_optimizer_state(
        _dense(dense, True), {k: jnp.asarray(v) for k, v in jparams.items()}, None, jent)
    jstate = jax.tree.map(lambda x: _random_like(x, rng), jstate)
    pparams = convert.params_from_jax(jparams, "cpu")
    pstate = convert.opt_state_from_jax(jstate, "cpu")
    pair = (jax_sh.Sharding.create(N, 1, seed=0), port_sh.Sharding.create(N, 1, seed=0))
    return jparams, jstate, pparams, pstate, pair, layout


def _bytes(x):
    """(shape, bytes) of a numpy array, a JAX array or a port tensor."""
    if torch.is_tensor(x):
        x = port_ckpt._host(x)
    x = np.asarray(x)
    return x.shape, np.ascontiguousarray(x).tobytes()


def _flat_port(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _equal_port(got, want):
    got, want = _flat_port(got), _flat_port(want)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert _bytes(got[k]) == _bytes(want[k]), k


def _equal_jax(got, want):
    """Two trees of one file layout (JAX's, or the port's as
    :func:`_file_tree` gives it) hold the same keys and bits."""
    got, want = jax_ckpt._flatten(got), jax_ckpt._flatten(want)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert _bytes(got[k]) == _bytes(want[k]), k


def _file_tree(state):
    """The port's optimizer state in the file's (optax) tree, as numpy."""
    return jax.tree.map(port_ckpt._host, port_ckpt._opt_to_file(state))


def _npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _same_npz(a, b):
    fa, fb = _npz(a), _npz(b)
    assert set(fa) == set(fb), (sorted(set(fa) ^ set(fb)))
    for k in fa:
        assert fa[k].dtype.str == fb[k].dtype.str, (k, fa[k].dtype, fb[k].dtype)
        assert _bytes(fa[k]) == _bytes(fb[k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_npz_files_cross_over(name, tmp_path):
    jparams, jstate, pparams, pstate, (jsh, psh), layout = _case(name)
    jpath, ppath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jax_ckpt.save_checkpoint(jpath, jparams, jstate, jsh, step=3, interleaved_entity=layout)
    port_ckpt.save_checkpoint(ppath, pparams, pstate, psh, step=3, interleaved_entity=layout)
    _same_npz(jpath, ppath)
    # the port loads the JAX package's file, and the JAX package the port's
    params, state, sharding, meta = port_ckpt.load_checkpoint(
        jpath, like=pstate, interleave_entity=layout)
    _equal_port(params, pparams)
    _equal_port(state, pstate)
    assert meta == {"step": 3} and np.array_equal(sharding.entity_to_idx, psh.entity_to_idx)
    params, state, _, _ = jax_ckpt.load_checkpoint(ppath, interleave_entity=layout)
    _equal_jax(params, jparams)
    _equal_jax(state, jstate)
    if not layout:
        # the JAX package's like= keeps only the template's keys before it
        # re-interleaves, so it is held with a template where nothing is
        # interleaved
        _, state, _, _ = jax_ckpt.load_checkpoint(ppath, like=jstate)
        assert jax.tree.structure(state) == jax.tree.structure(jstate)
        _equal_jax(state, jstate)
    # without a template the port reads its state from the keys (a plain
    # optax.sgd run without an entity optimizer keeps none: None)
    state = port_ckpt.load_checkpoint(ppath, interleave_entity=layout)[1]
    if name == "dense_sgd":
        assert state is None
    else:
        _equal_port(state, pstate)


@pytest.mark.parametrize("name", ["sgdm_interleaved_fp32", "sgdm_separate_plain_bf16",
                                  "adagrad_interleaved_fp16", "adamw_interleaved_bf16",
                                  "fused_dense_adamw", "dense_adamw", "dense_sgd"])
def test_sharded_directories_cross_over(name, tmp_path):
    jparams, jstate, pparams, pstate, (jsh, psh), _ = _case(name)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_ckpt.save_checkpoint_sharded(jdir, jparams, jstate, jsh, step=5)
    port_ckpt.save_checkpoint_sharded(pdir, pparams, pstate, psh, step=5)
    files = sorted(p.name for p in jdir.iterdir())
    assert files == sorted(p.name for p in pdir.iterdir()) == [
        "meta.json", "replicated.npz", "shard_00000.npz", "sharding.npz"]
    for f in files:
        if f.endswith(".npz"):
            _same_npz(jdir / f, pdir / f)
    assert filecmp.cmp(jdir / "meta.json", pdir / "meta.json", shallow=False)
    params, state, _, meta = port_ckpt.load_checkpoint_sharded(jdir, like=pstate)
    _equal_port(params, pparams)
    _equal_port(state, pstate)
    assert meta["step"] == 5
    params, state, _, _ = jax_ckpt.load_checkpoint_sharded(pdir, like=jstate)
    _equal_jax(params, jparams)
    _equal_jax(state, jstate)


@pytest.mark.parametrize("name", RESHARD_CASES)
def test_reshard_one_four_one_matches_jax(name, tmp_path):
    jparams, jstate, pparams, pstate, (jsh, psh), layout = _case(name, seed=1)
    jpath, ppath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jax_ckpt.save_checkpoint(jpath, jparams, jstate, jsh, interleaved_entity=layout)
    port_ckpt.save_checkpoint(ppath, pparams, pstate, psh, interleaved_entity=layout)
    j4, p4 = jax_sh.Sharding.create(N, 4, seed=3), port_sh.Sharding.create(N, 4, seed=3)
    jp, js, _, _ = jax_ckpt.load_checkpoint(jpath, new_sharding=j4, interleave_entity=layout)
    pp, ps, psh4, _ = port_ckpt.load_checkpoint(ppath, new_sharding=p4, like=pstate,
                                                interleave_entity=layout)
    assert psh4 is p4
    _equal_jax(pp, jp)
    _equal_jax(_file_tree(ps), js)
    assert _bytes(pp["entity_embedding"]) != _bytes(pparams["entity_embedding"])
    # back to one shard through a second file
    port_ckpt.save_checkpoint(ppath, pp, ps, psh4, interleaved_entity=layout)
    back, back_state, back_sh, _ = port_ckpt.load_checkpoint(
        ppath, new_sharding=psh, like=pstate, interleave_entity=layout)
    assert back_sh is psh
    _equal_port(back, pparams)
    _equal_port(back_state, pstate)


def test_reshard_plain_bf16_table():
    """A plain bf16 table in a file is ``|V2``, which the JAX package cannot
    reshard (``astype(float32)`` of a void array); the port reshards it by
    its bits, as the same values in fp32."""
    jparams, jstate, pparams, pstate, (_, psh), _ = _case("sgdm_separate_plain_bf16")
    p4 = port_sh.Sharding.create(N, 4, seed=3)
    as_fp32 = port_ckpt._reshard(pparams["entity_embedding"].float().numpy(), psh, p4)
    bits = port_ckpt._reshard(port_ckpt._host(pparams["entity_embedding"]), psh, p4)
    assert bits.dtype.str == "|V2"
    np.testing.assert_array_equal(
        (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32), as_fp32)
    back = port_ckpt._reshard(bits, p4, psh)
    assert _bytes(back) == _bytes(pparams["entity_embedding"])


def test_only_entity_state_is_resharded(tmp_path):
    """A dense state of another param that happens to have the entity
    table's shape is left as it is (the JAX package permutes it as if it
    were an entity row state)."""
    rng = np.random.default_rng(4)
    jparams = {"entity_embedding": rng.normal(size=(N, D)).astype(np.float32),
               "relation_embedding": rng.normal(size=(N, D)).astype(np.float32)}
    jstate = jax_trainer.init_optimizer_state(
        optax.sgd(LR, momentum=0.9), {k: jnp.asarray(v) for k, v in jparams.items()}, None,
        jax_optim.RowSGDM(LR))
    jstate = jax.tree.map(lambda x: _random_like(x, rng), jstate)
    pparams, pstate = convert.params_from_jax(jparams, "cpu"), convert.opt_state_from_jax(
        jstate, "cpu")
    path = tmp_path / "c.npz"
    port_ckpt.save_checkpoint(path, pparams, pstate, port_sh.Sharding.create(N, 1, seed=0))
    p4 = port_sh.Sharding.create(N, 4, seed=3)
    params, state, _, _ = port_ckpt.load_checkpoint(path, new_sharding=p4)
    trace = state["other"]["trace"]["relation_embedding"]
    assert torch.equal(trace, pstate["other"]["trace"]["relation_embedding"])
    assert torch.equal(params["relation_embedding"], pparams["relation_embedding"])
    assert not torch.equal(state["entity"]["m"], pstate["entity"]["m"])  # the entity state moved
    _, jnew, _, _ = jax_ckpt.load_checkpoint(path, new_sharding=jax_sh.Sharding.create(N, 4, 3))
    assert not np.array_equal(jnew["other"][0][0]["relation_embedding"], trace.numpy())


def test_unknown_layouts_and_heights_raise(tmp_path):
    """The JAX package's save reshapes whatever it is given, and its load
    takes any unknown truthy layout as the momentum one: the port raises."""
    rng = np.random.default_rng(5)
    sh = port_sh.Sharding.create(N, 1, seed=0)
    state = {"entity": {"count": torch.tensor(1, dtype=torch.int32)}, "other": {
        "count": torch.tensor(1, dtype=torch.int32)}}
    trebled = {"entity_embedding": torch.from_numpy(rng.normal(size=(3 * 13, D)).astype(np.float32))}
    with pytest.raises(ValueError, match="unknown interleaved layout 'adam'"):
        port_ckpt.save_checkpoint(tmp_path / "a.npz", trebled, state, sh, interleaved_entity="adam")
    # a treble-major fp32 store of an odd count saved as pairs
    with pytest.raises(ValueError, match="2 rows per row; got a table of 39 rows"):
        port_ckpt.save_checkpoint(tmp_path / "a.npz", trebled, state, sh, interleaved_entity=True)
    triplet = {"entity_embedding": torch.zeros((3 * 7, D), dtype=torch.int32)}
    with pytest.raises(ValueError, match="5 rows per packed row"):
        port_ckpt.save_checkpoint(tmp_path / "a.npz", triplet, state, sh,
                                  interleaved_entity="adamw")
    plain = {"entity_embedding": torch.zeros((N, D))}
    port_ckpt.save_checkpoint(tmp_path / "ok.npz", plain, state, sh)
    for bad in ("adam", "Momentum", 1, None):
        with pytest.raises(ValueError, match="unknown interleaved layout"):
            port_ckpt.load_checkpoint(tmp_path / "ok.npz", interleave_entity=bad)


def test_sharded_reshard_of_a_widened_table_raises(tmp_path):
    jparams, jstate, pparams, pstate, (_, psh), _ = _case("sgdm_interleaved_fp32")
    port_ckpt.save_checkpoint_sharded(tmp_path / "d", pparams, pstate, psh)
    with pytest.raises(ValueError, match="cannot re-shard a table of 80 rows per shard"):
        port_ckpt.load_checkpoint_sharded(tmp_path / "d",
                                          new_sharding=port_sh.Sharding.create(N, 4, 3))
    with pytest.raises(TypeError, match="ShardMesh"):
        port_ckpt.load_checkpoint_sharded(tmp_path / "d", mesh="mesh")


def test_sharded_reshard_matches_jax(tmp_path):
    jparams, jstate, pparams, pstate, (jsh, psh), _ = _case("adamw_separate_fp32", seed=2)
    port_ckpt.save_checkpoint_sharded(tmp_path / "d", pparams, pstate, psh)
    p4, j4 = port_sh.Sharding.create(N, 4, seed=3), jax_sh.Sharding.create(N, 4, seed=3)
    pp, ps, _, _ = port_ckpt.load_checkpoint_sharded(tmp_path / "d", new_sharding=p4, like=pstate)
    jp, js, _, _ = jax_ckpt.load_checkpoint_sharded(tmp_path / "d", new_sharding=j4, like=jstate)
    _equal_jax(pp, jp)
    _equal_jax(_file_tree(ps), js)


@pytest.mark.parametrize("typed", [False, True])
def test_sharding_files_cross_over(typed, tmp_path):
    offsets = np.array([0, 17, 30]) if typed else None
    jsh = jax_sh.Sharding.create(N, 4, seed=2, type_offsets=offsets)
    psh = port_sh.Sharding.create(N, 4, seed=2, type_offsets=offsets)
    jsh.save(tmp_path / "j.npz")
    psh.save(tmp_path / "p.npz")
    _same_npz(tmp_path / "j.npz", tmp_path / "p.npz")
    for loaded, want in ((port_sh.Sharding.load(tmp_path / "j.npz"), jsh),
                         (jax_sh.Sharding.load(tmp_path / "p.npz"), psh)):
        assert loaded.n_shard == want.n_shard
        for field in ("entity_to_shard", "entity_to_idx", "shard_and_idx_to_entity",
                      "shard_counts", "entity_type_counts", "entity_type_offsets"):
            a, b = getattr(loaded, field), getattr(want, field)
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), field


def _dataset(mod):
    rng = np.random.default_rng(6)
    return mod.KGDataset.from_triples(
        rng.integers(0, 30, size=(200, 3)).astype(np.int32), seed=1,
        entity_dict=[f"e{i}" for i in range(30)], type_offsets={"a": 0, "b": 12})


def _same_dataset(a, b):
    assert (a.n_entity, a.n_relation_type, a.entity_dict, a.type_offsets, a.neg_heads) == (
        b.n_entity, b.n_relation_type, b.entity_dict, b.type_offsets, b.neg_heads)
    for part in b.triples:
        assert np.array_equal(a.triples[part], b.triples[part])
        assert np.array_equal(a.original_triple_ids[part], b.original_triple_ids[part])


def test_dataset_files_cross_over(tmp_path):
    jds, pds = _dataset(jax_ds), _dataset(port_ds)
    jds.save(tmp_path / "j.pkl")
    pds.save(tmp_path / "p.pkl")
    loaded = jax_ds.KGDataset.load(tmp_path / "p.pkl")
    assert type(loaded) is jax_ds.KGDataset
    _same_dataset(loaded, jds)
    loaded = port_ds.KGDataset.load(tmp_path / "j.pkl")
    assert type(loaded) is port_ds.KGDataset
    _same_dataset(loaded, pds)
    # in a process of its own: no JAX and no JAX package
    code = (
        "import sys\n"
        "from besskge_tpu_torch.dataset import KGDataset\n"
        f"ds = KGDataset.load({str(tmp_path / 'j.pkl')!r})\n"
        "assert type(ds) is KGDataset and ds.n_entity == 30, ds\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'besskge_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_update_sharding_matches_jax():
    rng = np.random.default_rng(7)
    table = rng.normal(size=(N, 8)).astype(np.float32)
    for half in (None, jnp.bfloat16, jnp.float16):
        jsh, psh = jax_sh.Sharding.create(N, 1, 0), port_sh.Sharding.create(N, 1, 0)
        jfn = jax_scoring.TransE(True, 1, jsh, 3, 8, seed=0)
        pfn = port_scoring.TransE(True, 1, psh, 3, 8, seed=0)
        jtab = jnp.asarray(table) if half is None else jpk.pack_table(jnp.asarray(table).astype(half))
        jparams = {"entity_embedding": jtab, "relation_embedding": jnp.zeros((3, 8))}
        pparams = convert.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
        j4, p4 = jax_sh.Sharding.create(N, 4, 2), port_sh.Sharding.create(N, 4, 2)
        jout, pout = jfn.update_sharding(jparams, j4), pfn.update_sharding(pparams, p4)
        assert pfn.sharding is p4
        got = pout["entity_embedding"]
        assert got.dtype == pparams["entity_embedding"].dtype
        assert _bytes(got) == _bytes(np.asarray(jout["entity_embedding"]))


def _module(pkg, storage="fp32"):
    """A small wikikg2-like TransE-L1 module and its device sampler."""
    ds_mod, sh_mod, ns_mod, dev_mod, sc_mod, bess_mod, loss_mod = pkg
    n_entity = 600
    rng = np.random.default_rng(0)
    tri = np.stack([rng.integers(n_entity, size=3000), rng.integers(7, size=3000),
                    rng.integers(n_entity, size=3000)], 1).astype(np.int32)
    ds = ds_mod.KGDataset(n_entity=n_entity, n_relation_type=7, triples={"train": tri},
                          original_triple_ids={"train": np.arange(len(tri))})
    sharding = sh_mod.Sharding.create(n_entity, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    ns = ns_mod.RandomShardedNegativeSampler(16, sharding, 0, "ht", local_sampling=False,
                                             flat_negative_format=True)
    score_fn = sc_mod.TransE(negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
                             n_relation_type=7, embedding_size=64, seed=0)
    if storage != "fp32":
        jax_side = pkg[0] is jax_ds
        score_fn.compute_dtype = jnp.bfloat16 if jax_side else torch.bfloat16
        score_fn.dtype = jnp.bfloat16 if jax_side else torch.bfloat16
        score_fn.packed_entity_storage = True
    module = bess_mod.EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=loss_mod.SampledSoftmaxCrossEntropyLoss(n_entity), augment_negative=True,
        axis_name=None)
    dev = dev_mod.DeviceBatchSampler(pts, ns, shard_bs=32, batches_per_step=2, seed=0,
                                     positive_mode="runs")
    return module, dev


JAX = (jax_ds, jax_sh, jax_ns, jax_dev, jax_scoring, jax_bess, jax_loss)
PORT = (port_ds, port_sh, port_ns, port_dev, port_scoring, port_bess, port_loss)


@pytest.mark.parametrize("ent,storage", [("RowAdamW", "fp32"), ("RowAdagrad", "fp32"),
                                         ("RowAdagrad", "bf16"), ("RowSGDM", "bf16")])
def test_trainer_save_matches_jax_trainer_save(ent, storage, tmp_path):
    """``Trainer.save`` of an interleaved optimizer de-interleaves it in its
    own layout (``interleave_layout``), as the JAX package's does."""
    jmod, jdev = _module(JAX, storage)
    pmod, pdev = _module(PORT, storage)
    params = jmod.score_fn.initial_params()
    jtr = jax_trainer.Trainer(jmod, jdev, optax.sgd(LR, momentum=0.9), params=params,
                              entity_optimizer=getattr(jax_optim, ent)(LR, interleaved=True))
    ptr = port_trainer.Trainer(
        pmod, pdev, port_optim.SGD(LR, momentum=0.9),
        params=convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
        entity_optimizer=getattr(port_optim, ent)(LR, interleaved=True), device="cpu")
    jtr.save(str(tmp_path / "j.npz"), step=4)
    ptr.save(str(tmp_path / "p.npz"), step=4)
    _same_npz(tmp_path / "j.npz", tmp_path / "p.npz")
    state_keys = {k for k in _npz(tmp_path / "p.npz") if k.startswith("opt/entity/")}
    want = {"RowAdamW": {"mu", "nu"}, "RowAdagrad": {"acc"}, "RowSGDM": {"m"}}[ent]
    assert state_keys == {f"opt/entity/{k}" for k in want | {"count"}}
    jtr.save(str(tmp_path / "jd"), step=4, sharded=True)
    ptr.save(str(tmp_path / "pd"), step=4, sharded=True)
    for f in ("replicated.npz", "shard_00000.npz", "sharding.npz"):
        _same_npz(tmp_path / "jd" / f, tmp_path / "pd" / f)


def _trainer(storage, ent, params=None):
    module, dev = _module(PORT, storage)
    return port_trainer.Trainer(module, dev, port_optim.SGD(LR, momentum=0.9), params=params,
                                entity_optimizer=ent, steps_per_call=2, device="cpu")


def _run_calls(tr, calls):
    for i in calls:
        tr.params, tr.opt_state, _ = tr.train_step(tr.params, tr.opt_state, tr.sampler_state,
                                                   tr.batch_sampler.next_key(i))


@pytest.mark.parametrize("ent,storage", [
    (port_optim.RowSGDM(LR, 0.9, interleaved=True), "fp32"),
    (port_optim.RowSGDM(LR, 0.9, interleaved=True), "bf16"),
    (port_optim.RowAdagrad(LR, interleaved=True), "fp32"),
    (port_optim.RowAdagrad(LR), "bf16"),
    (port_optim.RowAdamW(LR), "fp32"),
], ids=["sgdm_fp32", "sgdm_bf16", "adagrad_interleaved", "adagrad_bf16", "adamw"])
def test_resume_equals_uninterrupted_run(ent, storage, tmp_path):
    """Two device-sampled calls, ``Trainer.save``, a fresh ``Trainer`` from
    ``load_checkpoint`` with its optimizer state from the file, then calls 2
    and 3: every array equals four calls without a break, bit for bit."""
    whole = _trainer(storage, ent)
    start = {k: v.clone() for k, v in whole.params.items()}
    _run_calls(whole, range(4))
    first = _trainer(storage, ent, params={k: v.clone() for k, v in start.items()})
    _run_calls(first, range(2))
    first.save(str(tmp_path / "c.npz"), step=2)
    layout = ent.interleave_layout if ent.interleaved else False
    params, state, _, meta = port_ckpt.load_checkpoint(tmp_path / "c.npz", interleave_entity=layout)
    assert meta == {"step": 2}
    resumed = _trainer(storage, ent, params=params)
    resumed.opt_state = port_ckpt.load_checkpoint(
        tmp_path / "c.npz", like=resumed.opt_state, interleave_entity=layout)[1]
    _equal_port(resumed.opt_state, state)
    for count in (resumed.opt_state["entity"]["count"], resumed.opt_state["other"]["count"]):
        assert count.dtype == torch.int32 and count.dim() == 0 and int(count) == 4
    _run_calls(resumed, range(2, 4))
    _equal_port(resumed.params, whole.params)
    _equal_port(resumed.opt_state, whole.opt_state)


@pytest.mark.parametrize("metrics,saves", [(None, [4]), ([0.5, 0.7], [2, 4]), ([0.7, 0.5], [2])])
def test_fit_saves_checkpoints(metrics, saves, tmp_path, monkeypatch):
    """``Trainer.fit(checkpoint_path=...)``: with ``valid_fn``, a save at
    each epoch whose metric improves; without one, a save after the last
    epoch."""
    tr = _trainer("fp32", port_optim.RowSGDM(LR, 0.9, interleaved=True))
    monkeypatch.setattr(type(tr.batch_sampler), "__len__", lambda self: 4)  # 2 calls per epoch
    steps = []
    orig = tr.save
    monkeypatch.setattr(tr, "save", lambda path, step=0: (steps.append(step), orig(path, step)))
    valid = None if metrics is None else (lambda p, it=iter(metrics): {"mrr": next(it)})
    path = tmp_path / "best.npz"
    summary = tr.fit(n_epochs=2, valid_fn=valid, checkpoint_path=str(path))
    assert steps == saves and summary["steps"] == 4
    if metrics is not None:
        assert summary["best_mrr"] == max(metrics)
    params, state, _, meta = port_ckpt.load_checkpoint(path, interleave_entity=True)
    assert meta["step"] == saves[-1]
    if saves[-1] == 4:
        _equal_port(params, tr.params)
        _equal_port(state, tr.opt_state)


def test_schedule_counts_load_from_a_jax_file(tmp_path):
    """``optax.adamw`` with a schedule keeps a second count
    (``scale_by_schedule``, ``#2/#0``); the port reads the dense state of
    such a file with the Adam count, and a separate-buffer entity state as
    it is."""
    rng = np.random.default_rng(8)
    jparams = {"entity_embedding": rng.normal(size=(N, D)).astype(np.float32),
               "relation_embedding": rng.normal(size=(N_REL, D)).astype(np.float32)}
    jstate = jax_trainer.init_optimizer_state(
        optax.adamw(optax.linear_schedule(0.1, 0.01, 10)),
        {k: jnp.asarray(v) for k, v in jparams.items()}, None, jax_optim.RowAdagrad(LR))
    jstate = jax.tree.map(lambda x: _random_like(x, rng), jstate)
    adam, decay, schedule = jstate["other"]
    jstate["other"] = (adam._replace(count=np.int32(5)), decay,
                       schedule._replace(count=np.int32(9)))
    path = tmp_path / "s.npz"
    jax_ckpt.save_checkpoint(path, jparams, jstate, jax_sh.Sharding.create(N, 1, 0))
    assert "opt/other/#2/#0" in _npz(path)
    _, state, _, _ = port_ckpt.load_checkpoint(path)
    assert set(state["other"]) == {"count", "mu", "nu"}
    adam = jstate["other"][0]
    assert int(state["other"]["count"]) == 5
    assert _bytes(state["other"]["mu"]["relation_embedding"]) == _bytes(adam.mu["relation_embedding"])
    assert _bytes(state["entity"]["acc"]) == _bytes(jstate["entity"]["acc"])
