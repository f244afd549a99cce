"""The port's data layer and initializers against the JAX package's, bit for bit.

``besskge_tpu_torch``'s dataset, sharding, batch sampler and numpy
initializers are copies of the JAX package's numpy code: for the same seeds
every array they produce must be equal, dtype included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import dataset as jax_ds
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import packed as port_packed
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import utils as port_utils


def _assert_same(x, y):
    if x is None or y is None:
        assert x is None and y is None
        return
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def _assert_same_fields(a, b):
    for field in dataclasses.fields(a):
        if field.name == "sharding":
            _assert_same_fields(a.sharding, b.sharding)
            continue
        va, vb = getattr(a, field.name), getattr(b, field.name)
        if isinstance(va, (np.ndarray, type(None))):
            _assert_same(va, vb)
        elif isinstance(va, dict):
            assert va.keys() == vb.keys()
            for k in va:
                _assert_same(va[k], vb[k])
        else:
            assert va == vb, field.name


@pytest.mark.parametrize("n_entity,n_shard", [(317, 1), (1000, 1), (317, 4)])
def test_sharding_matches(n_entity, n_shard):
    offsets = np.array([0, 100, 250])
    for type_offsets in (None, offsets):
        a = jax_sh.Sharding.create(n_entity, n_shard, seed=11, type_offsets=type_offsets)
        b = port_sh.Sharding.create(n_entity, n_shard, seed=11, type_offsets=type_offsets)
        _assert_same_fields(a, b)


def test_dataset_from_triples_matches():
    rng = np.random.default_rng(2)
    data = np.stack(
        [rng.integers(50, size=400), rng.integers(5, size=400), rng.integers(50, size=400)], 1
    ).astype(np.int32)
    offs = {"a": 0, "b": 20}
    a = jax_ds.KGDataset.from_triples(data, seed=9, type_offsets=offs)
    b = port_ds.KGDataset.from_triples(data, seed=9, type_offsets=offs)
    _assert_same_fields(a, b)
    for part in a.ht_types:
        _assert_same(a.ht_types[part], b.ht_types[part])


def _query_set(mod_sh, mod_ds, query_mode, n_entity=2000, n_query=300):
    rng = np.random.default_rng(5)
    sharding = mod_sh.Sharding.create(n_entity, 1, seed=4)
    ds = mod_ds.KGDataset(
        n_entity=n_entity, n_relation_type=9,
        triples={"test": np.zeros((1, 3), np.int32)},
        original_triple_ids={"test": np.arange(1)},
    )
    queries = np.stack(
        [rng.integers(n_entity, size=n_query), rng.integers(9, size=n_query)], 1
    ).astype(np.int32)
    if query_mode == "rt":
        queries = queries[:, ::-1].copy()
    gt = rng.integers(n_entity, size=n_query).astype(np.int32)
    return mod_sh.PartitionedTripleSet.create_from_queries(
        ds, sharding, queries, query_mode, ground_truth=gt
    )


@pytest.mark.parametrize("query_mode", ["hr", "rt"])
def test_partitioned_queries_and_batches_match(query_mode):
    pts = {
        "jax": _query_set(jax_sh, jax_ds, query_mode),
        "port": _query_set(port_sh, port_ds, query_mode),
    }
    _assert_same_fields(pts["jax"], pts["port"])
    scheme = "t" if query_mode == "hr" else "h"
    jax_sampler = jax_bs.RigidShardedBatchSampler(
        pts["jax"], jax_ns.PlaceholderNegativeSampler(scheme, seed=1),
        shard_bs=64, batches_per_step=2, seed=3, return_triple_idx=True,
        use_native=False,
    )
    port_sampler = port_bs.RigidShardedBatchSampler(
        pts["port"], port_ns.PlaceholderNegativeSampler(scheme, seed=1),
        shard_bs=64, batches_per_step=2, seed=3, return_triple_idx=True,
    )
    assert len(jax_sampler) == len(port_sampler)
    for shuffle in (False, True):
        jax_blocks = list(jax_sampler.epoch_index_blocks(shuffle))
        port_blocks = list(port_sampler.epoch_index_blocks(shuffle))
        assert len(jax_blocks) == len(port_blocks) > 1
        for jb, pb in zip(jax_blocks, port_blocks):
            _assert_same(jb, pb)
            want, got = jax_sampler.sample_batch(jb), port_sampler.sample_batch(pb)
            assert want.keys() == got.keys()
            for key in want:
                _assert_same(want[key], got[key])


def test_initial_params_match():
    sharding = jax_sh.Sharding.create(777, 1, seed=8)
    kw = dict(negative_sample_sharing=True, scoring_norm=1, n_relation_type=13,
              embedding_size=128, seed=21)
    want = jax_scoring.TransE(sharding=sharding, **kw).initial_params()
    port_sharding = port_sh.Sharding.create(777, 1, seed=8)
    got = port_scoring.TransE(sharding=port_sharding, **kw).initial_params(device="cpu")
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == torch.float32
        _assert_same(want[key], got[key].numpy())


def test_initial_params_device_draws_on_the_device_in_range():
    sharding = port_sh.Sharding.create(500, 1, seed=8)
    fn = port_scoring.TransE(True, 1, sharding, 7, 64, seed=3)
    p1 = fn.initial_params_device(device="cpu")
    p2 = fn.initial_params_device(device="cpu")
    assert p1["entity_embedding"].shape == (sharding.max_entity_per_shard, 64)
    assert p1["relation_embedding"].shape == (7, 64)
    for key in p1:
        assert torch.equal(p1[key], p2[key])  # seeded from fn.seed
        assert p1[key].abs().max() <= 1 / 64
    assert p1["entity_embedding"].std() > 0.5 / 64 / np.sqrt(3)


def test_gather_indices_matches_take_along_axis():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 9)).astype(np.float32)
    for idx in (rng.integers(9, size=(4, 5)), rng.integers(9, size=(1, 5))):
        want = np.take_along_axis(np.broadcast_to(x, (4, 9)), np.broadcast_to(idx, (4, 5)), 1)
        got = port_utils.gather_indices(torch.from_numpy(x), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)


def test_take_rows_plain_and_unported_layouts():
    table = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    idx = torch.tensor([[5, 0], [2, 2]])
    assert torch.equal(port_packed.take_rows(table, idx, 6), table[idx])
    assert torch.equal(port_packed.take_rows(table[None], idx, 6), table[idx])
    assert torch.equal(port_packed.take_contiguous_rows(table, 2, 3, 6), table[2:5])
    with pytest.raises(ValueError):
        port_packed.take_contiguous_rows(table, 4, 3, 6)
    # int32 storage is a row-pair-packed bf16 table (ROADMAP A9, ported):
    # logical row i is the halfword plane i % 2 of packed row i // 2.
    packed = port_packed.pack_table(table)
    assert packed.dtype == torch.int32 and packed.shape == (3, 4)
    assert torch.equal(port_packed.take_rows(packed, idx, 6), table[idx].to(torch.bfloat16))
    # (2N, D): pair-major interleaved, param row i at physical row 2i.
    pair_idx = torch.tensor([[2, 0], [1, 1]])
    assert torch.equal(port_packed.take_rows(table, pair_idx, 3), table[2 * pair_idx])
    assert torch.equal(port_packed.take_contiguous_rows(table, 0, 2, 3), table[0:4:2])
    # (3N, D): treble-major interleaved AdamW, param row i at physical row 3i.
    treb_idx = torch.tensor([[1, 0], [1, 1]])
    assert torch.equal(port_packed.take_rows(table, treb_idx, 2), table[3 * treb_idx])
    assert torch.equal(port_packed.take_contiguous_rows(table, 0, 2, 2), table[0:6:3])
