"""The port's on-device batch sampling against the JAX package's.

``DeviceBatchSampler`` draws a training batch from a key. The port's random
numbers are its own (a counter hash, ``device_sampler._uniform``), so the
parity tests put the JAX package's uniforms for the same key in their place:
``jax.random.split(key)`` into the positive and negative streams, then
``jax.random.uniform`` of each draw's shape. Given those, every index of the
port's batch (heads, relations, tails, negatives, random or type-based) is
equal to the JAX package's bit for bit: both map a uniform to an index in
float32 the same way. The one float sum, of the triple weights of a
micro-batch, runs in PyTorch's order in the port and in XLA's in the JAX
package; the two differ by that sum's rounding, at most ``n·2^-24`` of the
sum on each side for ``n`` terms, so ``triple_weight`` is held to
``2·n·2^-24`` relative.

The contract tests of ``tests/test_device_sampler.py`` have their twins here
on the port's own draws, and the host-side ``TypeBasedShardedNegativeSampler``
and the batch sampler's ``hrt_freq_weighting``, ``weight_smoothing`` and
``duplicate_batch`` are held to the JAX package's bit for bit for the same
seed.
"""

import jax
import numpy as np
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import dataset as jax_ds
from besskge_tpu import device_sampler as jax_dev
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import sharding as jax_sh
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import device_sampler as port_dev
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import sharding as port_sh

SEED = 11
N_SHARD = 4
N_ENTITY = 360
N_RELATION = 6
TYPE_OFFSETS = np.asarray([0, 120, 240])

JAX = (jax_ds, jax_sh, jax_ns, jax_dev, jax_bs)
PORT = (port_ds, port_sh, port_ns, port_dev, port_bs)


def _triples(n_triple=3000):
    rng = np.random.default_rng(SEED)
    return np.stack([rng.integers(N_ENTITY, size=n_triple),
                     rng.integers(N_RELATION, size=n_triple),
                     rng.integers(N_ENTITY, size=n_triple)], 1).astype(np.int32)


def _pts(pkg, typed=False, partition_mode="ht_shardpair", queries=False, n_triple=3000):
    ds_mod, sh_mod = pkg[:2]
    tri = _triples(n_triple)
    ds = ds_mod.KGDataset(
        n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"train": tri},
        original_triple_ids={"train": np.arange(len(tri))},
        type_offsets={"a": 0, "b": 120, "c": 240} if typed else None,
    )
    sharding = sh_mod.Sharding.create(
        N_ENTITY, N_SHARD, seed=SEED, type_offsets=TYPE_OFFSETS if typed else None)
    if queries:  # (h, r, ?) queries: h_shard partitions with a dummy tail
        return sharding, sh_mod.PartitionedTripleSet.create_from_queries(
            ds, sharding, tri[:, :2], "hr")
    return sharding, sh_mod.PartitionedTripleSet.create_from_dataset(
        ds, "train", sharding, partition_mode=partition_mode)


def _negative_sampler(pkg, sharding, pts, typed=False, corruption="t", n_negative=5,
                      flat=False, local=False):
    ns_mod = pkg[2]
    if typed:
        return ns_mod.TypeBasedShardedNegativeSampler(
            pts.types, n_negative, sharding, corruption, local_sampling=local, seed=SEED)
    return ns_mod.RandomShardedNegativeSampler(
        n_negative, sharding, SEED, corruption, local_sampling=local,
        flat_negative_format=flat)


def _device_sampler(pkg, typed=False, corruption="t", shard_bs=24, bps=2, n_negative=5,
                    flat=False, local=False, hrt=False, positive_mode="iid",
                    partition_mode="ht_shardpair", queries=False):
    sharding, pts = _pts(pkg, typed, partition_mode, queries)
    ns = _negative_sampler(pkg, sharding, pts, typed, corruption, n_negative, flat, local)
    return pkg[3].DeviceBatchSampler(
        pts, ns, shard_bs=shard_bs, batches_per_step=bps, seed=SEED,
        hrt_freq_weighting=hrt, weight_smoothing=0.5 if hrt else 0.0,
        positive_mode=positive_mode)


def _jax_uniforms(jdev, key):
    """The JAX sampler's uniforms for ``key``: [positive draws, negative
    draws], as ``sample`` draws them."""
    bps, S, ppp = jdev.batches_per_step, jdev.n_shard, jdev.positive_per_partition
    k_pos, k_neg = jax.random.split(key)
    counts_shape = np.asarray(jdev._counts).shape
    if jdev.positive_mode == "runs":
        pos_shape = (bps, *counts_shape)
    else:
        pos_shape = (bps, *counts_shape, ppp)
    ns = jdev.negative_sampler
    shard_bs = ppp * (S if jdev.triple_partition_mode == "ht_shardpair" else 1)
    b = (2 if ns.corruption_scheme == "ht" else 1) if ns.flat_negative_format else shard_bs
    return [np.asarray(jax.random.uniform(k_pos, pos_shape)),
            np.asarray(jax.random.uniform(k_neg, (bps, S, S, b, ns.n_negative)))]


def _with_uniforms(monkeypatch, draws):
    """Put ``draws`` (numpy uniforms, in draw order) in place of the port's
    own: each call of ``_uniform`` takes the next one."""
    queue = list(draws)

    def uniform(key, stream, shape):
        u = torch.from_numpy(np.array(queue.pop(0)))
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u.to(key.device)

    monkeypatch.setattr(port_dev, "_uniform", uniform)
    return queue


def _assert_batch_equal(got, want, shard_bs):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key].cpu().numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, (key, g.shape, w.shape, g.dtype)
        if key == "triple_weight":
            np.testing.assert_allclose(g, w, rtol=2 * shard_bs * 2.0**-24, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


CASES = {
    "iid-shardpair-random": {},
    "runs-shardpair-random": dict(positive_mode="runs"),
    "iid-hshard-random": dict(partition_mode="h_shard"),
    "runs-hshard-random": dict(partition_mode="h_shard", positive_mode="runs"),
    "iid-shardpair-type": dict(typed=True),
    "runs-shardpair-type": dict(typed=True, positive_mode="runs"),
    "iid-hshard-type": dict(typed=True, partition_mode="h_shard"),
    "runs-hshard-type": dict(typed=True, partition_mode="h_shard", positive_mode="runs"),
    "type-ht-local": dict(typed=True, corruption="ht", local=True),
    "type-h": dict(typed=True, corruption="h"),
    "flat-ht": dict(corruption="ht", flat=True),
    "hrt-weights": dict(hrt=True),
    "hrt-weights-runs": dict(hrt=True, positive_mode="runs", typed=True),
    "dummy-tail": dict(queries=True),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_sample_equals_jax_given_its_uniforms(monkeypatch, case):
    kw = CASES[case]
    jdev, pdev = _device_sampler(JAX, **kw), _device_sampler(PORT, **kw)
    assert len(pdev) == len(jdev)
    assert pdev.positive_per_partition == jdev.positive_per_partition
    jstate, pstate = jdev.state(), pdev.state("cpu")
    assert jstate.keys() == pstate.keys()
    for key in jstate:
        np.testing.assert_array_equal(pstate[key].numpy(), np.asarray(jstate[key]), err_msg=key)
    for step in (0, 5):
        jkey = jdev.next_key(step)
        queue = _with_uniforms(monkeypatch, _jax_uniforms(jdev, jkey))
        got = pdev.sample(pstate, pdev.next_key(step))
        assert not queue
        _assert_batch_equal(got, jdev.sample(jstate, jkey), pdev.shard_bs)
        if kw.get("queries"):
            assert "tail" not in got


def test_slice_local_equals_jax(monkeypatch):
    jdev, pdev = _device_sampler(JAX, typed=True), _device_sampler(PORT, typed=True)
    jkey = jdev.next_key(2)
    _with_uniforms(monkeypatch, _jax_uniforms(jdev, jkey))
    got = pdev.sample(pdev.state("cpu"), pdev.next_key(2))
    want = jdev.sample(jdev.state(), jkey)
    for shard in (0, 3):
        _assert_batch_equal(pdev.slice_local(got, shard), jdev.slice_local(want, shard),
                            pdev.shard_bs)
    _assert_batch_equal(pdev.slice_local(got, torch.tensor(1)), jdev.slice_local(want, 1),
                        pdev.shard_bs)


# --------------------------------------------------------------------------
# The port's own draws


def test_same_key_same_batch_and_keys_differ():
    dev = _device_sampler(PORT, typed=True, corruption="ht", hrt=True)
    state = dev.state("cpu")
    a, b = dev.sample(state, dev.next_key(4)), dev.sample(state, dev.next_key(4))
    for key in a:
        assert torch.equal(a[key], b[key]), key
    c = dev.sample(state, dev.next_key(5))
    assert not torch.equal(a["head"], c["head"]) and not torch.equal(a["negative"], c["negative"])
    assert dev.next_key(4).dtype == torch.int64 and int(dev.next_key(4)) == int(dev.next_key(4))
    assert int(dev.next_key(4)) != int(dev.next_key(5))


def test_split_key_gives_distinct_keys_on_the_key_device():
    key = torch.tensor(123456789, dtype=torch.int64)
    keys = port_dev.split_key(key, 8)
    assert keys.shape == (8,) and keys.dtype == torch.int64
    assert len(set(keys.tolist())) == 8 and int(key) not in keys.tolist()
    assert torch.equal(keys, port_dev.split_key(key, 8))
    assert ((keys >= 0) & (keys < 2**32)).all()


def test_uniforms_are_uniform_and_in_range():
    u = port_dev._uniform(torch.tensor(7, dtype=torch.int64), 0, (64, 1024))
    assert u.dtype == torch.float32 and u.shape == (64, 1024)
    assert u.min() >= 0.0 and u.max() < 1.0
    # 65,536 draws: the mean within 5 standard errors, and 16 equal bins
    # within 5 standard deviations of their count.
    assert abs(u.mean().item() - 0.5) < 5 * (1 / 12) ** 0.5 / 256
    counts = torch.histc(u, bins=16, min=0.0, max=1.0)
    assert (counts - 4096).abs().max() < 5 * 4096**0.5
    other = port_dev._uniform(torch.tensor(7, dtype=torch.int64), 1, (64, 1024))
    assert not torch.equal(u, other)


def test_layout_matches_host_sampler():
    """Device batches carry the host samplers' exact key set / shapes."""
    sharding, pts = _pts(PORT)
    ns = _negative_sampler(PORT, sharding, pts)
    dev = port_dev.DeviceBatchSampler(pts, ns, shard_bs=24, batches_per_step=2, seed=SEED)
    host = port_bs.RandomShardedBatchSampler(pts, ns, shard_bs=24, batches_per_step=2, seed=SEED)
    hb = host.sample_batch(next(host.epoch_index_blocks(shuffle=False)))
    db = dev.sample(dev.state("cpu"), dev.next_key(0))
    for key in ("head", "relation", "tail", "negative"):
        assert db[key].shape == hb[key].shape, (key, db[key].shape, hb[key].shape)
        assert db[key].dtype == torch.int32


@pytest.mark.parametrize("positive_mode", ["iid", "runs"])
def test_positives_come_from_their_partition(positive_mode):
    """Every sampled (h, r, t) is a triple of its (shard_h, shard_t) bucket,
    and in "runs" mode each (micro-batch, partition) block is a contiguous
    run of that bucket."""
    sharding, pts = _pts(PORT, n_triple=6000)
    ns = _negative_sampler(PORT, sharding, pts)
    dev = port_dev.DeviceBatchSampler(pts, ns, shard_bs=32, batches_per_step=3, seed=SEED,
                                      positive_mode=positive_mode)
    batch = {k: v.numpy() for k, v in dev.sample(dev.state("cpu"), dev.next_key(3)).items()}
    ppp = dev.positive_per_partition
    tail = np.swapaxes(batch["tail"], 1, 2)  # undo the AllToAll pre-transpose
    for mb in range(3):
        for sh in range(N_SHARD):
            for st in range(N_SHARD):
                lo, n = pts.triple_offsets[sh, st], pts.triple_counts[sh, st]
                bucket = pts.triples[lo : lo + n]
                rows = np.stack([batch["head"][mb, sh, st], batch["relation"][mb, sh, st],
                                 tail[mb, sh, st]], axis=1)
                members = {tuple(x) for x in bucket.tolist()}
                assert all(tuple(r) in members for r in rows.tolist()), (mb, sh, st)
                if positive_mode == "runs":
                    assert any((bucket[s : s + ppp] == rows).all()
                               for s in range(n - ppp + 1)), (mb, sh, st)


def test_runs_mode_rejects_small_partitions():
    sharding, pts = _pts(PORT)
    ns = _negative_sampler(PORT, sharding, pts)
    with pytest.raises(ValueError, match="runs"):
        port_dev.DeviceBatchSampler(pts, ns, shard_bs=3000, batches_per_step=2, seed=SEED,
                                    positive_mode="runs")


def test_other_negative_samplers_and_modes_raise():
    sharding, pts = _pts(PORT)
    ns = _negative_sampler(PORT, sharding, pts)
    with pytest.raises(ValueError, match="negative samplers"):
        port_dev.DeviceBatchSampler(pts, port_ns.PlaceholderNegativeSampler("t"), 24, 2)
    with pytest.raises(ValueError, match="positive_mode"):
        port_dev.DeviceBatchSampler(pts, ns, 24, 2, positive_mode="epoch")


def test_random_negatives_within_source_shard_range():
    dev = _device_sampler(PORT, n_negative=7)
    neg = dev.sample(dev.state("cpu"), dev.next_key(1))["negative"].numpy()
    assert neg.shape[1] == N_SHARD and neg.shape[-1] == 7
    for src in range(N_SHARD):
        assert neg[:, src].min() >= 0 and neg[:, src].max() < dev.sharding.shard_counts[src]


def test_type_based_negatives_match_consumer_type():
    """Decoded negatives have the type of the corrupted slot of the consumer
    triple (axis 2 = consumer shard for non-local sampling)."""
    dev = _device_sampler(PORT, typed=True)
    batch = {k: v.numpy() for k, v in dev.sample(dev.state("cpu"), dev.next_key(5)).items()}
    neg = batch["negative"]
    bps, S = neg.shape[:2]
    tail = np.swapaxes(batch["tail"], 1, 2)
    ent_of = dev.sharding.shard_and_idx_to_entity
    ent_type = np.searchsorted(TYPE_OFFSETS, np.arange(N_ENTITY), "right") - 1
    for b in range(bps):
        for dest in range(S):
            want = ent_type[ent_of[np.arange(S)[:, None], tail[b, dest]].ravel()]
            for src in range(S):
                got = ent_type[ent_of[src, neg[b, src, dest]]]
                assert (got == want[:, None]).all(), (b, src, dest)


def test_ht_corruption_even_split():
    dev = _device_sampler(PORT, corruption="ht", shard_bs=30)
    assert dev.positive_per_partition % 2 == 0
    batch = dev.sample(dev.state("cpu"), dev.next_key(0))
    assert batch["negative"].shape[3] == batch["head"].shape[1] * batch["head"].shape[-1]


def test_hrt_weighting_normalized_per_shard_batch():
    dev = _device_sampler(PORT, hrt=True)
    w = dev.sample(dev.state("cpu"), dev.next_key(2))["triple_weight"]
    assert w.shape == (2, N_SHARD, N_SHARD * dev.positive_per_partition)
    np.testing.assert_allclose(w.sum(-1).numpy(), dev.shard_bs, rtol=1e-5)
    assert (w > 0).all()


# --------------------------------------------------------------------------
# Host samplers: the type-based negatives and the batch sampler's options


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("corruption", ["h", "t", "ht"])
def test_type_based_negative_sampler_equals_jax(corruption, local):
    jsh, jpts = _pts(JAX, typed=True)
    psh, ppts = _pts(PORT, typed=True)
    want = _negative_sampler(JAX, jsh, jpts, True, corruption, 6, local=local)
    got = _negative_sampler(PORT, psh, ppts, True, corruption, 6, local=local)
    idx = np.random.default_rng(0).integers(len(ppts.triples), size=(2, N_SHARD, N_SHARD, 6))
    for _ in range(2):
        np.testing.assert_array_equal(got(idx)["negative_entities"],
                                      want(idx)["negative_entities"])


SAMPLER_OPTIONS = {
    "hrt_freq_weighting": dict(hrt_freq_weighting=True),
    "weight_smoothing": dict(hrt_freq_weighting=True, weight_smoothing=0.5),
    "duplicate_batch": dict(duplicate_batch=True),
}


@pytest.mark.parametrize("sampler", ["RandomShardedBatchSampler", "RigidShardedBatchSampler"])
@pytest.mark.parametrize("option", list(SAMPLER_OPTIONS))
def test_batch_sampler_options_equal_jax(option, sampler):
    batches = []
    for pkg in (JAX, PORT):
        sharding, pts = _pts(pkg, typed=True)
        ns = _negative_sampler(pkg, sharding, pts, typed=True, corruption="ht")
        bs = getattr(pkg[4], sampler)(pts, ns, shard_bs=24, batches_per_step=2, seed=SEED,
                                      **SAMPLER_OPTIONS[option])
        batches.append([bs.sample_batch(b) for b, _ in zip(bs.epoch_index_blocks(True), range(3))])
    for want, got in zip(*batches):
        assert want.keys() == got.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
