"""The port's fixtures (``besskge_tpu_torch.fixtures``) against the JAX
package's (``besskge_tpu.fixtures``).

* The numpy parts (constants, ``_relation_spec``, ``expected_rr``,
  ``PlantedTransE`` and all of ``build_wikikg2_fixture``) are copied: bit
  for bit.
* The device scans run the port's B5 (its plain version here) where the
  JAX package broadcasts in XLA. Both sum 128 fp32 terms, in other orders:
  a distance ``d`` differs by at most ``2·128·2^-24·d`` between the two
  (each side's recursive-summation bound). So:

  - ``pick`` with JAX's uniforms injected: the same pick wherever the
    perturbed top two stand more than ``2e-5·(|best| + 1)`` apart; the
    others are counted, at most 0.1 % of the rows;
  - ``log_z`` and ``subsampled_log_z`` (``x = -d/T``; a log-sum-exp moves
    by at most the largest move of its terms): within
    ``2^-15·max|x| + 1e-5·|lz|``;
  - ``count_better`` and the rank kernels: equal counts on every row where
    no candidate's score lies within that distance bound of the true
    score.
* ``build_biokg_fixture`` with JAX's Gumbel draws injected gives the same
  dataset (rows that differ are counted; see ``test_build_matches_jax``),
  and each package loads the other's cache file.
"""

import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import fixtures as jax_fx
from besskge_tpu_torch import fixtures as port_fx

DIST_REL = 2 * 128 * 2.0**-24  # relative bound on the two sides' distance sums
SCALE, TEMP, BATCH = 0.005, 0.5, 1024  # the biokg build of the tests


def test_public_names_and_signatures():
    assert port_fx.__all__ == jax_fx.__all__
    names = ["BIOKG_TYPE_COUNTS", "BIOKG_SPLIT_SIZES", "N_EVAL_NEGATIVE", "WIKIKG2_N_ENTITY",
             "WIKIKG2_N_RELATION", "WIKIKG2_SPLIT_SIZES"]
    for name in names:
        assert getattr(port_fx, name) == getattr(jax_fx, name), name
    assert port_fx._relation_spec() == jax_fx._relation_spec()
    for name in ("expected_rr", "build_biokg_fixture", "build_wikikg2_fixture"):
        ref = inspect.signature(getattr(jax_fx, name)).parameters
        port = inspect.signature(getattr(port_fx, name)).parameters
        assert list(port)[: len(ref)] == list(ref), name
        assert [p.default for p in list(port.values())[: len(ref)]] == [
            p.default for p in ref.values()], name
        assert list(port)[len(ref):] in ([], ["device"]), name
    for cls in ("PlantedRotatE", "PlantedTransE"):
        ref = [f.name for f in dataclasses.fields(getattr(jax_fx, cls))]
        port = [f.name for f in dataclasses.fields(getattr(port_fx, cls))]
        assert port[: len(ref)] == ref and port[len(ref):] in ([], ["device"]), cls


def test_expected_rr_is_exact():
    q = np.array([0.0, 1e-13, 1e-4, 0.01, 0.3, 1.0])
    for n in (500, 1, 49):
        np.testing.assert_array_equal(port_fx.expected_rr(q, n), jax_fx.expected_rr(q, n))
    assert port_fx.expected_rr(0.0) == 1.0


def test_wikikg2_fixture_is_bit_equal():
    """At tests/test_wikikg2_fixture.py's build (seed 3, scale 0.003),
    every array, the planted tables and the oracle estimate; and
    PlantedTransE's host score and ranks."""
    kw = dict(seed=3, scale=0.003, return_planted=True, oracle_sample=500)
    ds_p, pl_p = port_fx.build_wikikg2_fixture(**kw)
    ds_j, pl_j = jax_fx.build_wikikg2_fixture(**kw)
    _same_dataset(ds_p, ds_j)
    np.testing.assert_array_equal(pl_p.entity, pl_j.entity)
    np.testing.assert_array_equal(pl_p.relation, pl_j.relation)
    assert pl_p.oracle_estimate == pl_j.oracle_estimate
    v = ds_j.triples["valid"][:300]
    np.testing.assert_array_equal(pl_p.score(v[:, 0], v[:, 1], v[:, 2]),
                                  pl_j.score(v[:, 0], v[:, 1], v[:, 2]))
    capped = port_fx.build_wikikg2_fixture(seed=1, scale=0.002, eval_rows=250)
    _same_dataset(capped, jax_fx.build_wikikg2_fixture(seed=1, scale=0.002, eval_rows=250))
    assert len(capped.triples["valid"]) == 250


def _same_dataset(got, want):
    assert got.n_entity == want.n_entity and got.n_relation_type == want.n_relation_type
    assert got.type_offsets == want.type_offsets
    assert list(got.relation_dict or []) == list(want.relation_dict or [])
    for field in ("triples", "original_triple_ids", "neg_heads", "neg_tails"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.keys() == b.keys(), field
        for part in a:
            assert a[part].dtype == b[part].dtype, (field, part)
            np.testing.assert_array_equal(a[part], b[part], err_msg=f"{field}[{part}]")


def _tables(seed=0, n=1300, emb=64, n_rel=7):
    """Clustered planted-like tables, as the biokg build makes them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, size=(n // 40, 2 * emb))
    ent = (centers[rng.integers(len(centers), size=n)]
           + rng.uniform(-0.35, 0.35, size=(n, 2 * emb))).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=(n_rel, emb)).astype(np.float32)
    return ent, phase


def _scores64(ent, phase, hh, rr, lo, n_ty):
    """fp64 planted scores of (hh, rr) against type rows [lo, lo + n_ty)."""
    e = ent.astype(np.float64)
    re, im = np.split(e[hh], 2, -1)
    c, s = np.cos(phase[rr].astype(np.float64)), np.sin(phase[rr].astype(np.float64))
    hr = np.concatenate([re * c - im * s, re * s + im * c], -1)
    return -np.abs(hr[:, None, :] - e[None, lo: lo + n_ty]).sum(-1)


def test_pick_matches_jax_with_injected_uniforms(monkeypatch):
    ent, phase = _tables()
    lo, n_ty, chunk, temp = 100, 1100, 512, 0.4
    rng = np.random.default_rng(1)
    hh = rng.integers(0, 100, size=700).astype(np.int32)
    rr = rng.integers(0, len(phase), size=700).astype(np.int32)
    key = jax.random.PRNGKey(7)
    n_chunk = -(-n_ty // chunk)
    u = np.concatenate([np.asarray(jax.random.uniform(k, (len(hh), chunk), minval=1e-20,
                                                       maxval=1.0))
                        for k in jax.random.split(key, n_chunk)], 1)
    monkeypatch.setattr(port_fx, "_gumbel_uniforms",
                        lambda key, n_rows, n_ty, off, n: torch.from_numpy(u[:n_rows, off:off + n]))
    jpick = jax_fx._type_scan_fns()[0]
    want = np.asarray(jpick(jnp.asarray(ent), jnp.asarray(phase), jnp.asarray(hh), jnp.asarray(rr),
                            key, lo, n_ty, chunk, temp))
    got = port_fx._pick(torch.from_numpy(ent), torch.from_numpy(phase), torch.from_numpy(hh).long(),
                        torch.from_numpy(rr).long(), torch.tensor(0), lo, n_ty, chunk, temp).numpy()
    pert = _scores64(ent, phase, hh, rr, lo, n_ty) + temp * -np.log(-np.log(u[:, :n_ty]))
    top2 = -np.sort(-pert, 1)[:, :2]
    near = (top2[:, 0] - top2[:, 1]) <= 2e-5 * (np.abs(top2[:, 0]) + 1)
    assert (got[~near] == want[~near]).all()
    assert (got != want).sum() <= 0.001 * len(hh)
    # The port's own draws depend on (key, row, column) only: another chunk
    # size gives the same picks.
    monkeypatch.undo()
    k = torch.tensor(5)
    a = port_fx._pick(torch.from_numpy(ent), torch.from_numpy(phase), torch.from_numpy(hh).long(),
                      torch.from_numpy(rr).long(), k, lo, n_ty, 512, temp)
    b = port_fx._pick(torch.from_numpy(ent), torch.from_numpy(phase), torch.from_numpy(hh).long(),
                      torch.from_numpy(rr).long(), k, lo, n_ty, 300, temp)
    assert (a == b).float().mean() >= 0.999


def test_gumbel_uniforms_are_in_range_and_keyed():
    key = torch.tensor(3)
    u = port_fx._gumbel_uniforms(key, 64, 700, 0, 700)
    assert u.dtype == torch.float32 and u.shape == (64, 700)
    assert float(u.min()) >= 1e-20 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    torch.testing.assert_close(port_fx._gumbel_uniforms(key, 64, 700, 200, 100), u[:, 200:300],
                               rtol=0, atol=0)
    assert not torch.equal(port_fx._gumbel_uniforms(torch.tensor(4), 64, 700, 0, 700), u)


def test_log_z_and_subsampled_log_z_match_jax():
    ent, phase = _tables(seed=2)
    _, _, jlog_z, jsub = jax_fx._type_scan_fns()
    temp = 0.3
    for h_lo, h_n, t_lo, t_n, chunk in ((0, 530, 600, 700, 256), (40, 90, 100, 1200, 512)):
        want = np.asarray(jlog_z(jnp.asarray(ent), jnp.asarray(phase[2]), temp, h_lo, h_n,
                                 t_lo, t_n, chunk))
        got = port_fx._log_z(torch.from_numpy(ent), torch.from_numpy(phase[2]), temp, h_lo, h_n,
                             t_lo, t_n, chunk).numpy()
        assert got.shape == want.shape == (h_n,)
        x = _scores64(ent, np.broadcast_to(phase[2], phase.shape), np.arange(h_lo, h_lo + h_n),
                      np.full(h_n, 2), t_lo, t_n) / temp
        tol = 2.0**-15 * np.abs(x).max(1) + 1e-5 * np.abs(want)
        assert (np.abs(got - want) <= tol).all(), float((np.abs(got - want) - tol).max())
    rng = np.random.default_rng(3)
    h_ids = rng.choice(1300, 300, replace=False).astype(np.int32)
    t_ids = rng.choice(1300, 900, replace=False).astype(np.int32)
    want = np.asarray(jsub(jnp.asarray(ent), jnp.asarray(phase[4]), jnp.asarray(h_ids),
                           jnp.asarray(t_ids), temp))
    got = port_fx._subsampled_log_z(torch.from_numpy(ent), torch.from_numpy(phase[4]),
                                    torch.from_numpy(h_ids).long(), torch.from_numpy(t_ids).long(),
                                    temp).numpy()
    x = _scores64(ent, np.broadcast_to(phase[4], phase.shape), h_ids, np.full(300, 4), 0, 1300)
    tol = 2.0**-15 * np.abs(x).max(1) / temp + 1e-5 * np.abs(want)
    assert (np.abs(got - want) <= tol).all()


def test_count_better_matches_jax():
    ent, phase = _tables(seed=4)
    lo, n_ty, chunk = 200, 1000, 384
    rng = np.random.default_rng(5)
    hh = rng.integers(0, 200, 400).astype(np.int32)
    rr = rng.integers(0, 7, 400).astype(np.int32)
    tt = rng.integers(lo, lo + n_ty, 400).astype(np.int32)
    jcount = jax_fx._type_scan_fns()[1]
    want = np.asarray(jcount(*map(jnp.asarray, (ent, phase, hh, rr, tt)), lo, n_ty, chunk))
    got = port_fx._count_better(*(torch.from_numpy(x) for x in (ent, phase)),
                                *(torch.from_numpy(x).long() for x in (hh, rr, tt)),
                                lo, n_ty, chunk).numpy()
    s = _scores64(ent, phase, hh, rr, lo, n_ty)
    thr = s[np.arange(400), tt - lo]
    near = (np.abs(s - thr[:, None]) <= DIST_REL * np.abs(s) + 1e-6).sum(1) > 1
    assert (got[~near] == want[~near]).all() and near.mean() < 0.3


def test_count_better_never_counts_the_true_tail(monkeypatch):
    """The card's B5 sums the true tail's distance in another order than the
    threshold's sum: a tail a rounding above itself must not count. Here
    every B5 distance is made 1e-4 shorter than the threshold's, so each
    tail scores above its own threshold; only the others count."""
    ent, phase = _tables(seed=8, n=700)
    rng = np.random.default_rng(9)
    hh, rr = (torch.from_numpy(rng.integers(0, 100, 64)), torch.from_numpy(rng.integers(0, 7, 64)))
    tt = torch.from_numpy(rng.integers(100, 700, 64))
    args = (torch.from_numpy(ent), torch.from_numpy(phase), hh, rr, tt, 100, 600, 256)
    want = port_fx._count_better(*args)
    plain = port_fx.l1_distance_matrix
    monkeypatch.setattr(port_fx, "l1_distance_matrix", lambda a, b: plain(a, b) - 1e-4)
    got = port_fx._count_better(*args)
    s = _scores64(ent, phase, hh.numpy(), rr.numpy(), 100, 600)
    thr = s[np.arange(64), tt.numpy() - 100]
    near = (np.abs(s - thr[:, None]) <= 2e-4 + DIST_REL * np.abs(s)).sum(1) > 1
    assert (got[~near] == want[~near]).all() and (~near).sum() > 32


def test_rank_kernels_match_jax():
    """PlantedRotatE.rank_against (on the CPU here) and the TransE rank
    function against the JAX package's jitted kernels, both directions."""
    ent, phase = _tables(seed=6, n=900)
    rng = np.random.default_rng(7)
    tri = np.stack([rng.integers(900, size=250), rng.integers(7, size=250),
                    rng.integers(900, size=250)], 1).astype(np.int32)
    negs = rng.integers(900, size=(250, 230)).astype(np.int32)
    negs[:5, :3] = tri[:5, 2:3]  # the true entity among its negatives: a tie
    port = port_fx.PlantedRotatE(ent, phase, device="cpu")
    jax_pl = jax_fx.PlantedRotatE(ent, phase)
    rel = rng.normal(size=(7, 128)).astype(np.float32)
    for corrupt in ("h", "t"):
        got, want = port.rank_against(tri, negs, corrupt), jax_pl.rank_against(tri, negs, corrupt)
        assert got.dtype == want.dtype == np.int32
        _equal_away_from_ties(got, want, port.score, tri, negs, corrupt)
        got_t = port_fx._planted_transe_ranks(
            torch.from_numpy(ent), torch.from_numpy(rel), torch.from_numpy(tri).long(),
            torch.from_numpy(negs).long(), corrupt == "t").numpy()
        want_t = np.asarray(jax_fx._planted_transe_rank_kernel(corrupt == "t")(
            jnp.asarray(ent), jnp.asarray(rel), jnp.asarray(tri), jnp.asarray(negs)))
        np.testing.assert_array_equal(got_t, want_t)
    assert (got[:5] >= 2).all()  # the planted ties count (worst rank)
    np.testing.assert_allclose(port.score(tri[:, 0], tri[:, 1], tri[:, 2]),
                               jax_pl.score(tri[:, 0], tri[:, 1], tri[:, 2]), rtol=1e-5)


def _equal_away_from_ties(got, want, score, tri, negs, corrupt):
    pos = score(tri[:, 0], tri[:, 1], tri[:, 2]).astype(np.float64)
    cand = np.stack([score(np.where(corrupt == "h", negs[:, j], tri[:, 0]), tri[:, 1],
                           np.where(corrupt == "t", negs[:, j], tri[:, 2]))
                     for j in range(negs.shape[1])], 1)
    near = ((np.abs(cand - pos[:, None]) <= DIST_REL * np.abs(pos)[:, None] + 1e-6)
            & (cand != pos[:, None])).any(1)
    assert (got[~near] == want[~near]).all()


def test_fixture_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fx.build_biokg_fixture(scale=0.002, temperature=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fx.PlantedRotatE(*_tables(n=80)).rank_against(
            np.zeros((1, 3), np.int32), np.zeros((1, 4), np.int32), "t")


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The JAX build and the port's with JAX's Gumbel draws injected (same
    seed, scale, temperature and batch), each written to its cache."""
    root = tmp_path_factory.mktemp("fixture_cache")
    kw = dict(seed=11, scale=SCALE, temperature=TEMP, batch=BATCH, return_planted=True)
    ds_j, pl_j = jax_fx.build_biokg_fixture(cache_dir=str(root / "jax"), **kw)
    # JAX's key stream: one split of PRNGKey(seed) per batch, one key per
    # chunk, a (batch, chunk) draw per key; the port's pick asks chunk by
    # chunk, off == 0 opening the next batch.
    state = {"key": jax.random.PRNGKey(11), "u": None}

    def jax_draws(key, n_rows, n_ty, off, n):
        chunk = 512
        if off == 0:
            state["key"], sub = jax.random.split(state["key"])
            state["u"] = np.concatenate([
                np.asarray(jax.random.uniform(k, (BATCH, chunk), minval=1e-20, maxval=1.0))
                for k in jax.random.split(sub, -(-n_ty // chunk))], 1)
        return torch.from_numpy(state["u"][:n_rows, off:off + n])

    mp = pytest.MonkeyPatch()
    mp.setattr(port_fx, "_gumbel_uniforms", jax_draws)
    try:
        ds_p, pl_p = port_fx.build_biokg_fixture(cache_dir=str(root / "port"), device="cpu", **kw)
    finally:
        mp.undo()
    return dict(root=root, jax=(ds_j, pl_j), port=(ds_p, pl_p), kw=kw)


def test_build_matches_jax(builds):
    """The port's biokg build with JAX's draws equals the JAX build: the
    planted tables bit for bit; every row of every split and of the
    negatives equal, but for rows moved by a Gumbel near-tie or a head
    draw at a CDF boundary (counted: at most 0.1 % of a split)."""
    (ds_p, pl_p), (ds_j, pl_j) = builds["port"], builds["jax"]
    np.testing.assert_array_equal(pl_p.entity, pl_j.entity)
    np.testing.assert_array_equal(pl_p.phase, pl_j.phase)
    assert pl_p.temperature == pl_j.temperature == TEMP
    assert pl_p.oracle_estimate is None and pl_j.oracle_estimate is None
    assert ds_p.n_entity == ds_j.n_entity and ds_p.type_offsets == ds_j.type_offsets
    assert list(ds_p.relation_dict) == list(ds_j.relation_dict)
    moved = {}
    for part in ("train", "valid", "test"):
        a, b = ds_p.triples[part], ds_j.triples[part]
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a[:, 1], b[:, 1])
        rows = (a != b).any(1)
        if part != "train":
            rows |= (ds_p.neg_heads[part] != ds_j.neg_heads[part]).any(1)
            rows |= (ds_p.neg_tails[part] != ds_j.neg_tails[part]).any(1)
        moved[part] = int(rows.sum())
        assert moved[part] <= 0.001 * len(a), moved


def test_each_package_loads_the_others_cache(builds):
    """Same file name, same keys: the JAX package's file read by the port
    and the port's by the JAX package give the writer's dataset and
    planted tables."""
    root, kw = builds["root"], builds["kw"]
    ds_j, pl_j = builds["jax"]
    ds_p, pl_p = builds["port"]
    assert sorted(p.name for p in (root / "jax").iterdir()) == sorted(
        p.name for p in (root / "port").iterdir())
    got_ds, got_pl = port_fx.build_biokg_fixture(cache_dir=str(root / "jax"), device="cpu", **kw)
    _same_dataset(got_ds, ds_j)
    np.testing.assert_array_equal(got_pl.entity, pl_j.entity)
    np.testing.assert_array_equal(got_pl.phase, pl_j.phase)
    assert got_pl.temperature == TEMP and got_pl.oracle_estimate is None
    back_ds, back_pl = jax_fx.build_biokg_fixture(cache_dir=str(root / "port"), **kw)
    _same_dataset(back_ds, ds_p)
    np.testing.assert_array_equal(back_pl.entity, pl_p.entity)
    ds_only = port_fx.build_biokg_fixture(cache_dir=str(root / "port"), device="cpu",
                                          **{**kw, "return_planted": False})
    _same_dataset(ds_only, ds_p)


def test_build_is_a_fixture(builds):
    """What the build promises: type-contiguous triples of the relation's
    types, negatives of the right type without the true entity, and a
    planted oracle far above the uniform floor."""
    ds, planted = builds["port"]
    spec = port_fx._relation_spec()
    offs = ds.type_offsets
    ends = {k: offs[k] + (sorted(offs.values()) + [ds.n_entity])[
        sorted(offs.values()).index(offs[k]) + 1] - offs[k] for k in offs}
    for part, tri in ds.triples.items():
        h_ty = np.array([spec[r][0] for r in tri[:, 1]])
        t_ty = np.array([spec[r][1] for r in tri[:, 1]])
        for ids, ty in ((tri[:, 0], h_ty), (tri[:, 2], t_ty)):
            lo = np.array([offs[t] for t in ty])
            hi = np.array([ends[t] for t in ty])
            assert ((ids >= lo) & (ids < hi)).all(), part
    v = ds.triples["valid"]
    assert not (ds.neg_tails["valid"] == v[:, 2:]).any()
    assert not (ds.neg_heads["valid"] == v[:, :1]).any()
    n = 300
    rr = np.concatenate([1.0 / planted.rank_against(v[:n], ds.neg_tails["valid"][:n], "t"),
                         1.0 / planted.rank_against(v[:n], ds.neg_heads["valid"][:n], "h")])
    assert rr.mean() > 5 * float(port_fx.expected_rr(0.5))
    assert math.isfinite(rr.mean())
