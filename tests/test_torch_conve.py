"""ConvE in the port against the JAX package's, method by method.

At the JAX goldens' toy size (``tests/test_conve_weighting.py``: 100
entities, 4 relation types with inverses, d = 32 as 4 x 8), the same
inputs, made with numpy, go through ``besskge_tpu.scoring.ConvE`` and
``besskge_tpu_torch.scoring.ConvE``:

* ``initial_params`` and the trunk of ``initial_params_device``, bit for bit,
  nested ``bn0``/``bn1``/``bn2`` included;
* ``hr_transform``, ``score_triple``, ``score_tails`` and ``update_bn_stats``
  with ``train`` False and True, with and without sample sharing and
  BatchNorm, in fp32 and with a bf16 table and bf16 scoring math, and their
  gradients against ``jax.grad``;
* ``train=True`` with dropout: the port's masks are the JAX package's,
  put into :func:`besskge_tpu_torch.scoring._keep_mask` by :func:`jax_masks`
  (a key of the port's tree maps to the JAX mask of the same position of
  the JAX package's key tree);
* the port's own masks: a pure function of the key, ``Dropout2d`` whole
  channels, keep rates within 4 sigma of ``1 - p``;
* the raises: ``score_heads``, a shape that does not multiply out, SyncBN
  over a mesh.

Tolerances: fp32 within 1e-5 x max|want| (sums in other orders: the
convolution, the linear map, the batch statistics); BN statistics at rtol
1e-4, atol 1e-5 (``tests/test_conve_weighting.py``); gradients within 1e-5
x (|want| + max|want|); bf16 scoring math within 2^-7 x max|want| (bf16
roundings of the conv input and the scores land on neighbouring values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch.device_sampler import split_key

N_ENTITY, N_RELATION, EMB, HEIGHT, WIDTH, SEED = 100, 4, 32, 4, 8, 21
B, N_NEG = 24, 40
RTOL = 1e-5
BF16_RTOL = 2.0**-7


def conve(pkg, sharing=True, **kw):
    sh_mod, sc_mod = (jax_sh, jax_scoring) if pkg == "jax" else (port_sh, port_scoring)
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=SEED)
    return sc_mod.ConvE(sharing, sharding, N_RELATION, EMB, HEIGHT, WIDTH, seed=SEED, **kw)


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def to_port(tree):
    return {k: to_port(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def random_params(fn, seed=0):
    """The JAX package's initial params with the BN running stats, scales
    and biases drawn away from their initial values (numpy)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, fn.initial_params())
    for bn in ("bn0", "bn1", "bn2"):
        if bn in params:
            for f, v in params[bn].items():
                if f in ("scale", "var"):
                    params[bn][f] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                else:
                    params[bn][f] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    params["entity_embedding"][:, -1] = rng.normal(size=N_ENTITY).astype(np.float32)
    return params


def inputs(seed=1, sharing=True):
    rng = np.random.default_rng(seed)
    head = rng.normal(size=(B, EMB + 1)).astype(np.float32)
    tail = rng.normal(size=(B, EMB + 1)).astype(np.float32)
    rel = rng.integers(2 * N_RELATION, size=B).astype(np.int32)
    neg = rng.normal(size=(1, N_NEG, EMB + 1) if sharing else (B, N_NEG, EMB + 1))
    return head, rel, tail, neg.astype(np.float32)


def close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


# --------------------------------------------------------------------------
# The JAX package's masks in the port


class jax_masks:
    """Context manager: the port's dropout masks are the JAX package's.

    For each (JAX key, port key) pair of a call, the key trees are walked
    alike: split into ``n_split`` keys (micro-batches, or nothing when
    ``n_split`` is 0), each split three ways in ``hr_transform``; the JAX
    package's ``jax.random.bernoulli`` masks of the three sites (shapes of a
    micro-batch of ``b`` queries, in its NHWC layout) are stored under the
    port key of the same position. ``_keep_mask`` then returns the stored
    mask of its key, by a one-hot product, which runs under
    ``torch.func.vmap``."""

    def __init__(self, fn, pairs, b, n_split=0):
        fm_shape = (b, 1, 1, fn.out_channels)
        sites = [((b, 2 * HEIGHT, WIDTH, fn.inp_channels), 1.0 - fn.p_in),
                 (fm_shape, 1.0 - fn.p_fm), ((b, EMB), 1.0 - fn.p_hid)]
        table = {}
        for jax_key, port_key in pairs:
            j_keys, p_keys = [jax_key], [torch.as_tensor(port_key, dtype=torch.int64)]
            if n_split:
                j_keys = list(jax.random.split(jax_key, n_split))
                p_keys = list(split_key(p_keys[0], n_split))
            for jk, pk in zip(j_keys, p_keys):
                for (shape, keep), js, ps in zip(sites, jax.random.split(jk, 3), split_key(pk, 3)):
                    mask = np.asarray(jax.random.bernoulli(js, keep, shape))
                    table.setdefault(shape, ([], []))
                    table[shape][0].append(int(ps))
                    table[shape][1].append(mask.reshape(-1).astype(np.float32))
        self.table = {shape: (torch.tensor(k, dtype=torch.int64), torch.from_numpy(np.stack(m)))
                      for shape, (k, m) in table.items()}
        self.drawn = 0

    def _keep_mask(self, key, keep, shape):
        keys, masks = self.table[tuple(shape)]
        self.drawn += 1
        pick = (keys == key).to(torch.float32)
        return (pick @ masks).reshape(tuple(shape)) > 0.5

    def __enter__(self):
        self.saved = port_scoring._keep_mask
        port_scoring._keep_mask = self._keep_mask
        return self

    def __exit__(self, *exc):
        port_scoring._keep_mask = self.saved


# --------------------------------------------------------------------------
# Params


@pytest.mark.parametrize("batch_norm", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_initial_params_equal_jax(batch_norm, dtype):
    """Bit for bit, the nested trunk too; the trunk of
    ``initial_params_device`` equals it (its tables are drawn on the device
    and differ, as in the JAX package)."""
    jfn = conve("jax", batch_normalization=batch_norm, dtype=getattr(jnp, dtype))
    pfn = conve("port", batch_normalization=batch_norm, dtype=getattr(torch, dtype))
    want = dict(leaves(jax.tree.map(np.asarray, jfn.initial_params())))
    got = dict(leaves(pfn.initial_params(device="cpu")))
    assert sorted(got) == sorted(want)
    assert ("bn0/var" in got) == batch_norm
    for path, w in want.items():
        g = got[path]
        if g.dtype == torch.bfloat16:
            g = g.float()
            w = w.astype(np.float32)
        assert np.array_equal(g.numpy(), w), path
    device = dict(leaves(pfn.initial_params_device(device="cpu")))
    assert list(device) == list(got)
    for path in want:
        if "embedding" not in path:
            assert torch.equal(device[path], got[path]), path
    assert device["entity_embedding"].shape == got["entity_embedding"].shape == (N_ENTITY, EMB + 1)
    assert pfn.fc_in == jfn.fc_in == 32 * 6 * 6
    assert got["conv_w"].shape == (3, 3, 1, 32)  # HWIO, as the JAX package's


# --------------------------------------------------------------------------
# Methods


@pytest.mark.parametrize("batch_norm", [True, False])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("sharing", [True, False])
def test_methods_match_jax(sharing, train, batch_norm):
    """hr_transform, score_triple and score_tails, without dropout."""
    jfn = conve("jax", sharing, batch_normalization=batch_norm)
    pfn = conve("port", sharing, batch_normalization=batch_norm)
    params = random_params(jfn)
    jp, pp = to_jax(params), to_port(params)
    head, rel, tail, neg = inputs(sharing=sharing)
    r = params["relation_embedding"][rel]
    close(pfn.hr_transform(pp, torch.from_numpy(head[:, :-1]), torch.from_numpy(r), train),
          jfn.hr_transform(jp, jnp.asarray(head[:, :-1]), jnp.asarray(r), train))
    close(pfn.score_triple(pp, *map(torch.from_numpy, (head, rel, tail)), train=train),
          jfn.score_triple(jp, *map(jnp.asarray, (head, rel, tail)), train=train))
    got = pfn.score_tails(pp, *map(torch.from_numpy, (head, rel, neg)), train=train)
    close(got, jfn.score_tails(jp, *map(jnp.asarray, (head, rel, neg)), train=train))
    assert got.shape == (B, N_NEG)


@pytest.mark.parametrize("train", [False, True])
def test_bf16_scoring_matches_jax(train):
    """A bf16 table and relations with bf16 scoring math: BatchNorm's fp32
    stats promote the trunk to fp32 after bn0 in both packages."""
    jfn = conve("jax", dtype=jnp.bfloat16)
    pfn = conve("port", dtype=torch.bfloat16)
    jfn.compute_dtype, pfn.compute_dtype = jnp.bfloat16, torch.bfloat16
    params = random_params(conve("jax"))
    jp = to_jax(params)
    jp["relation_embedding"] = jp["relation_embedding"].astype(jnp.bfloat16)
    pp = to_port(params)
    pp["relation_embedding"] = pp["relation_embedding"].to(torch.bfloat16)
    head, rel, tail, neg = inputs()
    hb, tb, nb = (torch.from_numpy(x).to(torch.bfloat16) for x in (head, tail, neg))
    jh, jt, jn = (jnp.asarray(x).astype(jnp.bfloat16) for x in (head, tail, neg))
    got = pfn.score_tails(pp, hb, torch.from_numpy(rel), nb, train=train)
    want = jfn.score_tails(jp, jh, jnp.asarray(rel), jn, train=train)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, BF16_RTOL)
    close(pfn.score_triple(pp, hb, torch.from_numpy(rel), tb, train=train),
          jfn.score_triple(jp, jh, jnp.asarray(rel), jt, train=train), BF16_RTOL)


#: Params whose gradient is near 0 when BatchNorm takes batch statistics:
#: exactly 0 for a per-channel shift before a BN (conv_b before bn1, fc_b
#: before bn2, bn0's bias before the conv and bn1), 0 up to the 1e-5 in bn1's
#: rsqrt(var + 1e-5) for bn0's scale (one input channel: bn1 undoes it).
BN_INVARIANT = ("p/bn0/bias", "p/bn0/scale", "p/conv_b", "p/fc_b")


@pytest.mark.parametrize("train", [False, True])
def test_gradients_match_jax(train):
    """d(sum of the squared tail scores)/d(every param and the inputs): the
    conv's backward (the port's own autograd Function) and the linear map's.
    With ``train=True`` the :data:`BN_INVARIANT` gradients are 0 up to the
    cancellation of terms the size of the other gradients, so both sides are
    held to 1e-5 x the largest gradient there."""
    jfn, pfn = conve("jax"), conve("port")
    params = random_params(jfn)
    head, rel, _, neg = inputs()

    def jloss(p, h, n):
        return jnp.sum(jfn.score_tails(p, h, jnp.asarray(rel), n, train=train) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(to_jax(params), jnp.asarray(head), jnp.asarray(neg))

    def ploss(p, h, n):
        return torch.sum(pfn.score_tails(p, h, torch.from_numpy(rel), n, train=train) ** 2)

    got = torch.func.grad(ploss, argnums=(0, 1, 2))(
        to_port(params), torch.from_numpy(head), torch.from_numpy(neg))
    flat_want = dict(leaves({"p": want[0], "h": want[1], "n": want[2]}))
    flat_got = dict(leaves({"p": got[0], "h": got[1], "n": got[2]}))
    assert sorted(flat_got) == sorted(flat_want)
    largest = max(float(np.abs(np.asarray(w)).max()) for w in flat_want.values())
    for path, w in flat_want.items():
        w = np.asarray(w)
        g = flat_got[path].numpy()
        if train and path in BN_INVARIANT:
            assert np.abs(g).max() <= RTOL * largest and np.abs(w).max() <= RTOL * largest
            continue
        tol = RTOL * (np.abs(w) + np.abs(w).max())
        assert (np.abs(g - w) <= tol).all(), (path, np.abs(g - w).max(), np.abs(w).max())


def test_update_bn_stats_matches_jax():
    """The offline refresh: each BN's EMA, fed by the earlier BNs normalised
    with their refreshed stats; the input params unchanged."""
    jfn, pfn = conve("jax"), conve("port")
    params = random_params(jfn)
    head, rel, _, _ = inputs()
    want = jfn.update_bn_stats(to_jax(params), jnp.asarray(head), jnp.asarray(rel), 0.3)
    pp = to_port(params)
    got = pfn.update_bn_stats(pp, torch.from_numpy(head), torch.from_numpy(rel), 0.3)
    for bn in ("bn0", "bn1", "bn2"):
        for f in ("mean", "var"):
            np.testing.assert_allclose(got[bn][f].numpy(), np.asarray(want[bn][f]),
                                       rtol=1e-4, atol=1e-5)
            assert np.array_equal(pp[bn][f].numpy(), params[bn][f])
        assert got[bn]["scale"] is pp[bn]["scale"]
    plain = conve("port", batch_normalization=False)
    unchanged = plain.initial_params(device="cpu")
    assert plain.update_bn_stats(unchanged, torch.from_numpy(head), torch.from_numpy(rel)) \
        is unchanged


# --------------------------------------------------------------------------
# Dropout


@pytest.mark.parametrize("sharing", [True, False])
def test_dropout_with_the_jax_masks_matches_jax(sharing):
    """train=True with an rng: every mask drawn, and the scores the JAX
    package's; the positive's query gets the same masks in score_triple and
    score_tails (one key)."""
    jfn, pfn = conve("jax", sharing), conve("port", sharing)
    params = random_params(jfn)
    jp, pp = to_jax(params), to_port(params)
    head, rel, tail, neg = inputs(sharing=sharing)
    jkey, pkey = jax.random.PRNGKey(7), torch.tensor(12345, dtype=torch.int64)
    with jax_masks(pfn, [(jkey, pkey)], B) as masks:
        got_t = pfn.score_triple(pp, *map(torch.from_numpy, (head, rel, tail)), train=True,
                                 rng=pkey)
        got_n = pfn.score_tails(pp, *map(torch.from_numpy, (head, rel, neg)), train=True,
                                rng=pkey)
        assert masks.drawn == 6
    close(got_t, jfn.score_triple(jp, *map(jnp.asarray, (head, rel, tail)), train=True, rng=jkey))
    close(got_n, jfn.score_tails(jp, *map(jnp.asarray, (head, rel, neg)), train=True, rng=jkey))
    # the masks moved the scores: they differ from the dropout-free ones
    free = pfn.score_tails(pp, *map(torch.from_numpy, (head, rel, neg)), train=True)
    assert not torch.allclose(free, got_n)


def test_dropout_without_train_or_rng_draws_nothing():
    pfn = conve("port")
    pp = to_port(random_params(conve("jax")))
    head, rel, tail, _ = inputs()
    args = map(torch.from_numpy, (head, rel, tail))
    h, r, t = args
    with jax_masks(pfn, [], B) as masks:
        a = pfn.score_triple(pp, h, r, t, train=False, rng=torch.tensor(3))
        b = pfn.score_triple(pp, h, r, t, train=False)
        c = pfn.score_triple(pp, h, r, t, train=True)
        assert masks.drawn == 0
    assert torch.equal(a, b) and not torch.equal(b, c)


def test_the_port_masks_are_a_function_of_the_key():
    """The port's own draws: the same key gives the same masks (the card and
    a replayed graph draw from the key alone), another key others; keep
    rates within 4 sigma of 1 - p; Dropout2d keeps or drops whole
    channels; a kept value is scaled by 1 / (1 - p)."""
    key = torch.tensor(99, dtype=torch.int64)
    a = port_scoring._keep_mask(key, 0.8, (64, 8, 8, 3))
    assert torch.equal(a, port_scoring._keep_mask(key.clone(), 0.8, (64, 8, 8, 3)))
    assert not torch.equal(a, port_scoring._keep_mask(key + 1, 0.8, (64, 8, 8, 3)))
    n = a.numel()
    assert abs(a.float().mean().item() - 0.8) < 4 * (0.8 * 0.2 / n) ** 0.5
    x = torch.ones(64, 32, 6, 6)
    y = port_scoring.ConvE._dropout(x, 0.25, True, key, (64, 1, 1, 32), (0, 3, 1, 2))
    per_channel = y.reshape(64, 32, -1)
    assert ((per_channel == 0).all(-1) | (per_channel == 1 / 0.75).all(-1)).all()
    assert 0 < (per_channel[..., 0] == 0).float().mean() < 0.5


def test_dropout_under_vmap_takes_one_key_per_micro_batch():
    """Micro-batches under ``torch.func.vmap`` with their split keys draw
    what each draws alone."""
    pfn = conve("port")
    pp = to_port(random_params(conve("jax")))
    head, rel, tail, _ = inputs()
    h, r, t = (torch.from_numpy(x).reshape(2, B // 2, *x.shape[1:]) for x in (head, rel, tail))
    keys = split_key(torch.tensor(5, dtype=torch.int64), 2)
    batched = torch.func.vmap(
        lambda hh, rr, tt, k: pfn.score_triple(pp, hh, rr, tt, train=True, rng=k))(h, r, t, keys)
    for i in range(2):
        alone = pfn.score_triple(pp, h[i], r[i], t[i], train=True, rng=keys[i])
        torch.testing.assert_close(batched[i], alone, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# Raises


def test_raises_where_the_jax_package_does():
    with pytest.raises(ValueError, match="embedding_size must equal"):
        port_scoring.ConvE(True, port_sh.Sharding.create(N_ENTITY, 1, seed=0), N_RELATION,
                           30, 4, 8)
    with pytest.raises(ValueError, match="embedding_size must equal"):
        jax_scoring.ConvE(True, jax_sh.Sharding.create(N_ENTITY, 1, seed=0), N_RELATION,
                          30, 4, 8)
    pfn, jfn = conve("port"), conve("jax")
    head, rel, tail, neg = inputs()
    for fn, conv in ((pfn, torch.from_numpy), (jfn, jnp.asarray)):
        with pytest.raises(NotImplementedError, match="head corruption"):
            fn.score_heads(None, conv(neg), conv(rel), conv(tail))


def test_sync_batch_norm_is_the_identity_on_one_device():
    """sync_batch_norm=True without a mesh axis normalises as without it;
    with one and no mesh bound it raises (over a mesh it pmeans the moments:
    tests/test_torch_mesh.py)."""
    sync, plain = conve("port", sync_batch_norm=True), conve("port")
    pp = to_port(random_params(conve("jax")))
    head, rel, tail, _ = inputs()
    args = [torch.from_numpy(x) for x in (head, rel, tail)]
    assert torch.equal(sync.score_triple(pp, *args, train=True),
                       plain.score_triple(pp, *args, train=True))
    sync.mesh_axis = "shard"
    with pytest.raises(RuntimeError, match="mesh="):
        sync.score_triple(pp, *args, train=True)


def test_full_fp32_products_survive_mixed_precision_settings():
    """ConvE's linear map (and every pool product) runs under
    ``ops.distance._full_fp32``, which read the generic float32 matmul
    precision: after ``set_float32_matmul_precision("high")`` and a legacy
    ``allow_tf32 = False`` that getter raises (torch 2.9 on). The block now
    reads and restores cuBLAS's own flags: it runs in that state, turns TF32
    off inside, and leaves the caller's flags as they were."""
    from besskge_tpu_torch.ops import distance

    mm = torch.backends.cuda.matmul
    try:
        torch.set_float32_matmul_precision("high")
        mm.allow_tf32 = False
        pfn = conve("port")
        pp = to_port(random_params(conve("jax")))
        head, rel, _, neg = inputs()
        got = pfn.score_tails(pp, *map(torch.from_numpy, (head, rel, neg)))
        assert got.shape == (B, N_NEG) and mm.allow_tf32 is False
        for before in (True, False):
            mm.allow_tf32 = before
            with distance._full_fp32():
                assert mm.allow_tf32 is False
                assert mm.allow_bf16_reduced_precision_reduction is False
            assert mm.allow_tf32 is before
    finally:
        torch.set_float32_matmul_precision("highest")
        mm.allow_tf32 = False
