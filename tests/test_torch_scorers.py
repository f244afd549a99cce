"""The port's scorers but ConvE against the JAX package's, method by method.

DistMult, ComplEx, PairRE, TripleRE (and v2), BoxE, InterHT and TranS of
both packages are built with the same arguments (60 entities on one shard,
7 relation types, ``embedding_size`` 8); the port's params are the JAX
package's ``initial_params`` carried over by ``convert.params_from_jax``.
Inputs are numpy draws from a seed: query rows and candidate rows picked
from the table, and relation IDs.

Tolerances, each stated where it is used:

* ``initial_params``, the utils: bit for bit.
* fp32 scores: rtol 1e-5 against each result's largest value
  (``|got − want| ≤ 1e-5·(|want| + max|want|)``): sums of at most 2·8 terms
  and the products, norms, tanh and exp of two libraries, in other orders.
* fp32 gradients (of the scores weighted by a random cotangent, with
  respect to the query rows, the candidate rows and the relation table):
  the same bound. The inputs hold no exact zero under an ``abs`` (checked),
  where the JAX package's gradient is ``+g`` and the port's 0; a test of
  its own holds the port to ``sign(0) = 0`` there.
* bf16 ``compute_dtype``: the two libraries round each elementwise op to
  bf16 alike but may order the fp32 sums differently, and a sum that lands
  on the neighbouring bf16 value moves everything after it by one ulp:
  ``2^-7·(|want| + max|want|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import utils as jax_utils
from besskge_tpu_torch import convert
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import utils as port_utils

N_ENTITY, N_RELATION, EMB, N_QUERY, N_CAND = 60, 7, 8, 12, 5

#: (id, class name, whether it takes scoring_norm, extra keyword arguments).
CASES = [
    ("distmult", "DistMult", False, {}),
    ("distmult-inverse", "DistMult", False, {"inverse_relations": True}),
    ("complex", "ComplEx", False, {}),
    ("complex-inverse", "ComplEx", False, {"inverse_relations": True}),
    ("pairre-p1", "PairRE", 1, {}),
    ("pairre-p2", "PairRE", 2, {}),
    ("pairre-unnormalized", "PairRE", 1, {"normalize_entities": False}),
    ("triplere-p1", "TripleRE", 1, {}),
    ("triplere-v2-p2", "TripleRE", 2, {"u": 0.5}),
    ("triplere-unnormalized", "TripleRE", 1, {"normalize_entities": False}),
    ("boxe-p1", "BoxE", 1, {}),
    ("boxe-p2", "BoxE", 2, {}),
    ("boxe-no-tanh", "BoxE", 1, {"apply_tanh": False}),
    ("boxe-all-dims", "BoxE", 1, {"dist_func_per_dim": False}),
    ("boxe-no-tanh-all-dims-inverse", "BoxE", 2,
     {"apply_tanh": False, "dist_func_per_dim": False, "inverse_relations": True}),
    ("interht-p1", "InterHT", 1, {}),
    ("interht-p2-unnormalized", "InterHT", 2, {"normalize_entities": False, "offset": 0.5}),
    ("trans-p1", "TranS", 1, {}),
    ("trans-p2-unnormalized", "TranS", 2, {"normalize_entities": False, "offset": 2.0}),
]
IDS = [c[0] for c in CASES]
SCORERS = sorted({c[1] for c in CASES})


def _pair(cls, norm, extra, sharing=True, seed=11):
    """(JAX score function, port score function) of one case."""
    fns = []
    for sc, sh in ((jax_scoring, jax_sh), (port_scoring, port_sh)):
        sharding = sh.Sharding.create(N_ENTITY, 1, seed=0)
        args = (sharing, norm) if norm else (sharing,)
        fns.append(getattr(sc, cls)(*args, sharding, N_RELATION, EMB, seed=seed, **extra))
    return fns


def _inputs(jfn, sharing, seed=5):
    """The JAX params, the port's copy, and numpy query rows (N_QUERY, row),
    candidate rows (b, N_CAND, row) and relation IDs."""
    params = jfn.initial_params()
    pparams = convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    rng = np.random.default_rng(seed)
    ent = np.asarray(params["entity_embedding"])
    n_rel = params["relation_embedding"].shape[0]
    h = ent[rng.integers(0, N_ENTITY, N_QUERY)]
    t = ent[rng.integers(0, N_ENTITY, N_QUERY)]
    r = rng.integers(0, n_rel, N_QUERY).astype(np.int32)
    b = 2 if sharing else N_QUERY
    cand = ent[rng.integers(0, N_ENTITY, b * N_CAND)].reshape(b, N_CAND, -1)
    return params, pparams, h, r, t, cand


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = rtol * (np.abs(want) + np.abs(want).max())
    assert (err <= tol).all(), float((err - tol).max())


def _scores(fn, params, h, r, t, cand, lib):
    wrap = jnp.asarray if lib == "jax" else torch.from_numpy
    h, r, t, cand = wrap(h), wrap(r), wrap(t), wrap(cand)
    return {
        "triple": fn.score_triple(params, h, r, t),
        "heads": fn.score_heads(params, cand, r, t),
        "tails": fn.score_tails(params, h, r, cand),
    }


def test_utils_match_jax_bit_for_bit():
    x = np.random.default_rng(0).normal(size=(3, 4, 10)).astype(np.float32)
    got = port_utils.interleaved_to_blocked(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_utils.interleaved_to_blocked(jnp.asarray(x))))
    np.testing.assert_array_equal(got[..., :5], x[..., 0::2])
    for g, w in zip(port_utils.as_complex_pair(torch.from_numpy(x)),
                    jax_utils.as_complex_pair(jnp.asarray(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_initial_params_are_bit_equal(case):
    _, cls, norm, extra = case
    jfn, pfn = _pair(cls, norm, extra)
    assert (pfn.entity_row_size, pfn.relation_row_size) == (jfn.entity_row_size,
                                                            jfn.relation_row_size)
    want = jfn.initial_params()
    got = pfn.initial_params(device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    dev = pfn.initial_params_device(device="cpu")
    for key in want:
        assert dev[key].shape == got[key].shape and torch.isfinite(dev[key]).all()


def test_boxe_rows_are_the_widest():
    """BoxE's relation row is 4d + 2 wide: 514 at d = 128, not a multiple of
    4 (the width every dense optimizer and checkpoint path must take)."""
    sharding = port_sh.Sharding.create(10, 1, seed=0)
    fn = port_scoring.BoxE(True, 1, sharding, 3, 128)
    assert (fn.entity_row_size, fn.relation_row_size) == (256, 514)
    assert port_scoring.BaseScoreFunction.mesh_axis is None is fn.mesh_axis


@pytest.mark.parametrize("sharing", [True, False], ids=["sharing", "no-sharing"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scores_match_jax(case, sharing):
    _, cls, norm, extra = case
    jfn, pfn = _pair(cls, norm, extra, sharing)
    params, pparams, h, r, t, cand = _inputs(jfn, sharing)
    want = _scores(jfn, params, h, r, t, cand, "jax")
    got = _scores(pfn, pparams, h, r, t, cand, "torch")
    n = N_CAND * (2 if sharing else 1)
    assert got["heads"].shape == got["tails"].shape == (N_QUERY, n)
    for key in want:
        _close(got[key].numpy(), want[key])


@pytest.mark.parametrize("cls", SCORERS)
def test_bf16_compute_matches_jax(cls):
    case = next(c for c in CASES if c[1] == cls)
    jfn, pfn = _pair(cls, case[2], case[3])
    jfn.compute_dtype, pfn.compute_dtype = jnp.bfloat16, torch.bfloat16
    params, pparams, h, r, t, cand = _inputs(jfn, True)
    bf = lambda x: np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    h16, t16, cand16 = bf(h), bf(t), bf(cand)
    want = _scores(jfn, params, jnp.asarray(h16, jnp.bfloat16), r, jnp.asarray(t16, jnp.bfloat16),
                   jnp.asarray(cand16, jnp.bfloat16), "jax")
    # The rows arrive in bf16, as the BESS modules cast them.
    got = {
        "triple": pfn.score_triple(pparams, torch.from_numpy(h16).bfloat16(), torch.from_numpy(r),
                                   torch.from_numpy(t16).bfloat16()),
        "heads": pfn.score_heads(pparams, torch.from_numpy(cand16).bfloat16(),
                                 torch.from_numpy(r), torch.from_numpy(t16).bfloat16()),
        "tails": pfn.score_tails(pparams, torch.from_numpy(h16).bfloat16(), torch.from_numpy(r),
                                 torch.from_numpy(cand16).bfloat16()),
    }
    for key in want:
        assert got[key].dtype == torch.bfloat16 and want[key].dtype == jnp.bfloat16, key
        _close(got[key].float().numpy(), np.asarray(want[key].astype(jnp.float32)),
               rtol=2.0**-7)


def _abs_arguments_nonzero(cls, pfn, pparams, h, r, t, cand):
    """No exact zero reaches an ``abs`` of the port's scorer on these inputs:
    the L1 reductions' arguments and BoxE's widths and center distances."""
    seen = []
    orig = torch.abs

    def spy(x):
        seen.append(x.detach())
        return orig(x)

    torch.abs = spy
    try:
        _scores(pfn, pparams, h, r, t, cand, "torch")
    finally:
        torch.abs = orig
    return all(bool((x != 0).all()) for x in seen)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_match_jax(case):
    _, cls, norm, extra = case
    jfn, pfn = _pair(cls, norm, extra)
    params, pparams, h, r, t, cand = _inputs(jfn, True)
    assert _abs_arguments_nonzero(cls, pfn, pparams, h, r, t, cand)
    rng = np.random.default_rng(9)
    n = 2 * N_CAND
    cots = {"triple": rng.normal(size=N_QUERY), "heads": rng.normal(size=(N_QUERY, n)),
            "tails": rng.normal(size=(N_QUERY, n))}
    cots = {k: v.astype(np.float32) for k, v in cots.items()}

    def jax_loss(rel, h_, t_, c_):
        p = dict(params, relation_embedding=rel)
        out = _scores(jfn, p, h_, r, t_, c_, "jax")
        return sum(jnp.sum(out[k] * cots[k]) for k in out)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(params["relation_embedding"]), jnp.asarray(h), jnp.asarray(t),
        jnp.asarray(cand))
    leaves = [pparams["relation_embedding"].clone().requires_grad_()] + [
        torch.from_numpy(x).requires_grad_() for x in (h, t, cand)]
    rel, h_t, t_t, c_t = leaves
    p = dict(pparams, relation_embedding=rel)
    out = {
        "triple": pfn.score_triple(p, h_t, torch.from_numpy(r), t_t),
        "heads": pfn.score_heads(p, c_t, torch.from_numpy(r), t_t),
        "tails": pfn.score_tails(p, h_t, torch.from_numpy(r), c_t),
    }
    loss = sum(torch.sum(out[k] * torch.from_numpy(cots[k])) for k in out)
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("relation", "query", "tail", "candidates"), got, want):
        assert torch.isfinite(g).all(), name
        _close(g.numpy(), w)


@pytest.mark.parametrize("cls", ["PairRE", "TripleRE"])
def test_abs_at_an_exact_tie_takes_sign_zero(cls):
    """Where an L1 argument is exactly 0 (here h == t with r_h == r_t, the
    TripleRE middle part zero), the port's subgradient is 0, as torch's
    ``abs`` and the L1 kernels give; the JAX package's is ``+g`` off the TPU
    (ROADMAP C, "L1 ties"). Away from the tie both agree."""
    jfn, pfn = _pair(cls, 1, {"normalize_entities": False})
    params = jfn.initial_params()
    rel = np.asarray(params["relation_embedding"]).copy()
    rel[0, EMB:2 * EMB] = rel[0, :EMB] if cls == "PairRE" else 0.0  # r_t := r_h / r_m := 0
    if cls == "TripleRE":
        rel[0, 2 * EMB:] = rel[0, :EMB]
    h = np.asarray(params["entity_embedding"])[:1]
    r = np.zeros(1, np.int32)
    pparams = convert.params_from_jax({"entity_embedding": np.asarray(params["entity_embedding"]),
                                       "relation_embedding": rel}, "cpu")
    h_t = torch.from_numpy(h.copy()).requires_grad_()
    score = pfn.score_triple(pparams, h_t, torch.from_numpy(r), torch.from_numpy(h))
    assert float(score.detach()) == 0.0
    (g,) = torch.autograd.grad(score.sum(), h_t)
    assert (g == 0).all()
    jgrad = jax.grad(lambda x: jfn.score_triple(dict(params, relation_embedding=jnp.asarray(rel)),
                                                x, jnp.asarray(r), jnp.asarray(h)).sum())(
        jnp.asarray(h))
    assert (np.asarray(jgrad) != 0).any()  # the reference's +g at the tie


def test_l2_normalize_is_the_reference_formula():
    """``v / sqrt(Σv² + 1e-12)``, value and gradient, not ``F.normalize``."""
    x = np.random.default_rng(2).normal(size=(6, 9)).astype(np.float32)
    x[0] = 0.0
    want = jax_scoring._l2_normalize(jnp.asarray(x))
    got = port_scoring._l2_normalize(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert (got[0] == 0).all()
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    jgrad = jax.grad(lambda v: jnp.sum(jax_scoring._l2_normalize(v) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tgrad,) = torch.autograd.grad(torch.sum(port_scoring._l2_normalize(xt) * torch.from_numpy(w)),
                                   xt)
    _close(tgrad.numpy(), jgrad)
    assert float(tgrad[0].abs().max()) > 1e5  # 1/sqrt(1e-12): not F.normalize's 1/eps clamp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_product_accumulates_in_fp32(dtype):
    """The shared-pool product of DistMult and ComplEx: ``v1 @ pool.T``
    accumulated in fp32 and cast to ``v1``'s dtype, as ``jnp.dot(...,
    preferred_element_type=float32).astype``; fp32 at rtol 1e-6, bf16 to
    one bf16 ulp of the fp32-accumulated value."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(9, 64)).astype(np.float32)
    b = rng.normal(size=(2, 13, 64)).astype(np.float32)
    jfn, pfn = _pair("DistMult", False, {})
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jfn.broadcasted_dot_product(jnp.asarray(a, jd), jnp.asarray(b, jd))
                      .astype(jnp.float32))
    got = pfn.broadcasted_dot_product(torch.from_numpy(a).to(td), torch.from_numpy(b).to(td))
    assert got.dtype == td and got.shape == (9, 26)
    rtol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())
