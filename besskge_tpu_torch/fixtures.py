"""Deterministic ogbl-biokg-like and ogbl-wikikg2-like fixtures for offline
downstream-quality runs (torch).

Counterpart of ``besskge_tpu/fixtures.py``: the same public names,
signatures and defaults, the same datasets and the same cache files. Both
fixtures are synthetic and made from a seed, so no download is needed.

* :func:`build_biokg_fixture`: ogbl-biokg's published shape (93,773
  entities in 5 type-contiguous types, 51 relations, 4,762,678 / 162,886 /
  162,870 triples, 500 + 500 type-matched eval negatives) around a planted,
  clustered RotatE model (:class:`PlantedRotatE`). Each triple's head is
  drawn from its relation's Boltzmann head marginal ``p(h) ∝ Z_h(r)`` and
  its tail from the conditional ``p(t | h, r) ∝ exp(-d(h∘r, t)/T)`` over the
  whole tail type, exactly, by the Gumbel-max trick; ``T`` is calibrated by
  bisection so that the planted model's expected MRR hits
  ``target_oracle``.
* :func:`build_wikikg2_fixture`: ogbl-wikikg2's published shape around a
  planted, exactly TransE-representable lattice (:class:`PlantedTransE`);
  numpy only, bit for bit the JAX package's arrays.

The numpy parts are copied: every ``np.random.default_rng`` draw comes in
the same order from the same streams. The device scans of the biokg build
(``_pick``, ``_log_z``, ``_subsampled_log_z``, ``_count_better``: the JAX
package's ``_type_scan_fns``) run on ``device`` in fp32. Each scores a
block of rotated queries against a shared contiguous run of entity rows
(IDs are type-contiguous), which is an all-pairs L1 distance: it goes through
:func:`besskge_tpu_torch.ops.l1_kernels.l1_distance_matrix` (B5), the
port's CUDA kernel on a card and its plain version on the CPU. The Gumbel
uniforms come from the port's counter hash (:func:`_gumbel_uniforms`, keyed
by (batch key, row, candidate column), so the picks do not depend on
``chunk``), where the JAX package draws ``jax.random.uniform``. A build is
therefore the same on the CPU and on the card up to fp32 sums taken in
another order (a Gumbel near-tie can flip), and differs from the JAX
package's build in its tails. The JAX package's file of the same cache name
holds other draws: callers keep the two caches apart.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed, and raise
without a card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from numpy.typing import NDArray

from besskge_tpu_torch.dataset import KGDataset
from besskge_tpu_torch.device_sampler import _fold_in
from besskge_tpu_torch.ops.l1_kernels import l1_distance_matrix
from besskge_tpu_torch.utils import _M32, _mix32, _mul32, complex_rotation, resolve_device

__all__ = [
    "BIOKG_TYPE_COUNTS",
    "BIOKG_SPLIT_SIZES",
    "PlantedRotatE",
    "build_biokg_fixture",
    "expected_rr",
]

Device = Optional[Union[str, torch.device]]

#: Published ogbl-biokg entity-type sizes (sum = 93,773).
BIOKG_TYPE_COUNTS: Dict[str, int] = {
    "disease": 10_687,
    "drug": 10_533,
    "function": 45_085,
    "protein": 17_499,
    "sideeffect": 9_969,
}

#: Published split sizes (train, valid, test).
BIOKG_SPLIT_SIZES: Tuple[int, int, int] = (4_762_678, 162_886, 162_870)

#: Official eval protocol: 500 negative heads + 500 negative tails.
N_EVAL_NEGATIVE = 500

_GOLDEN = 0x9E3779B9
#: Salt of the Gumbel stream of a batch key.
_GUMBEL_SALT = 0x452821E6


def _relation_spec() -> Tuple[Tuple[str, str, float], ...]:
    """(head_type, tail_type, trainfraction) for the 51 relations: 38
    drug-drug, 7 protein-protein and 6 cross-type relations, with a
    geometric within-family profile (copied from the JAX package)."""
    spec = []

    def family(head, tail, n, mass):
        w = 0.82 ** np.arange(n)
        w = mass * w / w.sum()
        spec.extend((head, tail, float(f)) for f in w)

    family("drug", "drug", 38, 0.56)
    family("protein", "protein", 7, 0.13)
    family("function", "function", 1, 0.20)
    family("protein", "function", 1, 0.06)
    family("drug", "sideeffect", 1, 0.03)
    family("disease", "protein", 1, 0.015)
    family("drug", "protein", 1, 0.004)
    family("drug", "disease", 1, 0.001)
    assert len(spec) == 51
    return tuple(spec)


def expected_rr(q: NDArray[np.float64], n_negative: int = N_EVAL_NEGATIVE):
    """Expected reciprocal rank of a true entity with a fraction ``q`` of
    its type scoring strictly higher, against ``n_negative`` uniform
    type-matched negatives: ``E[1/(1+Binom(n, q))] =
    (1-(1-q)^(n+1)) / ((n+1) q)``, with the exact limit 1 at ``q=0``."""
    q = np.asarray(q, np.float64)
    safe = np.maximum(q, 1e-12)
    n = n_negative + 1
    rr = (1.0 - (1.0 - safe) ** n) / (n * safe)
    return np.where(q <= 0.0, 1.0, rr)


@dataclasses.dataclass
class PlantedRotatE:
    """The generator's ground-truth model: blocked-complex entity rows and
    relation phases, scored as ``-||h ∘ e^{i r} − t||_1`` (matching
    :class:`besskge_tpu_torch.scoring.RotatE` with ``scoring_norm=1``).

    :param device: where :meth:`rank_against` runs (default ``cuda``).
    """

    entity: NDArray[np.float32]  # (n_entity, 2*emb)
    phase: NDArray[np.float32]  # (n_relation, emb)
    device: Device = None

    def score(self, h, r, t) -> NDArray[np.float32]:
        """Planted scores for (h, r, t) index triples (host math)."""
        hr = complex_rotation(torch.from_numpy(self.entity[h]), torch.from_numpy(self.phase[r]))
        return (-(hr - torch.from_numpy(self.entity[t])).abs().sum(-1)).numpy()

    def rank_against(self, triples, negatives, corrupt: str) -> NDArray[np.int32]:
        """1-based rank of each true triple against its negative pool
        (``corrupt`` = "h" or "t"), worst tie-breaking to match
        :class:`besskge_tpu_torch.metric.Evaluation`'s default, on
        :attr:`device` with the tables kept there (only index arrays cross
        from the host)."""
        e_tab, ph_tab = self._e_dev(), self._p_dev()
        ranks = _planted_ranks(
            e_tab, ph_tab,
            torch.from_numpy(np.asarray(triples, np.int64)).to(e_tab.device),
            torch.from_numpy(np.asarray(negatives, np.int64)).to(e_tab.device),
            corrupt == "t",
        )
        return ranks.cpu().numpy().astype(np.int32)

    def _e_dev(self) -> torch.Tensor:
        if getattr(self, "_e_cache", None) is None:
            self._e_cache = torch.from_numpy(self.entity).to(resolve_device(self.device))
        return self._e_cache

    def _p_dev(self) -> torch.Tensor:
        if getattr(self, "_p_cache", None) is None:
            self._p_cache = torch.from_numpy(self.phase).to(resolve_device(self.device))
        return self._p_cache


# ---------------------------------------------------------------- device gen
def _planted_ranks(e_tab: torch.Tensor, ph_tab: torch.Tensor, triples: torch.Tensor,
                   negatives: torch.Tensor, corrupt_tail: bool) -> torch.Tensor:
    """1-based worst-tie ranks of true triples against their own negative
    pools under the planted RotatE scorer, the pools scanned in chunks of
    100 (the JAX package's ``_planted_rank_kernel``). The candidates differ
    per triple, so this is a gather and a broadcast, not a shared-pool
    distance."""
    h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]
    ph = ph_tab[r]
    hr = complex_rotation(e_tab[h], ph)
    t_emb = e_tab[t]
    pos = -(hr - t_emb).abs().sum(-1)
    acc = torch.ones(h.shape, dtype=torch.int32, device=e_tab.device)
    for lo in range(0, negatives.shape[1], 100):
        cand = e_tab[negatives[:, lo : lo + 100]]  # (B, chunk, 2emb)
        if corrupt_tail:
            s = -(hr[:, None, :] - cand).abs().sum(-1)
        else:
            s = -(complex_rotation(cand, ph[:, None, :]) - t_emb[:, None, :]).abs().sum(-1)
        acc += (s >= pos[:, None]).sum(1, dtype=torch.int32)
    return acc


def _planted_transe_ranks(e_tab: torch.Tensor, r_tab: torch.Tensor, triples: torch.Tensor,
                          negatives: torch.Tensor, corrupt_tail: bool) -> torch.Tensor:
    """:func:`_planted_ranks` for TransE ``-||h + r − t||_1`` (the JAX
    package's ``_planted_transe_rank_kernel``): any (entity, relation)
    tables, on their device."""
    h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]
    rel = r_tab[r]
    hr = e_tab[h] + rel
    t_emb = e_tab[t]
    pos = -(hr - t_emb).abs().sum(-1)
    acc = torch.ones(h.shape, dtype=torch.int32, device=e_tab.device)
    for lo in range(0, negatives.shape[1], 100):
        cand = e_tab[negatives[:, lo : lo + 100]]  # (B, chunk, d)
        if corrupt_tail:
            s = -(hr[:, None, :] - cand).abs().sum(-1)
        else:
            s = -(cand + rel[:, None, :] - t_emb[:, None, :]).abs().sum(-1)
        acc += (s >= pos[:, None]).sum(1, dtype=torch.int32)
    return acc


def _gumbel_uniforms(key: torch.Tensor, n_rows: int, n_ty: int, off: int, n: int) -> torch.Tensor:
    """fp32 uniforms in ``[1e-20, 1)`` for rows ``0 .. n_rows-1`` and type
    columns ``off .. off+n-1`` of one batch key, on the key's device: draw
    ``row·n_ty + column`` of the key's stream hashes ``seed + i·golden``
    (mod 2^32), and its top 24 bits times 2^-24 are exact in fp32. A draw
    depends on (key, row, column) only, not on the chunking; the clamp at
    1e-20 (``jax.random.uniform``'s ``minval`` in the JAX package) keeps
    ``-log(-log(u))`` finite."""
    dev = key.device
    seed = _mix32(key ^ _GUMBEL_SALT)
    rows = _mul32(torch.arange(n_rows, dtype=torch.int64, device=dev) * n_ty, _GOLDEN)
    cols = _mul32(torch.arange(off, off + n, dtype=torch.int64, device=dev), _GOLDEN)
    x = _mix32((seed + rows[:, None] + cols[None, :]) & _M32)
    return ((x >> 8).to(torch.float32) * 2.0**-24).clamp_min_(1e-20)


def _hr(e_tab: torch.Tensor, ph_tab: torch.Tensor, hh: torch.Tensor, rr: torch.Tensor):
    # fp32 throughout: the fixture's within-type top ranks must agree with
    # the fp32 PlantedRotatE oracle.
    return complex_rotation(e_tab.index_select(0, hh), ph_tab.index_select(0, rr))


def _pick(e_tab, ph_tab, hh, rr, key, lo: int, n_ty: int, chunk: int, temp: float):
    """Gumbel-max sample from ``p(t) ∝ exp(score(h∘r, t)/T)`` over the
    contiguous type range ``[lo, lo+n_ty)``, in chunks of ``chunk`` columns
    (B5 per chunk; the last chunk is short). No host synchronisation."""
    hr = _hr(e_tab, ph_tab, hh, rr)
    best = torch.full(hh.shape, -math.inf, dtype=torch.float32, device=hr.device)
    best_id = torch.zeros(hh.shape, dtype=torch.int64, device=hr.device)
    for off in range(0, n_ty, chunk):
        n = min(chunk, n_ty - off)
        s = -l1_distance_matrix(hr, e_tab[lo + off : lo + off + n])
        u = _gumbel_uniforms(key, hh.shape[0], n_ty, off, n)
        s = s + temp * -torch.log(-torch.log(u))
        m, am = s.max(1)
        upd = m > best
        best = torch.where(upd, m, best)
        best_id = torch.where(upd, am + (lo + off), best_id)
    return best_id


def _log_z(e_tab, ph_row, temp: float, h_lo: int, h_n: int, t_lo: int, t_n: int, chunk: int):
    """Per-head log partition function ``log Σ_t exp(-d(h∘r, t)/T)`` over
    the tail type: a streaming log-sum-exp over tail chunks (B5 per tile),
    within head chunks; ``(h_n,)`` fp32."""
    out = []
    for h_off in range(0, h_n, chunk):
        hr = complex_rotation(e_tab[h_lo + h_off : h_lo + min(h_off + chunk, h_n)], ph_row[None, :])
        m = torch.full(hr.shape[:1], -math.inf, dtype=torch.float32, device=hr.device)
        s = torch.zeros(hr.shape[:1], dtype=torch.float32, device=hr.device)
        for t_off in range(0, t_n, chunk):
            x = -l1_distance_matrix(hr, e_tab[t_lo + t_off : t_lo + min(t_off + chunk, t_n)]) / temp
            new_m = torch.maximum(m, x.amax(1))
            s = s * torch.exp(m - new_m) + torch.exp(x - new_m[:, None]).sum(1)
            m = new_m
        out.append(m + torch.log(s))
    return torch.cat(out)


def _subsampled_log_z(e_tab, ph_row, h_ids, t_ids, temp: float):
    """``log Σ_{t∈t_ids} exp(-d(h∘r,t)/T)`` per candidate head (B5 over the
    sampled tails): a subsampled estimate of the head marginal, used only
    to make the calibration probe draw heads the way generation does."""
    hr = complex_rotation(e_tab.index_select(0, h_ids), ph_row[None, :])
    s = -l1_distance_matrix(hr, e_tab.index_select(0, t_ids))
    return torch.logsumexp(s / temp, dim=1)


def _count_better(e_tab, ph_tab, hh, rr, tt, lo: int, n_ty: int, chunk: int):
    """Within-type counts of entities scoring strictly above the true tail
    (B5 per chunk), for the calibration's quantiles. The true tail's own
    column is left out: B5 sums its distance in another order than the
    threshold's sum, so on the card it could score a rounding above itself
    and count (at 502 entities a type, a self-count of half the probes
    moved the estimate by over 0.01 and the calibrated temperature to
    another bisection point)."""
    hr = _hr(e_tab, ph_tab, hh, rr)
    thr = -(hr - e_tab.index_select(0, tt)).abs().sum(-1)
    cnt = torch.zeros(hh.shape, dtype=torch.int64, device=hr.device)
    for off in range(0, n_ty, chunk):
        n = min(chunk, n_ty - off)
        s = -l1_distance_matrix(hr, e_tab[lo + off : lo + off + n])
        cols = torch.arange(lo + off, lo + off + n, device=hr.device)
        cnt += ((s > thr[:, None]) & (cols[None, :] != tt[:, None])).sum(1)
    return cnt


def _index(x: NDArray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)


def _calibrate_temperature(
    e_dev, p_dev, rng, rel_frac, h_lo, h_n, t_lo, t_n, target, chunk,
    n_eval_negative, n_probe=768,
):
    """Bisection on ``log T`` so the planted oracle MRR (quantile-based
    analytic estimate, :func:`expected_rr`) hits ``target``.

    Probe triples are drawn the way generation draws them: heads from the
    relation's Boltzmann head marginal (estimated per temperature with a
    subsampled partition function over ≤2048 head × ≤2048 tail candidates),
    tails from the exact full-type conditional. The Gumbel keys fold a
    counter into the key 12345, one per group of every probe."""
    dev = e_dev.device
    n_relation = len(rel_frac)
    r_probe = rng.choice(n_relation, size=n_probe, p=rel_frac).astype(np.int32)
    base = torch.tensor(12345, dtype=torch.int64, device=dev)
    n_key = 0

    sub_cap = 2048
    rel_cand: Dict[int, Tuple[NDArray, NDArray]] = {}
    for rid in np.unique(r_probe):
        hc = min(int(h_n[rid]), sub_cap)
        tc = min(int(t_n[rid]), sub_cap)
        rel_cand[int(rid)] = (
            (h_lo[rid] + rng.choice(h_n[rid], size=hc, replace=False)).astype(np.int32),
            (t_lo[rid] + rng.choice(t_n[rid], size=tc, replace=False)).astype(np.int32),
        )

    groups = []
    for lo, n_ty in sorted({(int(t_lo[r]), int(t_n[r])) for r in r_probe}):
        m = (t_lo[r_probe] == lo) & (t_n[r_probe] == n_ty)
        groups.append((np.where(m)[0], lo, n_ty))

    def oracle(log_t):
        nonlocal n_key
        temp = math.exp(log_t)
        # Heads ~ subsampled marginal (per relation, at this temperature).
        h_probe = np.empty(n_probe, np.int32)
        for rid, (h_cand, t_cand) in rel_cand.items():
            m = np.where(r_probe == rid)[0]
            lz = _subsampled_log_z(
                e_dev, p_dev[rid], _index(h_cand, dev), _index(t_cand, dev), temp,
            ).cpu().numpy().astype(np.float64)
            p = np.exp(lz - lz.max())
            h_probe[m] = h_cand[rng.choice(h_cand.size, size=m.size, p=p / p.sum())]
        rr = np.empty(n_probe)
        for idx, lo, n_ty in groups:
            sub = _fold_in(base, n_key)
            n_key += 1
            hh = _index(h_probe[idx], dev)
            rr_ids = _index(r_probe[idx], dev)
            tt = _pick(e_dev, p_dev, hh, rr_ids, sub, lo, n_ty, chunk, temp)
            cnt = _count_better(e_dev, p_dev, hh, rr_ids, tt, lo, n_ty, chunk).cpu().numpy()
            # Negatives are uniform over the type minus the true entity.
            q = cnt / max(n_ty - 1, 1)
            rr[idx] = expected_rr(q, n_eval_negative)
        return float(rr.mean())

    lo_t, hi_t = math.log(1e-3), math.log(30.0)
    est = None
    # Oracle MRR decreases in T.
    for _ in range(14):
        mid = 0.5 * (lo_t + hi_t)
        est = oracle(mid)
        if abs(est - target) < 0.004:
            return math.exp(mid), est
        if est > target:
            lo_t = mid
        else:
            hi_t = mid
    mid = 0.5 * (lo_t + hi_t)
    return math.exp(mid), oracle(mid)


def _cache_file(cache_dir: str, seed, scale, temperature, target_oracle, cluster_size,
                cluster_noise, n_eval_negative):
    import pathlib

    key = (
        f"biokg_s{seed}_sc{scale}_t{temperature or target_oracle}"
        f"_c{cluster_size}_n{cluster_noise}_neg{n_eval_negative}"
    ).replace(".", "p")
    return pathlib.Path(cache_dir) / f"{key}.npz"


def _load_cache(cache, return_planted: bool, device: torch.device):
    z = np.load(cache, allow_pickle=False)
    ds = KGDataset(
        n_entity=int(z["n_entity"]),
        n_relation_type=int(z["n_relation"]),
        entity_dict=None,
        relation_dict=list(z["relation_dict"]),
        type_offsets={str(k): int(v) for k, v in zip(z["type_names"], z["type_offs"])},
        triples={p: z[f"tri_{p}"] for p in ("train", "valid", "test")},
        original_triple_ids={
            p: np.arange(len(z[f"tri_{p}"]), dtype=np.int64) for p in ("train", "valid", "test")
        },
        neg_heads={p: z[f"nh_{p}"] for p in ("valid", "test")},
        neg_tails={p: z[f"nt_{p}"] for p in ("valid", "test")},
    )
    if not return_planted:
        return ds
    planted = PlantedRotatE(entity=z["ent"], phase=z["phase"], device=device)
    planted.temperature = float(z["temp"])  # type: ignore[attr-defined]
    planted.oracle_estimate = (  # type: ignore[attr-defined]
        float(z["oracle_est"]) if z["oracle_est"] >= 0 else None
    )
    return ds, planted


def build_biokg_fixture(
    seed: int = 0,
    scale: float = 1.0,
    target_oracle: float = 0.86,
    temperature: Optional[float] = None,
    cluster_size: int = 48,
    cluster_noise: float = 0.35,
    chunk: int = 512,
    batch: int = 4096,
    n_eval_negative: int = N_EVAL_NEGATIVE,
    return_planted: bool = False,
    cache_dir: Optional[str] = None,
    device: Device = None,
):
    """Build the biokg-like fixture dataset (see module docstring).

    :param scale: shrink factor for entity-type sizes and split sizes
        (tests use e.g. ``0.02``; quality runs use ``1.0``).
    :param target_oracle: calibrate the Boltzmann temperature so the planted
        model's analytic MRR vs ``n_eval_negative`` type-matched negatives
        hits this ceiling (ignored when ``temperature`` is given).
    :param temperature: fixed Boltzmann temperature (skips calibration).
    :param cluster_size: target entities per planted cluster.
    :param cluster_noise: uniform half-width of within-cluster noise
        (cluster centers are uniform in [-1, 1]).
    :param chunk: tail-type candidates scored per scan step on device.
    :param batch: triples sampled per scan.
    :param return_planted: also return the :class:`PlantedRotatE` generator
        and metadata (for oracle-MRR measurement).
    :param cache_dir: directory for a generation cache keyed on the build
        parameters, with the JAX package's file name and ``.npz`` keys (a
        file of either package loads into the other; the tails of the two
        packages' builds differ, so keep their directories apart). The
        port writes the file uncompressed.
    :param device: where the scans run (default ``cuda``; raises without
        a card).
    """
    device = resolve_device(device)
    cache = None
    if cache_dir is not None:
        cache = _cache_file(cache_dir, seed, scale, temperature, target_oracle, cluster_size,
                            cluster_noise, n_eval_negative)
        if cache.exists():
            return _load_cache(cache, return_planted, device)

    emb = 64
    rng = np.random.default_rng(seed)
    counts = {
        k: max(int(round(v * scale)), n_eval_negative + 2 if scale < 1 else v)
        for k, v in BIOKG_TYPE_COUNTS.items()
    }
    type_offsets: Dict[str, int] = {}
    off = 0
    for k in sorted(counts):
        type_offsets[k] = off
        off += counts[k]
    n_entity = off
    spec = _relation_spec()
    n_relation = len(spec)

    # Clustered planted entities: type = mixture of uniform clusters.
    entity = np.empty((n_entity, 2 * emb), np.float32)
    for ty, n_ty in counts.items():
        lo = type_offsets[ty]
        n_cl = max(2, n_ty // cluster_size)
        centers = rng.uniform(-1.0, 1.0, size=(n_cl, 2 * emb))
        assign = rng.integers(n_cl, size=n_ty)
        entity[lo : lo + n_ty] = (
            centers[assign]
            + rng.uniform(-cluster_noise, cluster_noise, size=(n_ty, 2 * emb))
        ).astype(np.float32)
    planted = PlantedRotatE(
        entity=entity,
        phase=rng.uniform(0.0, 2 * np.pi, size=(n_relation, emb)).astype(np.float32),
        device=device,
    )
    e_dev, p_dev = planted._e_dev(), planted._p_dev()

    split_sizes = [max(int(round(s * scale)), 64) for s in BIOKG_SPLIT_SIZES]
    rel_frac = np.array([w for _, _, w in spec])
    rel_frac = rel_frac / rel_frac.sum()

    # Per-relation head/tail type bounds, indexable by relation ID.
    h_lo = np.array([type_offsets[h] for h, _, _ in spec], np.int64)
    h_n = np.array([counts[h] for h, _, _ in spec], np.int64)
    t_lo = np.array([type_offsets[t] for _, t, _ in spec], np.int64)
    t_n = np.array([counts[t] for _, t, _ in spec], np.int64)

    if temperature is None:
        temperature, oracle_est = _calibrate_temperature(
            e_dev, p_dev, np.random.default_rng(seed + 999), rel_frac,
            h_lo, h_n, t_lo, t_n, target_oracle, chunk, n_eval_negative,
        )
    else:
        oracle_est = None

    base = torch.tensor(seed & 0x7FFFFFFF, dtype=torch.int64, device=device)
    n_key = 0

    # Per-relation head marginal p(h) ∝ Z_h(r) of the Boltzmann coupling
    # (heads that rotate near the tail cloud generate more triples — the
    # fixture's hub structure). Sampling (h ~ marginal, t ~ conditional)
    # draws the PAIR from p(h,t) ∝ exp(-d(h∘r,t)/T), so BOTH eval
    # directions rank the truth by the same concentrated posterior.
    head_pmf: Dict[int, NDArray[np.float64]] = {}

    def _head_pmf(rid: int) -> NDArray[np.float64]:
        if rid not in head_pmf:
            lz = _log_z(
                e_dev, p_dev[rid], temperature, int(h_lo[rid]), int(h_n[rid]),
                int(t_lo[rid]), int(t_n[rid]), chunk,
            ).cpu().numpy().astype(np.float64)
            p = np.exp(lz - lz.max())
            head_pmf[rid] = p / p.sum()
        return head_pmf[rid]

    triples: Dict[str, NDArray[np.int32]] = {}
    neg_heads: Dict[str, NDArray[np.int32]] = {}
    neg_tails: Dict[str, NDArray[np.int32]] = {}
    for part, n_part in zip(("train", "valid", "test"), split_sizes):
        r_all = rng.choice(n_relation, size=n_part, p=rel_frac).astype(np.int32)
        h_all = np.empty(n_part, np.int32)
        for rid in np.unique(r_all):
            m = np.where(r_all == rid)[0]
            h_all[m] = h_lo[rid] + rng.choice(
                h_n[rid], size=m.size, p=_head_pmf(int(rid))
            ).astype(np.int32)
        # Group triples by tail type; the picks stay on the device until
        # the part is done (one copy to the host per part).
        picked = []
        for lo, n_ty in sorted({(int(t_lo[r]), int(t_n[r])) for r in r_all}):
            m = np.where((t_lo[r_all] == lo) & (t_n[r_all] == n_ty))[0]
            for i in range(0, m.size, batch):
                idx = m[i : i + batch]
                sub = _fold_in(base, n_key)
                n_key += 1
                picked.append((idx, _pick(
                    e_dev, p_dev, _index(h_all[idx], device), _index(r_all[idx], device),
                    sub, lo, n_ty, chunk, temperature,
                )))
        t_all = np.empty(n_part, np.int32)
        if picked:
            flat = torch.cat([ids for _, ids in picked]).cpu().numpy()
            t_all[np.concatenate([idx for idx, _ in picked])] = flat
        triples[part] = np.stack([h_all, r_all, t_all], axis=1)
        if part == "train":
            continue
        # Official-style negatives: uniform type-matched, true entity
        # rejected (the real protocol's negatives are guaranteed false).
        nh = np.empty((n_part, n_eval_negative), np.int32)
        nt = np.empty((n_part, n_eval_negative), np.int32)
        for rid, (h_ty, t_ty, _) in enumerate(spec):
            m = r_all == rid
            nm = int(m.sum())
            if not nm:
                continue
            for buf, ty, true in (
                (nh, h_ty, h_all[m]),
                (nt, t_ty, t_all[m]),
            ):
                lo, n_ty = type_offsets[ty], counts[ty]
                draw = lo + rng.integers(n_ty - 1, size=(nm, n_eval_negative)).astype(np.int32)
                # Collision-free trick: remap draws >= true up by one.
                draw += (draw >= true[:, None]).astype(np.int32)
                buf[m] = draw
        neg_heads[part], neg_tails[part] = nh, nt

    ds = KGDataset(
        n_entity=n_entity,
        n_relation_type=n_relation,
        entity_dict=None,
        relation_dict=[f"{h}-{t}-{i}" for i, (h, t, _) in enumerate(spec)],
        type_offsets=type_offsets,
        triples=triples,
        original_triple_ids={p: np.arange(len(v), dtype=np.int64) for p, v in triples.items()},
        neg_heads=neg_heads,
        neg_tails=neg_tails,
    )
    planted.temperature = temperature  # type: ignore[attr-defined]
    planted.oracle_estimate = oracle_est  # type: ignore[attr-defined]
    if cache is not None:
        _save_cache(cache, ds, planted)
    if return_planted:
        return ds, planted
    return ds


def _save_cache(cache, ds: KGDataset, planted: PlantedRotatE) -> None:
    """Write a build to ``cache`` with the JAX package's ``.npz`` keys
    (``planted`` carries ``temperature`` and ``oracle_estimate``).
    Uncompressed (``np.load`` reads either form): zlib ran at ~6 MB/s on
    these random IDs, minutes for the 1.3 GB of full-scale negatives."""
    names = sorted(ds.type_offsets)
    oracle_est = planted.oracle_estimate  # type: ignore[attr-defined]
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        cache,
        n_entity=ds.n_entity,
        n_relation=ds.n_relation_type,
        relation_dict=np.asarray(ds.relation_dict),
        type_names=np.asarray(names),
        type_offs=np.asarray([ds.type_offsets[k] for k in names]),
        ent=planted.entity,
        phase=planted.phase,
        temp=planted.temperature,  # type: ignore[attr-defined]
        oracle_est=-1.0 if oracle_est is None else oracle_est,
        **{f"tri_{p}": ds.triples[p] for p in ds.triples},
        **{f"nh_{p}": ds.neg_heads[p] for p in ds.neg_heads},
        **{f"nt_{p}": ds.neg_tails[p] for p in ds.neg_tails},
    )


# ===================================================================== wikikg2
#: ogbl-wikikg2 published sizes (untyped, 535 relations).
WIKIKG2_N_ENTITY = 2_500_604
WIKIKG2_N_RELATION = 535
WIKIKG2_SPLIT_SIZES = {"train": 16_109_182, "valid": 429_456, "test": 598_543}


@dataclasses.dataclass
class PlantedTransE:
    """Ground-truth generator for the wikikg2 fixture:
    ``score = -||e_h + v_r − e_t||_1`` (matches
    :class:`besskge_tpu_torch.scoring.TransE` with ``scoring_norm=1``)."""

    entity: NDArray[np.float32]  # (n_entity, d)
    relation: NDArray[np.float32]  # (n_relation, d)

    def score(self, h, r, t) -> NDArray[np.float32]:
        x = self.entity[h] + self.relation[r] - self.entity[t]
        return -np.abs(x).sum(-1).astype(np.float32)

    def rank_against(self, triples, negatives, corrupt: str):
        """1-based worst-tie ranks vs per-triple negative pools, in chunked
        numpy on the host (seconds at oracle-sample sizes; the planted
        table stays off the device)."""
        triples = np.asarray(triples)
        negatives = np.asarray(negatives)
        h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]
        hr = self.entity[h] + self.relation[r]
        pos = -np.abs(hr - self.entity[t]).sum(-1)
        worse = np.ones(len(triples), np.int32)
        for lo in range(0, negatives.shape[1], 50):
            ids = negatives[:, lo : lo + 50]
            cand = self.entity[ids]  # (B, c, d)
            if corrupt == "t":
                s = -np.abs(hr[:, None, :] - cand).sum(-1)
            else:
                s = -np.abs(
                    cand + self.relation[r][:, None, :]
                    - self.entity[t][:, None, :]
                ).sum(-1)
            worse += (s >= pos[:, None]).sum(1).astype(np.int32)
        return worse


def build_wikikg2_fixture(
    seed: int = 0,
    scale: float = 1.0,
    structural_fraction: float = 0.95,
    emb_size: int = 128,
    lattice_dim: int = 4,
    cluster_size: int = 64,
    noise: float = 0.08,
    member_skew: float = 8.0,
    n_eval_negative: int = N_EVAL_NEGATIVE,
    oracle_sample: int = 4000,
    eval_rows: Optional[int] = None,
    return_planted: bool = False,
):
    """ogbl-wikikg2-shaped fixture with a planted, exactly
    TransE-representable structure (numpy only; bit for bit the JAX
    package's build).

    Entities live in clusters of ``cluster_size`` whose centers sit on a
    ``lattice_dim``-dimensional integer lattice embedded by a random basis
    ``G``: ``e = z @ G + η`` (η uniform ±``noise``). Each relation is a
    small integer lattice offset ``δ_r``, so ``v_r = δ_r @ G`` and a
    structural triple satisfies ``||e_h + v_r − e_t||_1 = ||η_h − η_t||_1``.
    A fraction ``1 − structural_fraction`` of the triples is noise; cluster
    members are drawn with the Zipf-like skew ``u^member_skew``. The oracle
    ceiling is scale-dependent (``n_eval_negative`` stays fixed while the
    entities shrink): compare trained MRR against the returned
    ``oracle_estimate``.

    :param scale: shrink factor for entity/split sizes (CPU tests ≪ 1).
    :param member_skew: within-cluster member draws use
        ``floor(cluster_size · u^member_skew)``; ``1.0`` is uniform.
    :param eval_rows: cap valid/test splits to this many triples (the two
        (rows, 500) negative arrays at the published sizes cost ~4 GB of
        host RAM).
    :param return_planted: also return the :class:`PlantedTransE`.
    """
    rng = np.random.default_rng(seed)
    n_entity = max(int(WIKIKG2_N_ENTITY * scale), 4 * cluster_size)
    n_relation = WIKIKG2_N_RELATION if scale >= 1.0 else max(
        int(WIKIKG2_N_RELATION * scale), 8
    )
    sizes = {
        p: max(int(n * scale), 1000 if p == "train" else 200)
        for p, n in WIKIKG2_SPLIT_SIZES.items()
    }
    if eval_rows is not None:
        sizes["valid"] = min(sizes["valid"], eval_rows)
        sizes["test"] = min(sizes["test"], eval_rows)

    # Lattice of cluster centers: the cluster count is EXACTLY side^p so
    # every lattice point in the box is a real cluster; the per-cluster
    # size adapts.
    side = max(2, int(round((n_entity / cluster_size) ** (1.0 / lattice_dim))))
    n_cluster = side**lattice_dim
    cse = -(-n_entity // n_cluster)  # effective cluster size (ceil)
    # only FULL clusters take part in structural sampling (the last one may
    # be ragged)
    n_full_cluster = n_entity // cse
    G = rng.normal(0.0, 0.5, size=(lattice_dim, emb_size)).astype(np.float32)
    cluster_z = np.stack(
        np.unravel_index(np.arange(n_cluster), (side,) * lattice_dim), 1
    ).astype(np.int32)  # (K, p)

    ent_cluster = np.arange(n_entity) // cse
    eta = rng.uniform(-noise, noise, size=(n_entity, emb_size)).astype(np.float32)
    entity = (cluster_z[ent_cluster].astype(np.float32) @ G + eta).astype(np.float32)

    # relation offsets: small nonzero lattice steps within the box
    max_step = min(2, side - 1)
    delta = rng.integers(-max_step, max_step + 1, size=(n_relation, lattice_dim)).astype(np.int32)
    zero = (delta == 0).all(1)
    delta[zero, 0] = max_step
    relation = (delta.astype(np.float32) @ G).astype(np.float32)
    planted = PlantedTransE(entity=entity, relation=relation)

    # z -> cluster id lookup (the lattice enumeration is row-major)
    strides = np.array([side ** (lattice_dim - 1 - i) for i in range(lattice_dim)], np.int64)

    def draw_members(prng, n: int):
        """Within-cluster member indices with the Zipf-like degree skew."""
        return np.minimum((prng.random(n) ** member_skew * cse).astype(np.int64), cse - 1)

    def sample_part(n: int, part_seed: int):
        prng = np.random.default_rng(part_seed)
        r = prng.integers(n_relation, size=n).astype(np.int32)
        structural = prng.random(n) < structural_fraction
        # source cluster uniform over the sub-box where z + delta stays in
        lo = np.maximum(0, -delta[r])  # (n, p)
        hi = side - np.maximum(0, delta[r])
        z_h = (lo + prng.random((n, lattice_dim)) * (hi - lo)).astype(np.int64)
        # at most ONE cluster (the box's max corner) can be ragged; reroute
        # rows touching it to the minimal valid corner of their relation
        z_t = z_h + delta[r]
        bad = ((z_h * strides).sum(1) >= n_full_cluster) | (
            (z_t * strides).sum(1) >= n_full_cluster
        )
        z_h[bad] = lo[bad]
        z_t[bad] = lo[bad] + delta[r[bad]]
        c_h = (z_h * strides).sum(1)
        c_t = (z_t * strides).sum(1)
        m_h = draw_members(prng, n)
        m_t = draw_members(prng, n)
        h = (c_h * cse + m_h).astype(np.int32)
        t = (c_t * cse + m_t).astype(np.int32)
        # noise triples: uniform cluster × skewed member
        n_noise = int((~structural).sum())
        h[~structural] = (
            prng.integers(n_full_cluster, size=n_noise) * cse + draw_members(prng, n_noise)
        ).astype(np.int32)
        t[~structural] = (
            prng.integers(n_full_cluster, size=n_noise) * cse + draw_members(prng, n_noise)
        ).astype(np.int32)
        return np.stack([h, r, t], axis=1).astype(np.int32)

    triples = {
        p: sample_part(sizes[p], seed * 7919 + i)
        for i, p in enumerate(("train", "valid", "test"))
    }

    # official-style eval negatives: uniform, true entity excluded
    neg_heads, neg_tails = {}, {}
    for part in ("valid", "test"):
        tri = triples[part]
        prng = np.random.default_rng(seed * 104729 + len(part))
        for which, store in (("h", neg_heads), ("t", neg_tails)):
            true = tri[:, 0] if which == "h" else tri[:, 2]
            draw = prng.integers(n_entity - 1, size=(len(tri), n_eval_negative)).astype(np.int32)
            draw += (draw >= true[:, None]).astype(np.int32)
            store[part] = draw

    ds = KGDataset(
        n_entity=n_entity,
        n_relation_type=n_relation,
        entity_dict=None,
        relation_dict=None,
        type_offsets=None,
        triples=triples,
        original_triple_ids={p: np.arange(len(v), dtype=np.int64) for p, v in triples.items()},
        neg_heads=neg_heads,
        neg_tails=neg_tails,
    )
    if return_planted:
        m = min(oracle_sample, len(triples["valid"]))
        rr = []
        for corrupt, negs in (("h", neg_heads), ("t", neg_tails)):
            ranks = planted.rank_against(triples["valid"][:m], negs["valid"][:m], corrupt)
            rr.append(1.0 / ranks)
        planted.oracle_estimate = float(np.mean(rr))  # type: ignore
        return ds, planted
    return ds
