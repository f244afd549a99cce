"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test here skips. On a machine with one
(and nvcc), run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``;
``chip_smoke.py`` makes the same checks at the serving and training shapes.
The last tests hold the device-sampled training call, one CUDA graph, to its
eager steps and to the CPU.

Tolerances: distances as in ``test_torch_l1_kernels.py``. Gradients (B2/B6)
are fp32 sums of n = N (da) or B (db) terms ``±w`` in another order on each
side: recursive summation errs by at most ``(n − 1)·2^-24·Σ|w|`` on each, so
the two differ by at most ``2·n·2^-24·Σ|w|`` per output. The row kernels
(B3, B4, B8, B9) copy, or round after each multiply and add exactly as their
plain versions do: equal bits. B10 rounds each operation as its plain
version does, in the same order: mu and nu to equal bits, the param to one
fp32 ulp (two for the square root and the division on the card, whose
library versions may differ in the last bit) and, for a bf16 param, to one
bf16 ulp.
"""

import numpy as np
import pytest
import torch

from besskge_tpu_torch import bess, loss, optim, trainer
from besskge_tpu_torch.batch_sampler import RandomShardedBatchSampler, RigidShardedBatchSampler
from besskge_tpu_torch.bess import TopKQueryBessKGE, build_topk_forward
from besskge_tpu_torch.dataset import KGDataset
from besskge_tpu_torch.device_sampler import DeviceBatchSampler, split_key
from besskge_tpu_torch.negative_sampler import (
    PlaceholderNegativeSampler,
    RandomShardedNegativeSampler,
    TypeBasedShardedNegativeSampler,
)
from besskge_tpu_torch.ops import adamw_kernels, distance, l1_kernels, row_kernels
from besskge_tpu_torch.packed import pack_table
from besskge_tpu_torch.profiling import DISTANCE_EDGES, device_kernels
from besskge_tpu_torch.scoring import RotatE, TransE
from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4
BF16_ULP = 2.0**-7
FP16_ULP = 2.0**-10
U32 = 2.0**-24
#: The relative rounding of a 16-bit output (B1/B5 store a's dtype).
OUT_ULP = {torch.float32: 0.0, torch.bfloat16: BF16_ULP, torch.float16: FP16_ULP}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(3, 256, 100), (37, 1536, 96), (130, 1152, 128)])
def test_kernels_match_plain(cuda, shape, dtype):
    B, N, d = shape
    gen = torch.Generator(cuda).manual_seed(B + N)
    a = ((torch.rand(B, d, device=cuda, generator=gen) * 2 - 1) / d).to(dtype)
    b = ((torch.rand(N, d, device=cuda, generator=gen) * 2 - 1) / d).to(dtype)
    valid = torch.rand(N, device=cuda, generator=gen) > 0.3
    valid[128:256] = False
    l1_kernels.reset_launch_counts()
    s, cmax = l1_kernels.l1_scores_chunkmax(a, b, valid)
    dist = l1_kernels.l1_distance_matrix(a, b)
    torch.cuda.synchronize()
    assert l1_kernels.l1_scores_chunkmax.launches == 1
    assert l1_kernels.l1_distance_matrix.launches == 1
    s_ref, cmax_ref = l1_kernels.l1_scores_chunkmax_plain(a, b, valid)
    torch.testing.assert_close(s, s_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cmax, cmax_ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(cmax, s.reshape(B, -1, 128).amax(-1))
    ref = l1_kernels.l1_distance_matrix_plain(a, b).float()
    tol = ATOL + (RTOL + OUT_ULP[dtype]) * ref.abs()
    assert dist.dtype == dtype
    assert ((dist.float() - ref).abs() <= tol).all()


@pytest.mark.parametrize("merge", ["chunk", "sort"])
def test_topk_on_the_card_matches_the_cpu(cuda, merge):
    sharding = Sharding.create(4000, 1, seed=1)
    fn = TransE(True, 1, sharding, 11, 128, seed=2)
    ns = PlaceholderNegativeSampler("t")
    topk = TopKQueryBessKGE(k=10, candidate_sampler=ns, score_fn=fn, return_scores=True,
                            window_size=1664, merge_mode=merge)
    rng = np.random.default_rng(0)
    batch = {
        "head": rng.integers(4000, size=(1, 1, 64)).astype(np.int32),
        "relation": rng.integers(11, size=(1, 1, 64)).astype(np.int32),
    }
    params = fn.initial_params(device="cpu")
    want = build_topk_forward(topk, device="cpu")(params, batch)
    l1_kernels.reset_launch_counts()
    got = build_topk_forward(topk)({k: v.to(cuda) for k, v in params.items()}, batch)
    kernel = l1_kernels.l1_scores_chunkmax if merge == "chunk" else l1_kernels.l1_distance_matrix
    assert kernel.launches == 3  # one per window
    torch.testing.assert_close(got["topk_scores"].cpu(), want["topk_scores"], rtol=RTOL, atol=ATOL)


def _sum_tol(w, dim):
    """2·n·2^-24·Σ|w| over the summed dimension, kept for broadcasting."""
    n = w.shape[dim]
    return 2 * n * U32 * w.abs().sum(dim).unsqueeze(-1) + 1e-30


def _grad_inputs(cuda, G, B, N, d, dtype, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    a = ((torch.rand(G, B, d, device=cuda, generator=gen) * 2 - 1) / d).to(dtype)
    b = ((torch.rand(G, N, d, device=cuda, generator=gen) * 2 - 1) / d).to(dtype)
    # Planted exact ties: a few rows of b copy coordinates of rows of a.
    b[:, : min(N, B) // 2, : d // 2] = a[:, : min(N, B) // 2, : d // 2]
    w = torch.randn(G, B, N, device=cuda, generator=gen)
    return a, b, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(8, 256, 288, 128), (3, 37, 211, 100), (2, 5, 9, 130)])
def test_batched_kernels_match_plain(cuda, shape, dtype):
    G, B, N, d = shape
    a, b, w = _grad_inputs(cuda, G, B, N, d, dtype, seed=G + B + N)
    l1_kernels.reset_launch_counts()
    dist = l1_kernels.l1_distance_matrix_batched(a, b)
    da, db = l1_kernels.l1_distance_grads_batched(a, b, w)
    da6, db6 = l1_kernels.l1_distance_grads(a[0], b[0], w[0])
    torch.cuda.synchronize()
    assert l1_kernels.l1_distance_matrix_batched.launches == 1
    assert l1_kernels.l1_distance_grads_batched.launches == 1
    assert l1_kernels.l1_distance_grads.launches == 1
    ref = l1_kernels.l1_distance_matrix_batched_plain(a, b).float()
    tol = ATOL + (RTOL + OUT_ULP[dtype]) * ref.abs()
    assert dist.dtype == dtype and ((dist.float() - ref).abs() <= tol).all()
    rda, rdb = l1_kernels.l1_distance_grads_batched_plain(a, b, w)
    assert da.dtype == db.dtype == torch.float32
    assert ((da - rda).abs() <= _sum_tol(w, 2)).all()
    assert ((db - rdb).abs() <= _sum_tol(w.transpose(1, 2), 2)).all()
    assert ((da6 - rda[0]).abs() <= _sum_tol(w[0], 1)).all()
    assert ((db6 - rdb[0]).abs() <= _sum_tol(w[0].T, 1)).all()


# One below, at and one above the gradient kernel's tiles (32 own rows, or 8
# where the grid is small; 32 stream rows; 32 depth columns), d = 1, one
# group, fewer stream rows than a tile; the last three give grids large
# enough for 32-row own tiles on a 132-SM card, with ragged edges and with
# 16-byte rows.
EDGE_SHAPES = [
    (2, 31, 40, 32), (2, 32, 40, 32), (2, 33, 40, 32),
    (2, 20, 31, 33), (2, 20, 32, 31), (2, 20, 33, 32),
    (1, 7, 9, 8), (1, 8, 8, 16), (1, 9, 7, 24),
    (3, 5, 6, 1),
    (64, 33, 31, 33), (64, 31, 36, 40), (64, 32, 64, 64),
]


def _kernels_per_call(fn, calls=10):
    """The CUDA kernels that one call of ``fn`` launches: name -> launches
    per call, over ``calls`` calls."""
    return {name: n for name, (_, n) in device_kernels(fn, calls).items()}


def _one_kernel(kernels, name):
    return len(kernels) == 1 and name in next(iter(kernels)) and list(kernels.values()) == [1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_grads_match_plain_at_tile_edges(cuda, shape, dtype):
    G, B, N, d = shape
    a, b, w = _grad_inputs(cuda, G, B, N, d, dtype, seed=3 * (G + B + N + d))
    da, db = l1_kernels.l1_distance_grads_batched(a, b, w)
    da6, db6 = l1_kernels.l1_distance_grads(a[0], b[0], w[0])
    torch.cuda.synchronize()
    rda, rdb = l1_kernels.l1_distance_grads_batched_plain(a, b, w)
    assert ((da - rda).abs() <= _sum_tol(w, 2)).all()
    assert ((db - rdb).abs() <= _sum_tol(w.transpose(1, 2), 2)).all()
    assert ((da6 - rda[0]).abs() <= _sum_tol(w[0], 1)).all()
    assert ((db6 - rdb[0]).abs() <= _sum_tol(w[0].T, 1)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(8, 256, 288, 128), (3, 37, 211, 100)])
def test_grads_are_one_deterministic_launch(cuda, shape, dtype):
    """B2 and B6 launch one kernel per call for both outputs, and sum in a
    fixed order: a repeat call gives the same bits."""
    G, B, N, d = shape
    a, b, w = _grad_inputs(cuda, G, B, N, d, dtype, seed=G * B)
    assert _one_kernel(_kernels_per_call(lambda: l1_kernels.l1_distance_grads_batched(a, b, w)),
                       "l1_grads_kernel")
    assert _one_kernel(_kernels_per_call(lambda: l1_kernels.l1_distance_grads(a[0], b[0], w[0])),
                       "l1_grads_kernel")
    first = (*l1_kernels.l1_distance_grads_batched(a, b, w),
             *l1_kernels.l1_distance_grads(a[0], b[0], w[0]))
    second = (*l1_kernels.l1_distance_grads_batched(a, b, w),
              *l1_kernels.l1_distance_grads(a[0], b[0], w[0]))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def _offset_tensor(flat, shape, offset):
    """``flat`` viewed as ``shape`` from a storage whose first ``offset``
    elements are skipped: contiguous, with a base off alignment."""
    n = int(np.prod(shape))
    out = torch.empty(n + offset, dtype=flat.dtype, device=flat.device)[offset:]
    out.copy_(flat.reshape(-1)[:n])
    return out.view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", DISTANCE_EDGES)
def test_distance_at_tile_edges(cuda, shape, dtype):
    """B1 (and B5 for one group) at the edges of the distance kernel's tiles:
    within tolerance of the plain version, one ``l1_distance_small_kernel``
    per call, the same bits on a repeat call."""
    G, B, N, d, offset = shape
    a0, b0, _ = _grad_inputs(cuda, G, B, N, d, dtype, seed=7 * (G + B + d))
    a, b = _offset_tensor(a0, a0.shape, offset), _offset_tensor(b0, b0.shape, offset)
    assert a.is_contiguous() and (a.data_ptr() % 16 != 0) == (offset != 0)
    ref = l1_kernels.l1_distance_matrix_batched_plain(a, b).float()
    tol = ATOL + (RTOL + OUT_ULP[dtype]) * ref.abs()
    calls = [(l1_kernels.l1_distance_matrix_batched, lambda: l1_kernels.l1_distance_matrix_batched(a, b))]
    if G == 1:
        calls.append((l1_kernels.l1_distance_matrix, lambda: l1_kernels.l1_distance_matrix(a[0], b[0])[None]))
    for wrapper, fn in calls:
        l1_kernels.reset_launch_counts()
        first, again = fn(), fn()
        torch.cuda.synchronize()
        assert wrapper.launches == 2
        assert first.dtype == dtype and torch.equal(first, again)
        assert ((first.float() - ref).abs() <= tol).all()
        assert _one_kernel(_kernels_per_call(fn, 3), "l1_distance_small_kernel")


def _runs(cuda, R, n, seed):
    """Sorted indices in [0, n) with duplicate runs."""
    gen = torch.Generator(cuda).manual_seed(seed)
    idx = torch.randint(0, n, (R,), device=cuda, generator=gen)
    idx[1::3] = idx[0::3][: idx[1::3].shape[0]]  # runs of two and three
    return torch.sort(idx).values.to(torch.int32), gen


@pytest.mark.parametrize("h", [1, 2, 3, 5])
@pytest.mark.parametrize("skip_dups", [False, True])
@pytest.mark.parametrize("block", [False, True])
def test_scatter_rows_matches_plain(cuda, h, skip_dups, block):
    n, D, R = 1000, 128, 301
    idx, gen = _runs(cuda, R, n - h, seed=h)
    idx = idx - idx % h  # h-major slices
    table = torch.randn(n, D, device=cuda, generator=gen)
    rows = torch.randn(h * R, D, device=cuda, generator=gen)
    first = torch.ones(R, dtype=torch.bool, device=cuda)
    first[1:] = idx[1:] != idx[:-1]
    if skip_dups:
        rows.view(R, h, D)[~first] = float("nan")  # garbage in duplicate slots
    else:  # duplicates carry identical rows
        run_start = torch.cummax(torch.where(first, torch.arange(R, device=cuda), 0), 0).values
        rows = rows.view(R, h, D)[run_start].reshape(h * R, D)
    want = table.clone()
    row_kernels.scatter_rows_plain(want, idx, rows, h, skip_dups)
    got = table.clone()
    row_kernels.reset_launch_counts()
    out = row_kernels.scatter_rows(got[None] if block else got, idx, rows, h, skip_dups)
    torch.cuda.synchronize()
    assert row_kernels.scatter_rows.launches == 1
    assert out.data_ptr() == got.data_ptr()
    assert torch.equal(got, want)


@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_fused_pair_sgdm_matches_plain(cuda, lr_tensor, weight_decay):
    n, D, R = 500, 128, 257
    idx, gen = _runs(cuda, R, n, seed=5)
    phys = 2 * idx
    table = torch.randn(2 * n, D, device=cuda, generator=gen)
    grads = torch.randn(R, D, device=cuda, generator=gen)
    first = torch.ones(R, dtype=torch.bool, device=cuda)
    first[1:] = phys[1:] != phys[:-1]
    grads[~first] = float("nan")  # only the first slot of a run is read
    lr = torch.tensor(0.05, device=cuda) if lr_tensor else 0.05
    want = table.clone()
    row_kernels.fused_pair_sgdm_plain(want, phys, grads, lr, 0.9, weight_decay)
    got = table.clone()
    row_kernels.reset_launch_counts()
    row_kernels.fused_pair_sgdm(got, phys, grads, lr, 0.9, weight_decay)
    torch.cuda.synchronize()
    assert row_kernels.fused_pair_sgdm.launches == 1
    assert torch.equal(got, want)


def test_p1_distance_has_a_gradient_on_the_card(cuda):
    """The autograd repair: p_distance_matrix(·, ·, 1) on the card carries
    the sign-subgradient VJP, through B5 forward and B6 backward."""
    gen = torch.Generator(cuda).manual_seed(3)
    a = torch.randn(37, 128, device=cuda, generator=gen)
    b = torch.randn(211, 128, device=cuda, generator=gen)
    b[:5, :40] = a[:5, :40]  # exact ties: sign(0) = 0
    w = torch.randn(37, 211, device=cuda, generator=gen)
    a.requires_grad_()
    b.requires_grad_()
    l1_kernels.reset_launch_counts()
    out = distance.p_distance_matrix(a, b, 1)
    assert isinstance(out.grad_fn, distance._L1._backward_cls)
    da, db = torch.autograd.grad(out, (a, b), w)
    torch.cuda.synchronize()
    assert l1_kernels.l1_distance_matrix.launches == 1
    assert l1_kernels.l1_distance_grads.launches == 1
    s = torch.sign(a.detach()[:, None] - b.detach()[None])
    assert ((da - (w[..., None] * s).sum(1)).abs() <= _sum_tol(w, 1)).all()
    assert ((db + (w[..., None] * s).sum(0)).abs() <= _sum_tol(w.T, 1)).all()


def _small_training(device, variant):
    n_entity, n_rel = 3000, 13
    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(n_entity, size=4000), rng.integers(n_rel, size=4000),
                        rng.integers(n_entity, size=4000)], 1).astype(np.int32)
    ds = KGDataset(n_entity=n_entity, n_relation_type=n_rel, triples={"train": triples},
                   original_triple_ids={"train": np.arange(4000)})
    sharding = Sharding.create(n_entity, 1, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = TransE(True, 1, sharding, n_rel, 128, seed=0)
    score_fn.compute_dtype = torch.bfloat16
    ns = RandomShardedNegativeSampler(32, sharding, 0, "ht", False, flat_negative_format=True)
    module = bess.EmbeddingMovingBessKGE(ns, score_fn, loss.SampledSoftmaxCrossEntropyLoss(n_entity),
                                         augment_negative=True)
    sampler = RandomShardedBatchSampler(pts, ns, shard_bs=128, batches_per_step=4, seed=0)
    row = optim.RowSGDM(0.05, momentum=0.9, interleaved=True, fused_variant=variant)
    sgd = optim.SGD(0.05, momentum=0.9)
    params = score_fn.initial_params(device="cpu")
    params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
    params = {k: v.to(device) for k, v in params.items()}
    state = trainer.init_optimizer_state(sgd, params, None, row, n_logical=n_entity)
    step = trainer.build_train_step(module, sgd, None, row, device=device)
    batch = sampler.sample_batch(next(iter(sampler.epoch_index_blocks())))
    return step(params, state, batch)


@pytest.mark.parametrize("variant", ["xla", "fused"])
def test_training_step_on_the_card_matches_the_cpu(cuda, variant):
    l1_kernels.reset_launch_counts()
    row_kernels.reset_launch_counts()
    got_p, got_s, got_o = _small_training(cuda, variant)
    torch.cuda.synchronize()
    assert l1_kernels.l1_distance_matrix_batched.launches == 2
    assert l1_kernels.l1_distance_grads_batched.launches == 2
    assert row_kernels.scatter_rows.launches == (1 if variant == "xla" else 0)
    assert row_kernels.fused_pair_sgdm.launches == (1 if variant == "fused" else 0)
    want_p, want_s, want_o = _small_training("cpu", variant)
    # bf16 scores: the fp32 sums of the two sides may round to neighbouring
    # bf16 values, which moves the loss by a bf16 ulp of a score at most per
    # score, and the gradients (cast to bf16 by the distance VJP) by one
    # bf16 ulp each.
    torch.testing.assert_close(got_o["loss"].cpu(), want_o["loss"], rtol=2.0**-8, atol=0.0)
    for key in want_p:
        m = want_p[key].abs().max()
        torch.testing.assert_close(got_p[key].cpu(), want_p[key], rtol=2.0**-7, atol=2.0**-7 * m)


def _first(idx):
    first = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    first[1:] = idx[1:] != idx[:-1]
    return first


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("skip_dups", [False, True])
def test_scatter_rows_multi_matches_plain(cuda, k, skip_dups):
    """B8: k tables of different heights, ragged index lists with their own
    duplicate runs, a (1, n, D) block among them."""
    D = 128
    tables, idxs, rows = [], [], []
    for b in range(k):
        n, R = 700 + 97 * b, 301 - 60 * b
        idx, gen = _runs(cuda, R, n, seed=10 + b)
        table = torch.randn(n, D, device=cuda, generator=gen)
        r = torch.randn(R, D, device=cuda, generator=gen)
        first = _first(idx)
        if skip_dups:
            r[~first] = float("nan")  # garbage in duplicate slots
        else:
            run_start = torch.cummax(torch.where(first, torch.arange(R, device=cuda), 0), 0).values
            r = r[run_start]
        tables.append(table[None] if b == 1 else table)
        idxs.append(idx)
        rows.append(r)
    want = [t.clone() for t in tables]
    row_kernels.scatter_rows_multi_plain(want, idxs, rows, skip_dups)
    row_kernels.reset_launch_counts()
    out = row_kernels.scatter_rows_multi(tables, idxs, rows, skip_dups)
    torch.cuda.synchronize()
    assert row_kernels.scatter_rows_multi.launches == 1
    assert all(o is t for o, t in zip(out, tables))
    for got, exp in zip(tables, want):
        assert torch.equal(got, exp)


def test_scatter_rows_multi_takes_int32_words(cuda):
    """B8 copies 4-byte words: an int32 (packed-storage) table beside an fp32
    one, rows 4 bytes wide that leave the 16-byte path."""
    gen = torch.Generator(cuda).manual_seed(4)
    packed = torch.randint(-2**31, 2**31 - 1, (50, 3), device=cuda, generator=gen,
                           dtype=torch.int64).to(torch.int32)
    moment = torch.randn(100, 3, device=cuda, generator=gen)
    idxs = [torch.tensor([4, 9, 49], device=cuda), torch.tensor([0, 99], device=cuda)]
    rows = [torch.randint(0, 2**30, (3, 3), device=cuda, generator=gen, dtype=torch.int64)
            .to(torch.int32), torch.randn(2, 3, device=cuda, generator=gen)]
    want = [packed.clone(), moment.clone()]
    row_kernels.scatter_rows_multi_plain(want, idxs, rows)
    row_kernels.scatter_rows_multi([packed, moment], idxs, rows)
    torch.cuda.synchronize()
    assert torch.equal(packed, want[0]) and torch.equal(moment, want[1])


@pytest.mark.parametrize("store", [torch.int32, torch.uint32])
def test_row_kernels_write_packed_storage(cuda, store):
    """B3 at h = 1, 3 and 5 over packed words (uint32: packed fp16, whose
    plain version indexes the int32 view) and B8 with a packed table beside
    two fp32 moments, each against its plain version on the same inputs;
    int32 rows into a uint32 table keep their bits."""
    gen = torch.Generator(cuda).manual_seed(5)
    P, D, R = 300, 128, 97

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, device=cuda, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    for h in (1, 3, 5):
        table = words(h * P, D).view(store)
        idx, _ = _runs(cuda, R, P - 1, seed=30 + h)
        phys = h * idx
        # int32 words (bits, not values), the same for every slot of a run
        run = torch.cummax(torch.where(_first(idx), torch.arange(R, device=cuda), 0), 0).values
        rows = words(R, h, D)[run].reshape(h * R, D)
        for skip in (False, True):
            got, want = table.clone(), table.clone()
            row_kernels.scatter_rows_plain(want, phys, rows, h, skip)
            row_kernels.scatter_rows(got, phys, rows, h, skip)
            torch.cuda.synchronize()
            assert got.dtype == store
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (h, skip)
    packed = words(P, D).view(store)
    mu, nu = (torch.randn(2 * P, D, device=cuda, generator=gen) for _ in range(2))
    pidx, _ = _runs(cuda, R, P, seed=40)
    lidx, _ = _runs(cuda, R, 2 * P, seed=41)  # later slots of a run hold anything
    rows = [words(R, D).view(store), torch.randn(R, D, device=cuda, generator=gen),
            torch.randn(R, D, device=cuda, generator=gen)]
    want = [packed.clone(), mu.clone(), nu.clone()]
    row_kernels.scatter_rows_multi_plain(want, [pidx, lidx, lidx], rows, True)
    row_kernels.reset_launch_counts()
    row_kernels.scatter_rows_multi([packed, mu, nu], [pidx, lidx, lidx], rows, True)
    torch.cuda.synchronize()
    assert row_kernels.scatter_rows_multi.launches == 1
    assert torch.equal(packed.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(mu, want[1]) and torch.equal(nu, want[2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_16bit_table_writes_take_b3_per_table(cuda, dtype):
    """A plain 16-bit table beside its fp32 moment: B8 copies 4-byte words
    only, so the separate-buffer RowSGDM writes each table with one B3
    launch; the step on the card equals the same step of the plain versions
    on the CPU bit for bit (one row update, stochastically rounded)."""
    gen = torch.Generator("cpu").manual_seed(6)
    N, D, R = 500, 128, 300
    table = torch.randn(N, D, generator=gen).to(dtype)
    idx = torch.randint(0, N, (R,), generator=gen)
    g = (torch.randint(-8, 9, (R, D), generator=gen) / 4).float()
    opt = optim.RowSGDM(1e-3, 0.9)
    cpu_t, cpu_s = table.clone(), opt.init(table)
    card_t, card_s = table.to(cuda), opt.init(table.to(cuda))
    for _ in range(2):
        cpu_t, cpu_s = opt.update_rows(cpu_t, cpu_s, idx, g)
        row_kernels.reset_launch_counts()
        card_t, card_s = opt.update_rows(card_t, card_s, idx.to(cuda), g.to(cuda))
        torch.cuda.synchronize()
        assert row_kernels.scatter_rows.launches == 2
        assert row_kernels.scatter_rows_multi.launches == 0
    assert torch.equal(card_t.cpu().view(torch.int16), cpu_t.view(torch.int16))
    assert torch.equal(card_s["m"].cpu(), cpu_s["m"])


@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("skip_dups", [False, True])
@pytest.mark.parametrize("block", [False, True])
def test_gather_rows_matches_plain(cuda, h, skip_dups, block):
    """B9: every slot, or the first slot of each run under skip_dups."""
    n, D, R = 1000, 128, 333
    idx, gen = _runs(cuda, R, n - h, seed=20 + h)
    idx = idx - idx % h
    table = torch.randn(n, D, device=cuda, generator=gen)
    row_kernels.reset_launch_counts()
    got = row_kernels.gather_rows(table[None] if block else table, idx, h, skip_dups)
    torch.cuda.synchronize()
    assert row_kernels.gather_rows.launches == 1
    want = row_kernels.gather_rows_plain(table, idx, h, skip_dups)
    keep = (_first(idx) if skip_dups else torch.ones_like(idx, dtype=torch.bool))
    keep = keep.repeat_interleave(h)
    assert got.shape == (h * R, D)
    assert torch.equal(got[keep], want[keep])


def _adamw_inputs(cuda, shape, param_dtype, grad_dtype, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    p = torch.randn(shape, device=cuda, generator=gen).to(param_dtype)
    mu = torch.randn(shape, device=cuda, generator=gen) * 0.1
    nu = (torch.randn(shape, device=cuda, generator=gen) * 0.1) ** 2
    g = torch.randn(shape, device=cuda, generator=gen).to(grad_dtype)
    return p, mu, nu, g


@pytest.mark.parametrize("shape", [(512, 128), (701, 128), (93, 7)])
@pytest.mark.parametrize("param_dtype,grad_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("lr_tensor", [False, True])
def test_dense_adamw_matches_plain(cuda, shape, param_dtype, grad_dtype, lr_tensor):
    """B10 against its plain version: a 16-byte-aligned table, a ragged
    one whose tail is not a multiple of four, several dtypes, and the lr
    read from device memory."""
    p, mu, nu, g = _adamw_inputs(cuda, shape, param_dtype, grad_dtype, seed=shape[0])
    count = torch.tensor(3, dtype=torch.int32, device=cuda)
    lr = torch.tensor(1e-2, device=cuda) if lr_tensor else 1e-2
    want = [t.clone() for t in (p, mu, nu)]
    adamw_kernels.dense_adamw_update_plain(*want, g, count, lr, 0.9, 0.999, 1e-8, 0.01)
    adamw_kernels.reset_launch_counts()
    adamw_kernels.dense_adamw_update(p, mu, nu, g, count, lr, 0.9, 0.999, 1e-8, 0.01)
    torch.cuda.synchronize()
    assert adamw_kernels.dense_adamw_update.launches == 1
    assert torch.equal(mu, want[1]) and torch.equal(nu, want[2])
    ulp = 2.0**-7 if param_dtype == torch.bfloat16 else 2.0**-22
    assert ((p.float() - want[0].float()).abs() <= ulp * want[0].float().abs() + 1e-30).all()


def test_dense_adamw_unaligned_views(cuda):
    """Views that start off a 16-byte boundary take the one-element path."""
    p, mu, nu, g = _adamw_inputs(cuda, (4 * 128 + 1,), torch.float32, torch.float32, seed=7)
    views = [t[1:] for t in (p, mu, nu, g)]
    count = torch.tensor(1, dtype=torch.int32, device=cuda)
    want = [t.clone() for t in views[:3]]
    adamw_kernels.dense_adamw_update_plain(*want, views[3], count, 5e-3)
    adamw_kernels.dense_adamw_update(*views, count, 5e-3)
    torch.cuda.synchronize()
    for got, exp in zip(views[:3], want):
        assert ((got - exp).abs() <= 2.0**-22 * exp.abs() + 1e-30).all()


@pytest.mark.parametrize("lr_tensor", [False, True])
def test_dense_adamw_is_one_kernel(cuda, lr_tensor):
    """B10 computes its bias corrections itself: one kernel per update, with
    a float learning rate and with one read from device memory."""
    p, mu, nu, g = _adamw_inputs(cuda, (701, 128), torch.float32, torch.float32, seed=9)
    count = torch.tensor(5, dtype=torch.int32, device=cuda)
    lr = torch.tensor(1e-2, device=cuda) if lr_tensor else 1e-2
    kernels = _kernels_per_call(lambda: adamw_kernels.dense_adamw_update(p, mu, nu, g, count, lr))
    assert _one_kernel(kernels, "dense_adamw_kernel"), kernels


@pytest.mark.parametrize("count_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("t", [1, 2, 3, 10, 1000, 100000])
def test_dense_adamw_corrections_match_plain(cuda, t, count_dtype):
    """The kernel's own bias corrections at early and late steps: moments
    equal to the plain version's, the param within the bound above."""
    p, mu, nu, g = _adamw_inputs(cuda, (93, 128), torch.float32, torch.float32, seed=t)
    count = torch.tensor(t, dtype=count_dtype, device=cuda)
    want = [x.clone() for x in (p, mu, nu)]
    adamw_kernels.dense_adamw_update_plain(*want, g, count, 1e-2, 0.9, 0.999, 1e-8, 0.01)
    adamw_kernels.dense_adamw_update(p, mu, nu, g, count, 1e-2, 0.9, 0.999, 1e-8, 0.01)
    torch.cuda.synchronize()
    assert torch.equal(mu, want[1]) and torch.equal(nu, want[2])
    assert ((p - want[0]).abs() <= 2.0**-22 * want[0].abs() + 1e-30).all()


# --------------------------------------------------------------------------
# Device-sampled training: one call of steps_per_call steps is one CUDA graph.
# A replay is held against the eager card steps from the same state with the
# same key: the sparse form's entity table and every step count to equal
# bits (their sums have no atomics), the relation table, its momentum and
# the dense forms' arrays within 1e-5 x (|want| + max|want|), plus, for an
# AdamW param, lr x the difference of m^/(v^1/2 + eps) of the two sides.


def _device_setup(device, form, spc, typed=False, hrt=False, donate=True, mesh=None):
    n_entity, n_rel = 3000, 13
    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(n_entity, size=6000), rng.integers(n_rel, size=6000),
                        rng.integers(n_entity, size=6000)], 1).astype(np.int32)
    ds = KGDataset(n_entity=n_entity, n_relation_type=n_rel, triples={"train": triples},
                   original_triple_ids={"train": np.arange(6000)},
                   type_offsets={"a": 0, "b": 1000} if typed else None)
    sharding = Sharding.create(n_entity, 1, seed=0,
                               type_offsets=np.asarray([0, 1000]) if typed else None)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    if form == "sparse":
        score_fn = TransE(True, 1, sharding, n_rel, 128, seed=0)
        score_fn.compute_dtype = torch.bfloat16
        ns = RandomShardedNegativeSampler(32, sharding, 0, "ht", False, flat_negative_format=True)
        module = bess.EmbeddingMovingBessKGE(
            ns, score_fn, loss.SampledSoftmaxCrossEntropyLoss(n_entity), augment_negative=True,
            axis_name=None if mesh is None else "shard")
        opt, ent = optim.SGD(0.05, momentum=0.9), optim.RowSGDM(0.05, momentum=0.9,
                                                                 interleaved=True)
    else:
        score_fn = RotatE(True, 2, sharding, n_rel, 32, seed=0)
        ns = (TypeBasedShardedNegativeSampler(pts.types, 2, sharding, "ht", False, 0) if typed
              else RandomShardedNegativeSampler(1, sharding, 0, "ht", False,
                                                flat_negative_format=True))
        module = bess.EmbeddingMovingBessKGE(ns, score_fn, loss.LogSigmoidLoss(12.0, True))
        opt = optim.AdamW(1e-3)
        ent = optim.FusedDenseAdamW(1e-3, weight_decay=1e-4) if form == "fused" else None
    dev = DeviceBatchSampler(pts, ns, shard_bs=128, batches_per_step=4, seed=0,
                             hrt_freq_weighting=hrt, positive_mode="runs")
    params = score_fn.initial_params(device="cpu")
    if form == "sparse":
        params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
    params = {k: v.to(device) for k, v in params.items()}
    state = trainer.init_optimizer_state(opt, params, mesh, ent, n_logical=n_entity)
    fn = trainer.build_device_train_step(module, opt, dev, mesh, ent, donate, spc,
                                         device if mesh is None else None)
    return fn, params, state, dev


def _ratio(tree, name, count):
    """m^/(v^1/2 + eps) of the AdamW moments of param ``name``."""
    flat = dict(trainer._leaves(tree))
    key = name.split(".", 1)[1]
    mu = next(flat[n] for n in (f"state.mu.{key}", f"state.other.mu.{key}", "state.entity.mu")
              if n in flat)
    nu = flat[next(n for n in (f"state.nu.{key}", f"state.other.nu.{key}", "state.entity.nu")
                   if n in flat)]
    return (mu / (1 - 0.9**count)) / (torch.sqrt(nu / (1 - 0.999**count)) + 1e-8)


def _assert_graph_like_eager(form, graph, eager, count):
    g_tree, e_tree = dict(params=graph[0], state=graph[1]), dict(params=eager[0], state=eager[1])
    for (name, g), (_, e) in zip(trainer._leaves(g_tree), trainer._leaves(e_tree)):
        if name.endswith("count") or (form == "sparse" and "entity" in name):
            assert torch.equal(g, e), name
            continue
        extra = 0.0
        if form != "sparse" and name.startswith("params."):
            extra = 1e-3 * (_ratio(g_tree, name, count) - _ratio(e_tree, name, count)).abs()
        assert ((g - e).abs() <= 1e-5 * (e.abs() + e.abs().max()) + extra).all(), name


# A step's kernel launches: by wrapper (counted where it launches) and by
# kernel name (seen by the profiler).
WANT_LAUNCHES = {
    "sparse": {"l1_distance_matrix_batched": 2, "l1_distance_grads_batched": 2, "scatter_rows": 1},
    "dense": {},
    "fused": {"dense_adamw_update": 1},
}
WANT_KERNELS = {
    "sparse": {"l1_distance_small_kernel": 2, "l1_grads_kernel": 2, "scatter_rows_kernel": 1},
    "dense": {},
    "fused": {"dense_adamw_kernel": 1},
}
WRAPPERS = (*l1_kernels._WRAPPERS, row_kernels.scatter_rows, row_kernels.fused_pair_sgdm,
            row_kernels.scatter_rows_multi, row_kernels.gather_rows,
            adamw_kernels.dense_adamw_update)


def _wrapper_launches():
    return {w.__name__: w.launches for w in WRAPPERS}


@pytest.mark.parametrize("form", ["sparse", "dense", "fused"])
def test_device_call_replays_equal_eager_steps(cuda, form):
    """The first call runs eagerly, then captures: its wrappers launch each
    kernel spc times a step's count and the capture records as many. Each
    replay equals the eager card steps with the same key from the same
    state, makes no host sync and calls no wrapper; the profiler sees its
    kernels by name, spc times a step's."""
    spc = 3
    fn, params, state, dev = _device_setup(cuda, form, spc)
    sampler_state = dev.state(cuda)
    eager = (trainer._clone(params), trainer._clone(state))
    for call in range(3):
        key = dev.next_key(call)
        if call:
            trainer._write_back(eager[0], params)
            trainer._write_back(eager[1], state)
        for module in (l1_kernels, row_kernels, adamw_kernels):
            module.reset_launch_counts()
        if call:
            torch.cuda.set_sync_debug_mode("error")
        try:
            new_params, new_state, out = fn(params, state, sampler_state, key)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert new_params is params and new_state is state
        per_call = 2 if call == 0 else 0  # the warm-up's launches and the capture's records
        assert _wrapper_launches() == {
            name: per_call * WANT_LAUNCHES[form].get(name, 0) * spc for name in _wrapper_launches()}
        fn._eager(*eager, sampler_state, key.to(cuda))
        torch.cuda.synchronize()
        _assert_graph_like_eager(form, (params, state), eager, (call + 1) * spc)
        assert torch.isfinite(out["loss"]).all()
    assert fn._graph.stats["capture_s"] > 0
    kernels = device_kernels(lambda: fn(params, state, sampler_state, dev.next_key(9)), 1)
    for kernel, n in WANT_KERNELS[form].items():
        assert sum(c for name, (_, c) in kernels.items() if kernel in name) == n * spc, kernel


@pytest.mark.parametrize("typed,hrt", [(False, False), (True, True)])
def test_device_batches_on_the_card_equal_the_cpu(cuda, typed, hrt):
    _, _, _, dev = _device_setup("cpu", "dense", 1, typed=typed, hrt=hrt)
    card, cpu = dev.state(cuda), dev.state("cpu")
    for step in range(3):
        key = dev.next_key(step)
        keys = split_key(key, 4)
        assert torch.equal(split_key(key.to(cuda), 4).cpu(), keys)
        for k in (key, *keys):
            got, want = dev.sample(card, k.to(cuda)), dev.sample(cpu, k)
            assert got.keys() == want.keys()
            for name in want:
                if name == "triple_weight":  # a float sum in each device's order
                    n = want[name].shape[-1]
                    torch.testing.assert_close(got[name].cpu(), want[name],
                                               rtol=2 * n * 2.0**-24, atol=0.0)
                else:
                    assert torch.equal(got[name].cpu(), want[name]), name


def test_device_call_on_the_card_matches_the_cpu(cuda):
    """One steps_per_call=1 call on the card against the same call on the
    CPU (bf16 scores: one bf16 ulp of each value, as for the host step)."""
    fn, params, state, dev = _device_setup(cuda, "sparse", 1)
    cpu_fn, cpu_params, cpu_state, _ = _device_setup("cpu", "sparse", 1)
    key = dev.next_key(3)
    _, _, out = fn(params, state, dev.state(cuda), key)
    _, _, cpu_out = cpu_fn(cpu_params, cpu_state, dev.state("cpu"), key)
    torch.testing.assert_close(out["loss"].cpu(), cpu_out["loss"], rtol=2.0**-8, atol=0.0)
    for name in cpu_params:
        m = cpu_params[name].abs().max()
        torch.testing.assert_close(params[name].cpu(), cpu_params[name], rtol=2.0**-7,
                                   atol=2.0**-7 * m)


def test_device_call_without_donation_leaves_the_inputs(cuda):
    """``donate=False`` on the card: the graph keeps its own state, filled
    from the caller's at every call; the caller's tensors stay as they were,
    and each call's result is one call from them."""
    fn, params, state, dev = _device_setup(cuda, "fused", 2, donate=False)
    before = trainer._clone(dict(p=params, s=state))
    sampler_state = dev.state(cuda)
    for call in range(3):  # the capture, then replays
        got = fn(params, state, sampler_state, dev.next_key(call))
        torch.cuda.synchronize()
        for (name, now), (_, was) in zip(trainer._leaves(dict(p=params, s=state)),
                                         trainer._leaves(before)):
            assert torch.equal(now, was), name
        ref_fn, ref_params, ref_state, _ = _device_setup(cuda, "fused", 2)
        ref_fn(ref_params, ref_state, sampler_state, dev.next_key(call))
        _assert_graph_like_eager("fused", got[:2], (ref_params, ref_state), 2)


# RowAdagrad and checkpoints on the card: the twins, at a small size, of
# chip_smoke.py's training-phase Adagrad gates and its checkpoint phase.


@pytest.mark.parametrize("storage", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("interleaved", [False, True])
def test_row_adagrad_on_the_card_equals_the_cpu(cuda, storage, interleaved):
    """Dyadic gradients sum exactly in any order, so the card's update (B8
    k = 2 separate, B3 h = 2 / h = 3 interleaved) equals the plain CPU one
    bit for bit, stochastic rounding of the 16-bit tables included."""
    rng = np.random.default_rng(11)
    n, d, r = 600, 128, 900
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    if storage != "fp32":
        table = pack_table(table.to(
            torch.bfloat16 if storage == "bf16" else torch.float16))
    idx = torch.from_numpy(rng.integers(0, n, size=r).astype(np.int32))
    g = torch.from_numpy((rng.integers(-8, 9, size=(r, d)) / 4).astype(np.float32))
    opt = optim.RowAdagrad(0.05, interleaved=interleaved)
    out = {}
    for device in ("cpu", cuda):
        t = opt.widen_table(table.clone()).to(device)
        s = opt.init(t, n_logical=n)
        row_kernels.reset_launch_counts()
        for _ in range(2):
            t, s = opt.update_rows(t, s, idx.to(device), g.to(device))
        out[str(device)] = (t.cpu(), {k: v.cpu() for k, v in s.items()})
    torch.cuda.synchronize()
    want = (row_kernels.scatter_rows.launches, row_kernels.scatter_rows_multi.launches)
    assert want == ((2, 0) if interleaved else (0, 2))
    (tc, sc), (tg, sg) = out["cpu"], out["cuda"]
    assert torch.equal(tg.view(torch.int32), tc.view(torch.int32))
    assert sg.keys() == sc.keys() and all(torch.equal(sg[k], sc[k]) for k in sc)


def _resume_setup(device, storage):
    """A small wikikg2-like device-sampled step (TransE-L1 d = 128, bf16
    scoring, RowSGDM interleaved) and the pieces of its Trainer."""
    n_entity, n_rel = 3000, 13
    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(n_entity, size=6000), rng.integers(n_rel, size=6000),
                        rng.integers(n_entity, size=6000)], 1).astype(np.int32)
    ds = KGDataset(n_entity=n_entity, n_relation_type=n_rel, triples={"train": triples},
                   original_triple_ids={"train": np.arange(6000)})
    sharding = Sharding.create(n_entity, 1, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = TransE(True, 1, sharding, n_rel, 128, seed=0)
    score_fn.compute_dtype = torch.bfloat16
    if storage == "bf16":
        score_fn.dtype = torch.bfloat16
        score_fn.packed_entity_storage = True
    ns = RandomShardedNegativeSampler(32, sharding, 0, "ht", False, flat_negative_format=True)
    module = bess.EmbeddingMovingBessKGE(
        ns, score_fn, loss.SampledSoftmaxCrossEntropyLoss(n_entity), augment_negative=True)
    dev = DeviceBatchSampler(pts, ns, shard_bs=128, batches_per_step=4, seed=0,
                             positive_mode="runs")
    return module, dev, score_fn.initial_params(device=device)


@pytest.mark.parametrize("storage", ["fp32", "bf16"])
def test_resume_on_the_card_equals_the_uninterrupted_run(cuda, storage, tmp_path):
    """Two graphed calls, ``Trainer.save``, a fresh Trainer from
    ``load_checkpoint`` with the file's optimizer state, calls 2 and 3: every
    array equals four calls without a break, bit for bit."""
    from besskge_tpu_torch import checkpoint

    module, dev, params = _resume_setup(cuda, storage)
    opt, ent = optim.SGD(0.05, momentum=0.9), optim.RowSGDM(0.05, momentum=0.9, interleaved=True)

    def fresh(p):
        return trainer.Trainer(module, dev, opt, params=p, entity_optimizer=ent, steps_per_call=3,
                               device=cuda)

    def calls(tr, keys):
        for i in keys:
            tr.params, tr.opt_state, _ = tr.train_step(tr.params, tr.opt_state, tr.sampler_state,
                                                       dev.next_key(i))
        torch.cuda.synchronize()

    whole = fresh(trainer._clone(params))
    calls(whole, range(4))
    first = fresh(trainer._clone(params))
    calls(first, range(2))
    first.save(str(tmp_path / "c.npz"), step=6)
    loaded, state, _, meta = checkpoint.load_checkpoint(tmp_path / "c.npz", interleave_entity=True)
    assert meta == {"step": 6}
    resumed = fresh(loaded)
    resumed.opt_state = checkpoint.load_checkpoint(
        tmp_path / "c.npz", like=resumed.opt_state, interleave_entity=True)[1]
    for part in ("entity", "other"):
        count = resumed.opt_state[part]["count"]
        assert count.dtype == torch.int32 and count.dim() == 0 and count.is_cuda
    row_kernels.reset_launch_counts()
    l1_kernels.reset_launch_counts()
    calls(resumed, (2, 3))
    assert row_kernels.scatter_rows.launches == 2 * 3  # warm-up and capture, then a replay
    got = dict(trainer._leaves(dict(p=resumed.params, s=resumed.opt_state)))
    want = dict(trainer._leaves(dict(p=whole.params, s=whole.opt_state)))
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert torch.equal(got[name].reshape(-1).view(torch.uint8),
                           value.reshape(-1).view(torch.uint8)), name


def test_reshard_on_the_card_keeps_table_and_topk(cuda, tmp_path):
    """A card table saved, re-sharded onto 4 shards, saved and re-sharded
    back comes back bit for bit, and its top-10 (B7 chunk merge) equals the
    original's by global ID."""
    from besskge_tpu_torch import checkpoint

    _, _, params = _resume_setup(cuda, "fp32")
    sharding = Sharding.create(3000, 1, seed=0)
    checkpoint.save_checkpoint(tmp_path / "a.npz", params, None, sharding)
    p4, _, sh4, _ = checkpoint.load_checkpoint(tmp_path / "a.npz",
                                               new_sharding=Sharding.create(3000, 4, seed=1))
    checkpoint.save_checkpoint(tmp_path / "b.npz", p4, None, sh4)
    back, _, _, _ = checkpoint.load_checkpoint(tmp_path / "b.npz", new_sharding=sharding)
    back = {k: v.to(cuda) for k, v in back.items()}
    for k in params:
        assert torch.equal(back[k], params[k]), k
    score_fn = TransE(True, 1, sharding, 13, 128, seed=0)
    rng = np.random.default_rng(2)
    queries = np.stack([rng.choice(3000, 256, replace=False), rng.integers(13, size=256)], 1)
    ds = KGDataset(n_entity=3000, n_relation_type=13, triples={"test": np.zeros((1, 3), np.int32)},
                   original_triple_ids={"test": np.arange(1)})
    pts = PartitionedTripleSet.create_from_queries(ds, sharding, queries.astype(np.int32), "hr",
                                                   ground_truth=queries[:, 0].astype(np.int32))
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=0)
    sampler = RigidShardedBatchSampler(pts, ns, shard_bs=256, batches_per_step=1, seed=0,
                                       return_triple_idx=True)
    batch = sampler.sample_batch(next(iter(sampler.epoch_index_blocks(shuffle=False))))
    topk = TopKQueryBessKGE(k=10, candidate_sampler=ns, score_fn=score_fn, return_scores=True,
                            merge_mode="chunk")
    fwd = build_topk_forward(topk, device=cuda)
    l1_kernels.reset_launch_counts()
    got, want = fwd(back, batch), fwd(params, batch)
    torch.cuda.synchronize()
    assert l1_kernels.l1_scores_chunkmax.launches == 2 * -(-3000 // topk.window_size)
    assert torch.equal(got["topk_global_id"], want["topk_global_id"])
    assert torch.equal(got["topk_scores"], want["topk_scores"])


# --------------------------------------------------------------------------
# The scorers but ConvE (ROADMAP A11)

BROADCAST_SCORERS = ("PairRE", "TripleRE", "BoxE", "InterHT", "TranS")


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cls", BROADCAST_SCORERS)
def test_blocked_window_scoring_on_the_card(cuda, monkeypatch, cls, bf16):
    """Top-k of a broadcast scorer over windows scored in blocks of 5
    queries equals, bit for bit, the top-k of one unblocked call per window
    on the card (each score is computed on its own, whatever the block);
    and the card's top-10 equals the CPU's, scores within 1e-5 (fp32) or
    2^-7 (bf16 scores) x (|want| + max|want|), IDs away from ties."""
    from besskge_tpu_torch import scoring

    sharding = Sharding.create(3000, 1, seed=0)
    score_fn = getattr(scoring, cls)(True, 1, sharding, 5, 64, seed=0)
    if bf16:
        score_fn.compute_dtype = torch.bfloat16
    params = score_fn.initial_params(device=cuda)
    rng = np.random.default_rng(3)
    rel = torch.from_numpy(rng.integers(5, size=48)).to(cuda)
    head = torch.from_numpy(rng.integers(3000, size=48)).to(cuda)
    topk = TopKQueryBessKGE(10, PlaceholderNegativeSampler("t"), score_fn, return_scores=True,
                            window_size=1024)
    with torch.no_grad():
        want = topk.forward(params, rel, head=head)
        monkeypatch.setattr(bess, "BROADCAST_BUDGET", 5 * 1024 * score_fn.entity_row_size)
        got = topk.forward(params, rel, head=head)
        cpu = topk.forward({k: v.cpu() for k, v in params.items()}, rel.cpu(), head=head.cpu())
    for key in want:
        assert torch.equal(got[key], want[key]), key
    scores, ids = want["topk_scores"].cpu(), want["topk_global_id"].cpu()
    rtol = 2.0**-7 if bf16 else 1e-5
    tol = rtol * (cpu["topk_scores"].abs() + cpu["topk_scores"].abs().max())
    assert ((scores - cpu["topk_scores"]).abs() <= tol).all()
    gap = (cpu["topk_scores"][:, :-1] - cpu["topk_scores"][:, 1:]).abs() > 2 * tol.max()
    isolated = gap[:, 1:] & gap[:, :-1]  # positions 1..k-2 with a clear gap on both sides
    assert torch.equal(ids[:, 1:-1][isolated], cpu["topk_global_id"][:, 1:-1][isolated])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_product_accumulates_in_fp32_on_the_card(cuda, dtype):
    """DistMult's and ComplEx's shared-pool product keeps full fp32 on the
    card whatever the caller set for TF32, and a bf16 product accumulates in
    fp32: against a float64 product of the same operands, within 1e-5 of
    the largest value (TF32 would miss by ~1e-3), or one bf16 rounding of
    the result (2^-8 relative)."""
    gen = torch.Generator(cuda).manual_seed(0)
    a = torch.randn(512, 256, device=cuda, generator=gen).to(dtype)
    b = torch.randn(4096, 256, device=cuda, generator=gen).to(dtype)
    want = a.double() @ b.double().T
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = distance.dot_product_matrix(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert got.dtype == dtype and torch.backends.cuda.matmul.allow_tf32 == prev
    err = (got.double() - want).abs()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * want.abs().max()
    else:
        assert (err <= 2.0**-8 * want.abs() + 1e-6 * want.abs().max()).all()


# --------------------------------------------------------------------------
# Evaluation and inference (ROADMAP A14)


def _allscores_setup(n_entity=3000, window=1024, bf16=False):
    from besskge_tpu_torch.bess import AllScoresBESS

    sharding = Sharding.create(n_entity, 1, seed=0)
    fn = TransE(True, 1, sharding, 7, 128, seed=0)
    if bf16:
        fn.compute_dtype = torch.bfloat16
    ns = PlaceholderNegativeSampler("t")
    rng = np.random.default_rng(0)
    tri = np.stack([rng.integers(n_entity, size=200), rng.integers(7, size=200),
                    rng.integers(n_entity, size=200)], 1).astype(np.int32)
    ds = KGDataset(n_entity=n_entity, n_relation_type=7, triples={"test": tri},
                   original_triple_ids={"test": np.arange(200)})
    pts = PartitionedTripleSet.create_from_dataset(ds, "test", sharding, partition_mode="h_shard")
    sampler = RigidShardedBatchSampler(pts, ns, shard_bs=64, batches_per_step=2, seed=0,
                                       return_triple_idx=True)
    return AllScoresBESS(ns, fn, window), fn, sampler, tri


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_allscores_windows_on_the_card_match_the_cpu(cuda, bf16):
    """Every window of AllScoresBESS (B5 on the card, one launch per
    micro-batch) against the CPU's plain version: within 1e-5 (fp32) or
    2^-7 (bf16 scores) x (|want| + max|want|); the last window clamped."""
    module, fn, sampler, _ = _allscores_setup(bf16=bf16)
    params = fn.initial_params(device="cpu")
    card = {k: v.to(cuda) for k, v in params.items()}
    batch = sampler.sample_batch(next(sampler.epoch_index_blocks(False)))
    on_card = bess.build_allscores_forward(module)
    on_cpu = bess.build_allscores_forward(module, device="cpu")
    rtol = 2.0**-7 if bf16 else 1e-5
    assert module.n_step == 3
    for step in range(module.n_step):
        l1_kernels.reset_launch_counts()
        got = on_card(card, batch, step)
        torch.cuda.synchronize()
        assert l1_kernels.l1_distance_matrix.launches == 2  # one per micro-batch
        want = on_cpu(params, batch, step).float()
        assert got.shape == want.shape == (2, 1, 64, 1024)
        tol = rtol * (want.abs() + want.abs().max())
        assert ((got.float().cpu() - want).abs() <= tol).all(), step


def test_pipeline_stitch_on_the_card_equals_a_host_stitch(cuda):
    """AllScoresPipeline stitches, filters and ranks on the card; its score
    matrix equals, bit for bit, the JAX package's host-side recipe applied to
    the same windows copied to the host (stitch, column map, candidate and
    filter masks, the true score restored)."""
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.pipeline import AllScoresPipeline
    from besskge_tpu_torch.utils import get_entity_filter

    module, fn, sampler, tri = _allscores_setup(window=1280)
    params = {k: v.to(cuda) for k, v in fn.initial_params(device="cpu").items()}
    known = np.concatenate([tri, (tri + [0, 0, 1]) % [3000, 7, 3000]]).astype(np.int32)
    cands = np.arange(0, 3000, 2, dtype=np.int32)
    pipe = AllScoresPipeline(sampler, "t", fn, evaluation=Evaluation(["mrr"], return_ranks=True),
                             filter_triples=[known], candidate_ents=cands, return_scores=True,
                             window_size=1280)
    out = pipe.forward(params)
    rows = []
    for batch in sampler.get_dataloader(shuffle=False):
        mask = batch["triple_mask"].reshape(-1)
        windows = [pipe._fwd(params, batch, i).cpu().numpy() for i in range(pipe.bess_module.n_step)]
        scores = np.concatenate([w.reshape(-1, w.shape[-1]) for w in windows], axis=-1)
        filt = scores[mask][:, pipe._col_select].astype(np.float32)
        filt[:, pipe.candidate_mask] = -np.inf
        gt = batch["tail"].reshape(-1)[mask]
        true = filt[np.arange(len(gt)), gt]
        pairs = get_entity_filter(pipe.triples[batch["triple_idx"].reshape(-1)[mask]], known, "t")
        filt[pairs[:, 0], pairs[:, 1]] = -np.inf
        filt[np.arange(len(gt)), gt] = true
        rows.append(filt)
    np.testing.assert_array_equal(out["scores"], np.concatenate(rows))
    assert np.isneginf(out["scores"]).any() and np.isfinite(out["ranks"]).all()


def test_device_eval_block_makes_no_host_sync(cuda):
    """run_device_eval's block runner, on a block staged on the card, runs
    under torch.cuda.set_sync_debug_mode("error"), and its sums equal the
    stepwise build_bess_forward loop's."""
    from besskge_tpu_torch.bess import ScoreMovingBessKGE, _FORWARD_KEYS, build_bess_forward
    from besskge_tpu_torch.eval_loop import _stack_block, make_block_runner, run_device_eval
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import TripleBasedShardedNegativeSampler

    rng = np.random.default_rng(1)
    n = 4000
    tri = np.stack([rng.integers(n, size=900), rng.integers(9, size=900),
                    rng.integers(n, size=900)], 1).astype(np.int32)
    ds = KGDataset(n_entity=n, n_relation_type=9, triples={"valid": tri},
                   original_triple_ids={"valid": np.arange(900)},
                   neg_tails={"valid": rng.integers(n, size=(900, 50)).astype(np.int32)})
    sharding = Sharding.create(n, 1, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(ds, "valid", sharding,
                                                   partition_mode="ht_shardpair")
    ns = TripleBasedShardedNegativeSampler(None, pts.neg_tails, sharding, "t", seed=0)
    sampler = RigidShardedBatchSampler(pts, ns, shard_bs=64, batches_per_step=3, seed=0,
                                       duplicate_batch=False)
    fn = TransE(False, 1, sharding, 9, 128, seed=0)
    fn.compute_dtype = torch.bfloat16
    module = ScoreMovingBessKGE(ns, fn, evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"))
    params = fn.initial_params(device=cuda)
    steps = [{k: v for k, v in b.items() if k in _FORWARD_KEYS}
             for b in sampler.get_dataloader(shuffle=False)]
    block = _stack_block(steps[:4], 4, cuda)
    run_block = make_block_runner(module)
    run_block(params, block)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sums = run_block(params, block)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fwd = build_bess_forward(module)
    want = sum(fwd(params, s)["metrics"].sum((0, 1)) for s in steps[:4])
    torch.testing.assert_close(sums, want, rtol=1e-6, atol=0)
    metrics, n_q = run_device_eval(module, params, sampler, steps_per_block=3)
    assert n_q == 900 and 0 < metrics["mrr"] <= 1


# --------------------------------------------------------------------------
# ConvE (ROADMAP A11): dropout in captured graphs, the in-step BN EMA


def _conve_setup(device, spc=1):
    """ConvE at a small width (d = 32 as 4 x 8) on the dense step with
    FusedDenseAdamW, 400 entities, 4 relation types with inverses, 2 x 64
    positives, 8 shared "t" negatives; params from the host draw."""
    from besskge_tpu_torch.scoring import ConvE

    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(400, size=3000), rng.integers(4, size=3000),
                        rng.integers(400, size=3000)], 1).astype(np.int32)
    ds = KGDataset(n_entity=400, n_relation_type=4, triples={"train": triples},
                   original_triple_ids={"train": np.arange(3000)})
    sharding = Sharding.create(400, 1, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding, add_inverse_triples=True)
    score_fn = ConvE(True, sharding, 4, 32, 4, 8, seed=0)
    ns = RandomShardedNegativeSampler(8, sharding, 0, "t", False, flat_negative_format=True)
    module = bess.EmbeddingMovingBessKGE(ns, score_fn, loss.SampledSoftmaxCrossEntropyLoss(400))
    opt, ent = optim.AdamW(1e-3), optim.FusedDenseAdamW(1e-3, weight_decay=1e-4)
    dev = DeviceBatchSampler(pts, ns, shard_bs=64, batches_per_step=2, seed=0,
                             positive_mode="runs")
    params = trainer._tree_map(lambda v: v.to(device), score_fn.initial_params(device="cpu"))
    state = trainer.init_optimizer_state(opt, params, None, ent)
    fn = trainer.build_device_train_step(module, opt, dev, None, ent, True, spc, device)
    return score_fn, fn, params, state, dev


def test_conve_masks_on_the_card_equal_the_cpu(cuda):
    """The counter hash draws the same dropout masks on the card as on the
    CPU, bit for bit, under vmap too."""
    from besskge_tpu_torch.scoring import _keep_mask

    keys = split_key(torch.tensor(11, dtype=torch.int64), 4)
    for shape, keep in (((64, 8, 8, 1), 0.8), ((64, 1, 1, 32), 0.8), ((64, 32), 0.7)):
        cpu = torch.func.vmap(lambda k: _keep_mask(k, keep, shape))(keys)
        card = torch.func.vmap(lambda k: _keep_mask(k, keep, shape))(keys.to(cuda))
        assert torch.equal(card.cpu(), cpu)


def test_conve_conv_runs_full_fp32_and_deterministic(cuda):
    """ConvE's conv on the card keeps full fp32 whatever cuDNN's TF32 flag
    says (against a float64 conv of the same operands, within 1e-5 of the
    largest value), its backward gives the same bits twice, and the flags
    are the caller's again afterwards."""
    from besskge_tpu_torch.scoring import _ValidConv2d

    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(256, 1, 20, 20, device=cuda, generator=gen, requires_grad=True)
    w = torch.randn(32, 1, 3, 3, device=cuda, generator=gen, requires_grad=True)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = _ValidConv2d.apply(x, w)
        grads = [torch.autograd.grad(out.square().sum(), (x, w), retain_graph=True)
                 for _ in range(2)]
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.backends.cudnn.allow_tf32 == prev
    want = torch.nn.functional.conv2d(x.double(), w.double())
    assert ((out.double() - want).abs() <= 1e-5 * want.abs().max()).all()
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_conve_step_on_the_card_matches_the_cpu(cuda):
    """One steps_per_call=1 ConvE call with a dropout key on the card
    against the same call on the CPU: fp32 sums in other orders, 1e-5 x
    (|want| + max|want|), a param also lr x its update directions'
    difference; the BN running stats moved and within 1e-5. The moments of
    conv_b and bn0's scale, whose gradients are near 0 (conv_b's exactly,
    bn0's scale's up to BatchNorm's eps), hold rounding noise: they are held
    against the largest moment of their kind instead of their own."""
    score_fn, fn, params, state, dev = _conve_setup(cuda)
    _, cpu_fn, cpu_params, cpu_state, _ = _conve_setup("cpu")
    key = dev.next_key(3)
    _, _, out = fn(params, state, dev.state(cuda), key, 77)
    _, _, cpu_out = cpu_fn(cpu_params, cpu_state, dev.state("cpu"), key, 77)
    torch.testing.assert_close(out["loss"].cpu(), cpu_out["loss"], rtol=1e-5, atol=0.0)
    g_tree = dict(params=trainer._tree_map(lambda v: v.cpu(), params),
                  state=trainer._tree_map(lambda v: v.cpu(), state))
    c_tree = dict(params=cpu_params, state=cpu_state)
    cpu_leaves = dict(trainer._leaves(c_tree))
    largest = {m: max(float(v.abs().max()) for n, v in cpu_leaves.items()
                      if m in n.split(".")) for m in ("mu", "nu")}
    for name, g in trainer._leaves(g_tree):
        c = cpu_leaves[name]
        if name.endswith("count"):
            continue  # below
        extra, scale = 0.0, c.abs().max()
        if name.startswith("params.") and not name.endswith(("mean", "var")):
            extra = 1e-3 * (_ratio(g_tree, name, 1) - _ratio(c_tree, name, 1)).abs()
        elif name.endswith(("conv_b", "bn0.scale")):
            scale = largest["mu" if "mu" in name.split(".") else "nu"]
        assert ((g - c).abs() <= 1e-5 * (c.abs() + scale) + extra).all(), name
    assert int(state["entity"]["count"]) == int(cpu_state["entity"]["count"]) == 1
    assert float(params["bn1"]["mean"].abs().max()) > 1e-4


def test_conve_device_call_replays_equal_eager(cuda):
    """A ConvE call of 3 steps with its dropout drawn inside one CUDA graph:
    each replay (a new key and dropout key each) equals the eager card
    steps bit for bit, with no host sync and no wrapper call; B10 3 times
    per replay by name."""
    spc = 3
    _, fn, params, state, dev = _conve_setup(cuda, spc)
    sampler_state = dev.state(cuda)
    eager = (trainer._clone(params), trainer._clone(state))
    for call in range(3):
        key = dev.next_key(call)
        if call:
            trainer._write_back(eager[0], params)
            trainer._write_back(eager[1], state)
        adamw_kernels.reset_launch_counts()
        if call:
            torch.cuda.set_sync_debug_mode("error")
        try:
            fn(params, state, sampler_state, key, 500 + call)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert adamw_kernels.dense_adamw_update.launches == (2 * spc if call == 0 else 0)
        fn._eager(*eager, sampler_state, key.to(cuda),
                  torch.tensor(500 + call, dtype=torch.int64, device=cuda))
        torch.cuda.synchronize()
        for (name, g), (_, e) in zip(trainer._leaves({"p": params, "s": state}),
                                     trainer._leaves({"p": eager[0], "s": eager[1]})):
            assert torch.equal(g, e), (call, name)
    kernels = device_kernels(lambda: fn(params, state, sampler_state, dev.next_key(9), 9), 1)
    assert sum(c for name, (_, c) in kernels.items() if "dense_adamw_kernel" in name) == spc


def test_one_rank_nccl_call_captures_its_collectives(cuda, tmp_path):
    """The sparse device-sampled call over a one-rank NCCL mesh is one CUDA
    graph with its collectives: the first call records 2 x bps all-to-alls
    and one all-reduce per step in its warm-up and again in its capture, a
    replay records none; each call equals its eager steps bit for bit and
    the same call without a mesh within 1e-5 x (|want| + max|want|)."""
    from besskge_tpu_torch.parallel import make_shard_mesh, multihost
    from besskge_tpu_torch.parallel.census import collective_summary

    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        mesh = make_shard_mesh(1)
        assert mesh.backend == "nccl" and mesh.capturable
        spc, bps = 2, 4
        fn, params, state, dev = _device_setup(cuda, "sparse", spc, mesh=mesh)
        free, _, _, _ = _device_setup(cuda, "sparse", spc)
        assert fn.uncaptured is None and fn._graph is not None
        sampler_state = dev.state(cuda)
        for call in range(3):
            key = dev.next_key(call)
            eager = (trainer._clone(params), trainer._clone(state))
            other = (trainer._clone(params), trainer._clone(state))
            counts = collective_summary(fn, params, state, sampler_state, key, mesh=mesh)
            runs = 2 if call == 0 else 0  # the warm-up and the capture; a replay none
            assert counts["all-to-all"] == runs * spc * 2 * bps, counts
            assert counts["all-reduce"] == runs * spc and counts["all-gather"] == 0, counts
            fn._eager(*eager, sampler_state, key.to(cuda))
            free(*other, sampler_state, key)
            torch.cuda.synchronize()
            for (name, g), (_, e), (_, o) in zip(
                    trainer._leaves({"p": params, "s": state}),
                    trainer._leaves({"p": eager[0], "s": eager[1]}),
                    trainer._leaves({"p": other[0], "s": other[1]})):
                assert torch.equal(g, e), (call, name)
                if g.is_floating_point():
                    assert ((g - o).abs() <= 1e-5 * (o.abs() + o.abs().max())).all(), (call, name)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("form", ["sm_forward", "device_eval", "pipeline", "sm_step",
                                  "conve_sync_bn"])
def test_one_rank_nccl_rest_of_the_mesh(cuda, tmp_path, form):
    """Each form that the rest of the mesh ported, over a one-rank NCCL mesh
    on the card, against the same call without a mesh: the ScoreMoving
    forward, ``run_device_eval`` and ``AllScoresPipeline`` bit for bit; the
    ScoreMoving sparse step and ConvE's fused dense step with SyncBN (one
    shard: the identity) within 1e-5 x (|want| + max|want|) (the mesh runs
    its micro-batches one by one through B5/B6, the mesh-free step vmaps
    them through B1/B2)."""
    import torch_mesh_ranks as R
    from besskge_tpu_torch import eval_loop
    from besskge_tpu_torch.parallel import make_shard_mesh, multihost, shard_params

    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        mesh = make_shard_mesh(1)
        assert mesh.backend == "nccl"
        on = lambda p: shard_params(p, mesh)  # noqa: E731

        def pair(build):
            """The form over the mesh and without one (axis_name None)."""
            return build(mesh, "shard"), build(None, None)

        if form in ("sm_forward", "device_eval"):
            def build(m, axis):
                score_fn, module, sampler = (R.sm_setup(R.PORT, 1, ("tb", "ht", False))
                                             if form == "sm_forward" else R.eval_setup(R.PORT, 1))
                module.axis_name = axis
                return score_fn, module, sampler
            (score_fn, module, sampler), (_, free, _) = pair(build)
            params = on(score_fn.initial_params("cpu"))
            if form == "sm_forward":
                batch = sampler.sample_batch(next(sampler.epoch_index_blocks(False)))
                got = bess.build_bess_forward(module, mesh)(params, batch)
                want = bess.build_bess_forward(free, None)(params, batch)
                for k in want:
                    assert torch.equal(got[k], want[k]), k
            else:
                got = eval_loop.run_device_eval(module, params, sampler, mesh, steps_per_block=3)
                want = eval_loop.run_device_eval(free, params, sampler, None, steps_per_block=3)
                assert got == want
        elif form == "pipeline":
            (score_fn, pipe, _, _), (_, free, _, _) = (
                R.pipe_setup(R.PORT, 1, "filters", m) for m in (mesh, None))
            params = on(score_fn.initial_params("cpu"))
            got, want = pipe.forward(params), free.forward(params)
            assert got.keys() == want.keys()
            for k, v in want.items():
                if isinstance(v, dict):
                    for name in v:
                        np.testing.assert_array_equal(got[k][name], v[name], err_msg=name)
                else:
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            def build(m, axis):
                if form == "sm_step":
                    score_fn, module, sampler, _ = R.smt_setup(R.PORT, 1, "ht")
                    opt, ent = optim.SGD(0.5), optim.RowSGDM(0.5, momentum=0.0)
                else:
                    score_fn, module, sampler = R.conve_setup(R.PORT, 1, True)
                    opt, ent = R.conve_optimizers("fused")
                module.axis_name = axis
                score_fn.mesh_axis = axis
                return score_fn, module, sampler, opt, ent
            (score_fn, module, sampler, opt, ent), (_, free, _, _, _) = pair(build)
            batch = sampler.sample_batch(next(sampler.epoch_index_blocks(False)))
            p0 = on(score_fn.initial_params("cpu"))
            out = []
            for m, mod in ((mesh, module), (None, free)):
                p = trainer._clone(p0)
                state = trainer.init_optimizer_state(opt, p, m, ent)
                out.append(trainer.build_train_step(mod, opt, m, ent)(p, state, batch))
            torch.cuda.synchronize()
            for (name, g), (_, w) in zip(trainer._leaves({"p": out[0][0], "s": out[0][1]}),
                                         trainer._leaves({"p": out[1][0], "s": out[1][1]})):
                if g.is_floating_point():
                    assert ((g - w).abs() <= 1e-5 * (w.abs() + w.abs().max())).all(), name
                else:
                    assert torch.equal(g, w), name
    finally:
        torch.distributed.destroy_process_group()


# bench_torch.py's monitor and self-test on the card (ROADMAP A16).


def test_bench_trace_breakdown_of_a_wikikg2_call(cuda, monkeypatch, tmp_path):
    """``monitor.trace_breakdown`` over one device-sampled wikikg2 call of
    ``bench_torch.py``'s set-up (smoke shapes; a replay: the capture is
    done first) returns every key of the reference's breakdown, the busy
    share in (0, 100]; a run that puts nothing on the card raises after its
    retries rather than returning ``{}``."""
    import bench_torch
    from besskge_tpu_torch import monitor

    monkeypatch.setattr(bench_torch, "_SMOKE", True)
    s = bench_torch._setup_wikikg2()
    dev, step, held = s["dev"], s["dstep"], (s["params"], s["opt_state"])
    st = dev.state("cuda")
    float(step(*held, st, dev.next_key(0))[2]["loss"])  # eager, then capture
    out = monitor.trace_breakdown(
        lambda: float(step(*held, st, dev.next_key(1))[2]["loss"]), str(tmp_path / "call"))
    assert set(out) == {"device_busy_pct", "collective_pct_of_busy", "collective_overlap_pct",
                        "data_movement_pct_of_busy"}
    assert 0 < out["device_busy_pct"] <= 100 and out["collective_pct_of_busy"] == 0.0
    assert 0 < out["data_movement_pct_of_busy"] < 100
    with pytest.raises(RuntimeError, match="no device event"):
        monitor.trace_breakdown(lambda: None, str(tmp_path / "empty"))
    stats = monitor.device_memory_stats()
    assert stats[str(torch.device("cuda", 0))]["allocated_bytes.all.current"] > 0


def test_bench_kernel_selftest_on_the_card(cuda):
    """``bench_torch._cuda_kernel_selftest``: B3 (plain and h = 3, 5), B8,
    B10 and B6 launched on the card, against numpy."""
    import bench_torch

    row_kernels.reset_launch_counts()
    adamw_kernels.reset_launch_counts()
    l1_kernels.reset_launch_counts()
    bench_torch._cuda_kernel_selftest()
    assert row_kernels.scatter_rows.launches == 3
    assert row_kernels.scatter_rows_multi.launches == 1
    assert adamw_kernels.dense_adamw_update.launches == 1
    assert l1_kernels.l1_distance_grads.launches == 1


def test_fixture_pick_runs_b5_without_host_sync(cuda):
    """One biokg ``pick`` at the build's shape (4,096 rows over the drug
    type, chunks of 512) on the card: its scans launch B5, one per chunk,
    no host synchronisation inside (``set_sync_debug_mode("error")``), and
    the picks equal the CPU's but where the perturbed top two lie within
    the two sides' fp32 sums (counted: at most 0.1 %)."""
    from besskge_tpu_torch import fixtures

    gen = torch.Generator(cuda).manual_seed(3)
    n_ty, lo, chunk = 10_533, 200, 512
    e_tab = torch.rand(lo + n_ty, 128, device=cuda, generator=gen) * 2 - 1
    ph = torch.rand(51, 64, device=cuda, generator=gen) * 6.283
    hh = torch.randint(0, lo, (4096,), device=cuda, generator=gen)
    rr = torch.randint(0, 51, (4096,), device=cuda, generator=gen)
    key = torch.tensor(17, device=cuda)
    pick = fixtures._pick
    pick(e_tab, ph, hh, rr, key, lo, n_ty, chunk, 0.5)  # warm-up: the build and the cuBLAS-free path
    torch.cuda.synchronize()
    l1_kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pick(e_tab, ph, hh, rr, key, lo, n_ty, chunk, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert l1_kernels.l1_distance_matrix.launches == -(-n_ty // chunk)
    want = pick(e_tab.cpu(), ph.cpu(), hh.cpu(), rr.cpu(), key.cpu(), lo, n_ty, chunk, 0.5)
    assert (got.cpu() != want).float().mean() <= 0.001
    assert ((got >= lo) & (got < lo + n_ty)).all()


def test_grad_of_vmapped_p1_distance_on_the_card(cuda):
    """The dense step's form, ``torch.func.grad`` of a vmapped p=1 forward,
    on the card: B1 forward and B2 backward launch (their wrappers take the
    plain tensors of the Functions' ``apply``), and the gradient equals the
    CPU's within the gradient sums' bound."""
    gen = torch.Generator(cuda).manual_seed(21)
    a = torch.randn(4, 48, 64, device=cuda, generator=gen)
    b = torch.randn(96, 64, device=cuda, generator=gen)
    w = torch.randn(4, 48, 96, device=cuda, generator=gen)

    def loss(p, w_):
        return torch.func.vmap(lambda x, v: (distance.p_distance_matrix(x, p["b"], 1) * v).sum())(
            p["a"], w_).sum()

    l1_kernels.reset_launch_counts()
    got = torch.func.grad(loss)({"a": a, "b": b}, w)
    torch.cuda.synchronize()
    assert l1_kernels.l1_distance_matrix_batched.launches == 1
    assert l1_kernels.l1_distance_grads_batched.launches == 1
    want = torch.func.grad(loss)({"a": a.cpu(), "b": b.cpu()}, w.cpu())
    assert ((got["a"].cpu() - want["a"]).abs() <= _sum_tol(w.cpu(), 2)).all()
    w_b = w.cpu().transpose(1, 2).reshape(96, -1)
    assert ((got["b"].cpu() - want["b"]).abs() <= _sum_tol(w_b, 1)).all()


def test_wikikg2_twin_on_the_card(cuda):
    """``examples/wikikg2_parity_torch.py`` at a tiny scale on the card: the
    packed bf16 table trained (B1, B2, B8), validated through
    ``run_device_eval`` (its gathers before the vmap) and ranked against all
    entities (B7)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
    import wikikg2_parity_torch

    for wrapper in (l1_kernels, row_kernels):
        wrapper.reset_launch_counts()
    got = wikikg2_parity_torch.main(["--scale", "0.002", "--epochs", "1", "--vs-all", "128",
                                     "--eval-triples", "200", "--oracle-sample", "200"])
    assert np.isfinite(got["value"]) and np.isfinite(got["vs_all"]["mrr"])
    for wrapper in (l1_kernels.l1_distance_matrix_batched, l1_kernels.l1_distance_grads_batched,
                    row_kernels.scatter_rows_multi, l1_kernels.l1_scores_chunkmax):
        assert wrapper.launches > 0, wrapper.__name__


def test_graft_entry_dryrun_over_one_nccl_rank(cuda, tmp_path):
    """``graft_entry_torch.dryrun_multichip(1)`` over one NCCL rank on the
    card: the eleven sub-checks pass, B5 runs in the ScoreMoving eval, B4 in
    the interleaved RowSGDM check (its block equal to its plain version) and
    the sparse row writes in each training check."""
    import graft_entry_torch as G
    from besskge_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        res = G.dryrun_multichip(1)
    finally:
        torch.distributed.destroy_process_group()
    checks = res["checks"]
    assert len(checks) == 11 and res["lines"][-1].endswith("11/11 golden sub-checks passed")
    assert checks["score_moving_eval"]["launches"]["l1_distance_matrix"] > 0
    assert checks["interleaved_row_sgdm"]["launches"]["fused_pair_sgdm"] == 3
    assert checks["interleaved_row_sgdm"]["arrays"]["b4_vs_plain"] == 0.0
    for name in ("sparse_row_sgdm", "packed_bf16_table", "packed_fp16_table",
                 "packed_triplet_interleave", "packed_quint_adamw"):
        counts = checks[name]["launches"]
        assert counts["scatter_rows"] + counts["scatter_rows_multi"] > 0, (name, counts)
