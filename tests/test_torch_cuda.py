"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test here skips. On a machine with one
(and nvcc), run them with ``python -m pytest tests/test_torch_cuda.py -q``;
``chip_smoke.py`` makes the same checks at the serving shapes.
"""

import numpy as np
import pytest
import torch

from besskge_tpu_torch.bess import TopKQueryBessKGE, build_topk_forward
from besskge_tpu_torch.negative_sampler import PlaceholderNegativeSampler
from besskge_tpu_torch.ops import l1_kernels
from besskge_tpu_torch.scoring import TransE
from besskge_tpu_torch.sharding import Sharding

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4
BF16_ULP = 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    tol = ATOL + (RTOL + (BF16_ULP if dtype == torch.bfloat16 else 0.0)) * ref.abs()
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
