"""Planted-oracle ceiling for the wikikg2 vs-ALL-entities ranking, through
the PyTorch/CUDA port (the twin of ``examples/wikikg2_oracle_vsall.py``).

The reference's vs-all number (MRR 0.267 over 2.5M entities) is measured on
real ogbl-wikikg2. The offline fixture
(:func:`besskge_tpu_torch.fixtures.build_wikikg2_fixture`) plants entities
in clusters of near-duplicates, so unfiltered whole-vocabulary ranking
competes the true tail against its cluster siblings: the quality bar for a
trained model is the planted model's own vs-all MRR@10 on the same queries.
This script scores the oracle embeddings through the same
``TopKQueryBessKGE`` program as ``examples/wikikg2_parity_torch.py
--vs-all`` (B7 on the card) and prints that ceiling.

Deviation: the JAX script prints no JSON line; this one ends with one
(``metric``, ``value``, ``hits@10``, ``oracle_500_mrr``) for callers.

    python examples/wikikg2_oracle_vsall_torch.py --vs-all 50000
    python examples/wikikg2_oracle_vsall_torch.py --scale 0.002 --vs-all 256 --cpu
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--vs-all", type=int, default=50_000, metavar="N")
    ap.add_argument("--eval-triples", type=int, default=50_000)
    ap.add_argument("--fixture-structural", type=float, default=0.95)
    ap.add_argument("--fixture-skew", type=float, default=8.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler
    from besskge_tpu_torch.bess import TopKQueryBessKGE, build_topk_forward
    from besskge_tpu_torch.fixtures import build_wikikg2_fixture
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import PlaceholderNegativeSampler
    from besskge_tpu_torch.scoring import TransE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
    from besskge_tpu_torch.utils import resolve_device

    device = str(resolve_device("cpu" if args.cpu else None))
    seed = 42  # MUST match examples/wikikg2_parity_torch.py
    t0 = time.perf_counter()
    ds, planted = build_wikikg2_fixture(
        seed=seed, scale=args.scale, return_planted=True, eval_rows=args.eval_triples,
        structural_fraction=args.fixture_structural, member_skew=args.fixture_skew,
    )
    print(
        f"fixture: {ds.n_entity} entities "
        f"({time.perf_counter() - t0:.1f}s); "
        f"planted 500-candidate oracle MRR ≈ {planted.oracle_estimate:.4f}"
    )

    sharding = Sharding.create(ds.n_entity, 1, seed=seed)
    max_e = sharding.max_entity_per_shard
    d = planted.entity.shape[1]
    ent = np.zeros((1, max_e, d), np.float32)
    ent[0, sharding.entity_to_idx] = planted.entity
    score_fn = TransE(
        negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=d,
        entity_initializer=ent, relation_initializer=planted.relation.astype(np.float32),
    )
    score_fn.compute_dtype = torch.bfloat16  # match the trained eval's math
    params = score_fn.initial_params(device)

    vq = ds.triples["valid"][: args.vs_all]
    pns = PlaceholderNegativeSampler(corruption_scheme="t", seed=seed)
    q_pts = PartitionedTripleSet.create_from_queries(
        ds, sharding, np.stack([vq[:, 0], vq[:, 1]], 1).astype(np.int32),
        "hr", ground_truth=vq[:, 2].astype(np.int32),
    )
    q_bs = RigidShardedBatchSampler(q_pts, pns, shard_bs=512, batches_per_step=4, seed=seed)
    topk_eval = Evaluation(["mrr", "hits@10"], worst_rank_infty=True, reduction="sum")
    topk = TopKQueryBessKGE(k=10, candidate_sampler=pns, score_fn=score_fn, evaluation=topk_eval)
    fwd = build_topk_forward(topk, None, device=device)
    totals = np.zeros(len(topk_eval.metrics))
    n_q = 0
    t0 = time.perf_counter()
    for batch in q_bs.get_dataloader(shuffle=False):
        out = fwd(params, batch)
        m = out["metrics"].cpu().numpy().astype(np.float64)
        totals += m.reshape(-1, len(topk_eval.metrics)).sum(0)
        n_q += int(batch["triple_mask"].sum())
    dt = time.perf_counter() - t0
    got = dict(zip(topk_eval.metrics.keys(), totals / n_q))
    print(
        f"ORACLE vs-ALL ({n_q} queries x {ds.n_entity} entities, "
        f"window {topk.window_size}, {dt:.1f}s): "
        + "  ".join(f"{k} {v:.4f}" for k, v in got.items())
    )
    result = {
        "metric": "wikikg2_fixture_oracle_vs_all_mrr",
        "value": round(float(got["mrr"]), 4),
        "unit": "MRR@10",
        "hits@10": round(float(got["hits@10"]), 4),
        "oracle_500_mrr": round(planted.oracle_estimate, 4),
        "queries": n_q,
        "scale": args.scale,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
