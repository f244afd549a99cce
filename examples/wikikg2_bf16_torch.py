"""The bf16 capacity recipe at ogbl-wikikg2 scale through the PyTorch/CUDA
port (the twin of ``examples/wikikg2_bf16.py``).

The reference trains TransE on wikikg2 (2.5M entities) with fp16 weights
to fit the table in IPU SRAM (TransE, SSCE loss, 32 shared "t"-corruption
negatives + in-batch augmentation, SGD lr 1e-3 momentum 0.95,
``model.half()``). The port's translation of ``model.half()`` is
row-pair-packed bf16 storage (:mod:`besskge_tpu_torch.packed`): the entity
table lives in card memory at half the fp32 footprint, with its fp32
momentum interleaved in the triplet store (``interleave_packed_momentum``)
so that one B3 launch writes each touched packed row with its momentum.
Scoring runs in bf16 (``compute_dtype``) through B1 and B2.

The step is built by hand as the JAX script builds it
(``build_train_step``, ``init_optimizer_state``), and the store is split
back (``split_packed_interleaved``) for a sampled top-k smoke-eval.

Data: ``--real DIR`` loads actual ogbl-wikikg2 (needs the OGB files).
Offline (default) a wikikg2-shaped random graph exercises the full
capacity path; training quality on it is meaningless, so the run reports
throughput, the table's bytes against fp32, and a top-k smoke-eval.

Run:  python examples/wikikg2_bf16_torch.py                    # full, on the card
      python examples/wikikg2_bf16_torch.py --cpu --entities 20000 --steps 8
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", default=None, metavar="DIR")
    ap.add_argument("--entities", type=int, default=2_500_604)
    ap.add_argument("--relations", type=int, default=535)
    ap.add_argument("--triples", type=int, default=2_000_000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--shard-bs", type=int, default=512)
    ap.add_argument("--bps", type=int, default=8,
                    help="micro-batches per step (notebook packs 100 per "
                         "device iteration; 8 keeps host batches small)")
    ap.add_argument("--topk-queries", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from besskge_tpu_torch.batch_sampler import RandomShardedBatchSampler, RigidShardedBatchSampler
    from besskge_tpu_torch.bess import EmbeddingMovingBessKGE, TopKQueryBessKGE, build_topk_forward
    from besskge_tpu_torch.dataset import KGDataset
    from besskge_tpu_torch.loss import SampledSoftmaxCrossEntropyLoss
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import (
        PlaceholderNegativeSampler,
        RandomShardedNegativeSampler,
    )
    from besskge_tpu_torch.optim import SGD, RowSGDM
    from besskge_tpu_torch.packed import interleave_packed_momentum, split_packed_interleaved
    from besskge_tpu_torch.scoring import TransE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
    from besskge_tpu_torch.trainer import build_train_step, init_optimizer_state
    from besskge_tpu_torch.utils import resolve_device

    device = str(resolve_device("cpu" if args.cpu else None))
    seed = 42
    if args.real:
        ds = KGDataset.build_ogbl_wikikg2(Path(args.real))
    else:
        rng = np.random.default_rng(seed)
        tri = np.stack([
            rng.integers(args.entities, size=args.triples),
            rng.integers(args.relations, size=args.triples),
            rng.integers(args.entities, size=args.triples),
        ], axis=1).astype(np.int32)
        ds = KGDataset(
            n_entity=args.entities,
            n_relation_type=args.relations,
            entity_dict=None,
            relation_dict=None,
            type_offsets=None,
            triples={"train": tri[:-5000], "valid": tri[-5000:]},
            original_triple_ids={
                "train": np.arange(len(tri) - 5000, dtype=np.int64),
                "valid": np.arange(5000, dtype=np.int64),
            },
            neg_heads=None,
            neg_tails=None,
        )
    print(f"dataset: {ds.n_entity:,} entities, {len(ds.triples['train']):,} train triples")

    n_shard = 1  # capacity demo: one card's memory
    sharding = Sharding.create(ds.n_entity, n_shard, seed=seed)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)

    # ------------------- model: bf16 packed table (the `model.half()`) ----
    score_fn = TransE(
        negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=128, seed=seed,
    )
    score_fn.dtype = torch.bfloat16
    score_fn.packed_entity_storage = True
    score_fn.compute_dtype = torch.bfloat16

    ns = RandomShardedNegativeSampler(32, sharding, seed, "t", local_sampling=False,
                                      flat_negative_format=True)
    bs = RandomShardedBatchSampler(pts, ns, shard_bs=args.shard_bs, batches_per_step=args.bps,
                                   seed=seed)
    bess = EmbeddingMovingBessKGE(
        negative_sampler=ns,
        score_fn=score_fn,
        loss_fn=SampledSoftmaxCrossEntropyLoss(n_entity=ds.n_entity),
        augment_negative=True,
    )
    opt = SGD(1e-3, momentum=0.95)
    # interleaved=True: the momentum lives inside the packed store (triplet-
    # major blocks, one scatter per touched packed row); checkpoints keep
    # the plain on-disk format.
    row = RowSGDM(learning_rate=1e-3, momentum=0.95, interleaved=True)
    params = dict(score_fn.initial_params_device(device=device))
    params["entity_embedding"] = interleave_packed_momentum(params["entity_embedding"])
    table = params["entity_embedding"]
    table_bytes = table.numel() * table.element_size()
    fp32_bytes = sharding.n_shard * sharding.max_entity_per_shard * 128 * 4
    print(f"entity table: packed {table.dtype} {tuple(table.shape)} = "
          f"{table_bytes / 2**30:.2f} GiB incl. interleaved fp32 "
          f"momentum (fp32 params alone would be "
          f"{fp32_bytes / 2**30:.2f} GiB + momentum)")
    opt_state = init_optimizer_state(opt, params, None, row)
    step_fn = build_train_step(bess, opt, None, row, device=device)

    # ----------------------------- train ----------------------------------
    loader = bs.get_dataloader(shuffle=True, prefetch=4, repeat=True)
    params, opt_state, out = step_fn(params, opt_state, next(loader))
    print(f"first step; loss {float(out['loss']):.3f}")
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, opt_state, out = step_fn(params, opt_state, next(loader))
    loss = float(out["loss"])  # sync point
    dt = time.perf_counter() - t0
    rate = args.steps * args.shard_bs * args.bps / dt
    print(f"train: {args.steps} steps, loss {loss:.3f}, {rate:,.0f} pos triples/s")
    assert np.isfinite(loss)

    # -------------------- sampled top-k smoke eval ------------------------
    vq = ds.triples["valid"][: args.topk_queries]
    qpts = PartitionedTripleSet.create_from_queries(
        ds, sharding, vq[:, :2].astype(np.int32), "hr", ground_truth=vq[:, 2].astype(np.int32),
    )
    pns = PlaceholderNegativeSampler(corruption_scheme="t", seed=seed)
    qbs = RigidShardedBatchSampler(qpts, pns, shard_bs=128, batches_per_step=2, seed=seed,
                                   return_triple_idx=True)
    topk = TopKQueryBessKGE(
        k=10, candidate_sampler=pns, score_fn=score_fn,
        evaluation=Evaluation(["mrr", "hits@10"], worst_rank_infty=True, reduction="sum"),
        window_size=1000,
    )
    fwd = build_topk_forward(topk, device=device)
    # split the triplet store for eval: contiguous window slices over the
    # interleaved table would read 3x the bytes
    eval_params = dict(params)
    eval_params["entity_embedding"], _ = split_packed_interleaved(params["entity_embedding"])
    totals, n_q = np.zeros(2), 0
    t0 = time.perf_counter()
    for b in qbs.get_dataloader(shuffle=False):
        o = fwd(eval_params, b)
        totals += o["metrics"].cpu().numpy().astype(np.float64).reshape(-1, 2).sum(0)
        n_q += int(b["triple_mask"].sum())
    print(f"top-10 vs ALL {ds.n_entity:,} entities, {n_q} queries: "
          f"{time.perf_counter() - t0:.1f}s, "
          f"mrr {totals[0] / n_q:.4f} hits@10 {totals[1] / n_q:.4f}")

    result = {
        "metric": "wikikg2_bf16_packed_train_pos_triples_per_s",
        "value": round(rate, 1),
        "unit": "triples/s",
        "table_gib": round(table_bytes / 2**30, 3),
        "fp32_table_gib": round(fp32_bytes / 2**30, 3),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
