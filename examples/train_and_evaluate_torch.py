"""End-to-end BESS-KGE walkthrough through the PyTorch/CUDA port (the twin
of ``examples/train_and_evaluate.py``): training, candidate-set
validation, top-k prediction, filtered all-scores evaluation, checkpoint
and re-shard.

RotatE (p = 2) trained by ``Trainer`` with ``RowAdamW`` on the entity table
(separate moment buffers: B8 with k = 3 on the card) and ``AdamW`` on the
relations; validation against 64 random candidates per triple through
``build_bess_forward``; top-10 against all entities; the filtered
``AllScoresPipeline``; a checkpoint re-sharded onto one shard.

One shard on the card (or with ``--cpu``), or one per rank under
``torchrun``:

    python examples/train_and_evaluate_torch.py
    python examples/train_and_evaluate_torch.py --cpu
    torchrun --nproc-per-node 4 examples/train_and_evaluate_torch.py

Deviations: the JAX script takes no flags and runs on ``min(4, devices)``
shards at import; this one has ``main(argv)`` with ``--cpu`` and
``--epochs`` (default 60, the JAX script's), takes its shards from the
process group, writes its checkpoint to a temporary directory, and ends
with a JSON line of its metrics.
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_ENTITY, N_RELATION = 500, 8


def shard_mesh(device: str):
    """``None`` (one shard) in one process; under ``torchrun`` the mesh of
    every rank, one shard each."""
    import torch.distributed as dist

    from besskge_tpu_torch.parallel import multihost

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 and not dist.is_initialized():
        return None
    multihost.initialize(device=device)
    n = dist.get_world_size()
    return multihost.make_global_mesh(n, [device] * n if device == "cpu" else None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch.distributed as dist

    from besskge_tpu_torch.batch_sampler import RandomShardedBatchSampler, RigidShardedBatchSampler
    from besskge_tpu_torch.bess import (
        EmbeddingMovingBessKGE,
        ScoreMovingBessKGE,
        TopKQueryBessKGE,
        build_bess_forward,
        build_topk_forward,
    )
    from besskge_tpu_torch.checkpoint import load_checkpoint
    from besskge_tpu_torch.dataset import KGDataset
    from besskge_tpu_torch.loss import LogSigmoidLoss
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import (
        PlaceholderNegativeSampler,
        RandomShardedNegativeSampler,
        TripleBasedShardedNegativeSampler,
    )
    from besskge_tpu_torch.optim import AdamW, RowAdamW
    from besskge_tpu_torch.pipeline import AllScoresPipeline
    from besskge_tpu_torch.scoring import RotatE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
    from besskge_tpu_torch.trainer import Trainer
    from besskge_tpu_torch.utils import resolve_device

    device = str(resolve_device("cpu" if args.cpu else None))
    mesh = shard_mesh(device)
    n_shard = 1 if mesh is None else mesh.n_shard
    axis = None if mesh is None else "shard"
    on = None if mesh is not None else device

    # ------------------------------------------------------------- dataset
    rng = np.random.default_rng(0)
    h = rng.integers(N_ENTITY, size=20_000)
    r = rng.integers(N_RELATION, size=20_000)
    t = (h * 7 + r * 13 + 1) % N_ENTITY  # structured, learnable
    ds = KGDataset.from_triples(np.stack([h, r, t], 1).astype(np.int32), split=(0.85, 0.1, 0.05))
    sharding = Sharding.create(ds.n_entity, n_shard, seed=0)
    train_pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)

    # --------------------------------------------------------------- model
    score_fn = RotatE(
        negative_sample_sharing=True, scoring_norm=2, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=64, seed=0,
    )

    # ------------------------------------------------------------ training
    train_ns = RandomShardedNegativeSampler(8, sharding, 0, "ht", local_sampling=False,
                                            flat_negative_format=True)
    train_bs = RandomShardedBatchSampler(train_pts, train_ns, shard_bs=64, batches_per_step=4,
                                         seed=0)
    bess = EmbeddingMovingBessKGE(
        negative_sampler=train_ns, score_fn=score_fn,
        loss_fn=LogSigmoidLoss(margin=6.0, negative_adversarial_sampling=True),
        evaluation=Evaluation(["mrr"], reduction="sum"), axis_name=axis,
    )
    # optax.adam(3e-3): AdamW without weight decay.
    trainer = Trainer(bess, train_bs, AdamW(3e-3, weight_decay=0.0), mesh=mesh,
                      entity_optimizer=RowAdamW(learning_rate=3e-3), seed=0, device=on)
    stats = trainer.fit(n_epochs=args.epochs)
    print(f"train: {stats['steps']} steps, {stats['triples_per_s']:.0f} triples/s,"
          f" final loss {stats['final_loss']:.1f}")
    params = trainer.params

    # ------------------------------------- validation vs random candidate sets
    valid = ds.triples["valid"]
    cand = rng.integers(N_ENTITY, size=(valid.shape[0], 64)).astype(np.int32)
    ds.neg_heads = {"valid": cand}
    ds.neg_tails = {"valid": cand}
    valid_pts = PartitionedTripleSet.create_from_dataset(ds, "valid", sharding)
    valid_ns = TripleBasedShardedNegativeSampler(
        valid_pts.neg_heads, valid_pts.neg_tails, sharding, corruption_scheme="ht", seed=0,
    )
    valid_bs = RigidShardedBatchSampler(valid_pts, valid_ns, shard_bs=64, batches_per_step=1,
                                        seed=0, duplicate_batch=True)
    # Per-triple candidate sets need a non-sharing scorer; it reads the SAME
    # trained params (the flag only changes the negative-scoring layout).
    val_score_fn = RotatE(
        negative_sample_sharing=False, scoring_norm=2, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=64,
    )
    val_bess = ScoreMovingBessKGE(
        negative_sampler=valid_ns, score_fn=val_score_fn,
        evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"), axis_name=axis,
    )
    val_fwd = build_bess_forward(val_bess, mesh, device=on)
    total, count = np.zeros(2), 0
    for block in valid_bs.epoch_index_blocks(shuffle=False):
        batch = valid_bs.sample_batch(block)
        out = val_fwd(params, batch)
        total += out["metrics"].cpu().numpy().reshape(-1)
        count += int(batch["triple_mask"].sum())
    valid_metrics = total / count
    print(f"valid vs 64 candidates: metrics/triple = {valid_metrics}")

    # --------------------------------------------- top-k (h, r, ?) prediction
    test = ds.triples["test"]
    test_pts = PartitionedTripleSet.create_from_queries(ds, sharding, test[:, :2], "hr",
                                                        ground_truth=test[:, 2])
    topk_ns = PlaceholderNegativeSampler(corruption_scheme="t")
    topk_bs = RigidShardedBatchSampler(test_pts, topk_ns, shard_bs=32, batches_per_step=1, seed=0)
    topk = TopKQueryBessKGE(
        k=10, candidate_sampler=topk_ns, score_fn=score_fn,
        evaluation=Evaluation(["mrr", "hits@10"], worst_rank_infty=True, reduction="sum"),
        window_size=100, axis_name=axis,
    )
    topk_fwd = build_topk_forward(topk, mesh, device=on)
    total, count = np.zeros(2), 0
    for block in topk_bs.epoch_index_blocks(shuffle=False):
        batch = topk_bs.sample_batch(block)
        out = topk_fwd(params, batch)
        total += out["metrics"].cpu().numpy().reshape(-1)
        count += int(batch["triple_mask"].sum())
    topk_metrics = total / count
    print(f"test top-10 vs ALL entities: metrics/triple = {topk_metrics}")

    # ------------------------------- filtered all-scores evaluation (pipeline)
    pipe_bs = RigidShardedBatchSampler(test_pts, topk_ns, shard_bs=32, batches_per_step=1, seed=0,
                                       return_triple_idx=True)
    pipeline = AllScoresPipeline(
        pipe_bs, "t", score_fn, mesh=mesh,
        evaluation=Evaluation(["mrr", "hits@10"], reduction="none"),
        filter_triples=[ds.triples["train"]], window_size=128, device=on,
    )
    out = pipeline.forward(params)
    print(f"test filtered (train triples masked): {out['metrics_avg']}")

    # --------------------------------------------- checkpoint + reshard to 1
    tmp = tempfile.TemporaryDirectory() if mesh is None or mesh.rank == 0 else None
    names = [tmp.name if tmp is not None else None]
    if mesh is not None:
        dist.broadcast_object_list(names, src=0)
    path = Path(names[0]) / "bess_example.pt.npz"
    trainer.save(str(path), step=stats["steps"])
    if mesh is not None:
        dist.barrier()
    one = Sharding.create(ds.n_entity, 1, seed=1)
    p1, _, _, meta = load_checkpoint(path, new_sharding=one)
    print(f"resharded checkpoint to 1 device: table {tuple(p1['entity_embedding'].shape)},"
          f" step {meta['step']}")
    if mesh is not None:
        dist.barrier()
    if tmp is not None:
        tmp.cleanup()
    result = {
        "metric": "toy_kg_filtered_test_mrr",
        "value": round(float(out["metrics_avg"]["mrr"]), 4),
        "unit": "MRR",
        "valid_mrr": round(float(valid_metrics[0]), 4),
        "topk_mrr": round(float(topk_metrics[0]), 4),
        "steps": stats["steps"],
        "shards": n_shard,
        "resharded_table": list(p1["entity_embedding"].shape),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
