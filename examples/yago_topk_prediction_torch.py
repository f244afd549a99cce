"""Knowledge-graph completion with top-k prediction through the PyTorch/CUDA
port (the twin of ``examples/yago_topk_prediction.py``).

The reference notebook trains ComplEx on YAGO3-10 with interleaved
validation, then runs ``TopKQueryBessKGE`` inference and a scaling analysis
(re-sharding the trained table to a different device count). This script
follows the same storyline:

1. shard the entity table and partition the triples;
2. train ComplEx + LogSigmoid/adversarial with in-loop validation via
   ``Trainer.fit(valid_fn=...)``;
3. top-k inference with ``TopKQueryBessKGE`` (each window scored against
   every entity), with metrics against the known tails and a sample of
   readable predictions;
4. scaling analysis: ``score_fn.update_sharding`` re-shards the TRAINED
   table to a new shard count and back onto a new one-shard layout, and
   inference is rebuilt unchanged.

Data: ``--real DIR`` loads actual YAGO3-10
(:meth:`besskge_tpu_torch.dataset.KGDataset.build_yago310`, needs the
files). Offline (the default) a YAGO-shaped synthetic graph: each relation
is a cyclic translation of entity IDs, so completion is learnable and the
top-k output is interpretable.

Deviations: one shard in one process where the JAX script runs four on a
mesh (a process serves one shard; ``train_and_evaluate_torch.py`` shows
the ``torchrun`` mesh), so step 4 re-shards 1 -> 2 -> 1 (a new
permutation) on the host and serves the result on one shard; ``--cpu``
runs on the CPU; ``main(argv)`` returns the final metrics.

Run:  python examples/yago_topk_prediction_torch.py --cpu --entities 2000 --epochs 8
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def make_yago_like(n_entity: int, n_relation: int, n_triple: int, seed: int):
    """Structured KG where each relation is a cyclic translation of entity
    IDs, ``t = (h + b_r) mod N``: functional (one true tail per query) and
    exactly representable by diagonal-bilinear scorers."""
    rng = np.random.default_rng(seed)
    b = rng.integers(1, n_entity, size=n_relation)
    h = rng.integers(n_entity, size=n_triple)
    r = rng.integers(n_relation, size=n_triple)
    t = (h + b[r]) % n_entity
    triples = np.stack([h, r, t], 1).astype(np.int32)
    labels = [f"entity_{i:04d}" for i in range(n_entity)]
    return triples, labels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", default=None, metavar="DIR",
                    help="load real YAGO3-10 from DIR (needs the files)")
    ap.add_argument("--entities", type=int, default=2000)
    ap.add_argument("--triples", type=int, default=80_000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--relations", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--eval-queries", type=int, default=512)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler
    from besskge_tpu_torch.bess import (
        EmbeddingMovingBessKGE,
        TopKQueryBessKGE,
        build_topk_forward,
    )
    from besskge_tpu_torch.dataset import KGDataset
    from besskge_tpu_torch.loss import LogSigmoidLoss
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import (
        PlaceholderNegativeSampler,
        RandomShardedNegativeSampler,
    )
    from besskge_tpu_torch.optim import AdamW
    from besskge_tpu_torch.scoring import ComplEx
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
    from besskge_tpu_torch.trainer import Trainer
    from besskge_tpu_torch.utils import resolve_device

    device = str(resolve_device("cpu" if args.cpu else None))
    seed = 12345
    if args.real:
        ds = KGDataset.build_yago310(Path(args.real))
        labels = ds.entity_dict
    else:
        triples, labels = make_yago_like(args.entities, args.relations, args.triples, seed)
        rng = np.random.default_rng(seed)
        part = rng.choice(3, p=(0.9, 0.05, 0.05), size=len(triples))
        ds = KGDataset(
            n_entity=args.entities,
            n_relation_type=args.relations,
            entity_dict=labels,
            relation_dict=[f"rel{i}" for i in range(args.relations)],
            type_offsets=None,
            triples={name: triples[part == i] for i, name in enumerate(("train", "valid", "test"))},
            original_triple_ids={
                name: np.arange((part == i).sum(), dtype=np.int64)
                for i, name in enumerate(("train", "valid", "test"))
            },
            neg_heads=None,
            neg_tails=None,
        )
    print(f"dataset: {ds.n_entity} entities, "
          f"{ {p: len(v) for p, v in ds.triples.items()} }")

    # ---- 1. sharding + triple partition ------------------------------------
    n_shard = 1
    sharding = Sharding.create(ds.n_entity, n_shard, seed=seed)
    train_pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)

    # ---- 2. training with interleaved validation ---------------------------
    score_fn = ComplEx(
        negative_sample_sharing=True, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=64, seed=seed,
    )
    ns = RandomShardedNegativeSampler(8, sharding, seed, "ht", local_sampling=False,
                                      flat_negative_format=True)
    bs = RigidShardedBatchSampler(train_pts, ns, shard_bs=120, batches_per_step=8, seed=seed)
    bess = EmbeddingMovingBessKGE(
        negative_sampler=ns,
        score_fn=score_fn,
        # The notebook's margin-12 recipe suits YAGO3-10's scale; the small
        # synthetic graph trains stably with a gentler margin.
        loss_fn=LogSigmoidLoss(margin=12.0 if args.real else 6.0,
                               negative_adversarial_sampling=True),
    )
    trainer = Trainer(bess, bs, AdamW(1e-3 if args.real else 3e-3), seed=seed, device=device)

    # In-loop tail-MRR validation on a query sample.
    vq = ds.triples["valid"][: args.eval_queries]
    topk_eval = Evaluation(["mrr", "hits@3", "hits@10"], worst_rank_infty=True, reduction="sum")

    def make_topk(sc_fn, shd, window=256):
        pns = PlaceholderNegativeSampler(corruption_scheme="t", seed=seed)
        pts = PartitionedTripleSet.create_from_queries(
            ds, shd, np.stack([vq[:, 0], vq[:, 1]], 1).astype(np.int32),
            "hr", ground_truth=vq[:, 2].astype(np.int32),
        )
        qbs = RigidShardedBatchSampler(pts, pns, shard_bs=64, batches_per_step=2, seed=seed,
                                       return_triple_idx=True)
        topk = TopKQueryBessKGE(k=args.k, candidate_sampler=pns, score_fn=sc_fn,
                                evaluation=topk_eval, return_scores=True, window_size=window)
        return pts, qbs, build_topk_forward(topk, device=device)

    val_pts, val_bs, val_fwd = make_topk(score_fn, sharding)

    def run_topk(params, collect=None):
        totals = np.zeros(len(topk_eval.metrics))
        n_q = 0
        for batch in val_bs.get_dataloader(shuffle=False):
            out = val_fwd(params, batch)
            m = out["metrics"].cpu().numpy().astype(np.float64)
            totals += m.reshape(-1, len(topk_eval.metrics)).sum(0)
            n_q += int(batch["triple_mask"].sum())
            if collect is not None:
                collect(batch, out)
        return dict(zip(topk_eval.metrics.keys(), totals / n_q))

    stats = trainer.fit(n_epochs=args.epochs, valid_fn=run_topk,
                        valid_every=max(1, args.epochs // 3))
    for h in (h for h in trainer.history if "valid" in h):
        print(f"epoch {h['epoch']}: " + "  ".join(f"{k} {v:.4f}" for k, v in h["valid"].items()))
    print(f"train: {stats['steps']} steps, {stats['triples_per_s']:.0f} pos triples/s")

    # ---- 3. final top-k inference + readable predictions -------------------
    t0 = time.perf_counter()
    predictions = {}

    def collect(batch, out):
        ids = out["topk_global_id"].cpu().numpy().reshape(-1, args.k)
        mask = np.asarray(batch["triple_mask"]).reshape(-1)
        tidx = np.asarray(batch["triple_idx"]).reshape(-1)
        orig = val_pts.triple_sort_idx[tidx[mask]]
        for q, row in zip(orig, ids[mask]):
            predictions[int(q)] = row

    metrics = run_topk(trainer.params, collect)
    dt = time.perf_counter() - t0
    print(f"top-{args.k} inference over {len(vq)} (h, r, ?) queries on "
          f"{n_shard} shard: {dt:.1f}s — "
          + "  ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    for q in list(predictions)[:3]:
        h, r, t = vq[q]
        names = [labels[i] for i in predictions[q][:5]]
        hit = "HIT" if t in predictions[q] else "miss"
        print(f"  ({labels[h]}, rel{r}, ?) -> true {labels[t]} [{hit}]; top-5: {names}")

    # ---- 4. scaling analysis: re-shard the trained table -------------------
    def complex_on(shd):
        return ComplEx(negative_sample_sharing=True, sharding=shd,
                       n_relation_type=ds.n_relation_type, embedding_size=64, seed=seed)

    two = Sharding.create(ds.n_entity, 2, seed=seed + 1)
    on_two = score_fn.update_sharding(dict(trainer.params), two)
    new_sharding = Sharding.create(ds.n_entity, 1, seed=seed + 2)
    new_params = complex_on(two).update_sharding(on_two, new_sharding)
    _, val_bs, val_fwd = make_topk(complex_on(new_sharding), new_sharding)
    t0 = time.perf_counter()
    metrics2 = run_topk(new_params)
    print(f"re-sharded 1 -> 2 -> 1 shards: {time.perf_counter() - t0:.1f}s — "
          + "  ".join(f"{k} {v:.4f}" for k, v in metrics2.items()))
    assert abs(metrics2["mrr"] - metrics["mrr"]) < 1e-3, "re-sharding must not change predictions"
    print("re-sharding parity: OK")
    return {"metrics": metrics, "resharded": metrics2, "steps": stats["steps"]}


if __name__ == "__main__":
    main()
