"""Downstream-quality parity run through the PyTorch/CUDA port: the
reference's ogbl-biokg recipe (the twin of ``examples/biokg_parity.py``).

RotatE d=64 (L1), LogSigmoid loss margin 12 with self-adversarial
weighting, random "ht" negatives with sample sharing, shard_bs 240, 48
micro-batches/step, AdamW lr 1e-3, 25 epochs; then ScoreMoving validation
against the official 500 negative heads + 500 negative tails per triple
(duplicate_batch, sharing off), reporting MRR / Hits@1 / Hits@5 / Hits@10.
The reference bar: MRR 0.818, H@10 0.942.

Data: with ``--real DIR`` the real ogbl-biokg is loaded through
:meth:`besskge_tpu_torch.dataset.KGDataset.build_ogbl_biokg` (needs the OGB
files). By default the run uses the deterministic re-distribution fixture
(:func:`besskge_tpu_torch.fixtures.build_biokg_fixture`: biokg's published
statistics around a planted RotatE), cached under
``<checkout>/.fixture_cache/torch/``, and reports the trained metrics next
to the planted model's oracle ceiling: a recipe or convention fault shows
as a trained-vs-oracle gap.

On the card the fixture's scans run B5, the training step's distances B1
and B2, the oracle's ranks a gather on the card. One shard, or one per rank
under ``torchrun`` (``parallel.multihost.initialize``); fewer shards take
proportionally more random negatives per shard (n_negative = 4 / n_shard).

    python examples/biokg_parity_torch.py                  # full, on the card
    python examples/biokg_parity_torch.py --scale 0.02 --epochs 8 --cpu
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: Where the fixture is cached: the port's own draws, apart from the JAX
#: package's files of the same name.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".fixture_cache" / "torch"


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


def lr_schedule(args, total_steps: int):
    """The peak rate, or the schedule ``--lr-decay``/``--warmup`` ask for."""
    from besskge_tpu_torch import schedules

    if args.lr_decay:
        if args.warmup:
            return schedules.warmup_cosine_decay_schedule(
                0.0, args.lr, args.warmup, total_steps, end_value=0.05 * args.lr)
        return schedules.cosine_decay_schedule(args.lr, total_steps, alpha=0.05)
    if args.warmup:
        return schedules.warmup_constant_schedule(0.0, args.lr, args.warmup)
    return args.lr


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", default=None, metavar="DIR",
                    help="load real ogbl-biokg from DIR (needs ogb)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fixture shrink factor (1.0 = published sizes)")
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--bps", type=int, default=48, metavar="N",
                    help="micro-batches per optimizer update (the notebook's"
                         " cadence on n_shard=1 is 24)")
    ap.add_argument("--eval-triples", type=int, default=0,
                    help="cap on validation triples (0 = all)")
    ap.add_argument("--oracle-sample", type=int, default=2000,
                    help="triples for the planted-oracle MRR estimate")
    ap.add_argument("--lr-decay", action="store_true",
                    help="cosine-decay the learning rate over the run")
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="peak learning rate (notebook: AdamW 1e-3)")
    ap.add_argument("--warmup", type=int, default=0, metavar="STEPS",
                    help="linear lr warmup over this many steps")
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="self-adversarial negative-weighting scale")
    ap.add_argument("--margin", type=float, default=12.0,
                    help="LogSigmoid margin (notebook: 12)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    import numpy as np

    from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler
    from besskge_tpu_torch.bess import EmbeddingMovingBessKGE, ScoreMovingBessKGE
    from besskge_tpu_torch.eval_loop import run_device_eval
    from besskge_tpu_torch.loss import LogSigmoidLoss
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import (
        RandomShardedNegativeSampler,
        TripleBasedShardedNegativeSampler,
    )
    from besskge_tpu_torch.optim import AdamW
    from besskge_tpu_torch.scoring import RotatE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
    from besskge_tpu_torch.trainer import Trainer
    from besskge_tpu_torch.utils import resolve_device

    device = str(resolve_device("cpu" if args.cpu else None))
    seed = 42
    planted = None
    if args.real:
        from besskge_tpu_torch.dataset import KGDataset

        ds = KGDataset.build_ogbl_biokg(Path(args.real))
        print("loaded real ogbl-biokg")
    else:
        from besskge_tpu_torch.fixtures import build_biokg_fixture

        t0 = time.perf_counter()
        ds, planted = build_biokg_fixture(
            seed=seed, scale=args.scale, return_planted=True, cache_dir=str(CACHE_DIR),
            device=device,
        )
        print(
            f"fixture: {ds.n_entity} entities, "
            f"{ {p: len(v) for p, v in ds.triples.items()} } triples "
            f"({time.perf_counter() - t0:.1f}s to generate)"
        )

    mesh = shard_mesh(device)
    n_shard = 1 if mesh is None else mesh.n_shard
    axis = None if mesh is None else "shard"
    sharding = Sharding.create(ds.n_entity, n_shard, seed=seed)
    train_pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)

    # ---------------------------------------------------------------- train
    score_fn = RotatE(
        negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=64, seed=seed,
    )
    ns = RandomShardedNegativeSampler(
        max(1, 4 // n_shard), sharding, seed, "ht",
        local_sampling=False, flat_negative_format=False,
    )
    bs = RigidShardedBatchSampler(train_pts, ns, shard_bs=240, batches_per_step=args.bps,
                                  seed=seed)
    bess = EmbeddingMovingBessKGE(
        negative_sampler=ns,
        score_fn=score_fn,
        loss_fn=LogSigmoidLoss(
            margin=args.margin, negative_adversarial_sampling=True,
            negative_adversarial_scale=args.alpha,
        ),
        axis_name=axis,
    )
    # torch/poptorch AdamW defaults (weight_decay=0.01), as in the notebook.
    total_steps = args.epochs * max(1, len(ds.triples["train"]) // (args.bps * n_shard * 240))
    lr = lr_schedule(args, total_steps)
    trainer = Trainer(bess, bs, AdamW(lr, weight_decay=0.01), mesh=mesh, seed=seed,
                      device=None if mesh is not None else device)
    stats = trainer.fit(n_epochs=args.epochs, log_every=100)
    print(
        f"train: {stats['steps']} steps, {stats['triples_per_s']:.0f} pos"
        f" triples/s, final loss/triple "
        f"{stats['final_loss'] / (args.bps * n_shard * 240):.4f}"
    )
    params = trainer.params

    # --------------------------- validation vs official 500+500 negatives
    valid_tri = ds.triples["valid"]
    if args.eval_triples:
        for d in (ds.triples, ds.neg_heads, ds.neg_tails):
            d["valid"] = d["valid"][: args.eval_triples]
        valid_tri = ds.triples["valid"]
    valid_pts = PartitionedTripleSet.create_from_dataset(ds, "valid", sharding)
    val_ns = TripleBasedShardedNegativeSampler(
        valid_pts.neg_heads, valid_pts.neg_tails, sharding, corruption_scheme="ht", seed=seed,
    )
    val_bs = RigidShardedBatchSampler(valid_pts, val_ns, shard_bs=240, batches_per_step=10,
                                      seed=seed, duplicate_batch=True)
    val_score_fn = RotatE(
        negative_sample_sharing=False, scoring_norm=1, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=64,
    )
    evaluator = Evaluation(["mrr", "hits@1", "hits@5", "hits@10"], reduction="sum")
    val_bess = ScoreMovingBessKGE(negative_sampler=val_ns, score_fn=val_score_fn,
                                  evaluation=evaluator, axis_name=axis)
    t0 = time.perf_counter()
    metrics, n_queries = run_device_eval(val_bess, params, val_bs, mesh=mesh, steps_per_block=16,
                                         device=None if mesh is not None else device)
    eval_s = time.perf_counter() - t0
    print(
        f"valid ({n_queries} queries, official-style 500+500 negatives,"
        f" {eval_s:.1f}s): "
        + "  ".join(f"{k} {v:.4f}" for k, v in metrics.items())
    )

    # ----------------------------------- oracle ceiling (fixture runs only)
    oracle = None
    if planted is not None and args.oracle_sample:
        n = min(args.oracle_sample, len(valid_tri))
        rk_t = planted.rank_against(valid_tri[:n], ds.neg_tails["valid"][:n], "t")
        rk_h = planted.rank_against(valid_tri[:n], ds.neg_heads["valid"][:n], "h")
        oracle = float(np.concatenate([1.0 / rk_t, 1.0 / rk_h]).mean())
        print(f"planted-oracle MRR ({n} triples): {oracle:.4f}")

    result = {
        "metric": "biokg_fixture_valid_mrr" if planted else "biokg_valid_mrr",
        "value": round(float(metrics["mrr"]), 4),
        "unit": "MRR",
        "hits@10": round(float(metrics["hits@10"]), 4),
        "oracle_mrr": None if oracle is None else round(oracle, 4),
        "reference_bar": 0.818,
        "epochs": args.epochs,
        "scale": args.scale,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
