"""Independent-implementation quality control for the wikikg2 fixture, in
plain PyTorch (the twin of ``examples/wikikg2_independent_control.py``).

A from-scratch trainer with the published reference recipe's semantics and
none of besskge_tpu_torch's training machinery on its compute path: plain
torch tensors and autograd, dense SGD with momentum, the reference loss.
The only shared code is the fixture builder
(:func:`besskge_tpu_torch.fixtures.build_wikikg2_fixture`, numpy, bit for
bit the JAX package's), the controlled object.

Independent choices, mirroring the reference notebook 3 recipe directly:

* dense fp32 entity/relation tables, single device, no sharding;
* TransE L1 scores ``-||h + r − t||₁`` over micro-batches of 512 split
  "ht" (first half corrupts heads, second half tails);
* 32 uniform random negatives per direction, SHARED across the half-batch,
  augmented with the half-batch's own 256 true entities (288 candidates);
* sampled-softmax cross-entropy with the reference's log-uniform
  correction ``log(n_entity−1) − log(n_neg)``;
* DENSE SGD with momentum 0.95, lr 1e-3 (poptorch semantics: momentum
  decays every step for every row);
* evaluation: MRR vs the fixture's 500 negative heads + 500 negative
  tails, average-tie ranks, computed in numpy.

If this trainer's extraction (MRR / planted-oracle) lands near the port's,
the fixture's calibration, not the framework, sets the plateau.
``--steps-per-call`` groups steps between host reads of the loss.
Deviation: the JAX script prints no JSON line; this one ends with one
(``metric``, ``value``, ``oracle_mrr``) for callers.

    python examples/wikikg2_independent_control_torch.py --scale 0.05 --epochs 70
    python examples/wikikg2_independent_control_torch.py --scale 0.002 --epochs 2 --cpu
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
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--epochs", type=int, default=70)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--momentum", type=float, default=0.95)
    ap.add_argument("--n-negative", type=int, default=32)
    ap.add_argument("--eval-triples", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps-per-call", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from besskge_tpu_torch.fixtures import build_wikikg2_fixture  # data only

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    t0 = time.perf_counter()
    ds, planted = build_wikikg2_fixture(
        seed=args.seed, scale=args.scale, return_planted=True,
        eval_rows=args.eval_triples or None, oracle_sample=4000,
    )
    n_entity, n_rel = ds.n_entity, ds.n_relation_type
    train = np.asarray(ds.triples["train"], np.int32)
    print(
        f"fixture: {n_entity} entities, {len(train)} train triples "
        f"({time.perf_counter() - t0:.1f}s); oracle ≈ "
        f"{planted.oracle_estimate:.4f}",
        flush=True,
    )

    d = 128
    rng = np.random.default_rng(args.seed)
    # notebook init: normal, as in besskge init_KGE_normal (std 1/sqrt(d))
    ent = torch.from_numpy(rng.normal(0.0, d**-0.5, size=(n_entity, d)).astype(np.float32))
    rel = torch.from_numpy(rng.normal(0.0, d**-0.5, size=(n_rel, d)).astype(np.float32))
    ent, rel = ent.to(device).requires_grad_(), rel.to(device).requires_grad_()
    vel_e, vel_r = torch.zeros_like(ent), torch.zeros_like(rel)

    B = 512  # micro-batch; halves of 256 corrupt heads / tails
    H = B // 2
    NN = args.n_negative
    log_corr = float(np.log(n_entity - 1) - np.log(NN + H))

    def half_loss(h_idx, r_idx, t_idx, neg_idx, corrupt_head):
        """(H,) SSCE losses for one corruption direction; candidates = NN
        shared random entities + the half-batch's own true entities on the
        corrupted side (in-batch augmentation)."""
        eh, er, et = ent[h_idx], rel[r_idx], ent[t_idx]
        own = h_idx if corrupt_head else t_idx
        cand = ent[torch.cat([neg_idx, own])]  # (NN+H, d)
        q = et - er if corrupt_head else eh + er
        pos = -(eh + er - et).abs().sum(-1)  # (H,)
        negs = -(q[:, None, :] - cand[None, :, :]).abs().sum(-1)  # (H, NN+H)
        logits = torch.cat([pos[:, None], negs + log_corr], dim=1)
        return -torch.log_softmax(logits, dim=1)[:, 0]

    def step(h, r, t, neg_h, neg_t):
        loss = half_loss(h[:H], r[:H], t[:H], neg_h, True).sum() + half_loss(
            h[H:], r[H:], t[H:], neg_t, False).sum()
        ge, gr = torch.autograd.grad(loss, (ent, rel))
        with torch.no_grad():
            # poptorch SGD(momentum): v <- m v + g ; p <- p − lr v, dense.
            vel_e.mul_(args.momentum).add_(ge)
            vel_r.mul_(args.momentum).add_(gr)
            ent.sub_(args.lr * vel_e)
            rel.sub_(args.lr * vel_r)
        return loss.detach()

    steps_per_epoch = len(train) // B
    spc = args.steps_per_call
    print(
        f"training: {args.epochs} epochs x {steps_per_epoch} steps "
        f"(B={B}, {NN} negatives + {H} in-batch)",
        flush=True,
    )
    t0 = time.perf_counter()
    last = None
    for epoch in range(args.epochs):
        perm = rng.permutation(len(train))[: steps_per_epoch * B]
        ep = torch.from_numpy(train[perm].reshape(steps_per_epoch, B, 3).astype(np.int64))
        negs_h = torch.from_numpy(rng.integers(n_entity, size=(steps_per_epoch, NN)))
        negs_t = torch.from_numpy(rng.integers(n_entity, size=(steps_per_epoch, NN)))
        ep, negs_h, negs_t = ep.to(device), negs_h.to(device), negs_t.to(device)
        for s0 in range(0, steps_per_epoch, spc):
            for s in range(s0, min(s0 + spc, steps_per_epoch)):
                loss = step(ep[s, :, 0], ep[s, :, 1], ep[s, :, 2], negs_h[s], negs_t[s])
            last = float(loss)  # one host read per group of steps
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            print(
                f"  epoch {epoch}: loss/triple {last / B:.4f} "
                f"({time.perf_counter() - t0:.0f}s)",
                flush=True,
            )

    # ------------------------------------------------- numpy evaluation
    ent_np = ent.detach().cpu().numpy()
    rel_np = rel.detach().cpu().numpy()
    valid = np.asarray(ds.triples["valid"], np.int32)
    nh = np.asarray(ds.neg_heads["valid"], np.int32)
    nt = np.asarray(ds.neg_tails["valid"], np.int32)
    if args.eval_triples:
        valid, nh, nt = valid[: args.eval_triples], nh[: args.eval_triples], nt[: args.eval_triples]

    def mrr_block(q, cand, pos):
        """Average-tie reciprocal ranks: q (M, d) queries, cand (M, K, d)
        candidate entities, pos (M,) positive scores."""
        s = -np.abs(q[:, None, :] - cand).sum(-1)
        greater = (s > pos[:, None]).sum(1)
        ties = (s == pos[:, None]).sum(1)
        rank = 1.0 + greater + 0.5 * ties
        return 1.0 / rank

    rr = []
    blk = 2048
    for i in range(0, len(valid), blk):
        v = valid[i : i + blk]
        eh, er, et = ent_np[v[:, 0]], rel_np[v[:, 1]], ent_np[v[:, 2]]
        pos = -np.abs(eh + er - et).sum(-1)
        rr.append(mrr_block(eh + er, ent_np[nt[i : i + blk]], pos))  # tails vs h + r
        rr.append(mrr_block(et - er, ent_np[nh[i : i + blk]], pos))  # heads vs t - r
    mrr = float(np.concatenate(rr).mean())
    print(
        f"independent control: valid MRR {mrr:.4f} over "
        f"{2 * len(valid)} queries (500 candidates each); "
        f"oracle {planted.oracle_estimate:.4f}; extraction "
        f"{100 * mrr / planted.oracle_estimate:.1f}%",
        flush=True,
    )
    result = {"metric": "wikikg2_fixture_independent_control_mrr", "value": round(mrr, 4),
              "unit": "MRR", "oracle_mrr": round(planted.oracle_estimate, 4),
              "epochs": args.epochs, "scale": args.scale}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
