"""ConvE's sparse step on the CPU in fp32 against the same step in float64,
stage by stage and micro-batch by micro-batch.

The ``conve`` phase of ``chip_smoke.py`` holds the card's sparse ConvE step
(RowSGDM interleaved, dropout key CONVE_RNG) against the same step on the
CPU in float64. This script runs that step on the CPU only, from one state
copied to fp32 and to float64, and prints how far the fp32 run strays from
the float64 one, as the largest |fp32 − float64| over the largest
|float64| of each array:

* each micro-batch run alone through autograd, in the order the step
  computes it: the trunk's conv, bn1 (the first ReLU's input), the FC, bn2
  (the second ReLU's input), the scores, the loss, then the backward's
  gradients at the FC's and the conv's outputs, the gathered rows'
  gradients and each trunk param's gradient; with the number of ReLU
  inputs whose sign differs between the two runs, and how far the
  gradient at each BN's input is from summing to 0 over the batch, per
  channel, over its largest value (train-mode BN's does, exactly);
* each micro-batch's trunk gradients as the step computes them (one
  ``torch.func.vmap`` over the micro-batches), and their sum;
* after the whole step, each momentum and each param.

``parting`` lists, in that order, the stages (outside CONVE_NOISE) whose
stray passes PARTING in any micro-batch, with those micro-batches. States: drawn on the CPU, and on the card when
there is one: the first draw from a generator seeded SEED, and the second
(what the ``conve`` phase's sparse step draws when the phase runs alone:
its dense step draws first). One JSON line per state.

    python3 tools/conve_cpu_stray.py [--threads N]
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from besskge_tpu_torch import optim, packed, trainer  # noqa: E402

#: A stray past this (relative to the array's largest value) is more than
#: fp32 rounding through a few stages.
PARTING = 1e-5

FORWARD = ("conv", "bn1", "fc", "bn2", "positive_score", "negative_score", "loss")
BACKWARD = ("d_fc", "d_conv", "row_grads")


def _micro_batch(module, params: dict, mb: dict, table: torch.Tensor, rng) -> dict:
    """One micro-batch of the sparse step through autograd, apart from the
    step: the trunk's stages (of each trunk call), its scores and loss, the
    gradients at the FC's and the conv's outputs, the gathered rows' and
    the trunk params' gradients."""
    score_fn = module.score_fn
    rec: dict = {"conv": [], "bn1": [], "fc": [], "bn2": [], "bn1_in": [], "bn2_in": []}
    conv, fc, bn = score_fn._conv, score_fn._fc, score_fn._bn

    def keep(name, x):
        if x.requires_grad:
            x.retain_grad()
        rec[name].append(x)
        return x

    def bn_rec(x, stats, train):
        name = {id(other["bn1"]): "bn1", id(other["bn2"]): "bn2"}.get(id(stats))
        if name is None:
            return bn(x, stats, train)
        return keep(name, bn(keep(f"{name}_in", x), stats, train))

    score_fn._conv = lambda p, x: keep("conv", conv(p, x))
    score_fn._fc = lambda p, x: keep("fc", fc(p, x))
    score_fn._bn = bn_rec
    idx = module.gather_plan(mb["head"], mb["tail"], mb["negative"])
    gathered = packed.take_rows(table, idx, n_logical=module.sharding.max_entity_per_shard)
    gathered.requires_grad_(True)
    other = {k: c._tree_map(lambda v: v.detach().requires_grad_(v.is_floating_point()), v)
             for k, v in params.items() if k != "entity_embedding"}
    local = dict(other, entity_embedding=table)
    try:
        module.return_scores = True
        out = module.forward(local, train=True, rng=rng, gathered_emb=gathered, **mb)
        out["loss"].backward()
    finally:
        del score_fn._conv, score_fn._fc, score_fn._bn
        module.return_scores = False
    cat = lambda xs: torch.cat([x.detach().reshape(-1) for x in xs])  # noqa: E731
    got = {k: cat(rec[k]) for k in ("conv", "bn1", "fc", "bn2")}
    got.update(positive_score=out["positive_score"].detach(),
               negative_score=out["negative_score"].detach(),
               loss=out["loss"].detach().reshape(1),
               d_fc=cat([x.grad for x in rec["fc"]]), d_conv=cat([x.grad for x in rec["conv"]]),
               row_grads=gathered.grad)
    # Train-mode BN's input gradient sums to 0 over the batch (per channel).
    got["zero_sums"] = {k: max(x.grad.sum(c.ConvE._axes(x)[0]).abs().max().item()
                               / x.grad.abs().max().item() for x in rec[k])
                        for k in ("bn1_in", "bn2_in")}
    got["relu_inputs"] = {k: [x.detach() for x in rec[k]] for k in ("bn1", "bn2")}
    got["trunk"] = {name: v.grad for name, v in trainer._leaves(other) if v.grad is not None}
    return got


def _vmapped(module, params: dict, mbs: dict, table: torch.Tensor, rngs) -> dict:
    """The trunk params' gradients of each micro-batch as the one-device
    sparse step computes them (``torch.func.vmap`` over the micro-batches
    of ``torch.func.vjp``), stacked."""
    other = {k: v for k, v in params.items() if k != "entity_embedding"}
    idx = torch.func.vmap(module.gather_plan)(mbs["head"], mbs["tail"], mbs["negative"])
    gathered = packed.take_rows(table, idx, n_logical=module.sharding.max_entity_per_shard)

    def mb_fn(mb, g_mb, rng):
        def f(g, o):
            out = module.forward(dict(o, entity_embedding=table), train=True, rng=rng,
                                 gathered_emb=g, **mb)
            return out["loss"], out
        _, vjp_fn, _ = torch.func.vjp(f, g_mb, other, has_aux=True)
        return vjp_fn(torch.ones((), dtype=torch.float32))[1]

    return dict(trainer._leaves(torch.func.vmap(mb_fn)(mbs, gathered, rngs)))


def run(drawn_on: str, draw: int) -> dict:
    sharding = c.Sharding.create(c.YAGO_ENTITY, 1, seed=c.SEED)
    score_fn = c._conve_fn(sharding)
    rng = np.random.default_rng(c.SEED)
    triples = np.stack([rng.integers(c.YAGO_ENTITY, size=c.YAGO_TRIPLE),
                        rng.integers(c.YAGO_RELATION, size=c.YAGO_TRIPLE),
                        rng.integers(c.YAGO_ENTITY, size=c.YAGO_TRIPLE)], 1).astype(np.int32)
    module, pts = c._conve_module(triples, sharding, score_fn)
    host = c.RigidShardedBatchSampler(pts, module.negative_sampler, shard_bs=c.CONVE_SHARD_BS,
                                      batches_per_step=c.CONVE_BPS, seed=c.SEED)
    batch = host.sample_batch(next(iter(host.epoch_index_blocks(shuffle=True))))
    gen = torch.Generator(drawn_on).manual_seed(c.SEED)
    for _ in range(draw):
        params = score_fn.initial_params_device(device=drawn_on, generator=gen)
    params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
    sgd = optim.SGD(c.CONVE_LR, momentum=c.MOMENTUM)
    row = optim.RowSGDM(c.CONVE_LR, momentum=c.MOMENTUM, interleaved=True)
    state = trainer.init_optimizer_state(sgd, params, None, row,
                                         n_logical=sharding.max_entity_per_shard)
    dtypes = (torch.float32, torch.float64)
    sides = {dtype: tuple(c._tree_map(
        lambda v: v.to("cpu", dtype if v.is_floating_point() else v.dtype, copy=True), t)
        for t in (params, state)) for dtype in dtypes}
    mbs = {k: torch.from_numpy(np.ascontiguousarray(v[:, 0])) for k, v in batch.items()
           if k in c._FORWARD_KEYS}
    rngs = c.split_key(torch.tensor(c.CONVE_RNG, dtype=torch.int64), c.CONVE_BPS)
    out = {"drawn_on": drawn_on, "draw": draw, "micro_batches": []}
    for i in range(c.CONVE_BPS):
        mb = {k: v[i] for k, v in mbs.items()}
        got = {d: _micro_batch(module, sides[d][0], mb, sides[d][0]["entity_embedding"], rngs[i])
               for d in dtypes}
        g, w = got[torch.float32], got[torch.float64]
        one = {k: c._rel_stray(g[k], w[k]) for k in FORWARD + BACKWARD}
        one.update({f"trunk.{k}": c._rel_stray(g["trunk"][k], v) for k, v in w["trunk"].items()})
        one["relu_sign_flips"] = {k: sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(
            g["relu_inputs"][k], w["relu_inputs"][k])) for k in ("bn1", "bn2")}
        one["zero_sums"] = {"fp32": g["zero_sums"], "float64": w["zero_sums"]}
        out["micro_batches"].append(one)
    vm = {d: _vmapped(module, sides[d][0], mbs, sides[d][0]["entity_embedding"], rngs)
          for d in dtypes}
    out["vmapped_trunk"] = {k: [c._rel_stray(vm[torch.float32][k][i], w[i])
                                for i in range(c.CONVE_BPS)]
                            for k, w in vm[torch.float64].items()}
    out["summed_trunk"] = {k: c._rel_stray(vm[torch.float32][k].sum(0), w.sum(0))
                           for k, w in vm[torch.float64].items()}
    step = trainer.build_train_step(module, sgd, None, row, device="cpu")
    after = {d: step(*sides[d], batch, c.CONVE_RNG)[:2] for d in dtypes}
    g_m = dict(trainer._leaves(after[torch.float32][1]["other"]["trace"]))
    out["momentum"] = {k: c._rel_stray(g_m[k], w) for k, w in
                       trainer._leaves(after[torch.float64][1]["other"]["trace"])}
    ent = [after[d][0]["entity_embedding"] for d in dtypes]
    out["entity_momentum"] = c._rel_stray(ent[0][1::2], ent[1][1::2])
    out["momentum_max_outside_noise"] = max(v for k, v in out["momentum"].items()
                                            if k not in c.CONVE_NOISE)
    order = list(FORWARD + BACKWARD) + [k for k in out["micro_batches"][0] if
                                        k.startswith("trunk.")]
    out["parting"] = [
        {"stage": k, "micro_batches": [i for i, mb in enumerate(out["micro_batches"])
                                       if mb[k] > PARTING],
         "stray": max(mb[k] for mb in out["micro_batches"])} for k in order
        if k.removeprefix("trunk.") not in c.CONVE_NOISE
        and max(mb[k] for mb in out["micro_batches"]) > PARTING]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", type=int, default=None)
    args = parser.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    cpu = next((line.split(":", 1)[1].strip() for line in Path("/proc/cpuinfo").read_text()
                .splitlines() if line.startswith("model name")), platform.processor())
    print(json.dumps({"torch": torch.__version__, "threads": torch.get_num_threads(),
                      "cpu": cpu, "mkldnn": torch.backends.mkldnn.is_available()}), flush=True)
    states = [("cpu", 1)] + ([("cuda", 1), ("cuda", 2)] if torch.cuda.is_available() else [])
    for drawn_on, draw in states:
        print(json.dumps(run(drawn_on, draw)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
