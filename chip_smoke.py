#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its top-k serving path on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, one line each with its elapsed seconds:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``besskge_tpu_torch/csrc`` source, one ``nvcc`` each, in
   parallel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shape, a ragged shape and a shape with a wholly invalid
   128-column chunk, in fp32 and bf16; times of the kernel, the plain
   version, one PyTorch library call, and the card's bound;
4. serving: ``build_topk_forward`` of TransE-L1 at ogbl-wikikg2 width
   (2,500,604 entities, 535 relation types, d = 128, 512 queries per batch,
   k = 10) once with the chunk merge (B7) and once with the sort merge (B5),
   launch counts set to 0 before and read after each; MRR of planted
   answers, and the top-10 of 32 queries against a plain full-table
   reference.

Then one JSON line describing each kernel, and the result line. Any failed
check raises, so the script exits non-zero and prints no result; so it does
when no CUDA card is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from besskge_tpu_torch import _build  # noqa: E402
from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler  # noqa: E402
from besskge_tpu_torch.bess import TopKQueryBessKGE, build_topk_forward  # noqa: E402
from besskge_tpu_torch.dataset import KGDataset  # noqa: E402
from besskge_tpu_torch.metric import Evaluation  # noqa: E402
from besskge_tpu_torch.negative_sampler import PlaceholderNegativeSampler  # noqa: E402
from besskge_tpu_torch.ops import l1_kernels  # noqa: E402
from besskge_tpu_torch.scoring import TransE  # noqa: E402
from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding  # noqa: E402

# Serving configuration: ogbl-wikikg2's entity and relation counts on one
# shard, the width of benchmarks/bench_topk.py --model transe-l1.
N_ENTITY, N_RELATION, DIM = 2_500_604, 535, 128
N_QUERY, SHARD_BS, K = 2048, 512, 10
N_REFERENCE = 32
SEED = 0

# Kernel-vs-plain tolerance: fp32 sums of 128 terms in another order.
RTOL, ATOL = 1e-5, 1e-4
# B5 stores bf16 for bf16 inputs: an fp32 sum that differs in its last bits
# may round to the neighbouring bf16 value, at most 2^-7 of the value.
BF16_ULP = 2.0**-7

# H100 SXM peaks (NVIDIA data sheet, at 700 W): 67 TFLOP/s fp32 on
# the CUDA cores counts an FMA as two operations, so the card issues 33.5e12
# fp32 instructions/s; 3.35 TB/s of HBM.
FP32_INSTR_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12

B7_SOURCE = "besskge_tpu_torch/csrc/l1_distance.cu"
KERNELS = {
    "l1_scores_chunkmax": {
        "id": "B7",
        "replaces": "besskge_tpu/ops/pallas_distance.py:153",
        "wrapper": l1_kernels.l1_scores_chunkmax,
    },
    "l1_distance_matrix": {
        "id": "B5",
        "replaces": "besskge_tpu/ops/pallas_distance.py:89",
        "wrapper": l1_kernels.l1_distance_matrix,
    },
}

_T0 = time.perf_counter()


def say(phase: str, text: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {phase}: {text}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(B: int, N: int, d: int, in_bytes: int, out_bytes: int) -> tuple:
    """Least time for a (B, N, d) L1 problem: 2 fp32 instructions (subtract,
    add of |.|) per (i, j, k) at the instruction rate, or every input read
    and every output written once at the HBM rate, whichever is larger."""
    ops_ms = 2.0 * B * N * d / FP32_INSTR_PER_S * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def uniform(shape, gen, d):
    return (torch.rand(shape, device="cuda", generator=gen) * 2 - 1) / d


def check_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version; times at the serving shape."""
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    serving = (SHARD_BS, 131072, DIM)
    for B, N, d in [serving, (3, 256, 100), (64, 1024, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            a = uniform((B, d), gen, d).to(dtype)
            b = uniform((N, d), gen, d).to(dtype)
            valid = torch.rand(N, device="cuda", generator=gen) > 0.2
            valid[128:256] = False  # a wholly invalid chunk
            s, cmax = l1_kernels.l1_scores_chunkmax(a, b, valid)
            torch.cuda.synchronize()
            s_ref, cmax_ref = l1_kernels.l1_scores_chunkmax_plain(a, b, valid)
            err7 = max((s - s_ref).abs().max().item(), (cmax - cmax_ref).abs().max().item())
            # Masked scores sit near `bad` = -5e4, where one fp32 ulp is 0.0039.
            err7_valid = (s - s_ref)[:, valid].abs().max().item()
            torch.testing.assert_close(s, s_ref, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(cmax, cmax_ref, rtol=RTOL, atol=ATOL)
            if not torch.equal(cmax, s.reshape(B, -1, 128).amax(-1)):
                raise AssertionError("B7 chunk maxima differ from the maxima of its own scores")
            if not (cmax[:, 1] < -40000.0).all():
                raise AssertionError("B7: the invalid chunk's maximum is not the sentinel")

            dist = l1_kernels.l1_distance_matrix(a, b)
            torch.cuda.synchronize()
            dist_ref = l1_kernels.l1_distance_matrix_plain(a, b).float()
            err5_all = (dist.float() - dist_ref).abs()
            tol = ATOL + RTOL * dist_ref.abs()
            if dtype == torch.bfloat16:
                tol = tol + BF16_ULP * dist_ref.abs()
            if not (err5_all <= tol).all():
                raise AssertionError(f"B5 off its plain version by {err5_all.max().item()}")
            err5 = err5_all.max().item()
            results["l1_scores_chunkmax"]["max_abs_err"] = max(
                results["l1_scores_chunkmax"]["max_abs_err"], err7)
            results["l1_distance_matrix"]["max_abs_err"] = max(
                results["l1_distance_matrix"]["max_abs_err"], err5)
            say("kernels", f"B={B} N={N} d={d} {str(dtype)[6:]}: B7 max|err| {err7:.3g}"
                f" ({err7_valid:.3g} on valid columns), cmax exact; B5 max|err| {err5:.3g}")
            if (B, N, d) == serving and dtype == torch.float32:
                a32 = a.float()
                results["l1_scores_chunkmax"].update(
                    ms=cuda_ms(lambda: l1_kernels.l1_scores_chunkmax(a, b, valid), 20),
                    plain_ms=cuda_ms(lambda: l1_kernels.l1_scores_chunkmax_plain(a, b, valid), 3),
                    library_ms=cuda_ms(lambda: library_chunkmax(a32, b, valid), 3),
                )
                results["l1_distance_matrix"].update(
                    ms=cuda_ms(lambda: l1_kernels.l1_distance_matrix(a, b), 20),
                    plain_ms=cuda_ms(lambda: l1_kernels.l1_distance_matrix_plain(a, b), 3),
                    library_ms=cuda_ms(lambda: torch.cdist(a32, b, p=1), 3),
                )
                in_bytes = (B + N) * d * 4
                results["l1_scores_chunkmax"]["bound"] = bound_ms(
                    B, N, d, in_bytes + N, B * N * 4 + B * (N // 128) * 4)
                results["l1_distance_matrix"]["bound"] = bound_ms(
                    B, N, d, in_bytes, B * N * 4)
                for name, r in results.items():
                    say("kernels", f"{name} at {B}x{N}x{d} fp32: kernel {r['ms']:.3f} ms,"
                        f" plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms,"
                        f" bound {r['bound'][0]:.3f} ms ({r['bound'][1]})")
    return results


def library_chunkmax(a, b, valid):
    """One library distance call plus the mask and the chunk maxima: the
    yardstick for B7 (never used by the port)."""
    s = -torch.cdist(a, b, p=1) + -50000.0 * (~valid).float()
    return s, s.reshape(s.shape[0], -1, 128).amax(-1)


def serving(gen: torch.Generator, device: str = "cuda") -> dict:
    """Drive build_topk_forward at full width with both merges."""
    t = time.perf_counter()
    sharding = Sharding.create(N_ENTITY, 1, seed=SEED)
    score_fn = TransE(True, 1, sharding, N_RELATION, DIM, seed=SEED)
    params = score_fn.initial_params_device(device=device, generator=gen)
    table, rel_table = params["entity_embedding"], params["relation_embedding"]
    rng = np.random.default_rng(SEED)
    ents = rng.choice(N_ENTITY, size=2 * N_QUERY, replace=False).astype(np.int32)
    heads, tails = ents[:N_QUERY], ents[N_QUERY:]
    rels = rng.integers(N_RELATION, size=N_QUERY).astype(np.int32)
    # Plant each query's answer: tail row = head row + relation row, so the
    # tail scores exactly 0, above every other entity.
    def rows(ids):
        return torch.from_numpy(ids.astype(np.int64)).to(device)

    entity_to_idx = sharding.entity_to_idx
    table[rows(entity_to_idx[tails])] = table[rows(entity_to_idx[heads])] + rel_table[rows(rels)]
    dataset = KGDataset(
        n_entity=N_ENTITY, n_relation_type=N_RELATION,
        triples={"test": np.zeros((1, 3), np.int32)},
        original_triple_ids={"test": np.arange(1)},
    )
    pts = PartitionedTripleSet.create_from_queries(
        dataset, sharding, np.stack([heads, rels], 1), "hr", ground_truth=tails
    )
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=SEED)
    sampler = RigidShardedBatchSampler(
        pts, ns, shard_bs=SHARD_BS, batches_per_step=1, seed=SEED, return_triple_idx=True
    )
    batches = [sampler.sample_batch(b) for b in sampler.epoch_index_blocks(shuffle=False)]
    say("serving", f"{N_ENTITY} x {DIM} table on the card, {len(batches)} batches of"
        f" {SHARD_BS} queries ({time.perf_counter() - t:.1f}s set-up)")

    # Plain full-table reference for the first queries of the first batch.
    batch0 = batches[0]
    h0 = rows(batch0["head"][0, 0, :N_REFERENCE])
    r0 = rows(batch0["relation"][0, 0, :N_REFERENCE])
    ref_scores = -l1_kernels.l1_distance_matrix_plain(table[h0] + rel_table[r0], table)
    ref_top, ref_pos = torch.topk(ref_scores, K + 1, dim=1)
    s2e = rows(sharding.shard_and_idx_to_entity[0])
    ref_ids = s2e[ref_pos[:, :K]]
    del ref_scores

    out = {}
    for merge, kernel in (("chunk", "l1_scores_chunkmax"), ("sort", "l1_distance_matrix")):
        evaluation = Evaluation(["mrr", "hits@1", "hits@10"], worst_rank_infty=True,
                                reduction="sum")
        topk = TopKQueryBessKGE(
            k=K, candidate_sampler=ns, score_fn=score_fn, evaluation=evaluation,
            return_scores=True, merge_mode=merge,
        )
        fwd = build_topk_forward(topk, device=device)
        l1_kernels.reset_launch_counts()
        fwd(params, batches[0])  # warm-up
        sync(device)
        t = time.perf_counter()
        outs = [fwd(params, b) for b in batches]
        sync(device)
        ms = (time.perf_counter() - t) / len(batches) * 1e3
        launches = {name: spec["wrapper"].launches for name, spec in KERNELS.items()}
        if launches[kernel] == 0:
            raise AssertionError(f"merge={merge} never launched {kernel}")

        sums = torch.stack([o["metrics"] for o in outs]).sum(0).reshape(-1) / N_QUERY
        metrics = dict(zip(evaluation.metrics, sums.tolist()))
        mrr, hits1, hits10 = metrics["mrr"], metrics["hits@1"], metrics["hits@10"]
        if mrr < 0.999:
            raise AssertionError(f"merge={merge}: MRR {mrr} of planted answers, expected 1")
        ids = outs[0]["topk_global_id"][0, 0, :N_REFERENCE].long()
        scores = outs[0]["topk_scores"][0, 0, :N_REFERENCE]
        torch.testing.assert_close(scores, ref_top[:, :K], rtol=RTOL, atol=ATOL)
        sure = (ref_top[:, K - 1] - ref_top[:, K]) > ATOL
        same = (ids.sort(1).values == ref_ids.sort(1).values).all(1)
        if not same[sure].all():
            raise AssertionError(f"merge={merge}: top-{K} IDs differ from the reference")
        say("serving", f"merge={merge} window={topk.window_size}: {ms:.2f} ms per"
            f" {SHARD_BS}-query batch, MRR {mrr:.4f} hits@1 {hits1:.4f} hits@10 {hits10:.4f},"
            f" top-{K} of {N_REFERENCE} queries match the reference ({int(sure.sum())}"
            f" with a clear 10th/11th gap), launches {launches}")
        out[kernel] = {"launches": launches[kernel], "serving_ms": ms}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)} (x{torch.cuda.device_count()}),"
        f" torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False

    t = time.perf_counter()
    paths = _build.build()
    say("build", f"{len(paths)} libraries with nvcc in {time.perf_counter() - t:.1f}s")

    gen = torch.Generator("cuda").manual_seed(SEED)
    results = check_kernels(gen)
    for name, run in serving(gen).items():
        results[name].update(run)

    kernels = []
    for name, spec in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": B7_SOURCE,
            "replaces": spec["replaces"], "tpu_counterpart": f"{spec['id']} {spec['replaces']}",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "max_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "serving_ms_per_batch": r["serving_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
