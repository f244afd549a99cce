#!/usr/bin/env python3
"""``bench.py`` through the PyTorch/CUDA port: one JSON line per config.

    python3 bench_torch.py [NAME ...]

Run from the root of a checkout on a machine with an NVIDIA card and the
CUDA toolkit (the port's kernels are built at first use). Without a name it
runs, in ``bench.py``'s order: ``census``, ``overlap``, ``biokg``,
``wikikg2``, ``wikikg2_bf16``, ``wikikg2_fp16``, ``valid``, ``allscores``,
``topk_yago``. Each line has ``bench.py``'s ``metric``, ``unit``,
``vs_baseline`` (against the same reference IPU rates) and statistics, and
``"card"``: the card's name and power limit as ``nvidia-smi`` gives them.
Before the configs, ``_cuda_kernel_selftest`` holds the in-place kernels
against numpy at ``bench.py``'s self-test shapes, and raises on a mismatch.

The configurations are ``bench.py``'s (its docstring names their sources):

1. **biokg** — RotatE p = 2 (d = 2 x 64) on 93,773 entities, LogSigmoid
   with adversarial weights, one shared "ht" negative, 48 x 240 positives
   per step, dense ``AdamW``;
2. **wikikg2** — TransE-L1 (d = 128) on 2,500,604 entities, bf16 scoring,
   SSCE, 32 shared "ht" negatives with in-batch augmentation, 8 x 512
   positives per step, ``RowSGDM`` interleaved pair-major;
3. **wikikg2_bf16** / **wikikg2_fp16** — the same with the entity table
   row-pair-packed in 16 bits, in ``RowSGDM``'s triplet store;
4. **valid**, **allscores**, **topk_yago** — ScoreMoving candidate-set
   validation, the all-scores pipeline and ComplEx top-k as ``bench.py``
   runs them;
5. **census** — the collectives of the n_shard = 8 step over 8 gloo ranks on
   the CPU, held to the BESS contract; **overlap** — the share of NCCL
   collective time that overlaps compute in the mesh step, at as many ranks
   as the machine has cards.

The primary training number is device-sampled: the whole batch is drawn on
the card (``DeviceBatchSampler``) and ``steps_per_call`` steps run as one
CUDA graph per call. Each line also has the host-fed rate (the numpy
sampler, one step ahead of a copy from pinned memory) and its input stall,
MFU and HBM utilization from analytic FLOP and byte models stated at each
set-up, and the device busy share, collective and data-movement shares from
a ``torch.profiler`` trace of three calls (``monitor.trace_breakdown``).

``bench.py``'s environment variables hold here: ``BENCH_SMOKE=1`` (toy
shapes; the runners then also run on the CPU with ``device="cpu"``, as the
tests call them), ``BENCH_SPC``, ``BENCH_PROCS``, ``BENCH_COMPUTE_DTYPE``,
``BENCH_INTERLEAVE``, ``BENCH_ASW``. ``main()`` needs a card: without one it
exits 1 and runs nothing.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from besskge_tpu_torch import monitor  # noqa: E402

# H100 SXM (NVIDIA data sheet, dense, at 700 W): 989.4 TFLOP/s bf16 on the
# tensor cores, 3.35 TB/s HBM. The line's "card" gives the card's name and
# power limit beside the percentages.
PEAK_FLOPS_BF16 = 989.4e12
PEAK_HBM_BPS = 3.35e12


def _spc(default: int) -> int:
    """steps_per_call, overridable with BENCH_SPC (steps per CUDA graph)."""
    return int(os.environ.get("BENCH_SPC", default))


# BENCH_SMOKE=1 shrinks every config to toy shapes so that every set-up and
# runner executes end to end on the CPU in the tests.
_SMOKE = os.environ.get("BENCH_SMOKE") == "1"


CONFIGS = {
    "biokg": dict(
        metric="biokg_rotate_train_pos_triples_per_s_per_chip",
        baseline=0.92e6,  # 1-IPU reference rate
        steps_per_call=_spc(10),
    ),
    "wikikg2": dict(
        metric="wikikg2_transe_sparse_train_pos_triples_per_s_per_chip",
        baseline=4.3e6 / 4,  # per-chip of the 4-IPU reference rate
        steps_per_call=_spc(8),
    ),
    "wikikg2_bf16": dict(
        metric="wikikg2_transe_bf16table_train_pos_triples_per_s_per_chip",
        baseline=4.3e6 / 4,
        steps_per_call=_spc(8),
    ),
    "wikikg2_fp16": dict(
        metric="wikikg2_transe_fp16table_train_pos_triples_per_s_per_chip",
        baseline=4.3e6 / 4,
        steps_per_call=_spc(8),
    ),
}


def _card(device: Any) -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi`` gives them; None
    for a run on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _cuda_kernel_selftest(device: str = "cuda") -> None:
    """The in-place kernels against numpy at ``bench.py``'s self-test cases,
    shapes and tolerances: ``scatter_rows`` (B3) plain and at h = 3 and 5
    with sorted duplicate runs, ``scatter_rows_multi`` (B8),
    ``dense_adamw_update`` (B10, t = 7) and ``l1_distance_grads`` (B6,
    96 x 200 x 128). On a card the wrappers launch the kernels; on the CPU
    they run their plain versions. Raises on a mismatch."""
    from besskge_tpu_torch.ops import adamw_kernels, l1_kernels, row_kernels

    def on(x: np.ndarray) -> torch.Tensor:  # a copy: the kernels write in place
        return torch.from_numpy(np.array(x)).to(device)

    def back(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    rng = np.random.default_rng(0)
    tab_np = rng.normal(size=(512, 128)).astype(np.float32)
    idx_np = rng.choice(512, size=37, replace=False).astype(np.int32)
    rows_np = rng.normal(size=(37, 128)).astype(np.float32)
    out = row_kernels.scatter_rows(on(tab_np), on(idx_np), on(rows_np))
    want = tab_np.copy()
    want[idx_np] = rows_np
    np.testing.assert_allclose(back(out), want, rtol=0, atol=0)

    mom_np = rng.normal(size=(512, 128)).astype(np.float32)
    m_idx = rng.choice(512, size=21, replace=False).astype(np.int32)
    m_rows = rng.normal(size=(21, 128)).astype(np.float32)
    o0, o1 = row_kernels.scatter_rows_multi(
        (on(tab_np), on(mom_np)), (on(idx_np), on(m_idx)), (on(rows_np), on(m_rows))
    )
    np.testing.assert_allclose(back(o0), want, rtol=0, atol=0)
    want_m = mom_np.copy()
    want_m[m_idx] = m_rows
    np.testing.assert_allclose(back(o1), want_m, rtol=0, atol=0)

    # Block writes with sorted duplicate skipping: the interleaved triplet
    # (h = 3, packed SGDM) and quintuplet (h = 5, packed AdamW) updates.
    for h in (3, 5):
        n_blk = 512 // h
        blk_np = rng.normal(size=(h * n_blk, 128)).astype(np.float32)
        starts = np.sort(rng.choice(n_blk, size=9, replace=False)).astype(np.int32)
        starts = np.repeat(starts, 2)[:13]  # sorted with duplicate runs
        phys = (h * starts).astype(np.int32)
        blocks = rng.normal(size=(13, h, 128)).astype(np.float32)
        first = np.concatenate([[True], starts[1:] != starts[:-1]])
        for k in range(13):  # duplicates carry identical content
            if not first[k]:
                blocks[k] = blocks[k - 1]
        out_b = row_kernels.scatter_rows(on(blk_np), on(phys), on(blocks.reshape(-1, 128)),
                                         slice_rows=h, skip_dups=True)
        want_b = blk_np.copy()
        for k in range(13):
            want_b[phys[k]: phys[k] + h] = blocks[k]
        np.testing.assert_allclose(back(out_b), want_b, rtol=0, atol=0)

    p = rng.normal(size=(256, 128)).astype(np.float32)
    mu = rng.normal(size=(256, 128)).astype(np.float32) * 0.1
    nu = abs(rng.normal(size=(256, 128)).astype(np.float32)) * 0.01
    g = rng.normal(size=(256, 128)).astype(np.float32)
    lr, b1, b2, eps, wd, t = 1e-2, 0.9, 0.999, 1e-8, 0.01, 7
    new_p, new_mu, new_nu = adamw_kernels.dense_adamw_update(
        on(p), on(mu), on(nu), on(g), torch.tensor(t, dtype=torch.int32, device=device), lr,
        b1=b1, b2=b2, eps=eps, wd=wd,
    )
    mu_w = b1 * mu + (1 - b1) * g
    nu_w = b2 * nu + (1 - b2) * g * g
    mhat = mu_w / (1 - b1**t)
    vhat = nu_w / (1 - b2**t)
    p_w = p - lr * (mhat / (np.sqrt(vhat) + eps) + wd * p)
    np.testing.assert_allclose(back(new_mu), mu_w, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back(new_nu), nu_w, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(back(new_p), p_w, rtol=3e-4, atol=1e-5)

    a = rng.normal(size=(96, 128)).astype(np.float32)
    b = rng.normal(size=(200, 128)).astype(np.float32)
    gg = rng.normal(size=(96, 200)).astype(np.float32)
    da, db = l1_kernels.l1_distance_grads(on(a), on(b), on(gg))
    sgn = np.sign(a[:, None, :] - b[None, :, :])
    np.testing.assert_allclose(back(da), (gg[:, :, None] * sgn).sum(1), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(back(db), -(gg[:, :, None] * sgn).sum(0), rtol=1e-5, atol=1e-4)
    print(f"# in-place kernels on {device}: numerics OK", file=sys.stderr)


def _make_dataset(n_entity: int, n_relation: int, n_train: int):
    from besskge_tpu_torch.dataset import KGDataset

    rng = np.random.default_rng(0)
    triples = np.stack(
        [
            rng.integers(n_entity, size=n_train),
            rng.integers(n_relation, size=n_train),
            rng.integers(n_entity, size=n_train),
        ],
        axis=1,
    ).astype(np.int32)
    return KGDataset(
        n_entity=n_entity,
        n_relation_type=n_relation,
        triples={"train": triples},
        original_triple_ids={"train": np.arange(n_train)},
    )


def _setup_biokg(device: str = "cuda") -> dict:
    from besskge_tpu_torch.batch_sampler import RandomShardedBatchSampler
    from besskge_tpu_torch.bess import EmbeddingMovingBessKGE
    from besskge_tpu_torch.device_sampler import DeviceBatchSampler
    from besskge_tpu_torch.loss import LogSigmoidLoss
    from besskge_tpu_torch.negative_sampler import RandomShardedNegativeSampler
    from besskge_tpu_torch.optim import AdamW
    from besskge_tpu_torch.scoring import RotatE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
    from besskge_tpu_torch.trainer import (
        build_device_train_step,
        build_train_step,
        init_optimizer_state,
    )

    shard_bs, bps = (64, 4) if _SMOKE else (240, 48)
    ds = (
        _make_dataset(4_096, 51, 50_000)
        if _SMOKE
        else _make_dataset(93_773, 51, 4_762_678)
    )
    sharding = Sharding.create(ds.n_entity, 1, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = RotatE(
        negative_sample_sharing=True, scoring_norm=2, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=64, seed=0,
    )
    ns = RandomShardedNegativeSampler(
        1, sharding, 0, "ht", local_sampling=False, flat_negative_format=True
    )
    bess = EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=LogSigmoidLoss(margin=12.0, negative_adversarial_sampling=True),
        axis_name=None,
    )
    # Plain dense AdamW (optax.adamw(1e-3)'s rule and weight decay), as
    # bench.py chooses it over the fused kernel for this table.
    optimizer = AdamW(1e-3)
    params = score_fn.initial_params_device(device=device)
    opt_state = init_optimizer_state(optimizer, params, None)

    spc = CONFIGS["biokg"]["steps_per_call"]
    dev = DeviceBatchSampler(pts, ns, shard_bs=shard_bs,
                             batches_per_step=bps, seed=0,
                             positive_mode="runs")
    dstep = build_device_train_step(
        bess, optimizer, dev, None, steps_per_call=spc, device=device
    )
    hstep = build_train_step(bess, optimizer, None, device=device)
    hbs = RandomShardedBatchSampler(pts, ns, shard_bs=shard_bs,
                                    batches_per_step=bps, seed=0)
    # Analytic per-step HBM traffic (bench.py's model): dense AdamW sweeps
    # the whole param set every step — read p, mu, nu, grad + write p, mu,
    # nu (7x param bytes) plus the table-sized dense gradient the backward
    # writes (1x); the batch's embedding gathers (h + t + 1 shared "ht"
    # negative per positive, 128-float rows) are read forward and backward.
    n_param = sum(int(np.prod(v.shape)) for v in params.values())
    p_bytes = 4 * n_param
    row_b = 4 * 128
    pos = shard_bs * bps
    gather_b = pos * 3 * row_b
    hbm_bytes = 8 * p_bytes + 2 * gather_b
    # Analytic FLOPs per step: each positive rotates h by r (one complex
    # product per coordinate, 6 FLOPs x 64) and takes the L2 distance of
    # h∘r to its tail and to its half's one shared negative (per complex
    # coordinate: 2 subtractions, 2 squares, an add, a square root and the
    # sum, 7 FLOPs); the backward costs twice the forward; AdamW does 12
    # FLOPs per param (two moment updates, bias corrections, square root,
    # division, decay, step).
    d_complex = 64
    fwd = pos * (6 * d_complex + 2 * 7 * d_complex)
    flops = 3 * fwd + 12 * n_param
    return dict(
        dstep=dstep, dev=dev, hstep=hstep, hbs=hbs,
        params=params, opt_state=opt_state,
        pos_per_step=pos,
        hbm_bytes_per_step=hbm_bytes,
        flops_per_step=flops,
    )


def _setup_wikikg2(bf16_table: bool = False, fp16_table: bool = False,
                   device: str = "cuda", mesh: Any = None) -> dict:
    """The wikikg2 configuration; over a ``mesh`` (on its device) the
    module runs over the "shard" axis and each rank holds its block."""
    from besskge_tpu_torch.batch_sampler import RandomShardedBatchSampler
    from besskge_tpu_torch.bess import EmbeddingMovingBessKGE
    from besskge_tpu_torch.device_sampler import DeviceBatchSampler
    from besskge_tpu_torch.loss import SampledSoftmaxCrossEntropyLoss
    from besskge_tpu_torch.negative_sampler import RandomShardedNegativeSampler
    from besskge_tpu_torch.optim import SGD, RowSGDM
    from besskge_tpu_torch.scoring import TransE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
    from besskge_tpu_torch.trainer import (
        build_device_train_step,
        build_train_step,
        init_optimizer_state,
    )

    shard_bs, bps = (64, 2) if _SMOKE else (512, 8)
    ds = (
        _make_dataset(8_192, 535, 50_000)
        if _SMOKE
        else _make_dataset(2_500_604, 535, 1_000_000)
    )
    if mesh is not None:
        device = mesh.device
    sharding = Sharding.create(ds.n_entity, 1 if mesh is None else mesh.n_shard, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = TransE(
        negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
        n_relation_type=ds.n_relation_type, embedding_size=128, seed=0,
    )
    # bf16 scoring math over the stored tables (fp32 loss and update);
    # BENCH_COMPUTE_DTYPE=fp32 scores in fp32.
    if os.environ.get("BENCH_COMPUTE_DTYPE", "bf16") != "fp32":
        score_fn.compute_dtype = torch.bfloat16
    if bf16_table or fp16_table:
        # The entity table itself in 16 bits, row-pair-packed in 32-bit
        # words (half the HBM), with sparse in-place updates.
        score_fn.dtype = torch.float16 if fp16_table else torch.bfloat16
        score_fn.packed_entity_storage = True
    n_negative = 32
    ns = RandomShardedNegativeSampler(
        n_negative, sharding, 0, "ht", local_sampling=False, flat_negative_format=True
    )
    bess = EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=SampledSoftmaxCrossEntropyLoss(n_entity=ds.n_entity),
        augment_negative=True, axis_name=None if mesh is None else "shard",
    )
    opt = SGD(1e-3, momentum=0.9)
    # The momentum interleaved into the table: pair-major (2N, D) for fp32,
    # the triplet store (3P, D) for a packed table; one block written back
    # per touched row (B3). BENCH_INTERLEAVE=0 keeps separate buffers (B8).
    interleave = os.environ.get("BENCH_INTERLEAVE", "1") == "1"
    row = RowSGDM(learning_rate=1e-3, momentum=0.9, interleaved=interleave)
    params = score_fn.initial_params_device(mesh, device=device)
    params["entity_embedding"] = row.widen_table(params["entity_embedding"])
    opt_state = init_optimizer_state(
        opt, params, mesh, row,
        n_logical=sharding.n_shard * sharding.max_entity_per_shard,
    )

    dev = DeviceBatchSampler(pts, ns, shard_bs=shard_bs,
                             batches_per_step=bps, seed=0,
                             positive_mode="runs")
    name = (
        "wikikg2_fp16" if fp16_table
        else "wikikg2_bf16" if bf16_table else "wikikg2"
    )
    spc = CONFIGS[name]["steps_per_call"]
    dstep = build_device_train_step(
        bess, opt, dev, mesh, entity_optimizer=row, steps_per_call=spc, device=device
    )
    hstep = build_train_step(bess, opt, mesh, row, device=device)
    hbs = RandomShardedBatchSampler(pts, ns, shard_bs=shard_bs,
                                    batches_per_step=bps, seed=0)
    # Analytic per-step HBM traffic (bench.py's model): the sparse row
    # optimizer touches only gathered rows — h + t per positive and the
    # shared negatives. Each touched row is read by the forward gather, read
    # again by the backward, and read + written by the row update.
    # Interleaved fp32 moves (param, momentum) (2, D) pairs per touch; the
    # packed triplet store a (3, D) 32-bit block per touched packed row at
    # update time (= 12·D bytes per logical row) plus half-width fwd/bwd
    # reads. The relation table is dense SGDM (read p, m, g + write p, m +
    # grad write = 6x).
    D = 128
    rows_touched = shard_bs * bps * 2 + n_negative * bps
    if bf16_table or fp16_table:
        row_rw = 2 * (2 * D) + (2 * (2 * D) + 2 * (4 * D))
    else:
        pair_b = 2 * D * 4
        row_rw = 4 * pair_b
    rel_bytes = 535 * D * 4
    hbm_bytes = rows_touched * row_rw + 6 * rel_bytes
    # Analytic FLOPs per step: every positive is scored against its own
    # tail, the shard_bs/2 in-batch rows of its half (augmentation) and the
    # shared negatives, each an L1 distance over D coordinates: forward 3
    # FLOPs per coordinate (subtract, abs, add), backward 5 (subtract, sign,
    # scale by the cotangent, accumulate into both rows); h + r costs D
    # forward and 2·D backward; SGDM takes 4 FLOPs per element of each
    # touched row and of the relation table.
    pos = shard_bs * bps
    n_cand = 1 + shard_bs // 2 + n_negative
    flops = pos * n_cand * 8 * D + pos * 3 * D + 4 * D * (rows_touched + 535)
    return dict(
        dstep=dstep, dev=dev, hstep=hstep, hbs=hbs,
        params=params, opt_state=opt_state,
        pos_per_step=pos,
        hbm_bytes_per_step=hbm_bytes,
        flops_per_step=flops,
    )


def _pct(x: float) -> float:
    """A share in percent to four significant digits (a share of a
    tensor-core peak can be far under 0.01 %)."""
    return float(f"{x:.4g}")


def _cost_fields(step_s: float, flops: int, analytic_bytes: int, device: str) -> dict:
    """MFU against the bf16 dense peak from the set-up's analytic FLOP
    model, and HBM utilization from its analytic byte model (a first-order
    model of mandatory DRAM traffic, so the share is a lower bound). On the
    CPU the device shares are not measured (None)."""
    on_card = torch.device(device).type == "cuda"
    return {
        "mfu_bf16_pct": _pct(100 * flops / step_s / PEAK_FLOPS_BF16) if on_card else None,
        "flops_per_step": int(flops),
        "flops_model": "analytic",
        "hbm_bw_pct": _pct(100 * analytic_bytes / step_s / PEAK_HBM_BPS) if on_card else None,
        "hbm_bytes_model": "analytic_min_traffic",
        "hbm_bytes_per_step": int(analytic_bytes),
        "peaks": "H100 SXM data sheet: 989.4e12 bf16 FLOP/s dense, 3.35e12 B/s HBM",
    }


def _device_prefetch(it: Iterator[dict], device: str) -> Iterator[dict]:
    """Batches as tensors on ``device``, one step ahead: batch k + 1 is
    copied from pinned host memory, without blocking, on a copy stream while
    step k runs; the consumer's stream waits for the copy before using it.
    On the CPU the batch is converted where it is."""
    from besskge_tpu_torch.bess import _FORWARD_KEYS

    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(batch: dict):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()
                if k in _FORWARD_KEYS}
        if stream is None:
            return host, None
        with torch.cuda.stream(stream):
            moved = {k: v.pin_memory().to(dev, non_blocking=True) for k, v in host.items()}
        return moved, stream.record_event()

    def ready(staged):
        moved, event = staged
        if event is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(event)
            for v in moved.values():
                v.record_stream(current)
        return moved

    ahead = None
    for batch in it:
        staged = stage(batch)
        if ahead is not None:
            yield ready(ahead)
        ahead = staged
    if ahead is not None:
        yield ready(ahead)


def run_topk(n_steps: int = 20, repeats: int = 3, device: str = "cuda") -> dict:
    """Top-k rank-vs-all inference on the YAGO benchmark shape: ComplEx
    2 x 128 over 123,182 entities, 512 queries, top-10; the default window
    and the chunk merge. Best of the repeats, as bench.py reports it."""
    from besskge_tpu_torch.bess import TopKQueryBessKGE
    from besskge_tpu_torch.negative_sampler import PlaceholderNegativeSampler
    from besskge_tpu_torch.scoring import ComplEx
    from besskge_tpu_torch.sharding import Sharding

    n_entity, batch = (4_096, 64) if _SMOKE else (123_182, 512)
    if _SMOKE:
        n_steps, repeats = 2, 1
    rng = np.random.default_rng(0)
    sharding = Sharding.create(n_entity, 1, seed=0)
    score_fn = ComplEx(
        negative_sample_sharing=True, sharding=sharding,
        n_relation_type=37, embedding_size=128, seed=0,
    )
    topk = TopKQueryBessKGE(
        k=10, candidate_sampler=PlaceholderNegativeSampler("t"),
        score_fn=score_fn, axis_name=None,
    )
    params = score_fn.initial_params_device(device=device)
    rel = torch.from_numpy(rng.integers(37, size=batch).astype(np.int32)).to(device)
    head = torch.from_numpy(rng.integers(
        sharding.max_entity_per_shard, size=batch).astype(np.int32)).to(device)
    with torch.inference_mode():
        out = topk.forward(params, rel, head=head)
        int(out["topk_global_id"][0, 0])  # read = sync
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                out = topk.forward(params, rel, head=head)
            int(out["topk_global_id"][0, 0])
            best = min(best, (time.perf_counter() - t0) / n_steps)
    baseline = 512 / 0.1207  # 1-IPU reference rate
    line = {
        "metric": "yago_complex_topk_vs_all_queries_per_s_per_chip",
        "value": round(batch / best, 1),
        "unit": "queries/s",
        "vs_baseline": round(batch / best / baseline, 3),
        "ms_per_512q_batch": round(best * 1e3, 2),
        "window": topk.window_size,
        "merge": "chunk",
        "stat": "best_of_repeats",
        "repeats": repeats,
        "card": _card(device),
    }
    print(json.dumps(line), flush=True)
    return line


def run_valid(n_valid: int = 40_960, repeats: int = 3, device: str = "cuda") -> dict:
    """ScoreMoving candidate-set validation at the reference's wikikg2
    shape: 500 candidate tails per triple, TripleBased negatives, corruption
    "t", shard_bs 256 x 10. Reference: 429,456 queries in 1.065 s on 4 IPUs
    = 100.8K queries/s/chip. The primary rate runs pre-staged blocks of 16
    steps; ``run_device_eval`` once end to end is the host-pipeline rate."""
    from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler
    from besskge_tpu_torch.bess import _FORWARD_KEYS, ScoreMovingBessKGE
    from besskge_tpu_torch.eval_loop import _stack_block, make_block_runner, run_device_eval
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import TripleBasedShardedNegativeSampler
    from besskge_tpu_torch.scoring import TransE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding

    rng = np.random.default_rng(0)
    n_entity = 8_192 if _SMOKE else 2_500_604
    if _SMOKE:
        n_valid, repeats = 640, 1
    ds = _make_dataset(n_entity, 535, 1000)
    ds.triples["valid"] = np.stack(
        [
            rng.integers(n_entity, size=n_valid),
            rng.integers(535, size=n_valid),
            rng.integers(n_entity, size=n_valid),
        ],
        axis=1,
    ).astype(np.int32)
    ds.original_triple_ids["valid"] = np.arange(n_valid)
    ds.neg_tails = {
        "valid": rng.integers(
            n_entity, size=(n_valid, 500), dtype=np.int64
        ).astype(np.int32)
    }

    sharding = Sharding.create(n_entity, 1, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(
        ds, "valid", sharding, partition_mode="ht_shardpair"
    )
    ns = TripleBasedShardedNegativeSampler(
        None, pts.neg_tails, sharding, corruption_scheme="t", seed=0
    )
    sbs, bps = (64, 2) if _SMOKE else (256, 10)
    bs = RigidShardedBatchSampler(
        pts, ns, shard_bs=sbs, batches_per_step=bps, seed=0,
        duplicate_batch=False,
    )
    score_fn = TransE(
        negative_sample_sharing=False, scoring_norm=1, sharding=sharding,
        n_relation_type=535, embedding_size=128, seed=0,
    )
    score_fn.compute_dtype = torch.bfloat16
    bess = ScoreMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"),
        axis_name=None,
    )
    params = score_fn.initial_params_device(device=device)

    # End to end through the host input path once: metric correctness and
    # the host-fed rate.
    spb = 4 if _SMOKE else 16
    t0 = time.perf_counter()
    metrics, n_queries = run_device_eval(
        bess, params, bs, mesh=None, steps_per_block=spb, device=device
    )
    e2e_s = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"valid: non-finite metrics {metrics}")

    # Primary: device-resident blocks, staged beforehand, then timed.
    run_block = make_block_runner(bess, mesh=None, device=device)
    steps = [{k: v for k, v in b.items() if k in _FORWARD_KEYS}
             for b in bs.get_dataloader(shuffle=False)]
    blocks = [_stack_block(steps[i:i + spb], spb, torch.device(device))
              for i in range(0, len(steps), spb)]
    tot = run_block(params, blocks[0])
    float(tot[0])  # warm + sync
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for blk in blocks:
            tot = run_block(params, blk)
        acc = float(tot[0])
        times.append(time.perf_counter() - t0)
        if not np.isfinite(acc):
            raise AssertionError(f"valid: non-finite metric sum {acc}")
    med = float(np.median(times))
    baseline = 429_456 / 1.06543 / 4  # reference per-chip rate (cell 32)
    line = {
        "metric": "wikikg2_scoremoving_valid500_queries_per_s_per_chip",
        "value": round(n_queries / med, 1),
        "unit": "queries/s",
        "vs_baseline": round(n_queries / med / baseline, 3),
        "stat": "median_of_repeats",
        "repeats": repeats,
        "spread_queries_per_s": [
            round(n_queries / max(times), 1), round(n_queries / min(times), 1)
        ],
        "n_queries": int(n_queries),
        "candidates_per_query": 500,
        "sampling": "device_resident_blocks",
        "host_pipeline_queries_per_s": round(n_queries / e2e_s, 1),
        "metrics_mrr": round(metrics.get("mrr", float("nan")), 5),
        "card": _card(device),
    }
    print(json.dumps(line), flush=True)
    return line


def run_allscores(n_queries: int = 1024, repeats: int = 3, device: str = "cuda") -> dict:
    """AllScoresPipeline full sweep: (h, r, ?) queries scored against all
    500,000 entities window by window (windows of 65,536), stitched and
    ranked. The pipeline once end to end is the host rate; the primary is
    the device sweep of every window per batch, ending in one read per
    repeat. The reference proxy baseline is its vs-all sweep, 429k x 2.5M
    in 47.12 s on 4 IPUs = 5.69G candidate-scores/s/chip."""
    from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler
    from besskge_tpu_torch.bess import _batch_tensors
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import PlaceholderNegativeSampler
    from besskge_tpu_torch.pipeline import AllScoresPipeline
    from besskge_tpu_torch.scoring import TransE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding

    rng = np.random.default_rng(0)
    n_entity = 8_192 if _SMOKE else 500_000
    if _SMOKE:
        n_queries, repeats = 64, 1
    ds = _make_dataset(n_entity, 535, 1000)
    sharding = Sharding.create(n_entity, 1, seed=0)
    queries = np.stack(
        [
            rng.integers(n_entity, size=n_queries),
            rng.integers(535, size=n_queries),
        ],
        axis=1,
    ).astype(np.int32)
    truth = rng.integers(n_entity, size=n_queries).astype(np.int32)
    pts = PartitionedTripleSet.create_from_queries(
        ds, sharding, queries, "hr", ground_truth=truth
    )
    pns = PlaceholderNegativeSampler(corruption_scheme="t", seed=0)
    sbs, sbps = (32, 2) if _SMOKE else (256, 4)
    bs = RigidShardedBatchSampler(
        pts, pns, shard_bs=sbs, batches_per_step=sbps, seed=0,
        return_triple_idx=True,
    )
    score_fn = TransE(
        negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
        n_relation_type=535, embedding_size=128, seed=0,
    )
    score_fn.compute_dtype = torch.bfloat16
    window = 2_048 if _SMOKE else int(os.environ.get("BENCH_ASW", 65_536))
    pipe = AllScoresPipeline(
        bs, "t", score_fn, mesh=None,
        evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"),
        window_size=window, device=device,
    )
    params = score_fn.initial_params_device(device=device)

    # Secondary: the reference architecture end to end (stitch, filter and
    # rank per batch), once.
    t0 = time.perf_counter()
    out = pipe.forward(params)
    e2e_s = time.perf_counter() - t0
    if not np.isfinite(out["metrics_avg"]["mrr"]):
        raise AssertionError(f"allscores: {out['metrics_avg']}")

    # Primary: the device program, every window of a batch with no host
    # sync between them; one read per repeat is the sync point.
    fwd = pipe._fwd
    n_step = pipe.bess_module.n_step
    batches = [_batch_tensors(bs.sample_batch(b), ("relation", "head", "tail"),
                              torch.device(device))
               for b in bs.epoch_index_blocks(False)]

    def sweep(b):
        return torch.stack([fwd(params, b, i).sum(dtype=torch.float32)
                            for i in range(n_step)]).sum()

    with torch.inference_mode():
        float(sweep(batches[0]))  # warm + sync
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            tot = None
            for b in batches:
                c = sweep(b)
                tot = c if tot is None else tot + c
            if not np.isfinite(float(tot)):  # read = sync
                raise AssertionError("allscores: non-finite score sum")
            times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    scores_per_s = n_queries * n_entity / med
    baseline = 429_456 * 2_500_604 / 47.12475 / 4  # vs-all proxy, per chip
    line = {
        "metric": "allscores_pipeline_candidate_scores_per_s_per_chip",
        "value": round(scores_per_s, 1),
        "unit": "scores/s",
        "vs_baseline": round(scores_per_s / baseline, 3),
        "stat": "median_of_repeats",
        "repeats": repeats,
        "spread_scores_per_s": [
            round(n_queries * n_entity / max(times), 1),
            round(n_queries * n_entity / min(times), 1),
        ],
        "n_queries": n_queries,
        "n_entity": n_entity,
        "window_size": window,
        "sampling": "device_resident_windows",
        "host_pipeline_scores_per_s": round(n_queries * n_entity / e2e_s, 1),
        "host_stitch_d2h_gb": round(n_queries * n_entity * 4 / 1e9, 2),
        "metrics_mrr": round(out["metrics_avg"]["mrr"], 5),
        "card": _card(device),
    }
    print(json.dumps(line), flush=True)
    return line


def _census_setup(n: int):
    """bench.py's census configuration over ``n`` shards: RotatE p = 2
    (d = 2 x 64) on 64·n entities, 16 relation types, LogSigmoid with
    adversarial weights, 32 shared "ht" negatives, the wikikg2 batch
    geometry (shard_bs 512, bps 1); the collective payloads depend on the
    batch geometry only. Returns (module, sampler, params, first batch)."""
    from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler
    from besskge_tpu_torch.bess import EmbeddingMovingBessKGE
    from besskge_tpu_torch.dataset import KGDataset
    from besskge_tpu_torch.loss import LogSigmoidLoss
    from besskge_tpu_torch.metric import Evaluation
    from besskge_tpu_torch.negative_sampler import RandomShardedNegativeSampler
    from besskge_tpu_torch.scoring import RotatE
    from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding

    n_entity, n_relation = 64 * n, 16
    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(n_entity, size=20000), rng.integers(n_relation, size=20000),
                        rng.integers(n_entity, size=20000)], axis=1).astype(np.int32)
    ds = KGDataset(n_entity=n_entity, n_relation_type=n_relation, triples={"train": triples},
                   original_triple_ids={"train": np.arange(len(triples))})
    sharding = Sharding.create(n_entity, n, seed=0)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = RotatE(negative_sample_sharing=True, scoring_norm=2, sharding=sharding,
                      n_relation_type=n_relation, embedding_size=64, seed=0)
    ns = RandomShardedNegativeSampler(32, sharding, 0, "ht", local_sampling=False,
                                      flat_negative_format=True)
    bs = RigidShardedBatchSampler(pts, ns, shard_bs=512, batches_per_step=1, seed=0)
    bess = EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=LogSigmoidLoss(margin=9.0, negative_adversarial_sampling=True),
        evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"),
        axis_name="shard",
    )
    batch = bs.sample_batch(next(bs.epoch_index_blocks(shuffle=False)))
    params = score_fn.initial_params(device="cpu")
    return bess, bs, params, batch


def _census_rank(n: int) -> dict:
    """One gloo rank of the census: the census of one dense Adam step
    (``AdamW`` without decay: ``optax.adam``) of the rank's params and batch
    column, and the check that no all-reduce is a table block's size."""
    from besskge_tpu_torch.optim import AdamW
    from besskge_tpu_torch.parallel import make_shard_mesh, shard_params
    from besskge_tpu_torch.parallel.census import assert_no_entity_allreduce
    from besskge_tpu_torch.trainer import build_train_step, init_optimizer_state

    mesh = make_shard_mesh(n, devices=["cpu"] * n, backend="gloo")
    bess, bs, params, batch = _census_setup(n)
    local = shard_params(params, mesh)
    opt = AdamW(1e-3, weight_decay=0.0)
    state = init_optimizer_state(opt, local, mesh)
    step = build_train_step(bess, opt, mesh, donate=False)
    census = assert_no_entity_allreduce(
        step, (n * bess.sharding.max_entity_per_shard, local["entity_embedding"].shape[-1]),
        local, state, batch, mesh=mesh,
    )
    block = local["entity_embedding"]
    return {"census": census, "ppp": int(bs.positive_per_partition),
            "block_bytes": block.numel() * block.element_size()}


def run_census(device: str = "cuda") -> dict:
    """The collective census of the n_shard = 8 train step over 8 gloo ranks
    on the CPU (a mesh of ranks is processes here, not devices of one
    program): asserts the BESS communication contract — exactly two
    all-to-alls (forward and its transpose) of the predicted payload, no
    all-gather, one all-reduce smaller than a table block. ``device`` only
    names where the other configs run; the ranks are CPU processes."""
    from besskge_tpu_torch.parallel.multihost import _spawn

    n = 8
    ranks = _spawn(_census_rank, n, (n,), backend="gloo", timeout=600)
    census, ppp = ranks[0]["census"], ranks[0]["ppp"]
    expected = n * (ppp + 2 * 32) * 128 * 4  # S*(ppp + B*n_neg)*row*4B
    ok = all(
        r["census"]["all-to-all"] == [expected, expected]
        and r["census"]["all-gather"] == []
        and len(r["census"]["all-reduce"]) == 1
        and r["census"]["all-reduce"][0] < r["block_bytes"]
        for r in ranks
    )
    line = {
        "metric": "bess_collective_census_nshard8",
        "value": expected,
        "unit": "bytes_per_device_alltoall",
        "vs_baseline": 1.0 if ok else 0.0,
        "all_to_all_payloads": census["all-to-all"],
        "all_gather_payloads": census["all-gather"],
        "all_reduce_payloads": census["all-reduce"],
        "no_table_allreduce": True,
        "contract_ok": ok,
        "ranks": n,
        "backend": "gloo (CPU processes)",
        "card": _card(device),
    }
    if not ok:
        raise AssertionError(f"census contract broken: {line}")
    print(json.dumps(line), flush=True)
    return line


def _overlap_rank(n: int, device: str, log_dir: str) -> dict:
    """One rank of the overlap measurement: the wikikg2 device-sampled call
    over an ``n``-rank mesh (NCCL on cards, gloo on the CPU), captured by its
    first call, then the breakdown of a trace of three calls."""
    from besskge_tpu_torch.parallel import make_shard_mesh

    mesh = make_shard_mesh(n, devices=[device] * n if device == "cpu" else None)
    s = _setup_wikikg2(mesh=mesh)
    dev, step, params, state = s["dev"], s["dstep"], s["params"], s["opt_state"]
    st = dev.state(mesh.device)
    float(step(params, state, st, dev.next_key(0))[2]["loss"])  # eager, then capture
    float(step(params, state, st, dev.next_key(1))[2]["loss"])

    def calls():
        for i in range(3):
            out = step(params, state, st, dev.next_key(2 + i))[2]
        float(out["loss"])

    return {"trace": monitor.trace_breakdown(calls, os.path.join(log_dir, f"rank{mesh.rank}")),
            "captured": step._graph is not None, "backend": mesh.backend}


def run_overlap(device: str = "cuda") -> dict:
    """Collective/compute overlap of the BESS mesh step: the share of the
    NCCL collectives' device time that overlaps other device work
    (``collective_overlap_pct`` of ``monitor.trace_breakdown``) in the
    wikikg2 device-sampled call over a mesh of as many ranks as the machine
    has cards (one rank runs in this process). There is no TPU topology to
    compile for. On the CPU one gloo rank runs in this process and the
    trace has no device track (value None)."""
    from besskge_tpu_torch.parallel import multihost

    on_card = torch.device(device).type == "cuda"
    n = torch.cuda.device_count() if on_card else 1
    with tempfile.TemporaryDirectory() as tmp:
        if n == 1:
            multihost.initialize(f"file://{tmp}/store", 1, 0,
                                 backend="nccl" if on_card else "gloo", device=device)
            try:
                rank0 = _overlap_rank(1, device, tmp)
            finally:
                torch.distributed.destroy_process_group()
        else:
            rank0 = multihost._spawn(_overlap_rank, n, (n, device, tmp), backend="nccl",
                                     timeout=900)[0]
    trace = rank0["trace"]
    value = trace.get("collective_overlap_pct")
    line = {
        "metric": "bess_collective_overlap",
        "value": value,
        "unit": "pct_of_collective_device_time_overlapping_compute",
        "vs_baseline": None,
        "ranks": n,
        "backend": rank0["backend"],
        "captured": rank0["captured"],
        "steps_per_call": CONFIGS["wikikg2"]["steps_per_call"],
        "traced_calls": 3,
        "topology": "no TPU topology: the NCCL mesh step traced on the cards of this machine",
        **trace,
        "card": _card(device),
    }
    if on_card and n == 1:
        line["note"] = ("one rank: NCCL runs no collective kernel (the all-to-alls and the"
                        " all-reduce of a one-rank group are local), so no collective time")
    print(json.dumps(line), flush=True)
    return line


def run_one(name: str, n_steps: int = 120, repeats: int = 3, device: str = "cuda") -> dict:
    if _SMOKE:
        n_steps, repeats = 16, 1
    if name == "topk_yago":
        return run_topk(device=device)
    if name == "census":
        return run_census(device=device)
    if name == "overlap":
        return run_overlap(device=device)
    if name == "valid":
        return run_valid(device=device)
    if name == "allscores":
        return run_allscores(device=device)
    setup = {
        "biokg": lambda: _setup_biokg(device=device),
        "wikikg2": lambda: _setup_wikikg2(device=device),
        "wikikg2_bf16": lambda: _setup_wikikg2(bf16_table=True, device=device),
        "wikikg2_fp16": lambda: _setup_wikikg2(fp16_table=True, device=device),
    }[name]
    cfg = CONFIGS[name]
    spc = cfg["steps_per_call"]
    s = setup()
    pos_per_step = s["pos_per_step"]

    # ---- primary: the batch drawn on the card, one CUDA graph per call ----
    dev, dstep = s["dev"], s["dstep"]
    dstate = dev.state(device)
    params, opt_state = s["params"], s["opt_state"]
    params, opt_state, out = dstep(params, opt_state, dstate, dev.next_key(0))  # capture
    loss = float(out["loss"])  # read = sync

    n_calls = max(1, n_steps // spc)
    times = []
    for r in range(repeats):
        t0 = time.perf_counter()
        for i in range(n_calls):
            params, opt_state, out = dstep(
                params, opt_state, dstate, dev.next_key(1 + r * n_calls + i)
            )
        loss = float(out["loss"])
        times.append(time.perf_counter() - t0)
    if not np.isfinite(loss):
        raise AssertionError(f"{name}: non-finite loss {loss}")
    # Median of the repeats, with the full spread.
    med = float(np.median(times))
    rates = [n_calls * spc * pos_per_step / t for t in times]
    value = n_calls * spc * pos_per_step / med
    cost = _cost_fields(med / (n_calls * spc), s["flops_per_step"], s["hbm_bytes_per_step"],
                        device)

    # ---- secondary: the host input pipeline (the reference's design) ----
    hstep = s["hstep"]
    batches = s["hbs"].get_dataloader(shuffle=True, prefetch=4, repeat=True)
    loader = _device_prefetch(batches, device)
    try:
        first = next(loader)
        params, opt_state, out = hstep(params, opt_state, first)
        loss = float(out["loss"])
        h_steps = max(2, n_steps // 2) if _SMOKE else max(20, n_steps // 2)
        t0 = time.perf_counter()
        for _ in range(h_steps):
            params, opt_state, out = hstep(params, opt_state, next(loader))
        loss = float(out["loss"])
        t_host = time.perf_counter() - t0
    finally:
        loader.close()
        batches.close()
    if not np.isfinite(loss):
        raise AssertionError(f"{name}: non-finite host-fed loss {loss}")
    # The same step re-fed one resident batch: the gap is the input
    # pipeline's share that the prefetch did not hide.
    t0 = time.perf_counter()
    for _ in range(h_steps):
        params, opt_state, out = hstep(params, opt_state, first)
    loss = float(out["loss"])
    t_pure = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise AssertionError(f"{name}: non-finite loss {loss}")

    # A trace of three device-sampled calls (replays: the capture is done,
    # and one call first checks that the host steps left the graph bound).
    params, opt_state, out = dstep(params, opt_state, dstate, dev.next_key(999))
    float(out["loss"])

    def _traced():
        p, o = params, opt_state
        for i in range(3):
            p, o, out = dstep(p, o, dstate, dev.next_key(1000 + i))
        float(out["loss"])

    with tempfile.TemporaryDirectory() as td:
        trace_fields = monitor.trace_breakdown(_traced, td)

    line = {
        "metric": cfg["metric"],
        "value": round(value, 1),
        "unit": "triples/s",
        "vs_baseline": round(value / cfg["baseline"], 3),
        "stat": "median_of_repeats",
        "repeats": repeats,
        "spread_triples_per_s": [round(min(rates), 1), round(max(rates), 1)],
        "sampling": "on_device",
        "steps_per_call": spc,
        "ms_per_step": round(med / (n_calls * spc) * 1e3, 4),
        "pos_per_step": pos_per_step,
        "host_pipeline_triples_per_s": round(h_steps * pos_per_step / t_host, 1),
        "host_input_stall_pct": round(
            max(0.0, 100.0 * (t_host - t_pure) / t_host), 1
        ),
        **cost,
        **trace_fields,
        "card": _card(device),
    }
    print(json.dumps(line), flush=True)
    return line


def run_procs(name: str, procs: int) -> dict:
    """Cross-process repeats of a training config: run ``bench_torch.py
    <name>`` ``procs`` times and aggregate the medians (``BENCH_PROCS=N``);
    the line's spread spans every process's."""
    vals, spreads = [], []
    sub = None
    for _ in range(procs):
        res = subprocess.run(
            [sys.executable, "-u", os.path.abspath(__file__), name],
            capture_output=True, text=True, timeout=3600,
        )
        for ln in res.stdout.splitlines():
            ln = ln.strip()
            if ln.startswith("{"):
                sub = json.loads(ln)
        if res.returncode != 0 or sub is None or "value" not in sub:
            raise RuntimeError(
                f"bench_torch subprocess for {name} produced no JSON line:\n"
                + (res.stderr or res.stdout)[-500:]
            )
        vals.append(sub["value"])
        spreads.append(sub.get("spread_triples_per_s", [sub["value"]] * 2))
    line = dict(sub)
    line["value"] = round(float(np.median(vals)), 1)
    if sub.get("vs_baseline"):
        line["vs_baseline"] = round(line["value"] / (sub["value"] / sub["vs_baseline"]), 3)
    line["stat"] = f"median_of_{procs}_processes"
    line["process_medians"] = [round(v, 1) for v in vals]
    line["spread_triples_per_s"] = [
        round(min(s[0] for s in spreads), 1),
        round(max(s[1] for s in spreads), 1),
    ]
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch.py: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from besskge_tpu_torch import _build

    _build.build()
    _cuda_kernel_selftest()
    names = sys.argv[1:] or [
        "census", "overlap", "biokg", "wikikg2", "wikikg2_bf16", "wikikg2_fp16",
        "valid", "allscores",
        "topk_yago",
    ]
    procs = int(os.environ.get("BENCH_PROCS", "1"))
    for name in names:
        if procs > 1 and name in CONFIGS:
            run_procs(name, procs)
        else:
            run_one(name)
        gc.collect()  # each config's tables and graph pool go before the next's
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
