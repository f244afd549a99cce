#!/usr/bin/env python3
"""Build the port's kernels and drive its serving, training and evaluation paths on one card.

    python3 chip_smoke.py [--profile | --profile=PHASE[,PHASE...]]

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, one line each with its elapsed seconds:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every native source of the port (``besskge_tpu_torch/csrc/*.cu``
   with ``nvcc``, ``csrc/bess_host.cpp`` with the host compiler), one
   compiler process each, in parallel; then ``ptxas``'s registers, shared
   memory and spills of every kernel of ``l1_distance.cu`` and
   ``dense_adamw.cu`` (the gradient, distance and AdamW kernels must not
   spill);
3. kernels: each kernel against its plain PyTorch version on the card, with
   times of the kernel, the plain version, one PyTorch library call, and the
   card's bound. B7/B5 at the serving shape, a ragged shape and a shape with
   a wholly invalid 128-column chunk, in fp32 and bf16; B1/B2/B6 at the
   training shape (8 x 256 x 288 x 128) and a ragged one, in fp32 and bf16,
   with planted exact ties, B2/B6 also giving the same bits on a repeat call
   and launching one kernel per call; B1 (and B5 for one group) at the edges
   of the distance kernel's tiles, with 200-byte bf16 rows, rows that are not
   runs of 4 values and an unaligned base, each call one
   ``l1_distance_small_kernel`` and a repeat call the same bits, and B5 timed
   at the autograd path's shape (256, 288, 128) fp32; B3/B4 with R = 8,704 slots over the
   (5,001,208, 128) pair-major table and a ragged R, with duplicate runs
   whose later slots hold garbage; B8 with k = 2 and 3 tables of
   (2,500,604, 128) at the same slots, and with unequal lists and a
   (1, n, D) block; B9 with h = 2 over the pair-major table; B10 over the
   (93,773, 128) biokg table in fp32 and with a bf16 param, and over a table
   whose size is not a multiple of 4, timed as a whole call (one kernel) and
   by kernel name beside ``torch.optim.AdamW(fused=True).step()``;
4. serving: ``build_topk_forward`` of TransE-L1 at ogbl-wikikg2 width
   (2,500,604 entities, 535 relation types, d = 128, 512 queries per batch,
   k = 10) once with the chunk merge (B7) and once with the sort merge (B5);
   MRR of planted answers, and the top-10 of 32 queries against a plain
   full-table reference;
5. autograd: ``p_distance_matrix(·, ·, 1)`` with a gradient on the card
   (B5 forward, B6 backward) against the sign-subgradient formula;
6. training: the sparse TransE-L1 step of the wikikg2 configuration
   (1,000,000 random triples, 32 shared "ht" negatives with augmentation,
   bf16 scoring, RowSGDM interleaved, 8 x 512 positives per step) through
   ``build_train_step``: one step held against the same step on the CPU,
   one step of each update variant held against the B3 step (B4 and the
   "pallas_gather" variant, B9 + B3, bit for bit; RowSGDM with a separate
   momentum buffer, B8, bit for bit after ``split_interleaved``), one
   RowAdamW step with separate moments (B8, k = 3) held against the CPU
   step and against the treble-interleaved RowAdamW step (B3, h = 3, bit
   for bit), one RowAdagrad step with a separate accumulator (B8, k = 2)
   held against the CPU step (its accumulator the square of the card's
   gradient bit for bit) and against the pair-major RowAdagrad step (B3,
   h = 2, bit for bit), packed bf16 RowAdagrad in the triplet store (B3,
   h = 3) against separate packed buffers (B8, k = 2) bit for bit,
   ``Trainer.fit`` over a few steps, and 2 x 20 timed steps of each of the
   eight variants;
7. dense training: the dense RotatE step of the biokg configuration
   (``bench.py`` ``_setup_biokg``: 93,773 entities, 51 relation types,
   d = 2 x 64, 4,762,678 random triples, one shared "ht" negative,
   ``LogSigmoidLoss`` with adversarial weights, 48 x 240 positives per step)
   with ``FusedDenseAdamW`` (B10) on the table and ``AdamW`` on the
   relations: one step held against the same step on the CPU,
   ``Trainer.fit`` over a few steps, and 2 x 20 timed steps beside 2 x 20 of
   the plain dense ``AdamW`` form (``entity_optimizer=None``, no kernel).

8. device training: ``bench.py``'s headline steps as it runs them, with the
   batch drawn on the card by ``DeviceBatchSampler`` ("runs" positives) and
   ``build_device_train_step`` making one CUDA graph of each call: the
   wikikg2 step at ``steps_per_call`` 8 and the biokg step, with plain
   ``AdamW`` and with ``FusedDenseAdamW``, at 10. Gates: a call's batches
   drawn on the card equal the CPU's bit for bit; one ``steps_per_call=1``
   call on the card is held against the same call on the CPU; the first
   call (eager, then captured) and two replays are each held against the
   eager card steps from the same state with the same key, the replays
   under ``torch.cuda.set_sync_debug_mode("error")``, with their launches
   counted (B1 and B2 2 x spc and B3 spc per wikikg2 call, B10 spc per
   fused biokg call) and a replay's kernels counted by name by the
   profiler; ``Trainer.fit`` over three calls of each; then 2 x 5 timed
   calls of each form, in turns.
9. packed training: ``bench.py``'s wikikg2_bf16 and wikikg2_fp16 steps as
   it runs them: both tables 16-bit, the entity table row-pair-packed
   (int32 bf16 pairs, uint32 fp16 pairs) in the (3,750,906, 128) triplet
   store of ``RowSGDM`` interleaved, device-sampled at ``steps_per_call``
   8 in one CUDA graph. Gates, for each: the batches as in phase 8; one
   ``steps_per_call=1`` call against the CPU (each 16-bit value within lr x
   the two devices' momentum difference plus one ulp, two for fp16;
   untouched rows and sibling planes bit for bit); the first
   call and two replays against the eager card steps, bit for bit on every
   array, no host sync, B1/B2 16 and B3 8 launches per call by name; the
   triplet store against separate buffers (B3 h = 3 against B8 k = 2) and
   the quintuplet store against separate AdamW buffers (B3 h = 5 against
   B8 k = 3) over one host-fed step, bit for bit; ``Trainer.fit``, which
   widens the packed table; sets of timed calls in turns with the fp32
   wikikg2 step; and a JSON line of times, table bytes, captures and
   launches.
10. checkpoint: the wikikg2 (fp32 pair-major) and wikikg2_bf16 (triplet
   store) device-sampled steps of phase 9, each run for 4 calls, and again
   for 2 calls through a ``Trainer`` that ``save``s; a fresh ``Trainer``
   from ``load_checkpoint`` (the file's optimizer state, counts 0-dim int32
   on the card) runs calls 2 and 3, and every array must equal the
   uninterrupted run bit for bit. Then one call of RowAdagrad in the
   pair-major store (B3, h = 2), saved with ``opt/entity/acc`` and loaded
   back bit for bit; and the fp32 file re-sharded onto 4 shards, saved,
   re-sharded back onto 1: table and momentum bit for bit, and 512 top-10
   queries (B7 chunk merge) over the restored table equal the original's by
   global entity ID. Files go to a temporary directory, deleted afterwards;
   a JSON line gives each file's bytes, save and load seconds and the
   host's peak extra RSS beside the card's name and power limit. The phase
   traces nothing (``--profile`` does not take it).
11. yago: ComplEx at YAGO3-10 width (123,182 entities, 37 relation types,
   ``embedding_size`` 128: rows of 256 fp32 values). Served as
   ``bench.py``'s ``topk_yago`` serves it (``initial_params_device``, 512
   queries, top-10, the default window 32768 and chunk merge; ms per batch
   the best of 3 x 20): the top-10 of 32 queries against one full-fp32
   product with the whole table (scores within 1e-5 x (|want| + max|want|),
   IDs as sets where the 10th and 11th stand apart), the chunk merge equal
   to the sort merge, 64 queries equal to the CPU's, planted answers MRR 1,
   and the batch's peak memory. Trained as ``examples/yago_topk_prediction.py``
   trains it, on one shard and at d = 128 (1,079,040 random triples, 8
   shared "ht" negatives, ``LogSigmoidLoss(12, adversarial)``, 8 x 120
   positives, ``FusedDenseAdamW`` (B10) on the table, ``AdamW`` on the
   relations): one host-fed step against the CPU, a device-sampled call at
   ``steps_per_call`` 10 (first call and two replays equal to the eager card
   steps bit for bit, B10 10 times per call by name), ``Trainer.fit`` over
   three calls, 2 x 5 timed calls; then the trained table served again.
12. scorers: DistMult, PairRE, TripleRE, BoxE, InterHT and TranS, each in
   TransE's place on the wikikg2 step of phase 6 (p = 1 for the distance
   scorers, bf16 scoring math, ``RowSGDM`` interleaved, B3): one host-fed
   step against the CPU (the sparse gate), one device-sampled call at
   ``steps_per_call`` 8 (first call and two replays equal to the eager card
   steps bit for bit, B3 8 times per call by name), 2 x 5 timed calls, the
   capture's peak memory, and the top-10 of 64 queries against all
   2,500,604 entities of the trained table, held against a full-table
   reference through ``score_triple`` (scores within 2^-7 x (|want| +
   max|want|), each returned ID's own reference score too).
13. eval: ``bench.py``'s ``valid`` and ``allscores`` modes as it runs them,
   on random data from the seed. Valid: TransE-L1 over 2,500,604 entities,
   535 relation types, d = 128, bf16 scoring without sharing; 40,960 valid
   triples (heads and tails distinct entities) with 500 random tail
   candidates each, ``TripleBasedShardedNegativeSampler`` over an
   "ht_shardpair" partition, ``RigidShardedBatchSampler`` (10 x 256),
   ``ScoreMovingBessKGE`` with MRR and hits@10 sums, ``run_device_eval``
   with 16 steps per block. Gates: two steps with fp32 scoring on the card
   against the CPU (scores within 1e-5 x (|want| + max|want|), ranks equal
   away from ties); with each true tail row set to head + relation, MRR 1.0
   through ``run_device_eval`` and through the device-resident blocks, which
   run under ``torch.cuda.set_sync_debug_mode("error")``; no kernel of ours
   on the path. Times: queries/s with pre-staged blocks (median of 3), the
   rate through ``run_device_eval`` once. Then candidate-set top-10
   (``mask_on_gather=True``) over the same candidates (2,048 queries, no
   sharing) and over one set of 4,096 entities shared by all queries
   (sharing: B5, 4 launches per batch by name), each in fp32 and bf16
   scoring against a plain ranking of each query's own candidates, the bf16
   one timed. Allscores: TransE-L1 with sharing over 500,000 entities, 1,024
   (h, r, ?) queries (4 x 256 per batch), ``AllScoresPipeline`` with windows
   of 65,536 (8, the last clamped). Gates: a filtered pass (8 other known
   tails per query) whose -inf entries are exactly the pairs of
   ``get_entity_filter`` and whose ranks equal a numpy ranking of the
   returned matrix; with planted answers, the returned matrix within 2^-7 x
   (|want| + max|want|) of one full-table matrix of B5's plain version and
   MRR 1.0, B5 32 launches per pass (wrappers) and per batch (by name);
   every window of a batch swept under ``set_sync_debug_mode("error")``.
   Times: the device sweep (median of 3 x 5 sweeps) as candidate-scores/s
   and ms per batch, B5 per launch at (256, 65,536, 128) bf16 beside its
   bound, the pipeline end to end once. A JSON line of these numbers.
14. conve: ConvE at YAGO3-10 width with the ConvE paper's settings (the
   repo's defaults: d = 200 as 10 x 20, 32 channels of 3 x 3, dropout 0.2 /
   0.2 / 0.3, BatchNorm; 123,182 x 201 table, 74 relation rows, fc_w 10,368
   x 200), on the YAGO stand-in triples doubled by ``add_inverse_triples``,
   8 x 120 positives, 8 shared "t" negatives, SSCE. (a) One dense host-fed
   step (``FusedDenseAdamW``, B10, and ``AdamW``) with a dropout key against
   the CPU's from copies of one state: the step's 24 dropout masks drawn on
   the card equal the CPU's bit for bit, every param and moment within the
   dense gate, the BN running stats moved; then 2 x 5 timed steps. (b) The
   same step device-sampled at 10 steps per call, one CUDA graph with its
   dropout drawn inside (the dropout key in a static buffer): the first
   call and two replays equal the eager card steps bit for bit, no host
   sync, B10 10 per call by name; each dropout site's keep rate over a call
   within 4 sigma of 1 - p; 2 x 5 timed calls. (c) One sparse host-fed step
   (``RowSGDM`` interleaved, B3) against the CPU within the sparse gate. (d)
   Top-10 of 512 tail queries against all entities (``train=False``), held
   against a full-table reference and the CPU. (e) One ``AllScoresPipeline``
   pass over 20,000 entities, its matrix within 1e-5 of a full-table one.
   Then B10 at 123,182 x 201 fp32 against its plain version and timed
   beside its bound, and the conv's cost under deterministic cuDNN without
   TF32 against cuDNN's defaults. ``--profile=conve`` traces two calls and
   gives the conv and FC kernels' share of the device time.
15. mesh: the BESS scheme over a mesh of ranks (``besskge_tpu_torch.parallel``).
   One card holds no two NCCL ranks, so: (a) the wikikg2 device-sampled call
   of phase 8 over a one-rank NCCL mesh (``make_shard_mesh(1)``,
   ``build_device_train_step(mesh=...)``), its all-to-alls and all-reduce
   captured in the call's CUDA graph: the census of the first call (eager
   warm-up and capture: 2 x bps all-to-alls of the bf16 rows and one
   all-reduce per step), B5/B6 2 x bps and B3 once per step by wrapper,
   replays equal to their eager steps bit for bit under the sync debug
   mode, each call held within the dense gate against the same call
   without a mesh, and ms per step beside it (two sets); (b) four ranks
   sharing the card over gloo at full width (625,151 rows per block,
   ``bench.py``'s batch geometry), spawned with
   ``parallel.multihost._spawn``: each rank's initial block equal to its
   rows of the one-process draw, top-10 of 512 queries per batch against all
   2,500,604 entities (B7, 2 all-gathers and 2 all-to-alls per batch) held
   against a full-table reference, one host-fed step (B5/B6 2 x bps, B3
   once) held within the sparse gate against the same step on CPU gloo
   ranks from copies of one state, timed steps, device-sampled calls (which
   gloo runs uncaptured, as the step's ``uncaptured`` says), ``Trainer.fit`` (the
   replicated params equal on every rank) and a sharded checkpoint saved
   and loaded back onto the four ranks bit for bit. Gloo runs uncaptured;
   its times are gloo on one card, no measure of NCCL across cards.
16. bench: ``python3 bench_torch.py``, the port's bench entry point, in a
   subprocess with every name and its default step counts: one line per
   name of ``bench.py`` (``BENCH_METRICS``), each value finite and positive
   (the overlap at one rank 0, no collective kernel running there), the
   census contract true, each training line's device busy share, MFU and
   HBM share in (0, 100] and its rate within ``BENCH_RATIO`` of the same
   configuration's device-sampled step in phases 8 and 9 (the ratio is
   printed); then one device-sampled call of its wikikg2 and wikikg2_bf16
   set-ups counted by wrapper (first call) and by name (a replay): B1, B2
   2 x spc and B3 spc per call, B4, B8 and B9 none.

Each path is driven with every launch count set to 0 just before it and
read just after. Then one JSON line describing each kernel, and the result
line. Any failed check raises, so the script exits non-zero and prints no
result; so it does when no CUDA card is available. ``--profile`` adds a
``torch.profiler`` trace of the training steps of each training phase
(``training``, ``dense``, ``device``, ``packed``, ``yago``, ``scorers``)
and of the ``eval`` phase's device-resident valid blocks and all-scores
sweep, and of the ``conve`` phase's calls (``--profile=yago,eval`` traces
only the named ones): device time by kernel, and the device's busy share.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_torch  # noqa: E402
from besskge_tpu_torch import _build, checkpoint, monitor, optim, packed, scoring, trainer  # noqa: E402
from besskge_tpu_torch.batch_sampler import (  # noqa: E402
    RandomShardedBatchSampler,
    RigidShardedBatchSampler,
)
from besskge_tpu_torch.bess import (  # noqa: E402
    _FORWARD_KEYS,
    EmbeddingMovingBessKGE,
    ScoreMovingBessKGE,
    TopKQueryBessKGE,
    _batch_tensors,
    build_bess_forward,
    build_topk_forward,
)
from besskge_tpu_torch.dataset import KGDataset  # noqa: E402
from besskge_tpu_torch.device_sampler import DeviceBatchSampler, split_key  # noqa: E402
from besskge_tpu_torch.eval_loop import _stack_block, make_block_runner, run_device_eval  # noqa: E402
from besskge_tpu_torch.loss import LogSigmoidLoss, SampledSoftmaxCrossEntropyLoss  # noqa: E402
from besskge_tpu_torch.metric import Evaluation  # noqa: E402
from besskge_tpu_torch.negative_sampler import (  # noqa: E402
    PlaceholderNegativeSampler,
    RandomShardedNegativeSampler,
    TripleBasedShardedNegativeSampler,
)
from besskge_tpu_torch.ops import adamw_kernels, distance, l1_kernels, row_kernels  # noqa: E402
from besskge_tpu_torch.parallel import make_shard_mesh, multihost, shard_params  # noqa: E402
from besskge_tpu_torch.parallel.census import collective_census  # noqa: E402
from besskge_tpu_torch.parallel.multihost import _spawn  # noqa: E402
from besskge_tpu_torch.pipeline import AllScoresPipeline  # noqa: E402
from besskge_tpu_torch.profiling import DISTANCE_EDGES, device_kernels  # noqa: E402
from besskge_tpu_torch.scoring import ComplEx, ConvE, RotatE, TransE  # noqa: E402
from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding  # noqa: E402
from besskge_tpu_torch.utils import (  # noqa: E402
    _tree_map,
    complex_multiplication,
    get_entity_filter,
)

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

# Training configuration: bench.py's wikikg2 recipe (_setup_wikikg2) with the
# momentum interleaved and bf16 scoring math.
N_TRIPLE, SHARD_BS_TRAIN, BPS, N_NEGATIVE, LR, MOMENTUM = 1_000_000, 512, 8, 32, 1e-3, 0.9
FIT_TRIPLES = 40_960  # Trainer.fit over 10 steps
TIMED_STEPS = 20
N_UNTOUCHED = 10_000
# Card against CPU at bf16 scoring: each side rounds its fp32 distance sums
# (B1) and row gradients (B2, cast to bf16 by the VJP) to bf16, and the two
# may land on neighbouring values: one bf16 ulp of a score moves the loss by
# at most that relative amount, and a gradient (hence a momentum row) by a
# bf16 ulp of each contribution, bounded by 2^-7 of the largest value.
BF16_STEP_RTOL = 2.0**-7
U32 = 2.0**-24

# Dense configuration: bench.py's biokg recipe (_setup_biokg) at full width:
# RotatE(scoring_norm=2, embedding_size=64), so 128 fp32 values per entity row.
DENSE_ENTITY, DENSE_RELATION, DENSE_EMB = 93_773, 51, 64
DENSE_TRIPLE, DENSE_SHARD_BS, DENSE_BPS, DENSE_LR = 4_762_678, 240, 48, 1e-3
DENSE_FIT_STEPS = 4
# Card against CPU in the dense step: fp32 sums of the same terms in other
# orders (atomics in the card's scatter-add of the table gradient), relative
# to each array's largest value. An AdamW update is lr·m̂/(√v̂ + eps), which
# follows g/|g| where |g| is near eps: there a gradient that differs by a
# few ulps between the devices moves the update by much more. So a param is
# held to the tolerance plus lr·|r_card − r_cpu|, where r = m̂/(√v̂ + eps) of
# each device's own moments, and the moments themselves to the tolerance.
DENSE_RTOL = 1e-5

# Device-sampled training: bench.py's headline steps as it runs them, the
# batch drawn on the device from a key ("runs" positives) and
# steps_per_call steps per call, one CUDA graph on the card.
WIKIKG2_SPC, BIOKG_SPC = 8, 10
# Timed calls per set: at least DEVICE_TIMED_CALLS, and enough to fill
# DEVICE_TIMED_S seconds.
DEVICE_TIMED_CALLS, DEVICE_TIMED_S = 20, 0.5
DEVICE_FIT_CALLS = 3
# 16-bit tables: bench.py's wikikg2_bf16 and wikikg2_fp16 configurations,
# the entity table row-pair-packed (int32 bf16 pairs, uint32 fp16 pairs) in
# the triplet store of RowSGDM interleaved, the relation table 16-bit too.
PACKED = {"wikikg2_bf16": torch.bfloat16, "wikikg2_fp16": torch.float16}

# YAGO3-10 at bench.py's topk_yago width (run_topk): ComplEx on one shard,
# 123,182 entities, 37 relation types, embedding_size 128 (entity rows of
# 256 fp32 values), 512 queries per batch, k = 10, the default window
# (32768) and merge (chunk); ms per batch the best of 3 repeats of 20.
YAGO_ENTITY, YAGO_RELATION, YAGO_EMB, YAGO_QUERIES = 123_182, 37, 128, 512
YAGO_BATCHES, YAGO_REPEATS = 20, 3
# ComplEx trained as examples/yago_topk_prediction.py trains it, on one
# shard (the example: four) and at d = 128 as topk_yago serves it (the
# example: 64): 8 shared "ht" negatives, LogSigmoidLoss(12, adversarial),
# 8 x 120 positives per step, FusedDenseAdamW on the table and AdamW on the
# relations at lr 1e-3 with optax.adamw's weight decay 1e-4; random triples
# standing for YAGO3-10's 1,079,040 training triples; 10 steps per
# device-sampled call, 2 sets of 5 timed calls.
YAGO_TRIPLE, YAGO_NEGATIVE, YAGO_SHARD_BS, YAGO_BPS, YAGO_LR = 1_079_040, 8, 120, 8, 1e-3
YAGO_SPC, YAGO_TIMED_CALLS = 10, 5
# The other scorers on the wikikg2 step (_setup_wikikg2 with the scorer in
# TransE's place, p = 1 for the distance scorers, each scorer's defaults
# otherwise), and their top-10 of 64 queries against every entity.
SCORERS = ("DistMult", "PairRE", "TripleRE", "BoxE", "InterHT", "TranS")
# Scorers whose bf16 scores are too coarse for the sparse gate: BoxE sums
# 2 x 128 box distances of order 1, so |score| ~ 10^2, one bf16 ulp of a
# score is 0.5-1 and moves its softmax weight by up to e^0.5; the gate's
# premise (one ulp of a score moves the loss by at most 2^-7) fails, and
# the card's and the CPU's gradients differ past it where a score rounds
# the other way. Their card-vs-CPU step is held with fp32 scoring math, the
# same state and batch; the bf16 step's distance to the gate is reported.
FP32_HELD = ("BoxE",)
SCORER_QUERIES, SCORER_TIMED_CALLS = 64, 5
# ConvE at YAGO3-10 width with the ConvE paper's settings (Dettmers et al.,
# AAAI 2018; the repo's ConvE defaults): YAGO_ENTITY entities, YAGO_RELATION
# relation types with inverses (74 relation rows), d = 200 as 10 x 20 (entity
# rows of 201 with the tail bias), 32 channels of 3 x 3 (fc_in 10,368),
# dropout 0.2 / 0.2 / 0.3, BatchNorm; YAGO_TRIPLE random triples doubled by
# add_inverse_triples, 8 x 120 positives per step, YAGO_NEGATIVE shared flat
# "t" negatives, SSCE, lr 1e-3; FusedDenseAdamW (B10) on the table and AdamW
# on the rest (dense), or RowSGDM interleaved (B3, sparse); device-sampled at
# 10 steps per call; 512 top-10 queries; one all-scores pass over 20,000
# entities (512 queries, windows of 4,096). CONVE_RNG seeds the dropout keys.
CONVE_EMB, CONVE_H, CONVE_W = 200, 10, 20
CONVE_SHARD_BS, CONVE_BPS, CONVE_LR, CONVE_SPC, CONVE_TIMED_CALLS = 120, 8, 1e-3, 10, 5
CONVE_QUERIES, CONVE_AS_ENTITY, CONVE_AS_QUERIES, CONVE_AS_WINDOW = 512, 20_000, 512, 4096
CONVE_RNG = 12345
# ConvE params whose gradient is near 0 at the first step, where BatchNorm
# takes batch statistics: conv_b's is exactly 0 (a per-channel shift before
# bn1), bn0's scale's 0 up to the 1e-5 in bn1's rsqrt(var + 1e-5) (one input
# channel, bn0's bias at its initial 0, so bn1 undoes the scale). Both
# devices hold rounding noise of cancelling terms there; their moments are
# held against the largest moment of the state, and the phase prints their
# CPU gradients beside the largest.
CONVE_NOISE = ("conv_b", "bn0.scale")
# Over a mesh with sync_batch_norm (the mesh phase's (d)), bn0's bias too:
# with one input channel its gradient is one value that sums a term per
# pixel of every positive's input map, per rank and then over the ranks
# (1,536,000 terms at YAGO3-10 width). The per-array gate leaves a
# one-value array 2e-5 of it, under that sum's fp32 rounding (sqrt(terms) x
# 2^-24 = 7.4e-5): the card strays 2.3e-5 from float64 there (NVIDIA H100
# 80GB HBM3, 700.00 W), and the phase prints that reading beside the
# bound. So its moments are held against the largest moment too.
MESH_CONVE_NOISE = CONVE_NOISE + ("bn0.bias",)
# Evaluation: bench.py's run_valid (TransE-L1 at wikikg2's counts, bf16
# scoring, no sharing; 40,960 random valid triples with 500 random tail
# candidates each; ScoreMoving through run_device_eval, 16 steps of 10 x 256
# per block; rates the median of 3) and candidate-set top-10 over the same
# candidates (2,048 queries, 4 x 256 per batch) and over one set of 4,096
# shared by all queries (sharing: B5); bench.py's run_allscores (500,000
# entities, sharing, 1,024 (h, r, ?) queries, 4 x 256 per batch, windows of
# 65,536: 8, the last clamped), each query with 8 other known tails in the
# filtered pass; the device sweep timed as the median of 3 x 5 sweeps.
VALID_QUERIES, VALID_CANDIDATES, VALID_SHARD_BS, VALID_BPS = 40_960, 500, 256, 10
VALID_SPB, VALID_REPEATS, VALID_CPU_STEPS = 16, 3, 2
VALID_TOPK_QUERIES, TOPK_BPS, FLAT_CANDIDATES = 2048, 4, 4096
AS_ENTITY, AS_QUERIES, AS_SHARD_BS, AS_BPS, AS_WINDOW = 500_000, 1024, 256, 4, 65_536
AS_KNOWN, AS_REPEATS, AS_SWEEPS = 8, 3, 5

# The mesh (ROADMAP A15a): the wikikg2 step over a mesh of ranks on the one
# card. NCCL cannot put two ranks on one card, so: the NCCL path at one rank
# (the device-sampled call at WIKIKG2_SPC, its collectives captured in the
# graph; MESH_TIMED_CALLS calls per timed set), and MESH_RANKS ranks sharing
# the card over gloo at full width (625,151 rows per block, bench.py's batch
# geometry): a host-fed step against the CPU ranks, MESH_TIMED_STEPS timed
# steps, top-10 of MESH_QUERIES queries per batch against all entities
# (MESH_TOPK_REPEATS passes timed), Trainer.fit over the first
# MESH_FIT_TRIPLES triples (3 steps), a sharded checkpoint round trip. The
# ranks are stopped after MESH_TIMEOUT_S seconds.
MESH_RANKS, MESH_TIMED_CALLS, MESH_TIMED_STEPS = 4, 5, 3
MESH_QUERIES, MESH_TOPK_REPEATS, MESH_FIT_TRIPLES, MESH_TIMEOUT_S = 512, 2, 45_000, 600
# The rest of the mesh (ROADMAP A15b) in the same phase, at the widths of the
# eval and conve phases: (a) bench.py's valid through run_device_eval, (b) its
# allscores pipeline (over the gloo ranks MESH_AS_BPS micro-batches of
# AS_SHARD_BS queries per rank, so that the 1,024 queries, about 256 per
# shard, fit one batch: each window scores (4 x 256, 65,536) per
# micro-batch), (c) a ScoreMoving sparse wikikg2 step, (d) ConvE with
# sync_batch_norm at YAGO3-10 width over the gloo ranks.
MESH_AS_BPS = 2
# The valid pass over the mesh against the mesh-free pass: the same
# per-candidate scores and ranks, whose fp32 metric sums differ in order
# only: at most (steps per block + log2 of a step's queries + the ranks'
# sum) roundings of the sum on each side, under 32 each.
VALID_SUM_ULPS = 64

# bench_torch.py, the port's bench entry point (ROADMAP A16), run as a user
# runs it: bench.py's metric of each name, written out here (bench.py imports
# JAX); the run's time limit; and the band in which a training line's rate
# must lie against the same configuration's device-sampled step in this run's
# device and packed phases (the same card, the same call; bench.py's timing
# window is shorter).
BENCH_METRICS = {
    "census": "bess_collective_census_nshard8",
    "overlap": "bess_collective_overlap",
    "biokg": "biokg_rotate_train_pos_triples_per_s_per_chip",
    "wikikg2": "wikikg2_transe_sparse_train_pos_triples_per_s_per_chip",
    "wikikg2_bf16": "wikikg2_transe_bf16table_train_pos_triples_per_s_per_chip",
    "wikikg2_fp16": "wikikg2_transe_fp16table_train_pos_triples_per_s_per_chip",
    "valid": "wikikg2_scoremoving_valid500_queries_per_s_per_chip",
    "allscores": "allscores_pipeline_candidate_scores_per_s_per_chip",
    "topk_yago": "yago_complex_topk_vs_all_queries_per_s_per_chip",
}
BENCH_TIMEOUT_S, BENCH_RATIO = 600, (0.8, 1.25)

L1_SOURCE = "besskge_tpu_torch/csrc/l1_distance.cu"
ROW_SOURCE = "besskge_tpu_torch/csrc/row_update.cu"
ADAMW_SOURCE = "besskge_tpu_torch/csrc/dense_adamw.cu"
KERNELS = {
    "l1_scores_chunkmax": {
        "id": "B7", "source": L1_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_distance.py:153",
        "wrapper": l1_kernels.l1_scores_chunkmax,
    },
    "l1_distance_matrix": {
        "id": "B5", "source": L1_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_distance.py:89",
        "wrapper": l1_kernels.l1_distance_matrix,
    },
    "l1_distance_matrix_batched": {
        "id": "B1", "source": L1_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_distance.py:238",
        "wrapper": l1_kernels.l1_distance_matrix_batched,
    },
    "l1_distance_grads_batched": {
        "id": "B2", "source": L1_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_distance.py:394",
        "wrapper": l1_kernels.l1_distance_grads_batched,
    },
    "l1_distance_grads": {
        "id": "B6", "source": L1_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_distance.py:310",
        "wrapper": l1_kernels.l1_distance_grads,
    },
    "scatter_rows": {
        "id": "B3", "source": ROW_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_scatter.py:428",
        "wrapper": row_kernels.scatter_rows,
    },
    "fused_pair_sgdm": {
        "id": "B4", "source": ROW_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_row_sgdm.py:149",
        "wrapper": row_kernels.fused_pair_sgdm,
    },
    "scatter_rows_multi": {
        "id": "B8", "source": ROW_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_scatter.py:365",
        "wrapper": row_kernels.scatter_rows_multi,
    },
    "gather_rows": {
        "id": "B9", "source": ROW_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_scatter.py:303",
        "wrapper": row_kernels.gather_rows,
    },
    "dense_adamw_update": {
        "id": "B10", "source": ADAMW_SOURCE,
        "replaces": "besskge_tpu/ops/pallas_adamw.py:50",
        "wrapper": adamw_kernels.dense_adamw_update,
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


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn``: the summed durations of the kernels it
    launches over ``reps`` calls (:func:`device_kernels`). Unlike
    :func:`cuda_ms` it leaves out the idle gaps in which the device waits for
    the host to launch the next kernel, which are most of the time of a
    kernel of a few microseconds."""
    return sum(ms for ms, _ in device_kernels(fn, reps).values())


def one_kernel(what: str, kernels: Dict[str, tuple], name: str) -> float:
    """The device ms of the one kernel that each call launched, which must be
    named ``name``; raises when a call launched any other kernel, or more
    than one. The tracer may drop a launch but never adds one, so the check
    is on the kernels recorded (one name, at most one launch per call), and
    the time is per recorded launch."""
    launches = {key: n for key, (_, n) in kernels.items()}
    if len(kernels) != 1 or name not in next(iter(kernels)) or not 0 < min(launches.values()) <= 1:
        raise AssertionError(f"{what}: launches per call {launches}, expected one {name}")
    ms, n = next(iter(kernels.values()))
    return ms / n


def bound_ms(B: int, N: int, d: int, in_bytes: int, out_bytes: int) -> tuple:
    """Least time for a (B, N, d) L1 problem: 2 fp32 instructions (subtract,
    add of |.|) per (i, j, k) at the instruction rate, or every input read
    and every output written once at the HBM rate, whichever is larger."""
    return bound_of(2.0 * B * N * d, in_bytes + out_bytes)


def bound_of(fp32_instructions: float, n_bytes: float) -> tuple:
    """(ms, "operations" or "bytes"): the larger of the instructions at the
    fp32 instruction rate and the bytes at the HBM rate."""
    ops_ms = fp32_instructions / FP32_INSTR_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def reset_counts() -> None:
    l1_kernels.reset_launch_counts()
    row_kernels.reset_launch_counts()
    adamw_kernels.reset_launch_counts()


def read_counts() -> Dict[str, int]:
    return {name: spec["wrapper"].launches for name, spec in KERNELS.items()}


def _launched() -> Dict[str, int]:
    """The launch counts of the kernels that launched."""
    return {name: n for name, n in read_counts().items() if n}


def expect_counts(path: str, counts: Dict[str, int], want: Dict[str, int]) -> None:
    """Launch counts of one run of a path (of every kernel, or of those that
    launched): the named kernels exactly, every other kernel 0."""
    full = {name: want.get(name, 0) for name in KERNELS}
    if {name: counts.get(name, 0) for name in KERNELS} != full or not counts.keys() <= full.keys():
        raise AssertionError(f"{path}: launches {counts}, expected {full}")


def sum_tol(w: torch.Tensor, dim: int) -> torch.Tensor:
    """Two fp32 sums of the n terms ±w along ``dim`` in different orders
    differ by at most 2·n·2^-24·Σ|w| (recursive summation bound)."""
    return 2 * w.shape[dim] * U32 * w.abs().sum(dim).unsqueeze(-1) + 1e-30


def uniform(shape, gen, d):
    return (torch.rand(shape, device="cuda", generator=gen) * 2 - 1) / d


def check_kernels(gen: torch.Generator) -> dict:
    """B7 and B5 against their plain versions; times at the serving shape."""
    results = {name: {"max_abs_err": 0.0} for name in ("l1_scores_chunkmax", "l1_distance_matrix")}
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
        reset_counts()
        fwd(params, batches[0])  # warm-up
        sync(device)
        t = time.perf_counter()
        outs = [fwd(params, b) for b in batches]
        sync(device)
        ms = (time.perf_counter() - t) / len(batches) * 1e3
        launches = read_counts()
        if device == "cuda":
            n_windows = -(-sharding.max_entity_per_shard // topk.window_size)
            expect_counts(f"serving merge={merge}", launches,
                          {kernel: n_windows * (len(batches) + 1)})

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


def _pair_slots(gen: torch.Generator, n_logical: int, slots: int, width: int) -> tuple:
    """B3's inputs over a pair-major table of ``n_logical`` row pairs:
    sorted physical indices of ``slots`` random rows with duplicate runs,
    the mask of each run's first slot, and (2 x slots, width) rows with NaN
    in the duplicate slots, which B3 skips."""
    logical = torch.randint(0, n_logical, (slots,), device="cuda", generator=gen)
    logical[1::5] = logical[0::5][: logical[1::5].shape[0]]  # duplicate runs
    phys = (2 * torch.sort(logical).values).to(torch.int32)
    first = torch.ones(slots, dtype=torch.bool, device="cuda")
    first[1:] = phys[1:] != phys[:-1]
    rows = torch.randn(2 * slots, width, device="cuda", generator=gen)
    rows.view(slots, 2, width)[~first] = float("nan")
    return phys, first, rows


def check_training_kernels(gen: torch.Generator, table_rows: int) -> dict:
    """B1, B2, B6, B3 and B4 against their plain versions on the card, and
    their times at the training step's shapes."""
    results = {name: {"max_abs_err": 0.0} for name in (
        "l1_distance_matrix_batched", "l1_distance_grads_batched", "l1_distance_grads",
        "scatter_rows", "fused_pair_sgdm")}
    G, B, N, d = BPS, SHARD_BS_TRAIN // 2, SHARD_BS_TRAIN // 2 + N_NEGATIVE, DIM
    for shape in [(G, B, N, d), (3, 37, 211, 100)]:
        for dtype in (torch.float32, torch.bfloat16):
            g_, b_, n_, d_ = shape
            a = uniform((g_, b_, d_), gen, d_).to(dtype)
            b = uniform((g_, n_, d_), gen, d_).to(dtype)
            k = min(b_, n_) // 2
            b[:, :k, : d_ // 2] = a[:, :k, : d_ // 2]  # planted exact ties
            w = torch.randn(g_, b_, n_, device="cuda", generator=gen)
            dist = l1_kernels.l1_distance_matrix_batched(a, b)
            da, db = l1_kernels.l1_distance_grads_batched(a, b, w)
            da6, db6 = l1_kernels.l1_distance_grads(a[0], b[0], w[0])
            again = (*l1_kernels.l1_distance_grads_batched(a, b, w),
                     *l1_kernels.l1_distance_grads(a[0], b[0], w[0]))
            torch.cuda.synchronize()
            # No atomics: every sum runs in one fixed order, so a repeat call
            # gives the same bits (the training phase's bit-for-bit gates
            # between step variants rest on it).
            if not all(torch.equal(x, y) for x, y in zip((da, db, da6, db6), again)):
                raise AssertionError("B2/B6 gave other bits on a repeat call")
            ref = l1_kernels.l1_distance_matrix_batched_plain(a, b).float()
            err1 = (dist.float() - ref).abs()
            tol = ATOL + (RTOL + (BF16_ULP if dtype == torch.bfloat16 else 0.0)) * ref.abs()
            if not (err1 <= tol).all():
                raise AssertionError(f"B1 off its plain version by {err1.max().item()}")
            rda, rdb = l1_kernels.l1_distance_grads_batched_plain(a, b, w)
            errs = {}
            for name, got, want, tol in (
                ("l1_distance_grads_batched", da, rda, sum_tol(w, 2)),
                ("l1_distance_grads_batched", db, rdb, sum_tol(w.transpose(1, 2), 2)),
                ("l1_distance_grads", da6, rda[0], sum_tol(w[0], 1)),
                ("l1_distance_grads", db6, rdb[0], sum_tol(w[0].T, 1)),
            ):
                err = (got - want).abs()
                if not (err <= tol).all():
                    raise AssertionError(f"{name} off its plain version by {err.max().item()}")
                errs[name] = max(errs.get(name, 0.0), err.max().item())
            errs["l1_distance_matrix_batched"] = err1.max().item()
            for name, e in errs.items():
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
            say("kernels", f"G={g_} B={b_} N={n_} d={d_} {str(dtype)[6:]}: B1 max|err|"
                f" {errs['l1_distance_matrix_batched']:.3g}, B2 {errs['l1_distance_grads_batched']:.3g},"
                f" B6 {errs['l1_distance_grads']:.3g} (ties planted)")
            if shape == (G, B, N, d) and dtype == torch.bfloat16:
                a32, b32 = a.float(), b.float()
                a_req, b_req = a32.clone().requires_grad_(), b32.clone().requires_grad_()
                lib_out = torch.cdist(a_req, b_req, p=1)
                a0, b0 = a32[0].clone().requires_grad_(), b32[0].clone().requires_grad_()
                lib_out0 = torch.cdist(a0, b0, p=1)
                terms = G * B * N * d
                in_bytes = (G * B + G * N) * d * 2
                results["l1_distance_matrix_batched"].update(
                    ms=one_kernel("B1", device_kernels(
                        lambda: l1_kernels.l1_distance_matrix_batched(a, b), 100),
                        "l1_distance_small_kernel"),
                    event_ms=cuda_ms(lambda: l1_kernels.l1_distance_matrix_batched(a, b), 100),
                    plain_ms=device_ms(lambda: l1_kernels.l1_distance_matrix_batched_plain(a, b), 10),
                    library_ms=device_ms(lambda: torch.cdist(a32, b32, p=1), 20),
                    # subtract and |.|-add per term; bf16 in, bf16 out
                    bound=bound_of(2.0 * terms, in_bytes + G * B * N * 2),
                )
                # per term: subtract, sign, and a multiply-add into each of da
                # and db, counted once (a design that computes each term for
                # da and again for db has its own floor at about twice this);
                # a, b in bf16 and w in fp32 read, da and db written
                grad_bytes = in_bytes + G * B * N * 4 + (G * B + G * N) * d * 4
                results["l1_distance_grads_batched"].update(
                    ms=one_kernel("B2", device_kernels(
                        lambda: l1_kernels.l1_distance_grads_batched(a, b, w), 100),
                        "l1_grads_kernel"),
                    event_ms=cuda_ms(lambda: l1_kernels.l1_distance_grads_batched(a, b, w), 100),
                    plain_ms=device_ms(lambda: l1_kernels.l1_distance_grads_batched_plain(a, b, w), 10),
                    library_ms=device_ms(lambda: torch.autograd.grad(
                        lib_out, (a_req, b_req), w, retain_graph=True), 10),
                    bound=bound_of(4.0 * terms, grad_bytes),
                )
                results["l1_distance_grads"].update(
                    ms=one_kernel("B6", device_kernels(
                        lambda: l1_kernels.l1_distance_grads(a[0], b[0], w[0]), 100),
                        "l1_grads_kernel"),
                    event_ms=cuda_ms(lambda: l1_kernels.l1_distance_grads(a[0], b[0], w[0]), 100),
                    plain_ms=device_ms(lambda: l1_kernels.l1_distance_grads_batched_plain(
                        a[:1], b[:1], w[:1]), 10),
                    library_ms=device_ms(lambda: torch.autograd.grad(
                        lib_out0, (a0, b0), w[0], retain_graph=True), 10),
                    bound=bound_of(4.0 * terms / G, grad_bytes / G),
                )
                del lib_out, lib_out0

    # B3 / B4 over the training step's (2 x 2,500,604, 128) pair-major table.
    table = torch.rand((table_rows, DIM), device="cuda", generator=gen)
    table_plain = table.clone()
    for R in (BPS * (2 * SHARD_BS_TRAIN + 2 * N_NEGATIVE), 1001):
        table_plain.copy_(table)  # the timing runs below move the two apart
        phys, first, rows = _pair_slots(gen, table_rows // 2, R, DIM)
        grads = torch.randn(R, DIM, device="cuda", generator=gen)
        grads[~first] = float("nan")
        lr = torch.tensor(LR, device="cuda")
        for name, kernel, plain, args in (
            ("scatter_rows", row_kernels.scatter_rows, row_kernels.scatter_rows_plain,
             (phys, rows, 2, True)),
            ("fused_pair_sgdm", row_kernels.fused_pair_sgdm, row_kernels.fused_pair_sgdm_plain,
             (phys, grads, lr, MOMENTUM, 0.0)),
        ):
            kernel(table, *args)
            plain(table_plain, *args)
            torch.cuda.synchronize()
            if not torch.equal(table, table_plain):  # copies and unfused fp32 math: equal bits
                diff = (table - table_plain).abs().max().item()
                raise AssertionError(f"{name} off its plain version by {diff}")
        unique = int(first.sum())
        say("kernels", f"R={R} ({unique} unique pairs) over a {table_rows} x {DIM} table: B3 and"
            f" B4 equal to their plain versions, duplicate slots untouched")
        if R != 1001:
            flat_first = (phys[first].long()[:, None] + torch.arange(2, device="cuda")).reshape(-1)
            rows_first = rows.view(R, 2, DIM)[first].reshape(-1, DIM)
            results["scatter_rows"].update(
                ms=device_ms(lambda: row_kernels.scatter_rows(table, phys, rows, 2, True), 100),
                event_ms=cuda_ms(lambda: row_kernels.scatter_rows(table, phys, rows, 2, True), 100),
                plain_ms=device_ms(lambda: row_kernels.scatter_rows_plain(
                    table_plain, phys, rows, 2, True), 10),
                library_ms=device_ms(lambda: table.index_copy_(0, flat_first, rows_first), 100),
                # idx read; each unique pair's rows read and written once
                bound=bound_of(0.0, 4 * R + unique * 2 * (2 * DIM * 4)),
            )
            results["fused_pair_sgdm"].update(
                ms=device_ms(lambda: row_kernels.fused_pair_sgdm(table, phys, grads, lr, MOMENTUM), 100),
                event_ms=cuda_ms(lambda: row_kernels.fused_pair_sgdm(
                    table, phys, grads, lr, MOMENTUM), 100),
                plain_ms=device_ms(lambda: row_kernels.fused_pair_sgdm_plain(
                    table_plain, phys, grads, lr, MOMENTUM), 10),
                library_ms=None,
                # idx read; per unique pair: [p | m] read and written, g read
                bound=bound_of(0.0, 4 * R + unique * (2 * 2 * DIM * 4 + DIM * 4)),
            )
    del table, table_plain
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        say("kernels", f"{KERNELS[name]['id']} {name} at the training shape: kernel {r['ms']:.4f} ms"
            f" on the device ({r['event_ms']:.4f} ms per call between CUDA events),"
            f" plain {r['plain_ms']:.4f} ms, library {lib}, bound {r['bound'][0]:.4f} ms"
            f" ({r['bound'][1]})")
    return results


def check_distance_edges(gen: torch.Generator) -> dict:
    """B1 (and B5 where G = 1) against its plain version at the edges of the
    distance kernel's tiles (``profiling.DISTANCE_EDGES``), fp32 and bf16;
    each call one ``l1_distance_small_kernel``, and a repeat call the same
    bits. B5 timed at the autograd path's shape (256, 288, 128) fp32."""
    errs = {"l1_distance_matrix_batched": 0.0, "l1_distance_matrix": 0.0}

    def tensor(shape, dtype, offset):
        n = int(np.prod(shape))
        flat = torch.empty(n + offset, dtype=dtype, device="cuda")[offset:]
        flat.copy_(uniform((n,), gen, shape[-1]))
        return flat.view(shape)

    for g_, b_, n_, d_, offset in DISTANCE_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = tensor((g_, b_, d_), dtype, offset), tensor((g_, n_, d_), dtype, offset)
            k = min(b_, n_) // 2
            b[:, :k, : d_ // 2] = a[:, :k, : d_ // 2]  # planted exact ties
            ref = l1_kernels.l1_distance_matrix_batched_plain(a, b).float()
            tol = ATOL + (RTOL + (BF16_ULP if dtype == torch.bfloat16 else 0.0)) * ref.abs()
            calls = [("l1_distance_matrix_batched",
                      lambda: l1_kernels.l1_distance_matrix_batched(a, b))]
            if g_ == 1:
                calls.append(("l1_distance_matrix",
                              lambda: l1_kernels.l1_distance_matrix(a[0], b[0])[None]))
            for name, fn in calls:
                first, again = fn(), fn()
                torch.cuda.synchronize()
                if not torch.equal(first, again):
                    raise AssertionError(f"{name} gave other bits on a repeat call at"
                                         f" {a.shape}, {b.shape}")
                err = (first.float() - ref).abs()
                if not (err <= tol).all():
                    raise AssertionError(f"{name} off its plain version by {err.max().item()}"
                                         f" at {a.shape}, {b.shape} {dtype}")
                one_kernel(f"{name} at {tuple(a.shape)}, {tuple(b.shape)}",
                           device_kernels(fn, 3), "l1_distance_small_kernel")
                errs[name] = max(errs[name], err.max().item())
            say("kernels", f"G={g_} B={b_} N={n_} d={d_} {str(dtype)[6:]} base +{offset}: B1"
                f"{' and B5' if g_ == 1 else ''} within tolerance (max|err|"
                f" {err.max().item():.3g}), same bits on repeat, one kernel per call")
            del ref, err

    B, N, d = SHARD_BS_TRAIN // 2, SHARD_BS_TRAIN // 2 + N_NEGATIVE, DIM
    a, b = uniform((B, d), gen, d), uniform((N, d), gen, d)
    autograd_shape = dict(
        ms=one_kernel("B5", device_kernels(lambda: l1_kernels.l1_distance_matrix(a, b), 100),
                      "l1_distance_small_kernel"),
        event_ms=cuda_ms(lambda: l1_kernels.l1_distance_matrix(a, b), 100),
        plain_ms=device_ms(lambda: l1_kernels.l1_distance_matrix_plain(a, b), 10),
        library_ms=device_ms(lambda: torch.cdist(a, b, p=1), 20),
        bound=bound_ms(B, N, d, (B + N) * d * 4, B * N * 4),
    )
    r = autograd_shape
    say("kernels", f"B5 l1_distance_matrix at the autograd shape {B}x{N}x{d} fp32: kernel"
        f" {r['ms']:.4f} ms on the device ({r['event_ms']:.4f} ms between events), plain"
        f" {r['plain_ms']:.4f} ms, cdist {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms"
        f" ({r['bound'][1]})")
    return {"l1_distance_matrix_batched": {"max_abs_err": errs["l1_distance_matrix_batched"]},
            "l1_distance_matrix": {"max_abs_err": errs["l1_distance_matrix"],
                                   "autograd_shape": autograd_shape}}


def _sorted_slots(gen: torch.Generator, R: int, n: int):
    """R sorted row indices in [0, n) with duplicate runs, and the mask of
    each run's first slot."""
    logical = torch.randint(0, n, (R,), device="cuda", generator=gen)
    logical[1::5] = logical[0::5][: logical[1::5].shape[0]]  # duplicate runs
    idx = torch.sort(logical).values.to(torch.int32)
    first = torch.ones(R, dtype=torch.bool, device="cuda")
    first[1:] = idx[1:] != idx[:-1]
    return idx, first


def check_multi_and_gather(gen: torch.Generator, n_rows: int) -> dict:
    """B8 and B9 against their plain versions on the card, bit for bit, and
    their times at the training step's shapes: B8 writes the rows of k = 2
    (RowSGDM) or 3 (RowAdamW) (n_rows, 128) fp32 tables at R = 8,704 slots
    each, B9 reads [param | momentum] pairs of the (2·n_rows, 128) table."""
    results = {name: {"max_abs_err": 0.0} for name in ("scatter_rows_multi", "gather_rows")}
    R = BPS * (2 * SHARD_BS_TRAIN + 2 * N_NEGATIVE)
    tables = [torch.rand((n_rows, DIM), device="cuda", generator=gen) for _ in range(3)]
    plain = [t.clone() for t in tables]
    for k, lengths, block in ((2, (R, R), False), (3, (R, R, R), False),
                              (3, (R, 5001, 1001), True)):
        for t, q in zip(tables, plain):
            q.copy_(t)  # the timing runs below move the two apart
        idxs, rows, firsts = [], [], []
        for n in lengths:
            idx, first = _sorted_slots(gen, n, n_rows)
            r = torch.randn(n, DIM, device="cuda", generator=gen)
            r[~first] = float("nan")  # garbage in duplicate slots
            idxs.append(idx)
            rows.append(r)
            firsts.append(first)
        uniques = [int(f.sum()) for f in firsts]
        got = [tables[0][None] if block else tables[0], *tables[1:k]]
        want = [plain[0][None] if block else plain[0], *plain[1:k]]
        row_kernels.scatter_rows_multi(got, idxs, rows, skip_dups=True)
        row_kernels.scatter_rows_multi_plain(want, idxs, rows, skip_dups=True)
        torch.cuda.synchronize()
        for b in range(k):
            if not torch.equal(tables[b], plain[b]):
                raise AssertionError(f"B8 table {b} of {k} off its plain version")
        say("kernels", f"B8 k={k} with {lengths} slots ({uniques} unique rows){' and a (1, n, D) block' if block else ''}"
            f" over {n_rows} x {DIM} tables: equal to its plain version, duplicate slots untouched")
        if block:
            continue
        flat = [(i[f].long(), r[f]) for i, r, f in zip(idxs, rows, firsts)]

        def index_copies(ts=tuple(tables[:k]), flat=flat):
            for t, (i, r) in zip(ts, flat):
                t.index_copy_(0, i, r)

        def b3_launches(ts=tuple(tables[:k]), idxs=idxs, rows=rows):
            for t, i, r in zip(ts, idxs, rows):
                row_kernels.scatter_rows(t, i, r, 1, True)

        timing = dict(
            ms=device_ms(lambda: row_kernels.scatter_rows_multi(tables[:k], idxs, rows, True), 100),
            event_ms=cuda_ms(lambda: row_kernels.scatter_rows_multi(tables[:k], idxs, rows, True), 100),
            plain_ms=device_ms(lambda: row_kernels.scatter_rows_multi_plain(
                plain[:k], idxs, rows, True), 10),
            library_ms=device_ms(index_copies, 100),
            b3_ms=device_ms(b3_launches, 100),
            # per table: idx read; each unique row read and written once
            bound=bound_of(0.0, sum(4 * R + u * 2 * DIM * 4 for u in uniques)),
        )
        if k == 2:
            results["scatter_rows_multi"].update({f"{key}_k2": v for key, v in timing.items()})
        else:
            results["scatter_rows_multi"].update(timing)
    del tables, plain

    pair_table = torch.rand((2 * n_rows, DIM), device="cuda", generator=gen)
    for R_, block in ((R, False), (1001, True)):
        logical, first = _sorted_slots(gen, R_, n_rows)
        phys = 2 * logical
        got = row_kernels.gather_rows(pair_table[None] if block else pair_table, phys, 2, True)
        want = row_kernels.gather_rows_plain(pair_table, phys, 2, True)
        torch.cuda.synchronize()
        keep = first.repeat_interleave(2)
        if not torch.equal(got[keep], want[keep]):
            raise AssertionError("B9 off its plain version at a first-of-run slot")
        say("kernels", f"B9 h=2 with R={R_} ({int(first.sum())} unique pairs) over a {2 * n_rows} x {DIM}"
            f" table{' block' if block else ''}: first-of-run slots equal to its plain version")
        if R_ == R:
            unique = int(first.sum())
            flat_first = (phys[first].long()[:, None] + torch.arange(2, device="cuda")).reshape(-1)
            results["gather_rows"].update(
                ms=device_ms(lambda: row_kernels.gather_rows(pair_table, phys, 2, True), 100),
                event_ms=cuda_ms(lambda: row_kernels.gather_rows(pair_table, phys, 2, True), 100),
                plain_ms=device_ms(lambda: row_kernels.gather_rows_plain(pair_table, phys, 2, True), 10),
                library_ms=device_ms(lambda: pair_table.index_select(0, flat_first), 100),
                # idx read; each unique pair read once and written once
                bound=bound_of(0.0, 4 * R + unique * 2 * (2 * DIM * 4)),
            )
    del pair_table
    r8, r9 = results["scatter_rows_multi"], results["gather_rows"]
    say("kernels", f"B8 scatter_rows_multi at R={R}: k=3 kernel {r8['ms']:.4f} ms ({r8['event_ms']:.4f} ms"
        f" between events), plain {r8['plain_ms']:.4f} ms, 3 index_copy_ {r8['library_ms']:.4f} ms,"
        f" 3 B3 launches {r8['b3_ms']:.4f} ms, bound {r8['bound'][0]:.4f} ms; k=2 kernel"
        f" {r8['ms_k2']:.4f} ms, 2 index_copy_ {r8['library_ms_k2']:.4f} ms, 2 B3 launches"
        f" {r8['b3_ms_k2']:.4f} ms, bound {r8['bound_k2'][0]:.4f} ms")
    say("kernels", f"B9 gather_rows at R={R}, h=2: kernel {r9['ms']:.4f} ms ({r9['event_ms']:.4f} ms"
        f" between events), plain {r9['plain_ms']:.4f} ms, index_select {r9['library_ms']:.4f} ms,"
        f" bound {r9['bound'][0]:.4f} ms")
    return results


#: (shape, dtype) of B10's checks on the biokg table: fp32 (timed), bf16,
#: and an unaligned fp32 table.
B10_BIOKG_CASES = (((DENSE_ENTITY, 2 * DENSE_EMB), torch.float32),
                   ((DENSE_ENTITY, 2 * DENSE_EMB), torch.bfloat16),
                   ((777, 129), torch.float32))


def check_dense_adamw(gen: torch.Generator, cases: tuple = B10_BIOKG_CASES) -> dict:
    """B10 against its plain version on the card for each (shape, dtype) of
    ``cases``: mu and nu to equal bits, the param to two fp32 ulps (one bf16
    ulp for a bf16 param); its time at the first case, an fp32 table,
    against torch.optim.AdamW(fused=True)."""
    result = {"max_abs_err": 0.0}
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    main = cases[0][0]
    for i, (shape, dtype) in enumerate(cases):
        p = (torch.rand(shape, device="cuda", generator=gen) * 2 - 1).to(dtype)
        mu = torch.randn(shape, device="cuda", generator=gen) * 1e-3
        nu = torch.rand(shape, device="cuda", generator=gen) * 1e-6
        g = torch.randn(shape, device="cuda", generator=gen) * 1e-2
        want = [t.clone() for t in (p, mu, nu)]
        adamw_kernels.dense_adamw_update(p, mu, nu, g, count, DENSE_LR, wd=1e-4)
        adamw_kernels.dense_adamw_update_plain(*want, g, count, DENSE_LR, wd=1e-4)
        torch.cuda.synchronize()
        if not (torch.equal(mu, want[1]) and torch.equal(nu, want[2])):
            raise AssertionError("B10 moments off their plain version")
        ulp = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-22
        err = (p.float() - want[0].float()).abs()
        if not (err <= ulp * want[0].float().abs() + 1e-30).all():
            raise AssertionError(f"B10 param off its plain version by {err.max().item()}")
        result["max_abs_err"] = max(result["max_abs_err"], err.max().item())
        say("kernels", f"B10 {shape} {str(dtype)[6:]} param: mu, nu equal to the plain version,"
            f" param max|err| {err.max().item():.3g}")
        if i == 0:
            n = p.numel()
            param = torch.nn.Parameter(p.clone())
            param.grad = g.clone()
            library = torch.optim.AdamW([param], lr=DENSE_LR, weight_decay=1e-4, fused=True)

            def update():
                adamw_kernels.dense_adamw_update(p, mu, nu, g, count, DENSE_LR, wd=1e-4)

            # B10's whole call is its one kernel (one_kernel raises otherwise).
            # The library's step() also advances its step count, so B10 is
            # timed a second time with the count increment that
            # FusedDenseAdamW.apply_dense launches before it; and the
            # library's AdamW kernel by name beside its whole call.
            kernel_ms = one_kernel("B10", device_kernels(update, 50), "dense_adamw_kernel")
            with_count_ms = device_ms(lambda: adamw_kernels.dense_adamw_update(
                p, mu, nu, g, count + 1, DENSE_LR, wd=1e-4), 50)
            theirs = device_kernels(library.step, 50)
            lib_name, (lib_kernel_ms, _) = max(theirs.items(), key=lambda kv: kv[1][0])
            result.update(
                ms=kernel_ms,
                event_ms=cuda_ms(update, 50),
                plain_ms=device_ms(lambda: adamw_kernels.dense_adamw_update_plain(
                    p, mu, nu, g, count, DENSE_LR, wd=1e-4), 10),
                library_ms=sum(ms for ms, _ in theirs.values()),
                library_kernel_ms=lib_kernel_ms,
                library_launches=sum(k for _, k in theirs.values()),
                # read g, p, mu, nu and write p, mu, nu, 4 bytes each; about
                # 12 fp32 instructions per element (moments, corrections,
                # square root, division, decay)
                bound=bound_of(12.0 * n, 28.0 * n),
            )
            say("kernels", f"B10 whole call {result['ms']:.4f} ms on the device (its one kernel),"
                f" {with_count_ms:.4f} ms with the step's count increment;"
                f" torch.optim.AdamW(fused=True).step() whole call {result['library_ms']:.4f} ms"
                f" ({result['library_launches']:g} kernels per call, its count increment"
                f" included), its AdamW kernel by name {lib_kernel_ms:.4f} ms ({lib_name[:100]})")
            del library, param
    say("kernels", f"B10 dense_adamw_update at {main} fp32: kernel {result['ms']:.4f} ms"
        f" ({result['event_ms']:.4f} ms between events), plain {result['plain_ms']:.4f} ms,"
        f" torch.optim.AdamW(fused=True) {result['library_ms']:.4f} ms, bound"
        f" {result['bound'][0]:.4f} ms ({result['bound'][1]})")
    return result


def autograd(gen: torch.Generator) -> dict:
    """The p=1 distance carries a gradient on the card: B5 forward, B6
    backward, against the sign-subgradient formula."""
    B, N, d = SHARD_BS_TRAIN // 2, SHARD_BS_TRAIN // 2 + N_NEGATIVE, DIM
    a = uniform((B, d), gen, d)
    b = uniform((N, d), gen, d)
    b[:16, :64] = a[:16, :64]  # exact ties: sign(0) = 0
    w = torch.randn(B, N, device="cuda", generator=gen)
    a.requires_grad_()
    b.requires_grad_()
    reset_counts()
    out = distance.p_distance_matrix(a, b, 1)
    da, db = torch.autograd.grad(out, (a, b), w)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("autograd", counts, {"l1_distance_matrix": 1, "l1_distance_grads": 1})
    if not isinstance(out.grad_fn, distance._L1._backward_cls):
        raise AssertionError(f"p_distance_matrix(p=1) has grad_fn {out.grad_fn}")
    s = torch.sign(a.detach()[:, None] - b.detach()[None])
    for got, want, tol in ((da, (w[..., None] * s).sum(1), sum_tol(w, 1)),
                           (db, -(w[..., None] * s).sum(0), sum_tol(w.T, 1))):
        if not ((got - want).abs() <= tol).all():
            raise AssertionError(f"p=1 gradient off the formula by {(got - want).abs().max().item()}")
    say("autograd", f"p_distance_matrix(p=1) at {B}x{N}x{d}: grad_fn {type(out.grad_fn).__name__},"
        f" gradients equal the sign-subgradient formula, launches {counts}")
    return {"l1_distance_grads": {"launches": counts["l1_distance_grads"]}}


def _training_setup(triples: np.ndarray, sharding: Sharding, score_fn: TransE,
                    axis_name: str = None):
    """The wikikg2 module (over the ``axis_name`` mesh axis) and its host
    sampler over ``triples``, and their partitioned triples."""
    dataset = KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"train": triples},
                        original_triple_ids={"train": np.arange(len(triples))})
    pts = PartitionedTripleSet.create_from_dataset(dataset, "train", sharding)
    ns = RandomShardedNegativeSampler(N_NEGATIVE, sharding, SEED, "ht", local_sampling=False,
                                      flat_negative_format=True)
    module = EmbeddingMovingBessKGE(ns, score_fn, SampledSoftmaxCrossEntropyLoss(N_ENTITY),
                                    augment_negative=True, axis_name=axis_name)
    sampler = RandomShardedBatchSampler(pts, ns, shard_bs=SHARD_BS_TRAIN, batches_per_step=BPS,
                                        seed=SEED)
    return module, sampler, pts


def _wikikg2(n_shard: int = 1):
    """The wikikg2 configuration's random triples, sharding (over
    ``n_shard`` shards) and TransE-L1 scorer with bf16 scoring math, and the
    generator that drew the triples."""
    rng = np.random.default_rng(SEED)
    triples = np.stack([rng.integers(N_ENTITY, size=N_TRIPLE), rng.integers(N_RELATION, size=N_TRIPLE),
                        rng.integers(N_ENTITY, size=N_TRIPLE)], 1).astype(np.int32)
    sharding = Sharding.create(N_ENTITY, n_shard, seed=SEED)
    score_fn = TransE(True, 1, sharding, N_RELATION, DIM, seed=SEED)
    score_fn.compute_dtype = torch.bfloat16
    return triples, sharding, score_fn, rng


def _biokg(triples=None):
    """bench.py's biokg configuration: its random triples (or ``triples``),
    sharding, RotatE scorer, module and partitioned triples."""
    if triples is None:
        rng = np.random.default_rng(SEED)  # bench.py _make_dataset's stream
        triples = np.stack([rng.integers(DENSE_ENTITY, size=DENSE_TRIPLE),
                            rng.integers(DENSE_RELATION, size=DENSE_TRIPLE),
                            rng.integers(DENSE_ENTITY, size=DENSE_TRIPLE)], 1).astype(np.int32)
    sharding = Sharding.create(DENSE_ENTITY, 1, seed=SEED)
    dataset = KGDataset(n_entity=DENSE_ENTITY, n_relation_type=DENSE_RELATION,
                        triples={"train": triples}, original_triple_ids={"train": np.arange(len(triples))})
    pts = PartitionedTripleSet.create_from_dataset(dataset, "train", sharding)
    score_fn = RotatE(True, 2, sharding, DENSE_RELATION, DENSE_EMB, seed=SEED)
    ns = RandomShardedNegativeSampler(1, sharding, SEED, "ht", local_sampling=False,
                                      flat_negative_format=True)
    module = EmbeddingMovingBessKGE(ns, score_fn, LogSigmoidLoss(12.0, True))
    return triples, sharding, score_fn, module, pts


def _to(state, device):
    if isinstance(state, dict):
        return {k: _to(v, device) for k, v in state.items()}
    return state.to(device, copy=True)


def training(gen: torch.Generator, profile: bool = False, device: str = "cuda") -> dict:
    """The sparse training step at ogbl-wikikg2 width on the card (``device``
    "cpu" rehearses the phase with the plain versions)."""
    on_card = device == "cuda"
    t = time.perf_counter()
    triples, sharding, score_fn, rng = _wikikg2()
    module, sampler, _ = _training_setup(triples, sharding, score_fn)
    batches = [sampler.sample_batch(b) for b, _ in zip(sampler.epoch_index_blocks(), range(2 + 2 * TIMED_STEPS))]
    sgd = optim.SGD(LR, momentum=MOMENTUM)
    rows = {v: optim.RowSGDM(LR, momentum=MOMENTUM, interleaved=True, fused_variant=v)
            for v in ("xla", "fused")}
    params = score_fn.initial_params_device(device=device, generator=gen)
    params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
    n_logical = sharding.max_entity_per_shard
    state0 = trainer.init_optimizer_state(sgd, params, None, rows["xla"], n_logical=n_logical)
    steps = {v: trainer.build_train_step(module, sgd, None, rows[v], device=device) for v in rows}
    cpu_step = trainer.build_train_step(module, sgd, None, rows["xla"], device="cpu")
    initial = {k: v.clone() for k, v in params.items()}
    say("training", f"{N_ENTITY} x {DIM} table interleaved to {tuple(params['entity_embedding'].shape)}"
        f" fp32, {N_TRIPLE} triples, {SHARD_BS_TRAIN * BPS} positives per step"
        f" ({time.perf_counter() - t:.1f}s set-up)")

    # One step on the card, and the same step on the CPU from copies.
    batch = batches[0]
    cpu_params = {k: v.to("cpu", copy=True) for k, v in params.items()}
    cpu_state = _to(state0, "cpu")
    touched = torch.unique(torch.from_numpy(np.concatenate([
        batch["head"].reshape(-1), batch["tail"].reshape(-1), batch["negative"].reshape(-1)])).long())
    pool = torch.from_numpy(rng.choice(n_logical, size=4 * N_UNTOUCHED, replace=False))
    untouched = pool[~torch.isin(pool, touched)][:N_UNTOUCHED]
    reset_counts()
    card_params, card_state, card_out = steps["xla"](params, trainer._clone(state0), batch)
    sync(device)
    counts_default = read_counts()
    if on_card:
        expect_counts("training step (B3 variant)", counts_default, {
            "l1_distance_matrix_batched": 2, "l1_distance_grads_batched": 2, "scatter_rows": 1})
    t = time.perf_counter()
    cpu_params, cpu_state, cpu_out = cpu_step(cpu_params, cpu_state, batch)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(card_out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > 2.0**-8 * abs(cpu_loss):
        raise AssertionError(f"training loss {loss} on the card, {cpu_loss} on the CPU")
    pairs = 2 * touched[:, None] + torch.arange(2)
    card_table = card_params["entity_embedding"]
    errs = {}
    for name, got, want in (
        ("params", card_table[pairs[:, 0].to(device)].cpu(), cpu_params["entity_embedding"][pairs[:, 0]]),
        ("momentum", card_table[pairs[:, 1].to(device)].cpu(), cpu_params["entity_embedding"][pairs[:, 1]]),
        ("relation", card_params["relation_embedding"].cpu(), cpu_params["relation_embedding"]),
        ("relation momentum", card_state["other"]["trace"]["relation_embedding"].cpu(),
         cpu_state["other"]["trace"]["relation_embedding"]),
    ):
        err = (got - want).abs()
        tol = BF16_STEP_RTOL * (want.abs() + want.abs().max())
        if not (err <= tol).all() or not torch.isfinite(got).all():
            raise AssertionError(f"training step: {name} off the CPU step by {err.max().item()}")
        errs[name] = err.max().item()
    untouched = untouched.to(device)
    if not torch.equal(card_table[2 * untouched], initial["entity_embedding"][2 * untouched]):
        raise AssertionError("training step moved untouched rows")
    say("training", f"one step on the card vs the CPU ({cpu_s:.1f}s): loss {loss:.6f} vs {cpu_loss:.6f},"
        f" max|err| {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} over {len(touched)} touched"
        f" rows (tolerance {BF16_STEP_RTOL} x (|want| + max|want|)); {len(untouched)} untouched rows"
        f" bit-identical; launches {counts_default}")
    # The first step's momentum is its deduplicated row gradient (m = 0.9·0 + g).
    cpu_grad = cpu_params["entity_embedding"][pairs[:, 1]]
    del cpu_params, cpu_state

    # The fused variant from the same state.
    fused_params = {k: v.clone() for k, v in initial.items()}
    reset_counts()
    fused_params, _, fused_out = steps["fused"](fused_params, trainer._clone(state0), batch)
    sync(device)
    counts_fused = read_counts()
    if on_card:
        expect_counts("training step (B4 variant)", counts_fused, {
            "l1_distance_matrix_batched": 2, "l1_distance_grads_batched": 2, "fused_pair_sgdm": 1})
    flat = pairs.reshape(-1).to(device)
    # The same gradients and the same unfused fp32 update: equal bits.
    fused_err = (fused_params["entity_embedding"][flat] - card_table[flat]).abs().max().item()
    if fused_err > 0.0 or not torch.equal(fused_params["entity_embedding"][2 * untouched],
                                          card_table[2 * untouched]):
        raise AssertionError(f"the B4 step differs from the B3 step by {fused_err}")
    say("training", f"the B4 variant's step equals the B3 variant's at every touched pair"
        f" (max|err| {fused_err}); launches {counts_fused}")
    del fused_params
    variants = row_variants(module, sgd, initial, batch, card_params, card_state, touched,
                            untouched, n_logical, device, cpu_grad)
    del initial

    # Trainer.fit, the entry a user calls, over a few steps.
    fit_module, fit_sampler, _ = _training_setup(triples[:FIT_TRIPLES], sharding, score_fn)
    fit = trainer.Trainer(fit_module, fit_sampler, sgd, params=card_params,
                          entity_optimizer=rows["xla"], device=device)
    summary = fit.fit(n_epochs=1, log_every=1)
    losses = [r["loss"] for r in fit.history]
    if summary["steps"] != FIT_TRIPLES // (SHARD_BS_TRAIN * BPS) or not np.isfinite(losses).all():
        raise AssertionError(f"Trainer.fit: {summary}")
    say("training", f"Trainer.fit: {summary['steps']} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f},"
        f" {summary['triples_per_s']:.0f} positive triples/s including host sampling")

    # 20 warm steps of each variant, in turns, host clock around synchronised runs.
    variants["xla"] = (steps["xla"], "pair", "B3")
    variants["fused"] = (steps["fused"], "pair", "B4")
    holders = variants.pop("holders")
    holders["pair"] = [card_params, fit.opt_state]
    order = ["xla", "fused", "pallas_gather", "separate", "adamw", "adamw_interleaved", "adagrad",
             "adagrad_interleaved"]
    timed: Dict[str, list] = {}
    for name in order + order[::-1]:
        step, key, _ = variants[name]
        held = holders[key]
        run = batches[2:2 + TIMED_STEPS] if name not in timed else batches[2 + TIMED_STEPS:]
        held[0], held[1], _ = step(held[0], held[1], batches[1])  # warm-up
        sync(device)
        t = time.perf_counter()
        for b in run:
            held[0], held[1], out = step(held[0], held[1], b)
        sync(device)
        timed.setdefault(name, []).append((time.perf_counter() - t) / len(run) * 1e3)
    for name in order:
        ms = timed[name]
        say("training", f"{name} variant ({variants[name][2]}): {ms[0]:.3f} / {ms[1]:.3f} ms per"
            f" step over {TIMED_STEPS} warm steps, {SHARD_BS_TRAIN * BPS / ms[0] * 1e3:.0f} /"
            f" {SHARD_BS_TRAIN * BPS / ms[1] * 1e3:.0f} positive triples/s")
    card_params, state = holders["pair"]
    if profile:
        profile_steps(steps["xla"], card_params, state, batches[2:12], "train_step_trace.json")
    return {
        "l1_distance_matrix_batched": {"launches": counts_default["l1_distance_matrix_batched"]},
        "l1_distance_grads_batched": {"launches": counts_default["l1_distance_grads_batched"]},
        "scatter_rows": {"launches": counts_default["scatter_rows"]},
        "fused_pair_sgdm": {"launches": counts_fused["fused_pair_sgdm"]},
        "scatter_rows_multi": {"launches": variants["separate_counts"]["scatter_rows_multi"]},
        "gather_rows": {"launches": variants["gather_counts"]["gather_rows"]},
        "step_ms": timed,
        "adagrad": variants["adagrad_results"],
    }


def _adam_ratio(state: dict, count: int, b1: float, b2: float, eps: float = 1e-8):
    """m̂/(√v̂ + eps) of AdamW moments ``state["mu"]``, ``state["nu"]`` after
    step ``count``: the factor that lr multiplies in the update."""
    return (state["mu"] / (1 - b1**count)) / (torch.sqrt(state["nu"] / (1 - b2**count)) + eps)


def row_variants(module, sgd, initial, batch, card_params, card_state, touched, untouched,
                 n_logical, device, cpu_grad) -> dict:
    """One step of each new row-update variant from the initial state of the
    B3 step, held against that step or the CPU; returns the steps,
    their params and states for the timed runs, and their launch counts.
    ``cpu_grad`` is the CPU step's deduplicated gradient at the touched rows
    (its first momentum)."""
    on_card = device == "cuda"
    card_table = card_params["entity_embedding"]
    p0, _ = optim.split_interleaved(initial["entity_embedding"])
    rel0 = initial["relation_embedding"]
    l1 = {"l1_distance_matrix_batched": 2, "l1_distance_grads_batched": 2}

    def run(opt, params, what, want_counts):
        state = trainer.init_optimizer_state(sgd, params, None, opt, n_logical=n_logical)
        step = trainer.build_train_step(module, sgd, None, opt, device=device)
        reset_counts()
        params, state, out = step(params, state, batch)
        sync(device)
        counts = read_counts()
        if on_card:
            expect_counts(f"training step ({what})", counts, {**l1, **want_counts})
        return step, params, state, out, counts

    # The "pallas_gather" variant: B9 reads the pairs, B3 writes them; the
    # same arithmetic as the B3 step, so the same bits.
    gather = optim.RowSGDM(LR, MOMENTUM, 0.0, True, True, "pallas_gather")
    g_step, g_params, _, _, g_counts = run(
        gather, {k: v.clone() for k, v in initial.items()}, "B9 + B3 variant",
        {"gather_rows": 1, "scatter_rows": 1})
    if not torch.equal(g_params["entity_embedding"], card_table):
        raise AssertionError("the pallas_gather step differs from the B3 step")
    del g_params
    say("training", f"the pallas_gather variant's step (B9 + B3) equals the B3 step bit for bit;"
        f" launches {g_counts}")

    # RowSGDM with a separate momentum buffer (B8, k = 2): equal bits to the
    # interleaved step after split_interleaved.
    separate = optim.RowSGDM(LR, MOMENTUM)
    s_step, s_params, s_state, _, s_counts = run(
        separate, {"entity_embedding": p0.clone(), "relation_embedding": rel0.clone()},
        "separate momentum, B8 k = 2", {"scatter_rows_multi": 1})
    card_p, card_m = optim.split_interleaved(card_table)
    if not (torch.equal(s_params["entity_embedding"], card_p)
            and torch.equal(s_state["entity"]["m"], card_m)
            and torch.equal(s_params["relation_embedding"], card_params["relation_embedding"])
            and torch.equal(s_state["other"]["trace"]["relation_embedding"],
                            card_state["other"]["trace"]["relation_embedding"])):
        raise AssertionError("the separate-buffer RowSGDM step differs from the interleaved one")
    say("training", f"RowSGDM with a separate momentum buffer (B8, k = 2): params and momentum equal"
        f" to the interleaved B3 step's bit for bit; launches {s_counts}")

    # RowAdamW with separate moments (B8, k = 3) against the CPU, and the
    # treble-interleaved RowAdamW (B3, h = 3) against it, bit for bit.
    adamw = optim.RowAdamW(LR)
    a_params = {"entity_embedding": p0.clone(), "relation_embedding": rel0.clone()}
    cpu_params = _to(a_params, "cpu")
    a_step, a_params, a_state, a_out, a_counts = run(
        adamw, a_params, "RowAdamW, B8 k = 3", {"scatter_rows_multi": 1})
    cpu_state = trainer.init_optimizer_state(sgd, cpu_params, None, adamw, n_logical=n_logical)
    t = time.perf_counter()
    cpu_params, cpu_state, cpu_out = trainer.build_train_step(module, sgd, None, adamw, device="cpu")(
        cpu_params, cpu_state, batch)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(a_out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > 2.0**-8 * abs(cpu_loss):
        raise AssertionError(f"RowAdamW step loss {loss} on the card, {cpu_loss} on the CPU")
    rows_t = touched.to(device)
    card_moments = {k: a_state["entity"][k][rows_t].cpu() for k in ("mu", "nu")}
    cpu_moments = {k: cpu_state["entity"][k][touched] for k in ("mu", "nu")}
    # The update's own sensitivity: lr times the difference of m̂/(√v̂ + eps).
    moved = LR * (_adam_ratio(card_moments, 1, adamw.b1, adamw.b2)
                  - _adam_ratio(cpu_moments, 1, adamw.b1, adamw.b2)).abs()
    errs = {}
    for name, got, want, extra in (
        ("params", a_params["entity_embedding"][rows_t].cpu(), cpu_params["entity_embedding"][touched],
         moved),
        ("mu", card_moments["mu"], cpu_moments["mu"], 0.0),
        ("nu", card_moments["nu"], cpu_moments["nu"], 0.0),
        ("relation", a_params["relation_embedding"].cpu(), cpu_params["relation_embedding"], 0.0),
    ):
        err = (got - want).abs()
        tol = BF16_STEP_RTOL * (want.abs() + want.abs().max()) + extra
        if not (err <= tol).all() or not torch.isfinite(got).all():
            raise AssertionError(f"RowAdamW step: {name} off the CPU step by {err.max().item()}")
        errs[name] = err.max().item()
    if not torch.equal(a_params["entity_embedding"][untouched], p0[untouched]):
        raise AssertionError("the RowAdamW step moved untouched rows")
    say("training", f"RowAdamW with separate moments (B8, k = 3), one step on the card vs the CPU"
        f" ({cpu_s:.1f}s): loss {loss:.6f} vs {cpu_loss:.6f}, max|err| "
        f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())} over {len(touched)} touched rows"
        f" (tolerance {BF16_STEP_RTOL} x (|want| + max|want|), plus for the params lr x the"
        f" difference of m^/(v^1/2 + eps), at most {moved.max().item():.3g}); launches {a_counts}")
    del cpu_params, cpu_state
    interleaved = optim.RowAdamW(LR, interleaved=True)
    i_step, i_params, i_state, _, i_counts = run(
        interleaved, {"entity_embedding": optim.interleave_adamw(p0),
                      "relation_embedding": rel0.clone()},
        "interleaved RowAdamW, B3 h = 3", {"scatter_rows": 1})
    p, mu, nu = optim.split_interleaved_adamw(i_params["entity_embedding"])
    if not (torch.equal(p, a_params["entity_embedding"]) and torch.equal(mu, a_state["entity"]["mu"])
            and torch.equal(nu, a_state["entity"]["nu"])):
        raise AssertionError("the interleaved RowAdamW step differs from the separate one")
    say("training", f"the treble-interleaved RowAdamW step (B3, h = 3) equals the separate one bit"
        f" for bit; launches {i_counts}")
    ada = adagrad_variants(run, module, sgd, p0, rel0, batch, card_table, touched, untouched,
                           cpu_grad, n_logical, device)
    return {
        "pallas_gather": (g_step, "pair", "B9 + B3"),
        "separate": (s_step, "separate", "B8, k = 2"),
        "adamw": (a_step, "adamw", "B8, k = 3"),
        "adamw_interleaved": (i_step, "adamw_interleaved", "B3, h = 3"),
        "adagrad": (ada["steps"]["separate"], "adagrad", "B8, k = 2"),
        "adagrad_interleaved": (ada["steps"]["interleaved"], "adagrad_interleaved", "B3, h = 2"),
        "holders": {"separate": [s_params, s_state], "adamw": [a_params, a_state],
                    "adamw_interleaved": [i_params, i_state], **ada["holders"]},
        "separate_counts": s_counts,
        "gather_counts": g_counts,
        "adagrad_results": ada["results"],
    }


def adagrad_variants(run, module, sgd, p0, rel0, batch, card_table, touched, untouched,
                     cpu_grad, n_logical, device) -> dict:
    """RowAdagrad on the wikikg2 step, host-fed, from the initial state of
    the B3 step: separate accumulator (B8, k = 2) against the CPU, the
    pair-major store (B3, h = 2) against it bit for bit, and over a packed
    bf16 table the triplet store (B3, h = 3) against separate buffers (B8,
    k = 2) bit for bit.

    Against the CPU: the accumulator after one step is g², and the update
    lr·g/(√g² + eps) is lr·sign(g) but where |g| is near eps, so a gradient
    that differs in its last bits between the devices may flip it. The
    accumulator must equal the square of the card's own gradient (the B3
    step's first momentum) bit for bit and lie within the sparse bound of
    the CPU's; the params within the sparse bound plus lr x the difference
    of g/(|g| + eps) of the two devices' gradients."""
    on_card = device == "cuda"
    rows_t = touched.to(device)
    g_card = card_table[2 * rows_t + 1]
    results, steps, holders = {}, {}, {}

    ada = optim.RowAdagrad(LR)
    params = {"entity_embedding": p0.clone(), "relation_embedding": rel0.clone()}
    cpu_params = _to(params, "cpu")
    steps["separate"], params, state, out, counts = run(
        ada, params, "RowAdagrad, B8 k = 2", {"scatter_rows_multi": 1})
    cpu_state = trainer.init_optimizer_state(sgd, cpu_params, None, ada, n_logical=n_logical)
    cpu_params, cpu_state, cpu_out = trainer.build_train_step(module, sgd, None, ada, device="cpu")(
        cpu_params, cpu_state, batch)
    loss, cpu_loss = float(out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > 2.0**-8 * abs(cpu_loss):
        raise AssertionError(f"RowAdagrad step loss {loss} on the card, {cpu_loss} on the CPU")
    acc = state["entity"]["acc"][rows_t]
    if not torch.equal(acc, g_card * g_card):
        raise AssertionError("RowAdagrad's accumulator is not the square of the step's gradient")
    moved = LR * (g_card / (g_card.abs() + ada.eps)
                  - cpu_grad.to(device) / (cpu_grad.to(device).abs() + ada.eps)).abs().cpu()
    errs = {}
    for name, got, want, extra in (
        ("params", params["entity_embedding"][rows_t].cpu(), cpu_params["entity_embedding"][touched],
         moved),
        ("acc", acc.cpu(), cpu_state["entity"]["acc"][touched], 0.0),
        ("relation", params["relation_embedding"].cpu(), cpu_params["relation_embedding"], 0.0),
    ):
        err = (got - want).abs()
        tol = BF16_STEP_RTOL * (want.abs() + want.abs().max()) + extra
        if not (err <= tol).all() or not torch.isfinite(got).all():
            raise AssertionError(f"RowAdagrad step: {name} off the CPU step by {err.max().item()}")
        errs[name] = err.max().item()
    if not torch.equal(params["entity_embedding"][untouched], p0[untouched]):
        raise AssertionError("the RowAdagrad step moved untouched rows")
    flips = int((moved > LR).sum())
    say("training", f"RowAdagrad with a separate accumulator (B8, k = 2), one step on the card vs"
        f" the CPU: loss {loss:.6f} vs {cpu_loss:.6f}, accumulator = g^2 of the card's gradient"
        f" bit for bit, max|err| {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} (tolerance"
        f" {BF16_STEP_RTOL} x (|want| + max|want|), plus for the params lr x the difference of"
        f" g/(|g| + eps): {flips} of {moved.numel()} values flipped); launches {counts}")
    results["separate"] = {"launches": counts, "max_abs_err": errs, "sign_flips": flips}
    holders["adagrad"] = [params, state]
    del cpu_params, cpu_state

    wide_opt = optim.RowAdagrad(LR, interleaved=True)
    steps["interleaved"], w_params, w_state, _, w_counts = run(
        wide_opt, {"entity_embedding": optim.interleave_momentum(p0),
                   "relation_embedding": rel0.clone()},
        "interleaved RowAdagrad, B3 h = 2", {"scatter_rows": 1})
    p, acc_all = optim.split_interleaved(w_params["entity_embedding"])
    if not (torch.equal(p, params["entity_embedding"]) and torch.equal(acc_all, state["entity"]["acc"])
            and torch.equal(w_params["relation_embedding"], params["relation_embedding"])):
        raise AssertionError("the interleaved RowAdagrad step differs from the separate one")
    say("training", f"the pair-major RowAdagrad step (B3, h = 2) equals the separate one bit for"
        f" bit; launches {w_counts}")
    results["interleaved"] = {"launches": w_counts}
    holders["adagrad_interleaved"] = [w_params, w_state]

    # A packed bf16 table: the triplet store against separate buffers.
    words = packed.pack_table(p0.to(torch.bfloat16))
    runs = {}
    for layout, opt, table, want in (
        ("triplet store, B3 h = 3", wide_opt, packed.interleave_packed_momentum(words),
         {"scatter_rows": 1}),
        ("separate packed buffers, B8 k = 2", ada, words.clone(), {"scatter_rows_multi": 1}),
    ):
        _, t_params, t_state, t_out, t_counts = run(
            opt, {"entity_embedding": table, "relation_embedding": rel0.clone()}, layout, want)
        runs[layout] = (t_params, t_state, t_counts, float(t_out["loss"]))
    (pi, si, ci, li), (ps, ss, cs, ls) = runs.values()
    store_p, (store_acc,) = packed.split_packed_state(pi["entity_embedding"], 1)
    same = {
        "params": torch.equal(store_p.view(torch.int32), ps["entity_embedding"].view(torch.int32)),
        "acc": torch.equal(store_acc, ss["entity"]["acc"]),
        "relation": torch.equal(pi["relation_embedding"], ps["relation_embedding"]),
        "loss": li == ls,
    }
    if not all(same.values()):
        raise AssertionError(f"packed RowAdagrad: the triplet store and separate buffers differ in"
                             f" {[k for k, v in same.items() if not v]}")
    say("training", f"packed bf16 RowAdagrad: the {tuple(pi['entity_embedding'].shape)} triplet"
        f" store (B3, h = 3; launches {ci}) and separate buffers (B8, k = 2; launches {cs}) give"
        " equal bits on every array after one step")
    results["packed"] = {"interleaved_launches": ci, "separate_launches": cs}
    del runs, pi, si, ps, ss, store_p, store_acc
    return {"steps": steps, "holders": holders, "results": results}


def dense_training(gen: torch.Generator, profile: bool = False, device: str = "cuda") -> dict:
    """The dense RotatE step of the biokg configuration at full width on the
    card (``device`` "cpu" rehearses the phase with the plain versions)."""
    on_card = device == "cuda"
    t = time.perf_counter()
    triples, sharding, score_fn, module, pts = _biokg()
    ns = module.negative_sampler
    sampler = RandomShardedBatchSampler(pts, ns, shard_bs=DENSE_SHARD_BS,
                                        batches_per_step=DENSE_BPS, seed=SEED)
    positives = DENSE_SHARD_BS * DENSE_BPS
    batches = [sampler.sample_batch(b) for b, _ in zip(sampler.epoch_index_blocks(),
                                                        range(2 + 2 * TIMED_STEPS))]
    adamw = optim.AdamW(DENSE_LR)  # bench.py's optax.adamw(1e-3): weight decay 1e-4
    fused = optim.FusedDenseAdamW(DENSE_LR, weight_decay=1e-4)
    params = score_fn.initial_params_device(device=device, generator=gen)
    state0 = trainer.init_optimizer_state(adamw, params, None, fused)
    step = trainer.build_train_step(module, adamw, None, fused, device=device)
    say("dense", f"{DENSE_ENTITY} x {2 * DENSE_EMB} fp32 RotatE table, {DENSE_TRIPLE} triples,"
        f" {positives} positives per step ({time.perf_counter() - t:.1f}s set-up)")

    # One step on the card, and the same step on the CPU from copies.
    batch = batches[0]
    cpu_params, cpu_state = _to(params, "cpu"), _to(state0, "cpu")
    reset_counts()
    params, state, out = step(params, state0, batch)
    sync(device)
    counts = read_counts()
    if on_card:
        expect_counts("dense training step", counts, {"dense_adamw_update": 1})
    t = time.perf_counter()
    cpu_params, cpu_state, cpu_out = trainer.build_train_step(module, adamw, None, fused, device="cpu")(
        cpu_params, cpu_state, batch)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > DENSE_RTOL * abs(cpu_loss):
        raise AssertionError(f"dense step loss {loss} on the card, {cpu_loss} on the CPU")
    ent, rel = "entity_embedding", "relation_embedding"
    card_ent = {k: state["entity"][k].cpu() for k in ("mu", "nu")}
    card_rel = {k: state["other"][k][rel].cpu() for k in ("mu", "nu")}
    cpu_rel = {k: cpu_state["other"][k][rel] for k in ("mu", "nu")}
    # The update's own sensitivity: lr times the difference of m̂/(√v̂ + eps).
    moved = {
        ent: DENSE_LR * (_adam_ratio(card_ent, 1, fused.b1, fused.b2)
                         - _adam_ratio(cpu_state["entity"], 1, fused.b1, fused.b2)).abs(),
        rel: DENSE_LR * (_adam_ratio(card_rel, 1, adamw.b1, adamw.b2)
                         - _adam_ratio(cpu_rel, 1, adamw.b1, adamw.b2)).abs(),
    }
    errs = {}
    for name, got, want, extra in (
        ("table", params[ent].cpu(), cpu_params[ent], moved[ent]),
        ("table mu", card_ent["mu"], cpu_state["entity"]["mu"], 0.0),
        ("table nu", card_ent["nu"], cpu_state["entity"]["nu"], 0.0),
        ("relation", params[rel].cpu(), cpu_params[rel], moved[rel]),
        ("relation mu", card_rel["mu"], cpu_rel["mu"], 0.0),
        ("relation nu", card_rel["nu"], cpu_rel["nu"], 0.0),
    ):
        err = (got - want).abs()
        tol = DENSE_RTOL * (want.abs() + want.abs().max()) + extra
        if not (err <= tol).all() or not torch.isfinite(got).all():
            raise AssertionError(f"dense step: {name} off the CPU step by {err.max().item()}")
        errs[name] = err.max().item()
    say("dense", f"one step (FusedDenseAdamW, B10) on the card vs the CPU ({cpu_s:.1f}s): loss"
        f" {loss:.6f} vs {cpu_loss:.6f}, max|err| {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}"
        f" over every row (tolerance {DENSE_RTOL} x (|want| + max|want|), plus for the params lr x"
        f" the difference of m^/(v^1/2 + eps), at most {moved[ent].max().item():.3g} (table) and"
        f" {moved[rel].max().item():.3g} (relations)); launches {counts}")
    del cpu_params, cpu_state

    # Trainer.fit, the entry a user calls, over a few steps.
    fit_triples = triples[: DENSE_FIT_STEPS * positives]
    fit_data = KGDataset(n_entity=DENSE_ENTITY, n_relation_type=DENSE_RELATION,
                         triples={"train": fit_triples},
                         original_triple_ids={"train": np.arange(len(fit_triples))})
    fit_sampler = RandomShardedBatchSampler(
        PartitionedTripleSet.create_from_dataset(fit_data, "train", sharding), ns,
        shard_bs=DENSE_SHARD_BS, batches_per_step=DENSE_BPS, seed=SEED)
    fit = trainer.Trainer(module, fit_sampler, adamw, params=params, entity_optimizer=fused,
                          device=device)
    summary = fit.fit(n_epochs=1, log_every=1)
    losses = [r["loss"] for r in fit.history]
    if summary["steps"] != DENSE_FIT_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"dense Trainer.fit: {summary}")
    say("dense", f"Trainer.fit: {summary['steps']} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f},"
        f" {summary['triples_per_s']:.0f} positive triples/s including host sampling")

    # 20 warm steps of each form, in turns: FusedDenseAdamW (B10) and the
    # plain dense AdamW over every param (no kernel).
    forms = {
        "fused": [step, fit.params, fit.opt_state],
        "plain": [trainer.build_train_step(module, adamw, None, None, device=device),
                  {k: v.clone() for k, v in fit.params.items()}, None],
    }
    forms["plain"][2] = trainer.init_optimizer_state(adamw, forms["plain"][1])
    timed: Dict[str, list] = {}
    for name in ("fused", "plain", "plain", "fused"):
        held = forms[name]
        run = batches[2:2 + TIMED_STEPS] if name not in timed else batches[2 + TIMED_STEPS:]
        reset_counts()
        held[1], held[2], _ = held[0](held[1], held[2], batches[1])  # warm-up
        sync(device)
        if on_card:
            expect_counts(f"dense {name} step", read_counts(),
                          {"dense_adamw_update": 1} if name == "fused" else {})
        t = time.perf_counter()
        for b in run:
            held[1], held[2], out = held[0](held[1], held[2], b)
        sync(device)
        timed.setdefault(name, []).append((time.perf_counter() - t) / len(run) * 1e3)
    for name, ms in timed.items():
        say("dense", f"{name} form ({'B10 on the table' if name == 'fused' else 'AdamW over every param'}):"
            f" {ms[0]:.3f} / {ms[1]:.3f} ms per step over {TIMED_STEPS} warm steps,"
            f" {positives / ms[0] * 1e3:.0f} / {positives / ms[1] * 1e3:.0f} positive triples/s;"
            f" final loss {float(out['loss']):.3f}")
    if profile:
        profile_steps(step, *forms["fused"][1:], batches[2:12], "dense_step_trace.json")
    return {"dense_adamw_update": {"launches": counts["dense_adamw_update"]}, "step_ms": timed}


def _adam_params(params: dict, state: dict) -> dict:
    """name -> (param, its AdamW moments {"mu", "nu"}) of a dense form's
    params and state: plain AdamW over every param, or FusedDenseAdamW on
    the table beside AdamW on the other params (the relations, and ConvE's
    trunk, named by dotted path)."""
    out, dense = {}, state
    if "entity" in state:
        out["entity_embedding"] = (params["entity_embedding"], state["entity"])
        dense = state["other"]
    flat = dict(trainer._leaves(params))
    mu, nu = dict(trainer._leaves(dense["mu"])), dict(trainer._leaves(dense["nu"]))
    out.update({path: (flat[path], {"mu": mu[path], "nu": nu[path]}) for path in mu})
    return out


def _dense_arrays(got: tuple, want: tuple, count: int, lr: float) -> list:
    """(param name, array name, got, want, extra) of each array a dense
    form's (params, state) holds: every param, with lr x the difference of
    m^/(v^1/2 + eps) of each side's own moments as its extra, and its two
    moments."""
    arrays = []
    g_adam, w_adam = _adam_params(*got), _adam_params(*want)
    for name, (w_param, w_mom) in w_adam.items():
        g_param, g_mom = g_adam[name]
        g_mom = {k: v.cpu().float() for k, v in g_mom.items()}
        w_mom = {k: v.cpu().float() for k, v in w_mom.items()}
        moved = lr * (_adam_ratio(g_mom, count, 0.9, 0.999)
                      - _adam_ratio(w_mom, count, 0.9, 0.999)).abs()
        arrays += [(name, name, g_param.cpu().float(), w_param.cpu().float(), moved),
                   (name, f"{name} mu", g_mom["mu"], w_mom["mu"], 0.0),
                   (name, f"{name} nu", g_mom["nu"], w_mom["nu"], 0.0)]
    return arrays


def _hold_dense(what: str, got: tuple, want: tuple, count: int, lr: float) -> dict:
    """A dense form's (params, state) against another's: equal bits, or every
    param within DENSE_RTOL x (|want| + max|want|) plus lr x the difference
    of m^/(v^1/2 + eps) of each side's own moments, and the moments within
    the tolerance. Returns each array's max |err| (0.0: equal bits)."""
    errs = {}
    for _, part, g, w, extra in _dense_arrays(got, want, count, lr):
        err = (g - w).abs()
        tol = DENSE_RTOL * (w.abs() + w.abs().max()) + extra
        if not (err <= tol).all() or not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {part} off by {err.max().item()}")
        errs[part] = err.max().item()
    return errs


def _sparse_arrays(got: tuple, want: tuple, rows=None, lr: float = 0.0) -> list:
    """(name, got, want, extra) of each array :func:`_hold_sparse` holds."""
    rel = "relation_embedding"
    m_rel = [side[1]["other"]["trace"][rel].cpu().float() for side in (got, want)]
    arrays = []
    if rows is not None:
        pairs = 2 * rows[:, None] + torch.arange(2)
        ent = [side[0]["entity_embedding"] for side in (got, want)]
        p_ent, m_ent = ([e[pairs[:, col].to(e.device)].cpu().float() for e in ent]
                        for col in (0, 1))
        arrays += [("momentum", *m_ent, 0.0),
                   ("params", *p_ent, lr * (m_ent[0] - m_ent[1]).abs())]
    return arrays + [("relation momentum", *m_rel, 0.0),
                     ("relation", got[0][rel].cpu().float(), want[0][rel].cpu().float(),
                      lr * (m_rel[0] - m_rel[1]).abs())]


def _hold_sparse(what: str, got: tuple, want: tuple, rows=None, lr: float = 0.0) -> dict:
    """The sparse form's (params, state) against another's over the relation
    table and its momentum and, given ``rows``, at those logical rows of the
    entity table (params and momentum), within BF16_STEP_RTOL x (|want| +
    max|want|). Given the first step's ``lr``, each param also gets lr x
    |m_got − m_want|: the step moved it by lr·m, and each side's m is held
    to the gate itself (where a relation's gradient sums 10^3-sized terms
    over the step's queries, as BoxE's do, lr·m outgrows the params)."""
    return {name: _within(what, name, g, w, extra)
            for name, g, w, extra in _sparse_arrays(got, want, rows, lr)}


def _gate_ratios(got: tuple, want: tuple, rows=None, lr: float = 0.0) -> dict:
    """Each array's max |got − want| over :func:`_hold_sparse`'s tolerance:
    under 1 where the gate holds."""
    return {name: float(((g - w).abs() / (BF16_STEP_RTOL * (w.abs() + w.abs().max()) + extra))
                        .max()) for name, g, w, extra in _sparse_arrays(got, want, rows, lr)}


def _within(what: str, name: str, got: torch.Tensor, want: torch.Tensor, extra=0.0) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = BF16_STEP_RTOL * (want.abs() + want.abs().max()) + extra
    if not (err <= tol).all() or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {name} off by {err.max().item()}")
    return err.max().item()


def _device_forms(gen: torch.Generator, device: str) -> dict:
    """bench.py's device-sampled steps at full width: the wikikg2 step
    (RowSGDM interleaved, B3) at steps_per_call 8 and the biokg step with
    plain AdamW (bench.py's form) and with FusedDenseAdamW (B10) at 10."""
    forms = {}
    triples, sharding, score_fn, _ = _wikikg2()
    module, _, pts = _training_setup(triples, sharding, score_fn)
    params = score_fn.initial_params_device(device=device, generator=gen)
    params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
    sgd, row = optim.SGD(LR, momentum=MOMENTUM), optim.RowSGDM(LR, momentum=MOMENTUM,
                                                               interleaved=True)
    forms["wikikg2"] = dict(
        module=module, opt=sgd, ent=row, spc=WIKIKG2_SPC, params=params, pts=pts,
        state=trainer.init_optimizer_state(sgd, params, None, row,
                                           n_logical=sharding.max_entity_per_shard),
        sampler=DeviceBatchSampler(pts, module.negative_sampler, shard_bs=SHARD_BS_TRAIN,
                                   batches_per_step=BPS, seed=SEED, positive_mode="runs"),
        triples=triples, want={"l1_distance_matrix_batched": 2, "l1_distance_grads_batched": 2,
                               "scatter_rows": 1},
        kernels={"l1_distance_small_kernel": 2, "l1_grads_kernel": 2, "scatter_rows_kernel": 1})
    triples, sharding, score_fn, module, pts = _biokg()
    sampler = DeviceBatchSampler(pts, module.negative_sampler, shard_bs=DENSE_SHARD_BS,
                                 batches_per_step=DENSE_BPS, seed=SEED, positive_mode="runs")
    initial = score_fn.initial_params_device(device=device, generator=gen)
    for name, ent in (("biokg_adamw", None),
                      ("biokg_fused", optim.FusedDenseAdamW(DENSE_LR, weight_decay=1e-4))):
        adamw = optim.AdamW(DENSE_LR)
        params = {k: v.clone() for k, v in initial.items()}
        forms[name] = dict(
            module=module, opt=adamw, ent=ent, spc=BIOKG_SPC, params=params, pts=pts,
            state=trainer.init_optimizer_state(adamw, params, None, ent), sampler=sampler,
            triples=triples, want={"dense_adamw_update": 1} if ent else {},
            kernels={"dense_adamw_kernel": 1} if ent else {})
    for form in forms.values():
        form["fn"] = trainer.build_device_train_step(
            form["module"], form["opt"], form["sampler"], None, form["ent"],
            steps_per_call=form["spc"], device=device)
        form["sampler_state"] = form["sampler"].state(device)
    return forms


def _card_batches_equal_cpu(name: str, form: dict) -> None:
    """The batches of one call drawn on the card equal those drawn on the
    CPU from the same key, bit for bit."""
    dev, spc, phase = form["sampler"], form["spc"], form.get("phase", "device")
    cpu_state = dev.state("cpu")
    key = dev.next_key(1000)
    card_keys, cpu_keys = split_key(key.cuda(), spc), split_key(key, spc)
    if not torch.equal(card_keys.cpu(), cpu_keys):
        raise AssertionError(f"{name}: the call's keys differ between the card and the CPU")
    for k_card, k_cpu in zip(card_keys, cpu_keys):
        card, cpu = dev.sample(form["sampler_state"], k_card), dev.sample(cpu_state, k_cpu)
        for key_name, want in cpu.items():
            if not torch.equal(card[key_name].cpu(), want):
                raise AssertionError(f"{name}: batch {key_name!r} drawn on the card differs from"
                                     " the CPU's")
    say(phase, f"{name}: the {spc} batches of a call drawn on the card equal the CPU's bit for"
        f" bit ({', '.join(f'{k} {tuple(v.shape)}' for k, v in cpu.items())})")


def _graph_equals_eager(name: str, form: dict) -> dict:
    """The first call (eager on a side stream, then captured) and two
    replays, each held against the eager card steps from the same state with
    the same key. The path's counts are set to 0 before each call and read
    after it: the first call's wrappers launch each kernel spc times a
    step's count in the warm-up and as many again into the capture; a replay
    calls no wrapper (no fall-back to eager steps, no new capture), runs
    under the sync debug mode "error" (any host synchronisation raises), and
    its launches are counted by the profiler, by kernel name. A form with an
    ``rng`` (ConvE) passes each call the dropout key ``rng(call)``, as a
    host int, which the graph copies into its static buffer. Returns the
    comparisons, counts and capture statistics."""
    fn, dev, spc, st = form["fn"], form["sampler"], form["spc"], form["sampler_state"]
    phase = form.get("phase", "device")

    def rngs(call):
        return (form["rng"](call),) if "rng" in form else ()

    graph = (form["params"], form["state"])
    eager = (trainer._clone(form["params"]), trainer._clone(form["state"]))
    sparse = isinstance(form["ent"], optim.EntityRowOptimizer)
    results = {"replays": []}
    for call in range(3):
        key = dev.next_key(call)
        if call:
            trainer._write_back(eager[0], graph[0])
            trainer._write_back(eager[1], graph[1])
        reset_counts()
        if call:
            torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*graph, st, key, *rngs(call))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = read_counts()
        per_call = 0 if call else 2  # a replay calls no wrapper
        expect_counts(f"{name} call {call}", counts,
                      {k: per_call * n * spc for k, n in form["want"].items()})
        if not call:
            results["first_call_wrapper_launches"] = {k: v for k, v in counts.items() if v}
        fn._eager(*eager, st, key.cuda(), *(torch.tensor(r, device="cuda") for r in rngs(call)))
        torch.cuda.synchronize()
        bits = {path: torch.equal(g, e) for (path, g), (_, e) in zip(
            trainer._leaves({"params": graph[0], "state": graph[1]}),
            trainer._leaves({"params": eager[0], "state": eager[1]}))}
        if sparse:
            errs = _hold_sparse(f"{name} call {call} (graph vs eager)", graph, eager)
        else:
            errs = _hold_dense(f"{name} call {call} (graph vs eager)", graph, eager,
                               (call + 1) * spc, DENSE_LR)
        if form.get("all_bits"):
            exact = list(bits)  # every array
        elif sparse:
            # The entity table (params and momentum rows) and the step counts
            # come from sums without atomics: equal bits.
            exact = [p for p in bits if "entity" in p or p.endswith("count")]
        else:
            exact = [p for p in bits if p.endswith("count")]
        if not all(bits[p] for p in exact):
            raise AssertionError(f"{name} call {call}: graph and eager differ in"
                                 f" {[p for p in exact if not bits[p]]}")
        results["replays"].append({"call": call, "graph": call > 0, "bitwise": bits,
                                   "max_abs_err": errs})
        differ = [p for p, b in bits.items() if not b]
        equal = (f"all {len(bits)} arrays equal" if not differ else
                 f"{len(bits) - len(differ)} of {len(bits)} arrays equal,"
                 f" {'; '.join(differ)} differ")
        say(phase, f"{name} call {call} ({'replay' if call else 'eager warm-up, then capture'},"
            f" key {int(key)}): {equal} against the eager card steps (max|err|"
            f" {max(errs.values()):.3g} over {len(errs)} held arrays); wrapper launches"
            f" {dict((k, v) for k, v in counts.items() if v)}"
            + ("" if call else " (the warm-up's and the capture's)"))
    results.update(fn._graph.stats)
    say(phase, f"{name}: capture of {spc} steps {results['capture_s']:.3f} s, graph pool"
        f" {results['pool_bytes'] / 2**20:.1f} MiB, peak during capture"
        f" {results['peak_bytes'] / 2**20:.1f} MiB; replays made no host sync")
    # A replay's launches, by kernel name, from the profiler.
    kernels = device_kernels(lambda: fn(*graph, st, dev.next_key(7), *rngs(7)), 1)
    seen = {kernel: sum(c for key, (_, c) in kernels.items() if kernel in key)
            for kernel in form["kernels"]}
    if seen != {k: n * spc for k, n in form["kernels"].items()}:
        raise AssertionError(f"{name}: the profiler saw {seen} in a replay, expected"
                             f" {spc} x {form['kernels']}")
    results["launches_per_call"] = seen
    say(phase, f"{name}: a replay launched {seen} (profiler, by name)")
    del eager
    return results


def _call_vs_cpu(name: str, form: dict) -> dict:
    """One steps_per_call=1 call on the card against the same call on the
    CPU, from copies of one state, within PERF.md section 2's tolerances."""
    dev, key = form["sampler"], form["sampler"].next_key(500)
    card = (trainer._clone(form["params"]), trainer._clone(form["state"]))
    cpu = (_to(form["params"], "cpu"), _to(form["state"], "cpu"))
    fn_card = trainer.build_device_train_step(form["module"], form["opt"], dev, None, form["ent"],
                                              device="cuda")
    fn_cpu = trainer.build_device_train_step(form["module"], form["opt"], dev, None, form["ent"],
                                             device="cpu")
    _, _, out = fn_card(*card, form["sampler_state"], key)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, cpu_out = fn_cpu(*cpu, dev.state("cpu"), key)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(out["loss"]), float(cpu_out["loss"])
    rtol = 2.0**-8 if name == "wikikg2" else DENSE_RTOL
    if not np.isfinite(loss) or abs(loss - cpu_loss) > rtol * abs(cpu_loss):
        raise AssertionError(f"{name}: loss {loss} on the card, {cpu_loss} on the CPU")
    if name == "wikikg2":
        batch = dev.sample(dev.state("cpu"), key)
        touched = torch.unique(torch.cat([batch[k].reshape(-1).long()
                                          for k in ("head", "tail", "negative")]))
        errs = _hold_sparse(f"{name} call vs the CPU", card, cpu, touched)
    else:
        errs = _hold_dense(f"{name} call vs the CPU", card, cpu, 1, DENSE_LR)
    say("device", f"{name}: one steps_per_call=1 call on the card vs the CPU ({cpu_s:.1f}s): loss"
        f" {loss:.6f} vs {cpu_loss:.6f}, max|err| {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}")
    return errs


def device_training(gen: torch.Generator, profile: bool = False, device: str = "cuda") -> dict:
    """bench.py's headline steps as it runs them: batches drawn on the device
    (``DeviceBatchSampler``, "runs" positives), ``steps_per_call`` steps per
    call of ``build_device_train_step``, one CUDA graph on the card
    (``device`` "cpu" rehearses the phase eagerly, without the graph's
    gates)."""
    on_card = device == "cuda"
    t = time.perf_counter()
    forms = _device_forms(gen, device)
    say("device", f"wikikg2 (spc {WIKIKG2_SPC}) and biokg (spc {BIOKG_SPC}, AdamW and"
        f" FusedDenseAdamW) forms built ({time.perf_counter() - t:.1f}s set-up)")
    results: Dict[str, dict] = {}
    for name, form in forms.items():
        if on_card:
            _card_batches_equal_cpu(name, form)
            results[name] = {"vs_cpu": _call_vs_cpu(name, form), **_graph_equals_eager(name, form)}
        else:
            out = form["fn"](form["params"], form["state"], form["sampler_state"],
                             form["sampler"].next_key(0))[2]
            results[name] = {"loss": float(out["loss"])}

    # Trainer.fit, the entry a user calls, over a few calls.
    for name, form in forms.items():
        positives = form["sampler"].partition_sample_size  # one shard
        fit_triples = form["triples"][: DEVICE_FIT_CALLS * form["spc"] * positives]
        if name == "wikikg2":
            fit_module, _, fit_pts = _training_setup(fit_triples, form["pts"].sharding,
                                                     form["module"].score_fn)
        else:
            *_, fit_module, fit_pts = _biokg(fit_triples)
        fit_dev = DeviceBatchSampler(fit_pts, fit_module.negative_sampler,
                                     shard_bs=form["sampler"].shard_bs,
                                     batches_per_step=form["sampler"].batches_per_step, seed=SEED,
                                     positive_mode="runs")
        fit = trainer.Trainer(fit_module, fit_dev, form["opt"],
                              params={k: v.clone() for k, v in form["params"].items()},
                              entity_optimizer=form["ent"], steps_per_call=form["spc"],
                              device=device)
        summary = fit.fit(n_epochs=1, log_every=1)
        losses = [r["loss"] for r in fit.history]
        if summary["steps"] != DEVICE_FIT_CALLS or not np.isfinite(losses).all():
            raise AssertionError(f"{name} Trainer.fit: {summary}")
        say("device", f"{name} Trainer.fit: {summary['steps']} calls of {form['spc']} steps, loss"
            f" {losses[0]:.3f} -> {losses[-1]:.3f}, {summary['triples_per_s']:.0f} positive"
            " triples/s, capture included")
        del fit

    # Two sets of warm calls of each form, in turns, host clock around
    # synchronised runs; a set's length comes from a timed warm-up call.
    timed: Dict[str, list] = {}
    order = list(forms)
    for name in order + order[::-1]:
        form = forms[name]
        fn, st, dev = form["fn"], form["sampler_state"], form["sampler"]
        held = (form["params"], form["state"])
        sync(device)
        t = time.perf_counter()
        fn(*held, st, dev.next_key(100))  # warm-up
        sync(device)
        n_calls = results[name].setdefault("timed_calls", max(
            DEVICE_TIMED_CALLS, int(np.ceil(DEVICE_TIMED_S / (time.perf_counter() - t)))))
        t = time.perf_counter()
        for i in range(n_calls):
            _, _, out = fn(*held, st, dev.next_key(101 + i))
        sync(device)
        timed.setdefault(name, []).append(
            (time.perf_counter() - t) / (n_calls * form["spc"]) * 1e3)
        results[name]["final_loss"] = float(out["loss"])
    for name, ms in timed.items():
        positives = forms[name]["sampler"].partition_sample_size
        spread = 100 * abs(ms[0] - ms[1]) / min(ms)
        say("device", f"{name} (device-sampled, {forms[name]['spc']} steps per call): {ms[0]:.4f} /"
            f" {ms[1]:.4f} ms per step over {results[name]['timed_calls']} calls each (spread"
            f" {spread:.1f} %), {positives / ms[0] * 1e3:.0f} / {positives / ms[1] * 1e3:.0f}"
            " positive triples/s")
        results[name]["ms_per_step"] = ms
    if profile and on_card:
        for name, form in forms.items():
            fn, st, dev = form["fn"], form["sampler_state"], form["sampler"]
            held = (form["params"], form["state"])
            results[name]["profile"] = profile_run(
                lambda: [fn(*held, st, dev.next_key(200 + i)) for i in range(2)],
                2 * form["spc"], f"device_{name}_trace.json")
    return results


def _packed_score_fn(sharding: Sharding, half: torch.dtype) -> TransE:
    """The wikikg2 scorer (bf16 scoring math) with both tables in ``half``
    and the entity table row-pair-packed, as bench.py sets it up for its
    wikikg2_bf16 and wikikg2_fp16 configurations."""
    score_fn = TransE(True, 1, sharding, N_RELATION, DIM, seed=SEED)
    score_fn.compute_dtype = torch.bfloat16
    score_fn.dtype = half
    score_fn.packed_entity_storage = True
    return score_fn


def _packed_forms(gen: torch.Generator, device: str, names=("wikikg2", *PACKED)) -> dict:
    """bench.py's wikikg2, wikikg2_bf16 and wikikg2_fp16 device-sampled steps
    (those of ``names``) at full width, RowSGDM interleaved (the fp32
    pair-major table, or the packed triplet store) at steps_per_call 8; each
    form keeps the table as drawn (``plain``) for Trainer.fit to widen."""
    triples, sharding, score_fn, _ = _wikikg2()
    forms = {}
    for name, half in (("wikikg2", None), *PACKED.items()):
        if name not in names:
            continue
        if half is not None:
            score_fn = _packed_score_fn(sharding, half)
        module, _, pts = _training_setup(triples, sharding, score_fn)
        params = score_fn.initial_params_device(device=device, generator=gen)
        sgd, row = optim.SGD(LR, momentum=MOMENTUM), optim.RowSGDM(LR, momentum=MOMENTUM,
                                                                   interleaved=True)
        plain = params["entity_embedding"]
        params["entity_embedding"] = row.widen_table(plain)
        forms[name] = dict(
            module=module, opt=sgd, ent=row, spc=WIKIKG2_SPC, params=params, pts=pts,
            plain=plain, triples=triples, all_bits=half is not None, phase="packed",
            state=trainer.init_optimizer_state(sgd, params, None, row,
                                               n_logical=sharding.max_entity_per_shard),
            sampler=DeviceBatchSampler(pts, module.negative_sampler, shard_bs=SHARD_BS_TRAIN,
                                       batches_per_step=BPS, seed=SEED, positive_mode="runs"),
            want={"l1_distance_matrix_batched": 2, "l1_distance_grads_batched": 2,
                  "scatter_rows": 1},
            kernels={"l1_distance_small_kernel": 2, "l1_grads_kernel": 2,
                     "scatter_rows_kernel": 1})
        forms[name]["fn"] = trainer.build_device_train_step(
            module, sgd, forms[name]["sampler"], None, row, steps_per_call=WIKIKG2_SPC,
            device=device)
        forms[name]["sampler_state"] = forms[name]["sampler"].state(device)
    return forms


def _ordinal16(bits: torch.Tensor) -> torch.Tensor:
    """16-bit float patterns (int16) as integers ordered like their values,
    ±0 both 0: neighbouring values are 1 apart."""
    b = bits.to(torch.int32) & 0xFFFF
    return torch.where(b >= 0x8000, -(b & 0x7FFF), b)


def _ulp16(x: torch.Tensor, half: torch.dtype) -> torch.Tensor:
    """The spacing of ``half`` values at |x| (the subnormal spacing at 0)."""
    mantissa, tiny = (7, 2.0**-133) if half == torch.bfloat16 else (10, 2.0**-24)
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 1 - mantissa)
    return torch.where(x == 0, tiny, torch.clamp(ulp, min=tiny))


def _packed_call_vs_cpu(name: str, form: dict) -> dict:
    """One steps_per_call=1 call of a packed form on the card against the
    same call on the CPU, from copies of one state. Untouched rows (the
    untouched siblings of touched rows among them) bit for bit as before
    the call; the fp32 momentum rows of the store and the 16-bit relation
    table and its trace within BF16_STEP_RTOL x (|want| + max|want|). A
    16-bit entity value is the stochastic rounding, with the same random
    bits on both devices, of ``p − lr·m``: it may differ by lr x the
    difference of the two devices' momenta (their gradients differ in the
    last bits of B1's bf16 distances and B2's sums) plus one 16-bit ulp in
    bf16, whose rounding (truncation after adding the random bits) is
    monotone, and two in fp16: its two-candidate rounding takes each value's
    neighbour on its own error's side, so two values just either side of a
    representable one that draw the same small number round away from it in
    opposite directions. The share of values that differ, and the largest
    difference in ulps, are reported."""
    dev, key = form["sampler"], form["sampler"].next_key(500)
    n = N_ENTITY
    before = packed.unpack_table(packed.split_packed_interleaved(form["params"]["entity_embedding"])[0], n)
    card = (trainer._clone(form["params"]), trainer._clone(form["state"]))
    cpu = (_to(form["params"], "cpu"), _to(form["state"], "cpu"))
    fn_card = trainer.build_device_train_step(form["module"], form["opt"], dev, None, form["ent"],
                                              device="cuda")
    fn_cpu = trainer.build_device_train_step(form["module"], form["opt"], dev, None, form["ent"],
                                             device="cpu")
    _, _, out = fn_card(*card, form["sampler_state"], key)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, cpu_out = fn_cpu(*cpu, dev.state("cpu"), key)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > 2.0**-8 * abs(cpu_loss):
        raise AssertionError(f"{name}: loss {loss} on the card, {cpu_loss} on the CPU")
    batch = dev.sample(dev.state("cpu"), key)
    touched = torch.zeros(n, dtype=torch.bool)
    for k in ("head", "tail", "negative"):
        touched[batch[k].reshape(-1).long()] = True
    card_p, (card_m,) = packed.split_packed_state(card[0]["entity_embedding"], 1)
    cpu_p, (cpu_m,) = packed.split_packed_state(cpu[0]["entity_embedding"], 1)
    got_v = packed.unpack_table(card_p, n).cpu()
    want_v = packed.unpack_table(cpu_p, n)
    got, want = got_v.view(torch.int16), want_v.view(torch.int16)
    gap = (_ordinal16(got) - _ordinal16(want)).abs()
    rows = torch.nonzero(touched).reshape(-1)
    moved = LR * (card_m[rows.cuda()].cpu() - cpu_m[rows]).abs()
    ulps = 1 if got_v.dtype == torch.bfloat16 else 2
    tol = moved + ulps * _ulp16(
        torch.maximum(got_v[rows].float().abs(), want_v[rows].float().abs()), got_v.dtype)
    off = (got_v[rows].float() - want_v[rows].float()).abs()
    if not (off <= tol).all():
        raise AssertionError(f"{name}: entity values off the CPU's by {float((off - tol).max())}"
                             f" beyond lr x the momentum difference plus {ulps} ulp")
    base = before.cpu().view(torch.int16)
    if not (torch.equal(got[~touched], base[~touched]) and torch.equal(want[~touched],
                                                                      base[~touched])):
        raise AssertionError(f"{name}: the call moved untouched rows (or sibling planes)")
    pairs = touched.reshape(-1, 2)
    lone = int((pairs[:, 0] != pairs[:, 1]).sum())
    errs = {"momentum": _within(f"{name} vs the CPU", "momentum", card_m[rows.cuda()].cpu(),
                                cpu_m[rows])}
    errs.update(_hold_sparse(f"{name} call vs the CPU", card, cpu))
    differ, one_ulp = int((gap > 0).sum()), int((gap == 1).sum())
    same_m = moved == 0
    values = int(touched.sum()) * DIM
    say("packed", f"{name}: one steps_per_call=1 call on the card vs the CPU ({cpu_s:.1f}s): loss"
        f" {loss:.6f} vs {cpu_loss:.6f}; 16-bit entity values: {differ} of {values} touched"
        f" ({100 * differ / values:.4f} %) differ, {one_ulp} by one ulp, at most"
        f" {int(gap.max())} ulps; where the momenta agree ({int(same_m.sum())} values) at most"
        f" {int(gap[rows][same_m].max()) if same_m.any() else 0} ulp; {int((~touched).sum())}"
        f" untouched rows bit for bit ({lone} packed rows with one plane touched); max|err|"
        f" {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}")
    del card, cpu
    return {"values_differ": differ, "values_one_ulp": one_ulp, "max_ulps": int(gap.max()),
            "touched_values": values, "max_abs_err": errs}


def _packed_layout_gates(name: str, form: dict, device: str) -> dict:
    """The port's layouts against each other on one host-fed step
    (``build_train_step``) from copies of one state, bit for bit: the
    triplet store (RowSGDM, B3 h = 3) against a packed table with a separate
    momentum buffer (B8, k = 2), and the quintuplet store (RowAdamW, B3
    h = 5) against a packed table with separate moments (B8, k = 3). The
    twins of tests/test_packed_interleaved.py:101 and
    tests/test_adamw_interleaved.py:311 at full width."""
    table, (momentum,) = packed.split_packed_state(form["params"]["entity_embedding"], 1)
    table = table.contiguous()
    rel = form["params"]["relation_embedding"]
    dev = form["sampler"]
    batch = dev.sample(form["sampler_state"], dev.next_key(900).to(device))
    sgd = form["opt"]
    results = {}
    for opt_name, k, wide_opt, sep_opt, widen in (
        ("RowSGDM", 1, optim.RowSGDM(LR, MOMENTUM, interleaved=True), optim.RowSGDM(LR, MOMENTUM),
         lambda t: packed.interleave_packed_momentum(t, momentum)),
        ("RowAdamW", 2, optim.RowAdamW(LR, interleaved=True), optim.RowAdamW(LR),
         packed.interleave_packed_adamw),
    ):
        runs = {}
        for layout, opt, ent in (("interleaved", wide_opt, widen(table)),
                                 ("separate", sep_opt, table.clone())):
            params = {"entity_embedding": ent, "relation_embedding": rel.clone()}
            state = trainer.init_optimizer_state(sgd, params, None, opt, n_logical=N_ENTITY)
            if layout == "separate" and k == 1:
                state["entity"]["m"].copy_(momentum)
            step = trainer.build_train_step(form["module"], sgd, None, opt, device=device)
            reset_counts()
            params, state, out = step(params, state, batch)
            sync(device)
            runs[layout] = (params, state, read_counts(), float(out["loss"]))
        (p_i, s_i, c_i, loss_i), (p_s, s_s, c_s, loss_s) = runs["interleaved"], runs["separate"]
        if device == "cuda":
            base = {"l1_distance_matrix_batched": 2, "l1_distance_grads_batched": 2}
            expect_counts(f"{name} {opt_name} interleaved", c_i, {**base, "scatter_rows": 1})
            expect_counts(f"{name} {opt_name} separate", c_s, {**base, "scatter_rows_multi": 1})
        params_i, states_i = packed.split_packed_state(p_i["entity_embedding"], k)
        moments = ["m"] if k == 1 else ["mu", "nu"]
        same = {
            "params": torch.equal(params_i.view(torch.int32),
                                  p_s["entity_embedding"].view(torch.int32)),
            **{m: torch.equal(si, s_s["entity"][m]) for m, si in zip(moments, states_i)},
            "relation": torch.equal(p_i["relation_embedding"], p_s["relation_embedding"]),
            "relation momentum": torch.equal(s_i["other"]["trace"]["relation_embedding"],
                                             s_s["other"]["trace"]["relation_embedding"]),
            "loss": loss_i == loss_s,
        }
        if not all(same.values()):
            raise AssertionError(f"{name} {opt_name}: interleaved and separate differ in"
                                 f" {[k for k, v in same.items() if not v]}")
        store = p_i["entity_embedding"]
        say("packed", f"{name} {opt_name}: the {tuple(store.shape)} store (launches"
            f" {dict((k, v) for k, v in c_i.items() if v)}) and separate buffers (launches"
            f" {dict((k, v) for k, v in c_s.items() if v)}) give equal bits on every array"
            f" after one step")
        results[opt_name] = {"interleaved_launches": {k: v for k, v in c_i.items() if v},
                             "separate_launches": {k: v for k, v in c_s.items() if v}}
        del runs, p_i, s_i, p_s, s_s, params_i, states_i, store
    return results


def packed_training(gen: torch.Generator, profile: bool = False, device: str = "cuda") -> dict:
    """bench.py's wikikg2_bf16 and wikikg2_fp16 steps as it runs them: the
    entity table row-pair-packed into the triplet store, the relation table
    16-bit, batches drawn on the device, steps_per_call 8 in one CUDA graph;
    timed in turns with the fp32 wikikg2 step. ``device`` "cpu" rehearses
    the phase eagerly, without the graph's and the card's gates."""
    on_card = device == "cuda"
    t = time.perf_counter()
    forms = _packed_forms(gen, device)
    table_bytes = {name: f["params"]["entity_embedding"].numel()
                   * f["params"]["entity_embedding"].element_size() for name, f in forms.items()}
    say("packed", f"wikikg2 (fp32 pair-major), wikikg2_bf16 and wikikg2_fp16 (triplet stores) at"
        f" spc {WIKIKG2_SPC} built ({time.perf_counter() - t:.1f}s set-up); table bytes"
        f" {table_bytes}")
    results: Dict[str, dict] = {name: {"table_bytes": b} for name, b in table_bytes.items()}
    for name in PACKED:
        form = forms[name]
        if on_card:
            _card_batches_equal_cpu(name, form)
            results[name]["vs_cpu"] = _packed_call_vs_cpu(name, form)
            results[name].update(_graph_equals_eager(name, form))
        else:
            out = form["fn"](form["params"], form["state"], form["sampler_state"],
                             form["sampler"].next_key(0))[2]
            results[name]["loss"] = float(out["loss"])
        results[name]["layouts"] = _packed_layout_gates(name, form, device)

    # Trainer.fit, the entry a user calls: it widens the packed table.
    for name in PACKED:
        form = forms[name]
        positives = form["sampler"].partition_sample_size
        fit_triples = form["triples"][: DEVICE_FIT_CALLS * form["spc"] * positives]
        fit_module, _, fit_pts = _training_setup(fit_triples, form["pts"].sharding,
                                                 form["module"].score_fn)
        fit_dev = DeviceBatchSampler(fit_pts, fit_module.negative_sampler, shard_bs=SHARD_BS_TRAIN,
                                     batches_per_step=BPS, seed=SEED, positive_mode="runs")
        rel = form["params"]["relation_embedding"]
        fit = trainer.Trainer(fit_module, fit_dev, form["opt"],
                              params={"entity_embedding": form.pop("plain"),
                                      "relation_embedding": rel.clone()},
                              entity_optimizer=form["ent"], steps_per_call=form["spc"],
                              device=device)
        if fit.params["entity_embedding"].shape != form["params"]["entity_embedding"].shape:
            raise AssertionError(f"{name}: Trainer widened the packed table to"
                                 f" {tuple(fit.params['entity_embedding'].shape)}")
        summary = fit.fit(n_epochs=1, log_every=1)
        losses = [r["loss"] for r in fit.history]
        if summary["steps"] != DEVICE_FIT_CALLS or not np.isfinite(losses).all():
            raise AssertionError(f"{name} Trainer.fit: {summary}")
        say("packed", f"{name} Trainer.fit (the packed table widened to the triplet store):"
            f" {summary['steps']} calls of {form['spc']} steps, loss {losses[0]:.3f} ->"
            f" {losses[-1]:.3f}, capture included")
        del fit
    forms["wikikg2"].pop("plain")

    # Sets of warm calls of each form, in turns (fp32, bf16, fp16, then
    # reversed), host clock around synchronised runs; the fp32 form's first
    # call (its capture) comes first, so that no set's length is read off a
    # capture.
    fp32 = forms["wikikg2"]
    fp32["fn"](fp32["params"], fp32["state"], fp32["sampler_state"], fp32["sampler"].next_key(99))
    timed: Dict[str, list] = {}
    order = list(forms)
    for name in order + order[::-1]:
        form = forms[name]
        fn, st, dev = form["fn"], form["sampler_state"], form["sampler"]
        held = (form["params"], form["state"])
        sync(device)
        t = time.perf_counter()
        fn(*held, st, dev.next_key(100))  # warm-up
        sync(device)
        n_calls = results[name].setdefault("timed_calls", max(
            DEVICE_TIMED_CALLS, int(np.ceil(DEVICE_TIMED_S / (time.perf_counter() - t)))))
        t = time.perf_counter()
        for i in range(n_calls):
            _, _, out = fn(*held, st, dev.next_key(101 + i))
        sync(device)
        timed.setdefault(name, []).append(
            (time.perf_counter() - t) / (n_calls * form["spc"]) * 1e3)
        results[name]["final_loss"] = float(out["loss"])
    positives = SHARD_BS_TRAIN * BPS
    for name, ms in timed.items():
        spread = 100 * abs(ms[0] - ms[1]) / min(ms)
        say("packed", f"{name} (spc {WIKIKG2_SPC}, {table_bytes[name] / 1e9:.3f} GB table): {ms[0]:.5f}"
            f" / {ms[1]:.5f} ms per step over {results[name]['timed_calls']} calls each (spread"
            f" {spread:.2f} %), {positives / ms[0] * 1e3:.0f} / {positives / ms[1] * 1e3:.0f}"
            f" positive triples/s; {min(ms) / min(timed['wikikg2']):.4f}x the fp32 step")
        results[name]["ms_per_step"] = ms
    if profile and on_card:
        for name, form in forms.items():
            fn, st, dev = form["fn"], form["sampler_state"], form["sampler"]
            held = (form["params"], form["state"])
            results[name]["profile"] = profile_run(
                lambda: [fn(*held, st, dev.next_key(200 + i)) for i in range(2)],
                2 * form["spc"], f"packed_{name}_trace.json")
    return results


class PeakRSS:
    """The host's peak resident bytes above their level on entry, sampled
    every millisecond from ``/proc/self/statm`` by a thread; ``extra`` is
    ``None`` where that file cannot be read."""

    def __enter__(self) -> "PeakRSS":
        self.base = self.peak = self._rss()
        self.extra = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        if self.base is not None:
            self._thread.start()
        return self

    @staticmethod
    def _rss():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError):
            return None

    def _sample(self) -> None:
        while not self._stop.wait(0.001):
            self.peak = max(self.peak, self._rss() or 0)

    def __exit__(self, *exc) -> None:
        if self.base is not None:
            self._stop.set()
            self._thread.join()
            self.peak = max(self.peak, self._rss() or 0)
            self.extra = self.peak - self.base


def _timed_io(what: str, fn, path: Path = None) -> tuple:
    """``fn()``'s result, and its seconds, the host's peak extra RSS and the
    bytes of ``path`` afterwards."""
    with PeakRSS() as rss:
        t = time.perf_counter()
        result = fn()
        seconds = time.perf_counter() - t
    stats = {f"{what}_s": seconds, f"{what}_peak_extra_rss_bytes": rss.extra}
    if path is not None:
        stats["bytes"] = path.stat().st_size
    return result, stats


def _same_tree(what: str, got: dict, want: dict) -> int:
    """Every leaf of ``got`` equals ``want``'s bit for bit (the same paths);
    returns the number of leaves."""
    got_leaves, want_leaves = dict(trainer._leaves(got)), dict(trainer._leaves(want))
    if got_leaves.keys() != want_leaves.keys():
        raise AssertionError(f"{what}: leaves {sorted(got_leaves)} against {sorted(want_leaves)}")
    for path, value in want_leaves.items():
        other = got_leaves[path].to(value.device)
        if other.dtype != value.dtype or not torch.equal(other.reshape(-1).view(torch.uint8),
                                                         value.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{what}: {path} differs")
    return len(want_leaves)


def _resume_gate(name: str, form: dict, tmp: Path, device: str) -> dict:
    """The form's device-sampled run saved after two calls and resumed in a
    fresh Trainer equals four calls without a break, on every array, bit for
    bit: the uninterrupted run on the form's own step, the interrupted one
    through ``Trainer.train_step``, ``Trainer.save`` and ``load_checkpoint``.
    The device sampler's batches are keyed by the call index, so the resumed
    calls take ``next_key(2)`` and ``next_key(3)``."""
    on_card = device == "cuda"
    fn, sampler_state, dev, spc = form["fn"], form["sampler_state"], form["sampler"], form["spc"]
    start = (trainer._clone(form["params"]), trainer._clone(form["state"]))
    for i in range(4):
        fn(form["params"], form["state"], sampler_state, dev.next_key(i))
    sync(device)

    def fresh(params):
        return trainer.Trainer(form["module"], dev, form["opt"], params=params,
                               entity_optimizer=form["ent"], steps_per_call=spc, device=device)

    def calls(tr, keys):
        for i in keys:
            tr.params, tr.opt_state, _ = tr.train_step(tr.params, tr.opt_state, tr.sampler_state,
                                                       dev.next_key(i))
        sync(device)

    first = fresh(start[0])
    first.opt_state = start[1]
    calls(first, range(2))
    path = tmp / f"{name}.npz"
    _, stats = _timed_io("save", lambda: first.save(str(path), step=2 * spc), path)
    del first, start
    if on_card:
        torch.cuda.empty_cache()
    (params, state, _, meta), load = _timed_io(
        "load", lambda: checkpoint.load_checkpoint(path, interleave_entity=True))
    stats.update(load)
    if meta != {"step": 2 * spc}:
        raise AssertionError(f"{name}: meta {meta}")
    resumed = fresh(params)
    del params
    resumed.opt_state = _to(state, device)
    for part in ("entity", "other"):
        count = resumed.opt_state[part]["count"]
        if count.dtype != torch.int32 or count.dim() or count.device.type != device \
                or int(count) != 2 * spc:
            raise AssertionError(f"{name}: restored {part} count {count!r}")
    reset_counts()
    calls(resumed, (2, 3))
    counts = _launched()
    if on_card:  # the first call's eager warm-up and capture, then a replay
        expect_counts(f"{name} resumed calls", counts, {
            k: 2 * n * spc for k, n in form["want"].items()})
    n_leaves = _same_tree(f"{name} resumed", dict(params=resumed.params, state=resumed.opt_state),
                          dict(params=form["params"], state=form["state"]))
    say("checkpoint", f"{name}: 2 calls, Trainer.save ({stats['bytes']} bytes,"
        f" {stats['save_s']:.2f} s), load_checkpoint ({stats['load_s']:.2f} s), a fresh Trainer,"
        f" calls 2 and 3: all {n_leaves} arrays equal 4 uninterrupted calls bit for bit; host peak"
        f" extra RSS save {stats['save_peak_extra_rss_bytes']}, load"
        f" {stats['load_peak_extra_rss_bytes']} bytes; launches {counts}")
    stats["launches"] = counts
    return stats


def _adagrad_round_trip(form: dict, tmp: Path, device: str) -> dict:
    """One device-sampled call of RowAdagrad in the pair-major store (B3,
    h = 2) from the form's current params, then ``Trainer.save`` (the
    accumulator to ``opt/entity/acc``) and ``load_checkpoint`` with
    ``interleave_entity="adagrad"``: the store comes back bit for bit."""
    p, _ = optim.split_interleaved(form["params"]["entity_embedding"])
    ada = optim.RowAdagrad(LR, interleaved=True)
    tr = trainer.Trainer(form["module"], form["sampler"], form["opt"],
                         params={"entity_embedding": p.contiguous(),
                                 "relation_embedding": form["params"]["relation_embedding"].clone()},
                         entity_optimizer=ada, steps_per_call=form["spc"], device=device)
    reset_counts()
    tr.params, tr.opt_state, out = tr.train_step(tr.params, tr.opt_state, tr.sampler_state,
                                                 form["sampler"].next_key(4))
    sync(device)
    counts = _launched()
    if device == "cuda":
        expect_counts("RowAdagrad interleaved call", counts, {
            k: 2 * n * form["spc"] for k, n in form["want"].items()})
    path = tmp / "wikikg2_adagrad.npz"
    _, stats = _timed_io("save", lambda: tr.save(str(path), step=form["spc"]), path)
    with np.load(path) as data:
        keys = sorted(k for k in data.files if k.startswith("opt/entity/"))
    if keys != ["opt/entity/acc", "opt/entity/count"]:
        raise AssertionError(f"RowAdagrad checkpoint keys {keys}")
    (params, state, _, _), load = _timed_io(
        "load", lambda: checkpoint.load_checkpoint(path, interleave_entity="adagrad"))
    stats.update(load)
    path.unlink()
    table = params.pop("entity_embedding").to(device)
    wide = tr.params["entity_embedding"]
    _, acc = optim.split_interleaved(wide)
    if not (torch.equal(table, wide) and (acc > 0).any() and torch.isfinite(acc).all()):
        raise AssertionError("the RowAdagrad store did not come back bit for bit")
    _same_tree("RowAdagrad state", _to(state, device), tr.opt_state)
    say("checkpoint", f"RowAdagrad pair-major {tuple(wide.shape)} store after one call (loss"
        f" {float(out['loss']):.4f}; launches {counts}): save {stats['bytes']} bytes in"
        f" {stats['save_s']:.2f} s, load {stats['load_s']:.2f} s, bit for bit with"
        f" opt/entity/acc in the file")
    stats["launches"] = counts
    return stats


def _reshard_gate(tmp: Path, device: str) -> dict:
    """The fp32 wikikg2 checkpoint re-sharded onto 4 shards, saved, and
    re-sharded back onto its 1-shard sharding: the table and the momentum
    come back bit for bit, and 512 top-10 queries (B7 chunk merge) over the
    restored table give the original table's answers by global entity ID."""
    path = tmp / "wikikg2.npz"
    (params, state, sharding, meta), plain = _timed_io(
        "load", lambda: checkpoint.load_checkpoint(path))
    four = Sharding.create(N_ENTITY, 4, seed=SEED)
    (p4, s4, sh4, _), to_four = _timed_io(
        "load", lambda: checkpoint.load_checkpoint(path, new_sharding=four))
    path.unlink()
    path4 = tmp / "wikikg2_4shard.npz"
    _, saved = _timed_io("save", lambda: checkpoint.save_checkpoint(path4, p4, s4, sh4,
                                                                     step=meta["step"]), path4)
    moved = not torch.equal(p4["entity_embedding"][:N_ENTITY], params["entity_embedding"])
    del p4, s4
    (back, back_state, back_sharding, _), to_one = _timed_io(
        "load", lambda: checkpoint.load_checkpoint(path4, new_sharding=sharding))
    path4.unlink()
    _same_tree("1 -> 4 -> 1 params", back, params)
    _same_tree("1 -> 4 -> 1 state", back_state, state)
    if not moved or back_sharding is not sharding:
        raise AssertionError("the 4-shard table did not move rows")

    # Serve 512 queries from both tables.
    score_fn = TransE(True, 1, sharding, N_RELATION, DIM, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    heads = rng.choice(N_ENTITY, size=SHARD_BS, replace=False).astype(np.int32)
    rels = rng.integers(N_RELATION, size=SHARD_BS).astype(np.int32)
    dataset = KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                        triples={"test": np.zeros((1, 3), np.int32)},
                        original_triple_ids={"test": np.arange(1)})
    pts = PartitionedTripleSet.create_from_queries(dataset, sharding, np.stack([heads, rels], 1),
                                                   "hr", ground_truth=heads)
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=SEED)
    sampler = RigidShardedBatchSampler(pts, ns, shard_bs=SHARD_BS, batches_per_step=1, seed=SEED,
                                       return_triple_idx=True)
    batch = sampler.sample_batch(next(iter(sampler.epoch_index_blocks(shuffle=False))))
    topk = TopKQueryBessKGE(k=K, candidate_sampler=ns, score_fn=score_fn, return_scores=True,
                            merge_mode="chunk")
    fwd = build_topk_forward(topk, device=device)
    answers = {}
    for what, tree in (("original", params), ("restored", back)):
        tables = {k: v.to(device) for k, v in tree.items()}
        reset_counts()
        answers[what] = fwd(tables, batch)
        sync(device)
        counts = _launched()
        if device == "cuda":
            expect_counts(f"top-{K} over the {what} table", counts, {
                "l1_scores_chunkmax": -(-sharding.max_entity_per_shard // topk.window_size)})
        del tables
    ids = {k: v["topk_global_id"] for k, v in answers.items()}
    scores = {k: v["topk_scores"] for k, v in answers.items()}
    if not (torch.equal(ids["original"], ids["restored"])
            and torch.equal(scores["original"], scores["restored"])):
        raise AssertionError("top-10 over the restored table differs from the original's")
    stats = {"load_1_shard": plain, "load_1_to_4": to_four, "save_4_shard": saved,
             "load_4_to_1": to_one, "topk_launches": counts}
    say("checkpoint", f"reshard 1 -> 4 -> 1 ({tuple(back['entity_embedding'].shape)} table and"
        f" its momentum bit for bit): load {plain['load_s']:.2f} s, load onto 4 shards"
        f" {to_four['load_s']:.2f} s, save {saved['bytes']} bytes {saved['save_s']:.2f} s,"
        f" load back {to_one['load_s']:.2f} s; top-{K} of {SHARD_BS} queries over the restored"
        f" table equal the original's by global ID (launches {counts})")
    return stats


def checkpoint_phase(gen: torch.Generator, device: str = "cuda") -> dict:
    """Checkpoints of bench.py's wikikg2 and wikikg2_bf16 device-sampled
    steps at full width: resumed bit for bit, a RowAdagrad store round trip,
    and a 1 -> 4 -> 1 reshard with top-10 serving from the restored table.
    Files go to a temporary directory, deleted afterwards. ``device`` "cpu"
    rehearses the phase without the card's launch gates."""
    t = time.perf_counter()
    forms = _packed_forms(gen, device, names=("wikikg2", "wikikg2_bf16"))
    for form in forms.values():
        form.pop("plain")
    say("checkpoint", f"wikikg2 (fp32 pair-major) and wikikg2_bf16 (triplet store) at spc"
        f" {WIKIKG2_SPC} built ({time.perf_counter() - t:.1f}s set-up)")
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files["wikikg2_bf16"] = _resume_gate("wikikg2_bf16", forms.pop("wikikg2_bf16"), tmp, device)
        (tmp / "wikikg2_bf16.npz").unlink()
        files["wikikg2"] = _resume_gate("wikikg2", forms["wikikg2"], tmp, device)
        files["wikikg2_adagrad"] = _adagrad_round_trip(forms.pop("wikikg2"), tmp, device)
        files["reshard"] = _reshard_gate(tmp, device)
    return files


def _hold_topk(what: str, got: dict, ref: torch.Tensor, sharding: Sharding, rtol: float) -> int:
    """A top-K output (``topk_scores``, ``topk_global_id``, (Q, K)) against
    ``ref`` (Q, local rows), the full-table reference scores (padding rows
    at -inf): the scores within rtol x (|want| + max|want|) of the
    reference's top K, each returned ID's own reference score within that of
    its returned score, and the IDs equal as sets wherever the K-th and
    (K+1)-th reference scores stand further apart than twice the tolerance.
    Returns the number of such queries."""
    scores, ids = got["topk_scores"].float(), got["topk_global_id"].long()
    want = torch.topk(ref, K + 1, dim=1)
    top = want.values[:, :K]
    tol = rtol * (top.abs() + top.abs().max())
    own = ref.gather(1, torch.as_tensor(sharding.entity_to_idx, device=ref.device)[ids])
    if not ((scores - top).abs() <= tol).all() or not ((own - scores).abs() <= tol).all():
        raise AssertionError(f"{what}: top-{K} scores off the full-table reference by"
                             f" {(scores - top).abs().max().item()} (own"
                             f" {(own - scores).abs().max().item()})")
    s2e = torch.as_tensor(sharding.shard_and_idx_to_entity[0], device=ref.device)
    ref_ids = s2e[want.indices[:, :K]]
    sure = (want.values[:, K - 1] - want.values[:, K]) > 2 * tol.max()
    same = (ids.sort(1).values == ref_ids.sort(1).values).all(1)
    if not same[sure].all():
        raise AssertionError(f"{what}: top-{K} IDs differ from the full-table reference")
    return int(sure.sum())


def _same_topk(what: str, got: dict, want: dict, rtol: float) -> None:
    """Two top-K outputs of the same queries: scores within rtol x (|want| +
    max|want|) (0: equal bits), IDs equal at every position whose score
    stands further than twice that from both neighbours."""
    g, w = got["topk_scores"].float().cpu(), want["topk_scores"].float().cpu()
    tol = rtol * (w.abs() + w.abs().max())
    if not ((g - w).abs() <= tol).all():
        raise AssertionError(f"{what}: top-{K} scores differ by {(g - w).abs().max().item()}")
    gap = (w[:, :-1] - w[:, 1:]).abs() > 2 * tol.max()
    alone = torch.ones_like(w, dtype=torch.bool)
    alone[:, 1:] &= gap
    alone[:, :-1] &= gap
    if not torch.equal(got["topk_global_id"].cpu()[alone], want["topk_global_id"].cpu()[alone]):
        raise AssertionError(f"{what}: top-{K} IDs differ away from ties")


def _complex_reference(params: dict, sharding: Sharding, rel: torch.Tensor,
                       head: torch.Tensor) -> torch.Tensor:
    """ComplEx tail scores of (head, rel) queries against every local row:
    one full-fp32 product against the whole table; padding rows at -inf."""
    table, rel_table = params["entity_embedding"], params["relation_embedding"]
    query = complex_multiplication(table[head.long()], rel_table[rel.long()])
    ref = torch.matmul(query, table.T)  # main() turns TF32 off
    ref[:, int(sharding.shard_counts[0]):] = -float("inf")
    return ref


def _yago_serving(what: str, params: dict, sharding: Sharding, score_fn, device: str) -> dict:
    """bench.py's run_topk on ``params``: 512 queries, relations uniform in
    37, heads uniform over the local rows, the default window and chunk
    merge; gated against a full-table reference, the sort merge, planted
    answers and the CPU. Returns times and the batch's peak memory."""
    on_card = device == "cuda"
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=SEED)
    rng = np.random.default_rng(SEED)
    rel = torch.from_numpy(rng.integers(YAGO_RELATION, size=YAGO_QUERIES)).to(device)
    head = torch.from_numpy(rng.integers(sharding.max_entity_per_shard,
                                         size=YAGO_QUERIES)).to(device)
    topk = TopKQueryBessKGE(K, ns, score_fn, return_scores=True)
    sort = TopKQueryBessKGE(K, ns, score_fn, return_scores=True, merge_mode="sort")
    with torch.inference_mode():
        out = topk.forward(params, rel, head=head)  # warm-up
        sync(device)
        best = float("inf")
        for _ in range(YAGO_REPEATS):
            t = time.perf_counter()
            for _ in range(YAGO_BATCHES):
                out = topk.forward(params, rel, head=head)
            sync(device)
            best = min(best, (time.perf_counter() - t) / YAGO_BATCHES)
        peak = None
        if on_card:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            topk.forward(params, rel, head=head)
            sync(device)
            peak = torch.cuda.max_memory_allocated() - base
        if not torch.isfinite(out["topk_scores"]).all() or out["topk_global_id"].shape != (
                YAGO_QUERIES, K):
            raise AssertionError(f"{what}: top-{K} output {tuple(out['topk_global_id'].shape)}")
        ref = _complex_reference(params, sharding, rel[:N_REFERENCE], head[:N_REFERENCE])
        sure = _hold_topk(f"{what} vs the full-table reference",
                          {k: v[:N_REFERENCE] for k, v in out.items()}, ref, sharding, DENSE_RTOL)
        _same_topk(f"{what} chunk vs sort merge", out, sort.forward(params, rel, head=head), 0.0)
        cpu = {k: v.cpu() for k, v in params.items()}
        _same_topk(f"{what} card vs CPU", {k: v[:64] for k, v in out.items()},
                   topk.forward(cpu, rel[:64].cpu(), head=head[:64].cpu()), DENSE_RTOL)
        # Planted answers: each tail row set to c·q/|q|, q = h ∘ r, with c ten
        # times the largest row norm: it scores c|q| against its query, more
        # than any other planted row (c|q|cos) or any other row (< c|q|/10).
        ents = rng.choice(YAGO_ENTITY, size=2 * YAGO_QUERIES, replace=False)
        e2i = torch.as_tensor(sharding.entity_to_idx, device=device)
        h_loc = e2i[torch.from_numpy(ents[:YAGO_QUERIES]).to(device)]
        t_glob = torch.from_numpy(ents[YAGO_QUERIES:]).to(device)
        planted = {k: v.clone() for k, v in params.items()}
        table = planted["entity_embedding"]
        q = complex_multiplication(table[h_loc], planted["relation_embedding"][rel])
        c = 10 * torch.linalg.vector_norm(table, dim=-1).max()
        table[e2i[t_glob]] = q * (c / torch.linalg.vector_norm(q, dim=-1, keepdim=True))
        evaluation = Evaluation(["mrr", "hits@1", "hits@10"], worst_rank_infty=True,
                                reduction="sum")
        scored = TopKQueryBessKGE(K, ns, score_fn, evaluation=evaluation)
        metrics = scored.forward(planted, rel, head=h_loc, tail=t_glob)["metrics"].reshape(-1)
        mrr = float(metrics[0]) / YAGO_QUERIES
        if mrr != 1.0:
            raise AssertionError(f"{what}: MRR {mrr} of planted answers, expected 1")
    say("yago", f"{what}: window {topk.window_size} (chunk merge): {best * 1e3:.3f} ms per"
        f" {YAGO_QUERIES}-query batch (best of {YAGO_REPEATS} x {YAGO_BATCHES}), peak"
        f" {peak if peak is None else f'{peak / 2**20:.1f} MiB'} above the tables; top-{K} of"
        f" {N_REFERENCE} queries match a full-fp32 full-table product ({sure} with a clear"
        f" 10th/11th gap), the chunk merge equals the sort merge, 64 queries equal the CPU's,"
        f" planted answers MRR {mrr}")
    return {"ms_per_batch": best * 1e3, "peak_bytes": peak, "window": topk.window_size}


def _yago_module(triples: np.ndarray, sharding: Sharding, score_fn) -> tuple:
    dataset = KGDataset(n_entity=YAGO_ENTITY, n_relation_type=YAGO_RELATION,
                        triples={"train": triples},
                        original_triple_ids={"train": np.arange(len(triples))})
    pts = PartitionedTripleSet.create_from_dataset(dataset, "train", sharding)
    ns = RandomShardedNegativeSampler(YAGO_NEGATIVE, sharding, SEED, "ht", local_sampling=False,
                                      flat_negative_format=True)
    return EmbeddingMovingBessKGE(ns, score_fn, LogSigmoidLoss(12.0, True)), pts


def yago(gen: torch.Generator, profile: bool = False, device: str = "cuda") -> dict:
    """ComplEx at YAGO3-10 width: served as bench.py's topk_yago serves it,
    trained as the YAGO example trains it (host-fed and device-sampled, B10
    on the table), then the trained table served again (``device`` "cpu"
    rehearses the phase without the card's gates)."""
    on_card = device == "cuda"
    t = time.perf_counter()
    sharding = Sharding.create(YAGO_ENTITY, 1, seed=SEED)
    score_fn = ComplEx(True, sharding, YAGO_RELATION, YAGO_EMB, seed=SEED)
    params = score_fn.initial_params_device(device=device)  # bench.py's call
    say("yago", f"{YAGO_ENTITY} x {2 * YAGO_EMB} fp32 ComplEx table drawn on the device"
        f" ({time.perf_counter() - t:.1f}s)")
    result = {"serving": _yago_serving("initial table", params, sharding, score_fn, device)}
    del params

    rng = np.random.default_rng(SEED)
    triples = np.stack([rng.integers(YAGO_ENTITY, size=YAGO_TRIPLE),
                        rng.integers(YAGO_RELATION, size=YAGO_TRIPLE),
                        rng.integers(YAGO_ENTITY, size=YAGO_TRIPLE)], 1).astype(np.int32)
    module, pts = _yago_module(triples, sharding, score_fn)
    ns = module.negative_sampler
    adamw, fused = optim.AdamW(YAGO_LR), optim.FusedDenseAdamW(YAGO_LR, weight_decay=1e-4)
    params = score_fn.initial_params_device(device=device, generator=gen)
    state = trainer.init_optimizer_state(adamw, params, None, fused)
    host = RigidShardedBatchSampler(pts, ns, shard_bs=YAGO_SHARD_BS, batches_per_step=YAGO_BPS,
                                    seed=SEED)
    batch = host.sample_batch(next(iter(host.epoch_index_blocks(shuffle=True))))
    cpu_params, cpu_state = _to(params, "cpu"), _to(state, "cpu")
    reset_counts()
    params, state, out = trainer.build_train_step(module, adamw, None, fused, device=device)(
        params, state, batch)
    sync(device)
    counts = read_counts()
    if on_card:
        expect_counts("yago training step", counts, {"dense_adamw_update": 1})
    t = time.perf_counter()
    cpu_params, cpu_state, cpu_out = trainer.build_train_step(
        module, adamw, None, fused, device="cpu")(cpu_params, cpu_state, batch)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > DENSE_RTOL * abs(cpu_loss):
        raise AssertionError(f"yago step loss {loss} on the card, {cpu_loss} on the CPU")
    errs = _hold_dense("yago step vs the CPU", (params, state), (cpu_params, cpu_state), 1,
                       YAGO_LR)
    say("yago", f"{len(triples)} triples, {YAGO_BPS} x {YAGO_SHARD_BS} positives per step; one"
        f" host-fed step (FusedDenseAdamW, B10) on the card vs the CPU ({cpu_s:.1f}s): loss"
        f" {loss:.6f} vs {cpu_loss:.6f}, max|err| {', '.join(f'{k} {v:.3g}' for k, v in errs.items())};"
        f" launches {_launched()}")
    result["host_step_vs_cpu"] = errs
    result["host_step_launches"] = counts["dense_adamw_update"]
    del cpu_params, cpu_state

    dev = DeviceBatchSampler(pts, ns, shard_bs=YAGO_SHARD_BS, batches_per_step=YAGO_BPS,
                             seed=SEED, positive_mode="runs")
    form = dict(module=module, opt=adamw, ent=fused, spc=YAGO_SPC, params=params, state=state,
                sampler=dev, pts=pts, want={"dense_adamw_update": 1},
                kernels={"dense_adamw_kernel": 1}, phase="yago", all_bits=True)
    form["fn"] = trainer.build_device_train_step(module, adamw, dev, None, fused,
                                                 steps_per_call=YAGO_SPC, device=device)
    form["sampler_state"] = dev.state(device)
    fn, st = form["fn"], form["sampler_state"]
    if on_card:
        result["device"] = _graph_equals_eager("yago", form)
    else:
        reset_counts()
        fn(params, state, st, dev.next_key(0))
        result["device"] = {"first_call_wrapper_launches": _launched()}

    # Trainer.fit over three device-sampled calls.
    fit_triples = triples[: 3 * YAGO_SPC * dev.partition_sample_size]
    fit_module, fit_pts = _yago_module(fit_triples, sharding, score_fn)
    fit_dev = DeviceBatchSampler(fit_pts, fit_module.negative_sampler, shard_bs=YAGO_SHARD_BS,
                                 batches_per_step=YAGO_BPS, seed=SEED, positive_mode="runs")
    fit = trainer.Trainer(fit_module, fit_dev, adamw,
                          params={k: v.clone() for k, v in params.items()},
                          entity_optimizer=fused, steps_per_call=YAGO_SPC, device=device)
    summary = fit.fit(n_epochs=1, log_every=1)
    losses = [r["loss"] for r in fit.history]
    if summary["steps"] != 3 or not np.isfinite(losses).all():
        raise AssertionError(f"yago Trainer.fit: {summary}")
    say("yago", f"Trainer.fit: {summary['steps']} calls of {YAGO_SPC} steps, loss {losses[0]:.3f}"
        f" -> {losses[-1]:.3f}, {summary['triples_per_s']:.0f} positive triples/s, capture"
        " included")
    del fit

    timed = []
    for i in range(2):
        fn(params, state, st, dev.next_key(100 + 10 * i))  # warm-up
        sync(device)
        t = time.perf_counter()
        for j in range(YAGO_TIMED_CALLS):
            _, _, out = fn(params, state, st, dev.next_key(101 + 10 * i + j))
        sync(device)
        timed.append((time.perf_counter() - t) / (YAGO_TIMED_CALLS * YAGO_SPC) * 1e3)
    table_bytes = params["entity_embedding"].numel() * params["entity_embedding"].element_size()
    positives = dev.partition_sample_size
    say("yago", f"device-sampled ({YAGO_SPC} steps per call): {timed[0]:.4f} / {timed[1]:.4f} ms"
        f" per step over {YAGO_TIMED_CALLS} calls each, {positives / timed[0] * 1e3:.0f} positive"
        f" triples/s; table {table_bytes} B; final loss {float(out['loss']):.3f}")
    result.update(ms_per_step=timed, table_bytes=table_bytes)
    if profile and on_card:
        result["profile"] = profile_run(
            lambda: [fn(params, state, st, dev.next_key(200 + i)) for i in range(2)],
            2 * YAGO_SPC, "yago_trace.json")
    result["trained_serving"] = _yago_serving("trained table", params, sharding, score_fn, device)
    return result


def _scorer_fn(name: str, sharding: Sharding):
    """A scorer of the wikikg2 step in TransE's place: p = 1 for a distance
    scorer, its own defaults otherwise, bf16 scoring math."""
    cls = getattr(scoring, name)
    if issubclass(cls, scoring.MatrixDecompositionScoreFunction):
        score_fn = cls(True, sharding, N_RELATION, DIM, seed=SEED)
    else:
        score_fn = cls(True, 1, sharding, N_RELATION, DIM, seed=SEED)
    score_fn.compute_dtype = torch.bfloat16
    return score_fn


def _scorer_reference(score_fn, params: dict, sharding: Sharding, rel: torch.Tensor,
                      head: torch.Tensor) -> torch.Tensor:
    """Tail scores of (head, rel) queries against every local row of the
    pair-major table, through ``score_triple`` over chunks of rows (the
    plain per-triple form, not the broadcast one the top-k runs); padding
    rows at -inf."""
    table = params["entity_embedding"][0::2]
    rows = table.shape[0]
    cd = score_fn.compute_dtype
    ref = torch.empty(len(rel), rows, dtype=torch.float32, device=table.device)
    chunk = 1 << 19
    with torch.inference_mode():
        for i in range(len(rel)):
            h = table[head[i].long()].to(cd)
            for start in range(0, rows, chunk):
                tails = table[start:start + chunk].to(cd)
                n = tails.shape[0]
                ref[i, start:start + n] = score_fn.score_triple(
                    params, h.expand(n, -1), rel[i].expand(n), tails).float()
    ref[:, int(sharding.shard_counts[0]):] = -float("inf")
    return ref


def _scorer_run(name: str, triples: np.ndarray, sharding: Sharding, gen: torch.Generator,
                profile: bool, device: str) -> dict:
    on_card = device == "cuda"
    t = time.perf_counter()
    score_fn = _scorer_fn(name, sharding)
    module, sampler, pts = _training_setup(triples, sharding, score_fn)
    params = score_fn.initial_params_device(device=device, generator=gen)
    params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
    sgd = optim.SGD(LR, momentum=MOMENTUM)
    row = optim.RowSGDM(LR, momentum=MOMENTUM, interleaved=True)
    state = trainer.init_optimizer_state(sgd, params, None, row,
                                         n_logical=sharding.max_entity_per_shard)
    batch = sampler.sample_batch(next(iter(sampler.epoch_index_blocks())))
    cpu_params, cpu_state = _to(params, "cpu"), _to(state, "cpu")
    if name in FP32_HELD:
        initial = {"card": (trainer._clone(params), trainer._clone(state)),
                   "cpu": (_to(params, "cpu"), _to(state, "cpu"))}
    setup_s = time.perf_counter() - t
    result = {"entity_row": score_fn.entity_row_size, "relation_row": score_fn.relation_row_size}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    reset_counts()
    params, state, out = trainer.build_train_step(module, sgd, None, row, device=device)(
        params, state, batch)
    sync(device)
    counts = read_counts()
    if on_card:
        expect_counts(f"{name} training step", counts, {"scatter_rows": 1})
        result["host_step_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    result["host_step_launches"] = counts["scatter_rows"]
    t = time.perf_counter()
    cpu_params, cpu_state, cpu_out = trainer.build_train_step(module, sgd, None, row,
                                                              device="cpu")(
        cpu_params, cpu_state, batch)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > 2.0**-8 * abs(cpu_loss):
        raise AssertionError(f"{name} training loss {loss} on the card, {cpu_loss} on the CPU")
    touched = torch.unique(torch.cat([torch.from_numpy(batch[k].reshape(-1).astype(np.int64))
                                      for k in ("head", "tail", "negative")]))
    held = "bf16"
    if name in FP32_HELD:
        result["bf16_step_gate_ratio"] = _gate_ratios(
            (params, state), (cpu_params, cpu_state), touched, LR)
        score_fn.compute_dtype = None
        card32 = trainer.build_train_step(module, sgd, None, row, device=device)(
            *initial["card"], batch)
        cpu32 = trainer.build_train_step(module, sgd, None, row, device="cpu")(
            *initial["cpu"], batch)
        score_fn.compute_dtype = torch.bfloat16
        errs = _hold_sparse(f"{name} fp32-scored step vs the CPU", card32[:2], cpu32[:2],
                            touched, LR)
        held = (f"fp32 scoring (bf16 step: max|err| / gate"
                f" {', '.join(f'{k} {v:.3g}' for k, v in result['bf16_step_gate_ratio'].items())})")
        del initial, card32, cpu32
    else:
        errs = _hold_sparse(f"{name} step vs the CPU", (params, state), (cpu_params, cpu_state),
                            touched, LR)
    del cpu_params, cpu_state
    say("scorers", f"{name} (rows {score_fn.entity_row_size} / {score_fn.relation_row_size}):"
        f" one host-fed step on the card vs the CPU ({cpu_s:.1f}s; set-up"
        f" {setup_s:.1f}s): loss {loss:.6f} vs {cpu_loss:.6f}, held with {held}: max|err|"
        f" {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} over {len(touched)} touched rows;"
        f" launches {counts['scatter_rows']} B3; peak"
        f" {result.get('host_step_peak_bytes', 0) / 2**30:.2f} GiB above the tables")
    result["host_step_vs_cpu"] = errs

    dev = DeviceBatchSampler(pts, module.negative_sampler, shard_bs=SHARD_BS_TRAIN,
                             batches_per_step=BPS, seed=SEED, positive_mode="runs")
    form = dict(module=module, opt=sgd, ent=row, spc=WIKIKG2_SPC, params=params, state=state,
                sampler=dev, pts=pts, want={"scatter_rows": 1},
                kernels={"scatter_rows_kernel": 1}, phase="scorers", all_bits=True)
    form["fn"] = trainer.build_device_train_step(module, sgd, dev, None, row,
                                                 steps_per_call=WIKIKG2_SPC, device=device)
    form["sampler_state"] = st = dev.state(device)
    fn = form["fn"]
    if on_card:
        graph = _graph_equals_eager(name, form)
        result.update(first_call_wrapper_launches=graph["first_call_wrapper_launches"],
                      launches_per_call=graph["launches_per_call"],
                      capture_s=graph["capture_s"], pool_bytes=graph["pool_bytes"],
                      peak_bytes=graph["peak_bytes"])
    else:
        fn(params, state, st, dev.next_key(0))
    timed = []
    for i in range(2):
        fn(params, state, st, dev.next_key(100 + 10 * i))  # warm-up
        sync(device)
        t = time.perf_counter()
        for j in range(SCORER_TIMED_CALLS):
            _, _, out = fn(params, state, st, dev.next_key(101 + 10 * i + j))
        sync(device)
        timed.append((time.perf_counter() - t) / (SCORER_TIMED_CALLS * WIKIKG2_SPC) * 1e3)
    if not np.isfinite(float(out["loss"])):
        raise AssertionError(f"{name}: loss {float(out['loss'])} after the timed calls")
    result["ms_per_step"] = timed
    if profile and on_card:
        result["profile"] = profile_run(lambda: fn(params, state, st, dev.next_key(200)),
                                        WIKIKG2_SPC, f"scorers_{name}_trace.json")

    # Top-10 of 64 queries against every entity, served from the trained
    # pair-major table.
    rng = np.random.default_rng(SEED)
    rel = torch.from_numpy(rng.integers(N_RELATION, size=SCORER_QUERIES)).to(device)
    head = torch.from_numpy(rng.integers(sharding.max_entity_per_shard,
                                         size=SCORER_QUERIES)).to(device)
    topk = TopKQueryBessKGE(K, PlaceholderNegativeSampler("t"), score_fn, return_scores=True)
    with torch.inference_mode():
        got = topk.forward(params, rel, head=head)  # warm-up
        sync(device)
        t = time.perf_counter()
        got = topk.forward(params, rel, head=head)
        sync(device)
        topk_ms = (time.perf_counter() - t) * 1e3
    ref = _scorer_reference(score_fn, params, sharding, rel, head)
    sure = _hold_topk(f"{name} top-{K}", got, ref, sharding, BF16_STEP_RTOL)
    del ref
    result.update(topk_ms=topk_ms, window=topk.window_size)
    say("scorers", f"{name}: device-sampled ({WIKIKG2_SPC} steps per call) {timed[0]:.4f} /"
        f" {timed[1]:.4f} ms per step over {SCORER_TIMED_CALLS} calls each; capture peak"
        f" {result.get('peak_bytes', 0) / 2**30:.2f} GiB, graph pool"
        f" {result.get('pool_bytes', 0) / 2**30:.2f} GiB; top-{K} of {SCORER_QUERIES} queries"
        f" against {sharding.n_entity} entities {topk_ms:.1f} ms (window {topk.window_size}),"
        f" equal to a score_triple full-table reference ({sure} with a clear 10th/11th gap)")
    return result


def scorers(gen: torch.Generator, profile: bool = False, device: str = "cuda") -> dict:
    """DistMult, PairRE, TripleRE, BoxE, InterHT and TranS on the wikikg2
    step at full width, one after another (``device`` "cpu" rehearses the
    phase without the card's gates)."""
    triples, sharding, _, _ = _wikikg2()
    results = {}
    for name in SCORERS:
        results[name] = _scorer_run(name, triples, sharding, gen, profile, device)
        if device == "cuda":
            torch.cuda.empty_cache()
    return results


def _plant(params: dict, sharding: Sharding, triples: np.ndarray) -> None:
    """Each triple's tail row set to its head row plus its relation row: the
    true tail then scores -|h + r - t| = 0 in fp32 (a bf16 rounding of its
    terms in bf16), far above any other entity's -O(10). Heads and tails must
    be distinct entities."""
    table, rel = params["entity_embedding"], params["relation_embedding"]
    e2i = torch.as_tensor(sharding.entity_to_idx, device=table.device)
    ids = torch.from_numpy(triples.astype(np.int64)).to(table.device)
    table[e2i[ids[:, 2]]] = table[e2i[ids[:, 0]]] + rel[ids[:, 1]]


def _distinct_queries(rng, n_entity: int, n_query: int) -> np.ndarray:
    """(h, r, t) triples with every head and tail a different entity."""
    ents = rng.choice(n_entity, size=2 * n_query, replace=False)
    rels = rng.integers(N_RELATION, size=n_query)
    return np.stack([ents[:n_query], rels, ents[n_query:]], 1).astype(np.int32)


def _eval_fn(sharding: Sharding, sharing: bool, bf16: bool = True) -> TransE:
    score_fn = TransE(sharing, 1, sharding, N_RELATION, DIM, seed=SEED)
    if bf16:
        score_fn.compute_dtype = torch.bfloat16
    return score_fn


def _hold_candidate_topk(what: str, out: dict, params: dict, score_fn: TransE,
                         sharding: Sharding, triples: np.ndarray, cands: np.ndarray,
                         batch: dict) -> int:
    """A top-K output of candidate sets against a plain ranking of each
    query's own candidates, scored apart from the windows, masks and merge of
    the top-k path by the same formula: one set per query through
    ``score_tails`` (PyTorch's elementwise ops: the same arithmetic, so the
    dense gate); a set shared by all queries through the plain version of B5
    (fp32 sums in another order, rounded to the compute dtype: the dense gate
    plus a bf16 ulp of the score). The returned scores within that of the K
    best, each returned ID a candidate of its query, the IDs equal to the K
    best as sets where the K-th and (K+1)-th stand further apart than twice
    it. Returns the number of such queries."""
    device = params["entity_embedding"].device
    keep = torch.from_numpy(batch["triple_mask"].reshape(-1)).to(device)
    q = batch["triple_idx"].reshape(-1)[batch["triple_mask"].reshape(-1)]
    e2i = torch.as_tensor(sharding.entity_to_idx, device=device)
    h, r = (torch.from_numpy(triples[q, i].astype(np.int64)).to(device) for i in (0, 1))
    shared = cands.shape[0] == 1
    own = torch.from_numpy(cands[np.zeros_like(q) if shared else q].astype(np.int64)).to(device)
    cd = score_fn.compute_dtype or torch.float32
    table = params["entity_embedding"]
    known = table[e2i[h]].to(cd)
    if shared:
        query = score_fn.distance_query_vector(params, known, r, "t").to(cd)
        ref = -l1_kernels.l1_distance_matrix_plain(query, table[e2i[own[0]]].to(cd)).float()
        ulp = 2.0**-8 if cd == torch.bfloat16 else 0.0
    else:
        ref = score_fn.score_tails(params, known, r, table[e2i[own]].to(cd)).float()
        ulp = 0.0
    want = torch.topk(ref, K + 1, dim=1)
    scores = out["topk_scores"].reshape(-1, K)[keep].float()
    ids = out["topk_global_id"].reshape(-1, K)[keep].long()
    top = want.values[:, :K]
    tol = DENSE_RTOL * (top.abs() + top.abs().max()) + ulp * top.abs()
    if not ((scores - top).abs() <= tol).all():
        raise AssertionError(f"{what}: top-{K} scores off the plain ranking by"
                             f" {(scores - top).abs().max().item()}")
    if not (ids[:, :, None] == own[:, None, :]).any(-1).all():
        raise AssertionError(f"{what}: a returned ID is not a candidate of its query")
    sure = (want.values[:, K - 1] - want.values[:, K]) > 2 * tol.max()
    ref_ids = torch.gather(own, 1, want.indices[:, :K])
    same = (ids.sort(1).values == ref_ids.sort(1).values).all(1)
    if not same[sure].all():
        raise AssertionError(f"{what}: top-{K} IDs differ from the plain ranking")
    return int(sure.sum())


def _valid_setup(n_shard: int, axis_name: str = "shard") -> tuple:
    """bench.py's valid over ``n_shard`` shards: (triples, candidates,
    sharding, ScoreMoving module with sum metrics, sampler, dataset, and the
    generator that drew the triples and candidates)."""
    sharding = Sharding.create(N_ENTITY, n_shard, seed=SEED)
    rng = np.random.default_rng(SEED)
    triples = _distinct_queries(rng, N_ENTITY, VALID_QUERIES)
    # Candidates never hold the triple's own tail, which would tie its score.
    shift = 1 + rng.integers(N_ENTITY - 1, size=(VALID_QUERIES, VALID_CANDIDATES))
    cands = ((triples[:, 2:3] + shift) % N_ENTITY).astype(np.int32)
    dataset = KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"valid": triples},
                        original_triple_ids={"valid": np.arange(VALID_QUERIES)},
                        neg_tails={"valid": cands})
    pts = PartitionedTripleSet.create_from_dataset(dataset, "valid", sharding,
                                                   partition_mode="ht_shardpair")
    ns = TripleBasedShardedNegativeSampler(None, pts.neg_tails, sharding, "t", seed=SEED)
    sampler = RigidShardedBatchSampler(pts, ns, shard_bs=VALID_SHARD_BS,
                                       batches_per_step=VALID_BPS, seed=SEED,
                                       duplicate_batch=False)
    module = ScoreMovingBessKGE(ns, _eval_fn(sharding, sharing=False), axis_name=axis_name,
                                evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"))
    return triples, cands, sharding, module, sampler, dataset, rng


def _as_setup(n_shard: int, bps: int) -> tuple:
    """bench.py's allscores over ``n_shard`` shards: (triples, sharding,
    score function, pts, sampler of ``bps`` x AS_SHARD_BS, and the generator
    that drew the triples)."""
    sharding = Sharding.create(AS_ENTITY, n_shard, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    triples = _distinct_queries(rng, AS_ENTITY, AS_QUERIES)
    dataset = KGDataset(n_entity=AS_ENTITY, n_relation_type=N_RELATION,
                        triples={"test": np.zeros((1, 3), np.int32)},
                        original_triple_ids={"test": np.arange(1)})
    pts = PartitionedTripleSet.create_from_queries(dataset, sharding, triples[:, :2], "hr",
                                                   ground_truth=triples[:, 2])
    sampler = RigidShardedBatchSampler(pts, PlaceholderNegativeSampler("t", seed=SEED),
                                       shard_bs=AS_SHARD_BS, batches_per_step=bps, seed=SEED,
                                       return_triple_idx=True)
    return triples, sharding, _eval_fn(sharding, sharing=True), pts, sampler, rng


def _valid(gen: torch.Generator, profile: bool, device: str, smi: str) -> dict:
    """bench.py's run_valid: ScoreMoving candidate-set validation of random
    triples, 500 tail candidates each, through run_device_eval; and
    candidate-set top-k over the same candidates."""
    on_card = device == "cuda"
    t = time.perf_counter()
    triples, cands, sharding, module, sampler, dataset, rng = _valid_setup(1, None)
    ns, score_fn = module.negative_sampler, module.score_fn
    params = score_fn.initial_params_device(device=device, generator=gen)
    steps = [{k: v for k, v in b.items() if k in _FORWARD_KEYS}
             for b in sampler.get_dataloader(shuffle=False)]
    say("eval", f"valid: {VALID_QUERIES} triples x {VALID_CANDIDATES} tail candidates over"
        f" {N_ENTITY} x {DIM} entities, {len(steps)} steps of {VALID_BPS} x {VALID_SHARD_BS}"
        f" ({time.perf_counter() - t:.1f}s set-up)")

    # Card against CPU with fp32 scoring, before the answers are planted.
    check = ScoreMovingBessKGE(ns, _eval_fn(sharding, sharing=False, bf16=False),
                               evaluation=Evaluation(["mrr"], return_ranks=True),
                               return_scores=True)
    cpu_params = _to(params, "cpu")
    card_fwd, cpu_fwd = build_bess_forward(check, device=device), build_bess_forward(check, device="cpu")
    n_clear = n_rows = 0
    err = 0.0
    for step in steps[:VALID_CPU_STEPS]:
        got = {k: v.cpu() for k, v in card_fwd(params, step).items()}
        want = cpu_fwd(cpu_params, step)
        pos, neg = want["positive_score"].reshape(-1), want["negative_score"].reshape(-1, VALID_CANDIDATES)
        scale = max(pos.abs().max().item(), neg.abs().max().item())
        for key in ("positive_score", "negative_score"):
            diff = (got[key] - want[key]).abs()
            if not (diff <= DENSE_RTOL * (want[key].abs() + scale)).all():
                raise AssertionError(f"valid card vs CPU: {key} off by {diff.max().item()}")
            err = max(err, diff.max().item())
        clear = ((neg - pos[:, None]).abs() > 2 * DENSE_RTOL * scale).all(1)
        if not torch.equal(got["ranks"].reshape(-1)[clear], want["ranks"].reshape(-1)[clear]):
            raise AssertionError("valid card vs CPU: ranks differ")
        n_clear, n_rows = n_clear + int(clear.sum()), n_rows + clear.numel()
    del cpu_params
    say("eval", f"valid card vs CPU ({VALID_CPU_STEPS} steps, fp32 scoring): scores max|err|"
        f" {err:.3g}, ranks equal for the {n_clear} of {n_rows} queries clear of ties")

    _plant(params, sharding, triples)
    # Device-resident blocks: staged beforehand, each run with no host sync.
    blocks = [_stack_block(steps[i:i + VALID_SPB], VALID_SPB, torch.device(device))
              for i in range(0, len(steps), VALID_SPB)]
    run_block = make_block_runner(module, device=device)
    run_block(params, blocks[0])  # warm-up
    sync(device)
    # The whole pass through run_device_eval, once: sampling, copies, blocks.
    reset_counts()
    t = time.perf_counter()
    metrics, n_q = run_device_eval(module, params, sampler, steps_per_block=VALID_SPB,
                                   device=device)
    host_s = time.perf_counter() - t
    if on_card:
        expect_counts("valid (run_device_eval)", read_counts(), {})
    if n_q != VALID_QUERIES or metrics["mrr"] != 1.0 or metrics["hits@10"] != 1.0:
        raise AssertionError(f"valid: planted answers give {metrics} over {n_q} queries")
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        sums = sum(run_block(params, blk) for blk in blocks)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    if float(sums[0]) != VALID_QUERIES:
        raise AssertionError(f"valid device blocks: MRR sum {float(sums[0])}")
    times = []
    for _ in range(VALID_REPEATS):
        t = time.perf_counter()
        for blk in blocks:
            tot = run_block(params, blk)
        float(tot[0])  # fetch = sync
        times.append(time.perf_counter() - t)
    med = float(np.median(times))
    result = {
        "queries_per_s": n_q / med, "spread_queries_per_s": [n_q / max(times), n_q / min(times)],
        "host_pipeline_queries_per_s": n_q / host_s, "ms_per_step": med / len(steps) * 1e3,
        "n_queries": n_q, "steps": len(steps), "steps_per_block": VALID_SPB,
        "card_vs_cpu_max_abs_err": err, "metrics": metrics,
    }
    say("eval", f"valid ({smi}): {result['queries_per_s']:.1f} queries/s device-resident"
        f" (median of {VALID_REPEATS}, {result['ms_per_step']:.4f} ms per step of"
        f" {VALID_BPS * VALID_SHARD_BS} queries), {result['host_pipeline_queries_per_s']:.1f}"
        f" queries/s through run_device_eval; planted MRR {metrics['mrr']}, no host sync in a"
        f" block, no kernel of ours launched")
    if profile and on_card:
        result["profile"] = profile_run(lambda: [run_block(params, blk) for blk in blocks],
                                        len(steps), "eval_valid_trace.json")

    # Candidate-set top-k over the same candidates: one set per query
    # (no sharing), and one shared set (sharing: B5).
    n_top = VALID_TOPK_QUERIES
    q_pts = PartitionedTripleSet.create_from_queries(
        dataset, sharding, triples[:n_top, :2], "hr", ground_truth=triples[:n_top, 2],
        negative=cands[:n_top])
    flat = rng.choice(N_ENTITY, size=(1, FLAT_CANDIDATES), replace=False).astype(np.int32)
    f_pts = PartitionedTripleSet.create_from_queries(
        dataset, sharding, triples[:n_top, :2], "hr", ground_truth=triples[:n_top, 2],
        negative=flat)
    result["topk"] = {}
    for name, p, sharing, own in (("per_query", q_pts, False, cands), ("shared", f_pts, True, flat)):
        c_ns = TripleBasedShardedNegativeSampler(None, p.neg_tails, sharding, "t", seed=SEED,
                                                 mask_on_gather=True)
        c_sampler = RigidShardedBatchSampler(p, c_ns, shard_bs=VALID_SHARD_BS,
                                             batches_per_step=TOPK_BPS, seed=SEED,
                                             return_triple_idx=True)
        batches = [c_sampler.sample_batch(b) for b in c_sampler.epoch_index_blocks(False)]
        own_sorted = own if sharing else own[p.triple_sort_idx]
        entry = {"queries_per_batch": TOPK_BPS * VALID_SHARD_BS, "sure": {}}
        # fp32 scoring for the gate's sake (clear gaps between the 10th and
        # 11th scores), then bf16 scoring as configured, gated and timed.
        for bf16 in (False, True):
            score_fn = _eval_fn(sharding, sharing, bf16)
            topk = TopKQueryBessKGE(K, c_ns, score_fn, return_scores=True)
            fwd = build_topk_forward(topk, device=device)
            fwd(params, batches[0])  # warm-up
            sync(device)
            reset_counts()
            t = time.perf_counter()
            outs = [fwd(params, b) for b in batches]
            sync(device)
            ms = (time.perf_counter() - t) / len(batches) * 1e3
            counts = read_counts()
            if on_card:
                expect_counts(f"candidate top-k {name}", counts,
                              {"l1_distance_matrix": TOPK_BPS * len(batches)} if sharing else {})
            entry["sure"]["bf16" if bf16 else "fp32"] = sum(
                _hold_candidate_topk(f"candidate top-k {name}", o, params, score_fn, sharding,
                                     triples[p.triple_sort_idx], own_sorted, b)
                for o, b in zip(outs, batches))
        entry.update(ms_per_batch=ms, wrapper_launches=counts["l1_distance_matrix"],
                     window=min(topk.window_size, -(-own.shape[1] // 128) * 128))
        if sharing and on_card:
            kernels = device_kernels(lambda: fwd(params, batches[0]), 3)
            entry["b5_per_batch_by_name"] = sum(
                n for key, (_, n) in kernels.items() if "l1_distance_small_kernel" in key)
            if entry["b5_per_batch_by_name"] != TOPK_BPS:
                raise AssertionError(f"candidate top-k shared: {kernels}")
        result["topk"][name] = entry
        say("eval", f"candidate top-{K} {name} ({own.shape[1]} candidates, {smi}): {ms:.3f} ms per"
            f" {TOPK_BPS * VALID_SHARD_BS}-query batch (bf16), window {entry['window']}, B5"
            f" {entry['wrapper_launches']} launches over {len(batches)} batches"
            f"{', ' + str(entry.get('b5_per_batch_by_name')) + ' per batch by name' if sharing else ''};"
            f" top-{K} of {n_top} queries equal a plain ranking of their candidates"
            f" ({entry['sure']['fp32']} fp32, {entry['sure']['bf16']} bf16 with a clear 10th/11th"
            f" gap)")
    return result


def _allscores(gen: torch.Generator, profile: bool, device: str, smi: str) -> dict:
    """bench.py's run_allscores: AllScoresPipeline of (h, r, ?) queries
    against every entity, window by window, with a filtered pass."""
    on_card = device == "cuda"
    t = time.perf_counter()
    triples, sharding, score_fn, pts, sampler, rng = _as_setup(1, AS_BPS)
    params = score_fn.initial_params_device(device=device, generator=gen)
    n_batches = len(list(sampler.epoch_index_blocks(False)))
    # Filtered pass on the random table: every query has AS_KNOWN other known tails.
    known = np.repeat(triples, AS_KNOWN, axis=0)
    known[:, 2] = rng.integers(AS_ENTITY, size=len(known))
    filtered = AllScoresPipeline(sampler, "t", score_fn,
                                 evaluation=Evaluation(["mrr", "hits@10"], return_ranks=True),
                                 filter_triples=[known], return_scores=True,
                                 window_size=AS_WINDOW, device=device)
    n_step = filtered.bess_module.n_step
    say("eval", f"allscores: {AS_QUERIES} queries x {AS_ENTITY} entities, {n_batches} batches of"
        f" {AS_BPS} x {AS_SHARD_BS}, {n_step} windows of {AS_WINDOW}"
        f" ({time.perf_counter() - t:.1f}s set-up)")
    t = time.perf_counter()
    out = filtered.forward(params)
    filtered_s = time.perf_counter() - t
    scores = out["scores"]
    tri = filtered.triples[out["triple_idx"]]
    rows = np.arange(len(tri))
    pairs = get_entity_filter(tri, known, "t")
    expect = np.zeros(scores.shape, bool)
    expect[pairs[:, 0], pairs[:, 1]] = True
    expect[rows, tri[:, 2]] = False  # the true score is restored
    if not np.array_equal(np.isneginf(scores), expect):
        raise AssertionError("allscores filtered: -inf entries differ from get_entity_filter's")
    ranked = scores.copy()
    true = ranked[rows, tri[:, 2]].copy()
    ranked[rows, tri[:, 2]] = -np.inf
    n_opt = (ranked > true[:, None]).sum(1)
    n_pess = (ranked >= true[:, None]).sum(1)
    numpy_ranks = (1.0 + 0.5 * (n_opt + n_pess)).astype(np.float32)
    if not np.array_equal(out["ranks"], numpy_ranks):
        raise AssertionError("allscores filtered: ranks differ from a numpy ranking")
    del ranked, scores, out
    say("eval", f"allscores filtered pass ({filtered_s:.2f}s): {len(pairs)} filter pairs, -inf"
        f" exactly there, ranks equal a numpy ranking of the returned matrix")

    # Planted answers: scores against one full-table plain matrix, MRR 1.
    _plant(params, sharding, triples)
    pipe = AllScoresPipeline(sampler, "t", score_fn,
                             evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"),
                             return_scores=True, window_size=AS_WINDOW, device=device)
    reset_counts()
    t = time.perf_counter()
    out = pipe.forward(params)
    sync(device)
    scores_s = time.perf_counter() - t
    counts = read_counts()
    if on_card:
        expect_counts("allscores pipeline", counts,
                      {"l1_distance_matrix": n_step * AS_BPS * n_batches})
    if out["metrics_avg"]["mrr"] != 1.0:
        raise AssertionError(f"allscores: planted answers give {out['metrics_avg']}")
    table, rel = params["entity_embedding"], params["relation_embedding"]
    e2i = torch.as_tensor(sharding.entity_to_idx, device=table.device)
    tri = triples[pts.triple_sort_idx[out["triple_idx"]]]
    pool = table[e2i].to(torch.bfloat16)  # global order
    err = 0.0
    for i in range(0, len(tri), AS_SHARD_BS):
        h, r = (torch.from_numpy(tri[i:i + AS_SHARD_BS, j].astype(np.int64)).to(table.device)
                for j in (0, 1))
        query = table[e2i[h]].to(torch.bfloat16) + rel[r].to(torch.bfloat16)
        want = -l1_kernels.l1_distance_matrix_plain(query, pool).float()
        got = torch.from_numpy(out["scores"][i:i + AS_SHARD_BS]).to(table.device)
        diff = (got - want).abs()
        if not (diff <= BF16_ULP * (want.abs() + want.abs().max())).all():
            raise AssertionError(f"allscores: scores off the plain full-table matrix by"
                                 f" {diff.max().item()}")
        err = max(err, diff.max().item())
    del pool, out
    # The end-to-end pipeline as bench.py runs it: metrics only.
    bench_pipe = AllScoresPipeline(sampler, "t", score_fn,
                                   evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"),
                                   window_size=AS_WINDOW, device=device)
    t = time.perf_counter()
    e2e = bench_pipe.forward(params)
    e2e_s = time.perf_counter() - t

    # The device sweep: every window of a batch, no host sync between them.
    fwd = pipe._fwd
    dbatches = [_batch_tensors(sampler.sample_batch(b), ("relation", "head", "tail"),
                               torch.device(device)) for b in sampler.epoch_index_blocks(False)]

    def sweep():
        return torch.stack([fwd(params, b, i).sum(dtype=torch.float32)
                            for b in dbatches for i in range(n_step)]).sum()

    float(sweep())  # warm-up
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        tot = sweep()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    float(tot)
    times = []
    for _ in range(AS_REPEATS):
        t = time.perf_counter()
        for _ in range(AS_SWEEPS):
            tot = sweep()
        float(tot)  # fetch = sync
        times.append((time.perf_counter() - t) / AS_SWEEPS)
    med = float(np.median(times))
    result = {
        "candidate_scores_per_s": AS_QUERIES * AS_ENTITY / med,
        "spread_candidate_scores_per_s": [AS_QUERIES * AS_ENTITY / max(times),
                                          AS_QUERIES * AS_ENTITY / min(times)],
        "ms_per_batch": med / n_batches * 1e3, "n_queries": AS_QUERIES, "n_entity": AS_ENTITY,
        "window": AS_WINDOW, "windows": n_step, "batches": n_batches,
        "host_pipeline_candidate_scores_per_s": AS_QUERIES * AS_ENTITY / e2e_s,
        "host_pipeline_s": e2e_s, "scores_pass_s": scores_s, "filtered_pass_s": filtered_s,
        "metrics_mrr": e2e["metrics_avg"]["mrr"], "scores_max_abs_err": err,
        "b5_wrapper_launches_per_pass": counts["l1_distance_matrix"],
    }
    if on_card:
        kernels = device_kernels(sweep, 2)
        result["b5_per_batch_by_name"] = sum(
            n for key, (_, n) in kernels.items() if "l1_distance_small_kernel" in key) / n_batches
        if result["b5_per_batch_by_name"] != n_step * AS_BPS:
            raise AssertionError(f"allscores sweep: {kernels}")
        # B5 alone at the window's shape.
        a = uniform((AS_SHARD_BS, DIM), gen, DIM).to(torch.bfloat16)
        b = uniform((AS_WINDOW, DIM), gen, DIM).to(torch.bfloat16)
        dist = l1_kernels.l1_distance_matrix(a, b)
        ref = l1_kernels.l1_distance_matrix_plain(a, b).float()
        b5_err = (dist.float() - ref).abs()
        if not (b5_err <= ATOL + (RTOL + BF16_ULP) * ref.abs()).all():
            raise AssertionError(f"B5 at the allscores shape off by {b5_err.max().item()}")
        a32, b32 = a.float(), b.float()
        result["b5"] = {
            "shape": [AS_SHARD_BS, AS_WINDOW, DIM, "bf16"], "max_abs_err": b5_err.max().item(),
            "ms": cuda_ms(lambda: l1_kernels.l1_distance_matrix(a, b), 20),
            "plain_ms": cuda_ms(lambda: l1_kernels.l1_distance_matrix_plain(a, b), 3),
            "library_ms": cuda_ms(lambda: torch.cdist(a32, b32, p=1), 3),
            "bound": bound_ms(AS_SHARD_BS, AS_WINDOW, DIM, (AS_SHARD_BS + AS_WINDOW) * DIM * 2,
                              AS_SHARD_BS * AS_WINDOW * 2),
        }
        r5 = result["b5"]
        say("eval", f"B5 at {AS_SHARD_BS} x {AS_WINDOW} x {DIM} bf16 ({smi}): kernel"
            f" {r5['ms']:.4f} ms per launch, plain {r5['plain_ms']:.3f} ms, library (fp32 cdist)"
            f" {r5['library_ms']:.3f} ms, bound {r5['bound'][0]:.4f} ms ({r5['bound'][1]}),"
            f" max|err| {r5['max_abs_err']:.3g}")
    say("eval", f"allscores ({smi}): {result['candidate_scores_per_s']:.4g} candidate-scores/s,"
        f" {result['ms_per_batch']:.3f} ms per {AS_BPS * AS_SHARD_BS}-query batch (device sweep,"
        f" median of {AS_REPEATS} x {AS_SWEEPS}, no host sync between windows); pipeline end to"
        f" end {e2e_s:.2f} s ({result['host_pipeline_candidate_scores_per_s']:.4g}"
        f" candidate-scores/s), with the score matrix returned {scores_s:.2f} s; scores within"
        f" 2^-7 of a plain full-table matrix (max|err| {err:.3g}), planted MRR 1.0, B5"
        f" {counts['l1_distance_matrix']} launches per pass"
        f"{', ' + str(result.get('b5_per_batch_by_name')) + ' per batch by name' if on_card else ''}")
    if profile and on_card:
        result["profile"] = profile_run(sweep, n_batches, "eval_allscores_trace.json")
    return result


def eval_phase(gen: torch.Generator, profile: bool = False, device: str = "cuda",
               smi: str = "") -> dict:
    """Evaluation and inference as bench.py's valid and allscores modes run
    them (``device`` "cpu" rehearses the phase without the card's gates)."""
    result = {"valid": _valid(gen, profile, device, smi)}
    if device == "cuda":
        torch.cuda.empty_cache()
    result["allscores"] = _allscores(gen, profile, device, smi)
    return result


def _conve_fn(sharding: Sharding) -> ConvE:
    """ConvE at the ConvE paper's YAGO3-10 settings (the repo's defaults):
    d = 200 as 10 x 20, 32 channels of 3 x 3, dropout 0.2 / 0.2 / 0.3,
    BatchNorm, inverse relations."""
    return ConvE(True, sharding, YAGO_RELATION, CONVE_EMB, CONVE_H, CONVE_W, seed=SEED)


def _conve_module(triples: np.ndarray, sharding: Sharding, score_fn: ConvE,
                  axis_name: str = None) -> tuple:
    """EmbeddingMovingBessKGE (over the ``axis_name`` mesh axis) with
    YAGO_NEGATIVE shared flat "t" negatives and SSCE over the triples with
    their inverses."""
    dataset = KGDataset(n_entity=sharding.n_entity, n_relation_type=YAGO_RELATION,
                        triples={"train": triples},
                        original_triple_ids={"train": np.arange(len(triples))})
    pts = PartitionedTripleSet.create_from_dataset(dataset, "train", sharding,
                                                   add_inverse_triples=True)
    ns = RandomShardedNegativeSampler(YAGO_NEGATIVE, sharding, SEED, "t", local_sampling=False,
                                      flat_negative_format=True)
    return EmbeddingMovingBessKGE(ns, score_fn, SampledSoftmaxCrossEntropyLoss(
        sharding.n_entity), axis_name=axis_name), pts


def _conve_masks(score_fn: ConvE, rng: torch.Tensor, bps: int, b: int) -> list:
    """The dropout masks of one step with dropout key ``rng``, drawn as the
    step draws them: one key per micro-batch, split three ways (input,
    feature map, hidden), each mask by ``scoring._keep_mask`` in the JAX
    package's layout. [(site, keep probability, mask)]."""
    sites = (("input", 1 - score_fn.p_in, (b, 2 * CONVE_H, CONVE_W, 1)),
             ("feature map", 1 - score_fn.p_fm, (b, 1, 1, score_fn.out_channels)),
             ("hidden", 1 - score_fn.p_hid, (b, CONVE_EMB)))
    out = []
    for mb in split_key(rng, bps):
        for (site, keep, shape), key in zip(sites, split_key(mb, 3)):
            out.append((site, keep, scoring._keep_mask(key, keep, shape)))
    return out


def _conve_within(got: torch.Tensor, want: torch.Tensor, scale=None, extra=0.0) -> tuple:
    """(max |got - want|, the largest ratio of its excess over ``extra`` to
    DENSE_RTOL x (|want| + ``scale``): at most 1 within the gate; inf where
    ``got`` is not finite), ``scale`` max|want| unless given: ConvE's steps
    are fp32 throughout. ``extra`` is a param's share of its moments'
    difference (held apart), which on Adam's first step is all of the
    difference where a gradient is near 0: the ratio reads what is left."""
    got, want = got.float(), want.float()
    over = ((got - want).abs() - extra).clamp_min(0.0)
    base = DENSE_RTOL * (want.abs() + (want.abs().max() if scale is None else scale))
    ratio = torch.where(over > 0, over / base, torch.zeros_like(over)).max().item()
    return (got - want).abs().max().item(), ratio if torch.isfinite(got).all() else float("inf")


def _conve_gate(what: str, errs: dict) -> dict:
    """Raises naming every array of ``errs`` (name -> (max|err|, ratio))
    over its gate; returns ``errs``."""
    over = {k: v for k, v in errs.items() if not v[1] <= 1.0}
    if over:
        raise AssertionError(f"{what}: " + ", ".join(
            f"{k} off by {e:.4g} ({r:.3g} x its gate)" for k, (e, r) in over.items()))
    return errs


def _conve_hold_dense(what: str, got: tuple, want: tuple, count: int,
                      noise: tuple = CONVE_NOISE) -> dict:
    """:func:`_hold_dense`'s gate, with the moments of ``noise`` held
    against the largest moment (mu or nu) of the state. Returns name ->
    (max|err|, ratio to the gate)."""
    arrays = _dense_arrays(got, want, count, CONVE_LR)
    largest = {m: max(w.abs().max().item() for _, part, _, w, _ in arrays if part.endswith(m))
               for m in (" mu", " nu")}
    return _conve_gate(what, {part: _conve_within(g, w, largest[part[-3:]] if (
        name in noise and part != name) else None, extra)
        for name, part, g, w, extra in arrays})


def _conve_hold_sparse(what: str, got: tuple, want: tuple, rows: torch.Tensor,
                       noise: tuple = CONVE_NOISE) -> dict:
    """The sparse step's (params, state) against another's within the dense
    gate (DENSE_RTOL x (|want| + max|want|); the step is fp32 throughout):
    the touched rows of the pair-major table (params and momentum) and the
    relations as :func:`_hold_sparse` takes them, each trunk param plus lr x
    the difference of its momenta, the momenta (those of ``noise`` against
    the largest momentum of the state), and the BN running stats. The step
    sums a row's slots as the difference of two running sums over the
    sorted slots (``optim._dedup_row_grads``, the JAX package's rounding),
    so a table row carries rounding of the running sum's size: its scale
    adds, per column, the sum of |m| over the touched rows. Returns name ->
    (max|err|, ratio to the gate)."""
    arrays = _sparse_arrays(got, want, rows, CONVE_LR)
    run = arrays[0][2].abs().sum(0)  # ("momentum", got, want, extra)
    errs = {name: _conve_within(g, w, w.abs().max() + run if name == "momentum" else None,
                                extra) for name, g, w, extra in arrays}
    g_p, w_p = dict(trainer._leaves(got[0])), dict(trainer._leaves(want[0]))
    g_m = dict(trainer._leaves(got[1]["other"]["trace"]))
    w_m = dict(trainer._leaves(want[1]["other"]["trace"]))
    largest = max(v.abs().max().item() for v in w_m.values())
    for path, w in w_m.items():
        if path == "relation_embedding":
            continue
        g, w = g_m[path].cpu(), w.cpu()
        errs[f"{path} momentum"] = _conve_within(g, w, largest if path in noise else None)
        errs[path] = _conve_within(g_p[path].cpu(), w_p[path].cpu(), None,
                                   CONVE_LR * (g - w).abs())
    for path in g_p:
        if path.endswith((".mean", ".var")):
            errs[path] = _conve_within(g_p[path].cpu(), w_p[path].cpu())
    return _conve_gate(what, errs)


def _conve_gate_report(errs: dict) -> str:
    """max|err| and the three arrays nearest their gates, of a
    :func:`_conve_gate` map."""
    near = sorted(errs, key=lambda k: -errs[k][1])[:3]
    return (f"max|err| {max(e for e, _ in errs.values()):.3g} over {len(errs)} arrays; nearest"
            f" their gates " + ", ".join(f"{k} {errs[k][1]:.3f}" for k in near))


def _conve_check_b3(gen: torch.Generator, slots: int) -> dict:
    """B3 against its plain version at the ConvE sparse step's shape: a
    (2 x YAGO_ENTITY, CONVE_EMB + 1) fp32 pair-major table, whose 804-byte
    rows take the kernel's 4-byte copy unit, written at the step's slot
    count with duplicate runs and NaN in the duplicate slots; equal bits.
    Its time against ``index_copy_`` of the first slots, with its bound."""
    width = CONVE_EMB + 1
    table = torch.rand((2 * YAGO_ENTITY, width), device="cuda", generator=gen)
    table_plain = table.clone()
    phys, first, rows = _pair_slots(gen, YAGO_ENTITY, slots, width)
    unit = row_kernels._copy_unit("scatter_rows", width * 4, (table, rows), (16, 4, 2))
    if unit != 4:
        raise AssertionError(f"B3 copies {unit}-byte units at rows of {width * 4} bytes, not 4")
    row_kernels.scatter_rows(table, phys, rows, 2, True)
    row_kernels.scatter_rows_plain(table_plain, phys, rows, 2, True)
    torch.cuda.synchronize()
    if not torch.equal(table, table_plain):
        diff = (table - table_plain).abs().nan_to_num(float("inf")).max().item()
        raise AssertionError(f"B3 at the ConvE shape off its plain version by {diff}")
    unique = int(first.sum())
    flat_first = (phys[first].long()[:, None] + torch.arange(2, device="cuda")).reshape(-1)
    rows_first = rows.view(slots, 2, width)[first].reshape(-1, width)
    bound = bound_of(0.0, 4 * slots + unique * 2 * (2 * width * 4))
    result = {
        "shape": [2 * YAGO_ENTITY, width], "slots": slots, "unique": unique, "copy_unit": unit,
        "max_abs_err": 0.0,
        "ms": device_ms(lambda: row_kernels.scatter_rows(table, phys, rows, 2, True), 100),
        "plain_ms": device_ms(lambda: row_kernels.scatter_rows_plain(
            table_plain, phys, rows, 2, True), 10),
        "library_ms": device_ms(lambda: table.index_copy_(0, flat_first, rows_first), 100),
        "bound_ms": bound[0], "bound_by": bound[1]}
    say("conve", f"B3 at the sparse step's shape ({2 * YAGO_ENTITY} x {width} fp32, {slots}"
        f" slots, {unique} unique pairs, {unit}-byte copies): equal to its plain version bit"
        f" for bit, duplicate slots (NaN) untouched; kernel {result['ms']:.4f} ms, plain"
        f" {result['plain_ms']:.4f} ms, index_copy_ {result['library_ms']:.4f} ms, bound"
        f" {bound[0]:.4f} ms ({bound[1]})")
    return result


def _conve_reference(params: dict, sharding: Sharding, score_fn: ConvE, rel: torch.Tensor,
                     head: torch.Tensor) -> torch.Tensor:
    """ConvE tail scores of (head, rel) queries against every local row: the
    queries' trunk (eval mode) and one full-fp32 product with the whole
    table plus the tail biases; padding rows at -inf."""
    table = params["entity_embedding"]
    with torch.inference_mode():
        hr = score_fn.hr_transform(params, table[head.long(), :-1],
                                   params["relation_embedding"][rel.long()])
        ref = torch.matmul(hr, table[:, :-1].T) + table[:, -1]  # main() turns TF32 off
        ref[:, int(sharding.shard_counts[0]):] = -float("inf")
    return ref


def _conve_serving(params: dict, sharding: Sharding, score_fn: ConvE, device: str,
                   smi: str) -> dict:
    """Top-10 of CONVE_QUERIES tail queries against every entity (the
    default window and chunk merge), held against a full-table reference and
    the CPU; ms per batch the best of YAGO_REPEATS x YAGO_BATCHES."""
    rng = np.random.default_rng(SEED + 1)
    rel = torch.from_numpy(rng.integers(2 * YAGO_RELATION, size=CONVE_QUERIES)).to(device)
    head = torch.from_numpy(rng.integers(int(sharding.shard_counts[0]),
                                         size=CONVE_QUERIES)).to(device)
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=SEED)
    topk = TopKQueryBessKGE(K, ns, score_fn, return_scores=True)
    with torch.inference_mode():
        out = topk.forward(params, rel, head=head)  # warm-up
        sync(device)
        best = float("inf")
        for _ in range(YAGO_REPEATS):
            t = time.perf_counter()
            for _ in range(YAGO_BATCHES):
                out = topk.forward(params, rel, head=head)
            sync(device)
            best = min(best, (time.perf_counter() - t) / YAGO_BATCHES)
    if not torch.isfinite(out["topk_scores"]).all() or out["topk_global_id"].shape != (
            CONVE_QUERIES, K):
        raise AssertionError(f"conve top-{K} output {tuple(out['topk_global_id'].shape)}")
    n = min(N_REFERENCE, CONVE_QUERIES)
    ref = _conve_reference(params, sharding, score_fn, rel[:n], head[:n])
    sure = _hold_topk("conve top-10 vs the full-table reference",
                      {k: v[:n] for k, v in out.items()}, ref, sharding, DENSE_RTOL)
    cpu = _tree_map(lambda v: v.cpu(), params) if device == "cuda" else params
    with torch.inference_mode():
        _same_topk("conve top-10 card vs CPU", {k: v[:64] for k, v in out.items()},
                   topk.forward(cpu, rel[:64].cpu(), head=head[:64].cpu()), DENSE_RTOL)
    say("conve", f"top-{K} of {CONVE_QUERIES} tail queries against all {sharding.n_entity}"
        f" entities (window {topk.window_size}, chunk merge, train=False): {best * 1e3:.3f} ms"
        f" per batch (best of {YAGO_REPEATS} x {YAGO_BATCHES}); {n} queries match a full-fp32"
        f" full-table reference ({sure} with a clear 10th/11th gap), 64 equal the CPU's; {smi}")
    return {"ms_per_batch": best * 1e3, "window": topk.window_size}


def _conve_allscores(params: dict, gen: torch.Generator, device: str) -> dict:
    """One AllScoresPipeline pass over CONVE_AS_ENTITY entities (the trained
    trunk and relations, a table drawn anew at that size) for
    CONVE_AS_QUERIES tail queries, windows of CONVE_AS_WINDOW: the matrix
    against one plain full-table matrix, within DENSE_RTOL."""
    sharding = Sharding.create(CONVE_AS_ENTITY, 1, seed=SEED)
    score_fn = _conve_fn(sharding)
    small = score_fn.initial_params_device(device=device, generator=gen)
    small.update({k: v for k, v in params.items() if k != "entity_embedding"})
    rng = np.random.default_rng(SEED + 2)
    tri = np.stack([rng.integers(CONVE_AS_ENTITY, size=CONVE_AS_QUERIES),
                    rng.integers(2 * YAGO_RELATION, size=CONVE_AS_QUERIES),
                    rng.integers(CONVE_AS_ENTITY, size=CONVE_AS_QUERIES)], 1).astype(np.int32)
    dataset = KGDataset(n_entity=CONVE_AS_ENTITY, n_relation_type=2 * YAGO_RELATION,
                        triples={"test": tri}, original_triple_ids={"test": np.arange(len(tri))})
    pts = PartitionedTripleSet.create_from_dataset(dataset, "test", sharding,
                                                   partition_mode="h_shard")
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=SEED)
    sampler = RigidShardedBatchSampler(pts, ns, shard_bs=CONVE_AS_QUERIES // 2, batches_per_step=2,
                                       seed=SEED, return_triple_idx=True)
    pipe = AllScoresPipeline(sampler, "t", score_fn, return_scores=True,
                             window_size=CONVE_AS_WINDOW, device=device)
    t = time.perf_counter()
    out = pipe.forward(small)
    sync(device)
    pass_s = time.perf_counter() - t
    got = torch.from_numpy(out["scores"])
    order = torch.from_numpy(out["triple_idx"].astype(np.int64))
    q = torch.from_numpy(tri).to(device)[order.to(device)]
    e2i = torch.as_tensor(sharding.entity_to_idx, device=device).long()
    want = _conve_reference(small, sharding, score_fn, q[:, 1], e2i[q[:, 0].long()])
    want = want[:, e2i].cpu()  # local rows -> global entity order
    err = (got - want).abs()
    if not (err <= DENSE_RTOL * (want.abs() + want.abs().max())).all():
        raise AssertionError(f"conve all-scores off the full-table matrix by {err.max().item()}")
    say("conve", f"AllScoresPipeline: {len(tri)} tail queries x {CONVE_AS_ENTITY} entities"
        f" (windows of {CONVE_AS_WINDOW}) in {pass_s:.3f} s, the matrix within"
        f" {DENSE_RTOL:g} x (|want| + max|want|) of a full-table matrix (max|err|"
        f" {err.max().item():.3g})")
    return {"pass_s": pass_s, "max_abs_err": err.max().item(), "entities": CONVE_AS_ENTITY}


def _rel_stray(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want| (0 for an all-zero ``want``)."""
    scale = want.abs().max().item()
    return (got.double() - want.double()).abs().max().item() / scale if scale else 0.0


def conve(gen: torch.Generator, profile: bool = False, device: str = "cuda",
          smi: str = "") -> dict:
    """ConvE at YAGO3-10 width, trained and served: (a) the dense host-fed
    step (FusedDenseAdamW, B10) against the CPU, its dropout masks equal to
    the CPU's and its BN running stats moved; (b) the same step
    device-sampled, one CUDA graph per call of CONVE_SPC steps with its
    dropout drawn inside, replays bit for bit and the keep rates of a call;
    (c) a sparse host-fed step (RowSGDM interleaved, B3) against the CPU;
    (d) top-10 serving; (e) an all-scores pass (``device`` "cpu" rehearses
    the phase without the card's gates)."""
    on_card = device == "cuda"
    result = {}
    sharding = Sharding.create(YAGO_ENTITY, 1, seed=SEED)
    score_fn = _conve_fn(sharding)
    rng = np.random.default_rng(SEED)
    triples = np.stack([rng.integers(YAGO_ENTITY, size=YAGO_TRIPLE),
                        rng.integers(YAGO_RELATION, size=YAGO_TRIPLE),
                        rng.integers(YAGO_ENTITY, size=YAGO_TRIPLE)], 1).astype(np.int32)
    module, pts = _conve_module(triples, sharding, score_fn)
    ns = module.negative_sampler
    host = RigidShardedBatchSampler(pts, ns, shard_bs=CONVE_SHARD_BS, batches_per_step=CONVE_BPS,
                                    seed=SEED)
    blocks = iter(host.epoch_index_blocks(shuffle=True))
    batch = host.sample_batch(next(blocks))
    b = batch["head"].shape[-1] * batch["head"].shape[-2]  # queries per micro-batch
    say("conve", f"ConvE {YAGO_ENTITY} x {CONVE_EMB + 1} table, {2 * YAGO_RELATION} relation"
        f" rows, fc_in {score_fn.fc_in} (fc_w {score_fn.fc_in} x {CONVE_EMB}); {len(triples)}"
        f" triples and their inverses, {CONVE_BPS} x {b} positives per step, {smi}")

    # (a) The dense host-fed step against the CPU, from copies of one state,
    # with one dropout key.
    adamw = optim.AdamW(CONVE_LR)
    fused = optim.FusedDenseAdamW(CONVE_LR, weight_decay=1e-4)
    params = score_fn.initial_params_device(device=device, generator=gen)
    initial_bn = {k: trainer._clone(params[k]) for k in ("bn0", "bn1", "bn2")}
    state = trainer.init_optimizer_state(adamw, params, None, fused)
    cpu_params, cpu_state = _to(params, "cpu"), _to(state, "cpu")
    key = torch.tensor(CONVE_RNG, dtype=torch.int64)
    card_masks = _conve_masks(score_fn, key.to(device), CONVE_BPS, b)
    cpu_masks = _conve_masks(score_fn, key, CONVE_BPS, b)
    if not all(torch.equal(c.cpu(), m) for (_, _, c), (_, _, m) in zip(card_masks, cpu_masks)):
        raise AssertionError("conve: the dropout masks drawn on the card differ from the CPU's")
    step = trainer.build_train_step(module, adamw, None, fused, device=device)
    reset_counts()
    params, state, out = step(params, state, batch, CONVE_RNG)
    sync(device)
    counts = read_counts()
    if on_card:
        expect_counts("conve dense step", counts, {"dense_adamw_update": 1})
    t = time.perf_counter()
    cpu_params, cpu_state, cpu_out = trainer.build_train_step(
        module, adamw, None, fused, device="cpu")(cpu_params, cpu_state, batch, CONVE_RNG)
    cpu_s = time.perf_counter() - t
    loss, cpu_loss = float(out["loss"]), float(cpu_out["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > DENSE_RTOL * abs(cpu_loss):
        raise AssertionError(f"conve step loss {loss} on the card, {cpu_loss} on the CPU")
    errs = _conve_hold_dense("conve dense step vs the CPU", (params, state),
                             (cpu_params, cpu_state), 1)
    for k, stats in initial_bn.items():
        for f in ("mean", "var"):
            if torch.equal(params[k][f], stats[f]):
                raise AssertionError(f"conve: {k} {f} did not move in the step")
    # The first step's mu is (1 - 0.9) g: the CPU's gradients of CONVE_NOISE
    # beside the largest.
    grads = {name: mom["mu"].abs().max().item() / 0.1
             for name, (_, mom) in _adam_params(cpu_params, cpu_state).items()}
    top = max(grads, key=grads.get)
    say("conve", f"(a) dense host-fed step (FusedDenseAdamW on the table, AdamW on the"
        f" relations and trunk), dropout key {CONVE_RNG}: the {len(card_masks)} masks drawn on"
        f" the card equal the CPU's bit for bit; card vs CPU ({cpu_s:.1f}s): loss {loss:.6f} vs"
        f" {cpu_loss:.6f}, {_conve_gate_report(errs)} (BN running stats moved, within the"
        f" gate); the CPU's max|g|: " + ", ".join(f"{n} {grads[n]:.3g}" for n in CONVE_NOISE)
        + f", the largest {top} {grads[top]:.3g}; launches {_launched()}")
    result["dense_vs_cpu"] = {"max_abs_err": max(e for e, _ in errs.values()),
                              "max_gate_ratio": max(r for _, r in errs.values()),
                              "arrays": len(errs),
                              "noise_grads": {n: grads[n] for n in CONVE_NOISE},
                              "largest_grad": grads[top]}
    result["dense_host_launches"] = counts["dense_adamw_update"]
    del cpu_params, cpu_state
    timed = []
    for _ in range(2):
        batches = [host.sample_batch(next(blocks)) for _ in range(CONVE_TIMED_CALLS)]
        batches = [_batch_tensors(x, _FORWARD_KEYS, device) for x in batches]
        sync(device)
        t = time.perf_counter()
        for i, x in enumerate(batches):
            params, state, out = step(params, state, x, CONVE_RNG + 1 + i)
        sync(device)
        timed.append((time.perf_counter() - t) / len(batches) * 1e3)
    say("conve", f"(a) host-fed dense step (batches staged on the device): {timed[0]:.4f} /"
        f" {timed[1]:.4f} ms per step over {CONVE_TIMED_CALLS} steps each, {smi}")
    result["host_ms_per_step"] = timed

    # (b) The same step device-sampled: one CUDA graph per call.
    dev = DeviceBatchSampler(pts, ns, shard_bs=CONVE_SHARD_BS, batches_per_step=CONVE_BPS,
                             seed=SEED, positive_mode="runs")
    form = dict(module=module, opt=adamw, ent=fused, spc=CONVE_SPC, params=params, state=state,
                sampler=dev, pts=pts, want={"dense_adamw_update": 1},
                kernels={"dense_adamw_kernel": 1}, phase="conve", all_bits=True,
                rng=lambda call: CONVE_RNG + 100 + call)
    form["fn"] = trainer.build_device_train_step(module, adamw, dev, None, fused,
                                                 steps_per_call=CONVE_SPC, device=device)
    form["sampler_state"] = dev.state(device)
    fn, st = form["fn"], form["sampler_state"]
    if on_card:
        result["device"] = _graph_equals_eager("conve", form)
    else:
        reset_counts()
        fn(params, state, st, dev.next_key(0), CONVE_RNG + 100)
        result["device"] = {"first_call_wrapper_launches": _launched()}
    # Keep rates over one call's masks (the call's key split per step as
    # the call splits it).
    call_key = torch.tensor(CONVE_RNG + 100, dtype=torch.int64, device=device)
    kept: Dict[str, list] = {}
    for step_key in split_key(call_key, CONVE_SPC):
        for site, keep, mask in _conve_masks(score_fn, step_key, CONVE_BPS, b):
            kept.setdefault(site, [keep, 0, 0])
            kept[site][1] += int(mask.sum())
            kept[site][2] += mask.numel()
    rates = {}
    for site, (keep, n_kept, n) in kept.items():
        sigma = (keep * (1 - keep) / n) ** 0.5
        rates[site] = {"keep": n_kept / n, "expected": keep, "sigmas": (n_kept / n - keep) / sigma}
        if abs(n_kept / n - keep) > 4 * sigma:
            raise AssertionError(f"conve {site} dropout keeps {n_kept / n} over a call, expected"
                                 f" {keep} within 4 x {sigma:.2g}")
    say("conve", "(b) keep rates over one call: " + ", ".join(
        f"{site} {r['keep']:.5f} (1 - p = {r['expected']:.1f}, {r['sigmas']:+.2f} sigma)"
        for site, r in rates.items()))
    result["keep_rates"] = rates
    timed = []
    for i in range(2):
        fn(params, state, st, dev.next_key(100 + 10 * i), CONVE_RNG + 200 + 10 * i)  # warm-up
        sync(device)
        t = time.perf_counter()
        for j in range(CONVE_TIMED_CALLS):
            _, _, out = fn(params, state, st, dev.next_key(101 + 10 * i + j),
                           CONVE_RNG + 201 + 10 * i + j)
        sync(device)
        timed.append((time.perf_counter() - t) / (CONVE_TIMED_CALLS * CONVE_SPC) * 1e3)
    say("conve", f"(b) device-sampled ({CONVE_SPC} steps per call): {timed[0]:.4f} /"
        f" {timed[1]:.4f} ms per step over {CONVE_TIMED_CALLS} calls each, capture"
        f" {result['device'].get('capture_s', float('nan')):.3f} s; final loss"
        f" {float(out['loss']):.3f}; {smi}")
    result["device_ms_per_step"] = timed
    if profile and on_card:
        prof = profile_run(
            lambda: [fn(params, state, st, dev.next_key(300 + i), CONVE_RNG + 300 + i)
                     for i in range(2)], 2 * CONVE_SPC, "conve_trace.json")
        result["profile"] = prof
        result["conv_fc_share"] = _conve_trunk_share(smi)

    # (c) A sparse host-fed step: RowSGDM interleaved (B3).
    sgd = optim.SGD(CONVE_LR, momentum=MOMENTUM)
    row = optim.RowSGDM(CONVE_LR, momentum=MOMENTUM, interleaved=True)
    sparse_params = score_fn.initial_params_device(device=device, generator=gen)
    sparse_params["entity_embedding"] = optim.interleave_momentum(
        sparse_params["entity_embedding"])
    sparse_state = trainer.init_optimizer_state(sgd, sparse_params, None, row,
                                                n_logical=sharding.max_entity_per_shard)
    # The reference: the same step on the CPU in float64, and in fp32 beside
    # it (on the card's host the CPU's fp32 step strays from the float64 one
    # by ~2e-3 of an array's largest value at this state, the card's by
    # ~1e-6: the fp32 CPU step cannot hold the card to the dense gate;
    # tools/conve_cpu_stray.py follows the stray stage by stage).
    cpu_sparse = {dtype: tuple(_tree_map(
        lambda v: v.to("cpu", dtype if v.is_floating_point() else v.dtype, copy=True), t)
        for t in (sparse_params, sparse_state)) for dtype in (torch.float64, torch.float32)}
    reset_counts()
    sparse_params, sparse_state, out = trainer.build_train_step(
        module, sgd, None, row, device=device)(sparse_params, sparse_state, batch, CONVE_RNG)
    sync(device)
    counts = read_counts()
    if on_card:
        expect_counts("conve sparse step", counts, {"scatter_rows": 1})
    cpu_step = trainer.build_train_step(module, sgd, None, row, device="cpu")
    cpu_sparse = {dtype: cpu_step(*t, batch, CONVE_RNG) for dtype, t in cpu_sparse.items()}
    loss, cpu_loss = float(out["loss"]), float(cpu_sparse[torch.float64][2]["loss"])
    if not np.isfinite(loss) or abs(loss - cpu_loss) > DENSE_RTOL * abs(cpu_loss):
        raise AssertionError(f"conve sparse step loss {loss} on the card, {cpu_loss} on the CPU")
    ids = np.concatenate([batch[k].reshape(-1) for k in ("head", "tail", "negative")])
    touched = torch.unique(torch.from_numpy(ids.astype(np.int64)))
    errs = _conve_hold_sparse("conve sparse step vs the CPU (float64)", (
        sparse_params, sparse_state), cpu_sparse[torch.float64][:2], touched)
    by_array = {side: {name: _rel_stray(g.cpu(), w) for (name, g), (_, w) in zip(
        trainer._leaves(state_[1]["other"]["trace"]),
        trainer._leaves(cpu_sparse[torch.float64][1]["other"]["trace"]))
        if w.abs().max().item() > 0 and name not in CONVE_NOISE}
        for side, state_ in (("card", (sparse_params, sparse_state)),
                             ("cpu_fp32", cpu_sparse[torch.float32]))}
    strays = {side: max(v.values()) for side, v in by_array.items()}
    worst = {side: max(v, key=v.get) for side, v in by_array.items()}
    say("conve", f"(c) sparse host-fed step (RowSGDM interleaved, B3): card vs the CPU's"
        f" float64 step: loss {loss:.6f} vs {cpu_loss:.6f}, {_conve_gate_report(errs)}; the"
        f" relations' and trunk's momenta but CONVE_NOISE off the float64 step by at most"
        f" {strays['card']:.3g} of their largest value on the card ({worst['card']}),"
        f" {strays['cpu_fp32']:.3g} in the CPU's fp32 step ({worst['cpu_fp32']}); launches"
        f" {_launched()}")
    result["sparse_vs_cpu"] = {"reference": "float64",
                               "max_abs_err": max(e for e, _ in errs.values()),
                               "max_gate_ratio": max(r for _, r in errs.values()),
                               "arrays": len(errs), "momentum_rel_err": strays}
    result["sparse_host_launches"] = counts["scatter_rows"]
    del sparse_params, sparse_state, cpu_sparse
    if on_card:  # B3 at the step's shape: one slot per gathered row
        result["b3"] = _conve_check_b3(gen, len(ids))

    # (d) Serving the trained params; (e) an all-scores pass.
    result["serving"] = _conve_serving(params, sharding, score_fn, device, smi)
    result["allscores"] = _conve_allscores(params, gen, device)
    if on_card:
        result["b10"] = check_dense_adamw(gen, (((YAGO_ENTITY, CONVE_EMB + 1), torch.float32),))
        b10 = result["b10"]
        say("conve", f"B10 at {YAGO_ENTITY} x {CONVE_EMB + 1} fp32: {b10['ms']:.4f} ms, bound"
            f" {b10['bound'][0]:.4f} ms ({b10['bound'][1]}), plain {b10['plain_ms']:.4f} ms,"
            f" torch.optim.AdamW(fused=True) {b10['library_ms']:.4f} ms; {smi}")
        result["conv_cost"] = _conve_conv_cost(b, smi)
        result["capture_s"] = result["device"]["capture_s"]
    return result


def _conve_conv_cost(b: int, smi: str) -> dict:
    """What deterministic cuDNN without TF32 costs the trunk's conv: its
    forward and both gradients under the micro-batch vmap at the step's
    shape (CONVE_BPS micro-batches of 2 x b maps of 1 x 20 x 20, 32 filters
    of 3 x 3), through the port's ``_ValidConv2d`` and through ``F.conv2d``
    under cuDNN's defaults (TF32 allowed, any algorithm); ms per pass."""
    x = torch.randn(CONVE_BPS, 2 * b, 1, 2 * CONVE_H, CONVE_W, device="cuda")
    w = torch.randn(32, 1, 3, 3, device="cuda")

    def grads(conv):
        def loss(w_, x_):
            return conv(x_, w_).square().sum()

        step = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)), in_dims=(None, 0))
        return lambda: step(w, x)

    cost = {"exact_ms": cuda_ms(grads(scoring._ValidConv2d.apply), 20),
            "default_ms": cuda_ms(grads(torch.nn.functional.conv2d), 20)}
    say("conve", f"the trunk's conv, forward and both gradients under vmap ({CONVE_BPS} x"
        f" {2 * b} maps): {cost['exact_ms']:.4f} ms deterministic without TF32 (the port's),"
        f" {cost['default_ms']:.4f} ms under cuDNN's defaults; {smi}")
    return cost


#: Kernel names of the conv (cuDNN) and the linear map (cuBLAS/CUTLASS GEMMs).
TRUNK_KERNELS = ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "sm90")


def _conve_trunk_share(smi: str) -> dict:
    """The conv and FC kernels' share of the device time of the last
    profiled ConvE calls (kernels named as cuDNN convolutions or GEMMs), from
    the trace that :func:`profile_run` wrote."""
    trace = json.loads((Path("chiprun_out") / "conve_trace.json").read_text())
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and "dur" in e]
    total = sum(e["dur"] for e in kernels)
    trunk = sum(e["dur"] for e in kernels
                if any(k in e["name"].lower() for k in TRUNK_KERNELS))
    share = {"trunk_us": trunk, "total_us": total, "share": trunk / total if total else None}
    say("profile", f"conve: conv and FC kernels {trunk / 1e3:.3f} of {total / 1e3:.3f} ms of"
        f" kernels ({100 * share['share']:.1f} %) over the profiled calls; {smi}")
    return share


# ---------------------------------------------------------------------------
# mesh: the BESS scheme over ranks (ROADMAP A15a)


def _mesh_module(n_shard: int, axis_name: str = "shard") -> tuple:
    """The wikikg2 step's score function, module and host sampler over
    ``n_shard`` shards (bench.py's batch geometry: 8 x 512 positives per
    shard, 32 shared "ht" negatives, bf16 scoring math)."""
    triples, sharding, score_fn, _ = _wikikg2(n_shard)
    module, sampler, pts = _training_setup(triples, sharding, score_fn, axis_name)
    return triples, score_fn, module, sampler, pts


def _touched(batch: dict, rank: int) -> torch.Tensor:
    """The logical rows of rank ``rank``'s table block that its column of a
    host batch gathers (its heads, its tails, its negatives)."""
    return torch.unique(torch.cat([torch.from_numpy(batch[k][:, rank].reshape(-1)).long()
                                   for k in ("head", "tail", "negative")]))


_L1_PATH = ("l1_distance_matrix", "l1_distance_grads")


def _l1_calls(run, names=_L1_PATH):
    """``run()``, and the shapes and dtypes of the arguments with which it
    called the B5 and B6 wrappers: a set of ``(name, ((shape, dtype), ...))``.
    The step reaches them through ``ops.distance``, whose view of
    ``l1_kernels`` is swapped for one that records each call and passes it
    on, so each launch count is as without the record. The path must call
    each of ``names``, and nothing else of them."""
    seen = set()

    def recorder(name):
        def call(*args):
            seen.add((name, tuple((tuple(x.shape), str(x.dtype)[6:]) for x in args)))
            return getattr(l1_kernels, name)(*args)
        return call

    class Recording:
        def __getattr__(self, name):
            return recorder(name) if name in _L1_PATH else getattr(l1_kernels, name)

    try:
        distance.l1_kernels = Recording()
        result = run()
    finally:
        distance.l1_kernels = l1_kernels
    if {name for name, _ in seen} != set(names):
        raise AssertionError(f"the path called {sorted(seen)}, not just {names}")
    return result, seen


def _hold_l1_at(calls, gen: torch.Generator) -> dict:
    """B5 and B6 at each of ``calls`` (as :func:`_l1_calls` records them),
    on fresh card tensors with planted exact ties and a random cotangent of
    the path's dtype, against their plain versions at
    :func:`check_training_kernels`' gates. Returns each kernel's shapes and
    max |err|."""
    out = {name: {"shapes": [], "max_abs_err": 0.0} for name in _L1_PATH}
    for name, args in sorted(calls):
        (sa, dt), (sb, _) = args[:2]
        dtype, d = getattr(torch, dt), sa[-1]
        a, b = uniform(sa, gen, d).to(dtype), uniform(sb, gen, d).to(dtype)
        k = min(sa[0], sb[0]) // 2
        b[:k, : d // 2] = a[:k, : d // 2]  # planted exact ties
        if name == "l1_distance_matrix":
            ref = l1_kernels.l1_distance_matrix_plain(a, b).float()
            err = (l1_kernels.l1_distance_matrix(a, b).float() - ref).abs()
            tol = ATOL + (RTOL + (BF16_ULP if dtype == torch.bfloat16 else 0.0)) * ref.abs()
            held = [(err, tol)]
        else:
            w = torch.randn(args[2][0], device="cuda", generator=gen).to(getattr(torch, args[2][1]))
            da, db = l1_kernels.l1_distance_grads(a, b, w)
            rda, rdb = l1_kernels.l1_distance_grads_batched_plain(a[None], b[None], w[None])
            held = [((da - rda[0]).abs(), sum_tol(w.float(), 1)),
                    ((db - rdb[0]).abs(), sum_tol(w.float().T, 1))]
        for err, tol in held:
            if not (err <= tol).all():
                raise AssertionError(f"{name} at {args} off its plain version by {err.max().item()}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err.max().item())
        out[name]["shapes"].append([list(shape) + [t] for shape, t in args])
    torch.cuda.synchronize()
    return out


def _mesh_nccl(gen: torch.Generator, tmp: Path, smi: str, profile: bool = False) -> dict:
    """The wikikg2 device-sampled call (spc WIKIKG2_SPC, one CUDA graph) over
    a one-rank NCCL mesh, its all-to-alls and all-reduce captured in the
    graph, against its own eager steps and against the same call without a
    mesh."""
    multihost.initialize(f"file://{tmp / 'nccl_store'}", 1, 0, backend="nccl")
    try:
        mesh = make_shard_mesh(1)
        if mesh.backend != "nccl" or not mesh.capturable:
            raise AssertionError(f"expected a capturable NCCL mesh, got {mesh}")
        _, score_fn, module, sampler, pts = _mesh_module(1)
        free_module = _mesh_module(1, None)[2]
        params = score_fn.initial_params_device(device="cuda", generator=gen)
        params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
        sgd, row = optim.SGD(LR, momentum=MOMENTUM), optim.RowSGDM(LR, momentum=MOMENTUM,
                                                                   interleaved=True)
        dev = DeviceBatchSampler(pts, module.negative_sampler, shard_bs=SHARD_BS_TRAIN,
                                 batches_per_step=BPS, seed=SEED, positive_mode="runs")
        st = dev.state("cuda")
        n_logical = module.sharding.max_entity_per_shard
        fn = trainer.build_device_train_step(module, sgd, dev, mesh, row,
                                             steps_per_call=WIKIKG2_SPC)
        free = trainer.build_device_train_step(free_module, sgd, dev, None, row,
                                               steps_per_call=WIKIKG2_SPC)
        if fn.uncaptured is not None or fn._graph is None:
            raise AssertionError(f"the NCCL mesh call is not a CUDA graph: {fn.uncaptured}")
        held = (params, trainer.init_optimizer_state(sgd, params, mesh, row, n_logical=n_logical))
        spc, results = WIKIKG2_SPC, {"replays": []}
        for call in range(3):
            key = dev.next_key(call)
            # The same call from the same state: by its eager steps, and
            # without a mesh.
            eager = (trainer._clone(held[0]), trainer._clone(held[1]))
            other = (trainer._clone(held[0]), trainer._clone(held[1]))
            reset_counts()
            if call == 0:
                census, l1_calls = _l1_calls(lambda: collective_census(fn, *held, st, key,
                                                                       mesh=mesh))
                counts = read_counts()
                # The warm-up's and the capture's: 2 x each step's.
                expect_counts("mesh nccl first call", counts, {
                    "l1_distance_matrix": 2 * spc * 2 * BPS, "l1_distance_grads": 2 * spc * 2 * BPS,
                    "scatter_rows": 2 * spc})
                ppp = SHARD_BS_TRAIN
                payload = 1 * (ppp + 2 * N_NEGATIVE) * DIM * 2  # bf16 rows
                if (census["all-to-all"] != [payload] * (2 * 2 * spc * BPS)
                        or census["all-gather"] or len(census["all-reduce"]) != 2 * spc):
                    raise AssertionError(f"mesh nccl census {census}")
                results["first_call_wrapper_launches"] = {k: v for k, v in counts.items() if v}
                results["l1_at_path_shape"] = _hold_l1_at(l1_calls, gen)
                results["census_first_call"] = {
                    "all-to-all": len(census["all-to-all"]), "all_to_all_bytes": payload,
                    "all-gather": len(census["all-gather"]), "all-reduce": len(census["all-reduce"]),
                    "all_reduce_bytes": census["all-reduce"][0], "steps": 2 * spc}
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn(*held, st, key)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                counts = read_counts()
                expect_counts(f"mesh nccl replay {call}", counts, {})
            free(*other, st, key)
            torch.cuda.synchronize()
            fn._eager(*eager, st, key.cuda())
            torch.cuda.synchronize()
            bits = [torch.equal(g, e) for (_, g), (_, e) in zip(
                trainer._leaves({"p": held[0], "s": held[1]}),
                trainer._leaves({"p": eager[0], "s": eager[1]}))]
            if not all(bits):
                raise AssertionError(f"mesh nccl call {call}: graph and eager differ")
            # Against the mesh-free call, within the dense gate, after each call.
            errs = _mesh_gate(f"mesh nccl call {call} vs no mesh", held, other,
                              _touched_device(dev, key, spc), DENSE_RTOL)
            results["replays"].append({"call": call, "bitwise_vs_eager": True, "vs_no_mesh": errs})
            say("mesh", f"NCCL 1 rank call {call} ({'replay' if call else 'eager, then capture'}):"
                f" equal to its eager steps bit for bit; vs the call without a mesh max|err|"
                f" {max(errs.values()):.3g} (dense gate {DENSE_RTOL}); wrapper launches"
                f" {dict((k, v) for k, v in counts.items() if v)}")
        say("mesh", f"NCCL 1 rank census of the first call (eager + capture, {2 * spc} steps):"
            f" {results['census_first_call']}")
        timed: Dict[str, list] = {}
        for name in ("mesh", "no mesh", "no mesh", "mesh"):
            call = fn if name == "mesh" else free
            args = held if name == "mesh" else other
            call(*args, st, dev.next_key(50))
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(MESH_TIMED_CALLS):
                call(*args, st, dev.next_key(51 + i))
            torch.cuda.synchronize()
            timed.setdefault(name, []).append(
                (time.perf_counter() - t) / (MESH_TIMED_CALLS * spc) * 1e3)
        results["ms_per_step"] = timed
        say("mesh", f"NCCL 1 rank, device-sampled spc {spc} ({smi}): {timed['mesh'][0]:.4f} /"
            f" {timed['mesh'][1]:.4f} ms per step over the mesh, {timed['no mesh'][0]:.4f} /"
            f" {timed['no mesh'][1]:.4f} without ({MESH_TIMED_CALLS} calls per set); NCCL at"
            " one rank, no measure of NCCL across cards")
        if profile:
            for name, call, args in (("mesh", fn, held), ("no_mesh", free, other)):
                results.setdefault("profile", {})[name] = profile_run(
                    lambda: [call(*args, st, dev.next_key(200 + i)) for i in range(2)],
                    2 * spc, f"mesh_nccl_{name}_trace.json")
        del held, other
        torch.cuda.empty_cache()
        results["rest"] = _mesh_nccl_rest(gen, mesh, free_module, sampler, smi)
        return results
    finally:
        torch.distributed.destroy_process_group()


def _touched_device(dev: DeviceBatchSampler, key: torch.Tensor, spc: int) -> torch.Tensor:
    """The logical rows that the steps of one device-sampled call gather
    (one shard)."""
    cpu = dev.state("cpu")
    keys = split_key(key, spc) if spc > 1 else key[None]
    batches = [dev.sample(cpu, k) for k in keys]
    return torch.unique(torch.cat([b[k].reshape(-1).long() for b in batches
                                   for k in ("head", "tail", "negative")]))


def _mesh_gate(what: str, got: tuple, want: tuple, rows: torch.Tensor, rtol: float) -> dict:
    """The sparse form's (params, state) against another's (the relation
    table, its momentum and the entity rows ``rows``, params and momentum)
    within rtol x (|want| + max|want|), each param also with lr x |m_got −
    m_want| (the step moved it by lr·m). Returns each array's max |err|."""
    errs = {}
    for name, g, w, extra in _sparse_arrays(got, want, rows, LR):
        err = (g - w).abs()
        tol = rtol * (w.abs() + w.abs().max()) + extra
        if not (err <= tol).all() or not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {name} off by {err.max().item()}")
        errs[name] = err.max().item()
    return errs


# ---------------------------------------------------------------------------
# mesh, the rest (ROADMAP A15b): ScoreMoving evaluation and training, the
# all-scores pipeline and ConvE's SyncBN over ranks


def _valid_blocks(sampler, mesh, device: str) -> tuple:
    """The pass of ``sampler`` staged as device blocks of VALID_SPB steps
    (the rank's column over ``mesh``), and its number of queries."""
    steps = [{k: v for k, v in b.items() if k in _FORWARD_KEYS}
             for b in sampler.get_dataloader(shuffle=False)]
    n_q = sum(int(s["triple_mask"].sum()) for s in steps)
    return [_stack_block(steps[i:i + VALID_SPB], VALID_SPB, torch.device(device), mesh)
            for i in range(0, len(steps), VALID_SPB)], n_q


def _blocks_rate(run_block, params, blocks, n_q: int, device: str) -> float:
    """Queries per second of the staged blocks run back to back (after one
    warm-up block), to the fetch of the sums."""
    run_block(params, blocks[0])
    sync(device)
    t = time.perf_counter()
    float(sum(run_block(params, blk) for blk in blocks)[0])
    return n_q / (time.perf_counter() - t)


def _global_rows(sharding: Sharding, device) -> torch.Tensor:
    """The row of each entity in the global (n_shard x rows) table."""
    return torch.from_numpy((sharding.entity_to_shard * sharding.max_entity_per_shard
                             + sharding.entity_to_idx).astype(np.int64)).to(device)


def _valid_one_shard(whole: dict, sharding: Sharding, device: str) -> dict:
    """run_device_eval's metrics of the valid pass without a mesh, on the
    global table ``whole`` (rows in ``sharding``'s order) laid out in the
    one-shard order: each candidate's score is the mesh's, by the same
    code."""
    _, _, one_sh, one_module, one_sampler, _, _ = _valid_setup(1, None)
    flat = torch.zeros((one_sh.max_entity_per_shard, DIM), device=device)
    flat[torch.from_numpy(one_sh.entity_to_idx.astype(np.int64)).to(device)] = whole[
        "entity_embedding"][_global_rows(sharding, device)]
    metrics, _ = run_device_eval(one_module, {"entity_embedding": flat, "relation_embedding":
                                              whole["relation_embedding"]}, one_sampler, None,
                                 steps_per_block=VALID_SPB, device=device)
    return metrics


def _hold_valid(what: str, got: dict, want: dict) -> None:
    """The mesh's metrics against the mesh-free pass's: the same per-query
    ranks summed in other orders, so within VALID_SUM_ULPS fp32 ulps of
    each metric (hits@10 counts whole queries, exact in fp32)."""
    for k, w in want.items():
        if abs(got[k] - w) > VALID_SUM_ULPS * U32 * w:
            raise AssertionError(f"{what}: {k} {got[k]} over the mesh, {w} without")


def _as_pipeline(sampler, score_fn, mesh, device: str, scores: bool = False) -> AllScoresPipeline:
    """The all-scores pipeline with per-query ranks and metrics and the
    top-K (and the score matrix with ``scores``)."""
    return AllScoresPipeline(sampler, "t", score_fn, mesh=mesh,
                             evaluation=Evaluation(["mrr", "hits@10"], return_ranks=True),
                             return_scores=scores, return_topk=True, k=K, window_size=AS_WINDOW,
                             device=device)


def _by_query(out: dict, pts) -> dict:
    """A pipeline's per-query outputs in the queries' own order."""
    order = np.argsort(pts.triple_sort_idx[out["triple_idx"]])
    return {"ranks": out["ranks"][order], "topk": out["topk_global_id"][order],
            "mrr": out["metrics"]["mrr"][order]}


def _hold_as_ties(got: dict, want: dict, whole: dict, sharding: Sharding,
                  triples: np.ndarray) -> dict:
    """The mesh pipeline's ranks and top-K (``got``, by query) against the
    mesh-free one's (``want``) up to ties within the bf16 gate: a query
    whose rank differs has at least that many entities whose plain score
    lies within 2^-7 of its true score; a top-K that differs as a set
    differs only in entities whose plain score lies within 2^-7 of the K-th
    best. Returns the counts of such queries."""
    table, rel = whole["entity_embedding"], whole["relation_embedding"]
    device = table.device
    row = _global_rows(sharding, device)
    pool = table[row].to(torch.bfloat16)  # the global order

    def scores(q):
        h, r = (torch.tensor([int(triples[q, j])], device=device) for j in (0, 1))
        query = table[row[h]].to(torch.bfloat16) + rel[r].to(torch.bfloat16)
        return l1_kernels.l1_distance_matrix_plain(query, pool).float().neg()[0]

    rank_diff = np.flatnonzero(got["ranks"] != want["ranks"])
    set_diff = np.flatnonzero(~(np.sort(got["topk"], 1) == np.sort(want["topk"], 1)).all(1))
    for q in rank_diff:
        s = scores(q)
        true = s[int(triples[q, 2])]
        near = int(((s - true).abs() <= BF16_ULP * true.abs()).sum()) - 1
        if abs(float(got["ranks"][q]) - float(want["ranks"][q])) > near:
            raise AssertionError(f"mesh allscores: query {q} ranks {got['ranks'][q]} and"
                                 f" {want['ranks'][q]}, {near} entities tie its true score")
    for q in set_diff:
        s = scores(q)
        kth = torch.topk(s, K).values[-1]
        odd = np.setxor1d(got["topk"][q], want["topk"][q])
        if not ((s[torch.from_numpy(odd).to(device)] - kth).abs() <= BF16_ULP * kth.abs()).all():
            raise AssertionError(f"mesh allscores: query {q} top-{K} differs beyond ties")
    return {"rank_ties": len(rank_diff), "topk_ties": len(set_diff)}


def _sm_module(module, axis_name: str = "shard") -> ScoreMovingBessKGE:
    """ScoreMoving on the wikikg2 step's score function and negatives (32
    shared "ht" negatives, SSCE; no augmentation, which it does not take)."""
    return ScoreMovingBessKGE(module.negative_sampler, module.score_fn,
                              SampledSoftmaxCrossEntropyLoss(N_ENTITY), axis_name=axis_name)


def _mesh_nccl_rest(gen: torch.Generator, mesh, wikikg2, sampler, smi: str) -> dict:
    """The rest of the mesh at one NCCL rank against the same calls without
    a mesh: (a) ScoreMoving validation through run_device_eval, the metric
    sums bit for bit, no host sync in a block; (b) the all-scores pipeline,
    scores, ranks, metrics and top-K bit for bit; (c) one ScoreMoving
    sparse wikikg2 step, every array bit for bit. B5 and B6 recorded at
    the shapes (b) and (c) give them."""
    out: Dict[str, object] = {}
    # (a) Validation.
    triples, cands, sharding, module, sampler_v, _, _ = _valid_setup(1)
    free = ScoreMovingBessKGE(module.negative_sampler, module.score_fn,
                              evaluation=module.evaluation, axis_name=None)
    params = module.score_fn.initial_params_device(device="cuda", generator=gen)
    got = run_device_eval(module, params, sampler_v, mesh, steps_per_block=VALID_SPB)
    want = run_device_eval(free, params, sampler_v, None, steps_per_block=VALID_SPB,
                           device="cuda")
    if got != want:
        raise AssertionError(f"mesh nccl valid: {got} over the mesh, {want} without")
    blocks, n_q = _valid_blocks(sampler_v, mesh, "cuda")
    runners = {"mesh": make_block_runner(module, mesh), "no mesh": make_block_runner(free)}
    rates: Dict[str, list] = {}
    for name in ("mesh", "no mesh", "no mesh", "mesh"):
        rates.setdefault(name, []).append(_blocks_rate(runners[name], params, blocks, n_q,
                                                       "cuda"))
    torch.cuda.set_sync_debug_mode("error")
    try:
        runners["mesh"](params, blocks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # Kernels of one block over the mesh and without: launches and device ms.
    per_block = {}
    for name, run in runners.items():
        kernels = device_kernels(lambda: run(params, blocks[0]), 2)
        per_block[name] = {"launches": sum(n for _, n in kernels.values()),
                           "kernel_ms": sum(ms for ms, _ in kernels.values())}
    out["valid"] = {"metrics": got[0], "n_queries": got[1], "queries_per_s": rates,
                    "per_block": per_block}
    say("mesh", f"(a) NCCL 1 rank valid ({VALID_QUERIES} x {VALID_CANDIDATES}, ScoreMoving,"
        f" run_device_eval {VALID_SPB} x ({VALID_BPS} x {VALID_SHARD_BS})): metrics {got[0]}"
        f" equal to the mesh-free pass bit for bit; no host sync in a block;"
        f" {rates['mesh'][0]:.4g} / {rates['mesh'][1]:.4g} queries/s over the mesh,"
        f" {rates['no mesh'][0]:.4g} / {rates['no mesh'][1]:.4g} without (blocks staged); a"
        f" block of {VALID_SPB} steps launches {per_block['mesh']['launches']:.0f} kernels"
        f" ({per_block['mesh']['kernel_ms']:.3f} ms of kernels) over the mesh,"
        f" {per_block['no mesh']['launches']:.0f} ({per_block['no mesh']['kernel_ms']:.3f} ms)"
        f" without; {smi}")
    del params

    # (b) The all-scores pipeline.
    triples, sharding, score_fn, pts, sampler_as, _ = _as_setup(1, AS_BPS)
    params = score_fn.initial_params_device(device="cuda", generator=gen)
    pipe, free_pipe = (_as_pipeline(sampler_as, score_fn, m, "cuda", True) for m in (mesh, None))
    reset_counts()
    got, calls = _l1_calls(lambda: pipe.forward(params), ("l1_distance_matrix",))
    counts = read_counts()
    n_step = pipe.bess_module.n_step
    expect_counts("mesh nccl allscores", counts, {"l1_distance_matrix": n_step * AS_BPS})
    want = free_pipe.forward(params)
    for key in ("scores", "ranks", "topk_global_id", "triple_idx"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"mesh nccl allscores: {key} differ from the mesh-free pipeline")
    if any(not np.array_equal(got["metrics"][k], want["metrics"][k]) for k in want["metrics"]):
        raise AssertionError("mesh nccl allscores: metrics differ from the mesh-free pipeline")
    timed = {}
    for name, p in (("mesh", pipe), ("no mesh", free_pipe), ("no mesh", free_pipe),
                    ("mesh", pipe)):
        p.return_scores = False
        t = time.perf_counter()
        p.forward(params)
        sync("cuda")
        timed.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
    passes = {}
    for name, p in (("mesh", pipe), ("no mesh", free_pipe)):
        kernels = device_kernels(lambda: p.forward(params), 1)
        passes[name] = {"kernel_ms": sum(ms for ms, _ in kernels.values()),
                        "nccl_ms": sum(ms for k, (ms, _) in kernels.items() if "nccl" in k.lower()),
                        "launches": sum(n for _, n in kernels.values())}
    out["allscores"] = {"ms_per_batch": timed, "windows": n_step, "b5_launches": counts[
        "l1_distance_matrix"], "l1_at_path_shape": _hold_l1_at(calls, gen), "kernels": passes}
    say("mesh", f"(b) NCCL 1 rank allscores ({AS_QUERIES} queries x {AS_ENTITY} entities,"
        f" {n_step} windows of {AS_WINDOW}): scores, ranks, metrics and top-{K} equal to the"
        f" mesh-free pipeline bit for bit; {timed['mesh'][0]:.2f} / {timed['mesh'][1]:.2f} ms per"
        f" {AS_QUERIES}-query batch over the mesh, {timed['no mesh'][0]:.2f} /"
        f" {timed['no mesh'][1]:.2f} without (the pipeline end to end); kernels of a pass"
        f" {passes['mesh']['kernel_ms']:.2f} ms over the mesh (NCCL's"
        f" {passes['mesh']['nccl_ms']:.2f}), {passes['no mesh']['kernel_ms']:.2f} without; B5"
        f" {counts['l1_distance_matrix']} launches; {smi}")
    del params, got, want

    # (c) A ScoreMoving sparse step.
    sm, sm_free = _sm_module(wikikg2, "shard"), _sm_module(wikikg2, None)
    params = sm.score_fn.initial_params_device(device="cuda", generator=gen)
    params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
    sgd, row = optim.SGD(LR, momentum=MOMENTUM), optim.RowSGDM(LR, momentum=MOMENTUM,
                                                               interleaved=True)
    state = trainer.init_optimizer_state(sgd, params, mesh, row,
                                         n_logical=sm.sharding.max_entity_per_shard)
    other = (trainer._clone(params), trainer._clone(state))
    batch = sampler.sample_batch(next(sampler.epoch_index_blocks(True)))
    step = trainer.build_train_step(sm, sgd, mesh, row)
    reset_counts()
    census, calls = _l1_calls(lambda: collective_census(step, params, state, batch, mesh=mesh))
    counts = read_counts()
    expect_counts("mesh nccl ScoreMoving step", counts, {
        "l1_distance_matrix": 2 * BPS, "l1_distance_grads": 2 * BPS, "scatter_rows": 1})
    trainer.build_train_step(sm_free, sgd, None, row)(*other, batch)
    torch.cuda.synchronize()
    diff = [name for (name, g), (_, w) in zip(trainer._leaves({"p": params, "s": state}),
                                              trainer._leaves({"p": other[0], "s": other[1]}))
            if not torch.equal(g, w)]
    if diff:
        raise AssertionError(f"mesh nccl ScoreMoving step: {diff} differ from the mesh-free step")
    kinds = {k: len(census[k]) for k in ("all-to-all", "all-gather", "reduce-scatter",
                                          "all-reduce")}
    if kinds != {"all-to-all": 2 * BPS, "all-gather": 3 * BPS, "reduce-scatter": 2 * BPS,
                 "all-reduce": 1}:
        raise AssertionError(f"mesh nccl ScoreMoving step census {kinds}")
    out["sm_step"] = {"launches": {k: v for k, v in counts.items() if v}, "census": kinds,
                      "l1_at_path_shape": _hold_l1_at(calls, gen)}
    say("mesh", f"(c) NCCL 1 rank ScoreMoving sparse wikikg2 step: every array equal to the"
        f" mesh-free step bit for bit; census {kinds}; launches {out['sm_step']['launches']}")
    return out


def _conve_mesh_rank(n: int, card, host, device: str, on_card: bool) -> dict:
    """(d) ConvE with SyncBN at YAGO3-10 width over the gloo ranks: one
    dense host-fed step (FusedDenseAdamW, B10) and one sparse step (RowSGDM
    interleaved, B3), each against the same step on the CPU ranks in
    float64 within the dense gate (the dense reference runs plain AdamW on
    the table, the same update: B10's plain version takes fp32 and bf16
    only), with the CPU's float64 gradient of bn0's bias beside the largest
    (MESH_CONVE_NOISE); the running stats equal on every rank and (rank 0)
    to the EMA of the global positive batch."""
    rank = card.rank
    sharding = Sharding.create(YAGO_ENTITY, n, seed=SEED)
    rng = np.random.default_rng(SEED)
    triples = np.stack([rng.integers(YAGO_ENTITY, size=YAGO_TRIPLE),
                        rng.integers(YAGO_RELATION, size=YAGO_TRIPLE),
                        rng.integers(YAGO_ENTITY, size=YAGO_TRIPLE)], 1).astype(np.int32)

    def conve_fn():
        return ConvE(True, sharding, YAGO_RELATION, CONVE_EMB, CONVE_H, CONVE_W,
                     sync_batch_norm=True, seed=SEED)
    score_fn = conve_fn()
    module, pts = _conve_module(triples, sharding, score_fn, "shard")
    cpu_module = EmbeddingMovingBessKGE(module.negative_sampler, conve_fn(), module.loss_fn,
                                        axis_name="shard")
    sampler = RigidShardedBatchSampler(pts, module.negative_sampler, shard_bs=CONVE_SHARD_BS,
                                       batches_per_step=CONVE_BPS, seed=SEED)
    batch = sampler.sample_batch(next(iter(sampler.epoch_index_blocks(shuffle=True))))
    whole = score_fn.initial_params_device(device=device,
                                           generator=torch.Generator(device).manual_seed(SEED))
    out: Dict[str, object] = {}
    rows = sharding.max_entity_per_shard
    touched = _touched(batch, rank)
    for form in ("dense", "sparse"):
        params = shard_params(whole, card)
        if form == "dense":
            opt, ent = optim.AdamW(CONVE_LR), optim.FusedDenseAdamW(CONVE_LR, weight_decay=1e-4)
            cpu_ent = None  # AdamW's weight decay is 1e-4 too
        else:
            opt = optim.SGD(CONVE_LR, momentum=MOMENTUM)
            ent = cpu_ent = optim.RowSGDM(CONVE_LR, momentum=MOMENTUM, interleaved=True)
            params["entity_embedding"] = optim.interleave_momentum(params["entity_embedding"])
        state = trainer.init_optimizer_state(opt, params, card, ent, n_logical=n * rows)
        cpu = tuple(_tree_map(lambda v: v.to("cpu", torch.float64 if v.is_floating_point()
                                             else v.dtype, copy=True), t) for t in (params, state))
        if form == "dense":
            cpu = (cpu[0], trainer.init_optimizer_state(opt, cpu[0], host))
        step = trainer.build_train_step(module, opt, card, ent, device=device)
        reset_counts()
        t = time.perf_counter()
        params, state, o = step(params, state, batch, CONVE_RNG)
        sync(device)
        card_s = time.perf_counter() - t
        counts = read_counts()
        if on_card:
            expect_counts(f"mesh rank {rank} conve {form} step", counts,
                          {"dense_adamw_update": 1} if form == "dense" else {"scatter_rows": 1})
        cpu_params, cpu_state, cpu_o = trainer.build_train_step(
            cpu_module, opt, host, cpu_ent, device="cpu")(*cpu, batch, CONVE_RNG)
        loss, cpu_loss = float(o["loss"]), float(cpu_o["loss"])
        if not np.isfinite(loss) or abs(loss - cpu_loss) > DENSE_RTOL * abs(cpu_loss):
            raise AssertionError(f"mesh rank {rank} conve {form}: loss {loss}, CPU {cpu_loss}")
        if form == "dense":
            errs = _conve_hold_dense(f"mesh rank {rank} conve dense vs the CPU (float64)",
                                     (params, state), (cpu_params, cpu_state), 1,
                                     MESH_CONVE_NOISE)
            # The first step's mu is (1 - 0.9) g.
            grads = [{name: mom["mu"] / 0.1 for name, (_, mom) in _adam_params(*side).items()}
                     for side in ((params, state), (cpu_params, cpu_state))]
        else:
            errs = _conve_hold_sparse(f"mesh rank {rank} conve sparse vs the CPU (float64)",
                                      (params, state), (cpu_params, cpu_state), touched,
                                      MESH_CONVE_NOISE)
            # The first step's momentum trace is g.
            grads = [dict(trainer._leaves(side["other"]["trace"])) for side in (state, cpu_state)]
        # bn0's bias (MESH_CONVE_NOISE): one value summing a term per pixel
        # of every positive's input map over the ranks.
        bias = [g["bn0.bias"].double().cpu() for g in grads]
        norms = {name: g.abs().max().item() for name, g in grads[1].items()}
        top = max(norms, key=norms.get)
        bn0_bias = {"grad": norms["bn0.bias"], "largest": [top, norms[top]],
                    "card_rel_err": ((bias[0] - bias[1]).abs() / bias[1].abs()).max().item(),
                    "terms": int(batch["head"].size) * 2 * CONVE_H * CONVE_W}
        stats = {k: {f: params[k][f].cpu().numpy() for f in ("mean", "var")}
                 for k in ("bn0", "bn1", "bn2")}
        if rank == 0:  # the EMA of the global positive batch, from the global params
            head, rel = batch["head"], batch["relation"]
            h = torch.from_numpy(np.concatenate([s * rows + head[:, s].reshape(-1)
                                                 for s in range(n)]).astype(np.int64))
            r = torch.from_numpy(np.concatenate([rel[:, s].reshape(-1)
                                                 for s in range(n)]).astype(np.int64))
            ref = _conve_fn(sharding).update_bn_stats(
                whole, whole["entity_embedding"][h.to(device)], r.to(device), momentum=0.1)
            for k, fields in stats.items():
                for f, v in fields.items():
                    w = ref[k][f].cpu().numpy()
                    if not np.allclose(v, w, rtol=2e-4, atol=2e-5):
                        raise AssertionError(f"mesh conve {form}: {k} {f} off the global batch's"
                                             f" EMA by {np.abs(v - w).max()}")
        out[form] = {"loss": loss, "cpu_loss": cpu_loss, "card_s": card_s,
                     "report": _conve_gate_report(errs),
                     "max_abs_err": max(e for e, _ in errs.values()),
                     "max_gate_ratio": max(r_ for _, r_ in errs.values()),
                     "launches": {k: v for k, v in counts.items() if v}, "bn": stats,
                     "bn0_bias": bn0_bias}
        del cpu, cpu_params, cpu_state
    return out


def _mesh_rank_rest(card, host, device: str, wikikg2: tuple, out: dict) -> None:
    """The rest of the mesh on a gloo rank sharing the card: (a) ScoreMoving
    validation through run_device_eval against a full-table reference, (b)
    the all-scores pipeline (the mesh-free pipeline over the same global
    params on rank 0), (c) a ScoreMoving sparse wikikg2 step against the CPU
    ranks (``wikikg2``: the rank's wikikg2 module over the card, the same
    over the CPU ranks, and their sampler), (d) ConvE with SyncBN. Each
    part's results go into ``out``."""
    n, rank = card.n_shard, card.rank
    on_card = device == "cuda"
    gen = torch.Generator(device)

    # (a) Validation.
    t0 = time.perf_counter()
    triples, cands, sharding, module, sampler_v, _, _ = _valid_setup(n)
    params = module.score_fn.initial_params_device(card, generator=gen.manual_seed(SEED))
    reset_counts()
    t = time.perf_counter()
    metrics, n_q = run_device_eval(module, params, sampler_v, card, steps_per_block=VALID_SPB)
    host_qps = n_q / (time.perf_counter() - t)
    if on_card:
        expect_counts(f"mesh rank {rank} valid", read_counts(), {})
    blocks, _ = _valid_blocks(sampler_v, card, device)
    qps = _blocks_rate(make_block_runner(module, card, device=device), params, blocks, n_q,
                       device)
    del blocks
    valid = {"metrics": metrics, "n_queries": n_q, "host_queries_per_s": host_qps,
             "queries_per_s": qps, "setup_s": t - t0}
    whole = module.score_fn.initial_params_device(device=device, generator=gen.manual_seed(SEED))
    if rank == 0:
        valid["no_mesh"] = _valid_one_shard(whole, sharding, device)
        _hold_valid("mesh valid", metrics, valid["no_mesh"])
    # Half the answers planted (each even query's tail row its head row plus
    # the relation row, on the global table): a true score put at another
    # query's row moves the ranks of both.
    table, rel = whole["entity_embedding"], whole["relation_embedding"]
    row = _global_rows(sharding, table.device)
    tri = torch.from_numpy(triples[::2].astype(np.int64)).to(table.device)
    table[row[tri[:, 2]]] = table[row[tri[:, 0]]] + rel[tri[:, 1]]
    planted, _ = run_device_eval(module, shard_params(whole, card), sampler_v, card,
                                 steps_per_block=VALID_SPB)
    if not min(planted.values()) >= 0.5:
        raise AssertionError(f"mesh valid: half the answers planted give {planted}")
    if rank == 0:
        valid["planted_no_mesh"] = _valid_one_shard(whole, sharding, device)
        _hold_valid("mesh valid, half the answers planted", planted, valid["planted_no_mesh"])
    valid["planted"] = planted
    out["valid"] = valid
    del params, whole, table

    # (b) The all-scores pipeline: every rank's dict; rank 0 runs the
    # mesh-free pipeline on the same global params.
    triples, sharding, score_fn, pts, sampler_as, _ = _as_setup(n, MESH_AS_BPS)
    params = score_fn.initial_params_device(card, generator=gen.manual_seed(SEED))
    pipe = _as_pipeline(sampler_as, score_fn, card, device)
    n_step = pipe.bess_module.n_step
    n_batches = sum(1 for _ in sampler_as.epoch_index_blocks(False))
    reset_counts()
    t = time.perf_counter()
    got, calls = _l1_calls(lambda: pipe.forward(params), ("l1_distance_matrix",))
    sync(device)
    first_s = time.perf_counter() - t
    counts = read_counts()
    if on_card:
        expect_counts(f"mesh rank {rank} allscores", counts,
                      {"l1_distance_matrix": n_step * MESH_AS_BPS * n_batches})
        out["as_l1_at_path_shape"] = _hold_l1_at(calls, gen.manual_seed(SEED + rank))
    t = time.perf_counter()
    pipe.forward(params)
    sync(device)
    allscores = {"ms_per_batch": [first_s * 1e3 / n_batches,
                                  (time.perf_counter() - t) * 1e3 / n_batches],
                 "windows": n_step, "batches": n_batches, "rows_per_block":
                 sharding.max_entity_per_shard, "b5_launches": counts["l1_distance_matrix"],
                 "out": got}
    if rank == 0:
        whole = score_fn.initial_params_device(device=device, generator=gen.manual_seed(SEED))
        _, one_sh, one_fn, one_pts, one_sampler, _ = _as_setup(1, AS_BPS)
        # The same global table in the one-shard order.
        rows = _global_rows(sharding, device)
        flat = torch.zeros((one_sh.max_entity_per_shard, DIM), device=device)
        flat[torch.from_numpy(one_sh.entity_to_idx.astype(np.int64)).to(device)] = whole[
            "entity_embedding"][rows]
        want = _as_pipeline(one_sampler, one_fn, None, device).forward(
            {"entity_embedding": flat, "relation_embedding": whole["relation_embedding"]})
        allscores["ties"] = _hold_as_ties(_by_query(got, pts), _by_query(want, one_pts), whole,
                                          sharding, triples)
        allscores["metrics_avg"] = got["metrics_avg"]
        allscores["no_mesh_metrics_avg"] = want["metrics_avg"]
        del whole, flat
    out["allscores"] = allscores
    del params

    # (c) A ScoreMoving sparse wikikg2 step against the CPU ranks.
    module, cpu_module, sampler = wikikg2
    score_fn = module.score_fn
    sm, cpu_sm = _sm_module(module), _sm_module(cpu_module)
    params = score_fn.initial_params_device(card, generator=gen.manual_seed(SEED))
    sgd, row = optim.SGD(LR, momentum=MOMENTUM), optim.RowSGDM(LR, momentum=MOMENTUM,
                                                               interleaved=True)
    rows = module.sharding.max_entity_per_shard
    params["entity_embedding"] = row.widen_table(params["entity_embedding"])
    state = trainer.init_optimizer_state(sgd, params, card, row, n_logical=n * rows)
    cpu = (_to(params, "cpu"), _to(state, "cpu"))
    step = trainer.build_train_step(sm, sgd, card, row, device=device)
    blocks = sampler.epoch_index_blocks(True)
    batch = sampler.sample_batch(next(blocks))
    reset_counts()
    census, l1_calls = _l1_calls(lambda: collective_census(step, params, state, batch, mesh=card))
    sync(device)
    counts = read_counts()
    if on_card:
        expect_counts(f"mesh rank {rank} ScoreMoving step", counts, {
            "l1_distance_matrix": 2 * BPS, "l1_distance_grads": 2 * BPS, "scatter_rows": 1})
        out["sm_l1_at_path_shape"] = _hold_l1_at(l1_calls, gen.manual_seed(SEED + rank))
    kinds = {k: len(census[k]) for k in ("all-to-all", "all-gather", "reduce-scatter",
                                          "all-reduce")}
    if kinds != {"all-to-all": 2 * BPS, "all-gather": 3 * BPS, "reduce-scatter": 2 * BPS,
                 "all-reduce": 1}:
        raise AssertionError(f"mesh rank {rank} ScoreMoving step census {kinds}")
    trainer.build_train_step(cpu_sm, sgd, host, row, device="cpu")(*cpu, batch)
    errs = _mesh_gate(f"mesh rank {rank} ScoreMoving step vs the CPU", (params, state), cpu,
                      _touched(batch, rank), BF16_STEP_RTOL)
    del cpu
    timed = [sampler.sample_batch(next(blocks)) for _ in range(MESH_TIMED_STEPS)]
    sync(device)
    t = time.perf_counter()
    for b in timed:
        step(params, state, b)
    sync(device)
    out["sm_step"] = {"vs_cpu": errs, "census": kinds, "launches": {
        k: v for k, v in counts.items() if v},
        "ms_per_step": (time.perf_counter() - t) / len(timed) * 1e3}
    del params, state

    # (d) ConvE with SyncBN.
    out["conve"] = _conve_mesh_rank(n, card, host, device, on_card)
    out["rest_s"] = time.perf_counter() - t0


#: The constants a rank of the mesh phase reads, passed from the parent (so
#: that a shrunk CPU rehearsal shrinks its ranks too).
_MESH_CONFIG = ("N_ENTITY", "N_RELATION", "DIM", "N_TRIPLE", "SHARD_BS_TRAIN", "BPS", "N_NEGATIVE",
                "MESH_RANKS", "MESH_QUERIES", "MESH_TOPK_REPEATS", "MESH_TIMED_STEPS",
                "MESH_FIT_TRIPLES", "N_REFERENCE", "VALID_QUERIES", "VALID_CANDIDATES",
                "VALID_SHARD_BS", "VALID_BPS", "VALID_SPB", "AS_ENTITY", "AS_QUERIES",
                "AS_SHARD_BS", "AS_BPS", "AS_WINDOW", "MESH_AS_BPS", "YAGO_ENTITY", "YAGO_TRIPLE",
                "CONVE_SHARD_BS", "CONVE_BPS")


def _mesh_rank(tmp: str, config: dict, device: str) -> dict:
    """One of MESH_RANKS ranks sharing the card over gloo, at full wikikg2
    width: one host-fed step held against the same step on CPU gloo ranks
    from copies of one state, timed steps, top-k against all entities held
    against a full-table reference, Trainer.fit, and a sharded checkpoint
    saved and loaded back bit for bit. ``device`` "cpu" rehearses it with
    the plain versions and without the launch gates."""
    globals().update(config)
    n = MESH_RANKS
    rank = torch.distributed.get_rank()
    on_card = device == "cuda"
    card = make_shard_mesh(n, devices=[device] * n, backend="gloo")
    host = make_shard_mesh(n, devices=["cpu"] * n, backend="gloo")
    out: Dict[str, object] = {"rank": rank}

    triples, score_fn, module, sampler, pts = _mesh_module(n)
    *_, cpu_module, _, _ = _mesh_module(n)
    # The rank's block of the initial tables, drawn on the card: the rows of
    # the one-process draw of the global table.
    params = score_fn.initial_params_device(card, generator=torch.Generator(device).manual_seed(SEED))
    whole = score_fn.initial_params_device(device=device,
                                           generator=torch.Generator(device).manual_seed(SEED))
    rows = out["rows_per_block"] = module.sharding.max_entity_per_shard
    if not (torch.equal(params["entity_embedding"],
                        whole["entity_embedding"][rank * rows:(rank + 1) * rows])
            and torch.equal(params["relation_embedding"], whole["relation_embedding"])):
        raise AssertionError(f"rank {rank}: its initial block is not the global draw's")

    # Top-k against all entities over the 4 blocks (B7 chunk merge).
    rng = np.random.default_rng(SEED)
    heads = rng.integers(N_ENTITY, size=MESH_QUERIES).astype(np.int32)
    rels = rng.integers(N_RELATION, size=MESH_QUERIES).astype(np.int32)
    dataset = KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                        triples={"test": np.zeros((1, 3), np.int32)},
                        original_triple_ids={"test": np.arange(1)})
    qpts = PartitionedTripleSet.create_from_queries(dataset, module.sharding,
                                                    np.stack([heads, rels], 1), "hr")
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=SEED)
    qsampler = RigidShardedBatchSampler(qpts, ns, shard_bs=MESH_QUERIES // n, batches_per_step=1,
                                        seed=SEED)
    qbatches = [qsampler.sample_batch(b) for b in qsampler.epoch_index_blocks(shuffle=False)]
    # fp32 scoring, as the serving phase serves.
    topk = TopKQueryBessKGE(k=K, candidate_sampler=ns, return_scores=True, axis_name="shard",
                            score_fn=TransE(True, 1, module.sharding, N_RELATION, DIM, seed=SEED))
    fwd = build_topk_forward(topk, card)
    reset_counts()
    census = collective_census(fwd, params, qbatches[0], mesh=card)
    sync(device)
    topk_counts = read_counts()
    windows = -(-rows // topk.window_size)
    if on_card:
        expect_counts(f"mesh rank {rank} top-k batch", topk_counts, {"l1_scores_chunkmax": windows})
    if (len(census["all-gather"]), len(census["all-to-all"]), len(census["all-reduce"])) != (2, 2, 0):
        raise AssertionError(f"rank {rank}: top-k census {census}")
    got = fwd(params, qbatches[0])
    # The full-table reference of the rank's first N_REFERENCE queries.
    table, rel = whole["entity_embedding"], whole["relation_embedding"]
    h = torch.from_numpy(rank * rows + qbatches[0]["head"][0, rank, :N_REFERENCE].astype(np.int64))
    r = torch.from_numpy(qbatches[0]["relation"][0, rank, :N_REFERENCE].astype(np.int64))
    ref = -l1_kernels.l1_distance_matrix_plain(table[h.to(device)] + rel[r.to(device)], table)
    real = torch.from_numpy((np.arange(rows)[None, :] < module.sharding.shard_counts[:, None])
                            .reshape(-1)).to(device)
    ref = torch.where(real, ref, torch.full_like(ref, -float("inf")))
    ref_top, ref_pos = torch.topk(ref, K + 1, dim=1)
    s2e = torch.from_numpy(module.sharding.shard_and_idx_to_entity.reshape(-1)).to(device)
    ref_ids = s2e[ref_pos[:, :K]].long()
    del ref
    ids = got["topk_global_id"][0, 0, :N_REFERENCE].long()
    scores = got["topk_scores"][0, 0, :N_REFERENCE]
    torch.testing.assert_close(scores, ref_top[:, :K], rtol=RTOL, atol=ATOL)
    sure = (ref_top[:, K - 1] - ref_top[:, K]) > ATOL
    if not (ids.sort(1).values == ref_ids.sort(1).values).all(1)[sure].all():
        raise AssertionError(f"rank {rank}: top-{K} IDs differ from the full-table reference")
    sync(device)
    t = time.perf_counter()
    for b in qbatches * MESH_TOPK_REPEATS:
        fwd(params, b)
    sync(device)
    out["topk"] = {"ms_per_batch": (time.perf_counter() - t) / (len(qbatches) * MESH_TOPK_REPEATS)
                   * 1e3, "launches_per_batch": topk_counts, "census": {
                       k: len(census[k]) for k in ("all-gather", "all-to-all", "all-reduce")},
                   "sure": int(sure.sum()), "window": topk.window_size}

    # One host-fed step on the card against the same step on the CPU.
    sgd, row = optim.SGD(LR, momentum=MOMENTUM), optim.RowSGDM(LR, momentum=MOMENTUM,
                                                               interleaved=True)
    params["entity_embedding"] = row.widen_table(params["entity_embedding"])
    state = trainer.init_optimizer_state(sgd, params, card, row, n_logical=n * rows)
    cpu = (_to(params, "cpu"), _to(state, "cpu"))
    step = trainer.build_train_step(module, sgd, card, row, device=device)
    cpu_step = trainer.build_train_step(cpu_module, sgd, host, row, device="cpu")
    blocks = sampler.epoch_index_blocks(True)
    batch = sampler.sample_batch(next(blocks))
    reset_counts()
    census, l1_calls = _l1_calls(lambda: collective_census(step, params, state, batch, mesh=card))
    sync(device)
    step_counts = read_counts()
    if on_card:
        expect_counts(f"mesh rank {rank} step", step_counts, {
            "l1_distance_matrix": 2 * BPS, "l1_distance_grads": 2 * BPS, "scatter_rows": 1})
        # B5 and B6 at the shapes this step gave them, after its counts.
        out["l1_at_path_shape"] = _hold_l1_at(
            l1_calls, torch.Generator(device).manual_seed(SEED + rank))
    ppp = SHARD_BS_TRAIN // n
    payload = n * (ppp + 2 * N_NEGATIVE) * DIM * 2  # bf16 rows
    if (census["all-to-all"] != [payload] * (2 * BPS) or census["all-gather"]
            or len(census["all-reduce"]) != 1 or census["all-reduce"][0] >= rows * DIM * 4):
        raise AssertionError(f"rank {rank}: step census {census}")
    t = time.perf_counter()
    cpu_step(*cpu, batch)
    cpu_s = time.perf_counter() - t
    errs = _mesh_gate(f"mesh rank {rank} step vs the CPU", (params, state), cpu,
                      _touched(batch, rank), BF16_STEP_RTOL)
    out["step"] = {"vs_cpu": errs, "cpu_s": cpu_s, "launches": step_counts, "census": {
        "all-to-all": len(census["all-to-all"]), "all_to_all_bytes": payload,
        "all-gather": 0, "all-reduce": 1, "all_reduce_bytes": census["all-reduce"][0]}}
    del cpu
    batches = [sampler.sample_batch(next(blocks)) for _ in range(MESH_TIMED_STEPS)]
    ms = []
    for _ in range(2):
        sync(device)
        t = time.perf_counter()
        for b in batches:
            _, _, o = step(params, state, b)
        sync(device)
        ms.append((time.perf_counter() - t) / len(batches) * 1e3)
    out["step"]["ms_per_step"] = ms
    out["step"]["loss"] = float(o["loss"])

    # A device-sampled call over the gloo mesh: it runs uncaptured, as the
    # step says; each rank draws the global batch and keeps its column.
    dev = DeviceBatchSampler(pts, module.negative_sampler, shard_bs=SHARD_BS_TRAIN,
                             batches_per_step=BPS, seed=SEED, positive_mode="runs")
    dev_state = dev.state(device)
    call = trainer.build_device_train_step(module, sgd, dev, card, row, device=device)
    if on_card and (call._graph is not None or not call.uncaptured):
        raise AssertionError(f"rank {rank}: a gloo call must run uncaptured and say so")
    _, _, o = call(params, state, dev_state, dev.next_key(0))
    sync(device)
    t = time.perf_counter()
    for i in range(MESH_TIMED_STEPS):
        _, _, o = call(params, state, dev_state, dev.next_key(1 + i))
    sync(device)
    if not np.isfinite(float(o["loss"])):
        raise AssertionError(f"rank {rank}: device-sampled call loss {float(o['loss'])}")
    out["device_call"] = {"uncaptured": call.uncaptured, "graph": call._graph is not None,
                          "ms_per_step": (time.perf_counter() - t) / MESH_TIMED_STEPS * 1e3}

    # Trainer.fit over a few steps, saved sharded and loaded back.
    fit_module, fit_sampler, _ = _training_setup(triples[:MESH_FIT_TRIPLES], module.sharding,
                                                 score_fn, "shard")
    fit = trainer.Trainer(fit_module, fit_sampler, sgd, card, params=shard_params(whole, card),
                          entity_optimizer=row)
    del whole
    summary = fit.fit(n_epochs=1, log_every=1)
    out["fit"] = {"steps": summary["steps"], "losses": [r["loss"] for r in fit.history],
                  "relation": fit.params["relation_embedding"].cpu().numpy()}
    path = Path(tmp) / "mesh_ckpt"
    t = time.perf_counter()
    fit.save(str(path), step=summary["steps"], sharded=True)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    lp, ls, lsh, meta = checkpoint.load_checkpoint_sharded(path, card, like=fit.opt_state)
    load_s = time.perf_counter() - t
    if lsh.n_shard != n or meta["step"] != summary["steps"]:
        raise AssertionError(f"rank {rank}: checkpoint {meta}, {lsh.n_shard} shards")
    same = _same_tree(f"mesh rank {rank} checkpoint", {"p": lp, "s": ls},
                      {"p": trainer._tree_map(lambda v: v.cpu(), fit.params),
                       "s": trainer._tree_map(lambda v: v.cpu(), fit.opt_state)})
    out["checkpoint"] = {"arrays_equal": same, "save_s": save_s, "load_s": load_s}
    del fit, lp, ls, params, state
    if on_card:
        torch.cuda.empty_cache()
    _mesh_rank_rest(card, host, device, (module, cpu_module, sampler), out)
    return out


def mesh_phase(gen: torch.Generator, smi: str = "", device: str = "cuda",
               profile: bool = False) -> dict:
    """The BESS scheme over a mesh of ranks on the one card: the NCCL path
    at one rank (captured in the call's CUDA graph), and MESH_RANKS ranks
    sharing the card over gloo at full wikikg2 width. No time here measures
    NCCL across cards. ``device`` "cpu" rehearses the gloo ranks (with the
    constants of this module, shrunk) and leaves out the NCCL rank;
    ``profile`` traces two calls of the NCCL rank and of the mesh-free
    call."""
    t0 = time.perf_counter()
    nccl = None
    with tempfile.TemporaryDirectory() as tmp:
        if device == "cuda":
            nccl = _mesh_nccl(gen, Path(tmp), smi, profile)
            say("mesh", f"NCCL 1 rank done ({time.perf_counter() - t0:.1f}s)")
        t = time.perf_counter()
        config = {name: globals()[name] for name in _MESH_CONFIG}
        ranks = _spawn(_mesh_rank, MESH_RANKS, (tmp, config, device), backend="gloo",
                       timeout=MESH_TIMEOUT_S)
        say("mesh", f"{MESH_RANKS} gloo ranks sharing the card done"
            f" ({time.perf_counter() - t:.1f}s, processes included)")
    rel = ranks[0]["fit"]["relation"]
    if not all(np.array_equal(r["fit"]["relation"], rel) and
               r["fit"]["losses"] == ranks[0]["fit"]["losses"] for r in ranks):
        raise AssertionError("mesh Trainer.fit: the replicated params differ between ranks")
    if not all(np.isfinite(ranks[0]["fit"]["losses"])) or ranks[0]["fit"]["steps"] < 1:
        raise AssertionError(f"mesh Trainer.fit: {ranks[0]['fit']}")
    for r in ranks:
        say("mesh", f"gloo rank {r['rank']} of {MESH_RANKS} on one card ({smi}): step vs the CPU"
            f" ranks max|err| {max(r['step']['vs_cpu'].values()):.3g} (sparse gate), CPU step"
            f" {r['step']['cpu_s']:.1f}s; {r['step']['ms_per_step'][0]:.2f} /"
            f" {r['step']['ms_per_step'][1]:.2f} ms per host-fed step; top-{K} of"
            f" {MESH_QUERIES} queries over {N_ENTITY} entities {r['topk']['ms_per_batch']:.2f} ms"
            f" per batch, {r['topk']['sure']} of {N_REFERENCE} held to the full-table reference;"
            f" checkpoint round trip bit for bit ({r['checkpoint']['arrays_equal']} arrays,"
            f" save {r['checkpoint']['save_s']:.1f}s, load {r['checkpoint']['load_s']:.1f}s)")
    if device == "cuda":
        for where, held in (("NCCL 1 rank", nccl["l1_at_path_shape"]),
                            (f"gloo rank 0 of {MESH_RANKS}", ranks[0]["l1_at_path_shape"])):
            say("mesh", f"{where}: B5 at {held['l1_distance_matrix']['shapes']} max|err|"
                f" {held['l1_distance_matrix']['max_abs_err']:.3g}, B6 at"
                f" {held['l1_distance_grads']['shapes']} max|err|"
                f" {held['l1_distance_grads']['max_abs_err']:.3g}, against their plain versions"
                " (ties planted), at the shapes the step gave them")
    say("mesh", f"gloo device-sampled call (steps_per_call 1): a CUDA graph:"
        f" {ranks[0]['device_call']['graph']}, uncaptured: {ranks[0]['device_call']['uncaptured']};"
        f" {', '.join(format(r['device_call']['ms_per_step'], '.2f') for r in ranks)} ms per step"
        f" by rank ({smi}, gloo on one card)")
    say("mesh", f"Trainer.fit over {ranks[0]['fit']['steps']} steps: loss"
        f" {ranks[0]['fit']['losses'][0]:.3f} -> {ranks[0]['fit']['losses'][-1]:.3f}, replicated"
        f" params equal bit for bit on every rank; per-rank census of a step"
        f" {ranks[0]['step']['census']}, of a top-k batch {ranks[0]['topk']['census']}"
        f" ({time.perf_counter() - t0:.1f}s)")
    _mesh_rest_report(nccl, ranks, smi)
    say("mesh", f"phase done ({time.perf_counter() - t0:.1f}s)")
    for r in ranks:
        del r["fit"]["relation"]
    return {"nccl_1_rank": nccl, "gloo_ranks": ranks}


def _mesh_rest_report(nccl: dict, ranks: list, smi: str) -> None:
    """The gloo ranks' rest of the mesh held across ranks (the metrics, the
    pipeline's dict and ConvE's running stats equal on every rank), and
    printed."""
    r0 = ranks[0]
    for r in ranks[1:]:
        if r["valid"]["metrics"] != r0["valid"]["metrics"]:
            raise AssertionError("mesh valid: the metrics differ between ranks")
        a, b = r["allscores"]["out"], r0["allscores"]["out"]
        if a.keys() != b.keys() or any(
                not np.array_equal(a[k], b[k]) for k in ("ranks", "topk_global_id", "triple_idx")):
            raise AssertionError("mesh allscores: the ranks return different dicts")
        if any(not np.array_equal(a["metrics"][k], b["metrics"][k]) for k in b["metrics"]):
            raise AssertionError("mesh allscores: the ranks return different metrics")
        for form in ("dense", "sparse"):
            for k, fields in r["conve"][form]["bn"].items():
                for f, v in fields.items():
                    if not np.array_equal(v, r0["conve"][form]["bn"][k][f]):
                        raise AssertionError(f"mesh conve {form}: {k} {f} differ between ranks")
    for r in ranks[1:]:
        if r["valid"]["planted"] != r0["valid"]["planted"]:
            raise AssertionError("mesh valid: the planted metrics differ between ranks")
    v = r0["valid"]
    say("mesh", f"(a) {MESH_RANKS} gloo ranks valid: metrics {v['metrics']} on every rank over"
        f" {v['n_queries']} queries, the mesh-free pass on the same global table"
        f" {v['no_mesh']} (held within {VALID_SUM_ULPS} fp32 ulps); half the answers planted:"
        f" {v['planted']} on every rank, {v['planted_no_mesh']} without a mesh;"
        f" {', '.join(format(r['valid']['queries_per_s'], '.4g') for r in ranks)} queries/s by"
        f" rank (blocks staged), {', '.join(format(r['valid']['host_queries_per_s'], '.4g') for r in ranks)}"
        f" through run_device_eval; {smi}")
    a = r0["allscores"]
    say("mesh", f"(b) {MESH_RANKS} gloo ranks allscores ({a['rows_per_block']} rows per rank,"
        f" {a['windows']} windows of {AS_WINDOW}, {a['batches']} batch of {MESH_AS_BPS} x"
        f" {AS_SHARD_BS} a rank): every rank returns the same dict; against the mesh-free"
        f" pipeline on the same global params: MRR {a['metrics_avg']['mrr']:.6f} vs"
        f" {a['no_mesh_metrics_avg']['mrr']:.6f}, {a['ties']['rank_ties']} ranks and"
        f" {a['ties']['topk_ties']} top-{K} sets differ, each by ties within 2^-7;"
        f" {', '.join(format(r['allscores']['ms_per_batch'][1], '.1f') for r in ranks)} ms per"
        f" {AS_QUERIES}-query batch by rank (first pass {a['ms_per_batch'][0]:.1f}); {smi}")
    say("mesh", f"(c) {MESH_RANKS} gloo ranks ScoreMoving sparse step vs the CPU ranks max|err| "
        + ", ".join(format(max(r["sm_step"]["vs_cpu"].values()), ".3g") for r in ranks)
        + f" (sparse gate); census {r0['sm_step']['census']}; "
        + ", ".join(format(r["sm_step"]["ms_per_step"], ".1f") for r in ranks)
        + f" ms per host-fed step by rank; launches {r0['sm_step']['launches']}; {smi}")
    for form in ("dense", "sparse"):
        c = r0["conve"][form]
        say("mesh", f"(d) {MESH_RANKS} gloo ranks ConvE SyncBN {form} step: vs the CPU ranks"
            f" (float64) loss {c['loss']:.6f} vs {c['cpu_loss']:.6f}, max|err| "
            + ", ".join(format(r["conve"][form]["max_abs_err"], ".3g") for r in ranks)
            + " by rank (gate ratios "
            + ", ".join(format(r["conve"][form]["max_gate_ratio"], ".3f") for r in ranks)
            + f"); rank 0 {c['report']}; bn0.bias: the CPU's float64 |g| "
            + ", ".join(format(r["conve"][form]["bn0_bias"]["grad"], ".4g") for r in ranks)
            + " by rank (the largest max|g| "
            + ", ".join(f"{r['conve'][form]['bn0_bias']['largest'][0]}"
                        f" {r['conve'][form]['bn0_bias']['largest'][1]:.4g}" for r in ranks)
            + "), the card's relative error "
            + ", ".join(format(r["conve"][form]["bn0_bias"]["card_rel_err"], ".3g")
                        for r in ranks)
            + f" over {c['bn0_bias']['terms']} terms (sqrt(terms) x 2^-24"
            f" {c['bn0_bias']['terms'] ** 0.5 * U32:.3g}); running stats equal on every rank and"
            " to the global batch's EMA; launches"
            f" {c['launches']}; {', '.join(format(r['conve'][form]['card_s'], '.2f') for r in ranks)}"
            f" s per step by rank; {smi}")
    if nccl is not None:
        for where, held in (("NCCL 1 rank allscores", nccl["rest"]["allscores"]["l1_at_path_shape"]),
                            ("NCCL 1 rank ScoreMoving step",
                             nccl["rest"]["sm_step"]["l1_at_path_shape"]),
                            ("gloo rank 0 allscores", r0["as_l1_at_path_shape"]),
                            ("gloo rank 0 ScoreMoving step", r0["sm_l1_at_path_shape"])):
            say("mesh", f"{where}: " + "; ".join(
                f"{name} at {h['shapes']} max|err| {h['max_abs_err']:.3g}"
                for name, h in held.items() if h["shapes"]) + " against the plain versions")
    say("mesh", "rest of the mesh by rank: " + ", ".join(
        format(r["rest_s"], ".1f") for r in ranks) + " s")


def hold_bench_lines(lines: list, step_rates: Dict[str, float]) -> Dict[str, dict]:
    """``bench_torch.py``'s JSON lines, by name, held to the contract: one
    line per name of :data:`BENCH_METRICS` with its metric; a finite positive
    value; the census contract true; each training line's device busy share,
    MFU and HBM share in (0, 100] and its rate within :data:`BENCH_RATIO` of
    ``step_rates`` (positive triples/s of the same configuration's
    device-sampled step measured in this run). The overlap line at one rank
    holds no collective time (NCCL runs no collective kernel in a one-rank
    group), so its value must be 0 there and positive over several ranks."""
    by_metric = {line.get("metric"): line for line in lines}
    out = {}
    for name, metric in BENCH_METRICS.items():
        if metric not in by_metric:
            raise AssertionError(f"bench_torch.py printed no {metric} line ({name})")
        line = out[name] = by_metric[metric]
        value = line.get("value")
        if not isinstance(value, (int, float)) or not np.isfinite(value):
            raise AssertionError(f"bench {name}: value {value!r}")
        if name == "overlap" and line.get("ranks") == 1:
            if value != 0.0 or line.get("collective_pct_of_busy") != 0.0:
                raise AssertionError(f"bench overlap at one rank: {line}")
        elif value <= 0:
            raise AssertionError(f"bench {name}: value {value!r}")
        if name == "census" and line.get("contract_ok") is not True:
            raise AssertionError(f"bench census: {line}")
        if name in step_rates:
            for key in ("device_busy_pct", "mfu_bf16_pct", "hbm_bw_pct"):
                pct = line.get(key)
                if not isinstance(pct, (int, float)) or not 0 < pct <= 100:
                    raise AssertionError(f"bench {name}: {key} {pct!r}")
            line["vs_device_phase"] = value / step_rates[name]
            if not BENCH_RATIO[0] <= line["vs_device_phase"] <= BENCH_RATIO[1]:
                raise AssertionError(f"bench {name}: {value} triples/s is {line['vs_device_phase']:.3f}"
                                     f"x this run's {step_rates[name]:.1f}")
    if len(lines) != len(BENCH_METRICS):
        raise AssertionError(f"bench_torch.py printed {len(lines)} lines, not {len(BENCH_METRICS)}")
    return out


def _bench_launches(name: str, **kw) -> dict:
    """The port's kernels that one device-sampled call of ``bench_torch.py``'s
    ``name`` set-up launches: by wrapper over the first call (the eager
    warm-up and the capture), by name over a replay (profiler)."""
    s = bench_torch._setup_wikikg2(**kw)
    dev, step, spc = s["dev"], s["dstep"], bench_torch.CONFIGS[name]["steps_per_call"]
    st = dev.state("cuda")
    held = (s["params"], s["opt_state"])
    reset_counts()
    step(*held, st, dev.next_key(0))
    torch.cuda.synchronize()
    first = read_counts()
    expect_counts(f"bench {name} first call", first, {
        "l1_distance_matrix_batched": 2 * 2 * spc, "l1_distance_grads_batched": 2 * 2 * spc,
        "scatter_rows": 2 * spc})
    kernels = device_kernels(lambda: step(*held, st, dev.next_key(1)), 1)
    per_call = {k: sum(n for key, (_, n) in kernels.items() if k in key) for k in (
        "l1_distance_small_kernel", "l1_grads_kernel", "scatter_rows_kernel",
        "fused_pair_sgdm_kernel", "gather_rows_kernel", "scatter_rows_multi_kernel")}
    want = {"l1_distance_small_kernel": 2 * spc, "l1_grads_kernel": 2 * spc,
            "scatter_rows_kernel": spc, "fused_pair_sgdm_kernel": 0, "gather_rows_kernel": 0,
            "scatter_rows_multi_kernel": 0}
    if per_call != want:
        raise AssertionError(f"bench {name} replay: kernels {per_call}, expected {want}")
    return {"first_call_wrapper_launches": {k: v for k, v in first.items() if v},
            "per_call_by_name": per_call, "steps_per_call": spc}


def bench_phase(smi: str, device_run: dict, packed_run: dict) -> dict:
    """``python3 bench_torch.py`` with every name and its default step
    counts, in a subprocess; its lines held by :func:`hold_bench_lines`
    against this run's device-sampled steps; then the kernels that one
    device-sampled call of its wikikg2 and wikikg2_bf16 set-ups launches."""
    t = time.perf_counter()
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, "-u", str(Path(__file__).resolve().parent / "bench_torch.py")],
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    if res.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {res.returncode}:\n{res.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    wiki, bio = SHARD_BS_TRAIN * BPS, DENSE_SHARD_BS * DENSE_BPS
    steps = {"biokg": (bio, device_run["biokg_adamw"]["ms_per_step"]),
             "wikikg2": (wiki, device_run["wikikg2"]["ms_per_step"]),
             **{name: (wiki, packed_run[name]["ms_per_step"]) for name in PACKED}}
    rates = {name: n / float(np.mean(ms)) * 1e3 for name, (n, ms) in steps.items()}
    held = hold_bench_lines(lines, rates)
    wall_s = time.perf_counter() - t
    for name, line in held.items():
        extra = (f", {line['vs_device_phase']:.4f}x the {rates[name]:.1f} of this run's"
                 f" {'device' if name in ('wikikg2', 'biokg') else 'packed'} phase, busy"
                 f" {line['device_busy_pct']} %, MFU {line['mfu_bf16_pct']} %, HBM"
                 f" {line['hbm_bw_pct']} %" if name in rates else "")
        say("bench", f"{name} ({smi}): {line['value']} {line['unit']}{extra}")
    torch.cuda.empty_cache()
    launches = {}
    for name, kw in (("wikikg2", {}), ("wikikg2_bf16", {"bf16_table": True})):
        launches[name] = _bench_launches(name, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        say("bench", f"{name} device-sampled call: first call {launches[name]['first_call_wrapper_launches']}"
            f" by wrapper, a replay {launches[name]['per_call_by_name']} by name")
    say("bench", f"bench_torch.py and its checks in {wall_s:.1f}s (the run), "
        f"{time.perf_counter() - t:.1f}s in all")
    return {"lines": held, "launches": launches, "wall_s": wall_s}


def profile_steps(step, params, state, batches, trace: str) -> dict:
    """Device time by kernel and the device's busy share over a few host-fed
    steps (``torch.profiler``); the trace goes to chiprun_out/."""
    def run():
        p, st = params, state
        for b in batches:
            p, st, _ = step(p, st, b)

    return profile_run(run, len(batches), trace)


def profile_run(run, n_steps: int, trace: str) -> dict:
    """Device time by kernel (per step, over ``n_steps`` steps) and the
    device's busy share while ``run()`` runs, from ``torch.profiler``; the
    trace goes to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Kernels only: an op's device time is its kernels' time again.
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / trace))
    # Busy: the union of the device events' intervals, so that kernels that
    # overlap (streams, graph branches) count once.
    with open(out / trace) as f:
        busy_ms = monitor.device_busy_us(json.load(f)["traceEvents"]) / 1e3
    say("profile", f"{n_steps} steps: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms"
        f" ({100 * busy_ms / wall_ms:.1f} %), kernels {sum(device_us.values()) / 1e3:.3f} ms")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:15]:
        if us > 0:
            say("profile", f"{us / 1e3 / n_steps:9.4f} ms per step  {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "busy_pct": 100 * busy_ms / wall_ms}


# Kernels redesigned for the card's registers: they must not spill.
NO_SPILL = ("l1_grads_kernel", "l1_distance_small_kernel", "dense_adamw_kernel")


def ptxas_report(names=("l1_distance", "dense_adamw")) -> None:
    """Registers, shared memory and spills of every kernel of the named
    sources, from ``ptxas -v`` in the build's log; raises when a kernel named
    in ``NO_SPILL`` spills."""
    for name in names:
        kernels = []
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function '" in line:
                kernels.append({"name": line.split("'")[1], "spills": (0, 0)})
            elif kernels and "bytes spill stores" in line:
                # "N bytes stack frame, S bytes spill stores, L bytes spill loads"
                parts = line.split(",")
                kernels[-1]["spills"] = (int(parts[1].split()[0]), int(parts[2].split()[0]))
            elif kernels and "Used " in line and " registers" in line:
                # "Used R registers, used B barriers, M bytes smem, ..."
                kernels[-1]["registers"] = int(line.split("Used ")[1].split()[0])
                smem = [part for part in line.split(",") if part.strip().endswith("bytes smem")]
                kernels[-1]["smem"] = int(smem[0].split()[0]) if smem else 0
        if not kernels:
            raise AssertionError(f"no ptxas report in the build log of {name}")
        try:
            readable = subprocess.run(["c++filt"], input="\n".join(k["name"] for k in kernels),
                                      capture_output=True, text=True, check=True).stdout
        except (OSError, subprocess.CalledProcessError):
            readable = ""  # no demangler: keep the mangled names
        for k, line in zip(kernels, readable.splitlines()):
            # "void (anonymous namespace)::f<...>(args)" -> "f<...>"
            k["name"] = line.replace("void ", "").replace("(anonymous namespace)::", "")
            k["name"] = k["name"].split("(")[0]
        for k in kernels:
            say("build", f"{name}.cu {k['name']}: {k.get('registers')} registers,"
                f" {k.get('smem')} bytes static smem, spill stores {k['spills'][0]} B,"
                f" loads {k['spills'][1]} B")
            if any(s in k["name"] for s in NO_SPILL) and k["spills"] != (0, 0):
                raise AssertionError(f"{k['name']} spills {k['spills']}")


PHASES = ("training", "dense", "device", "packed", "yago", "scorers", "eval", "conve", "mesh")


def profiled_phases(argv) -> set:
    """The training phases to trace: every one for ``--profile``, the named
    ones for ``--profile=a,b``."""
    phases = set()
    for arg in argv:
        if arg == "--profile":
            phases.update(PHASES)
        elif arg.startswith("--profile="):
            named = set(arg.split("=", 1)[1].split(","))
            if not named <= set(PHASES):
                raise SystemExit(f"--profile takes phases of {PHASES}, got {sorted(named)}")
            phases.update(named)
    return phases


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
    say("build", f"{len(paths)} libraries (nvcc, host C++) in {time.perf_counter() - t:.1f}s")
    ptxas_report()

    gen = torch.Generator("cuda").manual_seed(SEED)
    profile = profiled_phases(sys.argv[1:])
    results = check_kernels(gen)
    results.update(check_training_kernels(gen, 2 * N_ENTITY))
    for name, edges in check_distance_edges(gen).items():
        edges["max_abs_err"] = max(edges["max_abs_err"], results[name]["max_abs_err"])
        results[name].update(edges)
    results.update(check_multi_and_gather(gen, N_ENTITY))
    results["dense_adamw_update"] = check_dense_adamw(gen)
    for name, run in serving(gen).items():
        results[name].update(run)
    for name, run in autograd(gen).items():
        results[name].update(run)
    train = training(gen, profile="training" in profile)
    step_ms = train.pop("step_ms")
    train_adagrad = train.pop("adagrad")
    for name, run in train.items():
        results[name].update(run)
    dense = dense_training(gen, profile="dense" in profile)
    dense_ms = dense.pop("step_ms")
    for name, run in dense.items():
        results[name].update(run)
    device = device_training(gen, profile="device" in profile)
    packed_run = packed_training(gen, profile="packed" in profile)
    ckpt = checkpoint_phase(gen)
    torch.cuda.empty_cache()
    yago_run = yago(gen, profile="yago" in profile)
    torch.cuda.empty_cache()
    scorer_runs = scorers(gen, profile="scorers" in profile)
    torch.cuda.empty_cache()
    eval_run = eval_phase(gen, profile="eval" in profile, smi=smi)
    torch.cuda.empty_cache()
    conve_run = conve(gen, profile="conve" in profile, smi=smi)
    torch.cuda.empty_cache()
    mesh_run = mesh_phase(gen, smi=smi, profile="mesh" in profile)
    torch.cuda.empty_cache()
    bench_run = bench_phase(smi, device, packed_run)
    for bench_name, run in bench_run["launches"].items():
        for name in KERNELS:
            results[name].setdefault("launches_bench", {})[bench_name] = {
                "first_call_wrapper": run["first_call_wrapper_launches"].get(name, 0),
                "steps_in_first_call": 2 * run["steps_per_call"]}
    nccl, gloo = mesh_run["nccl_1_rank"], mesh_run["gloo_ranks"]
    for name in KERNELS:
        results[name]["launches_mesh"] = {
            "nccl_1_rank_first_call": nccl["first_call_wrapper_launches"].get(name, 0),
            "nccl_1_rank_steps_in_first_call": 2 * WIKIKG2_SPC,
            "gloo_4_ranks_step_per_rank": [r["step"]["launches"][name] for r in gloo],
            "gloo_4_ranks_topk_batch_per_rank": [r["topk"]["launches_per_batch"][name]
                                                 for r in gloo]}
        rest = nccl["rest"]
        results[name]["launches_mesh"]["rest"] = {
            "nccl_1_rank_allscores_pass": rest["allscores"]["b5_launches"]
            if name == "l1_distance_matrix" else 0,
            "nccl_1_rank_score_moving_step": rest["sm_step"]["launches"].get(name, 0),
            "gloo_4_ranks_allscores_pass_per_rank": [
                r["allscores"]["b5_launches"] if name == "l1_distance_matrix" else 0 for r in gloo],
            "gloo_4_ranks_score_moving_step_per_rank": [r["sm_step"]["launches"].get(name, 0)
                                                        for r in gloo],
            **{f"gloo_4_ranks_conve_{form}_step_per_rank": [
                r["conve"][form]["launches"].get(name, 0) for r in gloo]
               for form in ("dense", "sparse")}}
    # B5 and B6 held against their plain versions at the mesh paths' shapes.
    for name in _L1_PATH:
        held = [nccl["l1_at_path_shape"][name]] + [r["l1_at_path_shape"][name] for r in gloo]
        rest = [nccl["rest"]["allscores"]["l1_at_path_shape"][name],
                nccl["rest"]["sm_step"]["l1_at_path_shape"][name],
                gloo[0]["as_l1_at_path_shape"][name], gloo[0]["sm_l1_at_path_shape"][name]]
        err = max(h["max_abs_err"] for h in held + rest + [r["as_l1_at_path_shape"][name]
                                                           for r in gloo] + [
            r["sm_l1_at_path_shape"][name] for r in gloo])
        results[name]["launches_mesh"]["held_at_the_path_shape"] = {
            "nccl_1_rank": held[0]["shapes"], "gloo_4_ranks": held[1]["shapes"],
            "nccl_1_rank_allscores": rest[0]["shapes"],
            "nccl_1_rank_score_moving_step": rest[1]["shapes"],
            "gloo_4_ranks_allscores": rest[2]["shapes"],
            "gloo_4_ranks_score_moving_step": rest[3]["shapes"], "max_abs_err": err}
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    results["dense_adamw_update"]["launches_yago"] = {
        "host_step": yago_run["host_step_launches"],
        "first_device_call": yago_run["device"]["first_call_wrapper_launches"],
        "per_call_by_name": yago_run["device"]["launches_per_call"]}
    b5 = eval_run["allscores"]["b5"]
    results["l1_distance_matrix"]["launches_eval"] = {
        "allscores_pipeline_wrapper": eval_run["allscores"]["b5_wrapper_launches_per_pass"],
        "allscores_per_batch_by_name": eval_run["allscores"]["b5_per_batch_by_name"],
        "shared_candidate_topk_per_batch_by_name":
            eval_run["valid"]["topk"]["shared"]["b5_per_batch_by_name"],
        "shared_candidate_topk_wrapper": eval_run["valid"]["topk"]["shared"]["wrapper_launches"]}
    results["l1_distance_matrix"]["allscores_shape"] = b5
    results["dense_adamw_update"]["launches_conve"] = {
        "host_step": conve_run["dense_host_launches"],
        "first_device_call": conve_run["device"]["first_call_wrapper_launches"],
        "per_call_by_name": conve_run["device"]["launches_per_call"]}
    b10 = conve_run["b10"]
    results["dense_adamw_update"]["conve_shape"] = {
        "shape": [YAGO_ENTITY, CONVE_EMB + 1], "ms": b10["ms"], "plain_ms": b10["plain_ms"],
        "library_ms": b10["library_ms"], "bound_ms": b10["bound"][0], "bound_by": b10["bound"][1],
        "max_abs_err": b10["max_abs_err"]}
    results["scatter_rows"]["launches_conve"] = {
        "sparse_host_step": conve_run["sparse_host_launches"],
        "held_at_the_step_shape": conve_run["b3"]}
    results["scatter_rows"]["launches_scorers"] = {
        name: {"host_step": r["host_step_launches"],
               "first_device_call": r["first_call_wrapper_launches"],
               "per_call_by_name": r["launches_per_call"]} for name, r in scorer_runs.items()}

    kernels = []
    for name, spec in KERNELS.items():
        r = results[name]
        entry = {
            "name": name, "id": spec["id"], "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "tpu_counterpart": f"{spec['id']} {spec['replaces']}",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "max_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        }
        if "serving_ms" in r:
            entry["serving_ms_per_batch"] = r["serving_ms"]
        if "event_ms" in r:
            entry["event_ms"] = r["event_ms"]
        if "autograd_shape" in r:  # B5 at the autograd path's shape too
            t = r["autograd_shape"]
            entry.update(autograd_shape=[SHARD_BS_TRAIN // 2, SHARD_BS_TRAIN // 2 + N_NEGATIVE, DIM],
                         ms_autograd_shape=t["ms"], event_ms_autograd_shape=t["event_ms"],
                         plain_ms_autograd_shape=t["plain_ms"],
                         library_ms_autograd_shape=t["library_ms"],
                         bound_ms_autograd_shape=t["bound"][0])
        if "library_kernel_ms" in r:
            entry["library_kernel_ms"] = r["library_kernel_ms"]
        for key in ("launches_yago", "launches_scorers", "launches_eval", "launches_conve",
                    "conve_shape", "launches_mesh", "launches_bench"):
            if key in r:
                entry[key] = r[key]
        if "allscores_shape" in r:  # B5 at the all-scores window's shape too
            t = r["allscores_shape"]
            entry.update(allscores_shape=t["shape"], ms_allscores_shape=t["ms"],
                         plain_ms_allscores_shape=t["plain_ms"],
                         library_ms_allscores_shape=t["library_ms"],
                         bound_ms_allscores_shape=t["bound"][0],
                         bound_by_allscores_shape=t["bound"][1],
                         max_abs_err_allscores_shape=t["max_abs_err"])
        if "ms_k2" in r:  # B8 at k = 2 beside the k = 3 numbers above
            entry.update(k=3, ms_k2=r["ms_k2"], plain_ms_k2=r["plain_ms_k2"],
                         library_ms_k2=r["library_ms_k2"], bound_ms_k2=r["bound_k2"][0],
                         b3_launches_ms=r["b3_ms"], b3_launches_ms_k2=r["b3_ms_k2"])
        kernels.append(entry)
    print(json.dumps({"training_ms_per_step": step_ms,
                      "positives_per_step": SHARD_BS_TRAIN * BPS}), flush=True)
    print(json.dumps({"dense_training_ms_per_step": dense_ms,
                      "dense_positives_per_step": DENSE_SHARD_BS * DENSE_BPS}), flush=True)
    spc = {"wikikg2": WIKIKG2_SPC, "biokg_adamw": BIOKG_SPC, "biokg_fused": BIOKG_SPC}
    print(json.dumps({
        "device_training_ms_per_step": {name: r["ms_per_step"] for name, r in device.items()},
        "steps_per_call": spc,
        "host_sampled_ms_per_step": {"wikikg2": step_ms["xla"], "biokg_adamw": dense_ms["plain"],
                                     "biokg_fused": dense_ms["fused"]},
        "launches_per_call": {name: r["launches_per_call"] for name, r in device.items()},
        "first_call_wrapper_launches": {name: r["first_call_wrapper_launches"]
                                        for name, r in device.items()},
        "timed_calls": {name: r["timed_calls"] for name, r in device.items()},
        "capture_s": {name: r["capture_s"] for name, r in device.items()},
        "graph_pool_bytes": {name: r["pool_bytes"] for name, r in device.items()},
        "graph_capture_peak_bytes": {name: r["peak_bytes"] for name, r in device.items()},
        "replay_bitwise_equal_to_eager": {
            name: {path: all(rep["bitwise"][path] for rep in r["replays"])
                   for path in r["replays"][0]["bitwise"]} for name, r in device.items()},
        "busy_pct": {name: r["profile"]["busy_pct"] for name, r in device.items()
                     if "profile" in r},
    }), flush=True)
    print(json.dumps({
        "packed_training_ms_per_step": {name: r["ms_per_step"] for name, r in packed_run.items()},
        "steps_per_call": WIKIKG2_SPC, "positives_per_step": SHARD_BS_TRAIN * BPS,
        "table_bytes": {name: r["table_bytes"] for name, r in packed_run.items()},
        "timed_calls": {name: r["timed_calls"] for name, r in packed_run.items()},
        **{key: {name: packed_run[name][field] for name in PACKED} for key, field in (
            ("launches_per_call", "launches_per_call"), ("capture_s", "capture_s"),
            ("graph_pool_bytes", "pool_bytes"), ("graph_capture_peak_bytes", "peak_bytes"),
            ("first_call_wrapper_launches", "first_call_wrapper_launches"),
            ("vs_cpu", "vs_cpu"), ("layouts", "layouts"))},
        "replay_bitwise_equal_to_eager": {
            name: all(all(rep["bitwise"].values()) for rep in packed_run[name]["replays"])
            for name in PACKED},
        "busy_pct": {name: r["profile"]["busy_pct"] for name, r in packed_run.items()
                     if "profile" in r},
    }), flush=True)
    print(json.dumps({"checkpoint": ckpt, "card": smi,
                      "training_adagrad": train_adagrad}), flush=True)
    print(json.dumps({"yago": {
        "serving_ms_per_batch": {k: yago_run[k]["ms_per_batch"]
                                 for k in ("serving", "trained_serving")},
        "serving_peak_bytes": {k: yago_run[k]["peak_bytes"] for k in ("serving", "trained_serving")},
        "window": yago_run["serving"]["window"], "queries_per_batch": YAGO_QUERIES,
        "training_ms_per_step": yago_run["ms_per_step"], "steps_per_call": YAGO_SPC,
        "positives_per_step": YAGO_SHARD_BS * YAGO_BPS, "table_bytes": yago_run["table_bytes"],
        "capture_s": yago_run["device"]["capture_s"],
        "graph_pool_bytes": yago_run["device"]["pool_bytes"],
        "graph_capture_peak_bytes": yago_run["device"]["peak_bytes"],
        "host_step_vs_cpu": yago_run["host_step_vs_cpu"],
        "busy_pct": yago_run.get("profile", {}).get("busy_pct"),
        "deviations": ["one shard (the YAGO example: four)", "d = 128 (the example: 64)"],
        "card": smi}}), flush=True)
    print(json.dumps({"scorers": {name: {k: v for k, v in r.items() if k not in (
        "first_call_wrapper_launches", "launches_per_call")} for name, r in scorer_runs.items()},
        "steps_per_call": WIKIKG2_SPC, "positives_per_step": SHARD_BS_TRAIN * BPS,
        "topk_queries": SCORER_QUERIES, "card": smi}), flush=True)
    print(json.dumps({"eval": {
        "valid": {k: v for k, v in eval_run["valid"].items() if k != "profile"},
        "valid_busy_pct": eval_run["valid"].get("profile", {}).get("busy_pct"),
        "allscores": {k: v for k, v in eval_run["allscores"].items() if k not in ("b5", "profile")},
        "allscores_busy_pct": eval_run["allscores"].get("profile", {}).get("busy_pct"),
        "deviations": ["heads and tails of the planted queries are distinct entities",
                       "valid candidates never hold the triple's own tail"],
        "card": smi}}), flush=True)
    print(json.dumps({"conve": {
        "host_ms_per_step": conve_run["host_ms_per_step"],
        "device_ms_per_step": conve_run["device_ms_per_step"], "steps_per_call": CONVE_SPC,
        "positives_per_step": CONVE_SHARD_BS * CONVE_BPS,
        "topk_ms_per_batch": conve_run["serving"]["ms_per_batch"], "topk_queries": CONVE_QUERIES,
        "capture_s": conve_run["capture_s"],
        "graph_pool_bytes": conve_run["device"]["pool_bytes"],
        "dense_vs_cpu": conve_run["dense_vs_cpu"], "sparse_vs_cpu": conve_run["sparse_vs_cpu"],
        "keep_rates": conve_run["keep_rates"], "allscores": conve_run["allscores"],
        "b10_conve_shape": results["dense_adamw_update"]["conve_shape"],
        "busy_pct": conve_run.get("profile", {}).get("busy_pct"),
        "conv_fc_share": conve_run.get("conv_fc_share"),
        "conv_cost": conve_run["conv_cost"],
        "deviations": ["one shard", "random triples standing for YAGO3-10's 1,079,040",
                       "all-scores over 20,000 entities"],
        "card": smi}}), flush=True)
    print(json.dumps({"mesh": {
        "nccl_1_rank": {"ms_per_step": nccl["ms_per_step"], "steps_per_call": WIKIKG2_SPC,
                        "census_first_call": nccl["census_first_call"],
                        "vs_no_mesh": [r["vs_no_mesh"] for r in nccl["replays"]],
                        "replays_bitwise_equal_to_eager": all(
                            r["bitwise_vs_eager"] for r in nccl["replays"])},
        "gloo_ranks_on_one_card": {
            "ranks": MESH_RANKS, "rows_per_block": gloo[0]["rows_per_block"],
            "ms_per_step": [r["step"]["ms_per_step"] for r in gloo],
            "topk_ms_per_batch": [r["topk"]["ms_per_batch"] for r in gloo],
            "topk_queries_per_batch": MESH_QUERIES,
            "step_vs_cpu": [r["step"]["vs_cpu"] for r in gloo],
            "step_census": gloo[0]["step"]["census"], "topk_census": gloo[0]["topk"]["census"],
            "device_call_uncaptured": gloo[0]["device_call"]["uncaptured"],
            "device_call_ms_per_step": [r["device_call"]["ms_per_step"] for r in gloo],
            "fit_steps": gloo[0]["fit"]["steps"], "fit_losses": gloo[0]["fit"]["losses"],
            "checkpoint": [r["checkpoint"] for r in gloo]},
        "rest": {
            "nccl_1_rank": {"valid": nccl["rest"]["valid"],
                            "allscores_ms_per_batch": nccl["rest"]["allscores"]["ms_per_batch"],
                            "score_moving_step": {k: nccl["rest"]["sm_step"][k]
                                                  for k in ("launches", "census")}},
            "gloo_ranks_on_one_card": {
                "valid": [{k: r["valid"][k] for k in ("metrics", "queries_per_s",
                                                      "host_queries_per_s")} for r in gloo],
                "valid_no_mesh": {k: gloo[0]["valid"][k] for k in (
                    "no_mesh", "planted", "planted_no_mesh")},
                "allscores_ms_per_batch": [r["allscores"]["ms_per_batch"] for r in gloo],
                "allscores_ties": gloo[0]["allscores"]["ties"],
                "allscores_mrr": [gloo[0]["allscores"]["metrics_avg"]["mrr"],
                                  gloo[0]["allscores"]["no_mesh_metrics_avg"]["mrr"]],
                "score_moving_step": [{k: r["sm_step"][k] for k in ("vs_cpu", "ms_per_step")}
                                      for r in gloo],
                "conve_sync_bn": [{form: {k: v for k, v in r["conve"][form].items() if k != "bn"}
                                   for form in ("dense", "sparse")} for r in gloo],
                "rest_s": [r["rest_s"] for r in gloo]}},
        "note": "gloo ranks share one card: no time here measures NCCL across cards",
        "card": smi}}), flush=True)
    print(json.dumps({"bench": {
        "lines": {name: {k: v for k, v in line.items() if k not in ("peaks", "card")}
                  for name, line in bench_run["lines"].items()},
        "replay_kernels_per_call": {name: run["per_call_by_name"]
                                    for name, run in bench_run["launches"].items()},
        "wall_s": bench_run["wall_s"], "card": smi}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
