"""besskge_tpu_torch — the PyTorch/CUDA port of besskge_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``besskge_tpu``, with the same
module names. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``, built at first use by :mod:`besskge_tpu_torch._build`).

The port imports neither ``jax`` nor ``besskge_tpu``: the numpy-only modules
it needs are copied. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no card is there.

Ported so far, on one device: every scorer (TransE, RotatE, DistMult,
ComplEx, PairRE, TripleRE, BoxE, InterHT, TranS, and ConvE with its nested
trunk params, dropout keys drawn from a counter hash, in CUDA graphs too,
and the in-step BatchNorm EMA) and every loss;
top-k serving of each (``bess.TopKQueryBessKGE`` with
``build_topk_forward``), sparse training with every row optimizer
(``RowSGDM``, ``RowAdamW``, ``RowAdagrad``; fp32, plain 16-bit and
row-pair-packed tables) and dense training (``AdamW``, ``FusedDenseAdamW``),
through ``trainer.build_train_step`` and
``trainer.Trainer``, on host batches or on batches drawn on the device
(``device_sampler.DeviceBatchSampler``, ``trainer.build_device_train_step``:
one CUDA graph per call of ``steps_per_call`` steps on a card); checkpoints
in the JAX package's formats, with resharding (``checkpoint``,
``Trainer.save``); evaluation and inference: candidate-set validation
(``bess.ScoreMovingBessKGE`` with a
``negative_sampler.TripleBasedShardedNegativeSampler``, through
``bess.build_bess_forward`` or ``eval_loop.run_device_eval``), candidate-set
top-k, and filtered all-scores evaluation (``pipeline.AllScoresPipeline``);
the dataset builders (``dataset.KGDataset.build_*``).

Over a mesh of ranks, one process per shard (``parallel``: a
``torch.distributed`` group, NCCL on cards, gloo on the CPU): the sparse,
dense and device-sampled training steps and ``Trainer`` of an
``EmbeddingMovingBessKGE`` (one all-to-all per micro-batch, one all-reduce
per step), top-k serving, and checkpoints written and read by each rank's
block (``make_shard_mesh``; ``mesh=`` of ``build_train_step`` and the
other step functions).
"""

__version__ = "0.1.0"

# Keep the host sampler's large numpy buffers on a warm heap (glibc), as the
# JAX package does at import.
from besskge_tpu_torch._hostmem import configure_host_allocator  # noqa: E402

configure_host_allocator()

from besskge_tpu_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from besskge_tpu_torch.device_sampler import DeviceBatchSampler  # noqa: E402
from besskge_tpu_torch.eval_loop import run_device_eval  # noqa: E402
from besskge_tpu_torch.negative_sampler import TypeBasedShardedNegativeSampler  # noqa: E402
from besskge_tpu_torch.parallel import ShardMesh, make_shard_mesh  # noqa: E402
from besskge_tpu_torch.pipeline import AllScoresPipeline  # noqa: E402
from besskge_tpu_torch.trainer import (  # noqa: E402
    Trainer,
    build_device_train_step,
    build_train_step,
)

__all__ = [
    "AllScoresPipeline",
    "DeviceBatchSampler",
    "ShardMesh",
    "Trainer",
    "TypeBasedShardedNegativeSampler",
    "build_device_train_step",
    "build_train_step",
    "load_checkpoint",
    "make_shard_mesh",
    "run_device_eval",
    "save_checkpoint",
]
