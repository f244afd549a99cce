"""The port's public signatures keep the JAX package's parameter order.

A call written for the JAX package, with positional arguments, must mean the
same in the port: for every public class and function that a module of the
port shares with the same module of the JAX package, the port's parameter
list and the reference's agree on every position both have. The port may
stop early (parameters not ported yet) or add its own at the end (``device``,
``generator``), never in between. Dataclasses are compared by their fields,
classes by ``__init__`` and by each public method they both define.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import numpy as np
import pytest

import besskge_tpu_torch
from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import optim as jax_optim
from besskge_tpu import trainer as jax_trainer
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import trainer as port_trainer


def _params(obj):
    """Parameter names of a function, of a class's ``__init__``, or a
    dataclass's fields; ``None`` when there is no signature."""
    if isinstance(obj, type) and dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    try:
        sig = inspect.signature(obj.__init__ if isinstance(obj, type) else obj)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _shared():
    """(name, port object, JAX object) of every public name a port module
    shares with its JAX counterpart, and of the public methods both classes
    define."""
    out = []
    for info in pkgutil.walk_packages(besskge_tpu_torch.__path__, "besskge_tpu_torch."):
        try:
            jax_mod = importlib.import_module(info.name.replace("besskge_tpu_torch", "besskge_tpu", 1))
        except ModuleNotFoundError:
            continue  # a module of the port alone (_build, convert, ops.*_kernels)
        mod = importlib.import_module(info.name)
        for name in getattr(mod, "__all__", []):
            if not hasattr(jax_mod, name):
                continue
            port_obj, jax_obj = getattr(mod, name), getattr(jax_mod, name)
            if not callable(port_obj):
                continue  # a constant
            out.append((f"{info.name}.{name}", port_obj, jax_obj))
            if isinstance(port_obj, type):
                for attr, val in vars(port_obj).items():
                    if not attr.startswith("_") and callable(val) and hasattr(jax_obj, attr):
                        out.append((f"{info.name}.{name}.{attr}", val, getattr(jax_obj, attr)))
    return out


SHARED = _shared()


def test_the_scan_sees_the_ported_modules():
    names = {name for name, _, _ in SHARED}
    for must in ("besskge_tpu_torch.optim.RowSGDM", "besskge_tpu_torch.optim.RowAdamW",
                 "besskge_tpu_torch.optim.FusedDenseAdamW", "besskge_tpu_torch.scoring.RotatE",
                 "besskge_tpu_torch.loss.LogSigmoidLoss", "besskge_tpu_torch.trainer.Trainer",
                 "besskge_tpu_torch.trainer.build_train_step",
                 "besskge_tpu_torch.batch_sampler.ShardedBatchSampler",
                 "besskge_tpu_torch.bess.BessKGE.forward",
                 "besskge_tpu_torch.device_sampler.DeviceBatchSampler",
                 "besskge_tpu_torch.device_sampler.DeviceBatchSampler.sample",
                 "besskge_tpu_torch.device_sampler.DeviceBatchSampler.state",
                 "besskge_tpu_torch.device_sampler.DeviceBatchSampler.slice_local",
                 "besskge_tpu_torch.trainer.build_device_train_step",
                 "besskge_tpu_torch.negative_sampler.TypeBasedShardedNegativeSampler"):
        assert must in names, must
    assert len(SHARED) > 60


def test_the_scan_sees_the_packed_surface():
    """Every public function of the JAX package's packed.py is in the port's,
    and the scan holds each to its parameter order; so the row optimizers'
    16-bit members and the score function's packed storage flag."""
    from besskge_tpu import packed as jax_packed
    from besskge_tpu import scoring as jax_scoring
    from besskge_tpu_torch import packed as port_packed
    from besskge_tpu_torch import scoring as port_scoring

    names = {name for name, _, _ in SHARED}
    assert set(jax_packed.__all__) <= set(port_packed.__all__)
    for name in jax_packed.__all__:
        assert f"besskge_tpu_torch.packed.{name}" in names, name
    for cls in ("RowSGDM", "RowAdamW"):
        for member in ("init", "widen_table", "update_rows"):
            assert f"besskge_tpu_torch.optim.{cls}.{member}" in names, (cls, member)
    assert _params(port_optim._sr_round_16) == _params(jax_optim._sr_round_16)
    for cls in ("BaseScoreFunction", "TransE", "RotatE"):
        assert getattr(port_scoring, cls).packed_entity_storage is False
        assert getattr(jax_scoring, cls).packed_entity_storage is False


@pytest.mark.parametrize("name,port_obj,jax_obj", SHARED, ids=[n for n, _, _ in SHARED])
def test_shared_signatures_are_prefix_compatible(name, port_obj, jax_obj):
    port, ref = _params(port_obj), _params(jax_obj)
    assert port is not None and ref is not None, name
    n = min(len(port), len(ref))
    assert port[:n] == ref[:n], f"{name}: port {port}, reference {ref}"


def test_the_four_repaired_signatures():
    """C1: the positions that had shifted keep the reference's names."""
    assert _params(port_optim.RowSGDM)[:6] == _params(jax_optim.RowSGDM) == [
        "learning_rate", "momentum", "weight_decay", "stochastic_rounding", "interleaved",
        "fused_variant"]
    sampler = _params(port_bs.ShardedBatchSampler)
    assert sampler[5:8] == ["hrt_freq_weighting", "weight_smoothing", "duplicate_batch"]
    assert sampler == _params(jax_bs.ShardedBatchSampler)
    assert _params(port_trainer.Trainer)[5] == "seed" == _params(jax_trainer.Trainer)[5]
    step = _params(port_trainer.build_train_step)
    assert step[4] == "donate" and step[:5] == _params(jax_trainer.build_train_step)
    assert step[5:] == ["device"]


def _sampler_batch(bs_mod, sh_mod, ds_mod, ns_mod, options):
    rng = np.random.default_rng(0)
    tri = np.stack([rng.integers(200, size=900), rng.integers(5, size=900),
                    rng.integers(200, size=900)], 1).astype(np.int32)
    ds = ds_mod.KGDataset(n_entity=200, n_relation_type=5, triples={"train": tri},
                          original_triple_ids={"train": np.arange(900)})
    sharding = sh_mod.Sharding.create(200, 2, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    ns = ns_mod.RandomShardedNegativeSampler(3, sharding, 0, "ht", False, False)
    sampler = bs_mod.RandomShardedBatchSampler(pts, ns, shard_bs=12, batches_per_step=2, seed=0,
                                               **options)
    return sampler.sample_batch(next(sampler.epoch_index_blocks(True)))


@pytest.mark.parametrize("key,value", [("hrt_freq_weighting", True),
                                       ("weight_smoothing", 0.5),
                                       ("duplicate_batch", True)])
def test_unported_sampler_options_raise(key, value):
    """Each of the sampler options that once raised (ROADMAP A8) is ported:
    the batch it gives equals the JAX package's for the same seed."""
    from besskge_tpu import dataset as jax_ds
    from besskge_tpu import negative_sampler as jax_ns
    from besskge_tpu import sharding as jax_sh
    from besskge_tpu_torch import dataset as port_ds
    from besskge_tpu_torch import negative_sampler as port_ns
    from besskge_tpu_torch import sharding as port_sh

    options = {key: value}
    if key == "weight_smoothing":
        options["hrt_freq_weighting"] = True
    want = _sampler_batch(jax_bs, jax_sh, jax_ds, jax_ns, options)
    got = _sampler_batch(port_bs, port_sh, port_ds, port_ns, options)
    assert got.keys() == want.keys()
    assert ("triple_weight" in got) == options.get("hrt_freq_weighting", False)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_sixteen_bit_tables_raise_for_row_optimizers():
    """16-bit tables are ported (ROADMAP A9): the row optimizers take a plain
    or packed one, with fp32 moments. What still raises, as in the JAX
    package: an interleaved optimizer over a plain 16-bit table; and, the
    port's own gap, fp16 operands for the L1 kernels (ROADMAP A17)."""
    import torch

    from besskge_tpu_torch.ops import l1_kernels

    table = torch.zeros(8, 4, dtype=torch.bfloat16)
    for opt in (port_optim.RowSGDM(0.1, 0.9, 0.0, False), port_optim.RowAdamW(0.1)):
        state = opt.init(table)
        assert all(v.dtype == torch.float32 for k, v in state.items() if k != "count")
    for opt in (port_optim.RowSGDM(0.1, 0.9, interleaved=True),
                port_optim.RowAdamW(0.1, interleaved=True)):
        with pytest.raises(ValueError, match="row-pair-packed"):
            opt.init(table)
    half = torch.zeros(3, 4, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="A17"):
        l1_kernels.l1_distance_matrix(half, half)
    with pytest.raises(NotImplementedError, match="A17"):
        l1_kernels.l1_distance_matrix_batched(half[None], half[None])
