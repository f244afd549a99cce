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
                    if isinstance(val, (classmethod, staticmethod)):
                        val = getattr(port_obj, attr)  # bound: no ``cls``
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
                 "besskge_tpu_torch.negative_sampler.TypeBasedShardedNegativeSampler",
                 "besskge_tpu_torch.optim.RowAdagrad", "besskge_tpu_torch.optim.RowAdagrad.update_rows",
                 "besskge_tpu_torch.checkpoint.save_checkpoint",
                 "besskge_tpu_torch.checkpoint.load_checkpoint",
                 "besskge_tpu_torch.checkpoint.save_checkpoint_sharded",
                 "besskge_tpu_torch.checkpoint.load_checkpoint_sharded",
                 "besskge_tpu_torch.trainer.Trainer.save", "besskge_tpu_torch.sharding.Sharding.save",
                 "besskge_tpu_torch.dataset.KGDataset.save",
                 "besskge_tpu_torch.scoring.BaseScoreFunction.update_sharding",
                 "besskge_tpu_torch.embedding.refactor_embedding_sharding",
                 "besskge_tpu_torch.bess.ScoreMovingBessKGE", "besskge_tpu_torch.bess.AllScoresBESS",
                 "besskge_tpu_torch.bess.AllScoresBESS.forward",
                 "besskge_tpu_torch.bess.build_bess_forward",
                 "besskge_tpu_torch.bess.build_allscores_forward",
                 "besskge_tpu_torch.eval_loop.run_device_eval",
                 "besskge_tpu_torch.eval_loop.make_block_runner",
                 "besskge_tpu_torch.pipeline.AllScoresPipeline",
                 "besskge_tpu_torch.pipeline.AllScoresPipeline.forward",
                 "besskge_tpu_torch.negative_sampler.TripleBasedShardedNegativeSampler",
                 "besskge_tpu_torch.utils.get_entity_filter",
                 "besskge_tpu_torch.dataset.KGDataset.from_dataframe",
                 "besskge_tpu_torch.dataset.KGDataset.build_ogbl_wikikg2",
                 "besskge_tpu_torch.scoring.ConvE", "besskge_tpu_torch.scoring.ConvE.hr_transform",
                 "besskge_tpu_torch.scoring.ConvE.update_bn_stats",
                 "besskge_tpu_torch.scoring.ConvE.score_tails",
                 "besskge_tpu_torch.monitor.StepTimer", "besskge_tpu_torch.monitor.StepTimer.stop",
                 "besskge_tpu_torch.monitor.trace", "besskge_tpu_torch.monitor.trace_breakdown",
                 "besskge_tpu_torch.monitor.parse_trace_events",
                 "besskge_tpu_torch.monitor.top_ops",
                 "besskge_tpu_torch.monitor.device_memory_stats",
                 "besskge_tpu_torch._hostmem.configure_host_allocator",
                 "besskge_tpu_torch._hostmem.prewarm_host_memory"):
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


#: The port's own trailing dataclass fields, beyond the reference's: none.
PORT_EXTRA_FIELDS = {"RowSGDM": [], "RowAdamW": [], "RowAdagrad": [], "FusedDenseAdamW": []}


@pytest.mark.parametrize("cls", sorted(PORT_EXTRA_FIELDS))
def test_row_optimizer_fields_equal_the_reference(cls):
    """C2: the field lists (names and defaults) equal the reference's, in
    order, up to the port's own trailing extras; the prefix scan above lets
    a port stop early, this does not. The layout a checkpoint de-interleaves
    follows ``interleave_layout``, a field of RowAdamW and RowAdagrad and a
    class attribute of the base."""
    port = [(f.name, f.default) for f in dataclasses.fields(getattr(port_optim, cls))]
    ref = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_optim, cls))]
    assert port == ref + [(name, port[len(ref) + i][1])
                          for i, name in enumerate(PORT_EXTRA_FIELDS[cls])]
    if cls in ("RowAdamW", "RowAdagrad"):
        assert port[-2:] == ref[-2:] == [("interleaved", False),
                                         ("interleave_layout", cls[3:].lower())]
    assert (port_optim.EntityRowOptimizer.interleave_layout
            == jax_optim.EntityRowOptimizer.interleave_layout == "momentum")
    assert port_optim.RowSGDM(0.1, interleaved=True).interleave_layout == "momentum"


#: Public members of the reference that the port lacks, each queued under its
#: ROADMAP item. A gap that is not listed here fails the member scan, and so
#: does a listed one that the port has closed. The BESS modules' ``psum``
#: closed with the mesh (A15a), and every module runs over a mesh (A15b,
#: ``tests/test_torch_mesh.py::test_every_former_a15b_site_runs_over_a_mesh``).
UNPORTED_MEMBERS: dict = {}


def _public(mod):
    """A module's public names: its ``__all__`` and the public functions and
    classes it defines; without an ``__all__``, every public name that is
    not a module."""
    names = set(getattr(mod, "__all__", []))
    for name, value in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if not hasattr(mod, "__all__"):
            names.add(name)
        elif (inspect.isfunction(value) or inspect.isclass(value)) and \
                value.__module__ == mod.__name__:
            names.add(name)
    return names


def _member_gaps():
    """``module.name`` and ``module.Class.member`` of every public name the
    reference has and the port lacks, over the modules both packages have."""
    gaps = set()
    for info in pkgutil.walk_packages(besskge_tpu_torch.__path__, "besskge_tpu_torch."):
        try:
            jax_mod = importlib.import_module(info.name.replace("besskge_tpu_torch", "besskge_tpu", 1))
        except ModuleNotFoundError:
            continue
        mod = importlib.import_module(info.name)
        short = info.name.split(".", 1)[1]
        for name in _public(jax_mod):
            if not hasattr(mod, name):
                gaps.add(f"{short}.{name}")
                continue
            ref, port = getattr(jax_mod, name), getattr(mod, name)
            if inspect.isclass(ref) and inspect.isclass(port):
                gaps.update(f"{short}.{name}.{member}" for member in dir(ref)
                            if not member.startswith("_") and not hasattr(port, member))
    return gaps


def test_member_scan_holds_the_gaps_to_the_roadmap():
    """C3: the public members the port lacks are exactly the queued ones."""
    assert set(UNPORTED_MEMBERS.values()) <= {"A16"}
    gaps = _member_gaps()
    assert gaps - set(UNPORTED_MEMBERS) == set(), "new gaps"
    assert set(UNPORTED_MEMBERS) - gaps == set(), "closed gaps still listed"


def test_the_mesh_signatures_follow_the_reference():
    """``parallel.mesh`` and ``parallel.multihost`` are held to the
    reference's parameter order by the scan; the census functions, which
    read a call's collectives where the reference reads its HLO
    (``parallel/census.py`` against ``parallel/hlo_check.py``), here."""
    from besskge_tpu.parallel import hlo_check
    from besskge_tpu.parallel import mesh as jax_mesh
    from besskge_tpu.parallel import multihost as jax_multihost
    from besskge_tpu_torch.parallel import census

    names = {name for name, _, _ in SHARED}
    for mod in (jax_mesh, jax_multihost):
        short = mod.__name__.split(".", 1)[1]
        for name in mod.__all__:
            assert f"besskge_tpu_torch.{short}.{name}" in names, name
    assert census.__all__ == hlo_check.__all__
    for name in hlo_check.__all__:
        port, ref = _params(getattr(census, name)), _params(getattr(hlo_check, name))
        assert port[:len(ref)] == ref and port[len(ref):] == ["mesh"], (name, port, ref)


def test_the_c3_members():
    """The members C3 closed behave as the reference's."""
    from besskge_tpu import bess as jax_bess
    from besskge_tpu import native as jax_native
    from besskge_tpu import packed as jax_packed
    from besskge_tpu_torch import bess as port_bess
    from besskge_tpu_torch import native as port_native
    from besskge_tpu_torch import packed as port_packed

    assert port_native.available() is True
    assert jax_native.available() is True
    import jax.numpy as jnp
    import torch

    tab = np.zeros((4, 8), np.float32)
    for table in (tab, tab.astype(np.float16)):
        assert port_optim.is_packed_table(port_packed.pack_table(torch.from_numpy(table)))
        assert jax_optim.is_packed_table(jax_packed.pack_table(jnp.asarray(table)))
    assert not port_optim.is_packed_table(torch.from_numpy(tab))
    assert not jax_optim.is_packed_table(jnp.asarray(tab))
    ref_fn = _sampler_module(True)
    port_fn = _sampler_module(False)
    assert port_fn.n_embedding_parameters == ref_fn.n_embedding_parameters == 200 * 16 + 10 * 16
    assert isinstance(port_bess.BessKGE.n_embedding_parameters, property)
    assert isinstance(jax_bess.BessKGE.n_embedding_parameters, property)


def _sampler_module(jax_side):
    """An EmbeddingMovingBessKGE of either package: 200 entities, 5 relation
    types with inverses, d = 16."""
    if jax_side:
        from besskge_tpu import bess, loss, negative_sampler, scoring, sharding
    else:
        from besskge_tpu_torch import bess, loss, negative_sampler, scoring, sharding
    sh = sharding.Sharding.create(200, 1, seed=0)
    ns = negative_sampler.RandomShardedNegativeSampler(3, sh, 0, "ht", False, True)
    fn = scoring.TransE(True, 1, sh, 5, 16, inverse_relations=True)
    return bess.EmbeddingMovingBessKGE(ns, fn, loss.SampledSoftmaxCrossEntropyLoss(200))


def _topk_case(pkg, sampler, sharing, scheme, mask_on_gather, merge):
    """Construct a TopKQueryBessKGE of either package; the error it raises,
    as (type name, message), or None."""
    if pkg == "jax":
        from besskge_tpu import bess, negative_sampler as ns_mod, scoring, sharding
        kw = {"axis_name": None}
    else:
        from besskge_tpu_torch import bess, negative_sampler as ns_mod, scoring, sharding
        kw = {}
    sh = sharding.Sharding.create(100, 1, seed=0)
    fn = scoring.TransE(sharing, 1, sh, 3, 8)
    if sampler == "placeholder":
        ns = ns_mod.PlaceholderNegativeSampler(scheme)
    else:
        n = 1 if sampler == "shared" else 20
        negs = np.arange(n * 6, dtype=np.int32).reshape(n, 6) % 100
        ns = ns_mod.TripleBasedShardedNegativeSampler(
            negs if scheme == "h" else None, negs if scheme != "h" else None, sh,
            "t" if scheme == "ht" else scheme, 0, mask_on_gather=mask_on_gather)
        ns.corruption_scheme = scheme
    try:
        bess.TopKQueryBessKGE(5, ns, fn, merge_mode=merge, **kw)
    except (ValueError, NotImplementedError) as err:
        return type(err).__name__, str(err)
    return None


@pytest.mark.parametrize("sampler", ["placeholder", "shared", "per_triple"])
@pytest.mark.parametrize("sharing", [True, False])
@pytest.mark.parametrize("scheme", ["t", "h", "ht"])
@pytest.mark.parametrize("mask_on_gather,merge", [(True, "auto"), (False, "auto"),
                                                  (True, "sideways")])
def test_topk_constructor_raises_where_the_reference_does(sampler, sharing, scheme,
                                                          mask_on_gather, merge):
    """Candidate-set top-k (A14): the port's constructor takes and refuses
    the same samplers and scorers as the reference's, with its words: a flat
    candidate format needs sharing, a per-triple one forbids it, a
    TripleBasedShardedNegativeSampler needs mask_on_gather=True, only "h"
    and "t" are taken."""
    want = _topk_case("jax", sampler, sharing, scheme, mask_on_gather, merge)
    got = _topk_case("port", sampler, sharing, scheme, mask_on_gather, merge)
    assert got == want
