"""KGE score functions on torch tensors.

Counterpart of ``besskge_tpu/scoring.py``: a score function object holds the
static configuration and builds the tables; the learnable state is an
explicit ``params`` dict (``{"entity_embedding": (n_shard *
max_entity_per_shard, row), "relation_embedding": (n_relation, row)}``, and
:class:`ConvE`'s nested trunk params) passed to every method. Every scorer
of the JAX package is ported.

With sample sharing, the bilinear scorers (:class:`DistMult`,
:class:`ComplEx`) score the shared pool with one product accumulated in fp32
(:func:`~besskge_tpu_torch.ops.distance.dot_product_matrix`) and TransE and
RotatE with one p-distance matrix (the L1 kernels on a card); the other
distance scorers broadcast the queries against the pool, as the JAX package
does, and materialise a (queries, pool, row) intermediate
(:attr:`BaseScoreFunction.broadcasts_pool`).

Score-method shape contract (as in the JAX package):

* ``score_triple(params, head (B, r_e), rel_id (B,), tail (B, r_e)) -> (B,)``
* ``score_heads(params, heads (b, n, r_e), rel_id (B,), tail (B, r_e))
  -> (B, b*n)`` if sample sharing, else ``(B, n)`` with ``b == B``.
* ``score_tails`` symmetric.

Every score method takes the JAX package's keywords ``train`` and ``rng``
(a dropout key); only :class:`ConvE` reads them.
"""

from __future__ import annotations

import contextlib
from abc import ABC, abstractmethod
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from besskge_tpu_torch.device_sampler import _uniform, split_key
from besskge_tpu_torch.embedding import (
    Initializer,
    _device_blocks,
    device_table_init,
    init_KGE_normal,
    init_KGE_uniform,
    init_uniform,
    init_uniform_norm,
    init_uniform_rotation,
    init_xavier_norm,
    init_zeros,
    initialize_entity_embedding,
    initialize_relation_embedding,
    refactor_embedding_sharding,
)
from besskge_tpu_torch.ops.distance import dot_product_matrix, p_distance_matrix
from besskge_tpu_torch.packed import (
    _store_dtype,
    is_packed,
    pack_table,
    pack_table_host,
    unpack_table_host,
)
from besskge_tpu_torch.parallel import collectives
from besskge_tpu_torch.sharding import Sharding
from besskge_tpu_torch.utils import (
    _tree_map,
    complex_multiplication,
    complex_rotation,
    resolve_device,
)

__all__ = [
    "BaseScoreFunction",
    "DistanceBasedScoreFunction",
    "MatrixDecompositionScoreFunction",
    "TransE",
    "RotatE",
    "PairRE",
    "TripleRE",
    "DistMult",
    "ComplEx",
    "ConvE",
    "BoxE",
    "InterHT",
    "TranS",
]

#: A params dict: tensors, and nested dicts of tensors (ConvE's trunk).
Params = Dict[str, Any]
TableOrInit = Union[np.ndarray, List[Initializer]]

#: Softening for norms at exactly zero.
_NORM_EPS = 1e-12


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalization as the JAX package writes it:
    ``v / sqrt(Σv² + 1e-12)`` (not ``F.normalize``, whose ``max(‖v‖, eps)``
    gives other bits and other gradients)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + _NORM_EPS)


class BaseScoreFunction(ABC):
    """Base class for scoring functions; tables are built lazily by
    :meth:`initial_params` (numpy, bit-equal to the JAX package) or
    :meth:`initial_params_device` (drawn on the device)."""

    #: Share negative entities across all queries of the micro-batch.
    negative_sample_sharing: bool
    #: Entity sharding (device table layout: 2-D shard-major rows).
    sharding: Sharding
    #: Width of one entity-table row.
    entity_row_size: int
    #: Width of one relation-table row.
    relation_row_size: int
    #: Nominal embedding size of the model.
    embedding_size: int
    #: Optional compute precision for scoring (e.g. ``torch.bfloat16``):
    #: gathered rows are cast to it while storage stays in ``dtype``.
    compute_dtype: Optional[torch.dtype] = None
    #: Mesh axis name set by a BESS module (``None`` on one device,
    #: ``"shard"`` over a mesh); read by cross-shard ops such as ConvE's
    #: SyncBN.
    mesh_axis: Any = None
    #: The :class:`~besskge_tpu_torch.parallel.mesh.ShardMesh` whose
    #: collectives those ops use: bound with the module's
    #: (``bess._bind_mesh``), ``None`` on one device.
    mesh: Any = None
    #: Scoring a shared pool broadcasts each query against it: one
    #: (queries, pool, ≤ entity row) intermediate per elementwise op, which
    #: top-k serving scores in blocks of queries.
    broadcasts_pool: bool = False
    #: Store the entity table row-pair-packed (:mod:`besskge_tpu_torch.packed`):
    #: int32 words of bf16 pairs, or uint32 words of fp16 pairs when
    #: ``dtype`` is ``torch.float16``, at half the bytes of fp32; trained by
    #: an :class:`~besskge_tpu_torch.optim.EntityRowOptimizer`. Set before
    #: ``initial_params*``.
    packed_entity_storage: bool = False

    def _build_tables(
        self,
        sharding: Sharding,
        n_relation_type: int,
        inverse_relations: bool,
        entity_initializer: TableOrInit,
        entity_slices: List[int],
        relation_initializer: TableOrInit,
        relation_slices: List[int],
        seed: int,
        dtype: torch.dtype,
    ) -> None:
        self.sharding = sharding
        self.n_relation_type = n_relation_type
        self.inverse_relations = inverse_relations
        self.dtype = dtype
        self.seed = seed
        self.entity_row_size = int(sum(entity_slices))
        self.relation_row_size = int(sum(relation_slices))
        self._entity_spec = (entity_initializer, list(entity_slices))
        self._relation_spec = (relation_initializer, list(relation_slices))

    def initial_params(self, device: Optional[Union[str, torch.device]] = None) -> Params:
        """The initial tables and non-table params, drawn on the host with
        numpy exactly as the JAX package's ``initial_params`` draws them, then
        moved to ``device`` (default ``cuda``)."""
        device = resolve_device(device)
        ent_init, ent_slices = self._entity_spec
        rel_init, rel_slices = self._relation_spec
        ent = initialize_entity_embedding(
            self.sharding, ent_init, ent_slices, seed=self.seed
        ).reshape(-1, self.entity_row_size)
        rel = initialize_relation_embedding(
            self.n_relation_type,
            self.inverse_relations,
            rel_init,
            rel_slices,
            seed=self.seed + 1,
        )
        if self.packed_entity_storage:
            if self.sharding.max_entity_per_shard % 2:
                raise ValueError("a packed table needs an even max_entity_per_shard")
            # the JAX package casts to the table dtype, then packs on the host
            ent = pack_table_host(ent.astype(np.float16) if self.dtype == torch.float16 else ent)
            entity = torch.from_numpy(ent.view(np.int32)).view(_store_dtype(self.dtype))
        else:
            entity = torch.from_numpy(ent).to(self.dtype)
        return {
            "entity_embedding": entity.to(device),
            "relation_embedding": torch.from_numpy(rel).to(device, self.dtype),
            **self._extra_params(device),
        }

    def initial_params_device(
        self,
        mesh: Any = None,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Params:
        """The initial tables drawn directly on ``device`` (default ``cuda``)
        from ``generator`` (default: a generator on ``device`` seeded with
        :attr:`seed`). Values differ from :meth:`initial_params`; the
        non-table params (:meth:`_extra_params`) equal its, as in the JAX
        package.

        The entity table is drawn shard block by shard block (one block on
        one shard). Over a ``mesh`` (a
        :class:`~besskge_tpu_torch.parallel.mesh.ShardMesh`, whose device
        the params go to) each rank keeps its own block of the same stream
        (:func:`~besskge_tpu_torch.embedding.device_table_init`): the rank's
        rows of the mesh-free call's table, and the same replicated params
        on every rank."""
        if mesh is not None:
            device = mesh.device
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(self.seed)
        n_rel = self.n_relation_type * (2 if self.inverse_relations else 1)
        ent_shape = (
            self.sharding.n_shard * self.sharding.max_entity_per_shard,
            self.entity_row_size,
        )
        if mesh is not None or isinstance(self._entity_spec[0], np.ndarray):
            ent = device_table_init(
                *self._entity_spec, ent_shape, self.seed, self.dtype, mesh, device, generator
            )
        else:
            blocks = _device_blocks(*self._entity_spec, ent_shape, self.sharding.n_shard, None,
                                    self.dtype, device, generator)
            ent = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
        if self.packed_entity_storage:
            if self.sharding.max_entity_per_shard % 2:
                raise ValueError("a packed table needs an even max_entity_per_shard")
            ent = pack_table(ent)
        return {
            "entity_embedding": ent,
            "relation_embedding": device_table_init(
                *self._relation_spec, (n_rel, self.relation_row_size), self.seed + 1,
                self.dtype, None, device, generator,
            ),
            **self._extra_params(device),
        }

    def _extra_params(self, device: torch.device) -> Params:
        """Non-table learnable params on ``device``, drawn on the host in
        both ``initial_params`` forms as the JAX package draws them (ConvE's
        trunk); none by default."""
        return {}

    def update_sharding(self, params: Params, new_sharding: Sharding) -> Params:
        """Re-shard a (trained) entity table to ``new_sharding`` on the host
        and put it back on its device; a row-pair-packed table goes through
        its logical 16-bit rows (reference ``besskge/scoring.py:126-142``)."""
        tab = params["entity_embedding"]
        host = tab.detach().cpu()
        packed = is_packed(host)
        if packed:
            raw = unpack_table_host(
                host.view(torch.int32).numpy().view(
                    np.uint32 if host.dtype == torch.uint32 else np.int32),
                self.sharding.n_shard * self.sharding.max_entity_per_shard)
        else:  # a bf16 table widens to fp32 exactly
            raw = (host.float() if host.dtype == torch.bfloat16 else host).numpy()
        table = raw.reshape(self.sharding.n_shard, self.sharding.max_entity_per_shard, -1)
        new_table = refactor_embedding_sharding(
            table.astype(np.float32), self.sharding, new_sharding
        ).astype(table.dtype)
        self.sharding = new_sharding
        new_table = new_table.reshape(-1, new_table.shape[-1])
        if packed:
            if new_sharding.max_entity_per_shard % 2:
                raise ValueError("a packed table needs an even max_entity_per_shard")
            new = torch.from_numpy(pack_table_host(new_table).view(np.int32)).view(host.dtype)
        else:
            new = torch.from_numpy(new_table).to(host.dtype)
        return {**params, "entity_embedding": new.to(tab.device)}

    def relation_embedding(self, params: Params, relation_id: torch.Tensor) -> torch.Tensor:
        """Gather relation rows from the replicated table (cast to
        :attr:`compute_dtype` when set)."""
        r = params["relation_embedding"][relation_id.long()]
        if self.compute_dtype is not None and r.dtype != self.compute_dtype:
            r = r.to(self.compute_dtype)
        return r

    def _pool(self, v: torch.Tensor) -> torch.Tensor:
        """(b, n, d) -> (1, b*n, d) when sample sharing, else unchanged."""
        if self.negative_sample_sharing:
            return v.reshape(1, -1, v.shape[-1])
        return v

    @abstractmethod
    def score_triple(
        self, params: Params, head_emb: torch.Tensor, relation_id: torch.Tensor,
        tail_emb: torch.Tensor, **kwargs: Any,
    ) -> torch.Tensor:
        """Score a batch of (h, r, t) triples; see module docstring."""
        raise NotImplementedError

    @abstractmethod
    def score_heads(
        self, params: Params, head_emb: torch.Tensor, relation_id: torch.Tensor,
        tail_emb: torch.Tensor, **kwargs: Any,
    ) -> torch.Tensor:
        """Score head candidates against fixed (r, t) queries."""
        raise NotImplementedError

    @abstractmethod
    def score_tails(
        self, params: Params, head_emb: torch.Tensor, relation_id: torch.Tensor,
        tail_emb: torch.Tensor, **kwargs: Any,
    ) -> torch.Tensor:
        """Score tail candidates against fixed (h, r) queries."""
        raise NotImplementedError


class DistanceBasedScoreFunction(BaseScoreFunction, ABC):
    """Base for distance scorers: p-norm reduction + broadcasted distance."""

    def __init__(self, negative_sample_sharing: bool, scoring_norm: int) -> None:
        self.negative_sample_sharing = negative_sample_sharing
        self.scoring_norm = scoring_norm

    def reduce_embedding(self, v: torch.Tensor) -> torch.Tensor:
        """p-norm along the last axis."""
        if self.scoring_norm == 1:
            return torch.sum(torch.abs(v), dim=-1)
        if self.scoring_norm == 2:
            return torch.sqrt(torch.sum(v * v, dim=-1) + _NORM_EPS)
        return torch.sum(torch.abs(v) ** self.scoring_norm, dim=-1) ** (
            1.0 / self.scoring_norm
        )

    def broadcasted_distance(self, v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
        """p-distance of queries ``v1 (B, d)`` against candidates
        ``v2 (b, n, d)``; with sample sharing one all-pairs distance matrix
        (the L1 kernel on CUDA)."""
        if self.negative_sample_sharing:
            return p_distance_matrix(
                v1, v2.reshape(-1, v2.shape[-1]), p=self.scoring_norm
            )
        return self.reduce_embedding(v1[:, None, :] - v2)

    def distance_query_vector(
        self, params: Params, known_emb: torch.Tensor, relation_id: torch.Tensor,
        scheme: str,
    ) -> Optional[torch.Tensor]:
        """Transformed query ``a`` such that scoring against a shared
        candidate pool equals ``−cdist_p(a, pool)``: the hook for the fused
        window kernel. ``None`` means the model has no pure-cdist form."""
        return None


class MatrixDecompositionScoreFunction(BaseScoreFunction, ABC):
    """Base for bilinear scorers: sum reduction + broadcasted dot product,
    one product under sample sharing (reference
    ``besskge/scoring.py:203-255``)."""

    def __init__(self, negative_sample_sharing: bool) -> None:
        self.negative_sample_sharing = negative_sample_sharing

    def reduce_embedding(self, v: torch.Tensor) -> torch.Tensor:
        """Sum along the last axis."""
        return torch.sum(v, dim=-1)

    def broadcasted_dot_product(self, v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
        """Dot products of queries ``v1 (B, d)`` against ``v2 (b, n, d)``; with
        sample sharing one product against the pool, accumulated in fp32 and
        cast to ``v1.dtype``."""
        if self.negative_sample_sharing:
            return dot_product_matrix(v1, v2.reshape(-1, v2.shape[-1]))
        return self.reduce_embedding(v1[:, None, :] * v2)


class TransE(DistanceBasedScoreFunction):
    """TransE: ``-||h + r − t||_p`` (reference ``besskge/scoring.py:258-354``)."""

    def __init__(
        self,
        negative_sample_sharing: bool,
        scoring_norm: int,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing, scoring_norm)
        self.embedding_size = embedding_size
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            entity_initializer if entity_initializer is not None else [init_KGE_uniform],
            [embedding_size],
            relation_initializer if relation_initializer is not None else [init_KGE_uniform],
            [embedding_size],
            seed,
            dtype,
        )

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return -self.reduce_embedding(head_emb + r - tail_emb)

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return -self.broadcasted_distance(tail_emb - r, head_emb)

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return -self.broadcasted_distance(head_emb + r, tail_emb)

    def distance_query_vector(self, params, known_emb, relation_id, scheme):
        r = self.relation_embedding(params, relation_id)
        return known_emb - r if scheme == "h" else known_emb + r


class RotatE(DistanceBasedScoreFunction):
    """RotatE: ``-||h ∘ e^{i r} − t||_p`` on blocked complex rows
    (reference ``besskge/scoring.py:357-462``): entity rows hold
    ``[re | im]`` of ``embedding_size`` complex values, relation rows the
    ``embedding_size`` rotation phases."""

    def __init__(
        self,
        negative_sample_sharing: bool,
        scoring_norm: int,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing, scoring_norm)
        self.embedding_size = embedding_size
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            entity_initializer if entity_initializer is not None else [init_KGE_uniform],
            [2 * embedding_size],
            relation_initializer
            if relation_initializer is not None
            else [init_uniform_rotation],
            [embedding_size],
            seed,
            dtype,
        )

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return -self.reduce_embedding(complex_rotation(head_emb, r) - tail_emb)

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return -self.broadcasted_distance(complex_rotation(tail_emb, -r), head_emb)

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return -self.broadcasted_distance(complex_rotation(head_emb, r), tail_emb)

    def distance_query_vector(self, params, known_emb, relation_id, scheme):
        r = self.relation_embedding(params, relation_id)
        return complex_rotation(known_emb, -r if scheme == "h" else r)


class PairRE(DistanceBasedScoreFunction):
    """PairRE: ``-||h ∘ r_h − t ∘ r_t||_p``
    (reference ``besskge/scoring.py:465-593``)."""

    broadcasts_pool = True

    def __init__(
        self,
        negative_sample_sharing: bool,
        scoring_norm: int,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        normalize_entities: bool = True,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing, scoring_norm)
        self.embedding_size = embedding_size
        self.normalize = normalize_entities
        rel_init = relation_initializer if relation_initializer is not None else [init_KGE_uniform]
        if isinstance(rel_init, list):
            rel_init = 2 * rel_init
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            entity_initializer if entity_initializer is not None else [init_KGE_uniform],
            [embedding_size],
            rel_init,
            [embedding_size, embedding_size],
            seed,
            dtype,
        )

    def _split_rel(self, params, relation_id):
        return torch.chunk(self.relation_embedding(params, relation_id), 2, dim=-1)

    def _maybe_norm(self, v):
        return _l2_normalize(v) if self.normalize else v

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r_h, r_t = self._split_rel(params, relation_id)
        h = self._maybe_norm(head_emb)
        t = self._maybe_norm(tail_emb)
        return -self.reduce_embedding(h * r_h - t * r_t)

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r_h, r_t = self._split_rel(params, relation_id)
        h = self._pool(self._maybe_norm(head_emb))
        t = self._maybe_norm(tail_emb)
        return -self.reduce_embedding(h * r_h[:, None, :] - (t * r_t)[:, None, :])

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r_h, r_t = self._split_rel(params, relation_id)
        h = self._maybe_norm(head_emb)
        t = self._pool(self._maybe_norm(tail_emb))
        return -self.reduce_embedding(t * r_t[:, None, :] - (h * r_h)[:, None, :])


class TripleRE(DistanceBasedScoreFunction):
    """TripleRE(v2): ``-||h ∘ (r_h [+u]) − t ∘ (r_t [+u]) + r_m||_p``
    (reference ``besskge/scoring.py:596-743``); v2 when ``u > 0``."""

    broadcasts_pool = True

    def __init__(
        self,
        negative_sample_sharing: bool,
        scoring_norm: int,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        normalize_entities: bool = True,
        u: float = 0.0,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing, scoring_norm)
        self.embedding_size = embedding_size
        self.normalize = normalize_entities
        self.u = float(u)
        self.use_v2 = u > 0.0
        rel_init = relation_initializer if relation_initializer is not None else [init_KGE_uniform]
        if isinstance(rel_init, list):
            rel_init = 3 * rel_init
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            entity_initializer if entity_initializer is not None else [init_KGE_uniform],
            [embedding_size],
            rel_init,
            [embedding_size] * 3,
            seed,
            dtype,
        )

    def _split_rel(self, params, relation_id):
        r_h, r_m, r_t = torch.chunk(self.relation_embedding(params, relation_id), 3, dim=-1)
        if self.use_v2:
            r_h = r_h + self.u
            r_t = r_t + self.u
        return r_h, r_m, r_t

    def _maybe_norm(self, v):
        return _l2_normalize(v) if self.normalize else v

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r_h, r_m, r_t = self._split_rel(params, relation_id)
        h = self._maybe_norm(head_emb)
        t = self._maybe_norm(tail_emb)
        return -self.reduce_embedding(h * r_h - t * r_t + r_m)

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r_h, r_m, r_t = self._split_rel(params, relation_id)
        h = self._pool(self._maybe_norm(head_emb))
        t = self._maybe_norm(tail_emb)
        return -self.reduce_embedding(h * r_h[:, None, :] - (t * r_t - r_m)[:, None, :])

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r_h, r_m, r_t = self._split_rel(params, relation_id)
        h = self._maybe_norm(head_emb)
        t = self._pool(self._maybe_norm(tail_emb))
        return -self.reduce_embedding(t * r_t[:, None, :] - (h * r_h + r_m)[:, None, :])


class DistMult(MatrixDecompositionScoreFunction):
    """DistMult: ``⟨h, r, t⟩`` (reference ``besskge/scoring.py:746-837``)."""

    def __init__(
        self,
        negative_sample_sharing: bool,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing)
        self.embedding_size = embedding_size
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            entity_initializer if entity_initializer is not None else [init_KGE_uniform],
            [embedding_size],
            relation_initializer if relation_initializer is not None else [init_KGE_uniform],
            [embedding_size],
            seed,
            dtype,
        )

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return self.reduce_embedding(head_emb * r * tail_emb)

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return self.broadcasted_dot_product(r * tail_emb, head_emb)

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return self.broadcasted_dot_product(head_emb * r, tail_emb)


class ComplEx(MatrixDecompositionScoreFunction):
    """ComplEx: ``Re⟨h, r, t̄⟩`` on blocked complex rows of ``2 ·
    embedding_size`` values ``[re | im]`` (reference
    ``besskge/scoring.py:840-946``)."""

    def __init__(
        self,
        negative_sample_sharing: bool,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing)
        self.embedding_size = embedding_size
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            entity_initializer if entity_initializer is not None else [init_KGE_normal],
            [2 * embedding_size],
            relation_initializer if relation_initializer is not None else [init_KGE_normal],
            [2 * embedding_size],
            seed,
            dtype,
        )

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return self.reduce_embedding(complex_multiplication(head_emb, r) * tail_emb)

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        re, im = torch.chunk(r, 2, dim=-1)
        r_conj = torch.cat([re, -im], dim=-1)
        return self.broadcasted_dot_product(complex_multiplication(r_conj, tail_emb), head_emb)

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        return self.broadcasted_dot_product(complex_multiplication(head_emb, r), tail_emb)


def _kaiming_uniform(shape: Sequence[int], rng: np.random.Generator, fan_in: int) -> np.ndarray:
    """U(-1/√fan_in, 1/√fan_in) in float32 (``besskge_tpu/scoring.py``'s)."""
    bound = float(np.sqrt(1.0 / fan_in))
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _keep_mask(key: torch.Tensor, keep: float, shape: Sequence[int]) -> torch.Tensor:
    """A dropout mask: ``True`` where the uniform draw of the counter hash
    (:func:`~besskge_tpu_torch.device_sampler._uniform`, stream 0 of
    ``key``) lies below ``keep``, as ``jax.random.bernoulli`` keeps a draw
    below its ``p``. ``shape`` is the JAX package's layout of the masked
    array. Every mask of the port is drawn here: a key, and so a mask,
    depends on nothing but the step's dropout key, so the card, the CPU and
    a replayed CUDA graph draw the same masks (and the tests put the JAX
    package's masks here)."""
    return _uniform(key, 0, tuple(shape)) < keep


@contextlib.contextmanager
def _exact_conv() -> Iterator[None]:
    """cuDNN convolutions in full fp32 (no TF32, which cuDNN allows by
    default) and by deterministic algorithms chosen without benchmarking, so
    that a captured graph replays the eager call's bits; restored after."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        yield


class _ValidConv2d(torch.autograd.Function):
    """``F.conv2d(x, w)`` (NCHW, OIHW, stride 1, no padding: the JAX
    package's ``padding="VALID"``) under :func:`_exact_conv`, in the
    forward and in the backward (which autograd runs outside the
    forward's scope)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        with _exact_conv():
            return torch.nn.functional.conv2d(x, w)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: torch.Tensor) -> None:
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, w = ctx.saved_tensors
        with _exact_conv():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, True, False])
        return gx, gw


class ConvE(MatrixDecompositionScoreFunction):
    """ConvE: a 2-D convolution over the stacked [h; r] maps, a linear map
    back to ``embedding_size``, dotted with t plus a learned tail bias
    (reference ``besskge/scoring.py:949-1146``). Tail corruption only (head
    queries go through inverse triples).

    The params keep the JAX package's names and layouts, so checkpoints and
    :mod:`~besskge_tpu_torch.convert` carry them as they are: ``conv_w``
    HWIO (permuted to OIHW inside :meth:`hr_transform`), ``conv_b``,
    ``fc_w`` (fc_in, d), ``fc_b`` and, with ``batch_normalization``,
    ``bn0``/``bn1``/``bn2`` as ``{"scale", "bias", "mean", "var"}``.
    The trunk runs NCHW; its batch statistics, dropout masks and flattening
    follow the JAX package's NHWC arithmetic:

    * BatchNorm with ``train=True`` normalises by the micro-batch's biased
      statistics, ``var = E[x²] − mean²``, and by the running stats in
      ``params`` otherwise, with ``rsqrt(var + 1e-5)`` (not
      ``F.batch_norm``, whose running var is unbiased). The training step
      refreshes the running stats (``trainer._bn_ema``);
      ``sync_batch_norm`` takes the statistics of the global batch over a
      mesh (the mean and E[x²] pmeaned over the ranks) and is the identity
      on one device;
    * dropout with ``train=True`` and an ``rng`` (a key, as
      :mod:`~besskge_tpu_torch.device_sampler` keys): the key splits three
      ways (input, feature map, hidden), each mask drawn by
      :func:`_keep_mask` in the JAX package's layout and permuted to NCHW;
      the feature-map dropout keeps whole channels (``Dropout2d``);
    * the conv (cuDNN without TF32, deterministic, :class:`_ValidConv2d`)
      and the linear map (fp32 accumulation without TF32,
      :func:`~besskge_tpu_torch.ops.distance.dot_product_matrix`) return
      the input's dtype, as the JAX package's ``preferred_element_type``
      products cast back. No Pallas kernel runs here in the JAX package,
      and none in the port.
    """

    def __init__(
        self,
        negative_sample_sharing: bool,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        embedding_height: int,
        embedding_width: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        inverse_relations: bool = True,
        input_channels: int = 1,
        output_channels: int = 32,
        kernel_height: int = 3,
        kernel_width: int = 3,
        input_dropout: float = 0.2,
        feature_map_dropout: float = 0.2,
        hidden_dropout: float = 0.3,
        batch_normalization: bool = True,
        sync_batch_norm: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing)
        self.sync_batch_norm = sync_batch_norm
        if input_channels * embedding_height * embedding_width != embedding_size:
            raise ValueError(
                "embedding_size must equal"
                " input_channels * embedding_height * embedding_width"
            )
        self.embedding_size = embedding_size
        self.inp_channels = input_channels
        self.out_channels = output_channels
        self.emb_h = embedding_height
        self.emb_w = embedding_width
        self.kernel_h = kernel_height
        self.kernel_w = kernel_width
        self.p_in, self.p_fm, self.p_hid = input_dropout, feature_map_dropout, hidden_dropout
        self.batch_norm = batch_normalization
        # Entity row: [embedding, tail-bias scalar].
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            entity_initializer
            if entity_initializer is not None
            else [init_xavier_norm, init_zeros],
            [embedding_size, 1],
            relation_initializer if relation_initializer is not None else [init_xavier_norm],
            [embedding_size],
            seed,
            dtype,
        )
        rng = np.random.default_rng(seed + 2)
        fc_in = (
            output_channels
            * (2 * embedding_height - kernel_height + 1)
            * (embedding_width - kernel_width + 1)
        )
        self.fc_in = fc_in
        fan_conv = input_channels * kernel_height * kernel_width
        self._net_params: Dict[str, Any] = {
            # HWIO, the JAX package's layout.
            "conv_w": _kaiming_uniform(
                (kernel_height, kernel_width, input_channels, output_channels), rng, fan_conv
            ),
            "conv_b": _kaiming_uniform((output_channels,), rng, fan_conv),
            "fc_w": _kaiming_uniform((fc_in, embedding_size), rng, fc_in),
            "fc_b": _kaiming_uniform((embedding_size,), rng, fc_in),
        }
        if batch_normalization:
            for name, n in (("bn0", input_channels), ("bn1", output_channels),
                            ("bn2", embedding_size)):
                self._net_params[name] = {
                    "scale": np.ones(n, np.float32),
                    "bias": np.zeros(n, np.float32),
                    "mean": np.zeros(n, np.float32),
                    "var": np.ones(n, np.float32),
                }

    def _extra_params(self, device: torch.device) -> Params:
        return _tree_map(lambda a: torch.from_numpy(a.copy()).to(device), self._net_params)

    def _batch_stats(self, x: torch.Tensor, axes: Tuple[int, ...], sync: bool):
        """(mean, var) over ``axes``: the biased ``E[x²] − mean²``. With
        ``sync`` over a mesh both moments are pmeaned over the ranks in one
        all-reduce (:func:`~besskge_tpu_torch.parallel.collectives.pmean`,
        whose backward pmeans the cotangent), the global batch's statistics
        for equal per-rank batches, as the JAX package's ``jax.lax.pmean``;
        on one device (``mesh_axis`` ``None``) it is the identity."""
        mean = torch.mean(x, dim=axes)
        sq = torch.mean(torch.square(x), dim=axes)
        if sync and self.mesh_axis is not None:
            if self.mesh is None:
                raise RuntimeError(
                    "SyncBN over a mesh: build the module's step over its mesh (mesh=) first")
            both = collectives.pmean(torch.cat([mean, sq]), self.mesh)
            mean, sq = both[: mean.shape[0]], both[mean.shape[0] :]
        return mean, sq - torch.square(mean)

    @staticmethod
    def _axes(x: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """The statistics' axes of an NCHW map or a (b, d) batch, and the
        shape that broadcasts a per-channel vector against it."""
        return ((0, 2, 3), (-1, 1, 1)) if x.dim() == 4 else ((0,), (-1,))

    def _bn(self, x: torch.Tensor, stats: Params, train: bool) -> torch.Tensor:
        axes, shape = self._axes(x)
        if train:
            mean, var = self._batch_stats(x, axes, self.sync_batch_norm)
        else:
            mean, var = stats["mean"], stats["var"]
        inv = torch.rsqrt(var + 1e-5)
        return ((x - mean.reshape(shape)) * (inv * stats["scale"]).reshape(shape)
                + stats["bias"].reshape(shape))

    @staticmethod
    def _dropout(x: torch.Tensor, rate: float, train: bool, rng: Optional[torch.Tensor],
                 shape: Optional[Sequence[int]] = None,
                 perm: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``x / (1 − rate)`` where the mask keeps, else 0; the mask drawn
        in the JAX package's ``shape`` (default ``x``'s) and permuted by
        ``perm`` to the port's layout."""
        if not train or rate == 0.0 or rng is None:
            return x
        keep = _keep_mask(rng, 1.0 - rate, x.shape if shape is None else shape)
        if perm is not None:
            keep = keep.permute(*perm)
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def _conv(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """The VALID conv of an NCHW map with ``conv_w`` (HWIO -> OIHW) in
        ``x``'s dtype, plus ``conv_b``."""
        w = params["conv_w"].permute(3, 2, 0, 1).to(x.dtype)
        return _ValidConv2d.apply(x, w) + params["conv_b"].to(x.dtype).reshape(-1, 1, 1)

    def _fc(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """The NCHW map flattened (the torch Linear's input order, as the
        JAX package flattens its NHWC map transposed) times ``fc_w``, plus
        ``fc_b``."""
        x = x.reshape(x.shape[0], -1)
        return dot_product_matrix(x, params["fc_w"].T) + params["fc_b"].to(x.dtype)

    def _stack(self, head_emb: torch.Tensor, relation_emb: torch.Tensor) -> torch.Tensor:
        """[h; r] as one NCHW map (b, C, 2H, W): the head map above the
        relation map."""
        b = head_emb.shape[0]
        h_map = head_emb.reshape(b, self.inp_channels, self.emb_h, self.emb_w)
        r_map = relation_emb.reshape(b, self.inp_channels, self.emb_h, self.emb_w)
        return torch.cat([h_map, r_map], dim=2)

    def hr_transform(
        self,
        params: Params,
        head_emb: torch.Tensor,
        relation_emb: torch.Tensor,
        train: bool = False,
        rng: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The conv/BN/FC trunk mapping [h; r] to a query vector (B, d)."""
        x = self._stack(head_emb, relation_emb)
        b, c, hh, w = x.shape
        keys = split_key(rng, 3) if rng is not None else [None] * 3
        if self.batch_norm:
            x = self._bn(x, params["bn0"], train)
        x = self._dropout(x, self.p_in, train, keys[0], (b, hh, w, c), (0, 3, 1, 2))
        x = self._conv(params, x)
        if self.batch_norm:
            x = self._bn(x, params["bn1"], train)
        x = torch.relu(x)
        # Dropout2d: whole channels.
        x = self._dropout(x, self.p_fm, train, keys[1], (b, 1, 1, x.shape[1]), (0, 3, 1, 2))
        x = self._fc(params, x)
        x = self._dropout(x, self.p_hid, train, keys[2])
        if self.batch_norm:
            x = self._bn(x, params["bn2"], train)
        return torch.relu(x)

    def update_bn_stats(
        self,
        params: Params,
        head_emb: torch.Tensor,
        relation_id: torch.Tensor,
        momentum: float = 0.1,
        sync: bool = False,
    ) -> Params:
        """Refresh the BN running stats from one batch of (h, r) inputs
        (``head_emb`` full entity rows, the tail bias last): a momentum EMA
        of each BN's batch statistics, dropout-free, each later BN fed by
        the earlier ones normalised with their refreshed stats. Returns new
        params (the input ones unchanged)."""
        if not self.batch_norm:
            return params
        r = self.relation_embedding(params, relation_id)
        x = self._stack(head_emb[..., :-1], r)
        new = dict(params)

        def upd(stats, x):
            m, v = self._batch_stats(x, self._axes(x)[0], sync)
            return {
                **stats,
                "mean": (1 - momentum) * stats["mean"] + momentum * m,
                "var": (1 - momentum) * stats["var"] + momentum * v,
            }

        new["bn0"] = upd(params["bn0"], x)
        x = self._conv(params, self._bn(x, new["bn0"], False))
        new["bn1"] = upd(params["bn1"], x)
        x = self._fc(params, torch.relu(self._bn(x, new["bn1"], False)))
        new["bn2"] = upd(params["bn2"], x)
        return new

    def score_triple(self, params, head_emb, relation_id, tail_emb, *, train=False, rng=None,
                     **kw):
        r = self.relation_embedding(params, relation_id)
        hr = self.hr_transform(params, head_emb[..., :-1], r, train, rng)
        t, t_bias = tail_emb[..., :-1], tail_emb[..., -1]
        return self.reduce_embedding(hr * t) + t_bias

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        raise NotImplementedError("ConvE should not be used with head corruption")

    def score_tails(self, params, head_emb, relation_id, tail_emb, *, train=False, rng=None,
                    **kw):
        r = self.relation_embedding(params, relation_id)
        hr = self.hr_transform(params, head_emb[..., :-1], r, train, rng)
        t, t_bias = tail_emb[..., :-1], tail_emb[..., -1]
        if self.negative_sample_sharing:
            t_bias = t_bias.reshape(1, -1)
        return self.broadcasted_dot_product(hr, t) + t_bias


class BoxE(DistanceBasedScoreFunction):
    """BoxE: two-box distance with tanh bounding and a per-dimension in/out
    switch (reference ``besskge/scoring.py:1149-1415``). Entity rows are
    ``[base position | translational bump]`` (2d); relation rows ``[head
    center, tail center, head width, tail width, head size, tail size]``
    (4d + 2)."""

    broadcasts_pool = True

    def __init__(
        self,
        negative_sample_sharing: bool,
        scoring_norm: int,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        apply_tanh: bool = True,
        dist_func_per_dim: bool = True,
        eps: float = 1e-6,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing, scoring_norm)
        self.embedding_size = embedding_size
        self.apply_tanh = apply_tanh
        self.dist_func_per_dim = dist_func_per_dim
        self.eps = eps
        ent_init = entity_initializer if entity_initializer is not None else [init_uniform]
        if isinstance(ent_init, list):
            ent_init = 2 * ent_init
        rel_init = (
            relation_initializer
            if relation_initializer is not None
            else [init_uniform, init_uniform_norm]
        )
        if isinstance(rel_init, list):
            rel_init = 4 * [rel_init[0]] + 2 * [rel_init[1]]
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            ent_init,
            [embedding_size, embedding_size],
            rel_init,
            [embedding_size] * 4 + [1, 1],
            seed,
            dtype,
        )

    def boxe_score(self, bumped_ht, center_ht, width_ht, box_size):
        """Negative sum of head and tail box distances; shapes as in
        reference ``besskge/scoring.py:1253-1345``."""
        width_ht = torch.abs(width_ht)
        # Geometric-mean normalization of widths, softened by eps. The
        # maxima are torch.maximum against a 0-dim fill (a kernel, not a
        # host copy), whose gradient halves at a tie as jnp.maximum's does.
        eps = width_ht.new_full((), self.eps)
        log_w = torch.log(torch.maximum(width_ht, eps))
        width_ht = width_ht / torch.maximum(torch.exp(torch.mean(log_w, dim=-1, keepdim=True)), eps)
        scale = 1.0 + torch.nn.functional.elu(box_size[..., None].float()).to(width_ht.dtype)
        width_ht = width_ht * scale

        if self.apply_tanh:
            box_low = torch.tanh(center_ht - 0.5 * width_ht)
            box_up = torch.tanh(box_low + width_ht)
            center_ht = 0.5 * (box_low + box_up)
            width_ht = box_up - box_low
            center_dist = torch.abs(torch.tanh(bumped_ht) - center_ht)
        else:
            center_dist = torch.abs(bumped_ht - center_ht)

        width_p1 = 1.0 + width_ht
        k = 0.5 * width_ht * (width_p1 - 1.0 / width_p1)
        in_box = center_dist <= 0.5 * width_ht
        if not self.dist_func_per_dim:
            in_box = torch.all(in_box, dim=-1, keepdim=True)
        final = torch.where(in_box, center_dist / width_p1, center_dist * width_p1 - k)
        return -torch.sum(self.reduce_embedding(final), dim=-1)

    def _split_rel(self, params, relation_id):
        r = self.relation_embedding(params, relation_id)
        d = self.embedding_size
        return r[..., : 2 * d], r[..., 2 * d : 4 * d], r[..., 4 * d :]

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        center, width, size = self._split_rel(params, relation_id)
        d = self.embedding_size
        # Element 0: head bumped by the tail's bump (against the head box);
        # element 1: tail bumped by the head's bump (against the tail box).
        bumped = head_emb.reshape(-1, 2, d) + tail_emb.reshape(-1, 2, d).flip(1)
        return self.boxe_score(
            bumped, center.reshape(-1, 2, d), width.reshape(-1, 2, d), size.reshape(-1, 2)
        )

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        center, width, size = self._split_rel(params, relation_id)
        d = self.embedding_size
        h = self._pool(head_emb)
        bumped = h.reshape(h.shape[0], -1, 2, d) + tail_emb.reshape(-1, 1, 2, d).flip(2)
        return self.boxe_score(
            bumped, center.reshape(-1, 1, 2, d), width.reshape(-1, 1, 2, d),
            size.reshape(-1, 1, 2),
        )

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        center, width, size = self._split_rel(params, relation_id)
        d = self.embedding_size
        t = self._pool(tail_emb)
        bumped = head_emb.reshape(-1, 1, 2, d) + t.reshape(t.shape[0], -1, 2, d).flip(2)
        return self.boxe_score(
            bumped, center.reshape(-1, 1, 2, d), width.reshape(-1, 1, 2, d),
            size.reshape(-1, 1, 2),
        )


class InterHT(DistanceBasedScoreFunction):
    """InterHT: ``-||h ∘ (t̂+off) + r − t ∘ (ĥ+off)||_p`` on entity rows
    ``[main | auxiliary]`` (reference ``besskge/scoring.py:1418-1572``)."""

    broadcasts_pool = True

    def __init__(
        self,
        negative_sample_sharing: bool,
        scoring_norm: int,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        normalize_entities: bool = True,
        offset: float = 1.0,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing, scoring_norm)
        self.embedding_size = embedding_size
        self.normalize = normalize_entities
        self.offset = float(offset)
        ent_init = entity_initializer if entity_initializer is not None else [init_KGE_uniform]
        if isinstance(ent_init, list):
            ent_init = 2 * ent_init
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            ent_init,
            [embedding_size, embedding_size],
            relation_initializer if relation_initializer is not None else [init_KGE_uniform],
            [embedding_size],
            seed,
            dtype,
        )

    def _split_ent(self, v):
        main, aux = torch.chunk(v, 2, dim=-1)
        if self.normalize:
            main, aux = _l2_normalize(main), _l2_normalize(aux)
        return main, aux

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        h, h_aux = self._split_ent(head_emb)
        t, t_aux = self._split_ent(tail_emb)
        return -self.reduce_embedding(h * (t_aux + self.offset) + r - t * (h_aux + self.offset))

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        h, h_aux = self._split_ent(head_emb)
        t, t_aux = self._split_ent(tail_emb)
        h, h_aux = self._pool(h), self._pool(h_aux)
        return -self.reduce_embedding(
            h * (t_aux + self.offset)[:, None, :]
            + r[:, None, :]
            - t[:, None, :] * (h_aux + self.offset)
        )

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r = self.relation_embedding(params, relation_id)
        h, h_aux = self._split_ent(head_emb)
        t, t_aux = self._split_ent(tail_emb)
        t, t_aux = self._pool(t), self._pool(t_aux)
        return -self.reduce_embedding(
            h[:, None, :] * (t_aux + self.offset)
            + r[:, None, :]
            - t * (h_aux + self.offset)[:, None, :]
        )


class TranS(DistanceBasedScoreFunction):
    """TranS: ``-||h ∘ (t̃+off+r̄) − t ∘ (h̃+off−r̂) + r||_p`` on entity rows
    ``[main | tilde]`` and relation rows ``[r, r̄, r̂]`` (reference
    ``besskge/scoring.py:1575-1751``)."""

    broadcasts_pool = True

    def __init__(
        self,
        negative_sample_sharing: bool,
        scoring_norm: int,
        sharding: Sharding,
        n_relation_type: int,
        embedding_size: int,
        entity_initializer: Optional[TableOrInit] = None,
        relation_initializer: Optional[TableOrInit] = None,
        normalize_entities: bool = True,
        offset: float = 1.0,
        inverse_relations: bool = False,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(negative_sample_sharing, scoring_norm)
        self.embedding_size = embedding_size
        self.normalize = normalize_entities
        self.offset = float(offset)
        ent_init = entity_initializer if entity_initializer is not None else [init_KGE_uniform]
        if isinstance(ent_init, list):
            ent_init = 2 * ent_init
        rel_init = relation_initializer if relation_initializer is not None else [init_KGE_uniform]
        if isinstance(rel_init, list):
            rel_init = 3 * rel_init
        self._build_tables(
            sharding,
            n_relation_type,
            inverse_relations,
            ent_init,
            [embedding_size, embedding_size],
            rel_init,
            [embedding_size] * 3,
            seed,
            dtype,
        )

    def _split_ent(self, v):
        main, tilde = torch.chunk(v, 2, dim=-1)
        if self.normalize:
            main, tilde = _l2_normalize(main), _l2_normalize(tilde)
        return main, tilde

    def score_triple(self, params, head_emb, relation_id, tail_emb, **kw):
        r, r_bar, r_hat = torch.chunk(self.relation_embedding(params, relation_id), 3, dim=-1)
        h, h_tilde = self._split_ent(head_emb)
        t, t_tilde = self._split_ent(tail_emb)
        return -self.reduce_embedding(
            h * (t_tilde + self.offset + r_bar) - t * (h_tilde + self.offset - r_hat) + r
        )

    def score_heads(self, params, head_emb, relation_id, tail_emb, **kw):
        r, r_bar, r_hat = torch.chunk(self.relation_embedding(params, relation_id), 3, dim=-1)
        h, h_tilde = self._split_ent(head_emb)
        t, t_tilde = self._split_ent(tail_emb)
        h, h_tilde = self._pool(h), self._pool(h_tilde)
        return -self.reduce_embedding(
            h * (t_tilde + self.offset + r_bar)[:, None, :]
            - t[:, None, :] * (h_tilde + self.offset - r_hat[:, None, :])
            + r[:, None, :]
        )

    def score_tails(self, params, head_emb, relation_id, tail_emb, **kw):
        r, r_bar, r_hat = torch.chunk(self.relation_embedding(params, relation_id), 3, dim=-1)
        h, h_tilde = self._split_ent(head_emb)
        t, t_tilde = self._split_ent(tail_emb)
        t, t_tilde = self._pool(t), self._pool(t_tilde)
        return -self.reduce_embedding(
            h[:, None, :] * (t_tilde + self.offset + r_bar[:, None, :])
            - t * (h_tilde + self.offset - r_hat)[:, None, :]
            + r[:, None, :]
        )
