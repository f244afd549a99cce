"""Knowledge-graph datasets as collections of (head, relation, tail) triples.

Host-side numpy, copied from ``besskge_tpu/dataset.py`` so that the port
never imports the JAX package: the :class:`KGDataset` fields, its
``from_triples`` random split. Save/load, ``from_dataframe`` and the dataset
builders (OGB, YAGO3-10, OpenBioLink) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
from numpy.typing import NDArray

__all__ = ["KGDataset"]


@dataclasses.dataclass
class KGDataset:
    """A complete KG dataset: triples, optional labels, types and negatives."""

    #: Number of entities (nodes).
    n_entity: int
    #: Number of relation types (edge labels).
    n_relation_type: int
    #: {part: int32[n_triple, 3]} — (h, r, t) triples per dataset split.
    triples: Dict[str, NDArray[np.int32]]
    #: {part: int64[n_triple]} — position of each triple in the source data.
    original_triple_ids: Dict[str, NDArray[np.int64]]
    #: Entity labels by ID.
    entity_dict: Optional[List[str]] = None
    #: Relation labels by ID.
    relation_dict: Optional[List[str]] = None
    #: {type_label: first_global_id} — types own contiguous ID ranges.
    type_offsets: Optional[Dict[str, int]] = None
    #: {part: int32[n_triple or 1, n_neg]} — predefined negative heads.
    neg_heads: Optional[Dict[str, NDArray[np.int32]]] = None
    #: {part: int32[n_triple or 1, n_neg]} — predefined negative tails.
    neg_tails: Optional[Dict[str, NDArray[np.int32]]] = None

    @property
    def ht_types(self) -> Optional[Dict[str, NDArray[np.int32]]]:
        """Per-part type IDs of triple heads/tails; ``int32[n_triple, 2]``."""
        if not self.type_offsets:
            return None
        bins = np.fromiter(self.type_offsets.values(), dtype=np.int32)
        return {
            part: (np.digitize(tri[:, [0, 2]], bins) - 1).astype(np.int32)
            for part, tri in self.triples.items()
        }

    @classmethod
    def from_triples(
        cls,
        data: NDArray[np.int32],
        split: Tuple[float, float, float] = (0.7, 0.15, 0.15),
        seed: int = 1234,
        entity_dict: Optional[List[str]] = None,
        relation_dict: Optional[List[str]] = None,
        type_offsets: Optional[Dict[str, int]] = None,
    ) -> "KGDataset":
        """Random train/valid/test split of a pre-ID'd triple array.

        Entities of the same type must already have contiguous IDs when
        ``type_offsets`` is given.
        """
        n = data.shape[0]
        n_train = int(n * split[0])
        n_valid = int(n * split[1])
        perm = np.random.default_rng(seed).permutation(n)
        ids = {
            "train": perm[:n_train],
            "valid": perm[n_train : n_train + n_valid],
            "test": perm[n_train + n_valid :],
        }
        return cls(
            n_entity=int(data[:, [0, 2]].max()) + 1,
            n_relation_type=int(data[:, 1].max()) + 1,
            triples={k: data[v] for k, v in ids.items()},
            original_triple_ids=ids,
            entity_dict=entity_dict,
            relation_dict=relation_dict,
            type_offsets=type_offsets,
        )
