"""Row-pair-packed 16-bit entity tables, and logical-row reads of every
table layout (torch).

Counterpart of ``besskge_tpu/packed.py``. A logical 16-bit table of shape
``(N, D)`` is stored as 32-bit words of shape ``(ceil(N/2), D)`` in a planar
halfword layout: word ``w`` of packed row ``p`` is

    ``(bits of row 2p elem w)  |  (bits of row 2p+1 elem w) << 16``

so the low halfword plane holds the even logical row and the high plane the
odd one. The storage dtype says which 16-bit float is packed: **int32 =
bf16, uint32 = fp16**, as in the JAX package, so that arrays carry over bit
for bit. The table is 32-bit with row-granular slices, so the row kernels
(``scatter_rows``, ``scatter_rows_multi``) write it as they write an fp32
table, at half the bytes of one.

A packed row is written whole, so when both logical rows of a pair are
touched in one step their planes are merged before the write, and every
duplicate occurrence of a packed row carries the same bytes
(:func:`merge_packed_row_writes`). The optimizers' interleaved layouts put
the fp32 optimizer state beside the packed params in one block per packed
row: ``(3P, D)`` triplets ``[packed | m 2p | m 2p+1]`` for ``RowSGDM``
(:func:`is_tripled`), ``(5P, D)`` quintuplets ``[packed | mu 2p | mu 2p+1 |
nu 2p | nu 2p+1]`` for ``RowAdamW`` (:func:`is_quintupled`); the fp32 state
rows sit in the storage dtype by their bits. Plain floating-point tables
have their own interleaved layouts, pair-major ``(2N, D)`` (:func:`is_paired`)
and treble-major ``(3N, D)`` (:func:`is_trebled`).

PyTorch implements few operations on ``torch.uint32``, so every bit
operation here runs on the storage's ``int32`` view (:func:`_words`), and a
halfword plane is read as an ``int16`` view of the words: a little-endian
word holds its low halfword first, on the host and on the card alike.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "is_packed",
    "is_paired",
    "is_trebled",
    "is_tripled",
    "half_dtype",
    "pack_table",
    "unpack_table",
    "pack_table_host",
    "unpack_table_host",
    "take_rows",
    "take_contiguous_rows",
    "logical_rows",
    "merge_packed_row_writes",
    "merge_packed_triplet_writes",
    "merge_packed_block_writes",
    "interleave_packed_momentum",
    "interleave_packed_adamw",
    "interleave_packed_state",
    "split_packed_interleaved",
    "split_packed_adamw",
    "split_packed_state",
    "is_quintupled",
]

#: The halfword masks as int32 values (0x0000FFFF, 0xFFFF0000).
_LO = 0x0000FFFF
_HI = -0x10000
_STORE = (torch.int32, torch.uint32)


def is_packed(table: torch.Tensor) -> bool:
    """True when ``table`` is a row-pair-packed 16-bit table (32-bit integer
    storage: int32 = packed bf16, uint32 = packed fp16)."""
    return table.dtype in _STORE


def half_dtype(store: Union[torch.Tensor, torch.dtype]) -> torch.dtype:
    """The 16-bit float type packed into a storage (or logical) dtype."""
    dt = store.dtype if torch.is_tensor(store) else store
    return torch.float16 if dt in (torch.uint32, torch.float16) else torch.bfloat16


def _store_dtype(half: torch.dtype) -> torch.dtype:
    """uint32 stores packed fp16 pairs; int32 packed bf16 pairs."""
    return torch.uint32 if half == torch.float16 else torch.int32


def logical_rows(table: torch.Tensor, n_logical: int) -> int:
    """Validate and return the logical row count backed by ``table``."""
    if is_packed(table):
        p = (n_logical + 1) // 2
        # plain, triplet-major (SGDM) or quintuplet-major (AdamW) store
        assert table.shape[0] in (p, 3 * p, 5 * p)
    return n_logical


def _flat(table: torch.Tensor) -> torch.Tensor:
    """Strip the optional leading unit (device) axis."""
    return table[0] if table.dim() == 3 else table


def _words(t: torch.Tensor) -> torch.Tensor:
    """The int32 view of 32-bit storage (int32, uint32 or float32)."""
    return t.view(torch.int32)


def _planes(words: torch.Tensor) -> torch.Tensor:
    """``(..., D)`` 32-bit words as an ``(..., D, 2)`` int16 view: ``[..., 0]``
    the low (even-row) halfwords, ``[..., 1]`` the high (odd-row) ones."""
    return words.view(torch.int16).unflatten(-1, (-1, 2))


def _join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Int32 words from their int16 low and high halfwords."""
    return torch.stack([lo, hi], dim=-1).view(torch.int32).squeeze(-1)


def _bits16(x: torch.Tensor, half: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """16-bit float values → their bit patterns, as int32 values in
    ``[0, 2^16)`` (elementwise)."""
    return x.to(half).view(torch.int16).to(torch.int32) & _LO


def _from_bits16(u: torch.Tensor, half: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Low 16 bits of integers (32-bit words, or int64 values) → 16-bit
    float values (elementwise)."""
    v = (u.view(torch.int32) if u.dtype == torch.uint32 else u) & _LO
    return torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16).view(half)


def pack_table(table: torch.Tensor) -> torch.Tensor:
    """Pack a logical ``(N, D)`` float table into 32-bit ``(ceil(N/2), D)``
    storage on its device: int32 when packing to bf16 (any table but an fp16
    one), uint32 when the table is fp16. An odd ``N`` gets one zero row of
    padding (never addressed by logical indices)."""
    n, d = table.shape
    half = half_dtype(table)
    x = table.to(half)
    if n % 2:
        x = torch.cat([x, torch.zeros((1, d), dtype=half, device=x.device)])
    h = x.view(torch.int16).reshape(-1, 2, d)
    return _join(h[:, 0], h[:, 1]).view(_store_dtype(half))


def unpack_table(packed: torch.Tensor, n_logical: int) -> torch.Tensor:
    """Inverse of :func:`pack_table` → 16-bit ``(n_logical, D)``."""
    p = _flat(packed)
    d = p.shape[-1]
    planes = _planes(_words(p))  # (P, D, 2)
    rows = planes.permute(0, 2, 1).reshape(-1, d)[:n_logical]
    return rows.contiguous().view(half_dtype(p))


def _bf16_bits_host(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even bf16 bit patterns (uint16) of a float array,
    through a CPU torch tensor (numpy has no bfloat16)."""
    if x.dtype.name == "bfloat16":  # an ml_dtypes array: its bits as they are
        return x.view(np.uint16)
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def pack_table_host(table: np.ndarray) -> np.ndarray:
    """Host-side (numpy) :func:`pack_table`, bit for bit the same: an fp16
    array packs to uint32 fp16 pairs, any other float array (a float32 one,
    or an ``ml_dtypes`` bfloat16 one) to int32 bf16 pairs."""
    n, d = table.shape
    fp16 = table.dtype == np.float16
    bits = table.view(np.uint16) if fp16 else _bf16_bits_host(table)
    bits = np.ascontiguousarray(bits)
    if n % 2:
        bits = np.concatenate([bits, np.zeros((1, d), np.uint16)])
    even = bits[0::2].astype(np.uint32)
    odd = bits[1::2].astype(np.uint32)
    return (even | (odd << 16)).view(np.uint32 if fp16 else np.int32)


def unpack_table_host(packed: np.ndarray, n_logical: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_table_host` → ``(n_logical, D)``:
    float16 for uint32 storage; float32 for int32 storage, whose bf16 values
    it holds exactly (numpy has no bfloat16)."""
    u = np.ascontiguousarray(packed).view(np.uint32)
    bits = np.empty((2 * u.shape[0], u.shape[1]), np.uint16)
    bits[0::2] = u & 0xFFFF
    bits[1::2] = u >> 16
    bits = bits[:n_logical]
    if packed.dtype == np.uint32:
        return bits.view(np.float16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def is_paired(table: torch.Tensor, n_logical: Optional[int]) -> bool:
    """True when ``table`` is a pair-major floating-point ``(2·n_logical, D)``
    table ``[param row 2i | momentum row 2i+1]`` (``RowSGDM``
    ``interleaved=True``). Detection is by the row count, so ``n_logical``
    must be the logical row count of the exact table passed."""
    t = _flat(table)
    return n_logical is not None and not is_packed(t) and t.shape[0] == 2 * n_logical


def is_tripled(table: torch.Tensor, n_logical: Optional[int]) -> bool:
    """True when ``table`` is a triplet-major packed store
    ``(3·ceil(n_logical/2), D)`` holding, per packed row ``p``, ``[packed
    16-bit param pair | fp32 momentum row 2p | momentum 2p+1]`` (``RowSGDM``
    ``interleaved=True`` on a packed table); same detection contract as
    :func:`is_paired`."""
    t = _flat(table)
    return (
        n_logical is not None
        and is_packed(t)
        and t.shape[0] == 3 * ((n_logical + 1) // 2)
        and n_logical > 0
    )


def is_quintupled(table: torch.Tensor, n_logical: Optional[int]) -> bool:
    """True when ``table`` is a quintuplet-major packed store
    ``(5·ceil(n_logical/2), D)`` holding, per packed row ``p``, ``[packed
    param pair | Adam mu 2p | mu 2p+1 | nu 2p | nu 2p+1]`` (``RowAdamW``
    ``interleaved=True`` on a packed table); same detection contract as
    :func:`is_tripled`."""
    t = _flat(table)
    return (
        n_logical is not None
        and is_packed(t)
        and n_logical > 0
        and t.shape[0] == 5 * ((n_logical + 1) // 2)
    )


def is_trebled(table: torch.Tensor, n_logical: Optional[int]) -> bool:
    """True when ``table`` is a treble-major floating-point
    ``(3·n_logical, D)`` table ``[param row 3i | Adam mu 3i+1 | Adam nu
    3i+2]`` (``RowAdamW`` ``interleaved=True``); same detection contract as
    :func:`is_paired`."""
    t = _flat(table)
    return (
        n_logical is not None
        and not is_packed(t)
        and n_logical > 0
        and t.shape[0] == 3 * n_logical
    )


def interleave_packed_state(
    packed: torch.Tensor, states: Sequence[Optional[torch.Tensor]]
) -> torch.Tensor:
    """Widen a packed ``(P, D)`` table into the block-major ``((1+2k)·P, D)``
    store (``k = len(states)``; ``k = 1``: :func:`is_tripled`, ``k = 2``:
    :func:`is_quintupled`), interleaving each fp32 logical-major ``(2P, D)``
    state (zeros when ``None``): per packed row ``p`` the block ``[packed |
    s0 2p | s0 2p+1 | s1 2p | ...]``. A leading unit axis is kept."""
    t = _flat(packed)
    if not is_packed(t):
        raise ValueError(
            "interleave_packed_state requires a row-pair-packed table; "
            "plain fp32 tables use optim.interleave_momentum/_adamw"
        )
    p, d = t.shape
    blocks = [_words(t)]
    for s in states:
        if s is None:
            sb = torch.zeros((2 * p, d), dtype=torch.int32, device=t.device)
        else:
            if tuple(s.shape) != (2 * p, d):
                raise ValueError(
                    f"state must be logical-major (2·{p}, {d}) fp32 — got {tuple(s.shape)}"
                )
            sb = _words(s.to(torch.float32).contiguous())
        blocks.extend([sb[0::2], sb[1::2]])
    stride = 1 + 2 * len(states)
    out = torch.stack(blocks, dim=1).reshape(stride * p, d).view(t.dtype)
    return out[None] if packed.dim() == 3 else out


def split_packed_state(
    table: torch.Tensor, k: int
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Inverse of :func:`interleave_packed_state`: ``((1+2k)·P, D) → ((P, D)
    packed params, k × (2P, D) fp32 states)``, the states in the
    logical-major shape of a separate-buffer run's moments. The params are a
    view of the store; a leading unit axis is kept on them."""
    t = _flat(table)
    stride = 1 + 2 * k
    if not is_packed(t) or t.shape[0] % stride:
        raise ValueError(
            f"expected a block-major packed ({stride}P, D) store; got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    d = t.shape[-1]
    blocks = t.reshape(t.shape[0] // stride, stride, d)
    packed = blocks[:, 0]
    states = [
        _words(blocks[:, 1 + 2 * j: 3 + 2 * j].reshape(-1, d)).view(torch.float32)
        for j in range(k)
    ]
    return (packed[None] if table.dim() == 3 else packed), states


def interleave_packed_momentum(
    packed: torch.Tensor, momentum: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Widen a packed table into the triplet-major ``(3P, D)`` store of
    :func:`is_tripled` (the ``k = 1`` case of :func:`interleave_packed_state`)."""
    return interleave_packed_state(packed, [momentum])


def split_packed_interleaved(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`interleave_packed_momentum`: ``(3P, D) → ((P, D)
    packed params, (2P, D) fp32 momentum)``."""
    try:
        packed, (mom,) = split_packed_state(table, 1)
    except ValueError:
        t = _flat(table)
        raise ValueError(
            f"expected a triplet-major packed (3P, D) store; got {t.dtype} {tuple(t.shape)}"
        ) from None
    return packed, mom


def interleave_packed_adamw(
    packed: torch.Tensor,
    mu: Optional[torch.Tensor] = None,
    nu: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Widen a packed table into the quintuplet-major ``(5P, D)`` store of
    :func:`is_quintupled` (``RowAdamW`` ``interleaved=True``)."""
    return interleave_packed_state(packed, [mu, nu])


def split_packed_adamw(
    table: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`interleave_packed_adamw`: ``(5P, D) → ((P, D)
    packed params, (2P, D) mu, (2P, D) nu)``."""
    packed, (mu, nu) = split_packed_state(table, 2)
    return packed, mu, nu


def _resolve_paired(t, n_logical, paired):
    """Explicit ``paired`` override with shape validation, else inference."""
    if paired is None:
        return is_paired(t, n_logical)
    if paired and (is_packed(t) or t.shape[0] % 2):
        raise ValueError(
            f"paired=True requires a plain fp32 pair-major (2N, D) table; "
            f"got {'packed' if is_packed(t) else 'odd-height'} {tuple(t.shape)}"
        )
    return paired


def _resolve_trebled(t, n_logical, trebled):
    """Explicit ``trebled`` override with shape validation, else inference."""
    if trebled is None:
        return is_trebled(t, n_logical)
    if trebled and (is_packed(t) or t.shape[0] % 3):
        raise ValueError(
            f"trebled=True requires a plain fp32 treble-major (3N, D) table; "
            f"got {'packed' if is_packed(t) else 'bad-height'} {tuple(t.shape)}"
        )
    return trebled


def _resolve_tripled(t, n_logical, tripled):
    """Explicit ``tripled`` override with shape validation, else inference."""
    if tripled is None:
        return is_tripled(t, n_logical)
    if tripled and (not is_packed(t) or t.shape[0] % 3):
        raise ValueError(
            f"tripled=True requires a triplet-major packed (3P, D) store; "
            f"got {t.dtype} {tuple(t.shape)}"
        )
    return tripled


def _packed_stride(t, n_logical, tripled) -> int:
    """Rows per packed row of a packed store: 3 (triplets), 5 (quintuplets)
    or 1 (a plain packed table)."""
    if _resolve_tripled(t, n_logical, tripled):
        return 3
    return 5 if is_quintupled(t, n_logical) else 1


def take_rows(
    table: torch.Tensor,
    idx: torch.Tensor,
    n_logical: Optional[int] = None,
    paired: Optional[bool] = None,
    tripled: Optional[bool] = None,
    trebled: Optional[bool] = None,
) -> torch.Tensor:
    """Logical rows ``idx`` (any shape) of a table in any layout, as
    ``(*idx.shape, D)``: ``table[idx]`` for a plain table; the param rows
    ``2·idx`` or ``3·idx`` of a pair- or treble-major one; for a packed
    table (plain, triplet or quintuplet store) one gather of the packed rows
    and a select of each row's halfword plane, in the table's 16-bit dtype.

    ``n_logical`` is the logical row count of the exact table passed: the
    interleaved layouts are told apart by their height. ``paired``,
    ``tripled`` and ``trebled`` override that inference.
    """
    t = _flat(table)
    flat_idx = idx.reshape(-1).long()
    paired = _resolve_paired(t, n_logical, paired)
    if not is_packed(t):
        if tripled:
            _resolve_tripled(t, n_logical, tripled)  # raises: not packed
        if paired:
            rows = t[2 * flat_idx]
        elif _resolve_trebled(t, n_logical, trebled):
            rows = t[3 * flat_idx]
        else:
            rows = t[flat_idx]
        return rows.reshape(*idx.shape, t.shape[-1])
    stride = _packed_stride(t, n_logical, tripled)
    planes = _planes(_words(t)[stride * (flat_idx >> 1)])  # (R, D, 2)
    odd = (flat_idx & 1).bool()[:, None]
    rows = torch.where(odd, planes[..., 1], planes[..., 0]).view(half_dtype(t))
    return rows.reshape(*idx.shape, t.shape[-1])


def take_contiguous_rows(
    table: torch.Tensor,
    start: int,
    w: int,
    n_logical: Optional[int] = None,
    paired: Optional[bool] = None,
    tripled: Optional[bool] = None,
    trebled: Optional[bool] = None,
) -> torch.Tensor:
    """Logical rows ``[start, start + w)`` of a table in any layout as a
    ``(w, D)`` tensor: a view for a plain, pair- or treble-major table (the
    latter two strided), the unpacked rows of a packed one, for which
    ``start`` and ``w`` must be even. A window outside the table raises.
    Windows over an interleaved table read its optimizer state too, so
    evaluation on its own should split the table first."""
    t = _flat(table)
    paired = _resolve_paired(t, n_logical, paired)
    if not is_packed(t):
        if tripled:
            _resolve_tripled(t, n_logical, tripled)  # raises: not packed
        h = 2 if paired else 3 if _resolve_trebled(t, n_logical, trebled) else 1
        if not 0 <= start <= t.shape[0] // h - w:
            raise ValueError(f"window [{start}, {start + w}) outside {t.shape[0] // h} rows")
        return t[h * start: h * (start + w)].reshape(w, h, -1)[:, 0]
    if start % 2 or w % 2:
        raise ValueError(f"a packed table's window starts and ends on even rows, got"
                         f" [{start}, {start + w})")
    stride = _packed_stride(t, n_logical, tripled)
    if not 0 <= start // 2 <= t.shape[0] // stride - w // 2:
        raise ValueError(
            f"window [{start}, {start + w}) outside {2 * (t.shape[0] // stride)} rows")
    blk = _words(t)[stride * (start // 2): stride * (start // 2 + w // 2)]
    planes = _planes(blk.reshape(w // 2, stride, -1)[:, 0])  # (w/2, D, 2)
    rows = planes.permute(0, 2, 1).reshape(w, -1)
    return rows.contiguous().view(half_dtype(t))


def _sibling_runs(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For SORTED logical indices: ``(odd, sib_pos, present)``. A row's
    sibling (logical id ``idx ^ 1``, the other plane of its packed row), if
    written at all, is exactly the adjacent run: right after this run for an
    even id, right before it for an odd one. ``sib_pos`` is that run's
    nearest slot, clamped into range, and ``present`` says whether the
    sibling is there."""
    r = idx.shape[0]
    iota = torch.arange(r, dtype=torch.int64, device=idx.device)
    true = torch.ones(1, dtype=torch.bool, device=idx.device)
    brk = idx[1:] != idx[:-1]
    # run boundaries as running maxima/minima over run flags: no search
    left = torch.cummax(torch.where(torch.cat([true, brk]), iota, -1), 0).values
    last = torch.flip(torch.cummin(torch.flip(
        torch.where(torch.cat([brk, true]), iota, r), [0]), 0).values, [0])
    odd = (idx & 1).bool()
    sib_pos = torch.where(odd, left - 1, last + 1)
    in_range = (sib_pos >= 0) & (sib_pos < r)
    sib_pos = sib_pos.clamp(0, r - 1)
    present = in_range & (idx[sib_pos] == torch.where(odd, idx - 1, idx + 1))
    return odd, sib_pos, present


def _merged_words(
    cur: torch.Tensor, own: torch.Tensor, odd: torch.Tensor, sib_pos: torch.Tensor,
    present: torch.Tensor,
) -> torch.Tensor:
    """Packed words of the sorted-adjacency merge: each slot's own int16
    plane ``own``, its sibling's new plane where the sibling is written, else
    the sibling plane of the current words ``cur``."""
    planes = _planes(cur)
    odd = odd[:, None]
    cur_sib = torch.where(odd, planes[..., 0], planes[..., 1])
    sib = torch.where(present[:, None], own[sib_pos], cur_sib)
    return _join(torch.where(odd, sib, own), torch.where(odd, own, sib))


def _segmented_or(v: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive bitwise-OR scan of ``v`` (along dim 0) within runs of equal
    ``seg``: ``log2(R)`` shift-and-OR passes."""
    r, s = v.shape[0], 1
    while s < r:
        same = seg[s:] == seg[:-s]
        same = same.reshape(-1, *([1] * (v.dim() - 1)))
        v = torch.cat([v[:s], torch.where(same, v[s:] | v[:-s], v[s:])])
        s *= 2
    return v


def merge_packed_row_writes(
    packed: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, sorted_idx: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Turn logical-row writes into duplicate-safe packed-row writes.

    :param packed: the packed table (optionally with a leading unit axis),
        read for the planes nobody writes.
    :param idx: (R,) logical row indices; occurrences of the same logical
        row carry identical ``rows`` (the optimizer's dedup contract).
    :param rows: (R, D) new logical rows (any float dtype; cast to the
        table's 16-bit dtype).
    :param sorted_idx: ``idx`` is sorted ascending: the sibling plane comes
        from the adjacent run (no sort, no scan). Otherwise the writes are
        sorted by packed row and their planes combined by a segmented
        bitwise OR.
    :return: ``(packed_idx, packed_rows)``: (R,) sorted packed-row indices
        and (R, D) packed rows in the table's storage dtype, byte-identical
        across the occurrences of one packed row, ready for
        ``scatter_rows(..., skip_dups=True)``.
    """
    t = _flat(packed)
    words, half = _words(t), half_dtype(t)
    p = idx >> 1
    own = rows.to(half).view(torch.int16)
    if sorted_idx:
        odd, sib_pos, present = _sibling_runs(idx)
        merged = _merged_words(words[p.long()], own, odd, sib_pos, present)
        return p, merged.view(t.dtype)
    # Each occurrence's own plane (the other plane zero), and its plane mask.
    odd = (idx & 1).bool()
    zero = torch.zeros_like(own)
    placed = _join(torch.where(odd[:, None], zero, own), torch.where(odd[:, None], own, zero))
    mask = torch.where(odd, _HI, _LO).to(torch.int32)
    sp, order = torch.sort(p, stable=True)
    first = torch.ones_like(sp, dtype=torch.bool)
    first[1:] = sp[1:] != sp[:-1]
    seg = torch.cumsum(first.long(), 0)
    tot_v = _segmented_or(placed[order], seg)
    tot_m = _segmented_or(mask[order], seg)
    # each slot reads its segment's total at the segment's last slot
    r = sp.shape[0]
    iota = torch.arange(r, dtype=torch.int64, device=idx.device)
    is_last = torch.cat([first[1:], torch.ones(1, dtype=torch.bool, device=idx.device)])
    seg_end = torch.flip(torch.cummin(torch.flip(torch.where(is_last, iota, r), [0]), 0).values,
                         [0])
    tot_v, tot_m = tot_v[seg_end], tot_m[seg_end][:, None]
    merged = (tot_v & tot_m) | (words[sp.long()] & ~tot_m)
    return sp, merged.view(t.dtype)


def merge_packed_block_writes(
    store: torch.Tensor,
    idx: torch.Tensor,
    rows: torch.Tensor,
    mom_list: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Turn logical-row (param, k fp32 state rows) writes into duplicate-safe
    ``(1+2k, D)``-block writes on a block-major packed store (``k = 1``: the
    triplets of :func:`is_tripled`; ``k = 2``: the quintuplets of
    :func:`is_quintupled`).

    :param store: the ``((1+2k)·P, D)`` store (optionally with a leading
        unit axis), read for the planes and rows nobody writes.
    :param idx: (R,) logical row indices, sorted, with duplicate-identical
        ``rows`` and ``mom_list`` content (the dedup contract).
    :param rows: (R, D) new logical param rows (cast to the store's 16-bit
        dtype).
    :param mom_list: k (R, D) fp32 state rows (momentum; Adam mu, nu).
    :return: ``(phys, out_rows)``: (R,) physical block starts
        ``(1+2k)·(idx >> 1)`` and ``((1+2k)·R, D)`` rows in the storage
        dtype, slot ``i`` the block ``[merged packed params | state0 row 2p |
        state0 row 2p+1 | state1 row 2p | ...]``, byte-identical across the
        occurrences of one packed row, ready for ``scatter_rows(...,
        slice_rows=1+2k, skip_dups=True)``. A sibling row's state, like its
        plane, comes from the adjacent run when written, else from the store.
    """
    t = _flat(store)
    words, half = _words(t), half_dtype(t)
    stride = 1 + 2 * len(mom_list)
    p = idx >> 1
    base = stride * p.long()
    odd, sib_pos, present = _sibling_runs(idx)
    own = rows.to(half).view(torch.int16)
    blocks = [_merged_words(words[base], own, odd, sib_pos, present)]
    sib_off = torch.where(odd, 0, 1)  # the sibling's parity
    odd, present = odd[:, None], present[:, None]
    for j, mom_rows in enumerate(mom_list):
        mbits = _words(mom_rows.to(torch.float32).contiguous())
        m_sib = torch.where(present, mbits[sib_pos], words[base + 1 + 2 * j + sib_off])
        blocks.append(torch.where(odd, m_sib, mbits))  # row 2p
        blocks.append(torch.where(odd, mbits, m_sib))  # row 2p+1
    out = torch.stack(blocks, dim=1).reshape(stride * idx.shape[0], t.shape[-1])
    return stride * p, out.view(t.dtype)


def merge_packed_triplet_writes(
    store: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, mom_rows: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, D)-block writes on a triplet-major store: the ``k = 1`` case of
    :func:`merge_packed_block_writes`."""
    return merge_packed_block_writes(store, idx, rows, [mom_rows])
