"""Spatial hash for voxel-block coordinates, in plain fixed-shape torch ops.

The same open-addressing table as the JAX package (``int32`` keys and
values, ``EMPTY_KEY = -1``), filled in data-parallel rounds:

round r:  h = probe(key, r)
          - key already at table[h]            -> resolved
          - table[h] empty: scatter-claim; the winner of colliding scatters
            re-reads its own key back          -> resolved (new slot)
          - lost the claim or slot taken       -> continue to round r+1

Each newly claimed table slot gets a block index from a prefix sum over the
"newly claimed" mask. Every step is a fixed-shape gather, scatter or cumsum,
so an insert never waits on the host. Which of several colliding scatters
wins is arbitrary under torch (and differs from JAX), so two tables built
from the same keys hold the same key set, but not necessarily the same slot
numbers.

Block coordinates live in [-512, 512)^3 and pack into one non-negative int32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

EMPTY_KEY = -1
#: lookup miss marker in value arrays
MISS = -1

_COORD_BITS = 10
_COORD_OFFSET = 1 << (_COORD_BITS - 1)  # 512
_COORD_MASK = (1 << _COORD_BITS) - 1
_U32 = 0xFFFFFFFF


def pack_key(coords):
    """(..., 3) integer block coords -> (...,) packed non-negative int32."""
    c = coords.to(torch.int32) + _COORD_OFFSET
    return c[..., 0] | (c[..., 1] << _COORD_BITS) | (c[..., 2] << (2 * _COORD_BITS))


def unpack_key(keys):
    """Packed int32 -> (..., 3) int32 block coords (EMPTY maps to garbage; mask it)."""
    k = keys.to(torch.int32)
    return torch.stack([(k & _COORD_MASK) - _COORD_OFFSET,
                        ((k >> _COORD_BITS) & _COORD_MASK) - _COORD_OFFSET,
                        ((k >> (2 * _COORD_BITS)) & _COORD_MASK) - _COORD_OFFSET], dim=-1)


def pack_key_np(coords) -> np.ndarray:
    """Host twin of :func:`pack_key`: (..., 3) integer coords -> int32 keys,
    the same 10-bit packing, for bookkeeping on the host."""
    c = np.asarray(coords).astype(np.int64) + _COORD_OFFSET
    return (c[..., 0] | (c[..., 1] << _COORD_BITS)
            | (c[..., 2] << (2 * _COORD_BITS))).astype(np.int32)


def unpack_key_np(keys) -> np.ndarray:
    """Host twin of :func:`unpack_key`: int32 keys -> (..., 3) int32 coords."""
    k = np.asarray(keys).astype(np.int64)
    return np.stack([(k & _COORD_MASK) - _COORD_OFFSET,
                     ((k >> _COORD_BITS) & _COORD_MASK) - _COORD_OFFSET,
                     ((k >> (2 * _COORD_BITS)) & _COORD_MASK) - _COORD_OFFSET],
                    axis=-1).astype(np.int32)


def _mul_u32(h, c: int):
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32): split ``c`` in
    16-bit halves so no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix(k):
    """Finalizer-style integer hash (fmix32), uint32 arithmetic held in int64."""
    h = k.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _probe_slot(keys, r: int, capacity: int):
    """Table slot (int64) for probe round r: linear probing from the mixed hash."""
    return (_mix(keys) + r) & (capacity - 1)


class HashTable(NamedTuple):
    """Open-addressing table: keys[capacity] (EMPTY_KEY = free) and
    vals[capacity] (block slot index)."""

    keys: torch.Tensor  # int32[C]
    vals: torch.Tensor  # int32[C]

    @staticmethod
    def empty(capacity: int, device) -> "HashTable":
        return HashTable(
            keys=torch.full((capacity,), EMPTY_KEY, dtype=torch.int32, device=device),
            vals=torch.full((capacity,), MISS, dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def lookup(table: HashTable, query_keys, max_probes: int = 16):
    """Batch lookup. Returns int32 vals (MISS where absent)."""
    q = query_keys.to(torch.int32)
    found = torch.full_like(q, MISS)
    done = q == EMPTY_KEY  # empty queries resolve to MISS immediately
    for r in range(max_probes):
        slots = _probe_slot(q, r, table.capacity)
        k_at = table.keys[slots]
        hit = (k_at == q) & ~done
        found = torch.where(hit, table.vals[slots], found)
        # an EMPTY slot on the probe chain proves absence -> stop probing
        done = done | hit | (k_at == EMPTY_KEY)
    return found


def insert(table: HashTable, counter, new_keys, capacity_limit: int, max_probes: int = 16
           ) -> Tuple[HashTable, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch insert-or-get. Returns (table, counter, vals, overflowed).

    - ``counter``: int32 0-d tensor, number of allocated block slots so far.
    - ``vals``: per-query block slot (existing or newly allocated; MISS only
      if unresolved after max_probes or the pool is full).
    - ``overflowed``: bool 0-d tensor — some key FAILED to get a slot this
      call (pool full at claim time, or probe chain exhausted).

    Lanes with ``new_keys == EMPTY_KEY`` are inert (use as padding). The
    input table is not modified.
    """
    q = new_keys.to(torch.int32)
    cap = table.capacity
    keys_arr, vals_arr = table.keys, table.vals
    out_vals = torch.full_like(q, MISS)
    pending = q != EMPTY_KEY
    dropped = torch.zeros((), dtype=torch.bool, device=q.device)
    trash = keys_arr.new_full((1,), EMPTY_KEY)
    for r in range(max_probes):
        slots = _probe_slot(q, r, cap)
        k_at = keys_arr[slots]

        # 1) already present
        hit = pending & (k_at == q)
        out_vals = torch.where(hit, vals_arr[slots], out_vals)
        pending = pending & ~hit

        # 2) scatter-claim empty slots (losers keep probing next round);
        #    index ``cap`` is a trash row that absorbs the non-claimants
        want = pending & (k_at == EMPTY_KEY)
        claim = torch.where(want, slots, cap)
        old_keys = keys_arr
        keys_arr = torch.cat([keys_arr, trash]).scatter_(0, claim, q)[:cap]
        newly = (old_keys == EMPTY_KEY) & (keys_arr != EMPTY_KEY)

        # 3) allocate block indices for freshly claimed slots via prefix sum
        n_new = newly.to(torch.int32)
        alloc = counter + torch.cumsum(n_new, 0, dtype=torch.int32) - 1
        ok = newly & (alloc < capacity_limit)
        # full pool: roll back the claim so the slot stays reusable
        dropped = dropped | torch.any(newly & ~ok)
        keys_arr = torch.where(newly & ~ok, old_keys, keys_arr)
        vals_arr = torch.where(ok, alloc, vals_arr)
        counter = torch.clamp_max(counter + n_new.sum(dtype=torch.int32), capacity_limit)

        # 4) winners read their value back
        got = vals_arr[slots]
        resolved = pending & (keys_arr[slots] == q) & (got != MISS)
        out_vals = torch.where(resolved, got, out_vals)
        pending = pending & ~resolved
    overflowed = dropped | torch.any(pending)
    return HashTable(keys_arr, vals_arr), counter, out_vals, overflowed


def build_table(keys, slot_vals, capacity: int, max_probes: int = 16
                ) -> Tuple[HashTable, torch.Tensor]:
    """A fresh table mapping unique ``keys[i] -> slot_vals[i]``: explicit
    values instead of the counter's allocation, for a pool whose layout
    already exists (a compacted pool). The same scatter-claim rounds as
    :func:`insert`; lanes with ``keys == EMPTY_KEY`` are inert. Returns
    (table, ok_all), ``ok_all`` a bool 0-d tensor that is false when some
    key found no slot within ``max_probes`` rounds."""
    q = keys.to(torch.int32)
    v = slot_vals.to(torch.int32)
    # row ``capacity`` is a trash row that absorbs the non-claimants
    keys_arr = torch.full((capacity + 1,), EMPTY_KEY, dtype=torch.int32, device=q.device)
    vals_arr = torch.full((capacity + 1,), MISS, dtype=torch.int32, device=q.device)
    pending = q != EMPTY_KEY
    for r in range(max_probes):
        slots = _probe_slot(q, r, capacity)
        want = pending & (keys_arr[slots] == EMPTY_KEY)
        keys_arr.scatter_(0, torch.where(want, slots, capacity), q)
        won = pending & (keys_arr[slots] == q)
        vals_arr.scatter_(0, torch.where(won, slots, capacity), v)
        pending = pending & ~won
    return HashTable(keys_arr[:capacity], vals_arr[:capacity]), ~torch.any(pending)
