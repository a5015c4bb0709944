"""Block-paged KV-cache pool for the serving engine (counterpart of
``mxnet_tpu/serving/kvcache.py``).

The pool slices the cache into fixed-size pages and gives every sequence a
page table, so device memory held is proportional to the tokens actually
cached, sequences join and leave the decode batch without copying, and
eviction is "return the pages".

Device layout (one pool per engine, shared by every sequence):

    k_pool, v_pool : (num_layers, pages, num_kv_heads, page_size, head_dim)

Page ``0`` is a reserved scratch page that is never allocated: the engine
routes writes of padded batch rows and padded prompt positions there, so
the step never branches on row validity; gathers of real rows see only
their own pages, and positions past a row's length are masked with the
flash-attention ``NEG_INF`` convention, whose softmax weight is exactly
0.0.  The pools are torch tensors on the engine's device, written in place;
``release()`` drops them (a closed engine gives its pool back at once).

Host-side state (page tables, the free list) is plain Python guarded by one
lock; it is touched a handful of times per step, never per token.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["PagedKVCache", "pages_for"]


def pages_for(n_tokens, page_size):
    """Pages needed to hold ``n_tokens`` (at least one: a sequence owns a
    page from admission so its first decode step has somewhere to write)."""
    return max(1, -(-int(n_tokens) // int(page_size)))


class PagedKVCache:
    """Page allocator + device pools.  The engine owns the scatter/gather;
    this class owns which page belongs to whom."""

    def __init__(self, num_layers, num_kv_heads, head_dim, pages, page_size,
                 dtype=torch.float32, device=None):
        if pages < 2:
            raise MXNetError("PagedKVCache needs >= 2 pages (page 0 is the "
                             "reserved scratch page)")
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.pages = int(pages)
        self.page_size = int(page_size)
        self.dtype = dtype
        self.device = resolve_device(device)
        shape = (self.num_layers, self.pages, self.num_kv_heads,
                 self.page_size, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._nbytes = 2 * self.k_pool.numel() * self.k_pool.element_size()
        self._lock = threading.Lock()
        self._free = list(range(self.pages - 1, 0, -1))  # pop() -> page 1 first
        self._tables: dict = {}                          # seq_id -> [page,...]

    # -- capacity ----------------------------------------------------------
    @property
    def pages_free(self):
        with self._lock:
            return len(self._free)

    @property
    def pages_used(self):
        with self._lock:
            return (self.pages - 1) - len(self._free)

    def nbytes(self):
        """Device bytes of both pools (their size, also after release)."""
        return self._nbytes

    def release(self):
        """Drop the device pools (idempotent): the pool is unusable after,
        and its memory goes back to the allocator as soon as no step
        holds a view of it."""
        self.k_pool = self.v_pool = None

    # -- allocation --------------------------------------------------------
    def alloc(self, seq_id, n_tokens):
        """Give ``seq_id`` a table covering ``n_tokens``.  True on success;
        False when the pool cannot cover it (never partially allocates)."""
        need = pages_for(n_tokens, self.page_size)
        with self._lock:
            if seq_id in self._tables:
                raise MXNetError(f"seq {seq_id!r} already allocated")
            if need > len(self._free):
                return False
            self._tables[seq_id] = [self._free.pop() for _ in range(need)]
            return True

    def ensure(self, seq_id, n_tokens):
        """Grow ``seq_id``'s table to cover ``n_tokens`` (no-op when it
        already does).  False, table untouched, when out of pages."""
        need = pages_for(n_tokens, self.page_size)
        with self._lock:
            table = self._tables[seq_id]
            grow = need - len(table)
            if grow <= 0:
                return True
            if grow > len(self._free):
                return False
            table.extend(self._free.pop() for _ in range(grow))
            return True

    def free(self, seq_id):
        """Return ``seq_id``'s pages to the pool (idempotent).  Returns the
        number of pages released."""
        with self._lock:
            table = self._tables.pop(seq_id, None)
            if not table:
                return 0
            self._free.extend(table)
            return len(table)

    def table(self, seq_id):
        with self._lock:
            return list(self._tables[seq_id])

    def holds(self, seq_id):
        with self._lock:
            return seq_id in self._tables

    def table_rows(self, seq_ids, n_pages):
        """Page tables for ``seq_ids`` as row lists padded to ``n_pages``
        with the scratch page; ids of None (padded batch rows) get an
        all-scratch row."""
        rows = []
        with self._lock:
            for sid in seq_ids:
                table = self._tables.get(sid, ()) if sid is not None else ()
                if len(table) > n_pages:
                    raise MXNetError(
                        f"seq {sid!r} holds {len(table)} pages > page "
                        f"bucket {n_pages}")
                rows.append(list(table) + [0] * (n_pages - len(table)))
        return rows
