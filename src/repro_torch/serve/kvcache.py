"""Paged KV-cache: fixed-size pages + per-slot block tables.

Port of ``repro/serve/kvcache.py``.  The device side is one K/V page pool
per attention layer (``transformer.init_paged_cache``):
``[n_pages, page_size, KH, D]`` with no batch axis.  This host-side manager
owns the *placement*: a block table ``[n_slots, p_max]`` mapping each
slot's logical page index to a pool page (-1 = unallocated), a free list,
and reservation accounting.

Invariants the engine relies on:

* **No zeroing on reuse.**  A freed page goes straight back on the free
  list; whatever K/V it held stays in the pool.  Safe because the paged
  attention mask is ``k_pos <= q_pos`` over the slot's own block table:
  stale rows only surface at logical positions >= the new sequence's
  length, which the mask kills.
* **Reservation-based admission (deadlock freedom).**  ``admit`` succeeds
  only if the free list minus every active slot's *outstanding* pages
  (reserved - held) covers the request's worst case
  (``prompt + max_new - 1`` tokens: the last generated token is returned,
  never written).  Pages are then allocated lazily (``ensure``) as the
  sequence grows, but can never run out mid-flight, so the engine needs no
  preemption or swap path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf
from ..tree import tree_leaves

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Host manager for the device page pools of ``n_slots`` sequences."""

    def __init__(self, cfg: ModelConfig, *, n_slots: int, n_pages: int,
                 page_size: int, max_len: int, dtype=torch.float32,
                 device="cuda"):
        if max_len % page_size:
            max_len += page_size - max_len % page_size
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_len = max_len
        self.p_max = max_len // page_size
        self.pages = tf.init_paged_cache(cfg, n_pages, page_size, dtype,
                                         device=self.device)
        self.block_tables = np.full((n_slots, self.p_max), -1, np.int32)
        self._free = list(range(n_pages - 1, -1, -1))   # pop() -> low ids first
        self._reserved = np.zeros(n_slots, np.int64)    # worst-case pages/slot
        self.peak_pages_used = 0

    # -- accounting ---------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size)

    def held(self, slot: int) -> int:
        return int(np.sum(self.block_tables[slot] >= 0))

    def outstanding(self) -> int:
        """Pages promised to active slots but not yet allocated."""
        held = np.sum(self.block_tables >= 0, axis=1)
        return int(np.sum(np.maximum(self._reserved - held, 0)))

    def free_pages(self) -> int:
        return len(self._free)

    def can_admit(self, total_tokens: int) -> bool:
        return (self.free_pages() - self.outstanding()
                >= self.pages_needed(total_tokens))

    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.pages))

    def used_bytes(self) -> int:
        """Bytes of pool actually backing live sequences right now."""
        per_page = self.pool_bytes() // self.n_pages
        return int(np.sum(self.block_tables >= 0)) * per_page

    # -- slot lifecycle -----------------------------------------------------

    def admit(self, slot: int, total_tokens: int) -> None:
        """Reserve the worst-case page budget for a sequence that will write
        ``total_tokens`` KV rows.  Caller must have checked can_admit."""
        need = self.pages_needed(total_tokens)
        if self.block_tables[slot].max() >= 0 or self._reserved[slot]:
            raise RuntimeError(f"slot {slot} already active")
        if self.free_pages() - self.outstanding() < need:
            raise RuntimeError(
                f"admit without capacity: need {need}, free "
                f"{self.free_pages()}, outstanding {self.outstanding()}")
        self._reserved[slot] = need

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Lazily allocate pages so positions [0, n_tokens) are backed."""
        need = self.pages_needed(n_tokens)
        if need > self.p_max:
            raise RuntimeError(
                f"slot {slot}: {n_tokens} tokens exceed max_len "
                f"{self.max_len}")
        row = self.block_tables[slot]
        for j in range(need):
            if row[j] < 0:
                row[j] = self._free.pop()
        used = int(np.sum(self.block_tables >= 0))
        self.peak_pages_used = max(self.peak_pages_used, used)

    def release(self, slot: int) -> None:
        """Return the slot's pages to the free list (no zeroing, see the
        module docstring) and clear its reservation."""
        row = self.block_tables[slot]
        for j in range(self.p_max):
            if row[j] >= 0:
                self._free.append(int(row[j]))
                row[j] = -1
        self._reserved[slot] = 0

    # -- device view --------------------------------------------------------

    def device_tables(self) -> torch.Tensor:
        return torch.from_numpy(self.block_tables.copy()).to(self.device)
