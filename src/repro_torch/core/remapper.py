"""The address remapper (paper SS V.C); own copy of the reference's
``core/remapper.py``.

Transitions Gemmini's explicit scratchpad addressing to a *semi-explicit*
form: DMA streams into the scratchpad are intercepted and redirected (via a
dynamic offset) into banks that are either partially filled and locked by
the task, or currently unlocked.  A 4 KB remapping block records
logical->physical ranges; banklock semaphores mark banks holding valid data.

The OS-visible contract: the scheduler only tracks *how many* banks a task
holds (eta_i) — which banks and at what offsets is resolved in hardware.
When local memory suffices, a context switch needs **zero scratchpad data
movement** (the next task simply locks other banks) — that is the paper's
20-30 % context-switch acceleration (Obs. 1).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.core.isa import BANK_BYTES, REMAP_BLOCK_BYTES, SCRATCHPAD_BANKS


@dataclasses.dataclass
class Bank:
    idx: int
    owner: Optional[int] = None      # task id holding the banklock
    used_bytes: int = 0

    @property
    def locked(self) -> bool:
        return self.owner is not None


class AddressRemapper:
    """Bank allocation + logical->physical mapping."""

    def __init__(self, n_banks: int = SCRATCHPAD_BANKS,
                 bank_bytes: int = BANK_BYTES):
        self.banks = [Bank(i) for i in range(n_banks)]
        self.bank_bytes = bank_bytes
        # remapping block: logical (tid, laddr_range) -> (bank, offset)
        self.remap_block: Dict[Tuple[int, int], Tuple[int, int]] = {}
        # incremental per-owner aggregates (the scheduler's hot queries);
        # write()/release() are the only mutators, so these stay exact
        self._owner_banks: Dict[int, int] = {}
        self._owner_bytes: Dict[int, int] = {}
        # free bank indices as a min-heap (lowest-index-first, matching
        # the original first-free scan) + each task's single partial bank
        self._free_heap: List[int] = list(range(n_banks))
        self._partial: Dict[int, Bank] = {}
        self._keys_by_tid: Dict[int, List[Tuple[int, int]]] = {}

    # -- queries ------------------------------------------------------------
    def locked_banks(self, exclude_tid: Optional[int] = None) -> int:
        n = len(self.banks) - len(self._free_heap)
        if exclude_tid is not None:
            n -= self._owner_banks.get(exclude_tid, 0)
        return n

    def free_banks(self) -> int:
        return len(self._free_heap)

    def banks_of(self, tid: int) -> List[int]:
        return [b.idx for b in self.banks if b.owner == tid]

    def resident_bytes(self, tid: int) -> int:
        return self._owner_bytes.get(tid, 0)

    def resident_tasks(self) -> List[int]:
        return sorted(self._owner_banks)

    def fits(self, eta: int, exclude_tid: Optional[int] = None) -> bool:
        """Paper Alg.1 line 35: next->banks + locked <= total."""
        return eta + self.locked_banks(exclude_tid) <= len(self.banks)

    # -- DMA write interception (Fig. 5.b/e) ---------------------------------
    def write(self, tid: int, laddr: int, nbytes: int,
              strict: bool = False) -> int:
        """Route a DMA write; returns the physical bank.  Fills a partially
        used locked bank of this task first, else locks a free bank.  When
        the scratchpad is contended the write saturates (data stays in
        DRAM) unless ``strict``.

        The remapping block records one logical->physical entry per
        written range (keyed by the range's starting ``laddr``); the
        per-bank spill points are hardware-internal and not observable
        through :meth:`read`.
        """
        remaining = nbytes
        last_bank = -1
        bb = self.bank_bytes
        bank = self._partial.get(tid)     # a task has <=1 partial bank
        entry = None
        while remaining > 0:
            if bank is None:
                if not self._free_heap:
                    self._partial.pop(tid, None)
                    break
                bank = self.banks[heapq.heappop(self._free_heap)]
                bank.owner = tid
                bank.used_bytes = 0
                self._owner_banks[tid] = self._owner_banks.get(tid, 0) + 1
            take = min(remaining, bb - bank.used_bytes)
            if entry is None:
                entry = (bank.idx, bank.used_bytes)
            bank.used_bytes += take
            remaining -= take
            last_bank = bank.idx
            if bank.used_bytes >= bb:
                bank = None               # full: next round grabs a free one
        else:
            if bank is not None:
                self._partial[tid] = bank
            else:
                self._partial.pop(tid, None)
        if entry is not None:
            self._owner_bytes[tid] = self._owner_bytes.get(tid, 0) \
                + (nbytes - remaining)
            key = (tid, laddr)
            if key not in self.remap_block:
                self._keys_by_tid.setdefault(tid, []).append(key)
            self.remap_block[key] = entry
        if remaining > 0 and strict:
            raise MemoryError(f"scratchpad exhausted for task {tid}")
        return last_bank

    def read(self, tid: int, laddr: int) -> Optional[Tuple[int, int]]:
        """Consult the remapping block (Fig. 5.c/d)."""
        return self.remap_block.get((tid, laddr))

    # -- context-switch support ----------------------------------------------
    def release(self, tid: int):
        """Deactivate banklocks + flush the task's ranges (task end/evict)."""
        if tid not in self._owner_banks:
            return
        for b in self.banks:
            if b.owner == tid:
                b.owner = None
                b.used_bytes = 0
                heapq.heappush(self._free_heap, b.idx)
        self._owner_banks.pop(tid)
        self._owner_bytes.pop(tid, None)
        self._partial.pop(tid, None)
        rb = self.remap_block
        for k in self._keys_by_tid.pop(tid, ()):
            rb.pop(k, None)

    def snapshot(self, tid: int) -> dict:
        """Remap-block content shipped to DRAM on context save."""
        rb = self.remap_block
        return {k: rb[k] for k in self._keys_by_tid.get(tid, ())}

    def restore(self, tid: int, snap: dict, nbytes: int):
        """Re-load data on context restore into freshly allocated banks;
        the remapping block entry is re-established by the write (the
        saved ``snap`` records the old physical placement, which the
        new allocation supersedes)."""
        del snap
        if nbytes > 0:
            self.write(tid, 0, nbytes)

    @property
    def remap_block_bytes(self) -> int:
        return REMAP_BLOCK_BYTES
