"""KV-cache managers: page accounting, block manager and the paged pool.

A copy of the reference ``repro.serving.kv_cache`` whose device side
uses torch tensors updated in place.

Two layouts coexist behind the engine's ``kv_layout`` switch:

* ``contig`` — a fixed pool of per-sequence slot caches
  (:class:`SlotPool`): each slot owns ``max_len`` cache rows per global
  layer and a ring per sliding-window layer.

* ``paged`` — :class:`BlockManager` + :class:`PagedSlotPool`: the KV store
  is a pool of fixed-size pages (``page_size`` tokens each) shared by all
  sequences, addressed through per-request block tables. Preemption can
  then free *or retain* memory at page granularity: a preempted request's
  pages stay resident while memory allows, and re-admission re-links them
  into the new slot's block-table row without any copy ("copy-on-admit" is
  a table write, not a cache move), so only evicted pages are recomputed.
  This is the mechanism the paper's Section 3.3 preemption-cost discussion
  assumes away — paging makes the C-limit sweep's recompute term smaller.

With ``prefix_cache=True`` the paged layout additionally shares identical
KV *prefixes across requests*: full prompt pages are registered in a
chained content-hash index, later requests link matching pages by
refcount bump + block-table write (no prefill compute), writes into
shared pages copy-on-write, and refcount-zero indexed pages park in a
reusable LRU pool — warm for the next hit, reclaimable under pressure.
See :class:`BlockManager` for the invariants.

``bytes_for_context`` is the arch-aware preemption-cost function m(age)
from DESIGN.md section 4: dense KV grows linearly with context,
sliding-window layers clamp at the window, SSM layers cost O(1) state.
``paged_bytes_for_context`` is its page-granular counterpart (token counts
round up to whole pages — the fragmentation the scheduler must budget
for). The scheduler uses these both for the admission budget and
(implicitly, via the paper's C*r rule) for limiting preemption.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.config import (KIND_ATTN, KIND_HYBRID, KIND_LOCAL, KIND_MOE,
                                KIND_SSM, KIND_SSM_MOE, SSM_KINDS,
                                ModelConfig)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.ssm import ssm_dims


def dtype_bytes(cfg: ModelConfig) -> int:
    """Bytes per element of the cache dtype."""
    return torch_dtype(cfg.dtype).itemsize


def bytes_per_token_kind(cfg: ModelConfig, kind: str) -> int:
    """KV bytes one token adds in one layer of this kind (0 for SSM)."""
    if kind in (KIND_SSM, KIND_SSM_MOE):
        return 0
    if cfg.kv_quant:     # int8 payload + f32 per-(token,head) scales
        return 2 * (cfg.kv_dim * 1 + cfg.num_kv_heads * 4)
    return 2 * cfg.kv_dim * dtype_bytes(cfg)


def ssm_state_bytes(cfg: ModelConfig) -> int:
    """Fixed per-request SSM recurrent-state bytes (f32 state + conv)."""
    d_in, nh, conv_ch = ssm_dims(cfg)
    n = cfg.ssm_groups * cfg.ssm_state
    return 4 * (nh * cfg.ssm_head_dim * n) + 4 * (cfg.ssm_conv - 1) * conv_ch


@functools.lru_cache(maxsize=1 << 16)
def bytes_for_context(cfg: ModelConfig, context_len: int) -> int:
    """Total per-request cache bytes at a given context length.

    Memoized on the (hashable, frozen) config and length: ``select_batch``
    evaluates this per candidate per iteration, and at large request
    counts the layer_kinds walk dominated sim-mode scheduling cost.
    """
    total = 0
    for kind in cfg.layer_kinds:
        per_tok = bytes_per_token_kind(cfg, kind)
        if kind in (KIND_LOCAL, KIND_HYBRID) and cfg.sliding_window:
            total += per_tok * min(context_len, cfg.sliding_window)
        else:
            total += per_tok * context_len
        if kind in SSM_KINDS:
            total += ssm_state_bytes(cfg)
    if cfg.cross_attention and cfg.encoder_seq:
        total += (cfg.num_layers * 2 * cfg.kv_dim * dtype_bytes(cfg)
                  * cfg.encoder_seq)
    return total


def pages_for_tokens(tokens: int, page_size: int) -> int:
    """Whole pages needed to hold ``tokens`` tokens."""
    return max(0, math.ceil(tokens / page_size))


@functools.lru_cache(maxsize=4096)
def page_bytes(cfg: ModelConfig, page_size: int) -> int:
    """KV bytes of one page across all non-SSM layers (window layers too:

    their ring buffers are page-sized in the accounting model).
    """
    per_tok = sum(bytes_per_token_kind(cfg, kind) for kind in cfg.layer_kinds)
    return per_tok * page_size


@functools.lru_cache(maxsize=1 << 16)
def paged_bytes_for_context(cfg: ModelConfig, context_len: int,
                            page_size: int) -> int:
    """Page-granular m(age).

    Like ``bytes_for_context`` but every token
    count rounds up to whole pages, exposing allocation fragmentation.
    SSM state and cross-attention caches are unpaged (fixed-size).
    Memoized like ``bytes_for_context`` (same per-entry-per-iteration
    call pattern in the scheduler's bytes_fn).
    """
    rounded = pages_for_tokens(context_len, page_size) * page_size
    total = 0
    for kind in cfg.layer_kinds:
        per_tok = bytes_per_token_kind(cfg, kind)
        if kind in (KIND_LOCAL, KIND_HYBRID) and cfg.sliding_window:
            win = min(context_len, cfg.sliding_window)
            total += per_tok * pages_for_tokens(win, page_size) * page_size
        else:
            total += per_tok * rounded
        if kind in SSM_KINDS:
            total += ssm_state_bytes(cfg)
    if cfg.cross_attention and cfg.encoder_seq:
        total += (cfg.num_layers * 2 * cfg.kv_dim * dtype_bytes(cfg)
                  * cfg.encoder_seq)
    return total


def supports_page_retention(cfg: ModelConfig) -> bool:
    """Whether this arch can keep preempted KV pages resident.

    Retention is only coherent when the
    *whole* recurrent state lives in pages: pure global-attention
    stacks (dense/MoE). SSM state, ring buffers and cross caches are
    per-slot and reset on release, so such archs fall back to
    discard-and-recompute (still with page-accurate accounting).
    """
    return (all(k in (KIND_ATTN, KIND_MOE) for k in cfg.layer_kinds)
            and not cfg.cross_attention and not cfg.kv_quant)


class BlockManager:
    """Free-list page allocator with per-request block tables.

    Physical page ids run ``first_id .. first_id + num_pages - 1``; id 0 is
    reserved as the null page (device ``pkpos`` stays -1 there forever, so
    unallocated block-table entries mask out cleanly). ``num_pages=0``
    means unbounded (sim-mode accounting, no device pool behind it).

    Per request the manager tracks the ordered list of *resident* pages
    (covering logical pages ``[0, len(pages))``), a count of tail pages
    swapped to host memory, and ``cached_tokens`` — how many prefix tokens
    the resident+host pages actually hold. Eviction and swap are tail-first
    so the retained portion is always a clean prefix.

    With ``prefix_cache=True`` pages become shareable across requests:

    * every allocated page carries a **refcount** (owners among live
      requests); pages are physically reclaimed only at refcount zero;
    * full prompt pages are registered in a **content-hash index** keyed
      on ``(parent_physical_id, token_block)`` — a chained key, so a hit
      on page *j* proves the whole prefix up to *j* matches;
    * a request whose prompt matches a chain of cached pages **links**
      them (block-table writes, refcount bumps) instead of re-prefilling;
    * pages whose refcount drops to zero while still indexed move to a
      **reusable** LRU pool: warm for future hits, yet counted as free
      capacity — the allocator reclaims LRU-first (deregistering the page
      and its now-unreachable descendants) when the free list runs dry;
    * writes into a shared page go through **copy-on-write**
      (`make_writable`): the writer gets a private copy, the shared page
      is never mutated in place.

    With the default ``prefix_cache=False`` nothing is indexed or shared
    and every refcount is 1, so behaviour is exactly the pre-prefix-cache
    manager. ``track_resets=True`` (set by :class:`PagedSlotPool`) logs
    page ids whose device state must be invalidated or copied; sim-mode
    managers leave it off so nothing accumulates.
    """

    def __init__(self, num_pages: int, page_size: int, first_id: int = 1,
                 prefix_cache: bool = False, track_resets: bool = False,
                 reusable_cap: int | None = None):
        """See the class docstring.

        ``reusable_cap`` bounds the reusable
        pool (warm refcount-zero pages). A bounded pool is naturally
        capped at ``num_pages``; unbounded (sim-mode) managers must pass
        a cap or the index/LRU bookkeeping grows with every unique prompt
        ever served — and, worse, models an infinitely large always-warm
        cache no physical pool could provide.
        """
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = page_size
        self.num_pages = num_pages
        self.bounded = num_pages > 0
        self.free: list[int] = (
            list(range(first_id, first_id + num_pages))[::-1]
            if self.bounded else [])
        self._next_id = first_id + num_pages
        self.pages: dict[int, list[int]] = {}
        self.host_pages: dict[int, int] = {}
        self.cached_tokens: dict[int, int] = {}
        self.prefix_cache = prefix_cache
        self.track_resets = track_resets
        self.reusable_cap = reusable_cap
        # refcount: physical id -> live owners (0 while parked in _reusable)
        self.refcount: dict[int, int] = {}
        self._used = 0              # pages with refcount > 0 (incremental:
                                    # the refcount dict retains warm pages,
                                    # so scanning it per step would cost
                                    # O(pages ever registered))
        self.index_gen = 0          # bumped whenever index contents change
                                    # (register/deregister) — lets callers
                                    # cache match_prefix results
        self._index: dict[tuple, int] = {}     # (parent_pid, tokens) -> pid
        self._key_of: dict[int, tuple] = {}    # pid -> its index key
        self._kids: dict[int, set[int]] = {}   # pid -> registered children
        self._reusable: OrderedDict[int, None] = OrderedDict()  # LRU order
        self._reset_log: list[int] = []        # device invalidation queue
        self._cow_log: list[tuple[int, int]] = []   # (src, dst) page copies

    # -- allocation ------------------------------------------------------
    def available_pages(self) -> int:
        """Pages allocatable right now.

        Free-listed plus reusable (warm refcount-zero cache pages,
        reclaimed on demand).
        """
        if not self.bounded:
            return 1 << 30
        return len(self.free) + len(self._reusable)

    def _take_page(self) -> int | None:
        if self.free:
            pid = self.free.pop()
        elif not self.bounded:
            pid = self._next_id
            self._next_id += 1
        elif self._reusable:
            pid, _ = self._reusable.popitem(last=False)      # LRU reclaim
            del self.refcount[pid]
            self._deregister(pid)
            if self.track_resets:
                self._reset_log.append(pid)
        else:
            return None
        self.refcount[pid] = 1
        self._used += 1
        return pid

    def _take_pages(self, n: int) -> list[int] | None:
        """Atomically allocate ``n`` pages.

        Validates capacity first and either returns all ``n`` or None,
        never a partial allocation.
        """
        if self.bounded and self.available_pages() < n:
            return None
        return [self._take_page() for _ in range(n)]

    def _release_ref(self, pid: int) -> bool:
        """Drop one reference.

        Returns True when the page left the used set (refcount hit zero)
        — whether free-listed or parked reusable.
        """
        self.refcount[pid] -= 1
        if self.refcount[pid] > 0:
            return False
        self._used -= 1
        if self.prefix_cache and pid in self._key_of:
            self._reusable[pid] = None          # stays warm, counts as free
            self._reusable.move_to_end(pid)
            if (self.reusable_cap is not None
                    and len(self._reusable) > self.reusable_cap):
                old, _ = self._reusable.popitem(last=False)   # LRU out
                del self.refcount[old]
                self._deregister(old)
                if self.bounded:
                    self.free.append(old)
                if self.track_resets:
                    self._reset_log.append(old)
            return True
        del self.refcount[pid]
        if self.bounded:
            self.free.append(pid)
        if self.track_resets:
            self._reset_log.append(pid)
        return True

    def free_pages(self) -> int:
        """Unallocated page count (effectively infinite when unbounded)."""
        return self.available_pages() if self.bounded else 1 << 30

    def used_pages(self) -> int:
        """Unique physical pages referenced by at least one request.

        Shared pages count once — the page-accurate resident footprint.
        """
        return self._used

    def ensure(self, rid: int, tokens: int) -> bool:
        """Grow ``rid``'s resident page list to cover ``tokens``.

        Returns False (allocating nothing) on pool exhaustion.
        """
        have = self.pages.setdefault(rid, [])
        need = pages_for_tokens(tokens, self.page_size) - len(have)
        if need <= 0:
            return True
        got = self._take_pages(need)
        if got is None:
            return False
        have.extend(got)
        return True

    def note_cached(self, rid: int, tokens: int):
        """Record that the prefix up to ``tokens`` is now materialized."""
        cap = ((len(self.pages.get(rid, ())) + self.host_pages.get(rid, 0))
               * self.page_size)
        self.cached_tokens[rid] = min(tokens, cap)

    # -- queries ---------------------------------------------------------
    def block_table(self, rid: int) -> list[int]:
        """The request's ordered resident physical page ids (a copy)."""
        return list(self.pages.get(rid, ()))

    def resident_pages(self, rid: int) -> int:
        """Number of device-resident pages held by ``rid``."""
        return len(self.pages.get(rid, ()))

    def resident_tokens(self, rid: int) -> int:
        """Materialized prefix tokens covered by device-resident pages."""
        return min(self.cached_tokens.get(rid, 0),
                   self.resident_pages(rid) * self.page_size)

    def total_resident_pages(self) -> int:
        """Device-resident pages across all requests."""
        return sum(len(p) for p in self.pages.values())

    # -- eviction / swap (tail-first) -----------------------------------
    def evict_tail(self, rid: int, n_pages: int) -> list[int]:
        """Discard up to ``n_pages`` tail pages.

        The discarded tokens must be
        recomputed on resume. Host-swapped tail pages are dropped first —
        they are beyond the resident prefix. Shared pages (refcount > 1)
        stop the walk: reclaiming them frees no memory and would force a
        recompute of tokens other requests still serve, so eviction
        prefers — and only ever takes — unshared tail pages. Returns the
        physical ids that actually left the used set.
        """
        dropped_host = min(self.host_pages.get(rid, 0), n_pages)
        if dropped_host:
            self.host_pages[rid] -= dropped_host
            n_pages -= dropped_host
        have = self.pages.get(rid, [])
        freed = []
        for _ in range(min(n_pages, len(have))):
            if self.refcount.get(have[-1], 1) > 1:
                break                           # shared: not reclaimable
            pid = have.pop()
            if self._release_ref(pid):
                freed.append(pid)
        self.note_cached(rid, self.cached_tokens.get(rid, 0))
        return freed

    def unshared_tail_pages(self, rid: int) -> int:
        """Contiguous run of evictable (refcount == 1) pages at the tail.

        This is how much relief evicting the request can actually yield.
        """
        n = 0
        for pid in reversed(self.pages.get(rid, [])):
            if self.refcount.get(pid, 1) > 1:
                break
            n += 1
        return n

    def swap_out_tail(self, rid: int, n_pages: int) -> list[int]:
        """Move up to ``n_pages`` tail pages to host memory.

        The physical pages
        are freed but their tokens stay cached (swap-in restores them).
        Shared pages stop the walk (their device copy serves other
        requests). Returns the freed physical ids.
        """
        have = self.pages.get(rid, [])
        freed = []
        for _ in range(min(n_pages, len(have))):
            if self.refcount.get(have[-1], 1) > 1:
                break
            pid = have.pop()
            if self._release_ref(pid):
                freed.append(pid)
        if freed:
            self.host_pages[rid] = self.host_pages.get(rid, 0) + len(freed)
        return freed

    def swap_in(self, rid: int) -> int:
        """Re-allocate physical pages for host-swapped tail pages.

        Returns the number of pages brought back (0 if none or if the pool
        cannot hold them — caller must evict first). Atomic: a failed
        swap-in leaves ``pages``/``host_pages`` untouched.
        """
        n = self.host_pages.get(rid, 0)
        if not n:
            return 0
        got = self._take_pages(n)
        if got is None:
            return 0
        self.pages.setdefault(rid, []).extend(got)
        self.host_pages[rid] = 0
        return n

    # -- lifecycle -------------------------------------------------------
    def resume(self, rid: int) -> int:
        """Copy-on-admit: re-link the retained prefix on re-admission.

        A block-table write, no cache copy. Returns retained token count.
        """
        return self.resident_tokens(rid)

    def free_request(self, rid: int) -> list[int]:
        """Drop all of ``rid``'s references and bookkeeping.

        Returns the
        physical ids that left the used set: shared pages stay with their
        other owners (and are not returned), while indexed pages are
        returned but park in the reusable pool — still warm for future
        prefix hits, device-reset only if later reclaimed.
        """
        freed = [pid for pid in self.pages.pop(rid, [])
                 if self._release_ref(pid)]
        self.host_pages.pop(rid, None)
        self.cached_tokens.pop(rid, None)
        return freed

    # -- migration export/import -----------------------------------------
    def export_request(self, rid: int) -> dict:
        """Detach ``rid`` for migration.

        Snapshots its footprint, then drops
        every reference exactly like :meth:`free_request` (shared pages
        stay with their other owners; indexed pages park reusable). The
        source side therefore ends zero-leak by construction — the caller
        ships the snapshot plus, in real mode, the gathered page payload.
        Returns ``{"tokens", "resident_pages", "host_pages"}``.
        """
        snap = {"tokens": self.cached_tokens.get(rid, 0),
                "resident_pages": self.resident_pages(rid),
                "host_pages": self.host_pages.get(rid, 0)}
        self.free_request(rid)
        return snap

    def import_request(self, rid: int, tokens: int) -> bool:
        """Adopt a migrated request.

        Allocates fresh private pages covering
        ``tokens`` prefix tokens and marks them materialized. Imported
        pages are unshared (refcount 1) and unindexed — COW/index state
        never crosses replicas; the destination may re-register the
        prompt itself later. Atomic like :meth:`ensure`: returns False
        (allocating nothing) on pool exhaustion, in which case the caller
        falls back to re-prefilling from scratch.
        """
        if self.pages.get(rid) or self.host_pages.get(rid):
            raise ValueError(f"import for rid {rid}: already owns pages")
        if tokens <= 0:
            return True
        if not self.ensure(rid, tokens):
            return False
        self.note_cached(rid, tokens)
        return True

    # -- cross-request prefix cache --------------------------------------
    def match_prefix(self, tokens) -> tuple[list[int], int]:
        """Longest chain of cached full pages matching ``tokens``.

        Pure lookup (no refcount or LRU side effects): walks page-sized
        blocks of ``tokens`` through the chained hash index and returns
        ``(physical_ids, matched_token_count)``. The chained key — each
        block hashed against its parent's *physical id* — makes a hit on
        block j a proof that blocks 0..j all match, with one dict probe
        per block.
        """
        if not self.prefix_cache:
            return [], 0
        ps = self.page_size
        parent, pids = 0, []
        for j in range(len(tokens) // ps):
            pid = self._index.get((parent, tuple(tokens[j * ps:(j + 1) * ps])))
            if pid is None:
                break
            pids.append(pid)
            parent = pid
        return pids, len(pids) * ps

    def match_len(self, tokens) -> int:
        """Matched-prefix token count only (the router's affinity probe)."""
        return self.match_prefix(tokens)[1]

    def link_prefix(self, rid: int, tokens) -> int:
        """Link the longest cached prefix of ``tokens`` into ``rid``.

        Refcount bumps and block-table writes, no prefill compute.
        Only valid before ``rid`` owns any pages (fresh admission).
        Returns the number of prefix tokens now materialized for ``rid``.
        """
        if not self.prefix_cache or self.pages.get(rid):
            return 0
        pids, hit = self.match_prefix(tokens)
        if not pids:
            return 0
        for pid in pids:
            if self.refcount.get(pid, 0) == 0:
                self._used += 1                 # warm page back in use
            self.refcount[pid] = self.refcount.get(pid, 0) + 1
            self._reusable.pop(pid, None)
        self.pages[rid] = list(pids)
        self.cached_tokens[rid] = hit
        return hit

    def register_prefix(self, rid: int, tokens, upto: int) -> int:
        """Publish ``rid``'s full prompt pages into the hash index.

        Later requests can then link them. ``tokens`` is the prompt;
        only pages fully covered by ``min(upto, len(tokens))`` written
        tokens are registered (partial tail pages never enter the index,
        so indexed pages are immutable by construction). Duplicate content
        chains through the existing canonical page instead of forking the
        index. Returns how many pages were newly registered.
        """
        if not self.prefix_cache:
            return 0
        ps = self.page_size
        have = self.pages.get(rid, ())
        n_full = min(upto, len(tokens)) // ps
        parent, registered = 0, 0
        for j in range(min(n_full, len(have))):
            pid = have[j]
            if pid in self._key_of:             # already canonical
                parent = pid
                continue
            key = (parent, tuple(tokens[j * ps:(j + 1) * ps]))
            canon = self._index.get(key)
            if canon is not None:               # duplicate content: chain
                parent = canon                  # through the canonical page
                continue
            self._index[key] = pid
            self._key_of[pid] = key
            self._kids.setdefault(parent, set()).add(pid)
            parent = pid
            registered += 1
        if registered:
            self.index_gen += 1
        return registered

    def make_writable(self, rid: int, from_token: int) -> list[tuple[int, int]]:
        """Copy-on-write guard before KV writes.

        Gives ``rid`` private copies of any shared
        (refcount > 1) pages covering positions >= ``from_token``, so the
        upcoming KV writes never mutate a page other requests attend to.
        Returns the ``(src, dst)`` page copies performed (also queued for
        the device in the COW log). In the standard admission flow shared
        pages are always full and writes land beyond them, so this is a
        no-op backstop — but it is what makes the immutability invariant
        enforced rather than emergent.
        """
        if not self.prefix_cache:
            return []
        have = self.pages.get(rid, [])
        ops = []
        for j in range(from_token // self.page_size, len(have)):
            pid = have[j]
            if self.refcount.get(pid, 1) <= 1:
                continue
            new = self._take_page()
            if new is None:
                raise RuntimeError("paged KV pool exhausted during "
                                   "copy-on-write")
            self.refcount[pid] -= 1
            have[j] = new
            ops.append((pid, new))
            if self.track_resets:
                self._cow_log.append((pid, new))
        return ops

    def _deregister(self, pid: int):
        """Remove ``pid`` from the hash index, cascading to descendants.

        Registered descendants' chained keys name ``pid`` as parent, so once it
        is reclaimed (and its id possibly reused for other content) they
        must not be matchable. Unreferenced descendants move from the
        reusable pool to the free list.
        """
        key = self._key_of.pop(pid, None)
        if key is None:
            return
        self.index_gen += 1
        if self._index.get(key) == pid:
            del self._index[key]
        self._kids.get(key[0], set()).discard(pid)
        for kid in list(self._kids.pop(pid, ())):
            self._deregister(kid)
            if self.refcount.get(kid) == 0:
                del self._reusable[kid]
                del self.refcount[kid]
                if self.bounded:
                    self.free.append(kid)
                if self.track_resets:
                    self._reset_log.append(kid)

    def pop_resets(self) -> list[int]:
        """Drain the device-invalidation queue.

        Yields page ids whose content is dead: freed outright or
        reclaimed from the reusable pool.
        """
        out, self._reset_log = self._reset_log, []
        return out

    def pop_cow_copies(self) -> list[tuple[int, int]]:
        """Drain the pending (src, dst) device page copies from COW."""
        out, self._cow_log = self._cow_log, []
        return out


class SlotPool:
    """Host-side slot bookkeeping + device-side cache reset.

    The device cache is ``model.init_cache(slots, max_len)`` (the
    contiguous layout), updated in place. :class:`PagedSlotPool` shares
    the slot bookkeeping and the reset below.
    """

    def __init__(self, model, slots: int, max_len: int):
        self.model = model
        self.cfg = model.cfg
        self.n_slots = slots
        self.max_len = max_len
        self.cache = model.init_cache(slots, max_len)
        self.device = self.cache["lengths"].device
        self.slot_of: dict[int, int] = {}
        self.free = list(range(slots))[::-1]
        self._dirty: list[int] = []              # slots needing device reset

    # -- allocation ------------------------------------------------------
    def assign(self, rid: int) -> int:
        """Claim a free slot for ``rid``; returns the slot index."""
        slot = self.free.pop()
        self.slot_of[rid] = slot
        return slot

    def release(self, rid: int) -> int:
        """Return ``rid``'s slot to the free list, queueing a device reset."""
        slot = self.slot_of.pop(rid)
        self.free.append(slot)
        self._dirty.append(slot)
        return slot

    def flush_resets(self):
        """Apply pending slot resets on device, in place: ``lengths`` of
        each dirty slot back to 0, every slot-cache ``kpos`` row of it
        (contiguous caches and the rings of windowed layers) to -1, and
        the SSM state and conv buffer of SSM and hybrid layers to 0, one
        ``index_fill_`` per leaf, so that the slot's next request never
        attends over its predecessor's K/V or carries its recurrent
        state."""
        if not self._dirty:
            return
        idx = torch.tensor(self._dirty, dtype=torch.long, device=self.device)
        self.cache["lengths"].index_fill_(0, idx, 0)
        for sub in _layer_leaves(self.cache, "kpos"):
            sub["kpos"].index_fill_(1, idx, -1)
        for sub in _layer_leaves(self.cache, "ssm_state"):
            sub["ssm_state"].index_fill_(1, idx, 0.0)
            sub["conv_buf"].index_fill_(1, idx, 0.0)
        self._dirty.clear()

    # -- accounting --------------------------------------------------------
    def bytes_for(self, context_len: int) -> int:
        """Cache bytes this pool charges a context (clamped to max_len)."""
        return bytes_for_context(self.cfg, min(context_len, self.max_len))

    def used_slots(self) -> int:
        """Slots currently assigned."""
        return self.n_slots - len(self.free)


_PAGE_LEAVES = ("pk", "pv", "pkpos")
_ALIGN = 16                 # byte alignment of each leaf in a packed buffer


def _pack(tensors) -> torch.Tensor:
    """Concatenate tensors' bytes into one flat uint8 tensor (each leaf at
    a 16-byte aligned offset), on the tensors' device."""
    parts = []
    for t in tensors:
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(flat)
        pad = -flat.numel() % _ALIGN
        if pad:
            parts.append(flat.new_zeros(pad))
    return torch.cat(parts)


def _unpack(flat: torch.Tensor, like) -> list[torch.Tensor]:
    """Views into a `_pack`ed buffer with the dtypes and shapes of
    ``like``, in order."""
    out, offset = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[offset:offset + n].view(t.dtype).view(t.shape))
        offset += n + (-n % _ALIGN)
    return out


def _layer_leaves(cache: dict, leaf: str):
    """Every layer run's leaf dict that holds ``leaf`` (``kpos``: slot
    caches; ``pkpos``: paged K/V; ``ssm_state``: SSM and hybrid layers)."""
    for key, run in cache.items():
        if key.startswith("run_"):
            for sub in run:
                if leaf in sub:
                    yield sub


class PagedSlotPool(SlotPool):
    """Slot pool whose global-attention KV lives in shared device pages.

    Pages are addressed through per-slot block tables.

    Slots carry the per-sequence state that cannot be paged (``lengths``,
    the rings of windowed layers); the :class:`BlockManager` owns the page
    pool. With ``retain=True``
    (pure-attention archs) a preempted request keeps its pages across
    release/assign — resumption re-points the new slot's block-table row
    at them and restores ``lengths``, so decode continues over the
    retained prefix with zero recompute. Device updates (page resets,
    copy-on-write copies, block-table sync) are in place on the cache
    tensors.
    """

    def __init__(self, model, slots: int, max_len: int, page_size: int = 16,
                 retain: bool | None = None, prefix_cache: bool = False):
        self.page_size = page_size
        self.pages_per_seq = pages_for_tokens(max_len, page_size)
        self.model = model
        self.cfg = model.cfg
        self.n_slots = slots
        self.max_len = max_len
        self.cache = model.init_cache(slots, max_len, kv_layout="paged",
                                      page_size=page_size)
        self.device = self.cache["lengths"].device
        self.slot_of: dict[int, int] = {}
        self.free = list(range(slots))[::-1]
        self._dirty: list[int] = []
        self._dirty_pages: list[int] = []
        self._table_stale = True
        # physical ids 1..N; page 0 is the null page (pkpos stays -1)
        self.blocks = BlockManager(slots * self.pages_per_seq, page_size,
                                   prefix_cache=prefix_cache,
                                   track_resets=True)
        self.table = np.zeros((slots, self.pages_per_seq), np.int32)
        if retain is None:
            retain = supports_page_retention(self.cfg)
        self.retain = retain

    def _index(self, ids) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.long, device=self.device)

    # -- allocation ------------------------------------------------------
    def assign(self, rid: int) -> int:
        """Claim a slot and re-link any retained pages (copy-on-admit)."""
        slot = super().assign(rid)
        self._write_table_row(slot, self.blocks.block_table(rid))
        retained = self.blocks.resume(rid)
        if retained:
            # the slot's pending reset (from its previous occupant) must
            # land before we restore the resumed request's length, or the
            # deferred wipe would clobber it
            self.flush_resets()
            self.cache["lengths"][slot] = retained
        return slot

    def release(self, rid: int, retain: bool = False) -> int:
        """Release the slot; with ``retain`` the pages stay for resumption.

        Device invalidation is driven by the block manager's reset log
        (drained in ``flush_resets``), so pages parked in the reusable
        prefix pool keep their contents.
        """
        slot = self.slot_of[rid]
        if not retain:
            self.blocks.free_request(rid)
        self._write_table_row(slot, [])
        return super().release(rid)

    # -- pages -----------------------------------------------------------
    def ensure_pages(self, rid: int, tokens: int) -> bool:
        """Allocate pages for a ``tokens``-long prefix of ``rid``.

        Also refreshes the block-table row. False only on true pool
        exhaustion.
        """
        tokens = min(tokens, self.max_len)
        ok = self.blocks.ensure(rid, tokens)
        if ok and rid in self.slot_of:
            self._write_table_row(self.slot_of[rid],
                                  self.blocks.block_table(rid))
        return ok

    def evict_tail(self, rid: int, n_pages: int) -> list[int]:
        """Tail-evict pages, queueing device invalidation via resets.

        Returns the ids that left the used set.
        """
        freed = self.blocks.evict_tail(rid, n_pages)
        if rid in self.slot_of:
            self._write_table_row(self.slot_of[rid],
                                  self.blocks.block_table(rid))
        return freed

    def make_writable(self, rid: int, from_token: int) -> list:
        """COW guard before KV writes (see `BlockManager.make_writable`).

        Refreshes the table row when pages were swapped for copies.
        """
        ops = self.blocks.make_writable(rid, from_token)
        if ops and rid in self.slot_of:
            self._write_table_row(self.slot_of[rid],
                                  self.blocks.block_table(rid))
        return ops

    # -- migration export/import -----------------------------------------
    def export_pages(self, rid: int):
        """Gather ``rid``'s resident page payload for shipping.

        One batched device->host copy of pk/pv/pkpos per paged layer run:
        the run's pages are gathered and packed into one device buffer,
        copied to the host at once and viewed back as CPU tensors,
        ``{run: ({leaf: tensor}, ...)}``. Bookkeeping is untouched (pair
        with ``blocks.export_request``). Returns None when nothing is
        resident.
        """
        pids = self.blocks.block_table(rid)
        if not pids:
            return None
        self.flush_resets()        # pending wipes/COW must land first
        idx = self._index(pids)
        payload = {}
        for key, run in self.cache.items():
            if not key.startswith("run_"):
                continue
            pages = [sub[leaf].index_select(1, idx)
                     for sub in run if "pkpos" in sub
                     for leaf in _PAGE_LEAVES]
            host = iter(_unpack(_pack(pages).cpu(), pages) if pages else ())
            payload[key] = tuple(
                {leaf: next(host) for leaf in _PAGE_LEAVES}
                if "pkpos" in sub else None
                for sub in run)
        return payload

    def import_pages(self, rid: int, tokens: int, payload) -> bool:
        """Adopt a migrated request's KV.

        Allocates fresh pages covering ``tokens`` (clamped to ``max_len``)
        and scatters the shipped payload into them, in place, with one
        batched host->device copy per paged layer run (the run's leaves
        packed on the host, copied at once, then scattered).
        ``flush_resets`` runs first so a queued wipe of a recycled
        physical page cannot land after the import and destroy the new
        content. False on pool exhaustion (nothing allocated; the caller
        re-prefills from scratch).
        """
        self.flush_resets()
        tokens = min(tokens, self.max_len)
        if not self.blocks.import_request(rid, tokens):
            return False
        pids = self.blocks.block_table(rid)
        if payload is None or not pids:
            return True
        dst = self._index(pids)
        n = len(pids)            # may be < shipped pages (clamp/partial)
        for key, run in self.cache.items():
            if not key.startswith("run_"):
                continue
            targets, shipped = [], []
            for sub, pay in zip(run, payload[key]):
                if "pkpos" in sub and pay is not None:
                    for leaf in _PAGE_LEAVES:
                        targets.append(sub[leaf])
                        shipped.append(pay[leaf][:, :n])
            if not targets:
                continue
            flat = _pack(shipped).to(self.device)
            for target, pages in zip(targets, _unpack(flat, shipped)):
                target.index_copy_(1, dst, pages)
        return True

    def _write_table_row(self, slot: int, pages: list[int]):
        row = np.zeros((self.pages_per_seq,), np.int32)
        row[:len(pages)] = pages
        self.table[slot] = row
        self._table_stale = True

    # -- device sync -----------------------------------------------------
    def flush_resets(self):
        """Apply pending resets and COW copies; sync the block table.

        Freed pages get ``pkpos = -1`` so stale entries never attend.
        Resets run before copies so a page reclaimed from the reusable
        pool and immediately used as a COW destination ends up holding
        the copied content.
        """
        super().flush_resets()
        self._dirty_pages.extend(self.blocks.pop_resets())
        if self._dirty_pages:
            idx = self._index(self._dirty_pages)
            for sub in _layer_leaves(self.cache, "pkpos"):
                sub["pkpos"].index_fill_(1, idx, -1)
            self._dirty_pages.clear()
        cow = self.blocks.pop_cow_copies()
        if cow:
            src = self._index([s for s, _ in cow])
            dst = self._index([d for _, d in cow])
            for sub in _layer_leaves(self.cache, "pkpos"):
                for leaf in ("pk", "pv", "pkpos"):
                    sub[leaf].index_copy_(1, dst,
                                          sub[leaf].index_select(1, src))
        if self._table_stale:
            self.cache["block_table"].copy_(torch.from_numpy(self.table))
            self._table_stale = False

    # -- accounting ------------------------------------------------------
    def bytes_for(self, context_len: int) -> int:
        """Page-rounded cache bytes for a context (clamped to max_len)."""
        return paged_bytes_for_context(
            self.cfg, min(context_len, self.max_len), self.page_size)
