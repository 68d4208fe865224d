"""Continuous-batching server with chunked streamed prefill and a paged KV pool.

The counterpart of ``repro.runtime.server`` on one device:

* **Admission** is per slot: a request's prompt is prefilled into its
  chunk carry (a full-length K/V scratch for the dense family, the
  latent rows and shared rope keys for MLA, the constant-size SSD state
  and conv tail for the SSM family, both for the hybrid: the states of
  its Mamba-2 layers and a K/V scratch a shared attention application)
  by incremental chunk steps, at most one chunk
  per server step, so prefill interleaves with decode instead of blocking
  it.  Chunks round up to the carry's ``chunk_multiple`` (``ssm_chunk``
  for the SSM and the hybrid).  The finished carry becomes a
  single-request cache written into its batch row (contiguous) or into
  pool blocks (paged: dense, vlm and moe).  A MoE model's chunks bookkeep
  expert capacity over their own rows (chunk-local, as the reference;
  ``chunk_carry_spec`` declares the carry inexact), and decode runs every
  expert on every row.  ``prefill_chunk`` of
  ``None``/0 admits with one bulk prefill per request instead.
* **Decode** runs one batched step per server step; every cache row
  advances at its own position, argmax runs on the device and the server
  fetches one (B,) id vector per step.
* **Paged KV pool** (``ServerConfig.paged``): a host-side ref-counted
  :class:`BlockPool` runs the free list and the prefix cache; identical
  prompt prefixes are admitted once and mapped copy-on-write into many
  slots' block tables.  Decode through the table gives the contiguous
  ring's values exactly.

The reference's fault and membership hooks (``fault_plan``,
``membership``, ``fail_decode_rank(s)``, ``admit_decode_rank``) and the
pool's partition methods come with the elastic slice of the port.

``stats()`` adds to the reference's keys the device time split of this
run: prefill and decode tokens per second, each over the wall time of its
own phase, closed by a device synchronise so that queued work is counted
in the phase that issued it.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, chunk_carry_spec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.steps import block_write, park_row, serve_step, slot_write
from repro_torch.models.decode import (
    init_cache,
    init_paged_cache,
    kv_buf_len,
    paged_slot_blocks,
    supports_paged,
)
from repro_torch.models.prefill import (
    cache_to_blocks,
    chunk_rows,
    chunk_support,
    init_prefill_scratch,
    prefill,
    prefill_chunk,
    prefill_chunk_cuts,
    prefill_rows,
    scratch_to_blocks,
    scratch_to_cache,
    seed_scratch_from_blocks,
)


class BlockPool:
    """Host-side ref-counted free list over the paged KV pool.

    Block ids ``[0, reserved)`` are parking blocks (one per batch row) and
    are never handed out.  Every other id is on the free list or live: one
    ref per slot whose table maps it plus one per prefix-cache entry that
    pins it.  Entries are LRU-evicted when ``alloc`` runs short; blocks
    still mapped by running requests survive the eviction (copy-on-write).
    """

    def __init__(self, n_blocks: int, reserved: int = 0):
        self.n_blocks = int(n_blocks)
        self.reserved = int(reserved)
        if not 0 <= self.reserved <= self.n_blocks:
            raise ValueError(f"reserved {reserved} outside [0, {n_blocks}]")
        # LIFO free list, low ids first out
        self._free = list(range(self.n_blocks - 1, self.reserved - 1, -1))
        self._refs: Dict[int, int] = {}
        self._entries: "dict[bytes, List[int]]" = {}   # insertion = LRU order
        self.evictions = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._refs)

    @property
    def cached_entries(self) -> int:
        return len(self._entries)

    def evictable_blocks(self) -> int:
        """Blocks that evicting every prefix-cache entry would free: pinned
        only by entries (blocks shared with running requests stay live)."""
        pins: Dict[int, int] = {}
        for bids in self._entries.values():
            for b in bids:
                pins[b] = pins.get(b, 0) + 1
        return sum(1 for b, p in pins.items() if self._refs.get(b, 0) == p)

    def can_cover(self, n: int) -> bool:
        """Whether ``alloc(n)`` would succeed, without touching the cache."""
        return int(n) <= len(self._free) + self.evictable_blocks()

    def check_conservation(self):
        """Every non-reserved block is free xor referenced."""
        assert self.free_blocks + self.live_blocks \
            == self.n_blocks - self.reserved, (
                self.free_blocks, self.live_blocks, self.n_blocks)
        assert not set(self._free) & set(self._refs)
        assert all(b >= self.reserved for b in self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks (one ref each), LRU-evicting idle prefix-cache
        entries under pressure; ``MemoryError`` when the pool cannot cover
        it (checked first, so a doomed claim evicts nothing)."""
        if not self.can_cover(n):
            raise MemoryError(
                f"block pool exhausted: want {n}, free {len(self._free)}, "
                f"evictable {self.evictable_blocks()}")
        while len(self._free) < n:
            self._evict_lru()
        bids = [self._free.pop() for _ in range(n)]
        for b in bids:
            self._refs[b] = 1
        return bids

    def retain(self, bids: List[int]):
        for b in bids:
            if b not in self._refs:
                raise ValueError(f"retain of unallocated block {b}")
            self._refs[b] += 1

    def release(self, bids: List[int]):
        """Drop one reference from each block; at zero it is free again.
        Releasing a free block raises (double free)."""
        for b in bids:
            if b not in self._refs:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)

    def cache_insert(self, key: bytes, bids: List[int]):
        """Pin ``bids`` as the cached blocks of prompt prefix ``key``."""
        if key in self._entries:
            return
        self.retain(bids)
        self._entries[key] = list(bids)

    def cache_lookup(self, key: bytes) -> Optional[List[int]]:
        """Retain and return the blocks of ``key`` (refreshing its LRU
        position), or ``None``."""
        if key not in self._entries:
            return None
        bids = self._entries.pop(key)
        self._entries[key] = bids
        self.retain(bids)
        return list(bids)

    def _evict_lru(self):
        key = next(iter(self._entries))
        self.release(self._entries.pop(key))
        self.evictions += 1


@dataclasses.dataclass
class ServerConfig:
    """Continuous-batching knobs (the reference's)."""

    max_batch: int = 8
    max_seq: int = 256
    max_new_tokens: int = 32
    eos_id: int = -1               # -1: disabled (synthetic workloads)
    greedy: bool = True
    #: tokens per admitted prefill chunk; None/0 admits with one bulk
    #: prefill per request instead
    prefill_chunk: Optional[int] = 16
    #: paged KV pool behind per-slot block tables
    paged: bool = False
    #: KV positions per pool block; must divide the ring extent and (for
    #: prefix caching) be a multiple of ``prefill_chunk``
    block_size: int = 16
    #: pool size; default = parking row per slot + a full table per slot
    #: + one spare table's worth of prefix-cache headroom
    n_blocks: Optional[int] = None
    #: admit identical prompt prefixes once (shared ref-counted blocks)
    prefix_cache: bool = True


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    frontend_embeds: Optional[np.ndarray] = None   # frontend archs, fp32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted: float = 0.0
    first_token: Optional[float] = None
    finished: Optional[float] = None
    cancelled: bool = False
    # scheduler state
    phase: str = "queued"          # queued | prefill | decode | done
    _scratch: Optional[dict] = None
    _cursor: int = 0               # next prefill chunk index
    _blocks: List[int] = dataclasses.field(default_factory=list)
    _shared: int = 0               # leading blocks aliased from the cache


class Server:
    """Fixed-slot continuous-batching server on one device."""

    def __init__(self, cfg: ModelConfig, params, srv: ServerConfig = None,
                 device: DeviceLike = None):
        srv = srv or ServerConfig()
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the server runs on {self.device}")
        self.device = params["embed"].device
        self.cfg, self.params, self.srv = cfg, params, srv
        if not srv.greedy:
            raise ValueError("only greedy sampling is implemented")
        ok, why = chunk_support(cfg)
        if srv.prefill_chunk and not ok:
            warnings.warn(
                f"{cfg.name}: chunked prefill requested "
                f"(prefill_chunk={srv.prefill_chunk}) but unsupported — "
                f"{why}; admitting with bulk per-slot prefill", stacklevel=2)
        self._chunkable = ok and bool(srv.prefill_chunk)
        self._fallback_reason = ("" if self._chunkable
                                 else (why if srv.prefill_chunk
                                       else "prefill_chunk disabled"))
        mult = chunk_carry_spec(cfg).chunk_multiple
        self._eff_chunk = (-(-int(srv.prefill_chunk) // mult) * mult
                           if self._chunkable else 0)
        self._paged = bool(srv.paged)
        if self._paged:
            if not supports_paged(cfg):
                raise ValueError(f"{cfg.name} has no paged-cache layout")
            self._sb = kv_buf_len(cfg, srv.max_seq)
            self._blk = int(srv.block_size)
            self._npb = paged_slot_blocks(cfg, srv.max_seq, self._blk)
            self._n_blocks = int(srv.n_blocks or
                                 srv.max_batch * (1 + self._npb) + self._npb)
            if srv.prefix_cache and self._chunkable \
                    and self._blk % self._eff_chunk:
                raise ValueError(
                    "prefix caching needs block_size to be a multiple of "
                    f"the effective chunk ({self._blk} % {self._eff_chunk})")
            self.pool = BlockPool(self._n_blocks, reserved=srv.max_batch)
            self.cache = init_paged_cache(cfg, srv.max_batch, srv.max_seq,
                                          self._blk, self._n_blocks,
                                          self.device)
        else:
            self.pool = None
            self.cache = init_cache(cfg, srv.max_batch, srv.max_seq,
                                    self.device)
        self.slots: List[Optional[Request]] = [None] * srv.max_batch
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._next_tok = np.zeros((srv.max_batch,), np.int32)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefill_chunks = 0        # chunk (or bulk) prefill passes run
        self._prefill_tokens = 0
        self._prefill_s = 0.0
        self._decode_tokens = 0
        self._decode_s = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- request intake -------------------------------------------------------

    def submit(self, prompt: np.ndarray,
               frontend_embeds: Optional[np.ndarray] = None) -> int:
        """Queue a prompt; a frontend arch's request also takes its
        embeddings (``frontend_tokens`` × ``frontend_dim``)."""
        cfg = self.cfg
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0 \
                or prefill_rows(cfg, prompt.size) > self.srv.max_seq:
            raise ValueError(f"prompt shape {prompt.shape} outside "
                             f"(1..{self.srv.max_seq - prefill_rows(cfg, 0)}"
                             f",)")
        if cfg.family == "encdec" and prompt.size > cfg.decoder_max_seq:
            raise ValueError(f"prompt of {prompt.size} tokens > the "
                             f"decoder's {cfg.decoder_max_seq}")
        if cfg.frontend:
            if frontend_embeds is None:
                raise ValueError(
                    f"{cfg.name} requires frontend embeddings per request")
            frontend_embeds = np.asarray(frontend_embeds, np.float32)
            want = (cfg.frontend_tokens, cfg.frontend_dim)
            if frontend_embeds.shape != want:
                raise ValueError(f"frontend embeddings "
                                 f"{frontend_embeds.shape}, expected {want}")
        elif frontend_embeds is not None:
            raise ValueError(f"{cfg.name} takes no frontend embeddings")
        rid = len(self.queue) + len(self.done) + sum(s is not None
                                                     for s in self.slots)
        self.queue.append(Request(rid=rid, prompt=prompt,
                                  frontend_embeds=frontend_embeds,
                                  submitted=time.perf_counter()))
        return rid

    def _admit(self):
        """Assign queued requests to free slots; paged admission also claims
        the slot's pool blocks (a dry pool leaves the request queued)."""
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue[0]
                if self._paged and not self._claim_blocks(req):
                    break
                self.queue.pop(0)
                req.phase = "prefill"
                req._cursor = 0
                if self._chunkable:
                    se = prefill_rows(self.cfg, int(req.prompt.size))
                    req._scratch = init_prefill_scratch(self.cfg, 1, se,
                                                        self.device)
                    if self._paged and req._shared:
                        bids = torch.as_tensor(req._blocks[:req._shared],
                                               device=self.device)
                        seed_scratch_from_blocks(
                            self.cfg, req._scratch, self.cache["kp"][:, bids],
                            self.cache["vp"][:, bids])
                        req._cursor = (req._shared * self._blk
                                       // self._eff_chunk)
                self.slots[i] = req

    # -- paged block accounting ----------------------------------------------

    def _share_ok(self, s: int) -> bool:
        """Whether a prompt of length ``s`` may alias prefix-cache blocks:
        decode must be provably unable to ring-wrap into shared blocks, and
        the arch has no frontend (the key is the prompt's tokens alone,
        which do not say what patches came before them)."""
        return (self._paged and self.srv.prefix_cache and self._chunkable
                and self.cfg.window is None and not self.cfg.frontend
                and s + self.srv.max_new_tokens <= self._sb)

    def _m_max(self, s: int) -> int:
        """Most leading full blocks of an ``s``-token prompt that may be
        shared — at least one token must remain to prefill."""
        return min((s - 1) // self._blk, self._npb)

    def _claim_blocks(self, req: Request) -> bool:
        """Claim the slot's pool blocks: the longest resident prompt prefix
        supplies shared blocks, the rest come off the free list.  False =
        pool dry, leave queued."""
        s = int(req.prompt.size)
        shared: List[int] = []
        if self._share_ok(s):
            for m in range(self._m_max(s), 0, -1):
                got = self.pool.cache_lookup(
                    req.prompt[:m * self._blk].tobytes())
                if got is not None:
                    shared = got
                    break
            if shared:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1
        need = self._npb - len(shared)
        if not self.pool.can_cover(need):
            if shared:
                self.pool.release(shared)
                self.prefix_hits -= 1
                self.prefix_misses += 1
            return False
        req._blocks = shared + self.pool.alloc(need)
        req._shared = len(shared)
        return True

    def _install_paged(self, i: int, req: Request, blocks):
        """Push the slot's private blocks into the pool, install its table
        row, then register every full-block prompt prefix with the prefix
        cache."""
        bk, bv, slot_pos_row, pos_row = blocks
        m = req._shared
        table = torch.as_tensor(req._blocks, dtype=torch.int32,
                                device=self.device)
        block_write(self.cache, bk[:, m:], bv[:, m:], table[m:], table,
                    slot_pos_row, pos_row, i)
        s = int(req.prompt.size)
        if self._share_ok(s):
            for m2 in range(1, self._m_max(s) + 1):
                self.pool.cache_insert(
                    req.prompt[:m2 * self._blk].tobytes(), req._blocks[:m2])

    # -- prefill scheduling ---------------------------------------------------

    def _emit_first_token(self, i: int, req: Request, logits: torch.Tensor):
        """Sample the first decode token from the final prefill logits; the
        TTFT stamp is taken once the id has reached the host."""
        tok = int(torch.argmax(logits[0], dim=-1))
        req.first_token = time.perf_counter()
        req.out_tokens.append(tok)
        req.phase = "decode"
        self._next_tok[i] = tok
        if (len(req.out_tokens) >= self.srv.max_new_tokens
                or tok == self.srv.eos_id):
            self._retire(i, req)

    def _prefill_tick(self):
        """Run at most one prefill chunk (or one bulk prefill) for the
        earliest-admitted slot still in the prefill phase."""
        pending = [(req.rid, i, req) for i, req in enumerate(self.slots)
                   if req is not None and req.phase == "prefill"]
        if not pending:
            return
        t0 = time.perf_counter()
        _, i, req = min(pending)
        cfg = self.cfg
        s = int(req.prompt.size)
        toks = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                               device=self.device)
        self.prefill_chunks += 1

        def frontend(rows=slice(None)):
            return torch.as_tensor(req.frontend_embeds[None, rows],
                                   device=self.device)

        if not self._chunkable:
            cache1, logits = prefill(
                cfg, self.params, toks,
                frontend() if cfg.frontend else None,
                cache_len=self.srv.max_seq)
            self._prefill_tokens += prefill_rows(cfg, s)
            if self._paged:
                self._install_paged(i, req,
                                    cache_to_blocks(cfg, cache1, self._blk))
            else:
                slot_write(self.cache, cache1, i)
            self._sync()
            self._prefill_s += time.perf_counter() - t0
            self._emit_first_token(i, req, logits)
            return

        cuts = prefill_chunk_cuts(prefill_rows(cfg, s),
                                  chunk_len=self._eff_chunk)
        lo, hi = cuts[req._cursor]
        rows, fe_rows = chunk_rows(cfg, lo, hi)
        req._scratch, logits = prefill_chunk(
            cfg, self.params, req._scratch, toks[:, rows], lo,
            None if fe_rows is None else frontend(fe_rows))
        self._prefill_tokens += hi - lo
        req._cursor += 1
        if req._cursor < len(cuts):
            self._sync()
            self._prefill_s += time.perf_counter() - t0
            return                          # more chunks; decode proceeds
        if self._paged:
            blocks = scratch_to_blocks(cfg, req._scratch, self._blk,
                                       cache_len=self.srv.max_seq)
            self._install_paged(i, req, blocks)
        else:
            slot_write(self.cache, scratch_to_cache(
                cfg, req._scratch, cache_len=self.srv.max_seq), i)
        req._scratch = None
        self._sync()
        self._prefill_s += time.perf_counter() - t0
        self._emit_first_token(i, req, logits)

    def _retire(self, i: int, req: Request, now: Optional[float] = None):
        """The one retire path — finished, EOS or cancel, at any phase:
        drops the admission scratch and the slot's pool-block refs, and
        parks the row's block table."""
        req.finished = time.perf_counter() if now is None else now
        req.phase = "done"
        req._scratch = None
        if self._paged and req._blocks:
            self.pool.release(req._blocks)
            req._blocks = []
            req._shared = 0
            park_row(self.cache, i)
        self.done.append(req)
        self.slots[i] = None

    def cancel(self, rid: int) -> bool:
        """Abort a request wherever it is; returns whether it was found."""
        for q, req in enumerate(self.queue):
            if req.rid == rid:
                req.cancelled = True
                self.queue.pop(q)
                req.finished = time.perf_counter()
                req.phase = "done"
                self.done.append(req)
                return True
        for i, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                req.cancelled = True
                self._retire(i, req)
                return True
        return False

    # -- decode loop ----------------------------------------------------------

    def step(self):
        """One scheduler tick: admit, run one prefill chunk, decode."""
        self._admit()
        self._prefill_tick()
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and r.phase == "decode"]
        if not active:
            return
        t0 = time.perf_counter()
        toks = torch.as_tensor(self._next_tok, dtype=torch.long,
                               device=self.device)
        self.cache, ids = serve_step(self.cfg, self.params, self.cache, toks)
        choice = ids.cpu().numpy()          # one stacked host transfer
        now = time.perf_counter()
        self._decode_s += now - t0
        self._decode_tokens += len(active)
        for i in active:
            req = self.slots[i]
            tok = int(choice[i])
            req.out_tokens.append(tok)
            self._next_tok[i] = tok
            if (len(req.out_tokens) >= self.srv.max_new_tokens
                    or tok == self.srv.eos_id):
                self._retire(i, req, now)

    def run(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps

    # -- metrics ---------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        lat = [r.finished - r.submitted for r in self.done if r.finished]
        ttft = [r.first_token - r.submitted for r in self.done
                if r.first_token]
        itl = [(r.finished - r.first_token) / (len(r.out_tokens) - 1)
               for r in self.done
               if r.finished and r.first_token and len(r.out_tokens) > 1]
        toks = sum(len(r.out_tokens) for r in self.done)
        wall = (max(r.finished for r in self.done)
                - min(r.submitted for r in self.done)) if self.done else 0.0
        out = {
            "requests": len(self.done),
            "tokens": toks,
            "throughput_tok_s": toks / wall if wall else 0.0,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "mean_itl_s": float(np.mean(itl)) if itl else 0.0,
            "admission_mode": (f"chunked({self._eff_chunk})"
                               if self._chunkable else "bulk"),
            "admission_fallback": self._fallback_reason,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self._prefill_tokens,
            "prefill_tok_s": (self._prefill_tokens / self._prefill_s
                              if self._prefill_s else 0.0),
            "decode_tokens": self._decode_tokens,
            "decode_tok_s": (self._decode_tokens / self._decode_s
                             if self._decode_s else 0.0),
        }
        if self._paged:
            out.update({
                "prefix_hits": float(self.prefix_hits),
                "prefix_misses": float(self.prefix_misses),
                "pool_evictions": float(self.pool.evictions),
                "pool_free_blocks": float(self.pool.free_blocks),
            })
        return out


def drive_arrivals(server: Server, prompts, every: int,
                   max_steps: int = 10_000) -> int:
    """Run ``server`` under synthetic arrivals: one prompt up front, one
    more every ``every`` scheduler ticks, until the queue drains.  Each
    item is a prompt, or a ``(prompt, frontend_embeds)`` pair for a
    frontend arch.  Returns the tick count."""
    def submit(item):
        if isinstance(item, tuple):
            server.submit(*item)
        else:
            server.submit(item)

    pending = list(prompts)
    submit(pending.pop(0))
    steps = 0
    while ((pending or server.queue
            or any(s is not None for s in server.slots))
           and steps < max_steps):
        server.step()
        steps += 1
        if pending and steps % max(1, every) == 0:
            submit(pending.pop(0))
    return steps
