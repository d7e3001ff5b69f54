"""Continuous-batching serve engine.

Port of ``repro/serve/engine.py``.  Requests are admitted into a fixed pool
of ``n_slots`` in-flight decode slots; prefill runs in fixed-size chunks;
decode runs one batched step over every in-flight slot.  Both phases go
through one step function (``transformer.paged_step``) at exactly two
shapes -- ``[1, prefill_chunk]`` and ``[n_slots, 1]`` -- so admission,
progress and eviction change no shape: slot liveness is data
(``n_valid == 0`` masks a row).

Where the reference donates the page pools to its jitted step so that XLA
updates them in place, the port writes the pools in place
(``paged_step``'s scatter) and keeps the same tensors across steps.  Each
step moves its host inputs to the device in one copy and syncs once, when
the greedy argmax comes back to the host, as the reference's does.

Admission policy: FCFS, no head-of-line bypass.  The queue head is admitted
as soon as (a) a slot is free and (b) the paged KV cache can *reserve* its
worst case (``prompt + max_new - 1`` tokens: the last generated token is
returned, never written), which makes the engine deadlock-free with no
preemption path (see ``serve/kvcache.py``).

Per-phase host timing rides on ``StepTimer`` ring buffers ("schedule" /
"prefill" / "decode"); the decode timer's percentiles are the per-token
latency distribution, since every batched decode step emits one token for
each in-flight sequence and ends in its host sync.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf
from ..telemetry.trace import StepTimer
from .kvcache import PagedKVCache

__all__ = ["Request", "Completion", "ServeEngine", "sequential_generate"]


@dataclasses.dataclass(frozen=True)
class Request:
    id: int
    prompt: tuple[int, ...]
    max_new: int

    def __post_init__(self):
        if not self.prompt or self.max_new < 1:
            raise ValueError("Request needs a non-empty prompt, max_new >= 1")


@dataclasses.dataclass
class Completion:
    id: int
    prompt: tuple[int, ...]
    tokens: tuple[int, ...]       # the max_new generated tokens


@dataclasses.dataclass
class _Seq:
    """One in-flight sequence (host-side bookkeeping)."""
    req: Request
    slot: int
    order: int                    # admission sequence number (FCFS tie-break)
    consumed: int = 0             # prompt tokens already prefilled
    generated: list = dataclasses.field(default_factory=list)
    pending: Optional[int] = None  # next token to feed (None: still prefilling)

    @property
    def pos(self) -> int:
        """Absolute position of the pending token."""
        return len(self.req.prompt) + len(self.generated) - 1


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host->device copy of a small int32 array, without a sync on
    CUDA (staged through pinned memory, which the caching host allocator
    keeps alive until the copy is done)."""
    t = torch.from_numpy(host)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class ServeEngine:
    """Continuous-batching greedy-decode engine over a paged KV cache.
    ``params`` lie on the device the engine runs on."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 8,
                 page_size: int = 16, max_len: int = 256,
                 n_pages: int | None = None, prefill_chunk: int = 32,
                 use_pallas: bool = False, dtype=torch.float32):
        if n_pages is None:
            # default: every slot can grow to max_len (no queueing on pages)
            n_pages = n_slots * (-(-max_len // page_size))
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.use_pallas = use_pallas
        self.kv = PagedKVCache(cfg, n_slots=n_slots, n_pages=n_pages,
                               page_size=page_size, max_len=max_len,
                               dtype=dtype, device=self.device)
        self.timers = {k: StepTimer(capacity=8192)
                       for k in ("schedule", "prefill", "decode")}
        self._order = 0

    # -- the two step shapes ------------------------------------------------

    def _step(self, tokens: np.ndarray, pos, n_valid, tables: np.ndarray):
        """``paged_step`` on one packed host->device copy of its inputs."""
        b, c = tokens.shape
        host = np.concatenate([tokens.reshape(-1), pos, n_valid,
                               tables.reshape(-1)]).astype(np.int32)
        dev = _to_device(host, self.device)
        toks, rest = dev[:b * c].view(b, c), dev[b * c:]
        logits, self.kv.pages = tf.paged_step(
            self.params, toks, rest[:b], rest[b:2 * b],
            rest[2 * b:].view(b, -1), self.kv.pages, self.cfg,
            page_size=self.kv.page_size, use_pallas=self.use_pallas)
        return logits

    def _prefill_chunk(self, seq: _Seq) -> None:
        """Advance one sequence's prefill by one [1, prefill_chunk] slice;
        on the final slice, greedy-sample the first generated token from the
        returned last-valid-position logits."""
        c = self.prefill_chunk
        lo = seq.consumed
        hi = min(lo + c, len(seq.req.prompt))
        toks = np.zeros((1, c), np.int32)
        toks[0, :hi - lo] = seq.req.prompt[lo:hi]
        self.kv.ensure(seq.slot, hi)
        logits = self._step(toks, np.asarray([lo], np.int32),
                            np.asarray([hi - lo], np.int32),
                            self.kv.block_tables[seq.slot:seq.slot + 1])
        seq.consumed = hi
        if hi == len(seq.req.prompt):
            tok = int(torch.argmax(logits[0]))
            seq.generated.append(tok)
            seq.pending = tok

    def _decode_step(self, seqs: list) -> None:
        """One batched decode step over every decode-ready slot; inactive
        slots ride along masked (n_valid = 0)."""
        b = self.n_slots
        toks = np.zeros((b, 1), np.int32)
        pos = np.zeros((b,), np.int32)
        nv = np.zeros((b,), np.int32)
        for s in seqs:
            toks[s.slot, 0] = s.pending
            pos[s.slot] = s.pos
            nv[s.slot] = 1
            self.kv.ensure(s.slot, s.pos + 1)
        logits = self._step(toks, pos, nv, self.kv.block_tables)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # the step's sync
        for s in seqs:
            tok = int(nxt[s.slot])
            s.generated.append(tok)
            s.pending = tok

    # -- scheduler ----------------------------------------------------------

    def run(self, requests) -> list[Completion]:
        """Serve a batch of requests to completion; returns completions in
        request-id order.  Reentrant: slot and page state fully drain, so
        one engine can serve successive waves (pages are never zeroed
        between waves; the causal mask makes stale rows invisible)."""
        queue = collections.deque(
            r if isinstance(r, Request) else
            Request(id=i, prompt=tuple(r[0]), max_new=int(r[1]))
            for i, r in enumerate(requests))
        free_slots = list(range(self.n_slots - 1, -1, -1))
        active: dict[int, _Seq] = {}
        done: dict[int, Completion] = {}
        tm = self.timers

        while queue or active:
            tm["schedule"].arm()
            while queue and free_slots:
                req = queue[0]
                total = len(req.prompt) + req.max_new - 1
                if total > self.kv.max_len:
                    raise ValueError(
                        f"request {req.id}: {total} tokens exceed engine "
                        f"max_len {self.kv.max_len}")
                if not self.kv.can_admit(total):
                    break                      # FCFS: no head-of-line bypass
                queue.popleft()
                slot = free_slots.pop()
                self.kv.admit(slot, total)
                active[slot] = _Seq(req=req, slot=slot, order=self._order)
                self._order += 1
            tm["schedule"].lap()

            prefilling = [s for s in active.values() if s.pending is None]
            if prefilling:
                tm["prefill"].arm()
                self._prefill_chunk(min(prefilling, key=lambda s: s.order))
                tm["prefill"].lap()

            decoding = [s for s in active.values()
                        if s.pending is not None
                        and len(s.generated) < s.req.max_new]
            if decoding:
                tm["decode"].arm()
                self._decode_step(decoding)
                tm["decode"].lap()

            for s in list(active.values()):
                if s.pending is not None and \
                        len(s.generated) >= s.req.max_new:
                    done[s.req.id] = Completion(
                        id=s.req.id, prompt=s.req.prompt,
                        tokens=tuple(s.generated[:s.req.max_new]))
                    self.kv.release(s.slot)
                    free_slots.append(s.slot)
                    del active[s.slot]

        return [done[k] for k in sorted(done)]

    def stats(self) -> dict:
        per_page = self.kv.pool_bytes() // self.kv.n_pages
        return {
            "n_slots": self.n_slots,
            "page_size": self.kv.page_size,
            "n_pages": self.kv.n_pages,
            "pool_bytes": self.kv.pool_bytes(),
            "peak_cache_bytes": self.kv.peak_pages_used * per_page,
            "phases": {k: t.summary() for k, t in self.timers.items()},
        }


# ---------------------------------------------------------------------------
# sequential dense-cache baseline (the pre-engine serving path)
# ---------------------------------------------------------------------------

def sequential_generate(params, cfg: ModelConfig, prompts, *, gen_len: int,
                        cache_len: int, img=None, temperature: float = 0.0,
                        seed: int = 0, chunk: int = 256,
                        use_pallas: bool = False):
    """prompts [B, S] -> tokens [B, S + gen_len] through the dense per-batch
    KV cache, or a Mamba stack's O(1) state (prefill + decode_step).  Greedy
    at temperature 0, the engine's parity baseline.  ``use_pallas`` runs the
    prefill through the kernels (flash attention, the SSD scan), as the
    reference's ``prefill`` takes it; the reference's baseline never
    does.  At temperature > 0 it samples from
    ``softmax(logits / temperature)`` with a ``torch.Generator`` seeded with
    ``seed`` on the prompts' device: the same distribution as the
    reference's ``jax.random.categorical``, not its draws."""
    b, s = prompts.shape
    if gen_len < 1:
        return prompts
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=prompts.device).manual_seed(seed)

    def sample(logits):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)
        return torch.argmax(logits, dim=-1)[:, None]

    logits, cache = tf.prefill(params, prompts, cfg, img=img,
                               cache_len=cache_len, chunk=chunk,
                               use_pallas=use_pallas)
    out = [prompts]
    tok = sample(logits)
    for i in range(gen_len - 1):
        out.append(tok)
        logits, cache = tf.decode_step(params, tok, s + i, cache, cfg)
        tok = sample(logits)
    out.append(tok)
    return torch.cat([o.to(prompts.dtype) for o in out], dim=1)
