"""The LLM engine of the port: continuous-batched, KV-cached GPT-2 decoding
(counterpart of ``ray_tpu/serve/llm.py``'s ``LLMServer``).

Requests are ``{"prompt_tokens": [int], "max_new_tokens": N,
"temperature": T, "stream": bool}``; answers are ``{"tokens": [int]}``, or
a generator of ``{"token", "index"}`` when streaming. An engine thread
admits requests between decode steps (continuous batching) and runs every
live sequence's next token in one batched call of
``models/gpt2_decode.py``. Two engines, as in the JAX package:

- paged (the default, ``serve_paged_kv``): one refcounted page pool holds
  generation and prefix KV, a prefix hit is a refcount bump, admission is
  by free pages, long prompts prefill in chunks between decode steps;
- slots (``serve_paged_kv=False``): a cache row per sequence and a host
  pool of prefix blocks copied in at a hit.

Both run synchronously or as a one-step lookahead pipeline
(``serve_async_decode``): chunk N+1 is dispatched from chunk N's
device-resident outputs before chunk N's tokens reach the host. The two
share one loop (``_Loop``); they differ in how a request is admitted and
prefilled, how a row gives back its KV, and which decode functions run.

Differences from the JAX package: ``LLMConfig.device`` (None = ``cuda``,
which raises without one); weights are ``gpt2.init`` from a generator on
that device seeded with 0, or a pickle of the JAX ``gpt2.init`` pytree as
numpy arrays (``checkpoint_path``, through ``gpt2.from_jax``); the
recompute engine, the metrics gauges, tracing spans and the deployment
settings (replicas, route, concurrency) are not ported (ROADMAP.md, Queue
A item 3).
"""

from __future__ import annotations

import collections
import logging
import pickle
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models import gpt2_decode as dec
from ray_tpu_torch.serve import prefix_cache
from ray_tpu_torch.utils.config import config as rtcfg

_log = logging.getLogger(__name__)


class LLMConfig:
    def __init__(
        self,
        model_id: str = "gpt2-tiny",
        max_batch_size: int = 8,
        max_new_tokens_cap: int = 256,
        checkpoint_path: Optional[str] = None,
        engine: str = "kv",  # "kv" (cached decode) | "recompute" (not ported)
        paged_kv: Optional[bool] = None,  # None = RT_SERVE_PAGED_KV
        async_decode: Optional[bool] = None,  # None = RT_SERVE_ASYNC_DECODE
        device: Optional[str] = None,  # None = cuda; "cpu" for the tests
    ):
        self.model_id = model_id
        self.max_batch_size = max_batch_size
        self.max_new_tokens_cap = max_new_tokens_cap
        self.checkpoint_path = checkpoint_path
        if engine not in ("kv", "recompute"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.paged_kv = paged_kv
        self.async_decode = async_decode
        self.device = device


class _Request:
    __slots__ = ("prompt", "max_new", "temperature", "event", "result", "error",
                 "token_q", "cancelled", "t_enqueue", "kv_import")

    def __init__(self, prompt, max_new, temperature, stream=False):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.event = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        # disaggregated decode: prefill ran elsewhere and shipped
        # {"k", "v", "first_token", "prompt_len"} (serve/kv_transfer.py);
        # admission imports the KV instead of prefilling
        self.kv_import: Optional[Dict[str, Any]] = None
        self.t_enqueue = 0.0  # monotonic, for the TTFT samples
        # set when the consumer abandoned the request (closed its stream):
        # the engine frees its KV at the next round
        self.cancelled = False
        # streaming consumers read tokens here; None marks the end
        self.token_q: Optional[queue.Queue] = queue.Queue() if stream else None


class _Chunk:
    """One dispatched-but-unharvested decode chunk (the async pipeline's
    lookahead): the pinned host buffer its tokens are being copied into and
    the event recorded after that copy, the (row, seq, finish_pending) set
    captured at dispatch, and rows cancelled while it was in flight (their
    tokens are dropped)."""

    __slots__ = ("toks_host", "done", "n_steps", "rows", "by_row", "dropped")

    def __init__(self, toks_host, done, n_steps: int):
        self.toks_host = toks_host  # [K, S] (or [S] when K == 1)
        self.done = done  # torch.cuda.Event, or None on the CPU
        self.n_steps = n_steps
        self.rows: List[tuple] = []  # (row, seq, finish_pending)
        self.by_row: Dict[int, Any] = {}
        self.dropped: set = set()


class _Seq:
    """One sequence in the decode batch (both engines)."""

    __slots__ = ("req", "length", "produced", "last_token", "active", "budget_left")

    def __init__(self, req: _Request):
        self.req = req
        self.length = 0  # tokens in KV once active
        self.produced: List[int] = []
        self.last_token = 0
        self.active = False  # prefill complete, decoding
        # decode steps still to dispatch, decremented AT DISPATCH so the
        # loop knows which rows finish in the chunk it just launched
        self.budget_left = 0


class _PagedSeq(_Seq):
    """A sequence of the paged engine. Admission reserves every page it can
    ever touch (ceil(min(prompt + max_new, T_max) / page_tokens)), so its
    page-table row never changes while it is in flight."""

    __slots__ = ("prompt", "pages", "released", "digests", "n_hit", "table",
                 "cached_tokens", "prefill_pos")

    def __init__(self, req: _Request, prompt: List[int]):
        super().__init__(req)
        self.prompt = prompt
        # page pins: matched prefix pages first, then fresh ones. Released
        # exactly once (the ``released`` latch): finish, cancel, fail and
        # unload may race, and a second release would decref pages another
        # sequence may hold
        self.pages: List[int] = []
        self.released = False
        self.digests: List[str] = []
        self.n_hit = 0  # leading pages from the prefix cache
        self.table = None  # np [MaxPages] page-table row
        self.cached_tokens = 0
        self.prefill_pos = 0  # prompt tokens already in the pool


class _Slot(_Seq):
    """A sequence of the slot engine: one cache row, prefilled at admission,
    and its refs on the host prefix pool."""

    __slots__ = ("pool", "pool_refs")

    def __init__(self, req: _Request):
        super().__init__(req)
        self.pool = None  # the BlockPool holding this slot's prefix refs
        self.pool_refs: List[str] = []


class _Transfers:
    """Host-device copies of one engine thread.

    On CUDA, uploads go through pinned buffers with ``non_blocking=True``:
    a copy from pageable memory waits for the stream, which would hold the
    engine thread until the in-flight chunk ends. The pinned buffer can be
    dropped at once: PyTorch's caching host allocator records an event on
    the stream at each such copy and reuses the block only after it. A
    chunk's tokens are copied into pinned memory at dispatch, behind an
    event; the harvest waits on that event, the engine's one wait on the
    device besides the first token of a prefill. On the CPU, uploads copy
    (never alias the host mirrors) and downloads are the tensor itself."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def up(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self.cuda:
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def down(self, t: torch.Tensor):
        """-> (host tensor, event or None); read the host tensor only after
        the event."""
        if not self.cuda:
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done


def _bucket(n: int, cap: int) -> int:
    """Next power of two from 16, at most ``cap``: a short prompt does not
    pay a T_max-wide prefill, and the widths stay few."""
    p = 16
    while p < n:
        p *= 2
    return min(p, cap)


def load_model(cfg: LLMConfig, device: torch.device) -> gpt2.GPT2:
    """The engine's weights: the JAX ``gpt2.init`` pytree pickled as numpy
    arrays at ``checkpoint_path``, else the port's random init from a
    generator on ``device`` seeded with 0."""
    mcfg = gpt2.CONFIGS[cfg.model_id]
    if cfg.checkpoint_path:
        with open(cfg.checkpoint_path, "rb") as f:
            return gpt2.from_jax(pickle.load(f), mcfg, device)
    return gpt2.init(torch.Generator(device=device).manual_seed(0), mcfg, device)


def resolve_engine_device(name: Optional[str]) -> torch.device:
    """``resolve_device`` with a CUDA index filled in: the engine thread
    makes it its current device."""
    device = resolve_device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def sample_one(logits: torch.Tensor, temperature: float, generator: torch.Generator) -> int:
    """One token from logits [V]: the argmax at temperature <= 0, else a
    draw from ``generator`` (the JAX engines split their key here)."""
    if temperature <= 0:
        return int(torch.argmax(logits))
    d = logits.device
    return int(dec.sample(logits[None], torch.full((1,), temperature, device=d),
                          torch.zeros(1, dtype=torch.bool, device=d), generator)[0])


class LLMServer:
    """The deployment callable: continuous-batched KV-cached decode."""

    def __init__(self, config: LLMConfig):
        if config.engine != "kv":
            raise NotImplementedError(
                "the recompute engine is not ported (ROADMAP.md, Queue A item 3)")
        self.cfg = config
        self.device = resolve_engine_device(config.device)
        self.model_cfg = gpt2.CONFIGS[config.model_id]
        self.model = load_model(config, self.device)
        self._seed = 1  # decode steps draw from step_generator(1, step)
        self._gen = torch.Generator(device=self.device).manual_seed(1)  # first tokens

        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._batch_sizes = collections.deque(maxlen=1000)
        self._ttfts = collections.deque(maxlen=1000)  # seconds, enqueue to first token
        self._total_batches = 0
        self._max_batch_seen = 0
        self._occupied = 0  # sequences decoding after the last engine round
        self._stop = threading.Event()
        self._paged = (bool(config.paged_kv) if config.paged_kv is not None
                       else bool(rtcfg.serve_paged_kv))
        self._async_decode = (bool(config.async_decode) if config.async_decode is not None
                              else bool(rtcfg.serve_async_decode))
        if self._paged:
            # one pool for generation and prefix KV, by default the slot
            # engine's memory: S * ceil(T_max / B) pages, plus the scratch page
            B = int(rtcfg.serve_prefix_block_tokens)
            max_pages = -(-self.model_cfg.n_positions // B)
            pool_pages = int(rtcfg.serve_kv_pool_pages) or config.max_batch_size * max_pages
            self._prefix_pool = prefix_cache.PagedKVPool(
                config.model_id, num_pages=pool_pages + 1, page_tokens=B)
            loop = self._engine_loop_paged
        else:
            self._prefix_pool = prefix_cache.BlockPool(config.model_id)
            loop = self._engine_loop_kv
        self._thread = threading.Thread(target=self._run, args=(loop,), name="llm-engine",
                                        daemon=True)
        self._thread.start()

    def _run(self, loop) -> None:
        # grad mode and the current device are per thread: set both here,
        # and keep all device work on this thread
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            loop()

    def _engine_loop_kv(self) -> None:
        _SlotLoop(self).run()

    def _engine_loop_paged(self) -> None:
        _PagedLoop(self).run()

    # -- request path ---------------------------------------------------

    def _parse(self, request: Any) -> _Request:
        if hasattr(request, "json"):  # an HTTP request object
            body = request.json()
            stream = bool(body.get("stream")) or request.query.get("stream") in ("1", "true")
            request = body
        else:
            stream = bool(request.get("stream"))
        prompt = list(request.get("prompt_tokens") or [0])
        max_new = min(int(request.get("max_new_tokens", 16)), self.cfg.max_new_tokens_cap)
        temperature = float(request.get("temperature", 0.0))
        req = _Request(prompt, max_new, temperature, stream=stream)
        req.kv_import = request.get("kv_import")
        return req

    def __call__(self, request: Any):
        req = self._parse(request)
        req.t_enqueue = time.monotonic()
        with self._lock:
            self._queue.append(req)
        self._work.set()
        if req.token_q is not None:
            return self._stream_tokens(req)
        if not req.event.wait(timeout=300):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return {"tokens": req.result}

    def _stream_tokens(self, req: _Request):
        """Token-by-token generator. Closing it before the end (the client
        went away) cancels the request, so the engine frees its KV."""
        produced = 0
        done = False
        try:
            while True:
                try:
                    tok = req.token_q.get(timeout=300)
                except queue.Empty:
                    raise TimeoutError("generation stalled") from None
                if tok is None:
                    done = True
                    if req.error is not None:
                        raise req.error
                    return
                produced += 1
                yield {"token": int(tok), "index": produced - 1}
        finally:
            if not done:
                req.cancelled = True
                self._work.set()  # wake the engine to reap it

    def batch_stats(self, _payload=None) -> Dict[str, Any]:
        with self._lock:
            sizes = list(self._batch_sizes)
            ttfts = list(self._ttfts)
            total = self._total_batches
            mx = self._max_batch_seen
        return {
            "batches": total,
            "max_batch": mx,
            "mean_batch": sum(sizes) / len(sizes) if sizes else 0,
            "occupied": self._occupied,
            "prefix": self._prefix_pool.stats(),
            "ttft_s": {"n": len(ttfts),
                       "p50": float(np.percentile(ttfts, 50)) if ttfts else None,
                       "p95": float(np.percentile(ttfts, 95)) if ttfts else None},
        }

    def unload(self) -> None:
        """Stop the engine thread: queued requests fail here, in-flight ones
        in the loop's exit path, and the pool closes."""
        self._stop.set()
        self._work.set()
        err = RuntimeError(f"engine {self.cfg.model_id!r} was unloaded")
        while True:
            with self._lock:
                req = self._queue.popleft() if self._queue else None
            if req is None:
                break
            self._fail_request(req, err)
        self._prefix_pool.close()

    @staticmethod
    def _fail_request(req: _Request, err: BaseException) -> None:
        req.error = err
        req.event.set()
        if req.token_q is not None:
            req.token_q.put(None)

    def _next_request(self) -> Optional[_Request]:
        """The oldest queued request not cancelled while it waited."""
        while True:
            with self._lock:
                req = self._queue.popleft() if self._queue else None
            if req is None or not req.cancelled:
                return req
            req.event.set()  # cancelled while queued: never admit

    def _record_step(self, occupancy: int) -> None:
        with self._lock:
            self._batch_sizes.append(occupancy)
            self._total_batches += 1
            self._max_batch_seen = max(self._max_batch_seen, occupancy)

    def _record_first_token(self, req: _Request) -> None:
        with self._lock:
            self._ttfts.append(time.monotonic() - req.t_enqueue)

    def _sample_one(self, logits: torch.Tensor, temperature: float) -> int:
        return sample_one(logits, temperature, self._gen)


def _complete(s: _Seq) -> None:
    s.req.result = s.produced[: s.req.max_new]
    s.req.event.set()
    if s.req.token_q is not None:
        s.req.token_q.put(None)  # end of stream


class _Loop:
    """One engine thread's decode batch: the rows' host step state, its
    device copy, the lookahead chunk, and the rounds (reap, admit, prefill,
    dispatch, harvest). A subclass owns the KV caches: ``admit``,
    ``prefill``, ``release`` (a retired row's KV goes back), ``host_state``
    (the arrays mirrored on the device), ``update_rows`` and ``decode``.

    A retired row's KV is reusable at once, even while a chunk that writes
    it is in flight: every device write runs on the engine's one stream,
    so the next owner's prefill lands after that chunk."""

    name = "engine"

    def __init__(self, srv: LLMServer, S: int):
        self.srv = srv
        self.mcfg, self.model = srv.model_cfg, srv.model
        self.T_max = srv.model_cfg.n_positions
        self.S = S
        self.xfer = _Transfers(srv.device)
        self.rows: List[Optional[_Seq]] = [None] * S
        self.last = np.zeros((S,), np.int64)
        self.lengths = np.zeros((S,), np.int64)
        self.temps = np.zeros((S,), np.float32)
        self.greedy = np.ones((S,), bool)
        # device copies of the step state: uploaded whole only at (re)build;
        # admissions and retirements push just their rows (update_rows)
        self.dev_state: Optional[tuple] = None
        self.dirty: set = set()
        self.step_no = 0
        self.inflight: Optional[_Chunk] = None
        self.caches = self.new_caches()

    # -- the cache layout's part ----------------------------------------

    def new_caches(self) -> tuple:
        raise NotImplementedError

    def admit(self, i: int, req: _Request) -> bool:
        """Take ``req`` into free row i; False, taking nothing, to requeue
        it until KV frees up."""
        raise NotImplementedError

    def prefill(self) -> None:
        """Prefill work between decode steps (rows admitted, not active)."""

    def release(self, i: int, s: _Seq) -> None:
        """Give back row i's KV holdings (s has just left the row)."""
        raise NotImplementedError

    def host_state(self) -> tuple:
        return self.last, self.lengths, self.temps, self.greedy

    def update_rows(self, *args) -> tuple:
        return dec.update_rows(*args)

    def decode(self, K: int, step: int) -> tuple:
        """Dispatch K decode steps from ``dev_state`` -> (tokens [K, S] or
        [S], next last tokens, next lengths), all on the device."""
        raise NotImplementedError

    def rebuild(self) -> None:
        self.caches = self.new_caches()
        self.dev_state = None
        self.dirty.clear()

    # -- shared ---------------------------------------------------------

    def join(self, i: int, s: _Seq, first: int, kv_len: int) -> None:
        """s (prefilled or imported) joins the decode batch in row i at
        position ``kv_len`` with ``first`` sampled."""
        s.active = True
        s.length = kv_len
        s.produced = [first]
        s.last_token = first
        s.budget_left = min(s.req.max_new - 1, self.T_max - 1 - kv_len)
        self.rows[i] = s
        self.last[i] = first
        self.lengths[i] = kv_len
        self.temps[i] = max(s.req.temperature, 1e-6)
        self.greedy[i] = s.req.temperature <= 0
        self.dirty.add(i)
        self.srv._record_first_token(s.req)
        if s.req.token_q is not None and s.req.max_new >= 1:
            # a zero-token ask must not leak the sampled first token
            s.req.token_q.put(first)

    def retire(self, i: int) -> None:
        """Row i leaves the decode batch: its KV goes back and its host
        state goes to values that are safe to decode as junk (length 0
        writes position 0 of a free row, or of the scratch page)."""
        s = self.rows[i]
        self.rows[i] = None
        self.last[i] = 0
        self.lengths[i] = 0
        self.temps[i] = 1e-6
        self.greedy[i] = True
        self.dirty.add(i)
        self.release(i, s)

    def finish(self, i: int) -> None:
        s = self.rows[i]
        self.retire(i)
        _complete(s)

    def fail_all(self, e: BaseException) -> None:
        """Fail every occupied row's request, and those whose finish was
        scheduled at dispatch but never harvested; keep serving."""
        for i in range(self.S):
            s = self.rows[i]
            if s is not None:
                self.retire(i)
                self.srv._fail_request(s.req, e)
        if self.inflight is not None:
            rec, self.inflight = self.inflight, None
            for _i, s, fin in rec.rows:
                if fin:
                    self.srv._fail_request(s.req, e)

    def harvest(self, rec: _Chunk) -> None:
        """Read a dispatched chunk's tokens and do its host bookkeeping:
        fan-out, stream puts, completions. In async mode this runs while
        the next chunk keeps the device busy."""
        if rec.done is not None:
            rec.done.synchronize()
        toks = rec.toks_host.numpy()
        if toks.ndim == 1:
            toks = toks[None]  # [1, S]
        live = [r for r in rec.rows if r[0] not in rec.dropped]
        for k in range(rec.n_steps):
            for i, s, _fin in live:
                s.length += 1
                s.last_token = int(toks[k, i])
                s.produced.append(s.last_token)
                if (s.req.token_q is not None and not s.req.cancelled
                        and 1 < len(s.produced) <= s.req.max_new):
                    s.req.token_q.put(s.last_token)  # the first went at join
        for i, s, fin in live:
            if fin:
                _complete(s)
            elif self.rows[i] is s:
                # keep the host mirror right for a full rebuild
                self.last[i] = s.last_token
                self.lengths[i] = s.length

    def dispatch(self, active: List[int], one_step: bool) -> _Chunk:
        up = self.xfer.up
        if self.dev_state is None:
            self.dev_state = tuple(up(a) for a in self.host_state())
        elif self.dirty:
            idx = np.asarray(sorted(self.dirty), np.int64)
            self.dev_state = self.update_rows(*self.dev_state, up(idx),
                                              *(up(a[idx]) for a in self.host_state()))
        self.dirty.clear()
        # as many tokens as every active row still needs (at most 8); one
        # while requests wait, so admission latency stays one step, or while
        # a prompt is mid-prefill, whose next chunk must follow one step
        K = 1
        if not one_step:
            K = max(1, min(8, min(self.rows[i].budget_left for i in active)))
        self.srv._record_step(len(active))
        if K > 1:
            step = self.step_no
            self.step_no += K
        else:
            self.step_no += 1
            step = self.step_no
        toks, d_last, d_len = self.decode(K, step)
        self.dev_state = (d_last, d_len) + self.dev_state[2:]
        rec = _Chunk(*self.xfer.down(toks), K)
        for i in active:
            s = self.rows[i]
            s.budget_left -= K
            fin = s.budget_left <= 0
            rec.rows.append((i, s, fin))
            rec.by_row[i] = s
            if fin:
                # budgets, not token values, end a generation: the row
                # leaves the batch now and is reusable at once; its tokens
                # and completion come at harvest
                self.retire(i)
        return rec

    def one_round(self) -> None:
        """Reap and admit, prefill, dispatch the next chunk, harvest the
        previous one (async) or this one (sync)."""
        srv, rows = self.srv, self.rows
        if self.caches is None:  # rebuild after a failed round
            self.rebuild()
        # consume the wake flag BEFORE the scans: a set() landing after
        # them stays pending for the idle wait below
        srv._work.clear()
        for i in range(self.S):  # reap requests whose consumer went away
            s = rows[i]
            if s is not None and s.req.cancelled:
                if self.inflight is not None and self.inflight.by_row.get(i) is s:
                    self.inflight.dropped.add(i)  # its in-flight tokens drop
                self.retire(i)
                s.req.event.set()
        admitted = False
        for i in range(self.S):
            if rows[i] is not None:
                continue
            req = srv._next_request()
            if req is None:
                break
            if not self.admit(i, req):
                # KV pressure: requeue at the front (FIFO holds) and stop
                # admitting until KV frees up
                with srv._lock:
                    srv._queue.appendleft(req)
                break
            admitted = True
        self.prefill()
        prefilling = any(s is not None and not s.active for s in rows)
        for i in range(self.S):  # single-token answers (and 0-token asks)
            s = rows[i]
            if s is not None and s.active and (len(s.produced) >= s.req.max_new
                                               or s.length >= self.T_max - 1):
                self.finish(i)
        active = [i for i in range(self.S) if rows[i] is not None and rows[i].active]
        srv._occupied = len(active)
        if not active:
            if self.inflight is not None:
                # drain the lookahead before idling: its tokens are real
                rec, self.inflight = self.inflight, None
                self.harvest(rec)
            elif not admitted and not prefilling:
                srv._work.wait(timeout=0.5)
            return
        with srv._lock:
            waiting = bool(srv._queue)
        rec = self.dispatch(active, one_step=waiting or prefilling)
        if srv._async_decode:
            prev, self.inflight = self.inflight, rec
            if prev is not None:
                self.harvest(prev)
        else:
            self.harvest(rec)

    def run(self) -> None:
        srv = self.srv
        while not srv._stop.is_set():
            try:
                self.one_round()
            except Exception as e:  # noqa: BLE001 — the engine must survive
                _log.exception("%s round failed; failing in-flight requests", self.name)
                self.fail_all(e)
                self.dev_state = None
                self.dirty.clear()
                # rebuild the caches in the next round's try (as the JAX
                # engine does after donation deleted them), so a failing
                # rebuild cannot kill the thread
                self.caches = None
                time.sleep(0.05)  # no hot spin on a persistent fault
        self.fail_all(RuntimeError(f"engine {srv.cfg.model_id!r} was unloaded"))
        srv._occupied = 0


class _SlotLoop(_Loop):
    """The slot engine: a cache row per sequence, prefilled at admission,
    with a host pool of prefix blocks copied in at a hit."""

    name = "kv engine"

    def __init__(self, srv: LLMServer):
        super().__init__(srv, srv.cfg.max_batch_size)

    def new_caches(self) -> tuple:
        return dec.init_cache(self.mcfg, self.S, self.T_max, self.srv.device)

    def admit(self, i: int, req: _Request) -> bool:
        mcfg, model, T_max, up = self.mcfg, self.model, self.T_max, self.xfer.up
        cache_k, cache_v = self.caches
        prompt = req.prompt[-(T_max - 1):]
        pool = self.srv._prefix_pool if rtcfg.serve_prefix_cache else None
        held: List[str] = []
        digests: List[str] = []
        cached = 0
        try:
            if req.kv_import is not None:
                # disaggregated decode: import the shipped KV and first token
                imp = req.kv_import
                n = min(int(imp["prompt_len"]), T_max - 1)
                C = _bucket(n, T_max)
                L, H, Dh = mcfg.n_layer, mcfg.n_head, mcfg.head_dim
                pk = np.zeros((L, C, H, Dh), np.float32)
                pv = np.zeros((L, C, H, Dh), np.float32)
                pk[:, :n] = np.asarray(imp["k"])[:, :n]
                pv[:, :n] = np.asarray(imp["v"])[:, :n]
                dec.write_prefix(up(pk), up(pv), cache_k, cache_v, i)
                first = int(imp["first_token"])
                prompt_len = n
            else:
                if pool is not None:
                    digests = prefix_cache.hash_blocks(prompt, pool.block_tokens)
                    # keep >= 1 prompt token uncached: its prefill gives
                    # the first token's logits
                    held, ks, vs = pool.match(digests, max_tokens=len(prompt) - 1)
                    cached = len(held) * pool.block_tokens
                if cached:
                    dec.write_prefix(up(np.concatenate(ks, axis=1)),
                                     up(np.concatenate(vs, axis=1)), cache_k, cache_v, i)
                    tail = prompt[cached:]
                    tok = np.zeros((1, _bucket(len(tail), T_max - cached)), np.int64)
                    tok[0, :len(tail)] = tail
                    logits = dec.prefill_extend(mcfg, model, up(tok), cached, len(tail),
                                                cache_k, cache_v, i)
                else:
                    tok = np.zeros((1, _bucket(len(prompt), T_max)), np.int64)
                    tok[0, :len(prompt)] = prompt
                    logits = dec.prefill(mcfg, model, up(tok), len(prompt), cache_k, cache_v, i)
                first = self.srv._sample_one(logits, req.temperature)
                prompt_len = len(prompt)
                if pool is not None and len(digests) > len(held):
                    # park the blocks just prefilled for the next request
                    # sharing this prefix: f32 host copies of the row (numpy
                    # has no bf16 without ml_dtypes; the upcast is exact)
                    row_k = cache_k[:, i].float().cpu().numpy()
                    row_v = cache_v[:, i].float().cpu().numpy()
                    B = pool.block_tokens
                    for j in range(len(held), len(digests)):
                        pool.insert(digests[j], row_k[:, j * B:(j + 1) * B].copy(),
                                    row_v[:, j * B:(j + 1) * B].copy())
                    held = list(digests)
        except Exception as e:  # noqa: BLE001
            if pool is not None and held:
                pool.release(held)
            self.srv._fail_request(req, e)
            # the caches may be half written: propagate, so the outer
            # handler fails the in-flight requests and rebuilds them
            raise
        s = _Slot(req)
        s.pool = pool
        s.pool_refs = held
        self.join(i, s, first, prompt_len)
        return True

    def release(self, i: int, s: _Slot) -> None:
        if s.pool is not None and s.pool_refs:
            s.pool.release(s.pool_refs)
            s.pool_refs = []

    def decode(self, K: int, step: int) -> tuple:
        d_last, d_len, d_temps, d_greedy = self.dev_state
        cache_k, cache_v = self.caches
        if K > 1:
            return dec.decode_multi(self.mcfg, self.model, d_last, d_len, cache_k, cache_v,
                                    d_temps, d_greedy, self.srv._seed, K, step)
        toks, d_len = dec.decode_and_sample(self.mcfg, self.model, d_last, d_len, cache_k,
                                            cache_v, d_temps, d_greedy, self.srv._seed, step)
        return toks, toks, d_len


class _PagedLoop(_Loop):
    """The paged engine: continuous batching over one paged KV pool.
    Generation and prefix pages coexist, a prefix hit is a refcount bump,
    admission is by free pages, and long prompts prefill
    ``serve_prefill_chunk_tokens`` at a time between decode steps."""

    name = "paged kv engine"

    def __init__(self, srv: LLMServer):
        self.pool = srv._prefix_pool
        self.B = self.pool.page_tokens
        self.max_pages = -(-srv.model_cfg.n_positions // self.B)  # page-table width
        self.n_phys = self.pool.num_pages
        # decode rows: bounded by the pool (every live sequence pins a page)
        S = int(rtcfg.serve_paged_max_seqs) or min(self.n_phys - 1, 4 * srv.cfg.max_batch_size)
        S = max(1, min(S, self.n_phys - 1))
        self.tables = np.zeros((S, self.max_pages), np.int64)  # zero rows -> scratch
        super().__init__(srv, S)

    def new_caches(self) -> tuple:
        return dec.init_paged_cache(self.mcfg, self.n_phys, self.B, self.srv.device)

    def rebuild(self) -> None:
        # the pool's sealed pages pointed into the old cache: its metadata
        # resets too
        super().rebuild()
        self.pool.reset()

    def host_state(self) -> tuple:
        return super().host_state() + (self.tables,)

    def update_rows(self, *args) -> tuple:
        return dec.update_rows_paged(*args)

    def join(self, i: int, s: _PagedSeq, first: int, kv_len: int) -> None:
        self.tables[i] = s.table
        super().join(i, s, first, kv_len)

    def release(self, i: int, s: _PagedSeq) -> None:
        self.tables[i] = 0
        # a sequence's pages leave it exactly once
        if s.released:
            return
        s.released = True
        pages, s.pages = s.pages, []
        if pages:
            self.pool.release_pages(pages)

    def import_kv(self, i: int, s: _PagedSeq, imp: Dict[str, Any]) -> None:
        """Disaggregated decode: write the shipped KV into the pages the
        prefix match did not cover, then seal the full blocks so the next
        import of this prefix copies nothing."""
        mcfg, B, pool, up = self.mcfg, self.B, self.pool, self.xfer.up
        n = min(int(imp["prompt_len"]), self.T_max - 1)
        skip = min(s.cached_tokens, n)  # pool-resident prefix
        if n > skip:
            L, H, Dh = mcfg.n_layer, mcfg.n_head, mcfg.head_dim
            nblk = -(-(n - skip) // B)
            kb = np.zeros((L, nblk * B, H, Dh), np.float32)
            vb = np.zeros((L, nblk * B, H, Dh), np.float32)
            kb[:, :n - skip] = np.asarray(imp["k"])[:, skip:n]
            vb[:, :n - skip] = np.asarray(imp["v"])[:, skip:n]
            first_pg = skip // B
            pages = np.asarray(s.pages[first_pg:first_pg + nblk], np.int64)
            dec.write_pages(up(kb.reshape(L, nblk, B, H, Dh)), up(vb.reshape(L, nblk, B, H, Dh)),
                            *self.caches, up(pages))
            pool.copies += nblk
            for j in range(first_pg, min(n // B, len(s.digests))):
                pool.seal(s.digests[j], int(s.pages[j]))
        s.prefill_pos = len(s.prompt)
        s.cached_tokens = n
        self.join(i, s, int(imp["first_token"]), n)

    def admit(self, i: int, req: _Request) -> bool:
        """Reserve every page the sequence can touch; False, taking nothing,
        when the pool cannot cover it."""
        B, pool = self.B, self.pool
        prompt = req.prompt[-(self.T_max - 1):]
        total_tokens = min(len(prompt) + req.max_new, self.T_max)
        n_pages = -(-total_tokens // B)
        if n_pages > self.n_phys - 1:
            self.srv._fail_request(req, RuntimeError(
                f"request needs {n_pages} KV pages; pool has {self.n_phys - 1}"))
            return True  # consumed (failed); keep admitting
        digests = prefix_cache.hash_blocks(prompt, B) if rtcfg.serve_prefix_cache else []
        if req.kv_import is not None:
            cap = int(req.kv_import["prompt_len"])
        else:
            cap = len(prompt) - 1  # keep >= 1 prompt token to prefill
        _, hit_pages = pool.match_pages(digests, max_tokens=cap)
        new_pages = pool.alloc(n_pages - len(hit_pages))
        if new_pages is None:
            pool.release_pages(hit_pages)
            return False
        s = _PagedSeq(req, prompt)
        s.pages = hit_pages + new_pages
        s.digests = digests
        s.n_hit = len(hit_pages)
        s.cached_tokens = len(hit_pages) * B
        s.prefill_pos = s.cached_tokens
        row = np.zeros((self.max_pages,), np.int64)
        row[:len(s.pages)] = s.pages
        s.table = row
        self.rows[i] = s
        try:
            if req.kv_import is not None:
                self.import_kv(i, s, req.kv_import)
        except Exception as e:  # noqa: BLE001
            self.retire(i)
            self.srv._fail_request(req, e)
            raise  # the outer handler fails in-flight requests, rebuilds
        return True

    def prefill(self) -> None:
        """Chunked prefill: at most ``serve_prefill_chunk_tokens`` prompt
        tokens per round (0 = unchunked)."""
        chunk = int(rtcfg.serve_prefill_chunk_tokens)
        budget = chunk if chunk > 0 else (1 << 30)
        for i in range(self.S):
            s = self.rows[i]
            if s is None or s.active or s.req.cancelled:
                continue
            if budget <= 0:
                break
            logits = None
            while s.prefill_pos < len(s.prompt) and budget > 0:
                start = s.prefill_pos
                n = min(len(s.prompt) - start, budget)
                width = _bucket(n, self.max_pages * self.B - start)
                n = min(n, width)
                tok = np.zeros((1, width), np.int64)
                tok[0, :n] = s.prompt[start:start + n]
                logits = dec.prefill_paged(self.mcfg, self.model, self.xfer.up(tok), start, n,
                                           *self.caches, self.xfer.up(s.table))
                s.prefill_pos = start + n
                budget -= n
            if s.prefill_pos >= len(s.prompt) and logits is not None:
                # the full prompt blocks just written become shareable:
                # seal registers each page under its digest, no copy
                n_full = len(s.prompt) // self.B
                for j in range(s.n_hit, min(n_full, len(s.digests))):
                    self.pool.seal(s.digests[j], int(s.pages[j]))
                self.join(i, s, self.srv._sample_one(logits, s.req.temperature), len(s.prompt))

    def decode(self, K: int, step: int) -> tuple:
        d_last, d_len, d_temps, d_greedy, d_tables = self.dev_state
        cache_k, cache_v = self.caches
        if K > 1:
            return dec.decode_multi_paged(self.mcfg, self.model, d_last, d_len, cache_k, cache_v,
                                          d_tables, d_temps, d_greedy, self.srv._seed, K, step)
        toks, d_len = dec.decode_paged_and_sample(self.mcfg, self.model, d_last, d_len, cache_k,
                                                  cache_v, d_tables, d_temps, d_greedy,
                                                  self.srv._seed, step)
        return toks, toks, d_len
