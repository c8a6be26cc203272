"""OpenAI ingress deployment: HTTP surface of the LLM engine.

Parity: the reference's LLMRouter/LLMServer ingress
(python/ray/llm/_internal/serve/deployments/routers/router.py): one
deployment class that terminates `/v1/completions`,
`/v1/chat/completions` and `/v1/models`, translates them to the
engine's token-id interface through the tokenizer layer, and emits
OpenAI response bodies — SSE chunks when ``stream: true``.

Each replica hosts its engines IN-PROCESS through the multiplex layer
(one ``LLMServer`` continuous-batching engine per served model id,
LRU-bounded), so the OpenAI ``model`` field doubles as the multiplexed
model id: the controller's replica stats report loaded engines, the
router prefers replicas already holding the model, and the session key
(OpenAI ``user``) rendezvous-pins a conversation to one replica's warm
KV slots.

Concurrency: requests execute on the hosting worker's RPC dispatcher
threads (direct path) or the replica's executor threads; the engine's
continuous batcher coalesces them into shared decode steps, so the
ingress itself is thread-safe by construction (no mutable state past
init beyond the engine multiplexer).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Union

from ray_tpu_torch.serve.openai import protocol
from ray_tpu_torch.serve.openai.protocol import (
    ChatCompletionRequest,
    CompletionRequest,
    OpenAIError,
    UsageInfo,
)
from ray_tpu_torch.serve.openai import tokenizer as tokenizer_mod
from ray_tpu_torch.observability import tracing


def _normalize_models(models) -> Dict[str, Any]:
    """Accept str | LLMConfig | {name: str|dict|LLMConfig} and return
    {openai model name: LLMConfig}."""
    from ray_tpu_torch.serve.llm import LLMConfig

    def to_cfg(name: str, v) -> LLMConfig:
        if isinstance(v, LLMConfig):
            return v
        if isinstance(v, str):
            return LLMConfig(model_id=v)
        if isinstance(v, dict):
            return LLMConfig(**v)
        raise TypeError(f"model {name!r}: cannot build LLMConfig from {v!r}")

    if isinstance(models, str):
        return {models: to_cfg(models, models)}
    if isinstance(models, dict):
        return {name: to_cfg(name, v) for name, v in models.items()}
    from ray_tpu_torch.serve.llm import LLMConfig as _C

    if isinstance(models, _C):
        return {models.model_id: models}
    raise TypeError(f"unsupported models spec: {models!r}")


class OpenAIServer:
    """The `/v1` deployment callable (one instance per replica)."""

    def __init__(self, models, tokenizer: Optional[str] = None,
                 max_engines_per_replica: int = 2,
                 prefill_deployment: Optional[str] = None):
        from ray_tpu_torch.serve import multiplex

        self._models = _normalize_models(models)
        self._tokenizer_name = tokenizer
        # disaggregated serving: name of the prefill-tier deployment
        # (serve/kv_transfer.py PrefillServer); None = monolithic
        self._prefill_deployment = prefill_deployment
        # engines load lazily per model id and evict LRU — the multiplex
        # registry also feeds the replica's loaded-model stats, which the
        # router's warm-engine affinity reads
        self._engines = multiplex.make_multiplexer(
            lambda model: self._load_engine(model),
            max_models=max_engines_per_replica,
        )
        # replica identity surfaced as system_fingerprint so clients (and
        # the affinity tests) can observe which replica answered
        self._fingerprint = f"rt-replica-{os.getpid()}"

    def _load_engine(self, model: str):
        from ray_tpu_torch.serve.llm import LLMServer

        cfg = self._models.get(model)
        if cfg is None:
            raise OpenAIError(
                f"model {model!r} does not exist", status=404,
                err_type="invalid_request_error", param="model",
                code="model_not_found",
            )
        return LLMServer(cfg)

    def _tokenizer_for(self, model: str):
        return tokenizer_mod.get_tokenizer(self._tokenizer_name or model)

    # -- request entry ---------------------------------------------------

    def __call__(self, request: Any):
        """Route one front-door request. ``request`` is the proxy's
        Request (method/path/body) or a plain dict (handle calls in
        tests)."""
        try:
            return self._route(request)
        except OpenAIError as e:
            return e.status, "application/json", e.body()

    def _route(self, request: Any):
        trace_id = None
        if isinstance(request, dict):  # handle.remote() / test calls
            body = request
            path = request.get("__path__", "/v1/completions")
        else:
            path = getattr(request, "path", "") or ""
            if tracing.ENABLED:
                trace_id = (getattr(request, "headers", None)
                            or {}).get(tracing.TRACE_HEADER)
            if path.endswith("/models"):
                return self.list_models()
            try:
                body = request.json()
            except ValueError:
                raise OpenAIError("request body is not valid JSON") from None
        if path.endswith("/chat/completions"):
            return self.chat_completion(body, trace_id=trace_id)
        if path.endswith("/completions"):
            return self.completion(body, trace_id=trace_id)
        if path.endswith("/models"):
            return self.list_models()
        raise OpenAIError(f"no OpenAI route for {path!r}", status=404,
                          err_type="invalid_request_error")

    # -- endpoints -------------------------------------------------------

    def list_models(self):
        return 200, "application/json", json.dumps(
            protocol.model_list(sorted(self._models))
        ).encode()

    def _error_stream(self, e: OpenAIError) -> Iterator[bytes]:
        """A stream=true request that failed before decoding began: the
        error travels as the stream's only SSE event (the proxy already
        committed to the streaming response path from its body probe)."""
        yield b"data: " + e.body() + b"\n\n"
        yield protocol.SSE_DONE

    def completion(self, body: Any, trace_id: Optional[str] = None):
        try:
            req = CompletionRequest.from_body(body)
            tok = self._tokenizer_for(req.model)
            prompt_tokens = tok.encode(req.prompt)
            engine, eng_req = self._engine_request(
                req.model, prompt_tokens, req.max_tokens, req.temperature,
                trace_id=trace_id,
            )
        except OpenAIError as e:
            if isinstance(body, dict) and body.get("stream"):
                return self._error_stream(e)
            raise
        if req.stream:
            return self._stream_completion(engine, eng_req, req, tok)
        out = engine(eng_req)
        produced: List[int] = out["tokens"]
        text = tok.decode(produced)
        if req.echo:
            text = req.prompt + text
        resp = protocol.CompletionResponse(
            model=req.model, text=text,
            finish_reason=protocol.finish_reason(len(produced), req.max_tokens),
            usage=UsageInfo(len(prompt_tokens), len(produced)),
            system_fingerprint=self._fingerprint,
        )
        return 200, "application/json", resp.json_bytes()

    def chat_completion(self, body: Any, trace_id: Optional[str] = None):
        try:
            req = ChatCompletionRequest.from_body(body)
            tok = self._tokenizer_for(req.model)
            prompt_tokens = tokenizer_mod.encode_chat(req.messages, tok)
            engine, eng_req = self._engine_request(
                req.model, prompt_tokens, req.max_tokens, req.temperature,
                trace_id=trace_id,
            )
        except OpenAIError as e:
            if isinstance(body, dict) and body.get("stream"):
                return self._error_stream(e)
            raise
        if req.stream:
            return self._stream_chat(engine, eng_req, req, tok)
        out = engine(eng_req)
        produced: List[int] = out["tokens"]
        resp = protocol.ChatCompletionResponse(
            model=req.model, content=tok.decode(produced),
            finish_reason=protocol.finish_reason(len(produced), req.max_tokens),
            usage=UsageInfo(len(prompt_tokens), len(produced)),
            system_fingerprint=self._fingerprint,
        )
        return 200, "application/json", resp.json_bytes()

    def _engine_request(self, model: str, prompt_tokens: List[int],
                        max_tokens: int, temperature: float,
                        trace_id: Optional[str] = None):
        engine = self._engines.get(model)
        vocab = engine.model_cfg.vocab_size
        eng_req = {
            # out-of-vocab tokens (a non-byte tokenizer against a tiny
            # test vocab) clamp instead of faulting the gather
            "prompt_tokens": [min(int(t), vocab - 1) for t in prompt_tokens],
            "max_new_tokens": int(max_tokens),
            "temperature": float(temperature),
        }
        if trace_id is not None:
            # rides the engine-request dict: the proxy-minted trace id
            # reaches the engine span without a header-bearing object
            eng_req["trace_id"] = trace_id
        return engine, self._maybe_disaggregate(model, engine, eng_req)

    def _maybe_disaggregate(self, model: str, engine,
                            eng_req: Dict[str, Any]) -> Dict[str, Any]:
        """Disaggregated serving: run the prefill leg on the prefill
        deployment and attach the shipped KV rows as ``kv_import`` so
        the local engine only decodes. No-op without a prefill tier or
        with RT_SERVE_DISAGG=0. A dead prefill tier fails the request
        within RT_SERVE_DISAGG_TIMEOUT_S (never a decode hang)."""
        from ray_tpu_torch.utils.config import config

        if self._prefill_deployment is None or not config.serve_disagg:
            return eng_req
        from ray_tpu_torch.serve import kv_transfer

        try:
            imp = kv_transfer.prefill_remote(
                self._prefill_deployment, model, eng_req, engine.model_cfg
            )
        except OpenAIError:
            raise
        except Exception as e:  # noqa: BLE001 — OpenAI-shaped surface
            raise OpenAIError(
                f"disaggregated prefill failed: {type(e).__name__}: {e}",
                status=500, err_type="internal_error",
            ) from e
        return {**eng_req, "kv_import": imp}

    # -- SSE streaming ---------------------------------------------------

    def _stream_completion(self, engine, eng_req: Dict[str, Any],
                           req: CompletionRequest, tok) -> Iterator[bytes]:
        """SSE chunks for /v1/completions. Closing the generator (client
        disconnect) closes the engine stream, which cancels the request
        and frees its KV slot."""
        rid = protocol._new_id("cmpl")
        created = int(time.time())
        n_prompt = len(eng_req["prompt_tokens"])

        def gen():
            eng_gen = engine({**eng_req, "stream": True})
            dec = tok.incremental_decoder()
            produced = 0
            try:
                if req.echo:
                    yield protocol.sse_event(protocol.completion_chunk(
                        rid, created, req.model, req.prompt,
                        system_fingerprint=self._fingerprint,
                    ))
                for item in eng_gen:
                    produced += 1
                    text = dec.feed(item["token"])
                    if text:
                        yield protocol.sse_event(protocol.completion_chunk(
                            rid, created, req.model, text,
                            system_fingerprint=self._fingerprint,
                        ))
                tail = dec.flush()
                if tail:
                    yield protocol.sse_event(protocol.completion_chunk(
                        rid, created, req.model, tail,
                        system_fingerprint=self._fingerprint,
                    ))
                yield protocol.sse_event(protocol.completion_chunk(
                    rid, created, req.model, "",
                    finish_reason=protocol.finish_reason(
                        produced, req.max_tokens
                    ),
                    usage=UsageInfo(n_prompt, produced),
                    system_fingerprint=self._fingerprint,
                ))
                yield protocol.SSE_DONE
            finally:
                eng_gen.close()  # disconnect mid-stream frees the KV slot

        return gen()

    def _stream_chat(self, engine, eng_req: Dict[str, Any],
                     req: ChatCompletionRequest, tok) -> Iterator[bytes]:
        rid = protocol._new_id("chatcmpl")
        created = int(time.time())
        n_prompt = len(eng_req["prompt_tokens"])

        def gen():
            eng_gen = engine({**eng_req, "stream": True})
            dec = tok.incremental_decoder()
            produced = 0
            try:
                # the role announcement chunk the openai client expects
                yield protocol.sse_event(protocol.chat_chunk(
                    rid, created, req.model,
                    {"role": "assistant", "content": ""},
                    system_fingerprint=self._fingerprint,
                ))
                for item in eng_gen:
                    produced += 1
                    text = dec.feed(item["token"])
                    if text:
                        yield protocol.sse_event(protocol.chat_chunk(
                            rid, created, req.model, {"content": text},
                            system_fingerprint=self._fingerprint,
                        ))
                tail = dec.flush()
                if tail:
                    yield protocol.sse_event(protocol.chat_chunk(
                        rid, created, req.model, {"content": tail},
                        system_fingerprint=self._fingerprint,
                    ))
                yield protocol.sse_event(protocol.chat_chunk(
                    rid, created, req.model, {},
                    finish_reason=protocol.finish_reason(
                        produced, req.max_tokens
                    ),
                    usage=UsageInfo(n_prompt, produced),
                    system_fingerprint=self._fingerprint,
                ))
                yield protocol.SSE_DONE
            finally:
                eng_gen.close()

        return gen()

    # -- introspection (tests / ops) ------------------------------------

    def engine_stats(self, model: Optional[str] = None) -> Dict[str, Any]:
        """Stats of a loaded engine WITHOUT loading it (None when the
        model has no engine on this replica)."""
        for mid in self._engines.model_ids():
            if model is None or mid == model:
                eng = self._engines.peek(mid)
                if eng is not None:
                    stats = eng.batch_stats()
                    stats["model"] = mid
                    stats["fingerprint"] = self._fingerprint
                    return stats
        return {"model": model, "fingerprint": self._fingerprint,
                "batches": 0, "occupied": 0}


def build_openai_deployment(
    models: Union[str, Dict[str, Any]],
    *,
    name: str = "openai-llm",
    num_replicas: int = 1,
    route_prefix: str = "/v1",
    tokenizer: Optional[str] = None,
    max_engines_per_replica: int = 2,
    max_concurrency: int = 16,
    autoscaling_config: Optional[Dict[str, Any]] = None,
    ray_actor_options: Optional[Dict[str, float]] = None,
    prefill_deployment: Optional[str] = None,
    max_queued_requests: Optional[int] = None,
):
    """Bind the multi-replica OpenAI front door (use serve.llm.deploy to
    also run it)."""
    from ray_tpu_torch import serve

    _normalize_models(models)  # validate early, in the driver
    dep = serve.deployment(
        OpenAIServer,
        name=name,
        num_replicas=num_replicas,
        route_prefix=route_prefix,
        max_concurrency=max_concurrency,
        autoscaling_config=autoscaling_config,
        ray_actor_options=ray_actor_options,
        max_queued_requests=max_queued_requests,
    )
    return dep.bind(
        models, tokenizer=tokenizer,
        max_engines_per_replica=max_engines_per_replica,
        prefill_deployment=prefill_deployment,
    )
