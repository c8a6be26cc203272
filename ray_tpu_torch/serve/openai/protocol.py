"""OpenAI wire protocol: request/response models, SSE framing, errors.

Parity: the reference's serve/llm OpenAI models
(python/ray/llm/_internal/serve/configs/openai_api_models.py — itself a
vLLM-protocol mirror): `/v1/completions` and `/v1/chat/completions`
request bodies validated into dataclasses, response/chunk dataclasses
serialized back to the exact field shapes the `openai` python client
parses, `usage` accounting, SSE framing (``data: {json}\n\n`` with a
``data: [DONE]\n\n`` terminator) and OpenAI-shaped error envelopes
(``{"error": {"message", "type", "param", "code"}}``).

Everything here is transport-agnostic pure data: the ingress deployment
(ingress.py) builds these from engine output, and the proxy only probes
(``probe()``) the body for routing hints (stream flag, model id,
session key) without interpreting the rest.
"""

from __future__ import annotations

import hashlib
import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class OpenAIError(Exception):
    """Validation/lookup failure that maps to an OpenAI error body."""

    def __init__(self, message: str, status: int = 400,
                 err_type: str = "invalid_request_error",
                 param: Optional[str] = None, code: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.param = param
        self.code = code

    def body(self) -> bytes:
        return error_body(
            str(self), err_type=self.err_type, param=self.param,
            code=self.code,
        )


def error_body(message: str, err_type: str = "invalid_request_error",
               param: Optional[str] = None,
               code: Optional[str] = None) -> bytes:
    return json.dumps({
        "error": {
            "message": message, "type": err_type,
            "param": param, "code": code,
        }
    }).encode()


# ---------------------------------------------------------------------------
# SSE framing
# ---------------------------------------------------------------------------

SSE_DONE = b"data: [DONE]\n\n"
SSE_CONTENT_TYPE = "text/event-stream"


def sse_event(obj: Any) -> bytes:
    """One server-sent event carrying a JSON payload (the only event
    shape the OpenAI streaming protocol uses)."""
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


def sse_error(message: str, err_type: str = "internal_error") -> bytes:
    """Mid-stream failure: the status line already went out as 200, so
    the error travels as a data event (the openai client surfaces it as
    a malformed-chunk error, matching reference behavior)."""
    return b"data: " + error_body(message, err_type=err_type) + b"\n\n"


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


def _require(body: Dict[str, Any], key: str) -> Any:
    if key not in body or body[key] is None:
        raise OpenAIError(
            f"you must provide a {key!r} parameter", param=key,
            code="missing_field",
        )
    return body[key]


def _opt_number(body: Dict[str, Any], key: str, default, lo, hi):
    v = body.get(key, default)
    if v is None:
        return default
    try:
        v = float(v)
    except (TypeError, ValueError):
        raise OpenAIError(
            f"{key!r} must be a number, got {v!r}", param=key
        ) from None
    if not lo <= v <= hi:
        raise OpenAIError(
            f"{key!r} must be between {lo} and {hi}, got {v}", param=key
        )
    return v


@dataclass
class CompletionRequest:
    model: str
    prompt: str
    max_tokens: int = 16
    temperature: float = 1.0
    stream: bool = False
    n: int = 1
    user: Optional[str] = None
    echo: bool = False

    @classmethod
    def from_body(cls, body: Any) -> "CompletionRequest":
        if not isinstance(body, dict):
            raise OpenAIError("request body must be a JSON object")
        prompt = _require(body, "prompt")
        if isinstance(prompt, list):
            # the API accepts a batch of prompts; a single-element list is
            # common client behavior, larger batches are out of scope here
            if len(prompt) != 1 or not isinstance(prompt[0], str):
                raise OpenAIError(
                    "only a single string prompt is supported", param="prompt"
                )
            prompt = prompt[0]
        if not isinstance(prompt, str):
            raise OpenAIError("'prompt' must be a string", param="prompt")
        n = int(body.get("n") or 1)
        if n != 1:
            raise OpenAIError("only n=1 is supported", param="n")
        return cls(
            model=str(_require(body, "model")),
            prompt=prompt,
            max_tokens=int(_opt_number(body, "max_tokens", 16, 0, 1 << 20)),
            temperature=_opt_number(body, "temperature", 1.0, 0.0, 2.0),
            stream=bool(body.get("stream")),
            n=1,
            user=body.get("user"),
            echo=bool(body.get("echo")),
        )


@dataclass
class ChatMessage:
    role: str
    content: str

    def as_dict(self) -> Dict[str, str]:
        return {"role": self.role, "content": self.content}


@dataclass
class ChatCompletionRequest:
    model: str
    messages: List[ChatMessage]
    max_tokens: int = 16
    temperature: float = 1.0
    stream: bool = False
    user: Optional[str] = None

    @classmethod
    def from_body(cls, body: Any) -> "ChatCompletionRequest":
        if not isinstance(body, dict):
            raise OpenAIError("request body must be a JSON object")
        raw = _require(body, "messages")
        if not isinstance(raw, list) or not raw:
            raise OpenAIError(
                "'messages' must be a non-empty array", param="messages"
            )
        messages = []
        for i, m in enumerate(raw):
            if not isinstance(m, dict) or "role" not in m:
                raise OpenAIError(
                    f"messages[{i}] must be an object with a 'role'",
                    param="messages",
                )
            content = m.get("content")
            if not isinstance(content, str):
                raise OpenAIError(
                    f"messages[{i}].content must be a string", param="messages"
                )
            messages.append(ChatMessage(str(m["role"]), content))
        # both spellings: max_completion_tokens superseded max_tokens
        max_tokens = body.get("max_completion_tokens", body.get("max_tokens", 16))
        return cls(
            model=str(_require(body, "model")),
            messages=messages,
            max_tokens=int(_opt_number(
                {"max_tokens": max_tokens}, "max_tokens", 16, 0, 1 << 20
            )),
            temperature=_opt_number(body, "temperature", 1.0, 0.0, 2.0),
            stream=bool(body.get("stream")),
            user=body.get("user"),
        )


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------


@dataclass
class UsageInfo:
    prompt_tokens: int = 0
    completion_tokens: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.prompt_tokens + self.completion_tokens,
        }


def _new_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


@dataclass
class CompletionResponse:
    model: str
    text: str
    finish_reason: str
    usage: UsageInfo
    system_fingerprint: Optional[str] = None
    id: str = field(default_factory=lambda: _new_id("cmpl"))
    created: int = field(default_factory=lambda: int(time.time()))

    def as_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "object": "text_completion",
            "created": self.created,
            "model": self.model,
            "system_fingerprint": self.system_fingerprint,
            "choices": [{
                "index": 0, "text": self.text, "logprobs": None,
                "finish_reason": self.finish_reason,
            }],
            "usage": self.usage.as_dict(),
        }

    def json_bytes(self) -> bytes:
        return json.dumps(self.as_dict()).encode()


@dataclass
class ChatCompletionResponse:
    model: str
    content: str
    finish_reason: str
    usage: UsageInfo
    system_fingerprint: Optional[str] = None
    id: str = field(default_factory=lambda: _new_id("chatcmpl"))
    created: int = field(default_factory=lambda: int(time.time()))

    def as_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "object": "chat.completion",
            "created": self.created,
            "model": self.model,
            "system_fingerprint": self.system_fingerprint,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": self.content},
                "logprobs": None,
                "finish_reason": self.finish_reason,
            }],
            "usage": self.usage.as_dict(),
        }

    def json_bytes(self) -> bytes:
        return json.dumps(self.as_dict()).encode()


def completion_chunk(rid: str, created: int, model: str, text: str,
                     finish_reason: Optional[str] = None,
                     usage: Optional[UsageInfo] = None,
                     system_fingerprint: Optional[str] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "id": rid, "object": "text_completion", "created": created,
        "model": model, "system_fingerprint": system_fingerprint,
        "choices": [{
            "index": 0, "text": text, "logprobs": None,
            "finish_reason": finish_reason,
        }],
    }
    if usage is not None:
        out["usage"] = usage.as_dict()
    return out


def chat_chunk(rid: str, created: int, model: str,
               delta: Dict[str, Any],
               finish_reason: Optional[str] = None,
               usage: Optional[UsageInfo] = None,
               system_fingerprint: Optional[str] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "id": rid, "object": "chat.completion.chunk", "created": created,
        "model": model, "system_fingerprint": system_fingerprint,
        "choices": [{
            "index": 0, "delta": delta, "logprobs": None,
            "finish_reason": finish_reason,
        }],
    }
    if usage is not None:
        out["usage"] = usage.as_dict()
    return out


def model_list(model_ids: List[str]) -> Dict[str, Any]:
    return {
        "object": "list",
        "data": [
            {
                "id": mid, "object": "model", "created": 0,
                "owned_by": "ray_tpu_torch",
            }
            for mid in model_ids
        ],
    }


# ---------------------------------------------------------------------------
# Proxy-side body probe (routing hints only)
# ---------------------------------------------------------------------------


class Probe:
    """Routing hints the HTTP proxy extracts from an OpenAI request
    without fully interpreting it: whether the response streams (the
    stream flag lives in the JSON body, not the query string), which
    model it targets (multiplex warm-engine affinity), the session
    key (same `user` sticks to the replica holding its warm KV slots)
    and the prefix hint (requests sharing leading prompt text land on
    the replica whose engine holds those prefix KV blocks)."""

    __slots__ = ("endpoint", "stream", "model", "session_key",
                 "prefix_hint")

    def __init__(self, endpoint: str, stream: bool,
                 model: Optional[str], session_key: Optional[str],
                 prefix_hint: Optional[str] = None):
        self.endpoint = endpoint
        self.stream = stream
        self.model = model
        self.session_key = session_key
        self.prefix_hint = prefix_hint


_SESSION_HEADER = "x-session-id"

# Prefix-hint contract (must match across proxies; the engine's block
# pool is what the hint targets, so the geometry tracks the default
# serve_prefix_block_tokens=64 under the 1-byte-per-token tokenizer):
# hash the first <=256 chars of the rendered prompt, but only when at
# least 64 chars exist — shorter prompts share no full 64-token block,
# and pinning them all to one rendezvous replica would just hotspot it.
_PREFIX_HINT_MAX_CHARS = 256
_PREFIX_HINT_MIN_CHARS = 64


def _prefix_hint(obj: Dict[str, Any]) -> Optional[str]:
    """Content digest of the request's leading prompt text. Pure
    function of the body (no pid/salt) so every proxy maps a shared
    system prompt to the same rendezvous key. Chat bodies reuse the
    tokenizer's chat template rendering for the leading messages so the
    hinted text is exactly what the engine will tokenize."""
    if isinstance(obj.get("prompt"), str):
        lead = obj["prompt"]
    elif isinstance(obj.get("messages"), list):
        parts = []
        for m in obj["messages"]:
            if not isinstance(m, dict):
                return None
            parts.append(f"<|{m.get('role')}|>{m.get('content')}")
            if sum(len(p) for p in parts) >= _PREFIX_HINT_MAX_CHARS:
                break
        lead = "\n".join(parts)
    else:
        return None
    if len(lead) < _PREFIX_HINT_MIN_CHARS:
        return None
    return hashlib.blake2b(
        lead[:_PREFIX_HINT_MAX_CHARS].encode("utf-8", "replace"),
        digest_size=8,
    ).hexdigest()


def probe(method: str, path: str, body: bytes,
          headers: Dict[str, str]) -> Optional[Probe]:
    """Classify an OpenAI front-door request. Conservative on purpose:
    path shape alone is not enough (a pre-existing user deployment at
    ``/api/models`` or ``/foo/completions`` must keep its generic
    behavior), so completions/chat additionally require an OpenAI-shaped
    JSON object body carrying ``model``, and the models listing requires
    the canonical ``/v1/models`` tail. Returns None for everything
    else — the proxy's generic paths."""
    if path.endswith("/chat/completions"):
        endpoint = "chat"
    elif path.endswith("/completions"):
        endpoint = "completions"
    elif path.endswith("/v1/models") or path == "/v1/models":
        return Probe("models", False, None, None)
    else:
        return None
    try:
        obj = json.loads(body) if body else {}
    except ValueError:
        return None
    if not isinstance(obj, dict) or "model" not in obj:
        return None
    model = obj.get("model")
    user = obj.get("user") or headers.get(_SESSION_HEADER)
    return Probe(
        endpoint, bool(obj.get("stream")),
        str(model) if model is not None else None,
        str(user) if user is not None else None,
        _prefix_hint(obj),
    )


def finish_reason(produced: int, max_tokens: int) -> str:
    return "length" if produced >= max_tokens else "stop"


def split_http_result(result: Any) -> Tuple[int, str, Any]:
    """Normalize an ingress return value to (status, content_type, body).
    Bytes-like bodies (incl. zero-copy memoryviews off the direct RPC
    path) pass through unchanged."""
    if isinstance(result, tuple) and len(result) == 3:
        return result
    if isinstance(result, (bytes, bytearray, memoryview)):
        return 200, "application/json", result
    return 200, "application/json", json.dumps(result).encode()
