"""Pluggable tokenizer layer for the OpenAI front door.

The reference resolves a HuggingFace tokenizer per served model
(vllm's get_tokenizer); this image ships no vocab files, so the
default is a deterministic BYTE-LEVEL tokenizer: token i is byte i
(0..255), which maps exactly onto the gpt2-tiny test config's
vocab_size=256 and round-trips any UTF-8 text. Real deployments
register their tokenizer under the model name::

    from ray_tpu_torch.serve.openai import register_tokenizer
    register_tokenizer("my-model", lambda: MyBPETokenizer(...))

and the ingress resolves it with ``get_tokenizer(name)`` (falling back
to the byte tokenizer so tests and dryruns never need vocab files).

A tokenizer is any object with ``encode(text) -> List[int]``,
``decode(tokens) -> str`` and ``incremental_decoder() -> obj`` where
``obj.feed(token) -> str`` yields the newly-decodable text (UTF-8
multibyte sequences must not be split mid-character across SSE chunks).
"""

from __future__ import annotations

import codecs
import threading
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# Byte-level fallback
# ---------------------------------------------------------------------------


class _ByteIncrementalDecoder:
    """Streams tokens to text without splitting multibyte characters:
    a UTF-8 continuation byte buffers until its sequence completes, so
    each feed() returns only fully-decodable text."""

    def __init__(self):
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def feed(self, token: int) -> str:
        return self._dec.decode(bytes([int(token) & 0xFF]))

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)


class ByteTokenizer:
    """Deterministic byte-level tokenizer: token i == byte i. Vocab size
    256 — exactly the gpt2-tiny test config's vocabulary."""

    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens: List[int]) -> str:
        return bytes(int(t) & 0xFF for t in tokens).decode(
            "utf-8", errors="replace"
        )

    def incremental_decoder(self) -> _ByteIncrementalDecoder:
        return _ByteIncrementalDecoder()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_registry: Dict[str, Callable[[], object]] = {}
_instances: Dict[str, object] = {}
_lock = threading.Lock()


def register_tokenizer(name: str, factory: Callable[[], object]) -> None:
    """Register a tokenizer factory under a model (or tokenizer) name."""
    with _lock:
        _registry[name] = factory
        _instances.pop(name, None)


def get_tokenizer(name: Optional[str] = None):
    """Resolve a tokenizer by name; unknown names fall back to the byte
    tokenizer (this image has no vocab files — the serving machinery,
    not text quality, is the parity surface)."""
    key = name or "byte"
    with _lock:
        inst = _instances.get(key)
        if inst is None:
            factory = _registry.get(key, ByteTokenizer)
            inst = _instances[key] = factory()
        return inst


# ---------------------------------------------------------------------------
# Chat template
# ---------------------------------------------------------------------------

# Flattens a message list into one prompt string; role sentinels keep
# turns distinguishable to the model and the trailing assistant cue asks
# for the next turn (the minimal analogue of a HF chat_template).
_ROLE_OPEN = "<|{role}|>"
_ASSISTANT_CUE = "<|assistant|>"


def render_chat(messages) -> str:
    parts = []
    for m in messages:
        role = m.role if hasattr(m, "role") else m["role"]
        content = m.content if hasattr(m, "content") else m["content"]
        parts.append(_ROLE_OPEN.format(role=role) + content)
    parts.append(_ASSISTANT_CUE)
    return "\n".join(parts)


def encode_chat(messages, tokenizer) -> List[int]:
    """Flatten messages through the chat template into the engine's
    token-id stream."""
    return tokenizer.encode(render_chat(messages))
