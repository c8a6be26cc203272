"""ray_tpu_torch.serve.openai — OpenAI-compatible serving front door.

Parity target: the reference's serve/llm ingress
(python/ray/llm/_internal/serve/deployments/routers/router.py +
serve/llm/openai_api_models.py): `/v1/completions`,
`/v1/chat/completions` and `/v1/models` speaking the OpenAI wire
protocol — JSON request/response bodies, SSE streaming
(``data: {...}\\n\\n`` frames, ``data: [DONE]`` terminator), `usage`
token accounting, and OpenAI-shaped error bodies — in front of the
native KV-cache engine (`serve/llm.py`).

Layers:
  protocol.py   request/response dataclasses, validation, SSE framing
  tokenizer.py  pluggable tokenizer registry + byte-level fallback
  ingress.py    the OpenAIServer deployment (multiplexed engines)

Deploy with ``ray_tpu_torch.serve.llm.deploy(...)``.
"""

from ray_tpu_torch.serve.openai.ingress import OpenAIServer, build_openai_deployment
from ray_tpu_torch.serve.openai.protocol import (
    ChatCompletionRequest,
    CompletionRequest,
    OpenAIError,
    error_body,
    probe,
    sse_event,
    SSE_DONE,
)
from ray_tpu_torch.serve.openai.tokenizer import (
    ByteTokenizer,
    get_tokenizer,
    register_tokenizer,
)

__all__ = [
    "ByteTokenizer",
    "ChatCompletionRequest",
    "CompletionRequest",
    "OpenAIError",
    "OpenAIServer",
    "SSE_DONE",
    "build_openai_deployment",
    "error_body",
    "get_tokenizer",
    "probe",
    "register_tokenizer",
    "sse_event",
]
