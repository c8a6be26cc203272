"""The port's OpenAI front door (ray_tpu_torch/serve/openai, copies of the
JAX package's ingress, protocol and tokenizer; serve.llm.deploy) on the
port's cluster, at gpt2-tiny on the CPU.

The contracts of tests/test_openai_api.py (on 2 replicas where it has 4):
models, completion and chat shapes with usage, stream equal to unary,
zero-token answers, one session pinned to one replica, OpenAI error bodies
(also over SSE), a client that disconnects mid-stream. Those of
tests/test_request_tracing.py: one trace per streamed request across
proxy, router, replica and engine, and the serving metrics filled.

And the slice held to the JAX package: the replicas load a numpy pickle of
the JAX gpt2.init (checkpoint_path); at temperature 0 their texts are the
byte decode of the port's in-process LLMServer on the same checkpoint, bit
for bit, and with gpt2-tiny in f32 in the replica, the byte decode of the
JAX LLMServer's tokens.
"""

import dataclasses
import json
import pickle
import socket
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from chip_smoke import cluster_metrics, http_json, proxy_address, request_spans, sse_post
from ray_tpu_torch import serve
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.observability import tracing
from ray_tpu_torch.serve import llm as serve_llm
from ray_tpu_torch.serve.openai import OpenAIServer
from ray_tpu_torch.serve.openai.tokenizer import ByteTokenizer, render_chat

MODEL = "tiny"
DEPLOYMENT = "openai-llm"
F32 = "openai-f32"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, cpu_mesh_devices):
    """A numpy pickle of the JAX gpt2.init of gpt2-tiny (seed 0)."""
    import jax

    from ray_tpu.models import gpt2 as jg

    path = tmp_path_factory.mktemp("ckpt") / "gpt2_tiny.pkl"
    params = jax.tree.map(np.asarray, jg.init(jax.random.PRNGKey(0), jg.CONFIGS["gpt2-tiny"]))
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return str(path)


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    # the replicas inherit it: their torch on one intra-op thread each
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu_torch.init(num_cpus=4)
        serve.start(http_port=0)
        yield ray_tpu_torch
        serve.shutdown()
        ray_tpu_torch.shutdown()


def _config(checkpoint):
    return serve_llm.LLMConfig(model_id="gpt2-tiny", max_batch_size=4,
                               checkpoint_path=checkpoint, device="cpu")


@pytest.fixture(scope="module")
def front(rt, checkpoint):
    """2 OpenAI replicas on the JAX checkpoint, and the proxy's address."""
    handle = serve_llm.deploy({MODEL: _config(checkpoint)}, name=DEPLOYMENT, num_replicas=2,
                              route_prefix="/v1")
    yield proxy_address(), handle
    serve.delete(DEPLOYMENT)


def _stream(addr, path, body, headers=None):
    """(status, content type, SSE data strings) of a streamed request."""
    st, ctype, events, _ttft = sse_post(addr, path, body, headers=headers)
    return st, ctype, events


# -- the openai-client-shaped pass ---------------------------------------------


def test_models_endpoint(front):
    addr, _ = front
    st, body = http_json(addr, "/v1/models")
    assert st == 200 and body["object"] == "list"
    assert [m["id"] for m in body["data"]] == [MODEL]
    assert body["data"][0]["object"] == "model"


def test_completion_shape_and_usage(front):
    addr, _ = front
    st, body = http_json(addr, "/v1/completions", {
        "model": MODEL, "prompt": "hello world", "max_tokens": 6, "temperature": 0,
        "user": "alice"})
    assert st == 200
    assert body["id"].startswith("cmpl-") and body["object"] == "text_completion"
    assert body["model"] == MODEL
    choice = body["choices"][0]
    assert choice["index"] == 0 and isinstance(choice["text"], str)
    assert choice["finish_reason"] == "length"
    assert body["usage"] == {"prompt_tokens": len(b"hello world"), "completion_tokens": 6,
                             "total_tokens": len(b"hello world") + 6}
    assert body["system_fingerprint"].startswith("rt-replica-")


def test_chat_completion_shape(front):
    addr, _ = front
    st, body = http_json(addr, "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 5, "temperature": 0, "user": "alice",
        "messages": [{"role": "system", "content": "you are terse"},
                     {"role": "user", "content": "hi"}]})
    assert st == 200
    assert body["id"].startswith("chatcmpl-") and body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == 5


def test_stream_unary_parity_same_prompt(front):
    addr, _ = front
    req = {"model": MODEL, "prompt": "abcabc", "max_tokens": 8, "temperature": 0,
           "user": "alice"}
    st, unary = http_json(addr, "/v1/completions", req)
    assert st == 200
    st, ctype, events = _stream(addr, "/v1/completions", req)
    assert st == 200 and ctype == "text/event-stream" and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert "".join(c["choices"][0]["text"] for c in chunks) == unary["choices"][0]["text"]
    finals = [c for c in chunks if c["choices"][0]["finish_reason"]]
    assert len(finals) == 1 and finals[0] is chunks[-1]
    assert finals[0]["usage"]["completion_tokens"] == 8


def test_chat_streaming_role_then_deltas(front):
    addr, _ = front
    st, ctype, events = _stream(addr, "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 4, "temperature": 0, "user": "alice",
        "messages": [{"role": "user", "content": "hey"}]})
    assert st == 200 and ctype == "text/event-stream" and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == 4


def test_zero_token_completion_unary_and_stream(front):
    addr, _ = front
    req = {"model": MODEL, "prompt": "xyz", "max_tokens": 0, "temperature": 0,
           "user": "alice"}
    st, body = http_json(addr, "/v1/completions", req)
    assert st == 200 and body["choices"][0]["text"] == ""
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == 0
    st, _ctype, events = _stream(addr, "/v1/completions", req)
    assert st == 200 and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["choices"][0]["text"] == "" for c in chunks)
    assert chunks[-1]["usage"]["completion_tokens"] == 0


def test_session_affinity_pins_one_replica(front):
    """One session key lands on one replica; distinct sessions spread."""
    addr, _ = front
    pinned = set()
    for _ in range(6):
        st, body = http_json(addr, "/v1/completions", {
            "model": MODEL, "prompt": "pin me", "max_tokens": 1, "temperature": 0,
            "user": "alice"})
        assert st == 200
        pinned.add(body["system_fingerprint"])
    assert len(pinned) == 1, pinned
    spread = set()
    for i in range(8):
        st, body = http_json(addr, "/v1/completions", {
            "model": MODEL, "prompt": "spread", "max_tokens": 0, "temperature": 0,
            "user": f"user-{i}"})
        assert st == 200
        spread.add(body["system_fingerprint"])
    assert len(spread) == 2, spread


def test_openai_error_bodies(front):
    addr, _ = front
    st, body = http_json(addr, "/v1/completions", {"model": MODEL})
    assert st == 400
    err = body["error"]
    assert err["type"] == "invalid_request_error"
    assert err["param"] == "prompt" and err["code"] == "missing_field"
    st, body = http_json(addr, "/v1/completions", {"model": "no-such-model", "prompt": "x"})
    assert st == 404 and body["error"]["code"] == "model_not_found"
    st, body = http_json(addr, "/v1/chat/completions", {"model": MODEL, "messages": []})
    assert st == 400 and body["error"]["param"] == "messages"


def test_stream_error_rides_sse(front):
    addr, _ = front
    st, ctype, events = _stream(addr, "/v1/completions",
                                {"model": "no-such-model", "prompt": "x"})
    assert st == 200 and ctype == "text/event-stream" and events[-1] == "[DONE]"
    assert json.loads(events[0])["error"]["code"] == "model_not_found"


def test_client_disconnect_mid_stream_keeps_serving(front):
    """Closing the socket mid-SSE closes the stream generator: the engine
    drains back to zero occupied rows and the session keeps serving."""
    addr, handle = front
    host, port = addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=60)
    body = json.dumps({"model": MODEL, "prompt": "disconnect", "max_tokens": 100,
                       "temperature": 0, "user": "alice", "stream": True}).encode()
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    got = b""
    while b"data: " not in got:
        chunk = sock.recv(4096)
        assert chunk, "stream ended before its first event"
        got += chunk
    sock.close()
    stats_handle = handle.options(multiplexed_model_id=MODEL)
    deadline = time.monotonic() + 60
    stats = {}
    while time.monotonic() < deadline:
        stats = stats_handle.remote(None, method="engine_stats").result(timeout_s=60)
        if stats.get("occupied") == 0:
            break
        time.sleep(0.3)
    assert stats.get("occupied") == 0, stats
    st, body = http_json(addr, "/v1/completions", {
        "model": MODEL, "prompt": "still alive", "max_tokens": 2, "temperature": 0,
        "user": "alice"})
    assert st == 200 and body["usage"]["completion_tokens"] == 2


# -- request tracing and the serving metrics ----------------------------------


def test_streaming_request_joins_one_trace(front):
    """One SSE chat completion with a client trace id: proxy, router,
    replica and engine spans all carry it; the proxy's span covers the
    router's (one process, one clock)."""
    addr, _ = front
    tid = "feedfacecafe0001"
    st, _ctype, events = _stream(addr, "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 8, "temperature": 0, "user": "alice",
        "messages": [{"role": "user", "content": "trace me"}]},
        headers={tracing.TRACE_HEADER: tid})
    assert st == 200 and events[-1] == "[DONE]"
    deadline = time.monotonic() + 30
    spans = []
    while time.monotonic() < deadline:
        spans = [s for s in request_spans() if s["trace_id"] == tid]
        if {"proxy", "router", "replica", "engine"} <= {s["component"] for s in spans}:
            break
        time.sleep(0.3)
    assert {"proxy", "router", "replica", "engine"} <= {s["component"] for s in spans}, spans
    by = {s["component"]: s for s in spans}
    assert by["proxy"]["deployment"] == DEPLOYMENT
    assert by["engine"]["deployment"] == "gpt2-tiny" and by["engine"]["tokens"] == 8
    proxy, router = by["proxy"], by["router"]
    assert proxy["ts_us"] <= router["ts_us"]
    assert proxy["ts_us"] + proxy["dur_us"] >= router["ts_us"] + router["dur_us"]


def test_llm_serving_metrics_populated(front):
    """After traffic the engines' series are filled: TTFT and inter-token
    histograms counted (bucket detail kept), tokens >= the request's, the
    KV and queue gauges published, batch fill counted."""
    addr, _ = front
    st, _ctype, _events = _stream(addr, "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 8, "temperature": 0, "user": "bob",
        "messages": [{"role": "user", "content": "measure me"}]})
    assert st == 200
    deadline = time.monotonic() + 30
    mx = {}
    while time.monotonic() < deadline:
        mx = cluster_metrics()
        if (any(s["count"] for s in mx.get("rt_serve_ttft_s", {}).get("series", {}).values())
                and any(s["count"] for s in
                        mx.get("rt_serve_inter_token_s", {}).get("series", {}).values())):
            break
        time.sleep(0.3)
    assert any(s["count"] >= 1 for s in mx["rt_serve_ttft_s"]["series"].values())
    assert mx["rt_serve_ttft_s"]["boundaries"]
    assert any(s["count"] >= 1 for s in mx["rt_serve_inter_token_s"]["series"].values())
    assert sum(mx["rt_serve_tokens_generated_total"]["series"].values()) >= 8
    assert mx["rt_serve_kv_slots_occupied"]["series"]
    assert mx["rt_serve_kv_pages_total"]["series"]
    assert mx["rt_serve_queued_requests"]["series"]
    assert any(s["count"] >= 1 for s in mx["rt_serve_batch_fill"]["series"].values())


# -- the slice held to the port's engine and to JAX -----------------------------

PROMPTS = ["hello world", "the quick brown fox jumps over the lazy dog " * 2,
           "0123456789" * 9]
CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "count: 1 2 3"}]
MAX_TOKENS = 12


def _front_texts(addr, prefix):
    """Each prompt's greedy completion, unary, streamed and as chat."""
    out = []
    for i, prompt in enumerate(PROMPTS):
        req = {"model": MODEL, "prompt": prompt, "max_tokens": MAX_TOKENS, "temperature": 0,
               "user": f"s{i}"}
        st, body = http_json(addr, f"{prefix}/completions", req)
        assert st == 200, body
        st, _ctype, events = _stream(addr, f"{prefix}/completions", req)
        assert st == 200 and events[-1] == "[DONE]"
        streamed = "".join(json.loads(e)["choices"][0]["text"] for e in events[:-1])
        assert streamed == body["choices"][0]["text"]
        out.append(streamed)
    st, body = http_json(addr, f"{prefix}/chat/completions", {
        "model": MODEL, "messages": CHAT, "max_tokens": MAX_TOKENS, "temperature": 0})
    assert st == 200, body
    return out + [body["choices"][0]["message"]["content"]]


def _engine_texts(engine):
    """The byte decode of ``engine``'s greedy tokens on the same prompts."""
    tok = ByteTokenizer()
    prompts = [tok.encode(p) for p in PROMPTS] + [tok.encode(render_chat(CHAT))]
    return [tok.decode(engine({"prompt_tokens": p, "max_new_tokens": MAX_TOKENS,
                               "temperature": 0.0})["tokens"]) for p in prompts]


def test_front_door_texts_are_the_in_process_engines(front, checkpoint):
    """Through the proxy, router, ingress and a replica's engine, the greedy
    texts are the in-process LLMServer's on the same checkpoint, bit for
    bit."""
    addr, _ = front
    engine = serve_llm.LLMServer(_config(checkpoint))
    try:
        want = _engine_texts(engine)
    finally:
        engine.unload()
        engine._thread.join(timeout=30)
    assert _front_texts(addr, "/v1") == want


class _F32OpenAIServer(OpenAIServer):
    """The OpenAI ingress with gpt2-tiny in f32: the replica sets the config
    before its engine is built (the cluster form of monkeypatch.setitem)."""

    def __init__(self, *args, **kwargs):
        tg.CONFIGS["gpt2-tiny"] = dataclasses.replace(tg.CONFIGS["gpt2-tiny"],
                                                      dtype=torch.float32)
        super().__init__(*args, **kwargs)


def test_front_door_texts_are_the_jax_engines_in_f32(rt, checkpoint):
    """With gpt2-tiny in f32 in the replica, the greedy texts through the
    front door are the byte decode of the JAX LLMServer's tokens in f32 on
    the same checkpoint."""
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.serve.llm import LLMConfig as JaxLLMConfig
    from ray_tpu.serve.llm import LLMServer as JaxLLMServer

    serve.run(serve.deployment(_F32OpenAIServer, name=F32, route_prefix="/f32/v1")
              .bind({MODEL: _config(checkpoint)}))
    try:
        got = _front_texts(proxy_address(), "/f32/v1")
    finally:
        serve.delete(F32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jg.CONFIGS, "gpt2-tiny",
                   dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jnp.float32))
        jax_srv = JaxLLMServer(JaxLLMConfig(model_id="gpt2-tiny", max_batch_size=4,
                                            checkpoint_path=checkpoint))
    try:
        assert got == _engine_texts(jax_srv)
    finally:
        jax_srv._stop.set()
        jax_srv._work.set()
