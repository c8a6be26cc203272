"""Disaggregated prefill/decode on the port's cluster
(ray_tpu_torch/serve/kv_transfer.py: PrefillServer, send_kv, recv_kv,
prefill_remote), at gpt2-tiny on the CPU: the contracts of
tests/test_kv_transfer.py. A prefill deployment ships each prompt's KV to
the decode ingress over an RPC channel; /v1/chat/completions answers
unary and over SSE with the same text, and that text is the byte decode of
the port's in-process (monolithic) LLMServer on the same JAX checkpoint,
bit for bit; with gpt2-tiny in f32 in both tiers, the byte decode of the
JAX LLMServer's tokens. One trace joins prefill, transfer and engine; the
shipment's bytes are the f32 rows; a SIGKILLed prefill replica fails the
request within serve_disagg_timeout_s.
"""

import dataclasses
import json
import os
import pickle
import signal
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from chip_smoke import http_json, proxy_address, request_spans, sse_post
from ray_tpu_torch import serve
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.observability import tracing
from ray_tpu_torch.serve import kv_transfer
from ray_tpu_torch.serve import llm as serve_llm
from ray_tpu_torch.serve.openai import OpenAIServer
from ray_tpu_torch.serve.openai.tokenizer import ByteTokenizer, render_chat
from ray_tpu_torch.utils.config import config

MODEL = "tiny"
DEPLOYMENT = "disagg-llm"
PREFILL = f"{DEPLOYMENT}-prefill"
# a rendered chat prompt that spans a full 64-token block and leaves room
# to decode within gpt2-tiny's 128 positions
CONTENT = "shared system preamble long enough to span a prefix block: " + "x" * 30


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
    """A decode/ingress replica and a prefill replica on the JAX checkpoint."""
    serve_llm.deploy({MODEL: _config(checkpoint)}, name=DEPLOYMENT, num_replicas=1,
                     route_prefix="/v1", disaggregated=True, prefill_replicas=1)
    yield proxy_address()
    serve.delete(DEPLOYMENT)
    serve.delete(PREFILL)


def _chat_body(content, **extra):
    return {"model": MODEL, "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": content}], **extra}


def _chat_texts(addr, prefix, content, headers=None):
    """(unary text, streamed text) of one chat completion."""
    st, out = http_json(addr, f"{prefix}/chat/completions", _chat_body(content))
    assert st == 200, out
    assert out["usage"]["completion_tokens"] == 8
    st, _ctype, events, _ttft = sse_post(addr, f"{prefix}/chat/completions",
                                         _chat_body(content), headers=headers)
    assert st == 200 and events[-1] == "[DONE]"
    streamed = "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                       for e in events[:-1])
    return out["choices"][0]["message"]["content"], streamed


def _engine_text(engine, content):
    tok = ByteTokenizer()
    prompt = tok.encode(render_chat(_chat_body(content)["messages"]))
    return tok.decode(engine({"prompt_tokens": prompt, "max_new_tokens": 8,
                              "temperature": 0.0})["tokens"])


def test_disagg_unary_stream_and_monolithic_parity(front, checkpoint):
    """The same chat completion through the disaggregated stack, unary and
    over SSE, gives one text: the monolithic engine's, bit for bit (remote
    prefill and the KV import change where prefill runs, not what is
    generated)."""
    unary, streamed = _chat_texts(front, "/v1", CONTENT)
    assert streamed == unary
    mono = serve_llm.LLMServer(_config(checkpoint))
    try:
        assert unary == _engine_text(mono, CONTENT)
    finally:
        mono.unload()
        mono._thread.join(timeout=30)


def test_disagg_request_joins_one_trace(front):
    """One traced SSE request: proxy, router, replica, engine and the
    prefill and transfer legs carry the client's trace id; the prefill leg
    names the OpenAI model and ships 2 x L x n x H x Dh x 4 bytes (f32
    rows), which the transfer leg reports too; the engine counts the
    imported KV as cached."""
    tid = "feedfacecafe0d15"
    st, _ctype, events, _ttft = sse_post(front, "/v1/chat/completions",
                                         _chat_body("trace the disaggregated path"),
                                         headers={tracing.TRACE_HEADER: tid})
    assert st == 200 and events[-1] == "[DONE]"
    want = {"proxy", "router", "replica", "engine", "prefill", "transfer"}
    deadline = time.monotonic() + 30
    spans = []
    while time.monotonic() < deadline:
        spans = [s for s in request_spans() if s["trace_id"] == tid]
        if want <= {s["component"] for s in spans}:
            break
        time.sleep(0.3)
    assert want <= {s["component"] for s in spans}, spans
    by = {s["component"]: s for s in spans}
    pre = by["prefill"]
    mcfg = tg.CONFIGS["gpt2-tiny"]
    assert pre["deployment"] == MODEL
    assert pre["kv_bytes"] == 2 * mcfg.n_layer * pre["tokens"] * mcfg.n_head * mcfg.head_dim * 4
    assert by["transfer"]["kv_bytes"] == pre["kv_bytes"]
    assert by["engine"]["cached"] is True and by["engine"]["tokens"] == 8


class _F32OpenAIServer(OpenAIServer):
    """The decode ingress with gpt2-tiny in f32, set in the replica before
    its engine is built (the cluster form of monkeypatch.setitem)."""

    def __init__(self, *args, **kwargs):
        tg.CONFIGS["gpt2-tiny"] = dataclasses.replace(tg.CONFIGS["gpt2-tiny"],
                                                      dtype=torch.float32)
        super().__init__(*args, **kwargs)


class _F32PrefillServer(kv_transfer.PrefillServer):
    """The prefill tier with gpt2-tiny in f32, set the same way."""

    def __init__(self, *args, **kwargs):
        tg.CONFIGS["gpt2-tiny"] = dataclasses.replace(tg.CONFIGS["gpt2-tiny"],
                                                      dtype=torch.float32)
        super().__init__(*args, **kwargs)


def test_disagg_texts_are_the_jax_engines_in_f32(rt, checkpoint):
    """Both tiers in f32: the disaggregated text is the byte decode of the
    JAX LLMServer's greedy tokens in f32 on the same checkpoint."""
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.serve.llm import LLMConfig as JaxLLMConfig
    from ray_tpu.serve.llm import LLMServer as JaxLLMServer

    models = {MODEL: _config(checkpoint)}
    serve.run(serve.deployment(_F32PrefillServer, name="f32-prefill").bind(models))
    serve.run(serve.deployment(_F32OpenAIServer, name="f32-disagg", route_prefix="/f32/v1")
              .bind(models, prefill_deployment="f32-prefill"))
    try:
        texts = [_chat_texts(proxy_address(), "/f32/v1", c) for c in (CONTENT, "hi there")]
    finally:
        serve.delete("f32-disagg")
        serve.delete("f32-prefill")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jg.CONFIGS, "gpt2-tiny",
                   dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jnp.float32))
        jax_srv = JaxLLMServer(JaxLLMConfig(model_id="gpt2-tiny", max_batch_size=4,
                                            checkpoint_path=checkpoint))
    try:
        for (unary, streamed), content in zip(texts, (CONTENT, "hi there")):
            assert unary == streamed == _engine_text(jax_srv, content)
    finally:
        jax_srv._stop.set()
        jax_srv._work.set()


def test_sigkilled_prefill_replica_fails_within_deadline(front):
    """prefill_remote from this process ships full-shape f32 rows; then the
    prefill replica is SIGKILLed and the next call fails within the
    serve_disagg_timeout_s budget instead of hanging on a half-open
    channel. Runs last in the module (the controller respawns the replica
    after)."""
    h = serve.get_deployment_handle(PREFILL)
    info = h.remote({"op": "info"}).result(timeout_s=60)
    assert info["models"] == [MODEL]
    mcfg = tg.CONFIGS["gpt2-tiny"]
    prompt = [int(t) for t in np.random.RandomState(5).randint(0, 256, 70)]
    imp = kv_transfer.prefill_remote(PREFILL, MODEL, {"prompt_tokens": prompt,
                                                      "temperature": 0.0}, mcfg)
    assert imp["prompt_len"] == 70
    assert imp["k"].shape == (mcfg.n_layer, 70, mcfg.n_head, mcfg.head_dim)
    assert imp["k"].dtype == imp["v"].dtype == np.float32

    os.kill(info["pid"], signal.SIGKILL)
    config.set("serve_disagg_timeout_s", 4.0)
    t0 = time.monotonic()
    try:
        with pytest.raises(Exception):
            kv_transfer.prefill_remote(PREFILL, MODEL, {"prompt_tokens": prompt,
                                                        "temperature": 0.0}, mcfg)
    finally:
        config.set("serve_disagg_timeout_s", 60.0)
    assert time.monotonic() - t0 < 20
