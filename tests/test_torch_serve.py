"""The port's serve library (ray_tpu_torch/serve: copies of the JAX
package's controller, replicas, router, proxy and handles) on the port's
cluster: the contracts of tests/test_serve.py, re-run here. Function and
class deployments through handles, HTTP routes and 404, ndjson streaming
over HTTP, a bulk body across the direct RPC, a replica killed and
replaced, and the LLM deployment (build_llm_deployment, the port's engine
on the CPU at gpt2-tiny): greedy deterministic, streamed tokens equal to
the unary ones, concurrent requests batched. Besides: the controller and
the proxy never load torch, as the JAX package's never load JAX.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from chip_smoke import proxy_address, serve_processes, torch_loaded
from ray_tpu_torch import serve
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.serve.llm import LLMConfig, build_llm_deployment


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    # the replicas inherit it: their torch on one intra-op thread each, as
    # other test files run beside this one
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu_torch.init(num_cpus=4)
        serve.start(http_port=0)
        yield ray_tpu_torch
        serve.shutdown()
        ray_tpu_torch.shutdown()


def _http(addr, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _ndjson(addr, path, body):
    req = urllib.request.Request(f"http://{addr}{path}?stream=1",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        ctype = resp.headers.get("Content-Type")
        return ctype, [json.loads(raw) for raw in resp.read().decode().splitlines()
                       if raw.strip()]


def test_function_deployment_handle(rt):
    @serve.deployment(num_replicas=1)
    def square(req):
        return req * req

    handle = serve.run(square.bind())
    assert handle.remote(7).result() == 49
    serve.delete("square")


def test_class_deployment_with_state(rt):
    @serve.deployment(num_replicas=1)
    class Greeter:
        def __init__(self, greeting):
            self.greeting = greeting

        def __call__(self, req):
            return f"{self.greeting}, {req}!"

    handle = serve.run(Greeter.bind("hello"))
    assert handle.remote("world").result() == "hello, world!"
    serve.delete("Greeter")


def test_http_proxy_routes(rt):
    @serve.deployment(num_replicas=1, route_prefix="/echo")
    class Echo:
        def __call__(self, request):
            return {"you_sent": request.json(), "path": request.path}

    serve.run(Echo.bind())
    addr = proxy_address()
    status, body = _http(addr, "/echo", {"a": 1})
    assert status == 200 and body == {"you_sent": {"a": 1}, "path": "/echo"}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _http(addr, "/nope")
    assert ei.value.code == 404
    serve.delete("Echo")


def test_streaming_deployment_over_http(rt):
    """?stream=1 answers as chunked ndjson, one line per yielded item."""

    @serve.deployment(num_replicas=1, route_prefix="/tick")
    class Ticker:
        def __call__(self, request):
            for i in range(int(request.json().get("n", 3))):
                yield {"i": i}

    serve.run(Ticker.bind())
    ctype, lines = _ndjson(proxy_address(), "/tick", {"n": 5})
    assert ctype == "application/x-ndjson"
    assert lines == [{"i": i} for i in range(5)]
    serve.delete("Ticker")


def test_large_response_body_roundtrips(rt):
    """A 256 KiB bytes answer crosses the proxy's direct RPC as an
    out-of-band frame and reaches the client intact."""
    payload = bytes(range(256)) * 1024

    @serve.deployment(num_replicas=1, route_prefix="/blob")
    class Blob:
        def __call__(self, request):
            return bytes(range(256)) * 1024

    serve.run(Blob.bind())
    with urllib.request.urlopen(f"http://{proxy_address()}/blob", timeout=60) as resp:
        assert resp.read() == payload
    serve.delete("Blob")


def test_replica_death_recovery(rt):
    @serve.deployment(num_replicas=2)
    def ping(req):
        return "pong"

    handle = serve.run(ping.bind())
    assert handle.remote(None).result() == "pong"
    ray_tpu_torch.kill(ray_tpu_torch.get_actor("SERVE_REPLICA::ping#0"))
    for _ in range(5):  # the other replica answers; the router retries
        assert handle.remote(None).result(timeout_s=30) == "pong"
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and serve.status()["ping"]["running"] < 2:
        time.sleep(0.3)
    assert serve.status()["ping"]["running"] >= 2
    serve.delete("ping")


@pytest.fixture(scope="module")
def llm_handle(rt):
    """build_llm_deployment of gpt2-tiny on the CPU, route /llm."""
    handle = serve.run(build_llm_deployment(LLMConfig(
        model_id="gpt2-tiny", max_batch_size=8, batch_wait_timeout_s=0.05, device="cpu")))
    yield handle
    serve.delete("llm-gpt2-tiny")


def test_llm_streaming_tokens_match_batch(llm_handle):
    """stream over HTTP yields the unary greedy tokens one by one."""
    body = {"prompt_tokens": [5, 6, 7], "max_new_tokens": 6}
    full = llm_handle.remote(body).result(timeout_s=180)
    _ctype, lines = _ndjson(proxy_address(), "/llm", body)
    assert [ev["token"] for ev in lines] == full["tokens"]
    assert [ev["index"] for ev in lines] == list(range(6))


def test_llm_deployment_batched_generation(llm_handle):
    """Greedy decoding is deterministic, sampling returns its count, and a
    concurrent burst shares decode batches."""
    req = {"prompt_tokens": [1, 2, 3], "max_new_tokens": 5}
    out1 = llm_handle.remote(req).result(timeout_s=120)
    assert len(out1["tokens"]) == 5 and all(isinstance(t, int) for t in out1["tokens"])
    assert llm_handle.remote(req).result(timeout_s=120)["tokens"] == out1["tokens"]
    out3 = llm_handle.remote({"prompt_tokens": [1, 2, 3], "max_new_tokens": 4,
                              "temperature": 1.0}).result(timeout_s=120)
    assert len(out3["tokens"]) == 4
    resps = [llm_handle.remote({"prompt_tokens": [i], "max_new_tokens": 3}) for i in range(8)]
    assert all(len(r.result(timeout_s=180)["tokens"]) == 3 for r in resps)
    stats = llm_handle.remote(None, method="batch_stats").result(timeout_s=60)
    assert stats["max_batch"] >= 2, stats


def test_controller_and_proxy_load_no_torch(llm_handle):
    """The controller unpickles every deployment's LLMConfig and the proxy
    imports ray_tpu_torch.serve: neither loads torch; a replica does."""
    assert llm_handle.remote({"prompt_tokens": [1], "max_new_tokens": 1}).result(
        timeout_s=120)["tokens"]
    procs = serve_processes()
    names = sorted(procs)
    assert "SERVE_CONTROLLER" in names and any(n.startswith("SERVE_PROXY") for n in names)
    assert any(n.startswith("SERVE_REPLICA::llm-gpt2-tiny") for n in names)
    for name, pid in procs.items():
        assert torch_loaded(pid) == name.startswith("SERVE_REPLICA::llm-"), name
