"""The port stands alone: no file of ``ray_tpu_torch`` and not
``chip_smoke.py`` imports JAX, optax or any module of the JAX package, and
its entry points never fall back to the CPU on their own."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "ray_tpu")


def _port_files():
    return sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # exact name or a dotted child: "ray_tpu_torch" is NOT "ray_tpu"
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "id", getattr(node.func, "attr", None)) in
              ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_port_files_are_found():
    files = _port_files()
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"chip_smoke.py", "ray_tpu_torch/models/gpt2.py",
            "ray_tpu_torch/ops/flash_attention.py", "ray_tpu_torch/ops/attention.py",
            "ray_tpu_torch/models/gpt2_decode.py", "ray_tpu_torch/serve/llm.py",
            "ray_tpu_torch/serve/prefix_cache.py", "ray_tpu_torch/serve/kv_transfer.py",
            "ray_tpu_torch/utils/config.py", "ray_tpu_torch/ops/ring_attention.py",
            "ray_tpu_torch/ops/moe.py", "ray_tpu_torch/parallel/__init__.py",
            "ray_tpu_torch/parallel/mesh.py", "ray_tpu_torch/parallel/sharding.py",
            "ray_tpu_torch/parallel/context.py", "ray_tpu_torch/parallel/tensor_parallel.py"} <= names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_prefix_rule():
    assert _forbidden("ray_tpu") and _forbidden("ray_tpu.ops.attention")
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert not _forbidden("ray_tpu_torch") and not _forbidden("ray_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_default_device_raises_without_cuda(monkeypatch):
    """With no CUDA device the default entry points raise instead of running
    on the CPU; the CPU is used only when asked for by name."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models import gpt2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt2.GPT2(gpt2.CONFIGS["gpt2-tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt2.init(torch.Generator(), gpt2.CONFIGS["gpt2-tiny"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    model = gpt2.GPT2(gpt2.CONFIGS["gpt2-tiny"], device="cpu")
    assert model.wte.device.type == "cpu"


def test_serving_engines_raise_without_cuda(monkeypatch):
    """LLMServer and PrefillEngine run on cuda unless given device="cpu"."""
    from ray_tpu_torch.models import gpt2, gpt2_decode
    from ray_tpu_torch.serve.kv_transfer import PrefillEngine
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (LLMServer, PrefillEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(LLMConfig(model_id="gpt2-tiny"))
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt2_decode.init_paged_cache(gpt2.CONFIGS["gpt2-tiny"], 3, 64)
    srv = LLMServer(LLMConfig(model_id="gpt2-tiny", device="cpu"))
    try:
        assert srv.model.wte.device.type == "cpu"
        assert srv({"prompt_tokens": [1, 2], "max_new_tokens": 2})["tokens"]
    finally:
        srv.unload()
        srv._thread.join(timeout=30)
    pre = PrefillEngine(LLMConfig(model_id="gpt2-tiny", device="cpu"))
    assert pre.prefill([1, 2, 3], 0.0)["prompt_len"] == 3
    pre.unload()
