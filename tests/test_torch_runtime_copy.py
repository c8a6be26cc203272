"""The port's runtime is a copy of the JAX package's, pinned file by file.

Every module below is ``ray_tpu/<file>`` with ``\\bray_tpu\\b`` renamed to
``ray_tpu_torch`` (code, strings and comments alike) and nothing else,
except the hunks listed in ``HUNKS``, each with its reason. A change to a
copy that is not listed here fails, and so does a change to its source
that the copy did not follow: either is a porting cost to decide on, not
to drift into.

What is ported rather than copied (the LLM engines, the prefill tier and
the page pools in ``serve/llm.py``, ``serve/kv_transfer.py`` and
``serve/prefix_cache.py``, the GPU probe in ``accelerators/``, the train
backend's process group in ``collective/process_group.py``,
``ray_tpu_torch/__init__.py``, ``bench.py``, and the marked region of
``parallel/pipeline.py`` that holds ``PipelineStage``) is held to the JAX
package by behaviour, in the other ``test_torch_*`` files.
"""

import difflib
import os
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
RENAME = re.compile(r"\bray_tpu\b")

COPIES = """
_version.py usage.py native/__init__.py
utils/__init__.py utils/config.py utils/ids.py utils/serialization.py utils/rpc.py
utils/metrics.py utils/gateway.py
observability/__init__.py observability/core_metrics.py observability/tracing.py
observability/forensics.py observability/profiler.py
core/__init__.py core/exceptions.py core/object_ref.py core/task.py core/runtime_context.py
core/runtime_env.py core/scheduling.py core/placement.py core/actor.py core/object_store.py
core/ha/__init__.py core/ha/wal.py core/ha/reattach.py core/control_store.py
core/node_agent.py core/worker.py core/worker_main.py core/node_main.py core/head_main.py
core/api.py core/cluster_utils.py core/device_objects.py core/channels.py
dag.py parallel/pipeline.py
data/__init__.py data/block.py data/logical.py data/datasource.py data/executor.py
data/iterator.py data/dataset.py
collective/__init__.py collective/collective.py collective/p2p.py collective/bucketed.py
train/__init__.py train/config.py train/checkpoint.py train/context.py train/worker_group.py
train/controller.py train/trainer.py
serve/__init__.py serve/api.py serve/batching.py serve/controller.py serve/http_server.py
serve/multiplex.py serve/proxy.py serve/replica.py serve/router.py
serve/autoscale/__init__.py serve/autoscale/admission.py serve/autoscale/policy.py
serve/openai/__init__.py serve/openai/protocol.py serve/openai/tokenizer.py
serve/openai/ingress.py
""".split()

# Files of the runtime packages that are written for the port, not copied.
PORTED = {"accelerators/__init__.py", "accelerators/gpu.py", "collective/process_group.py",
          "serve/llm.py", "serve/kv_transfer.py", "serve/prefix_cache.py"}
RUNTIME_PACKAGES = ("core", "data", "utils", "observability", "accelerators", "native",
                    "collective", "train", "serve")

# A region that the port writes itself, inside a copy: from a line
# "# >>> ported: <what>" to a line "# <<< ported". The test pins the text
# around it; the region is held to the JAX package by behaviour
# (tests/test_torch_pipeline.py for parallel/pipeline.py).
_OWN_REGION = re.compile(r"(^[ \t]*# >>> ported: [^\n]*\n).*?(^[ \t]*# <<< ported\n)",
                         re.S | re.M)
_OWN = "<the port's own code>\n"


def _collapse_own(text: str) -> str:
    return _OWN_REGION.sub(lambda m: m.group(1) + _OWN + m.group(2), text)


# file -> [(text of the renamed source, or a pattern matching it; text of the port; reason)]
_OWN_FILES = ("the port's own temp_dir (under TMPDIR) and shm prefixes (rtt*): "
              "neither runtime's sweep of stale files matches the other's")
_NUM_GPUS = ("num_gpus raises instead of asking for TPU chips, which no node of the "
             "port has (ROADMAP.md, Queue A item 9)")

_TORCH_STAGE = ("the stage on torch: autograd graphs in place of jax.vjp, an explicit "
                "gradient accumulator, a torch optimizer from a factory in place of optax, "
                "and the wire format between stages (HostTensor: a host array, bf16 as its "
                "uint16 bits, out of band under pickle-5)")
_DEVICE = ("the stages' device: None is cuda (raises without it); the CPU tests pass "
           "\"cpu\"")

_HOST = ("the wire takes host arrays: a torch tensor (either device) is detached and "
         "copied to the host, bf16 widened to f32 (numpy has none), by _host_array; the "
         "JAX package's np.asarray of a jax array does that copy itself. What comes back "
         "is numpy, as in the JAX package; a bf16 leaf's sum comes back as f32, where "
         "JAX's comes back as ml_dtypes bf16 rounded at each add")
_TORCH_BACKEND = ("the train backend is torch.distributed (collective/process_group.py), "
                  "NCCL on cards and gloo on the CPU, where the JAX package's is "
                  "jax.distributed (collective/xla_group.py); workers ask for GPU, not TPU")

HUNKS = {
    "collective/__init__.py": [
        (re.compile(r"TPU-first backend mapping \(SURVEY\.md[^\n]*\n.*?jax\.distributed\.initialize "
                    r"and then build a global mesh\.\n", re.S),
         "Backend mapping in the port:\n"
         "  - device collectives are torch.distributed ops over the train\n"
         "    backend's process group (process_group.py: NCCL on cards, gloo on\n"
         "    the CPU) and the meshes built over it; this library's ops take\n"
         "    host arrays and torch tensors, and return numpy arrays;\n"
         "  - \"cpu\" backend here fills the Gloo role: host-tensor collectives\n"
         "    between actors, rendezvoused and exchanged through the control store\n"
         "    KV (the reference rendezvouses NCCLUniqueID through a named store\n"
         "    actor the same way, nccl_collective_group.py:29-60);\n"
         "  - the process group's TCP store address is handed out through the\n"
         "    control store KV (get_coordinator), so every member can call\n"
         "    torch.distributed.init_process_group and then build a mesh.\n",
         _TORCH_BACKEND),
        ("from ray_tpu_torch.collective.xla_group import get_xla_coordinator, xla_coordinator_env\n",
         "from ray_tpu_torch.collective.process_group import (\n"
         "    coordinator_env,\n    get_coordinator,\n    initialize_process_group,\n)\n",
         _TORCH_BACKEND),
        ('    "get_xla_coordinator",\n', '    "get_coordinator",\n', _TORCH_BACKEND),
        ('    "xla_coordinator_env",\n',
         '    "coordinator_env",\n    "initialize_process_group",\n', _TORCH_BACKEND),
    ],
    "collective/collective.py": [
        ("class ReduceOp:\n",
         "def _host_array(x) -> np.ndarray:\n"
         "    \"\"\"``x`` as a host array for the wire. A torch tensor, on either\n"
         "    device, is detached and copied to the host (a copy on the CPU too:\n"
         "    its owner may write into it while a bucket is on the wire), bf16\n"
         "    widened to f32; the tensor itself stays where it is. Anything else\n"
         "    goes through np.asarray, as in the JAX package.\"\"\"\n"
         "    import sys\n\n"
         "    torch = sys.modules.get(\"torch\")  # no tensor exists before torch is imported\n"
         "    if torch is not None and isinstance(x, torch.Tensor):\n"
         "        x = x.detach()\n"
         "        dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype\n"
         "        return x.to(\"cpu\", dtype, copy=True).numpy()\n"
         "    return np.asarray(x)\n\n\n"
         "class ReduceOp:\n", _HOST),
        ("    arr = np.ascontiguousarray(np.asarray(tensor))\n    t0 = time.monotonic()\n"
         "    tag = _next_tag(group, \"allreduce\")\n",
         "    arr = np.ascontiguousarray(_host_array(tensor))\n    t0 = time.monotonic()\n"
         "    tag = _next_tag(group, \"allreduce\")\n", _HOST),
        ("        out = p2p.ring_allgather(pg, np.asarray(tensor), tag,\n",
         "        out = p2p.ring_allgather(pg, _host_array(tensor), tag,\n", _HOST),
        ("        parts = _exchange(group, serialization.pack(np.asarray(tensor)),",
         "        parts = _exchange(group, serialization.pack(_host_array(tensor)),", _HOST),
        ("    arr = np.asarray(tensor)\n    t0 = time.monotonic()\n"
         "    tag = _next_tag(group, \"reducescatter\")\n",
         "    arr = _host_array(tensor)\n    t0 = time.monotonic()\n"
         "    tag = _next_tag(group, \"reducescatter\")\n", _HOST),
        ("        arr = np.asarray(tensor) if group.rank == src_rank else None\n",
         "        arr = _host_array(tensor) if group.rank == src_rank else None\n", _HOST),
        ("            serialization.pack(np.asarray(tensor))\n",
         "            serialization.pack(_host_array(tensor))\n", _HOST),
        ("    arr = np.ascontiguousarray(np.asarray(tensor))\n    t0 = time.monotonic()\n"
         "    tag = _p2p_tag(group, group.rank, dst_rank)\n",
         "    arr = np.ascontiguousarray(_host_array(tensor))\n    t0 = time.monotonic()\n"
         "    tag = _p2p_tag(group, group.rank, dst_rank)\n", _HOST),
    ],
    "collective/bucketed.py": [
        ("    closed = packer.add_leaves([np.asarray(x) for x in leaves])\n",
         "    closed = packer.add_leaves([coll_mod._host_array(x) for x in leaves])\n", _HOST),
        ("        arrs = [np.asarray(x) for x in leaves]\n",
         "        arrs = [coll_mod._host_array(x) for x in leaves]\n", _HOST),
    ],
    "train/__init__.py": [
        ("Parity: ray.train v2 (reference python/ray/train/v2/) with JAX/TPU as the\n"
         "first-class backend: JaxTrainer spawns one worker actor per host, wires\n"
         "jax.distributed + mesh env, and the train loop uses ray_tpu_torch.parallel for\n"
         "dp/fsdp/tp/cp sharding.\n",
         "Parity: ray.train v2 (reference python/ray/train/v2/) with torch on NVIDIA\n"
         "cards as the backend: TorchTrainer spawns one worker actor per card, joins\n"
         "them into one torch.distributed process group (NCCL; gloo on the CPU), and\n"
         "the train loop uses ray_tpu_torch.parallel for dp/fsdp/tp sharding.\n",
         _TORCH_BACKEND),
        ("from ray_tpu_torch.train.trainer import DataParallelTrainer, JaxTrainer\n",
         "from ray_tpu_torch.train.trainer import DataParallelTrainer, TorchTrainer\n",
         _TORCH_BACKEND),
        ('    "JaxTrainer",\n', '    "TorchTrainer",\n', _TORCH_BACKEND),
    ],
    "train/config.py": [
        ("with TPU-first fields: resources are TPU chips + slice topology instead of\n"
         "GPUs; one worker = one host = N chips (SURVEY.md §7 hard part e).\n",
         "with GPU fields: use_gpu and gpus_per_worker ask for cards (the\n"
         "cluster's GPU resource); one worker = one process = its cards.\n",
         _TORCH_BACKEND),
        ("    use_tpu: bool = False\n", "    use_gpu: bool = False\n", _TORCH_BACKEND),
        ("    tpu_chips_per_worker: int = 0\n", "    gpus_per_worker: int = 0\n", _TORCH_BACKEND),
        ("        if self.use_tpu and self.tpu_chips_per_worker:\n"
         "            res.setdefault(\"TPU\", float(self.tpu_chips_per_worker))\n",
         "        if self.use_gpu and self.gpus_per_worker:\n"
         "            res.setdefault(\"GPU\", float(self.gpus_per_worker))\n", _TORCH_BACKEND),
    ],
    "train/worker_group.py": [
        ("bundles :384-399) with the TPU worker model: one worker = one host = all\n"
         "its chips (JaxTrainer behavior, SURVEY.md §7 hard part e).\n",
         "bundles :384-399) with the torch worker model: one worker = one process,\n"
         "one rank of the process group, with its cards (GPU resources).\n",
         _TORCH_BACKEND),
        (re.compile(r"        # Multi-host TPU: join this worker into the group's JAX runtime\n"
                    r".*?            initialize_xla_group\(\n.*?            \)\n", re.S),
         "        # Join this worker into the group's torch.distributed process\n"
         "        # group before the train fn runs (parity: reference TorchConfig\n"
         "        # _setup_torch_process_group, train/torch/config.py). RT_XLA_*\n"
         "        # arrive via apply_env() on this actor; the dynamic flags re-read\n"
         "        # the process env on each access. Init failures propagate.\n"
         "        if config.xla_group:\n"
         "            from ray_tpu_torch.collective.process_group import (\n"
         "                BACKEND_ENV,\n"
         "                initialize_process_group,\n"
         "            )\n\n"
         "            initialize_process_group(\n"
         "                config.xla_group,\n"
         "                int(config.xla_rank),\n"
         "                int(config.xla_world),\n"
         "                os.environ[BACKEND_ENV],\n"
         "            )\n", _TORCH_BACKEND),
        ('                num_tpus=res.get("TPU", 0) or None,\n',
         '                resources={"GPU": res["GPU"]} if res.get("GPU") else None,\n',
         _TORCH_BACKEND),
    ],
    "train/controller.py": [
        ("        use_tpu: bool,\n        chips_per_worker: int,\n",
         "        use_gpu: bool,\n        gpus_per_worker: int,\n", _TORCH_BACKEND),
        ("                    wg, group_name, use_tpu, chips_per_worker,\n",
         "                    wg, group_name, use_gpu, gpus_per_worker,\n", _TORCH_BACKEND),
        (re.compile(r"                           use_tpu: bool, chips_per_worker: int,\n"
                    r".*?\n        wg\.setup_collectives\(group_name\)\n", re.S),
         "                           use_gpu: bool, gpus_per_worker: int,\n"
         "                           n: Optional[int] = None) -> None:\n"
         "        \"\"\"The torch backend (the JAX package's JaxBackend equivalent;\n"
         "        reference train/torch/config.py): CPU mode hides the cards from\n"
         "        the workers, which run torch on the CPU with no process group; GPU\n"
         "        mode hands every worker the RT_XLA_* env of one torch.distributed\n"
         "        process group, joined before the train fn runs: NCCL when each\n"
         "        worker has a card (gpus_per_worker >= 1), else gloo on the CPU.\"\"\"\n"
         "        from ray_tpu_torch.collective.process_group import BACKEND_ENV\n\n"
         "        if n is None:\n"
         "            n = self.scaling.num_workers\n"
         "        if not use_gpu:\n"
         "            envs = [{\"CUDA_VISIBLE_DEVICES\": \"\"} for _ in range(n)]\n"
         "            wg.apply_env(envs)\n"
         "        else:\n"
         "            backend = \"nccl\" if gpus_per_worker >= 1 else \"gloo\"\n"
         "            envs = [\n"
         "                {\n"
         "                    \"RT_XLA_GROUP\": group_name,\n"
         "                    \"RT_XLA_RANK\": str(i),\n"
         "                    \"RT_XLA_WORLD\": str(n),\n"
         "                    BACKEND_ENV: backend,\n"
         "                }\n"
         "                for i in range(n)\n"
         "            ]\n"
         "            wg.apply_env(envs)\n"
         "        wg.setup_collectives(group_name)\n", _TORCH_BACKEND),
    ],
    "train/trainer.py": [
        ('"""DataParallelTrainer / JaxTrainer — the user-facing Train API.\n\n'
         "Parity: DataParallelTrainer.fit (reference python/ray/train/v2/api/\n"
         "data_parallel_trainer.py:157) and JaxTrainer (train/v2/jax/jax_trainer.py:20).\n",
         '"""DataParallelTrainer / TorchTrainer — the user-facing Train API.\n\n'
         "Parity: DataParallelTrainer.fit (reference python/ray/train/v2/api/\n"
         "data_parallel_trainer.py:157) and TorchTrainer (train/torch/torch_trainer.py),\n"
         "the counterpart of the JAX package's JaxTrainer.\n", _TORCH_BACKEND),
        ("                    self.scaling_config.use_tpu,\n"
         "                    self.scaling_config.tpu_chips_per_worker,\n",
         "                    self.scaling_config.use_gpu,\n"
         "                    self.scaling_config.gpus_per_worker,\n", _TORCH_BACKEND),
        (re.compile(r"class JaxTrainer\(DataParallelTrainer\):\n.*\Z", re.S),
         "class TorchTrainer(DataParallelTrainer):\n"
         "    \"\"\"Data-parallel torch training: one worker per card, the workers\n"
         "    joined into one NCCL process group under ``use_gpu`` (on the CPU,\n"
         "    without a process group, when not).\n\n"
         "    Parity: reference TorchTrainer; the JAX package's JaxTrainer, whose\n"
         "    ``tpu_chips_per_worker`` defaults to 1 under ``use_tpu`` as\n"
         "    ``gpus_per_worker`` does here under ``use_gpu``.\"\"\"\n\n"
         "    def __init__(self, *args, **kwargs):\n"
         "        super().__init__(*args, **kwargs)\n"
         "        sc = self.scaling_config\n"
         "        if sc.use_gpu and not sc.gpus_per_worker:\n"
         "            sc.gpus_per_worker = 1\n", _TORCH_BACKEND),
    ],
    "core/channels.py": [
        ("import struct\nimport threading\n",
         "import struct\nimport tempfile\nimport threading\n", _OWN_FILES),
        ('_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"\n',
         '_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()\n',
         _OWN_FILES),
        ('os.path.join(_SHM_DIR, f"rtchan_{', 'os.path.join(_SHM_DIR, f"rttchan_{',
         _OWN_FILES),
    ],
    "parallel/pipeline.py": [
        ("Training semantics: forward saves each microbatch's VJP; backward pops\n"
         "it, accumulates parameter grads; apply() runs the optimizer on the\n"
         "accumulated (averaged) grads and clears them. Gradients are\n"
         "mathematically identical to the unpipelined model, which the tests\n"
         "assert.\n",
         "Training semantics: forward keeps each microbatch's autograd graph;\n"
         "backward runs ``torch.autograd.grad`` on it and sums the parameter\n"
         "grads into an accumulator in arrival order; apply() runs the\n"
         "optimizer on the accumulated (averaged) grads and clears them.\n"
         "Gradients are mathematically identical to the unpipelined model, which\n"
         "the tests assert. Activations and gradients cross between stages as\n"
         "host arrays (:class:`HostTensor`), copied off one card and onto the\n"
         "next.\n", _TORCH_STAGE),
        ("from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple\n\n"
         "import ray_tpu_torch\n",
         "import warnings\n"
         "from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple\n\n"
         "import numpy as np\nimport torch\n\nimport ray_tpu_torch\n", _TORCH_STAGE),
        (re.compile(r"@ray_tpu_torch\.remote\nclass PipelineStage:\n.*?\n\n"
                    r"(?=    def transport_info\(self\):)", re.S),
         "# >>> ported: the wire format between stages, and PipelineStage on torch autograd\n"
         + _OWN + "    # <<< ported\n\n", _TORCH_STAGE),
        ("        resources: Optional[Sequence[Dict[str, float]]] = None,\n    ):\n",
         "        resources: Optional[Sequence[Dict[str, float]]] = None,\n"
         "        device: Optional[str] = None,\n    ):\n", _DEVICE),
        ("                    opt_blob,\n                )\n",
         "                    opt_blob,\n                    device,\n                )\n", _DEVICE),
    ],
    "utils/config.py": [
        ("import json\nimport os\nimport threading\n",
         "import json\nimport os\nimport tempfile\nimport threading\n", _OWN_FILES),
        ('config.define("pip_find_links", "/tmp/ray_tpu_torch/wheels")\n',
         'config.define("pip_find_links",\n'
         '              os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "wheels"))\n',
         _OWN_FILES),
        ('config.define("temp_dir", "/tmp/ray_tpu_torch")\n',
         'config.define("temp_dir", os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))\n',
         _OWN_FILES),
        # a pattern: the end of the file
        (re.compile(r'config\.define\("crash_dir", "", dynamic=True\)\n\Z'),
         'config.define("crash_dir", "", dynamic=True)\n' + """
# --- Flags that no module of ray_tpu_torch reads -----------------------
# Their readers are modules not ported yet, named by the ROADMAP.md Queue A
# item that ports them (or, last, modules of neither package). The defines
# above stay as in the JAX package; the flags leave the registry here, so
# that config.set() or a read of one fails instead of doing nothing. An
# RT_<NAME> variable of one is ignored, as any unknown one is.
NOT_PORTED_FLAGS = {
    "item 8 (the state API, the metrics history and the alerts)": (
        "metrics_history_max_series", "alerts_enabled", "alerts_ttft_budget",
        "alerts_burn_short_s", "alerts_burn_long_s", "alerts_burn_factor",
        "alerts_kv_occupancy_frac", "alerts_for_s", "alerts_rules_extra",
        "alerts_shed_rate_max",
    ),
    "item 9 (GPU-aware scheduling; accelerators/ counts cards, not TPU chips)": (
        "num_tpus", "tpu_pod_type", "tpu_topology", "tpu_worker_id",
    ),
    "none: the Pallas kernels' blocks; the CUDA kernels fix their own tiles": (
        "flash_bq", "flash_bk",
    ),
    "none: read by neither package": (
        "worker_register_timeout_s", "worker_idle_timeout_s",
        "scheduler_spread_threshold", "actor_max_restarts", "log_to_driver",
    ),
}
for _names in NOT_PORTED_FLAGS.values():
    for _name in _names:
        del config._flags[_name]
""",
         "flags that no module of the port reads leave the registry, so that setting one "
         "fails instead of doing nothing (test_every_config_flag_is_read_by_the_port)"),
    ],
    "core/object_store.py": [
        ("import mmap\nimport os\nimport threading\n",
         "import mmap\nimport os\nimport tempfile\nimport threading\n", _OWN_FILES),
        ("from ray_tpu_torch.utils import serialization\n",
         "from ray_tpu_torch.utils import serialization\n"
         "from ray_tpu_torch.utils.config import config\n", _OWN_FILES),
        ('_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"\n',
         '_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()\n',
         _OWN_FILES),
        ('f"rtshm_{session_id[:8]}', 'f"rttshm_{session_id[:8]}', _OWN_FILES),
        ('f"rtpool_{session_id[:8]}', 'f"rttpool_{session_id[:8]}', _OWN_FILES),
        ('            "/tmp", f"rtspill_{session_id[:8]}',
         '            str(config.temp_dir), f"rttspill_{session_id[:8]}', _OWN_FILES),
    ],
    "core/runtime_env.py": [(
        '    target = os.path.join("/tmp", f"rtenv_{digest[:16]}")\n',
        "    from ray_tpu_torch.utils.config import config\n\n"
        '    target = os.path.join(str(config.temp_dir), f"rttenv_{digest[:16]}")\n',
        _OWN_FILES,
    )],
    "core/cluster_utils.py": [
        ('_SHM_DEBRIS_GLOBS = (\n'
         '    "/dev/shm/rtshm_*", "/dev/shm/rtpool_*", "/dev/shm/rtchan_*",\n'
         '    "/tmp/rtspill_*",\n)\n',
         "# The port's own prefixes (rtt*, not the JAX runtime's rt*) and spill\n"
         "# dirs under its temp_dir: neither runtime's sweep matches the other's files.\n"
         '_SHM_DEBRIS_GLOBS = (\n'
         '    "/dev/shm/rttshm_*", "/dev/shm/rttpool_*", "/dev/shm/rttchan_*",\n)\n',
         _OWN_FILES),
        ("    files (/dev/shm/rtshm_* segments, rtpool_* recycle pools, rtchan_*\n"
         "    compiled-graph channels, /tmp/rtspill_* spill dirs).",
         "    files (/dev/shm/rttshm_* segments, rttpool_* recycle pools, rttchan_*\n"
         "    compiled-graph channels, <temp_dir>/rttspill_* spill dirs).", _OWN_FILES),
        ('if "/dev/shm/rt" in line or "/tmp/rtspill_" in line:',
         'if "/dev/shm/rtt" in line or "/rttspill_" in line:', _OWN_FILES),
        ("    for pattern in _SHM_DEBRIS_GLOBS:\n",
         '    spill_glob = os.path.join(str(config.temp_dir), "rttspill_*")\n'
         "    for pattern in _SHM_DEBRIS_GLOBS + (spill_glob,):\n", _OWN_FILES),
    ],
    "core/task.py": [(
        '        if k == "num_gpus":  # accept the Ray-ism, map onto TPU chips\n'
        '            k = "num_tpus"\n',
        '        if k == "num_gpus":\n'
        "            raise NotImplementedError(\n"
        '                "num_gpus is not ported: ROADMAP.md, Queue A item 9 (GPU-aware "\n'
        '                "scheduling); ask for cards with resources={\'GPU\': n}")\n',
        _NUM_GPUS,
    )],
    "core/actor.py": [(
        '        num_tpus = opts.get("num_tpus") or opts.get("num_gpus")\n',
        '        if opts.get("num_gpus") is not None:\n'
        "            raise NotImplementedError(\n"
        '                "num_gpus is not ported: ROADMAP.md, Queue A item 9 (GPU-aware "\n'
        '                "scheduling); ask for cards with resources={\'GPU\': n}")\n'
        '        num_tpus = opts.get("num_tpus")\n',
        _NUM_GPUS,
    )],
    "core/worker.py": [
        (
            "        import jax\n\n        hosts = []\n",
            "        hosts = []\n",
            "JAX-bound: the port imports no jax",
        ),
        (
            "        # one batched transfer: jax overlaps the host->device copies\n"
            "        arrays = jax.device_put(hosts)\n",
            "        # the upload to the card waits for the port's device store\n"
            "        arrays = dev_mod.device_put(hosts)\n",
            "JAX-bound: jax.device_put becomes device_objects.device_put, which raises "
            "(ROADMAP.md, Queue A item 6); unreachable, as no DeviceValue is ever made",
        ),
    ],
    "core/control_store.py": [(
        "        from ray_tpu_torch.observability import alerts as alerts_mod\n"
        "        from ray_tpu_torch.observability import history as history_mod\n\n"
        "        self._history = history_mod.MetricsHistory(\n"
        "            base_step_s=interval,\n"
        "            max_series=int(config.metrics_history_max_series),\n"
        "        )\n"
        "        on_tick = None\n"
        "        if bool(config.alerts_enabled):\n"
        "            self._alert_engine = alerts_mod.AlertEngine(\n"
        "                alerts_mod.default_rules(), self._history\n"
        "            )\n"
        "            on_tick = self._alert_engine.evaluate\n"
        "        self._sampler = history_mod.HistorySampler(\n"
        "            self._history, self.address, self._stopped, interval,\n"
        "            on_tick=on_tick,\n"
        "        )\n"
        "        self._sampler.start()\n",
        "        # The history sampler scrapes the state API (state.py) and feeds\n"
        "        # the alert engine; the three are not ported yet (ROADMAP.md,\n"
        "        # Queue A item 8), so the plane stays off as at interval 0:\n"
        "        # rpc_metrics_history and rpc_alerts answer {\"enabled\": False}.\n",
        "the metrics history and the alerts wait with the state API they scrape; "
        "init() starts this plane by default, so it cannot raise here",
    )],
    "core/device_objects.py": [
        (
            # a pattern: the source names the reference checkout by its absolute path
            re.compile('"""TPU-RDT: device-resident objects [^\n]*\n\n'
                       "Parity target: Ray Direct Transport [^\n]*\n"
                       r"\(/\w+/reference/python/ray/experimental/gpu_object_manager/\n"),
            '"""TPU-RDT: device-resident objects (ObjectRefs whose payload stays in HBM).\n\n'
            "In ray_tpu_torch the device transport waits for a store of CUDA\n"
            "tensors (ROADMAP.md, Queue A item 6): ``validate_transport(\"device\")``\n"
            "raises NotImplementedError, and so does every helper below that the\n"
            "JAX package binds to jax. The transport-neutral parts (the\n"
            "DeviceValue marker, the store's bookkeeping, the overlapped export\n"
            "writer) are kept as they are, so that the worker copy links.\n\n"
            "Parity target: Ray Direct Transport — the reference's GPUObjectManager\n"
            "(Ray's python/ray/experimental/gpu_object_manager/\n",
            "says what the port keeps; names no machine path",
        ),
        (
            'VALID_TRANSPORTS = ("object", "device")\n',
            'VALID_TRANSPORTS = ("object", "device")\n'
            "_NOT_PORTED = (\n"
            "    \"tensor_transport='device' is not ported: ray_tpu_torch has no store of \"\n"
            "    \"CUDA tensors yet (ROADMAP.md, Queue A item 6, RDT for CUDA tensors)\"\n"
            ")\n",
            "the message of every raise below",
        ),
        (
            "            f\"expected one of {VALID_TRANSPORTS}\"\n"
            "        )\n"
            "    return transport\n",
            "            f\"expected one of {VALID_TRANSPORTS}\"\n"
            "        )\n"
            "    if transport == \"device\":\n"
            "        raise NotImplementedError(_NOT_PORTED)\n"
            "    return transport\n",
            "the API boundary: put, options and @method refuse the device transport",
        ),
        (
            "def _is_device_array(x: Any) -> bool:\n"
            "    import jax\n\n"
            "    return isinstance(x, jax.Array)\n",
            "def _is_device_array(x: Any) -> bool:\n"
            "    raise NotImplementedError(_NOT_PORTED)\n",
            "JAX-bound",
        ),
        (
            "    holds no device arrays (caller falls back to the object path).\"\"\"\n"
            "    import jax\n\n"
            "    leaves, treedef = jax.tree_util.tree_flatten(value)\n"
            "    arrays: List[Any] = []\n"
            "    static: List[Any] = []\n"
            "    for leaf in leaves:\n"
            "        if _is_device_array(leaf) and leaf.is_fully_addressable:\n"
            "            static.append(_ArraySlot(len(arrays)))\n"
            "            arrays.append(leaf)\n"
            "        else:\n"
            "            static.append(leaf)\n"
            "    if not arrays:\n"
            "        return None\n"
            "    skeleton = serialization.pack((treedef, static))\n"
            "    leaves_meta = [(tuple(a.shape), str(a.dtype)) for a in arrays]\n"
            "    return arrays, skeleton, leaves_meta\n",
            "    holds no device arrays (caller falls back to the object path).\"\"\"\n"
            "    raise NotImplementedError(_NOT_PORTED)\n",
            "JAX-bound (jax.tree_util, jax.Array)",
        ),
        (
            "    \"\"\"Inverse of :func:`split_device_value`.\"\"\"\n"
            "    import jax\n\n"
            "    treedef, static = serialization.unpack(skeleton)\n"
            "    leaves = [\n"
            "        arrays[s.index] if isinstance(s, _ArraySlot) else s for s in static\n"
            "    ]\n"
            "    return jax.tree_util.tree_unflatten(treedef, leaves)\n",
            "    \"\"\"Inverse of :func:`split_device_value`.\"\"\"\n"
            "    raise NotImplementedError(_NOT_PORTED)\n\n\n"
            "def device_put(hosts: List[Any]) -> List[Any]:\n"
            "    \"\"\"Upload host leaves to the card (the JAX worker's jax.device_put).\"\"\"\n"
            "    raise NotImplementedError(_NOT_PORTED)\n",
            "JAX-bound (jax.tree_util); device_put stands for the worker's jax.device_put",
        ),
    ],
}


def _expected(rel: str) -> str:
    text = RENAME.sub("ray_tpu_torch", (ROOT / "ray_tpu" / rel).read_text())
    for old, new, _reason in HUNKS.get(rel, []):
        pattern = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
        assert len(pattern.findall(text)) == 1, \
            f"hunk of {rel} no longer matches its source once:\n{old}"
        text = pattern.sub(lambda _: new, text)
    return text


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_source_under_the_rename(rel):
    got = _collapse_own((ROOT / "ray_tpu_torch" / rel).read_text())
    want = _expected(rel)
    if got != want:
        diff = "".join(difflib.unified_diff(want.splitlines(True), got.splitlines(True),
                                            f"ray_tpu/{rel} (renamed, listed hunks)",
                                            f"ray_tpu_torch/{rel}", n=2))
        pytest.fail(f"ray_tpu_torch/{rel} differs from its source beyond the listed hunks:\n"
                    + diff[:6000])


def test_every_hunk_has_a_reason_and_a_copy():
    assert set(HUNKS) <= set(COPIES)
    for rel, hunks in HUNKS.items():
        for old, new, reason in hunks:
            assert old != new and reason.strip(), rel


def test_runtime_packages_hold_only_copies_and_ported_files():
    """A new file under the runtime's packages is either pinned here or
    named as ported."""
    found = {p.relative_to(ROOT / "ray_tpu_torch").as_posix()
             for pkg in RUNTIME_PACKAGES
             for p in (ROOT / "ray_tpu_torch" / pkg).rglob("*.py")}
    assert found == {c for c in COPIES if c.split("/")[0] in RUNTIME_PACKAGES} | PORTED


def test_the_port_keeps_its_files_apart_from_the_jax_runtime():
    """The port writes under its own temp_dir, inside TMPDIR, and names its
    shm segments, recycle pools and spill dirs with its own prefixes, so
    that neither runtime's sweep of stale files (each knows only its own
    daemons) can match a live session's files of the other. The RT_* flags
    are shared: the rename leaves them alone."""
    import fnmatch
    import tempfile

    from ray_tpu.core import cluster_utils as jax_cluster
    from ray_tpu.core.object_store import ShmObjectStore as JaxStore
    from ray_tpu_torch.core import cluster_utils as port_cluster
    from ray_tpu_torch.core.object_store import ShmObjectStore as PortStore
    from ray_tpu_torch.utils.config import config

    assert config.temp_dir == os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    sid, node = "0123456789abcdef", "fedcba9876543210"

    def paths(store):
        return [store._prefix + "_x", store._recycle_prefix + "_x", store._spill_dir]

    port, jax = paths(PortStore(sid, node, 1 << 20)), paths(JaxStore(sid, node, 1 << 20))
    assert port[2].startswith(str(config.temp_dir) + os.sep)
    port_globs = port_cluster._SHM_DEBRIS_GLOBS + (
        os.path.join(str(config.temp_dir), "rttspill_*"),)
    for path in port:
        assert any(fnmatch.fnmatch(path, g) for g in port_globs), path
        assert not any(fnmatch.fnmatch(path, g) for g in jax_cluster._SHM_DEBRIS_GLOBS), path
    for path in jax:
        assert not any(fnmatch.fnmatch(path, g) for g in port_globs), path
    assert RENAME.sub("ray_tpu_torch", "ray_tpu_session RT_NUM_CPUS rtshm_x") == \
        "ray_tpu_session RT_NUM_CPUS rtshm_x"


def _port_text_but_config() -> str:
    return "\n".join(p.read_text() for p in (ROOT / "ray_tpu_torch").rglob("*.py")
                     if p != ROOT / "ray_tpu_torch" / "utils" / "config.py")


def test_every_config_flag_is_read_by_the_port():
    """A flag the port keeps is named by a module of the port; one it drops
    is read by none, and setting it fails instead of doing nothing."""
    from ray_tpu_torch.utils import config as config_mod

    text = _port_text_but_config()
    kept = set(config_mod.config._flags)
    dropped = [n for names in config_mod.NOT_PORTED_FLAGS.values() for n in names]
    source = (ROOT / "ray_tpu" / "utils" / "config.py").read_text()
    assert kept | set(dropped) == set(re.findall(r'config\.define\(\s*"(\w+)"', source))
    assert not kept & set(dropped) and len(dropped) == len(set(dropped))
    assert [n for n in sorted(kept) if not re.search(rf"\b{n}\b", text)] == []
    assert [n for n in dropped if re.search(rf"config\.{n}\b|config\.(get|set)\([\"']{n}[\"']", text)] == []
    with pytest.raises(KeyError):
        config_mod.config.set("alerts_enabled", False)
    with pytest.raises(AttributeError):
        config_mod.config.num_tpus
