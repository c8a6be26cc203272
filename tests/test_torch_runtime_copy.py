"""The port's runtime is a copy of the JAX package's, pinned file by file.

Every module below is ``ray_tpu/<file>`` with ``\\bray_tpu\\b`` renamed to
``ray_tpu_torch`` (code, strings and comments alike) and nothing else,
except the hunks listed in ``HUNKS``, each with its reason. A change to a
copy that is not listed here fails, and so does a change to its source
that the copy did not follow: either is a porting cost to decide on, not
to drift into.

What is ported rather than copied (the LLM engines, the prefill tier and
the page pools in ``serve/llm.py``, ``serve/kv_transfer.py`` and
``serve/prefix_cache.py``, the GPU probe and the NVLink gang group in
``accelerators/``, the train
backend's process group in ``collective/process_group.py``, the store of
device-resident tensors in ``core/device_objects.py``, the PPO learner in
``rllib/ppo.py``, ``ray_tpu_torch/__init__.py``, ``bench.py``, and the marked region of
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
observability/forensics.py observability/profiler.py observability/history.py
observability/alerts.py state.py
core/__init__.py core/exceptions.py core/object_ref.py core/task.py core/runtime_context.py
core/runtime_env.py core/scheduling.py core/placement.py core/actor.py core/object_store.py
core/ha/__init__.py core/ha/wal.py core/ha/reattach.py core/control_store.py
core/node_agent.py core/worker.py core/worker_main.py core/node_main.py core/head_main.py
core/api.py core/cluster_utils.py core/channels.py
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
rllib/__init__.py rllib/env.py
tune/__init__.py tune/session.py tune/trainable.py tune/search.py tune/schedulers.py
tune/tuner.py
job_submission.py dashboard.py cli.py __main__.py autoscaler.py
""".split()

# Files of the runtime packages that are written for the port, not copied.
PORTED = {"accelerators/__init__.py", "accelerators/gpu.py", "accelerators/slice_pg.py",
          "collective/process_group.py", "core/device_objects.py",
          "serve/llm.py", "serve/kv_transfer.py", "serve/prefix_cache.py", "rllib/ppo.py"}
RUNTIME_PACKAGES = ("core", "data", "utils", "observability", "accelerators", "native",
                    "collective", "train", "serve", "rllib", "tune")

# A region that the port writes itself, inside a copy: from a line
# "# >>> ported: <what>" to a line "# <<< ported". The test pins the text
# around it; the region is held to the JAX package by behaviour
# (tests/test_torch_pipeline.py for parallel/pipeline.py,
# tests/test_torch_autoscaler.py for autoscaler.py).
_OWN_REGION = re.compile(r"(^[ \t]*# >>> ported: [^\n]*\n).*?(^[ \t]*# <<< ported\n)",
                         re.S | re.M)
_OWN = "<the port's own code>\n"


def _collapse_own(text: str) -> str:
    return _OWN_REGION.sub(lambda m: m.group(1) + _OWN + m.group(2), text)


# file -> [(text of the renamed source, or a pattern matching it; text of the port; reason)]
_OWN_FILES = ("the port's own temp_dir (under TMPDIR) and shm prefixes (rtt*): "
              "neither runtime's sweep of stale files matches the other's")
_NUM_GPUS = ("num_gpus asks for cards (the GPU resource; a fraction shares one card), "
             "where the JAX package maps it onto TPU chips; num_tpus is refused, since no node "
             "of the port has a TPU")
_PLACEMENT = ("a worker is spawned seeing only its lease's cards (CUDA_VISIBLE_DEVICES: none "
              "for a cpu worker, as the JAX package keeps the TPU runtime off one), the "
              "lease's ids taken from the node's free shares and given back at release, and "
              "the worker pool keyed by them, since a process cannot change its cards once "
              "CUDA has started")

_TRIAL_CARDS = ("a trial's GPU asks for cards: its runner actor leases them through num_gpus "
                "(whole cards or a share of one), so the node agent spawns it seeing only "
                "them, and GPU leaves the custom resources; TPU stays num_tpus, which the "
                "port's actors refuse")
_QUEUED_TRIALS = ("a trial whose card another trial holds waits for its lease, where the JAX "
                  "package's trials take CPUs that are rarely short: the controller polled "
                  "such a runner with a drain that times out (5 s), counted each as a miss "
                  "and finished the trial as unresponsive after 24, so queued trials failed "
                  "once the trial before them ran for about two minutes; a runner is now "
                  "polled only once its actor is up, and the poll's timeout is a module "
                  "constant a test can shorten")
_DOMAINS = ("the provider's atom is one NVLink domain, a host of N cards carrying "
            "GPU-<domain>-head (accelerators/gpu.py), where the JAX package's is a TPU "
            "slice; its demand is one host a pending STRICT_PACK group of a domain "
            "(accelerators/slice_pg.py), where a TPU slice group asks one host a bundle")
_AGENT_ENV = ("a node agent can be spawned with variables of its own (the NVLink-domain "
              "provider hands one its card set as CUDA_VISIBLE_DEVICES) without touching "
              "this process's environment, which another thread may be reading")

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

_ROUTES_READY = (
    "a fix the JAX package lacks (ROADMAP.md Queue C item 2): serve.run returned once the "
    "controller saw every replica healthy, before the proxies' routing tables held them "
    "all, so traffic sent at once could all go to the replicas a proxy had heard of "
    "(streams past a full replica's max_concurrency then waited there); run() now has "
    "every proxy take the current table, and a router's long-poll applies only a newer "
    "table than the one it holds")



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
         '                num_gpus=res.get("GPU", 0) or None,\n', _TORCH_BACKEND),
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
         "        reference train/torch/config.py): in CPU mode the workers asked\n"
         "        for no card, so they see none (the node agent spawns them so) and\n"
         "        run torch on the CPU with no process group; GPU mode hands every\n"
         "        worker the RT_XLA_* env of one torch.distributed process group,\n"
         "        joined before the train fn runs: NCCL when each worker has a card\n"
         "        (gpus_per_worker >= 1), else gloo on the CPU.\"\"\"\n"
         "        from ray_tpu_torch.collective.process_group import BACKEND_ENV\n\n"
         "        if n is None:\n"
         "            n = self.scaling.num_workers\n"
         "        if use_gpu:\n"
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
    "tune/tuner.py": [
        ("from ray_tpu_torch.utils import serialization\n",
         "from ray_tpu_torch.utils import serialization\n"
         "from ray_tpu_torch.utils.config import config\n", _OWN_FILES),
        ('            "/tmp/ray_tpu_torch", "tune", f"run_{uuid.uuid4().hex[:8]}"\n',
         '            str(config.temp_dir), "tune", f"run_{uuid.uuid4().hex[:8]}"\n', _OWN_FILES),
        ('                    opts["num_cpus"] = cpus\n',
         '                    opts["num_cpus"] = cpus\n'
         '                gpus = resources.get("GPU")\n'
         "                if gpus is not None:\n"
         '                    opts["num_gpus"] = gpus\n', _TRIAL_CARDS),
        ('                    if k not in ("CPU", "TPU")\n',
         '                    if k not in ("CPU", "GPU", "TPU")\n', _TRIAL_CARDS),
        ("logger = logging.getLogger(__name__)\n",
         "logger = logging.getLogger(__name__)\n\n"
         "# A drain that outlasts this is a miss; 24 misses in a row of a runner\n"
         "# that holds its lease finish its trial as unresponsive.\n"
         "DRAIN_TIMEOUT_S = 5.0\n", _QUEUED_TRIALS),
        ("        while pending or running:\n",
         "        def placed(rec: Dict[str, Any]) -> bool:\n"
         "            # A runner whose actor still waits for its lease (the card it\n"
         "            # asks for held by another trial) is queued, not wedged: it is\n"
         "            # polled, and its misses counted, only once its actor is up.\n"
         "            if not rec.get(\"placed\"):\n"
         "                from ray_tpu_torch.core import worker as worker_mod\n\n"
         "                info = worker_mod.global_worker().control.call(\n"
         "                    \"get_actor_info\", actor_id=rec[\"actor\"]._actor_id\n"
         "                )\n"
         "                rec[\"placed\"] = info is not None and info[\"state\"] not in (\n"
         "                    \"DEPENDENCIES_UNREADY\", \"PENDING_CREATION\"\n"
         "                )\n"
         "            return rec[\"placed\"]\n\n"
         "        while pending or running:\n", _QUEUED_TRIALS),
        ("                rec = running[tid]\n                try:\n",
         "                rec = running[tid]\n"
         "                if not placed(rec):\n"
         "                    continue\n"
         "                try:\n", _QUEUED_TRIALS),
        ('rec["actor"].drain.remote(rec["cursor"]), timeout=5\n',
         'rec["actor"].drain.remote(rec["cursor"]),\n'
         "                        timeout=DRAIN_TIMEOUT_S,\n", _QUEUED_TRIALS),
    ],
    "autoscaler.py": [
        (re.compile(r"class TpuPodProvider\(NodeProvider\):\n.*?(?=\nclass Autoscaler:)", re.S),
         "# >>> ported: NVLink-domain provider\n" + _OWN + "# <<< ported\n\n", _DOMAINS),
        ("        hosts_needed = pending_slice_demand(\n"
         "            pgs, provider.node_resources(),\n"
         "            head_resource=f\"TPU-{provider.pod_type}-head\",\n",
         "        hosts_needed = pending_domain_demand(\n"
         "            pgs, provider.node_resources(),\n"
         "            head_resource=provider.head_resource,\n", _DOMAINS),
        ('        if hasattr(self.provider, "create_slice"):\n'
         "            self._step_slices(client, nodes, n_alive)\n",
         '        if hasattr(self.provider, "create_slice"):\n'
         "            launched = len(self._launched)\n"
         "            self._step_slices(client, nodes, n_alive)\n"
         "            if len(self._launched) > launched:\n"
         "                # the new slices registered after this step's view of the\n"
         "                # nodes was read: judged against it, they would be dropped\n"
         "                # from _launched below and never scaled down\n"
         "                return\n",
         "a fix the JAX package lacks (ROADMAP.md Queue C): the scale-down pass of the "
         "step that launched a slice read the nodes from before the launch, dropped the "
         "new slice's nodes from _launched as gone, and so never scaled a slice down"),
        ('                        if st.get("leases"):\n',
         "                        # a placement group's bundles reserved there hold\n"
         "                        # the node too: a gang between its reservation and\n"
         "                        # its workers' leases is not idle\n"
         '                        if st.get("leases") or st.get("bundles"):\n',
         "a fix the JAX package lacks (ROADMAP.md Queue C): the two-phase drain asked the "
         "agent for leases only, so a node whose placement group was reserved and whose "
         "workers had not leased yet was terminated under the group after idle_timeout_s"),
    ],
    "serve/controller.py": [(
        '            num_tpus=res.pop("TPU", 0) or None,\n',
        '            num_gpus=(res.pop("GPU", 0) + res.pop("num_gpus", 0)) or None,\n',
        "a replica asks for cards as GPU or num_gpus in ray_actor_options, where the JAX "
        "package's asks for TPU chips",
    ), (
        "    def proxy_addresses(self) -> List[str]:\n",
        "    def refresh_proxy_routes(self) -> int:\n"
        '        """Every proxy takes the current routing table (serve.run, once a\n'
        "        deployment is ready); a proxy that does not answer is skipped.\n"
        '        Returns how many did."""\n'
        "        with self._lock:\n"
        "            proxies = list(self._proxies.values())\n"
        "        done = 0\n"
        "        for p in proxies:\n"
        "            try:\n"
        "                ray_tpu_torch.get(p.refresh_routes.remote(), timeout=30)\n"
        "                done += 1\n"
        "            except Exception:  # noqa: BLE001\n"
        "                pass\n"
        "        return done\n\n"
        "    def proxy_addresses(self) -> List[str]:\n",
        _ROUTES_READY,
    )],
    "serve/proxy.py": [(
        "    def health(self) -> bool:\n        return True\n",
        "    def health(self) -> bool:\n        return True\n\n"
        "    def refresh_routes(self) -> int:\n"
        '        """Take the controller\'s routing table now (serve.run asks once a\n'
        "        deployment is ready, so traffic sent after run() returns is routed\n"
        "        over all of its replicas, not the ones this proxy had heard of).\n"
        '        Returns the table\'s version."""\n'
        "        self._router._refresh(force=True)\n"
        "        return self._router._version\n",
        _ROUTES_READY,
    )],
    "serve/api.py": [(
        '        raise TimeoutError(f"deployment {dep.name!r} did not become ready")\n'
        "    return DeploymentHandle(dep.name)\n",
        '        raise TimeoutError(f"deployment {dep.name!r} did not become ready")\n'
        "    if wait_ready:\n"
        "        # ready at the controller is not yet routable at every proxy\n"
        "        ray_tpu_torch.get(controller.refresh_proxy_routes.remote(), timeout=ready_timeout_s)\n"
        "    return DeploymentHandle(dep.name)\n",
        _ROUTES_READY,
    )],
    "serve/router.py": [(
        '                    if reply["version"] != self._version:\n',
        "                    # only a newer table: a reply computed before a forced\n"
        "                    # refresh (serve.run's) may land after it\n"
        '                    if reply["version"] > self._version:\n',
        _ROUTES_READY,
    )],
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
        ('config.define("num_tpus", "", dynamic=True)\n',
         'config.define("num_tpus", "", dynamic=True)\n'
         "# Card count override (accelerators/gpu.py, RT_NUM_GPUS): \"\" = the cards\n"
         "# the NVIDIA driver lists, as CUDA_VISIBLE_DEVICES restricts them.\n"
         'config.define("num_gpus", "", dynamic=True)\n',
         "the card count override, the counterpart of num_tpus (RT_NUM_TPUS)"),
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
# Their readers are TPU-only or read by neither package. The defines
# above stay as in the JAX package; the flags leave the registry here, so
# that config.set() or a read of one fails instead of doing nothing. An
# RT_<NAME> variable of one is ignored, as any unknown one is.
NOT_PORTED_FLAGS = {
    "none: TPU chips and slices; accelerators/gpu.py counts cards (num_gpus)": (
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
    "core/runtime_env.py": [
        ("    out = dict(runtime_env)\n",
         "    out = dict(runtime_env)\n"
         '    if "CUDA_VISIBLE_DEVICES" in (out.get("env_vars") or {}):\n'
         "        # the node agent sets a worker's cards from its lease, and the lease\n"
         "        # wins: a runtime env cannot point a worker at another card\n"
         "        import logging\n\n"
         "        logging.getLogger(__name__).warning(\n"
         '            "runtime_env env_vars CUDA_VISIBLE_DEVICES=%r dropped: a worker sees "\n'
         '            "its lease\'s cards (ask for them with num_gpus)",\n'
         '            out["env_vars"]["CUDA_VISIBLE_DEVICES"])\n'
         '        out["env_vars"] = {k: v for k, v in out["env_vars"].items()\n'
         '                           if k != "CUDA_VISIBLE_DEVICES"}\n',
         _PLACEMENT),
        ('    target = os.path.join("/tmp", f"rtenv_{digest[:16]}")\n',
         "    from ray_tpu_torch.utils.config import config\n\n"
         '    target = os.path.join(str(config.temp_dir), f"rttenv_{digest[:16]}")\n',
         _OWN_FILES),
    ],
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
        ("        num_tpus: float = 0,\n", "        num_gpus: float = 0,\n", _NUM_GPUS),
        ("    log_prefix: str,\n    startup_timeout_s: float = 60.0,\n):\n",
         "    log_prefix: str,\n    startup_timeout_s: float = 60.0,\n"
         "    env: Optional[Dict[str, str]] = None,\n):\n", _AGENT_ENV),
        ("    env = dict(os.environ)\n",
         "    env = dict(os.environ, **(env or {}))\n", _AGENT_ENV),
        ("    labels: Optional[Dict[str, str]] = None,\n    startup_timeout_s: float = 60.0,\n"
         "):\n    \"\"\"Start a node agent process (shared by the test Cluster and the\n"
         "    autoscaler's LocalNodeProvider).\"\"\"\n",
         "    labels: Optional[Dict[str, str]] = None,\n    startup_timeout_s: float = 60.0,\n"
         "    env: Optional[Dict[str, str]] = None,\n"
         "):\n    \"\"\"Start a node agent process (shared by the test Cluster and the\n"
         "    autoscaler's node providers); ``env`` sets variables in its environment\n"
         "    only.\"\"\"\n", _AGENT_ENV),
        ("        session_id, \"node\", startup_timeout_s,\n    )\n",
         "        session_id, \"node\", startup_timeout_s, env=env,\n    )\n",
         _AGENT_ENV),
        ('        res["TPU"] = float(num_tpus)\n', '        res["GPU"] = float(num_gpus)\n',
         _NUM_GPUS),
    ],
    "core/task.py": [
        ("    num_tpus: Optional[float] = None\n",
         "    num_gpus: Optional[float] = None  # cards (GPU); a fraction shares one card\n",
         _NUM_GPUS),
        ('        if self.num_tpus:\n            demand["TPU"] = float(self.num_tpus)\n',
         '        if self.num_gpus:\n            demand["GPU"] = float(self.num_gpus)\n',
         _NUM_GPUS),
        ('        if k == "num_gpus":  # accept the Ray-ism, map onto TPU chips\n'
         '            k = "num_tpus"\n',
         '        if k == "num_tpus":\n'
         "            raise ValueError(\n"
         '                "num_tpus asks for TPU chips, which no node of ray_tpu_torch has: "\n'
         '                "ask for cards with num_gpus")\n',
         _NUM_GPUS),
    ],
    "core/actor.py": [(
        "        if num_cpus is None:\n"
        '            num_cpus = 1.0 if not resources and not opts.get("num_tpus") else 0.0\n'
        "        if num_cpus:\n"
        '            resources["CPU"] = float(num_cpus)\n'
        '        num_tpus = opts.get("num_tpus") or opts.get("num_gpus")\n'
        "        if num_tpus:\n"
        '            resources["TPU"] = float(num_tpus)\n',
        '        if opts.get("num_tpus") is not None:\n'
        "            raise ValueError(\n"
        '                "num_tpus asks for TPU chips, which no node of ray_tpu_torch has: "\n'
        '                "ask for cards with num_gpus")\n'
        "        if num_cpus is None:\n"
        '            num_cpus = 1.0 if not resources and not opts.get("num_gpus") else 0.0\n'
        "        if num_cpus:\n"
        '            resources["CPU"] = float(num_cpus)\n'
        '        num_gpus = opts.get("num_gpus")\n'
        "        if num_gpus:\n"
        '            resources["GPU"] = float(num_gpus)\n',
        _NUM_GPUS,
    )],
    "core/api.py": [
        ("    num_tpus: Optional[float] = None,\n    resources: Optional[Dict[str, float]] = None,\n",
         "    num_gpus: Optional[float] = None,\n    resources: Optional[Dict[str, float]] = None,\n",
         _NUM_GPUS),
        ('            if num_tpus is not None:\n                res_override["TPU"] = float(num_tpus)\n',
         '            if num_gpus is not None:\n                res_override["GPU"] = float(num_gpus)\n',
         _NUM_GPUS),
    ],
    "core/node_agent.py": [
        ("        self.resources_available = dict(self.resources_total)\n",
         "        self.resources_available = dict(self.resources_total)\n"
         "        # The node's cards, by the ids a worker's CUDA_VISIBLE_DEVICES\n"
         "        # names them with, each with its free share (1.0: whole). A GPU\n"
         "        # lease takes whole cards or a share of one (_take_cards_locked).\n"
         "        from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager\n\n"
         "        self._card_free: Dict[str, float] = dict.fromkeys(\n"
         "            GPUAcceleratorManager.get_current_node_accelerator_ids(\n"
         '                int(self.resources_total.get("GPU", 0))), 1.0)\n',
         _PLACEMENT),
        ('    def _spawn_worker(self, kind: str = "cpu", env_spec=None,\n'
         '                      env_hash: str = "", slot_reserved: bool = False) -> None:\n',
         '    def _spawn_worker(self, kind: str = "cpu", env_spec=None,\n'
         '                      env_hash: str = "", slot_reserved: bool = False,\n'
         "                      cards=()) -> None:\n",
         _PLACEMENT),
        ('            env["JAX_PLATFORMS"] = "cpu"\n        env["PYTHONPATH"] = pythonpath\n',
         '            env["JAX_PLATFORMS"] = "cpu"\n'
         "        # the worker sees its lease's cards and no other (none for cpu),\n"
         "        # by index in nvidia-smi's order unless the node set its own\n"
         '        env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)\n'
         '        env.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")\n'
         '        env["PYTHONPATH"] = pythonpath\n',
         _PLACEMENT),
        ('        kind = "tpu" if resources.get("TPU") else "cpu"\n',
         '        kind = "gpu" if resources.get("GPU") else "cpu"\n', _PLACEMENT),
        ("        last_spill_check = time.monotonic()\n"
         "        self._lock.acquire()\n"
         "        try:\n"
         "            while True:\n"
         "                ok, resolved_bundle = self._try_allocate_locked(resources, bundle)\n",
         "        last_spill_check = time.monotonic()\n"
         "        # a GPU lease's cards, held from the first fit to the grant (or\n"
         "        # given back): the worker spawned for them sees only them\n"
         "        cards: Optional[List[str]] = None\n"
         "        granted = False\n"
         "        self._lock.acquire()\n"
         "        try:\n"
         "            while True:\n"
         "                ok, resolved_bundle = self._try_allocate_locked(resources, bundle)\n"
         "                # the count fits but no card has the share: as good as not\n"
         "                # fitting here, so the spill check below looks elsewhere\n"
         "                fragmented = False\n"
         '                if ok and kind == "gpu" and cards is None:\n'
         '                    cards = self._take_cards_locked(resources["GPU"])\n'
         "                    if cards is None:\n"
         "                        self._deallocate_locked(resources, resolved_bundle)\n"
         "                        ok, fragmented = False, True\n",
         _PLACEMENT),
        ("                        target = self._pick_available_target(\n"
         "                            resources, strategy\n"
         "                        )\n",
         "                        target = self._pick_available_target(\n"
         "                            resources, strategy, exclude_self=fragmented\n"
         "                        )\n",
         _PLACEMENT),
        ("    def _pick_available_target(self, resources, strategy):\n"
         '        """Like _pick_target_node, but only returns nodes whose AVAILABLE\n'
         '        resources fit the request (used by the mid-wait re-spill)."""\n'
         "        try:\n"
         '            view = self._control.call("get_cluster_view", timeout_s=5.0)\n'
         "        except RpcError:\n"
         "            return None\n",
         "    def _pick_available_target(self, resources, strategy, exclude_self=False):\n"
         '        """Like _pick_target_node, but only returns nodes whose AVAILABLE\n'
         "        resources fit the request (used by the mid-wait re-spill).\n"
         "        exclude_self: this node's count fits but its cards' free shares\n"
         '        do not, so only the other nodes are candidates."""\n'
         "        try:\n"
         '            view = self._control.call("get_cluster_view", timeout_s=5.0)\n'
         "        except RpcError:\n"
         "            return None\n"
         "        if exclude_self:\n"
         "            view = {k: v for k, v in view.items() if k != self.node_id.hex()}\n",
         _PLACEMENT),
        ("                    worker = self._pop_idle_worker_locked(kind, env_hash)\n",
         "                    worker = self._pop_idle_worker_locked(\n"
         "                        kind, self._pool_hash(env_hash, cards))\n",
         _PLACEMENT),
        ('                            "worker_id": worker.worker_id,\n',
         '                            "worker_id": worker.worker_id,\n'
         '                            "cards": cards,\n', _PLACEMENT),
        ("                            core_metrics.lease_grants.inc()\n",
         "                            core_metrics.lease_grants.inc()\n"
         "                        granted = True\n", _PLACEMENT),
        ('                        res_key = "TPU" if kind == "tpu" else "CPU"\n'
         "                        cap = max(1, int(self.resources_total.get(res_key, 1)))\n",
         '                        if kind == "gpu":\n'
         "                            # as many as the cards hold at once at this\n"
         "                            # share (two at 0.5 on one card)\n"
         "                            cap = max(1, int(self.resources_total.get(\"GPU\", 1)\n"
         "                                             / resources[\"GPU\"] + _RES_EPS))\n"
         "                        else:\n"
         "                            cap = max(1, int(self.resources_total.get(\"CPU\", 1)))\n",
         _PLACEMENT),
        ("                            evicted = self._evict_idle_mismatch_locked(\n"
         "                                kind, env_hash\n",
         "                            evicted = self._evict_idle_mismatch_locked(\n"
         "                                kind, self._pool_hash(env_hash, cards)\n",
         _PLACEMENT),
        ("                                self._spawn_worker(\n"
         "                                    kind, env_spec, env_hash,\n"
         "                                    slot_reserved=True,\n",
         "                                self._spawn_worker(\n"
         "                                    kind, env_spec, self._pool_hash(env_hash, cards),\n"
         "                                    slot_reserved=True, cards=cards or (),\n",
         _PLACEMENT),
        ("            if starved:\n                self._pending_leases -= 1\n",
         "            if starved:\n                self._pending_leases -= 1\n"
         "            if cards is not None and not granted:\n"
         '                self._give_back_cards_locked(cards, resources["GPU"])\n',
         _PLACEMENT),
        ("    def _release_resources_locked(self, info: Dict[str, Any]) -> None:\n"
         '        self._deallocate_locked(info["resources"], info["bundle"])\n',
         "    def _release_resources_locked(self, info: Dict[str, Any]) -> None:\n"
         '        self._deallocate_locked(info["resources"], info["bundle"])\n'
         '        if info.get("cards"):\n'
         '            self._give_back_cards_locked(info["cards"], info["resources"]["GPU"])\n\n'
         "    def _take_cards_locked(self, share: float) -> Optional[List[str]]:\n"
         "        \"\"\"Card ids for a lease of ``share`` GPUs: whole free cards for one\n"
         "        or more (a fraction above one takes the next whole card), else the\n"
         "        fullest card with ``share`` free, so that two halves share a card.\n"
         "        None when the free shares do not fit.\"\"\"\n"
         "        free = self._card_free\n"
         "        if share >= 1.0 - _RES_EPS:\n"
         "            n = int(share + 1.0 - _RES_EPS)  # the whole cards that cover it\n"
         "            whole = [i for i, f in free.items() if f >= 1.0 - _RES_EPS][:n]\n"
         "            if len(whole) < n:\n"
         "                return None\n"
         "            for i in whole:\n"
         "                free[i] = 0.0\n"
         "            return whole\n"
         "        fits = [i for i, f in free.items() if f >= share - _RES_EPS]\n"
         "        if not fits:\n"
         "            return None\n"
         "        best = min(fits, key=lambda i: free[i])\n"
         "        free[best] -= share\n"
         "        return [best]\n\n"
         "    def _give_back_cards_locked(self, cards: List[str], share: float) -> None:\n"
         "        for i in cards:\n"
         "            self._card_free[i] = min(1.0, self._card_free[i] + min(share, 1.0))\n\n"
         "    @staticmethod\n"
         "    def _pool_hash(env_hash: str, cards: Optional[List[str]]) -> str:\n"
         "        \"\"\"The pool key of a worker: its runtime env, and its cards.\"\"\"\n"
         "        return f\"{env_hash}|cards={','.join(cards)}\" if cards else env_hash\n",
         _PLACEMENT),
        ("                if b and b[0] == pg_id and b[1] in idx_set:\n"
         "                    self._leases.pop(lease_id, None)\n",
         "                if b and b[0] == pg_id and b[1] in idx_set:\n"
         "                    self._leases.pop(lease_id, None)\n"
         '                    if info.get("cards"):\n'
         "                        self._give_back_cards_locked(\n"
         '                            info["cards"], info["resources"]["GPU"])\n',
         _PLACEMENT),
        ('                "resources_available": dict(self.resources_available),\n'
         '                "labels": dict(self.labels),\n',
         '                "resources_available": dict(self.resources_available),\n'
         '                "cards_free": dict(self._card_free),\n'
         '                "labels": dict(self.labels),\n', _PLACEMENT),
    ],
    "core/worker.py": [
        (
            "        import jax\n\n"
            "        hosts = []\n"
            "        for (shape, dtype), off in zip(dv.leaves_meta, meta[\"offsets\"]):\n"
            "            n = int(np.prod(shape, dtype=np.int64)) if shape else 1\n"
            "            nbytes = n * np.dtype(dtype).itemsize\n"
            "            hosts.append(\n"
            "                np.frombuffer(\n"
            "                    view[off:off + nbytes], dtype=np.dtype(dtype)\n"
            "                ).reshape(shape)\n"
            "            )\n"
            "        # one batched transfer: jax overlaps the host->device copies\n"
            "        arrays = jax.device_put(hosts)\n",
            "        # each leaf into a tensor of its own on its kind of device (a CUDA\n"
            "        # leaf on this process's card); bf16 crossed the wire as its bits\n"
            "        arrays = dev_mod.device_put(view, meta[\"offsets\"], dv.leaves_meta)\n",
            "jax.device_put becomes device_objects.device_put, which reads the torch dtype "
            "and device kind that leaves_meta carries (numpy has no bfloat16, so the wire "
            "dtype is the port's) and copies each leaf out of the segment before it is dropped",
        ),
        (
            "                    logger.exception(\n"
            "                        \"actor task %s dependency wait failed\", spec.name\n"
            "                    )\n"
            "            # A failed *send* (frame never accepted by the socket) is safe\n",
            "                    logger.exception(\n"
            "                        \"actor task %s dependency wait failed\", spec.name\n"
            "                    )\n"
            "                # the refs go now, not when the actor's next call comes:\n"
            "                # a device object passed to its last task would stay in\n"
            "                # its producer's store, on the card, after every ref died\n"
            "                deps = None\n"
            "            # A failed *send* (frame never accepted by the socket) is safe\n",
            "a fix the JAX package lacks (ROADMAP.md Queue C): the actor sender loop held "
            "the last task's dependency list until that actor's next call, so a device "
            "object passed to an actor task was not freed when its refs were dropped",
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


def test_hunks_name_each_file_once():
    """A file named twice in the HUNKS literal would silently drop the
    first list (the later key wins), and with it the hunks it pins."""
    import ast

    tree = ast.parse(Path(__file__).read_text())
    (literal,) = [node.value for node in tree.body if isinstance(node, ast.Assign)
                  and [getattr(t, "id", None) for t in node.targets] == ["HUNKS"]]
    keys = [ast.literal_eval(k) for k in literal.keys]
    assert len(keys) == len(set(keys)), sorted(k for k in keys if keys.count(k) > 1)


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
    is read by none, and setting it fails instead of doing nothing. The
    port adds one flag: num_gpus, the card count override (the listed
    hunk of utils/config.py)."""
    from ray_tpu_torch.utils import config as config_mod

    text = _port_text_but_config()
    kept = set(config_mod.config._flags)
    dropped = [n for names in config_mod.NOT_PORTED_FLAGS.values() for n in names]
    source = (ROOT / "ray_tpu" / "utils" / "config.py").read_text()
    assert kept | set(dropped) == set(re.findall(r'config\.define\(\s*"(\w+)"', source)) | {
        "num_gpus"}
    assert not kept & set(dropped) and len(dropped) == len(set(dropped))
    assert [n for n in sorted(kept) if not re.search(rf"\b{n}\b", text)] == []
    assert [n for n in dropped if re.search(rf"config\.{n}\b|config\.(get|set)\([\"']{n}[\"']", text)] == []
    with pytest.raises(KeyError):
        config_mod.config.set("flash_bq", 512)
    with pytest.raises(AttributeError):
        config_mod.config.num_tpus
