"""ray_tpu_torch.serve — online model serving.

Parity target: Ray Serve (reference python/ray/serve — controller
reconciler, per-node HTTP proxies, pow-2 request router, replica
autoscaling, deployment handles).
"""

from ray_tpu_torch.serve.api import (
    DeploymentResponse,
    Deployment,
    DeploymentHandle,
    autoscale_status,
    delete,
    deployment,
    get_deployment_handle,
    proxy_addresses,
    run,
    scale,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import make_multiplexer, multiplexed
from ray_tpu_torch.serve.replica import Request

# submodules, imported LAST (they import this package's API above):
# serve.llm.deploy(...) is the OpenAI front-door entrypoint and
# serve.openai holds its protocol/tokenizer/ingress layers
from ray_tpu_torch.serve import llm, openai  # noqa: E402  (cycle-safe tail import)

__all__ = [
    "llm",
    "make_multiplexer",
    "openai",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "Request",
    "autoscale_status",
    "batch",
    "delete",
    "deployment",
    "get_deployment_handle",
    "multiplexed",
    "proxy_addresses",
    "run",
    "scale",
    "shutdown",
    "start",
    "status",
]
