"""`python -m ray_tpu_torch <cmd>` — forwards to the rt CLI (ray_tpu_torch/cli.py)."""

import sys

from ray_tpu_torch.cli import main

sys.exit(main())
