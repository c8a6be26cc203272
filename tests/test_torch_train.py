"""The port's Train library (``ray_tpu_torch.train``) on one module-scoped
port cluster on the CPU: the twins of ``tests/test_train.py`` (the MLP
data-parallel run with checkpoints and failure recovery) and of
``tests/test_train_xla_backend.py`` (the backend's process group), and
one gpt2-tiny step on a dp 2 mesh over the trainer's gloo group.

The MLP runs are held to the JAX package on the same inputs: the loss
stream and final parameters to an in-process JAX oracle (the JAX init,
``jax.value_and_grad(mlp.loss_fn)`` on each rank's shard, the gradients
averaged, SGD), within 1e-5, in f32. The gpt2-tiny step is a wiring test
of the trainer's gloo group under a mesh: it is held to the port's
unsharded single-process step (``bench.setup``'s ``make_train_step``),
which tests/test_torch_gpt2.py holds to the JAX step, as
tests/test_torch_sharded_step.py holds the sharded one, at the sharded
step's tolerances (loss 1e-5 relative; parameters after one AdamW step
rtol 2e-4, atol 2e-5), in f32.

The module names no ``ray_tpu`` module among its globals: its train
functions are pickled by value, with the modules their globals name.
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.train import (
    CheckpointConfig,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)

MLP_KW = dict(in_dim=8, hidden=(16,), num_classes=3)  # tests/test_train.py's
LR = 0.1
STEPS = 4
MLP_TOL = 1e-5
# The sharded step's limits (tests/test_parallel.py, chip_smoke.py phase 6).
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4, 2e-5
# f32, as the sharded-step tests run it: in bf16 the two steps round the
# gradients differently, and AdamW's first step moves a parameter whose
# gradient is near 0 by +-lr, whichever sign the rounding gives it.
TINY = dict(model="gpt2-tiny", batch=8, seq=64, dtype=torch.float32)


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    # GPU 2 is a resource label only (this box has no card): the run that
    # asks for cards gets placed, and its NCCL init must then fail.
    ray_tpu_torch.init(num_cpus=5, resources={"GPU": 2})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _kv(op, key, value=None):
    from ray_tpu_torch.core import worker as wm

    control = wm.global_worker().control
    if op == "put":
        return control.call("kv_put", ns="test", key=key, value=value, overwrite=False)
    return control.call("kv_get", ns="test", key=key)


def _shard(rank):
    """Rank ``rank``'s data: 32 rows from a numpy generator of its own."""
    rng = np.random.default_rng(100 + rank)
    x = rng.standard_normal((32, MLP_KW["in_dim"])).astype(np.float32)
    y = rng.integers(0, MLP_KW["num_classes"], 32).astype(np.int64)
    return x, y


def _mlp_train_fn(config):
    import pickle
    import tempfile

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models import mlp

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    cfg = mlp.MLPConfig(**MLP_KW)
    params, start, losses = config["init"], 0, []
    restore = ctx.get_checkpoint()
    if restore is not None:
        with open(os.path.join(restore.rank_dir(rank), "state.pkl"), "rb") as f:
            state = pickle.load(f)
        params, start, losses = state["params"], state["step"], state["losses"]
        if rank == 0:
            _kv("put", f"{config['tag']}/resume_start", str(start).encode())
    model = mlp.from_jax(params, cfg, device="cpu")
    x, y = (torch.from_numpy(a) for a in _shard(rank))
    for step in range(start, config["steps"]):
        model.zero_grad(set_to_none=True)
        loss = mlp.loss_fn(model, (x, y))
        loss.backward()
        # data-parallel sync of the torch gradients: bucketed allreduce,
        # averaged, numpy arrays back
        grads = train.grad_sync({n: p.grad for n, p in model.named_parameters()}).join()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * torch.from_numpy(grads[n])
        losses.append(loss.item())
        if config.get("crash_at") == step and rank == 0:
            # the first attempt only: the KV claim is the flag
            if _kv("put", f"{config['tag']}/crash", b"1"):
                os._exit(1)
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "state.pkl"), "wb") as f:
                pickle.dump({"params": mlp.to_jax(model), "step": step + 1,
                             "losses": losses}, f)
            train.report({"loss": losses[-1], "step": step, "losses": list(losses)},
                         checkpoint=train.Checkpoint.from_directory(tmp))


def _jax_mlp():
    """The JAX init (numpy leaves) and the oracle's rank-0 losses and final
    parameters over STEPS steps of the same DP loop."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mlp

    cfg = mlp.MLPConfig(**MLP_KW)
    params = mlp.init(jax.random.PRNGKey(0), cfg)
    init = jax.tree.map(np.asarray, params)
    grad_fn = jax.jit(jax.value_and_grad(mlp.loss_fn))
    shards = [tuple(jnp.asarray(a) for a in _shard(r)) for r in range(2)]
    losses = []
    for _ in range(STEPS):
        (l0, g0), (_, g1) = (grad_fn(params, s) for s in shards)
        losses.append(float(l0))
        params = jax.tree.map(lambda p, a, b: p - LR * (a + b) / 2, params, g0, g1)
    return init, losses, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_mlp(cpu_mesh_devices):
    return _jax_mlp()


def _final_params(result):
    import pickle

    with open(os.path.join(result.checkpoint.rank_dir(0), "state.pkl"), "rb") as f:
        return pickle.load(f)["params"]


def _assert_params_close(got, want, rtol, atol=0.0):
    assert sorted(got) == sorted(want)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf], rtol=rtol,
                                       atol=atol, err_msg=f"{layer}.{leaf}")


@pytest.fixture(scope="module")
def dp_run(rt, jax_mlp, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlp_dp")
    trainer = TorchTrainer(
        _mlp_train_fn,
        train_loop_config={"init": jax_mlp[0], "steps": STEPS, "tag": "dp"},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mlp_test", storage_path=str(tmp),
                             checkpoint_config=CheckpointConfig(num_to_keep=2)),
    )
    return trainer.fit(), tmp


def test_torch_trainer_mlp(dp_run, jax_mlp):
    result, tmp = dp_run
    assert result.error is None, result.error
    assert result.metrics["step"] == STEPS - 1
    assert result.checkpoint is not None
    # top-k retention: only 2 checkpoint dirs remain
    run_dir = os.path.join(str(tmp), "mlp_test")
    assert len([d for d in os.listdir(run_dir) if d.startswith("checkpoint_")]) == 2
    # both ranks wrote shards
    for r in (0, 1):
        assert os.path.isdir(os.path.join(result.checkpoint.path, f"rank_{r}"))
    _, want_losses, want_params = jax_mlp
    np.testing.assert_allclose(result.metrics["losses"], want_losses, rtol=MLP_TOL)
    _assert_params_close(_final_params(result), want_params, rtol=MLP_TOL, atol=MLP_TOL)


def test_torch_trainer_failure_recovery(rt, dp_run, jax_mlp, tmp_path):
    trainer = TorchTrainer(
        _mlp_train_fn,
        train_loop_config={"init": jax_mlp[0], "steps": STEPS, "crash_at": 2, "tag": "ft"},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mlp_ft", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["step"] == STEPS - 1
    # the retry RESUMED from the last complete checkpoint (step 2), not from 0
    resume = _kv("get", "ft/resume_start")
    assert resume is not None, "the second attempt never restored"
    assert int(resume.decode()) == 2
    # and ended where the uncrashed run ended, bit for bit
    clean = _final_params(dp_run[0])
    for layer, leaves in _final_params(result).items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(arr, clean[layer][leaf])
    np.testing.assert_allclose(result.metrics["losses"], jax_mlp[1], rtol=MLP_TOL)


def _backend_train_fn(config):
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch.collective import process_group

    ctx = train.get_context()
    # the backend wired the group's env BEFORE the train fn ran
    # (TrainWorker.run joins the process group from it)
    env = {k: os.environ[k] for k in ("RT_XLA_GROUP", "RT_XLA_RANK", "RT_XLA_WORLD",
                                      process_group.BACKEND_ENV)}
    t = torch.tensor([float(ctx.get_world_rank() + 1)])
    dist.all_reduce(t)
    train.report({
        "rank": ctx.get_world_rank(), "world": ctx.get_world_size(), "env": env,
        "pg_initialized": dist.is_initialized(), "pg_backend": dist.get_backend(),
        "pg_rank": dist.get_rank(), "pg_world": dist.get_world_size(),
        "all_reduce_sum": t.item(), "init_s": process_group.last_init_s,
    })


def test_gpu_backend_brings_up_a_gloo_process_group(rt, tmp_path):
    trainer = DataParallelTrainer(
        _backend_train_fn,
        train_loop_config={},
        # use_gpu drives the RT_XLA_* branch; 0 cards per worker asks for
        # none and joins over gloo, on the CPU worker pool
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=0),
        run_config=RunConfig(name="pg_backend", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["pg_initialized"] and m["pg_backend"] == "gloo"
    assert (m["rank"], m["pg_rank"], m["world"], m["pg_world"]) == (0, 0, 2, 2)
    assert m["all_reduce_sum"] == 3.0
    assert m["env"]["RT_XLA_RANK"] == "0" and m["env"]["RT_XLA_WORLD"] == "2"
    assert m["env"]["RT_XLA_GROUP"].startswith("rt_train_")
    assert m["env"]["RT_XLA_BACKEND"] == "gloo"
    assert m["init_s"] > 0


def test_use_gpu_without_a_card_fails_the_run(rt, tmp_path):
    """No fallback: with cards asked for (a GPU label here) and none
    visible, the worker's NCCL init raises and fit() returns the error."""
    trainer = TorchTrainer(
        _backend_train_fn,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="pg_nccl", storage_path=str(tmp_path)),
    )
    assert trainer.scaling_config.gpus_per_worker == 1
    assert trainer.scaling_config.worker_resources() == {"GPU": 1.0, "CPU": 1.0}
    result = trainer.fit()
    assert result.metrics is None
    assert "needs a CUDA device" in str(result.error)


def _gpt2_dp_train_fn(config):
    from ray_tpu_torch import bench
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_model
    from ray_tpu_torch.parallel.sharding import full_parameters, gpt_rules

    import ray_tpu_torch.train as train

    torch.set_num_threads(1)
    mesh = build_mesh(MeshConfig(dp=2), device_type="cpu")
    run = bench.setup(1, **TINY, device="cpu",
                      place=lambda m: shard_model(m, mesh, gpt_rules()))
    loss = run.step(run.batches[0]).item()
    params = {n: t.numpy() for n, t in full_parameters(run.model).items()}
    train.report({"loss": loss, "params": params, "mesh": dict(zip(mesh.mesh_dim_names,
                                                                   mesh.shape))})


def test_gpt2_tiny_step_on_a_dp2_mesh_over_the_trainers_group(rt, tmp_path):
    """Wiring: build_mesh and shard_model over the trainer's gloo group of 2.
    The reference is the port's unsharded step, the one held to JAX's."""
    from ray_tpu_torch import bench

    trainer = DataParallelTrainer(
        _gpt2_dp_train_fn,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=0),
        run_config=RunConfig(name="gpt2_dp", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["mesh"]["dp"] == 2
    ref = bench.setup(1, **TINY, device="cpu")
    want_loss = ref.step(ref.batches[0]).item()
    assert abs(m["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss), (m["loss"], want_loss)
    want = {n: p.detach().numpy() for n, p in ref.model.named_parameters()}
    assert sorted(m["params"]) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(m["params"][n], w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=n)


def test_coordinator_env_and_no_multislice(rt):
    """One slice: the env:// variables alone. Several: accepted, the slice
    vars beside them, and a rank outside its slice (ranks are
    domain-major) refused before the store is touched."""
    from ray_tpu_torch.collective import coordinator_env

    env0 = coordinator_env("env_group", rank=0, world_size=2)
    env1 = coordinator_env("env_group", rank=1, world_size=2)
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        assert env0[k] == env1[k]
    assert (env0["RANK"], env1["RANK"], env0["WORLD_SIZE"]) == ("0", "1", "2")
    assert int(env0["MASTER_PORT"]) > 0
    assert "RT_NUM_SLICES" not in env0 and "RT_SLICE_ID" not in env1
    env = coordinator_env("ms_group", rank=0, world_size=4, num_slices=2, slice_id=0)
    assert (env["RT_NUM_SLICES"], env["RT_SLICE_ID"], env["WORLD_SIZE"]) == ("2", "0", "4")
    with pytest.raises(ValueError, match="domain-major"):
        coordinator_env("ms_group", rank=1, world_size=4, num_slices=2, slice_id=1)


def test_multislice_env_includes_slice_vars(rt):
    """Twin of tests/test_train_xla_backend.py::test_multislice_env_includes_megascale:
    both slices get the one coordinator, and the slice count and their id
    (RT_NUM_SLICES, RT_SLICE_ID: the MEGASCALE variables' counterparts)."""
    from ray_tpu_torch.collective import coordinator_env

    env0 = coordinator_env("ms_twin", rank=0, world_size=4, num_slices=2, slice_id=0)
    env1 = coordinator_env("ms_twin", rank=2, world_size=4, num_slices=2, slice_id=1)
    assert (env0["MASTER_ADDR"], env0["MASTER_PORT"]) == (env1["MASTER_ADDR"], env1["MASTER_PORT"])
    for e, sid in ((env0, 0), (env1, 1)):
        assert e["RT_NUM_SLICES"] == "2"
        assert e["RT_SLICE_ID"] == str(sid)
        assert e["WORLD_SIZE"] == "4"


def test_nccl_init_raises_without_a_card():
    from ray_tpu_torch.collective import initialize_process_group

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the nccl path is driven by chip_smoke.py phase 9")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        initialize_process_group("no_card", 0, 1, "nccl")
    with pytest.raises(ValueError, match="unsupported backend"):
        initialize_process_group("bad", 0, 1, "mpi")
