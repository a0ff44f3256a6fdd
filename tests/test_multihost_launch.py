"""Multi-controller launch: N local processes form one global mesh,
host-sharded data reduces to identical global results on every process.

(ref: utils/queue.pl:15-58 — the reference's multi-host story is qsub +
 NFS; here the contract is env-driven jax.distributed, exercised with
 real separate processes and gloo CPU collectives.)
"""

import os
import subprocess
import sys

import pytest

from kaldi_tpu.parallel.launch import launch_local, host_shard

WORKER = r'''
import os, sys
sys.path.insert(0, %(repo)r)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from kaldi_tpu.parallel.launch import init_distributed, global_mesh, host_shard
pid, n = init_distributed()
import numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
assert jax.process_count() == n == 2, (jax.process_count(), n)
assert jax.device_count() == 4, jax.device_count()
mesh = global_mesh(data=4, model=1)
# host-sharded "data": each process contributes its own utterances
utts = [f"utt{i:02d}" for i in range(8)]
mine = host_shard(utts)
assert len(mine) == 4
local = np.array([float(u[3:]) for u in mine], np.float32)
arr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("data")), local)
total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(arr)
# every process must see the SAME global reduction over ALL hosts' data
expect = sum(range(8))
assert float(total) == expect, (float(total), expect)
print(f"proc {pid}: global={float(total)} shard={mine}")
'''


@pytest.mark.slow
def test_two_process_global_reduction(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER % {"repo": repo})
    codes = launch_local(
        [sys.executable, str(worker_py)], num_processes=2,
        log_dir=str(tmp_path / "logs"), coordinator_port=29431,
        env={"JAX_PLATFORMS": "cpu"}, timeout=300)
    logs = [(tmp_path / "logs" / f"worker.{i}.log").read_text()
            for i in range(2)]
    assert codes == [0, 0], logs
    for i, log in enumerate(logs):
        assert f"proc {i}: global=28.0" in log, log
        assert "# Accounting: time=" in log   # run.pl-style epilogue


def test_host_shard_partition():
    """Shards are disjoint, cover everything, and near-equal."""
    utts = [f"u{i}" for i in range(11)]
    shards = [host_shard(utts, pid, 3) for pid in range(3)]
    flat = sorted(x for s in shards for x in s)
    assert flat == sorted(utts)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1


def test_gang_restart_on_preemption(tmp_path):
    """SPMD preemption recovery: a worker that dies on the first gang
    attempt (simulated preemption) brings the whole gang down; the
    launcher relaunches all processes and the job completes. (ref: the
    reference's queue.pl leaves requeueing to SGE; an N-controller jit
    program must gang-restart — one dead controller hangs the
    collective.)"""
    flag = tmp_path / "preempted_once"
    script = (
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "pid = os.environ.get('KALDI_TPU_PROCESS_ID')\n"
        "if pid == '1' and not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n"
        "    sys.exit(17)   # simulated preemption\n"
        "print('worker', pid, 'done')\n"
    )
    worker = [sys.executable, "-c", script]
    log_dir = str(tmp_path / "logs")
    codes = launch_local(worker, 2, log_dir, coordinator_port=29500,
                         timeout=60.0, max_gang_restarts=1)
    assert codes == [0, 0]
    assert flag.exists()
    log1 = open(os.path.join(log_dir, "worker.1.log")).read()
    assert "status 17" in log1          # first attempt recorded failed
    assert "gang restart 1" in log1     # relaunch recorded
    assert log1.rstrip().endswith("status 0")

    # without restarts the same failure surfaces
    flag2 = tmp_path / "no_restart_flag"
    script2 = script.replace(str(flag), str(flag2))
    codes2 = launch_local([sys.executable, "-c", script2], 2,
                          str(tmp_path / "logs2"),
                          coordinator_port=29510, timeout=60.0)
    assert 17 in codes2


TRAIN_WORKER = r'''
import json, os, sys
sys.path.insert(0, %(repo)r)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
from kaldi_tpu.parallel.launch import init_distributed, global_mesh
pid, n = init_distributed()
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu.nnet.train import (NnetTrainOpts, make_optimizer,
                                  make_train_step, shard_params)
from kaldi_tpu.parallel.mesh import batch_sharding
assert jax.process_count() == 2 and jax.device_count() == 8
mesh = global_mesh(data=8, model=1)
cfg = TdnnConfig(feat_dim=8, num_pdfs=32, hidden_dim=32,
                 pnorm_output_dim=16,
                 splice_indexes=((-1, 0, 1), (-1, 1), (0,)))
model = Tdnn(cfg)
params = model.init(jax.random.PRNGKey(0))
params, _ = shard_params(params, mesh)
opts = NnetTrainOpts()
optimizer = make_optimizer(opts, 3)
opt_state = optimizer.init(params)
step = make_train_step(model, optimizer, mesh)
# the GLOBAL batch is generated identically on both processes; each
# process materializes only ITS device-local rows
B, chunk = 16, 4
ctx = cfg.left_context + cfg.right_context
rng = np.random.RandomState(7)
feats_g = rng.randn(B, chunk + ctx, cfg.feat_dim).astype(np.float32)
tgt_g = rng.randint(0, cfg.num_pdfs, (B, chunk)).astype(np.int32)
w_g = np.ones((B, chunk), np.float32)
def shard(g, ndim):
    sh = batch_sharding(mesh, ndim)
    return jax.make_array_from_process_local_data(
        sh, g[pid * (B // 2):(pid + 1) * (B // 2)])
feats = shard(feats_g, 3)
tgt = shard(tgt_g, 2)
w = shard(w_g, 2)
losses = []
for _ in range(3):
    params, opt_state, loss, acc = step(params, opt_state, feats, tgt, w)
    losses.append(float(loss))
# parameter fingerprint must be identical across processes (replicated
# params after the gradient psum) AND match the single-process run
leaves = jax.tree_util.tree_leaves(params)
fp = float(sum(float(jnp.sum(jnp.abs(l))) for l in leaves))
out = {"pid": pid, "losses": losses, "param_fp": fp}
with open(os.path.join(%(outdir)r, f"train.{pid}.json"), "w") as f:
    json.dump(out, f)
print("RESULT", json.dumps(out))
'''


@pytest.mark.slow
def test_two_process_dp_train_step_matches_single(tmp_path):
    """The full dp train step over 2 processes x 4 virtual devices must
    produce the SAME losses and parameters as the single-process
    8-device run of the same global batch (the gradient psum crosses
    the process boundary through gloo). (ref: SURVEY.md §2.11 DCN row;
    utils/queue.pl:15-58 — the reference's multi-host training story.)"""
    import json
    import numpy as np
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker_py = tmp_path / "train_worker.py"
    worker_py.write_text(TRAIN_WORKER % {"repo": repo,
                                         "outdir": str(tmp_path)})
    codes = launch_local(
        [sys.executable, str(worker_py)], num_processes=2,
        log_dir=str(tmp_path / "logs"), coordinator_port=29461,
        env={"JAX_PLATFORMS": "cpu"}, timeout=600)
    logs = [(tmp_path / "logs" / f"worker.{i}.log").read_text()
            for i in range(2)]
    assert codes == [0, 0], logs
    outs = [json.load(open(tmp_path / f"train.{i}.json"))
            for i in range(2)]
    # processes agree with each other exactly (replicated state)
    assert outs[0]["losses"] == pytest.approx(outs[1]["losses"], rel=1e-6)
    assert outs[0]["param_fp"] == pytest.approx(outs[1]["param_fp"],
                                                rel=1e-6)

    # single-process reference on the in-test 8-virtual-device mesh
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu.nnet.train import (NnetTrainOpts, make_optimizer,
                                      make_train_step, shard_params)
    from kaldi_tpu.parallel.mesh import make_mesh, batch_sharding
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(data=8, model=1, devices=jax.devices()[:8])
    cfg = TdnnConfig(feat_dim=8, num_pdfs=32, hidden_dim=32,
                     pnorm_output_dim=16,
                     splice_indexes=((-1, 0, 1), (-1, 1), (0,)))
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    params, _ = shard_params(params, mesh)
    optimizer = make_optimizer(NnetTrainOpts(), 3)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, mesh)
    B, chunk = 16, 4
    ctx = cfg.left_context + cfg.right_context
    rng = np.random.RandomState(7)
    feats = jax.device_put(
        rng.randn(B, chunk + ctx, cfg.feat_dim).astype(np.float32),
        batch_sharding(mesh, 3))
    tgt = jax.device_put(
        rng.randint(0, cfg.num_pdfs, (B, chunk)).astype(np.int32),
        batch_sharding(mesh, 2))
    w = jax.device_put(np.ones((B, chunk), np.float32),
                       batch_sharding(mesh, 2))
    losses = []
    for _ in range(3):
        params, opt_state, loss, acc = step(params, opt_state, feats,
                                            tgt, w)
        losses.append(float(loss))
    leaves = jax.tree_util.tree_leaves(params)
    fp = float(sum(float(jnp.sum(jnp.abs(l))) for l in leaves))
    assert outs[0]["losses"] == pytest.approx(losses, rel=1e-5)
    assert outs[0]["param_fp"] == pytest.approx(fp, rel=1e-5)


@pytest.mark.parametrize("env,expect", [
    ({"JAX_PLATFORMS": "cuda"}, ["0", "1", "2"]),
    ({}, ["0", "1", "2"]),
    ({"CUDA_VISIBLE_DEVICES": "4,6,7"}, ["4", "6", "7"]),
    ({"JAX_PLATFORMS": "cpu"}, [None, None, None]),
])
def test_worker_device_env_one_card_each(env, expect):
    from kaldi_tpu.parallel.launch import worker_device_env
    got = [worker_device_env(env, i).get("CUDA_VISIBLE_DEVICES")
           for i in range(3)]
    assert got == expect


def test_worker_device_env_too_few_cards():
    from kaldi_tpu.parallel.launch import worker_device_env
    with pytest.raises(ValueError):
        worker_device_env({"CUDA_VISIBLE_DEVICES": "0"}, 1)


def test_launch_local_gives_each_worker_its_card(tmp_path):
    """launch_local puts worker i on card i (no JAX in the worker)."""
    code = ("import os; print('card=' + os.environ.get("
            "'CUDA_VISIBLE_DEVICES', '-') + ' pid=' + "
            "os.environ['KALDI_TPU_PROCESS_ID'])")
    codes = launch_local([sys.executable, "-c", code], num_processes=2,
                         log_dir=str(tmp_path / "logs"),
                         env={"JAX_PLATFORMS": "cuda",
                              "CUDA_VISIBLE_DEVICES": "2,3"}, timeout=60)
    assert codes == [0, 0]
    for i, card in enumerate(["2", "3"]):
        log = (tmp_path / "logs" / f"worker.{i}.log").read_text()
        assert f"card={card} pid={i}" in log, log
