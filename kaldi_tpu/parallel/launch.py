"""Multi-controller launch: the queue.pl / multi-host role.

(ref: egs/wsj/s5/utils/queue.pl:15-58 and run.pl — the reference scales
past one machine by qsub'ing independent jobs against NFS. The
replacement here is one SPMD program over a global mesh: every host runs
the SAME script, jax.distributed wires the controllers together, data
loads host-sharded, and gradients/stats reduce over collectives inside
jit — SURVEY.md §2.11.)

Three pieces:
  - init_distributed(): the per-process entry — reads the coordinator
    contract from env (KALDI_TPU_COORDINATOR / NUM_PROCESSES /
    PROCESS_ID) or arguments, brings up jax.distributed (gloo collectives
    on the CPU backend so the path is testable without N GPU hosts).
  - host_shard(): deterministic utterance sharding per process — the
    host-sharded data loading the reference gets from split_scp.pl.
  - launch_local(): spawns N local processes of a worker script with the
    env contract set, one GPU per worker, waits, and writes run.pl-style
    accounting logs. On a cluster each host runs the worker under its own
    scheduler with the same env contract; this launcher makes the
    contract executable (and testable) on one machine.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


COORD_ENV = "KALDI_TPU_COORDINATOR"
NPROC_ENV = "KALDI_TPU_NUM_PROCESSES"
PID_ENV = "KALDI_TPU_PROCESS_ID"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_count: int | None = None):
    """Initialize the multi-controller runtime from args or env.

    Returns (process_id, num_processes). Safe to call with
    num_processes == 1 (no-op init). On the CPU backend the gloo
    collectives implementation is selected so cross-process collectives
    work without accelerators (the CI/dryrun path)."""
    import jax

    coordinator = coordinator or os.environ.get(COORD_ENV)
    num_processes = num_processes or int(os.environ.get(NPROC_ENV, "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get(PID_ENV, "0")))
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{local_device_count}").strip()
    if num_processes <= 1:
        return 0, 1
    assert coordinator, (
        f"multi-process launch needs {COORD_ENV} (host:port)")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass   # not on CPU, or newer jax handles it automatically
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return process_id, num_processes


def global_mesh(data: int | None = None, model: int = 1):
    """2-D ('data', 'model') mesh over ALL processes' devices."""
    from kaldi_tpu.parallel.mesh import make_mesh
    import jax
    return make_mesh(data=data, model=model, devices=jax.devices())


def host_shard(keys, process_id: int | None = None,
               num_processes: int | None = None):
    """Deterministic per-host utterance shard (split_scp.pl role):
    sorted round-robin so every process sees a near-equal share and the
    union over processes is exactly the input."""
    import jax
    pid = process_id if process_id is not None else jax.process_index()
    n = num_processes if num_processes is not None else jax.process_count()
    ordered = sorted(keys)
    return ordered[pid::n]


def worker_device_env(env: dict, i: int) -> dict:
    """Environment overrides giving local worker i its own GPU.

    A JAX process reserves most of every card it opens, so N workers on
    one host each see only card i (the i-th entry of an inherited
    CUDA_VISIBLE_DEVICES, else card i). Workers pinned to the CPU backend
    (JAX_PLATFORMS without cuda/gpu) keep the environment as it is."""
    plats = {p.strip() for p in env.get("JAX_PLATFORMS", "").split(",")
             if p.strip()}
    if plats and not plats & {"cuda", "gpu"}:
        return {}
    visible = [c for c in env.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if c.strip()]
    if not visible:
        return {"CUDA_VISIBLE_DEVICES": str(i)}
    if i >= len(visible):
        raise ValueError(f"worker {i} has no card: CUDA_VISIBLE_DEVICES="
                         f"{env['CUDA_VISIBLE_DEVICES']}")
    return {"CUDA_VISIBLE_DEVICES": visible[i].strip()}


def launch_local(worker: list[str], num_processes: int,
                 log_dir: str, coordinator_port: int = 29411,
                 env: dict | None = None, timeout: float = 600.0,
                 max_gang_restarts: int = 0):
    """Run `worker` (argv list) as num_processes local processes with the
    distributed env contract, one GPU each (worker_device_env); -> list
    of return codes. Writes run.pl-style accounting to
    <log_dir>/worker.<pid>.log.

    max_gang_restarts: SPMD preemption recovery — an N-process jit
    program is all-or-nothing (one dead controller hangs the
    collective), so when ANY worker exits nonzero the WHOLE gang is
    killed and relaunched (fresh coordinator port; workers are expected
    to resume from their checkpoints, which utils/checkpoint.py +
    stage-resumable experiments provide). Up to this many relaunches."""
    os.makedirs(log_dir, exist_ok=True)
    for attempt in range(max_gang_restarts + 1):
        base_env = dict(os.environ)
        # fresh port per attempt: a dead coordinator's socket may linger
        base_env[COORD_ENV] = f"localhost:{coordinator_port + attempt}"
        base_env[NPROC_ENV] = str(num_processes)
        if env:
            base_env.update(env)
        procs = []
        logs = []
        t0 = time.time()
        mode = "w" if attempt == 0 else "a"
        for i in range(num_processes):
            e = dict(base_env)
            e[PID_ENV] = str(i)
            e.update(worker_device_env(base_env, i))
            log = open(os.path.join(log_dir, f"worker.{i}.log"), mode)
            log.write(f"# Running on {os.uname().nodename}"
                      + (f" (gang restart {attempt})" if attempt else "")
                      + f"\n# Started at {time.ctime()}\n"
                      f"# {' '.join(worker)}\n")
            log.flush()
            procs.append(subprocess.Popen(worker, env=e, stdout=log,
                                          stderr=subprocess.STDOUT))
            logs.append(log)
        codes = []
        for i, p in enumerate(procs):
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(-9)
            if codes[-1] != 0:
                # one controller down = the SPMD program cannot finish:
                # kill the rest of the gang now (don't wait out their
                # hung collectives)
                for q in procs:
                    if q.poll() is None:
                        q.kill()
        dt = time.time() - t0
        for i, log in enumerate(logs):
            # run.pl accounting line (ref: utils/run.pl's epilogue)
            log.write(f"# Accounting: time={dt:.0f} threads=1\n"
                      f"# Finished at {time.ctime()} with status "
                      f"{codes[i]}\n")
            log.close()
        if all(c == 0 for c in codes) or attempt == max_gang_restarts:
            return codes
    return codes


def main():
    """`python -m kaldi_tpu.parallel.launch N -- worker.py args...`"""
    argv = sys.argv[1:]
    n = int(argv[0])
    assert argv[1] == "--"
    worker = [sys.executable] + argv[2:]
    codes = launch_local(worker, n, log_dir="launch_logs")
    sys.exit(max(codes, default=0))


if __name__ == "__main__":
    main()
