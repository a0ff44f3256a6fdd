"""Mesh & sharding utilities — the replacement for run.pl/queue.pl job
arrays and filesystem reduces (SURVEY.md §2.11)."""

from kaldi_tpu.parallel.mesh import make_mesh, data_parallel_sharding
from kaldi_tpu.parallel.mesh import batch_sharding, decode_sharded
from kaldi_tpu.parallel.frontier_decode import decode_frontier_sharded
from kaldi_tpu.parallel.launch import (init_distributed, global_mesh,
                                       host_shard, launch_local)
