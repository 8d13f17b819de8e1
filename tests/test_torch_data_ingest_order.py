"""The 2-rank store gang's rendezvous after every other data program, on
the port's runtime: the ingest program of ``torch_cluster_programs``,
which ``test_torch_data`` runs first on a fresh cluster, runs here last on
the cluster the other data programs used, and must give what it gives
first."""

import tempfile
import time

import pytest

import torch_cluster_programs as progs
from torch_runtimes import deadline

INGEST = progs.d_train_ingest_with_dataset_shard


def test_ingest_after_the_other_data_programs(tmp_path):
    import ray_tpu_torch

    others = [p for p in progs.PROGRAMS["data"] if p is not INGEST]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(what="the data programs, then the ingest gang"):
            ray_tpu_torch.init(**progs.CLUSTER)
            try:
                for prog in others:
                    prog(ray_tpu_torch, "GPU",
                         tempfile.mkdtemp(dir=tmp_path))
                t0 = time.monotonic()
                n, total, rank = INGEST(ray_tpu_torch, "GPU",
                                        tempfile.mkdtemp(dir=tmp_path))
                took = time.monotonic() - t0
            finally:
                ray_tpu_torch.shutdown()
    # Each rank streams its own blocks of range(60): rank 0's half.
    assert (n, total, rank) == (30, 735, 0)
    print(f"ingest after the data programs: {took:.2f} s")
