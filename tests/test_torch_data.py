"""The port's datasets (``ray_tpu_torch.data``) against the JAX package's
(``ray_tpu.data``).

The programs of ``torch_cluster_programs`` (those of tests/test_data.py,
tests/test_data_actor_pool.py and tests/test_data_streaming.py, block
splitting by ``DataContext``, and the main path's token pipeline) run on a
4-CPU ``ray_tpu`` cluster in a fresh interpreter, which exits, and then on
a 4-CPU ``ray_tpu_torch`` cluster in this process. Each program's results
must be equal: the same rows in the same order (a seeded shuffle
included), the same ``explain()`` plans, and the same rows consumed by each
rank of a trainer reading ``get_dataset_shard`` (the port's on
``device="cpu"``).
"""

import numpy as np
import pytest

import torch_cluster_programs as progs
from torch_runtimes import deadline, reference_results

NAMES = [p.__name__ for p in progs.PROGRAMS["data"]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = reference_results("torch_cluster_programs.py",
                            ["data", tmp_path_factory.mktemp("ref")],
                            tmp_path_factory.mktemp("ref_out"))
    import ray_tpu_torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with deadline(what="the data programs on the port's runtime"):
            port = progs.run_group(ray_tpu_torch, "GPU", "data",
                                   str(tmp_path_factory.mktemp("port")))
    return {"ray_tpu": ref, "ray_tpu_torch": port}


@pytest.mark.parametrize("program", NAMES)
def test_same_results_on_both_runtimes(results, program):
    ref = results["ray_tpu"][program]
    port = results["ray_tpu_torch"][program]
    assert ref[0] == "ok", ref
    assert port == ref


def test_shuffle_is_a_seeded_permutation(results):
    """The token pipeline's shuffled rows are the unshuffled rows in
    another order, the one both runtimes draw from the seed."""
    status, (batches, shuffled) = results["ray_tpu_torch"][
        "d_train_batches_of_a_token_table"]
    assert status == "ok"
    rows = [list(i) + [t] for b in batches
            for i, t in zip(b["inputs"], (r[-1] for r in b["targets"]))]
    assert sorted(map(tuple, shuffled)) == sorted(map(tuple, rows))
    assert shuffled != rows


def test_batches_are_the_seeded_tokens(results):
    """Each batch the pipeline yields is the seeded table cut into inputs
    and targets, as the main path's training step reads it."""
    toks = np.random.default_rng(0).integers(0, 256, (4, 17))
    status, (batches, _) = results["ray_tpu_torch"][
        "d_train_batches_of_a_token_table"]
    assert status == "ok" and len(batches) == 3
    for b in batches:
        assert b["inputs"] == toks[:, :-1].tolist()
        assert b["targets"] == toks[:, 1:].tolist()


def test_programs_cover_the_reference_tests():
    reference = {
        # tests/test_data.py
        "d_range_and_transforms", "d_flat_map_and_fusion",
        "d_map_batches_numpy", "d_iter_batches_formats",
        "d_repartition_shuffle_sort", "d_zip_union_split", "d_groupby",
        "d_aggregates_and_schema", "d_read_write_roundtrip",
        "d_from_numpy_pandas_arrow", "d_logical_plan_explain_and_rules",
        "d_limit_pushdown_skips_blocks",
        "d_leading_limit_caps_input_not_output",
        "d_limit_blocked_by_flat_map",
        # tests/test_data_actor_pool.py
        "d_actor_pool_init_once_per_actor", "d_actor_pool_respects_max_size",
        "d_actor_pool_composes_with_task_stages",
        "d_actor_pool_explain_and_plain_callable",
        "d_actor_pool_streaming_iter_batches",
        # tests/test_data_streaming.py
        "d_streaming_matches_bulk", "d_streaming_bounded_in_flight",
        "d_iter_batches_streams", "d_streaming_split_is_lazy_and_disjoint",
        "d_train_ingest_with_dataset_shard", "d_dataset_pipeline_windows",
        "d_dataset_pipeline_repeat_epochs",
        "d_dataset_pipeline_batches_across_windows"}
    assert reference <= set(NAMES)
