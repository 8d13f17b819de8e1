"""``tests/test_data_streaming.py`` on the port's runtime, test by test:
the streaming executor, Train ingest and dataset pipelines.

Each test's body runs as a program of ``torch_libs_programs``'
"data_streaming" group on both runtimes, on one cluster of the reference
fixture's size (4 CPUs, a 128 MiB store); the results must be equal and
pass the reference's assertions. The ingest gang runs on the CPU on the
port (``device="cpu"``).
"""

import pytest

import torch_libs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "data_streaming", tmp_path_factory)


def test_streaming_matches_bulk(results):
    streamed, bulk = same_result(results, "streaming_matches_bulk")
    assert streamed == bulk == [3 * i for i in range(100)]


def test_streaming_bounded_in_flight(results):
    """With ``prefetch_blocks=1`` the first block does not run them all."""
    first, bounded, rest = same_result(results,
                                       "streaming_bounded_in_flight")
    assert len(first) == 1
    assert bounded
    assert rest == 7


def test_iter_batches_streams(results):
    keys, seen = same_result(results, "iter_batches_streams")
    assert all(k == ["v"] for k in keys)
    assert seen == list(range(64))


def test_streaming_split_is_lazy_and_disjoint(results):
    all_rows, total = same_result(results,
                                  "streaming_split_is_lazy_and_disjoint")
    assert all_rows == [i + 1000 for i in range(40)]
    assert total == 40


def test_train_ingest_with_dataset_shard(results):
    """Rank 0 of a 2-rank gang consumes a strict subset of the rows."""
    assert same_result(results, "train_ingest_with_dataset_shard") == \
        (True, 0)


def test_dataset_pipeline_windows(results):
    rows, length = same_result(results, "dataset_pipeline_windows")
    assert rows == [2 * i for i in range(40)]
    assert length == 4


def test_dataset_pipeline_repeat_epochs(results):
    assert same_result(results, "dataset_pipeline_repeat_epochs") == \
        (30, list(range(10)))


def test_dataset_pipeline_batches_across_windows(results):
    assert same_result(results,
                       "dataset_pipeline_batches_across_windows") == 24


def test_mirrors_every_reference_test():
    assert_mirrored("data_streaming")
