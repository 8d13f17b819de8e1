"""Distributed datasets (port of ``ray_tpu/data``; reference:
``python/ray/data`` — ``Dataset``
``data/dataset.py:166`` on object-store blocks with a lazy
``ExecutionPlan`` ``data/_internal/plan.py:80``).

Blocks live in the shared-memory object store as serialized row lists /
arrow tables; transforms run as tasks over blocks (the reference's bulk
executor, ``_internal/execution/bulk_executor.py:20``). ``iter_batches``
feeds numpy batches host-side; device placement belongs to the training
step (a rank moves its batch to its GPU), not the dataset.
"""

from ray_tpu_torch.data.dataset import (  # noqa: F401
    ActorPoolStrategy,
    DataContext,
    Dataset,
    DatasetPipeline,
    from_items,
    range as range_,  # noqa: A001
    from_numpy,
    from_pandas,
    from_arrow,
    read_text,
    read_csv,
    read_json,
    read_parquet,
    read_binary_files,
)

# `ray_tpu_torch.data.range(n)` mirrors the reference's `ray.data.range`.
range = range_  # noqa: A001

__all__ = [
    "ActorPoolStrategy", "DataContext", "Dataset", "DatasetPipeline",
    "from_items", "range", "from_numpy", "from_pandas",
    "from_arrow", "read_text", "read_csv", "read_json", "read_parquet",
    "read_binary_files",
]

from ray_tpu_torch._private import usage as _usage  # noqa: E402
_usage.record_library_usage("data")
del _usage
