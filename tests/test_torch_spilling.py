"""``tests/test_spilling.py`` on the port's runtime, test by test.

``test_spilled_objects_served_to_tasks``' result is a value: it runs as a
program of ``torch_objects_programs``' "spilling" group on both runtimes,
and the results must be equal. The spill storage's round trip runs on
both ``external_storage`` modules here; the spill under pressure reads
the node manager's ``_spilled``, and runs on the port alone.
"""

import importlib
import time

import numpy as np
import pytest

import torch_objects_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, ports_runtime, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "spilling", tmp_path_factory)


def test_filesystem_storage_roundtrip(tmp_path):
    got = []
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        storage = importlib.import_module(f"{pkg}._private.external_storage")
        st = storage.FileSystemStorage(str(tmp_path / pkg / "spill"))
        url = st.spill(b"\x01" * 28, b"hello world")
        back = st.restore(url)
        st.delete(url)
        with pytest.raises(OSError):
            st.restore(url)
        got.append((url.startswith("file://"), back))
    assert got[1] == got[0] == (True, b"hello world")


def test_spill_and_restore_under_pressure():
    # 8 MiB store; 6 x 2MiB objects overflow it well past the 0.8
    # threshold, forcing spills; every object must still be gettable.
    with ports_runtime(num_cpus=2, object_store_memory=8 * 1024 * 1024) \
            as rt:
        from ray_tpu_torch._private import worker as worker_mod

        blobs = [np.full(2 * 1024 * 1024 // 8, i, np.int64)
                 for i in range(6)]
        refs = [rt.put(b) for b in blobs]

        # give the spill monitor time to react to the pressure
        nm = worker_mod._global_cluster.nm
        deadline = time.time() + 15
        while time.time() < deadline and not nm._spilled:
            time.sleep(0.2)
        assert nm._spilled, "nothing spilled under pressure"

        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(rt.get(ref, timeout=60), blobs[i])


def test_spilled_objects_served_to_tasks(results):
    assert same_result(results, "spilled_objects_served_to_tasks") == \
        [0, 1, 2, 3, 4, 5]


def test_mirrors_every_reference_test():
    assert_mirrored("spilling")
