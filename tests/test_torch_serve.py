"""The serve control plane on both runtimes: ``ray_tpu.serve`` on the JAX
package's runtime, then ``ray_tpu_torch.serve`` on the port's, one after
the other (``tests/torch_runtimes.py``).

The scenarios are ``tests/torch_serve_programs.py``'s, twins of
``tests/test_serve.py``'s: a function and a class deployment,
``options(method_name=...)``, composition by nested ``.bind()``,
``remote_gen`` over sync and async generators, ``status``/``delete``,
queue-depth autoscaling up and down, a killed replica replaced through
the GCS's death push, and a rolling redeploy that drains the old replica
(its in-flight call finishes on the old code). Each returns plain values,
equal on both runtimes. On the port, a replica may hold a GPU (declared
here): it sees ``CUDA_VISIBLE_DEVICES`` of its own, and a killed GPU
replica's replacement waits for the freed GPU, then serves.
"""

import pytest

import ray_tpu
import torch_serve_programs as progs
from torch_runtimes import deadline, ports_runtime


@pytest.fixture(scope="module")
def results():
    """Every program on the JAX package's runtime, then on the port's."""
    import ray_tpu.serve as jserve

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        with deadline(what="the serve programs on ray_tpu"):
            jserve.start(http_port=None)
            out["ray_tpu"] = progs.run_all(ray_tpu)
            jserve.shutdown()
    finally:
        ray_tpu.shutdown()
    with ports_runtime(num_cpus=4, num_gpus=1) as rt:
        import ray_tpu_torch.serve as tserve

        tserve.start(http_port=None)
        try:
            out["ray_tpu_torch"] = progs.run_all(rt)
            out["gpu"] = progs.gpu_replica_replaced(rt)
        finally:
            tserve.shutdown()
    return out


EXPECTED = {
    "function": {"got": "hi"},
    "class_methods_and_options": (10, 15, 10, 2),
    "composition": (20, ["Adder", "Doubler", "Pipeline"]),
    "remote_gen": ([{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}], [0, 10, 20],
                   True),
    "status_and_delete": (True, 1, 1, "/gone", False),
    "autoscale_up_and_down": (True, True),
    "killed_replica_replaced": ({"got": 1}, True, {"got": 7}, True),
    "drain_on_redeploy": ("v1", True, True),
}


def test_programs_cover_the_scenarios():
    assert set(progs.PROGRAMS) == set(EXPECTED)


@pytest.mark.parametrize("program", sorted(EXPECTED))
def test_same_outcome_on_both_runtimes(results, program):
    ref, port = results["ray_tpu"][program], results["ray_tpu_torch"][program]
    assert ref == ("ok", EXPECTED[program]), ref
    assert port == ref


def test_gpu_replica_sees_its_gpu_and_is_replaced(results):
    seen, replaced, after = results["gpu"]
    assert seen == ("0", "")
    assert replaced
    assert after == "0"


def test_serve_names_match_the_reference():
    import ray_tpu.serve as jserve
    import ray_tpu_torch.serve as tserve

    assert set(jserve.__all__) <= set(tserve.__all__)
    assert tserve.build_llm_app is \
        __import__("ray_tpu_torch.serve.llm", fromlist=["x"]).build_llm_app
