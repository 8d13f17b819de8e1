"""``tests/test_serialization.py`` on the port's serializer, test by test.

The port serializes through its own ``_private/pickler.py`` where the
reference uses cloudpickle. Each test runs its check on both
``_private/serialization`` modules in this process (no runtime is up) and
holds that they give the same values, and that the port's pass the
reference test's own assertions: what the reference carries by
cloudpickle (a local function, a task error) comes back equal.
"""

import numpy as np

from ray_tpu._private import serialization as ref_ser
from ray_tpu_torch._private import serialization as ser
from torch_mirror import assert_mirrored


def _both(check):
    """``check(module, package)`` on the reference's serializer, then on
    the port's; the two results must be equal."""
    import ray_tpu
    import ray_tpu_torch

    ref = check(ref_ser, ray_tpu)
    port = check(ser, ray_tpu_torch)
    assert port == ref, (port, ref)
    return port


def test_roundtrip_simple():
    values = [1, "x", None, {"a": [1, 2, (3, 4)]}, b"bytes"]
    assert _both(lambda s, _: [s.loads_oob(s.dumps_oob(v))
                               for v in values]) == values


def test_numpy_out_of_band_zero_copy():
    arr = np.arange(1 << 16, dtype=np.float32)

    def check(s, _):
        sobj = s.serialize({"w": arr, "tag": "x"})
        back = s.loads_oob(sobj.to_bytes())
        # The array must have gone out-of-band, not into the pickle stream.
        return (len(sobj.metadata) < arr.nbytes // 2,
                sum(b.nbytes for b in sobj.buffers) >= arr.nbytes,
                bool(np.array_equal(back["w"], arr)), back["tag"])

    assert _both(check) == (True, True, True, "x")


def test_zero_copy_view_shares_memory():
    arr = np.arange(1024, dtype=np.int64)

    def check(s, _):
        data = s.dumps_oob(arr)
        view = memoryview(bytearray(data))
        back = s.deserialize_framed(view)
        equal = bool(np.array_equal(back, arr))
        # Mutating the backing view must show through (proves zero-copy).
        back2 = s.deserialize_framed(view)
        view_arr = np.frombuffer(view, dtype=np.int64, count=1024,
                                 offset=data.index(arr[:8].tobytes()))
        view_arr[0] = 999
        return equal, int(back2[0])

    assert _both(check) == (True, 999)


def test_alignment():
    arr = np.ones(100, dtype=np.float64)

    def check(s, _):
        back = s.loads_oob(s.serialize(arr).to_bytes())
        # 64-byte alignment lets numpy map the buffer without copying.
        return bool(np.array_equal(back, arr)), str(back.dtype)

    assert _both(check) == (True, "float64")


def test_function_roundtrip():
    def f(x):
        return x * 2

    assert _both(lambda s, _: s.loads_oob(s.dumps_oob(f))(21)) == 42


def test_exception_roundtrip():
    def check(s, pkg):
        try:
            raise ValueError("boom")
        except ValueError as e:
            err = pkg.exceptions.RayTaskError.from_exception("f", e)
        back = s.loads_oob(s.dumps_oob(err))
        return (isinstance(back, pkg.exceptions.RayTaskError),
                "boom" in back.traceback_str,
                isinstance(back.as_instanceof_cause(), ValueError))

    assert _both(check) == (True, True, True)


def test_mirrors_every_reference_test():
    assert_mirrored("serialization")
