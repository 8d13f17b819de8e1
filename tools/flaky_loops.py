"""Loop a check or a test that failed now and then under load, on a tree
of this repo, and count the passes.

    python3 tools/flaky_loops.py [--tree DIR] [--loops 20]
        [--check death_push|fp_all_on] [--runtime ray_tpu|ray_tpu_torch]
    python3 tools/flaky_loops.py [--tree DIR] [--loops 10] --test NODEID

- ``death_push``: ``tests/test_torch_gang_fault_tolerance.py::
  test_death_push_detects_sigkill``'s check (the port's gang supervisor on
  the ``ray_tpu`` runtime, its pings unable to fail, a rank SIGKILLed),
  ``--loops`` times on one 4-CPU cluster, as the test module holds one.
- ``fp_all_on``: ``tests/test_torch_submit_fastpath_ab.py::
  test_same_results_on_both_runtimes[fp_all_on]``'s program (each loop its
  own 2-CPU cluster) on one runtime; a loop passes when the workload's
  results are the expected ones and every probe, ``local_actor`` among
  them, reads True.

- ``--test NODEID``: a pytest node id of the tree (``tests/test_x.py::
  test_y``), run ``--loops`` times, each in a fresh ``python -m pytest``
  from the tree's root; a loop passes when pytest exits 0. A test that
  runs past 60 s prints every thread's stack (``faulthandler_timeout``),
  and each loop's last lines go to stdout.

With no ``--check`` and no ``--test``, each check runs in a fresh interpreter of its own
(``fp_all_on`` once for each runtime, never both runtimes in one
process), and the last line is a JSON object of the pass counts. The
tree's ``tests`` directory gives the checks, so ``--tree`` of an unpacked
parent commit loops the parent's code. Run it beside other load (say,
five xdist workers running the port's tests) to see what the tests see
under load. Needs ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def death_push(loops, tmp):
    import torch

    import ray_tpu
    import ray_tpu.experimental.pubsub  # noqa: F401  (the runtime's push)
    import torch_gang_programs as gp
    from ray_tpu_torch._private.config import config

    torch.set_num_threads(1)
    for k, v in gp.GANG_KNOBS.items():
        config.set(k, v)
    os.environ["OMP_NUM_THREADS"] = "1"
    ray_tpu.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    out = []
    try:
        for i in range(loops):
            d = os.path.join(tmp, f"loop{i}")
            os.makedirs(d)
            try:
                took = gp.death_push_detects_sigkill(ray_tpu,
                                                     _Path(d))
                out.append({"ok": True, "s": round(took, 3)})
            except Exception as e:
                out.append({"ok": False, "error": repr(e)[:300]})
            print(f"death_push loop {i}: {out[-1]}", flush=True)
    finally:
        ray_tpu.shutdown()
    return out


def fp_all_on(runtime, loops, tmp):
    import importlib

    import torch_fastpath_programs as progs

    rt = importlib.import_module(runtime)
    os.environ["OMP_NUM_THREADS"] = "1"
    out = []
    for i in range(loops):
        try:
            res, probe = progs.fp_all_on(rt, "GPU", tmp)
            bad = sorted(k for k, v in probe.items() if v is not True)
            ok = res == progs.WORKLOAD_RESULT and not bad
            out.append({"ok": ok, "false_probes": bad})
        except Exception:
            out.append({"ok": False,
                        "error": traceback.format_exc()[-300:]})
        print(f"fp_all_on {runtime} loop {i}: {out[-1]}", flush=True)
    return out


def test_loops(tree, node_id, loops):
    out = []
    for i in range(loops):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", node_id, "-q", "-s",
             "-p", "no:cacheprovider", "-o", "faulthandler_timeout=60"],
            cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, stdin=subprocess.DEVNULL)
        out.append({"ok": proc.returncode == 0,
                    "s": round(time.time() - t0, 1)})
        tail = "\n".join(proc.stdout.splitlines()[-15:])
        print(f"loop {i}: {out[-1]}\n{tail}", flush=True)
    return out


class _Path(str):
    """The ``tmp_path`` the gang check takes (it joins with ``/``)."""

    def __truediv__(self, other):
        return _Path(os.path.join(self, other))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--loops", type=int, default=20)
    ap.add_argument("--check", choices=["death_push", "fp_all_on"])
    ap.add_argument("--runtime", default="ray_tpu_torch",
                    choices=["ray_tpu", "ray_tpu_torch"])
    ap.add_argument("--test", help="a pytest node id to loop instead")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if args.test is not None:
        out = test_loops(tree, args.test, args.loops)
        print(json.dumps({"tree": tree, "test": args.test,
                          "passed": sum(r["ok"] for r in out),
                          "loops": len(out)}), flush=True)
        return 0
    if args.check is None:
        counts = {}
        for check, runtime in (("death_push", "ray_tpu"),
                               ("fp_all_on", "ray_tpu"),
                               ("fp_all_on", "ray_tpu_torch")):
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--tree", tree,
                 "--loops", str(args.loops), "--check", check,
                 "--runtime", runtime], stdout=subprocess.PIPE, text=True,
                stdin=subprocess.DEVNULL)
            lines = proc.stdout.splitlines()
            sys.stdout.write(proc.stdout)
            last = json.loads(lines[-1]) if lines and \
                lines[-1].startswith("{") else {"passed": 0, "loops": 0}
            counts[f"{check}[{runtime}]"] = {
                "passed": last["passed"], "loops": last["loops"],
                "rc": proc.returncode, "s": round(time.time() - t0, 1)}
        print(json.dumps({"tree": tree, "counts": counts}), flush=True)
        return 0
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    with tempfile.TemporaryDirectory(prefix="flaky_loops_") as tmp:
        if args.check == "death_push":
            out = death_push(args.loops, tmp)
        else:
            out = fp_all_on(args.runtime, args.loops, tmp)
    print(json.dumps({"passed": sum(r["ok"] for r in out),
                      "loops": len(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
