"""The port's raylint (``ray_tpu_torch/_private/lint``) against the
reference's (``ray_tpu/_private/lint``).

Every test of ``tests/test_raylint.py`` runs here once more, on the port:
the file's source is translated (the package name, the ``RAY_TPU_``
variables, and the GPU names of the one hold kind that differs) and each
of its tests is a case of ``test_mirrored``. A fixture tree such a test
lints is written twice: under ``ray_tpu_torch/`` and linted by the
port's lint, whose findings the test then asserts on, and under
``ray_tpu/`` and linted by the reference's. Both must report the same
rules at the same lines.

Then the port's own cases: the runtime seam's ``get`` (``self._rt.get``,
``rt.get``, ``runtime.get``) counts as a blocking get, bounded only by a
timeout, and ``str``/``bytes`` ``.join`` on a literal is no thread join.

Pure ``ast`` + threading: no torch, no jax, no cluster.
"""

import ast
import inspect
import json
import linecache
import pathlib
import re
import subprocess
import sys
import types

import pytest

from ray_tpu._private.lint import core as ref_core
from ray_tpu_torch._private.lint import core

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE_TESTS = ROOT / "tests" / "test_raylint.py"

# Reference text -> port text. Lengths change but no line does, so a
# finding's line is the same in both trees.
_TO_PORT = [
    (re.compile(r"\bray_tpu\b"), "ray_tpu_torch"),
    (re.compile(r"\bRAY_TPU_"), "RAY_TPU_TORCH_"),
    # The node manager's accelerator holds: TPU chips there, GPUs here.
    (re.compile(r"\b_acquire_chips\b"), "_acquire_gpus"),
    (re.compile(r"\b_free_tpu_chips\b"), "_free_gpus"),
    (re.compile(r"\b_release_chips\b"), "_release_gpus"),
    (re.compile(r"\bchip hold\b"), "GPU hold"),
]
_TO_REFERENCE = [
    (re.compile(r"\bray_tpu_torch\b"), "ray_tpu"),
    (re.compile(r"\bRAY_TPU_TORCH_"), "RAY_TPU_"),
    (re.compile(r"\b_acquire_gpus\b"), "_acquire_chips"),
    (re.compile(r"\b_free_gpus\b"), "_free_tpu_chips"),
    (re.compile(r"\b_release_gpus\b"), "_release_chips"),
]


def _translate(text, table):
    for pat, repl in table:
        text = pat.sub(repl, text)
    return text


def _port_module():
    """``tests/test_raylint.py`` translated to the port, as a module."""
    src = _translate(REFERENCE_TESTS.read_text(), _TO_PORT)
    name = "<tests/test_raylint.py, translated to the port>"
    # Tracebacks show the translated lines, not the file's.
    linecache.cache[name] = (len(src), None, src.splitlines(True), name)
    mod = types.ModuleType("torch_raylint_mirror")
    mod.__file__ = name
    exec(compile(src, name, "exec"), mod.__dict__)
    port_lint_tree = mod.lint_tree

    def lint_tree(tmp_path, files, rules=None):
        """The mirrored module's ``lint_tree``: lint ``files`` with the
        port's lint (returned) and, written back under ``ray_tpu/`` in a
        tree of its own, with the reference's; both must agree."""
        got = port_lint_tree(tmp_path, files, rules)
        ref_root = tmp_path / "_reference_tree"
        for rel, text in files.items():
            p = ref_root / _translate(rel, _TO_REFERENCE)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(_translate(text, _TO_REFERENCE))
        want = ref_core.run_lint([str(ref_root / "ray_tpu")],
                                 root=str(ref_root), rules=rules)
        assert sorted((v.rule, _translate(v.path, _TO_PORT), v.line)
                      for v in want) == \
            sorted((v.rule, v.path, v.line) for v in got), (want, got)
        return got

    mod.lint_tree = lint_tree
    return mod


_MIRROR = _port_module()
MIRRORED = sorted(name for name, fn in vars(_MIRROR).items()
                  if name.startswith("test_") and inspect.isfunction(fn))


def test_every_reference_test_is_mirrored():
    names = re.findall(r"^def (test_\w+)", REFERENCE_TESTS.read_text(),
                       re.M)
    assert len(names) == 69
    assert sorted(names) == MIRRORED


@pytest.mark.parametrize("name", MIRRORED)
def test_mirrored(name, request):
    fn = getattr(_MIRROR, name)
    fn(*(request.getfixturevalue(p)
         for p in inspect.signature(fn).parameters))


# ------------------------------------------------------------ the port's own

COLL = "ray_tpu_torch/parallel/collective.py"
INGRESS = "ray_tpu_torch/serve/ingress/server.py"


def _lint(tmp_path, files, rules=None):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return core.run_lint([str(tmp_path / "ray_tpu_torch")],
                         root=str(tmp_path), rules=rules)


def test_runtime_seam_get_without_timeout_triggers(tmp_path):
    """The gang and serving paths hold their runtime as ``self._rt`` or
    take it as ``rt``/``runtime``: a get through it with no timeout waits
    forever on a dead producer, as ``ray.get`` does."""
    v = _lint(tmp_path, {COLL: (
        "class Group:\n"
        "    def sync(self, ref, rt, runtime):\n"
        "        self._rt.get(ref)\n"
        "        rt.get([ref])\n"
        "        runtime.get(ref)\n"
        "        self._runtime.get(ref)\n"
        "        self._rt.get(ref, timeout=5)\n"
        "        rt.get(ref, 5)\n"
        "        runtime.get(ref, timeout=self._op_timeout_s)\n"
    )}, rules={"unbounded-wait"})
    assert sorted(x.line for x in v) == [3, 4, 5, 6], v


def test_runtime_seam_get_under_lock_triggers(tmp_path):
    """A bounded seam get still blocks every thread queueing on a lock
    held across it (the controller's proxy reconcile was one)."""
    v = _lint(tmp_path, {COLL: (
        "import threading\n"
        "class Group:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def sync(self, ref):\n"
        "        with self._lock:\n"
        "            return self._rt.get(ref, timeout=5)\n"
    )}, rules={"blocking-under-lock"})
    assert [(x.rule, x.line) for x in v] == [("blocking-under-lock", 7)]
    assert "self._rt.get" in v[0].message


def test_literal_join_in_async_def_does_not_trigger(tmp_path):
    """``b"".join`` and ``"sep".join`` are a literal's methods, never a
    thread's: neither directly in an ``async def`` of the ingress nor
    through a helper module it calls (the port's HTTP server joins the
    body's chunks so)."""
    v = _lint(tmp_path, {
        "ray_tpu_torch/_private/http.py": (
            "def body(chunks):\n"
            "    return b''.join(chunks)\n"
            "def header(parts):\n"
            "    return ', '.join(parts)\n"
        ),
        INGRESS: (
            "from ray_tpu_torch._private import http\n"
            "async def handle(req, chunks):\n"
            "    data = b''.join(chunks)\n"
            "    return http.body([data]), http.header(['a', 'b'])\n"
        ),
    })
    assert v == []


def test_thread_join_in_async_def_still_triggers(tmp_path):
    """The same shapes on a thread do block the loop."""
    v = _lint(tmp_path, {
        "ray_tpu_torch/_private/http.py": (
            "def wait_writer(t):\n"
            "    t.join(1.0)\n"
        ),
        INGRESS: (
            "from ray_tpu_torch._private import http\n"
            "async def handle(req, t):\n"
            "    http.wait_writer(t)\n"
        ),
    }, rules={"async-blocking"})
    assert [(x.rule, x.line) for x in v] == [("async-blocking", 3)], v


def test_port_tree_is_clean_with_an_empty_baseline():
    """The port's ratchet holds nothing: every finding is fixed or
    carries a reasoned suppression, as the reference's does."""
    assert core.load_baseline() == {}
    assert json.loads(pathlib.Path(core.DEFAULT_BASELINE).read_text())[
        "entries"] == {}
    assert core.run_lint() == []


def test_scope_lists_name_existing_port_files():
    """``CONTROL_PLANE`` and ``GANG_PATHS`` name the port's counterparts
    of the reference's lists, plus the HTTP server under the ingress and
    the dashboard."""
    port = set(core.CONTROL_PLANE)
    assert {_translate(p, _TO_PORT) for p in ref_core.CONTROL_PLANE} \
        | {"ray_tpu_torch/_private/http.py"} == port
    assert {_translate(p, _TO_PORT) for p in ref_core.GANG_PATHS} == \
        set(core.GANG_PATHS)
    for rel in port | set(core.GANG_PATHS):
        assert (ROOT / rel).is_file(), rel


def test_lint_cli_loads_no_torch_jax_or_reference():
    """``python -m ray_tpu_torch._private.lint --json`` in a fresh
    interpreter: clean, and nothing of torch, jax or ``ray_tpu`` loaded."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['lint', '--json']\n"
        "try:\n"
        "    runpy.run_module('ray_tpu_torch._private.lint',"
        " run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print(repr((rc, sorted({m.split('.')[0] for m in sys.modules}))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    *report, last = out.strip().splitlines()
    rc, loaded = ast.literal_eval(last)
    assert rc == 0, out
    report = json.loads("\n".join(report))
    assert report["violations"] == [] and report["stale_baseline"] == []
    assert not {"torch", "jax", "jaxlib", "ray_tpu", "numpy"} & set(loaded)
