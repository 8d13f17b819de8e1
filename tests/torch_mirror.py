"""Which reference test files the port's tests mirror test by test.

``assert_mirrored(name)`` reads the module-level ``test_*`` functions of
``tests/test_<name>.py`` and of its twin ``tests/test_torch_<name>.py``
with ``ast`` (neither is imported) and holds that the twin has the same
set, besides its own coverage test, ``COVERAGE_TEST``.

``NOT_MIRRORED`` lists the reference files with no same-named twin. It
is empty: every reference test file has its twin.
``tests/test_torch_mirror_coverage.py`` holds it against the directory,
so a reference file added without a twin fails there.
"""

from __future__ import annotations

import ast
import pathlib

TESTS = pathlib.Path(__file__).resolve().parent
COVERAGE_TEST = "test_mirrors_every_reference_test"

NOT_MIRRORED = frozenset()


def names_in(path) -> set:
    tree = ast.parse(pathlib.Path(path).read_text())
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name.startswith("test_")}


def reference_files() -> set:
    """The reference's test files, by name (``test_<name>.py``)."""
    return {p.stem[len("test_"):] for p in TESTS.glob("test_*.py")
            if not p.stem.startswith("test_torch_")}


def unmirrored() -> set:
    return {n for n in reference_files()
            if not (TESTS / f"test_torch_{n}.py").exists()}


def assert_mirrored(name: str) -> None:
    ref = names_in(TESTS / f"test_{name}.py")
    port = names_in(TESTS / f"test_torch_{name}.py") - {COVERAGE_TEST}
    assert port == ref, {"missing": sorted(ref - port),
                         "extra": sorted(port - ref)}
