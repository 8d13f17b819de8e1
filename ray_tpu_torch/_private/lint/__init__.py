"""raylint: AST-based distributed-correctness static analysis for the
port's control plane.

The control-plane bug classes this repo has paid for by hand — locks and
GPU holds leaked on error paths, unbounded waits that wedge gangs,
blocking RPCs issued under a lock (the deferred-reply hang), raw env
reads bypassing the typed config registry — are exactly the defect
taxonomy Ray's C++ raylet fights (reference: src/ray/raylet/). raylint
encodes them as checkers over the python `ast`, inter-procedural one
call deep, with a committed baseline that may only shrink (the ratchet).

Usage:
    python -m ray_tpu_torch._private.lint              # lint the repo
    python -m ray_tpu_torch._private.lint --explain unbounded-wait
    python -m ray_tpu_torch._private.lint --write-baseline

Pair: the runtime lock-order witness (`ray_tpu_torch._private.lockdep`)
validates at run time what the `lock-order` checker proves statically.
"""

from ray_tpu_torch._private.lint.core import (  # noqa: F401
    Violation,
    load_baseline,
    run_lint,
)
