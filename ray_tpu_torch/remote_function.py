"""RemoteFunction: the object behind ``@ray_tpu_torch.remote`` on a function.

Role-equivalent to the reference's ``python/ray/remote_function.py:35``
(``_remote`` :241): holds normalized submission options, exports the
cloudpickled function to the GCS function store once
(reference: _private/function_manager.py:181), and submits TaskSpecs.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import pickler

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.task_spec import normalize_resources

# Option defaults (reference: _private/ray_option_utils.py task_options).
_TASK_DEFAULTS = dict(
    num_cpus=None,
    num_gpus=None,
    memory=None,
    resources=None,
    num_returns=1,
    max_retries=3,
    retry_exceptions=False,
    name=None,
    scheduling_strategy=None,
    placement_group=None,
    placement_group_bundle_index=-1,
    runtime_env=None,
    max_calls=0,
    _metadata=None,
    # Opt-in device-object donation: release the producing worker's
    # tensor storage as soon as the return value is staged into the
    # object store (see task_spec.TaskSpec.donate_result).
    _donate_result=False,
)


def _merge_options(base: Dict[str, Any], overrides: Dict[str, Any]):
    out = dict(base)
    for k, v in overrides.items():
        if k not in _TASK_DEFAULTS:
            raise ValueError(f"unknown task option: {k}")
        out[k] = v
    return out


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._options = _merge_options(_TASK_DEFAULTS, options or {})
        self._function_key: Optional[str] = None
        self._exported_blob: Optional[bytes] = None
        self._exported_core = None
        self._normalized_resources: Optional[Dict[str, float]] = None
        # Pre-serialized TaskSpec skeleton: this function's constant
        # submission fields frozen into a pickled template the core
        # worker patches per call (spec_template.py). Per-RemoteFunction
        # because options are immutable here (options() returns a new
        # one, with its own holder).
        self._submit_template = worker_mod.SubmitTemplate()
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__name__}' cannot be called "
            "directly; use '.remote()'.")

    def __getstate__(self):
        # A RemoteFunction closure-captured into a task must pickle even
        # after driver-side use: drop the per-process caches — the
        # CoreWorker handle behind the export-once optimization and the
        # spec-template holder (frozen caller identity) are both bound
        # to THIS process. The function blob and content-addressed key
        # travel; the destination re-exports (a GCS-side dedup no-op).
        d = dict(self.__dict__)
        d["_exported_core"] = None
        d["_submit_template"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._submit_template = worker_mod.SubmitTemplate()

    def options(self, **overrides) -> "RemoteFunction":
        rf = RemoteFunction(self._function,
                            _merge_options(self._options, overrides))
        rf._exported_blob = self._exported_blob
        return rf

    def _ensure_exported(self, core) -> str:
        if self._exported_blob is None:
            self._exported_blob = pickler.dumps(self._function)
        if self._function_key is not None and core is self._exported_core:
            # Same worker generation: the key is content-addressed and
            # the upload already happened — skip the per-call sha1.
            return self._function_key
        self._function_key = core.export_function(self._exported_blob)
        self._exported_core = core
        return self._function_key

    def remote(self, *args, **kwargs):
        core = worker_mod.require_worker()
        o = self._options
        key = self._ensure_exported(core)
        # Options are immutable per RemoteFunction (options() returns a
        # new one): normalize once, not per task submission.
        resources = self._normalized_resources
        if resources is None:
            resources = self._normalized_resources = normalize_resources(
                o["num_cpus"], o["num_gpus"], o["memory"],
                o["resources"], default_cpus=1.0)
        strategy = o["scheduling_strategy"]
        pg = o["placement_group"]
        bundle_index = o["placement_group_bundle_index"]
        if strategy is not None and hasattr(strategy, "placement_group"):
            pg = strategy.placement_group
            bundle_index = getattr(strategy, "placement_group_bundle_index",
                                   -1)
            strategy = None
        refs = core.submit_task(
            key, args, kwargs,
            name=o["name"] or self._function.__name__,
            num_returns=o["num_returns"],
            resources=resources,
            max_retries=o["max_retries"],
            scheduling_strategy=strategy,
            placement_group=pg,
            placement_group_bundle_index=bundle_index,
            runtime_env=o["runtime_env"],
            donate_result=bool(o["_donate_result"]),
            template=self._submit_template,
        )
        if o["num_returns"] == 0:
            return None
        if o["num_returns"] == 1 or o["num_returns"] == "dynamic":
            # dynamic: one ref whose value is an ObjectRefGenerator
            # (reference: python/ray generator tasks, test_generators.py).
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """A DAG node of this call (``ray_tpu_torch.dag``), submitted only
        when the graph executes."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    @property
    def bound_function(self):
        return self._function
