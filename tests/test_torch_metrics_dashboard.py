"""``tests/test_metrics_dashboard.py`` on the port's runtime, test by test.

Every test but the README check returns a value: each runs as a program
of ``torch_obs_programs``' "metrics" group on both runtimes. As the
reference's module-scoped fixture does, the programs that use its
cluster (4 CPUs, a 128 MiB store) share one, started at the first of
them; the dashboards bind free ports instead of the reference's fixed
18265-18267, which its own tests hold beside these. The results must be
equal and pass the reference's assertions. The node's free-accelerator
count is ``tpu_chips_free`` on the reference and ``gpus_free`` on the
port.

The README check scans the port's package for the metric names it
registers and holds them against the port's section of ``README.md``
(from "## PyTorch/CUDA port" on), where the port's metric table lives.
"""

import ast
import pathlib
import re

import pytest

import ray_tpu_torch
import torch_obs_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "metrics", tmp_path_factory)


def test_counter_gauge_histogram(results):
    (negative_raises, route_a, temperature, buckets, count, typed,
     series) = same_result(results, "counter_gauge_histogram")
    assert negative_raises           # inc(-1) raises ValueError
    assert route_a
    assert temperature == 21.5
    assert buckets == (1, 2, 3)      # le 0.1, 1.0, +Inf
    assert count == 3
    assert typed and series


def test_metrics_report_to_gcs(results):
    assert same_result(results, "metrics_report_to_gcs") == (True, True)


def test_dashboard_rest(results):
    (n_nodes, alive, cpus, html, nodes_alive, cpu_total, logs,
     stacks, workers) = same_result(results, "dashboard_rest")
    assert n_nodes == 1 and alive
    assert cpus == 4.0
    assert html
    assert nodes_alive and cpu_total
    assert logs and stacks and workers


def test_node_hardware_reporter(results):
    """Per-node reporter samples flow heartbeat -> GCS -> nodes API +
    /metrics gauges."""
    got = same_result(results, "node_hardware_reporter")
    assert all(got), got


def test_scheduler_counters_in_prometheus(results):
    got = same_result(results, "scheduler_counters_in_prometheus")
    assert all(got), got


def test_prometheus_multiprocess_aggregation(results):
    """Counters sum; per-replica gauges do not collide (last write wins
    for one tag set); buckets stay cumulative; families contiguous."""
    got = same_result(results, "prometheus_multiprocess_aggregation")
    assert got[0], "a family's series interleaved"
    assert all(got[1:]), got


def test_multiprocess_counters_sum_on_metrics_endpoint(results):
    pushed, total, ra, rb = same_result(
        results, "multiprocess_counters_sum_on_metrics_endpoint")
    assert pushed == [True, True]
    assert total and ra and rb


def _registered_metric_names():
    """Every metric name registered in ray_tpu_torch/: constructor
    literals (Counter/Gauge/Histogram first args) plus the dashboard
    head's builtin gauge/counter names."""
    root = pathlib.Path(ray_tpu_torch.__file__).parent
    names = set()
    for path in root.rglob("*.py"):
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            base = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if base in ("Counter", "Gauge", "Histogram") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                names.add(node.args[0].value)
    head = (root / "dashboard" / "head.py").read_text()
    names |= set(re.findall(r'"((?:ray_tpu|scheduler)_[a-z0-9_]+)"',
                            head))
    return names


def test_readme_metric_table_covers_registered_metrics():
    """Docs-drift guard: every metric name the port registers appears in
    the README's port section."""
    readme = (pathlib.Path(ray_tpu_torch.__file__).parent.parent /
              "README.md").read_text()
    port_section = readme[readme.index("## PyTorch/CUDA port"):]
    names = _registered_metric_names()
    assert "ray_tpu_node_gpus_free" in names, "scanner broken?"
    missing = sorted(n for n in names if f"`{n}`" not in port_section)
    assert not missing, (
        f"metrics registered in ray_tpu_torch/ but missing from the "
        f"README's port metric table: {missing}")


def test_mirrors_every_reference_test():
    assert_mirrored("metrics_dashboard")
