"""Cluster CLI of the port's runtime (the counterpart of
``ray_tpu/scripts/cli.py``; reference: ``python/ray/scripts/scripts.py`` —
``ray start/stop/status`` + state CLI ``experimental/state/state_cli.py``).

Usage: ``python -m ray_tpu_torch <command>``
  start --head [--num-cpus N] [--num-gpus N] [--port P]
  stop                                    # ends the head, waits for it
  up CONFIG | down                        # a cluster from a YAML config
  status  [--address ADDR]
  list    {tasks|actors|nodes|objects|jobs|placement-groups}
  summary tasks
  timeline [--output FILE]
  stack   [--node PREFIX] [--timeout S]   # in-band cluster-wide stacks
  logs    [WORKER|ACTOR] [--lines N] [-f] # per-worker log fan-in / follow
  profile [--duration S] [--hz N]         # cluster-wide flamegraphs

The head's pid, address and log, and a launched cluster's, live in the
port's own directory under the temp dir (``$TMPDIR/ray_tpu_torch``), as
its sessions do. A command that reads the cluster connects to
``--address``, else ``RAY_TPU_TORCH_ADDRESS``, else the head's address
file.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
_PID_FILE = os.path.join(_DIR, "head.pid")
_ADDR_FILE = os.path.join(_DIR, "head.addr")
_UP_PID_FILE = os.path.join(_DIR, "up.pid")
_UP_ADDR_FILE = os.path.join(_DIR, "up.addr")
# How long ``stop`` and ``down`` wait for the daemon to tear its cluster
# down (its node manager ends every worker and zygote first).
_STOP_TIMEOUT_S = 60.0


def _read(path: str) -> str:
    with open(path) as f:
        return f.read().strip()


def _unlink(*paths: str) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _connect(address: str | None):
    import ray_tpu_torch

    from ray_tpu_torch._private.config import config

    addr = address or config.refresh_from_env("address")
    if not addr and os.path.exists(_ADDR_FILE):
        addr = _read(_ADDR_FILE)
    if not addr:
        raise SystemExit("no cluster address: pass --address, set "
                         "RAY_TPU_TORCH_ADDRESS, or run `python -m "
                         "ray_tpu_torch start --head`")
    # A verb prints what it was asked for: the workers' own output stays
    # in their logs (``logs`` reads it there), not echoed here as well.
    ray_tpu_torch.init(address=addr, log_to_driver=False)
    return ray_tpu_torch


def _daemonize(pid_file: str, addr_file: str, log_name: str,
               what: str, timeout_s: float, start, on_ready) -> int:
    """Fork a daemon that runs ``start()`` (returning an object with
    ``address`` and ``shutdown()``) until SIGTERM. The parent waits for
    the daemon's address file and calls ``on_ready(address)``. The daemon
    detaches from the caller's session and stdio: workers and daemons
    inherit its fds, so its output goes to ``<dir>/<log_name>``."""
    if os.path.exists(pid_file):
        pid = int(_read(pid_file))
        if _alive(pid):
            addr = _read(addr_file) if os.path.exists(addr_file) else "?"
            print(f"{what} already running (pid {pid}, address {addr})")
            return 1
        _unlink(pid_file)
    # A stale addr file from a crashed daemon must not satisfy the
    # readiness poll below — only the child's fresh write counts.
    _unlink(addr_file)
    os.makedirs(_DIR, exist_ok=True)

    log_path = os.path.join(_DIR, log_name)
    pid = os.fork()
    if pid > 0:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if os.path.exists(addr_file):
                on_ready(_read(addr_file))
                return 0
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                print(f"{what} failed to start (log: {log_path})",
                      file=sys.stderr)
                return 1
            time.sleep(0.2)
        print(f"{what} did not come up within {timeout_s:.0f}s (log: "
              f"{log_path})", file=sys.stderr)
        return 1

    os.setsid()
    log_fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    null_fd = os.open(os.devnull, os.O_RDONLY)
    os.dup2(null_fd, 0)
    os.dup2(log_fd, 1)
    os.dup2(log_fd, 2)
    os.close(null_fd)
    os.close(log_fd)
    rc = 0
    try:
        running = start()
        with open(pid_file, "w") as f:
            f.write(str(os.getpid()))
        tmp = addr_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(running.address)
        os.replace(tmp, addr_file)
        stop = {"flag": False}

        def on_term(sig, frame):
            stop["flag"] = True

        signal.signal(signal.SIGTERM, on_term)
        while not stop["flag"]:
            time.sleep(0.5)
            if getattr(running, "watch", None) is not None and \
                    not running.watch():
                break
        running.shutdown()
    except BaseException:  # noqa: BLE001 (the daemon's last word, logged)
        import traceback

        traceback.print_exc()
        rc = 1
    finally:
        _unlink(pid_file, addr_file)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)


class _Head:
    """A head cluster in the daemon: the GCS in its own subprocess, and the
    head node manager. ``watch`` respawns a GCS
    child that died, on the same port and session directory: the node
    manager and attached drivers redial with backoff and recover."""

    def __init__(self, args):
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.config import config as _cfg

        _cfg.set("gcs_out_of_process", True)
        self.cluster = worker_mod._LocalCluster(
            args.num_cpus, args.num_gpus, None,
            args.object_store_memory, None, port=args.port)
        self.address = self.cluster.address

    def watch(self) -> bool:
        cluster = self.cluster
        if cluster.gcs_proc is None or cluster.gcs_proc.alive():
            return True
        from ray_tpu_torch._private.gcs_launcher import (
            GcsLaunchError, GcsProcess,
        )

        port = int(cluster.address.rsplit(":", 1)[1])
        print(f"gcs subprocess died (rc={cluster.gcs_proc.poll()}); "
              f"respawning on port {port}", file=sys.stderr)
        try:
            cluster.gcs_proc = GcsProcess(
                session_dir=cluster.session_dir, port=port)
        except GcsLaunchError as e:
            print(f"gcs respawn failed: {e}", file=sys.stderr)
            return False
        return True

    def shutdown(self):
        self.cluster.shutdown()


def cmd_start(args) -> int:
    """Start a standalone head node that outlives this command
    (reference: ``ray start --head`` spawning gcs_server+raylet;
    services.py:1273). The GCS runs as its OWN subprocess by default
    (the reference's gcs_server topology — its handler concurrency
    never competes with the head node manager for one GIL)."""

    def ready(addr):
        print(f"ray_tpu_torch head started at {addr}")
        print(f"connect with ray_tpu_torch.init(address='{addr}') or "
              f"RAY_TPU_TORCH_ADDRESS={addr}")

    return _daemonize(_PID_FILE, _ADDR_FILE, "head.log", "head", 30.0,
                      lambda: _Head(args), ready)


def cmd_up(args) -> int:
    """Launch a cluster from a YAML config — head + autoscaler + node
    provider (reference: ``ray up``, autoscaler/_private/commands.py)."""
    from ray_tpu_torch.autoscaler.cluster_launcher import (
        launch_cluster, load_cluster_config,
    )

    config = load_cluster_config(args.config)

    def ready(addr):
        print(f"cluster '{config.get('cluster_name', '?')}' up at {addr}")
        print(f"connect with ray_tpu_torch.init(address='{addr}')")

    return _daemonize(_UP_PID_FILE, _UP_ADDR_FILE, "up.log", "cluster",
                      60.0, lambda: launch_cluster(config), ready)


def _stop_daemon(pid_file: str, addr_file: str, what: str) -> int:
    """SIGTERM the daemon of ``pid_file`` and wait until it has exited
    (it tears its cluster down first)."""
    if not os.path.exists(pid_file):
        print(f"no {what} running")
        return 0
    pid = int(_read(pid_file))
    try:
        os.kill(pid, signal.SIGTERM)
    except OSError as e:
        print(f"{what} pid {pid} not running ({e})")
        _unlink(pid_file, addr_file)
        return 0
    deadline = time.time() + _STOP_TIMEOUT_S
    while time.time() < deadline and _alive(pid):
        time.sleep(0.1)
    if _alive(pid):
        print(f"{what} pid {pid} still running after "
              f"{_STOP_TIMEOUT_S:.0f}s", file=sys.stderr)
        return 1
    _unlink(pid_file, addr_file)
    print(f"stopped {what} (pid {pid})")
    return 0


def cmd_down(args) -> int:
    """Tear down an `up`-launched cluster (reference: ``ray down``)."""
    return _stop_daemon(_UP_PID_FILE, _UP_ADDR_FILE, "cluster")


def cmd_stop(args) -> int:
    """End the head started by ``start --head`` and wait until its
    daemon, and with it every process of its session, is gone."""
    return _stop_daemon(_PID_FILE, _ADDR_FILE, "head")


def format_stack_report(nodes: list) -> str:
    """Render the collect_stacks fan-in (list of per-node dicts) as the
    text report ``ray_tpu_torch stack`` prints."""
    lines = []
    for node in nodes:
        nid = (node.get("node_id") or "?")[:12]
        if node.get("error"):
            lines.append(f"=== node {nid}: ERROR {node['error']}")
            continue
        lines.append(f"=== node {nid} "
                     f"({len(node.get('workers') or [])} workers)")
        for w in node.get("workers") or []:
            who = f"worker {w.get('worker_id', '?')[:12]} " \
                  f"pid={w.get('pid')}"
            if w.get("actor_id"):
                who += f" actor={w['actor_id'][:12]}"
            if w.get("current_task_id"):
                who += f" task={w['current_task_id'][:12]}"
            if w.get("error"):
                lines.append(f"--- {who}: ERROR {w['error']}")
                continue
            lines.append(f"--- {who}")
            for t in w.get("threads") or []:
                lines.append(f"  thread {t.get('thread_name') or ''} "
                             f"({t.get('thread_id')}):")
                for ln in (t.get("stack") or "").splitlines():
                    lines.append(f"    {ln}")
    return "\n".join(lines)


def cmd_stack(args) -> int:
    """Snapshot every worker's Python stacks cluster-wide, in-band
    (reference: ``ray stack``): the per-node agents fan a dump_stacks
    RPC to each worker's socket listener thread and the frames come
    back as data — a rank wedged inside a collective is diagnosable in
    one bounded command, no SIGUSR2, no log scraping."""
    rt = _connect(args.address)
    from ray_tpu_torch._private import worker as worker_mod

    payload = {"timeout_s": args.timeout}
    if args.node:
        payload["node_id"] = args.node
    try:
        nodes = worker_mod.require_worker().gcs.request(
            "collect_stacks", payload, timeout=args.timeout + 15)
        print(format_stack_report(nodes))
    finally:
        rt.shutdown()
    return 0


def cmd_logs(args) -> int:
    """Tail a worker's (or actor's) stdout/stderr cluster-wide
    (reference: ``ray logs``): the head fans the request to the
    per-node agents, which read the session log files — including for
    workers that already died. ``-f`` follows with ``tail -f``
    semantics (bounded poll loop over agent byte-offset cursors;
    Ctrl-C exits cleanly)."""
    rt = _connect(args.address)
    from ray_tpu_torch._private import worker as worker_mod

    if args.follow:
        from ray_tpu_torch.experimental import state

        gen = state.get_log(ident=args.target, stream=args.stream,
                            lines=args.lines, follow=True,
                            interval_s=args.interval)
        try:
            for entry in gen:
                who = f"{entry['worker_id'][:12]}/{entry['stream']}"
                for ln in entry.get("lines") or []:
                    print(f"({who}) {ln}", flush=True)
        except KeyboardInterrupt:
            pass   # clean Ctrl-C: stop following, exit 0
        finally:
            gen.close()
            rt.shutdown()
        return 0

    payload: dict = {"lines": args.lines}
    if args.target:
        payload["id"] = args.target
    if args.stream:
        payload["stream"] = args.stream
    try:
        nodes = worker_mod.require_worker().gcs.request(
            "agent_logs", payload, timeout=30)
        shown = 0
        for node in nodes:
            if isinstance(node, dict) and node.get("error"):
                print(f"=== node {node.get('node_id', '?')[:12]}: "
                      f"ERROR {node['error']}", file=sys.stderr)
                continue
            for entry in node if isinstance(node, list) else []:
                head = (f"=== {entry['stream']} of worker "
                        f"{entry['worker_id'][:12]}")
                if entry.get("actor_id"):
                    head += f" (actor {entry['actor_id'][:12]})"
                head += f" on node {entry['node_id'][:12]}"
                print(head)
                for ln in entry["lines"]:
                    print(ln)
                shown += 1
        if not shown:
            print("no matching worker logs", file=sys.stderr)
            return 1
    finally:
        rt.shutdown()
    return 0


def cmd_profile(args) -> int:
    """Cluster-wide sampling profile (reference: the dashboard's
    per-worker py-spy verb, ``ray_tpu_torch``-style: in-band, no ptrace):
    one bounded window across every process — workers, drivers, node
    managers, the GCS subprocess — merged into ONE speedscope document
    (or folded flamegraph lines) covering the whole cluster."""
    rt = _connect(args.address)
    from ray_tpu_torch._private import profiler
    from ray_tpu_torch.experimental import state

    try:
        processes = state.profile(
            duration_s=args.duration, hz=args.hz, mode=args.mode,
            node_id=args.node, worker_id=args.worker,
            actor_id=args.actor, driver=args.driver, gcs=args.gcs)
        errors = [p for p in processes
                  if isinstance(p, dict) and p.get("error")]
        ok = [p for p in processes
              if isinstance(p, dict) and not p.get("error")]
        for p in errors:
            print(f"profile error ({p.get('kind', '?')} "
                  f"{p.get('node_id') or p.get('client_id') or ''}): "
                  f"{p['error']}", file=sys.stderr)
        if not ok:
            print("no profiles captured", file=sys.stderr)
            return 1
        # With profiler_always_on every process already samples, and the
        # window reads its running sampler instead of starting one.
        started = sum(1 for p in ok if p.get("sampler_started"))
        print(f"sampler already running in {len(ok) - started} of "
              f"{len(ok)} processes", file=sys.stderr)
        if args.format == "folded":
            out = "\n".join(profiler.folded_lines(ok)) + "\n"
            if args.output:
                with open(args.output, "w") as f:
                    f.write(out)
                print(f"wrote folded profile of {len(ok)} processes "
                      f"to {args.output}")
            else:
                sys.stdout.write(out)
        else:
            doc = profiler.speedscope_document(
                ok, name=f"ray_tpu_torch cluster profile "
                         f"({args.duration:g}s @ {args.hz or 'default'}"
                         f"Hz, {args.mode})")
            path = args.output or \
                f"profile-{int(time.time())}.speedscope.json"
            with open(path, "w") as f:
                json.dump(doc, f)
            print(f"wrote merged speedscope profile of {len(ok)} "
                  f"processes ({len(doc['profiles'])} threads) to "
                  f"{path}")
            print("open at https://www.speedscope.app/ or `speedscope "
                  f"{path}`")
    finally:
        rt.shutdown()
    return 0


def format_gcs_process_line(stats: dict) -> str:
    """One-line GCS process health from control_plane_stats."""
    gp = stats.get("gcs_process") or {}
    where = "own process" if gp.get("out_of_process") else "in-process"
    rss = gp.get("rss_bytes")
    rss_s = f"{rss / (1 << 20):.0f} MiB" if rss else "?"
    cpu = gp.get("cpu_percent")
    cpu_s = f"{cpu:g}%" if cpu is not None else "?"
    return (f"gcs: pid {gp.get('pid', '?')} ({where}) rss {rss_s} "
            f"cpu {cpu_s} listener-threads "
            f"{gp.get('listener_threads', '?')} "
            f"outbox {gp.get('outbox_depth', '?')}")


def cmd_status(args) -> int:
    rt = _connect(args.address)
    from ray_tpu_torch._private import worker as worker_mod

    nodes = rt.nodes()
    total = rt.cluster_resources()
    avail = rt.available_resources()
    print(f"nodes: {sum(1 for n in nodes if n['Alive'])} alive / "
          f"{len(nodes)} total")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g} / {total[k]:g} available")
    try:
        stats = worker_mod.require_worker().gcs.request(
            "control_plane_stats", timeout=30)
        print(format_gcs_process_line(stats))
        print(f"control plane: {stats.get('queued_tasks', 0)} queued / "
              f"{stats.get('running_tasks', 0)} running tasks, "
              f"{stats.get('actors', 0)} actors, "
              f"{stats.get('leases', 0)} leases")
    except Exception as e:
        print(f"gcs: stats unavailable ({e})", file=sys.stderr)
    rt.shutdown()
    return 0


def cmd_list(args) -> int:
    rt = _connect(args.address)
    from ray_tpu_torch.experimental import state

    fns = {
        "tasks": state.list_tasks,
        "actors": state.list_actors,
        "nodes": state.list_nodes,
        "objects": state.list_objects,
        "jobs": state.list_jobs,
        "placement-groups": state.list_placement_groups,
    }
    try:
        rows = fns[args.resource](limit=args.limit)
        print(json.dumps(rows, indent=2, default=repr))
    finally:
        rt.shutdown()
    return 0


def cmd_summary(args) -> int:
    rt = _connect(args.address)
    from ray_tpu_torch.experimental import state

    try:
        print(json.dumps(state.summarize_tasks(), indent=2))
    finally:
        rt.shutdown()
    return 0


def build_chrome_trace(events: list) -> list:
    """Chrome-trace records from task events/spans: one complete ("X")
    slice per event, plus flow-event pairs ("s"/"f") binding each child
    span to its parent — chrome://tracing / Perfetto then draw the
    submit → lease → run → collective → KV-handoff chain as one
    connected trace instead of unrelated slices."""
    by_span = {ev["span_id"]: ev for ev in events if ev.get("span_id")}

    def _loc(ev):
        return {"pid": (ev.get("node_id") or "")[:8],
                "tid": ev.get("pid", 0)}

    trace = []
    for ev in events:
        trace.append({
            "name": ev["name"], "cat": ev.get("kind", "task"), "ph": "X",
            "ts": ev["start"] * 1e6,
            "dur": (ev["end"] - ev["start"]) * 1e6,
            **_loc(ev),
            "args": {"status": ev.get("status"),
                     "trace_id": ev.get("trace_id"),
                     "span_id": ev.get("span_id"),
                     "parent_span_id": ev.get("parent_span_id")},
        })
        parent = by_span.get(ev.get("parent_span_id"))
        if parent is None or not ev.get("span_id"):
            continue
        flow = {"name": "trace", "cat": ev.get("trace_id") or "trace",
                "id": ev["span_id"]}
        # Flow start binds inside the parent slice; flow finish binds
        # at the child slice's start (bp=e: enclosing-slice binding).
        trace.append({**flow, "ph": "s", **_loc(parent),
                      "ts": parent["start"] * 1e6})
        trace.append({**flow, "ph": "f", "bp": "e", **_loc(ev),
                      "ts": ev["start"] * 1e6})
    return trace


def cmd_timeline(args) -> int:
    """Chrome-trace export (reference: ``ray timeline`` — chrome://tracing
    format from GCS task events)."""
    rt = _connect(args.address)
    try:
        trace = build_chrome_trace(rt.timeline())
    finally:
        rt.shutdown()
    out = args.output or "timeline.json"
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace)} events to {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch",
        description="Start, stop and inspect a ray_tpu_torch cluster.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start")
    p.add_argument("--head", action="store_true", required=True)
    p.add_argument("--num-cpus", type=int, default=None)
    p.add_argument("--num-gpus", type=int, default=None,
                   help="GPUs the head schedules (default: the GPUs this "
                        "host shows)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--object-store-memory", type=int, default=None)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("up")
    p.add_argument("config")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("stack")
    p.add_argument("--address", default=None)
    # All nodes is the default scope; --node narrows it.
    p.add_argument("--node", default=None,
                   help="restrict to one node id (hex prefix)")
    p.add_argument("--timeout", type=float, default=5.0)
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser("logs")
    p.add_argument("target", nargs="?", default=None,
                   help="worker or actor id (hex prefix); omit for all")
    p.add_argument("--lines", type=int, default=100)
    p.add_argument("--stream", choices=["stdout", "stderr"], default=None)
    p.add_argument("-f", "--follow", action="store_true",
                   help="tail -f semantics: keep polling the agents "
                        "for new lines until Ctrl-C")
    p.add_argument("--interval", type=float, default=None,
                   help="follow poll interval in seconds "
                        "(default: 1.0)")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("profile")
    p.add_argument("--duration", type=float, default=10.0,
                   help="profile window in seconds (default 10)")
    p.add_argument("--hz", type=float, default=None,
                   help="sampling rate (default: profiler_hz)")
    p.add_argument("--mode", choices=["wall", "cpu"], default="wall")
    p.add_argument("--format", choices=["folded", "speedscope"],
                   default="speedscope")
    p.add_argument("--output", "-o", default=None,
                   help="output path (speedscope default: "
                        "profile-<ts>.speedscope.json; folded default: "
                        "stdout)")
    p.add_argument("--node", default=None,
                   help="restrict to one node id (hex prefix)")
    p.add_argument("--worker", default=None,
                   help="restrict to one worker id (hex prefix)")
    p.add_argument("--actor", default=None,
                   help="restrict to one actor id (hex prefix)")
    p.add_argument("--driver", action="store_true",
                   help="profile only connected driver processes")
    p.add_argument("--gcs", action="store_true",
                   help="profile only the GCS-hosting process")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("status")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list")
    p.add_argument("resource", choices=["tasks", "actors", "nodes",
                                        "objects", "jobs",
                                        "placement-groups"])
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("summary")
    p.add_argument("what", choices=["tasks"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("timeline")
    p.add_argument("--output", default=None)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_timeline)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
