"""Runtime environments: working_dir + py_modules shipped through the GCS
KV with content-addressed URI caching.

Reference: ``python/ray/_private/runtime_env/plugin.py:24`` (plugin
protocol), ``working_dir.py`` / ``py_modules.py`` plugins, and
``packaging.py`` (zip + content hash + GCS upload with
``gcs://_ray_pkg_<hash>.zip`` URIs). Here the package store is the GCS KV
(namespace ``_runtime_env``), the URI scheme is ``kvzip://<sha1>``, and
nodes extract each URI once into the session's ``runtime_resources``
directory (the URI cache).
"""

from __future__ import annotations

import hashlib
import io
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

KV_NAMESPACE = "_runtime_env"


class RuntimeEnvPlugin:
    """Extension seam for new runtime_env keys (reference:
    ``python/ray/_private/runtime_env/plugin.py:24,116`` — conda/pip/
    container/working_dir are all plugins behind this protocol there).

    A plugin owns one ``runtime_env`` key. Driver side, ``package``
    rewrites the value into something shippable (e.g. upload a local
    path to the GCS KV and return a URI). Node side, ``create``
    materializes it and mutates the worker context: extra env vars,
    sys.path entries, or the working dir. pip/conda/container support
    plugs in here — this build gates them off (no package egress in the
    target environment), but the seam is the reference-parity surface.
    """

    name: str = ""
    priority: int = 10   # lower runs first (reference plugin priority)

    def package(self, value: Any, kv) -> Any:
        """Driver side: make the value location-independent."""
        return value

    def needs_isolation(self, value: Any) -> bool:
        """True (default) if workers need a dedicated process for this
        env. ``create()`` only runs on the isolated-worker path — return
        False ONLY for plugins with no per-worker materialization at all
        (driver-side ``package`` effects only)."""
        return True

    def create(self, value: Any, context: Dict[str, Any],
               base_dir: str) -> None:
        """Node side: materialize; mutate ``context`` —
        {"env_vars": {}, "py_paths": [], "working_dir": None}."""


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin needs a name (its runtime_env key)")
    _PLUGINS[plugin.name] = plugin


def unregister_plugin(name: str) -> None:
    _PLUGINS.pop(name, None)


def _sorted_plugins():
    return sorted(_PLUGINS.values(), key=lambda p: p.priority)
URI_SCHEME = "kvzip://"
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
_MAX_PACKAGE_BYTES = 256 * 1024 * 1024

# Per-process upload memo: path -> (tree stamp, uri). Submitting N tasks
# with the same working_dir zips it once, not N times (reference:
# packaging.py upload cache keyed by package URI).
_upload_memo: Dict[str, Tuple[Any, str]] = {}


def _tree_stamp(path: str):
    """Cheap change detector: (count, total size, max mtime_ns) over the
    walked tree — no file contents read."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        st = os.stat(path)
        return (1, st.st_size, st.st_mtime_ns)
    n = size = latest = 0
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for f in files:
            if f.endswith(".pyc"):
                continue
            try:
                st = os.stat(os.path.join(root, f))
            except OSError:
                continue
            n += 1
            size += st.st_size
            latest = max(latest, st.st_mtime_ns)
    return (n, size, latest)


def _zip_path(path: str) -> bytes:
    """Deterministic zip of a directory (or single file) — stable entry
    order + fixed timestamps so equal content hashes equal."""
    buf = io.BytesIO()
    path = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            entries = [(os.path.basename(path), path)]
        else:
            entries = []
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
                for f in sorted(files):
                    if f.endswith(".pyc"):
                        continue
                    full = os.path.join(root, f)
                    entries.append((os.path.relpath(full, path), full))
        total = 0
        for arcname, full in entries:
            with open(full, "rb") as fh:
                data = fh.read()
            total += len(data)
            if total > _MAX_PACKAGE_BYTES:
                raise ValueError(
                    f"runtime_env package {path} exceeds "
                    f"{_MAX_PACKAGE_BYTES >> 20} MiB")
            info = zipfile.ZipInfo(arcname, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
            zf.writestr(info, data)
    return buf.getvalue()


def _module_zip(path: str) -> bytes:
    """Zip a python module so it extracts as an importable top-level name:
    a package dir ``.../mymod`` lands as ``mymod/...``; a file
    ``.../util.py`` lands as ``util.py``."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        return _zip_path(path)
    buf = io.BytesIO()
    base = os.path.basename(path.rstrip("/"))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
            for f in sorted(files):
                if f.endswith(".pyc"):
                    continue
                full = os.path.join(root, f)
                arc = os.path.join(base, os.path.relpath(full, path))
                info = zipfile.ZipInfo(arc, date_time=(1980, 1, 1, 0, 0, 0))
                with open(full, "rb") as fh:
                    zf.writestr(info, fh.read())
    return buf.getvalue()


def _upload(kv, blob: bytes) -> str:
    h = hashlib.sha1(blob).hexdigest()
    key = h.encode()
    # Content-addressed: identical content uploads once cluster-wide.
    if not kv.exists(key, namespace=KV_NAMESPACE):
        kv.put(key, blob, namespace=KV_NAMESPACE)
    return URI_SCHEME + h


def package_runtime_env(kv, runtime_env: Optional[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """Driver side: replace local working_dir / py_modules paths with
    content-addressed KV URIs (reference: packaging.py upload_package_
    if_needed). Already-URI entries pass through untouched."""
    if not runtime_env:
        return runtime_env
    env = dict(runtime_env)

    def cached_upload(path: str, zipper) -> str:
        key = os.path.abspath(path)
        stamp = _tree_stamp(key)
        memo = _upload_memo.get(key)
        if memo is not None and memo[0] == stamp:
            return memo[1]
        uri = _upload(kv, zipper(path))
        _upload_memo[key] = (stamp, uri)
        return uri

    wd = env.get("working_dir")
    if wd and not wd.startswith(URI_SCHEME):
        if not os.path.isdir(wd):
            raise ValueError(f"runtime_env working_dir {wd!r} is not a "
                             f"directory")
        env["working_dir"] = cached_upload(wd, _zip_path)
    mods = env.get("py_modules")
    if mods:
        out: List[str] = []
        for m in mods:
            if isinstance(m, str) and m.startswith(URI_SCHEME):
                out.append(m)
                continue
            if not os.path.exists(m):
                raise ValueError(f"runtime_env py_module {m!r} not found")
            out.append(cached_upload(m, _module_zip))
        env["py_modules"] = out
    for plugin in _sorted_plugins():
        if plugin.name in env:
            env[plugin.name] = plugin.package(env[plugin.name], kv)
    return env


def needs_isolation(runtime_env: Optional[Dict[str, Any]]) -> bool:
    """True when this env requires a dedicated worker (cwd / sys.path)."""
    if not runtime_env:
        return False
    if runtime_env.get("working_dir") or runtime_env.get("py_modules"):
        return True
    return any(p.needs_isolation(runtime_env[p.name])
               for p in _sorted_plugins() if p.name in runtime_env)


class PipPlugin(RuntimeEnvPlugin):
    """``runtime_env={"pip": [...]}``: per-env virtualenv, content-cached
    by the hash of the requirement list (reference:
    ``python/ray/_private/runtime_env/pip.py`` — venv per pip spec,
    ``uri_cache.py`` content addressing).

    The venv is created with ``--system-site-packages`` (the cluster's
    baked-in jax/numpy stack stays visible) and its site-packages is
    PREPENDED to the worker's import path, so env-pinned versions shadow
    system ones. Workers with different pip envs are separate processes
    (``needs_isolation``), so two tasks can import different versions of
    the same package concurrently.

    Value forms: ``["pkg==1.0", ...]`` or
    ``{"packages": [...], "pip_install_options": [...]}``.
    """

    name = "pip"
    priority = 5   # before plugins that may import from the env

    def package(self, value: Any, kv) -> Any:
        if isinstance(value, (list, tuple)):
            value = {"packages": list(value)}
        if not isinstance(value, dict) or not isinstance(
                value.get("packages", []), list):
            raise ValueError(f"runtime_env['pip'] must be a list of "
                             f"requirements or a dict, got {value!r}")
        return {"packages": [str(p) for p in value.get("packages", [])],
                "pip_install_options":
                    [str(o) for o in value.get("pip_install_options", [])]}

    def create(self, value: Any, context: Dict[str, Any],
               base_dir: str) -> None:
        import fcntl
        import json
        import subprocess
        import sys as _sys

        if isinstance(value, (list, tuple)):
            value = {"packages": list(value)}
        packages = value.get("packages", [])
        options = value.get("pip_install_options", [])
        spec = json.dumps({"packages": packages, "options": options},
                          sort_keys=True)
        h = hashlib.sha1(spec.encode()).hexdigest()
        root = os.path.join(base_dir, "pip")
        os.makedirs(root, exist_ok=True)
        venv_dir = os.path.join(root, h)
        ready = os.path.join(venv_dir, ".ready")
        # Cross-process lock: concurrent tasks wanting the same env build
        # it once (reference: uri_cache single-flight).
        with open(os.path.join(root, h + ".lock"), "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            if not os.path.exists(ready):
                import venv as venv_mod

                venv_mod.create(venv_dir, system_site_packages=True,
                                with_pip=False, symlinks=True)
                if packages:
                    # Install with the CURRENT interpreter targeting the
                    # venv's site-packages: avoids needing pip bootstrapped
                    # inside the venv and works offline for local wheels.
                    proc = subprocess.run(
                        [_sys.executable, "-m", "pip", "install", "-q",
                         "--target", self._site_packages(venv_dir),
                         *options, *packages],
                        capture_output=True, text=True, timeout=600)
                    if proc.returncode != 0:
                        import shutil

                        shutil.rmtree(venv_dir, ignore_errors=True)
                        raise RuntimeError(
                            f"pip install failed (rc={proc.returncode}): "
                            f"{(proc.stderr or '')[-800:]}")
                with open(ready, "w") as f:
                    f.write(spec)
        context["env_vars"]["VIRTUAL_ENV"] = venv_dir
        # Prepend: env-pinned versions shadow system site-packages.
        context["py_paths"].insert(0, self._site_packages(venv_dir))

    @staticmethod
    def _site_packages(venv_dir: str) -> str:
        import sys as _sys

        return os.path.join(
            venv_dir, "lib",
            f"python{_sys.version_info[0]}.{_sys.version_info[1]}",
            "site-packages")


register_plugin(PipPlugin())


def ensure_runtime_env(kv_get, runtime_env: Optional[Dict[str, Any]],
                       base_dir: str
                       ) -> Tuple[Optional[str], List[str],
                                  Dict[str, str]]:
    """Node side: materialize each URI once under ``base_dir/<hash>/``
    (the URI cache) and return (working_dir, py_paths, plugin_env_vars).

    ``kv_get(key: bytes) -> Optional[bytes]`` fetches from the GCS KV
    namespace ``_runtime_env``.
    """
    if not runtime_env:
        return None, [], {}

    def materialize(uri: str) -> str:
        h = uri[len(URI_SCHEME):]
        target = os.path.join(base_dir, h)
        if os.path.isdir(target):
            return target  # cache hit
        blob = kv_get(h.encode())
        if blob is None:
            raise RuntimeError(f"runtime_env package {uri} missing from GCS")
        tmp = target + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, target)  # atomic publish; loser cleans up
        except OSError:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
        return target

    workdir = None
    wd = runtime_env.get("working_dir")
    if wd and wd.startswith(URI_SCHEME):
        workdir = materialize(wd)
    paths = []
    for m in runtime_env.get("py_modules") or []:
        if isinstance(m, str) and m.startswith(URI_SCHEME):
            paths.append(materialize(m))
    context: Dict[str, Any] = {"env_vars": {}, "py_paths": paths,
                               "working_dir": workdir}
    for plugin in _sorted_plugins():
        if plugin.name in runtime_env:
            plugin.create(runtime_env[plugin.name], context, base_dir)
    return context["working_dir"], context["py_paths"], context["env_vars"]
