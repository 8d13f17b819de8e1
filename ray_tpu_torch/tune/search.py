"""Search-space primitives and variant generation (port of
``ray_tpu/tune/search.py``, pure Python: the same seed gives the same
draws; reference:
``tune/search/sample.py`` domains + ``tune/search/basic_variant.py:191``
``BasicVariantGenerator`` grid/random resolution)."""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class _Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class _Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class _LogUniform(Domain):
    def __init__(self, low, high):
        import math
        self._llow, self._lhigh = math.log(low), math.log(high)

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self._llow, self._lhigh))


class _Randint(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class _Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class _Grid:
    def __init__(self, values):
        self.values = list(values)


def grid_search(values: List[Any]) -> dict:
    """Exhaustive axis: the cross product of all grid axes is generated
    (reference: ``tune/search/variant_generator.py``)."""
    return {"grid_search": list(values)}


def choice(categories) -> Domain:
    return _Categorical(categories)


def uniform(low: float, high: float) -> Domain:
    return _Uniform(low, high)


def loguniform(low: float, high: float) -> Domain:
    return _LogUniform(low, high)


def randint(low: int, high: int) -> Domain:
    return _Randint(low, high)


def sample_from(fn: Callable) -> Domain:
    return _Function(fn)


class Searcher:
    """Model-based search seam (reference: ``tune/search/searcher.py``
    Searcher — suggest/on_trial_result/on_trial_complete). Implementations
    see every completed trial's objective and propose the next config;
    they compose with any trial scheduler (ASHA/PBT prune or mutate the
    trials the searcher proposed)."""

    def set_search_properties(self, metric: Optional[str], mode: str,
                              param_space: Dict[str, Any]) -> None:
        self.metric = metric
        self.mode = mode
        self.param_space = param_space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        """Intermediate result (optional hook)."""

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        """Terminal result — the observation model-based searchers learn
        from."""


def _flatten(space: Dict[str, Any], path=()):
    """Yield (path, Domain) leaves; constants pass through untouched."""
    for k, v in space.items():
        if isinstance(v, dict) and set(v.keys()) != {"grid_search"}:
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def _unflatten(flat: Dict[tuple, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


class TPESearcher(Searcher):
    """Native Tree-structured Parzen Estimator (the model behind
    hyperopt; reference adapter: ``tune/search/hyperopt/
    hyperopt_search.py`` — here the estimator itself is implemented, no
    external dependency).

    After ``n_initial`` random trials, completed observations are split
    at the ``gamma`` quantile into good/bad sets; per dimension,
    ``n_candidates`` samples drawn from the good-set density l(x) are
    scored by l(x)/g(x) and the maximizer wins — expected improvement
    under the two-density model. Numeric dims use a Parzen mixture of
    normals (log-space for loguniform); categoricals use smoothed
    count ratios."""

    def __init__(self, metric: Optional[str] = None, mode: str = "min",
                 n_initial: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        self.metric = metric
        assert mode in ("min", "max")
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self.param_space: Dict[str, Any] = {}
        self._suggested: Dict[str, Dict[tuple, Any]] = {}
        self._obs: List[tuple] = []   # (flat_config, objective[min-form])

    def set_search_properties(self, metric, mode, param_space):
        self.metric = metric or self.metric
        self.mode = mode or self.mode
        self.param_space = param_space

    # ------------------------------------------------------------ suggest

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        leaves = dict(_flatten(self.param_space))
        if len(self._obs) < self.n_initial:
            flat = {p: self._random(d) for p, d in leaves.items()}
        else:
            good, bad = self._split()
            flat = {}
            for p, d in leaves.items():
                flat[p] = self._suggest_dim(
                    d, [g[p] for g in good if p in g],
                    [b[p] for b in bad if p in b])
        self._suggested[trial_id] = flat
        return _unflatten(flat)

    def _random(self, domain):
        if isinstance(domain, Domain):
            return domain.sample(self.rng)
        if isinstance(domain, dict) and set(domain) == {"grid_search"}:
            return self.rng.choice(domain["grid_search"])
        return domain   # constant

    def _split(self):
        obs = sorted(self._obs, key=lambda o: o[1])
        k = max(1, int(len(obs) * self.gamma))
        return ([c for c, _ in obs[:k]], [c for c, _ in obs[k:]])

    def _suggest_dim(self, domain, good_vals, bad_vals):
        import math

        if not isinstance(domain, Domain) or isinstance(domain, _Function):
            return self._random(domain)
        if isinstance(domain, _Categorical):
            cats = domain.categories
            n = len(cats)

            def smoothed(vals):
                counts = {c: 1.0 for c in cats}   # +1 smoothing
                for v in vals:
                    counts[v] = counts.get(v, 1.0) + 1.0
                total = sum(counts.values())
                return {c: counts[c] / total for c in cats}

            lg, bg = smoothed(good_vals), smoothed(bad_vals)
            # Sample candidates from l, keep the best l/g ratio.
            weights = [lg[c] for c in cats]
            cands = self.rng.choices(cats, weights=weights,
                                     k=min(self.n_candidates, 4 * n))
            return max(cands, key=lambda c: lg[c] / bg[c])

        # Numeric: Parzen mixture over good observations.
        is_log = isinstance(domain, _LogUniform)
        is_int = isinstance(domain, _Randint)
        if is_log:
            lo, hi = domain._llow, domain._lhigh
            xform, inv = math.log, math.exp
        elif is_int:
            lo, hi = float(domain.low), float(domain.high - 1)
            xform, inv = float, lambda v: int(round(v))
        else:
            lo, hi = float(domain.low), float(domain.high)
            xform, inv = float, float
        if not good_vals:
            return self._random(domain)
        g_pts = sorted(xform(v) for v in good_vals)
        b_pts = sorted(xform(v) for v in bad_vals) or [(lo + hi) / 2]
        span = max(hi - lo, 1e-12)

        def pt_sigmas(pts):
            # hyperopt's adaptive Parzen bandwidth: each point's sigma is
            # the larger gap to its sorted neighbors, clipped — dense
            # clusters get narrow kernels (exploitation), isolated points
            # stay wide (exploration).
            n = len(pts)
            out = []
            for i, p in enumerate(pts):
                prev_d = p - pts[i - 1] if i > 0 else span
                next_d = pts[i + 1] - p if i < n - 1 else span
                out.append(min(max(max(prev_d, next_d),
                                   span / min(100.0, n + 2)), span))
            return out

        sg, sb = pt_sigmas(g_pts), pt_sigmas(b_pts)

        def density(x, pts, sigmas):
            # Uniform floor keeps g(x) > 0 and preserves exploration.
            s = 1.0 / span
            for m, sig in zip(pts, sigmas):
                s += math.exp(-0.5 * ((x - m) / sig) ** 2) / sig
            return s / (len(pts) + 1)

        best_x, best_score = None, -1.0
        for _ in range(self.n_candidates):
            i = self.rng.randrange(len(g_pts))
            x = min(max(self.rng.gauss(g_pts[i], sg[i]), lo), hi)
            score = density(x, g_pts, sg) / density(x, b_pts, sb)
            if score > best_score:
                best_x, best_score = x, score
        out = inv(best_x)
        if is_int:
            out = min(max(out, domain.low), domain.high - 1)
        return out

    # ---------------------------------------------------------- feedback

    def on_trial_complete(self, trial_id, result=None, error=False):
        flat = self._suggested.pop(trial_id, None)
        if flat is None or error or not result:
            return
        value = result.get(self.metric) if self.metric else None
        if value is None:
            return
        v = float(value) if self.mode == "min" else -float(value)
        self._obs.append((flat, v))


class BasicVariantGenerator:
    """Expand a param_space into concrete trial configs: grid axes cross
    multiplied, Domain leaves sampled ``num_samples`` times."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> List[Dict[str, Any]]:
        grid_axes: List[tuple] = []   # (key_path, values)
        self._find_grids(self.param_space, (), grid_axes)
        combos = [()] if not grid_axes else list(
            itertools.product(*(vals for _, vals in grid_axes)))
        out = []
        for _ in range(self.num_samples):
            for combo in combos:
                overrides = {path: v for (path, _), v
                             in zip(grid_axes, combo)}
                out.append(self._resolve(self.param_space, (), overrides))
        return out

    def _find_grids(self, node, path, acc):
        if isinstance(node, dict):
            if set(node.keys()) == {"grid_search"}:
                acc.append((path, node["grid_search"]))
                return
            for k, v in node.items():
                self._find_grids(v, path + (k,), acc)

    def _resolve(self, node, path, overrides):
        if path in overrides:
            return overrides[path]
        if isinstance(node, dict):
            if set(node.keys()) == {"grid_search"}:
                return overrides[path]
            return {k: self._resolve(v, path + (k,), overrides)
                    for k, v in node.items()}
        if isinstance(node, Domain):
            return node.sample(self.rng)
        return node
