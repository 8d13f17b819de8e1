"""Carry the JAX package's RL state over to the port.

Each function takes the reference's state as numpy (for example
``jax.tree.map(np.asarray, learner.get_state())``) and returns it in the
form the port's ``set_state`` / ``set_weights`` take. Param pytrees become
``{name: tensor}`` under the port's module names: ``{"trunk": [{"w", "b"},
...], "pi": ..., "v": ...}`` becomes ``trunk.0.w``, ..., ``pi.w``, ``v.b``,
and SAC's ``actor`` / ``q1`` / ``q2`` lists likewise. optax's Adam state
(``ScaleByAdamState``: ``count``, ``mu``, ``nu``, inside the tuple of
``optax.adam``'s chain) becomes torch Adam's per-param ``step``,
``exp_avg`` and ``exp_avg_sq``. ``flat_to_port`` reorders a
``ravel_pytree`` vector into the port's ``parameters_to_vector`` order.
Reads attributes only, so it needs neither jax nor optax.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Leaves of nested dicts and lists by dotted path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def jax_leaf_order(tree: Any, prefix: str = "") -> List[Tuple[str, tuple]]:
    """(dotted path, shape) of each leaf in the order jax flattens
    ``tree``: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, np.shape(tree))]
    out: List[Tuple[str, tuple]] = []
    for k, v in items:
        out += jax_leaf_order(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def flat_to_port(flat: np.ndarray, tree: Any,
                 names: Sequence[str]) -> np.ndarray:
    """``flat``, a ``ravel_pytree`` vector of a pytree shaped as ``tree``,
    in the order of ``names`` (the port's parameter names, the order its
    ``parameters_to_vector`` takes)."""
    parts, off = {}, 0
    for name, shape in jax_leaf_order(tree):
        n = int(np.prod(shape))
        parts[name] = np.asarray(flat)[off:off + n]
        off += n
    if off != np.size(flat):
        raise ValueError(f"flat vector has {np.size(flat)} values, the "
                         f"tree {off}")
    return np.concatenate([parts[n] for n in names])


def params(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """An MLPPolicy (trunk/pi/v), DQN target or SAC (actor/q1/q2) params
    pytree as float32 CPU tensors by the port's names."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in flatten(tree, prefix).items()}


def _scale_by_adam(opt_state: Any):
    """The ``ScaleByAdamState`` inside an optax state (a NamedTuple with
    ``count``, ``mu``, ``nu``, possibly nested in the chain's tuple)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for s in opt_state:
            found = _scale_by_adam(s)
            if found is not None:
                return found
    return None


def adam(opt_state: Any, prefix: str = "") -> Dict[str, dict]:
    """optax.adam's state -> ``{name: {"step", "exp_avg", "exp_avg_sq"}}``
    (``prefix`` names a bare leaf, such as SAC's ``log_alpha``)."""
    st = _scale_by_adam(opt_state)
    if st is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the state")
    mu, nu = params(st.mu, prefix), params(st.nu, prefix)
    step = float(np.asarray(st.count))
    return {name: {"step": step, "exp_avg": mu[name],
                   "exp_avg_sq": nu[name]} for name in mu}


def learner_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A ``Learner.get_state()`` of the reference (PPO, A2C, IMPALA, BC;
    DQN's also carries ``target_params`` and ``num_updates``)."""
    out = {"params": params(state["params"]),
           "opt_state": adam(state["opt_state"])}
    if "target_params" in state:
        out["target_params"] = params(state["target_params"])
        out["num_updates"] = int(state["num_updates"])
    return out


def sac_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A ``SACLearner.get_state()`` of the reference."""
    return {"params": params(state["params"]),
            "target": params(state["target"]),
            "opt_state": adam(state["opt_state"]),
            "log_alpha": torch.tensor(float(np.asarray(state["log_alpha"]))),
            "alpha_opt_state": adam(state["alpha_opt_state"], "log_alpha")}
