"""``tests/test_tune_search.py`` on the port's ``ray_tpu_torch.tune``,
test by test.

TPE and HyperBand are pure Python: the three unit tests run their checks
on both ``tune`` packages here, with the reference's seeds, and hold that
the suggestions, wins and decisions are the same, and that the port's pass
the reference's bounds. The three Tuner tests run as programs of
``torch_cluster_programs``' "tune_search" group on a 4-CPU cluster of
each runtime (``ray_tpu`` in a fresh interpreter, then ``ray_tpu_torch``
here); their results must be equal and pass the same bounds.
"""

import importlib
import random

import pytest

import torch_cluster_programs as progs
from torch_mirror import assert_mirrored
from torch_runtimes import group_results, same_result

PACKAGES = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return group_results(progs, "tune_search", tmp_path_factory)


def _both(check):
    """``check(tune)`` on the reference's package, then on the port's;
    the two results must be equal."""
    ref, port = (check(importlib.import_module(f"{p}.tune"))
                 for p in PACKAGES)
    assert port == ref, (port, ref)
    return port


def test_tpe_concentrates_on_good_region():
    """Fed observations with a clear optimum, TPE's suggestions cluster
    near it (no cluster needed)."""
    def check(tune):
        s = tune.TPESearcher(metric="loss", mode="min", n_initial=0, seed=7)
        s.set_search_properties("loss", "min",
                                {"x": tune.uniform(0.0, 1.0),
                                 "c": tune.choice(["a", "b", "c"])})
        rng = random.Random(0)
        for i in range(30):
            x = rng.uniform(0, 1)
            c = rng.choice(["a", "b", "c"])
            # optimum at x=0.8, category "b"
            loss = (x - 0.8) ** 2 + (0.0 if c == "b" else 0.3)
            tid = f"t{i}"
            s._suggested[tid] = {("x",): x, ("c",): c}
            s.on_trial_complete(tid, {"loss": loss})
        cfgs = [s.suggest(f"s{i}") for i in range(40)]
        return [c["x"] for c in cfgs], [c["c"] for c in cfgs]

    xs, cs = _both(check)
    near = sum(1 for x in xs if abs(x - 0.8) < 0.25)
    assert near >= 28, (near, sorted(xs)[:5])
    assert cs.count("b") >= 24, cs.count("b")


def test_tpe_beats_random_within_budget():
    """Seeded, 10 paired seeds: on a smooth bowl, TPE's best-of-24 beats
    random search's best-of-24 in at least 8 of 10 runs."""
    def f(cfg):
        return (cfg["x"] - 0.2) ** 2 + (cfg["y"] + 0.4) ** 2

    def check(tune):
        space = {"x": tune.uniform(-1.0, 1.0), "y": tune.uniform(-1.0, 1.0)}
        wins = []
        for seed in range(10):
            s = tune.TPESearcher(metric="loss", mode="min", n_initial=6,
                                 seed=seed)
            s.set_search_properties("loss", "min", space)
            best_tpe = float("inf")
            for i in range(24):
                cfg = s.suggest(f"t{i}")
                v = f(cfg)
                s.on_trial_complete(f"t{i}", {"loss": v})
                best_tpe = min(best_tpe, v)
            rng = random.Random(1000 + seed)
            best_rand = min(f({"x": rng.uniform(-1, 1),
                               "y": rng.uniform(-1, 1)})
                            for _ in range(24))
            wins.append(best_tpe < best_rand)
        return wins

    wins = _both(check)
    assert sum(wins) >= 8, wins


def test_tpe_drives_tuner_end_to_end(results):
    assert same_result(results, "ts_tpe_drives_tuner_end_to_end") == \
        (16, 16, True)


def test_tpe_composes_with_asha(results):
    assert same_result(results, "ts_tpe_composes_with_asha") == \
        (10, True, True)


def test_hyperband_brackets_and_stopping():
    """Bracket assignment round-robins; a clearly worst trial in a
    small-grace bracket is stopped at its first rung while the best
    continues to max_t."""
    def check(tune):
        sch = importlib.import_module(f"{tune.__name__}.schedulers")
        hb = tune.HyperBandScheduler(metric="loss", mode="min", max_t=9,
                                     reduction_factor=3)
        n_brackets = len(hb._brackets)
        for i in range(6):
            hb.on_trial_add(f"t{i}", {})
        spread = hb._assignment["t0"] != hb._assignment["t1"] or \
            n_brackets == 1
        # Bracket 0 has grace 1: feed 3 trials at t=1, worst must stop.
        b0 = [tid for tid, b in hb._assignment.items() if b == 0][:3]
        while len(b0) < 3:
            tid = f"x{len(b0)}"
            hb._assignment[tid] = 0
            b0.append(tid)
        decisions = {tid: hb.on_result(tid, {"training_iteration": 1,
                                             "loss": float(rank)})
                     for rank, tid in enumerate(b0)}
        last = hb.on_result(b0[0], {"training_iteration": 9, "loss": 0.0})
        return (n_brackets, spread,
                decisions[b0[2]] == sch.STOP,       # worst of the rung
                decisions[b0[0]] == sch.CONTINUE,   # best survives
                last == sch.STOP)                   # max_t reached

    assert _both(check) == (3, True, True, True, True)


def test_hyperband_in_tuner(results):
    assert same_result(results, "ts_hyperband_in_tuner") == (True, True)


def test_mirrors_every_reference_test():
    assert_mirrored("tune_search")
