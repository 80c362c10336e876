"""Deterministic fallback for ``hypothesis`` on bare environments.

Tier-1 must collect and run with only jax/numpy/pytest installed
(ROADMAP "Tier-1 verify" on a fresh container), but the property tests
are written against hypothesis's ``@given``/``strategies`` API.  When
hypothesis is importable the tests use it unchanged; when it is not,
this module provides a seeded, minimal re-implementation of the subset
the suite uses (``integers``, ``floats``, ``booleans``, ``lists``,
``tuples``, ``sampled_from``) so the properties still execute on random
inputs — without shrinking, the database, or deadline handling.

Usage (in test modules)::

    try:
        from hypothesis import given, settings
        from hypothesis import strategies as st
    except ImportError:
        from repro_torch.testing import given, settings
        from repro_torch.testing import strategies as st

The JAX package's module of the same name, copied for the port's tests
(the port imports nothing of ``repro``).  Its ``count_compiles`` has no
counterpart: the port compiles nothing with jit, and its engines count
their CUDA graph captures (``graph_captures``) instead.
"""
from __future__ import annotations

import functools
import random
import types
from typing import Any, Callable

_DEFAULT_EXAMPLES = 25
_SEED = 0


class Strategy:
    """A draw function rng -> value (the whole hypothesis API we need)."""

    def __init__(self, draw: Callable[[random.Random], Any]):
        self.draw = draw

    def map(self, f: Callable[[Any], Any]) -> "Strategy":
        return Strategy(lambda rng: f(self.draw(rng)))

    def filter(self, pred: Callable[[Any], bool],
               max_tries: int = 100) -> "Strategy":
        def draw(rng: random.Random):
            for _ in range(max_tries):
                v = self.draw(rng)
                if pred(v):
                    return v
            raise ValueError("filter predicate never satisfied")
        return Strategy(draw)


def integers(min_value: int = -2 ** 31, max_value: int = 2 ** 31) -> Strategy:
    return Strategy(lambda rng: rng.randint(min_value, max_value))


def floats(min_value: float = 0.0, max_value: float = 1.0,
           **_ignored) -> Strategy:
    return Strategy(lambda rng: rng.uniform(min_value, max_value))


def booleans() -> Strategy:
    return Strategy(lambda rng: bool(rng.getrandbits(1)))


def sampled_from(seq) -> Strategy:
    seq = list(seq)
    return Strategy(lambda rng: seq[rng.randrange(len(seq))])


def tuples(*strategies: Strategy) -> Strategy:
    return Strategy(lambda rng: tuple(s.draw(rng) for s in strategies))


def lists(elements: Strategy, min_size: int = 0,
          max_size: int = 10) -> Strategy:
    def draw(rng: random.Random):
        n = rng.randint(min_size, max_size)
        return [elements.draw(rng) for _ in range(n)]
    return Strategy(draw)


def given(*arg_strategies: Strategy, **kw_strategies: Strategy):
    """Run the test once per generated example (seeded, reproducible)."""
    def deco(fn):
        def run(*args, **kwargs):
            n = getattr(run, "_max_examples",
                        getattr(fn, "_max_examples", _DEFAULT_EXAMPLES))
            rng = random.Random(_SEED)
            for _ in range(n):
                drawn = [s.draw(rng) for s in arg_strategies]
                kdrawn = {k: s.draw(rng) for k, s in kw_strategies.items()}
                fn(*args, *drawn, **kwargs, **kdrawn)
        # NOT functools.wraps: copying __wrapped__ would make pytest
        # introspect fn's signature and demand the drawn args as fixtures
        run.__name__ = fn.__name__
        run.__doc__ = fn.__doc__
        run.__module__ = fn.__module__
        run.hypothesis_shim = True
        return run
    return deco


def settings(max_examples: int = _DEFAULT_EXAMPLES, **_ignored):
    """Record max_examples on the (possibly already-wrapped) test."""
    def deco(fn):
        fn._max_examples = max_examples
        return fn
    return deco


# ``from repro_torch.testing import strategies as st`` mirror of the real layout
strategies = types.SimpleNamespace(
    integers=integers, floats=floats, booleans=booleans,
    sampled_from=sampled_from, tuples=tuples, lists=lists,
    Strategy=Strategy)
st = strategies
