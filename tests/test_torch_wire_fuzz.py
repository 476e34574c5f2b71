"""Differential wire fuzzing of the port: for every body, the port's
extender with its wire extension on, the same extender with it off (the
exact path, which owns every decode-failure and empty-list quirk) and the
JAX extender with its extension on must answer with the same status and
bytes, Prioritize and Filter, in both nodeCacheCapable modes.

The corpus is the JAX harness's wire grammar (``tests/test_wire_fuzz.py``:
key spellings and case variants, duplicate and null fields, Nodes /
NodeNames / both / neither, escaped, non-ASCII, empty and duplicate node
names, unknown policies) and its byte mutations of the golden fixtures,
driven here by a numpy generator from a fixed seed: 10,500 cases with
nodeCacheCapable and 3,500 without, the JAX harness's counts.  Skips
without a C compiler."""

from __future__ import annotations

import os

import numpy as np
import pytest

from platform_aware_scheduling_tpu.extender.server import HTTPRequest as JaxRequest
from platform_aware_scheduling_tpu.native import get_wirec as get_jax_wirec
from platform_aware_scheduling_tpu.testing.builders import rule
from platform_aware_scheduling_tpu_torch import native
from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest
from platform_aware_scheduling_tpu_torch.tas import telemetryscheduler

from test_torch_extender import Stacks
from test_wire_fuzz import GOLDEN_DIR, NAME_POOL, _gen_body, _mutate

SEED = 0x5EED
CASES = {True: (6_000, 4_500), False: (2_000, 1_500)}  # (generated, mutated) by nodeCacheCapable
HEADERS = {"Content-Type": "application/json"}


class NumpyRandom:
    """The ``random.Random`` methods the JAX grammar calls, drawn from a
    numpy Generator."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def random(self) -> float:
        return float(self.rng.random())

    def randrange(self, start: int, stop: int = None) -> int:
        if stop is None:
            start, stop = 0, start
        return int(self.rng.integers(start, stop))

    def choice(self, seq):
        return seq[int(self.rng.integers(0, len(seq)))]

    def shuffle(self, items: list) -> None:
        items[:] = [items[i] for i in self.rng.permutation(len(items))]


@pytest.fixture(scope="module", params=[True, False], ids=["ncc", "legacy"])
def stacks(request):
    """Both extenders over one seeded world: half the name pool holds
    metric values, so requests mix known and unknown candidates."""
    if native.get_wirec() is None or get_jax_wirec() is None:
        pytest.skip("no C toolchain for the wire extensions")
    world = Stacks(node_cache_capable=request.param)
    world.policy(
        "fuzz-pol",
        {
            "scheduleonmetric": [rule("fuzz_metric", "GreaterThan", 0)],
            "dontschedule": [rule("fuzz_metric", "GreaterThan", 700_000)],
        },
    )
    rng = np.random.default_rng(7)
    known = NAME_POOL[: len(NAME_POOL) // 2 * 2 : 2] + [f"node-{i:03d}" for i in range(40)]
    values = rng.integers(0, 1_000_000, size=len(known))
    world.metric("fuzz_metric", {n: int(v) for n, v in zip(known, values)})
    return world


@pytest.fixture(autouse=True)
def _native_wire(monkeypatch):
    monkeypatch.delenv("PAS_TPU_NO_NATIVE", raising=False)


def serve_three(world, body: bytes, verb: str, monkeypatch):
    path = f"/scheduler/{verb}"
    native_answer = getattr(world.port, verb)(HTTPRequest("POST", path, dict(HEADERS), body))
    jax_answer = getattr(world.jax, verb)(JaxRequest("POST", path, dict(HEADERS), body))
    with monkeypatch.context() as m:
        m.setattr(telemetryscheduler, "get_wirec", lambda: None)
        exact_answer = getattr(world.port, verb)(HTTPRequest("POST", path, dict(HEADERS), body))
    return native_answer, exact_answer, jax_answer


def assert_same(answers, body: bytes, verb: str) -> None:
    native_answer, exact_answer, jax_answer = answers
    got = (native_answer.status, native_answer.body)
    assert got == (exact_answer.status, exact_answer.body) == (jax_answer.status, jax_answer.body), (
        f"{verb} divergence on {body[:200]!r}: native {got[0]}/{got[1][:120]!r}, exact "
        f"{exact_answer.status}/{exact_answer.body[:120]!r}, JAX {jax_answer.status}/{jax_answer.body[:120]!r}"
    )


def test_generated_corpus(stacks, monkeypatch):
    count, _ = CASES[stacks.port.node_cache_capable]
    rng = NumpyRandom(SEED)
    for i in range(count):
        body = _gen_body(rng)
        verb = "prioritize" if i % 2 == 0 else "filter"
        assert_same(serve_three(stacks, body, verb, monkeypatch), body, verb)


def test_mutated_corpus(stacks, monkeypatch):
    _, count = CASES[stacks.port.node_cache_capable]
    rng = NumpyRandom(SEED + 1)
    goldens = [
        open(os.path.join(GOLDEN_DIR, name), "rb").read()
        for name in sorted(os.listdir(GOLDEN_DIR))
        if name.endswith(".json")
    ]
    assert goldens, "golden request fixtures missing"
    seeds = goldens + [_gen_body(rng) for _ in range(40)]
    for i in range(count):
        body = _mutate(rng, rng.choice(seeds))
        verb = "prioritize" if i % 2 == 0 else "filter"
        assert_same(serve_three(stacks, body, verb, monkeypatch), body, verb)


def test_corpus_size():
    assert sum(CASES[True]) >= 10_000
