"""The port's int64 layer and rule evaluation, held exactly against the JAX
package on the CPU.  Inputs come from numpy seeds and go to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.ops import rules as jax_rules
from platform_aware_scheduling_tpu_torch.ops import i64
from platform_aware_scheduling_tpu_torch.ops import rules

EDGES = np.array(
    [
        i64.INT64_MIN,
        i64.INT64_MIN + 1,
        -(2**32),
        -(2**31) - 1,
        -(2**31),
        -1,
        0,
        1,
        2**31 - 1,
        2**31,
        2**32 - 1,
        2**32,
        i64.INT64_MAX - 1,
        i64.INT64_MAX,
    ],
    dtype=np.int64,
)


def _values(seed, shape):
    """Seeded int64 values mixing the full range, small values and edges."""
    rng = np.random.default_rng(seed)
    wide = rng.integers(i64.INT64_MIN, i64.INT64_MAX, size=shape, dtype=np.int64)
    small = rng.integers(-5, 5, size=shape).astype(np.int64)
    edge = rng.choice(EDGES, size=shape)
    pick = rng.integers(0, 3, size=shape)
    return np.where(pick == 0, wide, np.where(pick == 1, small, edge))


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


class TestInt64:
    @pytest.mark.parametrize("seed", range(4))
    def test_flip_matches_split_flip(self, seed):
        vals = _values(seed, (64,))
        want = jax_i64.to_int64_np(jax_i64.flip(jax_i64.from_int64(vals)))
        np.testing.assert_array_equal(i64.flip(_t(vals)).numpy(), want)

    @pytest.mark.parametrize("seed", range(4))
    def test_cmp_matches_split_cmp(self, seed):
        a = _values(seed, (256,))
        b = np.where(np.arange(256) % 4 == 0, a, _values(seed + 100, (256,)))
        want = np.asarray(jax_i64.cmp(jax_i64.from_int64(a), jax_i64.from_int64(b)))
        np.testing.assert_array_equal(i64.cmp(_t(a), _t(b)).numpy(), want)

    def test_cmp_all_edge_pairs(self):
        a = np.repeat(EDGES, len(EDGES))
        b = np.tile(EDGES, len(EDGES))
        want = np.asarray(jax_i64.cmp(jax_i64.from_int64(a), jax_i64.from_int64(b)))
        np.testing.assert_array_equal(i64.cmp(_t(a), _t(b)).numpy(), want)

    def test_flip_reverses_order(self):
        order = np.argsort(EDGES)
        flipped = i64.flip(_t(EDGES)).numpy()
        assert (np.diff(flipped[order]) < 0).all()


def _rule_problem(seed, m=5, n=37, r=8):
    rng = np.random.default_rng(seed)
    values = _values(seed, (m, n))
    present = rng.random((m, n)) > 0.2
    metric_row = rng.integers(0, m, size=r).astype(np.int32)
    op_id = rng.integers(-1, 3, size=r).astype(np.int32)  # -1: unknown op
    # targets drawn partly from the values themselves so Equals can hit
    target = np.where(
        rng.random(r) < 0.5,
        values[metric_row, rng.integers(0, n, size=r)],
        _values(seed + 7, (r,)),
    )
    active = rng.random(r) > 0.25
    return values, present, metric_row, op_id, target, active


def _both(seed):
    values, present, metric_row, op_id, target, active = _rule_problem(seed)
    jax_args = (
        jax_i64.from_int64(values),
        jnp.asarray(present),
        jax_rules.RuleSet(
            metric_row=jnp.asarray(metric_row),
            op_id=jnp.asarray(op_id),
            target=jax_i64.from_int64(target),
            active=jnp.asarray(active),
        ),
    )
    torch_args = (
        _t(values),
        _t(present),
        rules.RuleSet(
            metric_row=_t(metric_row),
            op_id=_t(op_id),
            target=_t(target),
            active=_t(active),
        ),
    )
    return jax_args, torch_args


class TestRules:
    def test_op_ids_match(self):
        assert rules.OP_IDS == jax_rules.OP_IDS

    @pytest.mark.parametrize("seed", range(6))
    def test_rule_matches(self, seed):
        a = _values(seed, (3, 50))
        b = np.where(np.arange(50) % 3 == 0, a, _values(seed + 1, (3, 50)))
        op = np.array([[0], [1], [2]], dtype=np.int32)
        want = jax_rules.rule_matches(
            jax_i64.from_int64(a), jnp.asarray(op), jax_i64.from_int64(b)
        )
        got = rules.rule_matches(_t(a), _t(op), _t(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize(
        "fn", ["evaluate_rules", "violated_nodes", "first_violated_rule"]
    )
    def test_rule_functions(self, seed, fn):
        jax_args, torch_args = _both(seed)
        want = np.asarray(getattr(jax_rules, fn)(*jax_args))
        got = getattr(rules, fn)(*torch_args).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("op", [0, 1, 2])
    def test_edge_targets(self, op):
        """Every edge value against every edge target, one rule per target."""
        values = EDGES[None, :]
        present = np.ones_like(values, dtype=bool)
        r = len(EDGES)
        zeros = np.zeros(r, dtype=np.int32)
        ops = np.full(r, op, dtype=np.int32)
        active = np.ones(r, dtype=bool)
        want = jax_rules.evaluate_rules(
            jax_i64.from_int64(values),
            jnp.asarray(present),
            jax_rules.RuleSet(
                metric_row=jnp.asarray(zeros),
                op_id=jnp.asarray(ops),
                target=jax_i64.from_int64(EDGES),
                active=jnp.asarray(active),
            ),
        )
        got = rules.evaluate_rules(
            _t(values),
            _t(present),
            rules.RuleSet(_t(zeros), _t(ops), _t(EDGES), _t(active)),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
