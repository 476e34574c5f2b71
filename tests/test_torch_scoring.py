"""The port's ordinal scoring and Filter verdicts (``ops/scoring.py``), held
exactly against the JAX package's jitted kernels on the CPU.  Inputs come
from numpy seeds and go to both; the tolerance is 0, since every output is
an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.ops import rules as jax_rules
from platform_aware_scheduling_tpu.ops import scoring as jax_scoring
from platform_aware_scheduling_tpu_torch.ops import i64, rules, scoring

M = 4  # metric rows
K = 6  # rankings per problem: every op id, twice over
OPS = np.array([0, 1, 2, -1, 1, 0], dtype=np.int32)  # LessThan, GreaterThan, Equals, unknown
SIZES = [1, 37, 64]  # odd, and the mirror's minimum padded width
CASES = ["random", "ties", "int64_min_greater_than", "int64_max_less_than", "all_invalid", "all_valid"]


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


def _problem(case, n, seed=0):
    """(values [M,N], present [M,N], metric_row [K], op_id [K], candidate [K,N])."""
    rng = np.random.default_rng([seed, n, CASES.index(case)])
    values = rng.integers(-10**6, 10**6, size=(M, n), dtype=np.int64)
    present = rng.random((M, n)) > 0.25
    candidate = rng.random((K, n)) > 0.3
    metric_row = rng.integers(0, M, size=K).astype(np.int32)
    if case == "ties":
        values = rng.integers(-2, 3, size=(M, n), dtype=np.int64)
    elif case == "int64_min_greater_than":
        # flip(INT64_MIN) == INT64_MAX ties the invalid lanes' sentinel key:
        # the valid lanes must still rank ahead of every invalid one
        values[:, ::2] = i64.INT64_MIN
        values[:, 1::3] = i64.INT64_MAX
    elif case == "int64_max_less_than":
        values[:, ::2] = i64.INT64_MAX
        values[:, 1::3] = i64.INT64_MIN
    elif case == "all_invalid":
        candidate[:] = False
    elif case == "all_valid":
        present[:] = True
        candidate[:] = True
    return values, present, metric_row, OPS.copy(), candidate


def _check_ranking(got, want_scores, want_perm, want_count, want_valid):
    count = int(want_count)
    assert int(got.valid_count) == count
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want_valid))
    valid = np.asarray(want_valid)
    np.testing.assert_array_equal(got.scores.numpy()[valid], np.asarray(want_scores)[valid])
    np.testing.assert_array_equal(got.perm.numpy()[:count], np.asarray(want_perm)[:count])
    assert got.scores.dtype == got.perm.dtype == got.valid_count.dtype == torch.int32


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_prioritize(case, n):
    values, present, metric_row, op_id, candidate = _problem(case, n)
    for k in range(K):
        want = jax_scoring.prioritize_kernel(
            jax_i64.from_int64(values),
            jnp.asarray(present),
            jnp.int32(metric_row[k]),
            jnp.int32(op_id[k]),
            jnp.asarray(candidate[k]),
        )
        got = scoring.prioritize(
            _t(values), _t(present), int(metric_row[k]), int(op_id[k]), _t(candidate[k])
        )
        _check_ranking(got, want.scores, want.perm, want.valid_count, want.valid)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_batch_prioritize(case, n):
    values, present, metric_row, op_id, candidate = _problem(case, n, seed=1)
    want = jax_scoring.batch_prioritize_kernel(
        jax_i64.from_int64(values),
        jnp.asarray(present),
        jnp.asarray(metric_row),
        jnp.asarray(op_id),
        jnp.asarray(candidate),
    )
    got = scoring.batch_prioritize(
        _t(values), _t(present), _t(metric_row), _t(op_id), _t(candidate)
    )
    assert got.perm.shape == (K, n)
    for k in range(K):
        _check_ranking(
            scoring.PrioritizeResult(*(field[k] for field in got)),
            want.scores[k],
            want.perm[k],
            want.valid_count[k],
            want.valid[k],
        )


def test_valid_int64_min_lane_ranks_before_invalid_lanes():
    """The trap a single stable sort by key falls into: a valid GreaterThan
    lane at INT64_MIN keys as INT64_MAX, equal to the invalid sentinel,
    and must still come first although its index is the largest."""
    values = np.array([5, 7, 3, i64.INT64_MIN], dtype=np.int64)
    valid = np.array([False, False, True, True])
    got = scoring.ordinal_scores(_t(values), _t(valid), rules.OP_GREATER_THAN)
    assert got.perm[:2].tolist() == [2, 3]
    assert got.scores[[2, 3]].tolist() == [10, 9]


def _rule_problem(seed, n, r=8):
    rng = np.random.default_rng([seed, n])
    values = rng.integers(-50, 50, size=(M, n), dtype=np.int64) * 1000
    values[:, ::5] = rng.choice([i64.INT64_MIN, i64.INT64_MAX], size=values[:, ::5].shape)
    present = rng.random((M, n)) > 0.2
    metric_row = rng.integers(0, M, size=r).astype(np.int32)
    op_id = rng.integers(-1, 3, size=r).astype(np.int32)
    target = np.where(
        rng.random(r) < 0.5,
        values[metric_row, rng.integers(0, n, size=r)],
        rng.integers(-40, 40, size=r) * 1000,
    ).astype(np.int64)
    active = rng.random(r) > 0.25
    candidate = rng.random(n) > 0.2
    jax_args = (
        jax_i64.from_int64(values),
        jnp.asarray(present),
        jax_rules.RuleSet(
            metric_row=jnp.asarray(metric_row),
            op_id=jnp.asarray(op_id),
            target=jax_i64.from_int64(target),
            active=jnp.asarray(active),
        ),
        jnp.asarray(candidate),
    )
    torch_args = (
        _t(values),
        _t(present),
        rules.RuleSet(_t(metric_row), _t(op_id), _t(target), _t(active)),
        _t(candidate),
    )
    return jax_args, torch_args


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", range(3))
def test_filter(seed, n):
    jax_args, torch_args = _rule_problem(seed, n)
    want = np.asarray(jax_scoring.filter_kernel(*jax_args))
    got = scoring.filter(*torch_args)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", range(3))
def test_filter_explain(seed, n):
    jax_args, torch_args = _rule_problem(seed, n)
    want = jax_scoring.filter_explain_kernel(*jax_args)
    got = scoring.filter_explain(*torch_args)
    assert got.first_rule.dtype == torch.int32
    np.testing.assert_array_equal(got.passing.numpy(), np.asarray(want.passing))
    np.testing.assert_array_equal(got.first_rule.numpy(), np.asarray(want.first_rule))
    # the explained verdict is the plain verdict
    np.testing.assert_array_equal(got.passing.numpy(), scoring.filter(*torch_args).numpy())


def test_each_function_counts_its_calls():
    values, present, metric_row, op_id, candidate = _problem("random", 37)
    _jax, (v, p, ruleset, cand) = _rule_problem(0, 37)
    before = {fn: fn.CALLS for fn in (scoring.prioritize, scoring.batch_prioritize,
                                      scoring.filter, scoring.filter_explain,
                                      scoring.ordinal_scores)}
    scoring.prioritize(_t(values), _t(present), 0, 1, _t(candidate[0]))
    scoring.batch_prioritize(_t(values), _t(present), _t(metric_row), _t(op_id), _t(candidate))
    scoring.filter(v, p, ruleset, cand)
    scoring.filter_explain(v, p, ruleset, cand)
    moved = {fn.__name__: fn.CALLS - n for fn, n in before.items()}
    assert moved == {
        "prioritize": 1,
        "batch_prioritize": 1,
        "filter": 1,
        "filter_explain": 1,
        "ordinal_scores": 2,
    }
