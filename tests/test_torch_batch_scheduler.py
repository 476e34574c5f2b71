"""The port's batch solve held exactly against the JAX package's on the CPU:
the same ``example_inputs`` problem is carried across with ``convert.py``
and both ``score_and_filter`` and ``scheduling_step`` must agree."""

import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.models import batch_scheduler as jax_bs
from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu_torch import convert
from platform_aware_scheduling_tpu_torch.models import batch_scheduler as bs

SIZES = [(4, 64, 16), (3, 129, 33), (6, 300, 57)]  # (metrics, nodes, pods)


def _carried(jax_state, jax_pods):
    """The JAX problem as the port sees it, through convert.py."""
    rules = jax_state.dontschedule
    state = convert.cluster_state_from_numpy(
        np.asarray(jax_state.metric_values.hi),
        np.asarray(jax_state.metric_values.lo),
        np.asarray(jax_state.metric_present),
        np.asarray(rules.metric_row),
        np.asarray(rules.op_id),
        np.asarray(rules.target.hi),
        np.asarray(rules.target.lo),
        np.asarray(rules.active),
        np.asarray(jax_state.capacity),
        device="cpu",
    )
    pods = convert.pending_pods_from_numpy(
        np.asarray(jax_pods.metric_row),
        np.asarray(jax_pods.op_id),
        np.asarray(jax_pods.candidates),
        device="cpu",
    )
    return state, pods


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("size", SIZES)
def test_score_and_filter_matches(seed, size):
    m, n, p = size
    jax_state, jax_pods = jax_bs.example_inputs(m, n, p, seed=seed)
    state, pods = _carried(jax_state, jax_pods)
    j_viol, j_score, j_elig = jax_bs.score_and_filter(jax_state, jax_pods)
    viol, score, elig = bs.score_and_filter(state, pods)
    np.testing.assert_array_equal(viol.numpy(), np.asarray(j_viol))
    assert score.dtype == torch.int64
    np.testing.assert_array_equal(score.numpy(), jax_i64.to_int64_np(j_score))
    np.testing.assert_array_equal(elig.numpy(), np.asarray(j_elig))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("size", SIZES)
def test_scheduling_step_matches(seed, size):
    m, n, p = size
    jax_state, jax_pods = jax_bs.example_inputs(m, n, p, seed=seed)
    state, pods = _carried(jax_state, jax_pods)
    want = jax_bs.scheduling_step(jax_state, jax_pods)
    got = bs.scheduling_step(state, pods)
    np.testing.assert_array_equal(got.violating.numpy(), np.asarray(want.violating))
    np.testing.assert_array_equal(got.score.numpy(), jax_i64.to_int64_np(want.score))
    np.testing.assert_array_equal(got.eligible.numpy(), np.asarray(want.eligible))
    np.testing.assert_array_equal(
        got.assignment.node_for_pod.numpy(), np.asarray(want.assignment.node_for_pod)
    )
    np.testing.assert_array_equal(
        got.assignment.capacity_left.numpy(), np.asarray(want.assignment.capacity_left)
    )


@pytest.mark.parametrize("seed", range(2))
def test_port_example_inputs_draw_the_same_problem(seed):
    """The port's own example_inputs gives the JAX problem for one seed."""
    jax_state, jax_pods = jax_bs.example_inputs(5, 77, 21, seed=seed)
    carried_state, carried_pods = _carried(jax_state, jax_pods)
    state, pods = bs.example_inputs(5, 77, 21, seed=seed, device="cpu")
    for got, want in zip(
        (state.metric_values, state.metric_present, state.capacity, *state.dontschedule, *pods),
        (
            carried_state.metric_values,
            carried_state.metric_present,
            carried_state.capacity,
            *carried_state.dontschedule,
            *carried_pods,
        ),
    ):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_unknown_op_ranks_by_node_index():
    """op_id -1 (unknown operator) prefers the lowest node index."""
    state, pods = bs.example_inputs(2, 10, 3, seed=0, device="cpu")
    pods = pods._replace(op_id=torch.full((3,), -1, dtype=torch.int32))
    score = bs._score_keys(state.metric_values, state.metric_present, pods.metric_row, pods.op_id)
    assert (score.argmax(dim=1) == 0).all()
