"""The port's Sinkhorn solver (``ops/sinkhorn.py``) held against the JAX
package's ``sinkhorn_assign_kernel`` on the CPU.

The utilities are exact (``_normalize_scores`` bit for bit).  The plan is
not: ``torch.logsumexp`` sums in another order than XLA, and XLA's ``log``
and ``exp`` are its own approximations, so plans agree within
``PLAN_RTOL`` / ``PLAN_ATOL`` (a few float32 ulps, measured under 6e-6
relative) and the quantised guides within ``GUIDE_TOL`` micro-nats.  The
assignments are pinned exactly: on these seeds no pod's two best guide
values lie that close, and the rounding of JAX's own guide through the
port's greedy equals JAX's assignment."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.ops import sinkhorn as jax_sinkhorn
from platform_aware_scheduling_tpu.ops.assign import greedy_assign_kernel
from platform_aware_scheduling_tpu_torch.ops import _build, assign, cuda_assign, sinkhorn
from platform_aware_scheduling_tpu_torch.ops.i64 import INT64_MAX, INT64_MIN

#: plan tolerance: reduction order and XLA's log/exp, a few float32 ulps
PLAN_RTOL = 2e-5
PLAN_ATOL = 1e-6
#: guide tolerance in micro-nats: the log-plan's float32 ulps at its size
GUIDE_TOL = 16
#: total_utility: the same picked utilities summed in another order
UTILITY_RTOL = 1e-6


@jax.jit
def _jax_guide(score, eligible, capacity):
    """JAX's quantised guide as int64 pieces, step for step
    ``sinkhorn_assign_kernel``'s (it returns only the plan)."""
    utility = jax_sinkhorn._normalize_scores(score, eligible)
    logits = jnp.where(eligible, utility / jnp.float32(0.05), jax_sinkhorn.NEG)
    cap_f = capacity.astype(jnp.float32)
    has_eligible = jnp.any(eligible, axis=1)

    def step(carry, _):
        log_u, log_v = carry
        row_lse = jax.nn.logsumexp(logits + log_v[None, :], axis=1)
        log_u = jnp.where(has_eligible, -row_lse, jax_sinkhorn.NEG)
        col_lse = jax.nn.logsumexp(logits + log_u[:, None], axis=0)
        log_v = jnp.minimum(jnp.log(jnp.maximum(cap_f, 1e-9)) - col_lse, 0.0)
        log_v = jnp.where(cap_f > 0, log_v, jax_sinkhorn.NEG)
        return (log_u, log_v), None

    p, n = eligible.shape
    init = (jnp.zeros(p, jnp.float32), jnp.zeros(n, jnp.float32))
    (log_u, log_v), _ = jax.lax.scan(step, init, None, length=jax_sinkhorn.DEFAULT_ITERATIONS)
    log_plan = logits + log_u[:, None] + log_v[None, :]
    guide = jnp.where(eligible, log_plan, jnp.float32(jax_sinkhorn.NEG))
    return jnp.clip(guide * jnp.float32(1e6), -2.0e9, 2.0e9).astype(jnp.int32)


def _instance(seed, p=20, n=30):
    """``tests/test_parallel.py::TestSinkhornAssign``'s draw."""
    rng = np.random.default_rng(seed)
    score = rng.integers(0, 10**9, size=(p, n)).astype(np.int64)
    eligible = rng.random((p, n)) > 0.2
    capacity = rng.integers(0, 3, size=n).astype(np.int32)
    return score, eligible, capacity


def _both(score, eligible, capacity):
    jargs = (jax_i64.from_int64(score), jnp.asarray(eligible), jnp.asarray(capacity))
    want = jax_sinkhorn.sinkhorn_assign_kernel(*jargs)
    got = sinkhorn.sinkhorn_assign(torch.from_numpy(score), torch.from_numpy(eligible), torch.from_numpy(capacity))
    return jargs, want, got


CASES = [(seed, 20, 30) for seed in range(5)] + [
    (seed, p, n) for seed in (5, 6) for p, n in ((30, 20), (50, 100), (10, 200), (64, 256))
]


class TestNormalizeScores:
    @pytest.mark.parametrize("span", [10**9, 2**40, 2**62])
    @pytest.mark.parametrize("seed", range(3))
    def test_bit_for_bit(self, seed, span):
        rng = np.random.default_rng(seed)
        p, n = 24, 70
        score = rng.integers(-span, span, size=(p, n)).astype(np.int64)
        score[0, :3] = [INT64_MIN, INT64_MAX, -1]
        score[1] = 7  # one value: span clamps to 1
        eligible = rng.random((p, n)) > 0.2
        eligible[2] = False  # no eligible lane
        want = np.asarray(jax_sinkhorn._normalize_scores(jax_i64.from_int64(score), jnp.asarray(eligible)))
        got = sinkhorn._normalize_scores(torch.from_numpy(score), torch.from_numpy(eligible)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


class TestSinkhornAssign:
    @pytest.mark.parametrize("case", CASES)
    def test_assignment_equal_plan_close(self, case):
        score, eligible, capacity = _instance(*case)
        jargs, want, got = _both(score, eligible, capacity)
        np.testing.assert_array_equal(got.assignment.node_for_pod.numpy(), np.asarray(want.assignment.node_for_pod))
        np.testing.assert_array_equal(got.assignment.capacity_left.numpy(), np.asarray(want.assignment.capacity_left))
        np.testing.assert_allclose(got.plan.numpy(), np.asarray(want.plan), rtol=PLAN_RTOL, atol=PLAN_ATOL)
        jax_guide = np.asarray(_jax_guide(*jargs)).astype(np.int64)
        assert np.abs(got.guide.numpy() - jax_guide).max() <= GUIDE_TOL
        # JAX's own guide, rounded by the port's greedy, is JAX's assignment
        rounded = assign.greedy_assign_reference(
            torch.from_numpy(jax_guide), torch.from_numpy(eligible), torch.from_numpy(capacity)
        )
        np.testing.assert_array_equal(rounded.node_for_pod.numpy(), np.asarray(want.assignment.node_for_pod))
        assert np.array_equal(
            np.asarray(greedy_assign_kernel(jax_i64.from_int64(jax_guide), *jargs[1:]).node_for_pod),
            np.asarray(want.assignment.node_for_pod),
        )
        # feasible: eligible nodes only, capacity never exceeded
        nodes = got.assignment.node_for_pod.numpy()
        placed = nodes >= 0
        assert eligible[np.flatnonzero(placed), nodes[placed]].all()
        assert (np.bincount(nodes[placed], minlength=capacity.shape[0]) <= capacity).all()

    def test_textbook_coordination(self):
        """Greedy gives pod 0 the node pod 1 needs; Sinkhorn places both."""
        score = np.array([[100, 99], [100, 0]], dtype=np.int64)
        eligible = np.array([[True, True], [True, False]])
        capacity = np.array([1, 1], dtype=np.int32)
        _jargs, want, got = _both(score, eligible, capacity)
        assert got.assignment.node_for_pod.tolist() == [1, 0]
        np.testing.assert_array_equal(got.assignment.node_for_pod.numpy(), np.asarray(want.assignment.node_for_pod))
        greedy = assign.greedy_assign_reference(
            torch.from_numpy(score), torch.from_numpy(eligible), torch.from_numpy(capacity)
        )
        assert greedy.node_for_pod.tolist() == [0, -1]

    def test_ineligible_pod_carries_no_mass(self):
        score = np.array([[30, 20, 10], [30, 20, 10], [5, 5, 5]], dtype=np.int64)
        eligible = np.array([[1, 1, 1], [1, 1, 1], [0, 0, 0]], dtype=bool)
        capacity = np.ones(3, dtype=np.int32)
        _jargs, want, got = _both(score, eligible, capacity)
        assert float(got.plan[2].sum()) == 0.0
        assert int(got.assignment.node_for_pod[2]) == -1
        two = sinkhorn.sinkhorn_assign(
            torch.from_numpy(score[:2]), torch.from_numpy(eligible[:2]), torch.from_numpy(capacity)
        )
        np.testing.assert_allclose(got.plan[:2].numpy(), two.plan.numpy(), atol=1e-5)
        np.testing.assert_array_equal(got.assignment.node_for_pod.numpy(), np.asarray(want.assignment.node_for_pod))

    @pytest.mark.parametrize("seed", [0, 3])
    def test_total_utility(self, seed):
        score, eligible, capacity = _instance(seed, p=30, n=20)
        jargs, want, got = _both(score, eligible, capacity)
        mine = float(sinkhorn.total_utility(torch.from_numpy(score), got.assignment.node_for_pod))
        theirs = float(jax_sinkhorn.total_utility(jargs[0], want.assignment.node_for_pod))
        assert mine == pytest.approx(theirs, rel=UTILITY_RTOL)
        greedy = assign.greedy_assign_reference(*(torch.from_numpy(x) for x in (score, eligible, capacity)))
        assert (got.assignment.node_for_pod >= 0).sum() >= (greedy.node_for_pod >= 0).sum()

    def test_quantized_guide_clips_and_truncates(self):
        log_plan = torch.tensor([[-1e30, -2.5e-6, 2.5e-6, 3000.0, -0.0000015]], dtype=torch.float32)
        eligible = torch.tensor([[True, True, True, True, False]])
        guide = sinkhorn.quantize_guide(log_plan, eligible)
        assert guide.dtype == torch.int64
        assert guide.tolist() == [[-2_000_000_000, -2, 2, 2_000_000_000, -2_000_000_000]]

    def test_cpu_rounds_with_the_plain_greedy(self, monkeypatch):
        def refuse(*_args, **_kwargs):
            raise AssertionError("the CPU path touched the kernel builder")

        monkeypatch.setattr(_build, "load", refuse)
        monkeypatch.setattr(cuda_assign.greedy_assign_cuda, "LAUNCHES", 0)
        score, eligible, capacity = _instance(1)
        got = sinkhorn.sinkhorn_assign(torch.from_numpy(score), torch.from_numpy(eligible), torch.from_numpy(capacity))
        want = assign.greedy_assign_reference(got.guide, torch.from_numpy(eligible), torch.from_numpy(capacity))
        assert torch.equal(got.assignment.node_for_pod, want.node_for_pod)
        assert cuda_assign.greedy_assign_cuda.LAUNCHES == 0
