"""The plain greedy assignment and its dispatch, held exactly against the JAX
package's scan (``greedy_assign_kernel``) and its Pallas kernel run in
interpret mode on the CPU (``greedy_assign_pallas``); ``lex_argmin``,
``_row_lex_argmax`` and the auction fixpoint against theirs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.ops import assign as jax_assign
from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.ops.assign import greedy_assign_kernel
from platform_aware_scheduling_tpu.ops.pallas_assign import greedy_assign_pallas
from platform_aware_scheduling_tpu_torch.ops import _build, assign, cuda_assign
from platform_aware_scheduling_tpu_torch.ops.i64 import INT64_MAX, INT64_MIN


def _check(score, eligible, capacity, pallas=True):
    """Port's plain version == JAX scan (== Pallas interpret) exactly."""
    got = assign.greedy_assign_reference(
        torch.from_numpy(score), torch.from_numpy(eligible), torch.from_numpy(capacity)
    )
    args = (
        jax_i64.from_int64(score),
        jnp.asarray(eligible),
        jnp.asarray(capacity),
    )
    wants = [greedy_assign_kernel(*args)]
    if pallas:
        wants.append(greedy_assign_pallas(*args, interpret=True))
    for want in wants:
        np.testing.assert_array_equal(
            got.node_for_pod.numpy(), np.asarray(want.node_for_pod)
        )
        np.testing.assert_array_equal(
            got.capacity_left.numpy(), np.asarray(want.capacity_left)
        )
    assert got.node_for_pod.dtype == torch.int32
    assert got.capacity_left.dtype == torch.int32
    return got


class TestGreedyReference:
    @pytest.mark.parametrize("seed", range(6))
    def test_seeded_odd_shapes(self, seed):
        rng = np.random.default_rng(seed)
        # odd P and N take the JAX wrapper's padding paths
        p = int(rng.integers(1, 16)) * 2 + 1
        n = int(rng.integers(1, 150)) * 2 + 1
        score = rng.integers(-(2**62), 2**62, size=(p, n)).astype(np.int64)
        eligible = rng.random((p, n)) > 0.3
        capacity = rng.integers(0, 3, size=n).astype(np.int32)
        _check(score, eligible, capacity)

    def test_u32_bias_edge_values(self):
        vals = np.array(
            [[2**31, 2**31 - 1, 2**32 - 1, 0, -1, -(2**31), INT64_MAX, INT64_MIN]],
            dtype=np.int64,
        )
        score = np.repeat(vals, 8, axis=0)
        _check(score, np.ones_like(score, dtype=bool), np.ones(8, dtype=np.int32))

    def test_eligible_int64_min_lane_is_chosen(self):
        """The only ok lane scores INT64_MIN: it must still be chosen."""
        score = np.array([[INT64_MIN, 5, INT64_MAX]], dtype=np.int64)
        eligible = np.array([[True, False, True]])
        capacity = np.array([1, 1, 0], dtype=np.int32)
        got = _check(score, eligible, capacity)
        assert got.node_for_pod.tolist() == [0]
        assert got.capacity_left.tolist() == [0, 1, 0]

    def test_heavy_contention(self):
        """Equal scores, capacity one: pods fill nodes in index order."""
        p, n = 13, 9
        score = np.zeros((p, n), dtype=np.int64)
        got = _check(score, np.ones((p, n), dtype=bool), np.ones(n, dtype=np.int32))
        assert got.node_for_pod.tolist() == list(range(n)) + [-1] * (p - n)
        assert got.capacity_left.tolist() == [0] * n

    def test_zero_capacity_never_chosen(self):
        score = np.array([[9, 1, 0], [9, 5, 1]], dtype=np.int64)
        capacity = np.array([0, 2, 0], dtype=np.int32)
        got = _check(score, np.ones((2, 3), dtype=bool), capacity)
        assert got.node_for_pod.tolist() == [1, 1]

    def test_no_ok_lane_leaves_capacity(self):
        score = np.array([[3, 4], [1, 2]], dtype=np.int64)
        eligible = np.array([[False, False], [True, True]])
        capacity = np.array([1, 1], dtype=np.int32)
        got = _check(score, eligible, capacity)
        assert got.node_for_pod.tolist() == [-1, 1]
        assert got.capacity_left.tolist() == [1, 0]

    @pytest.mark.parametrize("shape", [(0, 5), (3, 0), (0, 0)])
    def test_empty(self, shape):
        p, n = shape
        got = assign.greedy_assign_reference(
            torch.zeros((p, n), dtype=torch.int64),
            torch.ones((p, n), dtype=torch.bool),
            torch.ones(n, dtype=torch.int32),
        )
        assert got.node_for_pod.tolist() == [-1] * p
        assert got.capacity_left.tolist() == [1] * n


def _staged_case(name, rng):
    """(score, eligible, capacity) for one named case of the staged model."""
    if name.startswith("odd shape"):
        p = int(rng.integers(1, 12)) * 2 + 1
        n = int(rng.integers(1, 60)) * 2 + 1
        score = rng.integers(-4, 4, size=(p, n)).astype(np.int64)  # many ties
        return score, rng.random((p, n)) > 0.3, rng.integers(0, 3, size=n).astype(np.int32)
    if name == "lists used up mid-way":
        p, n = 45, 41
        score = rng.integers(0, 3, size=(p, n)).astype(np.int64)
        return score, rng.random((p, n)) > 0.1, np.ones(n, dtype=np.int32)
    if name == "ties straddle the list boundary":
        # each row: one lane of 9, then 40 lanes of 5, then lanes of 1, so
        # a list of 1, 2 or 32 ends inside the run of equal scores
        p, n = 45, 67
        row = np.array([9] + [5] * 40 + [1] * (n - 41), dtype=np.int64)
        score = np.stack([rng.permutation(row) for _ in range(p)])
        return score, rng.random((p, n)) > 0.05, np.ones(n, dtype=np.int32)
    if name == "rows with fewer ok lanes than the list":
        p, n = 21, 37
        eligible = np.zeros((p, n), dtype=bool)
        for pod in range(p):
            eligible[pod, rng.choice(n, size=pod % 4, replace=False)] = True
        score = rng.integers(-(2**62), 2**62, size=(p, n)).astype(np.int64)
        return score, eligible, rng.integers(0, 3, size=n).astype(np.int32)
    if name == "INT64_MIN lanes":
        p, n = 19, 35
        score = rng.choice(np.array([INT64_MIN, INT64_MAX, 0, -1], dtype=np.int64), size=(p, n))
        score[3, :] = INT64_MIN
        return score, rng.random((p, n)) > 0.4, np.ones(n, dtype=np.int32)
    if name == "zero capacities":
        p, n = 23, 31
        capacity = np.where(rng.random(n) < 0.7, 0, 2).astype(np.int32)
        score = rng.integers(-9, 9, size=(p, n)).astype(np.int64)
        return score, rng.random((p, n)) > 0.2, capacity
    raise ValueError(name)


STAGED_CASES = [
    "odd shape 0",
    "odd shape 1",
    "odd shape 2",
    "lists used up mid-way",
    "ties straddle the list boundary",
    "rows with fewer ok lanes than the list",
    "INT64_MIN lanes",
    "zero capacities",
]


class TestStagedReference:
    """The plain model of the CUDA kernel's two stages (candidate lists of
    length k, then the in-order resolve with rescans) is exact against the
    plain loop, the JAX scan and the Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("k", [1, 2, 32])
    @pytest.mark.parametrize("case", STAGED_CASES)
    def test_equals_greedy(self, case, k):
        rng = np.random.default_rng(STAGED_CASES.index(case))
        score, eligible, capacity = _staged_case(case, rng)
        want = _check(score, eligible, capacity)
        got, rescans = assign.greedy_assign_staged_reference(
            torch.from_numpy(score), torch.from_numpy(eligible), torch.from_numpy(capacity), k
        )
        assert torch.equal(got.node_for_pod, want.node_for_pod)
        assert torch.equal(got.capacity_left, want.capacity_left)
        assert 0 <= rescans <= score.shape[0]

    @pytest.mark.parametrize("k, rescans", [(32, 468), (16, 484), (300, 0)])
    def test_contention_rescans(self, k, rescans):
        """500 pods, 300 nodes of capacity 1, equal scores: pod i takes node
        i; every pod after the k-th finds its list used up and rescans,
        unless the list holds the whole row."""
        p, n = 500, 300
        score = torch.zeros((p, n), dtype=torch.int64)
        eligible = torch.ones((p, n), dtype=torch.bool)
        capacity = torch.ones(n, dtype=torch.int32)
        got, count = assign.greedy_assign_staged_reference(score, eligible, capacity, k)
        want = assign.greedy_assign_reference(score, eligible, capacity)
        assert torch.equal(got.node_for_pod, want.node_for_pod)
        assert torch.equal(got.capacity_left, want.capacity_left)
        assert got.node_for_pod.tolist() == list(range(n)) + [-1] * (p - n)
        assert count == rescans

    def test_list_length_must_be_positive(self):
        with pytest.raises(ValueError, match="at least 1"):
            assign.greedy_assign_staged_reference(
                torch.zeros((1, 1), dtype=torch.int64),
                torch.ones((1, 1), dtype=torch.bool),
                torch.ones(1, dtype=torch.int32),
                0,
            )


class TestDispatch:
    def test_cpu_takes_plain_version_without_the_builder(self, monkeypatch):
        def refuse(*_args, **_kwargs):
            raise AssertionError("the CPU path touched the kernel builder")

        monkeypatch.setattr(_build, "find_nvcc", refuse)
        monkeypatch.setattr(_build, "build", refuse)
        monkeypatch.setattr(_build, "load", refuse)
        monkeypatch.setattr(cuda_assign.greedy_assign_cuda, "LAUNCHES", 0)
        rng = np.random.default_rng(3)
        score = torch.from_numpy(rng.integers(-100, 100, size=(7, 11)).astype(np.int64))
        eligible = torch.from_numpy(rng.random((7, 11)) > 0.2)
        capacity = torch.from_numpy(rng.integers(0, 3, size=11).astype(np.int32))
        got = assign.greedy_assign(score, eligible, capacity)
        want = assign.greedy_assign_reference(score, eligible, capacity)
        assert torch.equal(got.node_for_pod, want.node_for_pod)
        assert torch.equal(got.capacity_left, want.capacity_left)
        assert cuda_assign.greedy_assign_cuda.LAUNCHES == 0

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="not cuda"):
            cuda_assign.greedy_assign_cuda(
                torch.zeros((2, 3), dtype=torch.int64),
                torch.ones((2, 3), dtype=torch.bool),
                torch.ones(3, dtype=torch.int32),
            )

    def test_mixed_devices_refused(self):
        with pytest.raises(ValueError, match="different devices"):
            assign.greedy_assign(
                torch.zeros((2, 3), dtype=torch.int64),
                torch.ones((2, 3), dtype=torch.bool, device="meta"),
                torch.ones(3, dtype=torch.int32),
            )

    def test_library_named_by_source_and_flags(self, monkeypatch):
        path = _build.library_path("greedy_assign")
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith("libgreedy_assign-") and path.suffix == ".so"
        command = _build._nvcc_command("nvcc", "greedy_assign", path)
        assert "arch=compute_90a,code=sm_90a" in command
        assert command[-1] == str(_build.CSRC / "greedy_assign.cu")
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
        assert _build.library_path("greedy_assign") != path


def _lex_case(name):
    """(key int64 [P, N], valid bool [P, N]) for the argmin/argmax cases."""
    rng = np.random.default_rng(len(name))
    if name == "ties":
        key = rng.integers(-2, 2, size=(9, 17)).astype(np.int64)
        return key, rng.random((9, 17)) > 0.3
    if name == "INT64_MIN":
        key = rng.choice(np.array([INT64_MIN, INT64_MIN + 1, 0], dtype=np.int64), size=(7, 11))
        return key, rng.random((7, 11)) > 0.4
    if name == "INT64_MAX":
        key = rng.choice(np.array([INT64_MAX, INT64_MAX - 1, -1], dtype=np.int64), size=(7, 11))
        return key, rng.random((7, 11)) > 0.4
    if name == "all lanes masked":
        key = rng.integers(-(2**62), 2**62, size=(5, 13)).astype(np.int64)
        valid = rng.random((5, 13)) > 0.5
        valid[::2] = False
        return key, valid
    if name == "u32 limb edges":
        vals = np.array([2**31, 2**31 - 1, 2**32 - 1, 2**32, -(2**32), -(2**31), -1, 0], dtype=np.int64)
        return rng.choice(vals, size=(8, 24)), rng.random((8, 24)) > 0.2
    raise ValueError(name)


LEX_CASES = ["ties", "INT64_MIN", "INT64_MAX", "all lanes masked", "u32 limb edges"]


class TestLexReductions:
    """``lex_argmin`` and ``_row_lex_argmax`` exactly as the JAX package's
    split-int64 forms, row by row."""

    @pytest.mark.parametrize("case", LEX_CASES)
    def test_lex_argmin(self, case):
        key, valid = _lex_case(case)
        for row in range(key.shape[0]):
            want_idx, want_found = jax_assign.lex_argmin(
                jax_i64.from_int64(key[row]), jnp.asarray(valid[row])
            )
            idx, found = assign.lex_argmin(torch.from_numpy(key[row]), torch.from_numpy(valid[row]))
            assert idx.dtype == torch.int32 and found.dtype == torch.bool
            assert (int(idx), bool(found)) == (int(want_idx), bool(want_found)), row
        # the last axis, rows side by side
        idx, found = assign.lex_argmin(torch.from_numpy(key), torch.from_numpy(valid))
        want = [int(jax_assign.lex_argmin(jax_i64.from_int64(k), jnp.asarray(v))[0]) for k, v in zip(key, valid)]
        assert idx.tolist() == want
        assert found.tolist() == valid.any(axis=1).tolist()

    @pytest.mark.parametrize("case", LEX_CASES)
    def test_row_lex_argmax(self, case):
        score, ok = _lex_case(case)
        want = np.asarray(jax_assign._row_lex_argmax(jax_i64.from_int64(score), jnp.asarray(ok)))
        got = assign._row_lex_argmax(torch.from_numpy(score), torch.from_numpy(ok))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_ok_lane_at_int64_min_is_chosen(self):
        score = torch.tensor([[INT64_MIN, 4], [INT64_MAX, INT64_MIN]], dtype=torch.int64)
        ok = torch.tensor([[True, False], [False, True]])
        assert assign._row_lex_argmax(score, ok).tolist() == [0, 1]
        idx, found = assign.lex_argmin(torch.tensor([INT64_MAX, 3], dtype=torch.int64), torch.tensor([True, False]))
        assert (int(idx), bool(found)) == (0, True)


def _auction_draw(seed):
    """``tests/test_parallel.py::TestAuctionAssign``'s draw."""
    rng = np.random.default_rng(seed)
    p, n = int(rng.integers(1, 40)), int(rng.integers(1, 80))
    score = rng.integers(-3, 3, size=(p, n)).astype(np.int64) * (10 ** int(rng.integers(0, 15)))
    eligible = rng.random((p, n)) > 0.3
    capacity = rng.integers(0, 2, size=n).astype(np.int32)
    return score, eligible, capacity


class TestAuctionAssign:
    """The fixpoint equals JAX ``auction_assign_kernel`` and the greedy
    scan exactly."""

    def _check(self, score, eligible, capacity):
        got, rounds = assign.auction_assign(
            torch.from_numpy(score), torch.from_numpy(eligible), torch.from_numpy(capacity)
        )
        args = (jax_i64.from_int64(score), jnp.asarray(eligible), jnp.asarray(capacity))
        for want in (jax_assign.auction_assign_kernel(*args), greedy_assign_kernel(*args)):
            np.testing.assert_array_equal(got.node_for_pod.numpy(), np.asarray(want.node_for_pod))
            np.testing.assert_array_equal(got.capacity_left.numpy(), np.asarray(want.capacity_left))
        plain = assign.greedy_assign_reference(*(torch.from_numpy(x) for x in (score, eligible, capacity)))
        assert torch.equal(got.node_for_pod, plain.node_for_pod)
        assert torch.equal(got.capacity_left, plain.capacity_left)
        assert got.node_for_pod.dtype == torch.int32 and got.capacity_left.dtype == torch.int32
        assert 1 <= rounds <= score.shape[0] + 1
        return got, rounds

    @pytest.mark.parametrize("seed", range(6))
    def test_random_equivalence(self, seed):
        self._check(*_auction_draw(seed))

    def test_eviction_chain(self):
        """Pod 1 loses node 0 to pod 0 and must evict pod 2 from node 1."""
        score = np.array([[9, 1, 0], [9, 5, 1], [0, 9, 1]], dtype=np.int64)
        got, rounds = self._check(score, np.ones((3, 3), dtype=bool), np.ones(3, dtype=np.int32))
        assert got.node_for_pod.tolist() == [0, 1, 2]
        assert rounds >= 2

    @pytest.mark.parametrize("case", STAGED_CASES)
    def test_staged_cases(self, case):
        self._check(*_staged_case(case, np.random.default_rng(STAGED_CASES.index(case))))

    @pytest.mark.parametrize("shape", [(0, 5), (3, 0)])
    def test_empty(self, shape):
        p, n = shape
        got, rounds = assign.auction_assign(
            torch.zeros((p, n), dtype=torch.int64), torch.ones((p, n), dtype=torch.bool), torch.ones(n, dtype=torch.int32)
        )
        assert got.node_for_pod.tolist() == [-1] * p and rounds == 0
