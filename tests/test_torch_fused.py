"""The port's fused TAS+GAS solve (``models/fused.py``) held exactly against
the JAX package's ``fused_schedule`` on the CPU.  Each problem is drawn by
``benchmarks/configs._fused_problem`` (the recipe of BASELINE config #4),
edited in numpy where a case asks for it, and carried into the port with
``convert.py``; all five outputs must be equal, element for element.  The
CUDA kernel runs only on the card: ``chip_smoke.py`` holds it against the
plain scan there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks.configs import _fused_problem, _host_fused_control
from platform_aware_scheduling_tpu.models import fused as jax_fused
from platform_aware_scheduling_tpu.ops import binpack as jax_binpack
from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu_torch import convert
from platform_aware_scheduling_tpu_torch.models import fused
from platform_aware_scheduling_tpu_torch.ops import _build, cuda_binpack, cuda_fused
from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackRequest, fit_one_node
from platform_aware_scheduling_tpu_torch.ops.i64 import INT64_MAX, split_int64


def _carried(jax_state, jax_pods):
    """The JAX (state, pods) as the port sees them, through convert.py."""
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
        np.asarray(jax_pods.metric_row), np.asarray(jax_pods.op_id), np.asarray(jax_pods.candidates), device="cpu"
    )
    return state, pods


def _jax_i64(values):
    hi, lo = split_int64(values)
    return jax_i64.I64(hi=jnp.asarray(hi), lo=jnp.asarray(lo))


def _numpy_problem(num_nodes, num_pods, seed, **kw):
    """``_fused_problem``'s draw, its GAS state and classes as numpy."""
    state, pods, req_class, gas, requests, max_gpus, hosts = _fused_problem(
        num_nodes=num_nodes, num_pods=num_pods, seed=seed, **kw
    )
    gas_np = {
        "used": jax_i64.to_int64_np(gas.used),
        "capacity": jax_i64.to_int64_np(gas.capacity),
        "cap_present": np.asarray(gas.cap_present).copy(),
        "card_valid": np.asarray(gas.card_valid).copy(),
        "card_real": np.asarray(gas.card_real).copy(),
        "card_order": np.asarray(gas.card_order).copy(),
    }
    req_np = {
        "need": jax_i64.to_int64_np(requests.need),
        "need_active": np.asarray(requests.need_active).copy(),
        "num_gpus": np.asarray(requests.num_gpus).copy(),
        "container_active": np.asarray(requests.container_active).copy(),
    }
    return state, pods, np.asarray(req_class).copy(), gas_np, req_np, max_gpus, hosts


def _solve_both(state, pods, req_class, gas_np, req_np, max_gpus):
    """(JAX output, port output) on one problem."""
    jax_gas = jax_binpack.BinpackNodeState(
        used=_jax_i64(gas_np["used"]),
        capacity=_jax_i64(gas_np["capacity"]),
        cap_present=jnp.asarray(gas_np["cap_present"]),
        card_valid=jnp.asarray(gas_np["card_valid"]),
        card_real=jnp.asarray(gas_np["card_real"]),
        card_order=jnp.asarray(gas_np["card_order"]),
    )
    jax_requests = jax_fused.FusedRequests(
        need=_jax_i64(req_np["need"]),
        need_active=jnp.asarray(req_np["need_active"]),
        num_gpus=jnp.asarray(req_np["num_gpus"]),
        container_active=jnp.asarray(req_np["container_active"]),
    )
    want = jax_fused.fused_schedule(state, pods, jnp.asarray(req_class), jax_gas, jax_requests, max_gpus)

    port_state, port_pods = _carried(state, pods)
    used_hi, used_lo = split_int64(gas_np["used"])
    cap_hi, cap_lo = split_int64(gas_np["capacity"])
    gas = convert.binpack_state_from_numpy(
        used_hi, used_lo, cap_hi, cap_lo, gas_np["cap_present"], gas_np["card_valid"],
        gas_np["card_real"], gas_np["card_order"], device="cpu",
    )
    need_hi, need_lo = split_int64(req_np["need"])
    requests = convert.fused_requests_from_numpy(
        need_hi, need_lo, req_np["need_active"], req_np["num_gpus"], req_np["container_active"], device="cpu"
    )
    got = fused.fused_schedule(
        port_state, port_pods, torch.from_numpy(req_class.astype(np.int32)), gas, requests, max_gpus
    )
    return want, got


def _assert_equal(want, got):
    np.testing.assert_array_equal(got.node_for_pod.numpy(), np.asarray(want.node_for_pod))
    np.testing.assert_array_equal(got.capacity_left.numpy(), np.asarray(want.capacity_left))
    np.testing.assert_array_equal(got.used.numpy(), jax_i64.to_int64_np(want.used))
    np.testing.assert_array_equal(got.fits.numpy(), np.asarray(want.fits))
    np.testing.assert_array_equal(got.violating.numpy(), np.asarray(want.violating))
    assert got.node_for_pod.dtype == torch.int32 and got.capacity_left.dtype == torch.int32
    assert got.used.dtype == torch.int64 and got.fits.dtype == torch.bool


# the shapes of tests/test_fused.py::TestFusedParity: (nodes, pods, seed, _fused_problem options)
PARITY = {
    "small": (32, 12, 7, {}),
    "medium": (200, 64, 11, {"num_cards": 4, "num_classes": 4}),
    "scarce cards": (24, 40, 3, {"num_cards": 2, "num_res": 2}),
    **{
        f"seed sweep {seed}": (48, 20, seed, {"num_cards": 3, "num_res": 2, "num_classes": 2})
        for seed in range(6)
    },
    "revival": (16, 12, 23, {"num_cards": 3, "num_res": 2, "num_classes": 2}),
}

# three cards of room (10, 10) booked (0, 0), (10, 10) and (0, 5); class X
# books (10, 0) on one card, class Y (1, 5) then (0, 8)
REVIVAL_USED = [[0, 0], [10, 10], [0, 5]]
REVIVAL_NEED = [[[10, 0], [0, 0]], [[1, 5], [0, 8]]]


def _revival_edit(state, pods, req_class, gas_np, req_np, hosts):
    """Every node as REVIVAL_USED: class Y (1) fits no node until class X
    (0) books a node's first card.  The classes alternate from X, every pod
    may use every node and each node takes three pods; the host control's
    GAS state is edited alike."""
    gas_np["capacity"][:] = 10
    gas_np["used"][:] = REVIVAL_USED
    req_np["need"][:] = REVIVAL_NEED
    req_np["need_active"][:] = True
    req_np["num_gpus"][:] = [[1, 0], [1, 1]]
    req_np["container_active"][:] = True
    hosts.update(cap=gas_np["capacity"], used=gas_np["used"], need=req_np["need"],
                 need_active=req_np["need_active"], num_gpus=req_np["num_gpus"])
    req_class = (np.arange(req_class.shape[0]) % 2).astype(req_class.dtype)
    state = state._replace(capacity=jnp.full_like(state.capacity, 3))
    pods = pods._replace(candidates=jnp.ones_like(pods.candidates))
    return state, pods, req_class


EDITS = {"revival": _revival_edit}


class TestFusedParity:
    @pytest.mark.parametrize("case", list(PARITY))
    def test_equals_jax(self, case):
        nodes, pods_n, seed, kw = PARITY[case]
        state, pods, req_class, gas_np, req_np, max_gpus, hosts = _numpy_problem(nodes, pods_n, seed, **kw)
        if case in EDITS:
            state, pods, req_class = EDITS[case](state, pods, req_class, gas_np, req_np, hosts)
        want, got = _solve_both(state, pods, req_class, gas_np, req_np, max_gpus)
        _assert_equal(want, got)
        # and the sequential TAS-then-GAS host control agrees
        host_assign, _ = _host_fused_control(state, pods, req_class, hosts, nodes, pods_n)
        np.testing.assert_array_equal(got.node_for_pod.numpy(), host_assign)
        if case == "scarce cards":
            assert (got.node_for_pod == -1).any()  # scarcity reached
        if case == "revival":
            # each Y pod lands on the node the X pod before it booked, which
            # Y did not fit at the start: its fit there was turned back on
            placed = got.node_for_pod.numpy()
            later = np.flatnonzero(req_class == 1)
            assert (placed[later] >= 0).all()
            np.testing.assert_array_equal(placed[later], placed[later - 1])

    def test_inactive_resource_not_booked(self):
        """A resource absent from a class (need_active False) with a huge
        padded need neither gates nor books a card."""
        state, pods, req_class, gas_np, req_np, max_gpus, _ = _numpy_problem(24, 30, 5, num_res=2, num_cards=2)
        req_np["need_active"][:, :, 1] = False
        req_np["need"][:, :, 1] = 10**15
        want, got = _solve_both(state, pods, req_class, gas_np, req_np, max_gpus)
        _assert_equal(want, got)
        assert (got.node_for_pod >= 0).any()
        np.testing.assert_array_equal(got.used[..., 1].numpy(), gas_np["used"][..., 1])

    def test_inactive_containers_and_a_class_that_fits_nowhere(self):
        state, pods, req_class, gas_np, req_np, max_gpus, _ = _numpy_problem(40, 30, 9)
        req_np["container_active"][0, 1] = False
        req_np["need"][1, 0, 0] = 10**6  # above every capacity: class 1 fits no node
        req_np["need_active"][1, 0, 0] = True
        want, got = _solve_both(state, pods, req_class, gas_np, req_np, max_gpus)
        _assert_equal(want, got)
        assert not got.fits[1].any()
        assert (got.node_for_pod[torch.from_numpy(req_class == 1)] == -1).all()

    def test_int64_near_wrap_usage(self):
        """Cards booked to within 300 of INT64_MAX under a capacity near it:
        the check is ``used <= capacity - need``, never the sum."""
        state, pods, req_class, gas_np, req_np, max_gpus, _ = _numpy_problem(40, 30, 13)
        rng = np.random.default_rng(13)
        near = rng.random(gas_np["used"].shape[:2]) < 0.5
        gas_np["capacity"][:] = INT64_MAX - rng.integers(0, 200, size=gas_np["capacity"].shape)
        slack = rng.integers(0, 300, size=gas_np["used"].shape)
        gas_np["used"] = np.where(near[..., None], INT64_MAX - slack, gas_np["used"])
        want, got = _solve_both(state, pods, req_class, gas_np, req_np, max_gpus)
        _assert_equal(want, got)
        assert (got.node_for_pod >= 0).any()

    def test_card_order_past_2_30(self):
        """A fitting card whose order passes 2**30 is lost beside a card
        that does not fit, as in the reference; one at exactly 2**30 is
        taken."""
        state, pods, req_class, gas_np, req_np, max_gpus, _ = _numpy_problem(40, 30, 17, num_cards=4)
        rng = np.random.default_rng(17)
        order = gas_np["card_order"]
        order[::3, 0] = 2**30 + 1 + rng.integers(0, 5, size=order[::3, 0].shape)
        order[1::3, 1] = 2**30
        gas_np["used"][::2, 2:, :] = gas_np["capacity"][::2, None, :]  # full cards beside them
        gas_np["card_valid"][5::7, 3] = False
        gas_np["card_real"][6::7, 2] = False
        want, got = _solve_both(state, pods, req_class, gas_np, req_np, max_gpus)
        _assert_equal(want, got)

    def test_zero_capacity_and_absent_resources(self):
        state, pods, req_class, gas_np, req_np, max_gpus, _ = _numpy_problem(36, 24, 19)
        state = state._replace(capacity=state.capacity.at[::4].set(0))
        gas_np["cap_present"][1::5, 0] = False
        gas_np["capacity"][2::5, 1] = 0
        want, got = _solve_both(state, pods, req_class, gas_np, req_np, max_gpus)
        _assert_equal(want, got)
        assert not (got.node_for_pod.numpy()[:, None] == np.arange(0, 36, 4)[None, :]).any()

    def test_capacity_left_consistent(self):
        state, pods, req_class, gas_np, req_np, max_gpus, _ = _numpy_problem(32, 12, 7)
        _want, got = _solve_both(state, pods, req_class, gas_np, req_np, max_gpus)
        cap0 = np.asarray(state.capacity)
        assigned = got.node_for_pod.numpy()
        booked = np.bincount(assigned[assigned >= 0], minlength=cap0.shape[0])
        np.testing.assert_array_equal(got.capacity_left.numpy(), cap0 - booked)
        assert (got.capacity_left >= 0).all()
        assert (got.used.numpy() >= gas_np["used"]).all()


class TestRevival:
    def test_a_booking_turns_a_fit_back_on(self):
        """First-fit over several resources is not monotone in usage: Y does
        not fit REVIVAL_USED, X books its first card, and then Y fits."""
        cap = torch.full((2,), 10, dtype=torch.int64)
        args = (cap, torch.ones(2, dtype=torch.bool), torch.ones(3, dtype=torch.bool), torch.arange(3, dtype=torch.int32))

        def request(cls):
            need = torch.tensor(REVIVAL_NEED[cls], dtype=torch.int64)
            gpus = torch.tensor([[1, 0], [1, 1]][cls], dtype=torch.int32)
            return BinpackRequest(need, torch.ones((2, 2), dtype=torch.bool), gpus, torch.ones(2, dtype=torch.bool))

        used = torch.tensor(REVIVAL_USED, dtype=torch.int64)
        assert not bool(fit_one_node(used, *args, request(1), 2)[0])
        ok, _picks, booked = fit_one_node(used, *args, request(0), 2)
        assert bool(ok) and booked[0].tolist() == [10, 0]
        assert bool(fit_one_node(booked, *args, request(1), 2)[0])


class TestStagedModel:
    """``models/fused.fused_scan_staged_reference``, the plain model of the
    kernel's two launches, equals the plain scan on every edge case of the
    chip script, at the kernel's list sizes and at sizes so small that the
    lists run out and the revived lists overflow."""

    @pytest.mark.parametrize("sizes", [(cuda_fused.LIST_SIZE, cuda_fused.REVIVED_SIZE), (2, 1)], ids=["kernel", "tiny"])
    @pytest.mark.parametrize("name", [name for name, _problem in chip_smoke.fused_edge_cases(torch, np, "cpu")])
    def test_equals_the_plain_scan(self, name, sizes):
        problem = dict(chip_smoke.fused_edge_cases(torch, np, "cpu"))[name]
        args = chip_smoke.fused_scan_args(torch, problem)
        want = fused.fused_scan_reference(*args)
        got, stats = fused.fused_scan_staged_reference(*args, *sizes)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if sizes == (2, 1) and problem.pods.candidates.shape[0] > 2:
            assert stats.rescans > 0

    def test_refuses_an_empty_list(self):
        problem = chip_smoke.fused_problem(torch, np, "cpu", num_nodes=8, num_pods=2)
        with pytest.raises(ValueError, match="at least 1"):
            fused.fused_scan_staged_reference(*chip_smoke.fused_scan_args(torch, problem), 0, 1)


class TestChipRecipe:
    @pytest.mark.parametrize("name", list(chip_smoke.FUSED_CASE_WANTS))
    def test_edge_case_exercises_what_it_names(self, name):
        """The revival, overflow, rescan and exhausted-list cases of the chip
        script really revive, rescan and use up a complete list under the
        plain scan and the staged model at the kernel's sizes, so none can
        silently stop testing what it names."""
        problem = dict(chip_smoke.fused_edge_cases(torch, np, "cpu"))[name]
        args = chip_smoke.fused_scan_args(torch, problem)
        want = fused.fused_scan_reference(*args)
        _scan, stats = fused.fused_scan_staged_reference(*args, cuda_fused.LIST_SIZE, cuda_fused.REVIVED_SIZE)
        facts = chip_smoke.fused_case_facts(torch, args, want.node_for_pod, stats)
        for key in chip_smoke.FUSED_CASE_WANTS[name]:
            assert facts[key] > 0, (name, key, facts)

    def test_chip_smoke_draws_the_benchmark_problem(self):
        """``chip_smoke.fused_problem`` (the chip script's numpy copy of
        ``_fused_problem``, which imports nothing of the JAX package) draws
        the same problem."""
        nodes, pods_n = 64, 20
        state, pods, req_class, gas_np, req_np, max_gpus, _ = _numpy_problem(nodes, pods_n, 21)
        mine = chip_smoke.fused_problem(torch, np, "cpu", num_nodes=nodes, num_pods=pods_n)
        port_state, port_pods = _carried(state, pods)
        for got, want in zip((*mine.state, *mine.pods), (*port_state, *port_pods)):
            if isinstance(want, tuple):
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
            else:
                assert torch.equal(got, want)
        np.testing.assert_array_equal(mine.req_class.numpy(), req_class)
        for name, want in gas_np.items():
            np.testing.assert_array_equal(getattr(mine.gas, name).numpy(), want)
        for name, want in req_np.items():
            np.testing.assert_array_equal(getattr(mine.requests, name).numpy(), want)
        assert mine.max_gpus == max_gpus

    def test_edge_cases_solve_alike_on_the_cpu(self):
        """The chip script's edge cases run through both plain paths here
        (the kernel meets them on the card)."""
        for name, problem in chip_smoke.fused_edge_cases(torch, np, "cpu"):
            got = fused.fused_schedule(*problem)
            want = fused.fused_schedule_reference(*problem)
            for g, w in zip(got, want):
                assert torch.equal(g, w), name


class TestDispatch:
    def test_cpu_takes_plain_version_without_the_builder(self, monkeypatch):
        def refuse(*_args, **_kwargs):
            raise AssertionError("the CPU path touched the kernel builder")

        monkeypatch.setattr(_build, "find_nvcc", refuse)
        monkeypatch.setattr(_build, "build", refuse)
        monkeypatch.setattr(_build, "load", refuse)
        monkeypatch.setattr(cuda_fused.fused_schedule_cuda, "LAUNCHES", 0)
        monkeypatch.setattr(cuda_binpack.binpack_cuda, "LAUNCHES", 0)
        problem = chip_smoke.fused_problem(torch, np, "cpu", num_nodes=40, num_pods=10)
        got = fused.fused_schedule(*problem)
        want = fused.fused_schedule_reference(*problem)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert cuda_fused.fused_schedule_cuda.LAUNCHES == 0
        assert cuda_binpack.binpack_cuda.LAUNCHES == 0

    def test_mixed_devices_refused(self):
        problem = chip_smoke.fused_problem(torch, np, "cpu", num_nodes=8, num_pods=2)
        with pytest.raises(ValueError, match="different devices"):
            fused.fused_scan(
                torch.zeros((2, 8), dtype=torch.int64, device="meta"),
                torch.ones((2, 8), dtype=torch.bool),
                problem.state.capacity,
                problem.req_class,
                torch.ones((3, 8), dtype=torch.bool),
                problem.gas,
                problem.requests,
                problem.max_gpus,
            )
