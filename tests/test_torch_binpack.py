"""The port's GAS bin-pack (``ops/binpack.py``) held exactly against the
JAX package's ``binpack_kernel``: one seeded numpy state goes through JAX
(split int64) and, by way of ``convert.py``, through the port's plain
version.  ``fits`` and ``cards`` must be equal, element for element, on
the edge cases of ``tests/test_binpack_edges.py``, on the cases the CUDA
kernel's design turns on (repeat picks, card order unlike lane order,
inactive lanes, wide T x K, a grown C x R, R = 12, the JAX tie at order
2^30 with and without padding lanes) and on 256 random states with int64
values near the bounds.  The CUDA kernel itself runs only on the
card: ``chip_smoke.py`` holds it against this plain version there."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.ops import binpack as jax_binpack
from platform_aware_scheduling_tpu_torch import convert
from platform_aware_scheduling_tpu_torch.ops import binpack
from platform_aware_scheduling_tpu_torch.ops.i64 import split_int64

INT64_MAX = 2**63 - 1


@pytest.fixture(scope="module", autouse=True)
def threads_before_this_file():
    """The threads alive when this file's first test starts (a worker
    imports every test file at collection, before any runs)."""
    return set(threading.enumerate())


def twin_inputs(used, capacity, need, cap_present=None, card_valid=None, card_real=None,
                card_order=None, need_active=None, num_gpus=None, container_active=None):
    """(JAX state, JAX request, port state, port request) from numpy."""
    used = np.asarray(used, np.int64)
    capacity = np.asarray(capacity, np.int64)
    need = np.asarray(need, np.int64)
    n, c, r = used.shape
    t = need.shape[0]
    cap_present = np.ones((n, r), bool) if cap_present is None else np.asarray(cap_present, bool)
    card_valid = np.ones((n, c), bool) if card_valid is None else np.asarray(card_valid, bool)
    card_real = np.ones((n, c), bool) if card_real is None else np.asarray(card_real, bool)
    if card_order is None:
        card_order = np.broadcast_to(np.arange(c, dtype=np.int32), (n, c))
    card_order = np.asarray(card_order, np.int32)
    need_active = need != 0 if need_active is None else np.asarray(need_active, bool)
    num_gpus = np.ones(t, np.int32) if num_gpus is None else np.asarray(num_gpus, np.int32)
    container_active = np.ones(t, bool) if container_active is None else np.asarray(container_active, bool)

    used_hi, used_lo = split_int64(used)
    cap_hi, cap_lo = split_int64(capacity)
    need_hi, need_lo = split_int64(need)
    jax_state = jax_binpack.BinpackNodeState(
        used=jax_i64.I64(hi=jnp.asarray(used_hi), lo=jnp.asarray(used_lo)),
        capacity=jax_i64.I64(hi=jnp.asarray(cap_hi), lo=jnp.asarray(cap_lo)),
        cap_present=jnp.asarray(cap_present),
        card_valid=jnp.asarray(card_valid),
        card_real=jnp.asarray(card_real),
        card_order=jnp.asarray(card_order),
    )
    jax_request = jax_binpack.BinpackRequest(
        need=jax_i64.I64(hi=jnp.asarray(need_hi), lo=jnp.asarray(need_lo)),
        need_active=jnp.asarray(need_active),
        num_gpus=jnp.asarray(num_gpus),
        container_active=jnp.asarray(container_active),
    )
    state = convert.binpack_state_from_numpy(
        used_hi, used_lo, cap_hi, cap_lo, cap_present, card_valid, card_real, card_order, device="cpu"
    )
    request = convert.binpack_request_from_numpy(
        need_hi, need_lo, need_active, num_gpus, container_active, device="cpu"
    )
    return jax_state, jax_request, state, request


def run_both(max_gpus, *args, **kwargs):
    """Both packages' results on one input; asserts they are equal and
    returns the port's (fits, cards) as numpy."""
    jax_state, jax_request, state, request = twin_inputs(*args, **kwargs)
    want = jax_binpack.binpack_kernel(jax_state, jax_request, max_gpus)
    got = binpack.binpack(state, request, max_gpus)
    assert got.fits.dtype == torch.bool and got.cards.dtype == torch.int32
    fits, cards = got.fits.numpy(), got.cards.numpy()
    np.testing.assert_array_equal(fits, np.asarray(want.fits))
    np.testing.assert_array_equal(cards, np.asarray(want.cards))
    return fits, cards


# -- the edge cases of tests/test_binpack_edges.py, on both packages ------------------

EDGES = {
    # zero-card nodes
    "no real cards": (dict(used=[[[0], [0]]], capacity=[[100]], need=[[10]], card_real=[[False, False]]), 1, False),
    "no valid cards": (dict(used=[[[0], [0]]], capacity=[[100]], need=[[10]], card_valid=[[False, False]]), 1, False),
    "zero-GPU container on a cardless node": (
        dict(used=[[[0]]], capacity=[[100]], need=[[10]], card_real=[[False]], num_gpus=[0]), 1, True),
    # a request equal to the per-card capacity
    "need == capacity": (dict(used=[[[0]]], capacity=[[100]], need=[[100]]), 1, True),
    "one unit over": (dict(used=[[[1]]], capacity=[[100]], need=[[100]]), 1, False),
    "two full shares take two cards": (
        dict(used=[[[0], [0]]], capacity=[[100]], need=[[100]], num_gpus=[2]), 2, True),
    # int64 edges
    "sum overflowing int64": (dict(used=[[[INT64_MAX - 1]]], capacity=[[INT64_MAX]], need=[[2]]), 1, False),
    "sum landing on INT64_MAX": (dict(used=[[[INT64_MAX - 2]]], capacity=[[INT64_MAX]], need=[[2]]), 1, True),
    "capacity INT64_MAX, need INT64_MAX": (
        dict(used=[[[0]]], capacity=[[INT64_MAX]], need=[[INT64_MAX]]), 1, True),
    "used INT64_MAX, need 1": (dict(used=[[[INT64_MAX]]], capacity=[[INT64_MAX]], need=[[1]]), 1, False),
    "negative need": (dict(used=[[[0]]], capacity=[[100]], need=[[-1]]), 1, False),
    "negative used": (dict(used=[[[-1]]], capacity=[[100]], need=[[1]]), 1, False),
    "capacity 0": (dict(used=[[[0]]], capacity=[[0]], need=[[1]]), 1, False),
    "capacity negative": (dict(used=[[[0]]], capacity=[[-5]], need=[[1]]), 1, False),
    "capacity absent": (dict(used=[[[0]]], capacity=[[100]], need=[[1]], cap_present=[[False]]), 1, False),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_case(name):
    inputs, max_gpus, expected = EDGES[name]
    fits, _cards = run_both(max_gpus, **inputs)
    assert bool(fits[0]) is expected


def test_two_full_shares_pick_cards_in_order():
    _fits, cards = run_both(2, **EDGES["two full shares take two cards"][0])
    assert cards[0, 0].tolist() == [0, 1]


def test_repeat_picks_on_one_card():
    """A card with room for several shares takes them all before the next
    card (first fit, not spread)."""
    fits, cards = run_both(4, used=[[[0], [0]]], capacity=[[100]], need=[[25]], num_gpus=[4])
    assert fits[0] and cards[0, 0].tolist() == [0, 0, 0, 0]


def test_card_order_unlike_lane_order():
    """The mirror interns lanes append-only, so first fit follows
    card_order, ties to the smaller lane."""
    fits, cards = run_both(
        3, used=[[[0], [0], [0], [0]]], capacity=[[100]], need=[[60]], num_gpus=[3],
        card_order=[[3, 1, 1, 0]],
    )
    assert fits[0] and cards[0, 0].tolist() == [3, 1, 2]


def test_orders_past_big_order():
    """The JAX min over ``where(fits, order, big_order)``: a fitting lane
    whose order passes big_order is chosen when every lane fits, and lost
    beside a lane that does not fit; the port does the same."""
    fits, _cards = run_both(1, used=[[[0]]], capacity=[[100]], need=[[1]], card_order=[[2**30 + 1]])
    assert fits[0]
    fits, _cards = run_both(
        1, used=[[[0], [0]]], capacity=[[100]], need=[[1]], card_order=[[2**30 + 1, 0]],
        card_valid=[[True, False]],
    )
    assert not fits[0]


def test_inactive_lane_neither_gates_nor_books():
    """Resource 1 is absent from the request: its negative used, missing
    capacity and huge need do not matter, and nothing is booked there."""
    fits, cards = run_both(
        2,
        used=[[[0, -7]]],
        capacity=[[100, 0]],
        need=[[50, INT64_MAX]],
        need_active=[[True, False]],
        cap_present=[[True, False]],
        num_gpus=[2],
    )
    assert fits[0] and cards[0, 0].tolist() == [0, 0]


def test_later_containers_pick_after_a_failure():
    """The scan goes on after a container fails: cards is filled the same."""
    fits, cards = run_both(
        1, used=[[[0], [0]]], capacity=[[100]], need=[[500], [10]], num_gpus=[1, 1]
    )
    assert not fits[0] and cards[0, :, 0].tolist() == [-1, 0]


def test_inactive_container_books_nothing():
    fits, cards = run_both(
        2, used=[[[0]]], capacity=[[100]], need=[[500], [10]], num_gpus=[2, 1],
        container_active=[False, True],
    )
    assert fits[0] and cards[0].tolist() == [[-1, -1], [0, -1]]


def test_wide_request_t4_k8():
    rng = np.random.default_rng(4)
    n, c, r = 16, 8, 4
    run_both(
        8,
        used=rng.integers(0, 40, (n, c, r)),
        capacity=rng.integers(50, 200, (n, r)),
        need=rng.integers(0, 30, (4, r)),
        num_gpus=[8, 3, 0, 5],
        container_active=[True, True, True, False],
    )


def test_grown_mirror_c16_r8():
    rng = np.random.default_rng(5)
    n, c, r = 16, 16, 8
    run_both(
        4,
        used=rng.integers(0, 40, (n, c, r)),
        capacity=rng.integers(50, 200, (n, r)),
        need=rng.integers(0, 30, (2, r)),
        need_active=rng.random((2, r)) < 0.6,
        cap_present=rng.random((n, r)) < 0.9,
        card_valid=rng.random((n, c)) < 0.9,
        card_real=np.arange(c)[None, :] < rng.integers(1, c + 1, (n, 1)),
        card_order=np.stack([rng.permutation(c) for _ in range(n)]),
        num_gpus=[4, 2],
    )


# -- random states near the int64 bounds -------------------------------------------------

SHAPES = ((8, 4, 4, 2, 2), (8, 8, 4, 2, 4), (8, 4, 2, 4, 2))


def random_state(rng):
    n, c, r, t, k = SHAPES[int(rng.integers(len(SHAPES)))]

    def values(shape, hi):
        v = rng.integers(0, hi, size=shape, dtype=np.int64)
        pick = rng.random(shape)
        v = np.where(pick < 0.06, INT64_MAX - rng.integers(0, 4, size=shape), v)
        v = np.where((pick >= 0.06) & (pick < 0.09), -rng.integers(1, 4, size=shape), v)
        return v

    return k, dict(
        used=values((n, c, r), 60),
        capacity=values((n, r), 120),
        need=values((t, r), 50),
        cap_present=rng.random((n, r)) < 0.9,
        card_valid=rng.random((n, c)) < 0.9,
        card_real=rng.random((n, c)) < 0.9,
        card_order=np.where(
            rng.random((n, c)) < 0.05,
            2**30 + rng.integers(0, 2, (n, c)),
            np.stack([rng.permutation(c) for _ in range(n)]),
        ),
        need_active=rng.random((t, r)) < 0.7,
        num_gpus=rng.integers(0, k + 1, size=t),
        container_active=rng.random(t) < 0.9,
    )


@pytest.mark.parametrize("seed", range(8))
def test_random_states(seed):
    """32 states a seed, 256 in all; each must match exactly."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(32):
        k, inputs = random_state(rng)
        run_both(k, **inputs)


# -- fit_one_node, the dispatch, the conversion ---------------------------------------------


def check_fit_one_node(k, inputs):
    """``fit_one_node`` against the JAX ``_fit_one_node`` on every row."""
    jax_state, jax_request, state, request = twin_inputs(**inputs)
    jax_fit_one_node = jax.jit(jax_binpack._fit_one_node, static_argnums=6)
    for row in range(state.used.shape[0]):
        ok, picks, used_out = binpack.fit_one_node(
            state.used[row], state.capacity[row], state.cap_present[row],
            state.card_valid[row] & state.card_real[row], state.card_order[row], request, k,
        )
        j_ok, j_picks, j_used = jax_fit_one_node(
            jax_i64.I64(hi=jax_state.used.hi[row], lo=jax_state.used.lo[row]),
            jax_i64.I64(hi=jax_state.capacity.hi[row], lo=jax_state.capacity.lo[row]),
            jax_state.cap_present[row],
            jax_state.card_valid[row] & jax_state.card_real[row],
            jax_state.card_order[row],
            jax_request,
            k,
        )
        assert bool(ok) == bool(j_ok)
        np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
        if bool(ok):  # used_out means something only where the pod fits
            np.testing.assert_array_equal(used_out.numpy(), jax_i64.to_int64_np(j_used))


def test_fit_one_node_matches_jax():
    rng = np.random.default_rng(9)
    check_fit_one_node(*random_state(rng))


# -- the cases the CUDA kernel's selection and layout turn on ----------------------------

BIG = 2**30
TIE_CASES = {
    # best is the min over real lanes of where(fits, order, 2^30): a fitting
    # lane of order exactly 2^30 is picked above a lower lane that does not
    # fit; one past 2^30 is lost beside it
    "a fitting lane of order 2^30 above a lower lane that does not fit": (2, dict(
        used=[[[0] * 4] * 8, [[50] + [0] * 3] + [[0] * 4] * 7, [[0] * 4] * 8,
              [[0] * 4, [90] + [0] * 3] + [[0] * 4] * 6],
        capacity=[[100] * 4] * 4, need=[[60, 0, 0, 0]], num_gpus=[2],
        card_valid=[[False] + [True] * 7] + [[True] * 8] * 3,
        card_order=[[0, BIG] + [BIG + 1] * 6, [0, BIG, BIG] + [BIG + 1] * 5,
                    [BIG + 2, BIG + 1, BIG + 1] + [BIG + 3] * 5, [BIG, 7, 9, BIG] + [BIG + 5] * 4],
    ), ([False, True, False, True], [[1, -1], [1, 2], [1, -1], [2, 0]])),
    # C = 5, which the kernel spreads over a group of 8 lanes: the 3 padding
    # lanes must not stand in for JAX lanes beside orders past 2^30
    "padding lanes (C=5 in a group of 8) beside orders past 2^30": (2, dict(
        used=[[[0] * 4] * 5] * 4, capacity=[[100] * 4] * 4, need=[[40, 0, 0, 0]], num_gpus=[2],
        card_valid=[[True, False, False, False, False]] + [[True] * 5] * 3,
        card_real=[[True] * 5, [True] * 5, [True, True, True, False, False], [True] * 5],
        card_order=[[BIG + 1, 0, 1, 2, 3], [BIG + 3, BIG + 1, BIG + 2, BIG + 1, BIG + 5],
                    [BIG + 1, BIG + 2, BIG + 3, 0, 1], [5, BIG + 1, 3, BIG + 1, BIG + 2]],
    ), ([False, True, False, True], [[-1, -1], [1, 1], [-1, -1], [2, 2]])),
}


@pytest.mark.parametrize("name", sorted(TIE_CASES))
def test_order_tie_at_big_order(name):
    k, inputs, (want_fits, want_cards) = TIE_CASES[name]
    fits, cards = run_both(k, **inputs)
    assert fits.tolist() == want_fits and cards[:, 0].tolist() == want_cards


@pytest.mark.parametrize("name", sorted(TIE_CASES))
def test_order_tie_at_big_order_fit_one_node(name):
    k, inputs, _want = TIE_CASES[name]
    check_fit_one_node(k, inputs)


def r12_state():
    """A mirror grown to R = 12 resources: the kernel holds 8 in registers
    and the rest in shared memory."""
    rng = np.random.default_rng(15)
    n, c, r = 16, 8, 12
    return 3, dict(
        used=rng.integers(0, 40, (n, c, r)),
        capacity=rng.integers(60, 200, (n, r)),
        need=rng.integers(0, 30, (3, r)),
        need_active=rng.random((3, r)) < 0.5,
        cap_present=rng.random((n, r)) < 0.98,
        card_valid=rng.random((n, c)) < 0.9,
        card_real=np.arange(c)[None, :] < rng.integers(1, c + 1, (n, 1)),
        card_order=np.stack([rng.permutation(c) for _ in range(n)]),
        num_gpus=[3, 1, 2],
    )


def test_grown_mirror_r12():
    k, inputs = r12_state()
    fits, cards = run_both(k, **inputs)
    assert fits.any() and (cards >= 0).any()


def test_grown_mirror_r12_fit_one_node():
    check_fit_one_node(*r12_state())


def test_cpu_dispatch_is_the_reference():
    _k, inputs = random_state(np.random.default_rng(11))
    _js, _jr, state, request = twin_inputs(**inputs)
    a = binpack.binpack(state, request, 2)
    b = binpack.binpack_reference(state, request, 2)
    assert torch.equal(a.fits, b.fits) and torch.equal(a.cards, b.cards)


def test_dispatch_refuses_mixed_and_unknown_devices():
    _k, inputs = random_state(np.random.default_rng(12))
    _js, _jr, state, request = twin_inputs(**inputs)
    with pytest.raises(ValueError, match="different devices"):
        binpack.binpack(state._replace(used=state.used.to("meta")), request, 2)
    meta_state = binpack.BinpackNodeState(*(x.to("meta") for x in state))
    meta_request = binpack.BinpackRequest(*(x.to("meta") for x in request))
    with pytest.raises(ValueError, match="no path"):
        binpack.binpack(meta_state, meta_request, 2)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version: CPU tensors are
    refused before any build."""
    from platform_aware_scheduling_tpu_torch.ops.cuda_binpack import binpack_cuda

    _k, inputs = random_state(np.random.default_rng(13))
    _js, _jr, state, request = twin_inputs(**inputs)
    launches = binpack_cuda.LAUNCHES
    with pytest.raises(ValueError, match="not cuda"):
        binpack_cuda(state, request, 2)
    assert binpack_cuda.LAUNCHES == launches


def test_conversion_round_trip():
    rng = np.random.default_rng(14)
    used = rng.integers(-(2**63), 2**63 - 1, size=(4, 4, 4), dtype=np.int64)
    used[0, 0, 0], used[0, 0, 1] = INT64_MAX, -(2**63)
    hi, lo = jax_i64.split_int64_np(used)
    z = np.zeros((4, 4), bool)
    state = convert.binpack_state_from_numpy(hi, lo, hi[:, 0], lo[:, 0], z, z, z, z.astype(np.int32), device="cpu")
    assert state.used.dtype == torch.int64
    np.testing.assert_array_equal(state.used.numpy(), used)
    np.testing.assert_array_equal(state.capacity.numpy(), used[:, 0])


def test_conversion_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.binpack_request_from_numpy(
            np.zeros((2, 4), np.int32), np.zeros((2, 4), np.uint32), np.zeros((2, 4), bool),
            np.zeros(2, np.int32), np.zeros(2, bool),
        )


def test_no_thread_left_running(threads_before_this_file):
    assert not [t for t in threading.enumerate() if t not in threads_before_this_file and t.is_alive()]
