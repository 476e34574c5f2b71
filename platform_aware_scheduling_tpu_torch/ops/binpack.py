"""GAS first-fit card bin-packing of one pod against every candidate node.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/binpack.py``
(``binpack_kernel``, with ``_fit_one_node`` and ``_card_fits``).  Reference
semantics (gpu-aware-scheduling/pkg/gpuscheduler/scheduler.go:200-257,
341-383): for each container, each per-GPU share of its request goes to
the first card (sorted name order, carried as ``card_order``) where
``used + need <= capacity`` for every requested resource; a card may be
picked again for the same container while it has room; capacity absent or
``<= 0`` for a requested resource fails; a negative need or used fails; an
int64 overflow of ``used + need`` fails.

Values are native ``torch.int64`` (``ops/i64.py``).  The check never forms
the sum: ``used <= capacity - need`` is the same verdict, and with
``capacity > 0`` and ``need >= 0`` the difference cannot overflow, so no
step relies on wrapping arithmetic.

:func:`binpack` dispatches on where the tensors live: the plain version
:func:`binpack_reference` for CPU tensors, the hand-written CUDA kernel
(``ops/cuda_binpack.py`` → ``csrc/binpack.cu``) for CUDA tensors.  A CUDA
tensor never takes the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NO_CARD = -1
#: the card_order of a lane that cannot fit (the JAX ``big_order``)
BIG_ORDER = 2**30


class BinpackRequest(NamedTuple):
    """Per-container per-GPU shares, padded to T containers x R resources."""

    need: torch.Tensor  # int64 [T, R] per-GPU request share (host-divided)
    need_active: torch.Tensor  # bool [T, R] — resource present in the request
    num_gpus: torch.Tensor  # int32 [T] — the container's i915 count
    container_active: torch.Tensor  # bool [T] — real (non-padding) container


class BinpackNodeState(NamedTuple):
    """Per-node card state, padded to N nodes x C cards x R resources."""

    used: torch.Tensor  # int64 [N, C, R] booked usage
    capacity: torch.Tensor  # int64 [N, R] per-GPU capacity (homogeneous cards)
    cap_present: torch.Tensor  # bool [N, R] — resource in the node's capacity
    card_valid: torch.Tensor  # bool [N, C] — card still in the GPU label
    card_real: torch.Tensor  # bool [N, C] — non-padding lane
    # first-fit priority of each lane (lower = earlier): a persistent mirror
    # interns lanes append-only, so name order is carried, not assumed
    card_order: torch.Tensor  # int32 [N, C]


class BinpackResult(NamedTuple):
    fits: torch.Tensor  # bool [N]
    cards: torch.Tensor  # int32 [N, T, K] chosen card lane per GPU, -1 = none


def _card_fits(
    used: torch.Tensor,  # int64 [..., C, R]
    need: torch.Tensor,  # int64 [R]
    need_active: torch.Tensor,  # bool [R]
    capacity: torch.Tensor,  # int64 [..., R]
    cap_present: torch.Tensor,  # bool [..., R]
    card_ok: torch.Tensor,  # bool [..., C]
) -> torch.Tensor:
    """checkResourceCapacity (scheduler.go:341-383) for every card at once;
    bool [..., C].  An inactive resource lane neither gates a card nor
    counts."""
    cap_ok = cap_present & (capacity > 0)  # [..., R]
    room = capacity.clamp(min=0).unsqueeze(-2) - need.clamp(min=0)  # [..., 1, R]
    per_resource = (need >= 0) & cap_ok.unsqueeze(-2) & (used >= 0) & (used <= room)
    return card_ok & (per_resource | ~need_active).all(dim=-1)


def _fit_nodes(
    used: torch.Tensor,  # int64 [N, C, R]
    capacity: torch.Tensor,  # int64 [N, R]
    cap_present: torch.Tensor,  # bool [N, R]
    card_ok: torch.Tensor,  # bool [N, C]
    card_order: torch.Tensor,  # int32 [N, C]
    request: BinpackRequest,
    max_gpus: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """runSchedulingLogic's card selection (scheduler.go:313-338 with
    200-257) for N nodes side by side: containers in order, then GPU picks
    in order.  Returns (ok bool [N], picks int32 [N, T, K], used_out int64
    [N, C, R]); ``used_out`` carries every booked share and means something
    only where ok (the reference drops the scratch copy on failure)."""
    n, c, _r = used.shape
    t = request.need.shape[0]
    device = used.device
    lanes = torch.arange(c, dtype=torch.int32, device=device)
    ok = torch.ones(n, dtype=torch.bool, device=device)
    picks = torch.full((n, t, max_gpus), NO_CARD, dtype=torch.int32, device=device)
    for ti in range(t):
        need = request.need[ti]
        need_active = request.need_active[ti]
        # only resources present in the request are booked (addRM walks the
        # request's keys, resource_map.go:38-55)
        booked_need = torch.where(need_active, need, torch.zeros_like(need))
        for ki in range(max_gpus):
            fits = _card_fits(used, need, need_active, capacity, cap_present, card_ok)
            # first fit: the smallest card_order among fitting lanes, ties to
            # the smallest lane
            best = torch.where(fits, card_order, BIG_ORDER).amin(dim=-1, keepdim=True)
            chosen = torch.where(fits & (card_order == best), lanes, c).amin(dim=-1)  # [N]
            fitted = chosen < c
            wanted = request.container_active[ti] & (ki < request.num_gpus[ti])
            book = wanted & fitted
            sel = (lanes == chosen.unsqueeze(-1)) & book.unsqueeze(-1)  # [N, C]
            # adds zero off the booked card: no sum but a checked one is formed
            used = used + torch.where(sel.unsqueeze(-1), booked_need, torch.zeros_like(booked_need))
            ok = ok & (fitted | ~wanted)
            picks[:, ti, ki] = torch.where(book, chosen, NO_CARD)
    return ok, picks, used


def fit_one_node(
    used: torch.Tensor,  # int64 [C, R]
    capacity: torch.Tensor,  # int64 [R]
    cap_present: torch.Tensor,  # bool [R]
    card_ok: torch.Tensor,  # bool [C]
    card_order: torch.Tensor,  # int32 [C]
    request: BinpackRequest,
    max_gpus: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX ``_fit_one_node`` for one node: (ok bool [], picks int32
    [T, K], used_out int64 [C, R]).  The fused TAS+GAS solve re-packs one
    chosen node with it."""
    ok, picks, used_out = _fit_nodes(
        used.unsqueeze(0),
        capacity.unsqueeze(0),
        cap_present.unsqueeze(0),
        card_ok.unsqueeze(0),
        card_order.unsqueeze(0),
        request,
        max_gpus,
    )
    return ok[0], picks[0], used_out[0]


def binpack_reference(
    state: BinpackNodeState, request: BinpackRequest, max_gpus: int
) -> BinpackResult:
    """The plain PyTorch version: fit ``request`` against every node, a
    batch of nodes stepped through the T x K picks together.  Runs on
    whatever device the inputs live on, without host syncs."""
    fits, cards, _used = _fit_nodes(
        state.used,
        state.capacity,
        state.cap_present,
        state.card_valid & state.card_real,
        state.card_order,
        request,
        max_gpus,
    )
    return BinpackResult(fits=fits, cards=cards)


def binpack(state: BinpackNodeState, request: BinpackRequest, max_gpus: int) -> BinpackResult:
    """First-fit bin-pack on the inputs' device: the plain version on the
    CPU, the CUDA kernel on a GPU."""
    devices = {tensor.device for tensor in (*state, *request)}
    if len(devices) != 1:
        raise ValueError(f"binpack inputs on different devices: {devices}")
    device = state.used.device
    if device.type == "cpu":
        return binpack_reference(state, request, max_gpus)
    if device.type == "cuda":
        from platform_aware_scheduling_tpu_torch.ops.cuda_binpack import binpack_cuda

        return binpack_cuda(state, request, max_gpus)
    raise ValueError(f"binpack has no path for device {device}")
