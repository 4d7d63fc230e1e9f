"""The paper's load-balancing strategies as MoE dispatch policies (the port
of :mod:`repro.moe.balancing`).

Token→expert routing is the LM stack's form of the paper's problem: expert
loads follow a skewed, data-dependent distribution as node outdegrees do,
and the dispatch policy decides how that skew maps onto fixed-shape
products.  The correspondence:

==============  =====================================================
paper strategy  MoE dispatch policy (this module)
==============  =====================================================
BS (node)       ``padded`` — per-expert capacity slots, padding waste
                ∝ load skew (GShard-style dispatch)
EP/WD (edge /   ``sorted_block`` — sort assignments by expert, one
 decomposition)  product per expert over its contiguous group (the
                reference's ``jax.lax.ragged_dot``); no padding, no drops
NS (split)      ``replicate`` — experts over capacity spill into virtual
                replica experts (children) sharing the parent's weights
HP (hier.)      ``multi_round`` — R sub-rounds of capacity C/R each;
                overflow drains in later rounds
==============  =====================================================

``calibrate_capacity`` is the paper's histogram MDT heuristic applied to
observed expert loads.

The reference computes the dispatch outside any Pallas kernel (einsums,
``.at[].add``, ``take_along_axis``, ``argsort``, ``ragged_dot``), and so
does the port: ``torch.bmm`` for the expert products, ``index_add_`` and
``gather`` for dispatch and combine.  Integers (routing ids, positions,
keep masks, slot indices) equal the reference's bit for bit; top-k ties
go to the lower expert index, as ``jax.lax.top_k``'s do.  Two differences
of form, not of result: ``replicate`` runs the children's slots beside
their parent's in one ``[E, ·, D]`` product instead of concatenating the
weights ``SPLIT_FACTOR`` times, and ``sorted_block`` reads the group
sizes on the host (one sync a call) to cut the sorted assignments into
one product an expert.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DISPATCH_METHODS = ("padded", "sorted_block", "replicate", "multi_round")
#: ``multi_round``'s sub-rounds (HP), each of capacity C / NUM_ROUNDS
NUM_ROUNDS = 4
#: ``replicate``'s slot groups an expert (NS): the parent and its child
SPLIT_FACTOR = 2


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def topk_route(router_logits: torch.Tensor, k: int):
    """router_logits [..., E] -> (weights [..., k] float32, ids [..., k]
    int64, aux).

    The top k of the softmax in float32, renormalised; equal
    probabilities go to the lower expert index (a stable descending
    sort).  ``aux`` holds the switch-style load-balance loss and the
    router z-loss."""
    logits = router_logits.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = order.values[..., :k], order.indices[..., :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    e = router_logits.shape[-1]
    # fraction of assignments per expert vs mean router prob per expert
    onehot = F.one_hot(ids, e).float()                       # [...,k,E]
    frac = onehot.sum(-2).reshape(-1, e).mean(0) / k
    mean_prob = probs.reshape(-1, e).mean(0)
    lb_loss = e * torch.sum(frac * mean_prob)
    z = torch.logsumexp(logits, -1)
    z_loss = torch.mean(z ** 2)
    return weights, ids, {"lb_loss": lb_loss, "z_loss": z_loss}


def calibrate_capacity(sample_loads: np.ndarray, histogram_bins: int = 10,
                       ) -> int:
    """Histogram-MDT capacity (paper §III-B heuristic on expert loads)."""
    loads = np.asarray(sample_loads)
    loads = loads[loads > 0]
    if loads.size == 0:
        return 1
    mx = int(loads.max())
    if mx <= 1:
        return 1
    hist, _ = np.histogram(loads, bins=histogram_bins, range=(0, mx))
    bin_index = int(np.argmax(hist))
    return max(1, int(round((bin_index + 1) / histogram_bins * mx)))


# ---------------------------------------------------------------------------
# shared plumbing: per-row (GShard-group) positions, scatter / gather
# ---------------------------------------------------------------------------

def _positions(ids: torch.Tensor, num_experts: int):
    """ids [B,A] -> (position of each assignment in its expert's queue of
    its row [B,A], the one-hot [B,A,E]).  The queue is in assignment
    order: token-major, k-minor.  The prefix sum runs along the last axis
    of an expert-major one-hot [B,E,A] (a scan along a middle axis of
    E = 40 columns leaves the card's scan kernel 40 threads wide: 3 ms
    at A = 16,384)."""
    ids = ids.long()
    onehot = F.one_hot(ids, num_experts).to(torch.int32).transpose(1, 2)
    pos = torch.cumsum(onehot.contiguous(), dim=2, dtype=torch.int32) - 1
    return (torch.gather(pos, 1, ids[:, None, :])[:, 0],
            onehot.transpose(1, 2))


def _scatter_dispatch(x, flat, keep, num_slots: int):
    """x [B,A,D] -> expert slots [B,num_slots,D]; a dropped assignment
    goes to a trash slot past the end."""
    B, A, D = x.shape
    idx = torch.where(keep, flat, num_slots).long()             # [B,A]
    rows = torch.arange(B, device=x.device)[:, None] * (num_slots + 1)
    slots = torch.zeros(B * (num_slots + 1), D, dtype=x.dtype,
                        device=x.device)
    slots.index_add_(0, (idx + rows).reshape(-1), x.reshape(B * A, D))
    return slots.reshape(B, num_slots + 1, D)[:, :num_slots]


def _gather_combine(expert_out_flat, flat_idx, keep, weights):
    """expert_out_flat [B,num_slots,D] -> y [B,A,D], each assignment's
    output times its weight (0 where dropped), in the output's dtype."""
    D = expert_out_flat.shape[-1]
    idx = flat_idx.clamp(0, expert_out_flat.shape[1] - 1).long()
    y = torch.gather(expert_out_flat, 1, idx[..., None].expand(-1, -1, D))
    return y * (weights * keep)[..., None].to(y.dtype)


def _expert_ffn(expert_inputs, wp, activation: str):
    """expert_inputs [E,C*,D] × per-expert FFN weights -> [E,C*,D]."""
    up = torch.bmm(expert_inputs, wp["w_up"])
    if activation == "swiglu":
        up = F.silu(torch.bmm(expert_inputs, wp["w_gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return torch.bmm(up, wp["w_down"])


def _by_expert(slots, groups: int, num_experts: int, cap: int):
    """[B, groups·E·cap, D] slots (group-major, then expert) ->
    [E, groups·B·cap, D], each expert's slots of every row and group."""
    B, _, D = slots.shape
    return (slots.reshape(B, groups, num_experts, cap, D)
            .permute(2, 1, 0, 3, 4).reshape(num_experts, -1, D))


def _by_row(out, B: int, groups: int, num_experts: int, cap: int):
    """The inverse of :func:`_by_expert`."""
    D = out.shape[-1]
    return (out.reshape(num_experts, groups, B, cap, D)
            .permute(2, 1, 0, 3, 4).reshape(B, -1, D))


def _capacity_ffn(xa, ida, pos, keep, num_experts: int, cap: int,
                  groups: int, expert_params, activation: str, wa):
    """Dispatch the kept assignments to ``groups`` slots of ``cap`` an
    expert (group g of expert e is slot block ``g·E + e``), run every
    expert over all its slots at once, and gather back the weighted
    outputs [B,A,D]."""
    B = xa.shape[0]
    group = torch.div(pos, cap, rounding_mode="floor").clamp(0, groups - 1)
    flat = (ida + group * num_experts) * cap + (pos - group * cap)
    slots = _scatter_dispatch(xa, flat, keep, groups * num_experts * cap)
    out = _expert_ffn(_by_expert(slots, groups, num_experts, cap),
                      expert_params, activation)
    return _gather_combine(_by_row(out, B, groups, num_experts, cap), flat,
                           keep, wa)


# ---------------------------------------------------------------------------
# the four policies
# ---------------------------------------------------------------------------

def moe_dispatch(x, ids, weights, expert_params, *, num_experts: int,
                 capacity: int, activation: str = "swiglu",
                 method: str = "padded"):
    """Dispatch/compute/combine under one of the four paper policies.

    x [B,S,D]; ids/weights [B,S,K].  Returns (y [B,S,D], stats).
    ``capacity`` is per expert and per row (tokens), the static analogue
    of MDT.  ``stats``: ``dropped_frac`` and ``padding_waste`` as float32
    0-d tensors."""
    if method not in DISPATCH_METHODS:
        raise ValueError(f"unknown dispatch method {method!r}")
    B, S, D = x.shape
    K = ids.shape[-1]
    A = S * K
    xa = x.repeat_interleave(K, dim=1)                  # assignment inputs
    ida = ids.reshape(B, A).long()
    wa = weights.reshape(B, A).float()

    if method == "sorted_block":
        return _sorted_block(x, xa, ida, wa, expert_params, num_experts,
                             activation, B, S, K, D)

    pos, _ = _positions(ida, num_experts)               # [B,A]
    if method == "padded":
        keep = pos < capacity
        y = _capacity_ffn(xa, ida, pos, keep, num_experts, capacity, 1,
                          expert_params, activation, wa)
        stats = _drop_stats(keep, capacity, num_experts, A)
    elif method == "replicate":
        # NS: overflow beyond capacity/split spills into replica (child)
        # experts that share the parent's weights: a child's slots lie
        # beside its parent's in the same expert's product
        cap_child = max(capacity // SPLIT_FACTOR, 1)
        keep = pos < cap_child * SPLIT_FACTOR
        y = _capacity_ffn(xa, ida, pos, keep, num_experts, cap_child,
                          SPLIT_FACTOR, expert_params, activation, wa)
        stats = _drop_stats(keep, cap_child * SPLIT_FACTOR, num_experts, A)
    else:
        # HP: R sub-rounds of capacity C/R — bounded per-round working set
        cap_r = max(capacity // NUM_ROUNDS, 1)
        y = torch.zeros(B, A, D, dtype=x.dtype, device=x.device)
        keep = torch.zeros(B, A, dtype=torch.bool, device=x.device)
        for r in range(NUM_ROUNDS):
            in_round = (pos >= r * cap_r) & (pos < (r + 1) * cap_r)
            y = y + _capacity_ffn(xa, ida, pos - r * cap_r, in_round,
                                  num_experts, cap_r, 1, expert_params,
                                  activation, wa)
            keep = keep | in_round
        stats = _drop_stats(keep, cap_r * NUM_ROUNDS, num_experts, A)

    y = y.reshape(B, S, K, D).sum(2)
    return y.to(x.dtype), stats


def _sorted_block(x, xa, ida, wa, expert_params, num_experts, activation,
                  B, S, K, D):
    """WD/EP: flatten all assignments, sort them by expert (stable), and
    run one product an expert over its contiguous group: no padding, no
    drops.  The group sizes are read on the host (one sync)."""
    T = B * S * K
    flat_x = xa.reshape(T, D)
    flat_id = ida.reshape(T)
    order = torch.argsort(flat_id, stable=True)
    inv = torch.argsort(order, stable=True)
    sx = flat_x[order]
    sizes = torch.bincount(flat_id, minlength=num_experts).tolist()
    parts, lo = [], 0
    for e, n in enumerate(sizes):
        xe = sx[lo:lo + n]
        up = xe @ expert_params["w_up"][e]
        if activation == "swiglu":
            up = F.silu(xe @ expert_params["w_gate"][e]) * up
        else:
            up = F.gelu(up, approximate="tanh")
        parts.append(up @ expert_params["w_down"][e])
        lo += n
    down = torch.cat(parts, 0)
    y = down[inv] * wa.reshape(T)[:, None].to(down.dtype)
    y = y.reshape(B, S, K, D).sum(2)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y.to(x.dtype), {"dropped_frac": zero, "padding_waste": zero}


def _drop_stats(keep, total_capacity, num_experts, A):
    """The kept share of the assignments and of the issued slots, as
    float32.  The divisors are tensors: a division by a Python scalar is
    a product with its reciprocal on CUDA tensors, a true division on CPU
    ones, and the two may differ in the last bit."""
    kept = keep.sum(dtype=torch.float32)

    def share(n: int) -> torch.Tensor:
        return kept / torch.tensor(float(n), device=keep.device)
    return {
        "dropped_frac": 1.0 - share(keep.shape[0] * A),
        "padding_waste": 1.0 - share(keep.shape[0] * num_experts
                                     * total_capacity),
    }
