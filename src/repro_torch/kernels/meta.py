"""The meta device as a third explicit device of the kernel wrappers, and
what a dry run (`launch.dryrun`) needs from the code it runs there.

A kernel wrapper given meta tensors checks them as its CUDA branch does,
allocates exactly what that branch allocates (outputs, `lse`, padded
copies) on the meta device, launches nothing, and books the kernel's
cost with every active sink (`booking`): its FLOPs and HBM bytes by the
formulas of the bound column of `PERF.md`'s kernel table
(`flash_fwd_cost`, `flash_bwd_cost`, `embedding_bag_cost`,
`dot_interaction_cost`).

A loop whose trips all do the same work runs on the meta device only as
far as its distinct trips (`trips`): each trip that runs stands for
`weight` of them, and `weighted(weight)` scales what the sinks and a
`launch.mesh.DryMesh` book inside it by that much (`weight()`), the
counterpart of the reference's while-loop trip correction. `full_loops()`
turns the cut off, so a test can hold the scaled counts to a full run.
"""
from __future__ import annotations

import contextlib

_SINKS: list = []
_WEIGHT = [1]
_CUT = [True]


@contextlib.contextmanager
def booking(sink):
    """While active, every meta kernel call runs sink(name, flops, bytes)
    with its cost times the current `weight()`."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def book(name: str, flops: float, nbytes: float) -> None:
    """Book one meta kernel call's cost with every active sink."""
    w = _WEIGHT[-1]
    for sink in list(_SINKS):
        sink(name, flops * w, nbytes * w)


def weight() -> int:
    """How many trips of a cut loop the code now running stands for."""
    return _WEIGHT[-1]


@contextlib.contextmanager
def weighted(w: int):
    """Scale what is booked inside by `w` (nested weights multiply)."""
    _WEIGHT.append(_WEIGHT[-1] * int(w))
    try:
        yield
    finally:
        _WEIGHT.pop()


@contextlib.contextmanager
def full_loops():
    """Run every trip of the loops `trips` would cut."""
    _CUT.append(False)
    try:
        yield
    finally:
        _CUT.pop()


def trips(n: int, meta: bool) -> list[tuple[int, int]]:
    """The trips of a loop of `n` like trips to run, each with its weight:
    every trip (weight 1) off the meta device or under `full_loops`; on it
    the first (which may differ, as a first microbatch allocates the
    accumulators) and the second standing for the other n - 1."""
    if not meta or not _CUT[-1] or n <= 2:
        return [(i, 1) for i in range(n)]
    return [(0, 1), (1, n - 1)]


def chunk_trips(size: int, chunk: int, meta: bool
                ) -> list[tuple[int, int, int]]:
    """(lo, hi, weight) of a walk over `size` rows in chunks of `chunk`:
    every chunk off the meta device or under `full_loops`; on it the first
    full chunk standing for all full ones, and the ragged last one."""
    bounds = [(lo, min(lo + chunk, size)) for lo in range(0, size, chunk)]
    if not meta or not _CUT[-1] or len(bounds) <= 1:
        return [(lo, hi, 1) for lo, hi in bounds]
    full = [b for b in bounds if b[1] - b[0] == chunk]
    out = [(full[0][0], full[0][1], len(full))] if full else []
    if bounds[-1][1] - bounds[-1][0] != chunk:
        out.append((bounds[-1][0], bounds[-1][1], 1))
    return out

# ---------------------------------------------------------------------------
# the kernels' costs: the formulas of PERF.md's bound column
# ---------------------------------------------------------------------------


def flash_fwd_cost(b: int, h: int, s: int, dh: int, itemsize: int
                   ) -> tuple[float, float]:
    """(FLOPs, bytes) of causal attention's forward on (b, h, s, dh): two
    products over the causal triangle, q, k, v read and the output
    written once (row 10, "operations")."""
    flops = 4 * b * h * dh * s * (s + 1) / 2
    return flops, 4.0 * b * h * s * dh * itemsize


def flash_bwd_cost(b: int, h: int, s: int, dh: int, itemsize: int
                   ) -> tuple[float, float]:
    """(FLOPs, bytes) of its FlashAttention-2 backward: 2.5 times the
    forward's products; q, k, v, o, dO read and dq, dk, dv written once,
    and the fp32 lse (row 10b, "operations")."""
    flops = 2.5 * flash_fwd_cost(b, h, s, dh, itemsize)[0]
    return flops, 8.0 * b * h * s * dh * itemsize + 4.0 * b * h * s


def embedding_bag_cost(n_bags: int, length: int, d: int
                       ) -> tuple[float, float]:
    """(FLOPs, bytes) of a pooled lookup of n_bags bags of `length` slots
    into d columns, every slot taken as valid (row 1, "bytes": the rows
    read, the int32 indices read, the pooled rows written)."""
    n_valid = n_bags * length
    return float(n_valid * d), 4.0 * (n_valid * d + n_bags * length
                                      + n_bags * d)


def dot_interaction_cost(b: int, f: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the packed pairwise dots of (b, f, d) (row 3,
    "bytes": z read, the packed triangle written)."""
    p = f * (f - 1) // 2
    return float(b * p * 2 * d), 4.0 * (b * f * d + b * p)
