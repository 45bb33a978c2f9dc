"""Kernel K10: the k-th largest 16-bit key of every row of (G, 256, 256)
f32 cells, by binary search (CUDA C++, ``csrc/kth_select.cu``).

It replaces the TPU kernel ``tools/kth_bench.py`` ``make(body_fn)`` (its
``kern`` with ``body_vpu``, ``body_mxu`` or ``body_while``), the probe of
the count loop inside the fused top-k attention kernel.  A key is
``bitcast(x) >> 16`` (arithmetic); the search keeps [lo, hi] from
[-32769, 32768] and at each step counts the row's keys above mid = lo +
(hi - lo) // 2: lo = mid + 1 where at least k are, else hi = mid.  The
output is each row's key as f32, broadcast over the row.  ``strategy`` is
how the kernel counts: "vpu" on the CUDA cores and "mxu" as a tensor-core
product of the 0/1 matrix with ones, 17 steps each, and "while" until
every row of the cell has lo = hi.  All three give the k-th largest key,
which ``torch.kthvalue`` also computes (the port's tool times it beside
the kernel; the kernel does not call it).  No model path launches it; the
port's ``tools/kth_bench.py`` does.  The source's note says what bounds it
and how the design answers.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build

SOURCE = "kth_select.cu"
STRATEGIES = ("vpu", "mxu", "while")
N = 256  # keys a row, rows a cell: the TPU probe's cell
LO, HI = -32769, 32768
ITERS = 17


def _check(x, k, strategy):
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, not "
                         f"{strategy!r}")
    if x.dim() != 3 or x.shape[1:] != (N, N) or x.dtype != torch.float32:
        raise ValueError(f"K10 takes (G, {N}, {N}) float32 cells, not "
                         f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= k <= N:
        raise ValueError(f"k must be in 1..{N}, not {k}")


def keys_of(x: torch.Tensor) -> torch.Tensor:
    """The 16-bit keys of f32 ``x``: its bits shifted right by 16
    (arithmetic), as int32."""
    return x.contiguous().view(torch.int32) >> 16


def _search(x, k, strategy):
    """(each row's k-th largest key (G, N, 1) int32, the steps each cell
    took (G,)), the strategy's search as the TPU probe spells it,
    vectorized over the cells."""
    keys = keys_of(x)
    G = x.shape[0]
    lo = torch.full((G, N, 1), LO, dtype=torch.int32, device=x.device)
    hi = torch.full((G, N, 1), HI, dtype=torch.int32, device=x.device)
    ones = torch.ones(N, 8, dtype=torch.float32, device=x.device)

    def step(lo, hi):
        mid = lo + ((hi - lo) >> 1)
        gt = keys > mid
        if strategy == "mxu":  # the 0/1 matrix times ones, f32 sums
            up = (gt.to(torch.float32) @ ones)[..., :1] >= float(k)
        else:
            up = gt.to(torch.int32).sum(-1, keepdim=True) >= k
        return torch.where(up, mid + 1, lo), torch.where(up, hi, mid)

    if strategy != "while":
        for _ in range(ITERS):
            lo, hi = step(lo, hi)
        return lo, torch.full((G,), ITERS, device=x.device)
    # each cell until every row of it has converged
    steps = torch.zeros(G, dtype=torch.int64, device=x.device)
    while True:
        live = (hi - lo).amax(dim=(1, 2)) > 0
        if not bool(live.any()):
            return lo, steps
        nlo, nhi = step(lo, hi)
        lo = torch.where(live[:, None, None], nlo, lo)
        hi = torch.where(live[:, None, None], nhi, hi)
        steps += live


def kth_select_ref(x: torch.Tensor, k: int,
                   strategy: str = "vpu") -> torch.Tensor:
    """Plain PyTorch version of K10: each strategy's search as the TPU
    probe spells it, vectorized over the cells."""
    _check(x, k, strategy)
    lo, _ = _search(x, k, strategy)
    return lo.to(torch.float32).expand(x.shape).contiguous()


def search_steps(x: torch.Tensor, k: int) -> torch.Tensor:
    """The steps (G,) the "while" strategy takes in each cell of ``x``:
    until every row of the cell has lo = hi."""
    _check(x, k, "while")
    return _search(x, k, "while")[1]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.kth_select.argtypes = [p, p, i, i, i, p]
    lib.kth_select.restype = i
    return lib


def kth_select(x: torch.Tensor, k: int, strategy: str = "vpu"
               ) -> torch.Tensor:
    """x (G, 256, 256) f32 -> (G, 256, 256) f32, each row its k-th largest
    key broadcast: K10 on a CUDA tensor, the plain version on a CPU
    tensor.  Raises where the kernel cannot take the call."""
    if x.device.type == "cpu":
        return kth_select_ref(x, k, strategy)
    _check(x, k, strategy)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"K10 takes a contiguous CUDA or CPU tensor, not "
                         f"{x.device}")
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().kth_select(
            x.data_ptr(), out.data_ptr(), x.shape[0], k,
            STRATEGIES.index(strategy),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K10 launch failed with CUDA error {err}")
    kth_select.launches += 1
    kth_select.sites[(tuple(x.shape), k, strategy)] += 1
    return out


# launches, and launches per call site: (shape, k, strategy)
kth_select.launches = 0
kth_select.sites = collections.Counter()
