"""P1-P7: the kernels of the on-chip stencil probes (replace
benchmarks/probe_pallas.py::p1..p5 and benchmarks/probe_pallas2.py::mk,
mk2).

P1 doubles an (H, W) frame.  P2-P7 read the probes' zero-padded frame P
(H + k - 1, Wp) and tap weights dkf (2, k*k), and compute window sums

    out_o[r, c] = sum over taps (di, dj, t) of dkf[o, t] * P[r + di, c + dj]

(a tap with t = None reads P as it is) in each TPU body's own order;
`body_taps` lists them.  The TPU bodies read taps through DMA'd VMEM
slabs, unaligned slices and `pltpu.roll`; the rolls never wrap inside the
output window, so each body is this window sum.  The plain twins are
shifted-slice sums in the body's order.

The CUDA kernels are csrc/probes.cu: a scale-copy kernel (P1), a vector
copy kernel for the one-tap bodies (P2, P3, P6 a and b) and one kernel
for each tap pattern of the other bodies (`tap_pattern`): the full k x k
stencil (P4, P5, P6 e-h, P7), one row (P6 c) or one column (P6 d).  A
pattern kernel sums its taps in the pattern's canonical order
(`pattern_taps`), whatever the body's order; `window_pattern_plain` is
that sum in PyTorch.  Each TPU kernel has its own launch counter
(probe_p1 .. probe_p5, probe_mk, probe_mk2).

The weights cross to the kernel by value, so a dkf on the card is copied
to the host (a synchronisation) at every call; the probes keep it on the
host.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

K = 9                                   # the probes' tap-set size
MK_BODIES = ("a", "b", "c", "d", "e", "f", "g", "h")
MK2_BODIES = ("i", "h2", "h3")


def body_taps(body: str, k: int):
    """(groups, nout) of a probe body.  A group is a list of taps
    (di, dj, t) summed in order into a fresh partial sum; the groups'
    partial sums are added in order (the TPU bodies that flush a partial
    sum into the output ref once per row or column: p4, p5, h3)."""
    R = k // 2
    by_i = [[(i, j, i * k + j) for j in range(k)] for i in range(k)]
    by_j = [[(i, j, i * k + j) for i in range(k)] for j in range(k)]
    ij = [[tap for g in by_i for tap in g]]
    ji = [[tap for g in by_j for tap in g]]
    table = {
        "p2": ([[(R, R, None)]], 1),           # dma_kernel
        "p3": ([[(R, R, 0)]], 1),              # smem_kernel
        "p4": (by_i, 1),                       # sten1_kernel
        "p5": (by_i, 2),                       # sten2_kernel
        "a": ([[(1, R, None)]], 1),            # ka
        "b": ([[(0, 1, None)]], 1),            # kb
        "c": ([[(0, j, j) for j in range(k)]], 1),   # kc: dk[0, j]
        "d": ([[(i, R, i) for i in range(k)]], 1),   # kd: dk[0, i]
        "e": (ij, 1), "f": (ij, 1), "g": (ij, 1),    # ke, kf, kg
        "h": (ji, 1),                          # kh
        "i": (ij, 2), "h2": (ji, 2),           # ki, kh2
        "h3": (by_j, 2),                       # kh3
    }
    if body not in table:
        raise ValueError(f"unknown probe body {body!r}")
    return table[body]


def tap_size(dkf) -> int:
    """k of a (2, k*k) weight array."""
    k = math.isqrt(dkf.shape[1])
    if k * k != dkf.shape[1]:
        raise ValueError(f"dkf {tuple(dkf.shape)} is not (n, k*k)")
    return k


def frame_width(P, k: int) -> int:
    """The probes' W: a multiple of 128, with Wp = P.shape[1] the next
    multiple of 128 above W + k - 1."""
    return 128 * ((P.shape[1] - (k - 1)) // 128)


def _frame(P, k: int, w):
    """(h, w) of the output window over P (h + k - 1, Wp)."""
    if P.dim() != 2:
        raise ValueError(f"P: expected (H + k - 1, Wp), got {tuple(P.shape)}")
    h = P.shape[0] - (k - 1)
    w = frame_width(P, k) if w is None else w
    if h <= 0 or w <= 0 or w + k - 1 > P.shape[1]:
        raise ValueError(f"P {tuple(P.shape)} holds no ({h}, {w}) window "
                         f"for k={k}")
    return h, w


def window_plain(body: str, dkf, P: torch.Tensor, k: int = None,
                 w: int = None) -> list:
    """Plain twin of every window body: shifted-slice sums in the body's
    own tap order (see body_taps); a list of nout outputs."""
    k = tap_size(dkf) if k is None else k
    h, w = _frame(P, k, w)
    groups, nout = body_taps(body, k)
    outs = []
    for o in range(nout):
        total = None
        for group in groups:
            acc = None
            for di, dj, t in group:
                sl = P[di:di + h, dj:dj + w]
                term = sl if t is None else dkf[o, t] * sl
                acc = term if acc is None else acc + term
            total = acc if total is None else total + acc
        # a one-tap unit window is a view of P: write it out, as the
        # kernel does
        outs.append(total.contiguous())
    return outs


# the tap patterns of csrc/probes.cu, in the C entry point's numbering
PATTERNS = ("full", "row", "column")


def pattern_taps(pattern: str, k: int) -> list:
    """(di, dj) of each tap of a pattern in its canonical order, the
    order in which the kernel sums them: full (i, j) row-major; row
    (0, j); column (i, k // 2)."""
    if pattern == "full":
        return [(i, j) for i in range(k) for j in range(k)]
    if pattern == "row":
        return [(0, j) for j in range(k)]
    if pattern == "column":
        return [(i, k // 2) for i in range(k)]
    raise ValueError(f"unknown tap pattern {pattern!r}")


def tap_pattern(taps, k: int):
    """(pattern, cols) of a list of weighted taps (di, dj, t) that are
    exactly one pattern's taps, each once, for an odd k >= 3: cols[n] is
    the weight column t of the pattern's n-th tap.  Raises ValueError for
    any other list (a single tap, an unweighted tap, a repeat, a set that
    is no pattern's)."""
    pos = {}
    for di, dj, t in taps:
        if t is None or (di, dj) in pos:
            raise ValueError(f"taps {taps}: unweighted or repeated tap")
        pos[(di, dj)] = t
    if k >= 3 and k % 2:
        for pattern in PATTERNS:
            canon = pattern_taps(pattern, k)
            if len(canon) == len(pos) and set(canon) == set(pos):
                return pattern, [pos[p] for p in canon]
    raise ValueError(f"taps {taps} match no pattern of {PATTERNS} for "
                     f"k={k}")


def body_pattern(body: str, dkf, k: int):
    """(pattern, weights) of a probe body with several taps: weights
    (nout, n) float32, output o's weight of the pattern's n-th tap."""
    groups, nout = body_taps(body, k)
    pattern, cols = tap_pattern([tap for g in groups for tap in g], k)
    dk = np.asarray(dkf, np.float32)
    if dk.ndim != 2 or dk.shape[0] < nout or dk.shape[1] != k * k:
        raise ValueError(f"dkf {dk.shape}: expected ({nout}+, {k * k})")
    return pattern, np.ascontiguousarray(dk[:nout][:, cols])


def window_pattern_plain(pattern: str, weights, P: torch.Tensor, k: int,
                         w: int = None) -> list:
    """Plain twin of the pattern kernels: for each row of weights, the
    shifted-slice sum over the pattern's taps in canonical order."""
    h, w = _frame(P, k, w)
    outs = []
    for wo in np.asarray(weights, np.float32):
        acc = None
        for (di, dj), wt in zip(pattern_taps(pattern, k), wo):
            term = float(wt) * P[di:di + h, dj:dj + w]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return outs


def window_pattern_cuda(counter: str, pattern: str, weights,
                        P: torch.Tensor, k: int, w: int = None) -> list:
    """Launch the kernel of `pattern` with weights (nout, n) in its
    canonical order; returns the nout outputs (h, w)."""
    _build.require(P, "P")
    h, w = _frame(P, k, w)
    wts = np.ascontiguousarray(weights, np.float32)
    n = len(pattern_taps(pattern, k))
    if wts.ndim != 2 or wts.shape[0] not in (1, 2) or wts.shape[1] != n:
        raise ValueError(f"weights {wts.shape}: expected (1 or 2, {n})")
    fn = _build.library().imsim_window_taps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    outs = [torch.empty((h, w), dtype=torch.float32, device=P.device)
            for _ in range(wts.shape[0])]
    status = fn(P.data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
                P.shape[0], P.shape[1], h, w, k, PATTERNS.index(pattern),
                len(outs), wts[0].ctypes.data, wts[-1].ctypes.data,
                _build.stream_ptr(P))
    _build.check(status, counter)
    _build.count_launch(counter)
    return outs


def _window_copy_cuda(counter: str, tap, dkf, P: torch.Tensor, k: int,
                      w: int) -> torch.Tensor:
    """Launch the vector copy kernel for a one-tap body (di, dj, t)."""
    _build.require(P, "P")
    h, w = _frame(P, k, w)
    di, dj, t = tap
    wt = 1.0 if t is None else float(np.asarray(dkf, np.float32)[0, t])
    fn = _build.library().imsim_window_copy
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((h, w), dtype=torch.float32, device=P.device)
    status = fn(P.data_ptr(), out.data_ptr(), P.shape[0], P.shape[1], h, w,
                di, dj, wt, _build.stream_ptr(P))
    _build.check(status, counter)
    _build.count_launch(counter)
    return out


def _window_cuda(counter: str, body: str, dkf, P: torch.Tensor, k: int,
                 w: int) -> list:
    """Launch a body's kernel: the copy kernel for one tap with one
    output, else its pattern's kernel."""
    groups, nout = body_taps(body, k)
    taps = [tap for g in groups for tap in g]
    dk = None if dkf is None else dkf.detach().cpu().numpy()
    if len(taps) == 1 and nout == 1:
        return [_window_copy_cuda(counter, taps[0], dk, P, k, w)]
    pattern, weights = body_pattern(body, dk, k)
    return window_pattern_cuda(counter, pattern, weights, P, k, w)


def _window(counter: str, body: str, dkf, P: torch.Tensor, k: int,
            w: int) -> list:
    if P.is_cuda:
        return _window_cuda(counter, body, dkf, P, k, w)
    if P.device.type != "cpu":
        raise ValueError(f"{counter}: unsupported device {P.device}")
    return window_plain(body, dkf, P, k, w)


# ---- P1 -------------------------------------------------------------------

def probe_copy2_plain(img: torch.Tensor) -> torch.Tensor:
    return img * 2.0


def probe_copy2_cuda(img: torch.Tensor) -> torch.Tensor:
    """Launch the scale-copy kernel: 2 * img."""
    _build.require(img, "img")
    if img.data_ptr() % 16:
        raise ValueError("img: expected a 16-byte aligned tensor")
    fn = _build.library().imsim_scale_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(img)
    status = fn(img.data_ptr(), out.data_ptr(), img.numel(), 2.0,
                _build.stream_ptr(img))
    _build.check(status, "probe_p1")
    _build.count_launch("probe_p1")
    return out


def probe_copy2(img: torch.Tensor) -> torch.Tensor:
    """P1 (probe_pallas.py::p1): 2 * img.  CUDA tensor: the kernel; CPU
    tensor: the plain twin."""
    if img.is_cuda:
        return probe_copy2_cuda(img)
    if img.device.type != "cpu":
        raise ValueError(f"probe_copy2: unsupported device {img.device}")
    return probe_copy2_plain(img)


# ---- P2-P5 ----------------------------------------------------------------

def probe_window(P: torch.Tensor, k: int = K, w: int = None):
    """P2 (probe_pallas.py::p2): out[r, c] = P[r + R, c + R]."""
    return _window("probe_p2", "p2", None, P, k, w)[0]


def probe_window_plain(P: torch.Tensor, k: int = K, w: int = None):
    return window_plain("p2", None, P, k, w)[0]


def probe_window_tap(dkf, P: torch.Tensor, w: int = None):
    """P3 (probe_pallas.py::p3): P2 times dkf[0, 0]."""
    return _window("probe_p3", "p3", dkf, P, tap_size(dkf), w)[0]


def probe_window_tap_plain(dkf, P: torch.Tensor, w: int = None):
    return window_plain("p3", dkf, P, None, w)[0]


def probe_stencil1(dkf, P: torch.Tensor, w: int = None):
    """P4 (probe_pallas.py::p4): the k x k stencil with dkf[0]."""
    return _window("probe_p4", "p4", dkf, P, tap_size(dkf), w)[0]


def probe_stencil1_plain(dkf, P: torch.Tensor, w: int = None):
    return window_plain("p4", dkf, P, None, w)[0]


def probe_stencil2(dkf, P: torch.Tensor, w: int = None):
    """P5 (probe_pallas.py::p5): the stencils with dkf[0] and dkf[1],
    sharing taps."""
    return tuple(_window("probe_p5", "p5", dkf, P, tap_size(dkf), w))


def probe_stencil2_plain(dkf, P: torch.Tensor, w: int = None):
    return tuple(window_plain("p5", dkf, P, None, w))


# ---- P6, P7 ---------------------------------------------------------------

def _check_body(body: str, bodies: tuple) -> None:
    if body not in bodies:
        raise ValueError(f"body {body!r} not in {bodies}")


def probe_mk(body: str, dkf, P: torch.Tensor, w: int = None):
    """P6 (probe_pallas2.py::mk) with body ka..kh, one output."""
    _check_body(body, MK_BODIES)
    return _window("probe_mk", body, dkf, P, tap_size(dkf), w)[0]


def probe_mk_plain(body: str, dkf, P: torch.Tensor, w: int = None):
    _check_body(body, MK_BODIES)
    return window_plain(body, dkf, P, None, w)[0]


def probe_mk2(body: str, dkf, P: torch.Tensor, w: int = None):
    """P7 (probe_pallas2.py::mk2) with body ki, kh2 or kh3, two
    outputs."""
    _check_body(body, MK2_BODIES)
    return tuple(_window("probe_mk2", body, dkf, P, tap_size(dkf), w))


def probe_mk2_plain(body: str, dkf, P: torch.Tensor, w: int = None):
    _check_body(body, MK2_BODIES)
    return tuple(window_plain(body, dkf, P, None, w))
