"""Wrappers of the CUDA top-k kernels, each beside its plain PyTorch twin.

Counterpart of ``gtopkssgd_tpu/ops/pallas_topk.py``. Four functions, three
kernels (``csrc/topk_kernels.cu``):

* ``multi_threshold_count(mag, thr)`` -- ``counts[i] = #{j : mag[j] >=
  thr[i]}`` for 8 thresholds in one pass (K1, the TPU ``_count_kernel``).
* ``fused_stage1_candidates(grad, thr, residual, groups=)`` -- per-bucket
  max-|grad + residual| candidates of the 2048x128 tile layout, plus the
  optional 8 counts, in one pass (K2; 16-byte loads where grad and
  residual are 16-byte aligned, 4-byte loads where not).
* ``fused_multi_threshold_count(grad, thr, residual)`` -- the 8 counts of
  ``|grad + residual|`` without storing the sum (K3; the count kernel with
  a residual operand).
* ``multisection_tau_lo(x, k, residual)`` -- the whole tau bracket of the
  ``pallas`` method, 4 rounds of K1 (on |x|) or K3 (on |x + residual|)
  and the narrowing between them, in one cooperative launch. The selection
  path calls this one; the two single-pass wrappers above stay as the
  one-for-one ports of the TPU functions.

``launch_floor(device)`` launches an empty kernel through the same route:
what a launch costs with no work in it.

A wrapper launches its kernel when its tensors lie on a CUDA device and
uses its ``*_ref`` twin when they lie on the CPU; there is no fallback from
one to the other. Each launch adds one to ``launches[name]``; the
multisection wrapper counts its two modes apart, as
``multisection_tau_lo[abs]`` and ``multisection_tau_lo[residual]``.

Thresholds are taken to be >= 0, as every caller's are: elements past the
end of the data are never counted (the TPU pads them with -1).

NaN rules, one a kernel, held bitwise between kernel and twin on the card
(``chip_smoke.py`` phase 2) and by the CPU tests on the twins; nothing
raises on a NaN and every index stays in range:

* stage 1 (K2): a NaN |acc| counts as the largest magnitude, as
  ``torch.argmax`` and ``jnp.argmax`` take it; the first NaN row of a
  bucket wins and its NaN is the candidate value, so a NaN gradient is
  selected and reaches the loss. The JAX package's stride layout off the
  TPU takes the NaN too; its Pallas kernel in interpret mode does
  otherwise (value 0 at row rpg, an index past the bucket).
* the counts (K1, K3, the multisection kernel) and the multisection
  bracket: a NaN is ignored -- never counted (NaN >= thr is false) and
  never the maximum (the kernel's ``fmaxf`` drops it), so the bracket is
  that of the other elements, and ``pallas`` and ``threshold`` never
  select a NaN.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

NUM_THRESHOLDS = 8
BLOCK_ROWS = 2048
LANES = 128
BLOCK = BLOCK_ROWS * LANES
ROUNDS = 4
MULTISECTION_SCRATCH = 1024  # floats: one per block, one block per SM

CountFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches: Dict[str, int] = {
    "multi_threshold_count": 0,
    "fused_stage1_candidates": 0,
    "fused_multi_threshold_count": 0,
    "multisection_tau_lo[abs]": 0,
    "multisection_tau_lo[residual]": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nblocks(n: int) -> int:
    return max(1, -(-n // BLOCK))


# ---------------------------------------------------------------------------
# Plain twins (the CPU path, and the reference the kernels are held to).
# ---------------------------------------------------------------------------


def multi_threshold_count_ref(mag: torch.Tensor,
                              thr: torch.Tensor) -> torch.Tensor:
    return (mag[:, None] >= thr[None, :]).sum(0, dtype=torch.int32)


def fused_multi_threshold_count_ref(
    grad: torch.Tensor, thr: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    acc = grad if residual is None else grad + residual
    return multi_threshold_count_ref(acc.abs(), thr)


def multisection_rounds(
    mag: torch.Tensor, k: int, count_fn: CountFn,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The tau bracket over magnitudes `mag`: 4 rounds of 8-way geometric
    multisection, each counting with `count_fn(mag, thr)`. Returns lo (the
    bracket's lower end; count(mag >= lo) >= k always holds) and each
    round's thresholds f32[8] and counts i32[8]. The multisection kernel
    repeats these float32 operations in this order. A NaN magnitude is
    ignored: it is not the maximum (0 when every one is NaN, the kernel's
    starting value) and ``count_fn`` never counts it."""
    maxv = torch.where(torch.isnan(mag), 0.0, mag).max()
    lo = torch.zeros((), dtype=mag.dtype, device=mag.device)
    hi = maxv
    powers = torch.arange(1, 9, dtype=mag.dtype, device=mag.device)
    thrs, counts = [], []
    for _ in range(ROUNDS):
        lo_eff = torch.maximum(lo, maxv * 1e-12 + 1e-30)
        r = (lo_eff / (hi + 1e-30)) ** (1.0 / 9.0)
        thr = hi * r ** powers  # 8 candidates strictly inside (lo, hi)
        c = count_fn(mag, thr)
        ge = c >= k
        lo = torch.maximum(lo, torch.where(ge, thr, lo).max())
        hi = torch.minimum(hi, torch.where(ge, hi, thr).min())
        thrs.append(thr)
        counts.append(c)
    return lo, thrs, counts


def multisection_tau_lo_ref(
    x: torch.Tensor, k: int, residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    acc = x if residual is None else x + residual
    lo, thrs, counts = multisection_rounds(
        acc.abs(), k, multi_threshold_count_ref)
    return lo, torch.stack(thrs), torch.stack(counts)


def fused_stage1_candidates_ref(
    grad: torch.Tensor,
    thresholds: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    groups: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The tile layout, written out: bucket (tile, g, lane) holds the
    rpg = 2048/groups elements tile*262144 + (g*rpg + row)*128 + lane.
    The candidate is the bucket's first maximum of |acc|, a NaN counting
    as the largest (its first NaN row)."""
    n = grad.shape[0]
    if BLOCK_ROWS % groups != 0:
        raise ValueError(f"groups={groups} must divide {BLOCK_ROWS}")
    nb, rpg = _nblocks(n), BLOCK_ROWS // groups
    padded = nb * BLOCK
    acc = grad if residual is None else grad + residual
    acc = torch.nn.functional.pad(acc, (0, padded - n))
    eidx = torch.arange(padded, device=grad.device, dtype=torch.int64)
    mag = torch.where(eidx < n, acc.abs(), torch.full_like(acc, -1.0))
    mag4 = mag.view(nb, groups, rpg, LANES)
    rows = torch.arange(rpg, device=grad.device).view(1, 1, rpg, 1)
    nan = torch.isnan(mag4)
    first_nan = torch.where(nan, rows, rpg).amin(dim=2)
    mag4 = torch.where(nan, -1.0, mag4)  # a NaN wins through first_nan
    mx = mag4.amax(dim=2, keepdim=True)
    win = torch.where(mag4 == mx, rows, rpg).amin(dim=2)  # first max row
    win = torch.where(first_nan < rpg, first_nan, win)
    cand_val = torch.gather(acc.view(nb, groups, rpg, LANES), 2,
                            win[:, :, None, :]).reshape(-1)
    tiles = torch.arange(nb, device=grad.device).view(nb, 1, 1)
    grp = torch.arange(groups, device=grad.device).view(1, groups, 1)
    lane = torch.arange(LANES, device=grad.device).view(1, 1, LANES)
    cand_idx = (tiles * BLOCK + (grp * rpg + win) * LANES + lane)
    counts = (None if thresholds is None
              else multi_threshold_count_ref(mag[:n], thresholds))
    return cand_val, cand_idx.reshape(-1).to(torch.int32), counts


def stride_candidates_ref(
    grad: torch.Tensor, num_buckets: int,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stride-L bucket layout that the JAX package runs off the TPU
    (gtopkssgd_tpu/ops/topk.py:299-315): bucket j holds flat indices
    {j, L+j, 2L+j, ...}. Kept only so the tests compare like with like;
    the port's kernel computes the tile layout above."""
    n, L = grad.shape[0], num_buckets
    acc = grad if residual is None else grad + residual
    b = -(-n // L)
    mat = torch.nn.functional.pad(acc, (0, b * L - n)).view(b, L)
    rows = torch.arange(b, device=grad.device)[:, None]
    cols = torch.arange(L, device=grad.device)[None, :]
    mag = torch.where(rows * L + cols < n, mat.abs(),
                      torch.full_like(mat, -1.0))
    mx = mag.amax(dim=0, keepdim=True)
    win = torch.where(mag == mx, rows, b).amin(dim=0)  # first max row
    cand_idx = (win * L + torch.arange(L, device=grad.device))
    cand_val = torch.gather(mat, 0, win[None, :])[0]
    return cand_val, cand_idx.to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device, numel: Optional[int] = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _launch_count(x: torch.Tensor, thr: torch.Tensor,
                  residual: Optional[torch.Tensor], take_abs: bool,
                  name: str) -> torch.Tensor:
    from gtopkssgd_tpu_torch.ops import _build

    n = x.shape[0]
    _check("x", x, torch.float32, x.device)
    _check("thresholds", thr, torch.float32, x.device, NUM_THRESHOLDS)
    if residual is not None:
        _check("residual", residual, torch.float32, x.device, n)
    lib = _build.load()
    with torch.cuda.device(x.device):  # the launch uses the current context
        counts = torch.zeros(NUM_THRESHOLDS, dtype=torch.int32,
                             device=x.device)
        rc = lib.gtopk_count(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            int(take_abs), n, thr.data_ptr(), counts.data_ptr(),
            _stream(x.device))
    _raise_on(rc, name)
    launches[name] += 1
    return counts


def multi_threshold_count(mag: torch.Tensor,
                          thresholds: torch.Tensor) -> torch.Tensor:
    """i32[8]: counts[i] = #{j : mag[j] >= thresholds[i]} (mag f32[N],
    callers pass |x|)."""
    if mag.device.type == "cpu":
        return multi_threshold_count_ref(mag, thresholds)
    return _launch_count(mag, thresholds, None, False,
                         "multi_threshold_count")


def fused_multi_threshold_count(
    grad: torch.Tensor, thresholds: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """i32[8]: counts[i] = #{j : |grad[j] + residual[j]| >= thr[i]}, the
    sum never stored. With residual=None, the counts of |grad|."""
    if grad.device.type == "cpu":
        return fused_multi_threshold_count_ref(grad, thresholds, residual)
    return _launch_count(grad, thresholds, residual, True,
                         "fused_multi_threshold_count")


def fused_stage1_candidates(
    grad: torch.Tensor,
    thresholds: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    groups: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(cand_val f32[L], cand_idx i32[L], counts i32[8] | None) with
    L = nblocks * groups * 128; indices >= n mark padding buckets (value
    0). `groups` must divide 2048."""
    if BLOCK_ROWS % groups != 0:
        raise ValueError(f"groups={groups} must divide {BLOCK_ROWS}")
    if grad.device.type == "cpu":
        return fused_stage1_candidates_ref(
            grad, thresholds, residual, groups=groups)
    from gtopkssgd_tpu_torch.ops import _build

    n = grad.shape[0]
    if n >= 2**31 - BLOCK:
        raise ValueError(f"n={n} overflows the kernel's int32 indices")
    _check("grad", grad, torch.float32, grad.device)
    if residual is not None:
        _check("residual", residual, torch.float32, grad.device, n)
    if thresholds is not None:
        _check("thresholds", thresholds, torch.float32, grad.device,
               NUM_THRESHOLDS)
    L = _nblocks(n) * groups * LANES
    lib = _build.load()
    with torch.cuda.device(grad.device):  # the launch uses the current context
        counts = None if thresholds is None else torch.zeros(
            NUM_THRESHOLDS, dtype=torch.int32, device=grad.device)
        cand_val = torch.empty(L, dtype=torch.float32, device=grad.device)
        cand_idx = torch.empty(L, dtype=torch.int32, device=grad.device)
        rc = lib.gtopk_stage1(
            grad.data_ptr(),
            None if residual is None else residual.data_ptr(), n, groups,
            None if thresholds is None else thresholds.data_ptr(),
            None if counts is None else counts.data_ptr(),
            cand_val.data_ptr(), cand_idx.data_ptr(), _stream(grad.device))
    _raise_on(rc, "fused_stage1_candidates")
    launches["fused_stage1_candidates"] += 1
    return cand_val, cand_idx, counts


def launch_floor(device: torch.device) -> None:
    """One launch of an empty kernel on `device`'s current stream."""
    from gtopkssgd_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(device):
        _raise_on(lib.gtopk_noop(_stream(device)), "launch_floor")


def multisection_tau_lo(
    x: torch.Tensor, k: int, residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo f32[], thresholds f32[4, 8], counts i32[4, 8]): the tau bracket
    over |x| (residual None) or |x + residual|, the sum never stored.
    Bitwise what `multisection_rounds` gives with exact counts. One
    cooperative launch; raises if the card refuses it."""
    if x.device.type == "cpu":
        return multisection_tau_lo_ref(x, k, residual)
    from gtopkssgd_tpu_torch.ops import _build

    n = x.shape[0]
    if not (1 <= n < 2**31 and k >= 1):
        raise ValueError(f"n={n}, k={k}: need 1 <= n < 2**31 and k >= 1")
    _check("x", x, torch.float32, x.device)
    if residual is not None:
        _check("residual", residual, torch.float32, x.device, n)
    lib = _build.load()
    with torch.cuda.device(x.device):  # the launch uses the current context
        lo = torch.empty((), dtype=torch.float32, device=x.device)
        thr = torch.empty((ROUNDS, NUM_THRESHOLDS), dtype=torch.float32,
                          device=x.device)
        counts = torch.empty((ROUNDS, NUM_THRESHOLDS), dtype=torch.int32,
                             device=x.device)
        scratch = torch.empty(MULTISECTION_SCRATCH, dtype=torch.float32,
                              device=x.device)
        rc = lib.gtopk_multisection(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            n, k, lo.data_ptr(), thr.data_ptr(), counts.data_ptr(),
            scratch.data_ptr(), _stream(x.device))
    _raise_on(rc, "multisection_tau_lo")
    mode = "abs" if residual is None else "residual"
    launches[f"multisection_tau_lo[{mode}]"] += 1
    return lo, thr, counts
