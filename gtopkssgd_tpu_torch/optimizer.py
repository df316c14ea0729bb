"""gTop-k S-SGD: error-feedback top-k compression of the gradient, the
gradient exchange over P ranks, then SGD with momentum and weight decay.

Counterpart of ``gtopkssgd_tpu.optimizer.gtopk_sgd`` in every mode
(``dense``, ``gtopk``, ``allgather | topk | topkA | topk_allgather``,
``gtopk_hier``, ``gtopk_layerwise``), with every option of the JAX
optimizer, its telemetry included. One step:

1. ravel every parameter's gradient into one flat f32[N] buffer, in the
   order and layout of the JAX package's ``ravel_pytree`` (``FlatLayout``;
   ``convert.flat_layout`` builds it for a model) -- top-k buckets are
   positions in this vector, so the order decides what is selected; with
   ``clip_grad_norm`` c, scale it by min(1, c / (||flat|| + 1e-6)) first;
   under ``gtopk_hier`` at P > 1, then sum it within each slice of
   ``hier_ici_size`` ranks (``ici_dense_psum``), bitwise the same on each
   member, so a slice acts as one worker from here on;
2. the source: the flat gradient, or under ``momentum_correction`` (DGC,
   arXiv:1712.01887) the local velocity u = momentum*u + flat, whose
   accumulation v plays the residual;
3. during the first ``warmup_dense_steps`` steps of a sparse mode, the
   update is the source all-reduced and divided by P (by P x the slice
   width under ``gtopk_hier``, whose source is already a slice sum); the
   residual (and u) pass through unchanged;
4. sparse, at P = 1: acc = src + residual; keep = |acc| >= tau by the
   threshold-mask compressor (the selection reads src and residual
   unfused); residual = where(keep, 0, acc); u = where(keep, 0, u); the
   update is acc - residual. At P > 1: the local set (vals, idx) =
   compress(acc) in index form; a lossy wire codec's round-trip error is
   folded into the residual and the roundtripped values ship (not in mode
   ``topk``); u is zeroed at the local picks; then ``gtopk`` and
   ``gtopk_hier``: the global set by the hypercube merge (across slices
   for ``gtopk_hier``) or the balanced schedule, rejected local picks
   back into the residual (``repair``), the update
   scatter_add_dense(gidx, gvals) / P; the allgather modes: the update is
   the dense union / P, no repair; ``dense``: the update is the
   gradient, all-reduced and divided by P;
5. unravel the update into the parameters' ``.grad`` and take one
   ``torch.optim.SGD`` step: g + wd*p, then buf = momentum*buf + g (with
   ``nesterov``, g + momentum*buf is applied), then p -= lr*buf -- the
   arithmetic of the JAX package's ``add_decayed_weights(wd)`` +
   ``sgd(momentum, nesterov)`` chain, applied to every parameter,
   BatchNorm scale and bias included. Under momentum correction the SGD
   step runs with no momentum (the velocity lives before the exchange).

``gtopk_layerwise`` selects per leaf (a leaf is an entry of the layout):
k_l = ceil(density * n_l), the clip's norm summed over the leaves. Under
``buckets="concat"``, at P = 1 each leaf runs step 4's threshold form on
its own; at P > 1 each leaf selects its top-k_l, the sets are shifted by
the leaf offsets into one set over the global index space, merged once,
and the codec fold, the repair and the velocity mask go back to the
leaves (a leaf's padding index n_l drops out, it does not spill into the
next leaf). Under any other ``buckets`` spec (``parallel.bucketing``:
``leaf``, an int B, ``auto``) each bucket -- a contiguous run of leaves,
one slice of the flat buffer -- runs step 4 on its own with k_b =
ceil(density * n_b) and merges over its own index space [0, n_b). At
B = 1 that is the flat ``gtopk`` step. At P > 1 a bucket is two stages,
the JAX optimizer's: ``_select`` (accumulate, local top-k, zero-out,
velocity mask, the codec's error fold) and ``_merge`` (the exchange, the
repair, the averaged scatter), in the plan's order (``pipeline``):
``serial`` runs bucket b's merge before bucket b+1's selection;
``overlap`` selects bucket b+1 while bucket b's merge is in flight, one
merge at a time, on a merge thread the optimizer owns and, on a CUDA
device, with the selections on its side stream (``_overlap``). Both
orders run the same ops on the same values: bitwise the same results.
``auto`` keeps the order whose modeled span is smaller
(``bucketing.plan_buckets``), with the selection cost ``select_gamma``
(ms per 1e6 elements: the argument, or the card's fit for the run's
device and method, ``bucketing.find_select_gamma``; pricing the
selection without one raises). The residual stays one flat f32[N]
buffer in layout order in every mode; ``convert.layerwise_residual``
carries the JAX package's per-leaf tuple into it.

The wire plan (``parallel.planner``): at P > 1, ``comm_plan`` ('auto', or
a pin: tree | balanced for gtopk and gtopk_layerwise, hier, allgather,
dense) is decided once at construction (``plan_decision``), priced with
the comm-model fit (``comm_model_fit``, a path, or the fit committed with
the port for the process group's backend: gloo or NCCL).

Each unit's selection runs in a ``torch.profiler`` range "select" and
each gradient exchange in a range "exchange" (``profile_step`` reads
them).

The residual and the step count live in the optimizer's ``state`` (keys
"residual" and "count"; under momentum correction the residual is
{"v": v, "u": u}), so ``state_dict()`` saves error feedback.

Telemetry (``telemetry=True``; ``obs.counters``): each step also writes
the counters of the JAX optimizer's ``state.telemetry`` into one float32
device vector at a fixed address, ``state["telemetry"]``
(``telemetry_fields`` in order, then with ``telemetry_layers`` the
``obs.counters.LAYER_FIELDS`` rows of L layer values, the layout's
leaves in order), with no host sync, so a CUDA graph of the step keeps
them and the trainer reads them in one copy. With ``telemetry_layers``,
``state["age"]`` f32[N] holds the steps since each coordinate last
shipped. With ``telemetry_audit_interval`` A, a step whose count is a
multiple of A also takes the exact top-k of the accumulator (``topk_abs``)
and writes the recall of the production selection against it
(``audit_recall``; carried between audits, -1 before the first); its
other steps run no audit. At P > 1 the vector is averaged over the ranks
in one all-reduce a step (the age is the same on every rank by
construction, as the update is). The selection stats describe the
LOCAL selection: the shipped values (after a lossy codec) at P > 1, the
keep mask at P = 1; the dense mode and the dense warm-up read as
everything sent, tau 0, m_k 1.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import warnings
from typing import (Callable, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from gtopkssgd_tpu_torch.compression import get_compressor
from gtopkssgd_tpu_torch.obs import counters as obs_counters
from gtopkssgd_tpu_torch.modes import (
    ALL_MODES,
    DENSE_MODES,
    HIER_MODES,
    LAYERWISE_MODES,
)
from gtopkssgd_tpu_torch.ops import (
    k_for_density,
    membership_mask,
    scatter_add_dense,
    select_topk,
)
from gtopkssgd_tpu_torch.ops.topk import _method
from gtopkssgd_tpu_torch.parallel.bucketing import (
    buckets_key,
    device_kind,
    find_select_gamma,
    load_select_gamma,
    parse_buckets,
    parse_pipeline,
    plan_buckets,
)
from gtopkssgd_tpu_torch.parallel.codec import get_codec, roundtrip_aligned
from gtopkssgd_tpu_torch.parallel.collectives import (
    dense_allreduce,
    ici_dense_psum,
    psum,
    sparse_allreduce,
)
from gtopkssgd_tpu_torch.parallel.comm_model import committed_fit
from gtopkssgd_tpu_torch.parallel.planner import build_decision, validate_pin

Schedule = Callable[[int], float]


def clip_by_global_norm(flat: torch.Tensor, max_norm: float) -> torch.Tensor:
    """flat * min(1, max_norm / (||flat|| + 1e-6)), in float32: the JAX
    optimizer's clip before compression."""
    gnorm = torch.sqrt(torch.sum(flat * flat))
    # An IEEE quotient: torch computes a Python number over a tensor as
    # the tensor's reciprocal times the number.
    scale = torch.full_like(gnorm, max_norm) / (gnorm + 1e-6)
    return flat * torch.clamp(scale, max=1.0)


def velocity_update(momentum: float, u: torch.Tensor,
                    flat: torch.Tensor) -> torch.Tensor:
    """momentum * u + flat rounded once to float32, as a fused multiply-add
    rounds it (XLA emits one for the JAX optimizer's expression). Two
    float32 roundings would differ by an ulp in some entries, and v sums
    the velocities, so the difference would grow step by step. The
    product of two float32 values is exact in float64; the sum rounds to
    float64 and then to float32."""
    m = float(np.float32(momentum))
    return (m * u.double() + flat.double()).float()


def _mean(total: torch.Tensor, p: int) -> torch.Tensor:
    """total / p as XLA compiles the JAX optimizer's division by the
    constant P: times the float32 reciprocal of P (exact at powers of
    two)."""
    return total * float(np.float32(1.0) / np.float32(p))


def _zero_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x with the entries at idx set to 0; padding indices (n) drop out."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1)])
    out.index_fill_(0, idx.clamp(max=n).long(), 0.0)  # no host copy
    return out[:n]


class FlatLayout:
    """Map between a list of parameters and one flat f32[N] vector.

    Entry i is (param, perm): its segment of the flat vector is
    ``param.permute(perm).reshape(-1)``, segments back to back in list
    order. ``perm`` turns the port's tensor layout into the reference's
    (conv OIHW -> HWIO is (2, 3, 1, 0), Linear (out, in) -> (in, out) is
    (1, 0)); the identity keeps a tensor as it is.
    """

    def __init__(self, entries: Sequence[Tuple[torch.Tensor,
                                               Tuple[int, ...]]]):
        self.params: List[torch.Tensor] = [p for p, _ in entries]
        self.perms = [tuple(perm) for _, perm in entries]
        self.shapes = [tuple(p.permute(perm).shape) for p, perm in entries]
        self.inverse = [tuple(sorted(range(len(perm)), key=perm.__getitem__))
                        for perm in self.perms]
        self.sizes = [p.numel() for p in self.params]
        self.offsets, off = [], 0
        for s in self.sizes:
            self.offsets.append(off)
            off += s
        self.n = off

    @classmethod
    def identity(cls, params: Iterable[torch.Tensor]) -> "FlatLayout":
        return cls([(p, tuple(range(p.dim()))) for p in params])

    def _segments(self, flat: torch.Tensor):
        for off, size, shape in zip(self.offsets, self.sizes, self.shapes):
            yield flat[off:off + size].view(shape)

    def ravel(self, tensors: Sequence[Optional[torch.Tensor]],
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Flatten `tensors` (shaped like the params; None = zeros)."""
        if out is None:
            out = torch.empty(self.n, dtype=torch.float32,
                              device=self.params[0].device)
        for seg, t, perm in zip(self._segments(out), tensors, self.perms):
            if t is None:
                seg.zero_()
            else:
                seg.copy_(t.permute(perm))
        return out

    def unravel_into(self, flat: torch.Tensor,
                     targets: Sequence[torch.Tensor]) -> None:
        """Copy each segment of `flat` into the matching target tensor."""
        for seg, t, inv in zip(self._segments(flat), targets, self.inverse):
            t.copy_(seg.permute(inv))


def _add_at(x: torch.Tensor, pos: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """x with v added at positions pos (int64, in [0, n]); n drops out."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1)])
    out.index_add_(0, pos, v)
    return out[:n]


def wire_k(compression: Optional[str], density: float, n: int,
           leaf_sizes: Optional[Sequence[int]] = None) -> int:
    """Elements a rank communicates a step: n for the dense modes, k =
    ceil(rho * n) for the flat sparse modes, and under ``gtopk_layerwise``
    the concatenation of the per-leaf selections, sum_l ceil(rho * n_l),
    which the per-leaf ceil can push several times above ceil(rho * n) at
    low densities. Layer-wise therefore needs ``leaf_sizes`` and raises
    without them. A bucketed layer-wise wire ships its buckets' k
    instead (``parallel.bucketing.BucketPlan.k_total``)."""
    if compression in DENSE_MODES:
        return n
    if compression in LAYERWISE_MODES:
        if not leaf_sizes:
            raise ValueError(
                "wire_k/effective_density for layerwise modes needs "
                "leaf_sizes: per-leaf ceil rounding makes the communicated "
                "set sum(ceil(rho*n_l)), not ceil(rho*N)")
        return sum(k_for_density(int(s), density) for s in leaf_sizes)
    return k_for_density(n, density)


def effective_density(compression: Optional[str], density: float,
                      leaf_sizes: Optional[Sequence[int]] = None) -> float:
    """The density a rank communicates, ``wire_k / N`` (1.0 for the dense
    modes); layer-wise needs ``leaf_sizes``, as in ``wire_k``."""
    if compression in DENSE_MODES:
        return 1.0
    if compression in LAYERWISE_MODES:
        n = sum(int(s) for s in leaf_sizes) if leaf_sizes else 0
        return wire_k(compression, density, n, leaf_sizes) / n
    return density


class GTopKSGD(torch.optim.SGD):
    """SGD (momentum, weight decay, Nesterov) on the gTop-k-compressed
    gradient; the options of the JAX package's ``gtopk_sgd``.

    ``lr`` is a float or a schedule ``lr(count)`` read before every step,
    count being the number of steps taken. ``layout`` fixes the flat order
    and the leaves of ``gtopk_layerwise`` (default: ``params`` in the
    given order, each raveled as it is). ``process_group`` is the group of
    the P data-parallel ranks, or None for one worker. ``wire_codec`` is a
    ``parallel.codec`` spec (``fp32 | int8[:B] | fp8[:B]``).
    ``hier_ici_size`` is the slice width of ``gtopk_hier``; ``buckets``
    and ``pipeline`` the ``parallel.bucketing`` specs of
    ``gtopk_layerwise`` (``pipeline='overlap'`` needs buckets);
    ``comm_plan`` a ``parallel.planner`` pin or 'auto', priced with the
    fit at ``comm_model_fit`` (default: the fit committed with the port
    for ``process_group``'s backend) and, for the pipelines' spans, the
    selection cost ``select_gamma`` (default: the card's fit for the
    device and method). ``close()`` ends the merge thread of the
    ``overlap`` order.
    ``_restore_rejected_u`` is an ablation of momentum correction only:
    it gives globally rejected picks their velocity back, which the JAX
    package measured to diverge. ``telemetry``, ``telemetry_layers`` and
    ``telemetry_audit_interval`` are the JAX optimizer's counters (see the
    module docstring).

    After a sparse step, ``last_keep`` is the keep mask (P = 1),
    ``last_local`` the shipped local (vals, idx) and ``last_global`` the
    global (gvals, gidx) set (gtopk family) or ``last_union`` the dense
    union before the division by P (the allgather modes). Under a
    bucketed ``gtopk_layerwise`` at P > 1, ``last_local`` and
    ``last_global`` are lists of one set a bucket, in the bucket's own
    index space. All are None after a dense step.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        lr: Union[float, Schedule],
        *,
        momentum: float = 0.9,
        weight_decay: float = 0.0,
        nesterov: bool = False,
        compression: Optional[str] = "gtopk",
        density: float = 0.001,
        topk_method: str = "auto",
        wire_codec="fp32",
        clip_grad_norm: Optional[float] = None,
        hier_ici_size: int = 1,
        comm_plan: Optional[str] = "auto",
        buckets: Union[str, int] = "concat",
        pipeline: str = "serial",
        comm_model_fit: Optional[str] = None,
        select_gamma: Optional[float] = None,
        warmup_dense_steps: int = 0,
        momentum_correction: bool = False,
        telemetry: bool = False,
        telemetry_layers: bool = False,
        telemetry_audit_interval: int = 0,
        _restore_rejected_u: bool = False,
        layout: Optional[FlatLayout] = None,
        process_group=None,
    ):
        mode = compression
        if mode not in ALL_MODES:
            raise ValueError(f"unknown compression mode {mode!r}")
        self.hier = mode in HIER_MODES
        self.layerwise = mode in LAYERWISE_MODES
        if hier_ici_size < 1:
            raise ValueError(
                f"hier_ici_size must be >= 1, got {hier_ici_size}")
        if hier_ici_size > 1 and not self.hier:
            raise ValueError(
                f"hier_ici_size={hier_ici_size} only applies to "
                f"hierarchical modes {HIER_MODES}, not {mode!r}")
        if warmup_dense_steps < 0:
            raise ValueError(
                f"warmup_dense_steps must be >= 0, got {warmup_dense_steps}")
        if telemetry_audit_interval < 0:
            raise ValueError(
                f"telemetry_audit_interval must be >= 0, got "
                f"{telemetry_audit_interval}")
        if (telemetry_layers or telemetry_audit_interval) and not telemetry:
            raise ValueError(
                "telemetry_layers / telemetry_audit_interval extend the "
                "telemetry counters; they require telemetry=True")
        if nesterov and not momentum:
            raise ValueError("nesterov momentum requires momentum > 0")
        self.dense_mode = mode in DENSE_MODES
        if momentum_correction:
            if self.dense_mode:
                raise ValueError(
                    "momentum_correction only applies to sparse modes (the "
                    "dense path IS classic momentum-SGD already)")
            if not momentum:
                raise ValueError("momentum_correction requires momentum > 0")
            if nesterov:
                raise ValueError(
                    "momentum_correction defines its own velocity "
                    "recursion; nesterov is not expressible in it")
        if _restore_rejected_u and not momentum_correction:
            raise ValueError(
                "_restore_rejected_u is a momentum_correction ablation knob; "
                "it needs momentum_correction=True")
        if momentum_correction and self.layerwise:
            warnings.warn(
                "gtopk_layerwise x momentum_correction measured WORSE than "
                "either alone (benchmarks/results/warmup_ab_cpu_mesh8.json: "
                "cold val_top1 0.250 vs 0.734/0.281; masking ablations rule "
                "out a semantics fix) — prefer one or the other",
                stacklevel=2)
        self.codec = get_codec(wire_codec)
        comm_plan = validate_pin(comm_plan, mode, ici_size=hier_ici_size)
        bucket_spec = parse_buckets(buckets)
        if bucket_spec != "concat" and not self.layerwise:
            raise ValueError(
                f"--buckets {buckets!r} only applies to the layerwise mode "
                f"{LAYERWISE_MODES}; {mode!r} has a single wire set per step "
                "already (use --buckets concat)")
        pipeline_spec = parse_pipeline(pipeline)
        if pipeline_spec == "overlap" and bucket_spec == "concat":
            raise ValueError(
                f"--pipeline overlap requires a bucketed layerwise wire "
                f"(--buckets leaf|auto|<int B>); --buckets concat has a "
                "single select/merge pair per step, so there are no stages "
                "to overlap (use --pipeline serial or auto)")
        params = list(params)
        self.schedule = lr if callable(lr) else None
        # Under momentum correction the velocity lives before the exchange
        # (state "u"); the SGD step must not apply momentum a second time.
        super().__init__(params, lr=float(lr(0)) if callable(lr) else lr,
                         momentum=0.0 if momentum_correction else momentum,
                         weight_decay=weight_decay, nesterov=nesterov)
        #: The 'overlap' order's merge thread and side stream, made at
        #: their first use.
        self._pool = self._side = None
        self.layout = layout or FlatLayout.identity(params)
        if {id(p) for p in self.layout.params} != {id(p) for p in params}:
            raise ValueError("layout does not cover exactly these params")
        self.compressor = get_compressor(mode, density, topk_method)
        self.mode = mode
        self.clip_grad_norm = clip_grad_norm
        self.warmup_dense_steps = warmup_dense_steps
        self.correction = momentum_correction
        self.velocity_momentum = momentum
        self.restore_rejected_u = _restore_rejected_u
        self.group = process_group
        self.p = 1
        if process_group is not None:
            self.p = dist.get_world_size(process_group)
            if comm_model_fit is None:
                comm_model_fit = committed_fit(
                    dist.get_backend(process_group))
        p, n = self.p, self.layout.n
        device = params[0].device
        self.ici = hier_ici_size if self.hier and p > 1 else 1
        if p % self.ici:
            raise ValueError(f"axis size {p} not divisible by "
                             f"hier_ici_size={hier_ici_size}")
        #: Per-leaf k (gtopk_layerwise) and the bucket partition (a
        #: bucketed gtopk_layerwise), else None.
        self.leaf_ks = self.bucket_plan = None
        #: ms per 1e6 elements of this run's selection stage: the
        #: argument, else the card's fit for the device and method (None
        #: where there is none, and nothing needs it).
        self.select_gamma = select_gamma
        if select_gamma is None and not self.dense_mode:
            method = _method(topk_method, n)
            self.select_gamma = find_select_gamma(device_kind(device), method)
            prices_selection = bucket_spec != "concat" and (
                pipeline_spec == "auto"
                or (pipeline_spec == "overlap" and bucket_spec != "leaf"))
            if self.select_gamma is None and prices_selection:
                load_select_gamma(device_kind(device), method)  # raises
        if self.layerwise:
            self.leaf_ks = [k_for_density(s, density)
                            for s in self.layout.sizes]
            self.bucket_plan = plan_buckets(
                tuple(self.layout.sizes), density, buckets=bucket_spec, p=p,
                codec=self.codec.name, mode=mode, fit_path=comm_model_fit,
                pipeline=pipeline_spec, select_gamma=self.select_gamma)
        #: The wire plan at P > 1 (parallel.planner.CommPlan) and the
        #: decision that chose it, else None.
        self.plan_decision = self.plan = None
        if p > 1 and not self.dense_mode:
            bplan = self.bucket_plan
            k = self.compressor.k(n)
            if self.layerwise:
                k = bplan.k_total if bplan else sum(self.leaf_ks)
            self.plan_decision = build_decision(
                mode, p=p, n=n, k=k, codec=self.codec.name,
                ici_size=self.ici, pin=comm_plan, fit_path=comm_model_fit,
                bucketing=buckets_key(bucket_spec),
                buckets=bplan.pairs() if bplan else None,
                pipeline=bplan.pipeline if bplan else "serial",
                select_gamma=self.select_gamma)
            self.plan = self.plan_decision.plan
        residual = self.compressor.init_residual(n, device)
        if momentum_correction:
            residual = {"v": residual,
                        "u": torch.zeros(n, dtype=torch.float32,
                                         device=device)}
        self.state["residual"] = residual
        self.state["count"] = 0
        #: The flat gradient of the last step, before the clip (one
        #: buffer, reused).
        self.flat_grad = torch.empty(n, dtype=torch.float32, device=device)
        self.telemetry = telemetry
        self.telemetry_layers = telemetry_layers
        self.audit_interval = telemetry_audit_interval
        #: The scalar fields of ``state["telemetry"]``, in order.
        self.telemetry_fields = (
            obs_counters.field_names(telemetry_audit_interval > 0)
            if telemetry else ())
        if telemetry:
            self._init_telemetry(hier_ici_size, device)
        self.last_keep: Optional[torch.Tensor] = None
        self.last_local = self.last_global = None
        self.last_union: Optional[torch.Tensor] = None

    def _init_telemetry(self, hier_ici_size: int, device) -> None:
        """The telemetry's buffers: the vector (zeros; audit_recall -1),
        the age, the leaf sizes, and the step's wire model as two device
        constants (``obs.counters.wire_model``, the JAX optimizer's
        ``make_telemetry`` arguments)."""
        lay, n = self.layout, self.layout.n
        bplan = self.bucket_plan
        if self.dense_mode:
            k = n
        elif self.layerwise:
            k = bplan.k_total if bplan else sum(self.leaf_ks)
        else:
            k = self.compressor.k(n)
        wire, coll = obs_counters.wire_model(
            n=n, k=k, p=self.p, mode=self.mode,
            ici_size=hier_ici_size if self.hier else 1,
            codec=self.codec.name,
            schedule=self.plan.schedule if self.plan else None,
            buckets=bplan.pairs() if bplan else None)
        self._tel_const = torch.tensor([wire, coll], dtype=torch.float32,
                                       device=device)
        layers = len(lay.sizes) if self.telemetry_layers else 0
        self.state["telemetry"] = obs_counters.zero_vector(
            len(self.telemetry_fields), layers, self.audit_interval > 0,
            device)
        if self.telemetry_layers:
            self.state["age"] = torch.zeros(n, dtype=torch.float32,
                                            device=device)
            self._sizes_f = torch.tensor([max(1, s) for s in lay.sizes],
                                         dtype=torch.float32, device=device)
            self._inv_sizes = torch.tensor(
                [obs_counters.reciprocal(s) for s in lay.sizes],
                dtype=torch.float32, device=device)

    def _observe(self, flat: torch.Tensor, update: torch.Tensor,
                 residual: Optional[torch.Tensor], sel) -> None:
        """Write the step's counters into ``state["telemetry"]`` (and
        advance the age): `flat` is the gradient entering the pipeline,
        `update` the averaged update, `residual` the residual after the
        repair (None in the dense mode), `sel` the sparse step's units
        (None for a dense step: the dense mode and the warm-up)."""
        c, lay, n = obs_counters, self.layout, self.layout.n
        vec = self.state["telemetry"]
        nf = len(self.telemetry_fields)
        post = c.tree_l2(update)
        if sel is None:
            tau = flat.new_zeros(())
            sent = flat.new_full((), float(n))
            m_k = flat.new_ones(())
            acc = sel_dense = None
        else:
            tau, sent, m_k, acc, sel_dense = self._selection_stats(
                sel, update, post)
        res_norm = (flat.new_zeros(()) if residual is None
                    else c.tree_l2(residual))
        tel = c.make_telemetry(
            n=n, wire_bytes=self._tel_const[0],
            collective_count=self._tel_const[1],
            grad_norm_pre=c.tree_l2(flat), grad_norm_post=post,
            residual_norm=res_norm, tau=tau, sent_elems=sent, m_k=m_k)
        if self.dense_mode:
            # The JAX step's densities are constants there, n / n, which
            # XLA folds to exactly 1.
            tel["achieved_density"] = flat.new_ones(())
        parts = [torch.stack([tel[f] for f in c.TELEMETRY_FIELDS])]
        if self.audit_interval > 0:
            # Carry the last audited value; -1 means never audited.
            audit = vec[nf - 1:nf].clone()
            if (sel is not None
                    and self.state["count"] % self.audit_interval == 0):
                recall = self._audit(sel)
                audit = torch.where(recall >= 0, recall, audit)
            parts.append(audit.reshape(1))
        if self.telemetry_layers:
            offs, sizes = lay.offsets, lay.sizes
            age = c.update_age(self.state["age"], update != 0)
            lsel = (c.dense_phase_selection_stats(self._sizes_f)
                    if sel is None else
                    c.selection_layer_stats(acc, sel_dense, offs, sizes))
            res_l = (torch.zeros_like(self._sizes_f) if residual is None
                     else c.seg_l2(residual, offs, sizes))
            block = c.assemble_layer_telemetry(
                sel_stats=lsel, inv_sizes=self._inv_sizes,
                grad_norm_pre_l=c.seg_l2(flat, offs, sizes),
                grad_norm_post_l=c.seg_l2(update, offs, sizes),
                residual_norm_l=res_l,
                residual_age_l=c.layer_age_means(age, offs, sizes,
                                                 self._inv_sizes))
            if self.dense_mode:
                block[0].fill_(1.0)  # the folded constant, as above
            parts.append(block.reshape(-1))
        out = torch.cat(parts)
        if self.p > 1:
            # One all-reduce a step: the axis means of every counter.
            out = _mean(psum(out, group=self.group), self.p)
        vec.copy_(out)

    def _selection_stats(self, sel, update: torch.Tensor,
                         post: torch.Tensor):
        """(tau, sent, m_k, acc, sel_dense) of a sparse step from its
        units: at P = 1 from the keep masks, the kept taus and the update
        (the kept accumulator densified, its norm `post`), at P > 1 from
        the shipped values; `acc` is the flat accumulator and `sel_dense`
        the selection densified, both None unless the per-layer stats
        need them. Several units' norms are one fused reduction."""
        c, n = obs_counters, self.layout.n
        infos = [info for _, _, info in sel]
        accs = [info["acc"] for info in infos]
        acc_sq = c._sq(accs)
        acc = sel_dense = None
        if self.telemetry_layers:
            acc = accs[0] if len(accs) == 1 else torch.cat(accs)
        if self.p == 1:
            if len(infos) == 1:
                tau = infos[0]["tau"]
                sent = infos[0]["keep"].sum(dtype=torch.float32)
            else:
                # A kept entry is never 0 (zeros are kept out), so the
                # update's nonzeros are the keep masks' union.
                taus = torch.stack([info["tau"] for info in infos])
                tau = c._min_nonzero(taus, taus > 0)
                sent = torch.count_nonzero(update).float()
            sel_sq = torch.square(post)
            sel_dense = update if self.telemetry_layers else None
        else:
            vals = [info["local"][0] for info in infos]
            tau = c.selected_tau(vals[0] if len(vals) == 1
                                 else torch.cat(vals))
            sent = (c.sent_count(vals[0]) if len(vals) == 1 else
                    torch.stack([c.sent_count(v) for v in vals]).sum())
            sel_sq = c._sq(vals)
            if self.telemetry_layers:
                # Each unit's picks at their flat positions (padding: n).
                pos = [torch.where(info["local"][1] < s,
                                   info["local"][1].long() + o, n)
                       for o, s, info in sel]
                picks = [info.get("picked", info["local"][0])
                         for info in infos]
                sel_dense = c.densify(n, torch.cat(pos), torch.cat(picks))
        return tau, sent, c.mass_ratio(acc_sq, sel_sq), acc, sel_dense

    def _audit(self, sel) -> torch.Tensor:
        """The recall of this step's selection against the exact top-k of
        the accumulator: a bucketed wire per bucket (k_b each), else over
        the whole flat accumulator with the step's k (the sum of the
        leaves' under gtopk_layerwise)."""
        c, n = obs_counters, self.layout.n

        def mask(s, info):
            if "keep" in info:
                return info["keep"]
            return c.selected_mask(s, info["local"][1])

        if self.bucket_plan is not None:
            pairs = [c.exact_recall(info["acc"], k, mask(s, info))
                     for (_, s, info), k in zip(sel, self.bucket_plan.ks)]
            return c.topk_recall(torch.cat([h for h, _ in pairs]),
                                 torch.cat([v for _, v in pairs]))
        k = sum(self.leaf_ks) if self.layerwise else self.compressor.k(n)
        if len(sel) == 1:
            _, s, info = sel[0]
            acc, sel_mask = info["acc"], mask(s, info)
        else:
            acc = torch.cat([info["acc"] for _, _, info in sel])
            sel_mask = torch.cat([mask(s, info) for _, s, info in sel])
        return c.topk_recall(*c.exact_recall(acc, k, sel_mask))

    def _units(self) -> List[Tuple[int, int]]:
        """The (offset, size) ranges a sparse step selects over one by one:
        the whole vector, the buckets of a bucketed gtopk_layerwise, the
        leaves of gtopk_layerwise at P = 1."""
        lay = self.layout
        if self.bucket_plan is not None:
            bounds = self.bucket_plan.boundaries
            return [(lay.offsets[lo], sum(lay.sizes[lo:hi]))
                    for lo, hi in zip(bounds, bounds[1:])]
        if self.layerwise:
            return list(zip(lay.offsets, lay.sizes))
        return [(0, lay.n)]

    def _clip(self, flat: torch.Tensor) -> torch.Tensor:
        """The clip before compression; under gtopk_layerwise the norm is
        the square root of the leaves' sums of squares, summed in leaf
        order."""
        c = self.clip_grad_norm
        if not self.layerwise:
            return clip_by_global_norm(flat, c)
        total = flat.new_zeros(())
        for off, size in zip(self.layout.offsets, self.layout.sizes):
            f = flat[off:off + size]
            total = total + torch.sum(f * f)
        scale = torch.full_like(total, c) / (torch.sqrt(total) + 1e-6)
        return flat * torch.clamp(scale, max=1.0)

    def compress(self, flat: torch.Tensor) -> torch.Tensor:
        """The update for flat gradient `flat`, averaged over the P ranks;
        advances the residual (and the velocity) and, with telemetry, the
        counters."""
        p = self.p
        self.last_keep = self.last_local = None
        self.last_global = self.last_union = None
        if self.clip_grad_norm is not None:
            flat = self._clip(flat)
        if self.ici > 1:
            with record_function("exchange"):
                flat = ici_dense_psum(flat, ici_size=self.ici,
                                      group=self.group)
        if self.dense_mode:
            update = flat
            if p > 1:
                with record_function("exchange"):
                    update = _mean(dense_allreduce(flat, group=self.group), p)
            if self.telemetry:
                self._observe(flat, update, None, None)
            return update
        state = self.state["residual"]
        u = None
        if self.correction:
            u = velocity_update(self.velocity_momentum, state["u"], flat)
            src, res_in = u, state["v"]
        else:
            src, res_in = flat, state
        if self.state["count"] < self.warmup_dense_steps:
            # Dense warm-up: nothing is selected, so nothing is masked. A
            # slice sum already counts each gradient ici times.
            with record_function("exchange"):
                reduced = src if p == 1 else dense_allreduce(
                    src, group=self.group)
            update, residual, u_out = _mean(reduced, p * self.ici), res_in, u
            sel = None
        elif self.layerwise and self.bucket_plan is None and p > 1:
            update, residual, u_out, sel = self._concat(src, res_in, u)
        else:
            update, residual, u_out, sel = self._by_unit(src, res_in, u)
        self.state["residual"] = ({"v": residual, "u": u_out}
                                  if self.correction else residual)
        if self.telemetry:
            self._observe(flat, update, residual, sel)
        return update

    def _by_unit(self, src: torch.Tensor, res_in: torch.Tensor,
                 u: Optional[torch.Tensor]):
        """(update, residual, u, sel) of a sparse step that selects and
        exchanges each unit (``_units``) on its own, in the bucket plan's
        execution order; `sel` is the units' (offset, size, info), what
        the telemetry reads."""
        units = self._units()
        if (self.p > 1 and len(units) > 1
                and self.bucket_plan.pipeline == "overlap"):
            outs = self._overlap(units, src, res_in, u)
        else:
            outs = [self._sparse(src[o:o + s], res_in[o:o + s],
                                 None if u is None else u[o:o + s])
                    for o, s in units]
        sel = [(o, s, out[3]) for (o, s), out in zip(units, outs)]
        if len(outs) == 1 and self.bucket_plan is None:
            update, residual, u_out, info = outs[0]
            self.last_keep = info.get("keep")
            self.last_local = info.get("local")
            self.last_global = info.get("global")
            self.last_union = info.get("union")
            return update, residual, u_out, sel
        if self.p == 1:
            self.last_keep = torch.cat([info["keep"] for *_, info in outs])
        else:
            self.last_local = [info["local"] for *_, info in outs]
            self.last_global = [info["global"] for *_, info in outs]
        if len(outs) == 1:
            return outs[0][:3] + (sel,)
        cat = [torch.cat([out[j] for out in outs]) for j in range(2)]
        u_out = None if u is None else torch.cat([out[2] for out in outs])
        return cat[0], cat[1], u_out, sel

    def _sparse(self, src: torch.Tensor, res_in: torch.Tensor,
                u: Optional[torch.Tensor]):
        """(update, residual, u, info) of a sparse step over the vector
        `src` (a unit), k = ceil(density * its length); `info` holds the
        keep mask, or the local and global sets or the union."""
        if self.p > 1:
            return self._merge(self._select(src, res_in, u))
        comp = self.compressor
        with record_function("select"):
            acc = comp.accumulate(src, res_in)
            keep, residual, tau = comp.compress_by_threshold(
                acc, grad=src, residual=res_in)
            if u is not None:  # every local pick is delivered at P = 1
                u = torch.where(keep, torch.zeros_like(u), u)
        info = {"keep": keep}
        if self.telemetry:
            info.update(acc=acc, tau=tau)
        return acc - residual, residual, u, info

    def _select(self, src: torch.Tensor, res_in: torch.Tensor,
                u: Optional[torch.Tensor]) -> dict:
        """Stage 1 of a unit at P > 1 (the JAX optimizer's ``_select``):
        accumulate, select the local top-k, zero the picks out of the
        residual and the velocity, and fold a lossy codec's round-trip
        error into the residual. Returns the stage's tensors."""
        comp, n = self.compressor, src.shape[0]
        with record_function("select"):
            acc = comp.accumulate(src, res_in)
            vals, idx, residual = comp.compress(acc, grad=src,
                                                residual=res_in)
            if self.codec.lossy and self.mode != "topk":
                # Ship the roundtripped values and keep their error: repair
                # then restores the original value of a rejected pick. Mode
                # 'topk' ships the exact picks (every one lands), as in the
                # JAX package.
                vq = roundtrip_aligned(self.codec, vals, idx, n=n)
                residual = comp.fold_wire_error(residual, idx, vals - vq)
                vals = vq
            # Momentum factor masking at the local picks, delivered or not.
            u_out = None if u is None else _zero_at(u, idx)
        return {"vals": vals, "idx": idx, "res": residual, "u": u_out,
                "u_in": u, "acc": acc if self.telemetry else None}

    def _merge(self, st: dict):
        """Stage 2 of a unit (the JAX optimizer's ``_merge``): the
        exchange, the repair of rejected picks and the averaged dense
        update. Returns (update, residual, u, info)."""
        comp, p = self.compressor, self.p
        vals, idx, residual, u_out = st["vals"], st["idx"], st["res"], st["u"]
        n = residual.shape[0]
        with record_function("exchange"):
            result, gidx, needs_repair = sparse_allreduce(
                self.mode, vals, idx, k=comp.k(n), n=n, group=self.group,
                ici_size=self.ici, codec=self.codec, plan=self.plan)
        info = {"local": (vals, idx), "acc": st["acc"]}
        if not needs_repair:  # the allgather union: every pick lands
            info["union"] = result
            return _mean(result, p), residual, u_out, info
        info["global"] = (result, gidx)
        residual = comp.repair(residual, vals, idx, gidx)
        u = st["u_in"]
        if u is not None and self.restore_rejected_u:
            pos = idx.clamp(max=n).long()
            rejected = ~membership_mask(idx, gidx)
            back = torch.where(rejected, torch.cat([u, u.new_zeros(1)])[pos],
                               0.0)
            u_out = _add_at(u_out, pos, back)
        return (_mean(scatter_add_dense(n, gidx, result), p), residual,
                u_out, info)

    def _overlap(self, units, src: torch.Tensor, res_in: torch.Tensor,
                 u: Optional[torch.Tensor]) -> list:
        """The units' (update, residual, u, info) under the 'overlap'
        order, the JAX optimizer's double-buffered loop: unit b+1 selects
        while unit b's merge is in flight, one merge at a time. The merges
        run one after the other on the optimizer's merge thread, which is
        the only thread that drives the process group while they run; on
        a CUDA device the selections run on the optimizer's side stream,
        which first waits for the gradient (the current stream), and each
        merge waits for its selection's event. The ops and their values are
        those of the 'serial' order, so the results are bitwise equal."""
        pool = self._merge_pool()
        main = side = None
        if src.is_cuda:
            main = torch.cuda.current_stream(src.device)
            side = self._side_stream(src.device)
            side.wait_stream(main)
            for t in (src, res_in, u):
                if t is not None:  # read on the side stream
                    t.record_stream(side)

        def select(b: int) -> dict:
            o, s = units[b]
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                st = self._select(src[o:o + s], res_in[o:o + s],
                                  None if u is None else u[o:o + s])
            if side is not None:
                st["ready"] = torch.cuda.Event()
                st["ready"].record(side)
                for t in (st["vals"], st["idx"], st["res"], st["u"],
                          st["acc"]):
                    if t is not None:  # made on the side stream, read on main
                        t.record_stream(main)
            return st

        def merge(st: dict):
            if main is None:
                with torch.no_grad():
                    return self._merge(st)
            with torch.no_grad(), torch.cuda.device(main.device), \
                    torch.cuda.stream(main):
                main.wait_event(st["ready"])
                return self._merge(st)

        outs = []
        nxt = select(0)
        for b in range(len(units)):
            future = pool.submit(merge, nxt)
            try:
                nxt = select(b + 1) if b + 1 < len(units) else None
            finally:
                outs.append(future.result())
        return outs

    def _merge_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        """The one thread the 'overlap' order merges on, made at its first
        use; ``close()`` ends it."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gtopk-merge")
        return self._pool

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The CUDA stream the 'overlap' order selects on, made at its
        first use (creating it raises where the device cannot)."""
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        return self._side

    def close(self) -> None:
        """End the merge thread, if the 'overlap' order started one."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _concat(self, src: torch.Tensor, res_in: torch.Tensor,
                u: Optional[torch.Tensor]):
        """(update, residual, u, sel) of gtopk_layerwise under 'concat' at
        P > 1: per-leaf selection, one merge of the concatenated set in
        the global index space."""
        comp, p, n = self.compressor, self.p, src.shape[0]
        lay = self.layout
        with record_function("select"):
            acc = src + res_in
            sel = [select_topk(src[o:o + s], kl, comp.method,
                               residual=res_in[o:o + s])
                   for o, s, kl in zip(lay.offsets, lay.sizes,
                                       self.leaf_ks)]
            vals = torch.cat([v for v, _ in sel])
            idx = torch.cat([(i + o).to(torch.int32)
                             for (_, i), o in zip(sel, lay.offsets)])
            # Where each pick sits in the flat buffer; a leaf's padding
            # index (its size) maps to n and drops out.
            pos = torch.cat([torch.where(i < s, i.long() + o, n)
                             for (_, i), o, s in zip(sel, lay.offsets,
                                                     lay.sizes)])
            residual = _zero_at(acc, pos)
            u_out = None if u is None else _zero_at(u, pos)
            picked = vals
            if self.codec.lossy:
                vq = roundtrip_aligned(self.codec, vals, idx, n=n)
                residual = _add_at(residual, pos, vals - vq)
                vals = vq
        with record_function("exchange"):
            gvals, gidx, _ = sparse_allreduce(
                self.mode, vals, idx, k=sum(self.leaf_ks), n=n,
                group=self.group, codec=self.codec, plan=self.plan)
        self.last_local, self.last_global = (vals, idx), (gvals, gidx)
        rejected = ~membership_mask(idx, gidx)
        residual = _add_at(residual, pos, torch.where(rejected, vals, 0.0))
        if u is not None and self.restore_rejected_u:
            back = torch.where(rejected, torch.cat([u, u.new_zeros(1)])[pos],
                               0.0)
            u_out = _add_at(u_out, pos, back)
        # The telemetry's view: the flat positions (a leaf's padding at n)
        # and, for the per-layer stats, the picks before the codec.
        sel = [(0, n, {"acc": acc, "local": (vals, pos), "picked": picked})]
        return (_mean(scatter_add_dense(n, gidx, gvals), p), residual,
                u_out, sel)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lay = self.layout
        flat = lay.ravel([p.grad for p in lay.params], out=self.flat_grad)
        update = self.compress(flat)
        for p in lay.params:
            if p.grad is None:
                p.grad = torch.empty_like(p)
        lay.unravel_into(update, [p.grad for p in lay.params])
        if self.schedule is not None:
            lr = float(self.schedule(self.state["count"]))
            for group in self.param_groups:
                group["lr"] = lr
        super().step()
        self.state["count"] += 1
        return loss
