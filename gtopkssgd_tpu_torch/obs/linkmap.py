"""The link weather map, the port of ``gtopkssgd_tpu/obs/linkmap.py``:
per-(link class, peer) comm observability.

The schedules are deterministic round sequences with known peer pairs
(``parallel.collectives``): the hypercube tree exchanges participant a
with a ^ bit in round bit (with a ragged fold and unfold), the balanced
schedule ships round s from rank r to (r + s) mod p, and ``gtopk_hier``
runs its in-slice sum inside each slice of ``--hier-ici`` ranks before
the cross-slice tree. So round -> (src, dst, link class) comes from the
plan (``round_peers``, built on ``collectives._tree_plan``); a gather
phase (``dist.all_gather``: the balanced owner sets, the allgather mode)
counts as p - 1 rounds at offsets 1..p-1, and the dense all-reduce as a
ring of 2(p - 1).

Each profiled collective's measured span is carved into per-round times
in proportion to each round's modeled wire time (alpha + bytes / beta;
by default the card's committed fit, ``carve_defaults``), as critpath's
``wait_split`` carves wire from wait. Per (class, undirected peer pair)
the carved times feed EWMA latency and bandwidth estimates; one durable
"linkmap" record a capture (the calibrator's cadence), then the monitor's
``link_degraded`` rule. Pure host arithmetic.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from gtopkssgd_tpu_torch.parallel import comm_model
from gtopkssgd_tpu_torch.parallel.collectives import _tree_plan

# Link-class names of the two-level topology: "ici" for a hop inside a
# slice of ``--hier-ici`` ranks, "dcn" for every other hop (the JAX
# package's names, kept so records and keys read alike).
AXIS_ICI = "ici"
AXIS_DCN = "dcn"

# ms per byte at 1 Gbps (obs/calib.py's constant, kept here so calib can
# import this module without a cycle).
MS_PER_BYTE_AT_1GBPS = 8e-6

_EPS_MS = 1e-9


def carve_defaults(backend: str = "gloo") -> Dict[str, float]:
    """{alpha_ms, beta_gbps, ici_gbps} that weight the carve when a caller
    passes none: the fit measured on the card and committed for
    `backend` (``parallel.comm_model.COMMITTED_FITS``), the in-slice hop
    at the same bandwidth (one link class measured). The carve is
    scale-free in the measured span, so only the rounds' ratio matters."""
    fit = comm_model.load_fit(comm_model.committed_fit(backend))
    return {"alpha_ms": fit["alpha_ms"], "beta_gbps": fit["beta_gbps"],
            "ici_gbps": fit["beta_gbps"]}


def link_key(axis: str, a: int, b: int) -> str:
    """Canonical undirected link name, e.g. "dcn:2-5". Exchanges are
    keyed by the physical hop, not the message direction."""
    lo, hi = (a, b) if a <= b else (b, a)
    return f"{axis}:{lo}-{hi}"


def parse_link_key(key: str) -> Tuple[str, int, int]:
    """Inverse of link_key: "dcn:2-5" -> ("dcn", 2, 5)."""
    axis, _, pair = str(key).partition(":")
    lo, _, hi = pair.partition("-")
    return axis, int(lo), int(hi)


def _tree_pair_rounds(ranks: Sequence[int]) -> List[List[Tuple[int, int]]]:
    """Round-ordered (src, dst) pairs of the merge tree over the given
    participants, from the schedule ``parallel.collectives._merge_tree``
    and ``ici_dense_psum`` run (``_tree_plan``): the ragged fold, the
    hypercube exchange rounds, the ragged unfold. A hypercube round is a
    two-way exchange: one (lo, hi) pair a physical link."""
    q = len(ranks)
    if q <= 1:
        return []
    m = 1 << (q.bit_length() - 1)
    rounds: List[List[Tuple[int, int]]] = []
    for i, pairs in enumerate(_tree_plan(q)):
        ragged = q > m and i in (0, len(_tree_plan(q)) - 1)
        rounds.append([(ranks[a], ranks[b]) for a, b in pairs
                       if ragged or a < b])
    return rounds


def round_peers(wire_mode: str, p: int, *,
                ici_size: int = 1) -> List[dict]:
    """The deterministic round -> (axis, peer pairs) schedule of one
    collective, straight from the plan (parallel/collectives.py):

      gtopk / tree      ragged fold + hypercube exchanges + unfold over
                        all p ranks, every round on the dcn axis
      gtopk_balanced    the Ok-Topk split-and-reduce: p-1 scatter
                        rounds (round s: r -> (r+s) mod p) then p-1
                        gather rounds with the same offsets (the
                        owner-block all_gather), all dcn
      gtopk_hier        the in-slice sum inside each contiguous slice
                        (axis "ici"), then the cross-slice merge tree
                        with ici_size parallel lanes per slice pair
                        (axis "dcn")
      dense             ring all-reduce: 2(p-1) neighbor rounds
      allgather         p-1 ring rounds

    Returns [{"round": i, "axis": str, "phase": str,
    "pairs": [(src, dst), ...]}, ...]; empty at p <= 1."""
    if p <= 1:
        return []
    rounds: List[dict] = []

    def _add(axis: str, phase: str, pairs: List[Tuple[int, int]]) -> None:
        rounds.append({"round": len(rounds), "axis": axis,
                       "phase": phase, "pairs": pairs})

    if wire_mode == "gtopk_balanced":
        for s in range(1, p):
            _add(AXIS_DCN, "scatter", [(r, (r + s) % p) for r in range(p)])
        for s in range(1, p):
            _add(AXIS_DCN, "gather", [(r, (r + s) % p) for r in range(p)])
    elif wire_mode == "gtopk_hier" and ici_size > 1 and p % ici_size == 0:
        n_slices = p // ici_size
        slices = [[s * ici_size + j for j in range(ici_size)]
                  for s in range(n_slices)]
        for pairs in _tree_pair_rounds(list(range(ici_size))):
            # The same intra-slice exchange runs in every slice at once.
            flat = [(base[a], base[b]) for base in slices
                    for a, b in pairs]
            _add(AXIS_ICI, "ici_psum", flat)
        for pairs in _tree_pair_rounds(list(range(n_slices))):
            # Cross-slice hop: ici_size parallel lanes between the
            # corresponding members of the two slices.
            flat = [(slices[sa][j], slices[sb][j])
                    for sa, sb in pairs for j in range(ici_size)]
            _add(AXIS_DCN, "cross_slice", flat)
    elif wire_mode in ("dense", "psum"):
        for s in range(2 * (p - 1)):
            phase = "reduce_scatter" if s < p - 1 else "allgather"
            _add(AXIS_DCN, phase, [(r, (r + 1) % p) for r in range(p)])
    elif wire_mode == "allgather":
        for s in range(1, p):
            _add(AXIS_DCN, "allgather", [(r, (r + s) % p) for r in range(p)])
    else:  # gtopk and any tree-shaped fallback
        for pairs in _tree_pair_rounds(list(range(p))):
            _add(AXIS_DCN, "tree", pairs)
    return rounds


def rank_rounds(rounds: Iterable[dict], rank: int) -> List[dict]:
    """The one-rank view of a round schedule: for every round the rank
    participates in, {"round", "axis", "phase", "peer", "src", "dst"}.
    The peer is the other endpoint; src/dst keep the schedule's message
    direction (hypercube exchanges are recorded lo->hi)."""
    mine: List[dict] = []
    for rd in rounds:
        for src, dst in rd["pairs"]:
            if rank == src or rank == dst:
                mine.append({
                    "round": rd["round"], "axis": rd["axis"],
                    "phase": rd.get("phase", "?"),
                    "peer": dst if rank == src else src,
                    "src": src, "dst": dst,
                })
                break  # one message per rank per round in every schedule
    return mine


def round_weights(mine: Sequence[dict], wire_bytes: float, *,
                  alpha_ms: Optional[float] = None,
                  beta_gbps: Optional[float] = None,
                  ici_gbps: Optional[float] = None) -> List[float]:
    """Modeled wire ms of each of one rank's rounds — the carve
    weights. Bytes split uniformly over the rank's rounds; each round
    priced alpha + bytes * 8e-6 / beta(axis), with the ici rounds at
    the ici bandwidth. Only the RATIO matters to the carve. Constants
    not passed are ``carve_defaults()``'s."""
    if not mine:
        return []
    alpha_ms, beta_gbps, ici_gbps = _constants(alpha_ms, beta_gbps,
                                               ici_gbps)
    per_round = max(0.0, float(wire_bytes)) / len(mine)
    out = []
    for rd in mine:
        beta = ici_gbps if rd["axis"] == AXIS_ICI else beta_gbps
        out.append(alpha_ms
                   + per_round * MS_PER_BYTE_AT_1GBPS / max(beta, 1e-9))
    return out


def _constants(alpha_ms, beta_gbps, ici_gbps):
    """The carve's constants, the card's committed fit for those not
    given."""
    if alpha_ms is None or beta_gbps is None or ici_gbps is None:
        d = carve_defaults()
        alpha_ms = d["alpha_ms"] if alpha_ms is None else alpha_ms
        beta_gbps = d["beta_gbps"] if beta_gbps is None else beta_gbps
        ici_gbps = d["ici_gbps"] if ici_gbps is None else ici_gbps
    return float(alpha_ms), float(beta_gbps), float(ici_gbps)


def carve_rounds(t_comm_ms: float,
                 weights: Sequence[float]) -> List[float]:
    """Carve one measured comm span into per-round times in proportion
    to the modeled weights — the same proportional split critpath's
    ``wait_split`` applies to wire vs wait, here applied round-wise.
    Slack (measured > modeled) and compression (measured < modeled)
    both scale every round by the same factor, so the carve conserves
    the measured span exactly: sum(result) == t_comm_ms."""
    total = sum(weights)
    if total <= 0.0 or not weights:
        n = max(1, len(weights))
        return [max(0.0, float(t_comm_ms)) / n] * len(weights)
    scale = max(0.0, float(t_comm_ms)) / total
    return [w * scale for w in weights]


class LinkMap:
    """One rank's live link weather map.

    Feed it the measured comm span of a profiled dispatch (the same
    (wire_bytes, t_comm_ms) sample the calibrator sees) and it carves
    the span over the schedule's rounds, folds each round into the
    per-(axis, peer) EWMA latency/bandwidth estimates, writes ONE
    durable "linkmap" record (flush=True — the map must survive a hard
    kill), and only then feeds the monitor's ``link_degraded`` rule —
    so the durable evidence always precedes a halt raise."""

    def __init__(self, wire_mode: str, p: int, *, rank: int = 0,
                 ici_size: int = 1, ewma_alpha: float = 0.3,
                 alpha_ms: Optional[float] = None,
                 beta_gbps: Optional[float] = None,
                 ici_gbps: Optional[float] = None,
                 metrics=None, monitor=None):
        self.wire_mode = str(wire_mode)
        self.p = int(p)
        self.rank = int(rank)
        self.ici_size = int(ici_size)
        self.ewma_alpha = float(ewma_alpha)
        self.alpha_ms, self.beta_gbps, self.ici_gbps = _constants(
            alpha_ms, beta_gbps, ici_gbps)
        self.metrics = metrics
        self.monitor = monitor
        self.rounds = round_peers(self.wire_mode, self.p,
                                  ici_size=self.ici_size)
        self.mine = rank_rounds(self.rounds, self.rank)
        # link key -> {axis, src, dst, ewma_ms, ewma_gbps, n}
        self.links: Dict[str, dict] = {}
        self.n_observations = 0

    def observe(self, step: int, *, t_comm_ms: float,
                wire_bytes: float) -> Optional[dict]:
        """One profiled sample -> carve, EWMA update, durable record,
        then the anomaly rule (which may raise AnomalyHalt — after the
        record is already on disk). Returns the record, or None when
        the schedule has no rounds (p <= 1)."""
        if not self.mine:
            return None
        weights = round_weights(self.mine, wire_bytes,
                                alpha_ms=self.alpha_ms,
                                beta_gbps=self.beta_gbps,
                                ici_gbps=self.ici_gbps)
        carved = carve_rounds(t_comm_ms, weights)
        per_round_bytes = max(0.0, float(wire_bytes)) / len(self.mine)
        a = self.ewma_alpha
        round_rows = []
        for rd, t_ms in zip(self.mine, carved):
            key = link_key(rd["axis"], self.rank, rd["peer"])
            gbps = (per_round_bytes * MS_PER_BYTE_AT_1GBPS
                    / max(t_ms, _EPS_MS))
            link = self.links.get(key)
            if link is None:
                link = {"axis": rd["axis"],
                        "src": min(self.rank, rd["peer"]),
                        "dst": max(self.rank, rd["peer"]),
                        "ewma_ms": t_ms, "ewma_gbps": gbps, "n": 0}
                self.links[key] = link
            else:
                link["ewma_ms"] += a * (t_ms - link["ewma_ms"])
                link["ewma_gbps"] += a * (gbps - link["ewma_gbps"])
            link["n"] += 1
            round_rows.append({"round": rd["round"], "axis": rd["axis"],
                               "src": rd["src"], "dst": rd["dst"],
                               "t_ms": round(t_ms, 6)})
        self.n_observations += 1
        rec = self.record(step)
        rec["rounds"] = round_rows
        rec["t_comm_ms"] = round(float(t_comm_ms), 6)
        rec["wire_bytes"] = float(wire_bytes)
        if self.metrics is not None:
            self.metrics.log("linkmap", flush=True, step=step, **rec)
        if self.monitor is not None:
            # AFTER the durable write: the rule may raise AnomalyHalt.
            self.monitor.observe_links(step, self.ewma_by_link())
        return rec

    def ewma_by_link(self) -> Dict[str, float]:
        return {key: link["ewma_ms"]
                for key, link in sorted(self.links.items())}

    def record(self, step: int) -> dict:
        """The weather-map snapshot: every link's EWMAs plus the
        worst-link summary fields the watch/fleet surfaces read."""
        links = [{"link": key, **{k: (round(v, 6)
                                      if isinstance(v, float) else v)
                                  for k, v in link.items()}}
                 for key, link in sorted(self.links.items())]
        rec = {"wire_mode": self.wire_mode, "p": self.p,
               "ici_size": self.ici_size, "n_links": len(links),
               "n_rounds": len(self.mine),
               "n_obs": self.n_observations, "links": links}
        worst = worst_link(links)
        if worst is not None:
            med = _median([l["ewma_ms"] for l in links])
            rec.update({
                "worst_link": worst["link"], "worst_axis": worst["axis"],
                "worst_src": worst["src"], "worst_dst": worst["dst"],
                "worst_ewma_ms": round(float(worst["ewma_ms"]), 6),
                "median_ewma_ms": round(med, 6),
                "worst_over_median_x": round(
                    float(worst["ewma_ms"]) / max(med, _EPS_MS), 6),
            })
        return rec


def _median(vals: Sequence[float]) -> float:
    s = sorted(float(v) for v in vals)
    if not s:
        return 0.0
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def worst_link(links: Sequence[dict]) -> Optional[dict]:
    """The link with the highest EWMA latency; ties break toward the
    lexicographically first key so the pick is deterministic."""
    best = None
    for link in sorted(links, key=lambda l: str(l.get("link"))):
        if not isinstance(link.get("ewma_ms"), (int, float)):
            continue
        if best is None or link["ewma_ms"] > best["ewma_ms"]:
            best = link
    return best


def linkmap_rows(records: Iterable[dict]) -> List[dict]:
    """Join "linkmap" records (one stream or a fleet's concatenated
    shards) into one per-link table: each observing rank contributes
    its LAST record's EWMA for the link, and endpoints average — both
    ends of a slow hop see it, one end of a slow rank does. Rows sorted
    by key, each {link, axis, src, dst, n_ranks, n_obs, ewma_ms,
    ewma_gbps, vs_median_x}."""
    # (link, observing rank) -> latest link snapshot
    latest: Dict[Tuple[str, int], dict] = {}
    obs_count: Dict[Tuple[str, int], int] = {}
    for rec in records:
        if rec.get("kind") not in (None, "linkmap"):
            continue
        if not isinstance(rec.get("links"), list):
            continue
        rank = int(rec.get("rank", 0) or 0)
        for link in rec["links"]:
            key = str(link.get("link"))
            if not key or not isinstance(link.get("ewma_ms"),
                                         (int, float)):
                continue
            latest[(key, rank)] = link
            obs_count[(key, rank)] = int(link.get("n", 1))
    by_link: Dict[str, List[Tuple[int, dict]]] = {}
    for (key, rank), link in latest.items():
        by_link.setdefault(key, []).append((rank, link))
    rows: List[dict] = []
    for key in sorted(by_link):
        contrib = by_link[key]
        ewma_ms = sum(float(l["ewma_ms"]) for _, l in contrib) / len(contrib)
        gbps = [float(l["ewma_gbps"]) for _, l in contrib
                if isinstance(l.get("ewma_gbps"), (int, float))]
        axis, src, dst = parse_link_key(key)
        rows.append({
            "link": key, "axis": axis, "src": src, "dst": dst,
            "n_ranks": len(contrib),
            "n_obs": sum(obs_count.get((key, r), 0) for r, _ in contrib),
            "ewma_ms": round(ewma_ms, 6),
            "ewma_gbps": (round(sum(gbps) / len(gbps), 6)
                          if gbps else None),
        })
    med = _median([r["ewma_ms"] for r in rows])
    for r in rows:
        r["vs_median_x"] = round(r["ewma_ms"] / max(med, _EPS_MS), 4)
    return rows


def summarize_linkmap(records: Iterable[dict]) -> dict:
    """{rows, worst, median_ewma_ms, n_links, axes} over a record
    stream — the joined fleet weather map plus the per-axis fit lines
    (from the stream's last calib record carrying dotted per-axis
    keys, e.g. "alpha_ms.dcn")."""
    records = list(records)
    rows = linkmap_rows(records)
    axes: Dict[str, dict] = {}
    for rec in records:
        if rec.get("kind") != "calib":
            continue
        for field, val in rec.items():
            if not isinstance(val, (int, float)):
                continue
            for prefix in ("alpha_ms.", "beta_gbps."):
                if field.startswith(prefix):
                    axis = field[len(prefix):]
                    axes.setdefault(axis, {})[prefix[:-1]] = float(val)
    return {
        "rows": rows,
        "worst": worst_link(rows),
        "median_ewma_ms": _median([r["ewma_ms"] for r in rows]),
        "n_links": len(rows),
        "axes": axes,
    }


def format_linkmap(summary: dict) -> str:
    """The weather map as text: per-link table, worst-link line,
    axis-level fit lines."""
    rows = summary["rows"]
    if not rows:
        return ("linkmap: no linkmap records (run with --obs-linkmap, "
                "or the shards predate the link plane)")
    widths_rows = []
    for r in rows:
        widths_rows.append([
            r["link"], r["axis"], str(r["n_ranks"]), str(r["n_obs"]),
            f"{r['ewma_ms']:.4f}",
            ("-" if r["ewma_gbps"] is None else f"{r['ewma_gbps']:.4f}"),
            f"{r['vs_median_x']:.2f}x",
        ])
    header = ["link", "axis", "n_ranks", "n_obs", "ewma_ms",
              "ewma_gbps", "vs_median"]
    cols = [max(len(str(row[i])) for row in [header] + widths_rows)
            for i in range(len(header))]
    lines = [f"linkmap: {len(rows)} link(s)  median_ewma_ms="
             f"{summary['median_ewma_ms']:.4f}"]
    for row in [header, ["-" * w for w in cols]] + widths_rows:
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(row, cols)))
    worst = summary.get("worst")
    if worst is not None:
        lines.append(
            f"worst link: {worst['link']} "
            f"(ewma {float(worst['ewma_ms']):.4f} ms, "
            f"{float(worst.get('vs_median_x', 0.0)):.2f}x the fleet "
            "median)")
    for axis in sorted(summary.get("axes", {})):
        fit = summary["axes"][axis]
        lines.append(
            f"axis {axis}: alpha_ms={fit.get('alpha_ms')} "
            f"beta_gbps={fit.get('beta_gbps')} (per-axis calib fit)")
    return "\n".join(lines)


def axis_breakdown(wire_mode: str, p: int, *, ici_size: int = 1,
                   wire_bytes: float, t_comm_ms: float,
                   alpha_ms: Optional[float] = None,
                   beta_gbps: Optional[float] = None,
                   ici_gbps: Optional[float] = None,
                   rank: int = 0) -> Dict[str, dict]:
    """Split one blended (wire_bytes, t_comm_ms) sample per axis by the
    same proportional carve the weather map uses: {axis: {wire_bytes,
    t_ms, msgs}}. This is how the calibrator turns its one blended
    measurement into per-axis sample pools — hier's ici and dcn hops
    each get their modeled share of the measured span."""
    mine = rank_rounds(round_peers(wire_mode, p, ici_size=ici_size), rank)
    if not mine:
        return {}
    weights = round_weights(mine, wire_bytes, alpha_ms=alpha_ms,
                            beta_gbps=beta_gbps, ici_gbps=ici_gbps)
    carved = carve_rounds(t_comm_ms, weights)
    per_round_bytes = max(0.0, float(wire_bytes)) / len(mine)
    out: Dict[str, dict] = {}
    for rd, t_ms in zip(mine, carved):
        ax = out.setdefault(rd["axis"],
                            {"wire_bytes": 0.0, "t_ms": 0.0, "msgs": 0})
        ax["wire_bytes"] += per_round_bytes
        ax["t_ms"] += t_ms
        ax["msgs"] += 1
    return out
