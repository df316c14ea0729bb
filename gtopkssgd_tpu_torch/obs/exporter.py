"""Live OpenMetrics export, the port of ``gtopkssgd_tpu/obs/exporter.py``:
scrape the run instead of tailing its files.

``MetricsExporter`` keeps the LATEST numeric value of every metrics record
field it observes and serves them as OpenMetrics text on a localhost HTTP
port -- ``curl localhost:PORT/metrics`` answers "what is this run doing
now" without a shell on the host. Off by default; ``--obs-export-port``
turns it on, and the trainer installs ``observe`` as its
``MetricsLogger``'s sink, so the export sees exactly the records the rank
produces, file or no file.

Standard library only: ``http.server``'s ThreadingHTTPServer on a daemon
thread, bound to 127.0.0.1 (a local diagnostic, not a network service).
Sink errors are swallowed by ``MetricsLogger``, so a wedged exporter
cannot take training down.

The exposition follows the OpenMetrics text format: gauge families
``gtopk_<kind>_<field>``, a record's string fields become labels, ``rank``
is always a label, the body ends with ``# EOF``.
"""

from __future__ import annotations

import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
# Record fields that never become samples or labels.
_META_FIELDS = {"kind", "time"}
# Label values are clipped so a pathological record (a long message
# string) cannot bloat every scrape forever.
_MAX_LABEL_LEN = 120


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt_value(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsExporter:
    """Latest-value store + HTTP endpoint.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    exposed as ``.port`` after ``start()``. ``observe(rec)`` matches the
    MetricsLogger sink signature. Thread-safe: observe happens on the
    training thread, scrapes on the server's handler threads.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 prefix: str = "gtopk"):
        self.host = host
        self.port = port
        self.prefix = _sanitize(prefix)
        self._lock = threading.Lock()
        # {(family, labels-tuple): value}; insertion order groups scrapes.
        self._samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            float] = {}
        # family -> wall time of its newest observation. The
        # latest-value store serves stale gauges forever (a dead rank
        # looks healthy on scrape); the per-family
        # ``<prefix>_scrape_age_seconds`` gauge derived from this map
        # is how a scraper tells "fresh" from "fossil".
        self._family_seen: Dict[str, float] = {}
        self._n_records = 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- ingest
    def observe(self, rec: Dict[str, Any]) -> None:
        """MetricsLogger sink: fold one record into the latest-value
        store. String fields become labels shared by every numeric field
        of the record (so a fleet row's min/max land under
        src=…,field=… labels); numeric fields become gauge samples."""
        kind = rec.get("kind")
        if not isinstance(kind, str) or not kind:
            return
        labels = [("rank", str(rec.get("rank", 0)))]
        numeric = {}
        for key, val in rec.items():
            if key in _META_FIELDS or key == "rank":
                continue
            if isinstance(val, bool):
                numeric[key] = 1.0 if val else 0.0
            elif isinstance(val, (int, float)) and math.isfinite(val):
                numeric[key] = float(val)
            elif isinstance(val, str):
                labels.append((_sanitize(key), val[:_MAX_LABEL_LEN]))
        label_key = tuple(sorted(labels))
        stamp = rec.get("time")
        stamp = (float(stamp) if isinstance(stamp, (int, float))
                 and math.isfinite(stamp) else time.time())
        # Weather-map records additionally fan out their per-link list
        # into <prefix>_link_* families with (link, axis, src, dst)
        # labels — the scrapeable form of `report linkmap`.
        link_samples = []
        if kind == "linkmap" and isinstance(rec.get("links"), list):
            for link in rec["links"]:
                if not isinstance(link, dict):
                    continue
                link_labels = tuple(sorted(
                    [("rank", str(rec.get("rank", 0)))]
                    + [(name, str(link.get(name, ""))[:_MAX_LABEL_LEN])
                       for name in ("link", "axis", "src", "dst")]))
                for field in ("ewma_ms", "ewma_gbps", "n"):
                    val = link.get(field)
                    if isinstance(val, (int, float)) and math.isfinite(val):
                        link_samples.append(
                            (f"{self.prefix}_link_{_sanitize(field)}",
                             link_labels, float(val)))
        with self._lock:
            self._n_records += 1
            for field, val in numeric.items():
                family = f"{self.prefix}_{_sanitize(kind)}_{_sanitize(field)}"
                self._samples[(family, label_key)] = val
                self._family_seen[family] = stamp
            for family, lk, val in link_samples:
                self._samples[(family, lk)] = val
                self._family_seen[family] = stamp

    # ------------------------------------------------------------- expose
    def scrape(self, now: Optional[float] = None) -> str:
        """The OpenMetrics exposition body (also what GET /metrics
        serves): `# TYPE` line per family, samples grouped under it,
        terminated by `# EOF`. Every family additionally gets a
        ``<prefix>_scrape_age_seconds{family=...}`` gauge — seconds
        since its newest observation — because the latest-value store
        otherwise serves a dead rank's last gauges forever and it looks
        healthy. ``now`` overrides the clock (tests)."""
        with self._lock:
            samples = dict(self._samples)
            seen = dict(self._family_seen)
            n = self._n_records
        now = time.time() if now is None else float(now)
        by_family: Dict[str, list] = {}
        for (family, labels), val in samples.items():
            by_family.setdefault(family, []).append((labels, val))
        lines = []
        meta_family = f"{self.prefix}_exporter_records_observed"
        lines.append(f"# TYPE {meta_family} gauge")
        lines.append(f"{meta_family} {n}")
        if seen:
            age_family = f"{self.prefix}_scrape_age_seconds"
            lines.append(f"# TYPE {age_family} gauge")
            for family in sorted(seen):
                age = max(0.0, now - seen[family])
                lines.append(
                    f'{age_family}{{family="{_escape_label(family)}"}} '
                    f"{_fmt_value(age)}")
        for family in sorted(by_family):
            lines.append(f"# TYPE {family} gauge")
            for labels, val in sorted(by_family[family]):
                if labels:
                    body = ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in labels)
                    lines.append(f"{family}{{{body}}} {_fmt_value(val)}")
                else:
                    lines.append(f"{family} {_fmt_value(val)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "MetricsExporter":
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = exporter.scrape().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-scrape stderr
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-exporter",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
