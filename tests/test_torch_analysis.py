"""The port's graftlint (gtopkssgd_tpu_torch.analysis) against the JAX
package's (gtopkssgd_tpu.analysis), on the same inputs.

* metric-kind, exit-code, durable-event, event-rule: each case is one
  fixture tree (with its own utils/metrics.py, exit_codes.py and
  obs/events.py) linted by both analyzers; the findings must be equal as
  sets of (rule, path, line, symbol).
* host-sync-in-jit and codec-wire: each JAX case has a torch twin of the
  same shape (a CUDA-graph block, ``torch.compile`` or the optimizer's
  ``step`` in place of ``jax.jit``; ``torch.distributed`` calls in place
  of ``lax``); both give the same findings on the same lines.
* Suppression, baseline round trip, line drift and the CLI's exit codes
  behave as in JAX; the shipped tree lints clean against the port's
  baseline; the analyzer imports neither torch, jax nor gtopkssgd_tpu.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from gtopkssgd_tpu.analysis import engine as jax_engine
from gtopkssgd_tpu.analysis.__main__ import main as jax_main
from gtopkssgd_tpu.analysis.rules import ALL_RULES as JAX_RULES
from gtopkssgd_tpu_torch.analysis import engine
from gtopkssgd_tpu_torch.analysis.__main__ import (
    DEFAULT_BASELINE,
    main as port_main,
)
from gtopkssgd_tpu_torch.analysis.callgraph import CallGraph
from gtopkssgd_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_NAME

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gtopkssgd_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _tree(root, files: dict) -> str:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(root)


def _port(root, rule, baseline=None):
    return engine.run([root], rules=ALL_RULES, rule_names={rule},
                      baseline=baseline, root=root)


def _jax(root, rule, baseline=None):
    return jax_engine.run([root], rules=JAX_RULES, rule_names={rule},
                          baseline=baseline, root=root)


def _keys(findings):
    return {(f.rule, f.path, f.line, f.symbol) for f in findings}


# ------------------------------------------- the registry-backed rules

METRICS_FIXTURE = """\
    KINDS = frozenset({"train", "event"})
"""
EXIT_FIXTURE = """\
    EXIT_OK = 0
    EXIT_WEDGED = 7
"""
EVENTS_FIXTURE = """\
    RULES = frozenset({"nan_loss", "goodput_collapse"})
"""
REGISTRIES = {"pkg/utils/metrics.py": METRICS_FIXTURE,
              "pkg/exit_codes.py": EXIT_FIXTURE,
              "pkg/obs/events.py": EVENTS_FIXTURE}

# (id, rule, the files beside the registries, findings expected)
SHARED_CASES = [
    ("metric_kind_unregistered_literal", "metric-kind", {
        "pkg/mod.py": """\
            def f(m):
                m.log("tpyo_kind", step=1)
        """}, 1),
    ("metric_kind_literal_and_bound_name", "metric-kind", {
        "pkg/mod.py": """\
            KIND = "event"

            def f(m):
                m.log("train", step=1)
                m.log(KIND, step=2)
        """}, 0),
    ("metric_kind_fstring", "metric-kind", {
        "pkg/mod.py": """\
            def f(m, i):
                m.log(f"train_{i}", step=1)
        """}, 1),
    ("metric_kind_numeric_and_logger_log", "metric-kind", {
        "pkg/mod.py": """\
            import numpy as np
            import math
            import torch

            def f(logger, x):
                np.log(x)
                math.log(x)
                torch.log(x)
                logger.log(30, "a stdlib-logging message")
        """}, 0),
    ("exit_code_unregistered_literal", "exit-code", {
        "pkg/mod.py": """\
            import sys

            def f():
                sys.exit(8)
        """}, 1),
    ("exit_code_registered_literals", "exit-code", {
        "pkg/mod.py": """\
            import os
            import sys

            def f(bad):
                if bad:
                    raise SystemExit(7)
                os._exit(0)
                sys.exit("a message is rc 1, not a literal code")
        """}, 0),
    ("exit_code_collision_and_minted_constant", "exit-code", {
        "pkg/exit_codes.py": EXIT_FIXTURE + "    EXIT_CLASH = 7\n",
        "pkg/mod.py": "WEDGE_EXIT_CODE = 9\n"}, 2),
    ("durable_event_requires_flush", "durable-event", {
        "pkg/mod.py": """\
            def f(m, extra):
                m.log("event", what="anomaly")
                m.log("event", flush=extra)
        """}, 2),
    ("durable_event_flush_true", "durable-event", {
        "pkg/mod.py": """\
            def f(m):
                m.log("event", flush=True, what="anomaly")
                m.log("train", step=1)  # non-durable: flush optional
        """}, 0),
    ("durable_event_port_kinds", "durable-event", {
        "pkg/mod.py": """\
            def f(m, rec):
                m.log("goodput", **rec)
                m.log("forecast", flush=True, **rec)
                m.log("resize", flush=False)
        """}, 2),
    ("event_rule_unregistered_names", "event-rule", {
        "pkg/mod.py": """\
            def f(fire):
                ev = {"rule": "tpyo_rule", "severity": "warn"}
                fire("also_unregistered", step=1)
                return ev
        """}, 2),
    ("event_rule_registered_and_dynamic", "event-rule", {
        "pkg/mod.py": """\
            def f(fire, name):
                ev = {"rule": "goodput_collapse", "severity": "warn"}
                fire("nan_loss", step=1)
                fire(name, step=2)           # dynamic: runtime _emit's job
                other = {"rule": name}       # non-constant value: ignored
                return ev, other
        """}, 0),
]


@pytest.mark.parametrize("case", SHARED_CASES, ids=[c[0] for c in SHARED_CASES])
def test_registry_rules_match_jax(tmp_path, case):
    _, rule, files, want = case
    root = _tree(tmp_path, {**REGISTRIES, **files})
    port, ref = _port(root, rule), _jax(root, rule)
    assert _keys(port.findings) == _keys(ref.findings)
    assert len(port.findings) == want
    assert all(f.rule == rule for f in port.findings)


def test_unparseable_file_is_its_own_finding(tmp_path):
    root = _tree(tmp_path, {"pkg/broken.py": "def f(:\n"})
    port = engine.run([root], rules=ALL_RULES, root=root)
    ref = jax_engine.run([root], rules=JAX_RULES, root=root)
    assert [f.rule for f in port.findings] == ["syntax"]
    assert _keys(port.findings) == _keys(ref.findings)


# -------------------------------------------------- host-sync twins

HOST_SYNC_POS = """\
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(x):
        y = jnp.sum(x * x)
        return float(y)
"""
HOST_SYNC_POS_TORCH = """\
    import torch


    # the optimizer's step: hot by module contract
    def step(x):
        y = torch.sum(x * x)
        return float(y)
"""

# (id, JAX file, its text, port file, its text)
HOST_SYNC_TWINS = [
    ("positive", "mod.py", HOST_SYNC_POS, "optimizer.py",
     HOST_SYNC_POS_TORCH),
    ("item_and_device_get", "mod.py", """\
        import jax

        @jax.jit
        def step(x):
            a = x.item()
            b = jax.device_get(x)
            return a, b
    """, "optimizer.py", """\
        import torch


        def step(x):
            a = x.item()
            b = x.cpu()
            return a, b
    """),
    ("negative", "mod.py", """\
        import jax
        import jax.numpy as jnp

        @jax.jit
        def step(x, density):
            k = int(x.shape[0])        # static metadata: no sync
            d = float(density)          # parameter, not a jnp product
            return jnp.sum(x) * d, k

        def host_loop(x):
            return float(x)             # not jit-reachable at all
    """, "optimizer.py", """\
        import torch


        def step(x, density: float):
            k = int(x.shape[0])        # static metadata: no sync
            d = float(density)          # a host parameter
            return torch.sum(x) * d, k

        def host_loop(x):
            return float(x)             # not on the hot path at all
    """),
    ("wrapper_call_site_entry", "mod.py", """\
        import jax
        import jax.numpy as jnp

        def build():
            def step(x):
                return float(jnp.sum(x))
            return jax.jit(step)
    """, "mod.py", """\
        import torch


        def build(graph, x):
            def step(x):
                return float(torch.sum(x))
            with torch.cuda.graph(graph):
                return step(x)
    """),
    ("suppressed", "mod.py", """\
        import jax
        import jax.numpy as jnp

        @jax.jit
        def step(x):
            y = jnp.sum(x)
            # graftlint: disable=host-sync-in-jit
            return float(y)
    """, "optimizer.py", """\
        import torch


        def step(x):
            y = torch.sum(x)
            # graftlint: disable=host-sync-in-jit
            return float(y)
    """),
]


@pytest.mark.parametrize("case", HOST_SYNC_TWINS,
                         ids=[c[0] for c in HOST_SYNC_TWINS])
def test_host_sync_twin_matches_jax(tmp_path, case):
    _, jax_file, jax_text, port_file, port_text = case
    ref = _jax(_tree(tmp_path / "jax", {jax_file: jax_text}),
               "host-sync-in-jit")
    port = _port(_tree(tmp_path / "port", {port_file: port_text}),
                 "host-sync-in-jit")
    assert [(f.line, f.symbol) for f in port.findings] == [
        (f.line, f.symbol) for f in ref.findings]
    assert len(port.suppressed) == len(ref.suppressed)


def test_host_sync_baselined_and_line_drift_as_jax(tmp_path):
    for run, name, text in ((_jax, "mod.py", HOST_SYNC_POS),
                            (_port, "optimizer.py", HOST_SYNC_POS_TORCH)):
        root = _tree(tmp_path / run.__name__, {name: text})
        raw = run(root, "host-sync-in-jit")
        baseline = {f.baseline_key: {"reason": "fixture"}
                    for f in raw.findings}
        res = run(root, "host-sync-in-jit", baseline=baseline)
        assert res.findings == [] and len(res.baselined) == 1
        assert res.stale_baseline == []
        shifted = _tree(tmp_path / (run.__name__ + "_v2"), {
            name: "# a new header comment\n" + textwrap.dedent(text)})
        res = run(shifted, "host-sync-in-jit", baseline=baseline)
        assert res.findings == [] and len(res.baselined) == 1


@pytest.mark.parametrize("call,flagged", [
    ("x.tolist()", True), ("x.numpy()", True), ("x.cpu()", True),
    ('x.to("cpu")', True), ('x.to(device="cpu")', True),
    ('x.to(torch.device("cpu"))', True), ('x.to("cuda")', False),
    ("torch.cuda.synchronize()", True), ("event.synchronize()", True),
    ("np.asarray(x)", True), ("np.asarray([1, 2])", False),
    ("bool(x.sum())", True), ("print(x)", True), ('print("step")', False),
    ("int(x.numel())", False), ("int(x.size(0))", False),
    ("float(k)", False), ("int(torch.cuda.device_count())", False),
])
def test_host_sync_torch_reads(tmp_path, call, flagged):
    """The port's flag set, one read at a time, in the optimizer's step
    (``k`` is an annotated host parameter)."""
    root = _tree(tmp_path, {"optimizer.py": f"""\
        import numpy as np
        import torch


        def step(x, event, k: int):
            return {call}
    """})
    res = _port(root, "host-sync-in-jit")
    assert len(res.findings) == int(flagged), res.findings


@pytest.mark.parametrize("root_src", [
    "@torch.compile\ndef hot(x):\n    return float(x.sum())\n",
    "@torch.compile(mode='max-autotune')\n"
    "def hot(x):\n    return float(x.sum())\n",
    "def hot(x):\n    return float(x.sum())\n\n\n"
    "graphed = torch.cuda.make_graphed_callables(hot, (None,))\n",
    "def hot(x):\n    return float(x.sum())\n\n\n"
    "fast = torch.compile(hot)\n",
])
def test_host_sync_graph_and_compile_roots(tmp_path, root_src):
    """``torch.compile`` (decorator or call) and
    ``make_graphed_callables`` make their callee hot; a helper it calls
    is hot too."""
    root = _tree(tmp_path, {"mod.py": "import torch\n\n\n" + root_src})
    res = _port(root, "host-sync-in-jit")
    assert [f.symbol for f in res.findings] == ["hot"]
    plain = _tree(tmp_path / "plain", {
        "mod.py": "def hot(x):\n    return float(x.sum())\n"})
    assert _port(plain, "host-sync-in-jit").findings == []


def test_host_sync_reaches_helpers_across_modules(tmp_path):
    root = _tree(tmp_path, {
        "pkg/optimizer.py": """\
            from pkg.ops import topk


            class Opt:
                def step(self):
                    return self._select(self.flat)

                def _select(self, flat):
                    return topk.select(flat, 8)
        """,
        "pkg/ops/topk.py": """\
            def select(flat, k: int):
                vals = flat.abs().topk(k).values
                return vals.tolist()
        """})
    res = _port(root, "host-sync-in-jit")
    assert [(f.path, f.symbol) for f in res.findings] == [
        ("pkg/ops/topk.py", "select")]


def test_host_sync_follows_a_module_alias(tmp_path):
    """``c = counters`` then ``c.norm(x)``: the helper is hot too (the
    optimizer's counters are reached so)."""
    root = _tree(tmp_path, {
        "pkg/optimizer.py": """\
            from pkg.obs import counters


            def step(x):
                c, n = counters, 4
                return c.norm(x) * n
        """,
        "pkg/obs/counters.py": """\
            def norm(x):
                return float(x.norm())
        """})
    res = _port(root, "host-sync-in-jit")
    assert [(f.path, f.symbol) for f in res.findings] == [
        ("pkg/obs/counters.py", "norm")]


# ------------------------------------------------- codec-wire twins

CODEC_TWINS = [
    ("raw_sparse_gather", "pkg/parallel/coll.py", """\
        from jax import lax

        def bad(vals, idx, axis_name):
            av = lax.all_gather(vals, axis_name, tiled=True)
            ai = lax.all_gather(idx, axis_name, tiled=True)
            return av, ai
    """, "pkg/parallel/coll.py", """\
        import torch.distributed as dist

        def bad(vals, idx, group, gv, gi):
            av = dist.all_gather(gv, vals, group=group)
            ai = dist.all_gather(gi, idx, group=group)
            return av, ai
    """),
    ("encoded_and_dense", "pkg/parallel/coll.py", """\
        from jax import lax

        def good(vals, idx, axis_name, codec, n):
            wire = codec.encode(vals, idx, n=n)
            pwire = tuple(lax.ppermute(w, axis_name, [(0, 1)])
                          for w in wire)
            return codec.decode(pwire, k=2, n=n)

        def dense_ok(x, axis_name):
            return lax.psum(x, axis_name)
    """, "pkg/parallel/coll.py", """\
        import torch.distributed as dist

        def good(vals, idx, peer, codec, n):
            wire = codec.encode(vals, idx, n=n)
            reqs = tuple(dist.isend(w, peer)
                         for w in wire)
            return codec.decode(wire, k=2, n=n), reqs

        def dense_ok(x, group):
            return dist.all_reduce(x, group=group)
    """),
    ("all_to_all_and_nonleading_payload", "pkg/parallel/coll.py", """\
        from jax import lax

        def bad_a2a(vals, axis_name):
            return lax.all_to_all(vals, axis_name, 0, 0)

        def bad_tail(mask, vals, axis_name):
            return lax.ppermute(mask * vals, axis_name, [(0, 1)])

        def good_a2a(vals, idx, axis_name, codec, n):
            wire = codec.encode(vals, idx, n=n)
            swire = tuple(lax.all_to_all(w, axis_name, 0, 0)
                          for w in wire)
            return codec.decode(swire, k=2, n=n)
    """, "pkg/parallel/coll.py", """\
        import torch.distributed as dist

        def bad_a2a(out, vals, group):
            return dist.all_to_all_single(out, vals, group=group)

        def bad_tail(mask, vals, peer):
            return dist.isend(mask * vals, peer)

        def good_a2a(vals, idx, outs, codec, n):
            wire = codec.encode(vals, idx, n=n)
            swire = tuple(dist.all_to_all_single(o, w)
                          for o, w in zip(outs, wire))
            return codec.decode(swire, k=2, n=n)
    """),
    ("scoped_to_parallel", "pkg/other.py", """\
        from jax import lax

        def elsewhere(vals, axis_name):
            return lax.all_gather(vals, axis_name, tiled=True)
    """, "pkg/other.py", """\
        import torch.distributed as dist

        def elsewhere(vals, out):
            return dist.all_gather(out, vals)
    """),
]


@pytest.mark.parametrize("case", CODEC_TWINS, ids=[c[0] for c in CODEC_TWINS])
def test_codec_wire_twin_matches_jax(tmp_path, case):
    _, jax_file, jax_text, port_file, port_text = case
    ref = _jax(_tree(tmp_path / "jax", {jax_file: jax_text}), "codec-wire")
    port = _port(_tree(tmp_path / "port", {port_file: port_text}),
                 "codec-wire")
    assert sorted((f.line, f.symbol) for f in port.findings) == sorted(
        (f.line, f.symbol) for f in ref.findings)


@pytest.mark.parametrize("call", [
    "dist.send(vals, 1)", "dist.recv(idx, 0)", "dist.irecv(out_vals, 0)",
    "dist.P2POp(dist.isend, vals, 1)",
    "dist.batch_isend_irecv(idx_list)", "dist.all_gather(out, idx_b)",
    "dist.all_gather_into_tensor(out, vals_list)", "dist.all_to_all(o, vals)",
    "dist.broadcast(indices, 0)",
])
def test_codec_wire_torch_collectives(tmp_path, call):
    """Each collective of the port's set flags a raw sparse operand."""
    root = _tree(tmp_path, {"pkg/optimizer.py": f"""\
        import torch.distributed as dist


        def f(vals, idx, idx_b, idx_list, vals_list, indices, out, out_vals,
              o):
            return {call}
    """})
    assert len(_port(root, "codec-wire").findings) == 1


# ------------------------------------------------------------- the CLI

def _cli_fixture(rule: str) -> dict:
    return {
        "host-sync-in-jit": {"optimizer.py": HOST_SYNC_POS_TORCH},
        "metric-kind": {**REGISTRIES,
                        "pkg/mod.py": 'def f(m):\n    m.log("nope")\n'},
        "exit-code": {**REGISTRIES, "pkg/mod.py": "import sys\nsys.exit(8)\n"},
        "codec-wire": {"pkg/parallel/coll.py":
                       "import torch.distributed as dist\n\n"
                       "def bad(vals, out):\n"
                       "    return dist.all_gather(out, vals)\n"},
        "durable-event": {**REGISTRIES, "pkg/mod.py":
                          'def f(m):\n    m.log("event", what="x")\n'},
        "event-rule": {**REGISTRIES, "pkg/mod.py":
                       'def f(fire):\n    fire("nope_rule", step=1)\n'},
    }[rule]


def test_rule_names_match_jax(capsys):
    assert [r.name for r in ALL_RULES] == [r.name for r in JAX_RULES]
    assert port_main(["--list-rules"]) == jax_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES_BY_NAME:
        assert out.count(rule) == 2


@pytest.mark.parametrize("rule", list(RULES_BY_NAME))
def test_cli_nonzero_on_every_rule_fixture(tmp_path, rule):
    root = _tree(tmp_path, _cli_fixture(rule))
    assert port_main([root, "--no-baseline", "--rule", rule]) == 1
    if rule in ("metric-kind", "exit-code", "durable-event", "event-rule"):
        assert jax_main([root, "--no-baseline", "--rule", rule]) == 1


def test_cli_usage_codes_match_jax(tmp_path):
    for main in (port_main, jax_main):
        assert main([str(tmp_path), "--rule", "no-such-rule"]) == 2
        assert main([str(tmp_path / "missing")]) == 2
        bad = tmp_path / "bad.json"
        bad.write_text("{")
        assert main([str(tmp_path), "--baseline", str(bad)]) == 2


def test_cli_baseline_round_trip_as_jax(tmp_path, capsys):
    """--write-baseline grandfathers the findings (a TODO reason for
    review to replace); linting against it is then clean; --json
    reports them as baselined."""
    for name, main, files in (
            ("jax", jax_main, {"mod.py": HOST_SYNC_POS}),
            ("port", port_main, {"optimizer.py": HOST_SYNC_POS_TORCH})):
        root = _tree(tmp_path / name, files)
        path = str(tmp_path / f"{name}.json")
        assert main([root, "--no-baseline"]) == 1
        assert main([root, "--write-baseline", path]) == 0
        rows = json.load(open(path))["findings"]
        assert len(rows) == 1 and "TODO" in rows[0]["reason"]
        capsys.readouterr()
        assert main([root, "--baseline", path, "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["findings"] == [] and len(report["baselined"]) == 1


# ------------------------------------------------------- the shipped tree

def test_shipped_tree_lints_clean():
    """The port's gate: any non-baselined finding in the port or in
    chip_smoke.py fails this test. Fix it, suppress it with a reason on
    the line, or (a host sync a later change should remove) grandfather
    it into gtopkssgd_tpu_torch/analysis/baseline.json with a reason."""
    assert port_main([PKG, SMOKE]) == 0, (
        "run `python -m gtopkssgd_tpu_torch.analysis gtopkssgd_tpu_torch "
        "chip_smoke.py` for the report")
    assert port_main([PKG, SMOKE, "--baseline", DEFAULT_BASELINE]) == 0


def test_default_baseline_is_the_ports_own(tmp_path):
    """From another working directory, with no --baseline, the port's
    CLI reads the baseline beside the module (not a
    graftlint_baseline.json in the working directory) and names files
    from the checkout's root."""
    assert DEFAULT_BASELINE == os.path.join(PKG, "analysis", "baseline.json")
    (tmp_path / "graftlint_baseline.json").write_text("{")  # unreadable
    proc = subprocess.run(
        [sys.executable, "-m", "gtopkssgd_tpu_torch.analysis", "--json"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["files_scanned"] >= 70
    assert all(f["path"].startswith("gtopkssgd_tpu_torch/")
               for f in report["suppressed"] + report["baselined"])


def test_committed_baseline_entries_have_reasons():
    with open(DEFAULT_BASELINE) as fh:
        rows = json.load(fh)["findings"]
    for row in rows:
        assert row["rule"] in RULES_BY_NAME
        reason = row.get("reason", "")
        assert reason and "TODO" not in reason, (
            f"baseline entry {row} lacks a real justification")


def test_hot_path_roots_of_the_port():
    """The trainer's captured step and the optimizer's step are the
    port's roots; the selection and the exchange are reached from
    them."""
    files = engine.load_files([PKG], root=REPO)
    graph = CallGraph(files)
    entries = {(fi.sf.rel, fi.qualname) for fi in graph.reachable.values()
               if id(fi.node) in graph.entries}
    assert {("gtopkssgd_tpu_torch/trainer.py", "Trainer._train_step"),
            ("gtopkssgd_tpu_torch/optimizer.py", "GTopKSGD.step")} <= entries
    reached = {(fi.sf.rel, fi.qualname)
               for fi in graph.reachable_functions()}
    assert {("gtopkssgd_tpu_torch/ops/topk.py", "select_topk"),
            ("gtopkssgd_tpu_torch/ops/cuda_topk.py",
             "fused_stage1_candidates"),
            ("gtopkssgd_tpu_torch/parallel/collectives.py",
             "sparse_allreduce")} <= reached


def test_gloo_staging_is_suppressed_with_a_reason():
    """The three deliberate host copies (gloo moves a CUDA tensor by
    host) are flagged and suppressed on their lines, not baselined."""
    res = engine.run([PKG], rules=ALL_RULES, rule_names={"host-sync-in-jit"},
                     root=REPO)
    staged = {f.symbol for f in res.suppressed
              if f.path == "gtopkssgd_tpu_torch/parallel/collectives.py"}
    assert staged == {"_ship", "_gather_wires", "_all_reduce_sum"}


def test_analyzer_never_imports_torch_or_jax():
    code = (
        "import sys\n"
        "import gtopkssgd_tpu_torch.analysis.rules\n"
        "from gtopkssgd_tpu_torch.analysis.__main__ import main\n"
        "assert main(['gtopkssgd_tpu_torch', 'chip_smoke.py']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'gtopkssgd_tpu', 'numpy'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
