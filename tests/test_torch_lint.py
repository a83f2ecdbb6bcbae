"""The port's raylint in tier-1: ``ray_tpu_torch.devtools.lint``.

Mirrors tests/test_lint.py against the port: the live ``ray_tpu_torch``
tree must be clean vs the port's baseline, every pass must catch a
synthetically introduced violation (fixture mini-trees mirroring the
registry's file layout), including through the real
``python -m ray_tpu_torch.devtools.lint`` entry point. On top of the
mirror:

  * parity — every fixture tree goes through the JAX package's lint and
    the port's, and both report the same (pass, file, line, key) set;
  * the port's registry — every (file, qualname) key names a def or a
    class of the port's tree, and the GPU-era renames (``_free_gpus``,
    ``_reclaim_idle_gpu_workers``, ``stop_daemon``) are held by planted
    violations on copies of the port.

No cluster is started anywhere here; the port's lint loads no torch.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from ray_tpu_torch.devtools.lint import cli, core, registry

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_tpu_torch")


def _tree(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(tmp_path)


def _run(root, passes=None):
    return core.run_passes(core.LintTree(root), passes)


def _copy_port(tmp_path):
    dst = str(tmp_path / "ray_tpu_torch")
    shutil.copytree(PORT, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    return dst


# Every fixture tree of this file by name, so the parity case at the end
# runs each through both packages' lints.
_TREES = {}


def _named(name, files):
    assert name not in _TREES, name
    _TREES[name] = files
    return files


# ---------------------------------------------------------------------------
# the live tree
# ---------------------------------------------------------------------------
def test_live_tree_zero_unbaselined_violations():
    """All ten passes over the real port: nothing beyond the checked-in
    baseline (any NEW violation fails tier-1 right here)."""
    rc = cli.main(["-q"])
    if rc != 0:
        # Re-run loudly so the failure output names the violations.
        cli.main([])
    assert rc == 0


def test_live_tree_baseline_is_burndown_debt_only():
    """The port's baseline holds ONLY the two burn-down ratchets:
    broad-except swallows and guarded-by COVERAGE debt. Access
    violations must never be baselined; the other eight passes stay at
    zero."""
    baseline = core.load_baseline(cli.DEFAULT_BASELINE)
    assert baseline, "checked-in baseline missing or empty"
    wrong = [fp for fp in baseline
             if not fp.startswith(("broad-except:", "guarded-by:"))]
    assert wrong == []
    bad = [fp for fp in baseline if fp.startswith("guarded-by:")
           and ":unregistered-field:" not in fp]
    assert bad == []


def test_live_tree_no_baseline_reports_burndown_debt_only(capsys):
    """Without its baseline the port's lint reports broad-except and
    guarded-by ``unregistered-field`` violations and nothing else."""
    rc = cli.main(["--no-baseline", "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {k for k, n in data["per_pass"].items() if n} == {
        "broad-except", "guarded-by"}
    assert [v for v in data["violations"]
            if v["pass"] == "guarded-by"
            and ":unregistered-field:" not in v["fingerprint"]] == []


def test_live_tree_protocol_order_clean(capsys):
    """Every send site of the port, the three GPU-era ones included, is
    registered in a state where the protocol model makes it legal."""
    rc = cli.main(["--passes", "protocol-order", "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert data["total"] == 0


# ---------------------------------------------------------------------------
# per-pass synthetic violations (fixture trees)
# ---------------------------------------------------------------------------
_PROTO = """\
    # Message types: driver -> worker
    EXEC_TASK = "exec_task"
    SHUTDOWN = "shutdown"
"""

_PC_MISSING = _named("protocol-coverage-missing", {
    "_private/protocol.py": _PROTO,
    "_private/worker_proc.py": """\
        from . import protocol as P

        class Worker:
            def _handle_message(self, msg_type, payload):
                if msg_type == P.EXEC_TASK:
                    return False
                return False
    """,
})


def test_protocol_coverage_missing_dispatch_and_fallthrough(tmp_path):
    root = _tree(tmp_path, _PC_MISSING)
    vs = _run(root, ["protocol-coverage"])
    keys = {v.key for v in vs}
    assert "missing:worker.run:SHUTDOWN" in keys
    assert "fallthrough:Worker._handle_message" in keys


_named("protocol-coverage-clean", {
    "_private/protocol.py": _PROTO,
    "_private/worker_proc.py": """\
        import logging
        from . import protocol as P
        logger = logging.getLogger(__name__)

        class Worker:
            def _handle_message(self, msg_type, payload):
                if msg_type == P.EXEC_TASK:
                    return False
                elif msg_type == P.SHUTDOWN:
                    return True
                else:
                    logger.warning("unknown %r", msg_type)
                return False
    """,
})


def test_protocol_coverage_clean_loop_passes(tmp_path):
    root = _tree(tmp_path, _TREES["protocol-coverage-clean"])
    assert _run(root, ["protocol-coverage"]) == []


_named("protocol-coverage-undirected", {
    "_private/protocol.py": """\
        # Message types: per-host daemon <-> head control service
        MYSTERY = "mystery"
    """,
})


def test_protocol_coverage_undirected_constant(tmp_path):
    root = _tree(tmp_path, _TREES["protocol-coverage-undirected"])
    keys = {v.key for v in _run(root, ["protocol-coverage"])}
    assert "undirected:MYSTERY" in keys


_named("lock-discipline-blocking", {
    "_private/netcomm.py": """\
        import threading
        import time

        class ConnectionWriter:
            def __init__(self):
                self._cond = threading.Condition()

            def bad(self):
                with self._cond:
                    time.sleep(1.0)

            def fine(self):
                with self._cond:
                    x = 1
                time.sleep(0.0)
                return x
    """,
})


def test_lock_discipline_blocking_under_hot_lock(tmp_path):
    root = _tree(tmp_path, _TREES["lock-discipline-blocking"])
    vs = _run(root, ["lock-discipline"])
    assert len(vs) == 1
    assert vs[0].key == "ConnectionWriter._cond:time.sleep()"
    assert vs[0].scope == "ConnectionWriter.bad"


_named("lock-discipline-annotated", {
    "_private/netcomm.py": """\
        import threading
        import time

        class ConnectionWriter:
            def __init__(self):
                self._cond = threading.Condition()

            def bounded(self):
                with self._cond:
                    time.sleep(0.001)  # lint: blocking-under-lock-ok bounded debounce, measured
    """,
})


def test_lock_discipline_annotation_suppresses(tmp_path):
    root = _tree(tmp_path, _TREES["lock-discipline-annotated"])
    assert _run(root, ["lock-discipline"]) == []


_named("lock-discipline-annotated-no-reason", {
    "_private/netcomm.py": """\
        import threading
        import time

        class ConnectionWriter:
            def __init__(self):
                self._cond = threading.Condition()

            def bad(self):
                with self._cond:
                    time.sleep(0.001)  # lint: blocking-under-lock-ok
    """,
})


def test_lock_discipline_annotation_without_reason_does_not_suppress(
        tmp_path):
    root = _tree(tmp_path, _TREES["lock-discipline-annotated-no-reason"])
    assert len(_run(root, ["lock-discipline"])) == 1


_named("gate-discipline-site-and-ungated", {
    "_private/fault.py": 'SITES = ("net.connect",)\n',
    "_private/stuff.py": """\
        from . import fault

        def a():
            if fault.enabled:
                fault.fire("net.typo")

        def b():
            fault.fire("net.connect")

        def c():
            if fault.enabled:
                fault.fire("net.connect")
    """,
})


def test_gate_discipline_unknown_site_and_ungated(tmp_path):
    root = _tree(tmp_path, _TREES["gate-discipline-site-and-ungated"])
    keys = {v.key for v in _run(root, ["gate-discipline"])}
    assert "unknown-site:net.typo" in keys
    assert "ungated:fault.fire" in keys
    # c() is fully clean — exactly two distinct defects.
    assert len(keys) == 2


_named("gate-discipline-polarity", {
    "_private/fault.py": 'SITES = ("net.connect",)\n',
    "_private/telemetry.py": """\
        enabled = True
        _ops = 0

        def record_x():
            global _ops
            _ops += 1
    """,
    "_private/stuff.py": """\
        from . import fault
        from . import telemetry

        def inverted():
            if not telemetry.enabled:
                telemetry.record_x()

        def wrong_branch():
            if telemetry.enabled:
                pass
            else:
                telemetry.record_x()

        def wrong_plane():
            if fault.enabled:
                telemetry.record_x()

        def gated_else():
            if not telemetry.enabled:
                pass
            else:
                telemetry.record_x()

        def gated_compound():
            x = 1
            if telemetry.enabled and x:
                telemetry.record_x()
    """,
})


def test_gate_discipline_polarity_branch_and_plane(tmp_path):
    """An inverted gate, a call in the wrong branch, or a guard testing
    the WRONG plane module must all flag."""
    root = _tree(tmp_path, _TREES["gate-discipline-polarity"])
    vs = [v for v in _run(root, ["gate-discipline"])
          if v.key.startswith("ungated:")]
    scopes = sorted(v.scope for v in vs)
    assert scopes == ["inverted", "wrong_branch", "wrong_plane"]


_named("gate-discipline-tracing", {
    "util/tracing.py": """\
        enabled = False
        _ops = 0

        def span(name):
            global _ops
            _ops += 1

        def drain_spans():
            return [], 0
    """,
    "_private/stuff.py": """\
        from ..util import tracing

        def ungated():
            tracing.span("x")

        def gated():
            if tracing.enabled:
                tracing.span("x")

        def annotated(spec):
            if spec.trace_ctx:
                tracing.span("x")  # lint: ungated-instrumentation-ok gated by spec.trace_ctx

        def ungated_helper_free():
            tracing.drain_spans()  # not an _ops helper: no gate needed
    """,
})


def test_gate_discipline_tracing_helpers(tmp_path):
    """Span-recording sites must sit under `if tracing.enabled` (or
    annotate an indirect gate), parsed from util/tracing.py's
    `_ops`-bumping helpers exactly like telemetry's."""
    root = _tree(tmp_path, _TREES["gate-discipline-tracing"])
    vs = [v for v in _run(root, ["gate-discipline"])
          if v.key.startswith("ungated:tracing.")]
    assert [v.scope for v in vs] == ["ungated"]
    assert vs[0].key == "ungated:tracing.span"


_named("protocol-coverage-every-chain", {
    "_private/protocol.py": _PROTO,
    "_private/worker_proc.py": """\
        import logging
        from . import protocol as P
        logger = logging.getLogger(__name__)

        class Worker:
            def _handle_message(self, msgs, payload):
                for msg_type in msgs:
                    if msg_type == P.EXEC_TASK:
                        x = 1
                    # unmatched types silently dropped per-message
                msg_type = msgs[-1]
                if msg_type == P.SHUTDOWN:
                    return True
                else:
                    logger.warning("unknown %r", msg_type)
                return False
    """,
})


def test_protocol_coverage_checks_every_dispatch_chain(tmp_path):
    """A silent-drop chain that is not the LAST chain in the function
    is still flagged."""
    root = _tree(tmp_path, _TREES["protocol-coverage-every-chain"])
    vs = [v for v in _run(root, ["protocol-coverage"])
          if v.key.startswith("fallthrough:")]
    assert len(vs) == 1  # the loop chain; the terminal one logs


_named("gate-discipline-duplicate-metric", {
    "_private/a.py": """\
        from ..util.metrics import Counter
        m = Counter("jobs_total", "desc")
    """,
    "_private/b.py": """\
        from ..util.metrics import Gauge
        m = Gauge("jobs_total", "desc")
    """,
})


def test_gate_discipline_duplicate_metric_kinds(tmp_path):
    root = _tree(tmp_path, _TREES["gate-discipline-duplicate-metric"])
    vs = _run(root, ["gate-discipline"])
    assert {v.key for v in vs} == {"dup-metric:jobs_total"}
    assert len(vs) == 2  # reported at both definition sites


_named("broad-except-swallow", {
    "_private/x.py": """\
        def bad():
            try:
                1 / 0
            except Exception:
                pass

        def annotated():
            try:
                1 / 0
            except Exception:  # lint: broad-except-ok divide probe, failure means feature off
                pass

        def handles():
            try:
                1 / 0
            except Exception as e:
                result = e
                return result
    """,
    "util/outside_scope.py": """\
        def elsewhere():
            try:
                1 / 0
            except Exception:
                pass
    """,
})


def test_broad_except_swallow_flagged_and_annotated(tmp_path):
    root = _tree(tmp_path, _TREES["broad-except-swallow"])
    vs = _run(root, ["broad-except"])
    assert len(vs) == 1
    assert vs[0].scope == "bad"


_named("config-keys-typo", {
    "_private/config.py": """\
        class RayConfig:
            _DEFAULTS = {"pull_retry_attempts": 4}

        ray_config = RayConfig()
    """,
    "_private/y.py": """\
        from .config import ray_config

        def ok():
            return ray_config.pull_retry_attempts

        def typo():
            return ray_config.pull_rety_attempts

        def setter_typo():
            ray_config.set("pull_retry_attemps", 1)
    """,
})


def test_config_keys_typo_flagged(tmp_path):
    root = _tree(tmp_path, _TREES["config-keys-typo"])
    keys = {v.key for v in _run(root, ["config-keys"])}
    assert keys == {"unknown-key:pull_rety_attempts",
                    "unknown-key:pull_retry_attemps"}


# ---------------------------------------------------------------------------
# ref-discipline: ownership/refcount conservation
# ---------------------------------------------------------------------------
# A conservation-clean mini direct plane: the one registered mutation
# helper parks and drains in the same function, the flush elision
# consults the escape mark through a derived local, and the channel
# GEN_ITEM payload is field-conserved (producer writes o/i, consumer
# reads both).
_REF_DIRECT = """\
    class DirectPlane:
        def ref_delta(self, object_id, delta):
            ob = object_id
            if self._absorb:
                self._refs[ob] = self._refs.get(ob, 0) + delta
            else:
                self._ref_buf[ob] = self._ref_buf.get(ob, 0) + delta
            self.flush_accounting()

        def flush_accounting(self):
            with self._lock:
                self._flush_accounting_locked()

        def _flush_accounting_locked(self):
            escaped = bool(self._escaped)
            for ent in self._done_buf:
                if not escaped and ent["deltas"] == 0:
                    continue
                self._send(P.DIRECT_DONE, ent)
            self._done_buf = []

        def send_gen_item(self, oid, index):
            self._send(P.GEN_ITEM, {"o": oid, "i": index})

        def _on_gen_items(self, p):
            return (p["o"], p.get("i"))

        def _on_obj_chunk(self, chan, payload):
            st = self._pulls[payload["r"]]
            if st["view"] is None:
                st["res"] = self.store.reserve(st["oid"], payload["t"])
                st["view"] = st["res"].view()

        def _on_obj_eof(self, chan, payload):
            st = self._pulls[payload["r"]]
            st["res"].seal()
"""

_named("ref-discipline-clean", {"_private/direct.py": _REF_DIRECT})


def test_ref_discipline_clean_fixture(tmp_path):
    root = _tree(tmp_path, _TREES["ref-discipline-clean"])
    assert _run(root, ["ref-discipline"]) == []


_ELISION_SRC = _REF_DIRECT.replace('if not escaped and ent["deltas"] == 0:',
                                   'if ent["deltas"] == 0:')
_named("ref-discipline-elision-bug", {"_private/direct.py": _ELISION_SRC})


def test_ref_discipline_elision_bug(tmp_path):
    """The seeded elision bug: the flush elision stops consulting the
    escape mark, so an escaped id netting zero residual is silently
    dropped while the head holds a waiter on it."""
    assert _ELISION_SRC != _REF_DIRECT
    root = _tree(tmp_path, _TREES["ref-discipline-elision-bug"])
    vs = _run(root, ["ref-discipline"])
    assert [v.key for v in vs] == ["unguarded-elision"]
    assert vs[0].scope == "DirectPlane._flush_accounting_locked"


def test_ref_discipline_elision_bug_on_real_tree(tmp_path):
    """Re-introduce the elision bug into a COPY of the port: delete the
    `not escaped` consult from the real flush elision — the pass must
    flag exactly that guard."""
    dst = _copy_port(tmp_path)
    p = os.path.join(dst, "_private", "direct.py")
    with open(p) as f:
        src = f.read()
    seeded = src.replace("if (not escaped\n                        and ",
                         "if (")
    assert seeded != src, "live elision guard moved; update this test"
    with open(p, "w") as f:
        f.write(seeded)
    keys = [v.key for v in _run(dst, ["ref-discipline"])]
    assert keys == ["unguarded-elision"]
    # The pristine copy is clean (the live tree stays at zero).
    with open(p, "w") as f:
        f.write(src)
    assert _run(dst, ["ref-discipline"]) == []


_named("ref-discipline-unpaired-park", {"_private/direct.py": _REF_DIRECT + """\

        def park_only(self, ob):
            self._ref_buf[ob] = 1

        def park_annotated(self, ob):
            self._refs[ob] = 1  # lint: ref-park-ok caller holds the plane lock and flushes before releasing it
    """})


def test_ref_discipline_unpaired_park_and_annotation(tmp_path):
    root = _tree(tmp_path, _TREES["ref-discipline-unpaired-park"])
    vs = _run(root, ["ref-discipline"])
    assert [(v.scope, v.key) for v in vs] == [
        ("DirectPlane.park_only", "unpaired-park:_ref_buf")]


_named("ref-discipline-unregistered-helper",
       {"_private/direct.py": _REF_DIRECT + """\

        def decref(self, ob):
            pass
    """})


def test_ref_discipline_unregistered_mutation_helper(tmp_path):
    root = _tree(tmp_path, _TREES["ref-discipline-unregistered-helper"])
    keys = {v.key for v in _run(root, ["ref-discipline"])}
    assert keys == {"unregistered-mutation-helper:DirectPlane.decref"}


_named("ref-discipline-registry-rot", {
    "_private/direct.py": _REF_DIRECT.replace("def ref_delta",
                                              "def renamed_delta")})


def test_ref_discipline_registry_rot(tmp_path):
    """A registered helper that vanished from the tree is flagged."""
    root = _tree(tmp_path, _TREES["ref-discipline-registry-rot"])
    keys = {v.key for v in _run(root, ["ref-discipline"])}
    assert keys == {"stale-mutation-helper:DirectPlane.ref_delta"}


_named("reserve-unsettled", {"_private/direct.py": _REF_DIRECT + """\

        def leaky_put(self, oid, size):
            res = self.store.reserve(oid, size)
            return res.view()

        def annotated_put(self, oid, size):
            res = self.store.reserve(oid, size)  # lint: reserve-seal-ok settled by the caller's with-block helper
            return res
    """})


def test_reserve_pairing_unsettled(tmp_path):
    """A reservation opened with no lexical seal/abort (and no
    deferred-settle registry entry) is flagged; an annotated one is
    not."""
    root = _tree(tmp_path, _TREES["reserve-unsettled"])
    vs = _run(root, ["ref-discipline"])
    assert [(v.scope, v.key) for v in vs] == [
        ("DirectPlane.leaky_put", "unsettled-reserve:DirectPlane.leaky_put")]


_named("reserve-lexical-settle", {"_private/direct.py": _REF_DIRECT + """\

        def tidy_put(self, oid, size):
            res = self.store.reserve(oid, size)
            try:
                res.view()[0:1] = b"x"
            except BaseException:
                res.abort()
                raise
            res.seal()
    """})


def test_reserve_pairing_lexical_settle_clean(tmp_path):
    root = _tree(tmp_path, _TREES["reserve-lexical-settle"])
    assert _run(root, ["ref-discipline"]) == []


_DEFERRED_ROT_SRC = _REF_DIRECT.replace("def _on_obj_chunk",
                                        "def _renamed_chunk")
_named("reserve-deferred-rot", {"_private/direct.py": _DEFERRED_ROT_SRC})


def test_reserve_pairing_deferred_registry_rot(tmp_path):
    """Renaming the registered deferred-settle function rots the
    registry AND orphans the (now-undeclared) reserve call."""
    assert _DEFERRED_ROT_SRC != _REF_DIRECT
    root = _tree(tmp_path, _TREES["reserve-deferred-rot"])
    keys = {v.key for v in _run(root, ["ref-discipline"])}
    assert keys == {
        "stale-reserve-deferred:DirectPlane._on_obj_chunk",
        "unsettled-reserve:DirectPlane._renamed_chunk"}


_named("ref-discipline-payload-conservation", {
    "_private/direct.py": _REF_DIRECT.replace(
        '{"o": oid, "i": index}',
        '{"o": oid, "i": index, "x": 0}').replace(
        '(p["o"], p.get("i"))',
        '(p["o"], p.get("i"), p["z"])')})


def test_ref_discipline_payload_conservation(tmp_path):
    """Orphan (produced, never read) and phantom (read, never produced)
    payload fields are both flagged on the channel GEN_ITEM payload."""
    root = _tree(tmp_path, _TREES["ref-discipline-payload-conservation"])
    keys = {v.key for v in _run(root, ["ref-discipline"])}
    assert keys == {"orphan-field:GEN_ITEM(channel):x",
                    "phantom-field:GEN_ITEM(channel):z"}


# ---------------------------------------------------------------------------
# barrier-coverage: head-bound sends ordered after the barrier
# ---------------------------------------------------------------------------
_BARRIER_WP = """\
    from . import protocol as P

    class Worker:
        def request(self, msg_type, payload):
            self.direct._flush_accounting_locked()
            self._writer.send(msg_type, payload)
            return None

        def good(self, spec):
            self.direct.flush_accounting()
            self._writer.send(P.SUBMIT_TASK, {"spec": spec})

        def exempt_send(self):
            self._writer.send_lazy(P.REF_COUNT, {"delta": 1})
"""

_named("barrier-coverage-clean", {"_private/worker_proc.py": _BARRIER_WP})


def test_barrier_coverage_clean_fixture(tmp_path):
    root = _tree(tmp_path, _TREES["barrier-coverage-clean"])
    assert _run(root, ["barrier-coverage"]) == []


_named("barrier-coverage-unflushed",
       {"_private/worker_proc.py": _BARRIER_WP + """\

        def bad(self, spec):
            self._writer.send(P.SUBMIT_TASK, {"spec": spec})

        def annotated(self, spec):
            self._writer.send(P.SUBMIT_TASK, {"spec": spec})  # lint: barrier-ok spec references only head-owned ids
    """})


def test_barrier_coverage_unflushed_send_and_annotation(tmp_path):
    root = _tree(tmp_path, _TREES["barrier-coverage-unflushed"])
    vs = _run(root, ["barrier-coverage"])
    assert [(v.scope, v.key) for v in vs] == [
        ("Worker.bad", "unflushed-send:SUBMIT_TASK")]


_named("barrier-coverage-wrapper-unflushed", {
    "_private/worker_proc.py": _BARRIER_WP.replace(
        "            self.direct._flush_accounting_locked()\n", "")})
_named("barrier-coverage-wrapper-rot", {
    "_private/worker_proc.py": _BARRIER_WP.replace("def request",
                                                   "def renamed_request")})


def test_barrier_coverage_wrapper_must_flush(tmp_path):
    """The covered wrapper (Worker.request) losing its barrier is worse
    than one bad site — every send routed through it loses coverage."""
    root = _tree(tmp_path, _TREES["barrier-coverage-wrapper-unflushed"])
    keys = {v.key for v in _run(root, ["barrier-coverage"])}
    assert keys == {"unflushed-wrapper:Worker.request"}
    # Wrapper deleted outright -> registry rot.
    root2 = _tree(tmp_path / "rot", _TREES["barrier-coverage-wrapper-rot"])
    keys2 = {v.key for v in _run(root2, ["barrier-coverage"])}
    assert keys2 == {"stale-wrapper:Worker.request"}


_named("barrier-coverage-stale-exempt", {
    "_private/worker_proc.py": """\
        class Worker:
            def request(self, m, p):
                self.direct.flush_accounting()
                self._writer.send(m, p)
    """,
    "_private/direct.py": "class DirectPlane:\n    pass\n",
})


def test_barrier_coverage_stale_exempt_registry_rot(tmp_path):
    """With BOTH chokepoint files in scope and no P.<CONST> sends,
    every exemption is provably unused and flagged as registry rot."""
    root = _tree(tmp_path, _TREES["barrier-coverage-stale-exempt"])
    keys = {v.key for v in _run(root, ["barrier-coverage"])}
    assert keys == {f"stale-exempt:{c}" for c in registry.BARRIER_EXEMPT}


# ---------------------------------------------------------------------------
# machine-readable output (--format json / github)
# ---------------------------------------------------------------------------
_SWALLOW = _named("swallow", {
    "_private/x.py": """\
        def f():
            try:
                pass
            except Exception:
                pass
    """,
})


def test_cli_format_json(tmp_path, capsys):
    root = _tree(tmp_path, _SWALLOW)
    rc = cli.main(["--root", root, "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert data["total"] == 1 and data["new"] == 1
    assert data["baselined"] == 0 and data["stale_fingerprints"] == []
    assert data["per_pass"]["broad-except"] == 1
    (v,) = data["violations"]
    assert v["pass"] == "broad-except" and v["new"] is True
    assert v["file"] == "_private/x.py" and v["scope"] == "f"
    assert v["fingerprint"].startswith("broad-except:_private/x.py:f:")
    # Clean tree: rc 0, empty violation list, still valid JSON.
    clean = _tree(tmp_path / "clean", {"_private/x.py": "A = 1\n"})
    rc = cli.main(["--root", clean, "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0 and data["total"] == 0 and data["violations"] == []


def test_cli_format_github(tmp_path, capsys):
    root = _tree(tmp_path, _SWALLOW)
    rc = cli.main(["--root", root, "--format", "github"])
    out = capsys.readouterr().out
    assert rc == 1
    assert out.startswith("::error file=_private/x.py,line=")
    assert "title=raylint broad-except" in out
    # Baselined violations are silent; a fixed one surfaces as a
    # ::notice nudging the baseline refresh.
    bl = str(tmp_path / "bl.json")
    assert cli.main(["--root", root, "--update-baseline",
                     "--baseline", bl]) == 0
    capsys.readouterr()
    assert cli.main(["--root", root, "--format", "github",
                     "--baseline", bl]) == 0
    assert capsys.readouterr().out == ""
    (tmp_path / "_private/x.py").write_text("def f():\n    pass\n")
    assert cli.main(["--root", root, "--format", "github",
                     "--baseline", bl]) == 0
    out = capsys.readouterr().out
    assert out.startswith("::notice title=raylint stale baseline::")
    assert "--update-baseline" in out


# ---------------------------------------------------------------------------
# budget: the full ten-pass live-tree run must stay interactive
# ---------------------------------------------------------------------------
def test_full_tree_wall_clock():
    """The whole suite (parse once + ten passes) over the port gates
    tier-1: pin it under 5s."""
    t0 = time.perf_counter()
    core.run_passes(core.LintTree(PORT))
    elapsed = time.perf_counter() - t0
    assert elapsed < 5.0, f"raylint full-tree run took {elapsed:.2f}s"


# ---------------------------------------------------------------------------
# baseline ratchet semantics
# ---------------------------------------------------------------------------
def test_baseline_ratchet_counts(tmp_path):
    root = _tree(tmp_path, _SWALLOW)
    vs = _run(root, ["broad-except"])
    assert len(vs) == 1
    bl = str(tmp_path / "baseline.json")
    core.save_baseline(bl, vs)
    # Same tree vs its own baseline: clean.
    res = core.apply_baseline(vs, core.load_baseline(bl))
    assert res.new == [] and res.fixed == []
    # A SECOND identical swallow in the same scope exceeds the
    # baselined count -> new.
    (tmp_path / "_private/x.py").write_text(textwrap.dedent("""\
        def f():
            try:
                pass
            except Exception:
                pass
            try:
                pass
            except Exception:
                pass
    """))
    vs2 = _run(str(tmp_path), ["broad-except"])
    res2 = core.apply_baseline(vs2, core.load_baseline(bl))
    assert len(res2.new) == 1
    # Fixing the code makes the entry stale (burn-down signal).
    (tmp_path / "_private/x.py").write_text("def f():\n    pass\n")
    res3 = core.apply_baseline(_run(str(tmp_path), ["broad-except"]),
                               core.load_baseline(bl))
    assert res3.new == [] and len(res3.fixed) == 1


def test_baseline_file_has_per_pass_counts_header():
    with open(cli.DEFAULT_BASELINE) as f:
        data = json.load(f)
    header = "\n".join(data["__comment__"])
    assert "Per-pass counts" in header
    assert "broad-except" in header
    assert "python -m ray_tpu_torch.devtools.lint" in header


# ---------------------------------------------------------------------------
# the real CLI entry point (`python -m ray_tpu_torch.devtools.lint`
# exits nonzero on a synthetic violation)
# ---------------------------------------------------------------------------
def test_cli_module_entry_point_exits_nonzero(tmp_path):
    root = _tree(tmp_path, _SWALLOW)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint",
         "--root", root],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "broad-except" in proc.stdout
    # --update-baseline then re-check: green.
    bl = str(tmp_path / "bl.json")
    for args, want in ((["--update-baseline", "--baseline", bl], 0),
                       (["--baseline", bl], 0)):
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.devtools.lint",
             "--root", root] + args,
            capture_output=True, text=True, env=env, cwd=REPO,
            timeout=120)
        assert proc.returncode == want, proc.stdout + proc.stderr


# A miniature protocol.py for the protocol-order / payload-schema
# fixtures: real plane headers, real constant names (so the registry
# and the model line up), fixture wire values.
_PO_PROTO = '''\
# Message types: driver -> worker
EXEC_TASK = "exec_task"

# Message types: worker -> driver
METRICS_PUSH = "metrics_push"
TASK_DONE = "task_done"
WORKER_BLOCKED = "wkr_blocked"
GET_LOCATIONS = "get_locations"

# Message types: worker <-> worker (the direct call plane)
ACTOR_CALL = "actor_call"
'''


_VIOLATION_FIXTURES = {
    "protocol-coverage": _PC_MISSING,
    "lock-discipline": {
        "_private/netcomm.py": """\
            import threading
            import time

            class ConnectionWriter:
                def __init__(self):
                    self._cond = threading.Condition()

                def bad(self):
                    with self._cond:
                        time.sleep(1.0)
        """,
    },
    "gate-discipline": {
        "_private/fault.py": 'SITES = ("net.connect",)\n',
        "_private/stuff.py": """\
            from . import fault

            def f():
                if fault.enabled:
                    fault.fire("net.typo")
        """,
    },
    "broad-except": _SWALLOW,
    "config-keys": {
        "_private/config.py": """\
            class RayConfig:
                _DEFAULTS = {"alpha": 1}

            ray_config = RayConfig()
        """,
        "_private/y.py": """\
            from .config import ray_config

            def f():
                return ray_config.alhpa
        """,
    },
    "ref-discipline": _TREES["ref-discipline-elision-bug"],
    "barrier-coverage": {
        "_private/worker_proc.py": _BARRIER_WP.replace(
            "            self.direct.flush_accounting()\n", ""),
    },
    "protocol-order": {
        "_private/protocol.py": _PO_PROTO,
        "_private/worker_proc.py": """\
            from . import protocol as P

            class Mux:
                def rogue(self):
                    self.writer.send_message(P.EXEC_TASK, {"spec": 1})
        """,
    },
    "payload-schema": {
        "_private/protocol.py": _PO_PROTO,
        "_private/worker_proc.py": """\
            from . import protocol as P

            class W:
                def blocked(self):
                    self.w.send(P.WORKER_BLOCKED, {"extra": 1})
        """,
    },
}
for _pass, _files in _VIOLATION_FIXTURES.items():
    if _files not in _TREES.values():
        _named(f"violation-{_pass}", _files)


@pytest.mark.parametrize("pass_name", sorted(_VIOLATION_FIXTURES))
def test_cli_exits_nonzero_per_pass_violation(pass_name, tmp_path,
                                              capsys):
    """The CLI exits nonzero on a synthetically introduced violation of
    EACH pass (cli.main is the exact `python -m` code path; the
    subprocess test above covers the interpreter entry)."""
    root = _tree(tmp_path, _VIOLATION_FIXTURES[pass_name])
    rc = cli.main(["--root", root])
    out = capsys.readouterr().out
    assert rc == 1
    assert f"[{pass_name}]" in out


def test_cli_in_process_flags(tmp_path):
    root = _tree(tmp_path, {
        "_private/x.py": "def f():\n    pass\n",
    })
    assert cli.main(["--root", root, "-q"]) == 0
    assert cli.main(["--root", "/nonexistent-raylint-dir"]) == 2


def test_update_baseline_refuses_narrowed_scope(tmp_path):
    """The checked-in baseline can only be rewritten by a FULL run of
    the real tree: --passes (partial) and --root without an explicit
    --baseline (foreign tree) must refuse, not clobber."""
    root = _tree(tmp_path, _SWALLOW)
    before = open(cli.DEFAULT_BASELINE, "rb").read()
    assert cli.main(["--root", root, "--update-baseline"]) == 2
    assert cli.main(["--passes", "broad-except",
                     "--update-baseline"]) == 2
    assert open(cli.DEFAULT_BASELINE, "rb").read() == before
    # Explicit --baseline keeps fixture flows working.
    bl = str(tmp_path / "bl.json")
    assert cli.main(["--root", root, "--update-baseline",
                     "--baseline", bl]) == 0
    assert os.path.exists(bl)


# ---------------------------------------------------------------------------
# protocol-order: seeded-violation fixtures
# ---------------------------------------------------------------------------
def _po_keys(root):
    return {v.key for v in _run(root, ["protocol-order"])}


def test_protocol_order_unregistered_send(tmp_path):
    """A send site in a function with no PROTOCOL_SEND_FUNCS entry
    dodges the ordering contract — flagged by name."""
    root = _tree(tmp_path, _VIOLATION_FIXTURES["protocol-order"])
    assert "unregistered-send:EXEC_TASK" in _po_keys(root)


_named("protocol-order-out-of-order", {
    "_private/protocol.py": _PO_PROTO,
    "_private/worker_proc.py": """\
        from . import protocol as P

        class WorkerClient:
            def incref(self):
                self.w.send(P.EXEC_TASK, {"spec": 1})
    """,
})


def test_protocol_order_out_of_order_send(tmp_path):
    """EXEC_TASK is a head->worker frame; WorkerClient.incref is
    registered as a worker-role OPEN-state sender, so shipping it from
    there is a wrong-role/out-of-order frame."""
    root = _tree(tmp_path, _TREES["protocol-order-out-of-order"])
    keys = _po_keys(root)
    assert "illegal-send:EXEC_TASK" in keys
    assert "unregistered-send:EXEC_TASK" not in keys


_named("protocol-order-no-response-path", {
    "_private/protocol.py": _PO_PROTO,
    "_private/worker_proc.py": """\
        from . import protocol as P

        class WorkerClient:
            def incref(self):
                return self.w.request(P.METRICS_PUSH, {
                    "worker_id": 1, "node_id": 2,
                    "groups": (), "ts": 0.0})
    """,
})


def test_protocol_order_request_without_response_path(tmp_path):
    """A constant shipped through a request wrapper but absent from
    protocol_model.REQUESTS has no verified response path."""
    root = _tree(tmp_path, _TREES["protocol-order-no-response-path"])
    keys = _po_keys(root)
    assert "no-response-path:METRICS_PUSH" in keys
    assert "illegal-send:METRICS_PUSH" not in keys  # legal worker send


_named("protocol-order-send-after-close", {
    "_private/protocol.py": _PO_PROTO,
    "_private/worker_proc.py": """\
        from . import protocol as P

        class WorkerClient:
            def incref(self):
                self.conn.close()
                self.conn.send(P.TASK_DONE, {})
    """,
})


def test_protocol_order_send_after_close(tmp_path):
    root = _tree(tmp_path, _TREES["protocol-order-send-after-close"])
    assert "send-after-teardown:TASK_DONE" in _po_keys(root)


_named("protocol-order-annotated", {
    "_private/protocol.py": _PO_PROTO,
    "_private/worker_proc.py": """\
        from . import protocol as P

        class WorkerClient:
            def incref(self):
                self.w.send(P.EXEC_TASK, {"spec": 1})  # lint: protocol-order-ok fixture wrong-role
    """,
})
_named("protocol-order-stale-annotation", {
    "_private/protocol.py": _PO_PROTO,
    "_private/worker_proc.py": """\
        from . import protocol as P

        class WorkerClient:
            def incref(self):
                self.w.send(P.TASK_DONE, {})  # lint: protocol-order-ok nothing wrong here
    """,
})


def test_protocol_order_annotation_suppresses_and_rots(tmp_path):
    """The escape hatch silences exactly the annotated send; an
    annotation suppressing nothing is itself flagged (rot)."""
    root = _tree(tmp_path, _TREES["protocol-order-annotated"])
    keys = _po_keys(root)
    assert "illegal-send:EXEC_TASK" not in keys
    assert "stale-annotation" not in keys
    root2 = _tree(tmp_path / "rot",
                  _TREES["protocol-order-stale-annotation"])
    assert "stale-annotation" in _po_keys(root2)


# ---------------------------------------------------------------------------
# payload-schema: seeded-violation fixtures
# ---------------------------------------------------------------------------
def _ps_keys(root):
    return {v.key for v in _run(root, ["payload-schema"])}


_named("payload-schema-undeclared-missing", {
    "_private/protocol.py": _PO_PROTO,
    "_private/worker_proc.py": """\
        from . import protocol as P

        class W:
            def blocked(self):
                self.w.send(P.WORKER_BLOCKED, {"extra": 1})

            def locate(self):
                return self.w.request(P.GET_LOCATIONS,
                                      {"timeout": 1.0})
    """,
})


def test_payload_schema_undeclared_and_missing_keys(tmp_path):
    root = _tree(tmp_path, _TREES["payload-schema-undeclared-missing"])
    keys = _ps_keys(root)
    assert "undeclared-key:WORKER_BLOCKED:extra" in keys
    assert "missing-key:GET_LOCATIONS:object_ids" in keys


_named("payload-schema-arity-phantom", {
    "_private/protocol.py": _PO_PROTO,
    "_private/direct.py": """\
        from . import protocol as P

        class DirectPlane:
            def _send_call(self, chan):
                payload = {"c": (1, 2, 3)}
                chan.writer.send_message(P.ACTOR_CALL, payload)

            def _wire_spec(self, payload):
                return payload["bogus"]
    """,
})


def test_payload_schema_arity_drift_and_phantom_field(tmp_path):
    """Producer side: ACTOR_CALL's compact tuple is declared 11 slots —
    shipping 3 breaks every peer's unpack. Consumer side: a registered
    consumer reading a key no variant declares is a phantom field."""
    root = _tree(tmp_path, _TREES["payload-schema-arity-phantom"])
    keys = _ps_keys(root)
    assert "arity-drift:ACTOR_CALL:c" in keys
    assert "phantom-field:ACTOR_CALL:bogus" in keys


# ---------------------------------------------------------------------------
# --since: the incremental CI gate
# ---------------------------------------------------------------------------
def _git(root, *a):
    subprocess.run(["git", "-C", root, "-c", "user.email=t@t",
                    "-c", "user.name=t"] + list(a),
                   check=True, capture_output=True)


def test_cli_since_narrows_reporting(tmp_path, capsys):
    root = _tree(tmp_path, _SWALLOW)
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-q", "-m", "seed")
    # Committed violations are out of an incremental gate's scope.
    assert cli.main(["--root", root, "--since", "HEAD"]) == 0
    capsys.readouterr()
    # A new (untracked) violating file IS in scope — and is the only
    # thing reported.
    (tmp_path / "_private" / "y.py").write_text(
        "def g():\n    try:\n        pass\n    except Exception:\n"
        "        pass\n")
    assert cli.main(["--root", root, "--since", "HEAD"]) == 1
    out = capsys.readouterr().out
    assert "y.py" in out
    assert "x.py" not in out
    # Unknown revs are an explicit usage error, not a silent full run.
    assert cli.main(["--root", root, "--since", "no-such-rev-xyz"]) == 2


def test_cli_since_refuses_update_baseline(tmp_path):
    """The ratchet must be rewritten from a full run, never from a
    changed-files slice."""
    root = _tree(tmp_path, {"_private/x.py": "def f():\n    pass\n"})
    _git(root, "init", "-q")
    bl = str(tmp_path / "bl.json")
    assert cli.main(["--root", root, "--update-baseline",
                     "--baseline", bl, "--since", "HEAD"]) == 2
    assert not os.path.exists(bl)


# ---------------------------------------------------------------------------
# guarded-by: field-level lock-coverage proofs
# ---------------------------------------------------------------------------
# Mirrors the real registry entries for _private/gcs.py (all three
# registered classes, so the fixture itself carries no rot flags).
_GUARDED_GCS = """\
    from . import lockdep


    class ObjectDirectory:
        def __init__(self):
            self._lock = lockdep.rlock("gcs.object_dir")
            self._entries = {}

        def entry(self, oid):
            with self._lock:
                return self._entries.get(oid)

        def drop(self, oid):
            with self._lock:
                self._entries.pop(oid, None)


    class ActorDirectory:
        def __init__(self):
            self._lock = lockdep.rlock("gcs.actor_dir")
            self._actors = {}
            self._named = {}

        def register(self, aid, name):
            with self._lock:
                self._actors[aid] = name
                self._named[name] = aid


    class Pubsub:
        def __init__(self):
            self._lock = lockdep.lock("gcs.pubsub")
            self._subs = {}

        def subscribe(self, topic, fn):
            with self._lock:
                self._subs.setdefault(topic, []).append(fn)
"""


def _gcs_keys(root):
    return [v.key for v in _run(root, ["guarded-by"])
            if v.file == "_private/gcs.py"]


_named("guarded-by-clean", {"_private/gcs.py": _GUARDED_GCS})


def test_guarded_by_clean_fixture(tmp_path):
    root = _tree(tmp_path, _TREES["guarded-by-clean"])
    assert _gcs_keys(root) == []


_named("guarded-by-unguarded", {"_private/gcs.py": _GUARDED_GCS + """\

        def seeded_unlocked_write(self, topic):
            self._subs[topic] = []

        def seeded_unlocked_read(self, topic):
            return self._subs.get(topic)

        def annotated(self, topic):
            return len(self._subs)  # lint: guarded-by-ok exposition-time gauge, len() is GIL-atomic
    """})


def test_guarded_by_unguarded_access_flagged_and_annotated(tmp_path):
    """A write outside the owning lock is caught BY NAME; a reasoned
    annotation on the access line suppresses; a read is distinguished
    from a write in the key."""
    root = _tree(tmp_path, _TREES["guarded-by-unguarded"])
    assert sorted(_gcs_keys(root)) == ["unguarded-read:Pubsub._subs",
                                       "unguarded-write:Pubsub._subs"]


_named("guarded-by-def-line-annotation", {"_private/gcs.py": _GUARDED_GCS + """\

        def snapshot(self):  # lint: guarded-by-ok startup-only: called before the server threads spawn
            return dict(self._subs), len(self._subs)
    """})


def test_guarded_by_def_line_annotation_covers_function(tmp_path):
    """An annotation on the def line blesses every guarded access in
    that function."""
    root = _tree(tmp_path, _TREES["guarded-by-def-line-annotation"])
    assert _gcs_keys(root) == []


_STALE_GCS = _GUARDED_GCS.replace(
    "                self._subs.setdefault(topic, []).append(fn)",
    "                self._subs.setdefault(topic, []).append(fn)"
    "  # lint: guarded-by-ok vestigial reason")
_named("guarded-by-stale-annotation", {"_private/gcs.py": _STALE_GCS})


def test_guarded_by_stale_annotation(tmp_path):
    """An annotation that suppresses nothing is itself flagged."""
    assert _STALE_GCS != _GUARDED_GCS
    root = _tree(tmp_path, _TREES["guarded-by-stale-annotation"])
    keys = _gcs_keys(root)
    assert len(keys) == 1 and keys[0].startswith("stale-annotation:")


_named("guarded-by-rot-class", {"_private/gcs.py": _GUARDED_GCS.replace(
    "class Pubsub:", "class PubsubV2:")})
_named("guarded-by-rot-field", {"_private/gcs.py": _GUARDED_GCS.replace(
    "            self._named = {}\n", "").replace(
    "self._named[name] = aid", "pass")})
_named("guarded-by-rot-plain-lock", {"_private/gcs.py": _GUARDED_GCS.replace(
    'self._lock = lockdep.lock("gcs.pubsub")',
    "self._lock = __import__('threading').Lock()")})
_named("guarded-by-rot-lock-class", {"_private/gcs.py": _GUARDED_GCS.replace(
    '"gcs.pubsub"', '"gcs.pubsub_v2"')})


def test_guarded_by_registry_rot_class_field_lock(tmp_path):
    """Registry rot, all three axes: a registered class gone; a
    registered field never accessed; a guard lock that is not a
    lockdep-named primitive; a lock whose lockdep class diverged."""
    for sub, name, key in (
            ("c", "guarded-by-rot-class", "stale-guarded-class:Pubsub"),
            ("f", "guarded-by-rot-field",
             "stale-guarded-field:ActorDirectory._named"),
            ("p", "guarded-by-rot-plain-lock",
             "unnamed-guard-lock:Pubsub._lock"),
            ("w", "guarded-by-rot-lock-class",
             "wrong-lock-class:Pubsub._lock")):
        root = _tree(tmp_path / sub, _TREES[name])
        assert key in set(_gcs_keys(root)), name


_named("guarded-by-ratchet", {"_private/gcs.py": _GUARDED_GCS.replace(
    "            self._subs = {}",
    "            self._subs = {}\n            self._stats = {}")})


def test_guarded_by_ratchet_unregistered_init_field(tmp_path):
    """A NEW field assigned in __init__ of a registered class must be
    registered or annotated. Guard locks are exempt."""
    root = _tree(tmp_path, _TREES["guarded-by-ratchet"])
    assert _gcs_keys(root) == ["unregistered-field:Pubsub._stats"]


# A synthetic registry entry for the holds-lock fixture, applied to
# whichever registry module runs it (both, in the parity case).
_HOLDS_LOCK_PATCH = (
    ("GUARDED_FIELDS", ("_private/fake.py", "Box"),
     {"_q": ("_lock", "fake.box")}),
    ("HOLDS_LOCK", ("_private/fake.py", "Box._pop_locked"), {"_lock"}),
)
_named("guarded-by-holds-lock", {"_private/fake.py": """\
    import threading

    from . import lockdep


    class Box:
        def __init__(self):
            self._lock = lockdep.lock("fake.box")
            self._cond = threading.Condition(self._lock)  # lint: guarded-by-ok condition alias over the guard lock, not state
            self._q = []

        def _pop_locked(self):
            return self._q.pop()

        def good_call(self):
            with self._lock:
                return self._pop_locked()

        def cond_guarded(self, item):
            with self._cond:
                self._q.append(item)

        def bad_call(self):
            return self._pop_locked()
"""})


def _patch_registry(monkeypatch, reg, patch):
    for table, key, value in patch:
        monkeypatch.setitem(getattr(reg, table), key, value)


def test_guarded_by_holds_lock_and_condition_alias(tmp_path,
                                                   monkeypatch):
    """(a) a HOLDS_LOCK helper's body needs no `with` (and an unlocked
    CALL of it is itself flagged); (b) a Condition constructed over the
    guard lock aliases it."""
    _patch_registry(monkeypatch, registry, _HOLDS_LOCK_PATCH)
    root = _tree(tmp_path, _TREES["guarded-by-holds-lock"])
    vs = [v for v in _run(root, ["guarded-by"])
          if v.file == "_private/fake.py"]
    assert [(v.scope, v.key) for v in vs] == [
        ("Box.bad_call", "unguarded-locked-call:Box._pop_locked")]


_named("guarded-by-locked-convention", {"_private/gcs.py": _GUARDED_GCS + """\

        def _purge_locked(self):
            return len(self._subs)
    """})


def test_guarded_by_locked_convention_needs_registration(tmp_path):
    """A *_locked-suffixed method on a registered class without a
    HOLDS_LOCK entry is flagged."""
    root = _tree(tmp_path, _TREES["guarded-by-locked-convention"])
    assert "unregistered-locked-helper:Pubsub._purge_locked" in \
        _gcs_keys(root)


def _access_violations(root):
    return sorted((v.scope, v.key) for v in _run(root, ["guarded-by"])
                  if not v.key.startswith(("unregistered-field:",
                                           "stale-annotation:")))


def test_guarded_by_unguarded_field_on_real_tree(tmp_path):
    """Strip the req-lock from Worker.request's bookkeeping in a COPY of
    the port — the pass must flag exactly those field accesses by
    name."""
    dst = _copy_port(tmp_path)
    p = os.path.join(dst, "_private", "worker_proc.py")
    with open(p) as f:
        src = f.read()
    locked = """\
        with self._req_lock:
            self._req_counter += 1
            req_id = self._req_counter
            self._pending[req_id] = fut
"""
    seeded_body = """\
        self._req_counter += 1
        req_id = self._req_counter
        self._pending[req_id] = fut
"""
    assert locked in src, "live request() bookkeeping moved; update test"
    with open(p, "w") as f:
        f.write(src.replace(locked, seeded_body))
    assert [k for _, k in _access_violations(dst)] == [
        "unguarded-read:Worker._req_counter",
        "unguarded-write:Worker._pending",
        "unguarded-write:Worker._req_counter"]
    # The pristine copy carries no access violations at all.
    with open(p, "w") as f:
        f.write(src)
    assert [v for v in _run(dst, ["guarded-by"])
            if not v.key.startswith("unregistered-field:")] == []


# ---------------------------------------------------------------------------
# parse-once cache + per-pass timing
# ---------------------------------------------------------------------------
def test_source_cache_reuses_parsed_trees(tmp_path):
    """Two LintTree walks over an unchanged tree parse each file once
    (keyed by path+mtime+size); an edit invalidates only that entry."""
    root = _tree(tmp_path, _SWALLOW)
    t1 = core.LintTree(root)
    sf_a = t1.get("_private/x.py")
    t2 = core.LintTree(root)
    assert t2.get("_private/x.py") is sf_a  # cache hit: same object
    # Touch the file with different content: fresh parse.
    p = tmp_path / "_private/x.py"
    p.write_text("A = 2\n")
    os.utime(p, (os.path.getmtime(p) + 2, os.path.getmtime(p) + 2))
    t3 = core.LintTree(root)
    assert t3.get("_private/x.py") is not sf_a


def test_cli_json_reports_per_pass_timing(tmp_path, capsys):
    root = _tree(tmp_path, _SWALLOW)
    cli.main(["--root", root, "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    ms = data["per_pass_ms"]
    assert set(ms) == set(cli.PASS_NAMES)
    assert all(isinstance(v, (int, float)) and v >= 0
               for v in ms.values())


# ---------------------------------------------------------------------------
# the port's registry: it resolves, and it holds the GPU-era sites
# ---------------------------------------------------------------------------
# Registry tables keyed by (file, qualname) or (file, Class).
_KEYED_TABLES = ("HOT_LOCKS", "GUARDED_FIELDS", "HOLDS_LOCK",
                 "NON_LOOP_DISPATCHERS", "REF_MUTATION_HELPERS",
                 "REF_PARK_DEFERRED", "RESERVE_DEFERRED",
                 "REF_ELISION_FUNCS", "BARRIER_WRAPPERS",
                 "PROTOCOL_SEND_FUNCS")


def _registry_keys(reg):
    """Every (table, file, qualname) the registry names: the keyed
    tables, and the functions of RECV_LOOPS, REF_PAYLOADS and
    PAYLOAD_CONSUMERS."""
    out = [(t, f, q) for t in _KEYED_TABLES for f, q in getattr(reg, t)]
    for loop in reg.RECV_LOOPS.values():
        out += [("RECV_LOOPS", loop["file"], q) for q in loop["functions"]]
    for pay in reg.REF_PAYLOADS.values():
        out += [("REF_PAYLOADS", pay["producer_file"], q)
                for q in pay["producers"]]
        out += [("REF_PAYLOADS", pay["consumer_file"], q)
                for q in pay["consumers"]]
    for entries in reg.PAYLOAD_CONSUMERS.values():
        for ent in entries:
            out += [("PAYLOAD_CONSUMERS", ent["file"], q)
                    for q in ent["functions"]]
    return out


def _unresolved(reg, tree):
    """The registry keys that name no def or class of `tree`."""
    defs = {}
    for rel, sf in tree.files.items():
        defs[rel] = {sf.scope_of(n) for n in sf.nodes
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef,
                                       ast.ClassDef))}
    return sorted({k for k in _registry_keys(reg)
                   if k[2] not in defs.get(k[1], ())})


def test_registry_keys_resolve_in_the_port():
    tree = core.LintTree(PORT)
    keys = _registry_keys(registry)
    assert len({(f, q) for _, f, q in keys}) > 140
    assert _unresolved(registry, tree) == []


def test_reference_registry_goes_stale_in_the_port():
    """The JAX package's registry names two functions the port renamed:
    the resolution check above is what catches such a key, since no
    pass reports a PROTOCOL_SEND_FUNCS key whose function is gone."""
    from ray_tpu.devtools.lint import registry as ref_registry
    assert _unresolved(ref_registry, core.LintTree(PORT)) == [
        ("PROTOCOL_SEND_FUNCS", "_private/daemon.py",
         "NodeDaemon._reclaim_idle_tpu_workers"),
        ("PROTOCOL_SEND_FUNCS", "_private/scheduler.py",
         "Scheduler._reclaim_idle_tpu_workers")]


# The registry renames from the JAX package's to the port's.
_RENAMES = (("_free_chips", "_free_gpus"),
            ("_reclaim_idle_tpu_workers", "_reclaim_idle_gpu_workers"),
            ("chip_ids", "gpu_ids"))


def _renamed(obj):
    """`obj` with every string in it renamed to the port's names."""
    if isinstance(obj, str):
        for old, new in _RENAMES:
            obj = obj.replace(old, new)
        return obj
    if isinstance(obj, dict):
        return {_renamed(k): _renamed(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list, set, frozenset)):
        return type(obj)(_renamed(x) for x in obj)
    return obj


def test_registry_is_the_references_modulo_renames():
    """The port's registry is the JAX package's with the GPU renames,
    and one send site moved: the port's Cluster.remove_node stops a
    daemon through stop_daemon, which sends SHUTDOWN_NODE itself."""
    from ray_tpu.devtools.lint import registry as ref_registry
    names = [n for n in dir(ref_registry) if n.isupper()]
    assert names == [n for n in dir(registry) if n.isupper()]
    for name in names:
        want = _renamed(getattr(ref_registry, name))
        if name == "PROTOCOL_SEND_FUNCS":
            entry = want.pop(("cluster_utils.py", "Cluster.remove_node"))
            want[("cluster_utils.py", "stop_daemon")] = entry
        assert getattr(registry, name) == want, name


_SCHED_LOCKED = """\
                with self._lock:
                    if len(self._free_gpus) < ngpus:
                        reclaim = True
"""
_SCHED_SEEDED = """\
                short = len(self._free_gpus) < ngpus
                with self._lock:
                    if short:
                        reclaim = True
"""
_DAEMON_LOCKED = """\
                with self._lock:
                    if len(self._free_gpus) >= ngpus:
"""
_DAEMON_SEEDED = """\
                enough = len(self._free_gpus) >= ngpus
                with self._lock:
                    if enough:
"""


@pytest.mark.parametrize("rel, locked, seeded, scope, key", [
    ("scheduler.py", _SCHED_LOCKED, _SCHED_SEEDED,
     "Scheduler._maybe_start_worker", "unguarded-read:Scheduler._free_gpus"),
    ("daemon.py", _DAEMON_LOCKED, _DAEMON_SEEDED,
     "NodeDaemon._start_worker", "unguarded-read:NodeDaemon._free_gpus"),
], ids=["scheduler", "daemon"])
def test_guarded_by_free_gpus_out_of_lock_on_real_tree(
        tmp_path, rel, locked, seeded, scope, key):
    """Move the free-GPU check that decides whether to reclaim idle GPU
    workers (`_reclaim_idle_gpu_workers`) out of its lock in a COPY of
    the port: guarded-by must flag exactly that access by name, which
    it can only do because the registry guards `_free_gpus`."""
    dst = _copy_port(tmp_path)
    p = os.path.join(dst, "_private", rel)
    with open(p) as f:
        src = f.read()
    assert src.count(locked) == 1, "live free-GPU check moved; update test"
    assert "self._reclaim_idle_gpu_workers()" in \
        src[src.index(locked):src.index(locked) + 800]
    with open(p, "w") as f:
        f.write(src.replace(locked, seeded))
    assert _access_violations(dst) == [(scope, key)]


def test_protocol_order_flags_stop_daemon_without_its_entry(monkeypatch):
    """Without its PROTOCOL_SEND_FUNCS entry, stop_daemon's SHUTDOWN_NODE
    send is an unregistered send at its line of cluster_utils.py."""
    with open(os.path.join(PORT, "cluster_utils.py")) as f:
        lines = f.read().splitlines()
    (line,) = [i for i, ln in enumerate(lines, start=1)
               if "head_handle.send(P.SHUTDOWN_NODE" in ln]
    tree = core.LintTree(PORT)
    assert _run(PORT, ["protocol-order"]) == []
    monkeypatch.delitem(registry.PROTOCOL_SEND_FUNCS,
                        ("cluster_utils.py", "stop_daemon"))
    vs = core.run_passes(tree, ["protocol-order"])
    assert [(v.file, v.line, v.key, v.scope) for v in vs] == [
        ("cluster_utils.py", line, "unregistered-send:SHUTDOWN_NODE",
         "stop_daemon")]


# ---------------------------------------------------------------------------
# parity with the JAX package's lint
# ---------------------------------------------------------------------------
_PATCHES = {"guarded-by-holds-lock": _HOLDS_LOCK_PATCH}


def _signature(violations):
    return {(v.pass_name, v.file, v.line, _renamed(v.key))
            for v in violations}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_parity_with_the_jax_package_lint(name, tmp_path, monkeypatch):
    """Each fixture tree through both lints, all ten passes: the same
    (pass, file, line, key) set, modulo the registry renames."""
    from ray_tpu.devtools.lint import core as ref_core
    from ray_tpu.devtools.lint import registry as ref_registry
    for reg in (registry, ref_registry):
        _patch_registry(monkeypatch, reg, _PATCHES.get(name, ()))
    root = _tree(tmp_path, _TREES[name])
    ours = core.run_passes(core.LintTree(root))
    ref = ref_core.run_passes(ref_core.LintTree(root))
    assert _signature(ours) == _signature(ref)
