"""raylint: project-invariant static analysis for the ray_tpu_torch runtime.

The runtime is a heavily threaded multi-process system — per-connection
writer threads, serial routing executors, four recv loops dispatching
~30 protocol message types, and ~40 locks across ``_private/``. The bug
classes that slip through review there are exactly the ones a machine
can catch (a recv loop silently dropping an unknown frame, a blocking
send under a hot lock, a typo'd fault site or config key), so — in the
spirit of the Linux kernel's lockdep and clang-tidy's project checks,
adapted to what pure-Python AST walking can see — this package enforces
them mechanically. The dynamic half lives in
``ray_tpu_torch/_private/lockdep.py``.

Passes (see docs/STATIC_ANALYSIS.md for the full catalog):

    protocol-coverage   every protocol.py message constant is dispatched
                        by each recv loop serving its plane, and every
                        dispatch fallthrough logs unknown types
    lock-discipline     no blocking call lexically under a designated
                        hot-path lock
    gate-discipline     fault sites come from the fault.SITES registry;
                        telemetry instrumentation sits behind the
                        falsy-flag gate; metric names are globally unique
    broad-except        no silent ``except Exception: pass`` in _private/
    config-keys         every ray_config key read has a declared default
    ref-discipline      refcount-mutation helpers are registered, parked
                        accounting is lexically paired with a drain
                        barrier, flush elisions consult escape-marked
                        state, and residual-transfer payload fields are
                        conserved producer -> consumer
    barrier-coverage    every head-bound send chokepoint flushes the
                        accounting barrier first or carries a reasoned
                        exemption
    protocol-order      every send site's constant is a legal transition
                        of its registered session DFA, every request has
                        a verified response path, and no send follows
                        its connection's teardown
                        (_private/protocol_model.py)
    payload-schema      send-site payload shapes match the per-constant
                        schema (orphan keys, phantom consumer reads,
                        compact-tuple arity drift, dead model keys)
    guarded-by          every read/write of a field registered in
                        registry.GUARDED_FIELDS happens under its owning
                        lockdep lock (lexical `with`, HOLDS_LOCK helper,
                        or reasoned annotation), with registry-rot
                        detection and a coverage ratchet on new
                        __init__ fields of guarded classes; dynamic
                        half: _private/racedebug.py (Eraser locksets)

The protocol model has a dynamic half too: ``_private/wiretap.py``
replays live frame sequences through the same session DFAs when
RTT_WIRETAP=1 (see docs/STATIC_ANALYSIS.md#the-protocol-model).

Pre-existing violations are ratcheted in ``baseline.json``: the suite is
green on day one, any NEW violation fails tier-1
(tests/test_torch_lint.py), and the baseline only burns down. Escape
hatches are per-line comments (``# lint: <rule>-ok <reason>``); see
core.SUPPRESS_RE.

Run it:

    python -m ray_tpu_torch.devtools.lint                 # check vs baseline
    python -m ray_tpu_torch.devtools.lint --no-baseline   # full report
    python -m ray_tpu_torch.devtools.lint --update-baseline

This package is pure stdlib and never imports the runtime it analyzes:
its one import from the port is the pure-data protocol model
(``_private/protocol_model.py``, shared with the wiretap).
"""

from .core import LintTree, Violation, load_baseline, run_passes  # noqa: F401

PASS_NAMES = (
    "protocol-coverage",
    "lock-discipline",
    "gate-discipline",
    "broad-except",
    "config-keys",
    "ref-discipline",
    "barrier-coverage",
    "protocol-order",
    "payload-schema",
    "guarded-by",
)
