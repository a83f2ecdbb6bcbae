"""CLI (reference: python/ray/scripts/ — `ray start/status/list/timeline/
job submit`; SURVEY.md §2.2 process bootstrap row).

The runtime is driver-embedded (head processes collapse into the driver,
SURVEY.md §3.1 translation), so `start` boots a head that serves remote
drivers via the client server plus the dashboard. Inspection/job
commands act on a cluster addressed by `--address host:port` (or
$RTT_ADDRESS) through the client server — matching `ray status
--address`; without an address they act on a fresh local runtime.

GPUs are detected, never given on the command line: a head or a node
counts the cards it sees (``RTT_NUM_GPUS``, then
``CUDA_VISIBLE_DEVICES``, then the NVIDIA driver's list), so a head on a
host whose cards belong to its nodes starts with ``RTT_NUM_GPUS=0``.
A node's ``--resources`` may name ``"GPU"``, which reserves cards as a
GPU count, never as a custom resource; ``"TPU"`` raises.

Usage: python -m ray_tpu_torch <command> [args]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _backend(args):
    """Callable (name, *args, **kwargs) -> value, local or remote
    (ray_tpu_torch.util.client.api_ops.registry names)."""
    addr = getattr(args, "address", None) or \
        os.environ.get("RTT_ADDRESS")
    if addr:
        from ray_tpu_torch.util.client import connect

        conn = connect(addr)
        return conn.api_call
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=getattr(args, "num_cpus", None),
                 ignore_reinit_error=True)
    from ray_tpu_torch.util.client.api_ops import registry

    reg = registry()
    return lambda name, *a, **kw: reg[name](*a, **kw)


def node_resources(text):
    """A node's ``--resources`` JSON as ``(num_gpus, resources)``:
    ``"GPU"`` is the node's card count (None, the default, detects it),
    never a custom resource, which the scheduler would count against a
    card it does not pin. No node of the port declares a TPU, so
    ``"TPU"`` raises."""
    resources = dict(json.loads(text)) if text else {}
    if resources.get("TPU"):
        raise ValueError(
            f"--resources {text}: ray_tpu_torch schedules GPUs, and no node "
            f"declares a TPU; give {{\"GPU\": n}} instead")
    resources.pop("TPU", None)
    num_gpus = resources.pop("GPU", None)
    return num_gpus, resources or None


def cmd_start(args):
    import ray_tpu_torch

    if getattr(args, "address", None):
        # Worker-node mode (reference: `ray start --address=head:port`
        # launching a raylet that joins the cluster): run a node daemon
        # in the foreground until the head goes away.
        import os

        from ray_tpu_torch._private.daemon import NodeDaemon

        token_hex = (args.token_hex
                     or os.environ.get("RTT_CLUSTER_TOKEN_HEX"))
        if not token_hex:
            print("error: joining a cluster requires --token-hex or "
                  "RTT_CLUSTER_TOKEN_HEX (printed by the head)")
            return 1
        host, _, port = args.address.rpartition(":")
        from ray_tpu_torch._private.config import ray_config
        if (host not in ("127.0.0.1", "localhost")
                and "RTT_NODE_HOST" not in os.environ):
            # Joining a remote head: this node's transfer server must be
            # reachable from the other hosts, not loopback-only.
            ray_config.set("node_host", "0.0.0.0")
        if "RTT_HEAD_RECONNECT_ATTEMPTS" not in os.environ:
            # Production join mode: nodes survive a head restart by
            # rejoining with backoff (reference: raylets reconnect to a
            # restarted GCS, gcs_client_reconnection_test.cc).
            ray_config.set("head_reconnect_attempts", 120)
        num_gpus, resources = node_resources(args.resources)
        daemon = NodeDaemon(
            (host, int(port)), bytes.fromhex(token_hex),
            num_cpus=args.num_cpus, num_gpus=num_gpus, resources=resources,
            labels=json.loads(args.labels) if getattr(args, "labels",
                                                      None) else None)
        print(f"ray_tpu_torch node daemon joined head at {args.address} "
              f"(node {daemon.node_hex[:12]}, resources "
              f"{json.dumps(daemon.totals)})", flush=True)
        # SIGTERM (an operator's stop) runs the daemon's shutdown, as the
        # daemon's own entry point does, so its workers, session and
        # store directories go with it; a shutdown in progress is not
        # interrupted.
        import signal

        def _on_term(*_):
            if not daemon._stopped.is_set():
                sys.exit(0)

        signal.signal(signal.SIGTERM, _on_term)
        daemon.run()
        return 0

    if args.host not in ("127.0.0.1", "localhost"):
        # The daemon listener + transfer server must be reachable from
        # worker hosts (ray_config was already constructed at import, so
        # set programmatically rather than via env).
        from ray_tpu_torch._private.config import ray_config
        ray_config.set("node_host", args.host)
    ray_tpu_torch.init(num_cpus=args.num_cpus, ignore_reinit_error=True)
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util.client import server as client_server

    host, port = client_server.serve(host=args.host, port=args.port)
    dash_port = start_dashboard(host=args.host,
                                port=args.dashboard_port)
    from ray_tpu_torch._private import state as _state
    rt = _state.current()
    print("ray_tpu_torch head started.")
    print(f"  client address:  {host}:{port}  "
          f"(--address for other commands)")
    print(f"  cluster address: {rt.cluster_address}  "
          f"(python -m ray_tpu_torch start --address ... on worker hosts)")
    print(f"  cluster token:   {rt.cluster_token.hex()}  "
          f"(--token-hex on worker hosts)")
    print(f"  dashboard:       http://{args.host}:{dash_port}")
    print(f"  resources:       "
          f"{json.dumps(ray_tpu_torch.cluster_resources())}", flush=True)
    # The head lives in this process (client server + dashboard are
    # daemon threads), so returning would tear it down — block until
    # interrupted unless the caller embeds start programmatically.
    if not args.no_block:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return 0


def cmd_status(args):
    call = _backend(args)
    total = call("cluster_resources")
    avail = call("available_resources")
    print("======== Cluster status ========")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0.0):g}/{total[k]:g} available")
    alive = [n for n in call("list_nodes") if n.get("alive", True)]
    print(f"  nodes: {len(alive)}")
    return 0


def cmd_list(args):
    call = _backend(args)
    name = {
        "tasks": "list_tasks", "actors": "list_actors",
        "nodes": "list_nodes", "objects": "list_objects",
        "workers": "list_workers",
        "placement-groups": "list_placement_groups",
    }[args.what]
    print(json.dumps(call(name, limit=args.limit), indent=2,
                     default=str))
    return 0


def cmd_drain(args):
    """Gracefully drain a node (docs/DRAIN.md): stop new placement, let
    running work finish/migrate without charging retry budgets, re-home
    sole object copies, pull serve replicas out of routing — then print
    the final drain status. `--status` only inspects."""
    call = _backend(args)
    if args.status:
        st = call("drain_status", node_id=args.node_id or None)
        print(json.dumps(st, indent=2, default=str))
        return 0
    if not args.node_id:
        print("error: drain requires a node id (or --status)",
              file=sys.stderr)
        return 2
    st = call("drain_node", node_id=args.node_id,
              deadline_s=args.deadline, wait=not args.no_wait)
    print(json.dumps(st, indent=2, default=str))
    return 0 if st.get("state") in ("DRAINING", "DRAINED") else 1


def cmd_summary(args):
    call = _backend(args)
    print(json.dumps({
        "tasks": call("summarize_tasks"),
        "actors": call("summarize_actors"),
        "objects": call("summarize_objects"),
    }, indent=2, default=str))
    return 0


def cmd_metrics(args):
    """Print the cluster's federated Prometheus exposition: the head's
    metrics plus every node's and worker's latest snapshot, tagged with
    node_id/worker_id (reference: the dashboard /metrics endpoint the
    MetricsAgent fleet feeds)."""
    call = _backend(args)
    sys.stdout.write(call("cluster_metrics"))
    return 0


def cmd_timeline(args):
    call = _backend(args)
    events = call("timeline")
    out = args.output or f"timeline_{int(time.time())}.json"
    with open(out, "w") as f:
        json.dump(events, f)
    print(f"wrote Chrome-trace timeline to {out} "
          f"(open in ui.perfetto.dev)")
    return 0


def cmd_trace(args):
    """Print one trace's cross-node span tree + critical path, or
    export the span-merged chrome trace with --chrome (pid=node,
    tid=worker — the `ray_tpu_torch timeline` layout plus spans)."""
    call = _backend(args)
    if args.chrome:
        events = call("export_chrome_trace",
                      trace_id=args.trace_id or None)
        out = args.output or f"trace_{int(time.time())}.json"
        with open(out, "w") as f:
            json.dump(events, f)
        print(f"wrote span-merged Chrome trace to {out} "
              f"(open in ui.perfetto.dev)")
        return 0
    if not args.trace_id:
        print("error: trace <trace_id> (32-hex, from a span / the "
              "serve traceparent response header), or --chrome for "
              "the merged timeline export")
        return 1
    trace = call("get_trace", args.trace_id)
    if not trace.get("span_count"):
        print(f"no spans recorded for trace {args.trace_id}")
        return 1
    if args.json:
        print(json.dumps(trace, indent=2, default=str))
        return 0
    from ray_tpu_torch.util.tracing import format_trace
    print(format_trace(trace))
    return 0


def cmd_job(args):
    call = _backend(args)
    if args.job_cmd == "submit":
        import shlex
        entry = args.entrypoint
        if entry and entry[0] == "--":
            entry = entry[1:]
        job_id = call(
            "job_submit", entrypoint=shlex.join(entry),
            runtime_env=json.loads(args.runtime_env)
            if args.runtime_env else None)
        print(f"submitted: {job_id}")
        if not args.no_wait:
            while call("job_status", job_id) in ("PENDING", "RUNNING"):
                time.sleep(0.5)
            status = call("job_status", job_id)
            print(call("job_logs", job_id), end="")
            print(f"status: {status}")
            return 0 if status == "SUCCEEDED" else 1
    elif args.job_cmd == "status":
        print(call("job_status", args.job_id))
    elif args.job_cmd == "logs":
        print(call("job_logs", args.job_id), end="")
    elif args.job_cmd == "list":
        print(json.dumps(call("job_list"), indent=2, default=str))
    elif args.job_cmd == "stop":
        print("stopped" if call("job_stop", args.job_id)
              else "not running")
    return 0


def cmd_serve(args):
    """`serve deploy/run/build/status/shutdown` (reference:
    serve/scripts.py CLI over schema.py configs). deploy/status/shutdown
    target a RUNNING head via --address / $RTT_ADDRESS (the app must
    outlive this process); `serve run` hosts the app in-process and
    blocks."""
    from ray_tpu_torch.serve import schema as serve_schema

    def _load_config(target):
        if target.endswith((".yaml", ".yml")):
            return serve_schema.ServeDeploySchema.from_yaml(target)
        return serve_schema.ServeDeploySchema.from_dict(
            {"applications": [{"import_path": target}]})

    if args.serve_cmd == "deploy":
        addr = getattr(args, "address", None) or \
            os.environ.get("RTT_ADDRESS")
        if not addr:
            print("serve deploy needs a running head (--address or "
                  "$RTT_ADDRESS); to host the app from this "
                  "process, use `serve run`.", file=sys.stderr)
            return 1
        call = _backend(args)
        names = call("serve_deploy", _load_config(args.target).to_dict())
        print(f"deployed on {addr}: {', '.join(names)}")
    elif args.serve_cmd == "run":
        if getattr(args, "address", None) or \
                os.environ.get("RTT_ADDRESS"):
            # Remote target: the head hosts the app (no need to block);
            # identical to `serve deploy`.
            call = _backend(args)
            names = call("serve_deploy",
                         _load_config(args.target).to_dict())
            print(f"deployed remotely: {', '.join(names)} (app lives on "
                  f"the head; `serve shutdown --address ...` tears it "
                  f"down)")
            return 0
        import ray_tpu_torch
        from ray_tpu_torch import serve
        ray_tpu_torch.init(ignore_reinit_error=True)
        names = serve_schema.deploy_config(_load_config(args.target))
        print(f"deployed: {', '.join(names)}  ({serve.proxy_address()})")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            serve.shutdown()
    elif args.serve_cmd == "build":
        import yaml
        app = serve_schema.import_attr(args.target)
        cfg = serve_schema.build_config(
            app, import_path=args.target,
            route_prefix=getattr(args, "route_prefix", "/"))
        out = yaml.safe_dump(cfg, sort_keys=False)
        if args.output:
            with open(args.output, "w") as f:
                f.write(out)
            print(f"wrote {args.output}")
        else:
            print(out)
    elif args.serve_cmd == "status":
        print(json.dumps(_backend(args)("serve_status"), indent=2,
                         default=str))
    elif args.serve_cmd == "shutdown":
        _backend(args)("serve_shutdown")
        print("serve shut down")
    return 0


def cmd_dashboard(args):
    import ray_tpu_torch

    ray_tpu_torch.init(ignore_reinit_error=True)
    from ray_tpu_torch.dashboard import start_dashboard

    port = start_dashboard(host=args.host, port=args.dashboard_port)
    print(f"dashboard: http://{args.host}:{port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_address(sp):
        sp.add_argument("--address", default=None,
                        help="client-server address of a running head "
                        "(host:port); default $RTT_ADDRESS or a "
                        "local runtime")

    sp = sub.add_parser("start", help="start a head (client server + "
                        "dashboard) for remote drivers, or join a "
                        "cluster as a node daemon with --address")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=10001)
    sp.add_argument("--dashboard-port", type=int, default=8265)
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument("--address", default=None,
                    help="head cluster address (host:port) to join as a "
                    "worker node; the GPUs on this host are detected "
                    "(RTT_NUM_GPUS, then CUDA_VISIBLE_DEVICES, then the "
                    "driver)")
    sp.add_argument("--token-hex", default=None,
                    help="cluster token printed by the head")
    sp.add_argument("--resources", default=None,
                    help="JSON dict of custom resources for this node; "
                    "\"GPU\" sets its card count, \"TPU\" raises")
    sp.add_argument("--labels", default=None,
                    help="JSON dict of node labels for "
                    "NodeLabelSchedulingStrategy (reference: "
                    "`ray start --labels`)")
    sp.add_argument("--no-block", action="store_true",
                    help="return instead of serving (embedding only; "
                    "the head dies with this process)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("status", help="cluster resource status")
    add_address(sp)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("what", choices=["tasks", "actors", "nodes",
                                     "objects", "workers",
                                     "placement-groups"])
    sp.add_argument("--limit", type=int, default=100)
    add_address(sp)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="task/actor/object summaries")
    add_address(sp)
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("drain", help="gracefully drain a node "
                        "(zero-loss scale-down; see docs/DRAIN.md)")
    sp.add_argument("node_id", nargs="?", default=None,
                    help="hex node id (see `ray_tpu_torch list nodes`)")
    sp.add_argument("--deadline", type=float, default=None,
                    help="seconds before falling back to hard removal "
                    "(default: drain_deadline_s)")
    sp.add_argument("--no-wait", action="store_true",
                    help="start the drain and return immediately")
    sp.add_argument("--status", action="store_true",
                    help="print drain status instead of draining")
    add_address(sp)
    sp.set_defaults(fn=cmd_drain)

    sp = sub.add_parser("metrics", help="federated cluster metrics "
                        "(Prometheus text, node_id/worker_id tagged)")
    add_address(sp)
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("timeline", help="export Chrome-trace timeline")
    sp.add_argument("-o", "--output", default=None)
    add_address(sp)
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("trace", help="print one trace's cross-node "
                        "span tree (+ critical path), or --chrome for "
                        "the span-merged timeline export")
    sp.add_argument("trace_id", nargs="?", default=None)
    sp.add_argument("--json", action="store_true",
                    help="raw JSON instead of the tree rendering")
    sp.add_argument("--chrome", action="store_true",
                    help="write the span-merged Chrome trace JSON")
    sp.add_argument("-o", "--output", default=None)
    add_address(sp)
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("job", help="job submission")
    add_address(sp)
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--runtime-env", default=None,
                   help="JSON runtime env")
    j.add_argument("--no-wait", action="store_true")
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("job_id")
    jsub.add_parser("list")
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser("dashboard", help="serve the dashboard")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--dashboard-port", type=int, default=8265)
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser("serve", help="deploy/inspect Serve applications")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    for name, hlp in (("deploy",
                       "deploy a YAML config/import_path on a running "
                       "head (--address)"),
                      ("run", "deploy in-process and block "
                              "(ctrl-c tears down)")):
        s = ssub.add_parser(name, help=hlp)
        s.add_argument("target",
                       help="config.yaml or module.path:app import path")
        add_address(s)
    s = ssub.add_parser("build",
                        help="emit a YAML config for a bound app")
    s.add_argument("target", help="module.path:app import path")
    s.add_argument("-o", "--output", default=None)
    s.add_argument("--route-prefix", default="/")
    for name in ("status", "shutdown"):
        s = ssub.add_parser(name)
        add_address(s)
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
