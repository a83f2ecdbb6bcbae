"""Client side of the remote driver (reference: util/client/worker.py —
the Worker that proxies API calls over the channel).

Every message goes through the port's serializer (``_private/
serialization.py``), whose pickler brings each torch.Tensor it meets to
host (``_to_host``), nested ones too: a CUDA tensor passed as an argument
or put reaches the head as a CPU tensor, so the head never touches a
card for a client."""
import threading
import uuid
from multiprocessing.connection import Client as _MpClient
from typing import Any, List, Optional, Union

from ..._private.serialization import dumps, loads
from .common import (ClientActorClass, ClientActorHandle, ClientObjectRef,
                     ClientRemoteFunction)


def _resolve_token(token) -> bytes:
    if token is not None:
        return bytes.fromhex(token) if isinstance(token, str) else token
    import os
    env = os.environ.get("RTT_CLUSTER_TOKEN_HEX")
    if env:
        return bytes.fromhex(env)
    # Same-process fallback: a driver that also hosts the cluster.
    from ..._private import state
    rt = state.get_node()
    t = getattr(rt, "cluster_token", None)
    if t is not None:
        return t
    raise RuntimeError(
        "connecting to a ray_tpu_torch cluster requires its token: pass "
        "token=..., or set RTT_CLUSTER_TOKEN_HEX (printed by "
        "`python -m ray_tpu_torch start`)")


class ClientConnection:
    def __init__(self, address: str, token=None,
                 reconnect_attempts: int = 20,
                 reconnect_backoff_s: float = 0.25):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._authkey = _resolve_token(token)
        self._reconnect_attempts = int(reconnect_attempts)
        self._reconnect_backoff_s = float(reconnect_backoff_s)
        self._conn = _MpClient(self._addr, family="AF_INET",
                               authkey=self._authkey)
        self._lock = threading.Lock()
        # Refs released by ClientObjectRef.__del__ queue here and piggyback
        # on the next request: __del__ can fire from cyclic GC *inside*
        # _request (during cloudpickle) on the same thread, where a
        # synchronous release would deadlock on the non-reentrant _lock
        # (the reference routes releases through a background datapath for
        # the same reason, util/client/dataclient.py).
        self._pending_releases: list = []
        # fn/class registrations, replayed onto a restarted head so the
        # SAME driver session keeps working after a head crash
        # (reference: gcs_client_reconnection_test.cc — clients
        # re-establish and continue).
        self._registrations: list = []  # (op, id_kw, id_val, blob)
        self._closed = False
        assert self._request("ping")["ok"]

    # -- plumbing ----------------------------------------------------------
    def _reconnect_locked(self):
        """Re-dial the head with exponential backoff (caller holds
        _lock). Raises HeadConnectionError when attempts run out."""
        import time as _time

        from ...exceptions import HeadConnectionError
        try:
            self._conn.close()
        except Exception:
            pass
        delay = self._reconnect_backoff_s
        for _ in range(self._reconnect_attempts):
            _time.sleep(min(delay, 5.0))
            delay *= 2
            try:
                conn = _MpClient(self._addr, family="AF_INET",
                                 authkey=self._authkey)
                # Replay session state the restarted head lost.
                for op, id_kw, id_val, blob in self._registrations:
                    conn.send_bytes(dumps(
                        {"op": op, id_kw: id_val, "blob": blob}))
                    loads(conn.recv_bytes())
                self._conn = conn
                return
            except Exception:
                continue
        raise HeadConnectionError(
            f"head at {self._addr[0]}:{self._addr[1]} unreachable after "
            f"{self._reconnect_attempts} reconnect attempts")

    def _request(self, op: str, **payload) -> dict:
        from ...exceptions import HeadConnectionError
        payload["op"] = op
        drained: list = []
        if self._pending_releases:
            drained, self._pending_releases = self._pending_releases, []
            payload["__releases__"] = drained
        with self._lock:
            try:
                self._conn.send_bytes(dumps(payload))
                result = loads(self._conn.recv_bytes())
            except (EOFError, OSError) as e:
                if drained:
                    # The piggybacked releases died with the request; on
                    # a transient drop the head is still holding those
                    # objects — re-queue them for the next call.
                    self._pending_releases = drained + \
                        self._pending_releases
                if self._closed or self._reconnect_attempts <= 0:
                    raise
                # The head died mid-call. Reconnect for FUTURE calls,
                # but fail THIS one with a typed error: whether the op
                # applied is unknowable, so a silent replay could
                # double-execute it.
                self._reconnect_locked()
                raise HeadConnectionError(
                    f"head connection lost during {op!r}; reconnected — "
                    f"in-flight results were lost, retry the call"
                ) from e
        if not result.pop("__ok__", False):
            raise RuntimeError(
                f"client call failed: {result.get('error')}\n"
                f"{result.get('traceback', '')}")
        return result

    @staticmethod
    def _strip(args, kwargs):
        def conv(a):
            if isinstance(a, ClientObjectRef):
                return {"__client_ref__": True, "ref_id": a.ref_id}
            return a
        return (tuple(conv(a) for a in args),
                {k: conv(v) for k, v in kwargs.items()})

    def _call(self, op: str, *, args=(), kwargs=None, **extra
              ) -> ClientObjectRef:
        args, kwargs = self._strip(args, kwargs or {})
        out = self._request(op, args=args, kwargs=kwargs, **extra)
        return ClientObjectRef(self, out["ref_id"])

    def _create_actor(self, cls_id: str, args, kwargs) -> ClientActorHandle:
        args, kwargs = self._strip(args, kwargs or {})
        out = self._request("create_actor", cls_id=cls_id, args=args,
                            kwargs=kwargs)
        return ClientActorHandle(self, out["actor_id"])

    # -- API (mirrors ray_tpu_torch.*) ------------------------------------------
    def remote(self, target) -> Union[ClientRemoteFunction,
                                      ClientActorClass]:
        blob = dumps(target)
        if isinstance(target, type):
            cls_id = f"c_{uuid.uuid4().hex}"
            self._request("register_class", cls_id=cls_id, blob=blob)
            self._registrations.append(
                ("register_class", "cls_id", cls_id, blob))
            return ClientActorClass(self, cls_id, target.__name__)
        fn_id = f"f_{uuid.uuid4().hex}"
        self._request("register_fn", fn_id=fn_id, blob=blob)
        self._registrations.append(("register_fn", "fn_id", fn_id, blob))
        return ClientRemoteFunction(self, fn_id, target.__name__)

    def get(self, refs: Union[ClientObjectRef, List[ClientObjectRef]],
            *, timeout: Optional[float] = None) -> Any:
        single = isinstance(refs, ClientObjectRef)
        ref_list = [refs] if single else list(refs)
        out = self._request("get", ref_ids=[r.ref_id for r in ref_list],
                            timeout=timeout)
        values = loads(out["values"])
        return values[0] if single else values

    def put(self, value: Any) -> ClientObjectRef:
        out = self._request("put", blob=dumps(value))
        return ClientObjectRef(self, out["ref_id"])

    def api_call(self, name: str, *args, **kwargs) -> Any:
        """Run a whitelisted API op (api_ops.registry) on the head."""
        out = self._request("api_call", name=name, args=args,
                            kwargs=kwargs)
        return loads(out["value"])

    def _release(self, ref_id: str):
        try:
            self._pending_releases.append(ref_id)
        except Exception:
            pass  # interpreter teardown

    def close(self):
        self._closed = True
        try:
            self._conn.close()
        except Exception:
            pass


def connect(address: str, token=None) -> ClientConnection:
    """Reference: ray.init("ray://host:port") client-mode entry.
    `token`: the cluster token hex (or bytes) printed by `python -m
    ray_tpu_torch start`; defaults to RTT_CLUSTER_TOKEN_HEX or the
    in-process cluster's token."""
    return ClientConnection(address, token=token)
