"""Client-side proxy objects (reference: util/client/common.py —
ClientObjectRef, ClientActorHandle, ClientRemoteFunc)."""
from typing import Any, Optional


class ClientObjectRef:
    def __init__(self, conn, ref_id: str):
        self._conn = conn
        self.ref_id = ref_id

    def __repr__(self):
        return f"ClientObjectRef({self.ref_id[:16]})"

    def __del__(self):
        # Unpin the server-side ref so long-lived sessions don't
        # accumulate every result object (server 'release' op).
        conn = getattr(self, "_conn", None)
        if conn is not None:
            conn._release(self.ref_id)


class ClientRemoteFunction:
    def __init__(self, conn, fn_id: str, name: str, opts=None):
        self._conn = conn
        self._fn_id = fn_id
        self._opts = opts or {}
        self.__name__ = name

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        return self._conn._call("task", fn_id=self._fn_id,
                                args=args, kwargs=kwargs,
                                opts=self._opts)

    def options(self, **opts) -> "ClientRemoteFunction":
        return ClientRemoteFunction(self._conn, self._fn_id,
                                    self.__name__, opts)


class _ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        return self._handle._conn._call(
            "actor_method", actor_id=self._handle.actor_id,
            method=self._name, args=args, kwargs=kwargs)


class ClientActorHandle:
    def __init__(self, conn, actor_id: str):
        self._conn = conn
        self.actor_id = actor_id

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClientActorMethod(self, name)


class ClientActorClass:
    def __init__(self, conn, cls_id: str, name: str):
        self._conn = conn
        self._cls_id = cls_id
        self.__name__ = name

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        return self._conn._create_actor(self._cls_id, args, kwargs)
