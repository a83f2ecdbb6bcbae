"""Remote-driver client (Ray Client equivalent).

Reference parity: python/ray/util/client/ (+ARCHITECTURE.md) — a thin
driver on a laptop proxies `ray.*` calls over the wire to a server
inside the cluster (util/client/server/server.py RayletServicer,
protobuf/ray_client.proto). Here: a multiprocessing.connection listener
in the cluster process; the client ships functions/classes pickled by
the port's serializer and holds ClientObjectRef/ClientActorHandle ids.
Device data never crosses this link — only host args/results (the
reference has the same property: the client is control-plane): the
serializer brings every torch.Tensor it meets to host, nested ones too,
so a CUDA tensor a client passes or puts reaches the head, and the task
that reads it, as a CPU tensor.

Auth: the channel is pickle-based, so connections authenticate with the
per-cluster random token (printed by `python -m ray_tpu_torch start`, or
`state.current().cluster_token.hex()` in the head process).

Server:  from ray_tpu_torch.util.client import server
         server.serve("127.0.0.1", 20001)          # in-cluster process
Client:  import ray_tpu_torch.util.client as client
         conn = client.connect("127.0.0.1:20001", token="<token hex>")
         # (or set RTT_CLUSTER_TOKEN_HEX and omit token=)
         ref = conn.remote(fn).remote(args)
         conn.get(ref)
"""
from .common import (ClientActorHandle, ClientObjectRef,
                     ClientRemoteFunction)
from .client import ClientConnection, connect
from . import server

__all__ = ["ClientActorHandle", "ClientConnection", "ClientObjectRef",
           "ClientRemoteFunction", "connect", "server"]
