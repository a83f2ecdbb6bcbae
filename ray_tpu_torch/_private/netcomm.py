"""Cross-node object transfer: authenticated chunked pulls over TCP.

TPU-native analogue of the reference's ObjectManager data plane
(src/ray/object_manager/object_manager.h:117 chunked push/pull over gRPC,
pull_manager.h:53 admission control, push_manager.h:30 push scheduling).
The store is file-per-object shm (object_store.py), so the server streams
the object's backing file with ``os.sendfile`` (zero userspace copies) and
the puller receives straight into the destination store's mmap — the
chunking/buffer-pool machinery the reference needs (object_buffer_pool.h)
collapses into kernel pagecache.

Large objects (> pull_parallel_threshold_mb) are pulled as K disjoint
RANGES over K parallel connections — the multi-stream analogue of the
reference's chunked parallel pushes (object_buffer_pool.h chunk splits),
which one TCP stream's congestion window / single-core recv loop caps.

Auth: HMAC-SHA256 challenge/response keyed on the per-cluster token (the
same token daemons use to join the control plane), so an open port does
not serve objects to strangers.

Wire protocol (v2): request = 16-byte object id + ">QQ" (offset, length;
length 0 = to end of object). Response = ">Q" total object size (or
NOT_FOUND), then the requested byte range.
"""

from __future__ import annotations

import collections
import fcntl
import hmac
import os
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from . import fault
from . import lockdep
from . import protocol as P
from . import racedebug
from . import telemetry

_MAGIC = b"RTX2"
_NOT_FOUND = 0xFFFFFFFFFFFFFFFF
# offset sentinel: "tell me the backing file instead of streaming" —
# the same-host fast path (reference: same-node plasma clients mmap the
# store directly instead of copying through the object manager).
_REQ_LOCAL = 0xFFFFFFFFFFFFFFFE
_CHUNK = 8 << 20  # advisory sendfile/recv window

# Backing kinds in the same-host fast-path reply.
KIND_FILE = 0   # plain file: the peer copies it
KIND_ARENA = 1  # native arena slot: the peer may adopt it in place


def _auto_gate_width() -> int:
    """Concurrency width for big same-host copies, scaled to the host's
    parallel page-allocation bandwidth. Concurrent first-touch of fresh
    tmpfs pages collapses superlinearly on SMALL hosts — measured
    1.48 GB/s solo vs 0.04 GB/s each at 4-way on a 1-core box (kernel
    shmem allocation contention) — so tiny hosts serialize fully, while
    many-core hosts overlap several copies (one copy cannot saturate
    their zeroing + memcpy bandwidth)."""
    ncpu = os.cpu_count() or 1
    if ncpu <= 2:
        return 1
    if ncpu <= 4:
        return 2
    return 4


class HostCopyGate:
    """Bandwidth-aware admission gate for big same-host copies across
    all ray_tpu_torch processes OF THIS UID on this host: up to `width`
    copies run concurrently; excess waiters queue with FIFO tickets
    (in-process exact, cross-process best-effort via per-uid flock slot
    files). The old exclusive gate was correct for one client and
    catastrophic for many — multi-client puts/pulls serialized on a
    single host-wide lock; this gate lets them overlap up to what the
    host's page-allocation bandwidth supports (_auto_gate_width,
    overridable via ray_config.host_copy_gate_width).

    Scoping the slot files per-uid is a deliberate security tradeoff: a
    fixed world-writable path would let any local user symlink-squat it
    (and have a root daemon chmod an arbitrary file) or hold LOCK_EX to
    add latency to every large copy; the cost is that copies from
    DIFFERENT uids on one host no longer share the gate. Best-effort by
    design: if the slot files are unusable (permissions, hostile
    pre-creation) or all held for longer than max_wait_s, the copy runs
    ungated — a slow transfer beats a wedged one."""

    _PATH_FMT = ".rtt_host_copy.%d.%d.lock"  # under config.temp_root()
    _MAX_WAIT_S = 120.0

    def __init__(self, width: Optional[int] = None,
                 max_wait_s: Optional[float] = None):
        self._width_override = width
        self._max_wait_s = (self._MAX_WAIT_S if max_wait_s is None
                            else float(max_wait_s))
        self._lock = lockdep.lock("netcomm.host_copy_gate")
        self._queue: collections.deque = collections.deque()  # FIFO tickets
        self._holders = 0
        self._tls = threading.local()  # per-thread (admitted, slot)

    @property
    def width(self) -> int:
        if self._width_override is not None:
            return max(1, int(self._width_override))
        try:
            from .config import ray_config
            cfg = int(ray_config.host_copy_gate_width)
        except Exception:
            cfg = 0
        return max(1, cfg) if cfg > 0 else _auto_gate_width()

    # -- in-process FIFO admission -------------------------------------
    def _pump_locked(self, width: int):
        while self._queue and self._holders < width:
            ticket = self._queue.popleft()
            self._holders += 1
            ticket.set()

    def acquire(self) -> bool:
        """Admit this thread (True) or time out to an ungated copy
        (False). FIFO: earlier waiters are always admitted first."""
        global _gate_ops
        _gate_ops += 1
        import time as _t
        t0 = _t.monotonic() if telemetry.enabled else None
        width = self.width
        ticket = threading.Event()
        with self._lock:
            self._queue.append(ticket)
            self._pump_locked(width)
        if not ticket.wait(self._max_wait_s):
            admitted_late = False
            with self._lock:
                try:
                    self._queue.remove(ticket)
                except ValueError:
                    # Raced an admission: we hold a slot after all.
                    admitted_late = True
            if not admitted_late:
                self._tls.state = (False, None)
                if t0 is not None:
                    telemetry.record_gate_wait(_t.monotonic() - t0)  # lint: ungated-instrumentation-ok t0 is non-None only when telemetry.enabled was set at entry
                return False
        if t0 is not None:
            telemetry.record_gate_wait(_t.monotonic() - t0)  # lint: ungated-instrumentation-ok t0 is non-None only when telemetry.enabled was set at entry
        self._tls.state = (True, self._grab_slot(width))
        return True

    def release(self):
        admitted, slot = getattr(self._tls, "state", (False, None))
        self._tls.state = (False, None)
        if slot is not None:
            try:
                os.close(slot)  # per-acquisition fd: close drops the flock
            except OSError:
                pass
        if admitted:
            with self._lock:
                self._holders -= 1
                self._pump_locked(self.width)

    # -- cross-process width (best-effort flock slots) -----------------
    def _try_slot(self, i: int) -> Tuple[Optional[int], bool]:
        """Try to lock slot `i` on a FRESH fd. flock(2) is per open
        file description: a cached shared fd would make a second
        in-process holder's flock a silent no-op AND let the first
        release() drop a slot another thread still holds — so every
        acquisition gets its own fd (closed on release). Returns
        (locked fd or None, slot file usable)."""
        import stat as _stat
        from .config import temp_root
        try:
            fd = os.open(
                os.path.join(temp_root(), self._PATH_FMT % (os.getuid(), i)),
                os.O_CREAT | os.O_RDWR | os.O_NOFOLLOW | os.O_CLOEXEC,
                0o600)
        except OSError:
            return None, False
        try:
            st = os.fstat(fd)
            if not _stat.S_ISREG(st.st_mode) or st.st_uid != os.getuid():
                os.close(fd)
                return None, False  # hostile pre-creation: unusable
        except OSError:
            os.close(fd)
            return None, False
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return fd, True
        except OSError:
            os.close(fd)
            return None, True  # usable but held elsewhere

    def _grab_slot(self, width: int) -> Optional[int]:
        """Hold one of `width` host-wide flock slots so the TOTAL
        concurrency across processes honors the width. In-process
        admission already ran; an unobtainable slot (other processes
        saturating the host) falls back to running with in-process
        admission only after max_wait_s; unusable lock files (hostile
        pre-creation, bad perms) skip the wait entirely."""
        import time as _t
        deadline = _t.monotonic() + self._max_wait_s
        delay = 0.001  # 1 ms first retry; a typical gated copy is tens
        while True:    # of ms, so coarse polling would waste real time
            any_usable = False
            for i in range(width):
                fd, usable = self._try_slot(i)
                if fd is not None:
                    return fd
                any_usable = any_usable or usable
            if not any_usable or _t.monotonic() >= deadline:
                return None  # ungated beats wedged
            _t.sleep(delay)
            delay = min(delay * 2, 0.01)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# Backwards-compatible name: object_store and the pull paths gate
# through this instance.
_host_copy_gate = HostCopyGate()

# Ticket-acquisition counter (always on — one integer add per GATED
# copy, which is already a large-transfer slow path): the perf_smoke
# guard for the small-put bypass asserts this does not move across a
# batch of sub-threshold puts (tests/test_put_path.py).
_gate_ops = 0


def gate_ops() -> int:
    """Process-wide count of HostCopyGate ticket acquisitions."""
    return _gate_ops


class SerialExecutor:
    """One worker thread draining a FIFO queue: the recv-loop offload
    seam. Recv threads hand decoded messages here instead of routing
    inline, so a slow handler (or a handler blocking on a dead worker
    pipe) can't stall frame parsing or death detection — while
    per-connection message ORDER is preserved exactly (the property a
    thread pool would break: WORKER_DIED must not overtake the worker's
    final TASK_DONE).

    Bounded: past `max_queued` items submit() blocks the caller — the
    graceful degradation back to the old inline-routing throttling,
    instead of unbounded memory growth when handlers fall behind a
    message flood.

    The worker thread is LAZY: spawned on first submit and retired
    after `_IDLE_EXIT_S` with an empty queue, so an idle connection's
    executor costs zero threads (at 1,000 registered daemons the head
    would otherwise park 1,000 route threads that fire a few times a
    minute). Invariant: queue non-empty => a live thread owns draining
    it (submit re-spawns under the same condvar the retiree exits
    under, so no item is ever stranded)."""

    _MAX_QUEUED = 10_000
    _IDLE_EXIT_S = 5.0

    def __init__(self, name: str = "serial-exec",
                 max_queued: Optional[int] = None):
        self._q: collections.deque = collections.deque()
        self._max_queued = (self._MAX_QUEUED if max_queued is None
                            else int(max_queued))
        self._cond = lockdep.condition("netcomm.serial_exec")
        self._stopped = False
        self._busy = False  # a handler is executing right now
        self._name = name  # lint: guarded-by-ok immutable after __init__: thread-name template
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread_locked(self):
        """Spawn the drain thread if none is live (caller holds _cond)."""
        t = self._thread
        if t is None or not t.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=self._name)
            self._thread.start()

    def submit(self, fn, *args):
        with self._cond:
            while len(self._q) >= self._max_queued and not self._stopped:
                self._cond.wait(timeout=1.0)
            if self._stopped:
                return
            if racedebug.enabled:
                racedebug.access(self, "_q", write=True)
            self._q.append((fn, args))
            self._ensure_thread_locked()
            self._cond.notify()

    def qsize(self) -> int:
        """Queued (not yet executing) items — the head's loop-depth
        gauge reads this at exposition time (len() is GIL-atomic on a
        deque; no lock, no hot-path cost)."""
        return len(self._q)  # lint: guarded-by-ok exposition-time gauge: len() of a deque is GIL-atomic; no lock on the hot path

    def _loop(self):
        while True:
            with self._cond:
                self._busy = False
                self._cond.notify_all()  # close()/submit() waiters
                while not self._q and not self._stopped:
                    if (not self._cond.wait(timeout=self._IDLE_EXIT_S)
                            and not self._q and not self._stopped):
                        # Idle window expired with an empty queue:
                        # retire. Clearing _thread under the condvar is
                        # what lets submit() re-spawn race-free.
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                if not self._q and self._stopped:
                    return
                if racedebug.enabled:
                    racedebug.access(self, "_q", write=True)
                fn, args = self._q.popleft()
                self._busy = True
            try:
                fn(*args)
            except Exception:
                import traceback
                traceback.print_exc()

    def close(self, drain_timeout: float = 2.0):
        """Stop accepting work; give queued AND in-flight handlers a
        bounded window to finish (teardown paths want the last
        completions fully routed before death handling runs), then let
        the thread exit."""
        import time as _t
        deadline = _t.monotonic() + drain_timeout
        with self._cond:
            while ((self._q or self._busy)
                   and _t.monotonic() < deadline):
                self._cond.wait(timeout=0.05)
            self._stopped = True
            self._cond.notify_all()


def tune_control_socket(fd: int) -> None:
    """Uniform socket setup for every CONTROL connection: TCP_NODELAY
    (micro-batched writers replace Nagle; stacking the two means 40 ms
    stalls on small frames) and SO_KEEPALIVE (half-open links on
    long-lived daemon/head connections eventually error out of blocked
    recv loops instead of wedging forever). Best-effort: non-TCP fds
    (AF_UNIX worker pipes) ignore the TCP option."""
    try:
        s = socket.socket(fileno=os.dup(fd))
    except OSError:
        return
    try:
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        except OSError:
            pass
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
    finally:
        s.close()


class _NullGate:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], n - got)
        if r == 0:
            raise EOFError("peer closed during transfer")
        got += r
    return bytes(buf)


_IOV_MAX = 512  # conservative bound under the kernel's IOV_MAX (1024)


class ConnectionWriter:
    """Per-connection outbound writer: sends enqueue pre-pickled
    message chunks; ONE writer thread drains the whole queue per wakeup
    and ships it as a single vectored write (os.writev) of one
    multi-message frame (protocol.dump_messages layout). Replaces
    lock-per-send_bytes — under a burst, N messages cost one syscall
    and one receiver wake instead of N each, and a slow or dead peer
    never blocks the calling thread (recv pumps, schedulers, heartbeat
    loops) in write(2).

    Ordering: strict per-connection FIFO (single queue, single writer).
    Errors: the first write failure is latched; later send() calls
    raise it (callers treat that as peer death, same as the old inline
    send_bytes), and `on_error` fires once for connection-teardown
    hooks.

    Backpressure: the queue is byte-bounded (`max_queued_bytes`).
    Below the high-water mark senders never block; above it, send()
    blocks until the writer drains — the old blocking-send_bytes
    throttling, degraded to gracefully instead of growing the process
    without bound against a stalled peer (TCP zero-window, wedged
    daemon)."""

    _MAX_QUEUED_BYTES = 64 << 20

    def __init__(self, conn, name: str = "conn-writer",
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 autostart: bool = True,
                 max_queued_bytes: Optional[int] = None):
        self._conn = conn  # keep a ref so the fd outlives us
        self._fd = conn.fileno()
        self._on_error = on_error
        self._cond = lockdep.condition("netcomm.writer")
        self._q: collections.deque = collections.deque()
        self._q_bytes = 0
        self._max_q_bytes = (self._MAX_QUEUED_BYTES
                             if max_queued_bytes is None
                             else int(max_queued_bytes))
        self._busy = False
        self._stopped = False
        self._error: Optional[BaseException] = None
        self.write_calls = 0   # syscall counter (perf_smoke guard)
        self.frames_sent = 0   # messages shipped
        self._thread: Optional[threading.Thread] = None
        self._name = name
        if autostart:
            self.start()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=self._name)
            self._thread.start()

    def queued_bytes(self) -> int:
        """Bytes currently queued behind this writer (exposition-time
        gauge; a plain int read, no lock)."""
        return self._q_bytes  # lint: guarded-by-ok exposition-time gauge: plain int read, torn values are harmless

    # -- enqueue -------------------------------------------------------
    def send_message(self, msg_type: str, payload: dict):
        """Pickle NOW (payload state is captured at enqueue time) and
        queue for the next coalesced write. Out-of-band buffers
        (pickle.PickleBuffer-wrapped fields) stay separate chunks all
        the way into the vectored write — never copied into the
        frame."""
        chunks, _ = P.dump_message_parts(msg_type, payload)
        self.send_chunks(chunks)

    def send_frame(self, body: bytes):
        """Queue an already-pickled single-message body."""
        self.send_chunks([body])

    def send_chunks(self, chunks: List):
        nbytes = sum(P._chunk_len(c) for c in chunks)
        with self._cond:
            # High-water backpressure: only engages against a stalled
            # or far-too-slow peer (the writer normally drains in ms).
            while (self._q_bytes > self._max_q_bytes
                   and self._error is None and not self._stopped):
                self._cond.wait(timeout=1.0)
            if self._error is not None:
                raise self._error
            if self._stopped:
                raise OSError("connection writer stopped")
            if racedebug.enabled:
                racedebug.access(self, "_q", write=True)
            self._q.append(chunks)
            self._q_bytes += nbytes
            self._cond.notify()

    # -- drain ---------------------------------------------------------
    def _assemble(self, items: List[List]) -> List:
        """Build the iovec list for one drain: a lone plain message
        ships as a classic single-message frame; anything else (bursts,
        or messages carrying out-of-band buffers) ships as ONE batch
        frame (protocol.assemble_batch — the single encoder of the
        batch layout). Chunks are referenced, not joined."""
        if len(items) == 1 and len(items[0]) == 1:
            body = items[0][0]
            return [P.conn_frame_header(P._chunk_len(body)), body]
        body_chunks = P.assemble_batch(items)
        total = sum(P._chunk_len(c) for c in body_chunks)
        return [P.conn_frame_header(total)] + body_chunks

    def _writev_all(self, iov: List):
        """writev with partial-write + IOV_MAX handling. Zero-length
        chunks (empty out-of-band buffers) are dropped up front: a
        trailing empty iovec would make writev return 0 forever and
        spin this loop."""
        views = [v for v in
                 (memoryview(c).cast("B") if not isinstance(c, memoryview)
                  else c.cast("B") for c in iov)
                 if v.nbytes]
        idx = 0
        off = 0
        while idx < len(views):
            batch = [views[idx][off:]]
            batch.extend(views[idx + 1:idx + _IOV_MAX])
            n = os.writev(self._fd, batch)
            self.write_calls += 1
            while n > 0 and idx < len(views):
                chunk_left = views[idx].nbytes - off
                if n >= chunk_left:
                    n -= chunk_left
                    idx += 1
                    off = 0
                else:
                    off += n
                    n = 0

    def drain_once(self) -> int:
        """Drain the current queue with one vectored write. Returns the
        number of messages shipped (test seam; the writer thread calls
        this in its loop)."""
        with self._cond:
            if not self._q:
                return 0
            if racedebug.enabled:
                racedebug.access(self, "_q", write=True)
            items = list(self._q)
            self._q.clear()
            self._q_bytes = 0
            self._busy = True
            self._cond.notify_all()  # wake backpressured senders
        try:
            self._writev_all(self._assemble(items))
            self.frames_sent += len(items)
            if telemetry.enabled:
                telemetry.record_writer_batch(len(items))
        except (OSError, ValueError) as e:
            with self._cond:
                self._error = e
                self._q.clear()
                self._q_bytes = 0
                self._busy = False
                self._cond.notify_all()
            if self._on_error is not None:
                try:
                    self._on_error(e)
                except Exception:  # lint: broad-except-ok user error callback on the writer thread; the latched error (re-raised below) is the real signal
                    pass
            raise
        with self._cond:
            self._busy = False
            if not self._q:
                self._cond.notify_all()
        return len(items)

    def _loop(self):
        while True:
            with self._cond:
                while not self._q and not self._stopped \
                        and self._error is None:
                    self._cond.wait()
                if self._error is not None or (self._stopped
                                               and not self._q):
                    return
            try:
                self.drain_once()
            except (OSError, ValueError):
                return

    # -- lifecycle -----------------------------------------------------
    def flush(self, timeout: Optional[float] = 5.0) -> bool:
        """Wait until everything queued so far hit the wire (or the
        writer died). True when the queue drained."""
        import time as _t
        deadline = None if timeout is None else _t.monotonic() + timeout
        with self._cond:
            while self._q or self._busy:
                if self._error is not None:
                    return False
                remaining = None if deadline is None \
                    else deadline - _t.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return self._error is None

    def close(self, flush_timeout: float = 2.0):
        self.flush(flush_timeout)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=1.0)


class LoopWriter(ConnectionWriter):
    """ConnectionWriter without the thread: the owning ControlLoop
    drains the queue with nonblocking os.writev on EVENT_WRITE. At
    1,000 daemon connections the threaded writer costs 1,000 parked
    threads; folding the drain into the head's event loops makes the
    outbound side O(loops) too (reference: the GCS server's sends ride
    the same asio io_service as its reads).

    The ConnectionWriter contract is preserved EXACTLY — strict
    per-connection FIFO (single queue, single drainer: the loop
    thread), pickle-at-enqueue, first-error latched and re-raised on
    later send() calls with a one-shot `on_error`, byte-bounded
    blocking backpressure (bytes accepted-but-not-yet-on-the-wire
    count against the high-water mark, so a stalled peer still blocks
    senders instead of growing the process), coalesced one-frame
    bursts via the same _assemble, and flush()/close() waiting for the
    wire, not just the queue.

    Arming: senders set write interest through the loop's pending
    list + self-pipe (never touching the selector cross-thread); the
    loop drops interest when a drain pass ends idle. The arm runs
    OUTSIDE _cond — the loop thread nests loop._lock -> writer._cond,
    so arming under _cond would be the ABBA half."""

    def __init__(self, conn, loop: "ControlLoop",
                 name: str = "loop-writer",
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 max_queued_bytes: Optional[int] = None):
        super().__init__(conn, name=name, on_error=on_error,
                         autostart=False, max_queued_bytes=max_queued_bytes)
        self._loop_owner = loop  # immutable: the owning event loop
        # Drain state owned by the loop thread (the single drainer):
        self._pending: List = []  # loop-thread-only (the single drainer)
        self._pending_items = 0  # loop-thread-only (the single drainer)
        # Shared with senders under _cond (backpressure + arming).
        # Guarded by the INHERITED ConnectionWriter._cond (same
        # "netcomm.writer" lockdep class) — the static pass cannot see
        # a base-class lock, so the contract is annotated here and
        # proven dynamically by the lockset detector.
        self._pending_bytes = 0
        self._armed = False

    def start(self):
        """No writer thread: the ControlLoop drains this writer."""
        return

    def queued_bytes(self) -> int:
        """Bytes accepted but not yet on the wire (queued + mid-drain;
        exposition-time gauge, plain int reads)."""
        return self._q_bytes + self._pending_bytes

    def send_chunks(self, chunks: List):
        nbytes = sum(P._chunk_len(c) for c in chunks)
        arm = False
        # The loop thread is this writer's SOLE drainer. An inline
        # handler sending on its own loop (the head's NODE_PING ->
        # NODE_SYNC ack) must therefore NEVER block here: at the
        # high-water mark nothing else can drain _pending/_q, latch an
        # error, or stop the writer, so the wait would deadlock the
        # whole shard (and the heartbeat rescue runs on this same
        # thread). Loop-thread sends skip backpressure and enqueue
        # unconditionally — they are self-limiting (bounded per
        # inbound frame), so the overshoot is one reply per read.
        on_loop = self._loop_owner.on_loop_thread()
        with self._cond:
            # High-water backpressure: pending (drained-but-unsent)
            # bytes still count — against a zero-window peer the loop
            # parks the batch in _pending, and senders must block on
            # that exactly like they blocked on the writer thread.
            while (not on_loop
                   and self._q_bytes + self._pending_bytes
                   > self._max_q_bytes
                   and self._error is None and not self._stopped):
                self._cond.wait(timeout=1.0)
            if self._error is not None:
                raise self._error
            if self._stopped:
                raise OSError("connection writer stopped")
            if racedebug.enabled:
                racedebug.access(self, "_q", write=True)
            self._q.append(chunks)
            self._q_bytes += nbytes
            if not self._armed:
                self._armed = True
                arm = True
        if arm:
            self._loop_owner.arm_writer(self)

    def _latch_error(self, e: BaseException):
        with self._cond:
            self._error = e
            self._q.clear()
            self._q_bytes = 0
            self._pending = []
            self._pending_bytes = 0
            self._pending_items = 0
            self._busy = False
            self._armed = False
            self._cond.notify_all()
        if self._on_error is not None:
            try:
                self._on_error(e)
            except Exception:  # lint: broad-except-ok user error callback on the loop thread; the latched error (raised to later senders) is the real signal
                pass

    def _drain_nonblocking(self) -> str:
        """One drain pass on the loop thread. Returns 'idle' (all on
        the wire; write interest can drop), 'more' (socket
        backpressure mid-batch; keep EVENT_WRITE armed) or 'dead'
        (error latched; the read side owns teardown, as with the dead
        writer thread before)."""
        while True:
            if not self._pending:
                with self._cond:
                    if self._error is not None:
                        return "dead"
                    if not self._q:
                        self._busy = False
                        self._armed = False
                        self._cond.notify_all()  # flush() waiters
                        return "idle"
                    if racedebug.enabled:
                        racedebug.access(self, "_q", write=True)
                    items = list(self._q)
                    self._q.clear()
                    took = self._q_bytes
                    self._pending_bytes += took
                    self._q_bytes = 0
                    self._busy = True
                self._pending = [
                    v for v in
                    (memoryview(c).cast("B")
                     if not isinstance(c, memoryview) else c.cast("B")
                     for c in self._assemble(items))
                    if v.nbytes]
                self._pending_items = len(items)
                # _assemble added framing (conn_frame_header + batch
                # layout) on top of the payload bytes credited above,
                # and the debit below is raw `wrote` — which includes
                # that framing. Credit the delta so each completed
                # batch returns _pending_bytes to exactly zero instead
                # of drifting negative (queued_bytes gauge + the
                # backpressure threshold must not loosen over time).
                framing = (sum(v.nbytes for v in self._pending) - took)
                if framing:
                    with self._cond:
                        self._pending_bytes += framing
            wrote = 0
            err: Optional[BaseException] = None
            blocked = False
            try:
                while self._pending:
                    n = os.writev(self._fd, self._pending[:_IOV_MAX])
                    self.write_calls += 1
                    wrote += n
                    while n > 0:
                        v = self._pending[0]
                        if n >= v.nbytes:
                            n -= v.nbytes
                            self._pending.pop(0)
                        else:
                            self._pending[0] = v[n:]
                            n = 0
            except (BlockingIOError, InterruptedError):
                blocked = True
            except (OSError, ValueError) as e:
                err = e
            if wrote:
                with self._cond:
                    self._pending_bytes -= wrote
                    self._cond.notify_all()  # backpressured senders
            if err is not None:
                self._latch_error(err)
                return "dead"
            if blocked or self._pending:
                return "more"
            # One coalesced batch fully on the wire.
            self.frames_sent += self._pending_items
            if telemetry.enabled:
                telemetry.record_writer_batch(self._pending_items)
            self._pending_items = 0
            # Loop: the queue may have refilled while we wrote.


class _LoopConn:
    """Per-connection state owned by a ControlLoop (loop thread only)."""

    __slots__ = ("conn", "sock", "fd", "parser", "writer", "on_msgs",
                 "on_eof", "ctx", "want_write")

    def __init__(self, conn, sock, fd, writer, on_msgs, on_eof, ctx):
        self.conn = conn          # keep the Connection alive with us
        self.sock = sock          # dup'd fd wrapped for recv_into
        self.fd = fd
        self.parser = P.FrameParser()
        self.writer = writer      # LoopWriter or None
        self.on_msgs = on_msgs    # fn(ctx, [(msg_type, payload), ...])
        self.on_eof = on_eof      # fn(ctx)
        self.ctx = ctx
        self.want_write = False


class ControlLoop:
    """One selectors-based control-plane event loop: nonblocking
    accept, MSG_DONTWAIT reads through per-connection FrameParsers,
    and LoopWriter drains on EVENT_WRITE — the head-side analogue of
    the scheduler's _RecvMux, extended with the outbound half
    (reference: the GCS server's asio io_service owning both
    directions of every raylet connection;
    common/asio/instrumented_io_context.h).

    Threading model: the loop thread OWNS the selector and every
    _LoopConn. Other threads talk to it only through the pending-ops
    list under `_lock` plus the self-pipe wake (the _RecvMux idiom) —
    registering connections/acceptors, arming writers. Handlers run ON
    the loop thread, so they must stay nonblocking-cheap and offload
    anything slow (node_service routes worker-plane messages to the
    per-connection SerialExecutor for exactly this reason)."""

    def __init__(self, name: str = "control-loop"):
        import selectors
        self._sel = selectors.DefaultSelector()  # lint: guarded-by-ok loop-thread-only after __init__: every selector op runs on _run
        self._lock = lockdep.lock("netcomm.control_loop")
        self._pending_ops: list = []
        self._stopped = False
        self._conns: Dict[int, _LoopConn] = {}  # lint: guarded-by-ok loop-thread-only table; len() reads for the fd gauge are GIL-atomic
        self._rd, self._wr = os.pipe()  # lint: guarded-by-ok immutable fd pair after __init__: the self-pipe wake idiom
        os.set_blocking(self._rd, False)
        self._sel.register(self._rd, selectors.EVENT_READ, None)
        # Telemetry counters: loop thread writes, exposition reads
        # (plain ints; torn reads are harmless scrape noise).
        self.wakeups = 0  # lint: guarded-by-ok loop-thread writer, exposition-time reader; torn int reads are harmless scrape noise
        self.iterations = 0  # lint: guarded-by-ok loop-thread writer, exposition-time reader; torn int reads are harmless scrape noise
        self.last_iter_s = 0.0  # lint: guarded-by-ok loop-thread writer, exposition-time reader; torn float reads are harmless scrape noise
        self._name = name  # lint: guarded-by-ok immutable after __init__
        self._thread = threading.Thread(target=self._run, daemon=True,  # lint: guarded-by-ok immutable after __init__: stop() only joins it
                                        name=name)
        self._thread.start()

    # -- cross-thread API ----------------------------------------------
    def add_acceptor(self, sock, on_accept: Callable):
        """Register a nonblocking listening socket; `on_accept(client)`
        runs on the loop thread per accepted (blocking-mode) client."""
        sock.setblocking(False)
        with self._lock:
            self._pending_ops.append(("acceptor", sock, on_accept))
        self._wake()

    def register_conn(self, conn, writer: Optional[LoopWriter],
                      on_msgs: Callable, on_eof: Callable, ctx):
        """Adopt an established connection: reads feed a FrameParser
        and whole frames reach `on_msgs(ctx, msgs)` on the loop
        thread; EOF/error runs `on_eof(ctx)` once. Any bytes already
        queued on `writer` are drained at adoption (sends enqueued
        between handshake and registration are NOT lost)."""
        with self._lock:
            self._pending_ops.append(("add", conn, writer, on_msgs,
                                      on_eof, ctx))
        self._wake()

    def arm_writer(self, writer: LoopWriter):
        with self._lock:
            self._pending_ops.append(("arm", writer))
        self._wake()

    def on_loop_thread(self) -> bool:
        """True when the caller IS this loop's thread. LoopWriter uses
        this to keep loop-originated sends (inline handler replies)
        nonblocking: the loop thread is the sole drainer, so blocking
        it on its own writer's backpressure would deadlock the
        shard."""
        return threading.current_thread() is self._thread

    def registered_fds(self) -> int:
        """Connections owned by this loop (exposition-time gauge)."""
        return len(self._conns)

    def backlog_bytes(self) -> int:
        """Bytes buffered mid-frame across this loop's connections
        (exposition-time gauge; racy reads under the GIL)."""
        total = 0
        try:
            for state in list(self._conns.values()):
                total += len(state.parser.buf)
        except RuntimeError:
            pass  # table mutating mid-iteration: scrape-time only
        return total

    def stats(self) -> dict:
        return {"name": self._name, "fds": self.registered_fds(),
                "wakeups": self.wakeups, "iterations": self.iterations,
                "last_iter_s": self.last_iter_s,
                "backlog_bytes": self.backlog_bytes()}

    def stop(self, join_timeout: float = 2.0):
        with self._lock:
            self._stopped = True
        self._wake()
        t = self._thread
        if t is not threading.current_thread():
            t.join(timeout=join_timeout)

    def _wake(self):
        try:
            os.write(self._wr, b"x")
        except OSError:
            pass

    # -- loop internals (loop thread only) -----------------------------
    def _apply_op(self, op):
        import selectors
        kind = op[0]
        if kind == "add":
            _, conn, writer, on_msgs, on_eof, ctx = op
            try:
                fd = conn.fileno()
                # Nonblocking on the REAL fd: writev must never block
                # the loop (reads already use MSG_DONTWAIT).
                os.set_blocking(fd, False)
                sock = socket.socket(fileno=os.dup(fd))
            except (OSError, ValueError):
                self._safe_eof(on_eof, ctx)
                return
            state = _LoopConn(conn, sock, fd, writer, on_msgs, on_eof,
                              ctx)
            self._conns[fd] = state
            self._sel.register(fd, selectors.EVENT_READ, state)
            # Recover sends enqueued before adoption (NODE_ACK and
            # anything the registration callbacks queued).
            if writer is not None:
                self._drain_writer(state)
        elif kind == "acceptor":
            _, sock, on_accept = op
            self._sel.register(sock.fileno(), selectors.EVENT_READ,
                               ("accept", sock, on_accept))
        elif kind == "arm":
            writer = op[1]
            state = self._conns.get(writer._fd)
            if state is not None and state.writer is writer:
                self._drain_writer(state)
            # Unknown fd: the arm raced adoption — register_conn's
            # drain-at-adoption covers the queued bytes. Dropped.

    def _drain_writer(self, state: _LoopConn):
        import selectors
        res = state.writer._drain_nonblocking()
        want = res == "more"
        if want != state.want_write and state.fd in self._conns:
            state.want_write = want
            events = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if want else 0)
            try:
                self._sel.modify(state.fd, events, state)
            except (KeyError, ValueError, OSError):
                pass
        # 'dead': error latched; the read side sees the broken socket
        # and runs the one true teardown path (writer-thread parity).

    def _safe_eof(self, on_eof, ctx):
        try:
            on_eof(ctx)
        except Exception:
            import traceback
            traceback.print_exc()

    def _close_conn(self, state: _LoopConn):
        try:
            self._sel.unregister(state.fd)
        except (KeyError, ValueError):
            pass
        self._conns.pop(state.fd, None)
        try:
            state.sock.close()
        except OSError:
            pass
        self._safe_eof(state.on_eof, state.ctx)

    def _on_acceptable(self, sock, on_accept):
        while True:
            try:
                client, _addr = sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            try:
                on_accept(client)
            except Exception:
                import traceback
                traceback.print_exc()

    def _on_readable(self, state: _LoopConn, scratch, scratch_view,
                     scratch_n):
        eof = False
        while True:
            try:
                r = state.sock.recv_into(scratch, scratch_n,
                                         socket.MSG_DONTWAIT)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                eof = True
                break
            if r == 0:
                eof = True
                break
            state.parser.feed(scratch_view[:r])
            if r < scratch_n:
                break
        for frame in state.parser.frames():
            try:
                # One frame may carry a coalesced burst from the
                # peer's writer; the handler takes the whole batch (it
                # routes in order — burst framing must not reorder).
                state.on_msgs(state.ctx, P.load_messages(frame))
            except Exception:
                import traceback
                traceback.print_exc()
        if eof:
            self._close_conn(state)

    def _run(self):
        import time as _t

        import selectors
        _SCRATCH_N = 1 << 20
        scratch = bytearray(_SCRATCH_N)
        scratch_view = memoryview(scratch)
        while True:
            with self._lock:
                ops, self._pending_ops = self._pending_ops, []
                stopped = self._stopped
            for op in ops:
                try:
                    self._apply_op(op)
                except Exception:
                    import traceback
                    traceback.print_exc()
            if stopped:
                self._shutdown()
                return
            try:
                events = self._sel.select(timeout=1.0)
            except OSError:
                continue
            self.wakeups += 1
            t0 = _t.monotonic()
            for key, mask in events:
                data = key.data
                if data is None:
                    try:
                        while os.read(self._rd, 4096):
                            pass
                    except OSError:
                        pass
                    continue
                if isinstance(data, tuple):
                    self._on_acceptable(data[1], data[2])
                    continue
                state: _LoopConn = data
                if mask & selectors.EVENT_WRITE and state.writer is not None:
                    self._drain_writer(state)
                if mask & selectors.EVENT_READ:
                    self._on_readable(state, scratch, scratch_view,
                                      _SCRATCH_N)
            self.iterations += 1
            self.last_iter_s = _t.monotonic() - t0

    def _shutdown(self):
        # Close OUR dup'd fds and the selector; the owner (HeadServer
        # stop) runs connection teardown explicitly — on_eof must not
        # fire here on top of it.
        for state in list(self._conns.values()):
            try:
                self._sel.unregister(state.fd)
            except (KeyError, ValueError, OSError):
                pass
            try:
                state.sock.close()
            except OSError:
                pass
        self._conns.clear()
        try:
            self._sel.close()
        except OSError:
            pass
        for fd in (self._rd, self._wr):
            try:
                os.close(fd)
            except OSError:
                pass


class ControlLoopGroup:
    """A small fixed shard of ControlLoops: connections are assigned
    round-robin at registration and stay put (per-connection ordering
    lives inside one loop). O(loops) threads for any number of
    connections — the head's thread ceiling."""

    def __init__(self, n: int, name: str = "control-loop"):
        n = max(1, int(n))
        self._loops = [ControlLoop(name=f"{name}-{i}") for i in range(n)]  # lint: guarded-by-ok immutable shard list after __init__
        self._next = 0
        self._lock = lockdep.lock("netcomm.control_loop_group")

    def __len__(self) -> int:
        return len(self._loops)

    def assign(self) -> ControlLoop:
        with self._lock:
            i = self._next % len(self._loops)
            self._next += 1
        return self._loops[i]

    def add_acceptor(self, sock, on_accept: Callable):
        self._loops[0].add_acceptor(sock, on_accept)

    def stats(self) -> List[dict]:
        return [loop.stats() for loop in self._loops]

    def backlog_bytes(self) -> int:
        return sum(loop.backlog_bytes() for loop in self._loops)

    def stop(self):
        for loop in self._loops:
            loop.stop()


class TransferServer:
    """Serves this node's objects to peers (one thread per connection;
    reference: ObjectManager server side + PushManager chunking)."""

    def __init__(self, paths_for: Callable[[bytes], List[str]],
                 authkey: bytes, host: str = "0.0.0.0", port: int = 0,
                 view_for: Optional[Callable] = None,
                 locate_for: Optional[Callable] = None):
        self._paths_for = paths_for
        # Arena-backed stores have no per-object file: view_for returns
        # a pinned zero-copy memoryview instead (released after send).
        self._view_for = view_for
        # Same-host fast path: (path, offset, size, release_fn) of the
        # object's backing file, pinned until release_fn().
        self._locate_for = locate_for
        self._authkey = authkey
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stopped = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="transfer-accept")
        self._thread.start()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            nonce = os.urandom(32)
            conn.sendall(_MAGIC + nonce)
            digest = _recv_exact(conn, 32)
            expect = hmac.new(self._authkey, nonce, "sha256").digest()
            if not hmac.compare_digest(digest, expect):
                return
            # Connection reuse: serve requests until the peer hangs up.
            while True:
                try:
                    req = _recv_exact(conn, 32)
                except EOFError:
                    return
                oid = req[:16]
                offset, length = struct.unpack(">QQ", req[16:])
                if offset == _REQ_LOCAL:
                    self._serve_local(conn, oid)
                else:
                    self._serve_one(conn, oid, offset, length)
        except (OSError, EOFError):
            pass  # peer dropped mid-request/mid-send
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_local(self, conn: socket.socket, oid: bytes):
        """Same-host fast path: reply with the object's backing file +
        offset so the (loopback) peer copies — or, for arena-backed
        objects, ADOPTS — it straight from pagecache. Response:
        [u64 size][u16 path_len][path][u64 data_offset][u8 kind]; the
        object stays pinned until the peer's 1-byte ack (by which time
        an adopting peer holds its own pin through the shared header).
        NOT_FOUND here only means "no fast path" — the peer falls back
        to the streaming pull, which decides existence."""
        loc = None
        if self._locate_for is not None:
            try:
                loc = self._locate_for(oid)
            except Exception:  # lint: broad-except-ok any store-side locate failure (freed, spilled, foreign backend) means "no fast path" — NOT_FOUND sends the peer down the streaming pull, which decides existence
                loc = None
        if loc is None:
            conn.sendall(struct.pack(">Q", _NOT_FOUND))
            return
        path, offset, size, release, kind = loc
        try:
            pb = path.encode()
            conn.sendall(struct.pack(">Q", size)
                         + struct.pack(">H", len(pb)) + pb
                         + struct.pack(">Q", offset)
                         + struct.pack(">B", kind))
            if pb:
                _recv_exact(conn, 1)  # peer done copying / adopted
        finally:
            try:
                release()
            except Exception:  # lint: broad-except-ok pin release on a torn-down store during shutdown; the pull itself already succeeded or failed above
                pass

    def _serve_one(self, conn: socket.socket, oid: bytes,
                   offset: int, length: int):
        if fault.enabled:
            fault.fire("netcomm.serve", oid=oid.hex()[:8])
        fd = None
        for path in self._paths_for(oid):
            try:
                fd = os.open(path, os.O_RDONLY)
                break
            except OSError:
                continue
        if fd is None:
            view = self._view_for(oid) if self._view_for else None
            if view is None:
                conn.sendall(struct.pack(">Q", _NOT_FOUND))
                return
            try:
                size = len(view)
                end = size if length == 0 else min(size, offset + length)
                conn.sendall(struct.pack(">Q", size))
                if offset < end:
                    conn.sendall(view[offset:end])
            finally:
                view.release()
            return
        try:
            size = os.fstat(fd).st_size
            end = size if length == 0 else min(size, offset + length)
            conn.sendall(struct.pack(">Q", size))
            while offset < end:
                sent = os.sendfile(conn.fileno(), fd, offset,
                                   min(_CHUNK, end - offset))
                if sent == 0:
                    raise EOFError("peer closed mid-send")
                offset += sent
        finally:
            os.close(fd)

    def stop(self):
        self._stopped = True
        try:
            self._sock.close()
        except OSError:
            pass


class _PeerConn:
    """One authenticated, reusable connection to a peer's TransferServer."""

    def __init__(self, host: str, port: int, authkey: bytes):
        if fault.enabled:
            fault.fire("netcomm.connect", peer=f"{host}:{port}")
        self.sock = socket.create_connection((host, port), timeout=30.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        hdr = _recv_exact(self.sock, 36)
        if hdr[:4] != _MAGIC:
            raise ConnectionError("bad transfer-server magic")
        self.sock.sendall(hmac.new(authkey, hdr[4:], "sha256").digest())

    def request_range(self, oid: bytes, offset: int, length: int) -> int:
        """Send a range request; returns the TOTAL object size. Raises
        ObjectLostError on the NOT_FOUND sentinel — a mid-pull eviction
        on the source sends no payload, and treating the sentinel as a
        size would hang the recv loop forever."""
        from ..exceptions import ObjectLostError
        if fault.enabled:
            fault.fire("netcomm.recv", oid=oid.hex()[:8])
        self.sock.sendall(oid + struct.pack(">QQ", offset, length))
        (size,) = struct.unpack(">Q", _recv_exact(self.sock, 8))
        if size == _NOT_FOUND:
            raise ObjectLostError(
                oid.hex(), "object not present on source node")
        return size

    def recv_into_range(self, view, offset: int, end: int):
        got = offset
        while got < end:
            r = self.sock.recv_into(view[got:end], min(_CHUNK, end - got))
            if r == 0:
                raise EOFError("source closed mid-transfer")
            got += r

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class PullManager:
    """Client side: dedupe + admission-controlled pulls into a local store
    (reference: PullManager, pull_manager.h:53 — bounded in-flight bytes,
    one pull per object no matter how many requesters). Objects above
    the parallel threshold split into range-pulls over parallel
    connections (reference: object_buffer_pool.h chunked transfers)."""

    def __init__(self, store, authkey: bytes, max_concurrent: int = 4,
                 parallel_threshold: Optional[int] = None,
                 parallel_streams: Optional[int] = None):
        from .config import ray_config
        self._store = store
        self._authkey = authkey
        self._sem = threading.Semaphore(max_concurrent)
        self._lock = lockdep.lock("netcomm.pull_manager")
        self._inflight: dict = {}   # oid bytes -> (event, [error])
        self._conns: dict = {}      # (host, port) -> [_PeerConn]
        self._par_threshold = int(
            parallel_threshold if parallel_threshold is not None
            else float(ray_config.pull_parallel_threshold_mb) * (1 << 20))
        self._par_streams = int(
            parallel_streams if parallel_streams is not None
            else ray_config.pull_parallel_streams)
        thresh_mb = float(ray_config.transfer_serialize_threshold_mb)
        self._serialize_threshold = (int(thresh_mb * (1 << 20))
                                     if thresh_mb > 0 else (1 << 62))
        self._pull_tls = threading.local()  # per-pull size for warnings
        self._adopt_enabled = bool(ray_config.same_host_adoption)

    def pull(self, object_id, host: str, port: int) -> None:
        """Ensure `object_id` is in the local store, pulling from
        (host, port) if needed. Concurrent callers for the same object
        share one transfer."""
        if self._store.contains(object_id):
            return
        key = object_id.binary()
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None:
                entry = (threading.Event(), [None])
                self._inflight[key] = entry
                leader = True
            else:
                leader = False
        if not leader:
            entry[0].wait()
            if entry[1][0] is not None:
                raise entry[1][0]
            return
        try:
            with self._sem:
                if not self._store.contains(object_id):
                    self._pull_with_retry(object_id, host, port)
        except BaseException as e:  # noqa: BLE001 — propagate to waiters
            entry[1][0] = e
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            entry[0].set()

    def in_flight(self, object_id) -> bool:
        """A pull of ``object_id`` has started and not yet ended."""
        with self._lock:
            return object_id.binary() in self._inflight

    # -- connection pool (a LIST per peer: parallel range streams) -----
    def _acquire_conn(self, host: str, port: int) -> _PeerConn:
        with self._lock:
            pool = self._conns.setdefault((host, port), [])
            if pool:
                return pool.pop()
        return _PeerConn(host, port, self._authkey)

    def _release_conn(self, host: str, port: int, conn: _PeerConn):
        with self._lock:
            pool = self._conns.setdefault((host, port), [])
            if len(pool) < max(self._par_streams, 4):
                pool.append(conn)
                return
        conn.close()

    def _pull_with_retry(self, object_id, host: str, port: int) -> None:
        """One object pull, hardened: transient transport failures
        (connect resets, mid-transfer EOF, stale pooled connections past
        the single fast retry) back off exponentially with jitter and
        retry under an overall deadline; exhaustion surfaces a typed
        ObjectLostError instead of a hang or a raw socket error
        (reference: pull_manager.h retries + gcs_rpc_client.h backoff)."""
        import time as _t

        from ..exceptions import ObjectLostError
        from .config import ray_config
        attempts = max(1, int(ray_config.pull_retry_attempts))
        deadline = _t.monotonic() + float(ray_config.pull_deadline_s)
        delays = fault.backoff_delays(
            attempts, float(ray_config.pull_retry_backoff_s), cap_s=2.0,
            deadline=deadline)
        tries = 0
        while True:
            try:
                tries += 1
                if fault.enabled:
                    fault.fire("store.pull", oid=object_id.hex()[:8])
                return self._pull_once(object_id, host, port)
            except ObjectLostError:
                raise  # definitive: the source says it has no copy
            except (OSError, EOFError, ConnectionError) as e:
                if self._store.contains(object_id):
                    return  # a concurrent path landed the bytes
                if telemetry.enabled:
                    telemetry.record_pull_retry()
                if next(delays, None) is None:
                    # Report what actually happened: the deadline can
                    # truncate the backoff before all attempts ran.
                    raise ObjectLostError(
                        object_id.hex(),
                        f"pull of {object_id.hex()[:8]} from "
                        f"{host}:{port} failed after {tries} of "
                        f"{attempts} attempts "
                        f"(deadline {float(ray_config.pull_deadline_s)}"
                        f"s): {e!r}") from e

    def _pull_once(self, object_id, host: str, port: int) -> None:
        import time as _t
        _t0 = _t.monotonic()
        self._pull_tls.bytes = 0
        try:
            return self._pull_once_inner(object_id, host, port)
        finally:
            _dt = _t.monotonic() - _t0
            if _dt > 0.5:
                import logging
                # "Slow" is relative to size: big objects legitimately
                # take seconds (and gated copies queue behind peers), so
                # only warn when the pull is BOTH long and far below any
                # sane transfer rate — that's a stall, not a big object.
                bw = getattr(self._pull_tls, "bytes", 0) / _dt
                stalled = _dt > 5.0 and bw < 50e6
                lg = logging.getLogger(__name__)
                (lg.warning if stalled else lg.debug)(
                    "slow pull %s: %.3fs (%.0f MB/s)",
                    object_id.hex()[:8], _dt, bw / 1e6)

    def _pull_once_inner(self, object_id, host: str, port: int) -> None:
        from ..exceptions import ObjectLostError
        oid = object_id.binary()
        if host in ("127.0.0.1", "localhost", "::1"):
            # Same-host peer: copy straight from its store's backing
            # file (one memcpy through pagecache, no TCP byte-shuffling
            # — the reference's same-node plasma mmap behavior).
            try:
                if self._pull_local(object_id, host, port):
                    return
                # NOT_FOUND is a documented "no fast path" answer
                # (stores without locate_for): debug, not warning.
                import logging
                logging.getLogger(__name__).debug(
                    "fast path NOT_FOUND for %s", object_id.hex()[:8])
            except Exception as e:
                import logging
                logging.getLogger(__name__).warning(
                    "fast path failed for %s: %r", object_id.hex()[:8], e)
        conn = self._acquire_conn(host, port)
        retried = False
        while True:
            try:
                size = conn.request_range(oid, 0, self._par_threshold)
                break
            except ObjectLostError:
                self._release_conn(host, port, conn)  # clean protocol state
                raise
            except (OSError, EOFError, ConnectionError):
                # Stale pooled connection: retry once on a fresh one.
                conn.close()
                if retried:
                    raise
                retried = True
                conn = _PeerConn(host, port, self._authkey)
        self._pull_tls.bytes = size
        # Same-host streaming fallback (spilled/file-backed objects):
        # gate the whole copy like the fast path — the receive is paced
        # by a local sendfile, so holding the host gate is cheap, and
        # parallel range streams only add contention on one host.
        gated = (host in ("127.0.0.1", "localhost", "::1")
                 and size >= self._serialize_threshold)
        gate = _host_copy_gate if gated else _NullGate()
        with gate:
            view = self._store.create(object_id, size)
            try:
                head_end = min(size, self._par_threshold)
                if size > head_end and self._par_streams > 1 and not gated:
                    # Parallel tail ranges pull WHILE the head range
                    # streams on this connection.
                    tail = size - head_end
                    k = min(self._par_streams - 1,
                            max(1, tail // max(1, self._par_threshold // 2)))
                    k = int(k)
                    step = (tail + k - 1) // k
                    errors: list = []
                    threads = []
                    for i in range(k):
                        lo = head_end + i * step
                        hi = min(size, lo + step)
                        if lo >= hi:
                            break
                        t = threading.Thread(
                            target=self._pull_range,
                            args=(oid, host, port, view, lo, hi, errors),
                            daemon=True, name="pull-range")
                        t.start()
                        threads.append(t)
                    try:
                        conn.recv_into_range(view, 0, head_end)
                    finally:
                        # Range threads hold slices of `view`: they MUST
                        # end before the error path releases/aborts it,
                        # or the release raises over live exports while
                        # writers scribble into a recycled slot.
                        for t in threads:
                            t.join()
                    if errors:
                        raise errors[0]
                else:
                    conn.recv_into_range(view, 0, head_end)
                    if size > head_end:
                        # Single-stream mode: fetch the tail sequentially
                        # on the same connection.
                        conn.request_range(oid, head_end, 0)
                        conn.recv_into_range(view, head_end, size)
            except BaseException:
                view.release()
                abort = getattr(self._store, "_abort_reserve", None)
                if abort is not None:
                    abort(object_id)
                conn.close()
                raise
            view.release()
        self._store.seal(object_id)
        self._release_conn(host, port, conn)

    def _pull_local(self, object_id, host: str, port: int) -> bool:
        """Same-host fast path; True when the object landed locally.
        False/raise => caller falls back to streaming."""
        import mmap as _mmap
        oid = object_id.binary()
        conn = self._acquire_conn(host, port)
        try:
            conn.sock.sendall(oid + struct.pack(">QQ", _REQ_LOCAL, 0))
            (size,) = struct.unpack(">Q", _recv_exact(conn.sock, 8))
            if size == _NOT_FOUND:
                self._release_conn(host, port, conn)
                return False
            self._pull_tls.bytes = size
            (plen,) = struct.unpack(">H", _recv_exact(conn.sock, 2))
            path = _recv_exact(conn.sock, plen).decode()
            (data_off,) = struct.unpack(">Q", _recv_exact(conn.sock, 8))
            (kind,) = struct.unpack(">B", _recv_exact(conn.sock, 1))
            if (kind == KIND_ARENA and self._adopt_enabled
                    and hasattr(self._store, "adopt_native")):
                # Zero-copy adoption: pin the source's slot through the
                # shared arena header instead of copying the bytes —
                # the source's serve-pin covers us until our own pin
                # lands, then the ack lets it go.
                try:
                    self._store.adopt_native(
                        object_id, path, data_off, size, pin=True)
                    conn.sock.sendall(b"\x01")
                    self._release_conn(host, port, conn)
                    return True
                except Exception:
                    import logging
                    logging.getLogger(__name__).debug(
                        "adoption failed for %s; copying", oid.hex()[:8])
            try:
                fd = os.open(path, os.O_RDONLY)
            except OSError:
                conn.sock.sendall(b"\x01")  # release the source pin
                self._release_conn(host, port, conn)
                return False
            try:
                page = _mmap.ALLOCATIONGRANULARITY
                aligned = data_off - (data_off % page)
                delta = data_off - aligned
                mm = _mmap.mmap(fd, size + delta, prot=_mmap.PROT_READ,
                                offset=aligned)
            finally:
                os.close(fd)
            gate = (_host_copy_gate if size >= self._serialize_threshold
                    else _NullGate())
            try:
                with gate:
                    view = self._store.create(object_id, size)
                    try:
                        view[0:size] = memoryview(mm)[delta:delta + size]
                    except BaseException:
                        view.release()
                        abort = getattr(self._store, "_abort_reserve", None)
                        if abort is not None:
                            abort(object_id)
                        raise
            finally:
                mm.close()
                try:
                    conn.sock.sendall(b"\x01")  # source may unpin now
                except OSError:
                    pass
            view.release()
            self._store.seal(object_id)
            self._release_conn(host, port, conn)
            return True
        except BaseException:
            conn.close()
            raise

    def _pull_range(self, oid: bytes, host: str, port: int, view,
                    lo: int, hi: int, errors: list):
        try:
            conn = self._acquire_conn(host, port)
            try:
                conn.request_range(oid, lo, hi - lo)
                conn.recv_into_range(view, lo, hi)
            except BaseException:
                conn.close()
                raise
            self._release_conn(host, port, conn)
        except BaseException as e:  # noqa: BLE001 — joined by leader
            errors.append(e)

    def shutdown(self):
        with self._lock:
            pools = list(self._conns.values())
            self._conns.clear()
        for pool in pools:
            for c in pool:
                c.close()


def store_paths_factory(store):
    """(paths_for, view_for) serving hooks for either store backend:
    file-per-object stores serve via sendfile (shm file, then spill
    file); the arena store serves a pinned zero-copy view (spill files
    still go through the file path)."""
    from .ids import ObjectID

    file_path = getattr(store, "_path", None)
    if callable(file_path):
        def paths_for(oid_bytes: bytes) -> List[str]:
            oid = ObjectID(oid_bytes)
            return [store._path(oid), store._spill_path(oid)]
        return paths_for, None

    def spill_paths_for(oid_bytes: bytes) -> List[str]:
        return [store._spill_path(ObjectID(oid_bytes))]

    def view_for(oid_bytes: bytes):
        try:
            return store._pinned_view(ObjectID(oid_bytes))
        except KeyError:
            return None

    return spill_paths_for, view_for


def store_local_locator(store):
    """locate_for hook for the same-host fast path: (path, offset,
    size, release, kind) of an object's backing file, pinned until
    release. kind: 0 = plain file (copy it), 1 = native arena (the
    peer may ADOPT the slot in place — cross-process pins through the
    shared header make that safe). Returns None when the backend can't
    provide one (spilled, etc.)."""
    from .ids import ObjectID

    file_path = getattr(store, "_path", None)
    if callable(file_path):
        def locate_file(oid_bytes: bytes):
            oid = ObjectID(oid_bytes)
            for path in (store._path(oid), store._spill_path(oid)):
                try:
                    size = os.stat(path).st_size
                    return (path, 0, size, lambda: None, KIND_FILE)
                except OSError:
                    continue
            return None
        return locate_file

    native = getattr(store, "_store", None)
    arena_path = getattr(store, "_path", None)
    if native is None or not isinstance(arena_path, str):
        return None

    def locate_arena(oid_bytes: bytes):
        oid = ObjectID(oid_bytes)
        try:
            off, size = native.locate(oid)  # pins
        except KeyError:
            # Adopted here from another node's arena: serve the
            # ORIGINAL backing (pinned through the foreign handle for
            # the serve duration) so the next peer adopts it too.
            ext = getattr(store, "export_adoption", lambda _o: None)(oid)
            if ext is not None:
                epath, _eoff, _esize = ext
                try:
                    h = store._foreign_handle(epath)
                    hoff, hsize = h.locate(oid)  # serve pin
                    return (epath, hoff, hsize,
                            lambda: h.release(oid), KIND_ARENA)
                except KeyError:
                    pass
            # Spilled objects live in plain files.
            path = store._spill_path(oid)
            try:
                fsize = os.stat(path).st_size
                return (path, 0, fsize, lambda: None, KIND_FILE)
            except OSError:
                return None
        return (arena_path, off, size,
                lambda: native.release(oid), KIND_ARENA)
    return locate_arena
