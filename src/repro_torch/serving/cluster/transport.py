"""Cluster transports: in-process loopback, OS pipes, and TCP sockets.

All transports move ONLY ``protocol.encode`` dicts — the loopback
round-trips every message through the codec so tests prove the protocol is
complete (nothing leaks across by object reference), the multiprocessing
transport pickles the same dicts over OS pipes, and the socket transport
pickles them into length-prefixed TCP frames.  The controller speaks
strict request/reply per worker, so the interface is a plain per-worker
mailbox:

  send(wid, msg)           raises WorkerGone when the worker is dead
  recv(wid, timeout=None)  the next reply; raises WorkerGone on EOF
                           or when no reply lands within the heartbeat
                           timeout (a hung worker is a dead worker)
  kill(wid)                test/failover hook: hard-stop one worker
  add_worker(spec)         elastic join: bring up one more worker; its
                           Hello waits in the mailbox for recv(spec.wid)
  retire(wid)              elastic leave: forget a worker that completed
                           the graceful Shutdown -> Bye exchange
  close()                  shut every remaining worker down

``LoopbackTransport`` runs each worker's ``WorkerRuntime`` synchronously in
the calling process: fully deterministic, used by the equivalence tests and
the ``ContentionTimeline`` fluid validation.  ``PipeTransport`` spawns one
OS process per ``WorkerSpec`` (spawn start method — a forked child cannot
use CUDA).  ``SocketTransport`` is the multi-host deployment shape: the
controller listens on a TCP address and every worker process *dials in*
and identifies itself with its first frame (the ``Hello``), so a
worker joining mid-run needs nothing but the address.  Frame format: a
4-byte big-endian unsigned length followed by that many bytes of pickled
codec dict (pickle, not JSON, because ``PageArray`` handoff payloads carry
raw device bytes).  See ``docs/multi_host.md``.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import select
import signal
import socket
import struct
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.cluster import protocol as P
from repro_torch.serving.cluster.worker import WorkerRuntime, WorkerSpec, \
    build_engine, worker_main


class WorkerGone(RuntimeError):
    """The worker cannot be reached: crashed, killed, or heartbeat-silent."""

    def __init__(self, wid: int, why: str = "gone"):
        super().__init__(f"worker {wid} {why}")
        self.wid = wid


class LoopbackTransport:
    """Deterministic in-process transport over the real codec.

    Each ``send`` runs the target worker's handler immediately; replies
    queue in a per-worker mailbox for ``recv``.  ``kill`` drops the worker
    mid-conversation — subsequent sends/recvs raise ``WorkerGone`` exactly
    as a crashed process would, which makes failover deterministic to test
    (arm a ``timeline.call_at`` timer that kills at a virtual instant).
    """

    def __init__(self, specs: Sequence[WorkerSpec]):
        self.specs = list(specs)
        self.runtimes: Dict[int, WorkerRuntime] = {}
        self._inbox: Dict[int, List[dict]] = {}
        self._dead: set = set()
        for spec in self.specs:
            self._boot(spec)

    def _boot(self, spec: WorkerSpec) -> None:
        rt = WorkerRuntime(build_engine(spec))
        self.runtimes[spec.wid] = rt
        self._inbox[spec.wid] = [P.encode(rt.hello())]

    def workers(self) -> List[int]:
        return [s.wid for s in self.specs]

    def add_worker(self, spec: WorkerSpec) -> None:
        """Elastic join: build the runtime now; its Hello waits in the
        mailbox exactly as at construction."""
        self.specs = [s for s in self.specs if s.wid != spec.wid] + [spec]
        self._dead.discard(spec.wid)
        self._boot(spec)

    def retire(self, wid: int) -> None:
        """Elastic leave: the worker already answered Shutdown with Bye."""
        self._dead.add(wid)
        self._inbox[wid] = []
        self.specs = [s for s in self.specs if s.wid != wid]

    def send(self, wid: int, msg) -> None:
        if wid in self._dead:
            raise WorkerGone(wid, "killed")
        reply = self.runtimes[wid].handle(P.decode(P.encode(msg)))
        self._inbox[wid].append(P.encode(reply))

    def recv(self, wid: int, timeout: Optional[float] = None):
        if wid in self._dead:
            raise WorkerGone(wid, "killed")
        if not self._inbox[wid]:
            raise RuntimeError(f"worker {wid}: recv with no pending reply "
                               "(protocol is strict request/reply)")
        return P.decode(self._inbox[wid].pop(0))

    def kill(self, wid: int) -> None:
        self._dead.add(wid)
        self._inbox[wid].clear()

    def close(self) -> None:
        for wid, rt in self.runtimes.items():
            if wid not in self._dead:
                rt.handle(P.Shutdown())
        self._dead.update(self.runtimes)


class PipeTransport:
    """One OS process per worker, one duplex pipe each.

    ``recv`` bounds its wait by ``heartbeat_timeout`` wall seconds: a
    worker that neither replies nor closes its pipe within the window is
    declared gone (the controller then fails its requests over).  Uses the
    ``spawn`` start method so workers start their own CUDA context instead
    of forking the parent's (a forked child cannot use CUDA).
    """

    def __init__(self, specs: Sequence[WorkerSpec], *,
                 heartbeat_timeout: float = 60.0, start_method: str = "spawn"):
        self.specs = list(specs)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._ctx = mp.get_context(start_method)
        self._conns: Dict[int, object] = {}
        self._procs: Dict[int, object] = {}
        for spec in self.specs:
            self._spawn(spec)

    def _spawn(self, spec: WorkerSpec) -> None:
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=worker_main, args=(child, spec),
                                 daemon=True,
                                 name=f"cluster-worker-{spec.wid}")
        proc.start()
        child.close()  # child end lives in the worker process now
        self._conns[spec.wid] = parent
        self._procs[spec.wid] = proc

    def workers(self) -> List[int]:
        return [s.wid for s in self.specs]

    def add_worker(self, spec: WorkerSpec) -> None:
        """Elastic join: spawn the process; its Hello arrives on the pipe
        and waits for ``recv(spec.wid)``."""
        self.specs = [s for s in self.specs if s.wid != spec.wid] + [spec]
        self._spawn(spec)

    def retire(self, wid: int) -> None:
        """Elastic leave: reap a worker that completed Shutdown -> Bye
        (its main loop exits after sending the Bye)."""
        proc = self._procs.pop(wid, None)
        conn = self._conns.pop(wid, None)
        if proc is not None:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        self.specs = [s for s in self.specs if s.wid != wid]

    def send(self, wid: int, msg) -> None:
        try:
            self._conns[wid].send(P.encode(msg))
        except (BrokenPipeError, OSError) as e:
            raise WorkerGone(wid, f"pipe closed ({e})") from e

    def recv(self, wid: int, timeout: Optional[float] = None):
        conn = self._conns[wid]
        wait = self.heartbeat_timeout if timeout is None else float(timeout)
        try:
            if not conn.poll(wait):
                raise WorkerGone(wid, f"heartbeat timeout ({wait:.1f}s)")
            return P.decode(conn.recv())
        except (EOFError, OSError) as e:
            raise WorkerGone(wid, f"pipe closed ({e})") from e

    def kill(self, wid: int) -> None:
        proc = self._procs[wid]
        if proc.is_alive():
            proc.kill()
        self._conns[wid].close()

    def close(self) -> None:
        for wid, conn in self._conns.items():
            try:
                conn.send(P.encode(P.Shutdown()))
            except (BrokenPipeError, OSError):
                pass
        for wid, proc in self._procs.items():
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
            try:
                self._conns[wid].close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# socket transport: length-prefixed pickled frames over TCP
# ---------------------------------------------------------------------------

_FRAME_HDR = struct.Struct("!I")  # payload length, big-endian u32


def send_frame(sock: socket.socket, payload: dict) -> None:
    """Write one frame: 4-byte big-endian length + pickled codec dict."""
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_FRAME_HDR.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("socket closed mid-frame")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> dict:
    """Blocking read of one frame (the worker side of the loop)."""
    (n,) = _FRAME_HDR.unpack(_recv_exact(sock, _FRAME_HDR.size))
    return pickle.loads(_recv_exact(sock, n))


class _FrameBuffer:
    """Reassemble frames from a TCP byte stream, partial reads included."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[dict]:
        self._buf += data
        frames: List[dict] = []
        while len(self._buf) >= _FRAME_HDR.size:
            (n,) = _FRAME_HDR.unpack(self._buf[:_FRAME_HDR.size])
            end = _FRAME_HDR.size + n
            if len(self._buf) < end:
                break
            frames.append(pickle.loads(bytes(self._buf[_FRAME_HDR.size:end])))
            del self._buf[:end]
        return frames


class _SocketConn:
    """Duck-types the ``multiprocessing.Connection`` surface ``worker_main``
    uses (send/recv of codec dicts, close) over a TCP socket, so the socket
    worker runs the identical serve loop as the pipe worker."""

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def send(self, obj: dict) -> None:
        send_frame(self._sock, obj)

    def recv(self) -> dict:
        return recv_frame(self._sock)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def socket_worker_main(host: str, port: int, spec: WorkerSpec) -> None:
    """Socket worker entry: dial the controller, then run the standard
    serve loop.  The first frame out is the Hello — it is both the
    handshake and the connection's identification (the controller learns
    which wid dialed from it), which is what lets a fresh worker join a
    running fleet with nothing but the address."""
    sock = socket.create_connection((host, port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    worker_main(_SocketConn(sock), spec)


class SocketTransport:
    """TCP transport: the controller listens, workers dial in.

    One spawned OS process per ``WorkerSpec`` (same ``spawn`` rationale as
    ``PipeTransport``), each connecting back to the controller's listening
    socket and identifying itself with its Hello frame.  ``recv`` runs a
    bounded ``select`` loop over the listener and every live connection, so
    frames from OTHER workers that land while one reply is awaited (a late
    joiner's Hello is the one legal case under strict request/reply) are
    buffered into their own mailboxes instead of lost.

    Fault surface: a killed worker's socket EOFs (``WorkerGone`` at the
    next send/recv); a worker that keeps its connection open but never
    replies — the half-open peer, injectable with ``silence()`` — falls to
    the heartbeat timeout.  Both land in the controller's one failover
    path.
    """

    def __init__(self, specs: Sequence[WorkerSpec], *,
                 heartbeat_timeout: float = 60.0, start_method: str = "spawn",
                 host: str = "127.0.0.1"):
        self.specs = list(specs)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._ctx = mp.get_context(start_method)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))  # port 0: the OS picks a free one
        self._listener.listen()
        self._listener.setblocking(False)
        self.address = self._listener.getsockname()
        self._procs: Dict[int, object] = {}
        self._socks: Dict[int, socket.socket] = {}
        self._wid_of: Dict[socket.socket, int] = {}
        self._bufs: Dict[socket.socket, _FrameBuffer] = {}
        self._pending: List[socket.socket] = []  # dialed, Hello not yet seen
        self._inbox: Dict[int, List[dict]] = {}
        self._dead: set = set()
        self._stopped: set = set()  # SIGSTOPped by silence(); reaped at close
        for spec in self.specs:
            self._spawn(spec)

    def _spawn(self, spec: WorkerSpec) -> None:
        host, port = self.address
        proc = self._ctx.Process(target=socket_worker_main,
                                 args=(host, port, spec), daemon=True,
                                 name=f"cluster-worker-{spec.wid}")
        proc.start()
        self._procs[spec.wid] = proc
        self._inbox.setdefault(spec.wid, [])

    def workers(self) -> List[int]:
        return [s.wid for s in self.specs]

    def add_worker(self, spec: WorkerSpec) -> None:
        """Elastic join: spawn a worker that dials in; its Hello identifies
        the new connection and waits for ``recv(spec.wid)``."""
        self.specs = [s for s in self.specs if s.wid != spec.wid] + [spec]
        self._dead.discard(spec.wid)
        self._spawn(spec)

    # -- the select loop -----------------------------------------------------
    def _poll(self, wait: float) -> None:
        """One bounded sweep: accept dial-ins, drain readable connections,
        route complete frames to their wid mailboxes."""
        rlist = [self._listener] + list(self._socks.values()) + self._pending
        readable, _, _ = select.select(rlist, [], [], max(wait, 0.0))
        for sock in readable:
            if sock is self._listener:
                self._accept()
            else:
                self._drain(sock)

    def _accept(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._pending.append(conn)
            self._bufs[conn] = _FrameBuffer()

    def _drain(self, sock: socket.socket) -> None:
        try:
            data = sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            self._drop(sock)
            return
        for frame in self._bufs[sock].feed(data):
            self._route(sock, frame)

    def _route(self, sock: socket.socket, frame: dict) -> None:
        wid = self._wid_of.get(sock)
        if wid is None:
            # an unidentified connection's first frame must be its Hello
            if frame.get("kind") != "Hello" or sock not in self._pending:
                self._drop(sock)
                return
            wid = int(frame["wid"])
            if wid in self._socks:
                self._drop(sock)  # duplicate wid: refuse the newcomer
                return
            self._pending.remove(sock)
            self._wid_of[sock] = wid
            self._socks[wid] = sock
        self._inbox.setdefault(wid, []).append(frame)

    def _drop(self, sock: socket.socket) -> None:
        """A connection EOFed (or sent garbage): close it; if it was an
        identified worker, that worker is gone."""
        wid = self._wid_of.pop(sock, None)
        self._bufs.pop(sock, None)
        if sock in self._pending:
            self._pending.remove(sock)
        try:
            sock.close()
        except OSError:
            pass
        if wid is not None and self._socks.get(wid) is sock:
            del self._socks[wid]
            self._dead.add(wid)

    # -- mailbox interface ---------------------------------------------------
    def send(self, wid: int, msg) -> None:
        if wid in self._dead:
            raise WorkerGone(wid, "killed")
        sock = self._socks.get(wid)
        if sock is None:
            raise WorkerGone(wid, "not connected")
        try:
            send_frame(sock, P.encode(msg))
        except OSError as e:
            self._drop(sock)
            raise WorkerGone(wid, f"socket closed ({e})") from e

    def recv(self, wid: int, timeout: Optional[float] = None):
        wait = self.heartbeat_timeout if timeout is None else float(timeout)
        deadline = time.monotonic() + wait
        while True:
            if self._inbox.get(wid):
                return P.decode(self._inbox[wid].pop(0))
            if wid in self._dead:
                raise WorkerGone(wid, "socket closed")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise WorkerGone(wid, f"heartbeat timeout ({wait:.1f}s)")
            self._poll(remaining)

    # -- fault injection + lifecycle -----------------------------------------
    def kill(self, wid: int) -> None:
        """SIGKILL the worker process; the kernel resets its connection,
        which EOFs at the controller — the crashed-host case."""
        proc = self._procs.get(wid)
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=5.0)
        sock = self._socks.pop(wid, None)
        if sock is not None:
            self._wid_of.pop(sock, None)
            self._bufs.pop(sock, None)
            try:
                sock.close()
            except OSError:
                pass
        self._dead.add(wid)
        self._inbox.get(wid, []).clear()

    def silence(self, wid: int) -> None:
        """Fault injection: SIGSTOP the worker — its TCP connection stays
        open but no reply ever lands (the half-open / hung-peer case).
        The controller's next recv on it must fall to the heartbeat
        timeout; ``close()`` reaps the frozen process."""
        os.kill(self._procs[wid].pid, signal.SIGSTOP)
        self._stopped.add(wid)

    def retire(self, wid: int) -> None:
        """Elastic leave: reap a worker that completed Shutdown -> Bye."""
        proc = self._procs.pop(wid, None)
        if proc is not None:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        sock = self._socks.pop(wid, None)
        if sock is not None:
            self._wid_of.pop(sock, None)
            self._bufs.pop(sock, None)
            try:
                sock.close()
            except OSError:
                pass
        self._dead.add(wid)
        self._inbox.pop(wid, None)
        self.specs = [s for s in self.specs if s.wid != wid]

    def close(self) -> None:
        for wid in self._stopped:  # frozen peers can't answer a Shutdown
            proc = self._procs.get(wid)
            if proc is not None and proc.is_alive():
                proc.kill()
        for wid, sock in list(self._socks.items()):
            if wid in self._dead or wid in self._stopped:
                continue
            try:
                send_frame(sock, P.encode(P.Shutdown()))
            except OSError:
                pass
        for wid, proc in self._procs.items():
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        for sock in list(self._bufs):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass


TRANSPORTS = ("loopback", "mp", "socket")


def make_transport(kind: str, specs: Sequence[WorkerSpec], **kw):
    """Build a transport by name (the ``--transport`` CLI axis)."""
    if kind == "loopback":
        kw.pop("heartbeat_timeout", None)
        return LoopbackTransport(specs, **kw)
    if kind == "mp":
        return PipeTransport(specs, **kw)
    if kind == "socket":
        return SocketTransport(specs, **kw)
    raise ValueError(f"transport must be one of {TRANSPORTS}, got {kind!r}")
