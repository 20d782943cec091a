"""Socket transport client for external actor processes.

Port of ``seed_rl_tpu/runtime/transport.py``: the client half of the native
wire in front of the batching inference server (``batcher.cc``'s
TransportServer). An actor connects over a unix-domain or TCP socket,
reads the request and result specs from the server's handshake (the
reference's Init RPC signature discovery, grpc/ops/grpc.cc:145-153), then
streams fixed-size frames: one blocking ``inference(env_id, request) ->
result`` per env step, batched server-side like the in-process path.

A handler exception raises in the blocked call (status 2); a server
shutdown raises ``RuntimeError`` and closes the stream (status 1), which the
actor's reconnect loop handles (reference actor.py:71-74, 182-185).

This module imports no torch: an actor process needs numpy and the
port's spec types only.
"""

import os
import socket
import struct
import tempfile
import time
import uuid

import numpy as np

from seed_rl_torch.runtime import specs as specs_lib
from seed_rl_torch.runtime.inference_server import _Codec


def _read_full(sock: socket.socket, n: int) -> bytes:
    parts = []
    while n > 0:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionError("server closed the connection")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


# The longest unix-domain socket path (sun_path holds 108 bytes with its NUL).
UNIX_PATH_MAX = 107


def unique_socket_path(prefix: str) -> str:
    """A fresh unix socket path ``<prefix>_<pid>_<hex>.sock`` in the temp
    directory, or in /tmp when that path would pass ``UNIX_PATH_MAX``."""
    name = f"{prefix}_{os.getpid()}_{uuid.uuid4().hex[:8]}.sock"
    path = os.path.join(tempfile.gettempdir(), name)
    if len(path.encode()) > UNIX_PATH_MAX:
        path = os.path.join("/tmp", name)
    return path


def parse_address(address: str):
    """``(family, target)`` of a transport address.

    ``host:port`` / ``tcp://host:port`` -> AF_INET (or AF_INET6 for a
    bracketed IPv6 host; a wildcard host means this machine); anything
    else is a unix-domain socket path.
    """
    addr = address[6:] if address.startswith("tcp://") else address
    if ":" in addr and "/" not in addr:
        if addr.startswith("["):  # bracketed IPv6, e.g. "[::1]:9000"
            host, _, port = addr[1:].partition("]:")
        else:
            host, port = addr.rsplit(":", 1)
        if not host or host == "::":
            host = "127.0.0.1"
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        return family, (host, int(port))
    return socket.AF_UNIX, addr


class SocketClient:
    """Blocking per-step inference client over a unix or TCP socket; one
    call at a time."""

    def __init__(self, path: str, request_specs=None, result_specs=None,
                 connect_timeout: float = 10.0):
        family, target = parse_address(path)
        is_tcp = family in (socket.AF_INET, socket.AF_INET6)
        deadline = time.time() + connect_timeout
        while True:
            sock = None
            try:
                if is_tcp:
                    # Resolves hostnames and picks v4 or v6.
                    sock = socket.create_connection(target)
                else:
                    sock = socket.socket(family, socket.SOCK_STREAM)
                    sock.connect(target)
                break
            except socket.gaierror:
                raise  # an unresolvable host will not resolve on a retry
            except OSError:  # refused, or the socket file not there yet
                if sock is not None:
                    sock.close()
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        self._sock = sock
        if is_tcp:
            # One small request/response per env transition: without
            # NODELAY every call waits out Nagle's delay.
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        magic = _read_full(sock, 4)
        if magic != b"SRL1":
            raise ConnectionError(f"bad handshake magic {magic!r}")
        (spec_len,) = struct.unpack("<Q", _read_full(sock, 8))
        blob = _read_full(sock, spec_len) if spec_len else b""
        self.server_config = None
        if request_specs is None or result_specs is None:
            if not blob:
                raise ConnectionError(
                    "the server sent no specs; pass them explicitly")
            request_specs, result_specs, self.server_config = (
                specs_lib.loads_handshake(blob))
        # A request of another shape or dtype than the server's specs
        # raises here, before a byte of it is sent.
        self._req_codec = _Codec(request_specs)
        self._res_codec = _Codec(result_specs)
        sock.sendall(struct.pack("<QQ", self._req_codec.nbytes,
                                 self._res_codec.nbytes))
        (status,) = _read_full(sock, 1)
        if status != 0:
            raise ConnectionError(
                "request/result byte sizes do not match the server's")

    def get_config(self):
        return self.server_config

    def inference(self, env_id: int, request):
        """Blocking call; returns the un-batched result tree."""
        self._sock.sendall(struct.pack("<q", int(env_id))
                           + self._req_codec.encode(request))
        (status,) = _read_full(self._sock, 1)
        payload = _read_full(self._sock, self._res_codec.nbytes)
        if status == 2:
            raise RuntimeError("inference handler failed (server-side)")
        if status != 0:
            raise RuntimeError("inference server is shut down")
        return self._res_codec.decode(payload)

    def close(self):
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class RemoteActorClient:
    """``SocketClient`` in the reference actor's call convention
    (common/actor.py:108): ``inference(env_id, run_id, env_output,
    raw_reward) -> action``, the request being ``(run_id, EnvOutput)``."""

    def __init__(self, path: str, connect_timeout: float = 10.0):
        self._client = SocketClient(path, connect_timeout=connect_timeout)

    def get_config(self):
        return self._client.get_config()

    def inference(self, env_id, run_id, env_output, raw_reward):
        del raw_reward  # tracked learner-side via EnvOutput.reward
        (action,) = self._client.inference(
            env_id, (np.int64(run_id), env_output))
        return action

    def close(self):
        self._client.close()
