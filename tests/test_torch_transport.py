"""The port's socket transport and learner-config push.

Mirrors tests/test_transport.py and tests/test_config.py on
seed_rl_torch: a round trip over a unix socket with signature discovery and
the config push, a fleet of actor processes (that import neither JAX nor
seed_rl_tpu) against one server, handler errors and shutdown reaching
remote callers, a size mismatch refused at the handshake, TCP with an
ephemeral port, address parsing against the JAX package's, the config
validation and push, and the actor loop adopting a pushed config.

Socket paths are short and unique per test (a unix path holds at most 107
bytes); every join, wait and ``communicate`` has its own timeout.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import numpy as np
import pytest

from seed_rl_tpu.runtime.transport import parse_address as jax_parse_address
from seed_rl_tpu.utils import config as jax_config
from seed_rl_torch.runtime.actor import actor_loop
from seed_rl_torch.runtime.inference_server import InferenceServer
from seed_rl_torch.runtime.specs import array_spec
from seed_rl_torch.runtime.transport import (
    SocketClient,
    parse_address,
    unique_socket_path,
)
from seed_rl_torch.types import EnvOutput
from seed_rl_torch.utils.config import (
    apply_config,
    serialize_config,
    validate_learner_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 20


def sock_path():
    return unique_socket_path("srt")


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a caller hung"


def _run_threads(target, n):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    _join(threads)


def _make_server(batch_size=4, handlers=None, flush_timeout_ms=50,
                 config=None):
    spec = array_spec((2,), np.float32)
    server = InferenceServer(handlers or [lambda env_ids, x: x * 2.0], spec,
                             spec, batch_size=batch_size,
                             flush_timeout_ms=flush_timeout_ms)
    path = sock_path()
    server.serve(path, config=config)
    return server, path


def test_socket_roundtrip_and_signature_discovery():
    server, path = _make_server(batch_size=4, config={"unroll_length": 7})
    clients = [SocketClient(path) for _ in range(4)]
    try:
        # The config rides the handshake (reference get_config push).
        assert clients[0].get_config() == {"unroll_length": 7}
        results = {}

        def worker(i):
            results[i] = clients[i].inference(
                i, np.array([i, i + 0.5], np.float32))

        _run_threads(worker, 4)
        for i in range(4):
            np.testing.assert_allclose(results[i], [2.0 * i, 2.0 * i + 1.0])
        assert server.stats["connections"] == 4
    finally:
        for c in clients:
            c.close()
        server.shutdown()


ACTOR_WORKER = textwrap.dedent("""\
    import sys, threading
    for name in ("jax", "jaxlib", "seed_rl_tpu"):
        sys.modules[name] = None  # importing any of them fails
    import numpy as np
    from seed_rl_torch.runtime.transport import SocketClient
    path, offset, n_envs, rounds = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), int(sys.argv[4]))
    failures, done = [], []

    def env_thread(i):
        env_id = offset + i
        try:
            client = SocketClient(path)
            for r in range(rounds):
                res = client.inference(env_id,
                                       np.array([env_id, r], np.float32))
                np.testing.assert_allclose(res, [2.0 * env_id, 2.0 * r])
                done.append(1)
            client.close()
        except Exception as e:
            failures.append(repr(e))

    threads = [threading.Thread(target=env_thread, args=(i,))
               for i in range(n_envs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if failures or any(t.is_alive() for t in threads):
        print("FAIL", failures[:3], flush=True)
        sys.exit(1)
    print("OK", len(done), flush=True)
""")


def test_multi_process_actor_fleet():
    """N actor processes x M env threads against one learner process (the
    reference's fleet contract, gcp/run.py:54-68); the actors import
    neither JAX nor seed_rl_tpu."""
    server, path = _make_server(batch_size=8, flush_timeout_ms=50)
    n_procs, envs_per_proc, rounds = 2, 4, 25
    procs = [subprocess.Popen(
        [sys.executable, "-c", ACTOR_WORKER, path, str(100 * p),
         str(envs_per_proc), str(rounds)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}) for p in range(n_procs)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out.decode()
            assert f"OK {envs_per_proc * rounds}" in out.decode()
        assert server.stats["total_requests"] == (
            n_procs * envs_per_proc * rounds)
        assert server.stats["connections"] == n_procs * envs_per_proc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        server.shutdown()


def test_handler_error_propagates_over_socket():
    fail_once = [True]

    def handler(env_ids, x):
        if fail_once[0]:
            fail_once[0] = False
            raise ValueError("boom")
        return x * 2.0

    server, path = _make_server(batch_size=2, handlers=[handler],
                                flush_timeout_ms=-1)
    clients = [SocketClient(path) for _ in range(2)]
    errors, results = [], {}

    def worker(i):
        try:
            results[i] = clients[i].inference(i, np.array([i, i],
                                                          np.float32))
        except RuntimeError as e:
            errors.append(str(e))

    try:
        _run_threads(worker, 2)
        assert len(errors) == 2 and all("handler failed" in e
                                        for e in errors)
        # The stream stays usable after a failed batch.
        _run_threads(worker, 2)
        assert len(results) == 2
        for i in range(2):
            np.testing.assert_allclose(results[i], [2.0 * i, 2.0 * i])
    finally:
        for c in clients:
            c.close()
        server.shutdown()


def test_shutdown_unblocks_remote_callers():
    server, path = _make_server(batch_size=8, flush_timeout_ms=-1)
    client = SocketClient(path)
    errors = []

    def worker():
        try:
            client.inference(0, np.zeros(2, np.float32))
        except (RuntimeError, ConnectionError) as e:
            errors.append(repr(e))

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.3)
    server.shutdown()
    _join([t])
    client.close()
    assert len(errors) == 1


def test_size_mismatch_rejected():
    server, path = _make_server(batch_size=2)
    try:
        with pytest.raises(ConnectionError):
            SocketClient(path, request_specs=array_spec((3,), np.float32),
                         result_specs=array_spec((2,), np.float32))
    finally:
        server.shutdown()


def test_unbindable_address_raises():
    spec = array_spec((2,), np.float32)
    server = InferenceServer([lambda e, x: x], spec, spec, batch_size=2)
    try:
        with pytest.raises(OSError, match="failed to bind"):
            server.serve("/tmp/" + "x" * 120 + ".sock")  # > 107 bytes
    finally:
        server.shutdown()


def test_tcp_roundtrip():
    """The same wire over TCP: an ephemeral-port bind, the bound port,
    NODELAY round trips, a clean shutdown."""
    spec = array_spec((2,), np.float32)
    server = InferenceServer([lambda env_ids, x: x + 1.0], spec, spec,
                             batch_size=2, flush_timeout_ms=50)
    server.serve("127.0.0.1:0", config={"via": "tcp"})
    port = server.bound_port
    assert port > 0
    clients = [SocketClient(f"127.0.0.1:{port}") for _ in range(2)]
    results = {}

    def worker(i):
        results[i] = clients[i].inference(i, np.array([i, i + 0.5],
                                                      np.float32))

    try:
        assert clients[0].get_config() == {"via": "tcp"}
        _run_threads(worker, 2)
        for i in range(2):
            np.testing.assert_allclose(results[i], [i + 1.0, i + 1.5])
    finally:
        for c in clients:
            c.close()
        server.shutdown()


@pytest.mark.parametrize("temp_dir", ["/t", "/" + "d" * 100])
def test_unique_socket_path_fits_a_unix_address(monkeypatch, temp_dir):
    """Sockets go in the temp directory unless that would pass the 107
    bytes of a unix address; then in /tmp. Two calls never collide."""
    monkeypatch.setattr(tempfile, "tempdir", temp_dir)
    path = unique_socket_path("srt")
    assert len(path.encode()) <= 107
    short = len(temp_dir) < 50
    assert os.path.dirname(path) == (temp_dir if short else "/tmp")
    assert os.path.basename(path).startswith(f"srt_{os.getpid()}_")
    assert path != unique_socket_path("srt")


@pytest.mark.parametrize("address", [
    "tcp://10.0.0.1:9000", "[::]:9000", "[::1]:9000", "localhost:80",
    ":7000", "/tmp/x.sock", "relative.sock", "/tmp/a:b/c.sock",
])
def test_parse_address_matches_jax(address):
    assert parse_address(address) == jax_parse_address(address)


def test_parse_address_forms():
    assert parse_address("tcp://10.0.0.1:9000") == (
        socket.AF_INET, ("10.0.0.1", 9000))
    assert parse_address("[::]:9000")[1] == ("127.0.0.1", 9000)
    assert parse_address("/tmp/x.sock") == (socket.AF_UNIX, "/tmp/x.sock")


def test_inference_batch_size_auto_tune_matches_jax():
    cases = [(640, 20, None, 1), (640, 20, -1, 4), (40, 20, None, 2),
             (640, 20, 60, 1)]
    for num_envs, env_batch, batch, hosts in cases:
        assert validate_learner_config(num_envs, env_batch, batch,
                                       num_hosts=hosts) == (
            jax_config.validate_learner_config(num_envs, env_batch, batch,
                                               num_hosts=hosts))
    assert validate_learner_config(640, 20, None, num_hosts=1) == 320


def test_validate_learner_config_rejects_bad_sizes():
    with pytest.raises(ValueError, match="exact multiple"):
        validate_learner_config(640, 20, 64)
    with pytest.raises(ValueError, match="bigger than"):
        validate_learner_config(64, 16, 128)
    with pytest.raises(ValueError):
        validate_learner_config(0, 16)


@dataclasses.dataclass(frozen=True)
class _Cfg:
    unroll_length: int = 20
    num_action_repeats: int = 1
    gamma: float = 0.99


def test_serialize_and_apply_config_match_jax():
    for cfg in (_Cfg(unroll_length=80), _Cfg(), _Cfg(gamma=0.997)):
        assert serialize_config(cfg) == jax_config.serialize_config(cfg)
    pushed = serialize_config(_Cfg(unroll_length=80, gamma=0.997))
    assert apply_config(_Cfg(), pushed) == _Cfg(unroll_length=80,
                                                 gamma=0.997)
    with pytest.raises(ValueError, match="bogus"):
        apply_config(_Cfg(), {"bogus": 1})


def test_actor_loop_adopts_pushed_config():
    """actor_loop fetches client.get_config before building envs."""
    adopted = {}

    class _FakeEnv:
        num_envs = 2

        def reset(self):
            return EnvOutput(
                reward=np.zeros((2,), np.float32),
                done=np.zeros((2,), bool),
                observation=np.zeros((2, 3), np.float32),
                abandoned=np.zeros((2,), bool),
                episode_step=np.zeros((2,), np.int32))

        def step(self, actions):
            return self.reset()

        def close(self):
            pass

    class _FakeClient:
        def get_config(self):
            return {"unroll_length": 80}

        def inference(self, env_id, run_id, row, raw_reward):
            return np.zeros((), np.int32)

    assert actor_loop(_FakeEnv, _FakeClient(), num_steps=2,
                      apply_config_fn=adopted.update) == 2
    assert adopted == {"unroll_length": 80}
