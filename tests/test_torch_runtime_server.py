"""The port's batching inference server (seed_rl_torch.runtime) against JAX.

The codec must give the JAX package's bytes for the same values: the wire
is a concatenation of leaves in ``jax.tree`` order, dict keys sorted,
whatever order a dict was built in. Then the eight cases of
tests/test_inference_server.py on the port's server: batched calls, the
partial-batch flush, round-robin handlers, shutdown, env ids, a handler
error reaching every blocked caller, sustained rounds; and the build of the
port's own copy of batcher.cc into build/batcher.

Every thread join passes a timeout and is followed by a check that the
thread finished, so a hang fails in seconds.
"""

import pickle
import threading
import time

import jax
import numpy as np
import pytest

from seed_rl_tpu.runtime.inference_server import _Codec as JaxCodec
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch.runtime import inference_server, specs
from seed_rl_torch.runtime.inference_server import InferenceServer, _Codec
from seed_rl_torch.runtime.specs import ArraySpec, array_spec
from seed_rl_torch.types import EnvOutput

JOIN_S = 20


def _join(threads, timeout=JOIN_S):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a caller hung"


def _run_threads(target, n):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    _join(threads)


def _env_output_specs(obs_specs):
    return EnvOutput(
        reward=array_spec((), np.float32),
        done=array_spec((), bool),
        observation=obs_specs,
        abandoned=array_spec((), bool),
        episode_step=array_spec((), np.int32),
    )


def _jax_specs(tree):
    return jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, np.dtype(s.dtype)), tree,
        is_leaf=lambda x: isinstance(x, ArraySpec))


def test_codec_bytes_equal_jax_with_dict_keys_out_of_order():
    rng = np.random.default_rng(0)
    # The port's specs and values are built with the keys in another order
    # than JAX's; jax.tree sorts them, so must the port.
    obs_specs = {"zeta": array_spec((3,), np.float32),
                 "alpha": array_spec((2, 2), np.uint8),
                 "mid": array_spec((), np.int32)}
    port_specs = (array_spec((), np.int64), _env_output_specs(obs_specs))
    jax_obs = {k: jax.ShapeDtypeStruct(obs_specs[k].shape,
                                       np.dtype(obs_specs[k].dtype))
               for k in ("alpha", "mid", "zeta")}
    jax_specs = (jax.ShapeDtypeStruct((), np.int64), JaxEnvOutput(
        reward=jax.ShapeDtypeStruct((), np.float32),
        done=jax.ShapeDtypeStruct((), bool),
        observation=jax_obs,
        abandoned=jax.ShapeDtypeStruct((), bool),
        episode_step=jax.ShapeDtypeStruct((), np.int32)))
    port, ref = _Codec(port_specs), JaxCodec(jax_specs)
    assert port.nbytes == ref.nbytes
    for count in (1, 5):
        obs = {"zeta": rng.normal(size=(count, 3)).astype(np.float32),
               "mid": rng.integers(-9, 9, (count,)).astype(np.int32),
               "alpha": rng.integers(0, 255, (count, 2, 2)).astype(np.uint8)}
        values = (rng.integers(1, 2**62, (count,)), EnvOutput(
            reward=rng.normal(size=count).astype(np.float32),
            done=rng.random(count) < 0.5,
            observation=obs,
            abandoned=rng.random(count) < 0.5,
            episode_step=rng.integers(0, 99, count).astype(np.int32)))
        jax_values = (values[0], JaxEnvOutput(
            *values[1][:2], {k: obs[k] for k in sorted(obs)},
            *values[1][3:]))
        blob = port.encode_batch(values)
        assert blob == ref.encode_batch(jax_values)
        row = specs.map_tree(lambda x: x[0], values)
        assert port.encode(row) == ref.encode(
            jax.tree.map(lambda x: x[0], jax_values))
        # Decoding gives the values back, dict keys sorted.
        decoded = port.decode_batch(blob, count)
        assert list(decoded[1].observation) == ["alpha", "mid", "zeta"]
        for got, want in zip(specs.leaves_of(decoded),
                             specs.leaves_of(values)):
            np.testing.assert_array_equal(got, want)


def test_codec_roundtrip_and_shape_check():
    codec = _Codec({"a": array_spec((3,), np.float32),
                    "b": array_spec((2, 2), np.uint8)})
    value = {"a": np.array([1.0, 2.0, 3.0], np.float32),
             "b": np.arange(4, dtype=np.uint8).reshape(2, 2)}
    raw = codec.encode(value)
    assert len(raw) == codec.nbytes == 3 * 4 + 4
    decoded = codec.decode(raw)
    np.testing.assert_array_equal(decoded["a"], value["a"])
    np.testing.assert_array_equal(decoded["b"], value["b"])
    with pytest.raises(ValueError):
        codec.encode({"a": np.zeros(4, np.float32), "b": value["b"]})


def test_tree_helpers_follow_jax_order():
    tree = (EnvOutput(1, 2, {"b": 3, "a": (4, [5, 6])}, None, 7),
            {"y": 8, "x": 9})
    assert specs.leaves_of(tree) == jax.tree.leaves(tree)
    leaves, structure = specs.flatten(tree)
    rebuilt = specs.unflatten(structure, leaves)
    assert rebuilt == (EnvOutput(1, 2, {"a": (4, [5, 6]), "b": 3}, None, 7),
                       {"x": 9, "y": 8})
    assert specs.map_tree(lambda a, b: a + b, (1, {"k": 2}),
                          (10, {"k": 20})) == (11, {"k": 22})


def test_spec_pickle_and_handshake_refuses_foreign_types():
    spec_tree = (array_spec((), np.int64),
                 _env_output_specs(array_spec((84, 84, 1), np.uint8)))
    blob = pickle.dumps((spec_tree, (array_spec((), np.int32),),
                         {"unroll_length": 5}))
    assert specs.loads_handshake(blob) == (
        spec_tree, (array_spec((), np.int32),), {"unroll_length": 5})
    assert spec_tree[1].observation == ArraySpec((84, 84, 1), "uint8")
    with pytest.raises(pickle.UnpicklingError, match="foreign type"):
        specs.loads_handshake(pickle.dumps(np.zeros(2)))


def test_batcher_builds_into_the_build_directory():
    path = inference_server.build()
    assert path.exists()
    assert path.parent == inference_server.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert path.parent.parent.parent == inference_server.SOURCE.parents[2]
    assert inference_server.SOURCE.parent.name == "csrc"


def _make_server(batch_size, handlers=None, flush_timeout_ms=100):
    spec = array_spec((2,), np.float32)
    if handlers is None:
        handlers = [lambda env_ids, x: x * 2.0]
    return InferenceServer(handlers, spec, spec, batch_size=batch_size,
                           flush_timeout_ms=flush_timeout_ms)


def test_full_batch_correctness_many_threads():
    server = _make_server(8)
    results = {}

    def worker(i):
        results[i] = server.inference(i, np.array([i, i + 0.5], np.float32))

    try:
        _run_threads(worker, 32)
        assert len(results) == 32
        for i in range(32):
            np.testing.assert_allclose(results[i], [2 * i, 2 * i + 1.0],
                                       rtol=1e-6)
        assert server.stats["total_requests"] == 32
        # 32 requests at batch 8 -> exactly 4 full batches.
        assert server.stats["total_batches"] == 4
    finally:
        server.shutdown()


def test_partial_batch_flush():
    server = _make_server(8, flush_timeout_ms=50)
    out = []

    def worker(i):
        out.append((i, server.inference(i, np.array([i, i], np.float32))))

    try:
        start = time.time()
        # 3 requests < batch 8: only the flush timeout completes them.
        _run_threads(worker, 3)
        assert len(out) == 3
        assert time.time() - start < 5
        for i, res in out:
            np.testing.assert_allclose(res, [2 * i, 2 * i])
    finally:
        server.shutdown()


def test_round_robin_over_handlers():
    calls = []

    def make_handler(tag):
        def handler(env_ids, x):
            calls.append(tag)
            return x + float(tag)
        return handler

    server = _make_server(4, handlers=[make_handler(0), make_handler(1)],
                          flush_timeout_ms=-1)
    results = {}

    def worker(i):
        results[i] = server.inference(i, np.zeros(2, np.float32))

    try:
        _run_threads(worker, 8)
        assert sorted(calls) == [0, 1]
        offsets = sorted(float(v[0]) for v in results.values())
        assert offsets.count(0.0) == 4 and offsets.count(1.0) == 4
    finally:
        server.shutdown()


def test_shutdown_unblocks_half_filled_batch():
    server = _make_server(8, flush_timeout_ms=-1)
    errors = []

    def worker(i):
        try:
            server.inference(i, np.zeros(2, np.float32))
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    server.shutdown()
    _join(threads)
    assert len(errors) == 3
    assert all("shut down" in e for e in errors)


def test_handler_sees_env_ids():
    seen = []

    def handler(env_ids, x):
        seen.extend(env_ids.tolist())
        return x

    server = _make_server(4, handlers=[handler], flush_timeout_ms=-1)
    try:
        _run_threads(lambda i: server.inference(100 + i,
                                                np.zeros(2, np.float32)), 4)
        assert sorted(seen) == [100, 101, 102, 103]
    finally:
        server.shutdown()


def test_handler_error_propagates_to_all_blocked_callers():
    """A crashing policy raises in every blocked inference() call, and the
    server goes on serving (the reference's cancellation semantics,
    grpc.cc:381-397)."""
    fail_first = [True]

    def handler(env_ids, x):
        if fail_first[0]:
            fail_first[0] = False
            raise ValueError("policy exploded")
        return x * 2.0

    server = _make_server(4, handlers=[handler], flush_timeout_ms=-1)
    errors, ok = [], []

    def worker(i):
        try:
            ok.append(server.inference(i, np.zeros(2, np.float32)))
        except RuntimeError as e:
            errors.append(str(e))

    results = {}

    def worker2(i):
        results[i] = server.inference(i, np.array([i, i], np.float32))

    try:
        _run_threads(worker, 4)
        assert len(errors) == 4 and not ok
        assert all("policy exploded" in e for e in errors)
        _run_threads(worker2, 4)
        assert len(results) == 4
        for i in range(4):
            np.testing.assert_allclose(results[i], [2.0 * i, 2.0 * i])
    finally:
        server.shutdown()


def test_sustained_throughput_multiple_rounds():
    """Many rounds per thread: buffer recycling."""
    server = _make_server(4, flush_timeout_ms=100)
    n_threads, rounds = 8, 25
    failures = []

    def worker(i):
        try:
            for r in range(rounds):
                res = server.inference(i, np.array([i, r], np.float32))
                np.testing.assert_allclose(res, [2.0 * i, 2.0 * r])
        except Exception as e:  # reported below
            failures.append(e)

    try:
        _run_threads(worker, n_threads)
        assert not failures, failures
        assert server.stats["total_requests"] == n_threads * rounds
    finally:
        server.shutdown()


@pytest.mark.parametrize("requests", [1, 2])
def test_batch_after_a_late_recycle_is_run(requests):
    """C5: batch A's callers recycle A only after batch B has filled, run
    and been recycled (held by the batcher's test hook). The filling buffer
    is then B again while A, the next in ring order, is empty. A partial
    batch in B must still be flushed (requests=1) and a full one run
    (requests=2); a runner that waited on A alone stranded both."""
    server = _make_server(2, flush_timeout_ms=50)
    lib, handle = server._lib, server._handle
    results = {}

    def worker(i):
        results[i] = server.inference(i, np.array([i, i], np.float32))

    def start(ids):
        threads = [threading.Thread(target=worker, args=(i,)) for i in ids]
        for t in threads:
            t.start()
        return threads

    try:
        assert lib.batcher_test_hold(handle, 0, 1) == 0
        batch_a = start([0, 1])
        deadline = time.time() + JOIN_S
        while server.stats["total_batches"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert server.stats["total_batches"] == 1
        _join(start([2, 3]))  # batch B: filled, run and recycled
        assert all(t.is_alive() for t in batch_a)  # A's callers still held
        assert lib.batcher_test_hold(handle, 0, 0) == 0
        _join(batch_a)
        _join(start(range(4, 4 + requests)), timeout=5)
        assert sorted(results) == list(range(4 + requests))
        for i, res in results.items():
            np.testing.assert_allclose(res, [2.0 * i, 2.0 * i])
        assert server.stats["total_batches"] == 3
    finally:
        server.shutdown()
