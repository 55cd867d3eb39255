"""The port's wire (``dsml_tpu_torch/comm``: the device server, the
coordinator, the client; ``ops/collectives.py``'s in-process all-reduces;
``models/mlp.py``'s flat API; ``cli/``'s launchers and wire loop) against
the JAX package's ``comm``.

The same inputs, made from a seed with numpy, go through both packages:

- buffers, splices, stream lifecycles and their errors: the same bytes,
  statuses and status-code names (the port's ``DeviceError.code`` is the
  name of the JAX one's ``grpc.StatusCode``);
- ``forward_flat`` / ``backward_flat`` at rtol 1e-5 (f32 matmuls in two
  libraries);
- the coordinator's AllReduceRing (SUM, AVG) and NaiveAllReduce at n = 2
  and 3 bit for bit against the JAX coordinator with its servers pinned to
  one device (both take the host path through ``ds_reduce_f32``), and the
  device-resident path against the JAX XLA ring on distinct devices;
- ``device_buffers_all_reduce`` / ``make_stacked_all_reduce`` bit for bit
  against the JAX ones on virtual devices at n = 2, 3 and 4;
- each package's client driving the other's servers over real gRPC;
- 5 steps of the wire loop against ``examples/train_mnist_wire.py``'s loop
  on the JAX cluster from the same weights, at atol 1e-5.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import grpc
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dsml_tpu.comm import client as jclient
from dsml_tpu.comm import coordinator as jcoord
from dsml_tpu.comm import device_server as jds
from dsml_tpu.comm.proto import gpu_sim_pb2 as pb
from dsml_tpu.models.mlp import MLP as JMLP
from dsml_tpu.ops import collectives as jcoll
from dsml_tpu.utils import data as jdata
from dsml_tpu_torch.cli import train_mnist_wire as twire
from dsml_tpu_torch.comm import client as tclient
from dsml_tpu_torch.comm import coordinator as tcoord
from dsml_tpu_torch.comm import device_server as tds
from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as tpb
from dsml_tpu_torch.models.convert import mlp_flat_from_jax
from dsml_tpu_torch.models.mlp import MLP as TMLP
from dsml_tpu_torch.ops import collectives as tcoll
from dsml_tpu_torch.utils import data as tdata

FAST = dict(health_interval_s=0.25, probe_timeout_s=0.5, dial_retries=2, dial_backoff_s=0.05)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tiny ops gain nothing from more, and the
    suite's parallel workers would oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _code(e) -> str:
    c = e.code
    return c.name if hasattr(c, "name") else c


def test_proto_is_the_jax_proto_byte_for_byte():
    here = os.path.dirname(tpb.__file__)
    there = os.path.dirname(pb.__file__)
    for name in ("gpu_sim.proto", "gpu_sim_pb2.py"):
        with open(os.path.join(here, name), "rb") as a, open(os.path.join(there, name), "rb") as b:
            assert a.read() == b.read(), name
    assert tpb.MemcpyRequest is pb.MemcpyRequest  # one descriptor pool entry


# ---------------------------------------------------------------------------
# the device runtime against the JAX one
# ---------------------------------------------------------------------------


@pytest.fixture
def pair(devices8):
    """(port runtime on the CPU, JAX runtime on a virtual device)."""
    return (tds.DeviceRuntime(1, mem_size=0x300000, device="cpu"),
            jds.DeviceRuntime(1, mem_size=0x300000, jax_device=devices8[0]))


def _outcomes(rt, ops):
    out = []
    for op in ops:
        try:
            out.append(op(rt))
        except (tds.DeviceError, jds.DeviceError) as e:
            out.append(("error", _code(e)))
    return out


def test_buffer_errors_and_splices_equal_jax(pair):
    ops = [
        lambda rt: rt.memcpy_h2d(0x0500, b"x"),                       # below minAddr
        lambda rt: rt.memcpy_h2d(rt.memory.max_addr - 2, b"xxxx"),    # crosses maxAddr
        lambda rt: rt.memcpy_d2h(0x9000, 4),                          # nothing there
        lambda rt: rt.memcpy_h2d(0x1000, b"hello world"),
        lambda rt: rt.memcpy_d2h(0x1000, 5),
        lambda rt: rt.memcpy_d2h(0x1000, 100),                        # past the buffer
        lambda rt: rt.memcpy_h2d(0x2000, bytes(range(16))),
        lambda rt: rt.memcpy_h2d(0x2000, b"\xff\xff\xff\xff"),        # splice
        lambda rt: rt.memcpy_d2h(0x2000, 16),
        lambda rt: rt.memcpy_d2h(0x2000, None),
        lambda rt: rt.memory.logical_nbytes(0x2000),
        lambda rt: rt.memory.logical_nbytes(0x7000),
        lambda rt: rt.memcpy_h2d(0x3000, np.arange(6, dtype=np.float32)),
        lambda rt: rt.memcpy_d2h(0x3000, 24),
        lambda rt: rt.begin_send(0x0100, 4, 0),
        lambda rt: rt.begin_receive(5, rt.memory.max_addr, 4, 0),
        lambda rt: rt.stream_status(424242),
        lambda rt: rt.take_partial(424242),
        lambda rt: rt.run_backward(0x1000),
        lambda rt: bytes(rt.metadata().SerializeToString()),
    ]
    t, j = pair
    assert _outcomes(t, ops) == _outcomes(j, ops)
    buf = t.memory.get_array(0x2000)
    assert buf.dtype == torch.uint8 and buf.device.type == "cpu" and buf.numel() == 16


def _wait_status(rt, sid, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and rt.stream_status(sid) == tds.IN_PROGRESS:
        time.sleep(0.01)
    return rt.stream_status(sid)


def _reassembly(rt):
    rt.begin_receive(12345, 0x2000, num_bytes=12, src_rank=0)
    ok = rt.receive_chunks(iter([pb.DataChunk(data=b"chunk1", streamId=12345),
                                 pb.DataChunk(data=b"chunk2", streamId=12345)]))
    return ok, rt.stream_status(12345), rt.memcpy_d2h(0x2000, 12)


def _wrong_length(rt):
    rt.begin_receive(99, 0x2000, num_bytes=100, src_rank=0)
    return rt.receive_chunks(iter([pb.DataChunk(data=b"short", streamId=99)])), \
        rt.stream_status(99)


def _chunks_before_arm(rt):
    ok = rt.receive_chunks(iter([pb.DataChunk(data=b"abcd", streamId=7)]))
    before = rt.stream_status(7)
    rt.begin_receive(7, 0x2000, num_bytes=4, src_rank=1)
    return ok, before, rt.stream_status(7), rt.memcpy_d2h(0x2000, 4)


def _late_arm_underdelivery(rt):
    rt.receive_chunks(iter([pb.DataChunk(data=b"abcd", streamId=9)]))
    rt.begin_receive(9, 0x2000, num_bytes=8, src_rank=1)
    return rt.stream_status(9)


def _self_send_waits_for_arm(rt):
    rt.configure_peers({0: "unused"}, self_rank=0)
    rt.memcpy_h2d(0x1000, b"ringring")
    sid = rt.begin_send(0x1000, 8, dst_rank=0)
    time.sleep(0.2)
    before = rt.stream_status(sid)
    rt.begin_receive(sid, 0x2000, 8, src_rank=0)
    return before, _wait_status(rt, sid), rt.memcpy_d2h(0x2000, 8)


def _self_send_late_arm_underdelivery(rt):
    rt.configure_peers({0: "local"}, self_rank=0)
    rt.memcpy_h2d(0x1000, b"abcd")
    sid = rt.begin_send(0x1000, 4, dst_rank=0)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not rt.streams[sid].sender_done:
        time.sleep(0.01)
    rt.begin_receive(sid, 0x2000, num_bytes=8, src_rank=0)
    return rt.stream_status(sid)


def _late_delivery_on_terminal_stream(rt):
    rt.memory.write(0x1000, b"N" * 8)
    rt.begin_receive(999_003, 0x1000, 8, 1)
    harvested = rt.take_partial(999_003)

    class _Chunk:
        streamId = 999_003
        data = b"STALEOLD"

    rt.receive_chunks([_Chunk()])
    st = rt.streams[999_003]
    return harvested, st.status, st.armed, rt.read_bytes(0x1000, 8)


def _partial_harvest(rt):
    rt.begin_receive(999_002, 0x1000, 100, 1)
    with rt._stream_lock:
        st = rt.streams[999_002]
        st.chunks.append(b"abc")
        st.received = 3
    return rt.take_partial(999_002), rt.stream_status(999_002)


@pytest.mark.parametrize("scenario", [
    _reassembly, _wrong_length, _chunks_before_arm, _late_arm_underdelivery,
    _self_send_waits_for_arm, _self_send_late_arm_underdelivery,
    _late_delivery_on_terminal_stream, _partial_harvest,
], ids=lambda f: f.__name__.strip("_"))
def test_stream_lifecycle_equals_jax(pair, scenario):
    t, j = pair
    assert scenario(t) == scenario(j)


@pytest.fixture
def two_servers():
    recv = tds.serve_device(201, mem_size=0x200000, device="cpu")
    donor = tds.serve_device(202, mem_size=0x200000, device="cpu")
    peers = {0: recv.address, 1: donor.address}
    recv.runtime.configure_peers(peers, 0)
    donor.runtime.configure_peers(peers, 1)
    yield recv.runtime, donor.runtime
    recv.stop()
    donor.stop()


def test_stream_ttl_gc_stall_verdict_and_recycled_ids(two_servers, monkeypatch):
    from dsml_tpu_torch import obs

    recv, donor = two_servers
    obs.enable(forensics=False)
    try:
        fails = obs.get_registry().counter("comm_stream_failures_total",
                                           "P2P streams that ended FAILED", labels=("device",))
        before = fails.value(device=201)
        donor.memory.write(0x1000, b"x" * 64)
        sid = donor.begin_send(0x1000, 64, 0)
        recv.begin_receive(sid, 0x1000, 64, 1)
        assert _wait_status(recv, sid) == tds.SUCCESS
        assert _wait_status(donor, sid) == tds.SUCCESS
        sid2 = donor.begin_send(0x1000, 64, 0)
        recv.begin_receive(sid2, 0x1000, 32, 1)  # armed short
        assert _wait_status(recv, sid2) == tds.FAILED
        assert fails.value(device=201) == before + 1
        # a restarted sender reuses a terminal id: a fresh stream
        recv.begin_receive(sid, 0x1100, 32, 1)
        st = recv.streams[sid]
        assert st.status == tds.IN_PROGRESS and st.received == 0 and st.recv_addr == 0x1100
        # the stall verdict: no progress past DSML_STREAM_STALL_S is FAILED
        monkeypatch.setenv("DSML_STREAM_STALL_S", "0.01")
        time.sleep(0.05)
        assert recv.stream_status(sid) == tds.FAILED
        assert "stalled" in recv.streams[sid].fail_reason
        # TTL eviction of terminal entries
        monkeypatch.setenv("DSML_STREAM_TTL_S", "0.01")
        time.sleep(0.05)
        recv._gc_streams()
        assert sid not in recv.streams and sid2 not in recv.streams
        assert obs.get_registry().gauge("comm_streams_active", "P2P streams not yet terminal",
                                        labels=("device",)).value(device=201) == 0
    finally:
        obs.disable()


# ---------------------------------------------------------------------------
# the MLP's flat API and the on-device compute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(8, 16, 4), (784, 128, 64, 10)])
def test_forward_and_backward_flat_equal_jax(sizes):
    jm, tm = JMLP(sizes), TMLP(sizes, device="cpu")
    params = jax.tree.map(np.asarray, jm.init(0))
    flat = mlp_flat_from_jax(params, sizes)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jm.flatten(params)))
    assert tm.n_params == jm.n_params == flat.numel()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((21, sizes[0])).astype(np.float32)
    d = rng.standard_normal((21, sizes[-1])).astype(np.float32)
    np.testing.assert_allclose(tm.forward_flat(flat, torch.from_numpy(x)).numpy(),
                               np.asarray(jm.forward_flat(np.asarray(flat), x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.backward_flat(flat, torch.from_numpy(x),
                                                torch.from_numpy(d)).numpy(),
                               np.asarray(jm.backward_flat(np.asarray(flat), x, d)),
                               rtol=1e-5, atol=1e-5)
    for k, v in tm.unflatten(flat).items():
        np.testing.assert_array_equal(v.numpy(), params[k])
    np.testing.assert_array_equal(tm.flatten(tm.unflatten(flat)).numpy(), flat.numpy())


def test_run_forward_and_backward_equal_jax(devices8):
    sizes = (8, 16, 4)
    jm = JMLP(sizes)
    t = tds.DeviceRuntime(2, mem_size=0x400000, device="cpu", model=TMLP(sizes, device="cpu"))
    j = jds.DeviceRuntime(2, mem_size=0x400000, jax_device=devices8[1], model=jm)
    flat = np.asarray(jm.flatten(jm.init(0)), np.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    d = rng.standard_normal((5, 4)).astype(np.float32)
    outs = []
    for rt in (t, j):
        rt.memcpy_h2d(rt.weights_addr, flat.tobytes())
        rt.memcpy_h2d(0x3000, x.tobytes())
        n = rt.run_forward(0x3000, 0x4000)
        logits = np.frombuffer(rt.memcpy_d2h(0x4000, n), np.float32)
        rt.memcpy_h2d(0x5000, d.tobytes())
        rt.run_backward(0x5000)
        grads = np.frombuffer(rt.memcpy_d2h(0x5000, flat.nbytes), np.float32)
        errs = _outcomes(rt, [lambda r: r.memcpy_h2d(0x6000, b"\0" * 12),
                              lambda r: r.run_forward(0x6000, 0x7000),
                              lambda r: r.memcpy_h2d(0x6000, b"\0" * 40),
                              lambda r: r.run_backward(0x6000),
                              lambda r: r.memcpy_h2d(r.weights_addr, b"\0" * 8),
                              lambda r: r.run_forward(0x3000, 0x7000)])
        outs.append((n, logits, grads, errs))
    (tn, tl, tg, te), (jn, jl, jg, je) = outs
    assert tn == jn == 5 * 4 * 4 and te == je
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    assert t.memory.get_array(0x5000).device.type == "cpu"


# ---------------------------------------------------------------------------
# in-process all-reduces against the JAX mesh programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_device_buffers_and_stacked_all_reduce_equal_jax(devices8, n):
    mesh = Mesh(np.array(devices8[:n]), ("dev",))
    rng = np.random.default_rng(n)
    # every algorithm under SUM, AVG and MIN, the ring under PROD and MAX too
    cases = [(alg, op) for alg in ("ring", "ring2", "naive", "xla") for op in (0, 4, 2)]
    for alg, op in cases + [("ring", 1), ("ring", 3)]:
        rows = rng.standard_normal((n, 1003)).astype(np.float32)
        if op == 1:
            rows = rows * np.float32(0.5) + np.float32(1.0)
        want = jcoll.device_buffers_all_reduce(
            [jax.device_put(rows[i].view(np.uint8), devices8[i]) for i in range(n)],
            mesh, op, alg, "float32")
        got = tcoll.device_buffers_all_reduce(
            [torch.from_numpy(rows[i].view(np.uint8).copy()) for i in range(n)],
            op, alg, "float32")
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if op in (0, 4) and alg in ("ring", "xla"):
            np.testing.assert_array_equal(
                tcoll.make_stacked_all_reduce(["cpu"] * n, op, alg)(rows.copy()).numpy(),
                np.asarray(jcoll.make_stacked_all_reduce(mesh, op, alg)(rows.copy())))
    ints = rng.integers(-50, 50, (n, 64)).astype(np.int32)
    got = tcoll.device_buffers_all_reduce(
        [torch.from_numpy(ints[i].view(np.uint8).copy()) for i in range(n)], 0, "ring", "int32")
    np.testing.assert_array_equal(got[0].view(torch.int32).numpy(), ints.sum(0))
    with pytest.raises(ValueError, match="itemsize"):
        tcoll.device_buffers_all_reduce([torch.zeros(6, dtype=torch.uint8)] * n)


# ---------------------------------------------------------------------------
# the coordinator against the JAX one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clusters(devices8):
    """Three device servers and a coordinator in each package; the JAX
    servers pinned to one device (the host reduce path, as the port's on
    one card), plus three JAX servers on distinct devices (the XLA ring)."""
    tsrv = [tds.serve_device(41 + i, mem_size=0x400000, device="cpu") for i in range(3)]
    jsrv = [jds.serve_device(51 + i, mem_size=0x400000, jax_device=devices8[0])
            for i in range(3)]
    jring = [jds.serve_device(61 + i, mem_size=0x400000, jax_device=devices8[i])
             for i in range(3)]
    tc = tcoord.serve_coordinator(config=tcoord.CoordinatorConfig(**FAST))
    jc = jcoord.serve_coordinator(config=jcoord.CoordinatorConfig(**FAST))
    yield {"t": (tsrv, tc), "j": (jsrv, jc), "jring": (jring, jc)}
    tc.stop()
    jc.stop()
    for h in tsrv + jsrv + jring:
        h.stop()


def _comm(cluster, n):
    servers, coord = cluster
    comm = coord.runtime.comm_init(n, [s.address for s in servers[:n]])
    return coord.runtime, comm


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("op", [pb.SUM, pb.AVG])
@pytest.mark.parametrize("algorithm", ["ring", "naive"])
def test_all_reduce_ring_bit_equal_jax(clusters, n, op, algorithm, monkeypatch):
    rng = np.random.default_rng(10 * n + op)
    rows = rng.standard_normal((n, 4099)).astype(np.float32)
    out = {}
    for key in ("t", "j"):
        rt, comm = _comm(clusters[key], n)
        monkeypatch.setattr(rt.config, "ring_algorithm", algorithm)
        for rank, info in enumerate(comm.devices):
            # a longer resident buffer: the reduced prefix splices into it
            rt.memcpy_h2d(info.device_id, 0x1000, rows[rank].tobytes() + b"tail")
            rt.memcpy_h2d(info.device_id, 0x1000, rows[rank].tobytes())
        rt.all_reduce_ring(comm.comm_id, rows[0].nbytes, op)
        out[key] = [rt.memcpy_d2h(info.device_id, 0x1000, rows[0].nbytes + 4)
                    for info in comm.devices]
        rt.comm_destroy(comm.comm_id)
    assert out["t"] == out["j"]
    assert out["t"][0][-4:] == b"tail"


@pytest.mark.parametrize("n", [2, 3])
def test_naive_all_reduce_bit_equal_jax(clusters, n):
    rows = np.random.default_rng(n).standard_normal((n, 256)).astype(np.float32)
    out = {}
    for key in ("t", "j"):
        rt, comm = _comm(clusters[key], n)
        for rank, info in enumerate(comm.devices):
            rt.memcpy_h2d(info.device_id, 0x1000, rows[rank].tobytes())
        _, total_bytes = rt.naive_all_reduce(comm.comm_id, rows[0].nbytes, 0)
        out[key] = (total_bytes, [rt.memcpy_d2h(info.device_id, 0x2000, rows[0].nbytes)
                                  for info in comm.devices])
        rt.comm_destroy(comm.comm_id)
    assert out["t"] == out["j"]


def test_device_resident_path_equals_the_jax_xla_ring(clusters, monkeypatch):
    """Servers of this process on distinct devices reduce in process, in
    the JAX ring's order: against the JAX coordinator's XLA ring over
    servers on distinct virtual devices. (On the CPU every port server is on
    ``cpu``; the test lets the coordinator treat them as distinct.)"""
    rows = np.random.default_rng(7).standard_normal((3, 1000)).astype(np.float32)
    out = {}
    for key in ("t", "jring"):
        rt, comm = _comm(clusters[key], 3)
        if key == "t":
            calls = []
            monkeypatch.setattr(rt, "_comm_devices",
                                lambda c: calls.append(1) or [torch.device("cpu")] * 3)
        for rank, info in enumerate(comm.devices):
            rt.memcpy_h2d(info.device_id, 0x1000, rows[rank].tobytes())
        rt.all_reduce_ring(comm.comm_id, rows[0].nbytes, pb.AVG)
        out[key] = [rt.memcpy_d2h(info.device_id, 0x1000, rows[0].nbytes)
                    for info in comm.devices]
        rt.comm_destroy(comm.comm_id)
    assert calls and out["t"] == out["jring"]


def test_comm_lifecycle_group_ops_and_errors_equal_jax(clusters):
    results = {}
    for key in ("t", "j"):
        servers, coord = clusters[key]
        rt = coord.runtime
        addrs = [s.address for s in servers]
        res = []

        def attempt(fn):
            try:
                return fn()
            except (tds.DeviceError, jds.DeviceError) as e:
                return ("error", _code(e))

        res.append(attempt(lambda: rt.comm_init(3, [addrs[0], "127.0.0.1:1", "127.0.0.1:2"])))
        res.append(attempt(lambda: rt.comm_init(2, addrs)))
        comm = rt.comm_init(3, addrs)
        res.append([m[0] for m in rt.comm_members(comm.comm_id)[1]])
        for rank, info in enumerate(comm.devices):
            rt.memcpy_h2d(info.device_id, 0x1000, np.full(64, rank + 1, np.float32).tobytes())
            rt.memcpy_h2d(info.device_id, 0x3000, np.full(64, 10.0 * rank, np.float32).tobytes())
        rt.group_start(comm.comm_id)
        rt.all_reduce_ring(comm.comm_id, 256, pb.SUM)  # queued until group_end
        res.append(rt.memcpy_d2h(comm.devices[0].device_id, 0x1000, 256))
        res.append(rt.group_end(comm.comm_id))
        res.append(rt.memcpy_d2h(comm.devices[1].device_id, 0x1000, 256))
        rt.all_reduce_ring(comm.comm_id, 256, pb.MAX, {r: 0x3000 for r in range(3)})
        res.append(rt.memcpy_d2h(comm.devices[2].device_id, 0x3000, 256))
        res.append(attempt(lambda: rt.all_reduce_ring(comm.comm_id, 6, pb.SUM)))
        res.append(attempt(lambda: rt.all_reduce_ring(comm.comm_id, 256, pb.SUM, {0: 0x9000})))
        res.append(attempt(lambda: rt.memcpy_d2h(999, 0x1000, 4)))
        for fn in (rt.all_reduce_ring, rt.comm_destroy, rt.group_start, rt.group_end):
            res.append(attempt(lambda fn=fn: fn(12345, *(() if fn != rt.all_reduce_ring
                                                          else (4,)))))
        rt.comm_finalize(comm.comm_id)
        res.append(attempt(lambda: rt.comm_members(comm.comm_id)))
        results[key] = res
    assert results["t"] == results["j"]


def test_health_loop_fails_a_comm_and_elastic_re_ranks():
    servers = [tds.serve_device(71 + i, mem_size=0x10000, device="cpu") for i in range(3)]
    coord = tcoord.serve_coordinator(config=tcoord.CoordinatorConfig(**FAST, elastic=True))
    try:
        client = tclient.PipelineClient.connect(coord.address, [s.address for s in servers])
        feed = coord.runtime.failure_feed()
        servers[1].stop(grace=0)
        assert client.refresh_membership(timeout=10.0, expect_change=True) == 2
        assert client.device_ids == [71, 73]
        assert 72 in feed()
        grads = [np.full(16, 1.0, np.float32), np.full(16, 3.0, np.float32)]
        np.testing.assert_array_equal(client.all_reduce_gradients(grads, op=pb.AVG),
                                      np.full(16, 2.0))
    finally:
        coord.stop()
        for s in servers:
            s.stop()
    rigid = [tds.serve_device(74 + i, mem_size=0x10000, device="cpu") for i in range(2)]
    coord = tcoord.serve_coordinator(config=tcoord.CoordinatorConfig(**FAST))
    try:
        client = tclient.PipelineClient.connect(coord.address, [s.address for s in rigid])
        rigid[1].stop(grace=0)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and client.status() != pb.FAILED:
            time.sleep(0.05)
        with pytest.raises(grpc.RpcError) as e:
            client.all_reduce_ring(4)
        assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    finally:
        coord.stop()
        rigid[0].stop()


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


class _Err(grpc.RpcError):
    def __init__(self, code):
        self._code = code

    def code(self):
        return self._code


def _flaky(n_failures, code=grpc.StatusCode.UNAVAILABLE):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_failures:
            raise _Err(code)
        return "ok"

    return fn, calls


@pytest.mark.parametrize("case", ["transient", "deadline", "real_answer", "bounded"])
def test_call_with_retries_equals_jax(case):
    outcomes = []
    for mod in (tclient, jclient):
        sleeps = []
        n, code, retries = {"transient": (3, grpc.StatusCode.UNAVAILABLE, 4),
                            "deadline": (1, grpc.StatusCode.DEADLINE_EXCEEDED, 2),
                            "real_answer": (5, grpc.StatusCode.NOT_FOUND, 4),
                            "bounded": (100, grpc.StatusCode.UNAVAILABLE, 3)}[case]
        fn, calls = _flaky(n, code)
        try:
            out = mod.call_with_retries("op", fn, retries=retries, rng=lambda: 0.5,
                                        sleep=sleeps.append)
        except grpc.RpcError as e:
            out = e.code()
        outcomes.append((out, calls["n"], sleeps))
    assert outcomes[0] == outcomes[1]


def _grads(n, rng):
    return [rng.standard_normal(5000).astype(np.float32) for _ in range(n)]


def test_each_packages_client_drives_the_others_servers(clusters):
    """Real gRPC across the packages: the JAX client against the port's
    servers and coordinator, the port's client against the JAX ones; the
    same bytes come back as through each package's own client."""
    rng = np.random.default_rng(3)
    grads = _grads(3, rng)
    sizes = (784, 128, 64, 10)
    flat = np.asarray(JMLP(sizes).flatten(JMLP(sizes).init(0)), np.float32)
    x = rng.standard_normal((4, 784)).astype(np.float32)
    d = rng.standard_normal((4, 10)).astype(np.float32)
    out = {}
    for key in ("t", "j"):
        servers, coord = clusters[key]
        addrs = [s.address for s in servers]
        for cmod in (tclient, jclient):
            c = cmod.PipelineClient.connect(coord.address, addrs)
            reduced = c.all_reduce_gradients(grads, op=pb.AVG)
            c.broadcast_weights(flat)
            c.write(1, 0x10000, x)
            nbytes = c.run_forward(1, 0x10000, 0x20000)
            logits = c.read(1, 0x20000, nbytes)
            c.write(1, 0x1000, d)
            c.run_backward(1, 0x1000)
            back = c.read(1, 0x1000, flat.nbytes)
            c.destroy()
            out[key, cmod.__name__] = (reduced.tobytes(), nbytes, logits, back)
    for key in ("t", "j"):
        assert out[key, tclient.__name__] == out[key, jclient.__name__]
    assert out["t", tclient.__name__][0] == out["j", jclient.__name__][0]  # host reduce: bits
    np.testing.assert_allclose(np.frombuffer(out["t", tclient.__name__][2], np.float32),
                               np.frombuffer(out["j", jclient.__name__][2], np.float32),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the wire loop against the JAX example's
# ---------------------------------------------------------------------------


def _jax_example_steps(client, flat, data, steps, lr=0.1, batch=64, n_out=10):
    """``examples/train_mnist_wire.py``'s per-batch loop, verbatim in its
    arithmetic, over a JAX PipelineClient."""
    n_ranks = len(client.devices)
    client.broadcast_weights(flat, jclient.WEIGHTS_ADDR)
    losses = []
    for step, (x, y) in enumerate(jdata.shard_batches(data.train_x, data.train_y, batch, seed=1)):
        if step == steps:
            break
        shard = x.shape[0] // n_ranks
        dlogits_bytes = []
        for r in range(n_ranks):
            client.write(r, 0x10000, x[r * shard:(r + 1) * shard])
            client.run_forward(r, 0x10000, 0x20000)
        for r in range(n_ranks):
            logits = jclient.bytes_to_f32(client.read(r, 0x20000, shard * n_out * 4)) \
                .reshape(shard, n_out)
            ys = y[r * shard:(r + 1) * shard]
            z = logits - logits.max(axis=1, keepdims=True)
            p = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
            losses.append(float(-np.log(p[np.arange(shard), ys] + 1e-12).mean()))
            d = p
            d[np.arange(shard), ys] -= 1.0
            dlogits_bytes.append((d / shard).astype(np.float32))
        for r in range(n_ranks):
            client.write(r, jclient.GRAD_ADDR, dlogits_bytes[r])
            client.run_backward(r, jclient.GRAD_ADDR)
        client.all_reduce_ring(flat.nbytes, op=pb.AVG,
                               mem_addrs={r: jclient.GRAD_ADDR for r in range(n_ranks)})
        grads = jclient.bytes_to_f32(client.read(0, jclient.GRAD_ADDR, flat.nbytes))
        flat = flat - lr * grads
        client.broadcast_weights(flat, jclient.WEIGHTS_ADDR)
    return flat, losses


def test_five_wire_steps_equal_the_jax_example_loop(clusters):
    data = tdata.load_mnist()
    jm = JMLP()
    flat0 = mlp_flat_from_jax(jax.tree.map(np.asarray, jm.init(0))).numpy()
    jservers, jc = clusters["j"]
    jcl = jclient.PipelineClient.connect(jc.address, [s.address for s in jservers])
    want, want_losses = _jax_example_steps(jcl, flat0.copy(), jdata.load_mnist(), 5)
    tservers, tc = clusters["t"]
    tcl = tclient.PipelineClient.connect(tc.address, [s.address for s in tservers])
    steps = []
    got = twire.train_wire(tcl, data, flat0.copy(), steps=5,
                           on_step=lambda s, f, losses: steps.extend(losses))
    assert got["steps"] == 5 and len(steps) == len(want_losses) == 15
    np.testing.assert_allclose(steps, want_losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["flat"], want, rtol=0, atol=1e-5)
    # the same five steps on the runtimes directly: the wire changes no byte
    rt = tc.runtime
    comm = rt.comm_init(3, [s.address for s in tservers])
    local = twire.LocalClient(rt, [s.runtime for s in tservers], comm.comm_id)
    direct = twire.train_wire(local, data, flat0.copy(), steps=5)
    assert direct["flat"].tobytes() == got["flat"].tobytes()
    assert direct["losses"] == got["losses"]


def test_launchers_boot_a_cluster_that_all_reduces(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dsml_tpu_torch.cli.launch_devices", "--num_devices", "2",
             "--base_port", "0", "--device", "cpu", "--mem_size", str(0x10000)],
            stdout=subprocess.PIPE, env=env, text=True))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dsml_tpu_torch.cli.launch_coordinator", "--port", "0"],
            stdout=subprocess.PIPE, env=env, text=True))
        devices = json.loads(procs[0].stdout.readline())["devices"]
        coordinator = json.loads(procs[1].stdout.readline())["coordinator"]
        client = tclient.PipelineClient.connect(coordinator, devices, timeout=30.0)
        grads = [np.full(100, 1.5, np.float32), np.full(100, 2.5, np.float32)]
        np.testing.assert_array_equal(client.all_reduce_gradients(grads), np.full(100, 4.0))
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)


_WITHOUT_GRPC = r'''
import sys
sys.modules["grpc"] = None  # any import of grpc raises ImportError
import numpy as np
from dsml_tpu_torch.comm import coordinator, device_server
from dsml_tpu_torch.models.mlp import MLP
from dsml_tpu_torch.runtime import native

m = MLP(device="cpu").init(0)
rts = []
for i in range(3):
    rt = device_server.DeviceRuntime(11 + i, mem_size=0x400000, device="cpu", model=m)
    rt.bound_address = f"inproc:{11 + i}"
    rt.memcpy_h2d(rt.weights_addr, m.flatten().numpy())
    rt.memcpy_h2d(0x1000, np.full(4, float(i + 1), np.float32))
    rts.append(rt)
co = coordinator.CoordinatorRuntime()
comm = coordinator.Communicator(1, [coordinator.DeviceInfo(r, rt.device_id, rt.bound_address,
                                                           None, None, None)
                                    for r, rt in enumerate(rts)])
native.reset_calls()
co._execute_all_reduce(comm, 16, coordinator.ReduceOp.AVG, {}, "float32")
co.stop()
rts[0].memcpy_h2d(0x10000, np.ones((2, 784), np.float32))
print(np.frombuffer(rts[2].read_bytes(0x1000, 16), np.float32).tolist(),
      native.CALLS["ds_reduce_f32"], rts[0].run_forward(0x10000, 0x20000),
      sys.modules["grpc"] is None)
'''


def test_runtimes_and_the_host_reduce_run_without_grpc():
    """The device and coordinator runtimes import no grpc: with grpc
    unimportable, servers' runtimes in one process take an all-reduce
    through the coordinator's host path (``ds_reduce_f32``) and a
    forward."""
    out = subprocess.run([sys.executable, "-c", _WITHOUT_GRPC], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": os.getcwd()}, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[0] == "[2.0, 2.0, 2.0, 2.0] 1 80 True"
