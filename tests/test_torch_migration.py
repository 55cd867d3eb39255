"""The port's shard migration (``dsml_tpu_torch/comm/migration.py``) over
real gRPC streams between two device servers on the CPU, case for case
against the JAX package's ``tests/test_migration.py``: the round trip bit
for bit, a dropped stream resuming from its offset, persistent corruption
raising ``MigrationError`` with no byte landed, a transient corruption
retried to success, version refusal, dtype and shape refusal, the staging
allocator; and each package's migrator pulling from the other's donor.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dsml_tpu.comm import device_server as jds
from dsml_tpu.comm import migration as jmig
from dsml_tpu.runtime import chaos as jchaos
from dsml_tpu_torch import obs
from dsml_tpu_torch.comm import migration as tmig
from dsml_tpu_torch.comm.device_server import DeviceError, DeviceRuntime, StreamState, serve_device
from dsml_tpu_torch.comm.migration import (
    MigrationConfig,
    MigrationError,
    ShardMigrator,
    StateDonor,
    payload_chunk_crcs,
    tree_path_str,
)
from dsml_tpu_torch.runtime import chaos


@pytest.fixture()
def two_servers():
    recv = serve_device(201, mem_size=0x200000, device="cpu")
    donor = serve_device(202, mem_size=0x200000, device="cpu")
    peers = {0: recv.address, 1: donor.address}
    recv.runtime.configure_peers(peers, 0)
    donor.runtime.configure_peers(peers, 1)
    try:
        yield recv, donor
    finally:
        chaos.set_wire_fault_plan(None)
        recv.stop()
        donor.stop()


def _migrator(recv, donor, **cfg_kw) -> ShardMigrator:
    cfg_kw.setdefault("timeout_s", 10.0)
    return ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                         config=MigrationConfig(**cfg_kw), local_address=recv.address)


def test_fetch_piece_round_trip_bit_exact(two_servers):
    recv, donor = two_servers
    arr = np.arange(48_000, dtype=np.float32).reshape(120, 400)
    donor.runtime.donor.register_array("params/w", arr)
    donor.runtime.donor.register_array("params/b", torch.arange(10, dtype=torch.bfloat16))
    mig = _migrator(recv, donor)
    got = mig.fetch_piece("params/w", ((30, 90), (100, 300)), "float32")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), arr[30:90, 100:300])
    assert mig.stats["pieces"] == 1 and mig.stats["bytes"] == 60 * 200 * 4
    b = mig.fetch_piece("params/b", ((2, 7),), torch.bfloat16)
    assert torch.equal(b, torch.arange(2, 7, dtype=torch.bfloat16))
    mig.close()


def test_dropped_stream_resumes_from_offset(two_servers):
    """One dropped StreamSend (``drop@1``): the delivered prefix is
    harvested and only the rest re-ships — the same bits, resumed."""
    recv, donor = two_servers
    arr = np.arange(200_000, dtype=np.float32)
    donor.runtime.donor.register_array("w", arr)
    chaos.set_wire_fault_plan(chaos.WireFaultPlan.parse("drop@1"))
    mig = _migrator(recv, donor)
    np.testing.assert_array_equal(mig.fetch_piece("w", ((0, 200_000),), "float32").numpy(), arr)
    assert mig.stats["resumed"] == 1 and mig.stats["integrity_failures"] == 0
    assert chaos.wire_fault_plan().fired[0]["action"] == "drop"
    mig.close()


def test_corrupt_chunk_fires_crc_and_aborts(two_servers):
    """``corrupt@*``: every attempt fails frame validation and the piece is
    undeliverable; no corrupt byte reaches the caller."""
    recv, donor = two_servers
    donor.runtime.donor.register_array("w", np.arange(10_000, dtype=np.float32))
    chaos.set_wire_fault_plan(chaos.WireFaultPlan.parse("corrupt@*"))
    obs.enable(forensics=False)
    try:
        counter = obs.get_registry().counter("comm_stream_integrity_failures_total",
                                             "comm stream integrity failures total")
        before = counter.value()
        mig = _migrator(recv, donor, retries=1)
        with pytest.raises(MigrationError, match="CRC32C mismatch"):
            mig.fetch_piece("w", ((0, 10_000),), "float32")
        assert mig.stats["integrity_failures"] == 2  # one attempt + one retry
        assert counter.value() - before == 2
        mig.close()
    finally:
        obs.disable()


def test_transient_corruption_retries_to_success(two_servers):
    recv, donor = two_servers
    arr = np.arange(5_000, dtype=np.float32)
    donor.runtime.donor.register_array("w", arr)
    chaos.set_wire_fault_plan(chaos.WireFaultPlan.parse("corrupt@1"))
    mig = _migrator(recv, donor, retries=2)
    np.testing.assert_array_equal(mig.fetch_piece("w", ((0, 5_000),), "float32").numpy(), arr)
    assert mig.stats["integrity_failures"] == 1 and mig.stats["retries"] == 1
    mig.close()


def test_version_refusal_and_reset_donors(two_servers):
    recv, donor = two_servers
    arr = np.arange(64, dtype=np.float32)
    donor.runtime.donor.register_array("w", arr)
    donor.runtime.donor.version = 7
    stale = ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                          config=MigrationConfig(timeout_s=10.0), local_address=recv.address,
                          expect_version=8)
    with pytest.raises(MigrationError, match="no live donor"):
        stale.fetch_piece("w", ((0, 64),), "float32")
    stale.close()
    fresh = _migrator(recv, donor)
    fresh.expect_version = 7
    fresh._donors[0].alive = False
    with pytest.raises(MigrationError, match="no live donor"):
        fresh.fetch_piece("w", ((0, 64),), "float32")
    fresh.reset_donors()
    np.testing.assert_array_equal(fresh.fetch_piece("w", ((0, 64),), "float32").numpy(), arr)
    fresh.close()


def test_unknown_key_dead_donor_and_dtype_mismatch_raise(two_servers):
    recv, donor = two_servers
    donor.runtime.donor.register_array("w", np.arange(64, dtype=np.float64))
    mig = _migrator(recv, donor, retries=0)
    with pytest.raises(MigrationError, match="no live donor"):
        mig.fetch_piece("nope/missing", ((0, 1),), "float32")
    with pytest.raises(MigrationError, match="expected float32"):
        mig.fetch_piece("w", ((0, 64),), "float32")
    mig.close()
    dead = ShardMigrator(recv.runtime, 0, [(1, "127.0.0.1:1")],
                         config=MigrationConfig(timeout_s=2.0, retries=0),
                         local_address=recv.address)
    with pytest.raises(MigrationError, match="no live donor"):
        dead.fetch_piece("w", ((0, 1),), "float32")
    dead.close()


def test_stage_allocator_never_clobbers_inflight_sends():
    handle = serve_device(209, mem_size=0x1000, device="cpu")  # staging half = 0x800
    try:
        donor = handle.runtime.donor
        addr, token = donor._stage(0x700)
        with pytest.raises(DeviceError, match="in-flight") as err:
            donor._stage(0x700)
        assert err.value.code == "RESOURCE_EXHAUSTED"
        handle.runtime.streams[12345] = StreamState(12345)
        donor._commit_stage(token, 12345)
        with pytest.raises(DeviceError, match="in-flight"):
            donor._stage(0x700)
        with pytest.raises(DeviceError, match="exceeds the staging area"):
            donor._stage(0x2000)
        handle.runtime.streams[12345].status = 2  # FAILED
        assert donor._stage(0x700)[0] == addr
    finally:
        handle.stop()


def test_register_state_keys_frames_and_from_comm_equal_jax():
    tree = {"w": np.ones((2, 3), np.float32), "layers": [{"b": np.zeros(4, np.float32)}],
            "none": None}
    jd = jmig.StateDonor(jds.DeviceRuntime(401, mem_size=0x10000))
    td = StateDonor(DeviceRuntime(402, mem_size=0x10000, device="cpu"))
    assert td.register_state(tree, version=3) == jd.register_state(tree, version=3) == 2
    assert td.keys() == jd.keys() == ["state/layers/0/b", "state/w"]
    assert td.plan(td.keys() + ["x"]) == jd.plan(jd.keys() + ["x"])
    assert tree_path_str("p", ("a", 0, "b")) == "p/a/0/b"
    blob = np.random.default_rng(0).integers(0, 256, 600_000, dtype=np.uint8).tobytes()
    assert payload_chunk_crcs(blob) == jmig.payload_chunk_crcs(blob)
    members = [(0, 401, "a:1"), (1, 402, "b:2"), (2, 403, "c:3")]
    mig = ShardMigrator.from_comm(members, td.runtime,
                                  config=MigrationConfig(timeout_s=1.0))
    assert mig.self_rank == 1 and [(d.rank, d.address) for d in mig._donors] == \
        [(0, "a:1"), (2, "c:3")]
    mig.close()


@pytest.mark.parametrize("direction", ["port_pulls_from_jax", "jax_pulls_from_port"])
def test_each_packages_migrator_pulls_from_the_others_donor(devices8, direction):
    """The control JSON, dtype names, frames and streams are one protocol:
    a migration crosses the packages both ways, also under ``drop@1``."""
    if direction == "port_pulls_from_jax":
        recv = serve_device(211, mem_size=0x400000, device="cpu")
        donor = jds.serve_device(212, mem_size=0x400000, jax_device=devices8[0])
        plan_mod, mig_mod = jchaos, tmig
    else:
        recv = jds.serve_device(213, mem_size=0x400000, jax_device=devices8[0])
        donor = serve_device(214, mem_size=0x400000, device="cpu")
        plan_mod, mig_mod = chaos, jmig
    peers = {0: recv.address, 1: donor.address}
    recv.runtime.configure_peers(peers, 0)
    donor.runtime.configure_peers(peers, 1)
    arr = np.random.default_rng(1).standard_normal((300, 300)).astype(np.float32)
    donor.runtime.donor.register_array("w", arr)
    try:
        plan_mod.set_wire_fault_plan(plan_mod.WireFaultPlan.parse("drop@1"))
        mig = mig_mod.ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                                    config=mig_mod.MigrationConfig(timeout_s=10.0),
                                    local_address=recv.address)
        got = mig.fetch_piece("w", ((0, 300), (0, 300)), "float32")
        np.testing.assert_array_equal(np.asarray(got), arr)
        assert mig.stats["resumed"] == 1
        mig.close()
    finally:
        plan_mod.set_wire_fault_plan(None)
        recv.stop()
        donor.stop()
