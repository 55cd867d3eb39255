"""The port's native host runtime (``dsml_tpu_torch/runtime/native.py`` and
its own ``native/dsml_runtime.cc``) against the JAX package's
``runtime.native``, and its users (``utils/crc32c.py``,
``utils/data.py``).

Every function is held bit for bit: the same inputs, made from a seed
with numpy, through both libraries (and through the port's plain Python
versions). The port's library is built from its own source under
``build/native/``, and a failed build raises with the compiler's output.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import pytest

from dsml_tpu.runtime import native as jnative
from dsml_tpu.utils import data as jdata
from dsml_tpu_torch.runtime import native as tnative
from dsml_tpu_torch.utils import crc32c as tcrc
from dsml_tpu_torch.utils import data as tdata

MNIST = "data/mnist"


def test_library_is_built_from_the_ports_own_source():
    lib = tnative.load()
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert tnative.SOURCE.parent.parent.name == "runtime"
    assert "dsml_tpu_torch" in str(tnative.SOURCE)
    for name in ("ds_crc32c", "ds_reduce_f32", "ds_idx_parse", "ds_prefetch_next",
                 "ds_ring_plan", "ds_arena_new", "ds_stream_push"):
        assert hasattr(lib, name)
    # the port's copy is the JAX source's C code (only its header comments differ)
    jsrc = open(os.path.join(os.path.dirname(jnative.__file__), "native",
                             "dsml_runtime.cc")).read()
    tsrc = tnative.SOURCE.read_text()
    assert jsrc[jsrc.index("#include <atomic>"):] == tsrc[tsrc.index("#include <atomic>"):] \
        .replace("// frame checksum of the P2P shard-migration path (comm/migration.py)\n"
                 "// and of the serving handoff codec (serving/handoff.py).",
                 "// frame checksum of the P2P shard-migration path (comm/migration.py).") \
        .replace("// utils/crc32c.py is bit-identical", "// runtime/native.py is bit-identical")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "dsml_runtime.cc"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed on dsml_runtime.cc") as err:
        tnative.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("op", [0, 1, 2, 3, 4])
def test_reduce_f32_every_op_bit_equal_jax(op):
    rng = np.random.default_rng(op)
    for n_rows in (1, 2, 3, 4):
        rows = rng.standard_normal((n_rows, 1001)).astype(np.float32)
        if op == 1:
            rows = rows * np.float32(0.5) + np.float32(1.0)
        want = jnative.reduce_f32(rows, op)
        got = tnative.reduce_f32(rows, op)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(tnative.reduce_f32_py(rows, op).view(np.uint32),
                                      want.view(np.uint32))
    with pytest.raises(ValueError, match="status 3"):
        tnative.reduce_f32(np.zeros((2, 4), np.float32), 9)


def test_crc32c_rfc3720_vectors_and_rolling_equal_jax():
    # RFC 3720 appendix B.4, plus the classic check value
    vectors = [
        (bytes(32), 0x8A9136AA),
        (b"\xff" * 32, 0x62A8AB43),
        (bytes(range(32)), 0x46DD794E),
        (bytes(range(31, -1, -1)), 0x113FDB5C),
        (b"123456789", 0xE3069283),
        (b"", 0),
    ]
    for data, want in vectors:
        assert tcrc.crc32c(data) == want == jnative.crc32c(data) == tcrc.crc32c_py(data)
    blob = np.random.default_rng(0).integers(0, 256, 700_001, dtype=np.uint8).tobytes()
    rolled = 0
    for off in range(0, len(blob), 65_537):
        rolled = tcrc.crc32c(blob[off:off + 65_537], rolled)
    assert rolled == tcrc.crc32c(blob) == jnative.crc32c(blob) == tcrc.crc32c_py(blob)
    assert tcrc.crc32c(memoryview(blob)[:1000]) == jnative.crc32c(blob[:1000])
    assert tcrc.payload_chunk_crcs(blob) == \
        [jnative.crc32c(blob[o:o + tcrc.MIGRATE_CHUNK])
         for o in range(0, len(blob), tcrc.MIGRATE_CHUNK)]
    tnative.reset_calls()
    tcrc.crc32c(b"abc")
    assert tnative.CALLS["ds_crc32c"] == 1  # the C kernel is the one that ran


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_ring_plan_equal_jax(n):
    for rank in range(n):
        got, want = tnative.ring_plan(n, rank), jnative.ring_plan(n, rank)
        for g, p, w in zip(got, tnative.ring_plan_py(n, rank), want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(p, w)
    for bad in ((1, 0), (n, n), (n, -1)):
        with pytest.raises(ValueError):
            tnative.ring_plan(*bad)


def test_idx_parse_equal_jax_and_the_plain_parser():
    for name in ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"):
        with gzip.open(os.path.join(MNIST, name), "rb") as f:
            blob = f.read()
        got, dims = tnative.idx_parse(blob)
        want, jdims = jnative.idx_parse(blob)
        assert dims == jdims and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tdata._parse_idx_py(blob), want)
        np.testing.assert_array_equal(tdata._read_idx(os.path.join(MNIST, name)),
                                      jdata._read_idx(os.path.join(MNIST, name)))
    for garbage in (b"", b"\x00\x00\x08\x03", b"\x00\x00\x08\x03" + bytes(12),
                    b"\x00\x00\x09\x99" + bytes(20)):
        with pytest.raises(ValueError):  # a zero-count header passes the C parser,
            tnative.idx_parse(garbage)    # then numpy refuses its empty shape
        with pytest.raises(ValueError):
            jnative.idx_parse(garbage)


def test_prefetcher_batch_order_and_errors_equal_jax():
    rng = np.random.default_rng(3)
    for data in (rng.standard_normal((64, 5, 2)).astype(np.float32),
                 rng.integers(0, 255, (40, 17)).astype(np.uint8)):
        idx = rng.integers(0, data.shape[0], (9, 4)).astype(np.int32)
        got = list(tnative.NativePrefetcher(data, idx, depth=2))
        want = list(jnative.NativePrefetcher(data, idx, depth=2))
        assert len(got) == len(want) == 9
        for g, w, rows in zip(got, want, idx):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, data[rows])
    data = np.arange(30, dtype=np.float32).reshape(10, 3)
    drained = []
    with pytest.raises(IndexError):
        for b in tnative.NativePrefetcher(data, np.asarray([[0, 1], [2, 99]], np.int32)):
            drained.append(b)
    assert len(drained) == 1
    with pytest.raises(ValueError, match="depth"):
        tnative.NativePrefetcher(data, np.zeros((2, 2), np.int32), depth=-1)
    pf = tnative.NativePrefetcher(data, np.zeros((2, 2), np.int32))
    assert len(list(pf)) == 2
    with pytest.raises(RuntimeError, match="single-use"):
        list(pf)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_shard_batches_native_equal_jax(drop_remainder):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50, 7)).astype(np.float32)
    y = rng.integers(0, 5, 50).astype(np.int32)
    tnative.reset_calls()
    got = list(tdata.shard_batches(x, y, 8, seed=3, drop_remainder=drop_remainder, native=True))
    assert tnative.CALLS["ds_prefetch_next"] == 7  # six batches, then the end
    want = list(jdata.shard_batches(x, y, 8, seed=3, drop_remainder=drop_remainder, native=True))
    plain = list(tdata.shard_batches(x, y, 8, seed=3, drop_remainder=drop_remainder))
    assert len(got) == len(want) == len(plain)
    for (xg, yg), (xw, yw), (xp, yp) in zip(got, want, plain):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
        np.testing.assert_array_equal(xg, xp)
        np.testing.assert_array_equal(yg, yp)


def test_arena_and_streams_equal_jax():
    results = []
    for nat in (tnative, jnative):
        a = nat.NativeArena(0x1000, 0x1000)
        s = nat.NativeStreams(a)
        out = [a.write(0x1000, bytes(range(16))), a.write(0x0F00, b"x"),
               a.write(0x1FFE, b"xxxx"), a.write(0xFFFFFFFFFFFFFFF8, b"0123456789abcdef"),
               a.write(0x1000, b"\xff\xff"), a.read(0x1000, 16), a.logical_size(0x1000)]
        s.push(7, b"chunk1")
        s.push(7, b"chunk2")
        out.append(s.status(7))
        s.arm(7, 0x1100, expected=12)
        out += [s.status(7), a.read(0x1100, 12)]
        s.arm(9, 0x1200, expected=100)
        s.push(9, b"short", final=True)
        out += [s.status(9), s.status(12345), s.arm(10, 0x1FF0, 0x100)]
        with pytest.raises(KeyError):
            a.read(0x1F00, 4)
        results.append(out)
    assert results[0] == results[1]
