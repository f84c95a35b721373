"""RecordIO in the port (paddle_tpu_torch.recordio over its own copy of
native/recordio.cc): the JAX package's tests/test_recordio.py run against
the port, the library built where it belongs, and the two packages' files
held to each other: the same samples give byte-identical files, and each
package reads what the other wrote."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import os

import numpy as np
import pytest

from paddle_tpu import recordio as jax_recordio
from paddle_tpu_torch import recordio
from paddle_tpu_torch.reader import creator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_roundtrip_plain(tmp_path):
    path = str(tmp_path / "plain.recordio")
    recs = [os.urandom(n) for n in (1, 10, 1000, 65536)]
    with recordio.RecordIOWriter(path, compressor="none") as w:
        for r in recs:
            w.write(r)
    assert list(recordio.RecordIOScanner(path)) == recs


def test_roundtrip_compressed_many_chunks(tmp_path):
    path = str(tmp_path / "z.recordio")
    rng = np.random.RandomState(0)
    # > 1 MiB in all: several chunks
    recs = [rng.randint(0, 10, 65536).astype(np.uint8).tobytes()
            for _ in range(32)]
    with recordio.RecordIOWriter(path, compressor="snappy") as w:
        for r in recs:
            w.write(r)
    assert list(recordio.RecordIOScanner(path)) == recs


def test_sample_pickle_roundtrip(tmp_path):
    path = str(tmp_path / "samples.recordio")
    samples = [(np.arange(4, dtype=np.float32), i) for i in range(100)]
    recordio.write_samples(path, samples)
    out = list(recordio.read_samples(path))
    assert len(out) == 100
    np.testing.assert_array_equal(out[7][0], samples[7][0])
    assert out[7][1] == 7


def test_crc_detects_corruption(tmp_path):
    path = str(tmp_path / "c.recordio")
    recordio.write_samples(path, [b"x" * 1000])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        list(recordio.RecordIOScanner(path))


def test_truncated_file_raises(tmp_path):
    path = str(tmp_path / "t.recordio")
    recordio.write_samples(path, [np.zeros(100, np.float32)] * 3,
                           compressor="none")
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-7])
    with pytest.raises(IOError):
        list(recordio.read_samples(path))


def test_highly_compressible_chunk_not_flagged_corrupt(tmp_path):
    """zlib reaches ~1030:1 on redundant data; the corruption guard's cap
    (1200) stays above it."""
    path = str(tmp_path / "zeros.recordio")
    payload = b"\x00" * (1 << 20)
    w = recordio.RecordIOWriter(path)
    w.write(payload)
    w.close()
    got = list(recordio.RecordIOScanner(path))
    assert len(got) == 1 and got[0] == payload


def test_library_is_built_under_build_native():
    recordio._load()
    lib = recordio.library_path()
    assert lib.exists()
    assert lib.parent == recordio.BUILD_DIR
    assert os.path.relpath(lib, REPO).startswith(os.path.join("build",
                                                              "native"))


def _samples(seed, n=40):
    rng = np.random.RandomState(seed)
    return [(rng.rand(3, 5).astype(np.float32),
             np.array([rng.randint(0, 10)], np.int64), f"row{i}")
            for i in range(n)]


@pytest.mark.parametrize("compressor", ["snappy", "none"])
def test_files_are_byte_identical_across_packages(tmp_path, compressor):
    samples = _samples(1)
    a, b = str(tmp_path / "port.recordio"), str(tmp_path / "jax.recordio")
    recordio.write_samples(a, samples, compressor)
    jax_recordio.write_samples(b, samples, compressor)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    samples = _samples(2)
    path = str(tmp_path / f"{writer}.recordio")
    (recordio if writer == "port" else jax_recordio).write_samples(
        path, samples)
    for reader in (recordio, jax_recordio):
        got = list(reader.read_samples(path))
        assert len(got) == len(samples)
        for (x, y, s), (gx, gy, gs) in zip(samples, got):
            np.testing.assert_array_equal(gx, x)
            np.testing.assert_array_equal(gy, y)
            assert gs == s
    raw = list(recordio.RecordIOScanner(path))
    assert raw == list(jax_recordio.RecordIOScanner(path))


def test_creator_recordio_raw_and_decoded(tmp_path):
    paths = []
    for i in range(2):
        p = str(tmp_path / f"part{i}.recordio")
        recordio.write_samples(p, _samples(10 + i, n=5))
        paths.append(p)
    decoded = list(creator.recordio(",".join(paths), decode=True)())
    want = _samples(10, n=5) + _samples(11, n=5)
    assert [s for _, _, s in decoded] == [s for _, _, s in want]
    raw = list(creator.recordio(paths)())
    assert raw == [r for p in paths for r in recordio.RecordIOScanner(p)]


def test_convert_reader_to_recordio_file(tmp_path):
    path = str(tmp_path / "conv.recordio")
    samples = _samples(3, n=6)
    assert recordio.convert_reader_to_recordio_file(
        path, lambda: iter(samples)) == path
    assert [s for _, _, s in recordio.read_samples(path)] == \
        [s for _, _, s in samples]
