"""fiesta_tpu_torch's ROS bag reader/writer and LZ4 codec against
fiesta_tpu's (CPU).

``fiesta_tpu_torch/io/rosbag.py`` and ``io/lz4f.py`` are copies of the JAX
package's host modules.  The writers must give byte-identical bags and
frames for the same input (uncompressed, bz2 and lz4), each reader must
read the other's bags to equal messages, and the copies pass the checks
of ``tests/test_rosbag.py`` and ``tests/test_lz4.py``: golden bytes,
corrupt and truncated input, topic picking, reorder watermarks and the
``to-npz`` / ``from-npz`` converter.
"""

import dataclasses
import struct

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from fiesta_tpu.io import lz4f as jlz4f  # noqa: E402
from fiesta_tpu.io import rosbag as jrosbag  # noqa: E402

from fiesta_tpu_torch import run as trun  # noqa: E402
from fiesta_tpu_torch.io import lz4f, replay, rosbag  # noqa: E402

COMPRESSIONS = ("none", "bz2", "lz4")


def _frames(kind, h, w, n_frames):
    """The small preset's scans (``tests/test_rosbag.py:230-244``)."""
    cfg, ph, pw = trun._preset_cfg("small")
    if (h, w) != (ph, pw):
        cfg = dataclasses.replace(
            replay.scale_intrinsics(cfg, h, w, base_height=ph,
                                    base_width=pw),
            max_points_per_scan=h * w)
    _, frames = replay.make_sequence(
        cfg, n_frames=n_frames, n_boxes=4, seed=5, height=h, width=w,
        kind=kind)
    return frames


def _all_types(mod):
    """One message of each supported type, built with ``mod``
    (``tests/test_rosbag.py:101-126``)."""
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(50, 3)).astype(np.float32)
    cloud[3] = np.nan
    depth = rng.uniform(0.5, 4.0, size=(6, 8)).astype(np.float32)
    return [
        (1.0, "/tf", mod.make_transform(1.0, [1, 2, 3], [0.5, 0.5, 0.5, 0.5])),
        (1.1, "/pose", mod.PoseStamped(
            mod.Header(0, 1.1, "world"), np.asarray([4.0, 5.0, 6.0]),
            np.asarray([0.0, 0.0, 0.0, 1.0]))),
        (1.2, "/odom", mod.Odometry(
            mod.Header(0, 1.2, "world"), "base", np.asarray([7.0, 8.0, 9.0]),
            np.asarray([0.0, 1.0, 0.0, 0.0]), np.asarray([0.1, 0.2, 0.3]),
            np.zeros(3))),
        (1.3, "/cloud", mod.make_pointcloud2(1.3, cloud)),
        (1.4, "/depth16", mod.make_depth_image(1.4, depth,
                                               encoding="16UC1")),
        (1.5, "/depth32", mod.make_depth_image(1.5, depth,
                                               encoding="32FC1")),
    ], cloud, depth


def _same_message(a, b):
    """Field-by-field equality of two deserialized messages (numpy fields
    bit for bit, NaN included)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_message(x, y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes(), f.name
        elif isinstance(x, list):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                if dataclasses.is_dataclass(u):
                    _same_message(u, v)
                else:
                    assert u == v, f.name
        else:
            assert x == y, f.name


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_write_bag_byte_identical(tmp_path, compression):
    got, ref = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    rosbag.write_bag(got, _all_types(rosbag)[0], compression=compression)
    jrosbag.write_bag(ref, _all_types(jrosbag)[0], compression=compression)
    assert open(got, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("kind", ["cloud", "depth"])
@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_frames_to_bag_byte_identical(tmp_path, kind, compression):
    frames = _frames(kind, 24, 32, 3)
    got, ref = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    rosbag.frames_to_bag(got, frames, kind=kind, compression=compression)
    jrosbag.frames_to_bag(ref, frames, kind=kind, compression=compression)
    assert open(got, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_port_reads_jax_written_bag(tmp_path, compression):
    path = str(tmp_path / "j.bag")
    jrosbag.write_bag(path, _all_types(jrosbag)[0], compression=compression)
    got = list(rosbag.read_messages(path))
    ref = list(jrosbag.read_messages(path))
    assert [(m.topic, m.datatype, m.t) for m in got] == \
        [(m.topic, m.datatype, m.t) for m in ref]
    for g, r in zip(got, ref):
        _same_message(g.msg, r.msg)
    assert rosbag.bag_info(path) == jrosbag.bag_info(path)
    assert rosbag.bag_connections(path) == jrosbag.bag_connections(path)


@pytest.mark.parametrize("data", [
    b"",
    b"hello world",
    b"a" * 10_000,
    bytes(range(256)) * 64,
    np.random.default_rng(1).bytes(100_000),
    b"z" * (3 << 20),
], ids=["empty", "short", "rle", "periodic", "random", "multi_block"])
def test_lz4_frames_equal_jax(data):
    frame = lz4f.compress_frame(data)
    assert frame == jlz4f.compress_frame(data)
    assert lz4f.decompress_frame(frame) == jlz4f.decompress_frame(frame) \
        == data
    block = lz4f.compress_block(data)
    assert block == jlz4f.compress_block(data)
    assert lz4f.decompress_block(block) == data


# ---------------------------------------------------------------------------
# tests/test_rosbag.py on the copy
# ---------------------------------------------------------------------------


def _field(name: bytes, value: bytes) -> bytes:
    item = name + b"=" + value
    return struct.pack("<I", len(item)) + item


def _record(fields: bytes, data: bytes) -> bytes:
    return (struct.pack("<I", len(fields)) + fields
            + struct.pack("<I", len(data)) + data)


def _golden_bag() -> bytes:
    """A minimal spec-conformant bag, packed without the module's writer
    (``tests/test_rosbag.py:36-65``): file header, one uncompressed chunk
    holding one connection and one TransformStamped message."""
    msg = (struct.pack("<III", 7, 100, 500_000_000)
           + struct.pack("<I", 5) + b"world"
           + struct.pack("<I", 4) + b"body"
           + np.asarray([1.0, 2.0, 3.0], "<f8").tobytes()
           + np.asarray([0.0, 0.0, 0.0, 1.0], "<f8").tobytes())
    conn_hdr = (_field(b"topic", b"/tf_topic")
                + _field(b"type", b"geometry_msgs/TransformStamped")
                + _field(b"md5sum", b"*")
                + _field(b"message_definition", b""))
    inner = (_record(_field(b"op", b"\x07") + _field(b"conn", b"\x00" * 4)
                     + _field(b"topic", b"/tf_topic"), conn_hdr)
             + _record(_field(b"op", b"\x02") + _field(b"conn", b"\x00" * 4)
                       + _field(b"time", struct.pack("<II", 100,
                                                     500_000_000)), msg))
    chunk = _record(_field(b"op", b"\x05") + _field(b"compression", b"none")
                    + _field(b"size", struct.pack("<I", len(inner))), inner)
    fh = (_field(b"op", b"\x03")
          + _field(b"index_pos", struct.pack("<Q", 0))
          + _field(b"conn_count", struct.pack("<I", 1))
          + _field(b"chunk_count", struct.pack("<I", 1)))
    pad = 4096 - 8 - len(fh)
    file_header = (struct.pack("<I", len(fh)) + fh
                   + struct.pack("<I", pad) + b" " * pad)
    return rosbag.MAGIC + file_header + chunk


def test_reader_parses_golden_bytes(tmp_path):
    path = str(tmp_path / "golden.bag")
    with open(path, "wb") as f:
        f.write(_golden_bag())
    msgs = list(rosbag.read_messages(path))
    assert len(msgs) == 1
    m = msgs[0]
    assert (m.topic, m.datatype) == ("/tf_topic",
                                     "geometry_msgs/TransformStamped")
    assert m.t == pytest.approx(100.5)
    assert m.msg.header.frame_id == "world"
    assert m.msg.child_frame_id == "body"
    np.testing.assert_allclose(m.msg.pos, [1.0, 2.0, 3.0])
    np.testing.assert_allclose(m.msg.quat_wxyz, [1.0, 0.0, 0.0, 0.0])
    assert rosbag.bag_connections(path) == {
        "/tf_topic": "geometry_msgs/TransformStamped"}


def test_reader_rejects_bad_magic(tmp_path):
    path = str(tmp_path / "bad.bag")
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V1.2\x0a" + b"\x00" * 64)
    with pytest.raises(ValueError, match="not a ROS bag v2.0"):
        list(rosbag.read_messages(path))


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_roundtrip_all_types(tmp_path, compression):
    msgs, cloud, depth = _all_types(rosbag)
    path = str(tmp_path / f"rt_{compression}.bag")
    rosbag.write_bag(path, msgs, compression=compression)
    out = list(rosbag.read_messages(path))
    assert [m.topic for m in out] == [t for _, t, _ in msgs]
    assert out[0].msg.quat_wxyz[0] == pytest.approx(0.5)
    np.testing.assert_allclose(out[0].msg.pos, [1, 2, 3])
    np.testing.assert_allclose(out[1].msg.pos, [4, 5, 6])
    np.testing.assert_allclose(out[2].msg.pos, [7, 8, 9])
    np.testing.assert_allclose(out[2].msg.quat_wxyz, [0, 0, 1, 0])
    got = out[3].msg.xyz()
    assert got.shape == (50, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(cloud))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(cloud))
    np.testing.assert_allclose(out[4].msg.depth_m(1000.0), depth, atol=5e-4)
    np.testing.assert_allclose(out[5].msg.depth_m(1000.0), depth)
    conns = rosbag.bag_connections(path)
    assert conns["/cloud"] == "sensor_msgs/PointCloud2"
    assert conns["/depth16"] == "sensor_msgs/Image"
    info = rosbag.bag_info(path)
    assert info["/tf"]["count"] == 1
    assert info["/cloud"]["type"] == "sensor_msgs/PointCloud2"


def test_strided_and_row_padded_pointclouds():
    """xyz extraction honours point_step, field offsets and row padding
    (``tests/test_rosbag.py:155-169, 371-391``)."""
    n = 17
    xyz = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    raw = np.zeros((n, 32), np.uint8)
    raw[:, 4:16] = xyz.astype("<f4").view(np.uint8).reshape(n, 12)
    fields = [rosbag.PointField("x", 4, 7, 1), rosbag.PointField("y", 8, 7, 1),
              rosbag.PointField("z", 12, 7, 1),
              rosbag.PointField("rgb", 16, 7, 1)]
    pc = rosbag.PointCloud2(rosbag.Header(0, 2.0, "cam"), 1, n, fields,
                            False, 32, 32 * n, raw.tobytes(), True)
    np.testing.assert_allclose(pc.xyz(), xyz)

    h, w, step, pad = 4, 5, 16, 8
    grid = np.random.default_rng(3).normal(size=(h, w, 3)).astype(np.float32)
    raw = np.zeros((h, w * step + pad), np.uint8)
    for r in range(h):
        row = np.zeros((w, step), np.uint8)
        row[:, 0:12] = grid[r].astype("<f4").view(np.uint8).reshape(w, 12)
        raw[r, : w * step] = row.reshape(-1)
    pc = rosbag.PointCloud2(
        rosbag.Header(0, 1.0, "cam"), h, w,
        [rosbag.PointField("x", 0, 7, 1), rosbag.PointField("y", 4, 7, 1),
         rosbag.PointField("z", 8, 7, 1)],
        False, step, w * step + pad, raw.tobytes(), True)
    np.testing.assert_allclose(pc.xyz(), grid.reshape(-1, 3))


def test_reorder_and_topic_filter(tmp_path):
    msgs = [
        (10.0, "/tf", rosbag.make_transform(10.02, [0, 0, 0], [1, 0, 0, 0])),
        (10.0, "/junk", rosbag.make_transform(10.0, [9, 9, 9], [1, 0, 0, 0])),
        (10.1, "/tf", rosbag.make_transform(10.01, [1, 0, 0], [1, 0, 0, 0])),
        (10.2, "/tf", rosbag.make_transform(10.03, [2, 0, 0], [1, 0, 0, 0])),
    ]
    path = str(tmp_path / "ooo.bag")
    rosbag.write_bag(path, msgs)
    out = list(rosbag.read_messages(path, topics=["/tf"]))
    assert [m.topic for m in out] == ["/tf"] * 3
    assert [m.t for m in out] == sorted(m.t for m in out)
    assert out[0].msg.pos[0] == 1.0


def test_reorder_watermarks_handle_large_stamp_lag(tmp_path):
    lag, t, msgs = 2.0, 100.0, []
    for i in range(6):
        msgs.append((t, "/pose",
                     rosbag.make_transform(t, [i, 0, 0], [1, 0, 0, 0])))
        msgs.append((t + 0.05, "/depth",
                     rosbag.make_transform(t + 0.05 - lag, [0, i, 0],
                                           [1, 0, 0, 0])))
        t += 0.3
    path = str(tmp_path / "lag.bag")
    rosbag.write_bag(path, msgs)
    ts = [m.t for m in rosbag.read_messages(path)]
    assert len(ts) == 12 and ts == sorted(ts)


def test_pick_topics():
    info = {
        "/camera/depth_registered/points": {
            "type": "sensor_msgs/PointCloud2", "count": 100},
        "/other_cloud": {"type": "sensor_msgs/PointCloud2", "count": 5},
        "/kinect/vrpn_client/estimated_transform": {
            "type": "geometry_msgs/TransformStamped", "count": 900},
        "/strings": {"type": "std_msgs/String", "count": 10_000},
    }
    assert rosbag.pick_topics(info) == (
        "/camera/depth_registered/points",
        "/kinect/vrpn_client/estimated_transform")
    assert rosbag.pick_topics(info, sensor_topic="/other_cloud")[0] == \
        "/other_cloud"
    s2, p2 = rosbag.pick_topics({t: e["type"] for t, e in info.items()})
    assert s2 in ("/camera/depth_registered/points", "/other_cloud")
    assert p2 == "/kinect/vrpn_client/estimated_transform"
    with pytest.raises(ValueError, match="no sensor topic"):
        rosbag.pick_topics({"/a": "std_msgs/String"})
    with pytest.raises(ValueError, match="not in the bag"):
        rosbag.pick_topics(info, sensor_topic="/typo/points")
    with pytest.raises(ValueError, match="not in the bag"):
        rosbag.pick_topics(info, pose_topic="/typo/pose")


def test_corrupt_and_truncated_bags_fail_cleanly(tmp_path):
    """An lz4 chunk that is no LZ4 frame, a record cut mid-header, and bags
    cut anywhere fail loudly or stop with well-formed messages only
    (``tests/test_rosbag.py:214-223, 320-339, 425-437``)."""
    path = str(tmp_path / "lz4.bag")
    chunk = _record(_field(b"op", b"\x05") + _field(b"compression", b"lz4")
                    + _field(b"size", struct.pack("<I", 0)),
                    b"\x00\x01\x02\x03not a frame")
    with open(path, "wb") as f:
        f.write(rosbag.MAGIC + chunk)
    with pytest.raises(ValueError, match="magic"):
        list(rosbag.read_messages(path))

    with open(path, "wb") as f:
        f.write(rosbag.MAGIC + struct.pack("<I", 100) + b"x" * 10)
    with pytest.raises(ValueError, match="truncated"):
        list(rosbag.read_messages(path))

    bag = str(tmp_path / "full.bag")
    rosbag.frames_to_bag(bag, _frames("cloud", 60, 80, 3))
    blob = open(bag, "rb").read()
    for cut in (len(blob) // 3, len(blob) // 2, len(blob) - 7):
        cut_path = str(tmp_path / f"cut_{cut}.bag")
        with open(cut_path, "wb") as f:
            f.write(blob[:cut])
        try:
            msgs = list(rosbag.read_messages(cut_path))
        except Exception:   # noqa: BLE001 - any raise is a clean failure
            continue
        for m in msgs:
            assert m.datatype in rosbag._DESERIALIZERS
            assert np.isfinite(m.t)


def test_cli_converter_roundtrip(tmp_path, capsys):
    """bag -> npz -> bag through the copy's CLI (its ``to-npz`` runs the
    port's ``ScanSynchronizer``) gives the npz the JAX package's CLI
    gives, and the sequence survives."""
    frames = _frames("cloud", 60, 80, 4)
    bag1 = str(tmp_path / "a.bag")
    rosbag.frames_to_bag(bag1, frames)
    npz, jnpz = str(tmp_path / "a.npz"), str(tmp_path / "j.npz")
    assert rosbag._cli(["to-npz", bag1, npz]) == 0
    assert jrosbag._cli(["to-npz", bag1, jnpz]) == 0
    data, ref = np.load(npz), np.load(jnpz)
    assert sorted(data.files) == sorted(ref.files)
    for k in data.files:
        assert data[k].tobytes() == ref[k].tobytes(), k
    assert len(data["t"]) == 4 and data["clouds"].shape[0] == 4
    np.testing.assert_allclose(data["pos"][0], frames[0][1][0])

    bag2 = str(tmp_path / "b.bag")
    assert rosbag._cli(["from-npz", npz, bag2, "--compression", "bz2"]) == 0
    out = [m for m in rosbag.read_messages(bag2)
           if m.datatype == "sensor_msgs/PointCloud2"]
    assert len(out) == 4
    got, want = out[0].msg.xyz(), np.asarray(frames[0][2], np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want))
    assert rosbag._cli(["info", bag2]) == 0
    assert "PointCloud2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tests/test_lz4.py on the copy
# ---------------------------------------------------------------------------


def test_xxh32_vectors():
    assert lz4f.xxh32(b"") == 0x02CC5D05
    assert lz4f.xxh32(b"a") == 0x550D7456
    assert lz4f.xxh32(b"abc") == 0x32D153FF
    assert lz4f.xxh32(b"a" * 101) != lz4f.xxh32(b"a" * 100)


HIST = b"0123456789ABCDEF"


@pytest.mark.parametrize("block, prefix, want", [
    (b"\x50hello", b"", b"hello"),
    (b"\xa6" + b"0123456789" + struct.pack("<H", 10) + b"\x50ABCDE", b"",
     b"0123456789" * 2 + b"ABCDE"),
    (b"\x1fx" + struct.pack("<H", 1) + b"\x00" + b"\x50ABCDE", b"",
     b"x" * 20 + b"ABCDE"),
    (b"\xf0\x05" + bytes(range(20)), b"", bytes(range(20))),
    (b"\x06" + struct.pack("<H", 16) + b"\x50WORLD", HIST, b"0123456789WORLD"),
    (b"\x20xy" + struct.pack("<H", 4) + b"\x50ABCDE", HIST, b"xyEFxyABCDE"),
], ids=["literals", "match", "overlap_rle", "length_ext", "prefix",
        "prefix_crossing"])
def test_block_decode_golden(block, prefix, want):
    assert lz4f.decompress_block(block, prefix=prefix) == want
    assert jlz4f.decompress_block(block, prefix=prefix) == want


@pytest.mark.parametrize("block", [
    b"\x50hi",                                          # literals past end
    b"\x14" + b"a" + struct.pack("<H", 9) + b"\x10b",   # offset before start
    b"\x06" + struct.pack("<H", 16) + b"\x50WORLD",     # no history given
])
def test_block_decode_corrupt(block):
    with pytest.raises(lz4f.LZ4Error):
        lz4f.decompress_block(block)


def test_block_compression_ratio():
    data = b"abcd" * 25_000
    assert len(lz4f.compress_block(data)) < len(data) // 50


def test_frame_layout_and_raw_blocks():
    frame = lz4f.compress_frame(b"payload")
    (magic,) = struct.unpack_from("<I", frame, 0)
    assert magic == 0x184D2204
    assert frame[4] >> 6 == 1 and frame[4] & (1 << 2)
    assert frame[6] == (lz4f.xxh32(frame[4:6]) >> 8) & 0xFF
    data = np.random.default_rng(2).bytes(5000)
    frame = lz4f.compress_frame(data)
    (bsz,) = struct.unpack_from("<I", frame, 7)
    assert bsz & 0x80000000
    assert lz4f.decompress_frame(frame) == data
    empty = lz4f.compress_frame(b"")
    assert struct.unpack_from("<I", empty, 7)[0] == 0
    assert lz4f.decompress_frame(empty) == b""


def test_frame_corrupt_and_truncated():
    frame = bytearray(lz4f.compress_frame(b"some payload bytes here"))
    frame[-1] ^= 0xFF
    with pytest.raises(lz4f.LZ4Error, match="content checksum"):
        lz4f.decompress_frame(bytes(frame))
    frame2 = bytearray(lz4f.compress_frame(b"other data"))
    frame2[4] ^= 0x04
    with pytest.raises(lz4f.LZ4Error, match="header checksum"):
        lz4f.decompress_frame(bytes(frame2))
    with pytest.raises(lz4f.LZ4Error, match="magic"):
        lz4f.decompress_frame(b"\x00\x00\x00\x00rest")
    with pytest.raises(lz4f.LZ4Error):
        lz4f.decompress_frame(struct.pack("<I", 0x184D2204)
                              + bytes([0x48, 0x40]))
    with pytest.raises(lz4f.LZ4Error):
        lz4f.decompress_frame(lz4f.compress_frame(b"some payload")[:12])


def test_linked_block_frame_decodes():
    header = bytes([0x40, 0x40])      # linked blocks, no checksums, 64 KiB
    blk1 = b"\xf0\x01" + HIST
    blk2 = b"\x06" + struct.pack("<H", 16) + b"\x50WORLD"
    frame = (struct.pack("<I", lz4f.MAGIC) + header
             + bytes([(lz4f.xxh32(header) >> 8) & 0xFF])
             + struct.pack("<I", len(blk1)) + blk1
             + struct.pack("<I", len(blk2)) + blk2 + struct.pack("<I", 0))
    assert lz4f.decompress_frame(frame) == HIST + b"0123456789WORLD"
    assert jlz4f.decompress_frame(frame) == HIST + b"0123456789WORLD"
