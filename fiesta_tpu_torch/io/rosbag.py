"""ROS bag (format 2.0) ingestion — no ROS required.

A copy of ``fiesta_tpu/io/rosbag.py`` (Python and numpy): the same reader
and byte-identical writer; the ``to-npz`` converter runs the port's
``ScanSynchronizer``.

The reference framework is operated by replaying recorded ROS bags into a
live node (``rosbag play data.bag`` + ``roslaunch fiesta cow_and_lady.launch``,
reference README.md:88-96), with the node subscribing to a sensor topic
(``sensor_msgs/PointCloud2`` or ``sensor_msgs/Image``) and a pose topic
(``geometry_msgs/TransformStamped``, ``geometry_msgs/PoseStamped`` or
``nav_msgs/Odometry`` — Fiesta.h:28-33, 441-479).  A user switching to
fiesta_tpu_torch has those same ``.bag`` files; this module reads them directly:

  * ``read_messages(path, topics=...)`` — streaming, time-ordered iterator
    over deserialized messages (constant memory; chunks are decoded lazily).
  * ``bag_info(path)`` — topic/type/count summary (``rosbag info`` analog).
  * ``write_bag(path, messages)`` — a spec-complete writer (chunks, index
    records, chunk infos) used for round-trip tests and for converting
    synthetic/npz sequences into bags.

Only the bag *container* and the five message types the reference consumes
are implemented; everything is pure Python + numpy against the public bag
format 2.0 spec (http://wiki.ros.org/Bags/Format/2.0) and the ROS message
serialization rules (little-endian fields, u32-length-prefixed strings and
arrays).  Unknown message types are skipped (or surfaced raw on request).

Supported chunk compressions: ``none``, ``bz2`` (stdlib), and ``lz4``
(roslz4's standard LZ4-frame chunks, decoded by the pure-Python codec in
``io/lz4f.py``) — any bag ``rosbag record``/``compress`` produces replays
directly.  Throughput note: the pure-Python lz4 codec runs at ~1-10 MB/s
(Python-level loops); install the optional ``lz4`` package to decode
multi-GB lz4 bags at native speed (io/lz4f.py picks it up automatically).
"""

from __future__ import annotations

import bz2
import dataclasses
import heapq
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

# record op codes (bag format 2.0)
OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


# ---------------------------------------------------------------------------
# Message types (the subset the reference's node template accepts)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Header:
    seq: int
    stamp: float          # seconds (sec + 1e-9*nsec)
    frame_id: str


@dataclasses.dataclass
class TransformStamped:
    """geometry_msgs/TransformStamped (reference pose input, Fiesta.h:464)."""
    header: Header
    child_frame_id: str
    translation: np.ndarray      # [3] f64
    rotation_xyzw: np.ndarray    # [4] f64, ROS order (x, y, z, w)

    @property
    def pos(self) -> np.ndarray:
        return self.translation

    @property
    def quat_wxyz(self) -> np.ndarray:
        x, y, z, w = self.rotation_xyzw
        return np.asarray([w, x, y, z], np.float64)


@dataclasses.dataclass
class PoseStamped:
    """geometry_msgs/PoseStamped (reference pose input, Fiesta.h:444)."""
    header: Header
    position: np.ndarray         # [3] f64
    orientation_xyzw: np.ndarray  # [4] f64

    @property
    def pos(self) -> np.ndarray:
        return self.position

    @property
    def quat_wxyz(self) -> np.ndarray:
        x, y, z, w = self.orientation_xyzw
        return np.asarray([w, x, y, z], np.float64)


@dataclasses.dataclass
class Odometry:
    """nav_msgs/Odometry (reference pose input, Fiesta.h:453)."""
    header: Header
    child_frame_id: str
    position: np.ndarray
    orientation_xyzw: np.ndarray
    linear: np.ndarray           # [3] twist.linear
    angular: np.ndarray          # [3] twist.angular

    @property
    def pos(self) -> np.ndarray:
        return self.position

    @property
    def quat_wxyz(self) -> np.ndarray:
        x, y, z, w = self.orientation_xyzw
        return np.asarray([w, x, y, z], np.float64)


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int    # 1=I8 2=U8 3=I16 4=U16 5=I32 6=U32 7=F32 8=F64
    count: int


_FIELD_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
                 5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


@dataclasses.dataclass
class PointCloud2:
    """sensor_msgs/PointCloud2 (reference depth input, Fiesta.h:424-426)."""
    header: Header
    height: int
    width: int
    fields: List[PointField]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool

    def xyz(self) -> np.ndarray:
        """Extract [N,3] float32 points (NaN points preserved — the caller's
        finite-mask handles them, as pcl::fromROSMsg does for the reference).

        Organized clouds may pad each row (``row_step > width*point_step``,
        common for Kinect/OpenNI recordings): rows are decoded at their
        ``row_step`` strides, never contiguously across the padding.
        """
        byname = {f.name: f for f in self.fields}
        row_bytes = self.width * self.point_step
        if self.height > 1 and self.row_step > row_bytes:
            # strip row padding once, then decode densely
            raw = np.frombuffer(self.data, np.uint8,
                                count=self.height * self.row_step)
            raw = raw.reshape(self.height, self.row_step)[:, :row_bytes]
            data = np.ascontiguousarray(raw).tobytes()
        else:
            data = self.data
        n = self.height * self.width
        cols = []
        for name in ("x", "y", "z"):
            f = byname[name]
            base = _FIELD_DTYPES[f.datatype]
            dt = np.dtype({"names": [name], "formats": [base],
                           "offsets": [f.offset],
                           "itemsize": self.point_step})
            col = np.frombuffer(data, dtype=dt, count=n)[name]
            if self.is_bigendian:
                col = col.byteswap()
            cols.append(col.astype(np.float32))
        return np.stack(cols, axis=-1)


@dataclasses.dataclass
class Image:
    """sensor_msgs/Image (reference depth input, Fiesta.h:318-331)."""
    header: Header
    height: int
    width: int
    encoding: str
    is_bigendian: bool
    step: int
    data: bytes

    def depth_m(self, depth_scaling_factor: float = 1000.0) -> np.ndarray:
        """Decode to an [H,W] float32 depth map in meters — ``16UC1`` is
        millimeters / ``depth_scaling_factor`` (Fiesta.h:328-331, the
        reference's k_depth_scaling_factor), ``32FC1`` is meters as-is."""
        if self.encoding in ("16UC1", "mono16"):
            base = np.uint16
            scale = 1.0 / depth_scaling_factor
        elif self.encoding == "32FC1":
            base = np.float32
            scale = 1.0
        else:
            raise ValueError(
                f"unsupported depth encoding {self.encoding!r} "
                "(expected 16UC1 or 32FC1, Fiesta.h:325-331)")
        itemsize = np.dtype(base).itemsize
        rows = np.frombuffer(self.data, np.uint8).reshape(
            self.height, self.step)
        img = rows[:, : self.width * itemsize].view(base)
        if self.is_bigendian:
            img = img.byteswap()
        out = img.astype(np.float32) * scale
        return np.nan_to_num(out, nan=0.0)   # 0 = no return (filtered by gates)


POSE_TYPES = ("geometry_msgs/TransformStamped", "geometry_msgs/PoseStamped",
              "nav_msgs/Odometry")
SENSOR_TYPES = ("sensor_msgs/PointCloud2", "sensor_msgs/Image")


@dataclasses.dataclass
class BagMessage:
    t: float          # header stamp if present, else record receive time
    topic: str
    datatype: str
    msg: object       # one of the dataclasses above (or bytes if raw)


# ---------------------------------------------------------------------------
# Binary readers
# ---------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        v = _U32.unpack_from(self.buf, self.pos)[0]
        self.pos += 4
        return v

    def f64(self) -> float:
        v = struct.unpack_from("<d", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def f64s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, np.float64, count=n, offset=self.pos)
        self.pos += 8 * n
        return np.asarray(v)

    def string(self) -> str:
        n = self.u32()
        v = self.buf[self.pos: self.pos + n].decode("utf-8", "replace")
        self.pos += n
        return v

    def raw(self, n: int) -> bytes:
        v = self.buf[self.pos: self.pos + n]
        self.pos += n
        return v

    def time(self) -> float:
        sec, nsec = self.u32(), self.u32()
        return sec + 1e-9 * nsec

    def header(self) -> Header:
        return Header(seq=self.u32(), stamp=self.time(),
                      frame_id=self.string())


def _parse_fields(raw: bytes) -> Dict[str, bytes]:
    """Parse a record header (or connection-header) field block."""
    fields: Dict[str, bytes] = {}
    pos = 0
    end = len(raw)
    while pos < end:
        (n,) = _U32.unpack_from(raw, pos)
        pos += 4
        item = raw[pos: pos + n]
        pos += n
        eq = item.index(b"=")
        fields[item[:eq].decode("ascii")] = item[eq + 1:]
    return fields


def _field_u32(fields: Dict[str, bytes], name: str) -> int:
    return _U32.unpack(fields[name])[0]


def _field_time(fields: Dict[str, bytes], name: str) -> float:
    sec, nsec = struct.unpack("<II", fields[name])
    return sec + 1e-9 * nsec


def _read_exact(f, n: int, what: str) -> bytes:
    """Read exactly n bytes or raise a clear truncation error (a recorder
    crash leaves bags cut mid-record; rosbag reindex exists for the same
    reason)."""
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError(
            f"truncated bag: expected {n} bytes of {what} at offset "
            f"{f.tell() - len(buf)}, got {len(buf)} (recorder crash? "
            "try rosbag reindex on the original)")
    return buf


def _read_record(f) -> Optional[Tuple[Dict[str, bytes], bytes]]:
    hl = f.read(4)
    if len(hl) < 4:
        return None
    (n,) = _U32.unpack(hl)
    header = _parse_fields(_read_exact(f, n, "record header"))
    (dn,) = _U32.unpack(_read_exact(f, 4, "record data length"))
    data = f.read(dn)
    return header, data


def _iter_buffer_records(buf: bytes) -> Iterator[Tuple[Dict[str, bytes],
                                                       bytes]]:
    pos = 0
    end = len(buf)
    while pos < end:
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        header = _parse_fields(buf[pos: pos + n])
        pos += n
        (dn,) = _U32.unpack_from(buf, pos)
        pos += 4
        yield header, buf[pos: pos + dn]
        pos += dn


# -- message deserializers ---------------------------------------------------


def _de_transform_stamped(data: bytes) -> TransformStamped:
    c = _Cursor(data)
    h = c.header()
    child = c.string()
    return TransformStamped(h, child, c.f64s(3), c.f64s(4))


def _de_pose_stamped(data: bytes) -> PoseStamped:
    c = _Cursor(data)
    h = c.header()
    return PoseStamped(h, c.f64s(3), c.f64s(4))


def _de_odometry(data: bytes) -> Odometry:
    c = _Cursor(data)
    h = c.header()
    child = c.string()
    pos, quat = c.f64s(3), c.f64s(4)
    c.f64s(36)                       # pose covariance
    lin, ang = c.f64s(3), c.f64s(3)
    return Odometry(h, child, pos, quat, lin, ang)


def _de_pointcloud2(data: bytes) -> PointCloud2:
    c = _Cursor(data)
    h = c.header()
    height, width = c.u32(), c.u32()
    fields = [PointField(c.string(), c.u32(), c.u8(), c.u32())
              for _ in range(c.u32())]
    is_be = bool(c.u8())
    pstep, rstep = c.u32(), c.u32()
    payload = c.raw(c.u32())
    dense = bool(c.u8())
    return PointCloud2(h, height, width, fields, is_be, pstep, rstep,
                       payload, dense)


def _de_image(data: bytes) -> Image:
    c = _Cursor(data)
    h = c.header()
    height, width = c.u32(), c.u32()
    enc = c.string()
    is_be = bool(c.u8())
    step = c.u32()
    payload = c.raw(c.u32())
    return Image(h, height, width, enc, is_be, step, payload)


_DESERIALIZERS = {
    "geometry_msgs/TransformStamped": _de_transform_stamped,
    "geometry_msgs/PoseStamped": _de_pose_stamped,
    "nav_msgs/Odometry": _de_odometry,
    "sensor_msgs/PointCloud2": _de_pointcloud2,
    "sensor_msgs/Image": _de_image,
}


# ---------------------------------------------------------------------------
# Bag reading
# ---------------------------------------------------------------------------


def _decompress_chunk(header: Dict[str, bytes], data: bytes) -> bytes:
    comp = header.get("compression", b"none").decode("ascii")
    if comp == "none":
        return data
    if comp == "bz2":
        return bz2.decompress(data)
    if comp == "lz4":
        # roslz4 wraps chunks in the standard LZ4 frame format; decoded by
        # the pure-Python codec (io/lz4f.py) — no ROS needed
        from . import lz4f

        return lz4f.decompress_frame(data)
    raise ValueError(
        f"chunk compression {comp!r} not supported "
        "(expected none, bz2, or lz4)")


@dataclasses.dataclass
class _Connection:
    conn_id: int
    topic: str
    datatype: str


def _parse_connection(header: Dict[str, bytes], data: bytes) -> _Connection:
    conn_id = _field_u32(header, "conn")
    chdr = _parse_fields(data)
    # connection-header "topic" (the original) wins over the record header's
    # (possibly remapped) one, matching rosbag's own reader
    topic = chdr.get("topic", header.get("topic", b"")).decode()
    datatype = chdr.get("type", b"").decode()
    return _Connection(conn_id, topic, datatype)


def _iter_raw_messages(path: str) -> Iterator[Tuple[float, _Connection,
                                                    bytes]]:
    """Yield (record_time, connection, serialized_bytes) in file order."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(
                f"{path}: not a ROS bag v2.0 (magic {magic!r}); v1.2 bags "
                "must be upgraded with `rosbag fix`")
        conns: Dict[int, _Connection] = {}
        while True:
            rec = _read_record(f)
            if rec is None:
                return
            header, data = rec
            op = header["op"][0]
            if op == OP_CONNECTION:
                c = _parse_connection(header, data)
                conns[c.conn_id] = c
            elif op == OP_CHUNK:
                for ih, idata in _iter_buffer_records(
                        _decompress_chunk(header, data)):
                    iop = ih["op"][0]
                    if iop == OP_CONNECTION:
                        c = _parse_connection(ih, idata)
                        conns[c.conn_id] = c
                    elif iop == OP_MSG_DATA:
                        cid = _field_u32(ih, "conn")
                        t = _field_time(ih, "time")
                        yield t, conns[cid], idata
            elif op == OP_MSG_DATA:           # unchunked bag (valid, rare)
                cid = _field_u32(header, "conn")
                t = _field_time(header, "time")
                yield t, conns[cid], data
            # INDEX_DATA / CHUNK_INFO / BAG_HEADER: not needed for a
            # sequential scan — skip


def read_messages(
    path: str,
    topics: Optional[Sequence[str]] = None,
    raw: bool = False,
    reorder_slack: float = 0.5,
) -> Iterator[BagMessage]:
    """Stream deserialized messages in time order.

    ``topics=None`` yields every topic with a supported type.  Messages are
    timestamped by their header stamp when present (what the reference's
    synchronizer matches on, Fiesta.h:388-405) and re-ordered across topics,
    since bags interleave topics in *receive* order.

    Ordering guarantee: a message is released only once every LIVE topic's
    last-seen header stamp (its watermark) has passed it — exact whenever
    each topic's stamps are monotone, regardless of how far header stamps
    lag receive time (sensor pipeline latency).  During warm-up (before
    every requested topic has published at least once) releases are held
    to the ``reorder_slack`` receive-time horizon instead, so an
    early-stamped message of a late-starting topic cannot be beaten out
    of order by the topics that started first.  ``reorder_slack`` is also
    the liveness fallback: a topic that stops publishing mid-bag (or a
    requested topic absent from the bag entirely) stops holding the others
    back after ``slack`` seconds of receive time (messages of the stalled
    topic itself may then interleave imperfectly — the price of bounded
    buffering).  With ``topics=None`` the full topic set is unknown up
    front, so the warm-up hold covers only topics already seen.
    """
    want = set(topics) if topics is not None else None
    heap: List[Tuple[float, int, BagMessage]] = []
    seq = 0
    horizon = -np.inf
    watermark: Dict[str, float] = {}
    last_rec: Dict[str, float] = {}
    for t_rec, conn, payload in _iter_raw_messages(path):
        if want is not None and conn.topic not in want:
            continue
        de = _DESERIALIZERS.get(conn.datatype)
        if de is None:
            if not raw:
                continue
            msg: object = payload
            t = t_rec
        else:
            msg = de(payload)
            t = getattr(getattr(msg, "header", None), "stamp", 0.0) or t_rec
        heapq.heappush(heap, (t, seq, BagMessage(t, conn.topic,
                                                 conn.datatype, msg)))
        seq += 1
        horizon = max(horizon, t_rec)
        watermark[conn.topic] = max(watermark.get(conn.topic, -np.inf), t)
        last_rec[conn.topic] = t_rec
        # release below the lowest stamp watermark among LIVE topics; a
        # topic silent for > slack of receive time stops holding the
        # others back (liveness fallback, bounded buffering)
        live = [wm for tp, wm in watermark.items()
                if horizon - last_rec[tp] <= reorder_slack]
        flush_to = min(live) if live else horizon - reorder_slack
        if want is not None and not want <= watermark.keys():
            # warm-up: a requested topic has not published yet, so the
            # live-watermark min does not bound its (unknown) first stamp —
            # hold to the slack horizon until it appears or times out
            flush_to = min(flush_to, horizon - reorder_slack)
        while heap and heap[0][0] < flush_to:
            yield heapq.heappop(heap)[2]
    while heap:
        yield heapq.heappop(heap)[2]


def bag_info(path: str) -> Dict[str, dict]:
    """Per-topic summary: datatype, message count, time span
    (``rosbag info`` analog, without requiring the bag's index)."""
    out: Dict[str, dict] = {}
    for t, conn, _payload in _iter_raw_messages(path):
        e = out.setdefault(conn.topic, {
            "type": conn.datatype, "count": 0,
            "t0": float("inf"), "t1": float("-inf"),
        })
        e["count"] += 1
        e["t0"] = min(e["t0"], t)
        e["t1"] = max(e["t1"], t)
    return out


def bag_connections(path: str) -> Dict[str, str]:
    """topic -> datatype map, WITHOUT scanning message payloads: reads the
    trailing index section (``index_pos`` in the file-header record) where
    every connection record is repeated; falls back to a full scan for
    unindexed bags."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0")
        rec = _read_record(f)
        index_pos = 0
        if rec is not None and rec[0].get("op", b"\x00")[0] == OP_BAG_HEADER:
            index_pos = _U64.unpack(rec[0]["index_pos"])[0]
        out: Dict[str, str] = {}
        if index_pos:
            f.seek(index_pos)
            while True:
                rec = _read_record(f)
                if rec is None:
                    break
                header, data = rec
                if header["op"][0] == OP_CONNECTION:
                    c = _parse_connection(header, data)
                    out[c.topic] = c.datatype
            if out:
                return out
    # unindexed / reindex-needed bag: full sequential scan
    for _t, conn, _payload in _iter_raw_messages(path):
        out.setdefault(conn.topic, conn.datatype)
    return out


def print_bag_info(info: Dict[str, dict], file=None) -> None:
    """Print ``bag_info()`` as the topic table (one formatter, shared by
    run.py --bag-info and the module CLI)."""
    import sys

    file = file or sys.stdout
    for topic, e in sorted(info.items()):
        print(f"{topic:<45s} {e['type']:<35s} {e['count']:>8d} msgs "
              f"[{e['t0']:.3f}, {e['t1']:.3f}]", file=file)


def pick_topics(
    info: Dict[str, object],
    sensor_topic: Optional[str] = None,
    pose_topic: Optional[str] = None,
) -> Tuple[str, str]:
    """Resolve the sensor + pose topics: honor explicit names when present
    in the bag, else auto-pick a topic of a suitable type, preferring
    higher message counts when known (the launch-file remap equivalent,
    launch/cow_and_lady.launch:66-67).  ``info`` is either
    ``bag_info()``'s dict or ``bag_connections()``'s topic->type map."""

    def entry(v) -> Tuple[str, int]:
        if isinstance(v, dict):
            return v["type"], v.get("count", 0)
        return v, 0

    def best(types: Tuple[str, ...], given: Optional[str], kind: str) -> str:
        if given is not None:
            if given in info:
                return given
            present = {t: entry(v)[0] for t, v in info.items()}
            raise ValueError(
                f"requested {kind} topic {given!r} is not in the bag; "
                f"topics present: {present}")
        cands = [(entry(v)[1], i, t) for i, (t, v) in enumerate(info.items())
                 if entry(v)[0] in types]
        if not cands:
            present = {t: entry(v)[0] for t, v in info.items()}
            raise ValueError(
                f"no {kind} topic found in bag (need one of {types}); "
                f"topics present: {present}")
        # highest count wins; file order breaks ties deterministically
        return max(cands, key=lambda c: (c[0], -c[1]))[2]

    return (best(SENSOR_TYPES, sensor_topic, "sensor"),
            best(POSE_TYPES, pose_topic, "pose"))


# ---------------------------------------------------------------------------
# Bag writing (round-trip tests + npz/synthetic -> bag conversion)
# ---------------------------------------------------------------------------


_MD5 = {
    "geometry_msgs/TransformStamped": "b5764a33bfeb3588febc2682852579b0",
    "geometry_msgs/PoseStamped": "d3812c3cbc69362b77dc0b19b345f8f5",
    "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7",
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "sensor_msgs/Image": "060021388200f6f0f447d0fcd9c64743",
}


def _ser_fields(fields: Dict[str, bytes]) -> bytes:
    out = bytearray()
    for k, v in fields.items():
        item = k.encode("ascii") + b"=" + v
        out += _U32.pack(len(item)) + item
    return bytes(out)


def _ser_record(fields: Dict[str, bytes], data: bytes) -> bytes:
    h = _ser_fields(fields)
    return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data


def _ser_time(t: float) -> bytes:
    sec = int(t)
    nsec = int(round((t - sec) * 1e9))
    if nsec >= 10 ** 9:
        sec, nsec = sec + 1, nsec - 10 ** 9
    return struct.pack("<II", sec, nsec)


def _ser_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return _U32.pack(len(b)) + b


def _ser_header(h: Header) -> bytes:
    return _U32.pack(h.seq) + _ser_time(h.stamp) + _ser_string(h.frame_id)


def _ser_msg(msg) -> Tuple[str, bytes]:
    if isinstance(msg, TransformStamped):
        return "geometry_msgs/TransformStamped", (
            _ser_header(msg.header) + _ser_string(msg.child_frame_id)
            + np.asarray(msg.translation, "<f8").tobytes()
            + np.asarray(msg.rotation_xyzw, "<f8").tobytes())
    if isinstance(msg, PoseStamped):
        return "geometry_msgs/PoseStamped", (
            _ser_header(msg.header)
            + np.asarray(msg.position, "<f8").tobytes()
            + np.asarray(msg.orientation_xyzw, "<f8").tobytes())
    if isinstance(msg, Odometry):
        cov = np.zeros(36, "<f8").tobytes()
        return "nav_msgs/Odometry", (
            _ser_header(msg.header) + _ser_string(msg.child_frame_id)
            + np.asarray(msg.position, "<f8").tobytes()
            + np.asarray(msg.orientation_xyzw, "<f8").tobytes() + cov
            + np.asarray(msg.linear, "<f8").tobytes()
            + np.asarray(msg.angular, "<f8").tobytes() + cov)
    if isinstance(msg, PointCloud2):
        out = bytearray(_ser_header(msg.header))
        out += _U32.pack(msg.height) + _U32.pack(msg.width)
        out += _U32.pack(len(msg.fields))
        for f in msg.fields:
            out += (_ser_string(f.name) + _U32.pack(f.offset)
                    + bytes([f.datatype]) + _U32.pack(f.count))
        out += bytes([int(msg.is_bigendian)])
        out += _U32.pack(msg.point_step) + _U32.pack(msg.row_step)
        out += _U32.pack(len(msg.data)) + msg.data
        out += bytes([int(msg.is_dense)])
        return "sensor_msgs/PointCloud2", bytes(out)
    if isinstance(msg, Image):
        out = bytearray(_ser_header(msg.header))
        out += _U32.pack(msg.height) + _U32.pack(msg.width)
        out += _ser_string(msg.encoding)
        out += bytes([int(msg.is_bigendian)]) + _U32.pack(msg.step)
        out += _U32.pack(len(msg.data)) + msg.data
        return "sensor_msgs/Image", bytes(out)
    raise TypeError(f"cannot serialize {type(msg).__name__}")


def make_pointcloud2(stamp: float, points: np.ndarray,
                     frame_id: str = "camera") -> PointCloud2:
    """Build an xyz-float32 PointCloud2 from [N,3] or organized [H,W,3]."""
    pts = np.asarray(points, np.float32)
    if pts.ndim == 3:
        h, w = pts.shape[:2]
        flat = np.ascontiguousarray(pts.reshape(-1, 3))
    else:
        h, w = 1, pts.shape[0]
        flat = np.ascontiguousarray(pts)
    fields = [PointField("x", 0, 7, 1), PointField("y", 4, 7, 1),
              PointField("z", 8, 7, 1)]
    return PointCloud2(
        Header(0, stamp, frame_id), h, w, fields, False, 12, 12 * w,
        flat.astype("<f4").tobytes(),
        bool(np.isfinite(flat).all()))


def make_depth_image(stamp: float, depth_m: np.ndarray,
                     frame_id: str = "camera",
                     encoding: str = "32FC1",
                     depth_scaling_factor: float = 1000.0) -> Image:
    d = np.asarray(depth_m, np.float32)
    h, w = d.shape
    if encoding == "32FC1":
        payload = d.astype("<f4").tobytes()
        step = 4 * w
    elif encoding == "16UC1":
        payload = np.round(d * depth_scaling_factor).astype("<u2").tobytes()
        step = 2 * w
    else:
        raise ValueError(encoding)
    return Image(Header(0, stamp, frame_id), h, w, encoding, False, step,
                 payload)


def make_transform(stamp: float, pos, quat_wxyz,
                   frame_id: str = "world",
                   child_frame_id: str = "body") -> TransformStamped:
    w, x, y, z = np.asarray(quat_wxyz, np.float64)
    return TransformStamped(Header(0, stamp, frame_id), child_frame_id,
                            np.asarray(pos, np.float64),
                            np.asarray([x, y, z, w]))


def write_bag(
    path: str,
    messages: Iterable[Tuple[float, str, object]],
    compression: str = "none",
    chunk_threshold: int = 768 * 1024,
) -> None:
    """Write ``(receive_time, topic, msg)`` tuples to a format-2.0 bag with
    chunks, per-chunk index records, and a trailing index section (connection
    + chunk-info records) so standard ROS tools accept it unindexed."""
    if compression not in ("none", "bz2", "lz4"):
        raise ValueError("compression must be 'none', 'bz2', or 'lz4'")

    conn_ids: Dict[Tuple[str, str], int] = {}
    conn_records: List[bytes] = []
    chunk_infos: List[dict] = []

    def conn_record(cid: int, topic: str, datatype: str) -> bytes:
        chdr = _ser_fields({
            "topic": topic.encode(),
            "type": datatype.encode(),
            "md5sum": _MD5.get(datatype, "*").encode(),
            "message_definition": b"",
        })
        return _ser_record(
            {"op": bytes([OP_CONNECTION]), "conn": _U32.pack(cid),
             "topic": topic.encode()}, chdr)

    with open(path, "wb") as f:
        f.write(MAGIC)
        # placeholder file-header record, padded to 4096 total bytes
        header_pos = f.tell()

        def file_header(index_pos: int, nconn: int, nchunk: int) -> bytes:
            h = _ser_fields({
                "op": bytes([OP_BAG_HEADER]),
                "index_pos": _U64.pack(index_pos),
                "conn_count": _U32.pack(nconn),
                "chunk_count": _U32.pack(nchunk),
            })
            pad = 4096 - 8 - len(h)
            return _U32.pack(len(h)) + h + _U32.pack(pad) + b" " * pad

        f.write(file_header(0, 0, 0))

        buf = bytearray()        # current chunk's uncompressed records
        index: Dict[int, List[Tuple[float, int]]] = {}
        t_lo, t_hi = float("inf"), float("-inf")

        def flush() -> None:
            nonlocal buf, index, t_lo, t_hi
            if not buf:
                return
            raw = bytes(buf)
            if compression == "bz2":
                payload = bz2.compress(raw)
            elif compression == "lz4":
                from . import lz4f

                payload = lz4f.compress_frame(raw)
            else:
                payload = raw
            chunk_pos = f.tell()
            f.write(_ser_record(
                {"op": bytes([OP_CHUNK]),
                 "compression": compression.encode(),
                 "size": _U32.pack(len(raw))}, payload))
            for cid, entries in sorted(index.items()):
                data = b"".join(_ser_time(t) + _U32.pack(off)
                                for t, off in entries)
                f.write(_ser_record(
                    {"op": bytes([OP_INDEX_DATA]), "ver": _U32.pack(1),
                     "conn": _U32.pack(cid),
                     "count": _U32.pack(len(entries))}, data))
            chunk_infos.append({
                "pos": chunk_pos, "t0": t_lo, "t1": t_hi,
                "counts": {cid: len(e) for cid, e in index.items()},
            })
            buf = bytearray()
            index = {}
            t_lo, t_hi = float("inf"), float("-inf")

        for t, topic, msg in messages:
            datatype, payload = _ser_msg(msg)
            key = (topic, datatype)
            if key not in conn_ids:
                cid = len(conn_ids)
                conn_ids[key] = cid
                rec = conn_record(cid, topic, datatype)
                conn_records.append(rec)
                buf += rec
            cid = conn_ids[key]
            index.setdefault(cid, []).append((t, len(buf)))
            t_lo, t_hi = min(t_lo, t), max(t_hi, t)
            buf += _ser_record(
                {"op": bytes([OP_MSG_DATA]), "conn": _U32.pack(cid),
                 "time": _ser_time(t)}, payload)
            if len(buf) >= chunk_threshold:
                flush()
        flush()

        index_pos = f.tell()
        for rec in conn_records:
            f.write(rec)
        for ci in chunk_infos:
            data = b"".join(_U32.pack(cid) + _U32.pack(n)
                            for cid, n in sorted(ci["counts"].items()))
            f.write(_ser_record(
                {"op": bytes([OP_CHUNK_INFO]), "ver": _U32.pack(1),
                 "chunk_pos": _U64.pack(ci["pos"]),
                 "start_time": _ser_time(ci["t0"]),
                 "end_time": _ser_time(ci["t1"]),
                 "count": _U32.pack(len(ci["counts"]))}, data))

        f.seek(header_pos)
        f.write(file_header(index_pos, len(conn_ids), len(chunk_infos)))


def frames_to_bag(path: str, frames, kind: str = "cloud",
                  sensor_topic: str = "/camera/depth_registered/points",
                  pose_topic: str = "/pose",
                  compression: str = "none") -> None:
    """Convert a replay frame list ``[(t, (pos, quat_wxyz), scan), ...]``
    (the format of ``io.replay.make_sequence`` / run.py's npz loader) into
    a bag, interleaving poses just ahead of their scans so the stream
    synchronizer matches them exactly."""
    def gen():
        for t, (pos, quat), scan in frames:
            yield t, pose_topic, make_transform(t, pos, quat)
            if kind == "cloud":
                yield t, sensor_topic, make_pointcloud2(t, scan)
            else:
                yield t, sensor_topic, make_depth_image(t, scan)
    write_bag(path, gen(), compression=compression)


# ---------------------------------------------------------------------------
# CLI: python -m fiesta_tpu_torch.io.rosbag {info|to-npz|from-npz} ...
# ---------------------------------------------------------------------------


def _cli(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m fiesta_tpu_torch.io.rosbag",
        description="ROS bag utilities (no ROS install needed)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("info", help="topic/type/count table (rosbag info)")
    pi.add_argument("bag")
    pn = sub.add_parser("to-npz",
                        help="convert a bag to run.py's .npz replay format")
    pn.add_argument("bag")
    pn.add_argument("npz")
    pn.add_argument("--sensor-topic")
    pn.add_argument("--pose-topic")
    pn.add_argument("--depth-scale", type=float, default=1000.0)
    pf = sub.add_parser("from-npz",
                        help="convert a .npz replay sequence to a bag")
    pf.add_argument("npz")
    pf.add_argument("bag")
    pf.add_argument("--compression", choices=["none", "bz2"],
                    default="none")
    args = p.parse_args(argv)

    if args.cmd == "info":
        print_bag_info(bag_info(args.bag))
        return 0

    if args.cmd == "to-npz":
        # run the ACTUAL live synchronizer over the stream (not a
        # re-implementation), so bag -> npz -> replay keeps exactly the
        # scans (and pose matches) that `run.py --bag` would
        from ..pipeline import ScanSynchronizer

        sensor, pose = pick_topics(bag_connections(args.bag),
                                   args.sensor_topic, args.pose_topic)
        sync = ScanSynchronizer()
        kind = None
        last_pose = None
        ts, poss, quats, scans = [], [], [], []

        def drain():
            for (t_scan, scan), _mt, mpos, mquat in sync.drain():
                ts.append(t_scan)
                poss.append(mpos)
                quats.append(mquat)
                scans.append(scan)

        for m in read_messages(args.bag, topics=[sensor, pose]):
            if m.topic == pose:
                sync.push_pose(m.t, m.msg.pos, m.msg.quat_wxyz)
                last_pose = (m.t, m.msg.pos, m.msg.quat_wxyz)
                continue
            if m.datatype == "sensor_msgs/PointCloud2":
                scan, k = m.msg.xyz(), "cloud"
            else:
                scan, k = m.msg.depth_m(args.depth_scale), "depth"
            if kind is None:
                kind = k
            elif kind != k:
                continue    # mixed sensor types: keep the first kind
            sync.push_depth(m.t, (m.t, scan))
            drain()
        if last_pose is not None:   # flush, exactly as run.py --bag does
            sync.push_pose(last_pose[0] + 1.0, *last_pose[1:])
            drain()
        if not ts:
            raise SystemExit("no (pose, scan) pairs found")
        shapes = {s.shape for s in scans}
        if len(shapes) > 1:
            if kind == "depth":
                raise SystemExit(
                    "depth resolution changes mid-bag; the fixed-shape npz "
                    "format cannot hold it — replay the bag directly "
                    "(run.py --bag rescales intrinsics on the fly)")
            # ragged clouds: pad to the largest with NaN (dropped by the
            # pipeline's finite mask)
            n = max(s[0] for s in shapes)
            scans = [np.pad(s, ((0, n - s.shape[0]), (0, 0)),
                            constant_values=np.nan) for s in scans]
        key = "clouds" if kind == "cloud" else "depths"
        np.savez_compressed(args.npz, t=np.asarray(ts),
                            pos=np.stack(poss), quat=np.stack(quats),
                            **{key: np.stack(scans)})
        print(f"wrote {args.npz}: {len(ts)} frames ({kind})")
        return 0

    data = np.load(args.npz)
    kind = "cloud" if "clouds" in data else "depth"
    frames = [
        (float(data["t"][i]), (data["pos"][i], data["quat"][i]),
         data["clouds"][i] if kind == "cloud" else data["depths"][i])
        for i in range(len(data["t"]))
    ]
    frames_to_bag(args.bag, frames, kind=kind,
                  compression=args.compression)
    print(f"wrote {args.bag}: {len(frames)} frames ({kind})")
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
