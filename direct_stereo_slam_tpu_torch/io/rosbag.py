"""Pure-Python rosbag v2.0 reader + stereo replay.

The port's copy of the JAX package's ``io/rosbag.py``, pinned to it by
``tests/test_torch_host_copies.py`` (record and image wire format, decode
and replay); it is host code on numpy, bz2 and struct only. Decoded
images are float32 numpy arrays: ``SLAMNode.process`` uploads them.

The reference ingests recorded data through the ROS bag API
(`rosbag::Bag` / `rosbag::View`, the reference's main.cpp:320-345):
it iterates the two image topics in time order, keeps the latest message
of each, and fires the stereo callback whenever both have updated, after
checking the pair's stamps agree within 0.1 s. This module reimplements
that surface with no ROS dependency: a self-contained parser for the
on-disk rosbag 2.0 format (the format kitti2bag produces, README.md:60)
plus `replay_stereo_bag` with the reference's exact pairing rule.

Format notes (rosbag 2.0): the file is a `#ROSBAG V2.0` magic line
followed by length-prefixed records. Each record is
``<u32 header_len><header><u32 data_len><data>`` where the header is a
sequence of ``<u32 len>name=value`` fields. Record types (``op`` field):
0x03 bag header, 0x07 connection, 0x05 chunk (data = a none/bz2
compressed stream of further records), 0x02 message data, 0x04 index,
0x06 chunk info. This reader scans all chunks (indexes are not
required), collects connections and message records, and yields messages
in time order — equivalent to an unfiltered `rosbag::View` with a topic
query.

Image decoding follows cv_bridge's ``toCvShare(msg, "mono8")``
conversions the reference relies on (main.cpp:216-217): mono8/8UC1
pass-through, rgb8/bgr8 via the OpenCV luma weights, mono16/16UC1
scaled by 1/256.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    off = 0
    n = len(buf)
    while off < n:
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1:]
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


@dataclass
class ImageMsg:
    """Deserialized sensor_msgs/Image."""

    stamp: float              # header.stamp in seconds
    frame_id: str
    height: int
    width: int
    encoding: str
    data: np.ndarray          # [H, W] float32 grayscale (cv_bridge mono8)


def _decode_image(data: bytes) -> ImageMsg:
    """sensor_msgs/Image wire format: std_msgs/Header (u32 seq, u32 secs,
    u32 nsecs, string frame_id), u32 height, u32 width, string encoding,
    u8 is_bigendian, u32 step, u8[] data (length-prefixed)."""
    off = 0
    _seq, secs, nsecs = struct.unpack_from("<III", data, off)
    off += 12
    (flen,) = struct.unpack_from("<I", data, off)
    off += 4
    frame_id = data[off:off + flen].decode("utf-8", "replace")
    off += flen
    height, width = struct.unpack_from("<II", data, off)
    off += 8
    (elen,) = struct.unpack_from("<I", data, off)
    off += 4
    encoding = data[off:off + elen].decode("ascii", "replace")
    off += elen
    _bigendian = data[off]
    off += 1
    (step,) = struct.unpack_from("<I", data, off)
    off += 4
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    raw = np.frombuffer(data, np.uint8, count=dlen, offset=off)

    if encoding in ("mono8", "8UC1"):
        img = raw.reshape(height, step)[:, :width].astype(np.float32)
    elif encoding in ("rgb8", "bgr8"):
        px = raw.reshape(height, step)[:, : width * 3].reshape(
            height, width, 3).astype(np.float32)
        r_i, b_i = (0, 2) if encoding == "rgb8" else (2, 0)
        # cv_bridge -> cv::cvtColor luma weights
        img = 0.299 * px[..., r_i] + 0.587 * px[..., 1] + 0.114 * px[..., b_i]
    elif encoding in ("mono16", "16UC1"):
        px16 = raw[: height * step].view("<u2").reshape(
            height, step // 2)[:, :width]
        img = (px16.astype(np.float32) / 256.0)
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return ImageMsg(stamp=secs + 1e-9 * nsecs, frame_id=frame_id,
                    height=height, width=width, encoding=encoding, data=img)


class RosbagReader:
    """Parse a rosbag v2.0 file; iterate (topic, time, raw-data) messages
    in chronological order (stable on ties, like rosbag::View)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(_MAGIC):
            raise ValueError(f"{path}: not a rosbag v2.0 file")
        self.connections: Dict[int, Dict[bytes, bytes]] = {}
        self._messages: List[Tuple[float, int, bytes]] = []

        def scan(stream: bytes, off: int):
            for header, data in _iter_records(stream, off):
                op = header[b"op"][0]
                if op == OP_CONNECTION:
                    (conn,) = struct.unpack("<I", header[b"conn"])
                    self.connections[conn] = _parse_header(data)
                elif op == OP_CHUNK:
                    comp = header.get(b"compression", b"none")
                    if comp == b"none":
                        inner = data
                    elif comp == b"bz2":
                        inner = bz2.decompress(data)
                    else:
                        raise ValueError(
                            f"unsupported chunk compression {comp!r}")
                    scan(inner, 0)
                elif op == OP_MSG:
                    (conn,) = struct.unpack("<I", header[b"conn"])
                    secs, nsecs = struct.unpack("<II", header[b"time"])
                    self._messages.append((secs + 1e-9 * nsecs, conn, data))
                # bag header / index / chunk info records carry no payload
                # we need (indexes are an optimization; we scanned anyway)

        scan(buf, len(_MAGIC))
        self._messages.sort(key=lambda m: m[0])

    def topic(self, conn: int) -> str:
        return self.connections[conn].get(b"topic", b"").decode()

    def topics(self) -> Dict[str, str]:
        """topic -> message type."""
        return {
            c.get(b"topic", b"").decode(): c.get(b"type", b"").decode()
            for c in self.connections.values()
        }

    def messages(self, topics: Optional[Sequence[str]] = None
                 ) -> Iterator[Tuple[str, float, bytes]]:
        want = set(topics) if topics is not None else None
        for t, conn, data in self._messages:
            topic = self.topic(conn)
            if want is None or topic in want:
                yield topic, t, data

    def images(self, topics: Optional[Sequence[str]] = None
               ) -> Iterator[Tuple[str, ImageMsg]]:
        for topic, _t, data in self.messages(topics):
            yield topic, _decode_image(data)


def replay_stereo_bag(
    path: str,
    topic0: str,
    topic1: str,
    callback: Callable[[ImageMsg, ImageMsg], None],
    max_pairs: Optional[int] = None,
    stamp_tolerance: float = 0.1,
) -> int:
    """The reference's bag replay loop (main.cpp:325-345): walk both
    topics in time order, keep the latest message of each, fire
    ``callback(img0, img1)`` whenever both updated. The reference asserts
    the pair's stamps agree within 0.1 s; here a violating pair is
    dropped (both-updated flags reset) with the same tolerance, so a
    malformed bag degrades instead of aborting. Returns pairs fired."""
    reader = RosbagReader(path)
    img0 = img1 = None
    upd0 = upd1 = False
    fired = 0
    for topic, msg in reader.images((topic0, topic1)):
        if topic == topic0:
            img0, upd0 = msg, True
        else:
            img1, upd1 = msg, True
        if upd0 and upd1:
            if abs(img0.stamp - img1.stamp) < stamp_tolerance:
                callback(img0, img1)
                fired += 1
                if max_pairs is not None and fired >= max_pairs:
                    break
            upd0 = upd1 = False
    return fired


# ---------------------------------------------------------------------------
# writer (tests / tooling): minimal valid v2.0 bag
# ---------------------------------------------------------------------------


def _field(name: bytes, value: bytes) -> bytes:
    f = name + b"=" + value
    return struct.pack("<I", len(f)) + f


def _record(fields: List[Tuple[bytes, bytes]], data: bytes) -> bytes:
    header = b"".join(_field(n, v) for n, v in fields)
    return (struct.pack("<I", len(header)) + header
            + struct.pack("<I", len(data)) + data)


def serialize_image(img: np.ndarray, stamp: float, frame_id: str = "cam",
                    encoding: str = "mono8") -> bytes:
    """Serialize a [H, W] uint8 array as sensor_msgs/Image (mono8)."""
    assert encoding == "mono8"
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fid = frame_id.encode()
    return (struct.pack("<III", 0, secs, nsecs)
            + struct.pack("<I", len(fid)) + fid
            + struct.pack("<II", h, w)
            + struct.pack("<I", 5) + b"mono8"
            + b"\x00" + struct.pack("<I", w)
            + struct.pack("<I", h * w) + img.tobytes())


def write_stereo_bag(path: str,
                     messages: Sequence[Tuple[str, float, np.ndarray]],
                     compression: str = "none"):
    """Write a minimal rosbag v2.0 with sensor_msgs/Image messages
    (mono8). ``messages`` = (topic, stamp, [H, W] uint8). One chunk."""
    topics = sorted({t for t, _, _ in messages})
    conn_of = {t: i for i, t in enumerate(topics)}

    chunk_body = b""
    for t in topics:
        conn_hdr = (_field(b"topic", t.encode())
                    + _field(b"type", b"sensor_msgs/Image")
                    + _field(b"md5sum", b"060021388200f6f0f447d0fcd9c64743")
                    + _field(b"message_definition", b""))
        chunk_body += _record(
            [(b"op", bytes([OP_CONNECTION])),
             (b"conn", struct.pack("<I", conn_of[t])),
             (b"topic", t.encode())],
            conn_hdr)
    for topic, stamp, img in messages:
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        chunk_body += _record(
            [(b"op", bytes([OP_MSG])),
             (b"conn", struct.pack("<I", conn_of[topic])),
             (b"time", struct.pack("<II", secs, nsecs))],
            serialize_image(img, stamp))

    if compression == "bz2":
        chunk_data, comp = bz2.compress(chunk_body), b"bz2"
    else:
        chunk_data, comp = chunk_body, b"none"

    with open(path, "wb") as f:
        f.write(_MAGIC)
        # bag header record, data padded with spaces to 4096 bytes total
        bh_fields = [(b"op", bytes([OP_BAG_HEADER])),
                     (b"index_pos", struct.pack("<Q", 0)),
                     (b"conn_count", struct.pack("<I", len(topics))),
                     (b"chunk_count", struct.pack("<I", 1))]
        header = b"".join(_field(n, v) for n, v in bh_fields)
        pad = 4096 - 8 - len(header)
        f.write(struct.pack("<I", len(header)) + header
                + struct.pack("<I", pad) + b" " * pad)
        f.write(_record(
            [(b"op", bytes([OP_CHUNK])),
             (b"compression", comp),
             (b"size", struct.pack("<I", len(chunk_body)))],
            chunk_data))
