"""Live ROS1 topic transport — pure-stdlib TCPROS + master/slave APIs.

The port's copy of the JAX package's ``io/ros_transport.py`` (the
TCPROS connection header is pinned to it by
``tests/test_torch_host_copies.py``), on the port's own ``io/rosbag``
message codec and ``io/sync.ApproximateTimeSync``.

The reference's live mode subscribes to two sensor_msgs/Image topics
through roscpp + message_filters ApproximateTime (the reference's
main.cpp:347-362). This module implements the wire protocols those stand
on, with no ROS installation:

* **TCPROS**: length-prefixed connection header (callerid / topic /
  md5sum / type fields), then ``<u32 len><serialized message>`` frames.
* **Slave XML-RPC API** (every node runs one): ``requestTopic`` (returns
  the TCPROS endpoint) and ``publisherUpdate`` (master pushes publisher
  lists to subscribers).
* **Master XML-RPC API**: ``registerPublisher`` / ``registerSubscriber``
  — ``MiniMaster`` here is a protocol-faithful stand-in usable when no
  rosmaster exists (tests, self-contained deployments); against a real
  ROS1 system, point ``ImageSubscriber`` at its ``ROS_MASTER_URI``.

``StereoTopicSource`` composes two ``ImageSubscriber``s with the
ApproximateTime pairing in ``io/sync.py`` — the reference's
message_filters configuration — and hands synced stereo pairs to a
callback (``SLAMNode.process``) on its own thread, in arrival order. No
pair is dropped: the queue between the receive threads and that thread
is unbounded, and ``close()`` processes what was received before it
stops.

Failures are not swallowed, where the JAX package prints them and goes
on: a socket error ends its connection quietly (the publisher went
away), but any other failure of a connection (a malformed message, a
sync error) and any failure of the stereo callback is kept, the first
one of each object, and ``close()`` raises it. After a callback failure
the source only drains its queue.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple
from xmlrpc.client import Error as XmlRpcError
from xmlrpc.client import ServerProxy
from xmlrpc.server import SimpleXMLRPCServer

import numpy as np

from .rosbag import ImageMsg, _decode_image, serialize_image
from .sync import ApproximateTimeSync

IMAGE_MD5 = "060021388200f6f0f447d0fcd9c64743"   # sensor_msgs/Image
IMAGE_TYPE = "sensor_msgs/Image"


def _encode_header(fields: Dict[str, str]) -> bytes:
    body = b""
    for k, v in fields.items():
        f = f"{k}={v}".encode()
        body += struct.pack("<I", len(f)) + f
    return struct.pack("<I", len(body)) + body


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _read_header(sock: socket.socket) -> Dict[str, str]:
    (n,) = struct.unpack("<I", _read_exact(sock, 4))
    body = _read_exact(sock, n)
    fields: Dict[str, str] = {}
    off = 0
    while off < n:
        (flen,) = struct.unpack_from("<I", body, off)
        off += 4
        f = body[off:off + flen].decode("utf-8", "replace")
        off += flen
        k, _, v = f.partition("=")
        fields[k] = v
    return fields


class _FirstError:
    """The first exception of a set of threads, raised on demand."""

    def __init__(self, what: str):
        self.what = what
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def keep(self, e: BaseException) -> None:
        with self._lock:
            if self.error is None:
                self.error = e

    def raise_if_any(self) -> None:
        if self.error is not None:
            raise RuntimeError(self.what) from self.error


class _XmlRpcServerThread:
    """A SimpleXMLRPCServer on an ephemeral port, serving on a thread."""

    def __init__(self, instance):
        self.server = SimpleXMLRPCServer(
            ("127.0.0.1", 0), allow_none=True, logRequests=False)
        self.server.register_instance(instance)
        self.port = self.server.server_address[1]
        self.uri = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=5)


class MiniMaster:
    """Protocol-faithful rosmaster stand-in (register/lookup only)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pubs: Dict[str, List[Tuple[str, str]]] = {}   # topic -> [(id, uri)]
        self._subs: Dict[str, List[Tuple[str, str]]] = {}
        self._srv = _XmlRpcServerThread(self)
        self.uri = self._srv.uri

    # --- master API (subset) -------------------------------------------
    def registerPublisher(self, caller_id, topic, topic_type, caller_api):
        with self._lock:
            entry = (caller_id, caller_api)
            pubs = self._pubs.setdefault(topic, [])
            if entry not in pubs:
                pubs.append(entry)
            subs = list(self._subs.get(topic, []))
            pub_uris = [u for _, u in pubs]
        # push publisherUpdate to subscribers (the real master does); a
        # subscriber that went away is the master's to forget, as rosmaster
        for _, sub_uri in subs:
            try:
                ServerProxy(sub_uri).publisherUpdate(
                    "/master", topic, pub_uris)
            except (OSError, XmlRpcError):
                pass
        return 1, "registered", [u for _, u in subs]

    def registerSubscriber(self, caller_id, topic, topic_type, caller_api):
        with self._lock:
            entry = (caller_id, caller_api)
            subs = self._subs.setdefault(topic, [])
            if entry not in subs:
                subs.append(entry)
            return 1, "registered", [u for _, u in self._pubs.get(topic, [])]

    def unregisterPublisher(self, caller_id, topic, caller_api):
        with self._lock:
            self._pubs[topic] = [
                e for e in self._pubs.get(topic, []) if e[1] != caller_api]
        return 1, "unregistered", 1

    def unregisterSubscriber(self, caller_id, topic, caller_api):
        with self._lock:
            self._subs[topic] = [
                e for e in self._subs.get(topic, []) if e[1] != caller_api]
        return 1, "unregistered", 1

    def close(self):
        self._srv.close()


class ImagePublisher:
    """TCPROS publisher for one sensor_msgs/Image topic."""

    def __init__(self, topic: str, master_uri: str,
                 caller_id: str = "/dsslam_pub"):
        self.topic = topic
        self.caller_id = caller_id
        self._subs: List[socket.socket] = []
        self._lock = threading.Lock()

        self._tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._tcp.bind(("127.0.0.1", 0))
        self._tcp.listen(8)
        self.tcp_port = self._tcp.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

        self._srv = _XmlRpcServerThread(self)          # slave API
        ServerProxy(master_uri).registerPublisher(
            caller_id, topic, IMAGE_TYPE, self._srv.uri)

    # --- slave API ------------------------------------------------------
    def requestTopic(self, caller_id, topic, protocols):
        for proto in protocols:
            if proto and proto[0] == "TCPROS":
                return 1, "ready", ["TCPROS", "127.0.0.1", self.tcp_port]
        return 0, "no supported protocol", []

    def getBusInfo(self, caller_id):
        return 1, "", []

    # --- TCPROS ----------------------------------------------------------
    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._tcp.accept()
            except OSError:
                return
            try:
                _read_header(conn)                     # subscriber header
                conn.sendall(_encode_header({
                    "callerid": self.caller_id,
                    "md5sum": IMAGE_MD5,
                    "type": IMAGE_TYPE,
                    "latching": "0",
                }))
                with self._lock:
                    self._subs.append(conn)
            except (OSError, struct.error):           # the subscriber went away
                conn.close()

    @property
    def connected(self) -> int:
        """Subscribers connected now."""
        with self._lock:
            return len(self._subs)

    def publish(self, img: np.ndarray, stamp: float,
                frame_id: str = "cam"):
        data = serialize_image(np.asarray(img, np.uint8), stamp, frame_id)
        frame = struct.pack("<I", len(data)) + data
        with self._lock:
            alive = []
            for s in self._subs:
                try:
                    s.sendall(frame)
                    alive.append(s)
                except OSError:
                    s.close()
            self._subs = alive

    def close(self):
        try:
            self._tcp.shutdown(socket.SHUT_RDWR)   # wakes the accept loop
        except OSError:
            pass
        self._tcp.close()
        self._accept_thread.join(timeout=5)
        with self._lock:
            for s in self._subs:
                s.close()
            self._subs = []
        self._srv.close()


class ImageSubscriber:
    """TCPROS subscriber for one sensor_msgs/Image topic. Decoded
    messages go to ``callback(ImageMsg)`` on the receive thread. A socket
    error ends its connection quietly; any other failure ends it and is
    raised by ``close()``."""

    def __init__(self, topic: str, master_uri: str,
                 callback: Callable[[ImageMsg], None],
                 caller_id: str = "/dsslam_sub"):
        self.topic = topic
        self.caller_id = caller_id
        self.callback = callback
        self._connected: set = set()
        self._lock = threading.Lock()
        self._closed = False
        self._socks: List[socket.socket] = []
        self._failure = _FirstError(f"subscriber of {topic} failed")

        self._srv = _XmlRpcServerThread(self)          # slave API
        code, _msg, pubs = ServerProxy(master_uri).registerSubscriber(
            caller_id, topic, IMAGE_TYPE, self._srv.uri)
        if code == 1:
            self.publisherUpdate("/master", topic, pubs)

    @property
    def failed(self) -> bool:
        return self._failure.error is not None

    # --- slave API ------------------------------------------------------
    def publisherUpdate(self, caller_id, topic, publishers):
        if topic == self.topic:
            for uri in publishers:
                with self._lock:
                    if uri in self._connected or self._closed:
                        continue
                    self._connected.add(uri)
                threading.Thread(target=self._connect_loop, args=(uri,),
                                 daemon=True).start()
        return 1, "", 0

    def getBusInfo(self, caller_id):
        return 1, "", []

    # --- TCPROS ----------------------------------------------------------
    def _connect_loop(self, pub_uri: str):
        try:
            _c, _m, proto = ServerProxy(pub_uri).requestTopic(
                self.caller_id, self.topic, [["TCPROS"]])
            _, host, port = proto
            sock = socket.create_connection((host, port), timeout=10)
            sock.settimeout(None)       # a camera may pause: no idle limit
            with self._lock:
                if self._closed:
                    sock.close()
                    return
                self._socks.append(sock)
            sock.sendall(_encode_header({
                "callerid": self.caller_id,
                "topic": self.topic,
                "md5sum": IMAGE_MD5,
                "type": IMAGE_TYPE,
                "tcp_nodelay": "1",
            }))
            _read_header(sock)                          # publisher header
            while True:
                (n,) = struct.unpack("<I", _read_exact(sock, 4))
                data = _read_exact(sock, n)
                self.callback(_decode_image(data))
        except OSError:
            pass                        # the connection ended
        except Exception as e:  # noqa: BLE001 — kept for close()
            self._failure.keep(e)
        finally:
            with self._lock:
                self._connected.discard(pub_uri)

    def close(self):
        """Disconnect; raise the first failure of a connection."""
        with self._lock:
            self._closed = True
            for s in self._socks:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                s.close()
            self._socks = []
        self._srv.close()
        self._failure.raise_if_any()


class StereoTopicSource:
    """Two live image topics -> ApproximateTime-synced stereo pairs
    (the reference's message_filters setup, main.cpp:347-362).

    ``callback(img0: ImageMsg, img1: ImageMsg)`` fires on an internal
    thread in arrival order. ``max_queue`` is the deepest the queue of
    synced pairs waiting for the callback has been. ``close()`` stops
    receiving, processes the pairs already queued, stops the thread and
    raises the first failure of the callback or of a connection."""

    def __init__(self, master_uri: str, topic0: str, topic1: str,
                 callback: Callable[[ImageMsg, ImageMsg], None],
                 queue_size: int = 10, slop: float = 0.05):
        self._sync = ApproximateTimeSync(slop, queue_size=queue_size)
        self._sync_lock = threading.Lock()   # push() from both rx threads
        self._out: "queue.Queue" = queue.Queue()
        self._cb = callback
        self._stop = threading.Event()
        self._failure = _FirstError("the stereo callback failed")
        self.max_queue = 0

        def on_msg(stream):
            def handler(msg: ImageMsg):
                with self._sync_lock:
                    pairs = self._sync.push(stream, msg.stamp, msg)
                    for _t0, m0, _t1, m1 in pairs:
                        self._out.put((m0, m1))
                    self.max_queue = max(self.max_queue, self._out.qsize())
            return handler

        self.sub0 = ImageSubscriber(topic0, master_uri, on_msg(0),
                                    caller_id="/dsslam_sub0")
        self.sub1 = ImageSubscriber(topic1, master_uri, on_msg(1),
                                    caller_id="/dsslam_sub1")
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    @property
    def failed(self) -> bool:
        """The callback or a connection has failed (``close()`` raises)."""
        return (self._failure.error is not None or self.sub0.failed
                or self.sub1.failed)

    def _drain(self):
        while not (self._stop.is_set() and self._out.empty()):
            try:
                a, b = self._out.get(timeout=0.05)
            except queue.Empty:
                continue
            if self._failure.error is not None:
                continue                # after a failure, only drain
            try:
                self._cb(a, b)
            except Exception as e:  # noqa: BLE001 — kept for close()
                self._failure.keep(e)

    def close(self):
        errors = []
        for sub in (self.sub0, self.sub1):
            try:
                sub.close()
            except RuntimeError as e:
                errors.append(e)
        self._stop.set()
        self._thread.join()
        self._failure.raise_if_any()
        if errors:
            raise errors[0]
