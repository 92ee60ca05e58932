"""Streaming loaders: samples arrive at run time, not load time
(counterpart of ``veles_tpu/loader/stream.py``).

- ``InteractiveLoader``: samples fed from the owning process;
- ``RestfulLoader``: fed by the ``RESTfulAPI`` unit, one (sample,
  ticket) per HTTP request;
- ``ZeroMQLoader``: pickled work items received on a ZeroMQ ROUTER
  socket from external producers (``zmq`` imported at ``initialize``);
- the image variants, which decode an image payload with the training
  loader's size and color policy.

All are one ``StreamLoader``: a thread-safe queue of samples that
``run()`` drains into ``minibatch_data`` on the host, and ``close()``
stops the owning workflow on its next run. With ``minibatch_size`` > 1
a run serves every sample queued at that moment (dynamic batching):
concurrent requests share one forward dispatch on the card.
"""

from __future__ import annotations

import pickle
import queue as queue_mod
import threading
from typing import Any, Optional, Tuple

import numpy

from ..error import VelesError
from .base import Loader, TEST


class LoaderClosed(VelesError):
    """A feed after ``close()``: the service is shutting down (a server
    state, which the REST front answers 503, not a client's fault)."""


class StreamLoader(Loader):
    """Queue-fed loader: ``feed(sample[, label, ticket])`` from any
    thread; ``run()`` blocks until a sample (or the close) arrives."""

    MAPPING = "interactive_loader"
    hide_from_registry = False

    def __init__(self, workflow, sample_shape: Tuple[int, ...] = (),
                 timeout: float = 60.0, **kwargs) -> None:
        kwargs.setdefault("minibatch_size", 1)
        super().__init__(workflow, **kwargs)
        self.sample_shape = tuple(sample_shape)
        self.timeout = timeout
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._closed = threading.Event()
        #: the ticket of each row of the current minibatch (REST routing)
        self.current_tickets: list = []

    # -- producer side (any thread) ------------------------------------------
    def feed(self, sample, label: Optional[int] = None,
             ticket: Any = None) -> None:
        """Queue one sample. A shape other than ``sample_shape`` raises
        here, on the producer's thread, so it fails the one request that
        sent it and never the serving loop."""
        if self._closed.is_set():
            raise LoaderClosed("%s is closed" % self.name)
        sample = numpy.asarray(sample)
        if self.sample_shape and sample.shape != self.sample_shape:
            raise VelesError("sample shape %s != declared %s"
                             % (sample.shape, self.sample_shape))
        self._queue.put((sample, label, ticket))

    def parse_request(self, body: dict) -> numpy.ndarray:
        """A REST request body as a sample: the numeric ``input`` field
        (the image variants also decode an ``image`` payload). The
        loader owns its wire format; ``RESTfulAPI`` delegates here."""
        return numpy.asarray(body["input"], dtype=numpy.float32)

    def close(self) -> None:
        self._closed.set()
        self._queue.put(None)   # wake a blocked run()

    # -- loader contract ------------------------------------------------------
    def load_data(self) -> None:
        if not self.sample_shape:
            raise VelesError("%s needs sample_shape" % self.name)
        # the stream's length is unknown; what is served is TEST
        self.class_lengths = [1, 0, 0]

    def create_minibatch_data(self) -> None:
        from ..config import root
        dtype = root.common.engine.precision_type
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape, dtype=dtype))
        self.minibatch_labels.reset(numpy.zeros(
            self.max_minibatch_size, dtype=numpy.int32))

    def fill_minibatch(self) -> None:  # pragma: no cover - not used
        pass

    def run(self) -> None:
        """Block for the first sample, then drain whatever else is
        queued, up to ``max_minibatch_size``, into one minibatch; a
        close met mid-drain serves this batch and stops the workflow on
        the next run."""
        try:
            item = self._queue.get(timeout=self.timeout)
        except queue_mod.Empty:
            raise VelesError("%s: no sample within %.0fs"
                             % (self.name, self.timeout))
        if item is None or self._closed.is_set():
            self.workflow.stop()
            return
        batch = [item]
        while len(batch) < self.max_minibatch_size:
            try:
                nxt = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if nxt is None:
                self._queue.put(None)
                break
            batch.append(nxt)
        data = self.minibatch_data.map_invalidate()
        labels_arr = self.minibatch_labels.map_invalidate()
        self.current_tickets = []
        for row, (sample, label, ticket) in enumerate(batch):
            data[row] = sample
            # an unlabeled row must not keep the label an earlier
            # dispatch parked at the same row
            labels_arr[row] = 0 if label is None else label
            self.current_tickets.append(ticket)
        self.minibatch_class = TEST
        self.minibatch_size = len(batch)
        self.samples_served += len(batch)


class InteractiveLoader(StreamLoader):
    """Fed from the owning process (the reference's name)."""


class RestfulLoader(StreamLoader):
    """Fed by the ``RESTfulAPI`` unit with a ticket a request."""

    MAPPING = "restful_loader"


class _ImageStreamMixin:
    """Decode before enqueueing: raw encoded image bytes (``feed``) or a
    base64 ``image`` JSON field (REST), decoded with the training
    loader's size and color policy; ``size`` defaults to the declared
    sample shape's, so an image of other dimensions is resized, not
    refused downstream."""

    def __init__(self, workflow, size=None, color: str = "RGB",
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if size is None and len(self.sample_shape) >= 2:
            size = self.sample_shape[:2]
        self.size = size
        self.color = color

    def decode_sample(self, data: bytes) -> numpy.ndarray:
        from .image import decode_image
        return decode_image(bytes(data), self.size, self.color)

    def feed(self, sample, label: Optional[int] = None,
             ticket: Any = None) -> None:
        if isinstance(sample, (bytes, bytearray)):
            sample = self.decode_sample(sample)
        super().feed(sample, label, ticket)

    def parse_request(self, body: dict) -> numpy.ndarray:
        if "image" in body:
            import base64
            return self.decode_sample(base64.b64decode(body["image"]))
        return super().parse_request(body)


class InteractiveImageLoader(_ImageStreamMixin, InteractiveLoader):
    """Image samples fed from the owning process."""

    MAPPING = "interactive_image_loader"


class RestfulImageLoader(_ImageStreamMixin, RestfulLoader):
    """Image samples fed by the ``RESTfulAPI`` unit."""

    MAPPING = "restful_image_loader"


class ZeroMQLoader(StreamLoader):
    """Pickled ``(sample, label)`` work items received on a ZeroMQ ROUTER
    socket: a daemon thread polls the socket and feeds the queue; each
    item is acknowledged ``b"ok"``, and an empty payload closes the
    stream (acknowledged ``b"bye"``). Producers use DEALER sockets.
    ``bound_endpoint`` is the address after the bind (``:0`` picks a
    free port)."""

    MAPPING = "zeromq_loader"

    def __init__(self, workflow, endpoint: str = "tcp://*:0",
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.endpoint = endpoint
        self.bound_endpoint: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._ctx = None

    def initialize(self, **kwargs):
        res = super().initialize(**kwargs)
        if res:
            return res
        import zmq
        self._ctx = zmq.Context.instance()
        sock = self._ctx.socket(zmq.ROUTER)
        if self.endpoint.endswith(":0"):
            port = sock.bind_to_random_port(self.endpoint[:-2])
            self.bound_endpoint = "%s:%d" % (
                self.endpoint[:-2].replace("*", "127.0.0.1"), port)
        else:
            sock.bind(self.endpoint)
            self.bound_endpoint = self.endpoint.replace("*", "127.0.0.1")
        self._thread = threading.Thread(
            target=self._drain, args=(sock,), daemon=True,
            name=self.name + ".zmq")
        self._thread.start()
        self.info("%s: listening on %s", self.name, self.bound_endpoint)
        return None

    def _drain(self, sock) -> None:
        import zmq
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        # a poll with a timeout, so stop()/close() end the thread (and
        # free the port) without touching the socket from another thread
        while not self._closed.is_set():
            if not poller.poll(200):
                continue
            try:
                ident, payload = sock.recv_multipart()
            except Exception:
                break
            if not payload:
                sock.send_multipart([ident, b"bye"])
                self.close()
                break
            sample, label = pickle.loads(payload)
            self.feed(sample, label, ticket=ident)
            sock.send_multipart([ident, b"ok"])
        sock.close(0)

    def stop(self) -> None:
        super().stop()
        self._closed.set()
