"""Batched sampling service on the GPU, from a flat-npz weights file.

Counterpart of small_vision_tpu/tools/serve.py. The 125-step DDIM sampler
runs at a fixed batch; throughput comes from keeping that batch full,
latency from not waiting longer than needed to fill it. This server runs
the dynamic-batching loop around the sampler:

  request(n)  ->  queue  ->  coalesce up to `batch_size` images with a
  `max_wait_ms` deadline  ->  ONE sampler call  ->  slice per request

Endpoints (JSON over HTTP, stdlib-only — no server deps):
  POST /sample   {"n": 4, "seed": 123?}      -> npz bytes {"images": uint8}
  GET  /healthz                              -> {"ok": true, ...}
  GET  /stats                                -> latency/throughput counters

Run with the EMA weights as a flat .npz (the JAX package's
`export_sampler --weights_mode arg --weights_out` writes one):
  python -m small_vision_tpu_torch.tools.serve \\
      --config ae_i1k.py:variant=B/4 --weights ema.npz \\
      --fn uncond_eps --batch_size 64 --port 8777
"""

import argparse
import io
import json
import queue
import threading
import time

import numpy as np


class ServerOverloaded(Exception):
  """Bounded request queue is full; carries a retry-after estimate (s)."""

  def __init__(self, retry_after_s):
    super().__init__(f"server overloaded, retry after ~{retry_after_s:.1f}s")
    self.retry_after_s = retry_after_s


class ServerClosing(Exception):
  """Server is draining; no new requests accepted."""


class _Request:
  __slots__ = ("n", "seed", "event", "result", "error", "t_enqueue",
               "parts", "left")

  def __init__(self, n, seed):
    self.n = n
    self.seed = seed
    self.event = threading.Event()
    self.result = None
    self.error = None
    self.t_enqueue = time.perf_counter()
    self.parts = []   # image slices served so far (split requests)
    self.left = n     # images still to serve


class SamplerServer:
  """Dynamic-batching wrapper around `sample(seed) -> uint8 [B, H, W, C]`.

  Concurrency contract: `sample()` is called from N HTTP handler threads;
  one worker thread drains the queue. `stats` is only touched under `_lock`
  (handler threads and the worker both increment it — unlocked dict ops lost
  counts under threading). Coalescing is strict FIFO: a request that would
  overflow the batch is parked in `_pending` as a (request, remaining) span
  (not re-queued behind newer arrivals) and leads the next batch; with
  `split_requests` (default), an unseeded overflower first ships the chunk
  that fits. The queue is bounded; `sample()` on a full queue raises
  ServerOverloaded -> HTTP 429 with a Retry-After derived from the measured
  sampler latency.
  """

  def __init__(self, sample_fn, batch_size, *, max_wait_ms=200.0,
               max_queue_batches=8, split_requests=True):
    self.sample_fn = sample_fn
    self.batch_size = int(batch_size)
    self.max_wait_s = max_wait_ms / 1e3
    # split_requests: an UNSEEDED request that would overflow the batch is
    # split — the fitting chunk ships now, the remainder leads the next
    # batch (same FIFO position), so batches stay full under saturated
    # load; parking alone can't fill a batch whose remainder is smaller
    # than the next request. Seeded
    # requests are NEVER split: their images must come from one sampler
    # call. split_requests=False restores strict parking for all.
    self.split_requests = bool(split_requests)
    # Bound in requests: worst case every request is size 1, so allowing
    # `max_queue_batches` full batches of singles keeps the worst-case wait
    # at ~max_queue_batches * sampler_latency.
    self.queue = queue.Queue(maxsize=max_queue_batches * self.batch_size)
    self._lock = threading.Lock()
    self.stats = {"requests": 0, "images": 0, "batches": 0, "rejected": 0,
                  "batch_fill_sum": 0.0, "latency_ms_sum": 0.0,
                  "sampler_ms_last": 0.0}
    self._pending = None  # over-size head-of-line request, leads next batch
    self._seed_ctr = 0
    self._stop = threading.Event()
    self._closing = threading.Event()
    self._worker = threading.Thread(target=self._loop, daemon=True)
    self._worker.start()

  # -- client side ---------------------------------------------------------
  def sample(self, n, seed=None, timeout=600.0):
    if not 0 < n <= self.batch_size:
      raise ValueError(f"n must be in [1, {self.batch_size}], got {n}")
    if self._closing.is_set():
      raise ServerClosing("server is draining")
    req = _Request(int(n), seed)
    try:
      self.queue.put_nowait(req)
    except queue.Full:
      with self._lock:
        self.stats["rejected"] += 1
        sampler_s = self.stats["sampler_ms_last"] / 1e3 or 1.0
      raise ServerOverloaded(
          retry_after_s=max(1.0, self.queue.qsize() / self.batch_size
                            * sampler_s)) from None
    if not req.event.wait(timeout):
      raise TimeoutError("sampler batch did not complete in time")
    if req.error is not None:
      raise req.error
    with self._lock:
      self.stats["requests"] += 1
      self.stats["images"] += req.n
      self.stats["latency_ms_sum"] += (
          time.perf_counter() - req.t_enqueue) * 1e3
    return req.result

  def stats_snapshot(self):
    with self._lock:
      return dict(self.stats)

  def close(self, drain=True, drain_timeout=600.0):
    """Stops the worker. With drain=True (default), first rejects new
    requests and waits for every queued/pending request to complete."""
    self._closing.set()
    if drain:
      deadline = time.perf_counter() + drain_timeout
      while ((not self.queue.empty() or self._pending is not None)
             and time.perf_counter() < deadline):
        time.sleep(0.05)
    self._stop.set()
    self._worker.join(timeout=30)

  # -- batching worker -----------------------------------------------------
  def _take_batch(self):
    """Takes the pending head-of-line span (if any), then coalesces from
    the queue until the batch is full or the deadline passes. Returns a
    list of (request, count) spans. Strict FIFO: an arrival that would
    overflow is parked in `_pending` and is the FIRST span of the next
    batch — never re-queued behind newer requests. With split_requests, an
    overflowing UNSEEDED request instead ships its fitting chunk now and
    parks only the remainder (same FIFO position, fuller batches)."""
    batch, used = [], 0
    if self._pending is not None:
      req, count = self._pending
      take = min(count, self.batch_size)
      batch, used = [(req, take)], take
      self._pending = (req, count - take) if count > take else None
    else:
      try:
        first = self.queue.get(timeout=0.1)
      except queue.Empty:
        return []
      batch, used = [(first, first.n)], first.n
    deadline = time.perf_counter() + self.max_wait_s
    while used < self.batch_size and self._pending is None:
      remaining = deadline - time.perf_counter()
      if remaining <= 0:
        break
      try:
        nxt = self.queue.get(timeout=remaining)
      except queue.Empty:
        break
      if used + nxt.n > self.batch_size:
        room = self.batch_size - used
        if self.split_requests and nxt.seed is None and room > 0:
          batch.append((nxt, room))
          used += room
          self._pending = (nxt, nxt.n - room)
        else:
          self._pending = (nxt, nxt.n)
        break
      batch.append((nxt, nxt.n))
      used += nxt.n
    return batch

  def _loop(self):
    while not self._stop.is_set():
      batch = self._take_batch()
      if not batch:
        continue
      try:
        seed = batch[0][0].seed
        if seed is None:
          self._seed_ctr += 1
          seed = self._seed_ctr
        t0 = time.perf_counter()
        images = np.asarray(self.sample_fn(int(seed)))
        with self._lock:
          self.stats["sampler_ms_last"] = (time.perf_counter() - t0) * 1e3
          self.stats["batches"] += 1
          self.stats["batch_fill_sum"] += (
              sum(c for _, c in batch) / self.batch_size)
        off = 0
        for r, count in batch:
          r.parts.append(images[off:off + count])
          off += count
          r.left -= count
          if r.left == 0:
            r.result = (r.parts[0] if len(r.parts) == 1
                        else np.concatenate(r.parts))
            r.event.set()
      except Exception as e:  # noqa: BLE001 — propagate to every waiter,
        # including partially-served split requests (error wins).
        for r, _ in batch:
          r.error = e
          r.event.set()
        if self._pending is not None and self._pending[0].error is not None:
          # Drop the parked remainder of a request this batch errored —
          # it can never complete and would wedge drain.
          self._pending = None


def build_sample_fn(args):
  """sample(seed) -> uint8 images, from --config and --weights."""
  from small_vision_tpu_torch.configs import parse_config
  from small_vision_tpu_torch.tools import export_sampler
  from small_vision_tpu_torch.utils.checkpoint import load_params_npz

  config = parse_config(args.config)
  params = load_params_npz(args.weights)
  print(f"[serve] weights: {args.weights}")
  sample = export_sampler.build_sample_callable(
      config, params, fn=args.fn, batch_size=args.batch_size,
      device=args.device)
  return sample, int(args.batch_size)


def make_http_server(server: SamplerServer, port: int, host="0.0.0.0"):
  from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

  class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
      pass

    def _json(self, code, obj):
      blob = json.dumps(obj).encode()
      self.send_response(code)
      self.send_header("Content-Type", "application/json")
      self.send_header("Content-Length", str(len(blob)))
      self.end_headers()
      self.wfile.write(blob)

    def do_GET(self):
      if self.path == "/healthz":
        self._json(200, {"ok": True, "batch_size": server.batch_size})
      elif self.path == "/stats":
        s = server.stats_snapshot()
        if s["requests"]:
          s["latency_ms_mean"] = s.pop("latency_ms_sum") / s["requests"]
        if s["batches"]:
          s["batch_fill_mean"] = s.pop("batch_fill_sum") / s["batches"]
        self._json(200, s)
      else:
        self._json(404, {"error": "unknown path"})

    def do_POST(self):
      if self.path != "/sample":
        return self._json(404, {"error": "unknown path"})
      try:
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        images = server.sample(int(body.get("n", 1)), body.get("seed"))
        buf = io.BytesIO()
        np.savez_compressed(buf, images=images)
        blob = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)
      except ServerOverloaded as e:
        # Backpressure: bounded queue is full; tell the client when to retry.
        blob = json.dumps({"error": str(e),
                           "retry_after_s": e.retry_after_s}).encode()
        self.send_response(429)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", str(int(e.retry_after_s + 0.5)))
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)
      except ServerClosing as e:
        self._json(503, {"error": str(e)})
      except Exception as e:  # noqa: BLE001 — surface to the client.
        self._json(500, {"error": str(e)})

  return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--config", required=True)
  parser.add_argument("--weights", required=True,
                      help="flat .npz of the (EMA) weights, flax names")
  parser.add_argument("--fn", default="uncond_eps")
  parser.add_argument("--batch_size", type=int, default=64)
  parser.add_argument("--max_wait_ms", type=float, default=200.0)
  parser.add_argument("--port", type=int, default=8777)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  sample_fn, batch_size = build_sample_fn(args)
  server = SamplerServer(sample_fn, batch_size,
                         max_wait_ms=args.max_wait_ms)
  # Build the kernels and warm the caches before accepting traffic.
  t0 = time.perf_counter()
  server.sample(1, seed=0)
  print(f"[serve] warmup sample done in {time.perf_counter() - t0:.1f}s; "
        f"listening on :{args.port}", flush=True)
  httpd = make_http_server(server, args.port)
  try:
    httpd.serve_forever()
  except KeyboardInterrupt:
    pass
  finally:
    server.close()


if __name__ == "__main__":
  main()
