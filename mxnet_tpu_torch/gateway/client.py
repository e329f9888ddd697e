"""GatewayClient — the fleet-facing side of the wire protocol (the
port's counterpart of ``mxnet_tpu/gateway/client.py``; it speaks the
JAX package's protocol byte for byte).

One stdlib ``http.client`` connection per request (thread-safe by
construction), with the repo's shared recovery idiom on top:

* bounded, deterministically-jittered retries on **429 + connect
  reset** via :func:`mxnet_tpu_torch.faults.retry` (site
  ``gateway.client`` — same (seed, site, attempt) schedule every
  run, pinned by tests/test_torch_gateway.py);
* optional **hedged predict**: if the primary request hasn't
  answered within ``hedge_ms``, a duplicate fires carrying the same
  ``X-Idempotency-Key`` and the first success wins — the server
  dedupes, so the backend computes once;
* a **streaming iterator** for generate: tokens yield as the chunks
  land (TTFT is observable between the first and second ``next()``),
  and an in-band ``#error`` sentinel raises
  :class:`GatewayStreamError` — a broken stream is loud, never a
  silent truncation.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from http.client import HTTPConnection

import numpy as onp

from .. import faults as _faults
from ..base import MXNetError

__all__ = ["GatewayClient", "GatewayError", "GatewayBusy",
           "GatewayStreamError"]


class GatewayError(MXNetError):
    """Non-2xx gateway response (``.status`` carries the code)."""

    def __init__(self, msg, status=None):
        super(GatewayError, self).__init__(msg)
        self.status = status


class GatewayBusy(GatewayError):
    """HTTP 429 — edge backpressure; retryable, honors no queue."""

    def __init__(self, msg, retry_after=None):
        super(GatewayBusy, self).__init__(msg, status=429)
        self.retry_after = retry_after


class GatewayStreamError(GatewayError):
    """A generate stream ended with the ``#error`` sentinel."""


class GatewayClient(object):
    """Client for one :class:`~mxnet_tpu_torch.gateway.GatewayServer`.

    Parameters
    ----------
    host / port
        The gateway's bound address (``server.port`` for ephemeral).
    timeout : float
        Socket timeout per request, seconds.
    retries / backoff_s
        Bounded-retry budget for 429/connect-reset (the
        ``faults.retry`` schedule; jitter is seeded, so the schedule
        is a pure function of ``seed``).
    hedge_ms : float or None
        Hedged-predict trigger: fire a deduped duplicate when the
        primary is slower than this (None reads
        ``MXNET_GATEWAY_HEDGE_MS``; 0 disables hedging).
    seed : int
        Keys retry jitter and idempotency-key generation.
    sleep : callable, optional
        Injectable ``sleep(seconds)`` (tests record the schedule).
    """

    def __init__(self, host, port, timeout=30.0, retries=3,
                 backoff_s=0.05, hedge_ms=None, seed=0, sleep=None):
        self._host = str(host)
        self._port = int(port)
        self._timeout = float(timeout)
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        if hedge_ms is None:
            try:
                hedge_ms = float(os.environ.get(
                    "MXNET_GATEWAY_HEDGE_MS", "0"))
            except ValueError:
                hedge_ms = 0.0
        self._hedge_ms = float(hedge_ms)
        self._seed = int(seed)
        self._sleep = sleep
        self._idem_ids = itertools.count()

    # -- transport --------------------------------------------------------
    def _once(self, method, path, body, headers):
        conn = HTTPConnection(self._host, self._port,
                              timeout=self._timeout)
        try:
            conn.request(method, path, body, headers)
            r = conn.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        finally:
            conn.close()

    @staticmethod
    def _raise_status(status, headers, data):
        try:
            msg = json.loads(data).get("error", "")
        except ValueError:
            msg = data.decode(errors="replace")[:200]
        if status == 429:
            ra = headers.get("Retry-After")
            raise GatewayBusy("gateway busy: %s" % msg,
                              retry_after=ra and float(ra))
        raise GatewayError("gateway HTTP %d: %s" % (status, msg),
                           status=status)

    def _request_json(self, method, path, payload, headers=None):
        body = None if payload is None else json.dumps(payload).encode()
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})

        def attempt():
            status, rh, data = self._once(method, path, body, hdrs)
            if status >= 400:
                self._raise_status(status, rh, data)
            return json.loads(data)

        return _faults.retry(
            attempt, retries=self._retries, backoff_s=self._backoff_s,
            retry_on=(GatewayBusy, ConnectionError),
            seed=self._seed, site="gateway.client", sleep=self._sleep)

    # -- probes -----------------------------------------------------------
    def ready(self):
        """Whether ``/readyz`` answers 200 (False on 503 or a dead
        listener)."""
        try:
            status, _, _ = self._once("GET", "/readyz", None, {})
        except OSError:
            return False
        return status == 200

    def healthy(self):
        try:
            status, _, _ = self._once("GET", "/healthz", None, {})
        except OSError:
            return False
        return status == 200

    def stats(self):
        return self._request_json("GET", "/stats", None)

    # -- predict ----------------------------------------------------------
    @staticmethod
    def _headers(tenant, deadline_ms):
        h = {}
        if tenant is not None:
            h["X-Tenant"] = str(tenant)
        if deadline_ms is not None:
            h["X-Deadline-Ms"] = repr(float(deadline_ms))
        return h

    @staticmethod
    def _parse_predict(resp):
        outs = [onp.asarray(o, dtype=onp.dtype(dt))
                for o, dt in zip(resp["outputs"], resp["dtypes"])]
        return outs[0] if resp.get("single") else outs

    def predict(self, data, tenant=None, deadline_ms=None):
        """POST rows to ``/v1/predict``; returns the outputs as numpy
        arrays, bitwise-equal to the in-process call (float32
        survives the JSON round trip exactly). Hedges when
        ``hedge_ms`` is set."""
        arr = onp.asarray(data, dtype=onp.float32)
        payload = {"rows": arr.tolist()}
        headers = self._headers(tenant, deadline_ms)
        if self._hedge_ms > 0:
            headers["X-Idempotency-Key"] = "h%d-%08d" % (
                self._seed, next(self._idem_ids))
            return self._hedged(payload, headers)
        return self._parse_predict(
            self._request_json("POST", "/v1/predict", payload,
                               headers))

    def _hedged(self, payload, headers):
        """Primary in a worker thread; past ``hedge_ms`` a duplicate
        (same idempotency key) races it — first success wins, the
        loser is the server-side dedupe's problem."""
        out = {}
        ev = threading.Event()

        def run():
            try:
                out["ok"] = self._request_json(
                    "POST", "/v1/predict", payload, headers)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                out["exc"] = e
            finally:
                ev.set()

        t = threading.Thread(target=run, name="mxtorch-gw-hedge",
                             daemon=True)
        t.start()
        if not ev.wait(self._hedge_ms / 1000.0):
            try:
                return self._parse_predict(self._request_json(
                    "POST", "/v1/predict", payload, headers))
            except BaseException:  # noqa: BLE001 - primary may still win
                ev.wait(self._timeout)
        if "ok" in out:
            return self._parse_predict(out["ok"])
        raise out["exc"]

    # -- generate ---------------------------------------------------------
    def generate(self, prompt, max_new_tokens=32, seed=0, tenant=None,
                 deadline_ms=None):
        """POST to ``/v1/generate``; returns an iterator yielding
        token ids as the stream's chunks land. Retries (429 /
        connect-reset) apply only up to the response headers — once
        tokens flow, a break surfaces as
        :class:`GatewayStreamError`."""
        body = json.dumps({
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "seed": int(seed),
        }).encode()
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(self._headers(tenant, deadline_ms))

        def attempt():
            conn = HTTPConnection(self._host, self._port,
                                  timeout=self._timeout)
            try:
                conn.request("POST", "/v1/generate", body, hdrs)
                r = conn.getresponse()
                if r.status != 200:
                    data = r.read()
                    self._raise_status(r.status, dict(r.getheaders()),
                                       data)
                return conn, r
            except BaseException:
                conn.close()
                raise

        conn, r = _faults.retry(
            attempt, retries=self._retries, backoff_s=self._backoff_s,
            retry_on=(GatewayBusy, ConnectionError),
            seed=self._seed, site="gateway.client", sleep=self._sleep)
        return self._iter_stream(conn, r)

    @staticmethod
    def _iter_stream(conn, r):
        try:
            while True:
                line = r.readline()
                if not line:
                    return
                line = line.strip()
                if not line:
                    continue
                if line.startswith(b"#error"):
                    raise GatewayStreamError(
                        line.decode(errors="replace"))
                yield int(line)
        finally:
            conn.close()
