"""Bounded jittered-backoff retry — THE one recovery idiom (the port's
copy of ``mxnet_tpu/faults/retry.py``, same schedule bit for bit).

The fault-injection plane needs one backoff discipline at every
transient seam (device staging, transform workers, checkpoint commits):

* **bounded** — a component that cannot heal must fail loudly, not
  spin forever (the bootstrap contract, kept);
* **jittered deterministically** — the jitter is a SplitMix fold of
  ``(seed, site, attempt)``, never wall time or ``random``, so a
  seeded chaos run retries on the same schedule every time (and the
  bitwise contracts survive: retries change WHEN bytes move, never
  which bytes);
* **selective** — only ``retry_on`` exception types are retried;
  :class:`~mxnet_tpu_torch.faults.TransientFault` by default. A permanent
  :class:`~mxnet_tpu_torch.faults.InjectedFault` (or any real bug) propagates
  on the first throw.

Attempts and give-ups count into the telemetry ``faults.retries`` /
``faults.retry_giveups`` counters so a fleet quietly riding its retry
budget is visible on a scrape.
"""
from __future__ import annotations

import logging
import os
import time

from .plan import TransientFault, fold

__all__ = ["retry"]

_log = logging.getLogger("mxnet_tpu_torch.faults")


def _zlib_site(site):
    import zlib
    return zlib.crc32(str(site).encode("utf-8")) & 0xFFFFFFFF


def retry(fn, retries=None, backoff_s=None, max_backoff_s=30.0,
          jitter=0.25, retry_on=None, seed=0, site="retry", sleep=None,
          logger=None):
    """Call ``fn()`` with bounded exponential backoff.

    Parameters
    ----------
    fn : callable
        The attempt; its return value is returned on success.
    retries : int
        Retries AFTER the first attempt (total attempts = retries+1).
        Default ``MXNET_FAULT_RETRIES`` (3).
    backoff_s : float
        Base delay before the first retry; doubles per retry, capped
        at ``max_backoff_s``. Default ``MXNET_FAULT_BACKOFF`` (0.05).
    jitter : float
        Relative jitter amplitude: each delay is scaled by
        ``1 + jitter * u`` with ``u`` in [-1, 1) drawn from the
        deterministic ``(seed, site, attempt)`` SplitMix fold. 0
        disables (the bootstrap spelling, whose backoff is pinned).
    retry_on : tuple of exception types
        What heals by retrying. Default ``(TransientFault,)``.
    seed, site : int, str
        The jitter stream coordinates; ``site`` also names the retry
        in logs and counters.
    sleep : callable, optional
        Injection point for tests; default ``time.sleep``.

    Returns ``fn()``'s value; re-raises the LAST exception once the
    attempt budget is exhausted (callers wanting a domain-specific
    give-up message catch and wrap it).
    """
    if retry_on is None:
        # fast path: the default retry_on can only ever catch an
        # injection, so an UNARMED process skips the whole retry
        # scaffolding (env lookups, site hashing) — the seam-cost
        # discipline applies to the wrapper too
        from . import armed
        if not armed():
            return fn()
        retry_on = (TransientFault,)
    if retries is None:
        retries = int(os.environ.get("MXNET_FAULT_RETRIES", "3"))
    if backoff_s is None:
        backoff_s = float(os.environ.get("MXNET_FAULT_BACKOFF", "0.05"))
    log = logger or _log
    site_key = None
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as exc:  # noqa: B030 - caller-supplied types
            attempt += 1
            from . import _note_retry
            if attempt > retries:
                _note_retry(site, gave_up=True)
                raise
            delay = min(backoff_s * (2 ** (attempt - 1)), max_backoff_s)
            if jitter:
                if site_key is None:
                    site_key = _zlib_site(site)
                u = fold(seed, site_key, attempt) / float(1 << 63) - 1.0
                delay *= max(0.0, 1.0 + jitter * u)
            _note_retry(site)
            log.warning("%s: attempt %d/%d failed (%s); retrying in "
                        "%.3fs", site, attempt, retries + 1, exc, delay)
            (sleep or time.sleep)(delay)
