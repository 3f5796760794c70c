"""Device-owner inference service for multi-worker runs.

With no device worker in a pool, one spawned process owns the run's torch
device and serves the fused GL/EM/posterior window batches
(parallel/batch.launch_fused_inference) to the pool's host workers over
multiprocessing queues.

Protocol (all numpy, no tensors cross the process boundary).  One request
carries ALL of a region's bucketed batches:

  worker -> server  ("infer", worker_id, req_id,
                     [{loglik f32 [W,Hb,Rb], onehot f32 [W,I,Rb],
                       hap_mask [W,Hb], var_mask [W,Vb,Hb],
                       has_reads [W,I], em_iters}, ...])
  server -> worker  (req_id, "ok", [(em, freq, ratios, margin), ...])
                    (req_id, "err", message)

The server pipelines: requests are queued on the device up to a small
depth, so one worker's upload/compute overlaps another's transfer back.

The service is OPPORTUNISTIC: workers submit in begin_region_inference
(non-blocking) and POLL -- with a small grace window -- in
finish_region_call.  A response that has not arrived by then is abandoned
and the worker computes that region's EM/posteriors on its own f64 host
path instead of waiting.  Output is byte-identical either way because the
fused results pass the engine's f64-exactness guard
(engine/caller._device_window_needs_host).

The server owns the device it is given: if it cannot initialise it, or
records any error while serving, it exits non-zero and the parent raises
at the end of the run (DeviceService.raise_if_failed).  The client half
imports no torch: the host workers run it.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..ops.likelihood import genotype_index_pairs
from ..parallel import batch

logger = logging.getLogger("platypus_tpu")

_STOP = "stop"
_MAX_IN_FLIGHT = 4
# Grace window a worker grants an outstanding response at finish time
# before abandoning it for the host path (the opportunistic poll).
_CLIENT_GRACE_S = float(os.environ.get("PLATYPUS_TPU_SERVICE_GRACE", "0.05"))
# How long available() blocks on the server's ready event.  0 (default)
# keeps the service purely opportunistic; tests set it high so short runs
# deterministically exercise the serving path.
_READY_WAIT_S = float(os.environ.get("PLATYPUS_TPU_SERVICE_WAIT_READY", "0"))

# Sentinel: the response has not arrived (distinct from an error result).
NOT_READY = object()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

def _dispatch_infer(payload: dict, device):
    """Queue one request batch's fused program on `device`; returns the
    device output tuple."""
    _h1, _h2, dev = batch.launch_fused_inference(
        payload["loglik"], payload["onehot"], payload["hap_mask"],
        payload["var_mask"], payload["has_reads"], device,
        em_iters=int(payload.get("em_iters", 100)))
    return dev


def _finalize_infer(dev) -> tuple:
    """(em, freq, ratios, margin) of a dispatched batch as float64 numpy,
    in one device-to-host copy."""
    from ..utils.backend import fetch

    return tuple(np.asarray(a, np.float64)
                 for a in fetch([dev[1], dev[2], dev[4], dev[6]]))


def _write_stats(stats: dict) -> None:
    path = os.environ.get("PLATYPUS_TPU_SERVICE_STATS")
    if path:
        with open(path, "w") as fh:
            json.dump(stats, fh)


def device_server_main(req_q, resp_qs, ready_evt, down_evt, device) -> None:
    """Entry point of the spawned device-owner process.  Exits with code 1
    if it could not own `device` or recorded an error."""
    import torch

    stats = {"backend": device.type, "requests": 0, "windows": 0,
             "errors": 0}
    in_flight: deque = deque()  # (worker_id, req_id, [device outputs])

    def finalize_oldest() -> None:
        worker_id, req_id, devs = in_flight.popleft()
        try:
            resp_qs[worker_id].put(
                (req_id, "ok", [_finalize_infer(dev) for dev in devs]))
        except Exception as exc:  # noqa: BLE001 — answer, count, go on
            logger.exception("device service: finalize failed")
            stats["errors"] += 1
            resp_qs[worker_id].put((req_id, "err", repr(exc)))

    try:
        torch.empty(1, device=device)  # own the device before advertising
        ready_evt.set()
        logger.info("device service ready on %s", device)
        while True:
            try:
                item = req_q.get(timeout=0.02 if in_flight else 1.0)
            except queue_mod.Empty:
                if in_flight:
                    finalize_oldest()
                continue
            if item == _STOP:
                break
            kind, worker_id, req_id, payloads = item
            try:
                if kind != "infer":
                    raise ValueError(f"unknown request kind {kind!r}")
                devs = [_dispatch_infer(p, device) for p in payloads]
            except Exception as exc:  # noqa: BLE001 — answer, count, go on
                logger.exception("device service: dispatch failed")
                stats["errors"] += 1
                resp_qs[worker_id].put((req_id, "err", repr(exc)))
                continue
            stats["requests"] += 1
            stats["windows"] += sum(int(p["hap_mask"].shape[0])
                                    for p in payloads)
            in_flight.append((worker_id, req_id, devs))
            if len(in_flight) >= _MAX_IN_FLIGHT:
                finalize_oldest()
        while in_flight:
            finalize_oldest()
    except Exception:  # noqa: BLE001 — reported through the exit code
        logger.exception("device service failed on %s", device)
        stats["errors"] += 1
    finally:
        # Down, then ready: a client blocked in available() waits for the
        # ready event, wakes, and finds the service down.
        down_evt.set()
        ready_evt.set()
        _write_stats(stats)
        logger.info("device service stopping: %s", stats)
    if stats["errors"]:
        raise SystemExit(1)


# ---------------------------------------------------------------------------
# Parent-side lifecycle
# ---------------------------------------------------------------------------

@dataclass
class ServiceHandle:
    """Picklable per-worker view of the service (passed as a Process arg)."""

    worker_id: int
    req_q: object
    resp_q: object
    ready_evt: object
    down_evt: object


class DeviceService:
    """Parent-side owner: spawns the server on `device`, hands out worker
    handles."""

    def __init__(self, ctx, n_workers: int, device):
        self.req_q = ctx.Queue()
        self.resp_qs = [ctx.Queue() for _ in range(n_workers)]
        self.ready_evt = ctx.Event()
        self.down_evt = ctx.Event()
        self.proc = ctx.Process(
            target=device_server_main,
            args=(self.req_q, self.resp_qs, self.ready_evt, self.down_evt,
                  device),
            name="ptpu-device-service", daemon=True)
        self.proc.start()

    def handle_for(self, worker_id: int) -> ServiceHandle:
        return ServiceHandle(worker_id, self.req_q, self.resp_qs[worker_id],
                             self.ready_evt, self.down_evt)

    def check_alive(self) -> None:
        """Parent poll: a dead server must not leave workers waiting."""
        if not self.proc.is_alive() and not self.down_evt.is_set():
            logger.warning("device service process died (exit %s)",
                           self.proc.exitcode)
            self.down_evt.set()

    def stop(self) -> None:
        self.down_evt.set()
        try:
            self.req_q.put(_STOP)
        except Exception:  # noqa: BLE001
            pass
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)

    def raise_if_failed(self) -> None:
        """After stop(): RuntimeError unless the server exited cleanly."""
        if self.proc.exitcode != 0:
            raise RuntimeError(
                f"the device service exited with {self.proc.exitcode}: it "
                f"could not own its device or failed a request; its windows "
                f"fell back to the host path")


def should_start_service(config, n_workers: int, device) -> bool:
    """PLATYPUS_TPU_INFERENCE_SERVICE, then --inferenceService 0 / 1; auto
    (-1) is on for a multi-worker run on CUDA."""
    env = os.environ.get("PLATYPUS_TPU_INFERENCE_SERVICE")
    if env is not None:
        return env not in ("0", "off", "false")
    mode = config.inference_service
    if mode in (0, 1):
        return bool(mode)
    return n_workers > 1 and device.type == "cuda"


# ---------------------------------------------------------------------------
# Worker-side client
# ---------------------------------------------------------------------------

class InferenceClient:
    """Worker-side asynchronous client; at most one worker thread uses it.

    submit() enqueues a region's batch list and returns a request id
    immediately.  poll() checks — within a small grace window — whether
    the response has arrived: it returns the result list, None (error /
    service down), or NOT_READY, in which case the request is ABANDONED
    (a late response is silently dropped) and the caller computes on the
    host path instead.  Never blocks longer than the grace window, so the
    service is strictly additive to throughput."""

    def __init__(self, handle: ServiceHandle):
        self.h = handle
        self._next_id = 0
        self._done: Dict[int, Optional[list]] = {}
        self._abandoned: set = set()

    def available(self) -> bool:
        if self.h.down_evt.is_set():
            return False
        if self.h.ready_evt.is_set():
            return True
        return (_READY_WAIT_S > 0
                and self.h.ready_evt.wait(timeout=_READY_WAIT_S)
                and not self.h.down_evt.is_set())

    def submit(self, payloads: list) -> Optional[int]:
        if not self.available():
            return None
        req_id = self._next_id
        self._next_id += 1
        try:
            self.h.req_q.put(("infer", self.h.worker_id, req_id, payloads))
        except Exception:  # noqa: BLE001
            return None
        return req_id

    def _drain(self, timeout: float) -> bool:
        """Move one queued response into _done; False on timeout/empty."""
        try:
            rid, status, result = self.h.resp_q.get(timeout=timeout)
        except queue_mod.Empty:
            return False
        if rid in self._abandoned:
            self._abandoned.discard(rid)  # dropped: the host already ran
            return True
        self._done[rid] = result if status == "ok" else None
        return True

    def poll(self, req_id: int, grace: float = _CLIENT_GRACE_S):
        deadline = time.monotonic() + grace
        while req_id not in self._done:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self.h.down_evt.is_set():
                if req_id in self._done:  # pragma: no cover — tiny race
                    break
                self._abandoned.add(req_id)
                return NOT_READY
            self._drain(remaining)
        return self._done.pop(req_id)


class PendingServiceInference:
    """One region's in-flight service request; gather() POLLS (grace-bounded)
    and maps results back to WindowInference — same interface as
    parallel.batch.PendingInference so the engine treats both alike.  An
    empty dict means the response was not ready and the region falls back
    to the host path (finish_window computes f64 host EM per window)."""

    def __init__(self, client: InferenceClient, req_id: int, metas: list):
        self.client = client
        self.req_id = req_id
        self.metas = metas  # (items, h1, h2) per batch, request order

    def gather(self) -> dict:
        result = self.client.poll(self.req_id)
        if result is NOT_READY or result is None:
            return {}
        out: dict = {}
        for (items, h1, h2), (em_h, freq_h, ratio_h, margin_h) in zip(
                self.metas, result):
            out.update(batch.inference_results_to_windows(
                items, h1, h2, em_h, freq_h, ratio_h, margin_h))
        return out


def dispatch_service_inference(live, loglik_by_idx, n_individuals: int,
                               client: InferenceClient, em_iters: int = 100
                               ) -> Optional[PendingServiceInference]:
    """Ship a region's bucketed window batches to the device-owner service
    as ONE request (non-blocking).  Returns None when there is nothing to
    ship or the service is unavailable."""
    payloads = []
    metas = []
    for bucket in batch.build_inference_batches(live, loglik_by_idx,
                                                n_individuals):
        payload = bucket.arrays()
        payload["em_iters"] = em_iters
        payloads.append(payload)
        h1, h2 = genotype_index_pairs(bucket.hap_mask.shape[1])
        metas.append((bucket.items, h1, h2))
    if not payloads:
        return None
    req_id = client.submit(payloads)
    if req_id is None:
        return None
    return PendingServiceInference(client, req_id, metas)


_CLIENT: Optional[InferenceClient] = None


def set_service_handle(handle: Optional[ServiceHandle]) -> None:
    global _CLIENT
    _CLIENT = InferenceClient(handle) if handle is not None else None


def get_inference_client() -> Optional[InferenceClient]:
    return _CLIENT

