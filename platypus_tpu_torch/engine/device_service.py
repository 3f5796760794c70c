"""Device-owner inference service of the torch port: the server half.

Twin of the server and parent halves of platypus_tpu/engine/device_service.py.
One spawned process owns the run's torch.device and serves the fused
GL/EM/posterior window batches (parallel/batch.py launch_fused_inference)
to the pool's host workers.  The client half -- ServiceHandle,
InferenceClient, dispatch_service_inference, set_service_handle -- is the
JAX package's, unchanged: the host workers run the JAX package's host
path and submit through it (platypus_tpu/engine/region.py:564-582).  So
this server speaks that protocol exactly (numpy over multiprocessing
queues, device_service.py:11-19) and writes the same
PLATYPUS_TPU_SERVICE_STATS file.

The client's grace-bounded poll, which abandons a late response for the
float64 host path, is the protocol's own semantics and stays.  What does
not carry over is the JAX server's silent stand-down: this server owns
the device it is given, and if it cannot initialise it, or records any
error while serving, it exits non-zero and the parent raises at the end
of the run (DeviceService.raise_if_failed).
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
from collections import deque

import numpy as np
import torch

from platypus_tpu.engine import device_service as host_service
from platypus_tpu.engine.device_service import _MAX_IN_FLIGHT, _STOP

from ..parallel import batch
from ..utils.backend import fetch

logger = logging.getLogger("platypus_tpu")


def _dispatch_infer(payload: dict, device: torch.device):
    """Queue one request batch's fused program on `device`; returns the
    device output tuple (device_service.py:69-79)."""
    _h1, _h2, dev = batch.launch_fused_inference(
        payload["loglik"], payload["onehot"], payload["hap_mask"],
        payload["var_mask"], payload["has_reads"], device,
        em_iters=int(payload.get("em_iters", 100)))
    return dev


def _finalize_infer(dev) -> tuple:
    """(em, freq, ratios, margin) of a dispatched batch as float64 numpy,
    in one device-to-host copy (device_service.py:82-87)."""
    return tuple(np.asarray(a, np.float64)
                 for a in fetch([dev[1], dev[2], dev[4], dev[6]]))


def _write_stats(stats: dict) -> None:
    path = os.environ.get("PLATYPUS_TPU_SERVICE_STATS")
    if path:
        with open(path, "w") as fh:
            json.dump(stats, fh)


def device_server_main(req_q, resp_qs, ready_evt, down_evt,
                       device: torch.device) -> None:
    """Entry point of the spawned device-owner process
    (device_service.py:90-179).  Exits with code 1 if it could not own
    `device` or recorded an error."""
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


class DeviceService(host_service.DeviceService):
    """Parent-side owner (device_service.py:197-233): spawns this module's
    server on `device`; handle_for, check_alive and stop are the JAX
    package's."""

    def __init__(self, ctx, n_workers: int, device: torch.device):
        # Not super().__init__: that spawns the JAX package's server.
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

    def raise_if_failed(self) -> None:
        """After stop(): RuntimeError unless the server exited cleanly."""
        if self.proc.exitcode != 0:
            raise RuntimeError(
                f"the device service exited with {self.proc.exitcode}: it "
                f"could not own its device or failed a request; its windows "
                f"fell back to the host path")


def should_start_service(config, n_workers: int, device: torch.device) -> bool:
    """device_service.py:236-256 keyed on the run's device:
    PLATYPUS_TPU_INFERENCE_SERVICE, then --inferenceService 0 / 1; auto
    (-1) is on for a multi-worker run on CUDA."""
    env = os.environ.get("PLATYPUS_TPU_INFERENCE_SERVICE")
    if env is not None:
        return env not in ("0", "off", "false")
    mode = config.inference_service
    if mode in (0, 1):
        return bool(mode)
    return n_workers > 1 and device.type == "cuda"
