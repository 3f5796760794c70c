"""Multi-device execution of the torch port: a [win, lane] device mesh,
the region step over it, and the demo calling step.

Twin of platypus_tpu/parallel/mesh.py.  The JAX package hands GSPMD one
jitted program and its input shardings; here the partitioning is written
out:

* windows go to the mesh's `win` rows, in contiguous blocks of the
  bucketed window axis;
* a row's (window, hap, read) pairs are split over its `lane` devices,
  each of which runs the port's gather/pad and K1 (csrc/band_align.cu)
  on its share -- the JAX step runs the XLA scan band_align_padded there,
  the same function bit for bit;
* the row's scores come together on the row's first device, which
  scatter-mins them into the [W, Hmax, Rmax] score tensor, applies the
  short / aligned / hap masks and runs the fused inference
  (ops/likelihood_torch.infer_window_batch).

Every group's work is queued on every device before anything is fetched,
and then each device is read once.  A pair's score does not depend on the
mesh's shape, nor does a window's inference: the window sees the same
bucketed shapes (Wb, Hmax, Rmax, Vb) on any row.  --calculateFlankScore
windows take their pair scores from K2 and the host backtrace
(engine/score.flank_pair_scores) on their row's first device.

A mesh may name one device more than once: the CPU tests build an
8-shard mesh on `cpu`, and the card smoke a 2-shard mesh on one card.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.score import flank_pair_scores, window_loglik_from_pair_scores
from ..ops.align_cuda import band_align_padded
from ..ops.align_torch import gather_pad
from ..ops.kmer import HASH_NUCS
from ..ops.likelihood import genotype_index_pairs
from ..ops.likelihood_torch import (em_frequencies, genotype_log_likelihoods,
                                    infer_window_batch, rescale_likelihoods,
                                    scores_to_logliks,
                                    variant_posterior_ratio)
from ..utils.backend import fetch
from .batch import WindowInference, enumerate_window_variants, geom_bucket

_INT32_BIG = int(np.iinfo(np.int32).max)


class DeviceMesh:
    """A [win, lane] grid of torch devices: the twin of JAX's
    Mesh(devices, ("win", "lane")).  `devices[r][l]` is row r's lane l;
    `shape` is {"win": rows, "lane": devices per row}."""

    def __init__(self, devices: Sequence[torch.device], win: int, lane: int):
        if len(devices) != win * lane:
            raise ValueError(f"{len(devices)} devices cannot fill a "
                             f"{win} x {lane} mesh")
        self.devices = [[torch.device(devices[r * lane + c])
                         for c in range(lane)] for r in range(win)]
        self.shape = {"win": win, "lane": lane}

    @property
    def size(self) -> int:
        return self.shape["win"] * self.shape["lane"]

    def distinct_devices(self) -> List[torch.device]:
        seen: List[torch.device] = []
        for row in self.devices:
            for dev in row:
                if dev not in seen:
                    seen.append(dev)
        return seen

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.devices})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over the first n_devices of `devices` (default: the visible
    CUDA devices), factored into (win, lane) as square as possible, as
    the JAX package's make_mesh.  Asking for more devices than there are
    raises, naming both counts."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"a mesh of {n} devices was asked for; "
                         f"{len(devices)} are visible")
    lane = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            lane = cand
            break
    return DeviceMesh(devices[:n], n // lane, lane)


def get_engine_mesh(n_devices: int, device) -> DeviceMesh:
    """The production path's mesh for --meshDevices=n_devices on the
    run's device type (-1 and 0: all local devices).  On the CPU, the one
    local device, repeated n_devices times; on CUDA, the first n_devices
    visible cards."""
    device = torch.device(device)
    want = None if n_devices in (-1, 0) else n_devices
    if device.type == "cpu":
        return make_mesh(devices=[device] * (want or 1))
    if device.type != "cuda":
        raise ValueError(f"no mesh on device type {device.type!r}")
    return make_mesh(want)


# --------------------------------------------------------------------------
# Production path: real windows through the mesh
# --------------------------------------------------------------------------

def _fetch_each_device(tensors) -> List[np.ndarray]:
    """Host copies of tensors that lie on several devices, in their order:
    one fetch (one transfer) per device."""
    by_dev: Dict[torch.device, list] = {}
    for t in tensors:
        by_dev.setdefault(t.device, []).append(t)
    host = {}
    for dev_tensors in by_dev.values():
        for t, h in zip(dev_tensors, fetch(dev_tensors)):
            host[id(t)] = h
    return [host[id(t)] for t in tensors]


def _pack_group(items, n_individuals: int, n_win: int, L2: int,
                use_flank: bool) -> dict:
    """The host packing of one group (JAX mesh.py:310-396): deduplicated
    hap / gap-open / read / qual matrices, the flat pair rows and the
    per-window scatter targets and masks, in the JAX program's bucketed
    shapes (the matrices' widths decide gather_pad's column clamp).  The
    pair rows hold only the real pairs, in window order: `p_first[k]` is
    window k's first; the padding to a device multiple is per row
    (_row_pairs)."""
    I = n_individuals
    round_up = lambda n, m: -(-n // m) * m  # noqa: E731
    Wb = round_up(geom_bucket(len(items)), n_win)
    Hmax = geom_bucket(max(len(p.all_haps) for _, p in items))
    Rmax = geom_bucket(max(len(p.reads) for _, p in items), 64)
    variants_by_item = [enumerate_window_variants(p.all_haps)
                        for _, p in items]
    Vb = geom_bucket(max(1, max(len(v) for v in variants_by_item)))
    HB = geom_bucket(sum(p.request.hap_matrix.shape[0] for _, p in items), 32)
    AB = geom_bucket(sum(p.request.sub_seq.shape[0] for _, p in items), 256)
    L1B = geom_bucket(max(p.request.hap_matrix.shape[1] for _, p in items), 256)
    P = sum(p.request.n_pairs() for _, p in items)

    g = dict(
        Wb=Wb, Hmax=Hmax, Rmax=Rmax, L2=L2, items=items,
        variants_by_item=variants_by_item,
        hap_mat=np.full((HB, L1B), ord("N"), np.uint8),
        go_mat=np.zeros((HB, L1B), np.uint8),
        seq_mat=np.zeros((AB, L2), np.uint8),
        qual_mat=np.zeros((AB, L2), np.uint8),
        pair_hap=np.zeros(P, np.int32), pair_read=np.zeros(P, np.int32),
        pair_seg=np.zeros(P, np.int32), pair_len=np.zeros(P, np.int32),
        pair_scores=np.zeros(P, np.int32) if use_flank else None,
        pair_w=np.zeros(P, np.int32), pair_h=np.zeros(P, np.int32),
        pair_r=np.zeros(P, np.int32),
        p_first=np.zeros(len(items) + 1, np.int64),
        aligned=np.zeros((Wb, Rmax), bool), short=np.zeros((Wb, Rmax), bool),
        mapq=np.zeros((Wb, Rmax), np.int32),
        onehot=np.zeros((Wb, I, Rmax), np.float32),
        hap_mask=np.zeros((Wb, Hmax), bool),
        var_mask=np.zeros((Wb, Vb, Hmax), bool),
        has_reads=np.zeros((Wb, I), bool),
    )
    h_off = a_off = p_off = 0
    for k, (_w_idx, prep) in enumerate(items):
        req = prep.request
        H = len(prep.all_haps)
        R = len(prep.reads)
        nh, na = req.hap_matrix.shape[0], req.sub_seq.shape[0]
        np_pairs = req.n_pairs()
        g["hap_mat"][h_off : h_off + nh, : req.hap_matrix.shape[1]] = req.hap_matrix
        g["go_mat"][h_off : h_off + nh, : req.go_matrix.shape[1]] = req.go_matrix
        g["seq_mat"][a_off : a_off + na] = req.sub_seq
        g["qual_mat"][a_off : a_off + na] = req.sub_qual
        sl = slice(p_off, p_off + np_pairs)
        g["pair_hap"][sl] = req.pair_hap + h_off
        g["pair_read"][sl] = req.pair_read + a_off
        g["pair_seg"][sl] = req.pair_seg
        g["pair_len"][sl] = req.sub_len[req.pair_read]
        g["pair_w"][sl] = k
        g["pair_h"][sl] = req.pair_hap
        g["pair_r"][sl] = req.align_rows[req.pair_read]
        g["aligned"][k, req.align_rows] = True
        g["short"][k, req.align_rows[req.sub_len < HASH_NUCS]] = True
        g["mapq"][k, :R] = prep.reads.mapq
        if R:
            g["onehot"][k, prep.reads.sample_idx, np.arange(R)] = 1.0
        g["hap_mask"][k, :H] = True
        vidx = {v: vi for vi, v in enumerate(variants_by_item[k])}
        for h, hap in enumerate(prep.all_haps):
            for v in hap.variants:
                vi = vidx.get(v)
                if vi is not None:
                    g["var_mask"][k, vi, h] = True
        n_good = (np.bincount(prep.reads.sample_idx[prep.reads.is_good],
                              minlength=I) if R else np.zeros(I, np.int64))
        g["has_reads"][k] = n_good > 0
        h_off += nh
        a_off += na
        p_off += np_pairs
        g["p_first"][k + 1] = p_off
    return g


def _row_pairs(g: dict, r: int, Wr: int, lane: int) -> np.ndarray:
    """Indices into the group's pair rows of row r's share: the real
    pairs of windows [r*Wr, (r+1)*Wr), then pad pairs (index -1) up to a
    multiple of `lane`, so every lane device gets as many as the others,
    as GSPMD gives every device an equal slice of the JAX program's
    padded pair axis.  A pad pair is hap 0, read 0, segment 0, length
    min(8, L2), as there."""
    n_items = len(g["items"])
    lo = g["p_first"][min(r * Wr, n_items)]
    hi = g["p_first"][min((r + 1) * Wr, n_items)]
    n = int(hi - lo)
    share = np.full(-(-n // lane) * lane, -1, np.int64)
    share[:n] = np.arange(lo, hi)
    return share


def _take(values: np.ndarray, share: np.ndarray, pad) -> np.ndarray:
    """values[share], with `pad` where share is -1."""
    out = values[np.maximum(share, 0)]
    out[share < 0] = pad
    return out


def _launch_group(g: dict, mesh: DeviceMesh, use_cap: bool, use_flank: bool,
                  gapextend: int, nucprior: int, em_iters: int) -> list:
    """Queue one group's region step on every device of the mesh.
    Returns per row (number of real pairs, device outputs: K1 scores of
    the share (None for flank groups), em, freq, ratios, em_margin), all
    on the row's first device."""
    n_win, lane = mesh.shape["win"], mesh.shape["lane"]
    Wb, Hmax, Rmax, L2 = g["Wb"], g["Hmax"], g["Rmax"], g["L2"]
    Wr = Wb // n_win
    h1, h2 = genotype_index_pairs(Hmax)
    mats: Dict[torch.device, list] = {}
    if not use_flank:
        for dev in mesh.distinct_devices():
            mats[dev] = [torch.from_numpy(g[k]).to(dev) for k in
                         ("hap_mat", "go_mat", "seq_mat", "qual_mat")]
    rows = []
    for r, row_devs in enumerate(mesh.devices):
        dev0 = row_devs[0]
        share = _row_pairs(g, r, Wr, lane)
        n_real = int((share >= 0).sum())

        def up(a, dev=dev0):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        if use_flank:
            scores = up(_take(g["pair_scores"], share, 0))
            row_scores = None
        else:
            # gather/pad + K1 on each lane device, on its slice of the share
            idx = np.stack([_take(g["pair_hap"], share, 0),
                            _take(g["pair_read"], share, 0),
                            _take(g["pair_seg"], share, 0),
                            _take(g["pair_len"], share, min(8, L2))])
            per_lane = len(share) // lane
            pieces = []
            for c, dev in enumerate(row_devs):
                if per_lane == 0:
                    break
                cols = idx[:, c * per_lane : (c + 1) * per_lane]
                padded = gather_pad(*mats[dev], *up(cols, dev))
                pieces.append(band_align_padded(
                    *padded, gapextend=gapextend, nucprior=nucprior
                ).to(dev0, non_blocking=True))
            scores = (torch.cat(pieces) if pieces
                      else torch.empty(0, dtype=torch.int32, device=dev0))
            row_scores = scores
        # scatter-min into the row's [Wr, Hmax, Rmax] score tensor; pad
        # pairs carry INT32_MAX to index 0, which the min leaves unchanged
        valid = up(share >= 0)
        w, h, rd = (_take(g[k], share, 0).astype(np.int64)
                    for k in ("pair_w", "pair_h", "pair_r"))
        target = ((w - r * Wr) * Hmax + h) * Rmax + rd
        S = torch.full((Wr * Hmax * Rmax,), _INT32_BIG, dtype=torch.int32,
                       device=dev0)
        S = S.scatter_reduce(0, up(np.where(share >= 0, target, 0)),
                             torch.where(valid, scores.to(torch.int32),
                                         _INT32_BIG),
                             "amin", include_self=True).view(Wr, Hmax, Rmax)
        ws = slice(r * Wr, (r + 1) * Wr)
        short, aligned, hap_mask = (up(g[k][ws]) for k in
                                    ("short", "aligned", "hap_mask"))
        # Short-overlap reads score 0 (probability 1), as the host scatter.
        S = torch.where(short[:, None, :], 0, S)
        ll = scores_to_logliks(S.to(torch.float32),
                               up(g["mapq"][ws])[:, None, :].to(torch.float32),
                               use_map_qual_cap=use_cap)
        ll = torch.where(aligned[:, None, :], ll, 0.0)
        ll = torch.where(hap_mask[:, :, None], ll, 0.0)
        _lik, em, freq, _gof, ratios, _gl_rel, margin = infer_window_batch(
            ll, up(g["onehot"][ws]), hap_mask, up(h1.astype(np.int64)),
            up(h2.astype(np.int64)), up(g["var_mask"][ws]),
            up(g["has_reads"][ws]), em_iters)
        rows.append((n_real, (row_scores, em, freq, ratios, margin)))
    return rows


def mesh_call_region(live, n_individuals: int, mesh: DeviceMesh,
                     gapextend: int = 3, nucprior: int = 2,
                     em_iters: int = 100, defer: bool = False):
    """Run prepared windows (engine/caller.prepare_window output with
    their AlignmentRequests) through the region step on `mesh`.

    Returns (loglik_by_idx, inference_by_idx, leftover): leftover are the
    (w_idx, prep) pairs with nothing to align, which the caller routes
    through run_alignment_requests.  With defer=True returns
    (fetch, leftover): every device's work is queued, and fetch() reads
    each device once and returns (loglik_by_idx, inference_by_idx).  The
    per-window log-likelihood matrices are rebuilt on the host from the
    sparse pair scores (window_loglik_from_pair_scores), as in the JAX
    package.  PLATYPUS_TPU_MESH_TIMERS prints the three [mesh] lines."""
    timers = os.environ.get("PLATYPUS_TPU_MESH_TIMERS")
    t0 = time.perf_counter()
    leftover: list = []
    groups: dict = {}
    for w_idx, prep in live:
        req = prep.request
        if req is None or req.n_pairs() == 0:
            leftover.append((w_idx, prep))
            continue
        # Sub-bucketing by haplotype-count class keeps small windows from
        # paying the dense G = Hmax(Hmax+1)/2 cost of the largest one.
        key = (req.sub_seq.shape[1], bool(req.use_map_qual_cap),
               bool(req.calculate_flank_score),
               geom_bucket(len(prep.all_haps)))
        groups.setdefault(key, []).append((w_idx, prep))

    n_win, lane = mesh.shape["win"], mesh.shape["lane"]
    launched = []
    for (L2, use_cap, use_flank, _hclass), items in groups.items():
        g = _pack_group(items, n_individuals, n_win, L2, use_flank)
        if use_flank:
            Wr = g["Wb"] // n_win
            for r, row_devs in enumerate(mesh.devices):
                row_items = items[r * Wr : (r + 1) * Wr]
                if not row_items:
                    continue
                lo = g["p_first"][r * Wr]
                scores = flank_pair_scores([p.request for _, p in row_items],
                                           row_devs[0], gapextend, nucprior)
                g["pair_scores"][lo : lo + sum(map(len, scores))] = \
                    np.concatenate(scores)
        launched.append((g, _launch_group(g, mesh, use_cap, use_flank,
                                          gapextend, nucprior, em_iters)))
    if timers:
        print(f"[mesh] pack+launch {len(groups)} groups: "
              f"{time.perf_counter() - t0:.3f}s", flush=True)

    def _fetch():
        tf = time.perf_counter()
        tensors = [t for _g, rows in launched for _real, outs in rows
                   for t in outs if t is not None]
        host = dict(zip(map(id, tensors), _fetch_each_device(tensors)))
        if timers:
            print(f"[mesh] device_get: {time.perf_counter() - tf:.3f}s",
                  flush=True)
        tu = time.perf_counter()
        loglik_by_idx: dict = {}
        inference_by_idx: dict = {}
        for g, rows in launched:
            items = g["items"]
            h1, h2 = genotype_index_pairs(g["Hmax"])
            if g["pair_scores"] is not None:
                scores_h = g["pair_scores"]
            else:
                scores_h = np.concatenate(
                    [host[id(outs[0])][:n_real] for n_real, outs in rows])
            em_h, freq_h, ratio_h, margin_h = (
                np.concatenate([np.asarray(host[id(outs[j])], np.float64)
                                for _real, outs in rows])
                for j in range(1, 5))
            for k, (w_idx, prep) in enumerate(items):
                req = prep.request
                H = len(prep.all_haps)
                cols = np.nonzero((h1 < H) & (h2 < H))[0]
                lo, hi = g["p_first"][k], g["p_first"][k + 1]
                loglik_by_idx[w_idx] = window_loglik_from_pair_scores(
                    req, scores_h[lo:hi])
                inference_by_idx[w_idx] = WindowInference(
                    em=em_h[k][:, cols],
                    frequencies=freq_h[k][:H],
                    ratios={v: float(ratio_h[k, vi])
                            for vi, v in enumerate(g["variants_by_item"][k])},
                    em_margin=float(margin_h[k]),
                )
        if timers:
            print(f"[mesh] unpack: {time.perf_counter() - tu:.3f}s",
                  flush=True)
        return loglik_by_idx, inference_by_idx

    if defer:
        return _fetch, leftover
    loglik_by_idx, inference_by_idx = _fetch()
    return loglik_by_idx, inference_by_idx, leftover


# --------------------------------------------------------------------------
# The demo calling step (synthetic window batches, dry runs)
# --------------------------------------------------------------------------

def build_calling_step(mesh: DeviceMesh, gapextend: int = 3,
                       nucprior: int = 2, em_iters: int = 20):
    """One window-batch calling step over `mesh` (twin of the JAX
    package's build_calling_step, same inputs, numpy):

      hap_cols   [L1, W, Hmax]  int32  'N'-padded hap segment columns
      go4_cols   [L1, W, Hmax]  int32
      read_cols  [L2+8, W, Rmax] int32 '0'-padded read columns
      qual4_cols [L2+8, W, Rmax] int32
      read_len, mapq [W, Rmax] int32; read_mask [W, Rmax] bool
      hap_mask [W, Hmax] bool; h1, h2 [G] int32; geno_mask [W, G] bool
      hap_has_var [W, Hmax] bool

    Windows go to `win` rows and reads to `lane` devices (W and Rmax must
    divide evenly).  Each device aligns its windows' haps against its
    reads (K1) and sums its reads' genotype log-likelihoods; the row's
    first device adds the lane partial sums (in lane order) and runs the
    linear-space rescale, EM and posterior ratio.  Returns numpy
    (frequencies [W, Hmax], posterior_ratio [W], scores [W, Hmax, Rmax])."""
    n_win, lane = mesh.shape["win"], mesh.shape["lane"]

    def step(hap_cols, go4_cols, read_cols, qual4_cols, read_len, mapq,
             read_mask, hap_mask, h1, h2, geno_mask, hap_has_var):
        L1, W, Hmax = hap_cols.shape
        S, _, Rmax = read_cols.shape
        if W % n_win or Rmax % lane:
            raise ValueError(f"W={W} and Rmax={Rmax} must divide over the "
                             f"{n_win} x {lane} mesh")
        Wr, Rl = W // n_win, Rmax // lane
        outs = []
        for r, row_devs in enumerate(mesh.devices):
            dev0 = row_devs[0]
            ws = slice(r * Wr, (r + 1) * Wr)

            def up(a, dev=dev0):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            gl = None
            lane_scores = []
            for c, dev in enumerate(row_devs):
                rs = slice(c * Rl, (c + 1) * Rl)
                B = Wr * Hmax * Rl
                hap = up(hap_cols[:, ws], dev)[:, :, :, None].expand(
                    L1, Wr, Hmax, Rl).reshape(L1, B)
                go = up(go4_cols[:, ws], dev)[:, :, :, None].expand(
                    L1, Wr, Hmax, Rl).reshape(L1, B)
                rd = up(read_cols[:, ws, rs], dev)[:, :, None, :].expand(
                    S, Wr, Hmax, Rl).reshape(S, B)
                qu = up(qual4_cols[:, ws, rs], dev)[:, :, None, :].expand(
                    S, Wr, Hmax, Rl).reshape(S, B)
                rl = up(read_len[ws, rs], dev)[:, None, :].expand(
                    Wr, Hmax, Rl).reshape(B)
                scores = band_align_padded(
                    hap.contiguous(), go.contiguous(), rd.contiguous(),
                    qu.contiguous(), rl.contiguous(), gapextend=gapextend,
                    nucprior=nucprior).view(Wr, Hmax, Rl)
                loglik = scores_to_logliks(
                    scores.to(torch.float32),
                    up(mapq[ws, rs], dev)[:, None, :].to(torch.float32))
                part = genotype_log_likelihoods(
                    loglik, up(h1, dev), up(h2, dev),
                    up(read_mask[ws, rs], dev)).to(dev0, non_blocking=True)
                gl = part if gl is None else gl + part
                lane_scores.append(scores)
            has_reads = up(read_mask[ws]).any(dim=1)[:, None]       # I = 1
            hm = up(hap_mask[ws])
            lik = rescale_likelihoods(gl[:, None, :], up(geno_mask[ws]),
                                      has_reads)
            freq = em_frequencies(lik, up(h1), up(h2), Hmax, hm, has_reads,
                                  em_iters)
            ratio = variant_posterior_ratio(lik, freq, up(hap_has_var[ws]),
                                            up(h1), up(h2), has_reads)
            outs.append((freq, ratio, lane_scores))
        tensors = [t for freq, ratio, lane_scores in outs
                   for t in (freq, ratio, *lane_scores)]
        host = dict(zip(map(id, tensors), _fetch_each_device(tensors)))
        freqs = np.concatenate([host[id(f)] for f, _, _ in outs])
        ratios = np.concatenate([host[id(x)] for _, x, _ in outs])
        scores = np.concatenate([np.concatenate([host[id(s)] for s in ls],
                                                axis=2)
                                 for _, _, ls in outs])
        return freqs, ratios, scores

    return step


def make_example_batch(W=8, Hmax=4, Rmax=16, L2=24, seed=0):
    """Tiny synthetic window batch for the dry run (the JAX package's
    make_example_batch, host numpy)."""
    rng = np.random.default_rng(seed)
    L1 = L2 + 16
    S = L2 + 8
    bases = np.frombuffer(b"ACGT", np.uint8)

    hap_seqs = rng.choice(bases, size=(W, Hmax, L1)).astype(np.int32)
    # Reads copied from hap 0 with noise.
    reads = np.zeros((W, Rmax, L2), np.int32)
    for w in range(W):
        for r in range(Rmax):
            off = rng.integers(0, 8)
            reads[w, r] = hap_seqs[w, r % Hmax, off : off + L2]
    quals = np.full((W, Rmax, L2), 30, np.int32)
    read_len = np.full((W, Rmax), L2, np.int32)
    mapq = np.full((W, Rmax), 60, np.int32)

    hap_cols = np.ascontiguousarray(hap_seqs.transpose(2, 0, 1))
    go4_cols = np.full((L1, W, Hmax), 45 * 4, np.int32)
    read_cols = np.full((S, W, Rmax), ord("0"), np.int32)
    read_cols[:L2] = reads.transpose(2, 0, 1)
    qual4_cols = np.full((S, W, Rmax), 64 * 4, np.int32)
    qual4_cols[:L2] = 4 * quals.transpose(2, 0, 1)

    G = Hmax * (Hmax + 1) // 2
    h1 = np.array([i for i in range(Hmax) for _ in range(i, Hmax)], np.int32)
    h2 = np.array([j for i in range(Hmax) for j in range(i, Hmax)], np.int32)

    read_mask = np.ones((W, Rmax), bool)
    hap_mask = np.ones((W, Hmax), bool)
    geno_mask = np.ones((W, G), bool)
    hap_has_var = np.zeros((W, Hmax), bool)
    hap_has_var[:, 1:] = True

    return (hap_cols, go4_cols, read_cols, qual4_cols, read_len, mapq,
            read_mask, hap_mask, h1, h2, geno_mask, hap_has_var)


def dryrun_multichip(n_devices: int, device) -> None:
    """Run the demo calling step once on get_engine_mesh(n_devices,
    device), and check its outputs are finite and of the expected shape."""
    mesh = get_engine_mesh(n_devices, device)
    step = build_calling_step(mesh, em_iters=5)
    batch = make_example_batch(W=mesh.shape["win"] * 2,
                               Rmax=mesh.shape["lane"] * 8)
    freqs, ratios, scores = step(*batch)
    if not (np.isfinite(ratios).all() and np.isfinite(freqs).all()):
        raise AssertionError("the demo step gave non-finite results")
    if freqs.shape != (batch[0].shape[1], 4) or scores.shape != (
            batch[0].shape[1], 4, batch[2].shape[2]):
        raise AssertionError(f"the demo step gave shapes {freqs.shape}, "
                             f"{scores.shape}")
