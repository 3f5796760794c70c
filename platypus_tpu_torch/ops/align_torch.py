"""Plain torch versions of the banded pair-alignment inputs and DP.

Twin of platypus_tpu/ops/align_jax.py.  The sentinel conventions carry
over exactly: haplotype columns pad with 'N', gap-open columns clamp to the
value at len1-1 (len1 = read_len + 15), read columns pad with '0' and
4*quality columns with 4*64.  `band_align_padded_reference` and
`band_align_traceback_padded_reference` are the plain versions of the two
CUDA kernels in ops/align_cuda.py: the CPU tests run them, and
chip_smoke.py holds each kernel against its plain version on the card.

Scores are integer phred, bit-identical to ops/align_core.band_align_single
and, in traceback mode, band_align_traceback (tests/test_torch_align.py
runs the checked-in goldens).
"""

from __future__ import annotations

import numpy as np
import torch

from .align_core import N_LANES, POS_INF

_N_CHAR = ord("N")
_PAD_CHAR = ord("0")


def _pad_core(hap_seg, gapopen_seg, read, qual, read_len):
    """Sentinel padding from raw [B, L] integer tensors; returns
    ([L2+16, B] hap cols, [L2+16, B] 4*gapopen cols, [L2+8, B] read cols,
    [L2+8, B] 4*qual cols, [B] read_len), all contiguous int32."""
    B, L2max = read.shape
    L1max = L2max + 2 * N_LANES
    dev = read.device
    read_len = read_len.to(torch.int32)
    len1 = read_len + 15

    hp = torch.full((B, L1max), _N_CHAR, dtype=torch.int32, device=dev)
    hp[:, : hap_seg.shape[1]] = hap_seg.to(torch.int32)
    go = torch.zeros((B, L1max), dtype=torch.int32, device=dev)
    go[:, : gapopen_seg.shape[1]] = gapopen_seg.to(torch.int32)
    cols = torch.arange(L1max, device=dev)[None, :]
    inside = cols < len1[:, None]
    hp = torch.where(inside, hp, _N_CHAR)
    last_go = torch.gather(go, 1, (len1 - 1).clamp(min=0).long()[:, None])
    go = torch.where(inside, go, last_go)

    rd = torch.full((B, L2max + N_LANES), _PAD_CHAR, dtype=torch.int32, device=dev)
    rd[:, :L2max] = read.to(torch.int32)
    qd = torch.full((B, L2max + N_LANES), 64, dtype=torch.int32, device=dev)
    qd[:, :L2max] = qual.to(torch.int32)
    cols2 = torch.arange(L2max + N_LANES, device=dev)[None, :]
    in_read = cols2 < read_len[:, None]
    rd = torch.where(in_read, rd, _PAD_CHAR)
    qd = torch.where(in_read, qd, 64)

    return (hp.T.contiguous(), (4 * go).T.contiguous(), rd.T.contiguous(),
            (4 * qd).T.contiguous(), read_len.contiguous())


def gather_pad(hap_mat, go_mat, seq_mat, qual_mat,
               pair_hap, pair_read, pair_seg, read_len):
    """Per-chunk pair materialisation (twin of align_jax._gather_pad_device):
    gather each pair's haplotype segment and read row from the
    deduplicated [H, L1B] / [A, L2] matrices, then sentinel-pad.

    A segment may run past the matrix width: JAX's gather clamps such
    column indices to L1B-1, torch's raises, so the clamp is explicit."""
    L2max = seq_mat.shape[1]
    seg_len = L2max + 15
    cols = pair_seg.long()[:, None] + torch.arange(
        seg_len, device=pair_seg.device)[None, :]
    cols = cols.clamp(max=hap_mat.shape[1] - 1)
    rows = pair_hap.long()[:, None]
    hap_seg = hap_mat[rows, cols]
    go_seg = go_mat[rows, cols]
    pr = pair_read.long()
    return _pad_core(hap_seg, go_seg, seq_mat[pr], qual_mat[pr], read_len)


def pad_alignment_inputs(hap_seg, gapopen_seg, read, qual, read_len,
                         device="cpu"):
    """Host API: numpy [B, L1] hap/gap-open segments, [B, L2] reads and
    quals and [B] lengths -> padded column tensors on `device`."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return _pad_core(up(hap_seg, np.int32), up(gapopen_seg, np.int32),
                     up(read, np.int32), up(qual, np.int32),
                     up(read_len, np.int32))


def _shift_up(v, new_col):
    """Lane k takes lane k-1; lane 0 takes new_col ([B, 8] state)."""
    return torch.cat([new_col[:, None], v[:, :-1]], dim=1)


def _shift_down(v, new_col):
    """Lane k takes lane k+1; lane 7 takes new_col."""
    return torch.cat([v[:, 1:], new_col[:, None]], dim=1)


def band_align_padded_reference(hap_cols, go4_cols, read_cols, qual4_cols,
                                read_len, gapextend: int = 3,
                                nucprior: int = 2):
    """Plain torch banded DP on padded column tensors (the contract of
    align_jax.band_align_padded): [L2+16, B] hap / 4*gap-open columns,
    [L2+8, B] read / 4*qual columns, [B] read_len -> [B] int32 phred.

    The wavefront state is [B, 8] int32, one row per pair; the Python loop
    runs two antidiagonal phases per read base."""
    i32 = torch.int32
    hap_cols = hap_cols.to(i32)
    go4_cols = go4_cols.to(i32)
    read_cols = read_cols.to(i32)
    qual4_cols = qual4_cols.to(i32)
    read_len = read_len.to(i32)
    n_steps, B = read_cols.shape
    dev = read_cols.device
    ge = 4 * gapextend
    npr = 4 * nucprior
    lane = torch.arange(N_LANES, dtype=i32, device=dev)[None, :]
    pos_inf_col = torch.full((B,), POS_INF, dtype=i32, device=dev)
    zero_col = torch.zeros((B,), dtype=i32, device=dev)

    m1 = torch.full((B, N_LANES), POS_INF, dtype=i32, device=dev)
    i1, d1, m2, i2, d2 = (m1.clone() for _ in range(5))
    s1w = hap_cols[:N_LANES].T
    gow = go4_cols[:N_LANES].T
    nq = torch.where(s1w == _N_CHAR, 0, POS_INF).to(i32)
    s2w = torch.full((B, N_LANES), POS_INF, dtype=i32, device=dev)
    q2w = torch.full((B, N_LANES), 64 * 4, dtype=i32, device=dev)
    minsc = torch.full((B,), POS_INF, dtype=i32, device=dev)

    for s2 in range(n_steps):
        hap_c = hap_cols[N_LANES + s2]
        go_c = go4_cols[N_LANES + s2]

        # even phase --------------------------------------------------------
        s2w = _shift_up(s2w, read_cols[s2])
        q2w = _shift_up(q2w, qual4_cols[s2])
        if s2 < N_LANES:
            init = lane == s2
            m1 = torch.where(init, -0x8000, m1)
            m2 = torch.where(init, -0x8000, m2)

        m1 = torch.minimum(m1, torch.minimum(i1, d1))

        ext_lane = (s2 - read_len).clamp(0, N_LANES - 1).long()[:, None]
        valid = (s2 >= read_len) & (s2 < read_len + N_LANES)
        val = torch.gather(m1, 1, ext_lane)[:, 0]
        minsc = torch.where(valid, torch.minimum(minsc, val), minsc)

        sub = torch.minimum(torch.where(s2w == s1w, 0, q2w), nq)
        m1 = m1 + sub
        d1_new = torch.minimum(d2 + ge, torch.minimum(m2, i2)
                               + _shift_down(gow, zero_col))
        d1 = _shift_up(d1_new, pos_inf_col)
        i1 = torch.minimum(i2 + ge, m2 + gow) + npr

        # odd phase ---------------------------------------------------------
        s1w = _shift_down(s1w, hap_c)
        nq = _shift_down(nq, torch.where(hap_c == _N_CHAR, 0, POS_INF).to(i32))
        gow = _shift_down(gow, go_c)

        m2 = torch.minimum(m2, torch.minimum(i2, d2))
        val2 = torch.gather(m2, 1, ext_lane)[:, 0]
        minsc = torch.where(valid, torch.minimum(minsc, val2), minsc)

        sub2 = torch.minimum(torch.where(s2w == s1w, 0, q2w), nq)
        m2 = m2 + sub2
        d2 = torch.minimum(d1 + ge, torch.minimum(m1, i1) + gow)
        i2 = torch.minimum(_shift_down(i1, pos_inf_col) + ge,
                           _shift_down(m1, pos_inf_col) + gow) + npr
        i2[:, -1] = POS_INF

    return (minsc + 0x8000) >> 2


def _labels(m, i, d):
    """Traceback-mode label word of a phase (M in bits 0-1, I in 2-3, D in
    6-7: each state's predecessor label) and the states with their low two
    bits stamped with their own label (M=..00, I=..01, D=..11)."""
    word = (m & 3) | ((i & 3) << 2) | ((d & 3) << 6)
    return word, m & ~3, (i & ~3) | 1, (d & ~3) | 3


def band_align_traceback_padded_reference(hap_cols, go4_cols, read_cols,
                                          qual4_cols, read_len,
                                          gapextend: int = 3,
                                          nucprior: int = 2):
    """Plain torch traceback-mode DP (the contract of
    align_pallas.band_align_traceback_padded_pallas) on the padded column
    tensors of band_align_padded_reference.  Returns (score [B], exit
    index [B], bp [(L2+8)*8, B]), all int32: the traceback-mode score,
    2*(read_len+row)+phase of the first strict minimum exit cell (rows
    ascending, even phase before odd), and per step the 8 packed label
    words (even phase in bits 0-7, odd phase in bits 8-15)."""
    i32 = torch.int32
    hap_cols = hap_cols.to(i32)
    go4_cols = go4_cols.to(i32)
    read_cols = read_cols.to(i32)
    qual4_cols = qual4_cols.to(i32)
    read_len = read_len.to(i32)
    n_steps, B = read_cols.shape
    dev = read_cols.device
    ge = 4 * gapextend
    npr = 4 * nucprior
    lane = torch.arange(N_LANES, dtype=i32, device=dev)[None, :]
    pos_inf_col = torch.full((B,), POS_INF, dtype=i32, device=dev)
    zero_col = torch.zeros((B,), dtype=i32, device=dev)

    m1 = torch.full((B, N_LANES), POS_INF, dtype=i32, device=dev)
    i1, d1, m2, i2, d2, val_e, val_o = (m1.clone() for _ in range(7))
    s1w = hap_cols[:N_LANES].T
    gow = go4_cols[:N_LANES].T
    nq = torch.where(s1w == _N_CHAR, 0, POS_INF).to(i32)
    s2w = torch.full((B, N_LANES), POS_INF, dtype=i32, device=dev)
    q2w = torch.full((B, N_LANES), 64 * 4, dtype=i32, device=dev)
    bp = torch.empty((n_steps * N_LANES, B), dtype=i32, device=dev)

    for s2 in range(n_steps):
        hap_c = hap_cols[N_LANES + s2]
        go_c = go4_cols[N_LANES + s2]
        exit_mask = lane == (s2 - read_len)[:, None]  # <= 1 row per pair

        # even phase --------------------------------------------------------
        s2w = _shift_up(s2w, read_cols[s2])
        q2w = _shift_up(q2w, qual4_cols[s2])
        if s2 < N_LANES:
            init = lane == s2
            m1 = torch.where(init, -0x8000, m1)
            m2 = torch.where(init, -0x8000, m2)

        m1 = torch.minimum(m1, torch.minimum(i1, d1))
        val_e = torch.where(exit_mask, m1, val_e)

        sub = torch.minimum(torch.where(s2w == s1w, 0, q2w), nq)
        m1 = m1 + sub
        d1_new = torch.minimum(d2 + ge, torch.minimum(m2, i2)
                               + _shift_down(gow, zero_col))
        d1 = _shift_up(d1_new, pos_inf_col)
        i1 = torch.minimum(i2 + ge, m2 + gow) + npr
        bp_even, m1, i1, d1 = _labels(m1, i1, d1)

        # odd phase ---------------------------------------------------------
        s1w = _shift_down(s1w, hap_c)
        nq = _shift_down(nq, torch.where(hap_c == _N_CHAR, 0, POS_INF).to(i32))
        gow = _shift_down(gow, go_c)

        m2 = torch.minimum(m2, torch.minimum(i2, d2))
        val_o = torch.where(exit_mask, m2, val_o)

        sub2 = torch.minimum(torch.where(s2w == s1w, 0, q2w), nq)
        m2 = m2 + sub2
        d2 = torch.minimum(d1 + ge, torch.minimum(m1, i1) + gow)
        i2 = torch.minimum(_shift_down(i1, pos_inf_col) + ge,
                           _shift_down(m1, pos_inf_col) + gow) + npr
        i2[:, -1] = POS_INF
        bp_odd, m2, i2, d2 = _labels(m2, i2, d2)

        bp[s2 * N_LANES : (s2 + 1) * N_LANES] = (bp_even | (bp_odd << 8)).T

    # First strict minimum over (row ascending, even before odd), as the
    # scalar loop's `if score < minscore` resolves it.
    row_min = torch.minimum(val_e, val_o)
    row_phase = (val_o < val_e).to(i32)
    best = row_min[:, 0]
    best_r = torch.zeros((B,), dtype=i32, device=dev)
    best_p = row_phase[:, 0]
    for r in range(1, N_LANES):
        upd = row_min[:, r] < best
        best = torch.where(upd, row_min[:, r], best)
        best_r = torch.where(upd, r, best_r)
        best_p = torch.where(upd, row_phase[:, r], best_p)
    return (best + 0x8000) >> 2, 2 * (read_len + best_r) + best_p, bp


def band_align_batch(hap_seg, gapopen_seg, read, qual, read_len,
                     gapextend: int = 3, nucprior: int = 2) -> np.ndarray:
    """Host convenience API: pad, then run the plain DP on the CPU."""
    padded = pad_alignment_inputs(hap_seg, gapopen_seg, read, qual, read_len)
    return band_align_padded_reference(
        *padded, gapextend=gapextend, nucprior=nucprior).numpy()
