"""The plain banded-alignment DP: a frozen copy of the port's plain
version of K1's pair entry (platypus_tpu_torch/ops/align_torch.py
gather_pad, _pad_core and band_align_padded_reference at the commit that
added this benchmark), in plain torch on whatever device its inputs are.
It imports nothing of the program.

band_align_pairs(deduplicated uint8 matrices, int32 pair rows) -> [B]
int32 phred: each pair's haplotype segment and read gathered and padded
with the kernel's sentinels ('N' past len1 = read_len + 15, gap-open
clamped to its value at len1 - 1, read '0' and 4 * quality 64 past the
read), then the two-phase antidiagonal DP over 8 lanes.
"""

from __future__ import annotations

import torch

POS_INF = 0x7800
N_LANES = 8
N_CHAR = ord("N")
PAD_CHAR = ord("0")


def _pad(hap_seg, gapopen_seg, read, qual, read_len):
    B, L2max = read.shape
    L1max = L2max + 2 * N_LANES
    dev = read.device
    read_len = read_len.to(torch.int32)
    len1 = read_len + 15
    hp = torch.full((B, L1max), N_CHAR, dtype=torch.int32, device=dev)
    hp[:, : hap_seg.shape[1]] = hap_seg.to(torch.int32)
    go = torch.zeros((B, L1max), dtype=torch.int32, device=dev)
    go[:, : gapopen_seg.shape[1]] = gapopen_seg.to(torch.int32)
    inside = torch.arange(L1max, device=dev)[None, :] < len1[:, None]
    hp = torch.where(inside, hp, N_CHAR)
    last_go = torch.gather(go, 1, (len1 - 1).clamp(min=0).long()[:, None])
    go = torch.where(inside, go, last_go)
    rd = torch.full((B, L2max + N_LANES), PAD_CHAR, dtype=torch.int32, device=dev)
    rd[:, :L2max] = read.to(torch.int32)
    qd = torch.full((B, L2max + N_LANES), 64, dtype=torch.int32, device=dev)
    qd[:, :L2max] = qual.to(torch.int32)
    in_read = (torch.arange(L2max + N_LANES, device=dev)[None, :]
               < read_len[:, None])
    rd = torch.where(in_read, rd, PAD_CHAR)
    qd = torch.where(in_read, qd, 64)
    return (hp.T.contiguous(), (4 * go).T.contiguous(), rd.T.contiguous(),
            (4 * qd).T.contiguous(), read_len.contiguous())


def _gather_pad(hap_mat, go_mat, seq_mat, qual_mat, pair_hap, pair_read,
                pair_seg, read_len):
    seg_len = seq_mat.shape[1] + 15
    cols = pair_seg.long()[:, None] + torch.arange(
        seg_len, device=pair_seg.device)[None, :]
    cols = cols.clamp(max=hap_mat.shape[1] - 1)
    rows = pair_hap.long()[:, None]
    pr = pair_read.long()
    return _pad(hap_mat[rows, cols], go_mat[rows, cols], seq_mat[pr],
                qual_mat[pr], read_len)


def _up(v, new_col):
    return torch.cat([new_col[:, None], v[:, :-1]], dim=1)


def _down(v, new_col):
    return torch.cat([v[:, 1:], new_col[:, None]], dim=1)


def band_align_padded(hap_cols, go4_cols, read_cols, qual4_cols, read_len,
                      gapextend: int = 3, nucprior: int = 2):
    """The plain DP on padded columns -> [B] int32 phred."""
    i32 = torch.int32
    hap_cols, go4_cols = hap_cols.to(i32), go4_cols.to(i32)
    read_cols, qual4_cols = read_cols.to(i32), qual4_cols.to(i32)
    read_len = read_len.to(i32)
    n_steps, B = read_cols.shape
    dev = read_cols.device
    ge, npr = 4 * gapextend, 4 * nucprior
    lane = torch.arange(N_LANES, dtype=i32, device=dev)[None, :]
    pos_inf_col = torch.full((B,), POS_INF, dtype=i32, device=dev)
    zero_col = torch.zeros((B,), dtype=i32, device=dev)
    m1 = torch.full((B, N_LANES), POS_INF, dtype=i32, device=dev)
    i1, d1, m2, i2, d2 = (m1.clone() for _ in range(5))
    s1w = hap_cols[:N_LANES].T
    gow = go4_cols[:N_LANES].T
    nq = torch.where(s1w == N_CHAR, 0, POS_INF).to(i32)
    s2w = torch.full((B, N_LANES), POS_INF, dtype=i32, device=dev)
    q2w = torch.full((B, N_LANES), 64 * 4, dtype=i32, device=dev)
    minsc = torch.full((B,), POS_INF, dtype=i32, device=dev)
    for s2 in range(n_steps):
        hap_c = hap_cols[N_LANES + s2]
        go_c = go4_cols[N_LANES + s2]
        s2w = _up(s2w, read_cols[s2])
        q2w = _up(q2w, qual4_cols[s2])
        if s2 < N_LANES:
            init = lane == s2
            m1 = torch.where(init, -0x8000, m1)
            m2 = torch.where(init, -0x8000, m2)
        m1 = torch.minimum(m1, torch.minimum(i1, d1))
        ext_lane = (s2 - read_len).clamp(0, N_LANES - 1).long()[:, None]
        valid = (s2 >= read_len) & (s2 < read_len + N_LANES)
        minsc = torch.where(valid, torch.minimum(
            minsc, torch.gather(m1, 1, ext_lane)[:, 0]), minsc)
        m1 = m1 + torch.minimum(torch.where(s2w == s1w, 0, q2w), nq)
        d1 = _up(torch.minimum(d2 + ge, torch.minimum(m2, i2)
                               + _down(gow, zero_col)), pos_inf_col)
        i1 = torch.minimum(i2 + ge, m2 + gow) + npr
        s1w = _down(s1w, hap_c)
        nq = _down(nq, torch.where(hap_c == N_CHAR, 0, POS_INF).to(i32))
        gow = _down(gow, go_c)
        m2 = torch.minimum(m2, torch.minimum(i2, d2))
        minsc = torch.where(valid, torch.minimum(
            minsc, torch.gather(m2, 1, ext_lane)[:, 0]), minsc)
        m2 = m2 + torch.minimum(torch.where(s2w == s1w, 0, q2w), nq)
        d2 = torch.minimum(d1 + ge, torch.minimum(m1, i1) + gow)
        i2 = torch.minimum(_down(i1, pos_inf_col) + ge,
                           _down(m1, pos_inf_col) + gow) + npr
        i2[:, -1] = POS_INF
    return (minsc + 0x8000) >> 2


def band_align_pairs(hap_mat, go_mat, seq_mat, qual_mat, pair_hap, pair_read,
                     pair_seg, read_len, gapextend: int = 3,
                     nucprior: int = 2):
    """K1's pair entry in plain torch: [H, L1B] / [A, L2] uint8 matrices
    and [B] int32 pair rows -> [B] int32 phred."""
    return band_align_padded(
        *_gather_pad(hap_mat, go_mat, seq_mat, qual_mat, pair_hap, pair_read,
                     pair_seg, read_len),
        gapextend=gapextend, nucprior=nucprior)
