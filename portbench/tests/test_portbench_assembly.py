"""The long-event traffic (traffic/synth_long.py) and the plain assembler
(reference/assembly.py): the generator is byte-stable per seed, writes
CIGARs by the local aligner's clipping rule, leaves unmapped reads out of
the counts and plants the long events in the truth; and the program's
native assembler agrees exactly with the plain one on tiles of the timed
path (on the card: at least 200 tiles of the wgs1_30x_assemble cell)."""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from conftest_util import ROOT
from portbench.harness import core
from portbench.harness.core import HERE, Cell, load_cell, load_json, run_cell
from portbench.reference import assembly as plain
from portbench.traffic import synth_long

CELL = "wgs1_30x_assemble"
SEED = 2**34 + 29
M, INS, DEL, SOFT = 0, 1, 2, 4


def _small(length=60_000, coverage=10):
    cfg = load_json(HERE, "configs", "wgs1asm.json")
    cfg["genome_length"] = length
    cfg["platypus"] = dict(cfg["platypus"], buffer_size=20_000)
    tr = load_json(HERE, "traffic", "wgs30x_long.json")
    tr["coverage"] = coverage
    return cfg, tr


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(d))}


def test_generator_is_byte_stable_per_seed(tmp_path):
    cfg, tr = _small()
    dirs = []
    for k, seed in enumerate((SEED, SEED, SEED + 1)):
        d = tmp_path / f"d{k}"
        d.mkdir()
        synth_long.build(str(d), cfg, tr, seed)
        dirs.append(_digests(str(d)))
    assert dirs[0] == dirs[1]
    assert dirs[0]["S000.bam"] != dirs[2]["S000.bam"]


@pytest.mark.parametrize("pos,cigar,want", [
    # a 5 bp deletion with 40 and 60 bases beside it: aligned through
    (100, [(M, 40), (DEL, 5), (M, 60)], (100, [(M, 40), (DEL, 5), (M, 60)])),
    # a 50 bp deletion with 40 bases on the left: the left side clipped,
    # the read placed right of the deletion
    (100, [(M, 40), (DEL, 50), (M, 110)], (190, [(SOFT, 40), (M, 110)])),
    # a 60 bp insertion with 30 bases on the right: the right side clipped
    (100, [(M, 60), (INS, 60), (M, 30)], (100, [(M, 60), (SOFT, 90)])),
    # n + 1 is not enough: a 3 bp deletion needs 5 bases a side
    (100, [(M, 4), (DEL, 3), (M, 96)], (107, [(SOFT, 4), (M, 96)])),
    (100, [(M, 5), (DEL, 3), (M, 95)], (100, [(M, 5), (DEL, 3), (M, 95)])),
    # a read that starts inside an insertion
    (100, [(INS, 30), (M, 120)], (100, [(SOFT, 30), (M, 120)])),
    # two events: the short side of the long one goes first, then the
    # short indel still holds enough bases a side
    (100, [(M, 30), (INS, 40), (M, 40), (DEL, 2), (M, 40)],
     (130, [(SOFT, 70), (M, 40), (DEL, 2), (M, 40)])),
    # fewer than 20 bases left on the reference: unmapped
    (100, [(M, 19), (INS, 131)], (None, None)),
])
def test_clipping_rule(pos, cigar, want):
    got = synth_long.clip_alignment(pos, cigar, 20)
    assert got == want


def test_cigars_follow_the_rule_and_unmapped_reads_are_not_counted(tmp_path):
    from platypus_tpu_torch.io.bam import BamFile

    cfg, tr = _small()
    meta = synth_long.build(str(tmp_path), cfg, tr, SEED)
    with BamFile(str(tmp_path / "S000.bam")) as fh:
        reads = fh.fetch(cfg["contig"], 0, cfg["genome_length"])
    assert len(reads) == sum(meta["reads_per_region"])
    clipped = 0
    for i in range(len(reads)):
        ops = [(int(c) & 15, int(c) >> 4) for c in
               reads.cigar_flat[reads.cigar_off[i]:reads.cigar_off[i + 1]]]
        assert sum(n for op, n in ops if op in (M, INS, SOFT)) == \
            cfg["read_length"]
        assert sum(n for op, n in ops if op == M) >= 20
        assert all(op != SOFT for op, _n in ops[1:-1])
        clipped += any(op == SOFT for op, _n in ops)
        total, left = sum(n for op, n in ops if op == M), 0
        for op, n in ops:
            if op == M:
                left += n
            elif op in (INS, DEL):
                assert min(left, total - left) > n + 1, ops
    assert clipped > 0


def test_truth_carries_the_long_events(tmp_path):
    cfg, tr = _small(length=200_000)
    meta = synth_long.build(str(tmp_path), cfg, tr, SEED)
    spec = tr["long_events"]
    lengths = []
    for key in meta["long"]:
        pos, n, alt = key.split(":")
        assert key in meta["truth"]
        assert (int(n) == 0) != (alt == "")
        lengths.append(max(int(n), len(alt)))
    assert spec["length"][0] <= min(lengths) and max(lengths) <= spec["length"][1]
    share = len(meta["long"]) / len(meta["truth"])
    assert 0.05 < share < 0.2
    # no planted variant overlaps another
    spans = sorted((int(k.split(":")[0]), int(k.split(":")[0])
                    + max(1, int(k.split(":")[1]))) for k in meta["truth"])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


class TileRecorder:
    """Wraps the program's native region assembler: keeps a seeded
    reservoir of `keep` tiles of every call, each as plain.assemble_tile's
    inputs beside what the program returned for it."""

    def __init__(self, seed: int, keep: int):
        self.rng = np.random.default_rng(seed)
        self.keep, self.seen, self.tiles = keep, 0, []

    def wrap(self, orig):
        def region(tiles, piles, kmer_size, min_qual, min_weight, no_cycles,
                   n_threads, region_ref, slices):
            out = orig(tiles, piles, kmer_size, min_qual, min_weight,
                       no_cycles, n_threads, region_ref, slices)
            args = (kmer_size, min_qual, min_weight, no_cycles)
            for t, inputs in enumerate(plain.tile_inputs(tiles, piles, slices,
                                                         region_ref)):
                self.seen += 1
                slot = (len(self.tiles) if len(self.tiles) < self.keep
                        else int(self.rng.integers(0, self.seen)))
                if slot < self.keep:
                    item = (inputs, args, sorted(out[0][t]))
                    if slot == len(self.tiles):
                        self.tiles.append(item)
                    else:
                        self.tiles[slot] = item
            return out
        return region

    def mismatches(self):
        bad = []
        for (ref_seq, ref_start, a, b, reads), args, got in self.tiles:
            want, _retries = plain.assemble_tile(ref_seq, ref_start, a, b,
                                                 reads, *args)
            if want != got:
                bad.append((a, b, len(got), len(want)))
        return bad


def _run_recorded(cell, seed, seconds, device, keep, monkeypatch,
                  overrides=None):
    """run_cell with the tile recorder on the native assembler and the
    planted-variant judge also run on the long events alone; returns
    (result, recorder, the long events' tally)."""
    from platypus_tpu_torch import native

    rec = TileRecorder(seed, keep)
    monkeypatch.setattr(native, "native_assemble_region",
                        rec.wrap(native.native_assemble_region))
    judged = {}
    judge = core._judge_calls

    def both(win, meta, ds_dir):
        only_long = dict(meta, truth={k: meta["truth"][k]
                                      for k in meta["long"]})
        judged["long"] = judge(win, only_long, ds_dir)
        return judge(win, meta, ds_dir)

    monkeypatch.setattr(core, "_judge_calls", both)
    r = run_cell(cell, seed, seconds, False, time.perf_counter(),
                 device=device, overrides=overrides)
    return r, rec, judged["long"]


def test_native_assembler_equals_the_plain_one_on_the_cpu(monkeypatch):
    cfg, tr = _small(length=100_000)
    bench = load_json(ROOT, "BENCHMARK.json")
    metrics = [m for m in bench["end_to_end"] if "workloads" not in m]
    cell = Cell("tiny_assemble", "test_wgs1asm", cfg, "test_long", tr,
                load_json(HERE, "limits", CELL + ".json"), 1, metrics)
    r, rec, long_ = _run_recorded(cell, SEED, 1.0, torch.device("cpu"), 40,
                                  monkeypatch,
                                  overrides={"device_inference": 1})
    assert r["failed"] == 0
    assert len(rec.tiles) == 40 < rec.seen
    assert rec.mismatches() == []
    assert long_.sites > 0


@pytest.mark.cuda
def test_native_assembler_equals_the_plain_one_on_the_card(monkeypatch):
    """The cell at full size for a 20 s window: 256 tiles of the timed
    path drawn evenly, each tile's variants equal to the plain
    assembler's; the cell correct; the long events' missed share printed
    (a reading: PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = load_cell(ROOT, CELL, False)
    r, rec, long_ = _run_recorded(cell, 2**31 + 4099, 20.0,
                                  torch.device("cuda", 0), 256, monkeypatch)
    bad = rec.mismatches()
    print(json.dumps(dict(tiles_seen=rec.seen, tiles_compared=len(rec.tiles),
                          mismatched=len(bad), correct=r["correct"],
                          checks=r["checks"], readings=r["readings"],
                          long_sites=long_.sites, long_missed=long_.missed,
                          long_missed_share=long_.missed / max(1, long_.sites))))
    assert len(rec.tiles) >= 200 and bad == []
    assert r["correct"] and r["failed"] == 0, r["checks"]


def test_plain_assembler_imports_neither_the_program_nor_jax():
    import ast

    from portbench.harness.guard import forbidden_modules

    tree = ast.parse(open(plain.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not forbidden_modules(names)
    assert not [n for n in names if n.split(".")[0] == "platypus_tpu_torch"]
