"""The torch port's own native library (platypus_tpu_torch/native/): it
builds from the port's sources into platypus_tpu_torch/_build/, two
processes that build it at once both load a whole library, and it is
bitwise equal to the JAX package's library.

The parity inputs are those the JAX package's host path hands its own
library on a seeded synthetic region (30x, SNPs, an insertion and a
deletion): the k-mer voting batch, the native CPU alignment batch, the
loglik batch and the genotype / EM / posterior batches that finish_window's
pre-pass uses.  The port's library gets the same numpy arrays, and every
output must match byte for byte."""

import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

import platypus_tpu_torch
from platypus_tpu import native as jax_native
from platypus_tpu.engine import caller as jax_caller
from platypus_tpu_torch import native as port_native
from torch_twin_util import JAX_PKG, prepare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(platypus_tpu_torch.__file__)
JAX_LIB = os.path.join(REPO, "platypus_tpu", "native", "libplatypus_native.so")


def _same(a, b) -> bool:
    """Bitwise equality of nested tuples / lists of arrays and scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.ascontiguousarray(a).tobytes()
                == np.ascontiguousarray(b).tobytes())
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def test_library_builds_from_the_port_sources():
    path = port_native.library_path()
    assert os.path.dirname(path) == os.path.join(PKG_DIR, "_build")
    assert os.path.basename(path).startswith("libplatypus_native_")
    assert os.sep + "platypus_tpu" + os.sep not in path
    lib = port_native.load()
    assert lib is not None and lib._name == path and os.path.exists(path)
    sources = port_native._sources()
    assert "Makefile" in sources and len(sources) >= 12
    for rel in sources:
        assert os.path.exists(os.path.join(PKG_DIR, "native", rel))


def test_port_process_never_maps_the_jax_library(tmp_path):
    """A fresh process that runs the port's native path maps the port's
    library and not platypus_tpu/native/libplatypus_native.so."""
    code = ("import numpy as np\n"
            "from platypus_tpu_torch import native\n"
            "assert native.load() is not None\n"
            "native.native_tandem_annotate(b'ACACACACGT', False)\n"
            "maps = open('/proc/self/maps').read()\n"
            "print(native.library_path() in maps, "
            f"{JAX_LIB!r} in maps)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["True", "False"]


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Two processes build into an empty build directory at once: each
    compiles to its own temporary file and renames it into place, so both
    load a whole library and no temporary file is left."""
    build_dir = str(tmp_path / "build")
    code = ("import sys\n"
            "from platypus_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "lib = native.load()\n"
            "assert lib is not None and lib._name == native.library_path()\n"
            "assert native.native_tandem_annotate(b'ACGTACGT', False) is not None\n"
            "print(native.library_path())\n")
    env = {k: v for k, v in os.environ.items()
           if k != "PLATYPUS_TPU_TORCH_NATIVE_LIB"}
    procs = [subprocess.Popen([sys.executable, "-c", code, build_dir],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(out.strip())
    assert outs[0] == outs[1] and outs[0].startswith(build_dir)
    assert os.listdir(build_dir) == [os.path.basename(outs[0])]


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """name -> (args, kwargs) of every call the JAX package's host path
    made to its native library while preparing, aligning and pre-calling
    one seeded region, plus the genotype tables of its windows."""
    from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

    workdir = str(tmp_path_factory.mktemp("torch_native"))
    ref_path, ref_seq = make_reference(workdir, length=12000, seed=11)
    variants = [(3000, 1, b"A" if ref_seq[3000] != ord("A") else b"C"),
                (3012, 1, b"G" if ref_seq[3012] != ord("G") else b"T"),
                (6100, 3, b""), (9050, 0, b"TTA")]
    reads = simulate_reads([SimHaplotype(ref_seq, variants),
                            SimHaplotype(ref_seq, [])], 1000, 11000,
                           coverage=30, error_rate=0.002, seed=5,
                           fast_errors=True)
    bam = write_synth_bam(workdir, reads, ref_len=12000)
    names = ("native_kmer_segments_batch", "native_band_align_pairs",
             "native_loglik_batch", "native_infer_batch", "native_gl_batch")
    calls = {}
    patches = [mock.patch.object(jax_native, n, wraps=getattr(jax_native, n))
               for n in names]
    for p in patches:
        p.start()
    try:
        prep = prepare(JAX_PKG, ("chr20", 1000, 11000), bam_files=[bam],
                       ref_file=ref_path, output="-")
        logliks = prep.state.pending.finalize()
        entries = [(w_idx, p, ll) for (w_idx, p), ll
                   in zip(prep.state.live, logliks)]
        jax_caller.precompute_window_gl(entries, want_em=True)
        gl = jax_caller.precompute_window_gl(entries, want_em=False)
        for n in names:
            mocked = getattr(jax_native, n)
            assert mocked.call_count >= 1, n
            calls[n] = (mocked.call_args.args, mocked.call_args.kwargs)
        prep.close()
    finally:
        for p in patches:
            p.stop()
    return calls, entries, gl


@pytest.mark.parametrize("name", ["native_kmer_segments_batch",
                                  "native_band_align_pairs",
                                  "native_loglik_batch",
                                  "native_infer_batch",
                                  "native_gl_batch"])
def test_host_path_call_is_bitwise_equal(captured, name):
    calls, _entries, _gl = captured
    args, kwargs = calls[name]
    want = getattr(jax_native, name)(*args, **kwargs)
    got = getattr(port_native, name)(*args, **kwargs)
    assert want is not None and _same(got, want), name


def _em_entries(captured):
    """finish_window's EM inputs per window: (likelihoods, h1, h2, H,
    n_reads), from the GL pre-pass."""
    from platypus_tpu.ops import likelihood as lk

    _calls, entries, gl = captured
    out = []
    for w_idx, prep, _ll in entries:
        H = len(prep.all_haps)
        h1, h2 = lk.genotype_index_pairs(H)
        likelihoods, n_reads = gl[w_idx][2], gl[w_idx][3]
        out.append((likelihoods, h1, h2, H, n_reads))
    return out


def test_em_batch_is_bitwise_equal(captured):
    entries = _em_entries(captured)
    want = jax_native.native_em_batch(entries)
    assert want is not None and len(want) == len(entries) > 5
    assert _same(port_native.native_em_batch(entries), want)


def test_posteriors_batch_is_bitwise_equal(captured):
    """The variant posterior log-ratios on the EM frequencies, with the
    variant-in-haplotype table finish_window's pre-pass builds."""
    from platypus_tpu.parallel.batch import enumerate_window_variants

    _calls, entries, _gl = captured
    em_entries = _em_entries(captured)
    ems = jax_native.native_em_batch(em_entries)
    post = []
    for (_w, prep, _ll), (lik, h1, h2, _H, n_reads), em in zip(
            entries, em_entries, ems):
        sets = [set(h.variants) for h in prep.all_haps]
        variants = enumerate_window_variants(prep.all_haps)
        if not variants or em is None:
            continue
        vih = np.array([[v in s for s in sets] for v in variants], np.uint8)
        post.append((lik, em[0], h1, h2,
                     np.nonzero(n_reads)[0].astype(np.int64), vih))
    assert len(post) > 5
    want = jax_native.native_posteriors_batch(post)
    assert want is not None
    assert _same(port_native.native_posteriors_batch(post), want)
