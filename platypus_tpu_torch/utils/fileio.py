"""Small file-handling helpers mirroring the reference's conveniences.

* open_transparent: gzip-transparent text open (reference filez.py:7-47 /
  platypusutils.pyx:72-83 `Open`);
* is_indexable / expand_bam_file_names: accept a text file listing BAM
  paths in place of the BAM list itself (platypusutils.pyx:87-88,160-176,
  applied at variantcaller.pyx:905);
* expand_list_arg: comma-split with glob support for list-typed CLI flags
  (extendedoptparse.py:16-48).
"""

from __future__ import annotations

import glob
import gzip
import os
from typing import IO, List


def open_transparent(path: str, mode: str = "rt") -> IO:
    if path.lower().endswith((".gz", ".bgz")):
        return gzip.open(path, mode)
    return open(path, mode)


def open_url(url: str, command: str = "scp -q %s /dev/stdout") -> IO:
    """Pipe a remote file through a user-specified fetch command, with
    on-the-fly .gz/.bz2 decompression (reference filez.py:24-47 openurl).

    `command` shortcuts "scp"/"wget" expand to the reference's templates;
    underscores stand in for spaces to dodge shell quoting.
    """
    import subprocess

    if command == "scp":
        command = "scp -q %s /dev/stdout"
    elif command == "wget":
        command = "wget -q -O - %s"
    command = command.replace("_", " ")
    p1 = subprocess.Popen((command % url).split(), stdout=subprocess.PIPE)
    lower = url.lower()
    if lower.endswith(".gz"):
        p2 = subprocess.Popen(["zcat"], stdin=p1.stdout, stdout=subprocess.PIPE)
    elif lower.endswith(".bz2"):
        p2 = subprocess.Popen(["bzcat"], stdin=p1.stdout, stdout=subprocess.PIPE)
    else:
        p2 = p1
    return p2.stdout


def is_indexable(path: str) -> bool:
    return path.lower().endswith((".bam", ".cram"))


def expand_bam_file_names(names: List[str]) -> List[str]:
    """A single non-BAM entry is read as a text file of BAM paths."""
    if len(names) == 1 and not is_indexable(names[0]) and os.path.exists(names[0]):
        out: List[str] = []
        with open_transparent(names[0]) as fh:
            for line in fh:
                line = line.strip()
                if is_indexable(line):
                    out.append(line)
        return out
    return [os.path.expanduser(n) if not os.path.exists(n) else n for n in names]


def expand_list_arg(value: str) -> List[str]:
    value = value.strip(" ")
    if "*" in value:
        return sorted(glob.glob(os.path.expanduser(value)))
    return [v for v in value.replace(" ", "").split(",") if v]
