"""The reference's frozen copy (perfbench/reference/gnxref) against the
record of where it came from (perfbench/reference/provenance.json): every
file of the copy is listed, none has drifted from its recorded hash, and
where the port's file is still the one the copy was taken from, the copy
differs from it by the recorded edits alone.

The record was made from ``git show <commit>:<port file>`` for each file,
and the edits with difflib's unified diff (no context lines).
"""

import difflib
import hashlib
import json
import os

import pytest

from perfbench import harness

REF = os.path.join(harness.HERE, "reference")
GNXREF = os.path.join(REF, "gnxref")


def _record():
    with open(os.path.join(REF, "provenance.json")) as f:
        return json.load(f)["files"]


def _copy_files():
    out = []
    for dp, _, fn in os.walk(GNXREF):
        out += [os.path.relpath(os.path.join(dp, f), GNXREF).replace(os.sep, "/")
                for f in fn if f.endswith(".py")]
    return sorted(out)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_every_file_of_the_copy_is_recorded():
    assert _copy_files() == sorted(_record())


@pytest.mark.parametrize("rel", sorted(_record()))
def test_the_copy_is_its_source_with_the_recorded_edits(rel):
    rec = _record()[rel]
    mine = os.path.join(GNXREF, rel)
    assert _sha(mine) == rec["sha256"], f"{rel} drifted from its record"
    port = os.path.join(harness.ROOT, rec["port"])
    if not os.path.exists(port) or _sha(port) != rec["port_sha256"]:
        pytest.skip(f"{rec['port']} has changed since the copy was taken")
    with open(port) as f:
        src = f.read().splitlines()
    with open(mine) as f:
        copy = f.read().splitlines()
    edits = list(difflib.unified_diff(src, copy, n=0, lineterm=""))[2:]
    assert edits == rec["edits"]
