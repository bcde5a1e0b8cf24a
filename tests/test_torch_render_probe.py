"""render_kernel_probe.py's variants against the tree's kernel sources (CPU).

The probe times patched copies of kernels/csrc/; an edit whose text the
sources no longer hold would make it raise on the card.  Each edit of each
variant must occur exactly once in the file it patches.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import render_kernel_probe as probe  # noqa: E402


@pytest.mark.parametrize("variant", sorted(probe.PATCHES))
def test_every_edit_applies_exactly_once(variant, tmp_path):
    for f, old, _ in probe.PATCHES[variant]:
        with open(os.path.join(probe.CSRC, f)) as fh:
            assert fh.read().count(old) == 1, (variant, f, old[:60])
    dest = probe.apply_variant(variant, str(tmp_path / variant))
    for f, old, new in probe.PATCHES[variant]:
        with open(os.path.join(dest, f)) as fh:
            assert new in fh.read()


def test_timeline_parts_reads_both_warpgroups():
    import numpy as np

    t = np.zeros((2, 64), np.int64)
    for g in range(2):
        t[g, 60] = 1000 + 500 * g
        t[g, 0:6] = [1100 + 500 * g, 3100 + 500 * g, 3600 + 500 * g,
                     3700 + 500 * g, 4700 + 500 * g, 4800 + 500 * g]
        t[g, 39] = 1300 + 500 * g
        t[g, 62], t[g, 63] = 4900 + 500 * g, 5200 + 500 * g
    out = probe.timeline_parts(t, [("relu", 256), ("dens", 16)])
    w1 = out["warpgroup_1"]
    assert w1["chunk_start"] == 500 and w1["dists"] == 100 and w1["composite"] == 300
    assert w1["wide_products"] == 2000 and w1["narrow_products"] == 1000
    assert w1["issue_waits"] == 200 and w1["epilogues"] == 600 and w1["barriers"] == 200
    assert w1["passes"][1] == {"kind": "dens", "n": 16, "start": 3200, "issue_wait": 0,
                               "product": 1000, "epilogue": 100, "barrier": 100}
