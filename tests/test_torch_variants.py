"""PyTorch port, the variant tool of the hand-written kernels
(ops/adjoint_variants.py): every variant of every group applies to the
committed sources. Each variant is a set of text edits of a copy of
`csrc/`, which the tool makes on the card before it builds; an edit whose
text is no longer in its source stops the tool there. Here each one runs on
a copy under tmp_path, without a compiler."""

import filecmp
import shutil

import pytest

from kylespathtracer_tpu_torch.ops import adjoint_variants as av

# The parametric variants of each group, one value each, and K3's design
# before its box cull (uncut, 16x8 tiles, one tile a block) as a joined
# variant.
PARAMETRIC = {
    "adjoint": ["minblocks=3"],
    "frame": ["minblocks=3", "tile=32x4"],
    "path": ["minblocks=3", "k4_minblocks=3", "depth=3", "census", "uncut+minblocks=3"],
    "geometry": ["minblocks=3", "tile=16x8", "pixels=2", "uncut+tile=16x8+pixels=1"],
}
# Runtime options: the build is the committed one.
NO_EDIT = {"committed", "depth=3", "census"}
CASES = [(group, variant) for group, (off, *_) in av.GROUPS.items()
         for variant in ["committed", *off, *PARAMETRIC[group]]]


@pytest.mark.parametrize("group,variant", CASES, ids=[f"{g}-{v}" for g, v in CASES])
def test_variant_applies_to_the_committed_sources(tmp_path, group, variant):
    csrc = tmp_path / "csrc"
    shutil.copytree(av._build.CSRC, csrc)
    av.edit(csrc, variant, group)
    changed = [src for src in sorted(p.name for p in csrc.iterdir())
               if not filecmp.cmp(csrc / src, av._build.CSRC / src, shallow=False)]
    assert bool(changed) == (variant not in NO_EDIT), changed
    assert {src for src, *_ in av.edits_of(variant, group)} == set(changed)
