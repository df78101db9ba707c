"""kernel_diag.py's ablation: every patch finds its one line of
newton_doc.cuh (where B1's and B3's bodies live), and a patched line that
changed is refused rather than skipped."""

import pytest

import kernel_diag as kd
from strutopy_tpu_torch.ops import build


def _bodies():
    return (build.CSRC / "newton_doc.cuh").read_text()


def test_every_ablation_patch_applies_once():
    out = kd.ablated_source(_bodies())
    for _bit, _what, subs in kd.PARTS:
        for _old, new in subs:
            assert out.count(new) == 1, new
    bits = sum(bit for bit, _what, _subs in kd.PARTS)
    assert all(v & ~bits == 0 for v in kd.VARIANTS)
    assert kd.describe(0) == "nothing (the kernel)"


@pytest.mark.parametrize("old", [subs[0][0] for _bit, _what, subs in kd.PARTS])
def test_a_changed_patched_line_is_refused(old):
    with pytest.raises(RuntimeError, match="no longer holds"):
        half = len(old) // 2
        kd.ablated_source(_bodies().replace(old, old[:half] + "/**/" + old[half:]))
